"""The serving fleet: session servers in replica processes behind one
router, each replica a failure domain.

Counterpart of ``spark_rapids_tpu/fleet/``.  ``session.fleet()`` puts a
``FleetRouter`` (``router.py``) over ``spark.rapids.fleet.replicas``
spawned processes (``replica.py``), whose health the router scores
(``health.py``) and counts (``stats.py``).  With the fleet keys unset
no code of this package runs.

The names resolve when first read, so that a replica process importing
``fleet.replica`` and the stats registry reading ``fleet.stats`` do not
import the router (multiprocessing, the conf, the journal).
"""

__all__ = ["FleetQuery", "FleetRouter", "ReplicaHealthTracker"]


def __getattr__(name):
    if name in ("FleetRouter", "FleetQuery"):
        from spark_rapids_tpu_torch.fleet import router
        return getattr(router, name)
    if name == "ReplicaHealthTracker":
        from spark_rapids_tpu_torch.fleet.health import ReplicaHealthTracker
        return ReplicaHealthTracker
    raise AttributeError(
        f"module {__name__!r} has no attribute {name!r}")
