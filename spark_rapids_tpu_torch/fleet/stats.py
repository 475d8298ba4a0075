"""The fleet router's process-wide counters.

Counterpart of ``spark_rapids_tpu/fleet/stats.py``: the ``fleet``
section of ``obs/registry.snapshot()``.  It imports nothing else of the
fleet package.  The counters live in the router's process; each
replica's own serving counters stay in its process and come back on
request (``FleetRouter.replica_stats``).
"""

from __future__ import annotations

import threading
from typing import Dict

_LOCK = threading.Lock()

_COUNTERS = {
    "fleets": 0,            # FleetRouter instances started
    "submitted": 0,         # submit() calls past the fault gate
    "routed": 0,            # dispatched to a replica (failovers too)
    "overflowed": 0,        # routed past the stride pick (replica full)
    "rejected": 0,          # shed typed (AdmissionRejectedError)
    "completed": 0,         # finished with a result
    "failed": 0,            # ended with an error
    "failovers": 0,         # queries in flight replayed on another replica
    "failovers_shed": 0,    # failovers refused (budget, attempts): typed
    "quarantines": 0,       # replicas quarantined by the health rollup
    "restores": 0,          # replicas restored to full membership
    "probes": 0,            # probe queries sent
    "probe_failures": 0,
    "replica_deaths": 0,    # deaths by exit code or heartbeat silence
    "replica_restarts": 0,  # replacements booted (rolling restart too)
    "rolling_restarts": 0,  # rolling_restart() sweeps completed
    "route_faults": 0,      # injected fleet.route fires (typed shed)
    "replica_fail_faults": 0,   # injected replica.fail fires
    "replica_slow_faults": 0,   # injected replica.slow fires
}

_GAUGES = {
    "replicas": 0,          # the fleet's configured width
    "healthy_replicas": 0,  # routable now (not quarantined, not dead)
}


def bump(key: str, v: int = 1) -> None:
    if v:
        with _LOCK:
            _COUNTERS[key] += int(v)


def set_gauge(key: str, v: int) -> None:
    with _LOCK:
        _GAUGES[key] = int(v)


def global_stats() -> Dict[str, int]:
    with _LOCK:
        out = dict(_COUNTERS)
        out.update(_GAUGES)
        return out


def reset() -> None:
    with _LOCK:
        for k in _COUNTERS:
            _COUNTERS[k] = 0
        for k in _GAUGES:
            _GAUGES[k] = 0
