"""Execution over a mesh of shards.

Counterpart of ``spark_rapids_tpu/parallel/``.  The JAX package runs one
SPMD ``shard_map`` program over a ``jax.sharding.Mesh`` and moves rows
with ``jax.lax.all_to_all``; the port holds N shards, each on a
``torch.device``, in one process, and moves rows with per-destination
gathers (``parallel/mesh.py``).  Each shard runs the port's own
operators: the aggregate's update and merge phases, its joins and its
sort.  ``parallel/dryrun.py`` drives all three against numpy.
"""

from spark_rapids_tpu_torch.parallel.mesh import data_mesh, shard_table
from spark_rapids_tpu_torch.parallel.distagg import DistributedAggregate
from spark_rapids_tpu_torch.parallel.distjoin import (
    DistributedBroadcastJoinAggregate,
)

__all__ = ["data_mesh", "shard_table", "DistributedAggregate",
           "DistributedBroadcastJoinAggregate"]
