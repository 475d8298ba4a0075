"""Distributed joins over the mesh.

Counterpart of ``spark_rapids_tpu/parallel/distjoin.py``.

``DistributedHashJoin`` (the shuffled join the mesh execs lower an
equi-join to): both sides go to shard ``hash(keys) mod N`` (the join
hash of ``exec/joins.py: hash_keys``, read unsigned, the JAX package's
ids bit for bit), ``parallel/mesh.py: exchange`` moves them, and each
shard joins what it received with the port's own build and probe
(``exec/joins.py: TorchHashJoinExec``: its dense-FK, FK or general
route).  The JAX package probes each device through a bitonic sort of
the received hashes, a TPU workaround the port does not carry.  Inner,
left, right, full, semi and anti joins are locally complete, because
all the rows of one key land on one shard; a shard's unmatched rows are
emitted by the shard that owns the key.  The rows come shard by shard,
each shard's in its join's order, which is not the JAX package's (its
blocks put every shard's matched pairs before the unmatched rows).

``DistributedBroadcastJoinAggregate``: an inner join of the sharded
stream with a build side replicated to every shard (``extra``), run as
the ``prelude`` of a ``DistributedAggregate``, so only partial groups
cross the mesh.  The build keys must be unique (the dimension-table
shape); duplicates raise ``ValueError``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch, empty_batch
from spark_rapids_tpu_torch.columnar.dtypes import Field, Schema
from spark_rapids_tpu_torch.exec.base import DrainedSource, ExecContext
from spark_rapids_tpu_torch.exec.coalesce import concat_batches
from spark_rapids_tpu_torch.exec.exchange import unsigned_mod
from spark_rapids_tpu_torch.exec.joins import TorchHashJoinExec, hash_keys
from spark_rapids_tpu_torch.exprs.base import EvalContext, Expression, \
    colvals
from spark_rapids_tpu_torch.parallel.distagg import DistributedAggregate
from spark_rapids_tpu_torch.parallel.mesh import DeviceMesh, batch_to, \
    data_mesh, dense_batch, exchange, gather_batches, shard_table

_JOIN_TYPES = ("inner", "left", "right", "full", "semi", "anti")


def join_pids(batch: ColumnarBatch, keys: Sequence[Expression],
              n_dev: int) -> torch.Tensor:
    """Destination shard a row: its join hash read unsigned, mod
    ``n_dev`` (a null key's row goes where its data hashes, as in the
    JAX package); a dead row gets ``n_dev``."""
    ctx = EvalContext(colvals(batch.columns), batch.num_rows,
                      batch.capacity, batch.device)
    h, _valid, _ = hash_keys(keys, ctx)
    live = torch.arange(batch.capacity, device=batch.device) \
        < batch.num_rows
    pid = unsigned_mod(h, n_dev)
    return torch.where(live, pid, torch.full_like(pid, n_dev))


def local_join(left: ColumnarBatch, right: ColumnarBatch, left_keys,
               right_keys, join_type: str, ctx: ExecContext, metrics=None
               ) -> List[ColumnarBatch]:
    """One shard's join of ``left`` (stream) with ``right`` (build)
    through the port's hash join -> its output batches."""
    join = TorchHashJoinExec(DrainedSource([left], _schema_of(left)),
                             DrainedSource([right], _schema_of(right)),
                             left_keys, right_keys, join_type)
    if metrics is not None:
        join.metrics = metrics
    return [b for b in join._join(ctx, right) if b.num_rows]


class DistributedHashJoin:
    """Both sides hash-partitioned over the mesh, then joined shard by
    shard (reference GpuShuffledHashJoinExec over
    GpuShuffleExchangeExec)."""

    def __init__(self, left_keys: Sequence[Expression],
                 right_keys: Sequence[Expression], left_schema: Schema,
                 right_schema: Schema, join_type: str = "inner",
                 mesh: Optional[DeviceMesh] = None,
                 n_devices: Optional[int] = None, conf=None, metrics=None):
        if join_type not in _JOIN_TYPES:
            raise ValueError(f"unsupported join type {join_type}")
        from spark_rapids_tpu_torch.conf import TorchConf
        self.conf = conf if conf is not None else TorchConf()
        self.mesh = mesh if mesh is not None else \
            data_mesh(n_devices, conf=self.conf)
        self.n_dev = self.mesh.size
        self.left_keys = list(left_keys)
        self.right_keys = list(right_keys)
        self.left_schema = left_schema
        self.right_schema = right_schema
        self.join_type = join_type
        lf, rf = list(left_schema.fields), list(right_schema.fields)
        if join_type in ("right", "full"):
            lf = [Field(f.name, f.dtype, True) for f in lf]
        if join_type in ("left", "full"):
            rf = [Field(f.name, f.dtype, True) for f in rf]
        self.output_schema = left_schema if join_type in ("semi", "anti") \
            else Schema(lf + rf)
        if metrics is None:
            from spark_rapids_tpu_torch.utils.metrics import MetricSet
            metrics = MetricSet(owner="DistributedHashJoin")
        self.metrics = metrics
        # the count matrices of the last run's two exchanges
        self.last_counts = None

    def _side(self, batch: ColumnarBatch, keys, schema: Schema):
        batch = dense_batch(batch)
        batch = ColumnarBatch(batch.columns, batch.num_rows, schema)
        shards, _, _ = shard_table(batch, self.n_dev, self.mesh.devices)
        pids = [join_pids(s, keys, self.n_dev) if s.num_rows else None
                for s in shards]
        recv, counts = exchange(shards, pids, self.mesh)
        self.metrics["hostSyncs"] += 1  # the count matrix
        return recv, counts

    def run_sharded(self, left: ColumnarBatch, right: ColumnarBatch,
                    ctx: Optional[ExecContext] = None):
        """Shard both sides, exchange them and join each shard -> (each
        shard's output rows, each shard's output batch or None)."""
        if ctx is None:
            ctx = ExecContext(self.conf, self.mesh.devices[0])
        lrecv, lc = self._side(left, self.left_keys, self.left_schema)
        rrecv, rc = self._side(right, self.right_keys, self.right_schema)
        self.last_counts = (lc, rc)
        ns = np.zeros(self.n_dev, np.int64)
        outs: List[Optional[ColumnarBatch]] = []
        jt = self.join_type
        for d, dev in enumerate(self.mesh.devices):
            lb, rb = lrecv[d], rrecv[d]
            if lb is None and (rb is None or jt not in ("right", "full")):
                outs.append(None)
                continue
            lb = lb if lb is not None else empty_batch(self.left_schema, dev)
            rb = rb if rb is not None else empty_batch(self.right_schema,
                                                       dev)
            lb.schema, rb.schema = self.left_schema, self.right_schema
            parts = local_join(lb, rb, self.left_keys, self.right_keys, jt,
                               ctx, self.metrics)
            if not parts:
                outs.append(None)
                continue
            out = concat_batches(parts)
            out.schema = self.output_schema
            outs.append(out)
            ns[d] = out.num_rows
        return ns, outs

    def gather(self, outs, device=None) -> ColumnarBatch:
        return gather_batches(outs, [f.dtype for f in self.output_schema],
                              self.output_schema,
                              device if device is not None
                              else self.mesh.devices[0])

    def run(self, left: ColumnarBatch, right: ColumnarBatch,
            ctx: Optional[ExecContext] = None) -> ColumnarBatch:
        _, outs = self.run_sharded(left, right, ctx)
        return self.gather(outs)


def _unique_rows(batch: ColumnarBatch, keys: Sequence[Expression]) -> bool:
    """Whether the build's key tuples are unique (strings by their
    bytes, not their lengths alone; floats by their bits); nulls compare
    by their data, as in the JAX package."""
    n = batch.num_rows
    if n == 0:
        return True
    ctx = EvalContext(colvals(batch.columns), n, batch.capacity,
                      batch.device)
    cols = []
    for e in keys:
        cv = e.emit(ctx)
        d = cv.data[:n]
        d = d.to(torch.float64).view(torch.int64) \
            if d.dtype.is_floating_point else d.to(torch.int64)
        cols.append(d.reshape(n, -1))
        if cv.chars is not None:
            cols.append(cv.chars[:n].to(torch.int64))
    stacked = torch.cat(cols, dim=1).cpu().numpy()
    return len(np.unique(stacked, axis=0)) == n


def _schema_of(batch: ColumnarBatch) -> Schema:
    return batch.schema if batch.schema is not None else Schema(
        [Field(f"_c{i}", c.dtype, True) for i, c in enumerate(batch.columns)])


class DistributedBroadcastJoinAggregate(DistributedAggregate):
    """An inner join of the sharded stream with a replicated build of
    unique keys, fused with a grouped aggregation over the joined
    columns (stream columns first, then build columns)."""

    def __init__(self, build_batch: ColumnarBatch,
                 stream_keys: Sequence[Expression],
                 build_keys: Sequence[Expression],
                 groupings: Sequence[Expression],
                 aggregates: Sequence[Expression],
                 mesh: Optional[DeviceMesh] = None,
                 n_devices: Optional[int] = None, conf=None, metrics=None):
        build_batch = dense_batch(build_batch)
        if not _unique_rows(build_batch, build_keys):
            raise ValueError(
                "distributed broadcast join requires unique build-side "
                "keys (dimension-table shape)")
        self.build_batch = build_batch
        self.stream_keys = list(stream_keys)
        self.build_keys = list(build_keys)
        self._replicas = {}

        def prelude(shard, extra, ctx):
            (build,) = extra
            dev = shard.device
            if dev not in self._replicas:
                self._replicas[dev] = batch_to(build, dev)
            b = self._replicas[dev]
            if shard.num_rows == 0:
                return None
            parts = local_join(shard, b, self.stream_keys, self.build_keys,
                               "inner", ctx, self.metrics)
            return concat_batches(parts) if parts else None

        super().__init__(groupings, aggregates, mesh=mesh,
                         n_devices=n_devices, prelude=prelude, conf=conf,
                         metrics=metrics)

    def run(self, stream_batch: ColumnarBatch, extra: tuple = (),
            ctx=None) -> ColumnarBatch:
        return super().run(stream_batch, extra=(self.build_batch,), ctx=ctx)
