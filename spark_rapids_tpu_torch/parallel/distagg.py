"""Distributed hash aggregation over the mesh.

Counterpart of ``spark_rapids_tpu/parallel/distagg.py``
(``DistributedAggregate``).  The JAX package traces one ``shard_map``
program: a partial aggregate on every device, a hash partition of the
partial groups, ``jax.lax.all_to_all`` and a merge.  The port runs the
same four steps shard by shard in one process:

1. each shard's partial aggregate is the port's own update phase
   (``exec/aggregate.py: TorchHashAggregateExec._run_phase``), so a
   single integer key whose domain fits takes the dense-slot path, K1
   (``exec/pallas_agg.py``; the Hopper kernel on the card), and any
   other key the sorted-segment path;
2. each partial group goes to shard ``splitmix64(keys) mod N`` (the join
   hash, ``exec/joins.py: hash_colval``, combined as ``hash_keys``
   combines it, taken unsigned as ``exec/exchange.py: unsigned_mod``
   takes it), so every shard assignment is bit for bit the JAX
   package's;
3. ``parallel/mesh.py: exchange`` moves the groups (one host sync for
   the count matrix, no ``device_pull``);
4. each shard merges what it received (``make_agg_body(spec, "merge")``)
   and evaluates the final columns.

The result comes shard by shard, each shard's groups ascending with
nulls first, so the rows come in the JAX package's order.  A null group
key hashes as a zero value (its data plane zeroed first), so the null
group of every shard meets on one shard whatever the padding bytes hold.
``prelude`` (the broadcast join of ``distjoin.py``) turns each shard
into its joined rows before the partial aggregate; ``extra`` carries
what it needs to every shard (the replicated build).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.dtypes import Field, Schema
from spark_rapids_tpu_torch.exec.aggregate import TorchHashAggregateExec, \
    _to_batch, evaluate, unwrap_aggregate
from spark_rapids_tpu_torch.exec.exchange import unsigned_mod
from spark_rapids_tpu_torch.exec.joins import hash_colval, splitmix64
from spark_rapids_tpu_torch.exprs.base import ColVal, Expression, colvals
from spark_rapids_tpu_torch.parallel.mesh import DeviceMesh, data_mesh, \
    exchange, gather_batches, shard_table


def hash_pids(key_cvs: Sequence[ColVal], key_dtypes, n_dev: int,
              live: torch.Tensor) -> torch.Tensor:
    """Destination shard a row: ``splitmix64(keys)`` read unsigned, mod
    ``n_dev``; a dead row gets ``n_dev`` (it stays behind).  A null key
    hashes as a zero value."""
    acc = torch.zeros(live.shape[0], dtype=torch.int64, device=live.device)
    for cv, dt in zip(key_cvs, key_dtypes):
        zero = torch.zeros_like(cv.data)
        cv = ColVal(torch.where(cv.validity, cv.data, zero), cv.validity,
                    None if cv.chars is None else
                    cv.chars * cv.validity[:, None].to(cv.chars.dtype))
        acc = splitmix64(acc ^ hash_colval(cv, dt))
    pid = unsigned_mod(acc, n_dev)
    return torch.where(live, pid, torch.full_like(pid, n_dev))


def _partial_pids(part: ColumnarBatch, groupings, n_dev: int) -> torch.Tensor:
    nk = len(groupings)
    live = torch.arange(part.capacity, device=part.device) < part.num_rows
    return hash_pids(colvals(part.columns[:nk]), [g.dtype for g in groupings],
                     n_dev, live)


class DistributedAggregate:
    """A grouped aggregation over a 1-D mesh of shards.

    ``prelude`` (optional) runs on each shard before the partial
    aggregate: ``prelude(shard, extra, ctx) -> batch``; ``extra`` is a
    tuple replicated to every shard (the mesh's broadcast join rides
    this hook with its build side)."""

    def __init__(self, groupings: Sequence[Expression],
                 aggregates: Sequence[Expression],
                 mesh: Optional[DeviceMesh] = None,
                 n_devices: Optional[int] = None, prelude=None, conf=None,
                 metrics=None):
        from spark_rapids_tpu_torch.conf import TorchConf
        self.conf = conf if conf is not None else TorchConf()
        self.mesh = mesh if mesh is not None else \
            data_mesh(n_devices, conf=self.conf)
        self.n_dev = self.mesh.size
        self.groupings = list(groupings)
        self.agg_pairs = [unwrap_aggregate(e) for e in aggregates]
        self.prelude = prelude
        fields = [Field(g.name, g.dtype, g.nullable) for g in self.groupings]
        fields += [Field(n, f.dtype, f.nullable) for n, f in self.agg_pairs]
        self.output_schema = Schema(fields)
        # the port's own aggregate supplies the update, merge and evaluate
        # phases; it never runs as an operator
        self._agg = TorchHashAggregateExec(self.groupings, list(aggregates),
                                           None)
        if metrics is not None:
            self._agg.metrics = metrics
        self.metrics = self._agg.metrics
        # the count matrix of the last run's exchange
        self.last_counts: Optional[np.ndarray] = None

    def _ctx(self, ctx):
        if ctx is not None or self.prelude is None:
            return ctx
        from spark_rapids_tpu_torch.exec.base import ExecContext
        return ExecContext(self.conf, self.mesh.devices[0])

    # -- the exchange half ------------------------------------------------

    def run_sharded(self, batch: ColumnarBatch, extra: tuple = (),
                    ctx=None):
        """Shard ``batch`` over the mesh and run the partial aggregate,
        the exchange and the merge -> (each shard's group count, each
        shard's result batch or None), the batches still on their
        shards' devices."""
        shards, _, _ = shard_table(batch, self.n_dev, self.mesh.devices)
        return self.run_stacked(shards, extra, ctx)

    def run_stacked(self, shards: Sequence[ColumnarBatch],
                    extra: tuple = (), ctx=None):
        """The pipeline over shards already placed (``shard_table``)."""
        ctx = self._ctx(ctx)
        parts: List[Optional[ColumnarBatch]] = []
        pids: List[Optional[torch.Tensor]] = []
        for shard in shards:
            if self.prelude is not None:
                shard = self.prelude(shard, extra, ctx)
            if shard is None or shard.num_rows == 0:
                parts.append(None)
                pids.append(None)
                continue
            part = self._agg._run_phase("update", shard, self.conf)
            parts.append(part)
            pids.append(_partial_pids(part, self.groupings, self.n_dev))
        received, self.last_counts = exchange(parts, pids, self.mesh)
        self.metrics["hostSyncs"] += 1  # the count matrix
        n_groups = np.zeros(self.n_dev, np.int64)
        outs: List[Optional[ColumnarBatch]] = []
        for d, recv in enumerate(received):
            if recv is None:
                outs.append(None)
                continue
            merged = self._agg._run_phase("merge", recv)
            cols = evaluate(self._agg.spec, colvals(merged.columns),
                            merged.num_rows)
            outs.append(_to_batch(cols, [f.dtype for f in self.output_schema],
                                  merged.num_rows, self.output_schema))
            n_groups[d] = merged.num_rows
        return n_groups, outs

    # -- the collection half ----------------------------------------------

    def gather(self, outs, device=None) -> ColumnarBatch:
        """Shard ``d``'s groups, shard by shard, in one batch on
        ``device`` (default: the first shard's)."""
        return gather_batches(outs, [f.dtype for f in self.output_schema],
                              self.output_schema,
                              device if device is not None
                              else self.mesh.devices[0])

    def run(self, batch: ColumnarBatch, extra: tuple = (),
            ctx=None) -> ColumnarBatch:
        _, outs = self.run_sharded(batch, extra, ctx)
        return self.gather(outs)

