"""Mesh operators: the planner's lowering of grouped aggregates, global
sorts and equi-joins onto a mesh of shards.

Counterpart of ``spark_rapids_tpu/exec/meshexec.py``, without what
queues A8b-2 (the sharded scan ingest, the out-of-core path) and A8c
(chip health) own.  Each operator drains its input into one batch
through the spill catalog, runs a ``parallel/`` pipeline over
``n_devices`` shards (``DistributedAggregate``, ``DistributedSort``,
``DistributedHashJoin``) and gathers the shards' rows into one batch on
the session's device.  The shards' devices come from
``parallel/mesh.py: data_mesh`` over the session's pool.

Two lowerings share the rewrite (``_lower_fragments``):

* ``spark.rapids.sql.mesh.devices`` = N > 1 (``mesh_lower``): the
  static lowering, with no fallback.  A pool narrower than N keeps the
  single-device plan, as the JAX package does;
* ``spark.rapids.shuffle.mode=ici`` (``ici_lower``): every lowered
  fragment keeps its single-device operator as ``ici_fallback`` and
  runs through ``_guarded_collective``: the ``shuffle.ici.collective``
  fault site, the ``spark.rapids.shuffle.ici.maxStageBytes`` test, the
  hang watchdog under the ``shuffle.ici.hang`` site and a
  ``torch.cuda.OutOfMemoryError`` each degrade the fragment to that
  operator over the input already drained (counted ``iciFallbacks`` and
  ``fallbacks_<reason>``, logged, and written to the journal); any other
  error surfaces.  AQE-inserted hash exchanges under a lowered join are
  unwrapped: the mesh join is the exchange.

Each exchange records its per-shard bytes (the shards' output rows times
the output's row width, host arithmetic over counts already read) in
``iciBytes``, ``shufflePartitionBytes`` and the adaptive statistics, and
the ``device_pull``s made while it ran in ``ici_stats()``'s
``exchange_pulls``: none for a hash exchange, one (the bounds sample)
for a range exchange.  The coalesce the port's planner puts under an
aggregate or a join's stream side is dropped below a mesh operator,
which drains its whole input anyway, so the plans print as the JAX
package's do.
"""

from __future__ import annotations

import logging
import threading
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch import faults, lifecycle
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch, empty_batch
from spark_rapids_tpu_torch.columnar.dtypes import Field, Schema
from spark_rapids_tpu_torch.conf import HEALTH_ENABLED, OOC_ENABLED, \
    SHUFFLE_ICI_MAX_STAGE_BYTES, SHUFFLE_ICI_SHARDED_SCAN
from spark_rapids_tpu_torch.errors import QueryHangError
from spark_rapids_tpu_torch.exec.base import DrainedSource, ExecContext, \
    TorchExec
from spark_rapids_tpu_torch.exec.coalesce import TorchCoalesceBatchesExec, \
    concat_batches
from spark_rapids_tpu_torch.exec.exchange import est_batch_bytes, \
    record_partition_sizes
from spark_rapids_tpu_torch.exprs.base import Alias, Expression
from spark_rapids_tpu_torch.faults import InjectedFault
from spark_rapids_tpu_torch.memory.spill import close_all, \
    collect_spillable, materialize_all
from spark_rapids_tpu_torch.utils.metrics import METRIC_ICI_BYTES, \
    METRIC_ICI_EXCHANGES, METRIC_ICI_FALLBACKS

log = logging.getLogger("spark_rapids_tpu_torch.ici")

FAULT_SITE_ICI_COLLECTIVE = "shuffle.ici.collective"

# ---------------------------------------------------------------------------
# process-wide statistics (the registry's ``ici`` section)
# ---------------------------------------------------------------------------

_ICI_LOCK = threading.Lock()
_ICI_STATS = {
    # mesh exchanges run (a join counts its two sides)
    "exchanges": 0,
    # estimated bytes they moved
    "bytes": 0,
    # fragments degraded to their single-device operator, in all...
    "fallbacks": 0,
    # ...and by reason: over maxStageBytes, the injected fault, a device
    # out-of-memory error, the hang watchdog (a degraded chip pool and a
    # failed sharded ingest come with A8c and A8b-2)
    "fallbacks_over_budget": 0,
    "fallbacks_injected": 0,
    "fallbacks_oom": 0,
    "fallbacks_hang": 0,
    # device_pulls made while the exchanges ran: 0 for a hash exchange,
    # the bounds sample for a range exchange
    "exchange_pulls": 0,
}


def _bump_fallback(code: str) -> None:
    with _ICI_LOCK:
        _ICI_STATS["fallbacks"] += 1
        _ICI_STATS["fallbacks_" + code] = \
            _ICI_STATS.get("fallbacks_" + code, 0) + 1


def ici_stats() -> dict:
    """The process-wide mesh statistics."""
    with _ICI_LOCK:
        return dict(_ICI_STATS)


def reset_ici_stats() -> None:
    with _ICI_LOCK:
        for k in _ICI_STATS:
            _ICI_STATS[k] = 0


class IciUnqualifiedError(RuntimeError):
    """A fragment's input is over ``spark.rapids.shuffle.ici.maxStageBytes``:
    it keeps its single-device operator.  Never escapes
    ``_guarded_collective``."""

    code = "over_budget"


def _row_bytes(batch: ColumnarBatch) -> int:
    """Bytes a row of ``batch`` takes in the device layout (a validity
    byte a column, a string's char width)."""
    return sum(c.data.element_size() + 1 + c.string_width
               for c in batch.columns)


def _record_ici_exchange(node: TorchExec, counts, out: ColumnarBatch,
                         pulls: int, n_collectives: int = 1) -> None:
    """One exchange's statistics: each shard's bytes are its output rows
    times the output's row width (host arithmetic, nothing read back)."""
    roww = _row_bytes(out)
    sizes = [int(c) * roww for c in np.asarray(counts).tolist()]
    total = sum(sizes)
    node.metrics[METRIC_ICI_EXCHANGES] += n_collectives
    node.metrics[METRIC_ICI_BYTES] += total
    record_partition_sizes(node.metrics, sizes)
    with _ICI_LOCK:
        _ICI_STATS["exchanges"] += n_collectives
        _ICI_STATS["bytes"] += total
        _ICI_STATS["exchange_pulls"] += int(pulls)


def _d2h_pulls() -> int:
    from spark_rapids_tpu_torch.columnar import transfer
    return transfer.d2h_stats()["pulls"]


def _mesh(node: TorchExec, ctx: ExecContext):
    from spark_rapids_tpu_torch.parallel.mesh import data_mesh
    return data_mesh(node.n_devices, conf=ctx.conf, device=ctx.device)


def _host_fallback(node: TorchExec, ctx: ExecContext,
                   inputs: List[Optional[ColumnarBatch]]):
    """The fragment's single-device operator over the drained inputs (a
    broadcast join's build side behind a broadcast exchange again)."""
    from spark_rapids_tpu_torch.exec.broadcast import \
        TorchBroadcastExchangeExec, TorchBroadcastHashJoinExec
    fb = node.ici_fallback
    kids = [DrainedSource([] if b is None else [b], c.output_schema)
            for b, c in zip(inputs, node.children)]
    if isinstance(fb, TorchBroadcastHashJoinExec):
        kids[1] = TorchBroadcastExchangeExec(kids[1])
    fb.children = kids
    return fb.execute(ctx)


def _guarded_collective(node: TorchExec, ctx: ExecContext,
                        inputs: List[Optional[ColumnarBatch]], mesh,
                        fallback):
    """THE gate every mesh operator's exchange passes through
    (``tests/test_torch_shuffle_lint.py`` holds every operator's body to
    it).  A static fragment (``mesh.devices``; no ``ici_fallback``)
    runs ``mesh()`` as it is.  A guarded one first tests its input
    against ``maxStageBytes`` and fires the ``shuffle.ici.collective``
    site, then runs ``mesh()`` under the hang watchdog
    (``shuffle.ici.hang``); an over-budget input, the injected fault, a
    watchdog trip or a device out-of-memory error returns
    ``fallback()`` instead, counted and logged.  ``mesh()`` returns its
    batches built, so its failures surface here."""
    if node.ici_fallback is None:
        return mesh()
    try:
        cap = ctx.conf.get(SHUFFLE_ICI_MAX_STAGE_BYTES)
        total = sum(est_batch_bytes(b) for b in inputs if b is not None)
        if total > cap:
            raise IciUnqualifiedError(
                f"stage input ~{total} bytes over "
                f"spark.rapids.shuffle.ici.maxStageBytes={cap}")
        faults.maybe_fail(FAULT_SITE_ICI_COLLECTIVE)
        return lifecycle.supervise(mesh, lifecycle.FAULT_SITE_ICI_HANG)
    except IciUnqualifiedError as e:
        reason, code = str(e), e.code
    except QueryHangError as e:
        reason, code = str(e), "hang"
    except InjectedFault as e:
        if e.site != FAULT_SITE_ICI_COLLECTIVE:
            raise  # another site's fault keeps its own recovery path
        reason, code = str(e), "injected"
    except torch.cuda.OutOfMemoryError as e:
        reason, code = f"{type(e).__name__}: {e}", "oom"
    log.warning("mesh exchange degraded to its single-device path (%s, "
                "%s): %s", node.node_name, code, reason)
    node.metrics[METRIC_ICI_FALLBACKS] += 1
    _bump_fallback(code)
    from spark_rapids_tpu_torch.obs import journal
    if journal.enabled():
        journal.emit(journal.EVENT_ICI_FALLBACK, node=node.node_name,
                     reason=reason, code=code)
    return fallback()


def _drain(child: TorchExec, ctx: ExecContext) -> Optional[ColumnarBatch]:
    """The child's whole output as one batch, collected through the spill
    catalog (so it may demote while the rest arrives); None when it
    yields nothing."""
    handles = collect_spillable(child.execute(ctx), ctx)
    if not handles:
        return None
    batches = materialize_all(handles, ctx)
    return batches[0] if len(batches) == 1 else concat_batches(batches)


def _single_child_collective(node: TorchExec, ctx: ExecContext):
    """The execute body of the single-child mesh operators (aggregate,
    sort): drain the child, then the exchange through
    ``_guarded_collective``."""
    inp = _drain(node.children[0], ctx)
    if inp is None:
        return
    yield from _guarded_collective(
        node, ctx, [inp], lambda: node._run_mesh(ctx, inp),
        lambda: _host_fallback(node, ctx, [inp]))


class TorchMeshAggregateExec(TorchExec):
    """Grouped aggregation over the mesh: each shard's partial aggregate,
    the hash exchange of the partial groups, each shard's merge
    (``parallel/distagg.py``)."""

    def __init__(self, groupings: List[Expression],
                 aggregates: List[Expression], child: TorchExec,
                 n_devices: int):
        super().__init__()
        from spark_rapids_tpu_torch.exec.aggregate import unwrap_aggregate
        self.groupings = list(groupings)
        self.aggregates = list(aggregates)
        self.n_devices = int(n_devices)
        self.children = [child]
        self.ici_fallback = None
        pairs = [unwrap_aggregate(e) for e in aggregates]
        fields = [Field(g.name, g.dtype, g.nullable) for g in self.groupings]
        fields += [Field(n, f.dtype, f.nullable) for n, f in pairs]
        self._schema = Schema(fields)

    @property
    def output_schema(self) -> Schema:
        return self._schema

    def describe(self) -> str:
        gs = ", ".join(g.name for g in self.groupings)
        return f"TorchMeshAggregate [mesh={self.n_devices}, keys=[{gs}]]"

    def _run_mesh(self, ctx: ExecContext, inp: ColumnarBatch):
        from spark_rapids_tpu_torch.parallel.distagg import \
            DistributedAggregate
        dist = DistributedAggregate(self.groupings, self.aggregates,
                                    mesh=_mesh(self, ctx), conf=ctx.conf,
                                    metrics=self.metrics)
        pulls0 = _d2h_pulls()
        n_groups, outs = dist.run_sharded(inp, ctx=ctx)
        pulls = _d2h_pulls() - pulls0
        out = dist.gather(outs, ctx.device)
        # recorded once the gather is done: a fragment that degrades
        # must not count as an exchange as well
        _record_ici_exchange(self, n_groups, out, pulls)
        return [out]

    def execute(self, ctx: ExecContext) -> Iterator[ColumnarBatch]:
        return _single_child_collective(self, ctx)


class TorchMeshSortExec(TorchExec):
    """Global sort over the mesh: sampled range bounds, the range
    exchange, each shard's local sort (``parallel/distsort.py``)."""

    def __init__(self, orders: List[Tuple[Expression, bool, bool]],
                 child: TorchExec, n_devices: int):
        super().__init__()
        self.orders = list(orders)
        self.n_devices = int(n_devices)
        self.children = [child]
        self.ici_fallback = None

    @property
    def output_schema(self) -> Schema:
        return self.children[0].output_schema

    def describe(self) -> str:
        parts = [f"{e.name} {'ASC' if a else 'DESC'}"
                 for e, a, _ in self.orders]
        return (f"TorchMeshSort [mesh={self.n_devices}, "
                + ", ".join(parts) + "]")

    def _run_mesh(self, ctx: ExecContext, inp: ColumnarBatch):
        from spark_rapids_tpu_torch.conf import MAX_STRING_WIDTH
        from spark_rapids_tpu_torch.parallel.distsort import DistributedSort
        dist = DistributedSort(self.orders, self.output_schema,
                               mesh=_mesh(self, ctx),
                               pad_width=ctx.conf.get(MAX_STRING_WIDTH),
                               metrics=self.metrics)
        pulls0 = _d2h_pulls()
        n_local, outs = dist.run_sharded(inp)
        if n_local is None:  # empty, or no bound: as it came
            return [inp]
        pulls = _d2h_pulls() - pulls0
        out = dist.gather(outs, ctx.device)
        _record_ici_exchange(self, n_local, out, pulls)
        return [out]

    def execute(self, ctx: ExecContext) -> Iterator[ColumnarBatch]:
        return _single_child_collective(self, ctx)


class TorchMeshHashJoinExec(TorchExec):
    """The shuffled hash join over the mesh: both sides exchanged by key
    hash, each shard joined locally (``parallel/distjoin.py``)."""

    def __init__(self, left: TorchExec, right: TorchExec,
                 left_keys: List[Expression], right_keys: List[Expression],
                 join_type: str, n_devices: int):
        super().__init__()
        self.children = [left, right]
        self.left_keys = list(left_keys)
        self.right_keys = list(right_keys)
        self.join_type = join_type
        self.n_devices = int(n_devices)
        self.ici_fallback = None

    @property
    def output_schema(self) -> Schema:
        ls = self.children[0].output_schema
        if self.join_type in ("semi", "anti"):
            return ls
        lf = list(ls.fields)
        rf = list(self.children[1].output_schema.fields)
        if self.join_type in ("right", "full"):
            lf = [Field(f.name, f.dtype, True) for f in lf]
        if self.join_type in ("left", "full"):
            rf = [Field(f.name, f.dtype, True) for f in rf]
        return Schema(lf + rf)

    def describe(self) -> str:
        ks = ", ".join(f"{l.name}={r.name}"
                       for l, r in zip(self.left_keys, self.right_keys))
        return (f"TorchMeshHashJoin [mesh={self.n_devices}, "
                f"{self.join_type}, {ks}]")

    def _run_mesh(self, ctx: ExecContext, lb, rb):
        from spark_rapids_tpu_torch.parallel.distjoin import \
            DistributedHashJoin
        ls = self.children[0].output_schema
        rs = self.children[1].output_schema
        dist = DistributedHashJoin(self.left_keys, self.right_keys, ls, rs,
                                   join_type=self.join_type,
                                   mesh=_mesh(self, ctx),
                                   conf=ctx.conf, metrics=self.metrics)
        lb = lb if lb is not None else empty_batch(ls, ctx.device)
        rb = rb if rb is not None else empty_batch(rs, ctx.device)
        pulls0 = _d2h_pulls()
        ns, outs = dist.run_sharded(lb, rb, ctx)
        pulls = _d2h_pulls() - pulls0
        out = dist.gather(outs, ctx.device)
        out.schema = self.output_schema
        # both sides crossed the mesh: two exchanges
        _record_ici_exchange(self, ns, out, pulls, n_collectives=2)
        return [out]

    def execute(self, ctx: ExecContext) -> Iterator[ColumnarBatch]:
        # one side at a time through the spill catalog: while the right
        # side arrives the left side's batches may demote
        lh = collect_spillable(self.children[0].execute(ctx), ctx)
        try:
            rh = collect_spillable(self.children[1].execute(ctx), ctx)
        except BaseException:
            close_all(lh)
            raise
        try:
            lbs = materialize_all(lh, ctx)
        except BaseException:
            close_all(rh)
            raise
        rbs = materialize_all(rh, ctx)
        lb = concat_batches(lbs) if lbs else None
        rb = concat_batches(rbs) if rbs else None
        yield from _guarded_collective(
            self, ctx, [lb, rb], lambda: self._run_mesh(ctx, lb, rb),
            lambda: _host_fallback(self, ctx, [lb, rb]))


# ---------------------------------------------------------------------------
# the planner's lowering passes
# ---------------------------------------------------------------------------

_MESH_JOIN_TYPES = ("inner", "left", "right", "full", "semi", "anti")


def _no_coalesce(node: TorchExec) -> TorchExec:
    while isinstance(node, TorchCoalesceBatchesExec):
        node = node.children[0]
    return node


def _lower_fragments(plan: TorchExec, n: int, guarded: bool) -> TorchExec:
    """Rewrite the single-device grouped aggregates, global sorts and
    condition-free equi-joins of types inner, left, right, full, semi
    and anti to their mesh operators over ``n`` shards.  ``guarded``
    (``spark.rapids.shuffle.mode=ici``): each keeps the operator it
    replaced as ``ici_fallback``, and a join's AQE-inserted hash
    exchanges are unwrapped.  A broadcast join is a hash join: it
    lowers to the shuffled mesh join, which drains the broadcast
    exchange as its right side."""
    from spark_rapids_tpu_torch.exec.aggregate import TorchHashAggregateExec
    from spark_rapids_tpu_torch.exec.joins import TorchHashJoinExec
    from spark_rapids_tpu_torch.exec.sort import TorchSortExec

    def rewrite(node: TorchExec) -> TorchExec:
        node.children = [rewrite(c) for c in node.children]
        new = None
        if isinstance(node, TorchHashAggregateExec) and node.groupings:
            new = TorchMeshAggregateExec(
                node.groupings, [Alias(f, name) for name, f in node.agg_pairs],
                _no_coalesce(node.children[0]), n)
        elif isinstance(node, TorchSortExec):
            new = TorchMeshSortExec(node.orders, node.children[0], n)
        elif isinstance(node, TorchHashJoinExec) and \
                node.join_type in _MESH_JOIN_TYPES and \
                node.condition is None:
            left, right = node.children
            if guarded:
                from spark_rapids_tpu_torch.plan.adaptive import \
                    unwrap_aqe_exchange
                left, _ = unwrap_aqe_exchange(left)
                right, _ = unwrap_aqe_exchange(right)
            new = TorchMeshHashJoinExec(
                _no_coalesce(left), _no_coalesce(right), node.left_keys,
                node.right_keys, node.join_type, n)
        if new is None:
            return node
        if guarded:
            new.ici_fallback = node
        return new

    return rewrite(plan)


def _check_later_slices(plan: TorchExec, conf) -> None:
    """A key whose layer is a later slice raises on a plan that holds a
    mesh operator, naming its queue; none is ignored."""
    from spark_rapids_tpu_torch.shuffle.manager import MeshNotPortedError

    def has_mesh(node):
        return isinstance(node, (TorchMeshAggregateExec, TorchMeshSortExec,
                                 TorchMeshHashJoinExec)) or \
            any(has_mesh(c) for c in node.children)
    if not has_mesh(plan):
        return
    for entry, queue in ((SHUFFLE_ICI_SHARDED_SCAN, "A8b-2"),
                         (OOC_ENABLED, "A8b-2"), (HEALTH_ENABLED, "A8c")):
        if conf.get(entry):
            raise MeshNotPortedError(
                f"{entry.key}=true on a mesh plan: that layer is queue "
                f"{queue} of the torch port, not ported yet; set it false")


def mesh_lower(plan: TorchExec, conf) -> TorchExec:
    """With ``spark.rapids.sql.mesh.devices`` = N > 1 and a pool of at
    least N devices, the static mesh lowering (no fallback); a narrower
    pool keeps the single-device plan, as the JAX package's does."""
    from spark_rapids_tpu_torch.conf import MESH_DEVICES
    from spark_rapids_tpu_torch.parallel.mesh import visible_pool
    n = conf.get(MESH_DEVICES)
    if n <= 1 or len(visible_pool(conf)) < n:
        return plan
    plan = _lower_fragments(plan, n, guarded=False)
    _check_later_slices(plan, conf)
    return plan


def ici_lower(plan: TorchExec, conf) -> TorchExec:
    """The guarded lowering of ``spark.rapids.shuffle.mode=ici`` over
    ``ici_mesh_width`` shards, each fragment carrying its
    single-device operator as the fallback (``select_shuffle_mode``
    already qualified the session)."""
    from spark_rapids_tpu_torch.shuffle.manager import ici_mesh_width
    n = ici_mesh_width(conf)
    if n <= 1:
        return plan
    plan = _lower_fragments(plan, n, guarded=True)
    _check_later_slices(plan, conf)
    return plan
