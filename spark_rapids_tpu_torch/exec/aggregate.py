"""Hash aggregate exec.

Counterpart of ``spark_rapids_tpu/exec/aggregate.py``.  Per input batch
an update phase reduces the batch to one partial row per group; the
partials are concatenated and a merge phase combines them; a final
evaluate turns the buffers into output columns.

The update phase takes the dense-slot path (``exec/pallas_agg.py``, the
Hopper kernel on the card) when ``_try_pallas_update`` routes the batch
there, by the JAX package's rules; otherwise, and for the merge, it takes
the sorted-segment path of ``make_agg_body``: sort rows by their group
keys, mark segment boundaries where a key changes, number the segments
with a prefix sum, and reduce every buffer slot per segment (float sums
in a fixed order, so a sum comes out the same on every run).

Each path reads one or two numbers back to the host per batch (the key
range, the group count); ``hostSyncs`` counts them.  The JAX package
stops probing key ranges after two batches of fresh input, because each
probe costs it a round trip over a remote link; on the card a probe
costs microseconds, so every batch is probed.  An aggregate with no
functions (``DataFrame.distinct``) outputs its groups' keys alone, in
the same order.

The update runs under ``with_retry`` on both routes: on a device
out-of-memory error the spill catalog is relieved, then the batch is
split in half, each half its own partial (a half's keys take K1 at the
half's smaller capacity).  Partials wait for the merge as
``SpillableBatch``es, read back by ``materialize_all``.  A split changes
the order of float sums only, within the class ``exec/pallas_agg.py``
documents; counts, integer sums, min and max stay exact.

String grouping keys take the sorted-segment path (the dense-slot router
rejects them, as the JAX package's does): their sort keys are the packed
byte blocks of ``exec/sortkeys.py``, and each group's key is gathered,
chars and all, from its first row.  ``first`` and ``last`` gather each
group's first or last (non-null, unless nulls are kept) row in input
order, and ``min`` and ``max`` over a string gather the row that sorts
first or last by (group, packed string keys) with nulls losing, as the
JAX package does; their buffers carry the chars.  Sum and average over a
string raise at planning.
"""

from __future__ import annotations

from typing import Iterator, List, Sequence, Tuple

import torch

from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch, empty_batch
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.columnar.dtypes import STRING, DataType, Field, \
    Schema
from spark_rapids_tpu_torch.exec import pallas_agg as pag
from spark_rapids_tpu_torch.exec.base import ExecContext, TorchExec
from spark_rapids_tpu_torch.exec.coalesce import concat_batches
from spark_rapids_tpu_torch.exec.sortkeys import colval_sort_keys, \
    sort_permutation
from spark_rapids_tpu_torch.exprs.aggregates import AggregateFunction, \
    Count, First, Max, Min
from spark_rapids_tpu_torch.exprs.base import Alias, ColVal, EvalContext, \
    Expression, colvals
from spark_rapids_tpu_torch.memory.spill import SpillableBatch, close_all, \
    materialize_all
from spark_rapids_tpu_torch.utils.retry import split_batch_half, with_retry


def unwrap_aggregate(e: Expression) -> Tuple[str, AggregateFunction]:
    """Aggregate output expression -> (output name, function)."""
    if isinstance(e, Alias) and isinstance(e.children[0], AggregateFunction):
        return e.out_name, e.children[0]
    if isinstance(e, AggregateFunction):
        return e.name, e
    raise TypeError(f"not an aggregate expression: {e!r}")


def _segment(op: str, contrib: torch.Tensor, gid: torch.Tensor,
             num_segments: int) -> torch.Tensor:
    """Per-segment add/min/max over rows whose ``gid`` never decreases;
    empty segments hold the op's identity.  A float sum reduces each
    run of rows in a fixed order (``segment_reduce``): the card's
    ``index_add_`` adds with atomics, so two runs of the same sum round
    differently, and a query that compares two evaluations of one sum
    (TPC-H Q15's revenue against its maximum) would drop rows.  On the
    CPU both add in row order, bit for bit alike."""
    if op == "add":
        if contrib.dtype.is_floating_point:
            offsets = torch.searchsorted(gid, torch.arange(
                num_segments + 1, dtype=gid.dtype, device=gid.device))
            return torch.segment_reduce(contrib, "sum", offsets=offsets,
                                        unsafe=True)
        out = torch.zeros(num_segments, dtype=contrib.dtype,
                          device=contrib.device)
        return out.index_add_(0, gid, contrib)
    out = torch.full((num_segments,), pag.neutral(op, contrib.dtype),
                     dtype=contrib.dtype, device=contrib.device)
    return out.scatter_reduce_(0, gid, contrib,
                               reduce="amin" if op == "min" else "amax")


def _segment_reduce(op: str, vals: torch.Tensor, valid: torch.Tensor,
                    gid: torch.Tensor, num_segments: int,
                    live: torch.Tensor) -> torch.Tensor:
    """Masked segment reduction over sorted rows."""
    m = valid & live
    if op == "count":
        return _segment("add", m.to(torch.int64), gid, num_segments)
    if op == "sum":
        return _segment("add", torch.where(m, vals, torch.zeros_like(vals)),
                        gid, num_segments)
    if vals.dtype.is_floating_point:
        # Spark order: NaN is greatest.  min ignores NaN unless the group
        # is all NaN; max is NaN when any NaN is present.
        nan = torch.isnan(vals)
        sentinel = float("inf") if op == "min" else float("-inf")
        base = _segment(op, torch.where(m & ~nan, vals,
                                        torch.full_like(vals, sentinel)),
                        gid, num_segments)
        has_nan = _segment("max", (m & nan).to(torch.int32), gid,
                           num_segments) > 0
        has_non = _segment("max", (m & ~nan).to(torch.int32), gid,
                           num_segments) > 0
        nan_v = torch.full_like(base, float("nan"))
        if op == "min":
            return torch.where(has_nan & ~has_non, nan_v, base)
        return torch.where(has_nan, nan_v, base)
    if vals.dtype == torch.bool:
        v = vals.to(torch.int32)
        sentinel = torch.full_like(v, 1 if op == "min" else 0)
        return _segment(op, torch.where(m, v, sentinel), gid,
                        num_segments).to(torch.bool)
    sentinel = torch.full_like(vals, pag.neutral(op, vals.dtype))
    return _segment(op, torch.where(m, vals, sentinel), gid, num_segments)


class _AggSpec:
    """Static description of one aggregation (shared by update & merge)."""

    def __init__(self, groupings: Sequence[Expression],
                 aggs: Sequence[Tuple[str, AggregateFunction]]):
        self.groupings = list(groupings)
        self.aggs = list(aggs)


def make_agg_body(spec: _AggSpec, phase: str, capacity: int):
    """The sorted-segment aggregation of one batch.  phase 'update'
    (inputs = the child's columns) or 'merge' (inputs = key columns +
    buffer columns of partials).  Returns ``run(cols, num_rows) ->
    (n_groups, key ColVals, buffer ColVals)``, each plane of length
    ``capacity``."""
    nk = len(spec.groupings)

    def run(cols: Sequence[ColVal], num_rows: int):
        device = cols[0].data.device
        ctx = EvalContext(cols, num_rows, capacity, device)
        pos = torch.arange(capacity, device=device)
        live = pos < num_rows
        if phase == "update":
            key_cvs = [g.emit(ctx) for g in spec.groupings]
            inputs: List[Tuple[ColVal, str]] = []
            for _, f in spec.aggs:
                cv = f.input_projection()[0].emit(ctx)
                inputs.extend((cv, op) for op in f.update_ops())
        else:
            key_cvs = list(cols[:nk])
            inputs = []
            i = nk
            for _, f in spec.aggs:
                for op in f.merge_ops():
                    inputs.append((cols[i], op))
                    i += 1

        if nk == 0:
            # one segment of every live row, even of none
            gid0 = torch.zeros_like(pos)
            return 1, (), tuple(_reduce_buffer(cv, op, gid0, capacity, live,
                                               pos < 1)
                                for cv, op in inputs)

        keys = []
        for g, cv in zip(spec.groupings, key_cvs):
            keys.extend(colval_sort_keys(cv, g.dtype, True, True))
        perm = sort_permutation(keys, live_first=live)
        live_s = live[perm]
        keys_s = [k[perm] for k in keys]

        neq_prev = torch.zeros(capacity, dtype=torch.bool, device=device)
        for ks in keys_s:
            neq_prev[1:] |= ks[1:] != ks[:-1]
        boundary = neq_prev & live_s
        boundary[0] = live_s[0]
        gid = (torch.cumsum(boundary.to(torch.int64), 0) - 1) \
            .clamp(0, capacity - 1)
        n_groups = int(boundary.sum())

        group_valid = pos < n_groups
        bufs = [_reduce_buffer(ColVal(cv.data[perm], cv.validity[perm],
                                      None if cv.chars is None
                                      else cv.chars[perm]),
                               op, gid, capacity, live_s, group_valid)
                for cv, op in inputs]

        # representative row of each group, for the key output
        rep_sorted = _segment(
            "min", torch.where(boundary, pos, torch.full_like(pos, capacity)),
            gid, capacity)
        rep = perm[rep_sorted.clamp(0, capacity - 1)]
        key_outs = tuple(ColVal(cv.data[rep], cv.validity[rep] & group_valid,
                                None if cv.chars is None else cv.chars[rep])
                         for cv in key_cvs)
        return n_groups, key_outs, tuple(bufs)

    return run


def _end_rows(mask: torch.Tensor, gid: torch.Tensor, cap: int,
              first: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per segment, the first (or last) position where ``mask`` holds ->
    (positions, found)."""
    pos = torch.arange(cap, device=gid.device)
    if first:
        best = _segment("min", torch.where(mask, pos,
                                           torch.full_like(pos, cap)),
                        gid, cap)
        return best.clamp(max=cap - 1), best < cap
    best = _segment("max", torch.where(mask, pos, torch.full_like(pos, -1)),
                    gid, cap)
    return best.clamp(min=0), best >= 0


def _reduce_buffer(cv: ColVal, op: str, gid: torch.Tensor, cap: int,
                   live: torch.Tensor, group_valid: torch.Tensor) -> ColVal:
    """One buffer slot over rows sorted by group -> a ColVal of one row
    per group.  first/last take the first/last (valid, unless "_any")
    row of each segment in input order; string min/max the first/last
    valid row by (group, string order), nulls losing."""
    if op in ("first", "last", "first_any", "last_any"):
        keep_nulls = op.endswith("_any")
        rows, found = _end_rows(live if keep_nulls else cv.validity & live,
                                gid, cap, op.startswith("first"))
        valid = found & group_valid
        if keep_nulls:
            valid = valid & cv.validity[rows]
    elif cv.chars is not None and op in ("min", "max"):
        mask = cv.validity & live
        perm = sort_permutation(
            [gid] + colval_sort_keys(cv, STRING, True, op == "max"),
            live_first=mask)
        at, found = _end_rows(mask[perm], gid[perm], cap, op == "min")
        rows, valid = perm[at], found & group_valid
    else:
        return ColVal(_segment_reduce(op, cv.data, cv.validity, gid, cap,
                                      live), group_valid)
    return ColVal(cv.data[rows], valid, None if cv.chars is None
                  else cv.chars[rows])


def evaluate(spec: _AggSpec, cols: Sequence[ColVal],
             num_rows: int) -> List[ColVal]:
    """Finalize: merged buffers -> output columns (keys + evaluated)."""
    nk = len(spec.groupings)
    live = torch.arange(cols[0].data.shape[0],
                        device=cols[0].data.device) < num_rows
    outs = list(cols[:nk])
    i = nk
    for _, f in spec.aggs:
        nbuf = len(f.buffer_dtypes())
        ev = f.evaluate(list(cols[i:i + nbuf]))
        i += nbuf
        outs.append(ColVal(ev.data, ev.validity & live, ev.chars))
    return outs


def _to_batch(cvs: Sequence[ColVal], dtypes: Sequence[DataType], n: int,
              schema=None) -> ColumnarBatch:
    cols = [DeviceColumn(dt, cv.data, cv.validity, n, cv.chars)
            for cv, dt in zip(cvs, dtypes)]
    return ColumnarBatch(cols, n, schema)


class TorchHashAggregateExec(TorchExec):
    def __init__(self, groupings: List[Expression],
                 aggregates: List[Expression], child: TorchExec):
        super().__init__()
        self.groupings = list(groupings)
        self.agg_pairs = [unwrap_aggregate(e) for e in aggregates]
        for _, f in self.agg_pairs:
            if f.child.dtype == STRING and not isinstance(
                    f, (Count, Min, Max, First)):
                raise NotImplementedError(
                    f"{type(f).__name__} over strings is not in the torch "
                    "port yet")
        self.children = [child]
        self.spec = _AggSpec(self.groupings, self.agg_pairs)
        fields = [Field(g.name, g.dtype, g.nullable) for g in self.groupings]
        fields += [Field(n, f.dtype, f.nullable) for n, f in self.agg_pairs]
        self._schema = Schema(fields)
        self._pallas_off = False

    @property
    def output_schema(self) -> Schema:
        return self._schema

    def _buffer_dtypes(self) -> List[DataType]:
        out = [g.dtype for g in self.groupings]
        for _, f in self.agg_pairs:
            out.extend(f.buffer_dtypes())
        return out

    def _run_phase(self, phase: str, batch: ColumnarBatch,
                   conf=None) -> ColumnarBatch:
        cols = colvals(batch.columns)
        if phase == "update" and conf is not None and batch.num_rows > 0:
            out = self._try_pallas_update(cols, batch, conf)
            if out is not None:
                return out
        fn = make_agg_body(self.spec, phase, batch.capacity)
        n_groups, keys, bufs = fn(cols, batch.num_rows)
        if self.groupings:  # the group count was read back
            self.metrics["hostSyncs"] += 1
        return _to_batch(list(keys) + list(bufs), self._buffer_dtypes(),
                         n_groups)

    def _try_pallas_update(self, cols, batch: ColumnarBatch, conf):
        """The dense-slot path when the single integer key's observed
        domain fits (see exec/pallas_agg.py); None -> the sorted path.
        The first batch whose domain does not fit turns the probe off for
        this exec, so a high-cardinality aggregate stops paying for it."""
        if self._pallas_off:
            return None
        if batch.capacity > pag.max_capacity(self.spec):
            return None
        if not (pag.enabled(conf) and pag.supports(self.spec)):
            self._pallas_off = True
            return None
        rng = pag.key_range(self.spec.groupings[0], cols, batch.num_rows,
                            batch.capacity)
        self.metrics["hostSyncs"] += 1
        if rng is None:
            return None
        if not pag.fits(*rng):
            self._pallas_off = True
            return None
        lo, hi = rng
        fn = pag.make_update(self.spec, batch.capacity, lo, hi)
        n_groups, keys, bufs = fn(cols, batch.num_rows, lo)
        self.metrics["hostSyncs"] += 1
        self.metrics["pallasAggBatches"] += 1
        return _to_batch(list(keys) + list(bufs), self._buffer_dtypes(),
                         n_groups)

    def execute(self, ctx: ExecContext) -> Iterator[ColumnarBatch]:
        cat = ctx.runtime.catalog
        # the update partials wait for the merge as spillable handles
        partials: List[SpillableBatch] = []
        try:
            for batch in self.children[0].execute(ctx):
                # on a device out-of-memory error: relief, then halves
                for part in with_retry(
                        lambda b: self._run_phase("update", b, ctx.conf),
                        batch, ctx, split=split_batch_half):
                    partials.append(SpillableBatch(part, cat))
            if not partials:
                if self.groupings:
                    return  # grouped aggregate of empty input -> no rows
                # a global aggregate of empty input -> its initial values
                partials.append(SpillableBatch(self._run_phase(
                    "update", empty_batch(self.children[0].output_schema,
                                          ctx.device)), cat))
        except BaseException:
            close_all(partials)
            raise
        merged_in = materialize_all(partials, ctx)
        merged = merged_in[0]
        if len(merged_in) > 1:
            merged = self._run_phase("merge", concat_batches(merged_in))
        outs = evaluate(self.spec, colvals(merged.columns), merged.num_rows)
        yield _to_batch(outs, [f.dtype for f in self._schema],
                        merged.num_rows, self._schema)
