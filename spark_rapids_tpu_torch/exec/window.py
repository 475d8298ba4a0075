"""Window exec.

Counterpart of ``spark_rapids_tpu/exec/window.py`` (``TpuWindowExec``).
The child is concatenated into one batch, since a partition must stay
whole.  One sort orders the rows by (live first, partition keys, order
keys), with the stable ``torch.sort`` passes of ``exec/sortkeys.py``, so
rows that tie keep their input order, as in the JAX package's stable
sort, and ``row_number`` numbers ties alike.  From the sorted keys come
the frame geometry (each row's partition and peer group, as start and
end positions broadcast to every row of the group), then every window
function of the spec:

- ``row_number``, ``rank``, ``dense_rank`` from the geometry;
- ``lag`` / ``lead`` as a gather inside the partition, with a default;
- ``count``, ``sum`` and ``avg`` over any frame (whole partition, the
  default RANGE frame, ROWS offsets, value-based RANGE offsets found by
  a per-row binary search) as the difference of one global inclusive
  prefix sum at the frame's two ends.  A float sum's rounding error is
  therefore on the scale of the prefix of |v| up to the frame's end, as
  in the JAX package; counts and integer sums are exact.

The results scatter back through the permutation, so the input rows
keep their order and gain one column per function.  The exec reads
nothing back to the host (its ``hostSyncs`` stays 0); ``window.sort``
and ``window.eval`` name its two halves in a torch.profiler trace.

The input collects through the spill catalog (``collect_spillable``),
and the window runs under ``with_retry`` without a split, since a split
would cut partitions.  Not carried over: the matmul prefix sums, the
bitonic sort and the compiled-kernel cache (TPU workarounds).  Min, max, first and last over a frame (the JAX package's
arg-select scans and sparse-table range query) are not in the port yet:
the planner raises on them.
"""

from __future__ import annotations

from typing import Iterator, List, Tuple

import torch
from torch.profiler import record_function

from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.columnar.dtypes import Field, Schema, \
    device_dtype
from spark_rapids_tpu_torch.exec.base import ExecContext, TorchExec
from spark_rapids_tpu_torch.exec.coalesce import concat_batches
from spark_rapids_tpu_torch.exec.sortkeys import colval_sort_keys, \
    sort_permutation
from spark_rapids_tpu_torch.exprs.aggregates import Average, Count, Sum
from spark_rapids_tpu_torch.exprs.base import ColVal, EvalContext, colvals
from spark_rapids_tpu_torch.exprs.windows import DenseRank, Lag, Lead, \
    Rank, RowNumber, WindowExpression, WindowFrame
from spark_rapids_tpu_torch.memory.spill import collect_spillable, \
    materialize_all
from spark_rapids_tpu_torch.utils.retry import with_retry


class _Geometry:
    """Per sorted row: its position, liveness, partition (``gid``, the
    start and end positions of its partition) and peer group (rows equal
    in every order key; ``peer_gid``, start, end), and the first order
    column's values for value-based RANGE frames."""

    __slots__ = ("pos", "live", "gid", "seg_start", "seg_end",
                 "peer_start", "peer_end", "peer_gid", "order_cv",
                 "order_asc")


def _segment_extreme(vals: torch.Tensor, ids: torch.Tensor, cap: int,
                     reduce: str, init: int) -> torch.Tensor:
    """Per-segment amax / amin of ``vals`` (segment ids in [0, cap))."""
    out = torch.full((cap,), init, dtype=vals.dtype, device=vals.device)
    return out.scatter_reduce_(0, ids, vals, reduce=reduce)


def _changed(keys_s: List[torch.Tensor], base: torch.Tensor) -> torch.Tensor:
    """``base`` or-ed with "some key differs from the row before"."""
    out = base.clone()
    for k in keys_s:
        out[1:] |= k[1:] != k[:-1]
    return out


def _build_geometry(part_keys_s: List[torch.Tensor],
                    order_keys_s: List[torch.Tensor],
                    live_s: torch.Tensor, cap: int) -> _Geometry:
    dev = live_s.device
    pos = torch.arange(cap, dtype=torch.int64, device=dev)
    first = pos == 0
    neq_part = _changed(part_keys_s, torch.zeros_like(first))
    boundary = (neq_part | first) & live_s
    gid = (torch.cumsum(boundary.to(torch.int64), 0) - 1).clamp(0, cap - 1)
    oboundary = (_changed(order_keys_s, neq_part) | first) & live_s
    pgid = (torch.cumsum(oboundary.to(torch.int64), 0) - 1) \
        .clamp(0, cap - 1)

    def broadcast(flag_pos, ids):
        return _segment_extreme(flag_pos, ids, cap, "amax", -1)[ids]

    minus = torch.full_like(pos, -1)
    g = _Geometry()
    g.pos, g.live, g.gid = pos, live_s, gid
    g.seg_start = broadcast(torch.where(boundary, pos, minus), gid)
    g.seg_end = broadcast(torch.where(live_s, pos, minus), gid)
    g.peer_start = broadcast(torch.where(oboundary, pos, minus), pgid)
    g.peer_end = broadcast(torch.where(live_s, pos, minus), pgid)
    g.peer_gid = pgid
    return g


def _bounded_search(vals: torch.Tensor, targets: torch.Tensor,
                    lo_b: torch.Tensor, hi_b: torch.Tensor,
                    side_left: bool, cap: int) -> torch.Tensor:
    """Per row, the smallest j in [lo_b, hi_b] with vals[j] >= target
    (``side_left``) or > target, else hi_b + 1.  ``vals`` ascend inside
    each row's window (one partition's run of ordinary order values)."""
    lo, hi = lo_b, hi_b + 1
    for _ in range(max(1, cap.bit_length()) + 1):
        searching = lo < hi
        mid = torch.div(lo + hi, 2, rounding_mode="floor")
        mv = vals[mid.clamp(0, cap - 1)]
        right = (mv < targets) if side_left else (mv <= targets)
        lo = torch.where(searching & right, mid + 1, lo)
        hi = torch.where(searching & ~right, mid, hi)
    return lo


def _per_segment(masked_pos: torch.Tensor, g: _Geometry, cap: int,
                 take_min: bool) -> torch.Tensor:
    """min (or max) of ``masked_pos`` over each row's partition."""
    if take_min:
        per = _segment_extreme(masked_pos, g.gid, cap, "amin", cap)
    else:
        per = _segment_extreme(masked_pos, g.gid, cap, "amax", -1)
    return per[g.gid]


def _range_offset_bounds(fr: WindowFrame, g: _Geometry, cap: int):
    """Bounds of RANGE BETWEEN x AND y over the single order column, side
    by side as Spark composes them: an unbounded side is the partition's
    edge (null and NaN rows included); a bounded side searches the
    partition's ordinary values for an ordinary row, and stops at the
    peer group's edge for a null or NaN row (NaN + x is NaN, so such a
    row's frame is its peers)."""
    cv = g.order_cv
    v = cv.data
    if v.dtype.is_floating_point:
        special = ~cv.validity | torch.isnan(v)
    else:
        special = ~cv.validity
    vv = torch.where(special, torch.zeros_like(v), v)
    if not g.order_asc:
        vv = -vv
    ok = ~special & g.live
    lo_b = _per_segment(torch.where(ok, g.pos, torch.full_like(g.pos, cap)),
                        g, cap, True).clamp(0, cap - 1)
    hi_b = _per_segment(torch.where(ok, g.pos, torch.full_like(g.pos, -1)),
                        g, cap, False).clamp(0, cap - 1)
    if fr.lower is None:
        lo_c = g.seg_start
    else:
        lo_c = _bounded_search(vv, vv + fr.lower, lo_b, hi_b, True, cap)
        lo_c = torch.where(special, g.peer_start, lo_c)
    if fr.upper is None:
        hi_c = g.seg_end
    else:
        hi_c = _bounded_search(vv, vv + fr.upper, lo_b, hi_b, False,
                               cap) - 1
        hi_c = torch.where(special, g.peer_end, hi_c)
    return lo_c, hi_c, (lo_c <= hi_c) & g.live


def _frame_bounds(fr: WindowFrame, g: _Geometry, cap: int):
    """-> (first row, last row, frame not empty) of each row's frame, in
    sorted positions, never outside its partition."""
    if fr.is_offset_range:
        return _range_offset_bounds(fr, g, cap)
    if fr.is_whole_partition:
        lo, hi = g.seg_start, g.seg_end
    elif fr.is_default_range:
        lo, hi = g.seg_start, g.peer_end
    else:  # ROWS with literal offsets
        lo = g.seg_start if fr.lower is None else g.pos + fr.lower
        hi = g.seg_end if fr.upper is None else g.pos + fr.upper
    lo_c = torch.maximum(lo, g.seg_start)
    hi_c = torch.minimum(hi, g.seg_end)
    return lo_c, hi_c, (lo_c <= hi_c) & g.live


def _prefix_frame_sum(contrib: torch.Tensor, lo_c: torch.Tensor,
                      hi_c: torch.Tensor, cap: int) -> torch.Tensor:
    """sum(contrib[lo_c..hi_c]) as one global inclusive prefix sum at
    hi_c minus the prefix at lo_c - 1 (frames never cross a partition,
    so the other partitions' terms cancel)."""
    p = torch.cumsum(contrib, 0)
    hi_v = p[hi_c.clamp(0, cap - 1)]
    lo_v = torch.where(lo_c > 0, p[(lo_c - 1).clamp(0, cap - 1)],
                       torch.zeros_like(hi_v))
    return hi_v - lo_v


def _eval_one(wexpr: WindowExpression, g: _Geometry, ctx: EvalContext,
              perm: torch.Tensor, cap: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (data, validity) of one window function, in sorted order."""
    f = wexpr.func
    live = g.live
    if isinstance(f, RowNumber):
        return (g.pos - g.seg_start + 1).to(torch.int32), live
    if isinstance(f, Rank):
        return (g.peer_start - g.seg_start + 1).to(torch.int32), live
    if isinstance(f, DenseRank):
        first_pg = g.peer_gid[g.seg_start.clamp(0, cap - 1)]
        return (g.peer_gid - first_pg + 1).to(torch.int32), live

    if isinstance(f, Lag):
        cv = f.child.emit(ctx)
        vals_s, valid_s = cv.data[perm], cv.validity[perm]
        # Lead subclasses Lag
        src = g.pos + (f.offset if isinstance(f, Lead) else -f.offset)
        inb = (src >= g.seg_start) & (src <= g.seg_end) & live
        srcc = src.clamp(0, cap - 1)
        data, valid = vals_s[srcc], inb & valid_s[srcc]
        if f.has_default:
            dflt = f.default.emit(ctx)
            data = torch.where(inb, data, dflt.data.to(data.dtype))
            valid = torch.where(inb, valid, dflt.validity & live)
        return data.to(device_dtype(wexpr.dtype)), valid

    if not isinstance(f, (Count, Sum, Average)):
        raise NotImplementedError(
            f"window function {type(f).__name__} is not in the torch port")
    cv = f.input_projection()[0].emit(ctx)
    vals_s, valid_s = cv.data[perm], cv.validity[perm] & live
    lo_c, hi_c, nonempty = _frame_bounds(wexpr.frame, g, cap)
    cnt = _prefix_frame_sum(valid_s.to(torch.int64), lo_c, hi_c, cap)
    if isinstance(f, Count):
        return torch.where(nonempty, cnt, torch.zeros_like(cnt)), live
    acc = torch.float64 if isinstance(f, Average) or f.dtype.is_floating \
        else torch.int64
    contrib = torch.where(valid_s, vals_s.to(acc),
                          torch.zeros((), dtype=acc, device=vals_s.device))
    s = _prefix_frame_sum(contrib, lo_c, hi_c, cap)
    ok = nonempty & (cnt > 0)
    if isinstance(f, Average):
        return s / torch.where(ok, cnt, torch.ones_like(cnt)).to(s.dtype), ok
    return s.to(device_dtype(wexpr.dtype)), ok


class TorchWindowExec(TorchExec):
    """Evaluates window expressions that share one (partition, order)
    spec; frames may differ.  Appends one column per expression."""

    def __init__(self, window_cols: List[Tuple[str, WindowExpression]],
                 child: TorchExec):
        super().__init__()
        if not window_cols:
            raise ValueError("a window exec needs at least one function")
        sk = window_cols[0][1].spec_key()
        if any(w.spec_key() != sk for _, w in window_cols):
            raise ValueError("the window expressions of one exec must "
                             "share their partition and order spec")
        self.window_cols = window_cols
        self.children = [child]
        fields = list(child.output_schema.fields)
        fields += [Field(n, w.dtype, w.nullable) for n, w in window_cols]
        self._schema = Schema(fields)
        self.metrics["hostSyncs"] = 0

    @property
    def output_schema(self) -> Schema:
        return self._schema

    def execute(self, ctx: ExecContext) -> Iterator[ColumnarBatch]:
        # the input collects as spillable handles, within the budget
        handles = collect_spillable(self.children[0].execute(ctx), ctx)
        if not handles:
            return
        batch = concat_batches(materialize_all(handles, ctx))
        # relief without a split: a partition must stay whole
        yield from with_retry(self._window, batch, ctx)

    def _window(self, batch: ColumnarBatch) -> ColumnarBatch:
        cap, n, dev = batch.capacity, batch.num_rows, batch.device
        ectx = EvalContext(colvals(batch.columns), n, cap, dev)
        spec = self.window_cols[0][1]
        with record_function("window.sort"):
            live = torch.arange(cap, device=dev) < n
            part_keys: List[torch.Tensor] = []
            for e in spec.partition_exprs:
                part_keys += colval_sort_keys(e.emit(ectx), e.dtype)
            order_keys: List[torch.Tensor] = []
            for e, asc, nf in spec.orders:
                order_keys += colval_sort_keys(e.emit(ectx), e.dtype, asc,
                                               nf)
            perm = sort_permutation(part_keys + order_keys, live_first=live)
            g = _build_geometry([k[perm] for k in part_keys],
                                [k[perm] for k in order_keys], live[perm],
                                cap)
            g.order_cv = None
            g.order_asc = True
            if spec.orders:
                e0, g.order_asc, _ = spec.orders[0]
                ocv = e0.emit(ectx)
                g.order_cv = ColVal(ocv.data[perm],
                                    ocv.validity[perm] & g.live)
        cols = list(batch.columns)
        with record_function("window.eval"):
            for _, wexpr in self.window_cols:
                data_s, valid_s = _eval_one(wexpr, g, ectx, perm, cap)
                data = torch.empty_like(data_s)
                data[perm] = data_s
                valid = torch.empty_like(valid_s)
                valid[perm] = valid_s & g.live
                cols.append(DeviceColumn(wexpr.dtype, data, valid, n))
        return ColumnarBatch(cols, n, self._schema)
