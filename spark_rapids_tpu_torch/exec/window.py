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
  in the JAX package; counts and integer sums are exact.  The float
  prefix sum adds in an order fixed by the batch's capacity alone
  (``fixed_order_cumsum``), so a window's float results repeat bit for
  bit from run to run on the card, as they do in the JAX package;
- ``min``, ``max``, ``first`` and ``last`` over any frame, as an
  arg-select: the winning row's value is gathered, so the row chosen
  among tied values is the JAX package's, visible in the sign of a zero
  (a frame from the partition's start takes the latest tied row, the
  others the earliest).  Each row gets a unique rank in the order
  (valid, NaN rank, value, position); a frame from the partition's start
  or to its end reads a ``torch.cummin`` of (partition, rank) packed in
  one int64 (forward or reversed), a frame bounded on both sides a
  sparse table of ranks, whose depth a ROWS frame's width caps;
  ``first`` and ``last`` read the next valid row at or after the frame's
  start (the previous at or before its end);
- string-typed ``lag``, ``lead``, ``count``, ``min``, ``max``,
  ``first`` and ``last``, which the JAX package runs on its CPU engine:
  a string selects by its rank among the batch's strings, and the
  winner's char row moves with its length.

The results scatter back through the permutation, so the input rows
keep their order and gain one column per function.  The exec reads
nothing back to the host (its ``hostSyncs`` stays 0); ``window.sort``
and ``window.eval`` name its two halves in a torch.profiler trace.

The input collects through the spill catalog (``collect_spillable``),
and the window runs under ``with_retry`` without a split, since a split
would cut partitions.  Not carried over: the matmul prefix sums, the
bitonic sort, ``lax.associative_scan`` (torch has none: the scans above
take its place) and the compiled-kernel cache (TPU workarounds).
"""

from __future__ import annotations

from typing import Iterator, List, Tuple

import torch

from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.columnar.dtypes import FLOAT32, FLOAT64, \
    STRING, Field, Schema, device_dtype
from spark_rapids_tpu_torch.exec.base import ExecContext, TorchExec
from spark_rapids_tpu_torch.exec.coalesce import concat_batches
from spark_rapids_tpu_torch.exec.sortkeys import colval_sort_keys, \
    sort_permutation, string_order_keys
from spark_rapids_tpu_torch.exprs.aggregates import Average, Count, First, \
    Last, Max, Min, Sum
from spark_rapids_tpu_torch.exprs.base import ColVal, EvalContext, \
    align_chars, colvals, take
from spark_rapids_tpu_torch.exprs.windows import DenseRank, Lag, Lead, \
    Rank, RowNumber, WindowExpression, WindowFrame
from spark_rapids_tpu_torch.memory.spill import collect_spillable, \
    materialize_all
from spark_rapids_tpu_torch.utils import tracing
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


_SCAN_TILE = 1024


def fixed_order_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum of a 1-D tensor whose float adds come in an
    order fixed by the length alone: each tile of ``_SCAN_TILE`` scanned
    on its own, and the tiles' totals scanned and added after, in tile
    order.  ``torch.cumsum`` of one row on the card is CUB's decoupled
    look-back scan, whose order of adds depends on which blocks finish
    first, so two runs of a float sum differed in their last bits.
    Integers are exact in any order and keep ``torch.cumsum``."""
    if not x.is_floating_point():
        return torch.cumsum(x, 0)
    n = x.shape[0]
    t = min(_SCAN_TILE, max(1, n))
    nt = -(-n // t)
    tiles = torch.nn.functional.pad(x, (0, nt * t - n)).view(nt, t)
    # torch.cumsum along dim 1 of a 2-D tensor of two or more rows scans
    # each row in one block in a fixed order (a tensor that is one row
    # would go to CUB's single-pass scan); a zero row keeps even one tile
    # on that path
    inner = torch.cumsum(torch.cat([tiles, torch.zeros_like(tiles[:1])]),
                         dim=1)[:nt]
    totals = inner[:, -1]
    carry = torch.cumsum(torch.stack([totals, torch.zeros_like(totals)]),
                         dim=1)[0]
    carry = torch.cat([torch.zeros_like(carry[:1]), carry[:-1]])
    return (inner + carry[:, None]).reshape(-1)[:n]


def _prefix_frame_sum(contrib: torch.Tensor, lo_c: torch.Tensor,
                      hi_c: torch.Tensor, cap: int) -> torch.Tensor:
    """sum(contrib[lo_c..hi_c]) as one global inclusive prefix sum at
    hi_c minus the prefix at lo_c - 1 (frames never cross a partition,
    so the other partitions' terms cancel); float sums in a fixed order
    (``fixed_order_cumsum``)."""
    p = fixed_order_cumsum(contrib)
    hi_v = p[hi_c.clamp(0, cap - 1)]
    lo_v = torch.where(lo_c > 0, p[(lo_c - 1).clamp(0, cap - 1)],
                       torch.zeros_like(hi_v))
    return hi_v - lo_v


def _select_keys(vals: torch.Tensor, chars, dtype, for_max: bool):
    """Values -> (k1 int32, k2) selected by lexicographic min, the JAX
    package's ``_select_keys``: a float's k1 settles NaN (greatest, as in
    Spark: it loses a min and wins a max) and its k2 is the value with
    -0.0 and 0.0 made one (negated for a max); an integer's k2 is the
    value (its NOT for a max, which is safe at INT64_MIN).  A string's
    k2 is its rank among the batch's strings (``string_rank``)."""
    cap = vals.shape[0]
    if dtype in (FLOAT32, FLOAT64):
        isnan = torch.isnan(vals)
        canon = torch.where(isnan | (vals == 0), torch.zeros_like(vals),
                            vals)
        if for_max:
            return (~isnan).to(torch.int32), -canon
        return isnan.to(torch.int32), canon
    k = string_rank(chars, vals) if dtype == STRING else vals.to(torch.int64)
    return torch.zeros(cap, dtype=torch.int32, device=vals.device), \
        (~k if for_max else k)


def string_rank(chars: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Each row's dense rank (int64) among the strings of the batch, in
    byte order: equal strings share a rank."""
    keys = string_order_keys(chars, lengths)
    perm = sort_permutation(keys)
    changed = _changed([k[perm] for k in keys],
                       torch.zeros_like(perm, dtype=torch.bool))
    rank = torch.empty_like(perm)
    rank[perm] = torch.cumsum(changed.to(torch.int64), 0)
    return rank


def _unique_rank(valid_s, k1, k2, latest_first: bool
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each sorted row's place in the order (valid first, k1, k2, then
    position: earliest first, or latest first with ``latest_first``), a
    permutation of [0, cap) -> (rank, row of each rank).  The smallest
    rank in a frame is the JAX package's arg-select winner there."""
    keys = [(~valid_s).to(torch.int32), k1, k2]
    if latest_first:
        keys.append(-torch.arange(k2.shape[0], device=k2.device))
    order = sort_permutation(keys)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(order.shape[0], device=order.device)
    return rank, order


def _select_in_frame(valid_s, k1, k2, g: _Geometry, lo_c, hi_c, lower,
                     upper, cap: int, static_width: int = 0):
    """The row that wins the arg-select (lexicographic min (k1, k2) among
    valid rows) of each row's frame -> (winner, found), each frame
    shape with the JAX package's choice among ties (which shows in the
    sign of a zero): a frame from the partition's start takes the latest
    of the tied rows (its forward scan), one to the partition's end the
    earliest (the reverse scan), and a frame bounded on both sides the
    earliest (the sparse table, ``static_width`` capping its depth).
    The scans are ``torch.cummin`` over (partition, rank) packed in one
    int64, the partitions ordered so that a row's own comes first."""
    if lower is None or upper is None:
        rank, order = _unique_rank(valid_s, k1, k2, lower is None)
        if lower is None:
            packed = (cap - 1 - g.gid) * cap + rank
            best = torch.cummin(packed, 0).values
            at = hi_c.clamp(0, cap - 1)
        else:
            packed = (g.gid * cap + rank).flip(0)
            best = torch.cummin(packed, 0).values.flip(0)
            at = lo_c.clamp(0, cap - 1)
        win = order[torch.remainder(best[at], cap)]
        return win, valid_s[win]
    rank, order = _unique_rank(valid_s, k1, k2, False)
    win = order[_rmq_min(rank, lo_c, hi_c, cap, static_width)]
    return win, valid_s[win] & (hi_c >= lo_c)


def _sparse_table(vals: torch.Tensor, levels: int, cap: int
                  ) -> torch.Tensor:
    """(levels + 1, cap) int32: row l holds min(vals[i..i + 2**l - 1]),
    the last value repeated past the end.  One allocation, each level
    written in place from the one below (ranks are below the capacity,
    so int32)."""
    table = torch.empty((levels + 1, cap), dtype=torch.int32,
                        device=vals.device)
    table[0] = vals
    for lev in range(1, levels + 1):
        sh = 1 << (lev - 1)
        prev, row = table[lev - 1], table[lev]
        torch.minimum(prev[:cap - sh], prev[sh:], out=row[:cap - sh])
        torch.minimum(prev[cap - sh:], prev[-1:], out=row[cap - sh:])
    return table


def _rmq_min(vals: torch.Tensor, lo_c, hi_c, cap: int,
             max_width: int = 0) -> torch.Tensor:
    """min(vals[lo_c..hi_c]) a row from a sparse table: level l holds the
    min of each run of 2**l, and a frame of length L reads two runs of
    level floor(log2 L).  ``max_width`` > 0 (a ROWS frame's width) caps
    the levels built, as the JAX package's ``_rmq_argmin`` does: a full
    table of a 2**23-row batch would be 23 levels."""
    levels = max(1, cap.bit_length() - 1)
    if max_width > 0:
        levels = min(levels, max(1, (max_width - 1).bit_length()))
    flat = _sparse_table(vals, levels, cap).reshape(-1)
    length = (hi_c - lo_c + 1).clamp(min=1)
    # floor(log2 L), exact: L = m * 2**e with m in [0.5, 1)
    k = (torch.frexp(length.to(torch.float64)).exponent - 1).to(
        torch.int64).clamp(0, levels)
    p1 = lo_c.clamp(0, cap - 1)
    p2 = (hi_c + 1 - (1 << k)).clamp(0, cap - 1)
    return torch.minimum(flat[k * cap + p1], flat[k * cap + p2]).to(
        torch.int64)


def _eval_one(wexpr: WindowExpression, g: _Geometry, ctx: EvalContext,
              perm: torch.Tensor, cap: int) -> ColVal:
    """One window function's (data, validity, chars), in sorted order."""
    f = wexpr.func
    live = g.live
    if isinstance(f, RowNumber):
        return ColVal((g.pos - g.seg_start + 1).to(torch.int32), live)
    if isinstance(f, Rank):
        return ColVal((g.peer_start - g.seg_start + 1).to(torch.int32), live)
    if isinstance(f, DenseRank):
        first_pg = g.peer_gid[g.seg_start.clamp(0, cap - 1)]
        return ColVal((g.peer_gid - first_pg + 1).to(torch.int32), live)

    if isinstance(f, Lag):
        cv_s = take(f.child.emit(ctx), perm)
        # Lead subclasses Lag
        src = g.pos + (f.offset if isinstance(f, Lead) else -f.offset)
        inb = (src >= g.seg_start) & (src <= g.seg_end) & live
        out = take(cv_s, src.clamp(0, cap - 1))
        data, valid, chars = out.data, inb & out.validity, out.chars
        if f.has_default:
            dflt = f.default.emit(ctx)
            data = torch.where(inb, data, dflt.data.to(data.dtype))
            valid = torch.where(inb, valid, dflt.validity & live)
            if chars is not None:
                chars, dchars = align_chars(chars, dflt.chars)
                chars = torch.where(inb[:, None], chars, dchars)
        return ColVal(data.to(device_dtype(wexpr.dtype)), valid, chars)

    proj = f.input_projection()[0]
    cv_s = take(proj.emit(ctx), perm)
    vals_s, valid_s = cv_s.data, cv_s.validity & live
    fr = wexpr.frame
    lo_c, hi_c, nonempty = _frame_bounds(fr, g, cap)
    if isinstance(f, (Min, Max, First)):  # Last subclasses First
        if isinstance(f, (Min, Max)):
            # the JAX package's strategy a frame shape: the whole
            # partition and the default RANGE frame scan forward;
            # value-searched RANGE bounds take the full sparse table
            if fr.is_whole_partition or fr.is_default_range:
                lower, upper = None, 0
            elif fr.is_offset_range:
                lower, upper = -1, 1
            else:
                lower, upper = fr.lower, fr.upper
            width = 0
            if fr.kind == "rows" and fr.lower is not None and \
                    fr.upper is not None:
                width = max(1, int(fr.upper) - int(fr.lower) + 1)
            k1, k2 = _select_keys(vals_s, cv_s.chars, proj.dtype,
                                  isinstance(f, Max))
            win, found = _select_in_frame(valid_s, k1, k2, g, lo_c, hi_c,
                                          lower, upper, cap, width)
            ok = nonempty & found
        elif isinstance(f, Last):
            # the latest valid row at or before the frame's end
            prev = torch.cummax(torch.where(valid_s, g.pos,
                                            torch.full_like(g.pos, -1)),
                                0).values
            win = prev[hi_c.clamp(0, cap - 1)]
            ok = nonempty & (win >= lo_c)
        else:
            # the earliest valid row at or after the frame's start
            nxt = torch.cummin(torch.where(
                valid_s, g.pos, torch.full_like(g.pos, cap)).flip(0),
                0).values.flip(0)
            win = nxt[lo_c.clamp(0, cap - 1)]
            ok = nonempty & (win <= hi_c)
        out = take(cv_s, win.clamp(0, cap - 1))
        return ColVal(out.data.to(device_dtype(wexpr.dtype)), ok, out.chars)

    cnt = _prefix_frame_sum(valid_s.to(torch.int64), lo_c, hi_c, cap)
    if isinstance(f, Count):
        return ColVal(torch.where(nonempty, cnt, torch.zeros_like(cnt)),
                      live)
    if not isinstance(f, (Sum, Average)):
        raise NotImplementedError(
            f"window function {type(f).__name__} is not in the torch port")
    acc = torch.float64 if isinstance(f, Average) or f.dtype.is_floating \
        else torch.int64
    contrib = torch.where(valid_s, vals_s.to(acc),
                          torch.zeros((), dtype=acc, device=vals_s.device))
    s = _prefix_frame_sum(contrib, lo_c, hi_c, cap)
    ok = nonempty & (cnt > 0)
    if isinstance(f, Average):
        return ColVal(s / torch.where(ok, cnt, torch.ones_like(cnt)).to(
            s.dtype), ok)
    return ColVal(s.to(device_dtype(wexpr.dtype)), ok)


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

    def describe(self) -> str:
        fs = ", ".join(f"{w.func.name} as {n}" for n, w in self.window_cols)
        w0 = self.window_cols[0][1]
        parts = ", ".join(e.name for e in w0.partition_exprs)
        return f"TorchWindow [{fs}] partition by [{parts}]"

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
        with tracing.trace_range("window.sort"):
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
        with tracing.trace_range("window.eval"):
            for _, wexpr in self.window_cols:
                out_s = _eval_one(wexpr, g, ectx, perm, cap)
                data = torch.empty_like(out_s.data)
                data[perm] = out_s.data
                valid = torch.empty_like(out_s.validity)
                valid[perm] = out_s.validity & g.live
                chars = None
                if out_s.chars is not None:
                    chars = torch.empty_like(out_s.chars)
                    chars[perm] = out_s.chars
                cols.append(DeviceColumn(wexpr.dtype, data, valid, n, chars))
        return ColumnarBatch(cols, n, self._schema)
