"""Hash joins.

Counterpart of ``spark_rapids_tpu/exec/joins.py``.  The build side (the
right child) is concatenated into one batch; each stream batch (the left
child) is joined against it.  Three routes, chosen as the JAX package
chooses them from one probe of an inner join's build side
(``_Build._probe``: the longest run of equal key hashes and, for a
single integer-like key, the observed key range; one host sync; other
join types take the general route unprobed):

- **dense FK** (inner join, unique build keys, a single integer or date
  key whose observed range spans at most 2^24 values): a lookup table of
  ``bucket_capacity(span)`` int32 entries maps each key to its build row;
  a stream row's match is one gather.
- **hashed FK** (inner join, unique build keys otherwise): each stream
  row's hash is searched in the build's sorted hashes; the one candidate
  is checked for true key equality.
- **general** (duplicate build keys, or an outer, semi or anti join):
  ``torch.searchsorted`` gives each stream row its run of candidate
  build rows, one host sync reads the candidate total, and
  ``torch.repeat_interleave`` lays the candidates out as (stream row,
  build row) pairs, whose keys are checked for hash collisions before the
  pairs are compacted and gathered.  Left and full joins null-extend the
  stream rows that matched nothing; right and full joins count the
  matches of each build row across stream batches and emit the unmatched
  build rows last.

The join hash (``hash_colval``, ``hash_keys``) is bit-exact with the JAX
package's, whose partition ids depend on it.  torch has no uint64 add or
logical right shift, so splitmix64 runs on int64 with wrapping adds and
multiplies, its constants as their signed values, and masked shifts.
A double hashes the bits of its (f32 head, f32 tail) split, because that
split defines the reference's hash value.

Each output batch's row count is read back to the host (``hostSyncs``
counts every read).  Not carried over: the bitonic sort, the unrolled
binary search and matmul prefix sums (TPU workarounds), the memoized
build probe (a remote-link workaround) and the compressed code views (a
later slice).  Each stream batch's probe, on either route, runs under
``with_retry`` (``utils/retry.py``) and splits in halves when relief is
not enough.
An inner or cross join's ``condition`` (the non-equi terms of ``ON``, or
a predicate the planner pushed into the join) filters each joined batch
after the probe, as the JAX package does; the planner raises on a
condition on any other join type, since a filter after the probe cannot
null-extend the rows whose matches all fail it.

A cross join pairs every live stream row with every live build row.

**Band joins.**  When an inner join's condition holds comparisons of one
integer-like build column against stream-side expressions
(``_extract_band``: ``lo < b.x AND b.x <= hi``, a constant added to the
build column moved to the bound), the build sorts by (key hash, band
column) and the general route narrows each stream row's run of equal
hashes to the band's sub-range with two bounded binary searches, so a
many-to-many join whose band drops most equi pairs (TPCx-BB q3 and q8)
stops materializing them.  The range is conservative: rows of another
key that share the hash ride along, and the key check and the
condition's filter after the probe keep the result exact.
``joinCandidates`` counts the pairs the general and cross routes lay
out, ``bandJoinProbes`` the stream batches probed with a band.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence, Tuple

import torch
from torch.profiler import record_function

from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch, empty_batch
from spark_rapids_tpu_torch.columnar.column import DeviceColumn, \
    bucket_capacity
import numpy as np

from spark_rapids_tpu_torch.columnar.dtypes import FLOAT32, FLOAT64, \
    STRING, DataType, Field, Schema, device_dtype
from spark_rapids_tpu_torch.exec.base import ExecContext, TorchExec
from spark_rapids_tpu_torch.exec.coalesce import concat_batches
from spark_rapids_tpu_torch.exec.stage import emit_steps
from spark_rapids_tpu_torch.exprs import predicates as pr
from spark_rapids_tpu_torch.exprs.arithmetic import Add, Subtract
from spark_rapids_tpu_torch.exprs.base import BoundReference, ColVal, \
    EvalContext, Expression, Literal, colvals, take
from spark_rapids_tpu_torch.exprs.cast import Cast
from spark_rapids_tpu_torch.exprs.predicates import string_compare
from spark_rapids_tpu_torch.utils.retry import split_batch_half, with_retry

_I64_MAX = (1 << 63) - 1
_I64_MIN = -(1 << 63)
# the widest key span the dense route gives a lookup table
_DENSE_SPAN = 1 << 24
_INT_LIKE = ("byte", "short", "int", "long", "date")
_BAND_LIKE = _INT_LIKE + ("timestamp",)


def _signed(c: int) -> int:
    return c - (1 << 64) if c >= 1 << 63 else c


_GOLDEN = _signed(0x9E3779B97F4A7C15)
_MIX1 = _signed(0xBF58476D1CE4E5B9)
_MIX2 = _signed(0x94D049BB133111EB)
# the one hash input every NaN maps to
_NAN_BITS = -0x7FF8000000000001


def _flush(x: torch.Tensor, signed: bool) -> torch.Tensor:
    """Subnormal floats to zero: ``signed`` keeps their sign (a rounded
    result), else +0.0 (an input, where -0.0 also becomes +0.0).  The
    JAX package computes with subnormals flushed (XLA on the CPU, and a
    TPU has none), so there a subnormal key equals zero and hashes as
    zero; the card keeps subnormals, so the port flushes them itself."""
    tiny = x.abs() < torch.finfo(x.dtype).tiny
    return torch.where(tiny, x * 0 if signed else torch.zeros_like(x), x)


def _lsr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 ``x`` (torch's ``>>`` is
    arithmetic)."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def splitmix64(x: torch.Tensor) -> torch.Tensor:
    """splitmix64's finalizer on the bits of int64 ``x``."""
    x = x + _GOLDEN
    x = (x ^ _lsr(x, 30)) * _MIX1
    x = (x ^ _lsr(x, 27)) * _MIX2
    return x ^ _lsr(x, 31)


def hash_colval(cv: ColVal, dtype: DataType) -> torch.Tensor:
    """Per-row int64 hash of one key column, the JAX package's
    ``_hash_colval`` bit for bit.  Null rows hash their data; the join's
    validity mask excludes them."""
    if dtype == STRING:
        lens = cv.data.to(torch.int64)
        rows, w = cv.chars.shape
        inside = torch.arange(w, device=lens.device)[None, :] < lens[:, None]
        chars = torch.where(inside, cv.chars, torch.zeros_like(cv.chars))
        if w % 8:
            chars = torch.nn.functional.pad(chars, (0, 8 - w % 8))
        # 8-byte blocks read big-endian: reversed bytes viewed as a
        # little-endian int64
        blocks = chars.reshape(rows, chars.shape[1] // 8, 8).flip(2) \
            .contiguous().view(torch.int64)[:, :, 0]
        h = splitmix64(lens)  # seeded with the length
        # only the blocks the length reaches mix in, so the same value
        # hashes equal at any char-matrix width
        for i in range(blocks.shape[1]):
            h = torch.where(lens > 8 * i, splitmix64(h ^ blocks[:, i]), h)
        return h
    if dtype in (FLOAT32, FLOAT64):
        x = cv.data
        isnan = torch.isnan(x)
        # NaN is one group, -0.0 equals 0.0, and subnormals are zero
        x = torch.where(isnan, torch.zeros_like(x), _flush(x, False))
        if dtype == FLOAT32:
            bits = x.view(torch.int32).to(torch.int64)
        else:
            hi = _flush(x.to(torch.float32), True)
            hi64 = hi.to(torch.float64)
            lo = _flush(torch.where(
                torch.isfinite(x) & torch.isfinite(hi64), x - hi64,
                torch.zeros_like(x)).to(torch.float32), True)
            bits = hi.view(torch.int32).to(torch.int64) \
                ^ (lo.view(torch.int32).to(torch.int64) << 32)
        bits = torch.where(isnan, torch.full_like(bits, _NAN_BITS), bits)
        return splitmix64(bits)
    # integers, dates and booleans sign-extend to int64
    return splitmix64(cv.data.to(torch.int64))


def hash_keys(key_exprs: Sequence[Expression], ctx: EvalContext
              ) -> Tuple[torch.Tensor, torch.Tensor, List[ColVal]]:
    """-> (combined int64 hash, all-keys-valid, the keys' ColVals)."""
    cvs = [e.emit(ctx) for e in key_exprs]
    acc = torch.zeros(ctx.capacity, dtype=torch.int64, device=ctx.device)
    valid = torch.ones(ctx.capacity, dtype=torch.bool, device=ctx.device)
    for e, cv in zip(key_exprs, cvs):
        acc = splitmix64(acc ^ hash_colval(cv, e.dtype))
        valid = valid & cv.validity
    return acc, valid, cvs


def keys_equal(a: ColVal, b: ColVal, dtype: DataType) -> torch.Tensor:
    """Row-wise key equality: NaN equals NaN, -0.0 and subnormals equal
    0.0, strings by their bytes."""
    if dtype == STRING:
        return string_compare(a, b) == 0
    if dtype in (FLOAT32, FLOAT64):
        an, bn = torch.isnan(a.data), torch.isnan(b.data)
        eq = _flush(a.data, False) == _flush(b.data, False)
        return (an & bn) | (~an & ~bn & eq)
    return a.data == b.data


def _verify(keep: torch.Tensor, s_cvs: Sequence[ColVal],
            b_cvs: Sequence[ColVal], s_rows: torch.Tensor,
            b_rows: torch.Tensor, dtypes: Sequence[DataType]) -> torch.Tensor:
    """``keep`` and, for each key, both sides valid and equal at the
    candidate pairs (rejects hash collisions)."""
    for s_cv, b_cv, dt in zip(s_cvs, b_cvs, dtypes):
        s, b = take(s_cv, s_rows), take(b_cv, b_rows)
        keep = keep & s.validity & b.validity & keys_equal(s, b, dt)
    return keep


class BandSpec:
    """A band over one integer-like build column: ``lower (<|<=) build``
    and ``build (<|<=) upper``, each side optional, the bounds
    stream-side expressions; a constant ``c`` added to the build column
    moves to the bound (``build + c > lo`` is ``build > lo - c``)."""

    __slots__ = ("build_ord", "lower", "lower_strict", "lower_shift",
                 "upper", "upper_strict", "upper_shift")

    def __init__(self, build_ord, lower, lower_strict, upper, upper_strict,
                 lower_shift=0, upper_shift=0):
        self.build_ord = build_ord
        self.lower, self.lower_strict = lower, lower_strict
        self.lower_shift = lower_shift
        self.upper, self.upper_strict = upper, upper_strict
        self.upper_shift = upper_shift


def _width(dt: DataType) -> int:
    return np.dtype(dt.numpy_dtype).itemsize


def extract_band(condition: Expression, n_stream: int,
                 build_fields: Sequence[Field]) -> Optional[BandSpec]:
    """The band of an inner join's condition, bound against the join's
    output (stream columns first), or None.  Only the AND-ed comparisons
    of one build column against stream-only expressions count; the
    others stay for the filter after the probe, which runs anyway."""
    terms = []

    def flatten(e):
        if isinstance(e, pr.And):
            flatten(e.children[0])
            flatten(e.children[1])
        else:
            terms.append(e)
    flatten(condition)

    def side(e) -> Optional[str]:
        refs = []

        def walk(x):
            if isinstance(x, BoundReference):
                refs.append(x.ordinal)
            for c in x.children:
                walk(c)
        walk(e)
        if all(r < n_stream for r in refs):
            return "stream"  # constants too
        if all(r >= n_stream for r in refs):
            return "build"
        return None

    def unwrap(x):
        # only value-preserving casts (integral widening); a cast that
        # changes values must keep the band away, since the probe prunes
        if isinstance(x, Cast):
            frm = x.children[0].dtype
            if frm.is_integral and x.to.is_integral and \
                    _width(x.to) >= _width(frm):
                return unwrap(x.children[0])
        return x

    def build_ref(e) -> Tuple[Optional[BoundReference], int]:
        e = unwrap(e)
        if isinstance(e, BoundReference):
            return e, 0
        if isinstance(e, (Add, Subtract)):
            a, b = (unwrap(c) for c in e.children)
            sign = 1 if isinstance(e, Add) else -1
            if isinstance(a, BoundReference) and isinstance(b, Literal) \
                    and isinstance(b.value, int):
                return a, sign * b.value
            if isinstance(e, Add) and isinstance(b, BoundReference) \
                    and isinstance(a, Literal) and isinstance(a.value, int):
                return b, a.value
        return None, 0

    ops = {pr.GreaterThan: ">", pr.GreaterThanOrEqual: ">=",
           pr.LessThan: "<", pr.LessThanOrEqual: "<="}
    build_ord = lower = upper = None
    lower_strict = upper_strict = True
    lower_shift = upper_shift = 0
    for t in terms:
        op = ops.get(type(t))
        if op is None:
            continue
        a, b = t.children
        sa, sb = side(a), side(b)
        if sa == "build" and sb == "stream":
            ref, shift = build_ref(a)
            bound, is_lower = b, op in (">", ">=")
        elif sb == "build" and sa == "stream":
            ref, shift = build_ref(b)
            bound, is_lower = a, op in ("<", "<=")
        else:
            continue
        if ref is None:
            continue
        bo = ref.ordinal - n_stream
        if build_fields[bo].dtype.name not in _BAND_LIKE or \
                bound.dtype.name not in _BAND_LIKE:
            continue
        if build_ord is None:
            build_ord = bo
        elif build_ord != bo:
            continue  # a band over a second build column: the first wins
        strict = op in (">", "<")
        if is_lower and lower is None:
            lower, lower_strict, lower_shift = bound, strict, shift
        elif not is_lower and upper is None:
            upper, upper_strict, upper_shift = bound, strict, shift
    if build_ord is None or (lower is None and upper is None):
        return None
    return BandSpec(build_ord, lower, lower_strict, upper, upper_strict,
                    lower_shift, upper_shift)


def _bounded_search(vals: torch.Tensor, targets: torch.Tensor,
                    lo: torch.Tensor, hi: torch.Tensor, strict: bool,
                    span: int) -> torch.Tensor:
    """Per row, the first j in [lo, hi) with vals[j] > target (``strict``)
    or >= target, else hi; ``vals`` ascend inside each row's range, and
    no range is longer than ``span``, which bounds the halving steps."""
    cap = vals.shape[0]
    lo, hi = lo.clone(), hi.clone()
    for _ in range(span.bit_length() + 1):
        searching = lo < hi
        mid = torch.div(lo + hi, 2, rounding_mode="floor")
        mv = vals[mid.clamp(0, cap - 1)]
        right = (mv <= targets) if strict else (mv < targets)
        lo = torch.where(searching & right, mid + 1, lo)
        hi = torch.where(searching & ~right, mid, hi)
    return lo


class _Build:
    """The build batch and what every route reads of it: the hashes of
    its keys sorted (unusable rows, null keys or padding, sentinelled to
    INT64_MAX so they sort last), the permutation that sorts them, the
    keys' ColVals, and, when ``probe`` is set, the probe's (max_run,
    key_lo, key_hi)."""

    def __init__(self, batch: ColumnarBatch, keys: Sequence[Expression],
                 probe: bool, band: Optional[BandSpec] = None):
        self.batch = batch
        cap, dev = batch.capacity, batch.device
        ctx = EvalContext(colvals(batch.columns), batch.num_rows, cap, dev)
        h, valid, self.key_cvs = hash_keys(keys, ctx)
        self.live = torch.arange(cap, device=dev) < batch.num_rows
        usable = valid & self.live
        self.sorted_band = None
        if band is None:
            h = torch.where(usable, h, torch.full_like(h, _I64_MAX))
            self.sorted_h, self.perm = torch.sort(h, stable=True)
        else:
            # sorted by (hash, band column); a row whose band value is
            # null can satisfy no band, so it sorts last with the rest
            bcol = batch.columns[band.build_ord]
            usable = usable & bcol.validity
            bv = torch.where(usable, bcol.data.to(torch.int64),
                             torch.full_like(h, _I64_MAX))
            h = torch.where(usable, h, torch.full_like(h, _I64_MAX))
            by_band = torch.sort(bv, stable=True).indices
            self.perm = by_band[torch.sort(h[by_band], stable=True).indices]
            self.sorted_h, self.sorted_band = h[self.perm], bv[self.perm]
        # only an inner join reads the probe (the FK routes)
        self.max_run, self.key_lo, self.key_hi = self._probe(
            keys, usable) if probe else (None, 0, -1)
        self._lut = None

    def _probe(self, keys, usable) -> Tuple[int, int, int]:
        """-> (longest run of one valid hash, lowest and highest valid
        key of a single integer-like key, else (0, -1)), in one host
        sync.  max_run <= 1 means every valid key is unique (a hash
        collision reads as a duplicate, which only costs the FK
        route)."""
        s = self.sorted_h
        runs = torch.searchsorted(s, s, right=True) - torch.searchsorted(s, s)
        max_run = torch.where(s == _I64_MAX, torch.zeros_like(runs),
                              runs).max()
        if len(keys) != 1 or keys[0].dtype.name not in _INT_LIKE:
            return int(max_run), 0, -1
        kd = self.key_cvs[0].data.to(torch.int64)
        lo = torch.where(usable, kd, torch.full_like(kd, _I64_MAX)).min()
        hi = torch.where(usable, kd, torch.full_like(kd, _I64_MIN)).max()
        max_run, lo, hi = torch.stack([max_run, lo, hi]).tolist()
        return max_run, lo, hi

    def dense_lut(self, dense_cap: int) -> torch.Tensor:
        """(dense_cap + 1,) int32: entry ``key - key_lo`` holds the key's
        build row, -1 where no row has the key.  Rows whose key falls
        outside the table write the last entry, which no lookup reads,
        so no index reaches past the table."""
        if self._lut is None:
            cv, cap = self.key_cvs[0], self.batch.capacity
            off = cv.data.to(torch.int64) - self.key_lo
            ok = cv.validity & self.live & (off >= 0) & (off < dense_cap)
            slot = torch.where(ok, off, torch.full_like(off, dense_cap))
            lut = torch.full((dense_cap + 1,), -1, dtype=torch.int32,
                             device=off.device)
            lut.scatter_(0, slot, torch.arange(cap, dtype=torch.int32,
                                               device=off.device))
            self._lut = lut
        return self._lut


def one_batch(child: TorchExec, ctx: ExecContext) -> ColumnarBatch:
    """``child``'s output concatenated into one device batch, or an
    empty batch of its schema when it yields none."""
    batches = list(child.execute(ctx))
    if batches:
        return concat_batches(batches)
    return empty_batch(child.output_schema, ctx.device)


def _compact(keep: torch.Tensor, out_cap: Optional[int] = None
             ) -> Tuple[torch.Tensor, int]:
    """Positions of ``keep``'s true entries in order, padded with the
    last position to ``out_cap`` (default: the bucket of their count)
    -> (positions, count); one host sync."""
    idx = torch.nonzero(keep).squeeze(1)
    n = int(idx.numel())
    if out_cap is None:
        out_cap = bucket_capacity(max(1, n))
    pos = torch.full((out_cap,), max(0, keep.shape[0] - 1),
                     dtype=torch.int64, device=keep.device)
    pos[:n] = idx
    return pos, n


def _null_columns(fields: Sequence[Field], cap: int, n: int,
                  device) -> List[DeviceColumn]:
    """All-null columns of ``fields`` (strings 8 bytes wide)."""
    cols = []
    for f in fields:
        data = torch.zeros(cap, dtype=device_dtype(f.dtype), device=device)
        chars = torch.zeros((cap, 8), dtype=torch.uint8, device=device) \
            if f.dtype == STRING else None
        cols.append(DeviceColumn(f.dtype, data, torch.zeros(
            cap, dtype=torch.bool, device=device), n, chars))
    return cols


def _side_with_nulls(batch: ColumnarBatch, mask: torch.Tensor,
                     other: Sequence[Field], schema: Schema,
                     side_first: bool) -> ColumnarBatch:
    """The rows of ``batch`` where ``mask`` holds, beside all-null
    columns of the ``other`` side's fields (none for semi and anti
    joins); one host sync."""
    pos, n = _compact(mask)
    side = batch.gather(pos, n).columns
    nulls = _null_columns(other, pos.shape[0], n, mask.device)
    cols = side + nulls if side_first else nulls + side
    return ColumnarBatch(cols, n, schema)


class TorchHashJoinExec(TorchExec):
    """Equi-join of the left child (stream) with the right child (build),
    of type inner, left, right, full, semi or anti; an inner join may
    carry a ``condition`` bound against its output columns (the planner
    refuses one on any other type)."""

    def __init__(self, left: TorchExec, right: TorchExec,
                 left_keys: List[Expression], right_keys: List[Expression],
                 join_type: str = "inner",
                 condition: Optional[Expression] = None):
        super().__init__()
        if join_type not in ("inner", "cross", "left", "right", "full",
                             "semi", "anti"):
            raise NotImplementedError(
                f"{join_type} join is not in the torch port yet")
        self.children = [left, right]
        self.left_keys = list(left_keys)
        self.right_keys = list(right_keys)
        self.join_type = join_type
        self.condition = condition
        # the route the last run took: "dense_fk", "fk", "general" or
        # "cross"
        self.route: Optional[str] = None
        self.band = None
        if join_type == "inner" and condition is not None:
            self.band = extract_band(condition,
                                     len(left.output_schema.fields),
                                     right.output_schema.fields)

    @property
    def output_schema(self) -> Schema:
        jt = self.join_type
        ls = self.children[0].output_schema
        rs = self.children[1].output_schema
        if jt in ("semi", "anti"):
            return ls
        lf, rf = list(ls.fields), list(rs.fields)  # inner and cross too
        if jt in ("right", "full"):
            lf = [Field(f.name, f.dtype, True) for f in lf]
        if jt in ("left", "full"):
            rf = [Field(f.name, f.dtype, True) for f in rf]
        return Schema(lf + rf)

    def execute(self, ctx: ExecContext) -> Iterator[ColumnarBatch]:
        yield from self._join(ctx, one_batch(self.children[1], ctx))

    def _join(self, ctx: ExecContext,
              b_batch: ColumnarBatch) -> Iterator[ColumnarBatch]:
        if self.join_type == "cross":
            yield from self._cross_join(ctx, b_batch)
            return
        inner = self.join_type == "inner"
        # the join's own work runs inside named ranges (join.build,
        # join.<route>) that a torch.profiler trace attributes time to;
        # the children's work and the consumers' stay outside them
        with record_function("join.build"):
            build = _Build(b_batch, self.right_keys, probe=inner,
                           band=self.band)
        if inner:
            self.metrics["hostSyncs"] += 1
        fk = inner and build.max_run <= 1
        span = build.key_hi - build.key_lo + 1
        dense_cap = bucket_capacity(max(8, span)) \
            if fk and 0 < span <= _DENSE_SPAN else 0
        self.route = "dense_fk" if dense_cap else "fk" if fk else "general"
        m_build = torch.zeros(build.batch.capacity, dtype=torch.int32,
                              device=build.batch.device) \
            if self.join_type in ("right", "full") else None
        for sb in self.children[0].execute(ctx):
            with record_function(f"join.{self.route}"):
                # each stream batch's probe: on a device out-of-memory
                # error, relief, then the stream batch in halves
                if fk:
                    outs = with_retry(
                        lambda b: self._fk(b, build, dense_cap), sb, ctx,
                        split=split_batch_half)
                    self.metrics["fkFastPathBatches"] += len(outs)
                else:
                    outs = []
                    for part, mb in with_retry(
                            lambda b: self._general(b, build), sb, ctx,
                            split=split_batch_half):
                        outs += part
                        if mb is not None:
                            m_build += mb
                if self.condition is not None:
                    outs = [self._keep_where(o) for o in outs if o.num_rows]
            yield from (o for o in outs if o.num_rows)
        if self.join_type in ("right", "full"):
            with record_function(f"join.{self.route}"):
                out = _side_with_nulls(
                    build.batch, build.live & (m_build == 0),
                    self.children[0].output_schema.fields,
                    self.output_schema, side_first=False)
            self.metrics["hostSyncs"] += 1
            if out.num_rows:
                yield out

    def _cross_join(self, ctx: ExecContext,
                    b_batch: ColumnarBatch) -> Iterator[ColumnarBatch]:
        """Every live stream row with every live build row, stream row
        by stream row, then the condition's filter."""
        self.route = "cross"
        nb = b_batch.num_rows
        for sb in self.children[0].execute(ctx):
            with record_function("join.cross"):
                outs = with_retry(lambda b: self._cross(b, b_batch), sb, ctx,
                                  split=split_batch_half)
                if self.condition is not None:
                    outs = [self._keep_where(o) for o in outs if o.num_rows]
            yield from (o for o in outs if o.num_rows)

    def _cross(self, sb: ColumnarBatch,
               b_batch: ColumnarBatch) -> ColumnarBatch:
        ns, nb = sb.num_rows, b_batch.num_rows
        total = ns * nb
        self.metrics["joinCandidates"] += total
        cap = bucket_capacity(max(1, total))
        k = torch.arange(cap, device=sb.device).clamp(max=max(0, total - 1))
        srow = torch.div(k, max(1, nb), rounding_mode="floor")
        brow = torch.remainder(k, max(1, nb))
        cols = sb.gather(srow, total).columns \
            + b_batch.gather(brow, total).columns
        return ColumnarBatch(cols, total, self.output_schema)

    def _keep_where(self, out: ColumnarBatch) -> ColumnarBatch:
        """The joined rows of ``out`` where the condition holds; one host
        sync."""
        cols, n = emit_steps([("filter", (self.condition,))],
                             colvals(out.columns), out.num_rows,
                             out.capacity, out.device)
        self.metrics["hostSyncs"] += 1
        return ColumnarBatch(
            [DeviceColumn(f.dtype, cv.data, cv.validity, n, cv.chars)
             for f, cv in zip(self.output_schema, cols)], n,
            self.output_schema)

    def _fk(self, sb: ColumnarBatch, build: _Build,
            dense_cap: int) -> ColumnarBatch:
        """One stream batch against unique build keys: at most one match
        a stream row, so the output keeps the stream's capacity."""
        cap, dev = sb.capacity, sb.device
        ctx = EvalContext(colvals(sb.columns), sb.num_rows, cap, dev)
        live = torch.arange(cap, device=dev) < sb.num_rows
        b_cap = build.batch.capacity
        if dense_cap:
            skey = self.left_keys[0].emit(ctx)
            off = skey.data.to(torch.int64) - build.key_lo
            ok = skey.validity & live & (off >= 0) & (off < dense_cap)
            brow = build.dense_lut(dense_cap)[
                off.clamp(0, dense_cap - 1)].to(torch.int64)
            keep = ok & (brow >= 0)
            brow = brow.clamp(0, b_cap - 1)
        else:
            h, valid, s_cvs = hash_keys(self.left_keys, ctx)
            lo = torch.searchsorted(build.sorted_h, h)
            loc = lo.clamp(max=b_cap - 1)
            present = (lo < b_cap) & (build.sorted_h[loc] == h)
            brow = build.perm[loc]
            srow = torch.arange(cap, device=dev)
            keep = _verify(present & valid & live, s_cvs, build.key_cvs,
                           srow, brow,
                           [e.dtype for e in self.left_keys])
        pos, n = _compact(keep, cap)
        self.metrics["hostSyncs"] += 1
        cols = sb.gather(pos, n).columns \
            + build.batch.gather(brow[pos], n).columns
        return ColumnarBatch(cols, n, self.output_schema)

    def _band_range(self, ctx: EvalContext, build: _Build, h, lo, hi,
                    usable):
        """Each stream row's run of equal hashes narrowed to the band's
        sub-range of build rows -> (lo, hi, usable); a null bound
        leaves the row nothing."""
        band = self.band
        self.metrics["bandJoinProbes"] += 1
        vals = build.sorted_band
        # a band join is inner, so the build's probe has read max_run,
        # the longest run of one valid hash: it bounds every run and so
        # the halving steps.  The sentinel's run also holds the unusable
        # build rows, which sort after its valid ones (band value
        # INT64_MAX), so a stream row with that hash keeps max_run rows.
        span = build.max_run
        hi = torch.where(h == _I64_MAX, torch.minimum(hi, lo + span), hi)
        start, end = lo, hi
        if band.lower is not None:
            b = band.lower.emit(ctx)
            usable = usable & b.validity
            start = _bounded_search(vals, b.data.to(torch.int64)
                                    - band.lower_shift, lo, hi,
                                    band.lower_strict, span)
        if band.upper is not None:
            b = band.upper.emit(ctx)
            usable = usable & b.validity
            end = _bounded_search(vals, b.data.to(torch.int64)
                                  - band.upper_shift, lo, hi,
                                  not band.upper_strict, span)
        return start, torch.maximum(end, start), usable

    def _general(self, sb: ColumnarBatch, build: _Build
                 ) -> Tuple[List[ColumnarBatch], Optional[torch.Tensor]]:
        """One stream batch through candidate expansion -> (output
        batches, this batch's matches of each build row for right and
        full joins)."""
        jt = self.join_type
        cap, dev = sb.capacity, sb.device
        ctx = EvalContext(colvals(sb.columns), sb.num_rows, cap, dev)
        live = torch.arange(cap, device=dev) < sb.num_rows
        h, valid, s_cvs = hash_keys(self.left_keys, ctx)
        lo = torch.searchsorted(build.sorted_h, h)
        hi = torch.searchsorted(build.sorted_h, h, right=True)
        usable = valid & live
        if build.sorted_band is not None:
            lo, hi, usable = self._band_range(ctx, build, h, lo, hi,
                                              usable)
        counts = torch.where(usable, hi - lo, torch.zeros_like(lo))
        # the candidate total sizes the expansion: the join's host sync
        total = int(counts.sum())
        self.metrics["hostSyncs"] += 1
        self.metrics["joinCandidates"] += total
        srow = torch.repeat_interleave(
            torch.arange(cap, device=dev), counts, output_size=total)
        start = torch.cumsum(counts, 0) - counts
        j = lo[srow] + torch.arange(total, device=dev) - start[srow]
        brow = build.perm[j]
        keep = _verify(torch.ones(total, dtype=torch.bool, device=dev),
                       s_cvs, build.key_cvs, srow, brow,
                       [e.dtype for e in self.left_keys])
        hits = keep.to(torch.int32)
        m_stream = torch.zeros(cap, dtype=torch.int32, device=dev) \
            .index_add_(0, srow, hits)
        outs = []
        if jt in ("inner", "left", "right", "full") and total:
            pos, n = _compact(keep, bucket_capacity(total))
            self.metrics["hostSyncs"] += 1
            cols = sb.gather(srow[pos], n).columns \
                + build.batch.gather(brow[pos], n).columns
            outs.append(ColumnarBatch(cols, n, self.output_schema))
        side = {"left": (~(m_stream > 0), True), "full": (~(m_stream > 0),
                                                          True),
                "semi": (m_stream > 0, False),
                "anti": (~(m_stream > 0), False)}.get(jt)
        if side is not None:
            mask, null_ext = side
            other = self.children[1].output_schema.fields if null_ext else []
            outs.append(_side_with_nulls(sb, mask & live, other,
                                         self.output_schema, True))
            self.metrics["hostSyncs"] += 1
        mb = None
        if jt in ("right", "full"):
            mb = torch.zeros(build.batch.capacity, dtype=torch.int32,
                             device=dev).index_add_(0, brow, hits)
        return outs, mb
