"""Casts.

Counterpart of ``spark_rapids_tpu/exprs/cast.py``, with Spark's non-ANSI
semantics: integral overflow wraps, float -> integral truncates toward
zero and saturates like the JVM's d2l/d2i with NaN -> null, and a string
that does not parse gives null.  Besides the numeric and boolean casts:

- DATE <-> TIMESTAMP (days <-> microseconds, floor division before
  1970), TIMESTAMP <-> numeric (seconds; a float keeps the fraction);
- integral, boolean, DATE and TIMESTAMP -> STRING, rendered into the
  char matrix on the device (``_cast_to_string``; a timestamp as
  ``yyyy-MM-dd HH:mm:ss[.ffffff]`` with the fraction's trailing zeros
  cut, UTC);
- STRING -> integral (at most 18 significant digits, as the JAX
  package), floating (the mantissa summed in f64, so a result may sit a
  few ulp from Java's parser), boolean (Spark's word lists), DATE
  (``yyyy[-[m]m[-[d]d]]`` with an optional ``' '`` or ``'T'`` tail) and
  TIMESTAMP (a date, optionally followed by ``' '`` or ``'T'`` and
  ``hh:mm:ss[.f{1,6}]``), each after trimming spaces.

The JAX package's conf gates keep their keys and defaults
(``castStringToInteger``, ``castStringToFloat`` and
``castStringToTimestamp``, which also holds string -> date, all off).
With a gate off the JAX package runs the cast on its CPU engine; the port
has none, so the planner raises ``NotImplementedError`` naming the key
(``gate_key``).  Float -> string is refused whatever the conf, as on the
JAX device, with a message naming its key (``castFloatToString``); so are
DATE <-> numeric casts, which Spark does not allow.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar.dtypes import BOOLEAN, DATE, INT64, \
    STRING, TIMESTAMP, DataType, device_dtype
from spark_rapids_tpu_torch.conf import CAST_STRING_TO_FLOAT, \
    CAST_STRING_TO_INTEGER, CAST_STRING_TO_TIMESTAMP, ConfEntry
from spark_rapids_tpu_torch.exprs.base import ColVal, EvalContext, \
    Expression, fixed

_MICROS_PER_SECOND = 1_000_000
_MICROS_PER_DAY = 86_400 * _MICROS_PER_SECOND


def _plain(dt: DataType) -> bool:
    return dt.is_numeric or dt == BOOLEAN


def _supported(frm: DataType, to: DataType) -> bool:
    if frm == to or (_plain(frm) and _plain(to)):
        return True
    if TIMESTAMP in (frm, to):
        other = to if frm == TIMESTAMP else frm
        return other == DATE or other.is_numeric or other == STRING
    if to == STRING:
        return frm.is_integral or frm == BOOLEAN or frm == DATE
    if frm == STRING:
        return to.is_numeric or to == BOOLEAN or to == DATE
    return False


def _check_supported(frm: DataType, to: DataType) -> None:
    """Raises on a cast the port lacks."""
    if not _supported(frm, to):
        if frm.is_floating and to == STRING:
            raise NotImplementedError(
                f"cast {frm.name} -> string is not on the device (gated by "
                "spark.rapids.sql.castFloatToString.enabled, and refused "
                "even with it on, as in the JAX package)")
        raise NotImplementedError(f"cast {frm.name} -> {to.name}: not in "
                                  "the torch port")


def gate_key(frm: DataType, to: DataType) -> Optional[ConfEntry]:
    """The conf entry that must be on for this cast, else None."""
    if frm == STRING and to.is_integral:
        return CAST_STRING_TO_INTEGER
    if frm == STRING and to.is_floating:
        return CAST_STRING_TO_FLOAT
    if frm == STRING and to in (DATE, TIMESTAMP):
        return CAST_STRING_TO_TIMESTAMP
    return None


def cast_to(child: Expression, target: DataType,
            implicit: bool = False) -> Expression:
    """``child`` as ``target``; raises when the plan is built on a cast the
    port lacks, so an implicit cast can never reinterpret a column.
    ``implicit``: an operator's own cast (``sum``/``avg`` of a string,
    ``/``), which no ``castStringTo*`` gate holds, as in the JAX
    package."""
    if child.dtype == target:
        return child
    _check_supported(child.dtype, target)
    return Cast(child, target, implicit)


class Cast(Expression):
    def __init__(self, child: Expression, to: DataType,
                 implicit: bool = False):
        self.children = (child,)
        self.to = to
        self.implicit = implicit

    @property
    def dtype(self) -> DataType:
        return self.to

    @property
    def nullable(self) -> bool:
        # a string that does not parse, a NaN to an integer
        return self.children[0].nullable or self.children[0].dtype in (
            STRING,) or self.children[0].dtype.is_floating

    @property
    def name(self) -> str:
        return f"cast({self.children[0].name} as {self.to.name})"

    def key(self) -> str:
        return f"cast[{self.to.name},ansi=False]({self.children[0].key()})"

    def with_children(self, children):
        return Cast(children[0], self.to, self.implicit)

    def coerce(self) -> Expression:
        _check_supported(self.children[0].dtype, self.to)
        return self

    def emit(self, ctx: EvalContext) -> ColVal:
        frm, to = self.children[0].dtype, self.to
        _check_supported(frm, to)
        src = self.children[0].emit(ctx)
        if frm == to:
            return src
        if to == STRING:
            return _cast_to_string(src, frm)
        if frm == STRING:
            if to == BOOLEAN:
                return _string_to_bool(src)
            if to == DATE:
                return _string_to_date(src)
            if to == TIMESTAMP:
                return _string_to_timestamp(src)
            if to.is_floating:
                return _string_to_float(src, to)
            return _string_to_int(src, to)
        return _cast_fixed(src, frm, to)


def _fdiv(a: torch.Tensor, b: int) -> torch.Tensor:
    return torch.div(a, b, rounding_mode="floor")


def _cast_fixed(src: ColVal, frm: DataType, to: DataType) -> ColVal:
    data, valid = src.data, src.validity
    dt = device_dtype(to)
    if to == BOOLEAN:
        out = data != 0
    elif frm == TIMESTAMP and to == DATE:
        out = _fdiv(data, _MICROS_PER_DAY).to(dt)
    elif frm == DATE and to == TIMESTAMP:
        out = data.to(torch.int64) * _MICROS_PER_DAY
    elif frm == TIMESTAMP:
        # seconds since the epoch; a float keeps the fraction.  XLA turns
        # the reference's division by a constant into a multiplication
        # by its reciprocal, so the port multiplies too
        out = (data.to(torch.float64) * (1.0 / _MICROS_PER_SECOND)).to(dt) \
            if to.is_floating else _fdiv(data, _MICROS_PER_SECOND).to(dt)
    elif to == TIMESTAMP:
        out = (data * _MICROS_PER_SECOND).to(torch.int64) \
            if frm.is_floating else data.to(torch.int64) * _MICROS_PER_SECOND
    elif frm.is_floating and to.is_integral:
        finite = torch.isfinite(data)
        valid = valid & finite
        info = np.iinfo(to.numpy_dtype)
        t = torch.trunc(torch.where(finite, data, torch.zeros_like(data)))
        t = t.to(torch.float64).clamp(float(info.min), float(info.max))
        out = t.to(dt)
        # float64 cannot hold INT64_MAX: the clamp rounds it to 2^63,
        # which the conversion would wrap; pin the boundaries
        out = torch.where(t >= float(info.max), torch.full_like(out, info.max),
                          out)
        out = torch.where(t <= float(info.min), torch.full_like(out, info.min),
                          out)
    else:
        out = data.to(dt)
    return fixed(out, valid)


# ---------------------------------------------------------------------------
# -> STRING
# ---------------------------------------------------------------------------

_DIGIT_WIDTH = 32  # INT64_MIN takes 20 characters


def _digits(v: torch.Tensor) -> ColVal:
    """int64 -> decimal text, with INT64_MIN exact: digits come from the
    non-positive magnitude, so no value overflows."""
    neg = v < 0
    mag = torch.where(neg, v, -v)  # <= 0
    digs = []
    for k in range(19):
        p = 10 ** k
        q = -_fdiv(mag + (p - 1), p)  # |v| // 10**k, from mag <= 0
        digs.append(torch.remainder(q, 10))
    digs = torch.stack(digs, dim=1)
    pos = torch.arange(19, device=v.device)[None, :]
    sig = torch.where(digs != 0, pos, torch.full_like(pos, -1))
    ndig = (sig.amax(dim=1) + 1).clamp(min=1)
    lengths = ndig + neg.to(torch.int64)
    j = torch.arange(_DIGIT_WIDTH, device=v.device)[None, :]
    didx = (lengths[:, None] - 1 - j).clamp(0, 18)
    ch = torch.gather(digs, 1, didx) + ord("0")
    ch = torch.where(neg[:, None] & (j == 0), torch.full_like(ch, ord("-")),
                     ch)
    chars = torch.where(j < lengths[:, None], ch, torch.zeros_like(ch))
    return ColVal(lengths.to(torch.int32), None, chars.to(torch.uint8))


def _ymd_chars(y, m, d) -> torch.Tensor:
    """(n,) year, month, day -> (n, 16) 'yyyy-MM-dd' and 6 zero bytes
    (years 0 to 9999 zero-padded to four digits)."""
    z = ord("0")
    y, m, d = (x.to(torch.int64) for x in (y, m, d))
    cols = [_fdiv(y, 1000) % 10, _fdiv(y, 100) % 10, _fdiv(y, 10) % 10,
            y % 10, None, _fdiv(m, 10) % 10, m % 10, None,
            _fdiv(d, 10) % 10, d % 10]
    out = [torch.full_like(y, ord("-")) if c is None else c + z
           for c in cols]
    out += [torch.zeros_like(y)] * 6
    return torch.stack(out, dim=1).to(torch.uint8)


def _format_date(src: ColVal) -> ColVal:
    from spark_rapids_tpu_torch.exprs.datetime import days_to_civil
    chars = _ymd_chars(*days_to_civil(src.data))
    return ColVal(torch.full_like(src.data, 10, dtype=torch.int32),
                  src.validity, chars)


def _format_timestamp(src: ColVal) -> ColVal:
    from spark_rapids_tpu_torch.exprs.datetime import days_to_civil, \
        timestamp_time_of_day, timestamp_to_days
    y, m, d = days_to_civil(timestamp_to_days(src.data))
    h, mi, s, micro = (x.to(torch.int64)
                       for x in timestamp_time_of_day(src.data))
    z = ord("0")

    def two(v):
        return [_fdiv(v, 10) % 10 + z, v % 10 + z]

    def const(ch):
        return torch.full_like(h, ord(ch))

    cols = ([const(" ")] + two(h) + [const(":")] + two(mi) + [const(":")]
            + two(s) + [const(".")]
            + [_fdiv(micro, 10 ** (5 - i)) % 10 + z for i in range(6)])
    chars = torch.cat([_ymd_chars(y, m, d)[:, :10],
                       torch.stack(cols, dim=1).to(torch.uint8),
                       torch.zeros((h.shape[0], 6), dtype=torch.uint8,
                                   device=h.device)], dim=1)
    # 19 characters, or 20 + the fraction's digits up to its last non-zero
    frac = torch.stack([_fdiv(micro, 10 ** k) % 10 for k in range(6)], dim=1)
    nz = frac != 0
    trailing = torch.where(nz.any(dim=1), torch.argmax(nz.to(torch.uint8),
                                                       dim=1),
                           torch.full_like(micro, 6))
    lengths = torch.where(micro == 0, torch.full_like(micro, 19),
                          26 - trailing)
    pos = torch.arange(chars.shape[1], device=h.device)[None, :]
    chars = torch.where(pos < lengths[:, None], chars, torch.zeros_like(chars))
    return ColVal(lengths.to(torch.int32), src.validity, chars)


def _cast_to_string(src: ColVal, frm: DataType) -> ColVal:
    if frm == BOOLEAN:
        dev = src.data.device
        tr = torch.tensor([116, 114, 117, 101, 0, 0, 0, 0], dtype=torch.uint8,
                          device=dev)
        fa = torch.tensor([102, 97, 108, 115, 101, 0, 0, 0],
                          dtype=torch.uint8, device=dev)
        chars = torch.where(src.data[:, None], tr[None, :], fa[None, :])
        lengths = torch.where(src.data, 4, 5).to(torch.int32)
        return ColVal(lengths, src.validity, chars)
    if frm == DATE:
        return _format_date(src)
    if frm == TIMESTAMP:
        return _format_timestamp(src)
    out = _digits(src.data.to(torch.int64))
    return ColVal(out.data, src.validity, out.chars)


# ---------------------------------------------------------------------------
# STRING ->
# ---------------------------------------------------------------------------

def _trimmed(src: ColVal):
    """-> (padded chars as int64 with spaces past each length, position
    grid, any non-space, first and last non-space positions)."""
    chars, lengths = src.chars, src.data
    w = chars.shape[1]
    pos = torch.arange(w, device=chars.device)[None, :]
    in_str = pos < lengths[:, None]
    c = torch.where(in_str, chars.to(torch.int64), torch.full_like(
        chars, 32, dtype=torch.int64))
    nonspace = in_str & (c != 32)
    has_any = nonspace.any(dim=1)
    first = torch.argmax(nonspace.to(torch.uint8), dim=1)
    last = w - 1 - torch.argmax(nonspace.flip(1).to(torch.uint8), dim=1)
    return c, pos, has_any, first, last


def _at(c: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """c[row, idx[row]], 0 outside the matrix."""
    w = c.shape[1]
    g = torch.gather(c, 1, idx.clamp(0, w - 1)[:, None])[:, 0]
    return torch.where((idx >= 0) & (idx < w), g, torch.zeros_like(g))


def _string_to_int(src: ColVal, to: DataType) -> ColVal:
    c, pos, has_any, first, last = _trimmed(src)
    sign = _at(c, first)
    neg, plus = sign == ord("-"), sign == ord("+")
    dstart = first + (neg | plus).to(torch.int64)
    in_num = (pos >= dstart[:, None]) & (pos <= last[:, None])
    is_digit = (c >= ord("0")) & (c <= ord("9"))
    n_digits = (in_num & is_digit).sum(dim=1)
    # at most 18 digits, so 10**18 bounds the place values (the JAX
    # package nulls 19-digit values too)
    ok = has_any & (~in_num | is_digit).all(dim=1) & (dstart <= last) \
        & (n_digits <= 18)
    digits = torch.where(in_num & is_digit, c - ord("0"),
                         torch.zeros_like(c))
    place = in_num.to(torch.int64)
    after = (torch.cumsum(place.flip(1), dim=1).flip(1) - place).clamp(0, 18)
    val = (digits * torch.pow(torch.full_like(after, 10), after)).sum(dim=1)
    val = torch.where(neg, -val, val)
    if to != INT64:
        info = np.iinfo(np.dtype(to.numpy_dtype))
        ok = ok & (val >= info.min) & (val <= info.max)
    return fixed(val.to(device_dtype(to)), src.validity & ok)


def _string_to_float(src: ColVal, to: DataType) -> ColVal:
    """'[+-]ddd[.ddd][eE[+-]ddd]'; anything else null."""
    c, pos, has_any, first, last = _trimmed(src)
    sign = _at(c, first)
    neg, plus = sign == ord("-"), sign == ord("+")
    start = first + (neg | plus).to(torch.int64)
    span = (pos >= start[:, None]) & (pos <= last[:, None])
    is_digit = (c >= ord("0")) & (c <= ord("9"))
    is_dot = c == ord(".")
    is_e = (c == ord("e")) | (c == ord("E"))
    e_mask = span & is_e
    has_e = e_mask.any(dim=1)
    e_pos = torch.where(has_e, torch.argmax(e_mask.to(torch.uint8), dim=1),
                        last + 1)
    mant_span = span & (pos < e_pos[:, None])
    exp_span = span & (pos > e_pos[:, None])
    dot_in_mant = mant_span & is_dot
    dot_pos = torch.where(dot_in_mant.any(dim=1),
                          torch.argmax(dot_in_mant.to(torch.uint8), dim=1),
                          e_pos)
    mant_digit = mant_span & is_digit
    mant_ok = (~mant_span | is_digit | is_dot).all(dim=1) \
        & (dot_in_mant.sum(dim=1) <= 1) & (mant_digit.sum(dim=1) >= 1)
    exp_sign = _at(c, e_pos + 1)
    exp_neg, exp_plus = exp_sign == ord("-"), exp_sign == ord("+")
    exp_digit_span = exp_span & (
        pos >= (e_pos + 1 + (exp_neg | exp_plus).to(torch.int64))[:, None])
    exp_digits = exp_digit_span & is_digit
    exp_ok = ~has_e | ((exp_digits.sum(dim=1) >= 1)
                       & (~exp_digit_span | is_digit).all(dim=1))
    ok = has_any & mant_ok & exp_ok & (start <= last)
    dig_val = torch.where(mant_digit, (c - ord("0")).to(torch.float64),
                          torch.zeros_like(c, dtype=torch.float64))
    md = mant_digit.to(torch.int64)
    after = torch.cumsum(md.flip(1), dim=1).flip(1) - md
    mant = (dig_val * torch.pow(10.0, after.to(torch.float64))).sum(dim=1)
    frac_digits = (mant_digit & (pos > dot_pos[:, None])).sum(dim=1)
    ed = exp_digits.to(torch.int64)
    edig = torch.where(exp_digits, c - ord("0"), torch.zeros_like(c))
    eafter = torch.cumsum(ed.flip(1), dim=1).flip(1) - ed
    expv = (edig * torch.pow(torch.full_like(eafter, 10),
                             eafter.clamp(0, 8))).sum(dim=1)
    expv = torch.where(exp_neg, -expv, expv)
    val = mant * torch.pow(10.0, (expv - frac_digits).to(torch.float64))
    val = torch.where(neg, -val, val)
    return fixed(val.to(device_dtype(to)), src.validity & ok)


_TRUE_STRINGS = ("true", "t", "yes", "y", "1")
_FALSE_STRINGS = ("false", "f", "no", "n", "0")


def _string_to_bool(src: ColVal) -> ColVal:
    """Spark's word lists, trimmed and case-insensitive; else null."""
    c, _, has_any, first, last = _trimmed(src)
    w = c.shape[1]
    lower = torch.where((c >= ord("A")) & (c <= ord("Z")), c + 32, c)

    def matches(word: str):
        n = len(word)
        if n > w:
            return torch.zeros_like(has_any)
        tgt = torch.tensor(list(word.encode()), dtype=torch.int64,
                           device=c.device)
        idx = (first[:, None] + torch.arange(n, device=c.device)[None, :]) \
            .clamp(0, w - 1)
        got = torch.gather(lower, 1, idx)
        return ((last - first + 1) == n) & (got == tgt[None, :]).all(dim=1)

    is_true = torch.zeros_like(has_any)
    for word in _TRUE_STRINGS:
        is_true |= matches(word)
    is_false = torch.zeros_like(has_any)
    for word in _FALSE_STRINGS:
        is_false |= matches(word)
    return fixed(is_true, src.validity & has_any & (is_true | is_false))


def _digit_run(c, at, n):
    """(value, all digits) of the n characters from ``at``."""
    val = torch.zeros_like(at)
    ok = torch.ones_like(at, dtype=torch.bool)
    for i in range(n):
        ch = _at(c, at + i)
        ok = ok & (ch >= ord("0")) & (ch <= ord("9"))
        val = val * 10 + (ch - ord("0"))
    return val, ok


def _one_or_two(c, at):
    """A field of one or two digits from ``at`` -> (value, ok, next)."""
    v2, ok2 = _digit_run(c, at, 2)
    v1, ok1 = _digit_run(c, at, 1)
    return (torch.where(ok2, v2, v1), ok1,
            at + torch.where(ok2, 2, 1).to(at.dtype))


def _parse_date(c, first, last):
    """'yyyy[-[m]m[-[d]d]]' from ``first`` -> (days, ok, position after
    it); a missing month or day is 1."""
    from spark_rapids_tpu_torch.exprs.datetime import civil_to_days
    end = last + 1
    y, ok = _digit_run(c, first, 4)
    p = first + 4
    one = torch.ones_like(y)
    has_m = (p < end) & (_at(c, p) == ord("-"))
    m, ok_m, pm = _one_or_two(c, p + 1)
    ok = ok & (~has_m | ok_m) & ((p == end) | has_m)
    p = torch.where(has_m, pm, p)
    m = torch.where(has_m, m, one)
    has_d = has_m & (p < end) & (_at(c, p) == ord("-"))
    d, ok_d, pd = _one_or_two(c, p + 1)
    ok = ok & (~has_d | ok_d)
    p = torch.where(has_d, pd, p)
    d = torch.where(has_d, d, one)
    # what may follow: the end, or a ' ' or 'T' after a whole date
    tail = (p < end) & ~(has_d & ((_at(c, p) == ord(" "))
                                  | (_at(c, p) == ord("T"))))
    dim = torch.tensor([31, 29, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31],
                       device=c.device)[(m - 1).clamp(0, 11)]
    leap = ((y % 4 == 0) & (y % 100 != 0)) | (y % 400 == 0)
    dim = torch.where((m == 2) & ~leap, dim - 1, dim)
    ok = ok & (m >= 1) & (m <= 12) & (d >= 1) & (d <= dim)
    days = civil_to_days(y.clamp(0, 9999), m.clamp(1, 12),
                         d.clamp(1, 31)).to(torch.int64)
    return days, ok, p, has_d, tail


def _string_to_date(src: ColVal) -> ColVal:
    c, _, has_any, first, last = _trimmed(src)
    days, ok, _, _, tail = _parse_date(c, first, last)
    return fixed(days.to(torch.int32), src.validity & has_any & ok & ~tail)


def _string_to_timestamp(src: ColVal) -> ColVal:
    c, _, has_any, first, last = _trimmed(src)
    days, ok, p, has_d, _ = _parse_date(c, first, last)
    end = last + 1
    at_end = p == end
    sep = _at(c, p)
    timed = has_d & ~at_end & ((sep == ord(" ")) | (sep == ord("T")))
    q = p + 1
    h, ok_h = _digit_run(c, q, 2)
    mi, ok_mi = _digit_run(c, q + 3, 2)
    s, ok_s = _digit_run(c, q + 6, 2)
    ok_t = ok_h & ok_mi & ok_s & (_at(c, q + 2) == ord(":")) \
        & (_at(c, q + 5) == ord(":")) & (h <= 23) & (mi <= 59) & (s <= 59)
    r = q + 8
    has_frac = (r < end) & (_at(c, r) == ord("."))
    frac = torch.zeros_like(h)
    nfrac = torch.zeros_like(h)
    going = has_frac
    for i in range(6):
        ch = _at(c, r + 1 + i)
        dig = going & (r + 1 + i < end) & (ch >= ord("0")) & (ch <= ord("9"))
        frac = torch.where(dig, frac * 10 + (ch - ord("0")), frac)
        nfrac = nfrac + dig.to(nfrac.dtype)
        going = dig
    frac = frac * torch.pow(torch.full_like(nfrac, 10), 6 - nfrac)
    t_end = torch.where(has_frac, r + 1 + nfrac, r)
    ok_t = ok_t & (~has_frac | (nfrac >= 1)) & (t_end == end)
    micros = days * _MICROS_PER_DAY + torch.where(
        timed, (h * 3600 + mi * 60 + s) * _MICROS_PER_SECOND + frac,
        torch.zeros_like(h))
    good = ok & (at_end | (timed & ok_t))
    return fixed(micros, src.validity & has_any & good)
