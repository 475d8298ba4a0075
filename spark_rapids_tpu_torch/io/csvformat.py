"""CSV text of device columns: pyarrow's ``CSVWriter`` bytes, made on
the device.

``format_rows`` turns a batch's columns into CSV lines with torch ops:
each column becomes a few left-aligned byte segments (a sign, digits, a
dot, ...), each with a length a row, and a row is its segments' first
``length`` bytes side by side, so the lines are the bytes of the
segments' matrix under the mask ``position < length``, row by row (one
boolean index).  The text is pyarrow's (``io/writers.py`` lists it).

A double's digits are its shortest round-trip ones, Python's ``repr``'s.
On the device, for p = 1 to 15 significant digits, the candidate
integers m - 1, m, m + 1 around the double scaled by 10^s (s = p - 1 -
its decimal exponent) are scaled back, and the first that gives the
double back exactly is its digits: with m below 2^53 and |s| at most 22
each scaling is one correctly rounded operation, and at 15 digits or
fewer no two decimals round to one double, so the first found is the
shortest, as ``repr``'s.  For a double that needs 16 or 17 digits, and
every float32, numpy prints the digits on the host
(``shortest_text_host``), the device reads them back and puts them in
place; one layout on the device prints every row.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar.dtypes import BOOLEAN, DATE, FLOAT32, \
    FLOAT64, STRING, TIMESTAMP, Schema

Seg = Tuple[torch.Tensor, torch.Tensor]

# 10^0 .. 10^22, each exact in a double
_POW10F = [float(10 ** k) for k in range(23)]
_FAST_DIGITS = 15


# ---------------------------------------------------------------------------
# on the host: the digits the device does not find
# ---------------------------------------------------------------------------

def shortest_text_host(v: np.ndarray) -> np.ndarray:
    """Floats -> numpy's text of their magnitudes, (n, 32) bytes: the
    shortest round-trip digits (Python's ``repr``'s; at most 17, 9 for
    a float32) with a dot or an exponent."""
    return np.abs(v).astype("S32").view(np.uint8).reshape(len(v), 32)


# ---------------------------------------------------------------------------
# on the device
# ---------------------------------------------------------------------------

def _text_digits(m: torch.Tensor):
    """``shortest_text_host``'s bytes of finite nonzero floats ->
    (mant, scale), int64 each, the magnitude being mant x 10^-scale."""
    n, w = m.shape
    j = torch.arange(w, device=m.device)
    ln = (m != 0).sum(1)
    is_e = m == ord("e")
    e_pos = torch.where(is_e.any(1), torch.argmax(is_e.to(torch.uint8), 1),
                        ln)
    is_dot = (m == ord(".")) & (j < e_pos[:, None])
    dot = torch.where(is_dot.any(1), torch.argmax(is_dot.to(torch.uint8), 1),
                      e_pos)
    dig = (j < e_pos[:, None]) & ~is_dot
    # a digit's place: the mantissa digits to its right
    right = e_pos[:, None] - 1 - j - ((j < dot[:, None])
                                      & (dot < e_pos)[:, None]).long()
    pw = torch.tensor([10 ** k for k in range(19)], dtype=torch.int64,
                      device=m.device)
    d = m.long() - 48
    mant = (torch.where(dig, d, 0) * pw[right.clamp(0, 18)]).sum(1)
    edig = (j > (e_pos + 1)[:, None]) & (j < ln[:, None])
    expv = (torch.where(edig, d, 0) * pw[(ln[:, None] - 1 - j).clamp(0, 3)]
            ).sum(1)
    esign = m.gather(1, (e_pos + 1).clamp(max=w - 1)[:, None]).squeeze(1)
    expv = torch.where(esign == ord("-"), -expv, expv)
    return mant, (e_pos - dot - 1).clamp(min=0) - expv


def _const(n: int, text: bytes, on, dev) -> Seg:
    chars = torch.tensor(list(text), dtype=torch.uint8,
                         device=dev).expand(n, len(text))
    return chars, on.long() * len(text)


def _left(m: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Each row's bytes from ``k`` on, at column 0."""
    w = m.shape[1]
    idx = (torch.arange(w, device=m.device) + k[:, None]).clamp_(max=w - 1)
    return m.gather(1, idx)


def _digits(v: torch.Tensor, width: int = 19):
    """Non-negative int64 -> (digit values (n, width) left-aligned, their
    count, at least 1)."""
    q = v.clone()
    cols = []
    for _ in range(width):
        cols.append(torch.remainder(q, 10))
        q = torch.div(q, 10, rounding_mode="floor")
    d = torch.stack(cols[::-1], 1)
    nz = d != 0
    nd = torch.where(nz.any(1), width - torch.argmax(nz.to(torch.uint8), 1),
                     1)
    return _left(d, width - nd), nd


def _int_segs(v: torch.Tensor) -> List[Seg]:
    v = v.long()
    neg = v < 0
    # |v| of the most negative int64 overflows: count its digits off
    # -(v + 1) and add the one back to the last digit
    low = v == torch.iinfo(torch.int64).min
    a = torch.where(neg, -(v + low.long()), v)
    d, nd = _digits(a)
    last = (nd - 1)[:, None]
    d = d.scatter_add(1, last, low.long()[:, None])
    return [_const(len(v), b"-", neg, v.device),
            ((d + 48).to(torch.uint8), nd)]


def _fixed(v: torch.Tensor, width: int) -> torch.Tensor:
    cols = []
    q = v.long()
    for _ in range(width):
        cols.append(torch.remainder(q, 10))
        q = torch.div(q, 10, rounding_mode="floor")
    return (torch.stack(cols[::-1], 1) + 48).to(torch.uint8)


def _civil(days: torch.Tensor):
    """Days since the epoch -> (year, month, day) (H. Hinnant)."""
    z = days.long() + 719468
    era = torch.div(z, 146097, rounding_mode="floor")
    doe = z - era * 146097
    yoe = torch.div(doe - torch.div(doe, 1460, rounding_mode="floor")
                    + torch.div(doe, 36524, rounding_mode="floor")
                    - torch.div(doe, 146096, rounding_mode="floor"), 365,
                    rounding_mode="floor")
    y = yoe + era * 400
    doy = doe - (365 * yoe + torch.div(yoe, 4, rounding_mode="floor")
                 - torch.div(yoe, 100, rounding_mode="floor"))
    mp = torch.div(5 * doy + 2, 153, rounding_mode="floor")
    d = doy - torch.div(153 * mp + 2, 5, rounding_mode="floor") + 1
    mo = torch.where(mp < 10, mp + 3, mp - 9)
    return y + (mo <= 2).long(), mo, d


def _char(n: int, ch: str, dev) -> torch.Tensor:
    return torch.full((n, 1), ord(ch), dtype=torch.uint8, device=dev)


def _date_chars(days: torch.Tensor) -> torch.Tensor:
    y, mo, d = _civil(days)
    n, dev = len(days), days.device
    return torch.cat([_fixed(y, 4), _char(n, "-", dev), _fixed(mo, 2),
                      _char(n, "-", dev), _fixed(d, 2)], 1)


def _timestamp_chars(us: torch.Tensor) -> torch.Tensor:
    us = us.long()
    n, dev = len(us), us.device
    days = torch.div(us, 86_400_000_000, rounding_mode="floor")
    rest = us - days * 86_400_000_000
    secs = torch.div(rest, 1_000_000, rounding_mode="floor")
    frac = rest - secs * 1_000_000
    return torch.cat([
        _date_chars(days), _char(n, " ", dev), _fixed(secs // 3600, 2),
        _char(n, ":", dev), _fixed(secs // 60 % 60, 2), _char(n, ":", dev),
        _fixed(secs % 60, 2), _char(n, ".", dev), _fixed(frac, 6),
        _char(n, "Z", dev)], 1)


def _string_segs(chars: torch.Tensor, lens: torch.Tensor) -> List[Seg]:
    """``"`` + the bytes with each ``"`` doubled + ``"``."""
    n, w = chars.shape
    dev = chars.device
    lens = lens.long()
    j = torch.arange(w, device=dev)
    inside = j < lens[:, None]
    isq = (chars == ord('"')) & inside
    q = _const(n, b'"', torch.ones(n, dtype=torch.bool, device=dev), dev)
    if not bool(isq.any()):
        return [q, (chars, lens), q]
    shift = torch.cumsum(isq, 1) - isq.long()
    out = torch.zeros((n, 2 * w), dtype=torch.uint8, device=dev)
    r = torch.arange(n, device=dev)[:, None].expand(n, w)
    pos = j + shift
    out[r[inside], pos[inside]] = chars[inside]
    out[r[isq], pos[isq] + 1] = ord('"')
    return [q, (out, lens + isq.sum(1)), q]


def _float_segs(x: torch.Tensor) -> List[Seg]:
    n, dev = len(x), x.device
    a = x.abs().double()
    fin = torch.isfinite(x)
    is_zero = fin & (a == 0)
    live = fin & ~is_zero
    found = torch.zeros(n, dtype=torch.bool, device=dev)
    mant = torch.zeros(n, dtype=torch.int64, device=dev)
    scale = torch.zeros(n, dtype=torch.int64, device=dev)
    if x.dtype == torch.float64:
        p10 = torch.tensor(_POW10F, dtype=torch.float64, device=dev)
        safe = torch.where(live, a, 1.0)
        e10 = torch.floor(torch.log10(safe)).long()
        for p in range(1, _FAST_DIGITS + 1):
            s = p - 1 - e10
            ok_s = s.abs() <= 22
            up = p10[s.clamp(0, 22)]
            down = p10[(-s).clamp(0, 22)]
            m0 = torch.round(torch.where(s >= 0, safe * up, safe / down))
            for dm in (0.0, -1.0, 1.0):
                m = m0 + dm
                back = torch.where(s >= 0, m / up, m * down)
                hit = live & ~found & ok_s & (m >= 1) \
                    & (m < float(1 << 53)) & (back == safe)
                mant = torch.where(hit, m.long(), mant)
                scale = torch.where(hit, s, scale)
                found |= hit
    rest = torch.nonzero(live & ~found).squeeze(1)
    if rest.numel():
        text = shortest_text_host(x[rest].cpu().numpy())
        mant[rest], scale[rest] = _text_digits(
            torch.from_numpy(text).to(dev))
        found[rest] = True
    # the digits, trailing zeros dropped: value = digits x 10^(point - nd)
    d, ln = _digits(mant, 17)
    nzr = (d != 0) & (torch.arange(17, device=dev) < ln[:, None])
    last = 16 - torch.argmax(nzr.flip(1).to(torch.uint8), 1)
    nd = torch.where(found, last + 1, 0)
    point = ln - scale
    exp10 = point - 1
    dec = found & (exp10 >= -6) & (exp10 < 10)
    sci = found & ~dec
    neg = torch.signbit(x) & ~torch.isnan(x) & (found | is_zero
                                                | torch.isinf(x))
    dg = (d + 48).to(torch.uint8)
    segs = [_const(n, b"-", neg, dev),
            _const(n, b"0", is_zero | (dec & (point <= 0)), dev),
            (dg, torch.where(dec, torch.minimum(point.clamp(min=0), nd),
                             sci.long()))]
    zeros = torch.full((n, 10), ord("0"), dtype=torch.uint8, device=dev)
    segs.append((zeros, torch.where(dec, (point - nd).clamp(0, 10), 0)))
    segs.append(_const(n, b".", (dec & (point < nd)) | (sci & (nd > 1)),
                       dev))
    segs.append((zeros[:, :8], torch.where(dec & (point < 0),
                                           (-point).clamp(0, 8), 0)))
    b0 = torch.where(dec, point.clamp(min=0), 1)
    segs.append((_left(dg, b0), torch.where(
        (dec & (point < nd)) | (sci & (nd > 1)), nd - b0, 0)))
    segs.append(_const(n, b"e", sci, dev))
    sign = torch.where(exp10 < 0, ord("-"), ord("+")).to(torch.uint8)
    segs.append((sign[:, None], sci.long()))
    ed, el = _digits(exp10.abs(), 3)
    segs.append(((ed + 48).to(torch.uint8), el * sci))
    segs.append(_const(n, b"nan", torch.isnan(x), dev))
    segs.append(_const(n, b"inf", torch.isinf(x), dev))
    return segs


def _column_segs(dtype, col, n: int) -> List[Seg]:
    data = col.data[:n]
    dev = data.device
    if dtype == STRING:
        segs = _string_segs(col.chars[:n], data)
    elif dtype == BOOLEAN:
        t = torch.tensor(list(b"true\0"), dtype=torch.uint8, device=dev)
        f = torch.tensor(list(b"false"), dtype=torch.uint8, device=dev)
        segs = [(torch.where(data[:, None], t, f),
                 torch.where(data, 4, 5).long())]
    elif dtype in (FLOAT64, FLOAT32):
        segs = _float_segs(data)
    elif dtype == DATE:
        segs = [(_date_chars(data), torch.full((n,), 10, device=dev))]
    elif dtype == TIMESTAMP:
        segs = [(_timestamp_chars(data), torch.full((n,), 27, device=dev))]
    else:
        segs = _int_segs(data)
    valid = col.validity[:n]
    return [(c, torch.where(valid, ln, 0)) for c, ln in segs]


def header(schema: Schema, sep: str) -> bytes:
    names = ['"' + f.name.replace('"', '""') + '"' for f in schema]
    return (sep.join(names) + "\n").encode()


def format_rows(schema: Schema, columns, n: int, sep: str = ",") -> bytes:
    """The first ``n`` rows of device columns -> their CSV lines."""
    if n == 0:
        return b""
    dev = columns[0].data.device
    on = torch.ones(n, dtype=torch.bool, device=dev)
    segs: List[Seg] = []
    for i, (f, col) in enumerate(zip(schema, columns)):
        if i:
            segs.append(_const(n, sep.encode(), on, dev))
        segs.extend(_column_segs(f.dtype, col, n))
    segs.append(_const(n, b"\n", on, dev))
    chars = torch.cat([c for c, _ in segs], 1)
    mask = torch.cat([torch.arange(c.shape[1], device=dev) < ln[:, None]
                      for c, ln in segs], 1)
    return chars[mask].cpu().numpy().tobytes()
