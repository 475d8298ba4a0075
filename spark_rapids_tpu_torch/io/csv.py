"""CSV scan, decoded on the device.

Counterpart of ``spark_rapids_tpu/io/csv.py``.  The JAX package parses
text on the host with pyarrow; the port decodes it on the card, where
RAPIDS' ``GpuCSVScan`` decodes it too (cuDF's ``Table.readCSV``).  The
host only reads each file in byte ranges that end at a line end
(``read_ranges``) and uploads each range once as a uint8 tensor, pinned,
through ``io/hostio.py: pipelined_scan`` (``device_ranges``: while
``spark.rapids.sql.io.prefetch.enabled`` is on the next range is read on
a background thread and its upload dispatched before this range is
decoded); torch ops on the device then

1. find the line ends (a value holds no newline, pyarrow's default, so
   every ``\\n`` ends a line; a ``\\r`` before it is dropped),
2. walk the lines a field at a time, all lines at once: a field ends at
   the first delimiter or line end from its start or, when it begins
   with a quote, from the quote that closes it (found from the runs of
   quote bytes, as Arrow's parser reads them); a quote anywhere else
   is a byte of the text.  This lays out each field's start and
   length, skipping empty lines (``split_fields``),
3. gather each column's fields into a (rows, width) byte matrix, and
4. convert the matrices into the port's columns (``convert_fields``):
   int64, double, boolean, date, timestamp and string, whose char matrix
   is the gathered one, a ``""`` inside quotes made one ``"``
   (``_unquote``).

The values are pyarrow's, as the JAX package reads them with its
defaults: ``NULL_VALUES`` are null in every column but a string one,
where an empty field and ``NULL`` are strings; ``TRUE_VALUES`` and
``FALSE_VALUES`` are booleans, but a column of 0 and 1 is int64 (it
infers first); ``1e400`` is inf; ``1995-03-15`` is a date and
``1995-03-15 10:00:00`` a timestamp; numbers may carry spaces around
them, an int64 no ``+``.

Doubles are correctly rounded.  A field of at most 16 significant digits
whose mantissa is below 2^53 and whose decimal exponent is at most 22
away from 0 converts on the card in one f64 multiply or divide (both
operands exact, so the one rounding is the right one); every other field
goes through one exact path, counted by the scan's
``csvSlowFloatFields``: it is read back and parsed by numpy, Python's
correctly rounded parser (``_exact_floats``).  Nothing is approximated.

The schema is inferred on the host from the first 1 MiB block of the
first file (pyarrow's ``open_csv`` block), by the same splitter and
converters on CPU tensors, in pyarrow's order: null, int64, boolean,
date, timestamp, double, string.  A column of empty fields is pyarrow's
null type, which the JAX package's ``Schema.from_arrow`` refuses with a
``TypeError``; so does the port.  A user schema applies by position and
skips the header.  A column inferred as int64 that meets a double later
raises ``CsvConversionError``, where the JAX scan raises pyarrow's
``ArrowInvalid``.  A file's batches hold
``spark.rapids.sql.reader.batchSizeRows`` rows each but the last, as the
in-memory scan cuts a table, so an aggregate over a file sums in the
same order as over the table it was written from.  While compressed
ingest is on, each batch's low-cardinality string columns are
dictionary-encoded where their char matrices already are, on the device
(``columnar/encoding.py: encode_batch_on_device``), into the dictionary
and codes the host encoder makes of the same strings.  Its numeric
columns stay plain: they are decoded on the device and never cross the
link, so a plane encoding (RLE, delta, packed) would save no byte (the
JAX package's CSV scan encodes them on the host: ROADMAP.md C).

The scan's batches, encoded and with their partition columns, go through
the device scan cache (``io/parquet.py: cached_device_scan``), keyed by
the pruned file list, the predicate, the header and the separator; a
hit counts ``scanCacheHits``, which the JAX package's CSV scan does not
(ROADMAP.md C).
"""

from __future__ import annotations

import glob as _glob
import os
import time
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar import encoding
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.column import DeviceColumn, \
    bucket_capacity
from spark_rapids_tpu_torch.columnar.dtypes import BOOLEAN, DATE, FLOAT32, \
    FLOAT64, INT8, INT16, INT32, INT64, STRING, TIMESTAMP, Field, Schema
from spark_rapids_tpu_torch.conf import COMPRESSED_MAX_DICT_FRACTION, \
    MAX_STRING_WIDTH, READER_BATCH_SIZE_ROWS
from spark_rapids_tpu_torch.exec.base import ExecContext, TorchExec
from spark_rapids_tpu_torch.utils.metrics import \
    METRIC_CSV_READ_TIME, METRIC_CSV_SLOW_FLOAT_FIELDS, \
    METRIC_NUM_FILES_READ, METRIC_NUM_FILES_TOTAL, METRIC_UPLOAD_TIME

# pyarrow.csv.ConvertOptions' defaults
NULL_VALUES = ("", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN",
               "-NaN", "-nan", "1.#IND", "1.#QNAN", "N/A", "NA", "NULL",
               "NaN", "n/a", "nan", "null")
TRUE_VALUES = ("1", "True", "TRUE", "true")
FALSE_VALUES = ("0", "False", "FALSE", "false")

# pyarrow.csv.ReadOptions' block_size: what inference reads
INFER_BLOCK_BYTES = 1 << 20
# what the host reads and uploads at once
RANGE_BYTES = 128 << 20

_NL, _CR, _QUOTE = 10, 13, 34
_POW10 = [10 ** k for k in range(19)]
# 10^0 .. 10^22: each exact in a double
_POW10F = [float(10 ** k) for k in range(23)]
_INT64_MAX_DIGITS = [int(c) for c in "9223372036854775807"]
_DAYS_BEFORE_EPOCH = 719468


class CsvParseError(ValueError):
    """A row whose field count is not the file's."""


class CsvConversionError(ValueError):
    """A value that does not convert to its column's type."""


def expand_csv_paths(path) -> List[str]:
    if isinstance(path, (list, tuple)):
        return [f for p in path for f in expand_csv_paths(p)]
    if os.path.isdir(path):
        return sorted(_glob.glob(os.path.join(path, "**", "*.csv"),
                                 recursive=True))
    if any(ch in path for ch in "*?["):
        return sorted(_glob.glob(path))
    return [path]


def read_ranges(path: str, range_bytes: Optional[int] = None,
                start: int = 0) -> Iterator[bytearray]:
    """The file's bytes from ``start`` in ranges of about ``range_bytes``,
    each ending at a line end; a last line without one gets it.  Each
    range is read straight into its own buffer (no copy of it after)."""
    size = range_bytes or RANGE_BYTES
    carry = b""
    with open(path, "rb") as f:
        f.seek(start)
        while True:
            buf = bytearray(len(carry) + size)
            buf[:len(carry)] = carry
            got = f.readinto(memoryview(buf)[len(carry):])
            end = len(carry) + got
            if not got:
                break
            cut = buf.rfind(b"\n", 0, end) + 1
            carry = bytes(buf[cut:end])
            if cut:
                del buf[cut:]
                yield buf
    if carry:
        yield bytearray(carry + b"\n")


# ---------------------------------------------------------------------------
# splitting
# ---------------------------------------------------------------------------

def _closing_quotes(isq: torch.Tensor):
    """-> a function from the positions of quotes that open fields to
    the positions of the quotes that close them (-1 where none does),
    as Arrow's parser reads them: past the opening quote, a run of
    quotes of even length is that many halves of ``""``, and the first
    run of odd length ends the quoted part with its last quote."""
    qpos = torch.nonzero(isq).squeeze(1)
    head = torch.ones_like(qpos, dtype=torch.bool)
    head[1:] = qpos[1:] != qpos[:-1] + 1
    first = torch.nonzero(head).squeeze(1)
    starts = qpos[first]
    runs = torch.diff(first, append=first.new_tensor([qpos.numel()]))
    # the runs of odd length, and the last quote of each (-1: none)
    odd = torch.nonzero(runs % 2 == 1).squeeze(1)
    last = torch.cat([(starts + runs - 1)[odd], runs.new_tensor([-1])])

    def close(opens: torch.Tensor) -> torch.Tensor:
        i = torch.searchsorted(starts, opens)
        n = runs[i]
        after = last[torch.searchsorted(odd, i + 1)]
        return torch.where(n % 2 == 0, opens + n - 1, after)
    return close


def split_fields(buf: torch.Tensor, sep: str, ncols: Optional[int] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Bytes ending at a line end -> ``(starts, lens, quoted)``, each
    (rows, ncols), one row a non-empty line.  A field that begins with a
    quote is quoted up to the quote that closes it (delimiters inside
    are text); its start is past the opening quote, and its length
    stops before the closing one unless text follows it, which
    ``_unquote`` then keeps.  A quote anywhere else is a byte of the
    text.  ``ncols`` None takes the first line's count.  Raises
    ``CsvParseError`` on a line with another count or a quote that no
    quote closes within its line.

    Each field's end is the first delimiter or line end at or after its
    start, or after its closing quote: the lines are walked a field at
    a time, all at once, over the sorted positions of those bytes."""
    dev = buf.device
    nl = buf == _NL
    ends = torch.nonzero(nl).squeeze(1)
    nlines = ends.numel()
    lstart = torch.zeros_like(ends)
    lstart[1:] = ends[:-1] + 1
    cr_end = (ends > lstart) & (buf[(ends - 1).clamp(min=0)] == _CR)
    line = torch.nonzero((ends - lstart - cr_end.long()) > 0).squeeze(1)
    if line.numel() == 0:
        e = torch.zeros((0, ncols or 0), dtype=torch.int64, device=dev)
        return e, e, e.bool()
    isq = buf == _QUOTE
    close_of = _closing_quotes(isq) if bool(isq.any()) else None
    cand = torch.nonzero(nl | (buf == ord(sep))).squeeze(1)
    lend = ends[line]
    p = lstart[line]
    k = torch.searchsorted(cand, p)
    cols = []

    def fail(bad: torch.Tensor, what: str):
        i = int(line[torch.nonzero(bad)[0, 0]])
        raise CsvParseError(f"CSV parse error: {what} (line {i + 1} of "
                            "the range)")
    while True:
        q = isq[p]
        close = torch.full_like(p, -1)
        if close_of is not None and bool(q.any()):
            at = torch.nonzero(q).squeeze(1)
            close[at] = close_of(p[at])
            shut = (close[at] >= 0) & (close[at] < lend[at])
            if not bool(shut.all()):
                fail(q.index_put((at,), ~shut), "a quote is not closed")
            k[at] = torch.searchsorted(cand, close[at] + 1)
        e = cand[k]
        done = nl[e]
        stop = e - (done & (e > p) & (buf[(e - 1).clamp(min=0)] == _CR)
                    ).long()
        cols.append((torch.where(q, p + 1, p),
                     torch.where(q, torch.where(close == stop - 1, close,
                                                stop) - p - 1, stop - p),
                     q))
        count = len(cols)
        nd = int(done.sum())
        if nd == done.numel():
            if ncols is not None and count != ncols:
                fail(done, f"expected {ncols} columns, got {count}")
            break
        if nd:
            # the first line's count is the file's when none is given
            if ncols is None and bool(done[0]):
                fail(~done, f"expected {count} columns, got more")
            want = ncols or f"more than {count}"
            fail(done, f"expected {want} columns, got {count}")
        if ncols is not None and count == ncols:
            fail(~done, f"expected {ncols} columns, got more")
        p = e + 1
        k = k + 1
    starts, lens, quoted = (torch.stack(c, 1) for c in zip(*cols))
    return starts, lens, quoted


def _gather(buf: torch.Tensor, starts: torch.Tensor, lens: torch.Tensor,
            width: int) -> torch.Tensor:
    """(rows,) fields -> (rows, width) bytes, zero past each length."""
    j = torch.arange(width, device=buf.device)
    m = buf[(starts[:, None] + j).clamp_(max=max(0, buf.numel() - 1))]
    return m.masked_fill_(j >= lens[:, None], 0)


def _trim(m: torch.Tensor, lens: torch.Tensor):
    """Drop spaces and tabs around each value (pyarrow trims them before
    it converts a number)."""
    w = m.shape[1]
    j = torch.arange(w, device=m.device)
    inside = j < lens[:, None]
    sp = ((m == 32) | (m == 9)) & inside
    solid = inside & ~sp
    lead = torch.where(solid.any(1), torch.argmax(solid.to(torch.uint8), 1),
                       lens)
    end = torch.where(solid, j + 1, 0).max(1).values
    n = (end - lead).clamp(min=0)
    out = m.gather(1, (j + lead[:, None]).clamp_(max=w - 1))
    return out.masked_fill_(j >= n[:, None], 0), n


def _matches(m: torch.Tensor, lens: torch.Tensor,
             words: Sequence[str]) -> torch.Tensor:
    """Rows whose value is one of ``words``."""
    out = torch.zeros(m.shape[0], dtype=torch.bool, device=m.device)
    for word in words:
        b = word.encode()
        if len(b) > m.shape[1]:
            continue
        hit = lens == len(b)
        if b:
            hit &= (m[:, :len(b)] == torch.tensor(
                list(b), dtype=torch.uint8, device=m.device)).all(1)
        out |= hit
    return out


# ---------------------------------------------------------------------------
# converters: (rows, width) bytes and lengths -> (values, ok)
# ---------------------------------------------------------------------------

def _digits(m: torch.Tensor) -> torch.Tensor:
    return (m >= 48) & (m <= 57)


def _place_values(m: torch.Tensor, sel: torch.Tensor,
                  right: torch.Tensor) -> torch.Tensor:
    """The integer the digits at ``sel`` form in each row, ``right``
    being each digit's place (digits to its right; at most 18 digits,
    or it wraps)."""
    pw = torch.tensor(_POW10, dtype=torch.int64, device=m.device)
    return ((m.long() - 48) * sel * pw[right.clamp(0, 18)]).sum(1)


def parse_int64(m: torch.Tensor, lens: torch.Tensor):
    w = m.shape[1]
    j = torch.arange(w, device=m.device)
    neg = m[:, 0] == ord("-")
    off = neg.long()
    body = (j >= off[:, None]) & (j < lens[:, None])
    nd = lens - off
    ok = (nd >= 1) & (nd <= 19) & (_digits(m) | ~body).all(1)
    val = _place_values(m, body, lens[:, None] - 1 - j)
    if w >= 19:
        # 19 digits: beyond int64 when above 9223372036854775807 (one
        # more for a negative value)
        lim = torch.tensor(_INT64_MAX_DIGITS, device=m.device)
        lim = lim.expand(m.shape[0], 19).clone()
        lim[:, 18] += off
        idx = (off[:, None] + torch.arange(19, device=m.device)).clamp_(
            max=w - 1)
        diff = (m.gather(1, idx).long() - 48) - lim
        first = torch.argmax((diff != 0).to(torch.uint8), 1)
        over = diff.gather(1, first[:, None]).squeeze(1) > 0
        ok &= ~((nd == 19) & over)
    return torch.where(neg, -val, val), ok


def parse_bool(m: torch.Tensor, lens: torch.Tensor):
    t = _matches(m, lens, TRUE_VALUES)
    return t, t | _matches(m, lens, FALSE_VALUES)


def _num(m: torch.Tensor, a: int, b: int) -> torch.Tensor:
    out = torch.zeros(m.shape[0], dtype=torch.int64, device=m.device)
    for k in range(a, b):
        out = out * 10 + (m[:, k].long() - 48)
    return out


def _date_part(m: torch.Tensor, lens: torch.Tensor):
    """``YYYY-MM-DD`` in the first ten bytes -> (days since the epoch,
    ok)."""
    if m.shape[1] < 10:
        z = torch.zeros(m.shape[0], dtype=torch.int64, device=m.device)
        return z, z.bool()
    d = _digits(m[:, :10])
    ok = (lens >= 10) & (m[:, 4] == ord("-")) & (m[:, 7] == ord("-")) \
        & d[:, [0, 1, 2, 3, 5, 6, 8, 9]].all(1)
    y, mo, dd = _num(m, 0, 4), _num(m, 5, 7), _num(m, 8, 10)
    leap = ((y % 4 == 0) & (y % 100 != 0)) | (y % 400 == 0)
    mdays = torch.tensor([31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31],
                         device=m.device)[(mo - 1).clamp(0, 11)]
    mdays = mdays + (leap & (mo == 2)).long()
    ok &= (mo >= 1) & (mo <= 12) & (dd >= 1) & (dd <= mdays)
    # days_from_civil (H. Hinnant)
    yy = y - (mo <= 2).long()
    era = torch.div(yy, 400, rounding_mode="floor")
    yoe = yy - era * 400
    doy = torch.div(153 * (mo + torch.where(mo > 2, -3, 9)) + 2, 5,
                    rounding_mode="floor") + dd - 1
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    return era * 146097 + doe - _DAYS_BEFORE_EPOCH, ok


def parse_date(m: torch.Tensor, lens: torch.Tensor):
    days, ok = _date_part(m, lens)
    return days.to(torch.int32), ok & (lens == 10)


def parse_timestamp(m: torch.Tensor, lens: torch.Tensor):
    """``YYYY-MM-DD[ T]HH:MM[:SS[.fraction]][Z]`` -> microseconds since
    the epoch (UTC)."""
    n, w = m.shape
    if w < 16:
        z = torch.zeros(n, dtype=torch.int64, device=m.device)
        return z, z.bool()
    days, ok = _date_part(m, lens)
    j = torch.arange(w, device=m.device)
    d = _digits(m)
    ok &= (lens >= 16) & ((m[:, 10] == 32) | (m[:, 10] == ord("T"))) \
        & d[:, [11, 12, 14, 15]].all(1) & (m[:, 13] == ord(":"))
    z = m.gather(1, (lens - 1).clamp(0, w - 1)[:, None]).squeeze(1) \
        == ord("Z")
    stop = lens - z.long()
    has_sec = (stop >= 19) & (m[:, 16] == ord(":")) if w > 18 else \
        torch.zeros(n, dtype=torch.bool, device=m.device)
    sec = _num(m, 17, 19) if w > 18 else torch.zeros_like(days)
    ok &= ~has_sec | d[:, 17:19].all(1) if w > 18 else ok
    rest = torch.where(has_sec, 19, 16)
    has_frac = (stop > rest) & (m.gather(
        1, rest.clamp(max=w - 1)[:, None]).squeeze(1) == ord("."))
    frac = (j > rest[:, None]) & (j < stop[:, None]) & has_frac[:, None]
    nfrac = frac.sum(1)
    ok &= torch.where(has_frac, (nfrac >= 1) & (nfrac <= 9)
                      & (d | ~frac).all(1), stop == rest)
    # the first six digits of the fraction, as microseconds
    rank = j - rest[:, None] - 1
    us_digit = frac & (rank < 6)
    pw = torch.tensor([10 ** (5 - k) for k in range(6)], device=m.device)
    us = ((m.long() - 48) * us_digit * pw[rank.clamp(0, 5)]).sum(1)
    hh, mi = _num(m, 11, 13), _num(m, 14, 16)
    sec = torch.where(has_sec, sec, 0)
    ok &= (hh <= 23) & (mi <= 59) & (sec <= 59)
    return ((days * 86400 + hh * 3600 + mi * 60 + sec) * 1_000_000 + us,
            ok)


_SPECIALS = ("inf", "infinity", "nan")


def parse_double(m: torch.Tensor, lens: torch.Tensor):
    """-> (values, ok, slow): ``slow`` rows are valid and off the
    one-operation path, their values here 0, left to ``_exact_floats``."""
    n, w = m.shape
    dev = m.device
    j = torch.arange(w, device=dev)
    inside = j < lens[:, None]
    s0 = m[:, 0]
    neg = s0 == ord("-")
    off = (neg | (s0 == ord("+"))).long()
    is_e = ((m == ord("e")) | (m == ord("E"))) & inside
    e_pos = torch.where(is_e.any(1), torch.argmax(is_e.to(torch.uint8), 1),
                        lens)
    mant = (j >= off[:, None]) & (j < e_pos[:, None])
    is_dot = (m == ord(".")) & mant
    dot_pos = torch.where(is_dot.any(1),
                          torch.argmax(is_dot.to(torch.uint8), 1), e_pos)
    isd = _digits(m)
    mdig = mant & ~is_dot
    ok = (isd | ~mdig).all(1) & (mdig.sum(1) >= 1) & (is_dot.sum(1) <= 1)
    has_e = e_pos < lens
    es = (e_pos + 1).clamp(max=w - 1)
    ec = m.gather(1, es[:, None]).squeeze(1)
    eneg = ec == ord("-")
    ed0 = es + (eneg | (ec == ord("+"))).long()
    edig = (j >= ed0[:, None]) & inside & has_e[:, None]
    ned = edig.sum(1)
    ok &= ~has_e | (((isd | ~edig).all(1)) & (ned >= 1))
    expv = _place_values(m, edig & (ned[:, None] <= 6),
                         lens[:, None] - 1 - j)
    expv = torch.where(eneg, -expv, expv)
    # the significant digits: first to last nonzero mantissa digit
    nz = mdig & (m != ord("0"))
    any_nz = nz.any(1)
    fz = torch.argmax(nz.to(torch.uint8), 1)
    lz = w - 1 - torch.argmax(nz.flip(1).to(torch.uint8), 1)
    sel = mdig & (j >= fz[:, None]) & (j <= lz[:, None])
    nsig = sel.sum(1)
    # a digit's place: the digits up to the last nonzero one, less the
    # dot when it lies between
    right = lz[:, None] - j - ((j < dot_pos[:, None])
                               & (dot_pos[:, None] < lz[:, None])).long()
    mint = _place_values(m, sel & (nsig[:, None] <= 16), right)
    exp10 = expv + torch.where(lz < dot_pos, dot_pos - 1 - lz, dot_pos - lz)
    fast = ~any_nz | ((nsig <= 16) & (mint < (1 << 53))
                      & (exp10.abs() <= 22))
    fast &= ned <= 6
    p = torch.tensor(_POW10F, dtype=torch.float64, device=dev)
    v = mint.to(torch.float64)
    v = torch.where(exp10 >= 0, v * p[exp10.clamp(0, 22)],
                    v / p[(-exp10).clamp(0, 22)])
    v = torch.where(any_nz & fast & ok, v, 0.0)
    v = torch.where(neg, -v, v)
    # inf, infinity, nan in any case after a sign
    low = torch.where((m >= 65) & (m <= 90), m + 32, m)
    body = low.gather(1, (off[:, None] + j).clamp_(max=w - 1))
    body = body.masked_fill_(j >= (lens - off)[:, None], 0)
    special = _matches(body, lens - off, _SPECIALS)
    return v, ok | special, (ok & ~fast) | special


def _exact_floats(m: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """The named slow path: the fields read back and parsed by numpy
    (Python's correctly rounded conversion, in C)."""
    rows = np.ascontiguousarray(m.cpu().numpy())
    text = rows.view(f"S{rows.shape[1]}").ravel()
    return torch.from_numpy(text.astype(np.float64)).to(m.device)


_PARSERS = {INT64: parse_int64, INT32: parse_int64, INT16: parse_int64,
            INT8: parse_int64, BOOLEAN: parse_bool, DATE: parse_date,
            TIMESTAMP: parse_timestamp}


# ---------------------------------------------------------------------------
# fields -> columns
# ---------------------------------------------------------------------------

def _unquote(m: torch.Tensor, lens: torch.Tensor, quoted: torch.Tensor):
    """A quoted field's text as Arrow's parser reads it: up to the quote
    that closes it (the last of the first run of odd length), each
    ``""`` becomes one ``"`` and the closing quote goes; the bytes after
    that are text as they are."""
    n, w = m.shape
    j = torch.arange(w, device=m.device)
    inside = j < lens[:, None]
    isq = (m == _QUOTE) & inside & quoted[:, None]
    rank = j - torch.cummax(torch.where(isq, -1, j), 1).values - 1
    run_end = isq.clone()
    run_end[:, :-1] &= ~isq[:, 1:]
    odd_end = run_end & (rank % 2 == 0)
    close = torch.where(odd_end.any(1),
                        torch.argmax(odd_end.to(torch.uint8), 1), w)[:, None]
    drop = isq & (j <= close) & ((rank % 2 == 1) | (j == close))
    keep = inside & ~drop
    at = keep.cumsum(1) - 1
    out = torch.zeros_like(m)
    r = torch.arange(n, device=m.device)[:, None].expand(n, w)
    out[r[keep], at[keep]] = m[keep]
    return out, keep.sum(1)


def _fields(buf: torch.Tensor, starts: torch.Tensor, lens: torch.Tensor,
            quoted: torch.Tensor, width: int):
    """One column's fields -> (rows, width) bytes of their text, and its
    lengths."""
    m = _gather(buf, starts, lens, width)
    if bool(((m == _QUOTE) & quoted[:, None]).any()):
        return _unquote(m, lens, quoted)
    return m, lens


def convert_fields(buf: torch.Tensor, starts: torch.Tensor,
                   lens: torch.Tensor, quoted: torch.Tensor, schema: Schema,
                   max_string_width: Optional[int] = None
                   ) -> Tuple[List[DeviceColumn], int]:
    """Fields (rows, len(schema)) -> (columns at the rows' bucket
    capacity, the number of double fields the slow path converted)."""
    n = starts.shape[0]
    cap = bucket_capacity(n)
    dev = buf.device
    widths = lens.max(0).values.tolist() if n else [0] * len(schema)
    cols: List[DeviceColumn] = []
    checks = []
    slow_total = 0
    for i, f in enumerate(schema):
        s, ln, q = starts[:, i], lens[:, i], quoted[:, i]
        valid = torch.zeros(cap, dtype=torch.bool, device=dev)
        if f.dtype == STRING:
            width = bucket_capacity(max(1, int(widths[i])))
            if max_string_width is not None and width > max_string_width:
                raise ValueError(
                    f"string width {width} exceeds device limit "
                    f"{max_string_width} "
                    "(spark.rapids.sql.maxDeviceStringWidth)")
            m, ln = _fields(buf, s, ln, q, width)
            chars = torch.zeros((cap, width), dtype=torch.uint8, device=dev)
            chars[:n] = m
            data = torch.zeros(cap, dtype=torch.int32, device=dev)
            data[:n] = ln
            valid[:n] = True
            cols.append(DeviceColumn(STRING, data, valid, n, chars))
            continue
        m, ln = _fields(buf, s, ln, q, max(1, int(widths[i])))
        null = _matches(m, ln, NULL_VALUES)
        tm, tl = _trim(m, ln)
        if f.dtype in (FLOAT64, FLOAT32):
            vals, ok, slow = parse_double(tm, tl)
            idx = torch.nonzero(slow & ~null).squeeze(1)
            slow_total += idx.numel()
            if idx.numel():
                vals = vals.index_put((idx,), _exact_floats(tm[idx],
                                                            tl[idx]))
            if f.dtype == FLOAT32:
                vals = vals.to(torch.float32)
        else:
            parser = _PARSERS.get(f.dtype)
            if parser is None:
                raise TypeError(f"CSV columns of type {f.dtype} are not "
                                "read")
            vals, ok = parser(tm, tl)
            if f.dtype in (INT8, INT16, INT32):
                info = np.iinfo(f.dtype.numpy_dtype)
                ok &= (vals >= int(info.min)) & (vals <= int(info.max))
                vals = vals.to(getattr(torch, np.dtype(
                    f.dtype.numpy_dtype).name))
        bad = ~ok & ~null
        checks.append((f, bad, m, ln))
        data = torch.zeros(cap, dtype=vals.dtype, device=dev)
        data[:n] = torch.where(null, torch.zeros_like(vals), vals)
        valid[:n] = ~null
        cols.append(DeviceColumn(f.dtype, data, valid, n))
    if checks:
        flags = torch.stack([b.any() for _, b, _, _ in checks]).tolist()
        for (f, bad, m, ln), hit in zip(checks, flags):
            if hit:
                r = int(torch.nonzero(bad)[0, 0])
                raw = bytes(m[r, :int(ln[r])].cpu().numpy()).decode(
                    "utf-8", "replace")
                raise CsvConversionError(
                    f"In CSV column {f.name!r}: CSV conversion error to "
                    f"{f.dtype.name}: invalid value {raw!r}")
    return cols, slow_total


# ---------------------------------------------------------------------------
# schema inference
# ---------------------------------------------------------------------------

def _infer_type(m: torch.Tensor, lens: torch.Tensor):
    null = _matches(m, lens, NULL_VALUES)
    live = ~null
    if not bool(live.any()):
        return None
    tm, tl = _trim(m, lens)
    for dt, parse in ((INT64, parse_int64), (BOOLEAN, parse_bool),
                      (DATE, parse_date), (TIMESTAMP, parse_timestamp),
                      (FLOAT64, parse_double)):
        ok = parse(tm, tl)[1]
        if dt == TIMESTAMP:
            # pyarrow infers a zoned or a naive timestamp column, never
            # one of both
            z = tm.gather(1, (tl - 1).clamp(min=0)[:, None]).squeeze(1) \
                == ord("Z")
            ok &= bool((z | ~live).all()) | bool((~z | ~live).all())
        if bool((ok | ~live).all()):
            return dt
    return STRING


def infer_file_schema(path: str, header: bool = True,
                      sep: str = ",") -> Schema:
    """The schema pyarrow infers from the file's first block."""
    with open(path, "rb") as f:
        blob = f.read(INFER_BLOCK_BYTES)
        more = bool(f.read(1))
    if more:
        blob = blob[:blob.rfind(b"\n") + 1]
    elif blob and not blob.endswith(b"\n"):
        blob += b"\n"
    buf = torch.frombuffer(bytearray(blob), dtype=torch.uint8) if blob \
        else torch.zeros(0, dtype=torch.uint8)
    starts, lens, quoted = split_fields(buf, sep)
    ncols = starts.shape[1]
    if header:
        if starts.shape[0] == 0:
            raise ValueError(f"{path}: empty CSV file")
        m, ln = _fields(buf, starts[0], lens[0], quoted[0],
                        max(1, int(lens[0].max())))
        names = [bytes(r[:n].numpy()).decode("utf-8", "replace")
                 for r, n in zip(m, ln.tolist())]
        starts, lens, quoted = starts[1:], lens[1:], quoted[1:]
    else:
        names = [f"f{i}" for i in range(ncols)]
    fields = []
    for i, name in enumerate(names):
        width = max(1, int(lens[:, i].max())) if starts.shape[0] else 1
        m, ln = _fields(buf, starts[:, i], lens[:, i], quoted[:, i], width)
        dt = _infer_type(m, ln)
        if dt is None:
            raise TypeError("unsupported arrow type null (reference type "
                            "gate GpuOverrides.scala:375-387)")
        fields.append(Field(name, dt, True))
    return Schema(fields)


def read_csv_schema(paths, header: bool = True, sep: str = ",") -> Schema:
    """The first file's inferred schema, hive partition columns after
    the file's."""
    from spark_rapids_tpu_torch.io import hivepart
    files = expand_csv_paths(paths)
    if not files:
        raise FileNotFoundError(f"no csv files at {paths!r}")
    schema = infer_file_schema(files[0], header, sep)
    return hivepart.with_partition_fields(schema, paths, files)


# ---------------------------------------------------------------------------
# the scan
# ---------------------------------------------------------------------------

class _Range:
    """One byte range on the device, and its upload's event until the
    consumer's stream waits on it."""

    __slots__ = ("buf", "ready")

    def __init__(self, buf: torch.Tensor, ready):
        self.buf = buf
        self.ready = ready


def device_ranges(path: str, device, metrics=None, start: int = 0,
                  range_bytes: Optional[int] = None,
                  ctx: Optional[ExecContext] = None) -> Iterator:
    """The file's byte ranges (``read_ranges``), each uploaded pinned
    (``transfer.Upload``) -> uint8 tensors on ``device``.  Given the
    query's ``ctx`` they go through ``io/hostio.py: pipelined_scan``:
    while ``spark.rapids.sql.io.prefetch.enabled`` is on, the next
    range's host read runs on a background thread and its upload is
    dispatched before this range is decoded.  ``csvReadTime`` counts the
    host reads, ``uploadTime`` the uploads' dispatch."""
    from spark_rapids_tpu_torch.columnar import transfer
    from spark_rapids_tpu_torch.io.hostio import pipelined_scan

    def reads():
        ranges = read_ranges(path, range_bytes, start)
        while True:
            t0 = time.perf_counter_ns()
            blob = next(ranges, None)
            if metrics is not None:
                metrics[METRIC_CSV_READ_TIME] += time.perf_counter_ns() - t0
            if blob is None:
                return
            yield blob

    def upload(blob) -> _Range:
        t0 = time.perf_counter_ns()
        up = transfer.Upload(device)
        buf = up.plane(np.frombuffer(blob, np.uint8))
        r = _Range(buf, up.finish())
        if metrics is not None:
            metrics[METRIC_UPLOAD_TIME] += time.perf_counter_ns() - t0
        return r

    if ctx is None:
        for blob in reads():
            r = upload(blob)
            transfer.await_upload(r)
            yield r.buf
        return
    for r in pipelined_scan(ctx, metrics, reads(), upload, "csv-read", len):
        yield r.buf


def decode_file(path: str, schema: Schema, header: bool, sep: str, device,
                batch_rows: int, max_string_width: Optional[int] = None,
                metrics=None, start: int = 0,
                range_bytes: Optional[int] = None,
                ctx: Optional[ExecContext] = None
                ) -> Iterator[ColumnarBatch]:
    """One file's batches of ``batch_rows`` rows, the last one fewer:
    the lines a range leaves over a whole number of batches go on the
    device in front of the next range.  ``start`` > 0 reads from that
    byte on (a grown file's new lines, no header).  The ranges come from
    ``device_ranges`` (pipelined given the query's ``ctx``)."""
    skip_header = header and start == 0
    bufs = device_ranges(path, device, metrics, start, range_bytes, ctx)
    try:
        yield from _decode_ranges(bufs, schema, skip_header, sep,
                                  batch_rows, max_string_width, metrics)
    finally:
        bufs.close()


def _decode_ranges(bufs, schema: Schema, skip_header: bool, sep: str,
                   batch_rows: int, max_string_width: Optional[int],
                   metrics) -> Iterator[ColumnarBatch]:
    carry = None
    buf = next(bufs, None)
    while buf is not None:
        after = next(bufs, None)
        if carry is not None:
            buf = torch.cat([carry, buf])
            carry = None
        starts, lens, quoted = split_fields(buf, sep, len(schema))
        if skip_header and starts.shape[0]:
            starts, lens, quoted = starts[1:], lens[1:], quoted[1:]
            skip_header = False
        n = starts.shape[0]
        whole = n if after is None else n - n % batch_rows
        if whole < n:
            # the leftover lines, from the first one's start
            at = int(starts[whole, 0] - quoted[whole, 0].long())
            carry = buf[at:]
        for r0 in range(0, whole, batch_rows):
            r1 = min(r0 + batch_rows, whole)
            cols, slow = convert_fields(buf, starts[r0:r1], lens[r0:r1],
                                        quoted[r0:r1], schema,
                                        max_string_width)
            if metrics is not None:
                metrics[METRIC_CSV_SLOW_FLOAT_FIELDS] += slow
            yield ColumnarBatch(cols, r1 - r0, schema)
        buf = after


def read_csv_relation(paths, schema: Optional[Schema], header: bool = True,
                      sep: str = ","):
    from spark_rapids_tpu_torch.plan import logical as lp
    schema = schema or read_csv_schema(paths, header, sep)
    return lp.CsvRelation(paths, schema, header=header, sep=sep)


class TorchCsvScanExec(TorchExec):
    """CSV files -> device batches, decoded on the device; hive
    partition columns appended, partitions pruned by ``pred``."""

    def __init__(self, paths, schema: Schema, header: bool = True,
                 sep: str = ",", pred=None):
        super().__init__()
        from spark_rapids_tpu_torch.io import hivepart
        self.paths = expand_csv_paths(paths)
        # kept for the host shuffle, which discovers a stripe's hive
        # values again (shuffle/stage.py: _restrict_to_split)
        self.roots = hivepart.roots_of(paths)
        self.part_schema, self.part_values = hivepart.discover(
            self.roots, self.paths)
        self._schema = schema
        self._file_schema = hivepart.file_fields(schema, self.part_schema)
        self.header = header
        self.sep = sep
        self.pred = pred
        self.children = []

    def describe(self) -> str:
        extra = f", partitioned by {self.part_schema.names}" \
            if self.part_schema else ""
        return f"TorchCsvScan [{len(self.paths)} files{extra}]"

    @property
    def output_schema(self) -> Schema:
        return self._schema

    def execute(self, ctx: ExecContext) -> Iterator[ColumnarBatch]:
        from spark_rapids_tpu_torch.io import hivepart
        from spark_rapids_tpu_torch.io.parquet import cached_device_scan, \
            scan_cache_key
        files, fvals = hivepart.prune_files(
            self.part_schema, self.part_values, self.paths, self.pred)
        if self.part_schema:
            self.metrics[METRIC_NUM_FILES_TOTAL] += len(self.paths)
            self.metrics[METRIC_NUM_FILES_READ] += len(files)
        rows = ctx.conf.get(READER_BATCH_SIZE_ROWS)
        max_w = ctx.conf.get(MAX_STRING_WIDTH)
        frac = ctx.conf.get(COMPRESSED_MAX_DICT_FRACTION)

        def gen():
            for path, vals in zip(files, fvals or [None] * len(files)):
                for b in decode_file(path, self._file_schema, self.header,
                                     self.sep, ctx.device, rows, max_w,
                                     self.metrics, ctx=ctx):
                    if encoding.ingest_enabled():
                        # the char matrices are on the device already:
                        # the dictionary and codes are made there
                        b = encoding.encode_batch_on_device(
                            b, frac, max_w, self.metrics)
                    if self.part_schema:
                        b = hivepart.append_partition_columns(
                            b, self.part_schema, vals, self._schema)
                    yield b
        # the pruned file list names the partitions the predicate kept
        key = scan_cache_key(ctx, "csv", files, self._schema, self.pred,
                             (self.header, self.sep))
        yield from cached_device_scan(ctx, key, gen, self.metrics)
