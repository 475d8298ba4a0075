"""Compressed columns: dictionary-encoded strings run in the code domain,
and integer and boolean columns carried as compressed planes.

Counterpart of ``spark_rapids_tpu/columnar/encoding.py``.  The module is
the one home of every encoding concern:

* ``EncodedColumn``: a STRING ``DeviceColumn`` whose device planes are
  int32 ``codes`` and a small shared dictionary (``DictPlanes``: a
  char matrix, lengths and validity of ``size + 1`` rows, the last one
  the null slot) instead of the ``(capacity, width)`` char matrix.  The
  dictionary is normalized: its values are unique and sorted by UTF-8
  bytes, so a code is a rank and code order is value order.
* ``decode_late``: the one counted decode (``late_decodes``).  An
  operator that knows nothing of encoding reads ``.data``/``.chars``
  off an ``EncodedColumn`` and gets the dense planes through it, so it
  stays correct.
* the plane encodings: ``RleColumn`` (run values and cumulative run
  ends), ``DeltaColumn`` (a base and int8 or int16 row deltas, for
  null-free integers) and ``PackedBoolColumn`` (8 rows a byte).  Like
  an ``EncodedColumn`` each looks like a ``DeviceColumn``: reading
  ``.data`` decodes once through ``decode_plane_late`` (counted
  ``late_decodes``); the fused stage (``stage_view``) and the
  aggregate (``plane_view``) decode in their own pass instead, counted
  ``fused_decodes``.
* ``IngestEncoder``: decides per string column whether the upload
  carries codes or the char matrix, from the port's host columns with
  numpy (or from an Arrow dictionary array a parquet scan read), per
  INT32, INT64 or BOOLEAN column which plane encoding crosses the
  fewest bytes, if any, and keeps the raw and wire byte counts.
  ``encode_on_device`` makes the same dictionary and codes from a char
  matrix already on the card (the CSV scan's).  The ``io.encode``
  fault site: an injected fault or an I/O error sends the column the
  plain way, counted in ``encode_faults`` and logged.
* the code views: ``stage_view`` rewrites a fused stage's steps so that
  a deterministic subtree over one encoded column evaluates once over
  the dictionary and becomes a gather by code (``DictGather``), a bare
  reference passes the codes through (``CodeRef``), and partition keys
  hash by per-code tables (``hash_planes``); ``agg_code_view`` and
  ``key_columns_code_view`` group by codes; ``JoinCodeView`` compares
  equi-join keys as codes (``rekey_for_join`` across disjoint
  dictionaries); ``unify_columns`` puts batches of one column onto one
  dictionary for a concat.

Everything gates on ``spark.rapids.sql.compressed.{enabled, ingest,
egress}``, the plane encodings also on ``compressed.{rle, delta,
packedBool}.enabled``; with the master key false no compressed column
is built and every view is the identity.  Every upload here (codes,
planes, a dictionary) goes through ``columnar/transfer.py: Upload``;
the result pull's raw and wire bytes are ``transfer.d2h_stats``', which
``compressed_stats`` reads, as the JAX package's does.

Where the port differs: the JAX package runs jitted kernels, so its
views also carry a flat input list and a signature for its kernel
cache; the port runs eagerly and has neither, so a view carries the
``ColVal``s themselves; for the same reason the JAX package's stage
decodes a plane column in a prepended projection of ``PlaneDecode``
expressions, which its jit fuses, where the port's decodes it as the
stage reads its inputs.  The dictionary's host copy is a char matrix
and lengths (``host_chars``, ``host_lengths``), which the result pull
indexes by code.  pyarrow is imported only inside the functions that
read an Arrow dictionary array.
"""

from __future__ import annotations

import logging
import threading
import time
import weakref
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch import faults
from spark_rapids_tpu_torch.columnar.column import DeviceColumn, \
    bucket_capacity
from spark_rapids_tpu_torch.columnar.dtypes import BOOLEAN, INT32, \
    INT64, STRING, DataType
from spark_rapids_tpu_torch.exprs.base import Alias, BoundReference, \
    ColVal, EvalContext, Expression

FAULT_SITE_ENCODE = "io.encode"

_LOG = logging.getLogger("spark_rapids_tpu_torch.io")

# ---------------------------------------------------------------------------
# process-wide switches (set from every ExecContext) and counters
# ---------------------------------------------------------------------------

_ENABLED = False
_INGEST = False
_EGRESS = False
_MAX_DICT_FRACTION = 0.5
_MAX_COMPOSED_CELLS = 65536
_RLE = False
_DELTA = False
_PACKED = False

_STATS_LOCK = threading.Lock()
_STATS = {
    # what the dense upload of the string columns would have cost, and
    # what crossed (codes, validity and each dictionary once)
    "h2d_raw_bytes": 0, "h2d_wire_bytes": 0,
    "encoded_columns": 0, "plain_columns": 0, "encode_faults": 0,
    # the plane encoding each won integer or boolean column took (the
    # string columns count under encoded_columns)
    "rle_columns": 0, "delta_columns": 0, "packed_bool_columns": 0,
    # host time of the encoder's builds (a memo hit costs none)
    "host_encode_ns": 0,
    # late: a separate decode; fused: a decode folded into a stage's
    # own gather (DictGather of a bare reference) or a plane column
    # decoded in its consumer's own pass; code_stages: stage
    # batches that ran with a column in the code domain
    "late_decodes": 0, "fused_decodes": 0, "code_stages": 0,
    # subtrees over two encoded columns kept in the code domain
    "composed_gathers": 0,
}


def set_conf(conf) -> None:
    """Install the session's switches (process-wide, as the JAX package
    does from every ``ExecContext``)."""
    from spark_rapids_tpu_torch import conf as C
    global _ENABLED, _INGEST, _EGRESS, _MAX_DICT_FRACTION
    global _MAX_COMPOSED_CELLS, _RLE, _DELTA, _PACKED
    _ENABLED = conf.get(C.COMPRESSED_ENABLED)
    _INGEST = _ENABLED and conf.get(C.COMPRESSED_INGEST)
    _EGRESS = _ENABLED and conf.get(C.COMPRESSED_EGRESS)
    _MAX_DICT_FRACTION = conf.get(C.COMPRESSED_MAX_DICT_FRACTION)
    _MAX_COMPOSED_CELLS = conf.get(C.COMPRESSED_MAX_COMPOSED_CELLS)
    _RLE = _INGEST and conf.get(C.COMPRESSED_RLE)
    _DELTA = _INGEST and conf.get(C.COMPRESSED_DELTA)
    _PACKED = _INGEST and conf.get(C.COMPRESSED_PACKED_BOOL)


def enabled() -> bool:
    return _ENABLED


def ingest_enabled() -> bool:
    return _INGEST


def egress_enabled() -> bool:
    return _EGRESS


def ingest_key() -> tuple:
    """The switches that decide how a scan's batches are encoded
    (compressed ingest, the three plane keys, ``maxDictFraction``): a
    part of the device scan cache's key, so that a session never gets
    batches encoded under another session's switches."""
    return (_INGEST, _RLE, _DELTA, _PACKED, _MAX_DICT_FRACTION)


def _bump(key: str, v: int = 1) -> None:
    if v:
        with _STATS_LOCK:
            _STATS[key] += int(v)


def compressed_stats() -> dict:
    """A snapshot of the counters, with the result pull's raw and wire
    bytes (``transfer.d2h_stats``), ``bytes_saved`` (raw less wire, both
    directions) and ``memo_host_bytes``."""
    from spark_rapids_tpu_torch.columnar import transfer
    with _STATS_LOCK:
        out = dict(_STATS)
    d2h = transfer.d2h_stats()
    out["d2h_raw_bytes"] = d2h["raw_bytes"]
    out["d2h_wire_bytes"] = d2h["wire_bytes"]
    out["bytes_saved"] = max(0, out["h2d_raw_bytes"]
                             - out["h2d_wire_bytes"]) \
        + max(0, out["d2h_raw_bytes"] - out["d2h_wire_bytes"])
    # a level, not a counter: the host bytes the local scan's memo holds
    out["memo_host_bytes"] = _MEMO_BYTES
    return out


def reset_stats() -> None:
    with _STATS_LOCK:
        for k in _STATS:
            _STATS[k] = 0


# ---------------------------------------------------------------------------
# DictPlanes: the shared dictionary
# ---------------------------------------------------------------------------

class DictPlanes:
    """One string dictionary, shared by every batch that references it.

    ``host_chars`` (capacity, width) uint8 and ``host_lengths``
    (capacity,) int32 hold the values on the host, unique and sorted by
    UTF-8 bytes (codes are ranks); row ``size`` is the null slot (zero
    bytes, length 0, invalid) that dictionary-domain evaluation maps
    null rows onto, and the rows past it are zero.  ``lengths``,
    ``chars`` and ``validity`` are the same planes on the device.
    ``aux(key, build)`` memoizes planes derived from the dictionary (a
    predicate's membership table, a hash table, a projected column), so
    a rewritten subtree evaluates over ``size + 1`` rows once."""

    __slots__ = ("host_chars", "host_lengths", "size", "capacity", "width",
                 "lengths", "chars", "validity", "fingerprint", "_aux",
                 "_aux_lock")

    _AUX_BOUND = 64

    def __init__(self, chars: np.ndarray, lengths: np.ndarray, device,
                 up=None):
        from spark_rapids_tpu_torch.columnar import transfer
        d = int(lengths.shape[0])
        self.size = d
        self.capacity = bucket_capacity(max(1, d + 1))
        self.width = bucket_capacity(max(1, int(lengths.max()) if d else 1))
        hc = np.zeros((self.capacity, self.width), np.uint8)
        w = min(self.width, chars.shape[1])
        hc[:d, :w] = chars[:, :w]
        hl = np.zeros(self.capacity, np.int32)
        hl[:d] = lengths
        self.host_chars, self.host_lengths = hc, hl
        valid = np.zeros(self.capacity, np.bool_)
        valid[:d] = True
        # through the batch's upload when one is given, else its own,
        # waited on at once
        own = up is None
        if own:
            up = transfer.Upload(device)
        self.lengths = up.plane(hl)
        self.chars = up.plane(hc)
        self.validity = up.plane(valid)
        if own:
            transfer.await_event(up.finish())
        self.fingerprint = _fingerprint(hc[:d], hl[:d])
        self._aux: "OrderedDict[object, tuple]" = OrderedDict()
        self._aux_lock = threading.Lock()

    @property
    def values(self) -> np.ndarray:
        """The values as Python strings (an object array, for reading)."""
        return np.asarray([bytes(self.host_chars[i, :self.host_lengths[i]])
                           .decode("utf-8", errors="surrogateescape")
                           for i in range(self.size)], dtype=object)

    def wire_bytes(self) -> int:
        return int(self.lengths.numel() * 4 + self.chars.numel()
                   + self.validity.numel())

    def clone(self) -> "DictPlanes":
        """A dictionary of its own with the same values: its planes and
        host arrays copied, no derived planes."""
        out = object.__new__(DictPlanes)
        out.size, out.capacity, out.width = self.size, self.capacity, \
            self.width
        out.fingerprint = self.fingerprint
        out.host_chars = self.host_chars.copy()
        out.host_lengths = self.host_lengths.copy()
        out.lengths = self.lengths.clone()
        out.chars = self.chars.clone()
        out.validity = self.validity.clone()
        out._aux = OrderedDict()
        out._aux_lock = threading.Lock()
        return out

    def aux(self, key, build):
        """The planes derived for ``key``, built once (bounded: a
        dictionary that outlives many queries drops its oldest)."""
        with self._aux_lock:
            hit = self._aux.get(key)
        if hit is not None:
            return hit[0]
        planes = build()
        with self._aux_lock:
            if len(self._aux) >= self._AUX_BOUND:
                self._aux.popitem(last=False)
            self._aux[key] = (planes,)
        return planes

    def dense_column(self) -> DeviceColumn:
        """The dictionary as a dense STRING column of ``size + 1`` rows,
        the null slot last: the domain rewritten subtrees evaluate
        over."""
        return DeviceColumn(STRING, self.lengths, self.validity,
                            self.size + 1, self.chars)

    def same_values(self, other: "DictPlanes") -> bool:
        if self is other:
            return True
        return (self.fingerprint == other.fingerprint
                and self.holds(other.host_chars[:other.size],
                               other.host_lengths[:other.size]))

    def holds(self, chars: np.ndarray, lengths: np.ndarray) -> bool:
        """Whether the dictionary's values are these sorted values
        (``chars`` zero past each length), compared value by value."""
        w = min(self.width, chars.shape[1])
        return (self.size == lengths.shape[0]
                and np.array_equal(self.host_lengths[:self.size], lengths)
                and np.array_equal(self.host_chars[:self.size, :w],
                                   chars[:, :w]))


def _fingerprint(chars: np.ndarray, lengths: np.ndarray) -> int:
    """A dictionary's hash of its values: where two agree, the values
    are compared before one stands for the other."""
    return hash((int(lengths.shape[0]), np.ascontiguousarray(chars).tobytes(),
                 np.ascontiguousarray(lengths, np.int32).tobytes()))


# ---------------------------------------------------------------------------
# EncodedColumn
# ---------------------------------------------------------------------------

class EncodedColumn(DeviceColumn):
    """A STRING column stored as codes and a shared dictionary.

    To every consumer it looks like a ``DeviceColumn``: ``.data`` (the
    lengths) and ``.chars`` decode on first touch through
    ``decode_late``, counted.  Encoding-aware paths read ``.codes`` and
    ``.dict`` and never make the dense planes.  A null row's code is 0;
    its validity is False."""

    __slots__ = ("codes", "dict", "_dense")

    def __init__(self, codes: torch.Tensor, validity: torch.Tensor,
                 num_rows: int, dict_planes: DictPlanes):
        # DeviceColumn.__init__ is not called: data and chars are the
        # lazy-decode properties below
        self.dtype = STRING
        self.codes = codes
        self.validity = validity
        self.num_rows = int(num_rows)
        self.dict = dict_planes
        self._dense = None

    def decoded(self) -> DeviceColumn:
        if self._dense is None:
            self._dense = decode_late(self)
        return self._dense

    @property
    def data(self):
        return self.decoded().data

    @property
    def chars(self):
        return self.decoded().chars

    @property
    def capacity(self) -> int:
        return int(self.codes.shape[0])

    @property
    def string_width(self) -> int:
        return self.dict.width

    def size_bytes(self) -> int:
        # the shared dictionary is charged to each column that holds it
        return int(self.codes.numel() * 4 + self.validity.numel()
                   + self.dict.wire_bytes())

    def gather(self, rows: torch.Tensor, n: int,
               live: Optional[torch.Tensor] = None) -> "EncodedColumn":
        """The rows at ``rows``, still codes; the first ``n`` live."""
        if live is None:
            live = torch.arange(rows.shape[0], device=rows.device) < n
        return EncodedColumn(self.codes[rows], self.validity[rows] & live,
                             n, self.dict)

    def slice_rows(self, start: int, n: int, cap: int) -> "EncodedColumn":
        """Rows ``start`` to ``start + n`` at capacity ``cap``; a slice
        that fills it exactly is a view."""
        if n == cap:
            return EncodedColumn(self.codes[start:start + n],
                                 self.validity[start:start + n], n,
                                 self.dict)
        codes = self.codes.new_zeros(cap)
        valid = self.validity.new_zeros(cap)
        codes[:n] = self.codes[start:start + n]
        valid[:n] = self.validity[start:start + n]
        return EncodedColumn(codes, valid, n, self.dict)

    def __repr__(self):
        return (f"EncodedColumn(dict={self.dict.size}, "
                f"rows={self.num_rows}, cap={self.capacity})")


def decode_late(col: EncodedColumn) -> DeviceColumn:
    """THE decode: the dense planes gathered from the dictionary by code,
    on the column's device.  A null row decodes to zeros, as the dense
    ingest path leaves it.  Counted: ``late_decodes`` measures how much
    of a plan still runs in the value domain."""
    d = col.dict
    idx = torch.where(col.validity, col.codes.to(torch.int64),
                      torch.full_like(col.codes, d.size, dtype=torch.int64))
    idx = idx.clamp(0, d.capacity - 1)
    _bump("late_decodes")
    return DeviceColumn(STRING, d.lengths[idx], col.validity, col.num_rows,
                        d.chars[idx])


def is_encoded(col) -> bool:
    return isinstance(col, EncodedColumn)


def has_encoded(batch) -> bool:
    return any(isinstance(c, EncodedColumn) for c in batch.columns)


def code_colval(c) -> ColVal:
    """A column's ColVal with an encoded column as its codes (chars
    None): what a code-domain kernel reads."""
    if isinstance(c, EncodedColumn):
        return ColVal(c.codes, c.validity, None)
    return ColVal(c.data, c.validity, c.chars)


def codes_stand_in(batch, keep=()):
    """``batch`` with each encoded column, but those at ``keep``,
    replaced by an INT32 column of its codes: a stand-in for the
    columns a code-domain pass reads as codes or not at all, so that
    reading the batch's planes decodes nothing.  The batch itself when
    nothing changes."""
    from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
    if not has_encoded(batch):
        return batch
    cols = [DeviceColumn(INT32, c.codes, c.validity, c.num_rows)
            if isinstance(c, EncodedColumn) and i not in keep else c
            for i, c in enumerate(batch.columns)]
    return ColumnarBatch(cols, batch.num_rows, batch.schema)


# ---------------------------------------------------------------------------
# the plane encodings: RLE, delta-narrowed and bit-packed columns
# ---------------------------------------------------------------------------
#
# An integer or boolean column the link carries compressed.  Its decode
# runs in the consumer's own pass (``stage_view`` in the fused stage,
# ``plane_view`` in the aggregate, both counted ``fused_decodes``), or
# for a consumer that knows nothing of encoding through the counted
# ``decode_plane_late``: the EncodedColumn contract.  The decodes are
# torch ops, as they are jitted jnp code (not Pallas) in the JAX
# package.

def _rle_dense(run_values: torch.Tensor, run_ends: torch.Tensor,
               cap: int) -> torch.Tensor:
    """Each row's run by a search over the cumulative run ends.  Padding
    runs hold 0 and end at ``cap``, so rows past the data decode to 0;
    null rows were filled with 0 before the runs were found."""
    pos = torch.arange(cap, dtype=run_ends.dtype, device=run_ends.device)
    idx = torch.searchsorted(run_ends, pos, right=True)
    return run_values[idx.clamp_(0, run_values.shape[0] - 1)]


def _delta_dense(deltas: torch.Tensor, base: torch.Tensor,
                 validity: torch.Tensor) -> torch.Tensor:
    """The base plus the running sum of the narrowed deltas, in the
    column's own type: an INT32 sum past 2^31 wraps, as the JAX
    package's int32 cumsum does, and base plus it is still the exact
    value.  Delta is chosen only for null-free columns, so ``validity``
    is the rows-below-n mask and masking with it leaves the padding 0."""
    vals = base + torch.cumsum(deltas, 0, dtype=base.dtype)
    return torch.where(validity, vals, torch.zeros_like(vals))


def _packed_dense(packed: torch.Tensor, cap: int) -> torch.Tensor:
    """8 rows a byte, the first in the lowest bit; pad bits are 0.  Each
    byte shifts by 0 to 7 in place, in uint8."""
    shifts = torch.arange(8, dtype=torch.uint8, device=packed.device)
    return ((packed[:, None] >> shifts) & 1).reshape(-1)[:cap] \
        .to(torch.bool)


class _PlaneColumn(DeviceColumn):
    """What the three plane encodings share: to every consumer a
    ``DeviceColumn`` whose ``.data`` decodes once through the counted
    ``decode_plane_late``; ``chars`` is None.  ``gather`` and
    ``slice_rows`` go through that decode and give dense columns."""

    __slots__ = ("_cap", "_dense")
    mode = ""

    def _init(self, dtype: DataType, validity: torch.Tensor, num_rows: int,
              capacity: int) -> None:
        # DeviceColumn.__init__ is not called: data and chars are the
        # lazy-decode properties below
        self.dtype = dtype
        self.validity = validity
        self.num_rows = int(num_rows)
        self._cap = int(capacity)
        self._dense = None

    def decoded(self) -> DeviceColumn:
        if self._dense is None:
            self._dense = decode_plane_late(self)
        return self._dense

    @property
    def data(self):
        return self.decoded().data

    @property
    def chars(self):
        return None

    @property
    def capacity(self) -> int:
        return self._cap

    def planes(self) -> tuple:
        """The compressed planes as a ``ColVal``'s three slots (what a
        spill stores)."""
        raise NotImplementedError

    def dense_data(self) -> torch.Tensor:
        """The decoded data plane (uncounted: the callers count)."""
        raise NotImplementedError

    def size_bytes(self) -> int:
        return int(sum(t.numel() * t.element_size() for t in self.planes()
                       if t is not None))

    def gather(self, rows: torch.Tensor, n: int,
               live: Optional[torch.Tensor] = None) -> DeviceColumn:
        if live is None:
            live = torch.arange(rows.shape[0], device=rows.device) < n
        d = self.decoded()
        return DeviceColumn(self.dtype, d.data[rows], d.validity[rows] & live,
                            n)

    def slice_rows(self, start: int, n: int, cap: int) -> DeviceColumn:
        return self.decoded().slice_rows(start, n, cap)

    def __repr__(self):
        return (f"{type(self).__name__}({self.dtype}, rows={self.num_rows}, "
                f"cap={self._cap})")


class RleColumn(_PlaneColumn):
    """An INT32 or INT64 column as run values and cumulative run ends,
    ``rcap`` of each (``bucket_capacity(runs + 1)``): the runs past
    ``num_runs`` hold 0 and end at the capacity."""

    __slots__ = ("run_values", "run_ends", "num_runs")
    mode = "rle"

    def __init__(self, dtype: DataType, run_values: torch.Tensor,
                 run_ends: torch.Tensor, num_runs: int,
                 validity: torch.Tensor, num_rows: int, capacity: int):
        self._init(dtype, validity, num_rows, capacity)
        self.run_values = run_values
        self.run_ends = run_ends
        self.num_runs = int(num_runs)

    def planes(self) -> tuple:
        return (self.run_values, self.validity, self.run_ends)

    def dense_data(self) -> torch.Tensor:
        return _rle_dense(self.run_values, self.run_ends, self._cap)


class DeltaColumn(_PlaneColumn):
    """A null-free INT32 or INT64 column as its first value (``base``,
    one element of the column's type) and int8 or int16 deltas from
    each row to the next (the first and the padding 0)."""

    __slots__ = ("deltas", "base")
    mode = "delta"

    def __init__(self, dtype: DataType, deltas: torch.Tensor,
                 base: torch.Tensor, validity: torch.Tensor, num_rows: int,
                 capacity: int):
        self._init(dtype, validity, num_rows, capacity)
        self.deltas = deltas
        self.base = base

    def planes(self) -> tuple:
        return (self.deltas, self.validity, self.base)

    def dense_data(self) -> torch.Tensor:
        return _delta_dense(self.deltas, self.base, self.validity)


class PackedBoolColumn(_PlaneColumn):
    """A BOOLEAN column bit-packed, 8 rows a byte, the first in the
    lowest bit (``np.packbits(..., bitorder="little")``)."""

    __slots__ = ("packed",)
    mode = "packed"

    def __init__(self, packed: torch.Tensor, validity: torch.Tensor,
                 num_rows: int, capacity: int):
        self._init(BOOLEAN, validity, num_rows, capacity)
        self.packed = packed

    def planes(self) -> tuple:
        return (self.packed, self.validity, None)

    def dense_data(self) -> torch.Tensor:
        return _packed_dense(self.packed, self._cap)


def is_plane_compressed(col) -> bool:
    return isinstance(col, _PlaneColumn)


def decode_plane_late(col: _PlaneColumn) -> DeviceColumn:
    """THE decode of a plane column, counted in ``late_decodes``: the
    dense column, its data plane the plain upload's (0 under nulls and
    padding)."""
    _bump("late_decodes")
    return DeviceColumn(col.dtype, col.dense_data(), col.validity,
                        col.num_rows)


def plane_view(columns) -> List[ColVal]:
    """A consumer's dense ``ColVal``s of ``columns``, each plane column
    decoded here, in the consumer's own pass (counted ``fused_decodes``
    a column and a batch), never through the late decode; any other
    column as ``colvals`` gives it."""
    return [_fused_colval(c) if isinstance(c, _PlaneColumn)
            else ColVal(c.data, c.validity, c.chars) for c in columns]


def _fused_colval(c: "_PlaneColumn") -> ColVal:
    _bump("fused_decodes")
    return ColVal(c.dense_data(), c.validity, None)


def stored_planes(c) -> tuple:
    """What a spill keeps of a column: ``(planes, dictionary, kind)``,
    the planes as the column holds them on the device (an encoded
    column's codes, a plane column's compressed planes, else the dense
    planes) and what ``restore_column`` needs to rebuild it."""
    if isinstance(c, EncodedColumn):
        return (c.codes, c.validity, None), c.dict, None
    if isinstance(c, RleColumn):
        return c.planes(), None, ("rle", c.num_runs, c.capacity)
    if isinstance(c, _PlaneColumn):
        return c.planes(), None, (c.mode, c.capacity)
    return (c.data, c.validity, c.chars), None, None


def restore_column(dtype: DataType, planes: tuple, num_rows: int,
                   dict_planes: Optional[DictPlanes] = None,
                   kind: Optional[tuple] = None) -> DeviceColumn:
    """``stored_planes``' inverse: the column of the same class."""
    a, valid, b = planes
    if dict_planes is not None:
        return EncodedColumn(a, valid, num_rows, dict_planes)
    if kind is None:
        return DeviceColumn(dtype, a, valid, num_rows, b)
    if kind[0] == "rle":
        return RleColumn(dtype, a, b, kind[1], valid, num_rows, kind[2])
    if kind[0] == "delta":
        return DeltaColumn(dtype, a, b, valid, num_rows, kind[1])
    return PackedBoolColumn(a, valid, num_rows, kind[1])


def unshare_batches(batches: list, storages: set) -> list:
    """``batches`` with every column whose planes or dictionary lie in
    ``storages`` (``untyped_storage().data_ptr()``s: the device scan
    cache's) rebuilt on copies of them, so that a caller that writes
    what it was handed cannot reach the batches the cache shares with
    later queries.  Other columns are kept as they are."""
    from spark_rapids_tpu_torch.columnar import transfer
    from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch

    def shared(planes) -> bool:
        return any(a is not None and a.untyped_storage().data_ptr()
                   in storages for a in planes)

    dicts = {}
    out = []
    for b in batches:
        cols = []
        for c in b.columns:
            planes, dct, kind = stored_planes(c)
            dshared = dct is not None and shared(
                (dct.lengths, dct.chars, dct.validity))
            if not (dshared or shared(planes)):
                cols.append(c)
                continue
            transfer.await_upload(b)
            if dshared:
                if id(dct) not in dicts:
                    dicts[id(dct)] = dct.clone()
                dct = dicts[id(dct)]
            planes = tuple(None if a is None else a.clone() for a in planes)
            cols.append(restore_column(c.dtype, planes, c.num_rows, dct,
                                       kind))
        out.append(b if all(x is y for x, y in zip(cols, b.columns))
                   else ColumnarBatch(cols, b.num_rows, b.schema))
    return out


def plan_plane(values: np.ndarray, validity: np.ndarray, dtype: DataType,
               cap: int, rle: bool, delta: bool) -> Optional[tuple]:
    """The JAX encoder's choice for one host INT32, INT64 or BOOLEAN
    column of ``n`` rows at capacity ``cap`` -> ``(kind, arrays, runs,
    wire)``, the arrays to upload beside the validity, or None when it
    declines (the column rides plain).  BOOLEAN is always bit-packed.
    An integer column takes RLE or the int8/int16 delta, whichever
    crosses fewer bytes (RLE on a tie), and only if it crosses fewer
    than ``cap * (itemsize + 1)``; delta never takes a column with
    nulls.  Nulls are 0 (False) before the runs are found."""
    from spark_rapids_tpu_torch.columnar.batch import host_values
    n = len(values)
    vals = host_values(values, dtype)
    all_valid = bool(validity.all())
    if not all_valid:
        vals = np.where(validity, vals, np.zeros((), vals.dtype))
    itemsize = vals.dtype.itemsize
    if dtype == BOOLEAN:
        bits = np.zeros(cap, np.uint8)
        bits[:n] = vals
        packed = np.packbits(bits, bitorder="little")
        return "packed", (packed,), 0, packed.nbytes + cap
    raw = cap * (itemsize + 1)
    delta = delta and all_valid and n >= 1
    if not (rle or delta):
        return None
    # one int64 diff serves both: a run changes where it is nonzero
    diffs = np.diff(vals.astype(np.int64, copy=False))
    best = None
    if rle:
        runs = int(np.count_nonzero(diffs)) + 1
        rcap = bucket_capacity(max(1, runs + 1))
        wire = rcap * (itemsize + 4) + cap
        if wire < raw:
            change = np.flatnonzero(diffs)
            rv = np.zeros(rcap, vals.dtype)
            rv[:runs] = vals[np.insert(change + 1, 0, 0)]
            ends = np.full(rcap, cap, np.int32)
            ends[:runs] = np.append(change + 1, n)
            best = ("rle", (rv, ends), runs, wire)
    if delta:
        store = None
        lo, hi = (int(diffs.min()), int(diffs.max())) if diffs.size \
            else (0, 0)
        if lo >= -128 and hi <= 127:
            store = np.dtype(np.int8)
        elif lo >= -32768 and hi <= 32767:
            store = np.dtype(np.int16)
        if store is not None and store.itemsize < itemsize:
            wire = cap * store.itemsize + itemsize + cap
            if wire < raw and (best is None or wire < best[3]):
                deltas = np.zeros(cap, store)
                deltas[1:n] = diffs
                best = ("delta", (deltas, vals[:1].copy()), 0, wire)
    return best


_PLANE_STATS = {"rle": "rle_columns", "delta": "delta_columns",
                "packed": "packed_bool_columns"}


# ---------------------------------------------------------------------------
# building a dictionary: the same one on the host and on the card
# ---------------------------------------------------------------------------

_H0 = np.uint64(0x9E3779B97F4A7C15)
_H1 = np.uint64(0xBF58476D1CE4E5B9)


def _words_host(chars: np.ndarray) -> np.ndarray:
    """(n, w) uint8, w a multiple of 8 -> (n, w / 8) uint64 read
    big-endian, so that word order is byte order."""
    return np.ascontiguousarray(chars).view(">u8").astype(np.uint64)


def _sorted_order_host(words: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """The order that sorts rows by (bytes, length): the UTF-8 byte order
    of the values their zero-padded words and lengths stand for."""
    return np.lexsort([lengths] + [words[:, j]
                                   for j in reversed(range(words.shape[1]))])


def dictionary_host(chars: np.ndarray, lengths: np.ndarray, limit: int
                    ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """The distinct values of ``n`` rows (``chars`` zero past each
    length) -> (rows: the index of a row of each distinct value, in
    the values' sorted order; codes: each row's rank), or None when
    there are more than ``limit`` distinct values.  A 64-bit hash of
    each row's words finds the distinct values; each row is checked
    against its value's row, and a collision falls back to an exact
    sort of the rows."""
    n, w = chars.shape
    words = _words_host(chars) if n else np.zeros((0, w // 8), np.uint64)
    lens = lengths.astype(np.uint64)
    with np.errstate(over="ignore"):
        h = lens * _H0
        for j in range(words.shape[1]):
            h = (h ^ words[:, j]) * _H1
            h ^= h >> np.uint64(29)
    # no return_index, which makes np.unique sort stably, slower than
    # its default sort: any row of a distinct hash stands for it
    uh, inv = np.unique(h, return_inverse=True)
    inv = inv.reshape(-1)
    if uh.shape[0] > limit:
        return None
    first = np.empty(uh.shape[0], np.intp)
    first[inv] = np.arange(n)
    if not (np.array_equal(words, words[first][inv])
            and np.array_equal(lengths, lengths[first][inv])):
        keys = np.concatenate([words, lens[:, None]], axis=1)
        _, first, inv = np.unique(keys, axis=0, return_index=True,
                                  return_inverse=True)
        inv = inv.reshape(-1)
        if first.shape[0] > limit:
            return None
    order = _sorted_order_host(words[first], lengths[first])
    rank = np.empty(order.shape[0], np.int32)
    rank[order] = np.arange(order.shape[0], dtype=np.int32)
    return first[order], rank[inv]


def _words_device(chars: torch.Tensor) -> torch.Tensor:
    """(n, w) uint8 -> (n, w / 8) int64 whose signed order is the bytes'
    order: the bytes read big-endian, the sign bit flipped."""
    n, w = chars.shape
    words = chars.reshape(n, w // 8, 8).flip(2).contiguous() \
        .view(torch.int64).reshape(n, w // 8)
    return words ^ (-(1 << 63))


def _lsr(x: torch.Tensor, s: int) -> torch.Tensor:
    return (x >> s) & ((1 << (64 - s)) - 1)


def dictionary_device(chars: torch.Tensor, lengths: torch.Tensor,
                      limit: int):
    """``dictionary_host`` on the card, with torch ops: the same
    dictionary and codes for the same strings (two host syncs: the distinct count and
    the collision check)."""
    n, w = chars.shape
    words = _words_device(chars)
    lens = lengths.to(torch.int64)
    h = lens * -7046029254386353131          # 0x9E3779B97F4A7C15
    for j in range(words.shape[1]):
        h = (h ^ words[:, j]) * -4658895280553007687   # 0xBF58476D1CE4E5B9
        h = h ^ _lsr(h, 29)
    uh, inv = torch.unique(h, sorted=True, return_inverse=True)
    d = int(uh.shape[0])
    if d > limit:
        return None
    pos = torch.arange(n, device=chars.device)
    first = torch.full((d,), n, dtype=torch.int64, device=chars.device) \
        .scatter_reduce_(0, inv, pos, reduce="amin")
    same = bool(((words == words[first][inv]).all(dim=1)
                 & (lens == lens[first][inv])).all())
    if not same:
        keys = torch.cat([words, lens[:, None]], dim=1)
        uk, inv = torch.unique(keys, dim=0, sorted=True, return_inverse=True)
        d = int(uk.shape[0])
        if d > limit:
            return None
        first = torch.full((d,), n, dtype=torch.int64, device=chars.device) \
            .scatter_reduce_(0, inv, pos, reduce="amin")
    # stable sorts from the last key to the first: (bytes, length) order
    order = torch.arange(d, device=chars.device)
    fw, fl = words[first], lens[first]
    for key in [fl] + [fw[:, j] for j in reversed(range(words.shape[1]))]:
        order = order[torch.sort(key[order], stable=True).indices]
    rank = torch.empty(d, dtype=torch.int32, device=chars.device)
    rank[order] = torch.arange(d, dtype=torch.int32, device=chars.device)
    return first[order], rank[inv]


# ---------------------------------------------------------------------------
# ingest
# ---------------------------------------------------------------------------

# host columns already encoded, keyed on the addresses of their arrays:
# a scan of the same local table in the next query uploads its codes
# again but not the dictionary, and does not rebuild either, as the JAX
# package's dictionary memo keys on Arrow's buffer identity.  An entry
# holds the codes and the DictPlanes, or a plane column's compressed
# host planes (or only the decision, for a column sent plain), never
# the host arrays: it is dropped when the array that owns any of their
# memory is freed, so no address in a key can be reused by other data
# while the entry exists.  A plane decision is kept only for arrays no
# one can write (``_frozen``): a string column's keyed arrays are ones
# the port built, but an integer column is often the user's own numpy
# array, which may be edited in place between two scans.  The entries'
# host arrays are bounded in bytes (``memo_host_bytes`` in
# ``compressed_stats``), the oldest dropped first.
_MEMO_BOUND_BYTES = 1 << 30
_MEMO: "OrderedDict[tuple, tuple]" = OrderedDict()
_MEMO_LOCK = threading.Lock()
_MEMO_BYTES = 0
# keys whose arrays were freed while the lock was held (a collection
# run inside the locked block, or another thread): dropped on next use
_MEMO_DEAD: List[tuple] = []


def _array_id(a: np.ndarray) -> tuple:
    return (a.__array_interface__["data"][0], a.shape, a.strides)


def _owner(a: np.ndarray) -> np.ndarray:
    """The array at the end of ``a``'s chain of views: it keeps the
    memory alive for as long as it lives."""
    while isinstance(a.base, np.ndarray):
        a = a.base
    return a


def _frozen(*arrays: np.ndarray) -> bool:
    """Whether no one can write these arrays: the array owning each
    one's memory is read-only.  That is an Arrow buffer read zero-copy
    (immutable by Arrow's contract, even where it wraps a numpy array),
    a host copy the port made and marked, or an array its user froze."""
    return not any(_owner(a).flags.writeable for a in arrays)


def _entry_bytes(codes_np, planes) -> int:
    """The host bytes a memo entry holds: a string column's codes and
    its dictionary's host copy (a dictionary several batches share
    counts in each), or a plane column's compressed planes."""
    if isinstance(codes_np, tuple):           # a plane decision
        return int(sum(a.nbytes for a in codes_np[1]))
    total = 0 if codes_np is None else codes_np.nbytes
    if planes is not None:
        total += planes.host_chars.nbytes + planes.host_lengths.nbytes
    return int(total)


def _memo_drop(key: tuple) -> None:
    # a finalizer: never waits on the lock, and never changes the memo
    # from inside a locked block of its own thread
    if _MEMO_LOCK.acquire(blocking=False):
        try:
            _memo_evict(key)
        finally:
            _MEMO_LOCK.release()
    else:
        _MEMO_DEAD.append(key)


def _memo_evict(key: tuple) -> None:
    """Drops ``key``'s entry and its finalizers (the lock held)."""
    global _MEMO_BYTES
    entry = _MEMO.pop(key, None)
    if entry is not None:
        for fin in entry[2]:
            fin.detach()
        _MEMO_BYTES -= entry[3]


def _memo_get(key: tuple):
    with _MEMO_LOCK:
        while _MEMO_DEAD:
            _memo_evict(_MEMO_DEAD.pop())
        hit = _MEMO.get(key)
        if hit is not None:
            _MEMO.move_to_end(key)
        return hit


def _memo_put(key: tuple, codes_np, planes, arrays) -> None:
    global _MEMO_BYTES
    owners = {id(o): o for o in map(_owner, arrays)}.values()
    fins = tuple(weakref.finalize(o, _memo_drop, key) for o in owners)
    for fin in fins:
        fin.atexit = False
    size = _entry_bytes(codes_np, planes)
    with _MEMO_LOCK:
        _memo_evict(key)
        _MEMO[key] = (codes_np, planes, fins, size)
        _MEMO_BYTES += size
        while _MEMO_BYTES > _MEMO_BOUND_BYTES and len(_MEMO) > 1:
            _memo_evict(next(iter(_MEMO)))


def clear_memo() -> None:
    """Forgets the local scan's encodings: the next scan of each table
    builds its dictionaries again, as a new table's first scan does."""
    with _MEMO_LOCK:
        for key in list(_MEMO):
            _memo_evict(key)
        _MEMO_DEAD.clear()


def _own_upload(device, up, fn):
    """``fn(up)``, through an upload of its own waited on at once when
    ``up`` is None."""
    from spark_rapids_tpu_torch.columnar import transfer
    if up is not None:
        return fn(up)
    up = transfer.Upload(device)
    out = fn(up)
    transfer.await_event(up.finish())
    return out


class IngestEncoder:
    """One scan's encoder: decides per string column whether the upload
    carries codes or the dense planes, builds the ``EncodedColumn``, and
    keeps the raw and wire byte counts.  Its decisions are the JAX
    encoder's: a null dictionary value, more distinct values than
    ``max(1, int(n * maxDictFraction))`` or a dictionary wider than
    ``maxDeviceStringWidth`` send the column the plain way; nulls are
    not values.  An INT32, INT64 or BOOLEAN column takes a plane
    encoding where ``plan_plane`` finds one, while its key is on; a
    declined plane column counts no bytes, as in the JAX package."""

    def __init__(self, device, metrics=None,
                 max_dict_fraction: Optional[float] = None,
                 max_string_width: Optional[int] = None,
                 memo: bool = False):
        self.device = device
        self.metrics = metrics
        # the local scan's host arrays outlive a query, so its encodings
        # are kept (_MEMO); a file scan's are new every batch
        self.memo = memo
        self.max_dict_fraction = _MAX_DICT_FRACTION \
            if max_dict_fraction is None else max_dict_fraction
        self.max_string_width = max_string_width
        # the scan's dictionaries by value set: batches with the same
        # values share one DictPlanes, uploaded once
        self._dicts: Dict[int, DictPlanes] = {}

    def _limit(self, n: int) -> int:
        return max(1, int(n * self.max_dict_fraction))

    def upload_column(self, values, validity: np.ndarray, dtype: DataType,
                      cap: int, up=None) -> Optional[DeviceColumn]:
        """An ``EncodedColumn`` for host string values (a
        ``HostStrings``), or a plane column for INT32, INT64 or BOOLEAN
        values, when encoding wins, else None: the caller uploads the
        plain planes.  ``up`` is the batch's ``transfer.Upload`` (None:
        one of its own, waited on at once)."""
        return _own_upload(self.device, up, lambda u: self._upload_column(
            values, validity, dtype, cap, u))

    def _upload_column(self, values, validity: np.ndarray, dtype: DataType,
                       cap: int, up) -> Optional[DeviceColumn]:
        if dtype != STRING:
            if dtype == BOOLEAN or dtype in (INT32, INT64):
                return self._upload_plane(values, validity, dtype, cap, up)
            return None
        if len(values) == 0:
            return None
        n = len(values)
        dense_w = bucket_capacity(max(1, int(values.lengths.max())))
        try:
            faults.maybe_fail(FAULT_SITE_ENCODE,
                              "injected ingest-encode failure")
            got = self._encode_host(values, validity, up)
        except (IOError, OSError) as e:
            return self._fault(e, cap, dense_w)
        if got is None:
            self._count_plain(cap, dense_w)
            return None
        codes_np, planes, fresh = got
        return self._upload(codes_np, validity, planes, fresh, n, cap,
                            dense_w, up)

    def upload_arrow(self, arr, dtype: DataType, cap: int,
                     up=None) -> Optional[EncodedColumn]:
        """An ``EncodedColumn`` for an Arrow dictionary array (a parquet
        scan's ``read_dictionary`` column), its dictionary sorted and
        deduplicated, as the JAX encoder does; None for anything else
        or when encoding loses.  ``up`` as for ``upload_column``."""
        return _own_upload(self.device, up, lambda u: self._upload_arrow(
            arr, dtype, cap, u))

    def _upload_arrow(self, arr, dtype: DataType, cap: int,
                      up) -> Optional[EncodedColumn]:
        import pyarrow as pa
        if dtype != STRING or not pa.types.is_dictionary(arr.type):
            return None
        if isinstance(arr, pa.ChunkedArray):
            arr = arr.combine_chunks()
        n = len(arr)
        if n == 0:
            return None
        from spark_rapids_tpu_torch.columnar.batch import _arrow_strings
        dense_w = 8
        try:
            faults.maybe_fail(FAULT_SITE_ENCODE,
                              "injected ingest-encode failure")
            dictionary = arr.dictionary
            if not pa.types.is_large_string(dictionary.type):
                dictionary = dictionary.cast(pa.large_string())
            dvals = _arrow_strings(dictionary)
            idx = arr.indices.fill_null(0).to_numpy(zero_copy_only=False) \
                .astype(np.int64)
            if len(dvals):
                dense_w = bucket_capacity(max(1, int(
                    dvals.lengths[idx].max())))
            valid = np.ones(n, np.bool_) if arr.null_count == 0 \
                else np.asarray(arr.is_valid())
            if dictionary.null_count \
                    or len(dictionary) > self._limit(n):
                self._count_plain(cap, dense_w)
                return None
            w = bucket_capacity(max(1, int(dvals.lengths.max())
                                    if len(dvals) else 1))
            got = dictionary_host(dvals.chars[:, :w], dvals.lengths,
                                  len(dvals))
            rows, dcodes = got
            planes, fresh = self._planes(dvals.chars[rows],
                                         dvals.lengths[rows], up)
            if planes is None:
                self._count_plain(cap, dense_w)
                return None
            # an all-null batch has an empty dictionary: its indices are
            # all null, each read as 0 and masked
            lut = np.zeros(max(1, dcodes.shape[0]), np.int32)
            lut[:dcodes.shape[0]] = dcodes
            codes_np = np.where(valid, lut[idx], 0).astype(np.int32)
        except (IOError, OSError, pa.ArrowInvalid) as e:
            return self._fault(e, cap, dense_w)
        return self._upload(codes_np, valid, planes, fresh, n, cap, dense_w,
                            up)

    # -- internals -----------------------------------------------------

    def _upload_plane(self, values, validity: np.ndarray, dtype: DataType,
                      cap: int, up) -> Optional[DeviceColumn]:
        """The plane column for host INT32, INT64 or BOOLEAN values, or
        None (its key off, no byte won, nulls under delta).  An
        ``io.encode`` fault sends it plain, counted as in the JAX
        package: its plain bytes in raw and wire alike."""
        rle, delta = _RLE, _DELTA
        if not (_PACKED if dtype == BOOLEAN else rle or delta):
            return None
        n = len(values)
        if n == 0:
            return None
        raw = cap * (np.dtype(dtype.numpy_dtype).itemsize + 1)
        try:
            faults.maybe_fail(FAULT_SITE_ENCODE,
                              "injected ingest-encode failure")
        except (IOError, OSError) as e:
            _bump("encode_faults")
            _bump("h2d_raw_bytes", raw)
            _bump("h2d_wire_bytes", raw)
            _bump("plain_columns")
            _LOG.warning("ingest encode degraded to plain planes: %s", e)
            return None
        # the local scan keeps each decision over arrays no one can
        # write, a decline too, so that a warm scan of them pays no host
        # encode; a writable array is planned again every scan
        key = ("plane", _array_id(values), _array_id(validity), dtype.name,
               cap, rle, delta) \
            if self.memo and _frozen(values, validity) else None
        hit = None if key is None else _memo_get(key)
        if hit is not None:
            got = hit[0]
        else:
            t0 = time.perf_counter_ns()
            got = plan_plane(values, validity, dtype, cap, rle, delta)
            _bump("host_encode_ns", time.perf_counter_ns() - t0)
            if key is not None:
                _memo_put(key, got, None, (values, validity))
        if got is None:
            return None
        kind, arrays, runs, wire = got
        put = [up.plane(a) for a in arrays]
        valid_t = up.plane(validity, cap)
        if kind == "packed":
            col = PackedBoolColumn(put[0], valid_t, n, cap)
        elif kind == "rle":
            col = RleColumn(dtype, put[0], put[1], runs, valid_t, n, cap)
        else:
            col = DeltaColumn(dtype, put[0], put[1], valid_t, n, cap)
        _bump("h2d_raw_bytes", raw)
        _bump("h2d_wire_bytes", wire)
        _bump(_PLANE_STATS[kind])
        if self.metrics is not None:
            self.metrics["encodedColumns"] += 1
        return col

    def _encode_host(self, values, validity, up):
        key = None
        if self.memo:
            key = (_array_id(values.chars), _array_id(values.lengths),
                   _array_id(validity), self.max_dict_fraction,
                   self.max_string_width, str(self.device))
            hit = _memo_get(key)
            if hit is not None:
                codes_np, planes = hit[0], hit[1]
                if planes is None:
                    return None
                # the dictionary is on the device since an earlier scan
                self._dicts.setdefault(planes.fingerprint, planes)
                return codes_np, planes, False
        t0 = time.perf_counter_ns()
        got = self._build_host(values, validity, up)
        _bump("host_encode_ns", time.perf_counter_ns() - t0)
        if key is not None:
            codes_np, planes = (None, None) if got is None else got[:2]
            _memo_put(key, codes_np, planes,
                      (values.chars, values.lengths, validity))
        return got

    def _build_host(self, values, validity, up):
        n = len(values)
        lengths = values.lengths
        vidx = None if validity.all() else np.flatnonzero(validity)
        lv = lengths if vidx is None else lengths[vidx]
        w = bucket_capacity(max(1, int(lv.max()) if lv.size else 1))
        chars = values.chars[:, :w] if vidx is None \
            else values.chars[vidx, :w]
        if chars.shape[1] < w:
            chars = np.pad(chars, ((0, 0), (0, w - chars.shape[1])))
        got = dictionary_host(chars, lv, self._limit(n))
        if got is None:
            return None
        rows, vcodes = got
        planes, fresh = self._planes(chars[rows], lv[rows], up)
        if planes is None:
            return None
        if vidx is None:
            codes_np = vcodes.astype(np.int32)
        else:
            codes_np = np.zeros(n, np.int32)
            codes_np[vidx] = vcodes
        return codes_np, planes, fresh

    def _planes(self, chars: np.ndarray, lengths: np.ndarray, up):
        """-> (the scan's DictPlanes of these sorted values, whether they
        were uploaded now), or (None, False) when the dictionary is
        wider than the device may hold."""
        width = bucket_capacity(max(1, int(lengths.max())
                                    if lengths.size else 1))
        if self.max_string_width is not None \
                and width > self.max_string_width:
            return None, False
        hit = self._dicts.get(_fingerprint(chars[:, :width], lengths))
        if hit is not None and hit.holds(chars, lengths):
            return hit, False
        planes = DictPlanes(chars, lengths, self.device, up)
        self._dicts[planes.fingerprint] = planes
        return planes, True

    def _upload(self, codes_np, valid, planes, fresh: bool, n: int,
                cap: int, dense_w: int, up) -> EncodedColumn:
        col = EncodedColumn(up.plane(codes_np, cap), up.plane(valid, cap),
                            n, planes)
        # the dense upload: lengths, validity and a (cap, W) char matrix
        # at the batch's own width; the dictionary crosses once a scan
        raw = cap * (4 + 1) + cap * dense_w
        wire = cap * (4 + 1) + (planes.wire_bytes() if fresh else 0)
        _bump("h2d_raw_bytes", raw)
        _bump("h2d_wire_bytes", wire)
        _bump("encoded_columns")
        if self.metrics is not None:
            self.metrics["encodedColumns"] += 1
        return col

    def _count_plain(self, cap: int, dense_w: int) -> None:
        """A declined column rides the plain planes: its bytes count in
        raw and wire alike, so the ratio covers every string column the
        scan uploaded."""
        dense = cap * (4 + 1) + cap * dense_w
        _bump("h2d_raw_bytes", dense)
        _bump("h2d_wire_bytes", dense)
        _bump("plain_columns")

    def _fault(self, e: Exception, cap: int, dense_w: int) -> None:
        _bump("encode_faults")
        self._count_plain(cap, dense_w)
        _LOG.warning("ingest encode degraded to plain planes: %s", e)
        return None


def encode_on_device(col: DeviceColumn, max_dict_fraction: float,
                     max_string_width: Optional[int] = None,
                     metrics=None) -> DeviceColumn:
    """A dense STRING column already on the device (the CSV scan's) ->
    an ``EncodedColumn`` with the dictionary and codes the host encoder
    gives for the same strings, or the column itself when encoding
    loses (counted as ``plain_columns``).  The ``io.encode`` site
    applies as on the host.  Nothing crosses the link, so the h2d byte
    counts are left alone."""
    n = col.num_rows
    if n == 0:
        return col
    try:
        faults.maybe_fail(FAULT_SITE_ENCODE, "injected ingest-encode failure")
    except (IOError, OSError) as e:
        _bump("encode_faults")
        _bump("plain_columns")
        _LOG.warning("ingest encode degraded to plain planes: %s", e)
        return col
    valid = col.validity[:n]
    lengths = col.data[:n]
    vidx = torch.nonzero(valid).squeeze(1)
    all_valid = int(vidx.numel()) == n
    lv = lengths if all_valid else lengths[vidx]
    w = bucket_capacity(max(1, int(lv.max()) if lv.numel() else 1))
    chars = col.chars[:n] if all_valid else col.chars[vidx]
    chars = chars[:, :w] if chars.shape[1] >= w else \
        torch.nn.functional.pad(chars, (0, w - chars.shape[1]))
    got = dictionary_device(chars, lv, max(1, int(n * max_dict_fraction)))
    if got is None:
        _bump("plain_columns")
        return col
    rows, vcodes = got
    dl = lv[rows].cpu().numpy().astype(np.int32)
    width = bucket_capacity(max(1, int(dl.max()) if dl.size else 1))
    if max_string_width is not None and width > max_string_width:
        _bump("plain_columns")
        return col
    dc = chars[rows, :min(width, w)].cpu().numpy()
    planes = DictPlanes(dc, dl, col.validity.device)
    codes = torch.zeros(col.capacity, dtype=torch.int32,
                        device=col.validity.device)
    if all_valid:
        codes[:n] = vcodes
    else:
        codes[vidx] = vcodes
    _bump("encoded_columns")
    if metrics is not None:
        metrics["encodedColumns"] += 1
    return EncodedColumn(codes, col.validity, n, planes)


def encode_batch_on_device(batch, max_dict_fraction: float,
                           max_string_width: Optional[int] = None,
                           metrics=None):
    """``encode_on_device`` over each dense STRING column of a batch."""
    from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
    if not any(c.dtype == STRING and not isinstance(c, EncodedColumn)
               for c in batch.columns):
        return batch
    cols = [encode_on_device(c, max_dict_fraction, max_string_width,
                             metrics)
            if c.dtype == STRING and not isinstance(c, EncodedColumn) else c
            for c in batch.columns]
    return ColumnarBatch(cols, batch.num_rows, batch.schema)


# ---------------------------------------------------------------------------
# dictionary-domain evaluation
# ---------------------------------------------------------------------------

def _rebind_to(expr: Expression, from_ordinal: int,
               to_ordinal: int) -> Expression:
    """BoundReference(from) -> BoundReference(to)."""
    return _rebind_many(expr, {from_ordinal: to_ordinal})


def _rebind_many(expr: Expression, mapping: Dict[int, int]) -> Expression:
    """Every BoundReference remapped at once (collision-safe)."""
    if isinstance(expr, BoundReference):
        to = mapping.get(expr.ordinal)
        if to is None:
            return expr
        return BoundReference(to, expr.dtype, expr.nullable, expr.col_name)
    if not expr.children:
        return expr
    return expr.with_children([_rebind_many(c, mapping)
                               for c in expr.children])


def _expr_key(expr: Expression) -> tuple:
    # the object as well as its key: an expression whose key() leaves
    # out a parameter must not share another's table; the memo entry
    # keeps the object alive, so its id stays its own
    return (id(expr), expr.key())


def _eval_over_dict(planes: DictPlanes, subtree: Expression, ordinal: int):
    """``subtree`` (over the encoded column at ``ordinal``) evaluated over
    the dictionary's ``size + 1`` rows (the null slot last), once a
    dictionary: the gather table a ``DictGather`` indexes by code."""
    def build():
        rebound = _rebind_to(subtree, ordinal, 0)
        ctx = EvalContext([ColVal(planes.lengths, planes.validity,
                                  planes.chars)], planes.size + 1,
                          planes.capacity, planes.lengths.device)
        out = rebound.emit(ctx)
        return (ColVal(out.data, out.validity, out.chars), subtree)

    return planes.aux(("expr",) + _expr_key(subtree) + (ordinal,), build)[0]


def hash_planes(planes: DictPlanes) -> ColVal:
    """Each code's partition/join hash, from the same ``hash_colval`` the
    dense path applies, so a hash partition over codes sends every row
    where the dense path does.  The null slot holds the hash of an empty
    string (a null row's zeroed planes) with validity False."""
    def build():
        from spark_rapids_tpu_torch.exec.joins import hash_colval
        h = hash_colval(ColVal(planes.lengths, planes.validity,
                               planes.chars), STRING)
        return ColVal(h, planes.validity, None)

    return planes.aux(("hash",), build)


def _eval_over_dict_pair(d1: DictPlanes, d2: DictPlanes,
                         subtree: Expression, ord1: int, ord2: int):
    """``subtree`` over two encoded columns evaluated once over the
    (size1 + 1) x (size2 + 1) cross product of their dictionaries (null
    slots included), indexed by ``code1 * (size2 + 1) + code2``."""
    def build():
        rebound = _rebind_many(subtree, {ord1: 0, ord2: 1})
        n2 = d2.size + 1
        cells = (d1.size + 1) * n2
        cap = bucket_capacity(cells)
        dev = d1.lengths.device
        pos = torch.arange(cap, device=dev)
        i1 = torch.clamp(pos // n2, max=d1.size)
        i2 = torch.clamp(pos % n2, max=d2.size)
        cols = [ColVal(d.lengths[i], d.validity[i], d.chars[i])
                for d, i in ((d1, i1), (d2, i2))]
        out = rebound.emit(EvalContext(cols, cells, cap, dev))
        return (ColVal(out.data, out.validity, out.chars), subtree, d2)

    return d1.aux(("expr2",) + _expr_key(subtree) + (d2.fingerprint,),
                  build)[0]


class DictGather(Expression):
    """``f(col)`` as a gather: the aux table at ``aux_ordinal`` holds
    ``f`` evaluated over the dictionary (null slot last), and each
    row's code (a null row's, the null slot) indexes it.  For ``f`` the
    identity, this is the decode folded into the stage (counted as a
    fused decode).  ``is_precomputed_hash`` marks a partition key's
    per-code hash table (``hash_planes``): ``hash_keys`` takes its
    value as the column's hash."""

    def __init__(self, aux_ordinal: int, col_ordinal: int, dict_size: int,
                 dtype: DataType, nullable: bool, out_name: str,
                 precomputed_hash: bool = False):
        self.aux_ordinal = int(aux_ordinal)
        self.col_ordinal = int(col_ordinal)
        self.dict_size = int(dict_size)
        self._dtype = dtype
        self._nullable = nullable
        self.out_name = out_name
        self.is_precomputed_hash = precomputed_hash
        self.children = ()

    @property
    def dtype(self) -> DataType:
        return self._dtype

    @property
    def nullable(self) -> bool:
        return self._nullable

    @property
    def name(self) -> str:
        return self.out_name

    def key(self) -> str:
        h = ":h" if self.is_precomputed_hash else ""
        return (f"dictgather[{self.aux_ordinal},{self.col_ordinal},"
                f"{self.dict_size}:{self._dtype.name}{h}]")

    def emit(self, ctx: EvalContext) -> ColVal:
        col = ctx.cols[self.col_ordinal]
        return _gather_table(ctx.aux[self.aux_ordinal], torch.where(
            col.validity, col.data.to(torch.int64),
            torch.full_like(col.data, self.dict_size, dtype=torch.int64)))


def _gather_table(aux: ColVal, idx: torch.Tensor) -> ColVal:
    idx = idx.clamp(0, aux.data.shape[0] - 1)
    return ColVal(aux.data[idx], aux.validity[idx],
                  None if aux.chars is None else aux.chars[idx])


class DictGather2(Expression):
    """``f(col1, col2)`` as one gather of a composed table (see
    ``_eval_over_dict_pair``) by ``code1 * (size2 + 1) + code2``, a null
    row's code its null slot."""

    def __init__(self, aux_ordinal: int, ord1: int, ord2: int, size1: int,
                 size2: int, dtype: DataType, nullable: bool,
                 out_name: str):
        self.aux_ordinal = int(aux_ordinal)
        self.ord1, self.ord2 = int(ord1), int(ord2)
        self.size1, self.size2 = int(size1), int(size2)
        self._dtype = dtype
        self._nullable = nullable
        self.out_name = out_name
        self.children = ()

    @property
    def dtype(self) -> DataType:
        return self._dtype

    @property
    def nullable(self) -> bool:
        return self._nullable

    @property
    def name(self) -> str:
        return self.out_name

    def key(self) -> str:
        return (f"dictgather2[{self.aux_ordinal},{self.ord1},{self.ord2},"
                f"{self.size1}x{self.size2}:{self._dtype.name}]")

    def emit(self, ctx: EvalContext) -> ColVal:
        c1, c2 = ctx.cols[self.ord1], ctx.cols[self.ord2]
        code1 = torch.where(c1.validity, c1.data.to(torch.int64),
                            torch.full_like(c1.data, self.size1,
                                            dtype=torch.int64))
        code2 = torch.where(c2.validity, c2.data.to(torch.int64),
                            torch.full_like(c2.data, self.size2,
                                            dtype=torch.int64))
        return _gather_table(ctx.aux[self.aux_ordinal],
                             code1 * (self.size2 + 1) + code2)


class CodeRef(Expression):
    """A bare reference to an encoded column inside a code view: passes
    the codes through (the logical type stays STRING; the view re-wraps
    the output as an ``EncodedColumn``)."""

    def __init__(self, ordinal: int, nullable: bool, out_name: str):
        self.ordinal = int(ordinal)
        self._nullable = nullable
        self.out_name = out_name
        self.children = ()

    @property
    def dtype(self) -> DataType:
        return STRING

    @property
    def nullable(self) -> bool:
        return self._nullable

    @property
    def name(self) -> str:
        return self.out_name

    def key(self) -> str:
        return f"coderef[{self.ordinal}]"

    def emit(self, ctx: EvalContext) -> ColVal:
        return ctx.cols[self.ordinal]


# ---------------------------------------------------------------------------
# the stage code view
# ---------------------------------------------------------------------------

class StageView:
    """The code-domain view of one stage batch: the rewritten steps, the
    input ColVals (codes for encoded columns), the aux gather tables (a
    separate ordinal space, ``EvalContext.aux``, so that a filter's
    compaction never sweeps them), the wrap map re-wrapping code
    outputs as ``EncodedColumn``s, and the rewritten partition keys."""

    __slots__ = ("steps", "cols", "aux", "wrap", "keys")

    def __init__(self, steps, cols, aux, wrap, keys):
        self.steps = steps
        self.cols = cols
        self.aux = aux
        self.wrap = wrap
        self.keys = keys

    def wrap_column(self, i: int, data, valid, rows: int):
        d = self.wrap.get(i)
        return None if d is None else EncodedColumn(data, valid, rows, d)


def _refs(expr: Expression) -> set:
    out = set()

    def walk(e):
        if isinstance(e, BoundReference):
            out.add(e.ordinal)
        for c in e.children:
            walk(c)
    walk(expr)
    return out


def _deterministic(expr: Expression) -> bool:
    from spark_rapids_tpu_torch.exprs.nondeterministic import \
        contains_nondeterministic
    return not contains_nondeterministic(expr)


def stage_view(steps, batch, keys: Sequence[Expression] = (),
               keys_hash: bool = True) -> StageView:
    """The code-domain view of ``steps`` (and trailing partition-key
    expressions) over ``batch``.  Each plane column decodes here, in
    the stage's own pass (counted ``fused_decodes``, as ``plane_view``
    does), and the steps read it dense.  Then for each encoded input
    column:

    * a deterministic subtree whose references are exactly that column
      becomes a ``DictGather`` of planes evaluated once over the
      dictionary: predicates become code-set membership, scalar
      functions per-code tables, and a bare reference under a
      value-domain parent a decode folded into the stage;
    * a deterministic subtree over exactly two encoded columns becomes a
      ``DictGather2`` when the composed table fits ``maxComposedCells``;
    * a bare reference that is a step output stays codes (``CodeRef``)
      and its output re-wraps onto the same dictionary;
    * a key that is a bare reference hashes by its dictionary's per-code
      hash table, so every row lands where the dense path puts it (with
      ``keys_hash`` false, keys are values: a range partition's sort
      keys).

    With no encoded column the steps are unchanged."""
    cols = [_fused_colval(c) if isinstance(c, _PlaneColumn)
            else code_colval(c) for c in batch.columns]
    return _code_view(steps, batch, cols, keys, keys_hash)


def _code_view(steps, batch, cols: List[ColVal],
               keys: Sequence[Expression], keys_hash: bool) -> StageView:
    """``stage_view``'s rewrite over the input ``cols`` the caller read
    (an encoded column's codes among them)."""
    enc = {i: c for i, c in enumerate(batch.columns)
           if isinstance(c, EncodedColumn)}
    if not enc:
        return StageView(tuple(steps), cols, (), {},
                         tuple(keys) if keys else None)
    aux: List[ColVal] = []
    aux_at: Dict[tuple, int] = {}

    def aux_ordinal(planes: ColVal, memo_key) -> int:
        hit = aux_at.get(memo_key)
        if hit is None:
            hit = aux_at[memo_key] = len(aux)
            aux.append(planes)
        return hit

    live: Dict[int, DictPlanes] = {i: c.dict for i, c in enc.items()}

    def rewrite(expr: Expression, is_output: bool):
        refs = _refs(expr)
        enc_refs = refs & set(live)
        if not enc_refs:
            return expr, None
        target = expr.children[0] if isinstance(expr, Alias) else expr
        if is_output and isinstance(target, BoundReference) \
                and target.ordinal in live:
            return (CodeRef(target.ordinal, target.nullable, expr.name),
                    live[target.ordinal])
        if refs == enc_refs and not isinstance(expr, Alias) \
                and _deterministic(expr):
            if len(enc_refs) == 1:
                (o,) = enc_refs
                d = live[o]
                planes = _eval_over_dict(d, expr, o)
                a = aux_ordinal(planes, ("expr", id(expr), o))
                if isinstance(expr, BoundReference):
                    _bump("fused_decodes")
                return (DictGather(a, o, d.size, expr.dtype, expr.nullable,
                                   expr.name), None)
            if len(enc_refs) == 2:
                o1, o2 = sorted(enc_refs)
                d1, d2 = live[o1], live[o2]
                cells = (d1.size + 1) * (d2.size + 1)
                if 0 < cells <= _MAX_COMPOSED_CELLS:
                    planes = _eval_over_dict_pair(d1, d2, expr, o1, o2)
                    a = aux_ordinal(planes, ("expr2", id(expr), o1, o2))
                    _bump("composed_gathers")
                    return (DictGather2(a, o1, o2, d1.size, d2.size,
                                        expr.dtype, expr.nullable,
                                        expr.name), None)
        if not expr.children:
            return expr, None
        kids = [rewrite(c, False)[0] for c in expr.children]
        if all(a is b for a, b in zip(kids, expr.children)):
            return expr, None
        return expr.with_children(kids), None

    out_steps = []
    for kind, exprs in steps:
        if kind == "project":
            new, nxt = [], {}
            for oi, e in enumerate(exprs):
                ne, d = rewrite(e, True)
                new.append(ne)
                if d is not None:
                    nxt[oi] = d
            out_steps.append(("project", tuple(new)))
            live = nxt
        else:  # a filter keeps the columns and their ordinals
            out_steps.append(("filter", (rewrite(exprs[0], False)[0],)))
    new_keys = None
    if keys:
        new_keys = []
        for k in keys:
            target = k.children[0] if isinstance(k, Alias) else k
            if keys_hash and isinstance(target, BoundReference) \
                    and target.ordinal in live:
                d = live[target.ordinal]
                a = aux_ordinal(hash_planes(d), ("hash", target.ordinal))
                new_keys.append(DictGather(
                    a, target.ordinal, d.size, STRING, target.nullable,
                    k.name, precomputed_hash=True))
            else:
                new_keys.append(rewrite(k, False)[0])
        new_keys = tuple(new_keys)
    if enc:
        _bump("code_stages")
    return StageView(tuple(out_steps), cols, tuple(aux), dict(live),
                     new_keys)


def encoded_ref(expr: Expression, batch) -> Optional[EncodedColumn]:
    """The encoded column ``expr`` is a bare reference to, else None."""
    r = _bare_ref(expr)
    c = batch.columns[r.ordinal] if r is not None \
        and r.ordinal < len(batch.columns) else None
    return c if isinstance(c, EncodedColumn) else None


def eval_view(exprs: Sequence[Expression], batch, hashed: bool = False
              ) -> Tuple[EvalContext, Tuple[Expression, ...]]:
    """``exprs`` over ``batch`` through its code view -> (the context,
    the rewritten expressions): encoded columns read as codes, each
    subtree over one a gather of its dictionary table; ``hashed`` takes
    the expressions for hash keys (``stage_view``'s keys).  A plane
    column reads as dense, through its late decode, which the rows'
    gather after it reuses."""
    view = _code_view((), batch, [code_colval(c) for c in batch.columns],
                      exprs, hashed)
    ctx = EvalContext(view.cols, batch.num_rows, batch.capacity,
                      batch.device, aux=view.aux)
    return ctx, tuple(view.keys) if view.keys is not None else ()


# ---------------------------------------------------------------------------
# unification: one dictionary for the batches of a column
# ---------------------------------------------------------------------------

def _translate(col: EncodedColumn, trans: np.ndarray) -> torch.Tensor:
    """The column's codes mapped through ``trans`` (old code -> new), a
    null row's to 0."""
    return _map_codes(col, torch.from_numpy(
        np.ascontiguousarray(trans, np.int32)).to(col.codes.device))


def _map_codes(col: EncodedColumn, t: torch.Tensor) -> torch.Tensor:
    if t.numel() == 0:
        return torch.zeros_like(col.codes)
    idx = col.codes.to(torch.int64).clamp(0, t.numel() - 1)
    return torch.where(col.validity, t[idx], torch.zeros_like(col.codes))


def _union_rows(dicts: Sequence[DictPlanes]):
    """The sorted union of several dictionaries' values -> (its chars and
    lengths, and each dictionary's translation into it)."""
    width = max(d.width for d in dicts)
    chars = np.concatenate([np.pad(d.host_chars[:d.size],
                                   ((0, 0), (0, width - d.width)))
                            for d in dicts])
    lengths = np.concatenate([d.host_lengths[:d.size] for d in dicts])
    rows, codes = dictionary_host(chars, lengths, max(1, chars.shape[0]))
    trans, off = [], 0
    for d in dicts:
        trans.append(codes[off:off + d.size])
        off += d.size
    return chars[rows], lengths[rows], trans


def unify_columns(cols: Sequence[EncodedColumn]
                  ) -> Tuple[List[EncodedColumn], DictPlanes]:
    """Every column re-keyed onto one shared dictionary (the sorted union
    of their values); columns already on it pass through.  The union is
    sorted, so codes stay ranks."""
    first = cols[0].dict
    if all(c.dict.same_values(first) for c in cols):
        return [c if c.dict is first else
                EncodedColumn(c.codes, c.validity, c.num_rows, first)
                for c in cols], first
    chars, lengths, trans = _union_rows([c.dict for c in cols])
    union = DictPlanes(chars, lengths, cols[0].codes.device)
    return [EncodedColumn(_translate(c, t), c.validity, c.num_rows, union)
            for c, t in zip(cols, trans)], union


def unify_ordinals(col_lists: List[list]) -> Dict[int, DictPlanes]:
    """For each column index where every batch's column is encoded, put
    them all on one dictionary in place in ``col_lists``; -> ordinal ->
    that dictionary."""
    out: Dict[int, DictPlanes] = {}
    for ci in range(len(col_lists[0])):
        cl = [cols[ci] for cols in col_lists]
        if all(isinstance(c, EncodedColumn) for c in cl):
            unified, d = unify_columns(cl)
            for bi, u in enumerate(unified):
                col_lists[bi][ci] = u
            out[ci] = d
    return out


def rekey_for_join(col: EncodedColumn, build_dict: DictPlanes
                   ) -> DeviceColumn:
    """One side's codes in the other side's code space, for an equi-join
    across dictionaries: a value in ``build_dict`` takes its code there,
    a value absent from it a distinct code past its size, which never
    equals a build code.  -> a plain INT32 key column (the payload stays
    encoded)."""
    if col.dict.same_values(build_dict):
        return DeviceColumn(INT32, col.codes, col.validity, col.num_rows)

    def build():
        _, _, (tb, ts) = _union_rows([build_dict, col.dict])
        pos = np.full(tb.shape[0] + ts.shape[0] + 1, -1, np.int64)
        pos[tb] = np.arange(tb.shape[0])
        trans = pos[ts] if ts.size else np.zeros(0, np.int64)
        trans = np.where(trans >= 0, trans,
                         build_dict.size + np.arange(ts.shape[0]))
        return torch.from_numpy(np.ascontiguousarray(trans, np.int32)).to(
            col.codes.device)

    # built once a pair of dictionaries: every stream batch over the same
    # dictionary, and each half of a split one, reuses the translation
    held, trans = col.dict.aux(("rekey", build_dict.fingerprint),
                               lambda: (build_dict, build()))
    if not held.same_values(build_dict):      # a fingerprint collision
        trans = build()
    return DeviceColumn(INT32, _map_codes(col, trans), col.validity,
                        col.num_rows)


# ---------------------------------------------------------------------------
# the aggregate's code views
# ---------------------------------------------------------------------------

def _bare_ref(expr: Expression) -> Optional[BoundReference]:
    t = expr.children[0] if isinstance(expr, Alias) else expr
    return t if isinstance(t, BoundReference) else None


def agg_code_view(batch, groupings, value_exprs: Sequence = ()):
    """The update phase's code view: a grouping that is a bare reference
    to an encoded column groups by its codes (ranks, so the groups, their
    order and representatives are the strings'), its output re-wrapped
    onto the dictionary.  A column a value-domain expression also reads
    (a non-bare grouping, an aggregate's input) keeps its dense planes.
    Encoded columns nothing reads stand in as codes.  -> (batch2,
    groupings2, wrap: grouping position -> DictPlanes), or None."""
    if not _ENABLED or not has_encoded(batch):
        return None
    bare = {g.ordinal for g in map(_bare_ref, groupings) if g is not None}
    other = set()
    for g in groupings:
        r = _bare_ref(g)
        if r is None:
            other |= _refs(g)
    for e in value_exprs:
        other |= _refs(e)
    viewable: Dict[int, DictPlanes] = {}
    groupings2 = []
    for g in groupings:
        r = _bare_ref(g)
        c = batch.columns[r.ordinal] if r is not None \
            and r.ordinal < len(batch.columns) else None
        if isinstance(c, EncodedColumn) and r.ordinal not in other:
            viewable[r.ordinal] = c.dict
            groupings2.append(BoundReference(r.ordinal, INT32, r.nullable,
                                             r.col_name))
        else:
            groupings2.append(g)
    passive = {i for i, c in enumerate(batch.columns)
               if isinstance(c, EncodedColumn) and i not in other
               and i not in bare}
    if not viewable and not passive:
        return None
    batch2 = codes_stand_in(batch, keep=other)
    wrap = {gi: viewable[_bare_ref(g).ordinal]
            for gi, g in enumerate(groupings)
            if _bare_ref(g) is not None
            and _bare_ref(g).ordinal in viewable}
    return batch2, groupings2, wrap


def key_columns_code_view(batch, nk: int):
    """The merge and evaluate phases' code view: the first ``nk``
    columns of a partial are the group keys; encoded ones stand in as
    INT32 codes.  -> (batch2, {key position: INT32}, wrap: key position
    -> DictPlanes), or None."""
    if not _ENABLED:
        return None
    wrap = {ki: batch.columns[ki].dict for ki in range(nk)
            if isinstance(batch.columns[ki], EncodedColumn)}
    if not wrap:
        return None
    return codes_stand_in(batch, keep=set(range(nk, len(batch.columns)))), \
        {ki: INT32 for ki in wrap}, wrap


# ---------------------------------------------------------------------------
# row gathers
# ---------------------------------------------------------------------------

def col_planes(c, as_codes: bool) -> tuple:
    """THE flatten of one column for a kernel that only gathers rows:
    ``(data, validity, chars)``, an encoded column's codes and validity
    when ``as_codes`` (its chars None), else its dense planes (a late
    decode)."""
    if as_codes and isinstance(c, EncodedColumn):
        return (c.codes, c.validity, None)
    return (c.data, c.validity, c.chars)


def wrap_gathered(src_columns, outs, rows: int, schema, extra_wrap=None):
    """A batch of gathered planes, a column whose source was encoded
    re-wrapped onto its dictionary (a row gather keeps the code space);
    ``extra_wrap`` names another dictionary for a position."""
    from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
    cols = []
    for i, (c, (d, v, ch)) in enumerate(zip(src_columns, outs)):
        over = extra_wrap.get(i) if extra_wrap else None
        if over is not None:
            cols.append(EncodedColumn(d, v, rows, over))
        elif isinstance(c, EncodedColumn):
            cols.append(EncodedColumn(d, v, rows, c.dict))
        else:
            cols.append(DeviceColumn(c.dtype, d, v, rows, ch))
    return ColumnarBatch(cols, rows, schema)


# ---------------------------------------------------------------------------
# the join's code view
# ---------------------------------------------------------------------------

class _StreamJoinView:
    """One stream batch's key view: the batch the keys are evaluated
    over (re-keyed codes for the code pairs) and the key expressions."""

    __slots__ = ("key_batch", "lkeys")

    def __init__(self, key_batch, lkeys):
        self.key_batch = key_batch
        self.lkeys = lkeys


class JoinCodeView:
    """Equi-join keys compared as codes: a key pair whose two sides are
    bare references to encoded columns joins in the code domain.  The
    build side keeps its rank codes; each stream batch re-keys its codes
    into the build's code space (``rekey_for_join``: a shared dictionary
    maps 1:1, a value absent from the build maps past it and never
    matches).  The rewritten keys are INT32 references, so the hash, the
    key check and the dense lookup table all run on small ints.

    The port evaluates keys over a key batch and gathers the output from
    the original batches, so payload columns stay encoded and a stream
    column's output keeps its own dictionary.  A pair may claim an
    ordinal no other key reads; other keys over encoded columns read
    their dense planes (a late decode).  A stream batch whose pair
    column arrived dense takes the dense keys against the build's dense
    key view."""

    def __init__(self, b_batch, left_keys, right_keys):
        self.left_keys = list(left_keys)
        self.right_keys = list(right_keys)
        self.pairs: Dict[int, Tuple[int, int, DictPlanes]] = {}
        if _ENABLED and has_encoded(b_batch):
            for ki, (lk, rk) in enumerate(zip(left_keys, right_keys)):
                lt, rt = _bare_ref(lk), _bare_ref(rk)
                if lt is None or rt is None:
                    continue
                other_l, other_r = set(), set()
                for kj, (lk2, rk2) in enumerate(zip(left_keys,
                                                    right_keys)):
                    if kj != ki:
                        other_l |= _refs(lk2)
                        other_r |= _refs(rk2)
                c = b_batch.columns[rt.ordinal] \
                    if rt.ordinal < len(b_batch.columns) else None
                if isinstance(c, EncodedColumn) \
                        and lt.ordinal not in other_l \
                        and rt.ordinal not in other_r:
                    self.pairs[ki] = (lt.ordinal, rt.ordinal, c.dict)
        b_refs = set()
        for e in right_keys:
            b_refs |= _refs(e)
        self._s_refs = set()
        for e in left_keys:
            self._s_refs |= _refs(e)
        pair_b = {b for _, b, _ in self.pairs.values()}
        self._b_orig = b_batch
        self._b_dense = None
        self._b_refs = b_refs
        # the build's key batch: pair columns as their codes, key columns
        # of other keys dense, every other encoded column a stand-in
        self.build_keys = codes_stand_in(b_batch, keep=b_refs - pair_b)
        self.rkeys = [BoundReference(self.pairs[ki][1], INT32, rk.nullable,
                                     rk.name) if ki in self.pairs else rk
                      for ki, rk in enumerate(right_keys)]

    @property
    def code_keys(self) -> bool:
        return bool(self.pairs)

    def dense_build_keys(self):
        """The build's key batch for a stream batch that arrived dense."""
        if self._b_dense is None:
            self._b_dense = codes_stand_in(self._b_orig, keep=self._b_refs)
        return self._b_dense

    def stream_tag(self, sb) -> str:
        """"code" when every pair's stream column arrived encoded (the
        keys compare as codes), else "dense"."""
        return "code" if self.pairs and all(
            isinstance(sb.columns[s], EncodedColumn)
            for s, _, _ in self.pairs.values()) else "dense"

    def for_stream(self, sb) -> _StreamJoinView:
        from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
        if self.stream_tag(sb) == "code":
            cols = list(sb.columns)
            lkeys = list(self.left_keys)
            for ki, (s, _, bdict) in self.pairs.items():
                cols[s] = rekey_for_join(cols[s], bdict)
                lk = self.left_keys[ki]
                lkeys[ki] = BoundReference(s, INT32, lk.nullable, lk.name)
            kb = codes_stand_in(ColumnarBatch(cols, sb.num_rows, sb.schema),
                                keep=self._s_refs)
            return _StreamJoinView(kb, lkeys)
        return _StreamJoinView(codes_stand_in(sb, keep=self._s_refs),
                               self.left_keys)


# ---------------------------------------------------------------------------
# the result pull
# ---------------------------------------------------------------------------

def strings_from_codes(d: DictPlanes, codes: np.ndarray,
                       valid: np.ndarray):
    """Host codes of a column on dictionary ``d`` -> its strings, looked
    up in the dictionary's host copy (a null row reads the null slot's
    zeros); counts the result pull's raw and wire bytes of the column
    (codes and validity crossed, the dense planes did not)."""
    from spark_rapids_tpu_torch.columnar import transfer
    from spark_rapids_tpu_torch.columnar.batch import HostStrings
    n = int(codes.shape[0])
    idx = np.where(valid, codes, d.size).clip(0, d.capacity - 1)
    transfer._bump_d2h("wire_bytes", n * (4 + 1))
    transfer._bump_d2h("raw_bytes", n * (4 + 1 + d.width))
    return HostStrings(d.host_chars[idx], d.host_lengths[idx])
