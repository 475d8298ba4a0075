"""Columnar batches and host <-> device conversion.

Counterpart of ``spark_rapids_tpu/columnar/batch.py``.  The host format
is a dict of numpy ``(values, validity)`` pairs, so that the main path
runs without pyarrow; Arrow tables convert to and from that format in
functions that import pyarrow when they are called.  A STRING column's
host values are a ``HostStrings``: the same (rows, width) uint8 char
matrix and int32 byte lengths the card holds, built from numpy ``U``
arrays or from Arrow's offsets and bytes without a loop over the rows
(``S`` and object arrays encode their values one by one).

Uploads go through ``columnar/transfer.py: Upload`` (pinned, on the
copy stream, ordered before the consumer reads the batch) and every
pull through ``columnar/transfer.py: device_pull``, one pull a batch.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar.column import (
    DeviceColumn, bucket_capacity,
)
from spark_rapids_tpu_torch.columnar.dtypes import (
    DATE, STRING, TIMESTAMP, Field, Schema, from_numpy_dtype, to_arrow_type,
)


class HostStrings:
    """Host string values: ``chars`` (rows, width) uint8, each row's
    UTF-8 bytes from column 0 and zeros after them, and ``lengths``
    (rows,) int32.  Slicing rows slices both; the width stays."""

    __slots__ = ("chars", "lengths")

    def __init__(self, chars: np.ndarray, lengths: np.ndarray):
        if chars.ndim != 2 or chars.dtype != np.uint8 \
                or lengths.shape != (chars.shape[0],):
            raise ValueError(f"chars {chars.dtype}{chars.shape} and lengths "
                             f"{lengths.shape} do not form a string column")
        self.chars = chars
        self.lengths = lengths.astype(np.int32, copy=False)

    def __len__(self) -> int:
        return int(self.lengths.shape[0])

    def __getitem__(self, rows: slice) -> "HostStrings":
        return HostStrings(self.chars[rows], self.lengths[rows])

    @property
    def width(self) -> int:
        return int(self.chars.shape[1])

    def to_bytes(self) -> Tuple[np.ndarray, np.ndarray]:
        """-> (offsets int64 (rows + 1,), the rows' bytes end to end)."""
        lengths = np.clip(self.lengths.astype(np.int64), 0, self.width)
        offsets = np.zeros(len(self) + 1, np.int64)
        np.cumsum(lengths, out=offsets[1:])
        inside = np.arange(self.width)[None, :] < lengths[:, None]
        return offsets, self.chars[inside]

    def to_pylist(self) -> List[str]:
        offsets, data = self.to_bytes()
        raw = data.tobytes()
        return [raw[a:b].decode("utf-8", errors="replace")
                for a, b in zip(offsets[:-1].tolist(), offsets[1:].tolist())]

    @staticmethod
    def concat(parts: Sequence["HostStrings"]) -> "HostStrings":
        """Rows of every part in order, at the widest part's width."""
        width = max([p.width for p in parts], default=8)
        chars = np.zeros((sum(len(p) for p in parts), width), np.uint8)
        off = 0
        for p in parts:
            chars[off:off + len(p), :p.width] = p.chars
            off += len(p)
        lengths = np.concatenate([p.lengths for p in parts]) if parts \
            else np.zeros(0, np.int32)
        return HostStrings(chars, lengths)


def strings_from_bytes(offsets: np.ndarray, data: np.ndarray) -> HostStrings:
    """UTF-8 bytes laid end to end with row offsets (Arrow's layout) ->
    HostStrings; the counterpart of ``_arrow_string_to_matrix`` (JAX
    ``columnar/batch.py:164``).  Embedded NUL bytes stay, since the
    lengths are the true ones."""
    offsets = np.asarray(offsets, np.int64)
    n = offsets.shape[0] - 1
    lengths = np.diff(offsets)
    width = bucket_capacity(max(1, int(lengths.max()) if n else 1))
    chars = np.zeros((n, width), np.uint8)
    total = int(offsets[-1] - offsets[0]) if n else 0
    if total:
        rows = np.repeat(np.arange(n, dtype=np.int64), lengths)
        cols = np.arange(total, dtype=np.int64) - np.repeat(
            offsets[:-1] - offsets[0], lengths)
        chars.reshape(-1)[rows * width + cols] = \
            data[offsets[0]:offsets[-1]]
    return HostStrings(chars, lengths.astype(np.int32))


def _first_nul(units: np.ndarray) -> np.ndarray:
    """(rows, L) code units -> each row's length up to its first zero
    unit: pyarrow cuts a numpy string there, and numpy's fixed-width
    strings end where their trailing zeros begin."""
    zero = units == 0
    return np.where(zero.any(axis=1), np.argmax(zero, axis=1),
                    units.shape[1]).astype(np.int64)


def _utf8_matrix(cp: np.ndarray, ulen: np.ndarray) -> HostStrings:
    """(rows, L) Unicode code points, ``ulen`` of them in each row ->
    HostStrings, encoding UTF-8 with array operations."""
    n, L = cp.shape
    inside = np.arange(L)[None, :] < ulen[:, None]
    nb = np.where(cp < 0x80, 1, np.where(cp < 0x800, 2,
                  np.where(cp < 0x10000, 3, 4))).astype(np.int64) * inside
    lengths = nb.sum(axis=1)
    width = bucket_capacity(max(1, int(lengths.max()) if n else 1))
    chars = np.zeros((n, width), np.uint8)
    flat = chars.reshape(-1)
    # where each code point's first byte lands in the flat matrix
    at = (np.arange(n, dtype=np.int64) * width)[:, None] \
        + np.cumsum(nb, axis=1) - nb
    cp = cp.astype(np.int64)
    lead = np.where(nb == 1, cp, np.where(
        nb == 2, 0xC0 | (cp >> 6), np.where(
            nb == 3, 0xE0 | (cp >> 12), 0xF0 | (cp >> 18))))
    m = nb >= 1
    flat[at[m]] = lead[m]
    for b in range(1, 4):
        m = nb > b
        tail = 0x80 | ((cp >> (6 * (nb - 1 - b)).clip(0)) & 0x3F)
        flat[at[m] + b] = tail[m]
    return HostStrings(chars, lengths.astype(np.int32))


def strings_from_numpy(values: np.ndarray) -> Tuple[HostStrings, np.ndarray]:
    """A numpy ``U`` array, or an ``S`` or object array of strings ->
    (HostStrings, validity).  A ``U`` or ``S`` value ends at its first
    NUL, as pyarrow (and so the JAX package) reads it; an object array's
    values stay whole.  A ``U`` array converts with array operations (an
    ASCII one in one cast); the others' values are encoded one by one,
    and an object array's ``None`` is null."""
    n = values.shape[0]
    if values.dtype.kind == "U":
        L = values.dtype.itemsize // 4
        cp = np.ascontiguousarray(values).view(np.uint32).reshape(n, L)
        ulen = _first_nul(cp)
        past = np.arange(L)[None, :] >= ulen[:, None]
        if np.any(past & (cp != 0)):
            # a value holds units after a NUL: drop them (in a copy)
            cp = np.where(past, np.uint32(0), cp)
        lengths = ulen.astype(np.int32)
        # rows of ASCII take their code points as bytes; only the others
        # go through the UTF-8 encoder
        wide = np.flatnonzero((cp >= 0x80).any(axis=1)) if n and L \
            else np.zeros(0, np.int64)
        enc = _utf8_matrix(cp[wide], ulen[wide]) if wide.size else None
        if enc is not None:
            lengths[wide] = enc.lengths
        width = bucket_capacity(max(1, int(lengths.max()) if n else 1))
        chars = np.zeros((n, width), np.uint8)
        chars[:, :min(L, width)] = cp[:, :width]
        if enc is not None:
            chars[wide] = 0
            chars[wide, :enc.width] = enc.chars[:, :width]
        return HostStrings(chars, lengths), np.ones(n, np.bool_)
    items = values.tolist()
    if values.dtype.kind == "S":
        items = [v.split(b"\x00", 1)[0] for v in items]
    enc = [b"" if v is None else
           (v.encode("utf-8") if isinstance(v, str) else bytes(v))
           for v in items]
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum([len(b) for b in enc], out=offsets[1:])
    data = np.frombuffer(b"".join(enc), np.uint8)
    valid = np.array([v is not None for v in items], np.bool_)
    return strings_from_bytes(offsets, data), valid


# name -> (values, validity); validity True = valid.  values is a numpy
# array, or a HostStrings for a STRING column.
HostColumns = Dict[str, Tuple[Union[np.ndarray, HostStrings], np.ndarray]]


class ColumnarBatch:
    """A batch of device columns sharing one row count and capacity.
    ``ready``: the event of an upload the consumer's stream has not
    waited on yet (``transfer.await_upload``), else None."""

    __slots__ = ("columns", "num_rows", "schema", "ready")

    def __init__(self, columns: List[DeviceColumn], num_rows: int,
                 schema: Optional[Schema] = None):
        self.columns = columns
        self.num_rows = int(num_rows)
        self.schema = schema
        self.ready = None

    @property
    def capacity(self) -> int:
        return self.columns[0].capacity if self.columns else \
            bucket_capacity(self.num_rows)

    @property
    def device(self) -> torch.device:
        return self.columns[0].validity.device

    def size_bytes(self) -> int:
        return sum(c.size_bytes() for c in self.columns)

    def slice_rows(self, start: int, n: int) -> "ColumnarBatch":
        """Rows ``start`` to ``start + n`` at the bucket capacity of
        ``n``; padding rows are zero and invalid, and a string column
        keeps its width.  Rows that fill their bucket exactly (the halves
        of a full batch) are views of this batch's planes, so the split
        of an out-of-memory retry allocates nothing for them."""
        if start < 0 or n < 0 or start + n > self.num_rows:
            raise ValueError(f"rows [{start}, {start + n}) are not inside "
                             f"a batch of {self.num_rows}")
        cap = bucket_capacity(max(1, n))
        return ColumnarBatch([c.slice_rows(start, n, cap)
                              for c in self.columns], n, self.schema)

    def gather(self, rows: torch.Tensor, n: int) -> "ColumnarBatch":
        """The rows at ``rows`` (a string column's chars move with them,
        an encoded column's codes stay codes); the first ``n`` are live,
        the rest padding."""
        from spark_rapids_tpu_torch.columnar.encoding import col_planes, \
            wrap_gathered
        live = torch.arange(rows.shape[0], device=rows.device) < n
        outs = [(d[rows], v[rows] & live, None if ch is None else ch[rows])
                for d, v, ch in (col_planes(c, True) for c in self.columns)]
        return wrap_gathered(self.columns, outs, n, self.schema)

    def __repr__(self):
        return (f"ColumnarBatch(rows={self.num_rows}, "
                f"cols={len(self.columns)}, cap={self.capacity})")


# ---------------------------------------------------------------------------
# host -> device
# ---------------------------------------------------------------------------

def host_values(values: np.ndarray, dtype) -> np.ndarray:
    """Host values of a fixed-width column in the column type's device
    representation."""
    if dtype == DATE and np.issubdtype(values.dtype, np.datetime64):
        values = values.astype("datetime64[D]").astype(np.int64)
    if dtype == TIMESTAMP and np.issubdtype(values.dtype, np.datetime64):
        values = values.astype("datetime64[us]").astype(np.int64)
    return np.ascontiguousarray(values, dtype=dtype.numpy_dtype)


def upload_column(dtype, values, validity: np.ndarray, capacity: int,
                  device, max_string_width: Optional[int] = None,
                  up=None) -> DeviceColumn:
    """Host values + validity -> one device column padded to capacity
    (padding rows hold 0 and are invalid, as in the JAX package), its
    planes copied through ``up`` (a ``transfer.Upload``; one of its own,
    waited on at once, when None).  A string column's width is the
    bucket of this batch's longest string; past ``max_string_width`` it
    raises, as the JAX package does."""
    from spark_rapids_tpu_torch.columnar import transfer
    own = up is None
    if own:
        up = transfer.Upload(device)
    n = len(values)
    if dtype == STRING:
        width = bucket_capacity(max(1, int(values.lengths.max()) if n
                                    else 1))
        if max_string_width is not None and width > max_string_width:
            raise ValueError(
                f"string width {width} exceeds device limit "
                f"{max_string_width} (spark.rapids.sql.maxDeviceStringWidth)")
        chars = values.chars
        if chars.shape[1] != width:
            chars = np.pad(chars[:, :width],
                           ((0, 0), (0, max(0, width - chars.shape[1]))))
        col = DeviceColumn(STRING, up.plane(values.lengths, capacity),
                           up.plane(validity, capacity), n,
                           up.plane(chars, capacity))
    else:
        col = DeviceColumn(dtype, up.plane(host_values(values, dtype),
                                           capacity),
                           up.plane(validity, capacity), n)
    if own:
        transfer.await_event(up.finish())
    return col


def host_batch_to_device(schema: Schema, cols: HostColumns, device,
                         max_string_width: Optional[int] = None,
                         encoder=None, decided=None, up=None,
                         defer: bool = False) -> ColumnarBatch:
    """Host columns (all of one length) -> device batch.  ``encoder``
    (``columnar/encoding.py: IngestEncoder``, which the scans make while
    ``spark.rapids.sql.compressed.ingest`` is on) may take a string
    column: it uploads codes and a dictionary instead; a column it
    declines uploads its plain planes.  ``decided`` names the columns
    the encoder already decided on (name -> the encoded column, or None
    for plain).  Every plane goes through ``up`` (a ``transfer.Upload``,
    made here when None); with ``defer`` the batch keeps the upload's
    event in ``ready`` for the consumer to wait on
    (``pipelined_h2d``), else the current stream waits on it here."""
    from spark_rapids_tpu_torch.columnar import transfer
    n = len(cols[schema[0].name][0]) if len(schema) else 0
    cap = bucket_capacity(n)
    decided = decided or {}
    up = up if up is not None else transfer.Upload(device)
    out = []
    for f in schema:
        values, valid = cols[f.name]
        if f.name in decided:
            col = decided[f.name]
        else:
            col = None if encoder is None else \
                encoder.upload_column(values, valid, f.dtype, cap, up)
        out.append(col if col is not None else upload_column(
            f.dtype, values, valid, cap, device, max_string_width, up))
    batch = ColumnarBatch(out, n, schema)
    batch.ready = up.finish()
    if not defer:
        transfer.await_upload(batch)
    return batch


def empty_batch(schema: Schema, device) -> ColumnarBatch:
    """A batch of no rows: every column all null at the smallest
    capacity (an empty build side, a global aggregate's empty input)."""
    cap = bucket_capacity(0)
    cols = [upload_column(f.dtype, empty_host_values(f.dtype),
                          np.zeros(0, np.bool_), cap, device)
            for f in schema]
    return ColumnarBatch(cols, 0, schema)


def host_columns_from_numpy(data: Dict[str, np.ndarray],
                            masks: Optional[Dict[str, np.ndarray]] = None
                            ) -> Tuple[Schema, HostColumns]:
    """A dict of numpy arrays, with optional validity masks (True =
    valid), -> (schema, host columns)."""
    masks = masks or {}
    fields, cols = [], {}
    for name, values in data.items():
        values = np.asarray(values)
        dt = from_numpy_dtype(values.dtype)
        valid = masks.get(name)
        valid = _read_only(np.ones(len(values), np.bool_)) if valid is None \
            else np.asarray(valid, dtype=np.bool_)
        if valid.shape != values.shape:
            raise ValueError(f"mask of {name!r} has shape {valid.shape}, "
                             f"values {values.shape}")
        if dt == STRING:
            values, not_none = strings_from_numpy(values)
            valid = valid & not_none
        fields.append(Field(name, dt, True))
        cols[name] = (values, valid)
    return Schema(fields), cols


def host_columns_from_arrow(table) -> Tuple[Schema, HostColumns]:
    """Arrow Table/RecordBatch -> (schema, host columns)."""
    import pyarrow as pa
    import pyarrow.compute as pc
    schema = Schema.from_arrow(table.schema)
    cols = {}
    for f, arr in zip(schema, table.columns):
        if isinstance(arr, pa.ChunkedArray):
            arr = arr.combine_chunks()
        if pa.types.is_dictionary(arr.type):
            # a read_dictionary column the ingest encoder declined
            arr = arr.cast(arr.type.value_type)
        valid = _read_only(np.ones(len(arr), np.bool_)
                           if arr.null_count == 0
                           else np.asarray(arr.is_valid()))
        if f.dtype == STRING:
            cols[f.name] = (_arrow_strings(arr), valid)
            continue
        if pa.types.is_date32(arr.type):
            arr = arr.cast(pa.int32())
        elif pa.types.is_timestamp(arr.type):
            arr = arr.cast(pa.timestamp("us")).cast(pa.int64())
        if arr.null_count:
            arr = pc.fill_null(arr, False if f.dtype.name == "boolean"
                               else 0)
        # read zero-copy (read-only) or copied (a bool column) into an
        # array no one else holds: either way no one writes it
        cols[f.name] = (_read_only(arr.to_numpy(zero_copy_only=False)),
                        valid)
    return schema, cols


def _read_only(a: np.ndarray) -> np.ndarray:
    """``a``, which the caller made and no one else holds, marked
    read-only down to the array owning its memory: the local scan keeps
    its plane decisions only for host arrays no one can write
    (``columnar/encoding.py: _frozen``)."""
    b = a
    while isinstance(b, np.ndarray):
        b.flags.writeable = False
        b = b.base
    return a


def _arrow_strings(arr) -> HostStrings:
    """An Arrow string array -> HostStrings from its offsets and bytes,
    as JAX ``_arrow_string_to_matrix`` reads them."""
    import pyarrow as pa
    if not pa.types.is_large_string(arr.type):
        arr = arr.cast(pa.large_string())
    n = len(arr)
    if n == 0:
        return HostStrings(np.zeros((0, 8), np.uint8), np.zeros(0, np.int32))
    _, off_buf, data_buf = arr.buffers()
    offsets = np.frombuffer(off_buf, np.int64, count=n + 1,
                            offset=arr.offset * 8)
    data = np.frombuffer(data_buf, np.uint8) if data_buf is not None \
        else np.zeros(0, np.uint8)
    return strings_from_bytes(offsets, data)


# ---------------------------------------------------------------------------
# device -> host
# ---------------------------------------------------------------------------

def pull_planes(batch: ColumnarBatch) -> list:
    """What ``device_batch_to_host`` pulls of each column: the first
    ``num_rows`` rows of its planes, an encoded column's codes and
    validity while ``spark.rapids.sql.compressed.egress`` is on (off, it
    decodes on the device first)."""
    from spark_rapids_tpu_torch.columnar import encoding
    n = batch.num_rows
    out = []
    for c in batch.columns:
        if isinstance(c, encoding.EncodedColumn) \
                and encoding.egress_enabled():
            out.append((c.codes[:n], c.validity[:n], None))
        else:
            out.append((c.data[:n], c.validity[:n],
                        None if c.chars is None else c.chars[:n]))
    return out


def device_batch_to_host(batch: ColumnarBatch,
                         schema: Optional[Schema] = None,
                         metrics=None, staged=None) -> HostColumns:
    """Device batch -> host columns trimmed to the row count, every plane
    in one pull (``transfer.device_pull``; ``staged``, a
    ``transfer.start_host_copies`` of ``pull_planes(batch)``, when its
    copies were started earlier).  A string column comes back as its
    lengths and char matrix, whole (the counterpart of JAX
    ``columnar/batch.py:331``); an encoded column's strings are looked
    up in its dictionary's host copy (``encoding.strings_from_codes``)."""
    from spark_rapids_tpu_torch.columnar import transfer
    host = transfer.device_pull(
        staged if staged is not None else pull_planes(batch), metrics)
    return _host_columns(batch, schema or batch.schema, host)


def host_batch_columns(batch: ColumnarBatch,
                       schema: Optional[Schema] = None,
                       copy: bool = True) -> HostColumns:
    """A batch whose planes are host tensors -> its host columns, as
    ``device_batch_to_host`` gives them but with no pull: the result of
    a plan the placement pass put on the host (``plan/placement.py``).
    The values are copies, so a caller's write reaches no cached plane;
    ``copy=False`` shares the planes, for a batch no one else holds (a
    gather's output)."""
    host = [tuple(None if t is None else
                  (t.numpy().copy() if copy else t.numpy()) for t in planes)
            for planes in pull_planes(batch)]
    return _host_columns(batch, schema or batch.schema, host)


def _host_columns(batch: ColumnarBatch, schema: Schema,
                  host: list) -> HostColumns:
    from spark_rapids_tpu_torch.columnar import encoding
    out = {}
    for f, c, (data, valid, chars) in zip(schema, batch.columns, host):
        if isinstance(c, encoding.EncodedColumn) \
                and encoding.egress_enabled():
            out[f.name] = (encoding.strings_from_codes(c.dict, data, valid),
                           valid)
        elif chars is not None:
            out[f.name] = (HostStrings(chars, data), valid)
        else:
            out[f.name] = (data, valid)
    return out


def concat_host_values(parts: Sequence) -> Union[np.ndarray, HostStrings]:
    if parts and isinstance(parts[0], HostStrings):
        return HostStrings.concat(parts)
    return np.concatenate(parts)


def empty_host_values(dtype) -> Union[np.ndarray, HostStrings]:
    if dtype == STRING:
        return HostStrings(np.zeros((0, 8), np.uint8), np.zeros(0, np.int32))
    return np.zeros(0, dtype=dtype.numpy_dtype)


def host_columns_to_arrow(schema: Schema, cols: HostColumns):
    import pyarrow as pa
    arrays = []
    for f in schema:
        values, valid = cols[f.name]
        mask = None if valid.all() else ~valid
        if f.dtype == STRING:
            offsets, data = values.to_bytes()
            arr = pa.LargeStringArray.from_buffers(
                len(values), pa.py_buffer(offsets.tobytes()),
                pa.py_buffer(data.tobytes())).cast(pa.string())
            if mask is not None:
                import pyarrow.compute as pc
                arr = pc.if_else(pa.array(valid), arr,
                                 pa.nulls(len(values), pa.string()))
            arrays.append(arr)
            continue
        arrays.append(pa.array(values, type=to_arrow_type(f.dtype),
                               mask=mask))
    return pa.Table.from_arrays(arrays, schema=schema.to_arrow())
