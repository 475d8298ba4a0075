"""Columnar batches and host <-> device conversion.

Counterpart of ``spark_rapids_tpu/columnar/batch.py``.  The host format
is a dict of numpy ``(values, validity)`` pairs, so that the main path
runs without pyarrow; Arrow tables convert to and from that format in
functions that import pyarrow when they are called.  A STRING column's
host values are a ``HostStrings``: the same (rows, width) uint8 char
matrix and int32 byte lengths the card holds, built from numpy ``U``
arrays or from Arrow's offsets and bytes without a loop over the rows
(``S`` and object arrays encode their values one by one).

The result pull (``columnar/transfer.py:device_pull`` in the JAX
package) is a plain ``.cpu()`` of the planes trimmed to the row count.
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
    """A batch of device columns sharing one row count and capacity."""

    __slots__ = ("columns", "num_rows", "schema")

    def __init__(self, columns: List[DeviceColumn], num_rows: int,
                 schema: Optional[Schema] = None):
        self.columns = columns
        self.num_rows = int(num_rows)
        self.schema = schema

    @property
    def capacity(self) -> int:
        return self.columns[0].capacity if self.columns else \
            bucket_capacity(self.num_rows)

    @property
    def device(self) -> torch.device:
        return self.columns[0].data.device

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
        cols = []
        for c in self.columns:
            planes = []
            for a in (c.data, c.validity, c.chars):
                if a is None:
                    planes.append(None)
                    continue
                out = a[start:start + n]
                if n < cap:
                    out = a.new_zeros((cap,) + tuple(a.shape[1:]))
                    out[:n] = a[start:start + n]
                planes.append(out)
            cols.append(DeviceColumn(c.dtype, planes[0], planes[1], n,
                                     planes[2]))
        return ColumnarBatch(cols, n, self.schema)

    def gather(self, rows: torch.Tensor, n: int) -> "ColumnarBatch":
        """The rows at ``rows`` (a string column's chars move with
        them); the first ``n`` are live, the rest padding."""
        live = torch.arange(rows.shape[0], device=rows.device) < n
        cols = [DeviceColumn(c.dtype, c.data[rows], c.validity[rows] & live,
                             n, None if c.chars is None else c.chars[rows])
                for c in self.columns]
        return ColumnarBatch(cols, n, self.schema)

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
                  device, max_string_width: Optional[int] = None
                  ) -> DeviceColumn:
    """Host values + validity -> one device column padded to capacity
    (padding rows hold 0 and are invalid, as in the JAX package).  A
    string column's width is the bucket of this batch's longest string;
    past ``max_string_width`` it raises, as the JAX package does."""
    n = len(values)
    valid = np.zeros(capacity, dtype=np.bool_)
    valid[:n] = validity
    if dtype == STRING:
        width = bucket_capacity(max(1, int(values.lengths.max()) if n
                                    else 1))
        if max_string_width is not None and width > max_string_width:
            raise ValueError(
                f"string width {width} exceeds device limit "
                f"{max_string_width} (spark.rapids.sql.maxDeviceStringWidth)")
        chars = np.zeros((capacity, width), np.uint8)
        chars[:n] = values.chars[:, :width]
        lengths = np.zeros(capacity, np.int32)
        lengths[:n] = values.lengths
        return DeviceColumn(STRING, torch.from_numpy(lengths).to(device),
                            torch.from_numpy(valid).to(device), n,
                            torch.from_numpy(chars).to(device))
    values = host_values(values, dtype)
    data = np.zeros(capacity, dtype=values.dtype)
    data[:n] = values
    return DeviceColumn(dtype, torch.from_numpy(data).to(device),
                        torch.from_numpy(valid).to(device), n)


def host_batch_to_device(schema: Schema, cols: HostColumns, device,
                         max_string_width: Optional[int] = None
                         ) -> ColumnarBatch:
    """Host columns (all of one length) -> device batch."""
    n = len(cols[schema[0].name][0]) if len(schema) else 0
    cap = bucket_capacity(n)
    out = [upload_column(f.dtype, *cols[f.name], cap, device,
                         max_string_width) for f in schema]
    return ColumnarBatch(out, n, schema)


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
        valid = np.ones(len(values), np.bool_) if valid is None \
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
        valid = np.ones(len(arr), np.bool_) if arr.null_count == 0 \
            else np.asarray(arr.is_valid())
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
        cols[f.name] = (arr.to_numpy(zero_copy_only=False), valid)
    return schema, cols


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

def device_batch_to_host(batch: ColumnarBatch,
                         schema: Optional[Schema] = None) -> HostColumns:
    """Device batch -> host columns trimmed to the row count; a string
    column comes back as its lengths and char matrix, whole (the
    counterpart of JAX ``columnar/batch.py:289-330``)."""
    schema = schema or batch.schema
    n = batch.num_rows
    out = {}
    for f, c in zip(schema, batch.columns):
        valid = c.validity[:n].cpu().numpy()
        if c.chars is not None:
            out[f.name] = (HostStrings(c.chars[:n].cpu().numpy(),
                                       c.data[:n].cpu().numpy()), valid)
        else:
            out[f.name] = (c.data[:n].cpu().numpy(), valid)
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
