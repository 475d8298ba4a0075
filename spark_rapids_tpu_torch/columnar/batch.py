"""Columnar batches and host <-> device conversion.

Counterpart of ``spark_rapids_tpu/columnar/batch.py``.  The host format
is a dict of numpy ``(values, validity)`` pairs, so that the main path
runs without pyarrow; Arrow tables convert to and from that format in
functions that import pyarrow when they are called.

The result pull (``columnar/transfer.py:device_pull`` in the JAX
package) is a plain ``.cpu()`` of the planes trimmed to the row count.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar.column import (
    DeviceColumn, bucket_capacity,
)
from spark_rapids_tpu_torch.columnar.dtypes import (
    DATE, STRING, Field, Schema, from_numpy_dtype, to_arrow_type,
)

# name -> (values, validity); validity True = valid
HostColumns = Dict[str, Tuple[np.ndarray, np.ndarray]]


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

    def __repr__(self):
        return (f"ColumnarBatch(rows={self.num_rows}, "
                f"cols={len(self.columns)}, cap={self.capacity})")


# ---------------------------------------------------------------------------
# host -> device
# ---------------------------------------------------------------------------

def host_values(values: np.ndarray, dtype) -> np.ndarray:
    """Host values in the column type's device representation."""
    if dtype == STRING:
        raise NotImplementedError("string columns: later slice")
    if dtype == DATE and np.issubdtype(values.dtype, np.datetime64):
        values = values.astype("datetime64[D]").astype(np.int64)
    return np.ascontiguousarray(values, dtype=dtype.numpy_dtype)


def upload_column(dtype, values: np.ndarray, validity: np.ndarray,
                  capacity: int, device) -> DeviceColumn:
    """Host values + validity -> one device column padded to capacity
    (padding rows hold 0 and are invalid, as in the JAX package)."""
    values = host_values(values, dtype)
    n = values.shape[0]
    data = np.zeros(capacity, dtype=values.dtype)
    data[:n] = values
    valid = np.zeros(capacity, dtype=np.bool_)
    valid[:n] = validity
    return DeviceColumn(dtype, torch.from_numpy(data).to(device),
                        torch.from_numpy(valid).to(device), n)


def host_batch_to_device(schema: Schema, cols: HostColumns,
                         device) -> ColumnarBatch:
    """Host columns (all of one length) -> device batch."""
    n = len(cols[schema[0].name][0]) if len(schema) else 0
    cap = bucket_capacity(n)
    out = [upload_column(f.dtype, *cols[f.name], cap, device)
           for f in schema]
    return ColumnarBatch(out, n, schema)


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
        if f.dtype == STRING:
            raise NotImplementedError("string columns: later slice")
        valid = np.ones(len(arr), np.bool_) if arr.null_count == 0 \
            else np.asarray(arr.is_valid())
        if pa.types.is_date32(arr.type):
            arr = arr.cast(pa.int32())
        if arr.null_count:
            arr = pc.fill_null(arr, False if f.dtype.name == "boolean"
                               else 0)
        cols[f.name] = (arr.to_numpy(zero_copy_only=False), valid)
    return schema, cols


# ---------------------------------------------------------------------------
# device -> host
# ---------------------------------------------------------------------------

def device_batch_to_host(batch: ColumnarBatch,
                         schema: Optional[Schema] = None) -> HostColumns:
    """Device batch -> host columns trimmed to the row count."""
    schema = schema or batch.schema
    n = batch.num_rows
    return {f.name: (c.data[:n].cpu().numpy(), c.validity[:n].cpu().numpy())
            for f, c in zip(schema, batch.columns)}


def host_columns_to_arrow(schema: Schema, cols: HostColumns):
    import pyarrow as pa
    arrays = []
    for f in schema:
        values, valid = cols[f.name]
        mask = None if valid.all() else ~valid
        arrays.append(pa.array(values, type=to_arrow_type(f.dtype),
                               mask=mask))
    return pa.Table.from_arrays(arrays, schema=schema.to_arrow())

