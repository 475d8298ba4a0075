"""SQL data types and schemas with numpy / torch / arrow mappings.

Counterpart of ``spark_rapids_tpu/columnar/dtypes.py``.  The same Spark
scalar types, with date as days-since-epoch int32.  DOUBLE is always
``torch.float64``: the card computes f64 natively, so the TPU package's
``double_as_float`` demotion has no counterpart here.

A STRING column's data plane holds the int32 byte lengths; its bytes
sit beside it in a (capacity, width) uint8 char matrix
(``columnar/column.py``).  TIMESTAMP is microseconds since the epoch in
an int64 plane, UTC only: it comes from Arrow timestamps (UTC or naive)
and from numpy ``datetime64`` arrays, and goes back to Arrow as
``timestamp[us, tz=UTC]``.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch


class DataType:
    name: str = "?"
    numpy_dtype = None      # host and device representation

    def __repr__(self):
        return self.name

    def __eq__(self, other):
        return type(self) is type(other)

    def __hash__(self):
        return hash(type(self))

    @property
    def is_numeric(self) -> bool:
        return self in (INT8, INT16, INT32, INT64, FLOAT32, FLOAT64)

    @property
    def is_integral(self) -> bool:
        return self in (INT8, INT16, INT32, INT64)

    @property
    def is_floating(self) -> bool:
        return self in (FLOAT32, FLOAT64)


class BooleanType(DataType):
    name = "boolean"; numpy_dtype = np.bool_

class ByteType(DataType):
    name = "byte"; numpy_dtype = np.int8

class ShortType(DataType):
    name = "short"; numpy_dtype = np.int16

class IntegerType(DataType):
    name = "int"; numpy_dtype = np.int32

class LongType(DataType):
    name = "long"; numpy_dtype = np.int64

class FloatType(DataType):
    name = "float"; numpy_dtype = np.float32

class DoubleType(DataType):
    name = "double"; numpy_dtype = np.float64

class DateType(DataType):
    """Days since unix epoch, int32 (arrow date32)."""
    name = "date"; numpy_dtype = np.int32

class TimestampType(DataType):
    """Microseconds since unix epoch, int64, UTC only."""
    name = "timestamp"; numpy_dtype = np.int64

class StringType(DataType):
    name = "string"; numpy_dtype = None


BOOLEAN = BooleanType()
INT8 = ByteType()
INT16 = ShortType()
INT32 = IntegerType()
INT64 = LongType()
FLOAT32 = FloatType()
FLOAT64 = DoubleType()
DATE = DateType()
TIMESTAMP = TimestampType()
STRING = StringType()

_TORCH = {
    "boolean": torch.bool, "byte": torch.int8, "short": torch.int16,
    "int": torch.int32, "long": torch.int64, "float": torch.float32,
    "double": torch.float64, "date": torch.int32, "timestamp": torch.int64,
    "string": torch.int32,  # the lengths plane; the bytes are in chars
}


def device_dtype(dt: DataType) -> torch.dtype:
    """torch dtype of this column type's on-device data plane."""
    try:
        return _TORCH[dt.name]
    except KeyError:
        raise NotImplementedError(f"{dt.name} columns: later slice") from None


class Field:
    __slots__ = ("name", "dtype", "nullable")

    def __init__(self, name: str, dtype: DataType, nullable: bool = True):
        self.name = name
        self.dtype = dtype
        self.nullable = nullable

    def __repr__(self):
        return f"{self.name}:{self.dtype}{'?' if self.nullable else ''}"

    def __eq__(self, other):
        return (isinstance(other, Field) and self.name == other.name
                and self.dtype == other.dtype)

    def __hash__(self):
        return hash((self.name, self.dtype))


class Schema:
    def __init__(self, fields: List[Field]):
        self.fields = list(fields)

    def __len__(self):
        return len(self.fields)

    def __iter__(self):
        return iter(self.fields)

    def __getitem__(self, i):
        return self.fields[i]

    def __repr__(self):
        return "Schema(" + ", ".join(map(repr, self.fields)) + ")"

    def __eq__(self, other):
        return isinstance(other, Schema) and self.fields == other.fields

    def field_index(self, name: str) -> int:
        for i, f in enumerate(self.fields):
            if f.name == name:
                return i
        raise KeyError(f"no field {name!r} in {self}")

    @property
    def names(self) -> List[str]:
        return [f.name for f in self.fields]

    def to_arrow(self):
        import pyarrow as pa
        return pa.schema([pa.field(f.name, to_arrow_type(f.dtype), f.nullable)
                          for f in self.fields])

    @staticmethod
    def from_arrow(schema) -> "Schema":
        return Schema([Field(f.name, from_arrow_type(f.type), f.nullable)
                       for f in schema])


def from_numpy_dtype(dtype: np.dtype) -> DataType:
    """numpy array dtype -> column type, for ``create_dataframe`` dicts."""
    dtype = np.dtype(dtype)
    for dt in (BOOLEAN, INT8, INT16, INT32, INT64, FLOAT32, FLOAT64):
        if dtype == np.dtype(dt.numpy_dtype):
            return dt
    if dtype == np.dtype("datetime64[D]"):
        return DATE
    if dtype.kind == "M":
        # any finer datetime64 unit: microseconds since the epoch, as the
        # JAX package takes such an array through Arrow
        return TIMESTAMP
    if dtype.kind in ("U", "S", "O"):
        return STRING
    raise TypeError(f"unsupported numpy dtype {dtype}")


def from_arrow_type(t) -> DataType:
    import pyarrow as pa
    table = {
        pa.bool_(): BOOLEAN, pa.int8(): INT8, pa.int16(): INT16,
        pa.int32(): INT32, pa.int64(): INT64, pa.float32(): FLOAT32,
        pa.float64(): FLOAT64, pa.string(): STRING,
        pa.large_string(): STRING, pa.date32(): DATE,
    }
    if t in table:
        return table[t]
    if pa.types.is_dictionary(t):
        # a parquet column read with read_dictionary
        return from_arrow_type(t.value_type)
    if pa.types.is_timestamp(t):
        if t.tz not in (None, "UTC", "+00:00"):
            raise TypeError(f"only UTC timestamps supported, got tz={t.tz}")
        return TIMESTAMP
    raise TypeError(f"unsupported arrow type {t}")


def to_arrow_type(dt: DataType):
    import pyarrow as pa
    table = {
        "boolean": pa.bool_(), "byte": pa.int8(), "short": pa.int16(),
        "int": pa.int32(), "long": pa.int64(), "float": pa.float32(),
        "double": pa.float64(), "date": pa.date32(), "string": pa.string(),
    }
    if dt == TIMESTAMP:
        return pa.timestamp("us", tz="UTC")
    try:
        return table[dt.name]
    except KeyError:
        raise TypeError(f"cannot map {dt} to arrow") from None


def from_name(name: str) -> DataType:
    """Spark SQL type name -> DataType (the names ``CAST`` and
    ``Column.cast`` take)."""
    names = {
        "boolean": BOOLEAN, "bool": BOOLEAN,
        "byte": INT8, "tinyint": INT8,
        "short": INT16, "smallint": INT16,
        "int": INT32, "integer": INT32,
        "long": INT64, "bigint": INT64,
        "float": FLOAT32, "real": FLOAT32, "double": FLOAT64,
        "string": STRING, "varchar": STRING, "date": DATE,
        "timestamp": TIMESTAMP,
    }
    try:
        return names[name.lower()]
    except KeyError:
        raise ValueError(f"unknown type name {name!r}") from None


def common_type(a: DataType, b: DataType) -> Optional[DataType]:
    """Numeric widening for binary ops (Spark's findTightestCommonType)."""
    if a == b:
        return a
    order: Tuple[DataType, ...] = (INT8, INT16, INT32, INT64, FLOAT32, FLOAT64)
    if a in order and b in order:
        return order[max(order.index(a), order.index(b))]
    return None
