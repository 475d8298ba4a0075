"""The torch port's columnar core against the JAX package.

Capacities must equal the JAX package's for every row count, host ->
device -> host must be the identity (exact, bit for bit for floats), and
a JAX batch's planes carried across by ``interop.batch_from_planes``
must arrive bit for bit.
"""

import numpy as np
import pyarrow as pa
import pytest

from spark_rapids_tpu.columnar import dtypes as jdt
from spark_rapids_tpu.columnar.batch import host_batch_to_device as jupload
from spark_rapids_tpu.columnar.column import bucket_capacity as jbucket

from spark_rapids_tpu_torch.columnar import dtypes as tdt
from spark_rapids_tpu_torch.columnar.batch import (
    device_batch_to_host, host_batch_to_device, host_columns_from_arrow,
    host_columns_from_numpy, host_columns_to_arrow,
)
from spark_rapids_tpu_torch.columnar.column import bucket_capacity
from spark_rapids_tpu_torch.columnar.interop import batch_from_planes


def test_bucket_capacity_matches_jax():
    for n in range(0, 5001):
        assert bucket_capacity(n) == jbucket(n), n


def _values(kind, n, rng):
    if kind == "bool":
        return rng.random(n) < 0.5
    if kind.startswith("int"):
        info = np.iinfo(kind)
        return rng.integers(info.min, info.max, n, dtype=kind,
                            endpoint=True)
    v = rng.normal(size=n).astype(kind)
    if n >= 4:
        v[:4] = [np.nan, -0.0, 0.0, np.inf]
    return v


KINDS = ["int64", "int32", "float32", "float64", "bool"]


def _bits(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a).view(np.uint8)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", [0, 1, 9, 1000])
def test_numpy_roundtrip_is_identity(kind, n):
    rng = np.random.default_rng(n)
    values = _values(kind, n, rng)
    mask = rng.random(n) < 0.8
    schema, cols = host_columns_from_numpy({"x": values}, {"x": mask})
    batch = host_batch_to_device(schema, cols, "cpu")
    assert batch.capacity == bucket_capacity(n)
    back_v, back_m = device_batch_to_host(batch)["x"]
    np.testing.assert_array_equal(back_m, mask)
    np.testing.assert_array_equal(_bits(back_v[mask]), _bits(values[mask]))


@pytest.mark.parametrize("kind", KINDS)
def test_arrow_roundtrip_is_identity(kind):
    rng = np.random.default_rng(1)
    values = _values(kind, 500, rng)
    mask = rng.random(500) < 0.1
    table = pa.table({"x": pa.array(values, mask=mask)})
    schema, cols = host_columns_from_arrow(table)
    batch = host_batch_to_device(schema, cols, "cpu")
    back = host_columns_to_arrow(schema, device_batch_to_host(batch))
    assert back.schema.field("x").type == table.schema.field("x").type
    zero = False if kind == "bool" else 0
    got = back.column("x").fill_null(zero).to_numpy()
    want = table.column("x").fill_null(zero).to_numpy()
    np.testing.assert_array_equal(back.column("x").is_null().to_numpy(),
                                  mask)
    np.testing.assert_array_equal(_bits(got[~mask]), _bits(want[~mask]))


def test_empty_arrow_table_roundtrip():
    table = pa.table({"x": pa.array([], pa.int64()),
                      "y": pa.array([], pa.float64())})
    schema, cols = host_columns_from_arrow(table)
    batch = host_batch_to_device(schema, cols, "cpu")
    assert batch.num_rows == 0
    back = host_columns_to_arrow(schema, device_batch_to_host(batch))
    assert back.num_rows == 0 and back.schema.names == ["x", "y"]


def test_string_columns_are_refused():
    """Strings upload now; a batch whose string width (the bucket of its
    longest string) passes maxDeviceStringWidth is refused, as in the
    JAX package."""
    schema, cols = host_columns_from_numpy(
        {"s": np.array(["a", "b" * 513])})
    with pytest.raises(ValueError, match="maxDeviceStringWidth"):
        host_batch_to_device(schema, cols, "cpu", max_string_width=512)
    batch = host_batch_to_device(schema, cols, "cpu", max_string_width=1024)
    assert batch.columns[0].string_width == 1024


def test_interop_reproduces_jax_planes_bit_for_bit():
    rng = np.random.default_rng(9)
    n = 777
    f64 = rng.normal(size=n)
    f64[:3] = [np.nan, -0.0, np.inf]
    table = pa.table({
        "k": pa.array(rng.integers(-9, 9, n), pa.int64(),
                      mask=rng.random(n) < 0.1),
        "i": pa.array(rng.integers(-5, 5, n).astype(np.int32)),
        "f": pa.array(rng.normal(size=n).astype(np.float32)),
        "d": pa.array(f64, mask=rng.random(n) < 0.2),
        "b": pa.array(rng.random(n) < 0.5),
    })
    jb = jupload(table, jdt.Schema.from_arrow(table.schema))
    planes = [(np.asarray(c.data), np.asarray(c.validity))
              for c in jb.columns]
    dtypes = [tdt.INT64, tdt.INT32, tdt.FLOAT32, tdt.FLOAT64, tdt.BOOLEAN]
    tb = batch_from_planes(planes, dtypes, jb.num_rows, jb.capacity, "cpu",
                           names=table.column_names)
    assert tb.capacity == jb.capacity == bucket_capacity(n)
    for (data, valid), c in zip(planes, tb.columns):
        assert c.data.numpy().dtype == data.dtype
        np.testing.assert_array_equal(_bits(c.data.numpy()), _bits(data))
        np.testing.assert_array_equal(c.validity.numpy(), valid)
