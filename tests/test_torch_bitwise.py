"""The torch port's bitwise expressions against the JAX package.

Neither package's ``functions`` or SQL reaches them, so both sides build
them as ``Column`` over the expression classes: ``&``, ``|``, ``^``, ``~``,
``shiftleft``, ``shiftright`` and ``shiftrightunsigned`` over byte,
short, int and long columns, with nulls, each type's minimum and -1, and
shift amounts of 0, ``bits - 1``, ``bits``, more and negative (masked to
the width, as Java masks them).  Results compare exactly, row for row.
"""

import jax
import numpy as np
import pyarrow as pa
import pytest

from spark_rapids_tpu import api as japi
from spark_rapids_tpu.exprs import bitwise as jbw
from tests.compare import assert_tables_equal, tpu_session

import spark_rapids_tpu_torch as st
from spark_rapids_tpu_torch import api as tapi
from spark_rapids_tpu_torch.exprs import bitwise as tbw


@pytest.fixture(autouse=True, scope="module")
def _drop_compiled_kernels():
    """After this file, drop the JAX package's compiled executables (its
    kernel caches and jax's own), as ``tests/conftest.py`` does between
    files once they pile up: the JAX side of these parity tests compiles
    a kernel for each new shape, and a worker process that holds too
    many crashes XLA."""
    yield
    from spark_rapids_tpu.utils import kernel_cache
    with kernel_cache._REGISTRY_LOCK:
        caches = list(kernel_cache._REGISTRY)
    for c in caches:
        c.clear()
    jax.clear_caches()


TYPES = {"byte": (np.int8, pa.int8()), "short": (np.int16, pa.int16()),
         "int": (np.int32, pa.int32()), "long": (np.int64, pa.int64())}


def _table(np_t, pa_t, n=600, seed=5):
    info = np.iinfo(np_t)
    bits = info.bits
    rng = np.random.default_rng(seed)
    a = rng.integers(info.min, info.max, n, dtype=np_t, endpoint=True)
    b = rng.integers(info.min, info.max, n, dtype=np_t, endpoint=True)
    a[:6] = [info.min, -1, 0, 1, info.max, info.min]
    b[:6] = [-1, info.min, info.max, 0, -1, 1]
    sh = rng.integers(-2 * bits, 2 * bits, n).astype(np.int32)
    sh[:8] = [0, bits - 1, bits, bits + 1, -1, -bits, 2 * bits - 1, 1]
    return pa.table({
        "a": pa.array(a, pa_t, mask=rng.random(n) < 0.08),
        "b": pa.array(b, pa_t, mask=rng.random(n) < 0.08),
        "sh": pa.array(sh, pa.int32(), mask=rng.random(n) < 0.08),
    })


def _query(api, bw, df):
    col = api.col

    def c(e):
        return api.Column(e)
    a, b, sh = col("a").expr, col("b").expr, col("sh").expr
    return df.select(
        c(bw.BitwiseAnd(a, b)).alias("and_"),
        c(bw.BitwiseOr(a, b)).alias("or_"),
        c(bw.BitwiseXor(a, b)).alias("xor_"),
        c(bw.BitwiseNot(a)).alias("not_"),
        c(bw.ShiftLeft(a, sh)).alias("shl"),
        c(bw.ShiftRight(a, sh)).alias("shr"),
        c(bw.ShiftRightUnsigned(a, sh)).alias("shru"),
        # a literal amount, and the long amount cast to the value's type
        c(bw.ShiftRightUnsigned(a, api.lit(1).expr)).alias("shru1"),
        c(bw.ShiftLeft(a, b)).alias("shl_b"),
        c(bw.BitwiseAnd(a, api.lit(255).expr)).alias("and_lit"))


@pytest.mark.parametrize("name", sorted(TYPES))
def test_bitwise_matches_jax(name):
    t = _table(*TYPES[name])
    want = _query(japi, jbw, tpu_session().create_dataframe(t)).to_arrow()
    got = _query(tapi, tbw, st.TorchSession(
        {"spark.rapids.torch.device": "cpu"}).create_dataframe(t)).to_arrow()
    assert got.schema == want.schema
    assert_tables_equal(got, want, ignore_order=False)


def test_unsigned_shift_edges():
    """``>>>`` at INT64_MIN and -1, by 0, 1, 63, 64 and -1."""
    vals = np.array([np.iinfo(np.int64).min, -1, -1, -1, -1, 5],
                    dtype=np.int64)
    sh = np.array([1, 0, 63, 64, -1, 2], dtype=np.int32)
    s = st.TorchSession({"spark.rapids.torch.device": "cpu"})
    df = s.create_dataframe({"a": vals, "sh": sh})
    got = [r["x"] for r in df.select(tapi.Column(tbw.ShiftRightUnsigned(
        tapi.col("a").expr, tapi.col("sh").expr)).alias("x")).collect()]
    assert got == [1 << 62, -1, 1, -1, 1, 1]
