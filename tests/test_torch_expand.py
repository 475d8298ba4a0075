"""The torch port's rollup, cube and ``grouping_id`` against the JAX
package.

Rollup and cube over one to three keys, integer and string, with null
keys (so a null key and a rolled-up key both show as null, told apart by
``grouping_id``), and every aggregate kind the port has: count, count(*),
sum, min, max, avg, first and last, of integers, doubles and strings.
Integers, strings and nulls compare exactly; float sums and averages
within rtol 1e-9 (``approx_float``: the two packages may add a group's
values in different orders).  The rows carry no order, so they compare
as sorted lists.  Also: the Expand streams batch by batch (its output
batches each hold one input batch's rows), and a non-column key raises
as in the JAX package.
"""

import jax
import numpy as np
import pyarrow as pa
import pytest

from spark_rapids_tpu import functions as F
from tests.compare import assert_tables_equal, tpu_session

import spark_rapids_tpu_torch as st
from spark_rapids_tpu_torch import functions as TF


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


def _table(n=3000, seed=21):
    rng = np.random.default_rng(seed)
    return pa.table({
        "a": pa.array(rng.integers(0, 4, n), pa.int32(),
                      mask=rng.random(n) < 0.1),
        "b": pa.array(np.array(["x", "yy", "zzz", "w"], dtype=object)[
            rng.integers(0, 4, n)].tolist(), mask=rng.random(n) < 0.1),
        "c": pa.array(rng.integers(0, 3, n), pa.int64()),
        "v": pa.array(rng.normal(size=n), mask=rng.random(n) < 0.05),
        "i": pa.array(rng.integers(-50, 50, n), pa.int64(),
                      mask=rng.random(n) < 0.05),
        "s": pa.array(np.array(["p", "q", "rr", "sss"], dtype=object)[
            rng.integers(0, 4, n)].tolist(), mask=rng.random(n) < 0.05),
    })


def _port():
    return st.TorchSession({"spark.rapids.torch.device": "cpu"})


def _aggs(f):
    return [f.count(f.col("v")).alias("n"), f.count("*").alias("rows"),
            f.sum(f.col("i")).alias("si"), f.sum(f.col("v")).alias("sv"),
            f.min(f.col("v")).alias("lo"), f.max(f.col("i")).alias("hi"),
            f.avg(f.col("v")).alias("mean"), f.min(f.col("s")).alias("smin"),
            f.max(f.col("s")).alias("smax"),
            f.first(f.col("i")).alias("fi"), f.last(f.col("i")).alias("la"),
            f.grouping_id().alias("gid")]


CASES = {
    "rollup_a": ("rollup", ["a"]),
    "rollup_ab": ("rollup", ["a", "b"]),
    "rollup_bac": ("rollup", ["b", "a", "c"]),
    "cube_b": ("cube", ["b"]),
    "cube_ab": ("cube", ["a", "b"]),
    "cube_abc": ("cube", ["a", "b", "c"]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_grouping_sets_match_jax(case):
    mode, keys = CASES[case]
    t = _table()

    def build(f, s):
        return getattr(s.create_dataframe(t), mode)(*keys).agg(*_aggs(f))
    want = build(F, tpu_session()).to_arrow()
    got = build(TF, _port()).to_arrow()
    assert got.column_names == want.column_names
    assert_tables_equal(got, want, approx_float=True)


def test_grouping_id_alone_and_ordered():
    t = _table(800, 3)

    def build(f, s):
        return (s.create_dataframe(t).rollup("a", "c")
                .agg(f.grouping_id(), f.sum(f.col("i")).alias("si"))
                .order_by("a", "c", "grouping_id()"))
    want = build(F, tpu_session()).to_arrow()
    got = build(TF, _port()).to_arrow()
    assert got.column_names == ["a", "c", "grouping_id()", "si"]
    assert_tables_equal(got, want, ignore_order=False)


def test_expand_streams_batch_by_batch():
    """A cube over two keys sends four batches on for each input batch,
    each of the input batch's rows: nothing is concatenated first."""
    from spark_rapids_tpu_torch.exec.base import ExecContext
    from spark_rapids_tpu_torch.exec.expand import TorchExpandExec
    from spark_rapids_tpu_torch.plan.planner import plan_query
    s = _port()
    n = (1 << 20) + 10
    df = s.range(n).with_column("k", TF.col("id") % 3)
    q = df.cube("k", "id").agg(TF.count("*").alias("c"))
    root = plan_query(q.plan, s.conf)
    exp = root
    while not isinstance(exp, TorchExpandExec):
        exp = exp.children[0]
    rows = [b.num_rows for b in exp.execute(ExecContext(s.conf, s.device))]
    assert rows == [1 << 20] * 4 + [10] * 4


def test_non_column_keys_raise():
    for f, s in ((F, tpu_session()), (TF, _port())):
        df = s.create_dataframe(_table(10))
        with pytest.raises(ValueError, match="plain column references"):
            df.rollup(f.col("a") + 1)
