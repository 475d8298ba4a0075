"""The torch port's union, range and thin actions against the JAX package.

``DataFrame.union`` of two and three frames (strings of different widths
and nulls, so the union carries batches of different char widths into a
sort and an aggregate), and ``session.range`` with positive, negative
and empty steps, ``end=None``, and a range of more than one 2**20-row
batch; then ``count``, ``head``, ``take``, ``first``, ``to_numpy``,
``schema``, ``columns`` and ``GroupedData.count``.  Integers, strings and
nulls compare exactly, rows in order wherever the query fixes it.
"""

import jax
import numpy as np
import pyarrow as pa
import pytest

from spark_rapids_tpu import functions as F
from tests.compare import assert_tables_equal, tpu_session

import spark_rapids_tpu_torch as st
from spark_rapids_tpu_torch import functions as TF
from tests.torch_threads import _one_torch_thread  # noqa: F401


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


WORDS = ["", "a", "bb", "ccc-ccc", "a much longer string of text, 40 bytes",
         "é", "zz"]


def _port():
    return st.TorchSession({"spark.rapids.torch.device": "cpu"})


def _frame(n, seed, words):
    rng = np.random.default_rng(seed)
    return pa.table({
        "k": pa.array(rng.integers(0, 9, n), pa.int64(),
                      mask=rng.random(n) < 0.1),
        "s": pa.array(np.array(words, dtype=object)[
            rng.integers(0, len(words), n)].tolist(),
            mask=rng.random(n) < 0.1),
        "v": pa.array(rng.normal(size=n), mask=rng.random(n) < 0.1),
    })


def _both(build):
    want = build(F, tpu_session()).to_arrow()
    got = build(TF, _port()).to_arrow()
    return got, want


@pytest.mark.parametrize("parts", [2, 3])
def test_union_matches_jax(parts):
    # the first frame holds short strings only, the others long ones
    tables = [_frame(1500 + 300 * i, 11 + i, WORDS[:3] if i == 0 else WORDS)
              for i in range(parts)]

    def build(f, s):
        df = s.create_dataframe(tables[0])
        for t in tables[1:]:
            df = df.union(s.create_dataframe(t))
        return df

    got, want = _both(build)
    assert got.num_rows == sum(t.num_rows for t in tables)
    assert_tables_equal(got, want, ignore_order=False)

    def grouped(f, s):
        return build(f, s).group_by("s").agg(
            f.count(f.col("k")).alias("n"),
            f.sum(f.col("k")).alias("sk")).order_by("s")

    got, want = _both(grouped)
    assert_tables_equal(got, want, ignore_order=False)

    def ordered(f, s):
        return build(f, s).order_by(f.col("s").desc(), "k", "v")

    got, want = _both(ordered)
    assert_tables_equal(got, want, ignore_order=False)


RANGES = {
    "positive": (3, 5000, 7),
    "negative": (100, -4000, -13),
    "empty": (10, 0, 1),
    "empty_negative": (0, 10, -1),
    "one_argument": (2500, None, 1),
    "batches": (0, (1 << 20) + 4321, 1),
}


@pytest.mark.parametrize("name", sorted(RANGES))
def test_range_matches_jax(name):
    start, end, step = RANGES[name]

    def build(f, s):
        df = s.range(start) if end is None else s.range(start, end, step)
        return df.select("id", (f.col("id") * 2).alias("twice"))

    if name == "batches":
        # a sum and a count keep the check small; both packages cut the
        # range into 2**20-row batches
        def build(f, s):  # noqa: F811
            return s.range(start, end, step).agg(
                f.count(f.col("id")).alias("n"), f.sum(f.col("id")).alias("t"),
                f.min(f.col("id")).alias("lo"), f.max(f.col("id")).alias("hi"))
    got, want = _both(build)
    assert got.schema == want.schema
    assert_tables_equal(got, want, ignore_order=False)


def test_range_batches_and_step_zero():
    s = _port()
    n = (1 << 20) + 4321
    plan_batches = list(s.range(n)._execute()[1])
    assert [b.num_rows for b in plan_batches] == [1 << 20, 4321]
    assert s.range(5, 5).count() == 0
    with pytest.raises(ZeroDivisionError):
        s.range(0, 10, 0).collect()
    with pytest.raises(ZeroDivisionError):
        tpu_session().range(0, 10, 0).collect()


def test_thin_actions_match_jax():
    t = _frame(800, 5, WORDS)
    j = tpu_session().create_dataframe(t)
    p = _port().create_dataframe(t)
    assert p.count() == j.count() == 800
    assert p.columns == j.columns
    assert [f.name for f in p.schema] == [f.name for f in j.schema]
    assert [f.dtype.name for f in p.schema] == \
        [f.dtype.name for f in j.schema]
    assert p.head() == j.head()
    assert p.head(3) == j.head(3)
    assert p.take(4) == j.take(4)
    assert p.first() == j.first()
    assert p.filter(TF.col("k") > 100).head() is None
    pn, jn = p.to_numpy(), j.to_numpy()
    assert sorted(pn) == sorted(jn)
    for name in jn:
        a, b = pn[name], jn[name]
        assert np.ma.is_masked(a) == np.ma.is_masked(b), name
        assert np.array_equal(np.ma.getmaskarray(a), np.ma.getmaskarray(b))
        keep = ~np.ma.getmaskarray(b)
        assert np.asarray(a)[keep].tolist() == np.asarray(b)[keep].tolist()
    got = p.group_by("k").count().order_by("k").to_arrow()
    want = j.group_by("k").count().order_by("k").to_arrow()
    assert_tables_equal(got, want, ignore_order=False)
