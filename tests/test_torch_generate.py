"""The torch port's explode and posexplode against the JAX package.

All four forms (explode, explode_outer, posexplode, posexplode_outer)
over literal arrays of ints, strings (with a null), dates, and empty and
all-null typed arrays; a generated column that replaces one of the same
name (``with_column``); a generator with an aggregate and a filter above
it; and the misuse errors with the JAX package's messages (an array
literal outside a generator, two generators, a nested one, one in a
filter, explode of a column).  Rows compare exactly and in order: row j
of the output is element j % n of input row j // n in both packages.
"""

import datetime

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


def _table(n=1200, seed=8):
    rng = np.random.default_rng(seed)
    return pa.table({
        "k": pa.array(rng.integers(0, 50, n), pa.int64()),
        "s": pa.array(np.array(["a", "bcd", "efghijklmnop"], dtype=object)[
            rng.integers(0, 3, n)].tolist(), mask=rng.random(n) < 0.1),
        "v": pa.array(rng.normal(size=n), mask=rng.random(n) < 0.1),
    })


def _port():
    return st.TorchSession({"spark.rapids.torch.device": "cpu"})


D0, D1 = datetime.date(1995, 3, 15), datetime.date(2024, 2, 29)
ARRAYS = {
    "ints": lambda f: f.array(7, 30, 90),
    "strings": lambda f: f.array("x", None, "a longer element"),
    "dates": lambda f: f.array(D0, D1),
    "empty": lambda f: f.array(elem_dtype="int"),
    "all_null": lambda f: f.array(None, None, elem_dtype="string"),
}
FORMS = ["explode", "explode_outer", "posexplode", "posexplode_outer"]


def _check(build, t=None):
    t = _table() if t is None else t
    want = build(F, tpu_session().create_dataframe(t)).to_arrow()
    got = build(TF, _port().create_dataframe(t)).to_arrow()
    assert got.schema == want.schema
    assert_tables_equal(got, want, ignore_order=False)
    return got


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("arr", sorted(ARRAYS))
def test_explode_forms_match_jax(form, arr):
    got = _check(lambda f, df: df.select(
        "k", "s", getattr(f, form)(ARRAYS[arr](f))))
    n_elem = {"ints": 3, "strings": 3, "dates": 2, "empty": 0,
              "all_null": 2}[arr]
    outer_rows = 1 if form.endswith("outer") else 0
    assert got.num_rows == 1200 * (n_elem or outer_rows)


def test_alias_and_shadowing_match_jax():
    # an aliased generator, and one that replaces the column it names
    _check(lambda f, df: df.select(
        "k", f.posexplode(f.array(1, 2)).alias("step"), "v"))
    _check(lambda f, df: df.with_column("k", f.explode(f.array(5, 6, 7))))
    _check(lambda f, df: df.with_column(
        "s", f.explode_outer(f.array("p", "q"))))


def test_explode_under_aggregate_and_filter_matches_jax():
    def build(f, df):
        out = df.select("k", "v", f.posexplode(f.array(7, 30, 90)))
        return (out.filter(f.col("k") > 10)
                .group_by("pos").agg(f.count("*").alias("n"),
                                     f.sum(f.col("v")).alias("sv"),
                                     f.sum(f.col("col")).alias("days"))
                .order_by("pos"))
    want = build(F, tpu_session().create_dataframe(_table())).to_arrow()
    got = build(TF, _port().create_dataframe(_table())).to_arrow()
    assert_tables_equal(got, want, ignore_order=False, approx_float=True)


MISUSE = {
    "stray_array": (lambda f, df: df.select(f.array(1, 2)),
                    "F.array\\(...\\) literals are only usable inside"),
    "two_generators": (lambda f, df: df.select(
        f.explode(f.array(1)), f.explode(f.array(2))),
        "only one generator"),
    "nested": (lambda f, df: df.select(
        f.explode(f.array(1, 2)) + 1), "must be a top-level select"),
    "in_filter": (lambda f, df: df.filter(
        f.explode(f.array(1, 2)) > 1), "not allowed in filter"),
    "column": (lambda f, df: df.select(f.explode("k")),
               "supports literal arrays only"),
}


@pytest.mark.parametrize("name", sorted(MISUSE))
def test_misuse_raises_as_jax(name):
    build, msg = MISUSE[name]
    t = _table(10)
    for f, s in ((F, tpu_session()), (TF, _port())):
        with pytest.raises(ValueError, match=msg):
            build(f, s.create_dataframe(t))
