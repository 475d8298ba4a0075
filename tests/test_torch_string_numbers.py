"""A string read as a number in the torch port, against the JAX package.

The JAX package casts a string operand to a number in three places:
``sum`` and ``avg`` cast their child to the result type (``sum`` to
LONG, ``avg`` to DOUBLE; ``exprs/aggregates.py`` ``input_projection``),
in a group-by and in a window alike, and ``/`` casts both sides to
DOUBLE (``exprs/arithmetic.py`` ``Divide.coerce``).  ``+ - * %`` widen
through ``common_type``, which has no common type for a string and a
number, so both packages raise ``TypeError`` with the same message.  A
string that does not parse is null, as Spark's non-ANSI cast makes it;
spaces around a value are trimmed, and exponent forms parse as doubles
(and not as LONG, so ``sum`` nulls them).  None of these casts needs a
``castStringTo*`` gate, in either package: the gates hold only the casts
a query writes.

The JAX side runs its device planner with ``spark.rapids.sql.test.enabled``
(no CPU fallback) except for the window cases: the JAX package runs a
string-typed window function on its CPU engine, so those use a JAX
session with ``test.enabled`` off.  Tolerance: LONG sums exact; a DOUBLE
average or quotient within ``tests/compare.py``'s ``approx_float``
(1e-9 relative: the port and the JAX package both parse the mantissa's
digits in f64, and may sum a group in another order); a window average
within ``1e-12 * sum(|v|)`` over the whole input, the window tests' class
(``tests/test_torch_window.py``).
"""

import numpy as np
import pyarrow as pa
import pytest

from spark_rapids_tpu import Window as JWindow
from spark_rapids_tpu import functions as F
from spark_rapids_tpu.api import col as jcol
from tests.compare import assert_tables_equal, tpu_session

import spark_rapids_tpu_torch as st
from spark_rapids_tpu_torch import functions as TF

# parse as LONG and as DOUBLE; spaces around; exponents (DOUBLE only);
# not a number at all (null under the non-ANSI cast)
_POOL = ["12", "-7", "+3", "0", " 42", "17 ", "  -5  ", "1.5", "-2.25",
         " 3.75 ", "1e3", "2.5E-2", "-1e2", "6.02e23", "abc", "1.2.3", "",
         "e5", "--1", "1e", "NaN-ish", "9223372036854775807", "-0"]


# A window sum is the difference of two global prefix sums in both
# packages' device paths (tests/test_torch_window.py), so its error scales
# with the whole input's sum of |v|: a 6.02e23 would put every small frame
# inside that bound.  The window cases take the same forms at a smaller
# exponent and hold the average to that class.
_WINDOW_POOL = [p if p != "6.02e23" else "6.02e2" for p in _POOL]
REL = 1e-12


def _table(n=600, seed=5, pool=_POOL):
    rng = np.random.default_rng(seed)
    picks = rng.integers(0, len(pool) + 40, n)
    s = [(pool[p] if p < len(pool) else str(int(rng.integers(-999, 999))))
         for p in picks]
    return pa.table({
        "g": pa.array(rng.integers(0, 9, n), pa.int64()),
        "o": pa.array(np.arange(n), pa.int64()),
        "s": pa.array(s, pa.string(), mask=rng.random(n) < 0.1),
        "i": pa.array(rng.integers(-50, 50, n), pa.int64()),
        "d": pa.array(rng.normal(size=n) * 10, pa.float64()),
    })


def _port():
    return st.TorchSession({"spark.rapids.torch.device": "cpu"})


def _check(build, jconf=None, ignore_order=False):
    t = _table()
    want = build(jcol, F, JWindow,
                 tpu_session(jconf).create_dataframe(t)).to_arrow()
    got = build(st.col, TF, st.Window, _port().create_dataframe(t)) \
        .to_arrow()
    assert got.schema.types == want.schema.types
    assert_tables_equal(got, want, ignore_order=ignore_order,
                        approx_float=True)


def test_group_by_sum_avg_of_a_string():
    _check(lambda c, f, w, df: df.group_by("g").agg(
        f.sum(c("s")).alias("total"), f.avg(c("s")).alias("mean"),
        f.count(c("s")).alias("n")), ignore_order=True)


def test_group_by_sum_avg_of_a_string_through_sql():
    t = _table()
    js = tpu_session()
    js.create_dataframe(t).create_or_replace_temp_view("strnum")
    ps = _port()
    ps.create_dataframe(t).create_or_replace_temp_view("strnum")
    q = ("SELECT g, sum(s) AS total, avg(s) AS mean FROM strnum "
         "GROUP BY g")
    want, got = js.sql(q).to_arrow(), ps.sql(q).to_arrow()
    assert got.schema.types == want.schema.types
    assert_tables_equal(got, want, ignore_order=True, approx_float=True)


def test_global_sum_avg_of_a_string():
    _check(lambda c, f, w, df: df.agg(f.sum(c("s")).alias("total"),
                                      f.avg(c("s")).alias("mean")))


@pytest.mark.parametrize("frame", ["running", "partition"])
def test_window_sum_avg_of_a_string(frame):
    def build(c, f, w, df):
        spec = w.partition_by("g").order_by("o") if frame == "running" \
            else w.partition_by("g")
        return df.select("g", "o", f.sum(c("s")).over(spec).alias("total"),
                         f.avg(c("s")).over(spec).alias("mean"))
    t = _table(pool=_WINDOW_POOL)
    jdf = tpu_session({"spark.rapids.sql.test.enabled": False}) \
        .create_dataframe(t)
    want = build(jcol, F, JWindow, jdf).to_arrow()
    got = build(st.col, TF, st.Window, _port().create_dataframe(t)) \
        .to_arrow()
    assert got.schema == want.schema
    for name in ("g", "o", "total"):
        assert got.column(name).to_pylist() == want.column(name).to_pylist()
    parsed = jdf.select(jcol("s").cast("double").alias("v")).to_arrow()
    scale = float(np.nansum(np.abs(np.asarray(
        parsed.column("v").to_numpy(zero_copy_only=False), np.float64))))
    g, w = got.column("mean").to_pylist(), want.column("mean").to_pylist()
    assert [x is None for x in g] == [x is None for x in w]
    np.testing.assert_allclose(
        np.array([np.nan if x is None else x for x in g]),
        np.array([np.nan if x is None else x for x in w]),
        rtol=0, atol=REL * scale, equal_nan=True)


@pytest.mark.parametrize("pair", ["s/i", "i/s", "s/d", "d/s", "s/2",
                                  "s/s"])
def test_divide_reads_a_string_as_a_double(pair):
    a, b = pair.split("/")

    def build(c, f, w, df):
        lhs = c(a) if a != "2" else 2
        rhs = c(b) if b != "2" else 2
        return df.select("o", (lhs / rhs).alias("q"))
    _check(build)


@pytest.mark.parametrize("op", ["+", "-", "*", "%"])
@pytest.mark.parametrize("other", ["i", "d"])
@pytest.mark.parametrize("string_left", [True, False])
def test_widening_arithmetic_over_a_string_raises_as_jax(op, other,
                                                         string_left):
    def expr(c):
        a, b = (c("s"), c(other)) if string_left else (c(other), c("s"))
        return {"+": a + b, "-": a - b, "*": a * b, "%": a % b}[op]
    t = _table(40)
    with pytest.raises(TypeError) as jerr:
        tpu_session({"spark.rapids.sql.test.enabled": False}) \
            .create_dataframe(t).select(expr(jcol).alias("x")).to_arrow()
    with pytest.raises(TypeError) as perr:
        _port().create_dataframe(t).select(expr(st.col).alias("x")) \
            .to_arrow()
    assert str(perr.value) == str(jerr.value)


def test_string_sum_needs_no_cast_gate():
    # the gates hold a cast the query writes, not the aggregate's own
    t = _table(50)
    df = _port().create_dataframe(t)
    with pytest.raises(NotImplementedError, match="castStringToInteger"):
        df.select(st.col("s").cast("long").alias("x")).to_arrow()
    assert df.agg(TF.sum(st.col("s")).alias("x")).to_arrow().num_rows == 1
