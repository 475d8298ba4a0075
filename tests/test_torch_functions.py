"""The torch port's expression breadth against the JAX package.

Math (``sqrt``, ``floor``, ``ceil``, ``abs``, ``pmod``, ``div``,
``signum``, and the transcendental functions), null and NaN predicates
(``isnan``, ``nanvl``, ``<=>`` with nulls on both sides,
``AtLeastNNonNulls``), the string functions (case conversion, trims,
``concat`` / ``concat_ws`` / ``||``, ``locate`` / ``instr``,
``replace``, ``substring_index``, ``split_part``, ``regexp_replace``,
LIKE with ``%``, ``_`` and escapes, RLIKE), TIMESTAMP columns (numpy
``datetime64[us]`` and Arrow ingest, egress, literals, ``hour`` /
``minute`` / ``second``, ``unix_timestamp``, interval arithmetic) and
``first`` / ``last`` / string ``min`` / ``max`` in the aggregate.  The
same numpy inputs from a seed (thousands of rows, with empty strings,
multi-byte UTF-8, nulls, NaN, infinities and pre-1970 timestamps) go
through both packages: the JAX side on its CPU platform with
``incompatibleOps`` on, the port on ``cpu``.

Tolerances: exact for integers, strings, booleans, dates, timestamps,
``sqrt``, ``floor``, ``ceil``, ``abs``, ``pmod`` and ``div``; ``exp``,
``log``, ``pow``, ``sin``, ``cos``, ``tan``, ``atan``, ``atan2``,
``log2`` and ``log10`` within 2 ulp (XLA's CPU routines and torch's
differ by one ulp at most on these inputs, ``log10`` by two; XLA on the
CPU flushes a subnormal result to zero where torch keeps it, so such a
result counts as zero); the f64 sums of the aggregate at the relative
1e-9 of ``approx_float``.
Also: every gated expression raises ``NotImplementedError`` naming its
key at the default conf.
"""

import datetime as dt

import numpy as np
import pyarrow as pa
import pytest

from spark_rapids_tpu import functions as F
from spark_rapids_tpu.api import Column as JColumn
from spark_rapids_tpu.api import col, lit
from spark_rapids_tpu.exprs import arithmetic as jar
from spark_rapids_tpu.exprs import datetime as jdte
from spark_rapids_tpu.exprs import math as jmt
from spark_rapids_tpu.exprs import nullexprs as jne
from tests.compare import assert_tables_equal, tpu_session

import spark_rapids_tpu_torch as st
from spark_rapids_tpu_torch import functions as TF
from spark_rapids_tpu_torch.api import Column as TColumn
from spark_rapids_tpu_torch.exprs import arithmetic as tar
from spark_rapids_tpu_torch.exprs import datetime as tdte
from spark_rapids_tpu_torch.exprs import math as tmt
from spark_rapids_tpu_torch.exprs import nullexprs as tne

INCOMPAT = {"spark.rapids.sql.incompatibleOps.enabled": True}
# (col, lit, functions, Column, arithmetic, math, nullexprs, datetime)
JAX = (col, lit, F, JColumn, jar, jmt, jne, jdte)
PORT = (st.col, st.lit, TF, TColumn, tar, tmt, tne, tdte)

STRINGS = ["hello world", "", "  padded  ", "héllo wörld", "日本語テキスト",
           "a😀b😀c", "x", "aaa", "a.b.c", "a,b,,c", "MiXeD cAsE wOrDs",
           "100%_done", "tab\there", "xxhello", " é ", "hello",
           "the end.", "a_b", "a%b"]

N = 2000


def _port(conf=None):
    return st.TorchSession({"spark.rapids.torch.device": "cpu",
                            **(conf or {})})


def _table(seed=5, n=N):
    rng = np.random.default_rng(seed)

    def mask(p=0.06):
        return rng.random(n) < p
    d = rng.normal(size=n) * 20
    d[rng.random(n) < 0.03] = np.nan
    d[rng.random(n) < 0.01] = np.inf
    d[rng.random(n) < 0.01] = -np.inf
    d[rng.random(n) < 0.02] = -0.0
    i = rng.integers(-1000, 1000, n)
    i[:4] = [np.iinfo(np.int64).min, np.iinfo(np.int64).max, 0, -1]
    j = rng.integers(-9, 10, n)
    j[4:8] = [0, -1, 1, 0]
    us = rng.integers(-(10 ** 15), 3 * 10 ** 15, n)
    return pa.table({
        "i": pa.array(i, mask=mask()),
        "j": pa.array(j, mask=mask()),
        "k": pa.array(rng.integers(0, 12, n).astype(np.int32)),
        "d": pa.array(d, mask=mask()),
        "e": pa.array(rng.normal(size=n) * 3, mask=mask()),
        "s": pa.array(np.array(STRINGS, dtype=object)[
            rng.integers(0, len(STRINGS), n)].tolist(), mask=mask()),
        "t": pa.array(np.array(STRINGS, dtype=object)[
            rng.integers(0, len(STRINGS), n)].tolist(), mask=mask()),
        "ts": pa.array(us, pa.timestamp("us", tz="UTC"), mask=mask()),
    })


@pytest.fixture(scope="module")
def table():
    return _table()


def _both(t, build, conf=None):
    conf = {**INCOMPAT, **(conf or {})}
    want = build(JAX, tpu_session(conf).create_dataframe(t)).to_arrow()
    got = build(PORT, _port(conf).create_dataframe(t)).to_arrow()
    return got, want


def _check(t, build, conf=None, ignore_order=False, approx_float=False):
    got, want = _both(t, build, conf)
    assert got.schema.types == want.schema.types
    assert_tables_equal(got, want, ignore_order=ignore_order,
                        approx_float=approx_float)
    return got


def _assert_ulps(got, want, ulps):
    g = np.asarray(got.to_pylist(), dtype=object)
    w = np.asarray(want.to_pylist(), dtype=object)
    assert [x is None for x in g] == [x is None for x in w]
    keep = np.array([x is not None for x in w])
    g = g[keep].astype(np.float64)
    w = w[keep].astype(np.float64)
    # XLA on the CPU flushes subnormal results to zero; torch (and Java)
    # keep them, so a result below the smallest normal equals zero
    tiny = np.finfo(np.float64).tiny
    g = np.where(np.abs(g) < tiny, 0.0, g)
    w = np.where(np.abs(w) < tiny, 0.0, w)
    same = (g == w) | (np.isnan(g) & np.isnan(w))
    scale = np.spacing(np.maximum(np.abs(g), np.abs(w)))
    with np.errstate(invalid="ignore"):
        off = np.where(same, 0.0, np.abs(g - w) / scale)
    assert np.all(np.isfinite(off) | same) and off.max() <= ulps, off.max()


# -- math ---------------------------------------------------------------

def test_exact_math_matches_jax(table):
    _check(table, lambda a, df: df.select(
        a[2].sqrt("d").alias("sqrt_d"), a[2].sqrt("k").alias("sqrt_k"),
        a[2].floor("d").alias("floor_d"), a[2].ceil("d").alias("ceil_d"),
        a[2].floor("i").alias("floor_i"), a[2].abs("d").alias("abs_d"),
        a[2].abs("i").alias("abs_i"), a[2].pmod("i", "j").alias("pmod_i"),
        a[2].pmod("d", "e").alias("pmod_d"),
        a[3](a[4].IntegralDivide(a[0]("i").expr, a[0]("j").expr))
        .alias("div"),
        a[3](a[5].Signum(a[0]("d").expr)).alias("signum"),
        (a[0]("i") % a[0]("j")).alias("rem")))


UNARY = ["Exp", "Log", "Sin", "Cos", "Tan", "Atan", "Log2", "Log10",
         "Cbrt"]


def test_transcendental_math_within_2_ulp(table):
    def build(a, df):
        cols = [a[3](getattr(a[5], f)(a[0]("d").expr)).alias(f)
                for f in UNARY]
        cols.append(a[2].pow("d", "e").alias("pow"))
        cols.append(a[3](a[5].Atan2(a[0]("d").expr, a[0]("e").expr))
                    .alias("atan2"))
        cols.append(a[2].exp("i").alias("exp_i"))
        cols.append(a[2].log("k").alias("log_k"))
        return df.select(*cols)
    got, want = _both(table, build)
    for name in got.column_names:
        _assert_ulps(got.column(name), want.column(name), 2)


def test_null_and_nan_predicates_match_jax(table):
    _check(table, lambda a, df: df.select(
        a[2].isnan("d").alias("isnan"), a[2].isnull("d").alias("isnull"),
        a[2].nanvl("d", "e").alias("nanvl"),
        a[0]("d").eq_null_safe(a[0]("e")).alias("nse_d"),
        a[0]("i").eq_null_safe(a[0]("j")).alias("nse_i"),
        a[0]("s").eq_null_safe(a[0]("t")).alias("nse_s"),
        a[3](a[6].AtLeastNNonNulls(2, a[0]("d").expr, a[0]("e").expr,
                                   a[0]("s").expr)).alias("at_least")))


def test_null_safe_equal_with_nulls_on_both_sides():
    t = pa.table({"a": pa.array([1, None, None, 2, 3]),
                  "b": pa.array([1, None, 4, None, 5])})
    got = _check(t, lambda a, df: df.select(
        a[0]("a").eq_null_safe(a[0]("b")).alias("e")))
    assert got.column("e").to_pylist() == [True, True, False, False, False]


# -- strings ------------------------------------------------------------

def test_case_and_trim_match_jax(table):
    _check(table, lambda a, df: df.select(
        a[2].upper("s").alias("u"), a[2].lower("s").alias("l"),
        a[2].initcap("s").alias("ic"), a[2].trim("s").alias("tr"),
        a[2].ltrim("s").alias("ltr"), a[2].rtrim("s").alias("rtr"),
        a[2].trim("s", "xh ").alias("tr_x"),
        a[2].length(a[2].trim("s")).alias("len")))


def test_concat_and_search_match_jax(table):
    _check(table, lambda a, df: df.select(
        a[2].concat("s", "t").alias("c"),
        a[2].concat("s", a[1]("-"), "t", a[1]("é")).alias("c4"),
        a[2].concat_ws("|", "s", "t", "s").alias("ws"),
        a[2].concat_ws("", "s", "t").alias("ws0"),
        a[2].locate("l", "s").alias("loc"),
        a[2].locate("o", "s", 6).alias("loc6"),
        a[2].locate("", "s", 3).alias("loc_empty"),
        a[2].instr("s", "ö").alias("instr"),
        a[2].replace("s", "l", "LL").alias("rep_long"),
        a[2].replace("s", "aa", "").alias("rep_drop"),
        a[2].replace("s", "😀", "?").alias("rep_mb"),
        a[2].replace("s", "é", "E!").alias("rep_same_mb"),
        a[2].replace("s", "aa", "bb").alias("rep_same_overlap"),
        a[2].substring_index("s", ".", 2).alias("si2"),
        a[2].substring_index("s", ",", -2).alias("si_neg"),
        a[2].substring_index("s", "aa", 2).alias("si_overlap"),
        a[2].split_part("s", ",", 2).alias("sp2"),
        a[2].split_part("s", " ", -1).alias("sp_last"),
        a[2].regexp_replace("s", "o", "0").alias("rr")))


LIKE_PATTERNS = ["%", "", "hello%", "%world", "%l_o%", "_", "___",
                 "h%o%", "日本%", "%😀_%", "100\\%%", "a\\_b", "a\\%b",
                 "%\\\\%", "x%x"]


def test_like_matches_jax(table):
    _check(table, lambda a, df: df.select(*[
        a[0]("s").like(p).alias(f"p{i}")
        for i, p in enumerate(LIKE_PATTERNS)]))


RLIKE_PATTERNS = ["hello", "^hello", "world$", "^a.b", "a.+c", "l.*o",
                  "^$", "\\.", "^.$", "d\\.$"]


def test_rlike_matches_jax(table):
    _check(table, lambda a, df: df.select(*[
        a[2].rlike("s", p).alias(f"r{i}")
        for i, p in enumerate(RLIKE_PATTERNS)]))


def test_like_refuses_what_the_jax_device_refuses():
    df = _port().create_dataframe({"s": np.array(["a", "b"])})
    with pytest.raises(NotImplementedError, match="literal"):
        df.select(st.col("s").like(st.col("s")).alias("x")).collect()
    with pytest.raises(NotImplementedError, match="regex"):
        df.select(TF.rlike("s", "[ab]").alias("x")).collect()
    with pytest.raises(ValueError, match="escape"):
        st.col("s").like("a\\")


# -- timestamps ---------------------------------------------------------

def test_timestamp_parts_and_arithmetic_match_jax(table):
    hour_us = 3_600_000_000
    _check(table, lambda a, df: df.select(
        "ts", a[2].hour("ts").alias("h"), a[2].minute("ts").alias("mi"),
        a[2].second("ts").alias("sec"), a[2].year("ts").alias("y"),
        a[2].unix_timestamp("ts").alias("unix"),
        a[3](a[7].TimeAdd(a[0]("ts").expr, 5 * hour_us)).alias("plus5h"),
        a[3](a[7].TimeSub(a[0]("ts").expr, 7)).alias("minus7us"),
        (a[0]("ts") > a[1](dt.datetime(1990, 6, 1, 12, 30))).alias("gt")))


def test_timestamp_group_by_hour_matches_jax(table):
    """An integer key from a timestamp, through the dense-slot route."""
    _check(table, lambda a, df: df.group_by(
        a[2].hour("ts").alias("h")).agg(
        a[2].sum("d").alias("s"), a[2].max("e").alias("m"),
        a[2].count("ts").alias("n")).order_by("h"), approx_float=True)


def test_numpy_datetime64_ingest_matches_arrow():
    """numpy ``datetime64[us]`` (and coarser units) lands as TIMESTAMP,
    as the JAX package reads it through Arrow; egress is Arrow's
    ``timestamp[us, UTC]`` and UTC datetimes."""
    us = np.array([-10 ** 12 - 1, 0, 1, 1_700_000_000_123_456],
                  dtype="datetime64[us]")
    s = _port()
    df = s.create_dataframe({"ts": us, "sec": us.astype("datetime64[s]")})
    got = df.select("ts", "sec", TF.hour("ts").alias("h")).to_arrow()
    want = tpu_session().create_dataframe(pa.table({
        "ts": pa.array(us), "sec": pa.array(us.astype("datetime64[s]"))})) \
        .select("ts", "sec", F.hour("ts").alias("h")).to_arrow()
    assert got.column("ts").type == pa.timestamp("us", tz="UTC")
    assert_tables_equal(got, want, ignore_order=False)
    rows = df.collect()
    assert rows[0]["ts"] == dt.datetime(1969, 12, 20, 10, 13, 19, 999999,
                                        tzinfo=dt.timezone.utc)


# -- aggregates ---------------------------------------------------------

def test_first_last_and_string_extrema_match_jax(table):
    _check(table, lambda a, df: df.group_by("k").agg(
        a[2].first("d").alias("fd"), a[2].last("d").alias("ld"),
        a[2].first("s").alias("fs"), a[2].last("s").alias("ls"),
        a[2].min("s").alias("mins"), a[2].max("s").alias("maxs"),
        a[2].first("ts").alias("fts")).order_by("k"))


def test_global_first_and_string_extrema_match_jax(table):
    _check(table, lambda a, df: df.agg(
        a[2].first("s").alias("fs"), a[2].min("t").alias("mint"),
        a[2].max("t").alias("maxt"), a[2].last("i").alias("li")))


def test_first_last_keeping_nulls_follow_spark(table):
    """``ignore_nulls=False`` (the JAX package leaves it to its CPU
    engine): each group's first and last row in input order, null or
    not, against numpy."""
    df = _port().create_dataframe(table)
    got = df.group_by("k").agg(
        TF.first("d", ignore_nulls=False).alias("f"),
        TF.last("s", ignore_nulls=False).alias("l")).order_by("k") \
        .to_arrow()
    k = table.column("k").to_numpy()
    d = table.column("d").to_pylist()
    s = table.column("s").to_pylist()
    for row in got.to_pylist():
        rows = np.flatnonzero(k == row["k"])
        want_f, want_l = d[rows[0]], s[rows[-1]]
        assert (row["f"] is None) == (want_f is None)
        if want_f is not None:
            assert row["f"] == want_f or (np.isnan(row["f"])
                                          and np.isnan(want_f))
        assert row["l"] == want_l


def test_first_and_string_max_merge_across_batches(tmp_path, table):
    """Several update batches (parquet row groups of 300 rows) merge
    their partials: first/last keep input order, string extrema
    compare across batches."""
    import pyarrow.parquet as pq
    path = str(tmp_path / "t.parquet")
    pq.write_table(table, path, row_group_size=300)
    conf = {**INCOMPAT, "spark.rapids.sql.reader.batchSizeRows": 300}

    def build(a, s):
        return s.read.parquet(path).group_by("k").agg(
            a[2].first("s").alias("fs"), a[2].last("d").alias("ld"),
            a[2].max("t").alias("mt"), a[2].min("s").alias("ms")) \
            .order_by("k").to_arrow()
    got = build(PORT, _port(conf))
    want = build(JAX, tpu_session(conf))
    assert_tables_equal(got, want, ignore_order=False)


# -- gates --------------------------------------------------------------

GATED = {
    "Upper": (lambda df: df.select(TF.upper("s").alias("x")),
              "incompatibleOps"),
    "Lower": (lambda df: df.select(TF.lower("s").alias("x")),
              "incompatibleOps"),
    "InitCap": (lambda df: df.select(TF.initcap("s").alias("x")),
                "incompatibleOps"),
    "Rand": (lambda df: df.select(TF.rand(3).alias("x")),
             "incompatibleOps"),
    "castStringToInteger": (
        lambda df: df.select(st.col("s").cast("int").alias("x")),
        "spark.rapids.sql.castStringToInteger.enabled"),
    "castStringToFloat": (
        lambda df: df.select(st.col("s").cast("double").alias("x")),
        "spark.rapids.sql.castStringToFloat.enabled"),
    "castStringToTimestamp": (
        lambda df: df.select(st.col("s").cast("timestamp").alias("x")),
        "spark.rapids.sql.castStringToTimestamp.enabled"),
    "castFloatToString": (
        lambda df: df.select(st.col("f").cast("string").alias("x")),
        "spark.rapids.sql.castFloatToString.enabled"),
}


@pytest.mark.parametrize("name", sorted(GATED))
def test_gated_expression_raises_at_default_conf(name):
    build, key = GATED[name]
    df = _port().create_dataframe({"s": np.array(["1", "x"]),
                                   "f": np.array([1.5, 2.0])})
    with pytest.raises(NotImplementedError, match=key):
        build(df).collect()


def test_own_expression_key_enables_it():
    """``spark.rapids.sql.expression.Upper`` alone, as in the JAX
    package."""
    df = _port({"spark.rapids.sql.expression.Upper": True}) \
        .create_dataframe({"s": np.array(["ab", "Cd"])})
    assert df.select(TF.upper("s").alias("u")).to_arrow() \
        .column("u").to_pylist() == ["AB", "CD"]


def test_like_literal_runs_agree_with_the_nfa():
    """The '%'-and-literals path of LIKE (a search per literal run)
    gives the code-point NFA's answer on random patterns over random
    multi-byte strings."""
    import random

    import torch
    from spark_rapids_tpu_torch.columnar.batch import \
        host_batch_to_device, host_columns_from_numpy
    from spark_rapids_tpu_torch.exprs import strings as ss
    from spark_rapids_tpu_torch.exprs.base import ColVal
    rng = random.Random(1)
    vals = ["".join(rng.choice("abcé😀") for _ in range(rng.randint(0, 9)))
            for _ in range(3000)]
    schema, cols = host_columns_from_numpy({"s": np.array(vals,
                                                          dtype=object)})
    c = host_batch_to_device(schema, cols, "cpu").columns[0]
    cv = ColVal(c.data, c.validity, c.chars)
    tried = 0
    for _ in range(300):
        pat = "".join(rng.choice("abcé😀%%") for _ in range(
            rng.randint(1, 6)))
        toks = ss._parse_like(pat, "\\")
        assert ss._segments(toks) is not None
        assert torch.equal(ss._like_match(cv, toks),
                           ss._nfa_match(cv, toks)), pat
        tried += 1
    assert tried == 300
