"""The torch port's conditional, date, IN / null-test and string-length
expressions against the JAX package.

``when`` / ``otherwise`` and ``If`` (null conditions, the branches' type
promotion, string branches), every ported date part and ``date_add`` /
``date_sub`` / ``datediff`` on dates before and after 1970, on leap days
and on the last days of leap and common years, ``isin`` with nulls in
the value and in the list (integers and strings), ``isnull`` /
``is_null`` / ``is_not_null``, ``length`` and ``substring`` (pos 0,
negative pos, overshoot, no length, the to-the-end idiom, multi-byte
UTF-8).  The same Arrow table goes through both packages' sessions; the
JAX side runs on its CPU platform.  Tolerance: exact (these expressions
do no float arithmetic; a promoted branch is a cast).  Also: what the
port cannot plan raises ``NotImplementedError`` at planning (a
non-literal substring position, a date part over a TIMESTAMP).
"""

import datetime as dt

import numpy as np
import pyarrow as pa
import pytest

from spark_rapids_tpu import functions as F
from spark_rapids_tpu.api import Column as JColumn
from spark_rapids_tpu.api import col, lit, when
from spark_rapids_tpu.exprs.conditional import If as JIf
from spark_rapids_tpu.exprs.datetime import WeekDay as JWeekDay
from tests.compare import assert_tables_equal, tpu_session

import spark_rapids_tpu_torch as st
from spark_rapids_tpu_torch import functions as TF
from spark_rapids_tpu_torch.api import Column as TColumn
from spark_rapids_tpu_torch.columnar.dtypes import TIMESTAMP
from spark_rapids_tpu_torch.exprs.conditional import If as TIf
from spark_rapids_tpu_torch.exprs.datetime import WeekDay as TWeekDay

JAX = (col, lit, when, F, JColumn, JIf, JWeekDay)
PORT = (st.col, st.lit, st.when, TF, TColumn, TIf, TWeekDay)


def _port_session():
    return st.TorchSession({"spark.rapids.torch.device": "cpu"})


def _both(table, build):
    """``build(api, df)`` through both packages -> (port, JAX) tables."""
    want = build(JAX, tpu_session().create_dataframe(table)).to_arrow()
    got = build(PORT, _port_session().create_dataframe(table)).to_arrow()
    return got, want


def _check(table, build):
    got, want = _both(table, build)
    assert got.schema == want.schema
    assert_tables_equal(got, want, ignore_order=False)
    return got


def _cond_table(n=64, seed=3):
    rng = np.random.default_rng(seed)

    def maybe(values, p=0.2):
        return pa.array(values, mask=rng.random(n) < p)
    return pa.table({
        "c1": maybe(rng.random(n) < 0.5),
        "c2": maybe(rng.random(n) < 0.5),
        "i": maybe(rng.integers(-50, 50, n).astype(np.int32)),
        "l": maybe(rng.integers(-2**40, 2**40, n)),
        "d": maybe(rng.normal(size=n)),
        "s": maybe(np.array(["apple", "é", "", "long string value"])[
            rng.integers(0, 4, n)].tolist()),
    })


def test_case_when_null_conditions_and_promotion():
    got = _check(_cond_table(), lambda a, df: df.select(
        # INT32 branches stay INT32
        a[2](a[0]("c1"), 1).otherwise(0).alias("flag"),
        # INT32 and DOUBLE branches widen to DOUBLE
        a[2](a[0]("c1"), a[0]("i")).when(a[0]("c2"), a[0]("d"))
        .otherwise(0.0).alias("num"),
        # no ELSE: rows no branch takes are null
        a[2](a[0]("c2"), a[0]("l")).alias("no_else"),
        # INT32 and INT64 widen to INT64
        a[2](~a[0]("c1"), a[0]("i")).otherwise(a[0]("l")).alias("wide"),
        # whole string rows, widths aligned
        a[2](a[0]("c1"), a[0]("s")).otherwise(a[1]("x")).alias("str")))
    assert got.schema.field("flag").type == pa.int32()
    assert got.schema.field("num").type == pa.float64()
    assert got.schema.field("wide").type == pa.int64()
    assert got.column("no_else").null_count > 0


def test_if_null_condition_takes_else():
    t = _cond_table()
    got = _check(t, lambda a, df: df.select(
        a[4](a[5](a[0]("c1").expr, a[0]("i").expr, a[0]("d").expr))
        .alias("v"),
        a[4](a[5](a[0]("c2").expr, a[0]("s").expr, a[1]("n/a").expr))
        .alias("w")))
    c1 = t.column("c1").to_pylist()
    i, d = t.column("i").to_pylist(), t.column("d").to_pylist()
    want = [float(x) if x is not None else None
            for x in (i[r] if c1[r] else d[r] for r in range(len(c1)))]
    assert got.column("v").to_pylist() == want


# dates around 1970, leap days, and the last days of leap and common years
EDGE_DATES = [dt.date(1970, 1, 1), dt.date(1969, 12, 31), dt.date(1968, 2, 29),
              dt.date(1900, 2, 28), dt.date(1900, 3, 1), dt.date(1600, 2, 29),
              dt.date(2000, 2, 29), dt.date(2000, 12, 31),
              dt.date(2023, 12, 31), dt.date(2024, 12, 31),
              dt.date(2024, 2, 29), dt.date(2100, 3, 1), dt.date(1, 1, 1),
              dt.date(9999, 12, 31), dt.date(1583, 10, 15),
              dt.date(1969, 1, 1), dt.date(1972, 3, 1)]


def _date_table(seed=5, edges=EDGE_DATES):
    rng = np.random.default_rng(seed)
    rand = [dt.date(1970, 1, 1) + dt.timedelta(days=int(x))
            for x in rng.integers(-200_000, 200_000, 300)]
    days = list(edges) + rand
    n = len(days)
    return pa.table({
        "d": pa.array(days + [None], pa.date32()),
        "e": pa.array(list(reversed(days)) + [dt.date(2000, 1, 1)],
                      pa.date32()),
        "k": pa.array(rng.integers(-1000, 1000, n + 1).astype(np.int32),
                      mask=np.r_[rng.random(n) < 0.05, False]),
    })


def test_date_parts_match_jax_and_the_calendar():
    t = _date_table()
    got = _check(t, lambda a, df: df.select(
        a[3].year("d").alias("y"), a[3].month("d").alias("m"),
        a[3].dayofmonth("d").alias("dom"), a[3].dayofweek("d").alias("dow"),
        a[3].dayofyear("d").alias("doy"), a[3].quarter("d").alias("q"),
        a[3].last_day("d").alias("last"),
        a[4](a[6](a[0]("d").expr)).alias("wd")))
    days = t.column("d").to_pylist()
    for name, fn in [("y", lambda x: x.year), ("m", lambda x: x.month),
                     ("dom", lambda x: x.day),
                     ("dow", lambda x: x.isoweekday() % 7 + 1),
                     ("wd", lambda x: x.weekday()),
                     ("doy", lambda x: x.timetuple().tm_yday),
                     ("q", lambda x: (x.month - 1) // 3 + 1)]:
        assert got.column(name).to_pylist() == [
            None if x is None else fn(x) for x in days], name
    last = [None if x is None else dt.date(x.year, 12, 31) if x.month == 12
            else dt.date(x.year, x.month + 1, 1) - dt.timedelta(days=1)
            for x in days]
    assert got.column("last").to_pylist() == last


def test_date_arithmetic_matches_jax():
    # results past year 9999 or before year 1 have no Python date
    t = _date_table(edges=[d for d in EDGE_DATES if 1 < d.year < 9999])
    got = _check(t, lambda a, df: df.select(
        a[3].date_add("d", a[1](45)).alias("add"),
        a[3].date_sub("d", a[1](366)).alias("sub"),
        a[3].date_add("d", "k").alias("add_col"),
        a[3].date_sub("e", "k").alias("sub_col"),
        a[3].datediff("d", "e").alias("diff")))
    days, other = t.column("d").to_pylist(), t.column("e").to_pylist()
    assert got.column("diff").to_pylist() == [
        None if x is None else (x - y).days for x, y in zip(days, other)]
    assert got.column("add").to_pylist() == [
        None if x is None else x + dt.timedelta(days=45) for x in days]


def test_in_with_nulls_ints_and_strings():
    t = pa.table({
        "i": pa.array([1, 2, 3, None, 5, 7, -1, 0]),
        "s": pa.array(["a", "bb", None, "é", "bb", "", "x", "ccc"]),
    })
    got = _check(t, lambda a, df: df.select(
        a[0]("i").isin(1, 3, 7).alias("in_int"),
        a[0]("i").isin([2, None]).alias("in_null_list"),
        a[0]("s").isin("bb", "é", "").alias("in_str"),
        a[0]("s").isin("a", None).alias("in_str_null"),
        a[0]("i").isin().alias("in_empty")))
    assert got.column("in_null_list").to_pylist() == [
        None, True, None, None, None, None, None, None]
    assert got.column("in_str").to_pylist() == [
        False, True, None, True, True, True, False, False]


def test_null_tests_match_jax():
    t = _cond_table()
    got = _check(t, lambda a, df: df.select(
        a[3].isnull("i").alias("isnull_i"),
        a[0]("s").is_null().alias("s_null"),
        a[0]("d").is_not_null().alias("d_set"),
        a[3].isnull(a[0]("i") + a[0]("l")).alias("sum_null")))
    assert got.column("s_null").null_count == 0
    assert got.column("isnull_i").to_pylist() == [
        v is None for v in t.column("i").to_pylist()]


STRINGS = ["hello", "", "héllo wörld", "日本語テキスト", "a😀b😀c", "x", None,
           "0123456789abcdefghij", "é", "13-456-789-1234"]
SUBSTRINGS = [(0, 3), (1, 2), (2, None), (-3, 2), (-3, None), (-20, 3),
              (-12, 15), (3, 100), (5, -1), (2, 2 ** 31 - 1), (100, 2),
              (1, 0), (-1, 1)]


def test_length_and_substring_match_jax():
    t = pa.table({"s": pa.array(STRINGS)})
    got = _check(t, lambda a, df: df.select(
        a[3].length("s").alias("len"),
        *[a[3].substring("s", p, n).alias(f"sub{i}")
          for i, (p, n) in enumerate(SUBSTRINGS)]))
    assert got.column("len").to_pylist() == [
        None if s is None else len(s) for s in STRINGS]

    def spark_substring(s, pos, n):
        if s is None:
            return None
        start = pos - 1 if pos > 0 else (len(s) + pos if pos < 0 else 0)
        end = len(s) if n is None else (start if n < 0 else start + n)
        return s[max(start, 0):max(end, 0)]
    for i, (p, n) in enumerate(SUBSTRINGS):
        assert got.column(f"sub{i}").to_pylist() == [
            spark_substring(s, p, n) for s in STRINGS], (p, n)


def test_substring_feeds_group_by_and_isin():
    """TPC-H Q22's country code: substring, isin over its result, and a
    group by the new strings."""
    rng = np.random.default_rng(11)
    phones = [f"{rng.integers(10, 35)}-{rng.integers(100, 999)}"
              for _ in range(500)]
    t = pa.table({"p": pa.array(phones), "v": pa.array(rng.normal(size=500))})
    _check(t, lambda a, df: df.select(
        a[3].substring("p", 1, 2).alias("cc"), "v")
        .filter(a[0]("cc").isin("13", "31", "23", "29", "30", "18", "17"))
        .group_by("cc").agg(a[3].count(a[1](1)).alias("n"))
        .order_by("cc"))


def test_unported_expressions_raise_at_planning():
    """What the port once refused when planned now runs, equal to the JAX
    package (its CPU engine for the string function): a string-typed
    lag and a first over a window frame."""
    from spark_rapids_tpu import Window as JWindow
    t = pa.table({"s": pa.array(["abc", "de", None, "fgh", "", "ij"]),
                  "i": pa.array([1, 2, 1, 1, 2, None]),
                  "o": pa.array([3, 1, 2, 5, 4, 0])})

    def build(a, win, df):
        w = win.partition_by("i").order_by("o")
        return df.select(
            "s", "i", a[3].lag("s").over(w).alias("x"),
            a[3].first("o").over(w.rows_between(-1, 1)).alias("y"))
    want = build(JAX, JWindow, tpu_session(
        {"spark.rapids.sql.test.enabled": False}).create_dataframe(t)) \
        .to_arrow()
    got = build(PORT, st.Window, _port_session().create_dataframe(t)) \
        .to_arrow()
    assert_tables_equal(got, want, ignore_order=False)


def test_substring_column_position_matches_jax():
    """A column position and length (the JAX package computes them on
    its CPU engine, the port per row on the device): negative, zero and
    null positions, negative and null lengths, multi-byte UTF-8."""
    rng = np.random.default_rng(17)
    n = 400
    t = pa.table({
        "s": pa.array(np.array(STRINGS, dtype=object)[
            rng.integers(0, len(STRINGS), n)].tolist(),
            mask=rng.random(n) < 0.05),
        "p": pa.array(rng.integers(-6, 7, n).astype(np.int32),
                      mask=rng.random(n) < 0.05),
        "n": pa.array(rng.integers(-2, 6, n).astype(np.int32),
                      mask=rng.random(n) < 0.05),
    })

    def build(a, df):
        return df.select(
            a[3].substring("s", a[0]("p"), a[0]("n")).alias("a"),
            a[3].substring("s", a[0]("p")).alias("b"),
            a[3].substring("s", 2, a[0]("n")).alias("c"))
    want = build(JAX, tpu_session({"spark.rapids.sql.test.enabled": False})
                 .create_dataframe(t)).to_arrow()
    got = build(PORT, _port_session().create_dataframe(t)).to_arrow()
    assert_tables_equal(got, want, ignore_order=False)


def test_date_parts_over_timestamps_match_jax():
    """The DATE parts of a TIMESTAMP's day (once refused), before and
    after 1970 and across midnight UTC."""
    rng = np.random.default_rng(23)
    n = 500
    us = rng.integers(-(10 ** 15) // 2, 10 ** 15 * 2, n)
    t = pa.table({"ts": pa.array(us, pa.timestamp("us", tz="UTC"),
                                 mask=rng.random(n) < 0.05)})
    _check(t, lambda a, df: df.select(*[
        getattr(a[3], f)("ts").alias(f) for f in (
            "year", "month", "dayofmonth", "dayofweek", "dayofyear",
            "quarter", "last_day")]))
