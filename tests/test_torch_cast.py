"""The torch port's casts against the JAX package.

To STRING: every integral width (``INT64_MIN`` and ``INT64_MAX``
among them), booleans, dates (before 1970, year 1 and 9999) and
timestamps (before 1970, fractions with and without trailing zeros).
From STRING: integral (with and without sign, spaces around, more than
18 digits, out of a narrow type's range, malformed), floating (exponents,
a lone dot, malformed) and boolean (Spark's word lists, any case); the
JAX package parses these on its device.  Between DATE, TIMESTAMP and
the numeric types.  String -> DATE and -> TIMESTAMP, which the JAX
device refuses, are held against a Python rendering of the same forms,
and ``CAST(CAST(x AS STRING) AS DATE|TIMESTAMP)`` must give ``x`` back.

Tolerances: exact, except string -> double within 2 ulp (the JAX
package and the port both sum the mantissa's digits in f64, but XLA's
CPU ``pow`` and torch's can differ by an ulp).  Every gate is on for the
parity runs; at the default conf each gated cast raises naming its key
(``tests/test_torch_functions.py``), and float -> string raises even
with its gate on, as on the JAX device.
"""

import datetime as dt

import numpy as np
import pyarrow as pa
import pytest

from spark_rapids_tpu.api import col
from tests.compare import assert_tables_equal, tpu_session

import spark_rapids_tpu_torch as st

GATES = {"spark.rapids.sql.castStringToInteger.enabled": True,
         "spark.rapids.sql.castStringToFloat.enabled": True,
         "spark.rapids.sql.castStringToTimestamp.enabled": True}


def _port(conf=None):
    return st.TorchSession({"spark.rapids.torch.device": "cpu", **GATES,
                            **(conf or {})})


def _both(t, build):
    want = build(col, tpu_session(GATES).create_dataframe(t)).to_arrow()
    got = build(st.col, _port().create_dataframe(t)).to_arrow()
    return got, want


def _check(t, build):
    got, want = _both(t, build)
    assert got.schema.types == want.schema.types
    assert_tables_equal(got, want, ignore_order=False)
    return got


def _ints(n=1500, seed=2):
    rng = np.random.default_rng(seed)
    i64 = rng.integers(-(2 ** 62), 2 ** 62, n)
    i64[:6] = [np.iinfo(np.int64).min, np.iinfo(np.int64).max, 0, -1, 1,
               -10 ** 18]
    mask = rng.random(n) < 0.05
    return pa.table({
        "b": pa.array(rng.integers(-128, 128, n).astype(np.int8), mask=mask),
        "h": pa.array(rng.integers(-2 ** 15, 2 ** 15, n).astype(np.int16)),
        "i": pa.array(rng.integers(-2 ** 31, 2 ** 31, n).astype(np.int32)),
        "l": pa.array(i64, mask=mask),
        "z": pa.array(rng.random(n) < 0.5, mask=mask),
        # 0001-01-01 to 9999-12-31, the years a date renders in
        "d": pa.array(rng.integers(-719_162, 2_932_897, n).astype(np.int32),
                      pa.date32()),
        "ts": pa.array(np.concatenate([
            [-1, 0, 1, -86_400_000_000, 1_500_000, 1_230_000],
            rng.integers(-(10 ** 16), 10 ** 16, n - 6)]),
            pa.timestamp("us", tz="UTC"), mask=mask),
    })


def test_to_string_matches_jax():
    _check(_ints(), lambda c, df: df.select(*[
        c(n).cast("string").alias(n) for n in ("b", "h", "i", "l", "z",
                                               "d", "ts")]))


def test_date_to_string_edges_match_jax():
    days = [(dt.date(y, m, d) - dt.date(1970, 1, 1)).days
            for y, m, d in [(1, 1, 1), (9999, 12, 31), (1969, 12, 31),
                            (2000, 2, 29), (1900, 3, 1), (1582, 10, 4)]]
    t = pa.table({"d": pa.array(days, pa.int32()).cast(pa.date32())})
    got = _check(t, lambda c, df: df.select(c("d").cast("string")
                                            .alias("s")))
    assert got.column("s").to_pylist()[:3] == [
        "0001-01-01", "9999-12-31", "1969-12-31"]


NUMBERS = ["0", "42", "-17", "+8", " 123 ", "00012", "-0", "", "   ",
           "12a", "a12", "1 2", "-", "+", "99999999999999999", "123456789012345678",
           "1234567890123456789", "-9223372036854775808", "3.5", "1e3",
           "127", "128", "-129", "32768", "2147483648", "-2147483649",
           ".5", "5.", "-.25", "1.5e10", "2.5E-3", "1e", "1e+", "e5",
           "1.2.3", "--1", "١٢", "tRuE", "Yes", "n", "F", "0", "1", "true ",
           "maybe", None]


def test_string_to_numbers_and_bools_match_jax():
    t = pa.table({"s": pa.array(NUMBERS * 20)})
    _check(t, lambda c, df: df.select(
        *[c("s").cast(ty).alias(ty) for ty in
          ("tinyint", "smallint", "int", "bigint", "boolean")]))


def test_string_to_double_within_2_ulp():
    rng = np.random.default_rng(8)
    vals = [repr(float(x)) for x in rng.normal(size=600) * 10.0 **
            rng.integers(-30, 30, 600)] + NUMBERS
    t = pa.table({"s": pa.array(vals)})
    got, want = _both(t, lambda c, df: df.select(
        c("s").cast("double").alias("d"), c("s").cast("float").alias("f")))
    for name in ("d", "f"):
        g, w = got.column(name).to_pylist(), want.column(name).to_pylist()
        assert [x is None for x in g] == [x is None for x in w]
        for a, b in zip(g, w):
            if a is None:
                continue
            ulp = np.spacing(np.float32(abs(b))) if name == "f" \
                else np.spacing(abs(b))
            assert a == b or abs(a - b) <= 2 * ulp, (name, a, b)


def test_between_dates_timestamps_and_numbers_match_jax():
    t = _ints()
    _check(t, lambda c, df: df.select(
        c("d").cast("timestamp").alias("d_ts"),
        c("ts").cast("date").alias("ts_d"),
        c("ts").cast("bigint").alias("ts_l"),
        c("ts").cast("double").alias("ts_f"),
        c("i").cast("timestamp").alias("i_ts"),
        c("z").cast("int").alias("z_i"),
        c("l").cast("boolean").alias("l_z")))


def _py_date(s):
    """Spark's accepted DATE forms, the reference for the port's parser:
    yyyy, yyyy-[m]m, yyyy-[m]m-[d]d, then optionally ' ' or 'T' and
    anything, after trimming spaces."""
    import re
    if s is None:
        return None
    m = re.fullmatch(r"(\d{4})(?:-(\d{1,2})(?:-(\d{1,2})(?:[ T].*)?)?)?",
                     s.strip(" "), re.S)
    if not m:
        return None
    try:
        return dt.date(int(m.group(1)), int(m.group(2) or 1),
                       int(m.group(3) or 1))
    except ValueError:
        return None


def _py_timestamp(s):
    """A date form alone (midnight), or a whole date, ' ' or 'T', and
    hh:mm:ss[.f{1,6}] (UTC)."""
    import re
    if s is None:
        return None
    t = s.strip(" ")
    m = re.fullmatch(r"(\d{4}-\d{1,2}-\d{1,2})[ T](\d{2}):(\d{2}):(\d{2})"
                     r"(?:\.(\d{1,6}))?", t)
    if m:
        d = _py_date(m.group(1))
        h, mi, sec = (int(m.group(i)) for i in (2, 3, 4))
        if d is None or h > 23 or mi > 59 or sec > 59:
            return None
        frac = int((m.group(5) or "0").ljust(6, "0"))
        return dt.datetime(d.year, d.month, d.day, h, mi, sec, frac,
                           tzinfo=dt.timezone.utc)
    if re.fullmatch(r"\d{4}(-\d{1,2}(-\d{1,2})?)?", t):
        d = _py_date(t)
        return None if d is None else dt.datetime(
            d.year, d.month, d.day, tzinfo=dt.timezone.utc)
    return None


DATES = ["2020-01-15", " 1999-12-31 ", "2020-2-3", "2020-02", "2020",
         "1969-12-31", "0001-01-01", "2000-02-29", "2001-02-29",
         "2020-13-01", "2020-00-10", "2020-04-31", "2020-01-15T10:00",
         "2020-01-15 junk", "2020-01-15junk", "20-01-15", "2020/01/15",
         "", "abc", "2020-01-", "2020-1-1", None,
         "2020-01-15 10:20:30", "2020-01-15T23:59:59.5",
         "1960-06-30 01:02:03.000001", "2020-01-15 24:00:00",
         "2020-01-15 10:61:00", "2020-01-15 10:20:30.1234567",
         "2020-01-15 10:20", "2020-01-15 10:20:30.", "1970-01-01 00:00:00"]


def test_string_to_date_and_timestamp_follow_spark_forms():
    df = _port().create_dataframe(pa.table({"s": pa.array(DATES)}))
    got = df.select(st.col("s").cast("date").alias("d"),
                    st.col("s").cast("timestamp").alias("ts")).collect()
    assert [r["d"] for r in got] == [_py_date(s) for s in DATES]
    assert [r["ts"] for r in got] == [_py_timestamp(s) for s in DATES]


def test_dates_and_timestamps_round_trip_through_strings():
    t = _ints()
    df = _port().create_dataframe(t)
    got = df.select(
        "d", st.col("d").cast("string").cast("date").alias("d2"),
        "ts", st.col("ts").cast("string").cast("timestamp").alias("ts2")) \
        .to_arrow()
    assert got.column("d2").to_pylist() == got.column("d").to_pylist()
    assert got.column("ts2").to_pylist() == got.column("ts").to_pylist()


def test_float_to_string_is_refused_even_with_its_gate_on():
    df = _port({"spark.rapids.sql.castFloatToString.enabled": True}) \
        .create_dataframe({"f": np.array([1.5])})
    with pytest.raises(NotImplementedError, match="castFloatToString"):
        df.select(st.col("f").cast("string").alias("s")).collect()


def test_casts_through_sql_match_jax():
    t = _ints()
    js, ts = tpu_session(GATES), _port()
    js.create_dataframe(t).create_or_replace_temp_view("t")
    ts.create_dataframe(t).create_or_replace_temp_view("t")
    q = ("SELECT CAST(l AS STRING) s, CAST(CAST(i AS STRING) AS BIGINT) r, "
         "CAST(d AS TIMESTAMP) dt, CAST(ts AS DATE) td, "
         "CAST(CAST(z AS STRING) AS BOOLEAN) zb FROM t")
    assert_tables_equal(ts.sql(q).to_arrow(), js.sql(q).to_arrow(),
                        ignore_order=False)
