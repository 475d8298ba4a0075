"""The torch port's CSV reader, decoded by torch ops (on the CPU here),
against the JAX package's pyarrow reader over the same files.

Each case writes a file, reads it with both packages and holds the
inferred schema and every value equal: every type the reader infers
(int64, double, boolean, date, timestamp, string) and pyarrow's traps
as the JAX package meets them (NaN read as null in a double column,
``NULL`` and an empty field kept as strings, a 0/1 column as int64,
``1e400`` as inf, quoted delimiters and doubled quotes, a quote inside
an unquoted field or after a field's closing quote kept as text (also
over hypothesis-made rows), ``\\r\\n`` and
empty lines, no header, ``sep=";"``, spaces around numbers); a user
schema by position; a directory of files; files larger than one host
range and one batch; an all-empty column refused with the JAX package's
``TypeError``; and a column inferred int64 that meets a double past the
first block, which both refuse.  A hypothesis run holds every double's
decode exactly to Python's and pyarrow's, and ``csvSlowFloatFields`` to
the count of fields outside the fast path, computed apart with
``decimal``.
"""

import decimal
import io
import math
import os

import numpy as np
import pyarrow as pa
import pyarrow.csv as pacsv
import pytest
from hypothesis import given, settings, strategies as hst

import spark_rapids_tpu_torch as st
from spark_rapids_tpu_torch import functions as TF
from spark_rapids_tpu_torch.columnar.dtypes import FLOAT64, INT64, STRING, \
    Field, Schema
from spark_rapids_tpu_torch.io import csv as tcsv
from tests.compare import assert_tables_equal, tpu_session
from tests.torch_threads import _one_torch_thread  # noqa: F401

CPU = {"spark.rapids.torch.device": "cpu"}

CASES = {
    "types": ("i,d,b,dt,ts,s\n"
              "1,1.5,true,1995-03-15,1995-03-15 10:00:00Z,abc\n"
              "-2,-0.25,False,2000-02-29,2000-01-01 01:02:03Z,\"x y\"\n"
              "3,1e5,TRUE,1970-01-01,1969-12-31 23:59:59Z,z\n"),
    "nan_is_null": "d,k\n1.5,1\nNaN,2\nnan,3\nNA,4\n,5\n-2.25,6\n",
    "null_string_is_string": "s,k\nNULL,1\n,2\nNA,3\nabc,4\n\"\",5\n",
    "zero_one_is_int": "a,b\n0,1\n1,true\n0,0\n",
    "inf": "d\n1e400\n-1e400\ninf\n-Infinity\n2.5\n",
    "quoted": ('a,b,c\n"x,y",1,"q""uote"\n"",2,""\n"a""",3,plain\n'
               '"7",4,"sp ace"\n'),
    "crlf_and_empty_lines": "a,b\r\n1,x\r\n\r\n2,y\r\n\n3,z\r\n",
    "spaces": "a,b\n 1, 2.5\n2 ,3.5 \n",
    "timestamps": ("t,u\n2000-01-01T01:02:03Z,2000-01-01 01:02:03Z\n"
                   "1995-03-15 10:00Z,1995-03-15 10:00:00.123456Z\n"),
    "dates_invalid_are_strings": "d\n2000-02-30\n2000-01-01\n",
    "utf8": "s,n\nécole,1\n日本語,2\n\"a,é\",3\n",
    "no_trailing_newline": "a,b\n1,2\n3,4",
    "stray_quotes": ('a,b\n5" x,1\n1"2"3,2\n"ab"c"d,3\n"a,b"x",4\n ",5\n'
                     'x",6\n'),
    "text_after_closing_quote": 'a,b\n"1"2,3\n"4" ,5\n"""q"""r,6\n',
}


def _write(path, text, mode="w"):
    with open(path, mode, encoding="utf-8", newline="") as f:
        f.write(text)
    return path


def _both(path, header=True, sep=",", schema=None, jschema=None):
    js = tpu_session()
    jr = js.read if jschema is None else js.read.schema(jschema)
    want = jr.csv(path, header=header, sep=sep).to_arrow()
    s = st.TorchSession(CPU)
    tr = s.read if schema is None else s.read.schema(schema)
    got = tr.csv(path, header=header, sep=sep).to_arrow()
    return got, want


@pytest.mark.parametrize("case", sorted(CASES))
def test_inference_and_values_match_jax(tmp_path, case):
    path = _write(str(tmp_path / "t.csv"), CASES[case])
    got, want = _both(path)
    assert got.schema == want.schema, (got.schema, want.schema)
    assert_tables_equal(got, want, ignore_order=False)
    if case == "nan_is_null":
        assert got.column("d").null_count == 4
    if case == "null_string_is_string":
        assert got.column("s").to_pylist() == ["NULL", "", "NA", "abc", ""]
    if case == "inf":
        assert got.column("d").to_pylist()[:2] == [math.inf, -math.inf]


def test_naive_timestamps_read_as_utc(tmp_path):
    # pyarrow infers timestamp[s] for a naive column, and the JAX scan
    # then fails casting it to its UTC type; the port reads it as UTC
    path = _write(str(tmp_path / "n.csv"),
                  "t\n1995-03-15 10:00:00\n2000-01-01T01:02:03.5\n")
    assert pacsv.read_csv(path).schema.field("t").type.tz is None
    with pytest.raises(pa.ArrowInvalid, match="zone"):
        tpu_session().read.csv(path).to_arrow()
    got = st.TorchSession(CPU).read.csv(path).to_numpy()["t"]
    assert got.tolist() == np.array(
        ["1995-03-15T10:00:00", "2000-01-01T01:02:03.5"],
        "datetime64[us]").tolist()


# a field that begins with a quote is a quoted one: made by _QUOTED,
# closed on its line
_UNQUOTED = hst.text(alphabet='a1 "', max_size=4).filter(
    lambda t: not t.startswith('"'))
_QUOTED = hst.builds(lambda body, tail: '"' + body + '"' + tail,
                     hst.text(alphabet='a1 ,"', max_size=4).map(
                         lambda t: t.replace('"', '""')),
                     _UNQUOTED.filter(lambda t: len(t) <= 2))


@settings(max_examples=40, deadline=None)
@given(hst.lists(hst.lists(hst.one_of(_UNQUOTED, _QUOTED), min_size=3,
                           max_size=3), min_size=1, max_size=6))
def test_quotes_anywhere_split_as_jax_does(tmp_path_factory, rows):
    # a quote opens a quoted field only at the field's start; anywhere
    # else, and after the quote that closes a field, it is text
    body = "x,y,z\n" + "".join(",".join(r) + "\n" for r in rows)
    path = _write(str(tmp_path_factory.mktemp("q") / "q.csv"), body)
    try:
        want = tpu_session().read.csv(path).to_arrow()
    except (ValueError, TypeError) as e:
        with pytest.raises(type(e) if isinstance(e, TypeError)
                           else ValueError):
            st.TorchSession(CPU).read.csv(path).to_arrow()
        return
    got = st.TorchSession(CPU).read.csv(path).to_arrow()
    assert got.schema == want.schema, body
    assert_tables_equal(got, want, ignore_order=False)


def test_header_less_and_semicolon_match_jax(tmp_path):
    path = _write(str(tmp_path / "h.csv"), "1;a;2.5\n2;b;3.5\n")
    got, want = _both(path, header=False, sep=";")
    assert got.schema == want.schema
    assert got.column_names == ["f0", "f1", "f2"]
    assert_tables_equal(got, want, ignore_order=False)


def test_user_schema_applies_by_position(tmp_path):
    from spark_rapids_tpu.columnar.dtypes import (
        FLOAT64 as JF64, INT64 as JI64, STRING as JSTR, Field as JField,
        Schema as JSchema)
    path = _write(str(tmp_path / "u.csv"), "x,y,z\n1,2,a\n3,4.5,b\n")
    schema = Schema([Field("k", INT64), Field("v", FLOAT64),
                     Field("s", STRING)])
    jschema = JSchema([JField("k", JI64), JField("v", JF64),
                       JField("s", JSTR)])
    got, want = _both(path, schema=schema, jschema=jschema)
    assert got.column_names == ["k", "v", "s"]
    assert got.schema == want.schema
    assert_tables_equal(got, want, ignore_order=False)


def test_directory_of_files_matches_jax(tmp_path):
    d = tmp_path / "dir"
    os.makedirs(d / "sub")
    _write(str(d / "a.csv"), "k,v\n1,1.5\n2,2.5\n")
    _write(str(d / "sub" / "b.csv"), "k,v\n3,3.5\n")
    _write(str(d / "ignored.txt"), "not csv\n")
    got, want = _both(str(d))
    assert_tables_equal(got, want, ignore_order=False)
    assert got.num_rows == 3


def _big(tmp_path, rows=60_000, seed=3):
    rng = np.random.default_rng(seed)
    t = pa.table({
        "k": pa.array(rng.integers(-1000, 1000, rows)),
        "v": pa.array(np.round(rng.normal(size=rows) * 1000, 3),
                      mask=rng.random(rows) < 0.05),
        "s": pa.array(np.array(["a", "bb,c", 'q"q', "", "long " * 9],
                               dtype=object)[rng.integers(0, 5, rows)]),
        "d": pa.array(rng.integers(0, 20000, rows).astype(np.int32)
                      ).cast(pa.date32()),
    })
    path = str(tmp_path / "big.csv")
    pacsv.write_csv(t, path)
    return path, t


def test_files_larger_than_one_range_and_one_batch(tmp_path, monkeypatch):
    path, _ = _big(tmp_path)
    assert os.path.getsize(path) > 3 * 65536
    monkeypatch.setattr(tcsv, "RANGE_BYTES", 65536)
    s = st.TorchSession({**CPU,
                         "spark.rapids.sql.reader.batchSizeRows": "5000"})
    df = s.read.csv(path)
    batches = df.to_device_batches()
    # whole batches across the 64 KiB ranges, as the in-memory scan cuts
    assert [b.num_rows for b in batches] == [5000] * 12
    got = df.to_arrow()
    want = tpu_session().read.csv(path).to_arrow()
    assert got.schema == want.schema
    assert_tables_equal(got, want, ignore_order=False)
    g = (s.read.csv(path).group_by("k").agg(TF.sum(TF.col("v")).alias("sv"))
         .order_by("k").to_arrow())
    from spark_rapids_tpu import functions as JF
    w = (tpu_session().read.csv(path).group_by("k")
         .agg(JF.sum(JF.col("v")).alias("sv")).order_by("k").to_arrow())
    assert_tables_equal(g, w, ignore_order=False, approx_float=True)


def test_all_empty_column_is_refused_like_jax(tmp_path):
    path = _write(str(tmp_path / "n.csv"), "a,b\n,1\n,2\n")
    with pytest.raises(TypeError, match="null"):
        tpu_session().read.csv(path)
    with pytest.raises(TypeError, match="null"):
        st.TorchSession(CPU).read.csv(path)


def test_int_column_meeting_a_double_later_fails_like_jax(tmp_path):
    rows = (tcsv.INFER_BLOCK_BYTES // 8) + 10
    text = "k,v\n" + "".join(f"{i},{i % 7}\n" for i in range(rows)) \
        + "5,1.5\n"
    path = _write(str(tmp_path / "late.csv"), text)
    jdf = tpu_session().read.csv(path)
    assert str(jdf.plan.output_schema()) .count("long") == 2
    with pytest.raises(pa.ArrowInvalid):
        jdf.to_arrow()
    df = st.TorchSession(CPU).read.csv(path)
    assert [f.dtype for f in df.plan.output_schema()] == [INT64, INT64]
    with pytest.raises(st.CsvConversionError, match="1.5"):
        df.to_arrow()


def test_ragged_row_raises(tmp_path):
    path = _write(str(tmp_path / "r.csv"), "a,b\n1,2\n3\n")
    with pytest.raises(st.CsvParseError):
        st.TorchSession(CPU).read.csv(path).to_arrow()
    with pytest.raises(pa.ArrowInvalid):
        tpu_session().read.csv(path).to_arrow()


def test_unclosed_quote_raises(tmp_path):
    path = _write(str(tmp_path / "q.csv"), 'a,b\n1,2\n"x,3\n')
    with pytest.raises(st.CsvParseError, match="not closed"):
        st.TorchSession(CPU).read.csv(path).to_arrow()
    with pytest.raises(pa.ArrowInvalid):
        tpu_session().read.csv(path).to_arrow()


def test_csv_scan_imports_no_pyarrow_module_level():
    src = open(tcsv.__file__, encoding="utf-8").read()
    assert "import pyarrow" not in src


# ---------------------------------------------------------------------------
# doubles: exact, and the slow path counted exactly
# ---------------------------------------------------------------------------

def _is_fast(text: str) -> bool:
    """The fast path's rule, computed apart: a mantissa (trailing zeros
    dropped) below 2^53 and a decimal exponent within 22 of 0."""
    low = text.strip().lower().lstrip("+-")
    if low in ("inf", "infinity"):
        return False
    sign, digits, exp = decimal.Decimal(text.strip()).as_tuple()
    digits = list(digits)
    while len(digits) > 1 and digits[-1] == 0:
        digits.pop()
        exp += 1
    m = int("".join(map(str, digits)))
    return m == 0 or (m < 2 ** 53 and abs(exp) <= 22)


_FORMATS = [repr, lambda x: f"{x:.17g}", lambda x: f"{x:.6e}",
            lambda x: f"{x:.3f}", lambda x: f"{x:.15g}",
            lambda x: f"{x:E}"]


@settings(max_examples=60, deadline=None)
@given(hst.lists(hst.tuples(
    hst.floats(allow_nan=False, allow_infinity=True, width=64),
    hst.integers(0, len(_FORMATS) - 1)), min_size=1, max_size=40))
def test_doubles_decode_exactly_and_slow_fields_counted(tmp_path_factory,
                                                        values):
    texts = [_FORMATS[i](x) for x, i in values]
    texts = [t.replace("inf", "Infinity") if "inf" in t else t
             for t in texts]
    body = "v\n" + "".join(t + "\n" for t in texts)
    path = str(tmp_path_factory.mktemp("dbl") / "d.csv")
    _write(path, body)
    s = st.TorchSession(CPU)
    got = s.read.schema(Schema([Field("v", FLOAT64)])).csv(path).to_numpy()
    want = np.array([float(t) for t in texts])
    assert np.array_equal(np.asarray(got["v"]).view(np.int64),
                          want.view(np.int64)), (texts, got["v"], want)
    arrow = pacsv.read_csv(io.BytesIO(body.encode()), convert_options=
                           pacsv.ConvertOptions(column_types={
                               "v": pa.float64()}))
    assert np.array_equal(arrow.column("v").to_numpy().view(np.int64),
                          want.view(np.int64))
    scan = s._last_plan
    while scan.children:
        scan = scan.children[0]
    assert scan.metrics["csvSlowFloatFields"] == \
        sum(not _is_fast(t) for t in texts)
