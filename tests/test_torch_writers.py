"""The torch port's writers against the JAX package's.

``write_csv`` makes its text with torch ops (on the CPU here) and no
pyarrow, and its files must be byte for byte those of the JAX package's
``write_csv`` (pyarrow's ``CSVWriter``) for the same table: fixed tables
of every type with nulls, quotes and the doubles whose layout Arrow
picks (decimal, exponent, ``-0``, ``nan``, ``inf``), and a hypothesis
run over doubles (random bit patterns included), nulls and strings with
quotes against pyarrow itself.  The save modes (error, ignore,
overwrite, append) against the JAX package's; the ``partition_by``
layout (a null as ``__HIVE_DEFAULT_PARTITION__``, ``we/st`` as
``we%2Fst``, an append adding a file) against the JAX package's parquet
layout; parquet and ORC round trips through both packages (tier-1: they
need pyarrow); and ``PyarrowRequiredError`` where pyarrow cannot be
imported, while CSV still writes and reads.
"""

import io
import os
import sys

import numpy as np
import pyarrow as pa
import pyarrow.csv as pacsv
import pytest
from hypothesis import given, settings, strategies as hst

import spark_rapids_tpu_torch as st
from spark_rapids_tpu_torch.columnar.batch import host_batch_to_device, \
    host_columns_from_arrow
from spark_rapids_tpu_torch.io import csvformat
from tests.compare import assert_tables_equal, tpu_session

CPU = {"spark.rapids.torch.device": "cpu"}

SPECIAL_DOUBLES = [1.0, -0.0, 0.0, 1.5e-6, 1e-6, 1e-7, 1.5e-7, 1e20, 1e16,
                   1e15, 1e17, 1.2345678901234568e17, 123456789012345.6,
                   1234567890123456.7, float("nan"), float("inf"),
                   -float("inf"), 0.1, 100.0, 1e21, 2.5e-5, 5e-324,
                   1.7976931348623157e308, 0.001, 123.456, 1e9, 1e10,
                   9999999999.0, -1e-7, 0.00001234, 55335.55, 0.04, 7.0,
                   2.0 ** 53, 2.0 ** 53 + 2, 0.30000000000000004]


def _table(n=400, seed=1):
    rng = np.random.default_rng(seed)
    d = np.array((SPECIAL_DOUBLES * (n // len(SPECIAL_DOUBLES) + 1))[:n])
    return pa.table({
        "d": pa.array(d, mask=rng.random(n) < 0.1),
        "r": pa.array(rng.normal(size=n) * 10.0 ** rng.integers(-9, 12, n)),
        "i": pa.array(rng.integers(-10 ** 18, 10 ** 18, n),
                      mask=rng.random(n) < 0.1),
        "i32": pa.array(rng.integers(-100, 100, n).astype(np.int32)),
        "b": pa.array(rng.random(n) < 0.5, mask=rng.random(n) < 0.1),
        "s": pa.array(np.array(["a", "", 'x"y', "a,b", "é", '""q"', "NULL"],
                               dtype=object)[rng.integers(0, 7, n)],
                      mask=rng.random(n) < 0.1),
        "dt": pa.array(rng.integers(-30000, 30000, n).astype(np.int32)
                       ).cast(pa.date32()),
        "ts": pa.array(rng.integers(-2 * 10 ** 15, 4 * 10 ** 15, n)
                       ).cast(pa.timestamp("us", tz="UTC")),
        "f": pa.array(rng.normal(size=n).astype(np.float32)),
    })


def _part_files(path):
    return sorted(os.path.relpath(os.path.join(d, f), path)
                  for d, _, fs in os.walk(path) for f in fs)


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def test_write_csv_is_jax_byte_for_byte(tmp_path):
    t = _table()
    tpu_session().create_dataframe(t).write.csv(str(tmp_path / "j"))
    st.TorchSession(CPU).create_dataframe(t).write.csv(str(tmp_path / "t"))
    assert _part_files(str(tmp_path / "t")) == ["part-00000.csv"]
    want = _read(str(tmp_path / "j" / "part-00000.csv"))
    got = _read(str(tmp_path / "t" / "part-00000.csv"))
    assert got == want


def test_write_csv_of_a_query_and_read_back(tmp_path):
    from spark_rapids_tpu import functions as JF
    from spark_rapids_tpu_torch import functions as TF
    t = _table(2000, seed=2)
    jdf = tpu_session().create_dataframe(t)
    tdf = st.TorchSession(CPU).create_dataframe(t)
    jq = jdf.filter(JF.col("i32") > 0).select("s", "d", "dt")
    tq = tdf.filter(TF.col("i32") > 0).select("s", "d", "dt")
    jq.write.csv(str(tmp_path / "j"))
    tq.write.csv(str(tmp_path / "t"))
    assert _read(str(tmp_path / "t" / "part-00000.csv")) == \
        _read(str(tmp_path / "j" / "part-00000.csv"))
    back = st.TorchSession(CPU).read.csv(str(tmp_path / "t")).to_arrow()
    jback = tpu_session().read.csv(str(tmp_path / "j")).to_arrow()
    assert back.schema == jback.schema
    assert_tables_equal(back, jback, ignore_order=False)


_DOUBLES = hst.one_of(
    hst.floats(width=64),
    hst.integers(0, 2 ** 64 - 1).map(
        lambda b: float(np.array([b], np.uint64).view(np.float64)[0])),
    hst.decimals(allow_nan=False, allow_infinity=False, places=4,
                 min_value=-10 ** 9, max_value=10 ** 9).map(float))


@settings(max_examples=60, deadline=None)
@given(hst.lists(hst.tuples(_DOUBLES, hst.booleans(),
                            hst.text(alphabet='ab",\\ é', max_size=6),
                            hst.booleans()), min_size=1, max_size=50))
def test_doubles_nulls_and_quotes_are_pyarrow_bytes(rows):
    d = pa.array([x for x, _, _, _ in rows], pa.float64(),
                 mask=np.array([m for _, m, _, _ in rows]))
    s = pa.array([x for _, _, x, _ in rows], pa.string(),
                 mask=np.array([m for _, _, _, m in rows]))
    t = pa.table({"d": d, "s": s})
    buf = io.BytesIO()
    pacsv.write_csv(t, buf)
    schema, cols = host_columns_from_arrow(t)
    batch = host_batch_to_device(schema, cols, "cpu")
    got = csvformat.header(schema, ",") + csvformat.format_rows(
        schema, batch.columns, batch.num_rows)
    assert got == buf.getvalue()


@pytest.mark.parametrize("mode", ["error", "ignore", "overwrite", "append"])
def test_save_modes_match_jax(tmp_path, mode):
    from spark_rapids_tpu.io.writers import WriteModeError as JWriteModeError
    t = _table(50)
    outs = {}
    for name, sess, err in (("j", tpu_session(), JWriteModeError),
                            ("t", st.TorchSession(CPU), st.WriteModeError)):
        path = str(tmp_path / name)
        df = sess.create_dataframe(t)
        df.write.csv(path)
        w = df.limit(5).write.mode(mode)
        if mode == "error":
            with pytest.raises(err):
                w.csv(path)
        else:
            w.csv(path)
        outs[name] = {f: _read(os.path.join(path, f))
                      for f in _part_files(path)}
    assert outs["t"] == outs["j"]
    expect = {"error": 1, "ignore": 1, "overwrite": 1, "append": 2}[mode]
    assert len(outs["t"]) == expect


def test_unknown_mode_and_append_to_a_file_raise(tmp_path):
    df = st.TorchSession(CPU).create_dataframe({"a": np.arange(3)})
    df.write.csv(str(tmp_path / "x"))
    with pytest.raises(st.WriteModeError, match="unknown save mode"):
        df.write.mode("sideways").csv(str(tmp_path / "x"))
    p = str(tmp_path / "file")
    open(p, "w").close()
    with pytest.raises(st.WriteModeError, match="non-directory"):
        df.write.mode("append").csv(p)


def _regions():
    return pa.table({
        "region": pa.array(["east", None, "we/st", "east", "we/st", None]),
        "v": pa.array([1.0, 2.0, 3.0, 4.0, 5.0, 6.0]),
        "k": pa.array([1, 2, 3, 4, 5, 6], pa.int64())})


def test_partition_by_layout_matches_jax(tmp_path):
    t = _regions()
    tpu_session().create_dataframe(t).write.partition_by("region") \
        .parquet(str(tmp_path / "jp"))
    s = st.TorchSession(CPU)
    s.create_dataframe(t).write.partitionBy("region") \
        .parquet(str(tmp_path / "tp"))
    s.create_dataframe(t).write.partition_by("region").csv(
        str(tmp_path / "tc"))
    jfiles = _part_files(str(tmp_path / "jp"))
    assert jfiles == _part_files(str(tmp_path / "tp"))
    assert [f.replace(".parquet", ".csv") for f in jfiles] == \
        _part_files(str(tmp_path / "tc"))
    assert "region=__HIVE_DEFAULT_PARTITION__/part-00000.parquet" in jfiles
    assert "region=we%2Fst/part-00000.parquet" in jfiles
    # each directory holds its rows without the partition column
    back = s.read.csv(str(tmp_path / "tc")).to_arrow()
    jback = tpu_session().read.parquet(str(tmp_path / "jp")).to_arrow()
    assert back.column_names == ["v", "k", "region"]
    assert_tables_equal(back, jback.select(back.column_names))
    # an append adds a file next to each one
    s.create_dataframe(t).write.partition_by("region").mode("append").csv(
        str(tmp_path / "tc"))
    files = _part_files(str(tmp_path / "tc"))
    assert "region=east/part-00001.csv" in files and len(files) == 6
    assert s.read.csv(str(tmp_path / "tc")).to_arrow().num_rows == 12


def test_partition_by_an_unknown_column_raises(tmp_path):
    df = st.TorchSession(CPU).create_dataframe({"a": np.arange(3)})
    with pytest.raises(st.WriteModeError, match="not in schema"):
        df.write.partition_by("zz").csv(str(tmp_path / "p"))


@pytest.mark.parametrize("fmt", ["parquet", "orc"])
def test_parquet_and_orc_round_trips(tmp_path, fmt):
    t = _table(300, seed=5).drop(["ts"]) if fmt == "orc" else _table(300)
    s = st.TorchSession(CPU)
    getattr(s.create_dataframe(t).write, fmt)(str(tmp_path / "t"))
    getattr(tpu_session().create_dataframe(t).write, fmt)(
        str(tmp_path / "j"))
    got = getattr(s.read, fmt)(str(tmp_path / "t")).to_arrow()
    want = getattr(tpu_session().read, fmt)(str(tmp_path / "j")).to_arrow()
    jgot = getattr(tpu_session().read, fmt)(str(tmp_path / "t")).to_arrow()
    assert got.schema == want.schema
    assert_tables_equal(got, want, ignore_order=False)
    assert_tables_equal(jgot, want, ignore_order=False)


@pytest.fixture
def no_pyarrow(monkeypatch):
    """Make ``import pyarrow`` fail for the test's length."""
    for m in [m for m in sys.modules
              if m == "pyarrow" or m.startswith("pyarrow.")]:
        monkeypatch.delitem(sys.modules, m)
    monkeypatch.setitem(sys.modules, "pyarrow", None)


def test_parquet_and_orc_need_pyarrow_csv_does_not(tmp_path, no_pyarrow):
    s = st.TorchSession(CPU)
    df = s.create_dataframe({"a": np.arange(5), "s": np.array(list("abcde"))})
    for fn in (lambda: df.write.parquet(str(tmp_path / "p")),
               lambda: df.write.orc(str(tmp_path / "o")),
               lambda: s.read.orc(str(tmp_path / "none.orc")),
               lambda: s.read.parquet(str(tmp_path / "none.parquet"))):
        with pytest.raises(st.PyarrowRequiredError, match="pyarrow"):
            fn()
    assert not os.path.exists(str(tmp_path / "p"))
    df.write.csv(str(tmp_path / "c"))
    back = s.read.csv(str(tmp_path / "c")).to_numpy()
    assert back["a"].tolist() == list(range(5))
    assert back["s"].tolist() == list("abcde")
