"""Hive partitions in the torch port against the JAX package.

``discover`` over the same file lists (types int64, then float64, then
string; ``__HIVE_DEFAULT_PARTITION__`` as null; ``%XX`` escapes undone;
a mixed layout read as plain files); ``prune_files`` over bound
predicates; and partitioned parquet and CSV reads with filters on the
partition columns: the files each scan read (``numFilesRead`` of
``numFilesTotal``) against the JAX package's parquet scan, and every
result against the JAX session's.  The JAX package's CSV scan prunes
nothing, so its CSV results are the reference there, not its counts.
"""

import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import spark_rapids_tpu_torch as st
from spark_rapids_tpu import functions as JF
from spark_rapids_tpu.exec.base import ExecContext
from spark_rapids_tpu.io import hivepart as jhive
from spark_rapids_tpu.plan.planner import plan_query as jplan
from spark_rapids_tpu_torch import functions as TF
from spark_rapids_tpu_torch.io import hivepart as thive
from tests.compare import assert_tables_equal, tpu_session

CPU = {"spark.rapids.torch.device": "cpu"}


def _touch(path):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    open(path, "w").close()
    return path


LAYOUTS = {
    "ints": ["y=2020/m=1/a.csv", "y=2021/m=12/b.csv", "y=2021/m=3/c.csv"],
    "floats": ["x=1.5/a.csv", "x=2/b.csv"],
    "strings": ["r=east/a.csv", "r=we%2Fst/b.csv",
                "r=__HIVE_DEFAULT_PARTITION__/c.csv", "r=1x/d.csv"],
    "null_int": ["n=__HIVE_DEFAULT_PARTITION__/a.csv", "n=7/b.csv"],
    "mixed": ["y=1/a.csv", "b.csv"],
    "unequal": ["y=1/a.csv", "z=1/b.csv"],
}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_discover_matches_jax(tmp_path, layout):
    root = str(tmp_path / layout)
    files = [_touch(os.path.join(root, f)) for f in LAYOUTS[layout]]
    js, jv = jhive.discover([root], files)
    ts, tv = thive.discover([root], files)
    assert tv == jv
    if js is None:
        assert ts is None
    else:
        assert [(f.name, f.dtype.name) for f in ts] == \
            [(f.name, f.dtype.name) for f in js]


@pytest.mark.parametrize("raw", ["we%2Fst", "a%3Db", "100%", "%zz", "%4", ""])
def test_unescape_matches_jax(raw):
    assert thive._hive_unescape(raw) == jhive._hive_unescape(raw)


def _fact(rng, n=3000):
    return pa.table({
        "k": pa.array(rng.integers(0, 4, n), pa.int64()),
        "r": pa.array(np.array(["east", "we/st", "north"],
                               dtype=object)[rng.integers(0, 3, n)]),
        "v": pa.array(np.round(rng.normal(size=n), 3)),
        "i": pa.array(rng.integers(-50, 50, n), pa.int64())})


FILTERS = {
    "eq_int": lambda F: F.col("k") == 1,
    "lt_int": lambda F: F.col("k") < 2,
    "ge_and_str": lambda F: (F.col("k") >= 1) & (F.col("r") == "we/st"),
    "not_partition": lambda F: F.col("v") > 0.5,
    "flipped": lambda F: F.lit(2) <= F.col("k"),
}


def _jax_files_read(df, conf):
    result = jplan(df.plan, conf)
    scan = result.physical
    while scan.children:
        scan = scan.children[0]
    list(result.physical.execute_host(ExecContext(conf)))
    return (scan.metrics["numFilesRead"].value,
            scan.metrics["numFilesTotal"].value)


def _port_files_read(session):
    scan = session._last_plan
    while scan.children:
        scan = scan.children[0]
    return (int(scan.metrics["numFilesRead"]),
            int(scan.metrics["numFilesTotal"]))


@pytest.mark.parametrize("flt", sorted(FILTERS))
def test_pruned_parquet_reads_the_files_jax_reads(tmp_path, flt):
    t = _fact(np.random.default_rng(3))
    js = tpu_session()
    out = str(tmp_path / "pq")
    js.create_dataframe(t).write.partition_by("k", "r").parquet(out)
    jdf = js.read.parquet(out).filter(FILTERS[flt](JF))
    want = jdf.to_arrow()
    s = st.TorchSession(CPU)
    tdf = s.read.parquet(out).filter(FILTERS[flt](TF))
    got = tdf.to_arrow()
    assert got.schema == want.schema
    assert_tables_equal(got, want)
    assert _port_files_read(s) == _jax_files_read(jdf, js.conf)
    if flt != "not_partition":
        assert _port_files_read(s)[0] < _port_files_read(s)[1]


@pytest.mark.parametrize("flt", sorted(FILTERS))
def test_pruned_csv_matches_jax(tmp_path, flt):
    t = _fact(np.random.default_rng(4))
    s = st.TorchSession(CPU)
    out = str(tmp_path / "csv")
    s.create_dataframe(t).write.partition_by("k", "r").csv(out)
    js = tpu_session()
    want = js.read.csv(out).filter(FILTERS[flt](JF)).to_arrow()
    got = s.read.csv(out).filter(FILTERS[flt](TF)).to_arrow()
    assert got.schema == want.schema
    assert got.column_names[-2:] == ["k", "r"]
    assert_tables_equal(got, want)
    read, total = _port_files_read(s)
    assert total == len(set(zip(t.column("k").to_pylist(),
                                t.column("r").to_pylist())))
    # the files the JAX package's parquet scan would open for the filter
    pq_out = str(tmp_path / "pq")
    js.create_dataframe(t).write.partition_by("k", "r").parquet(pq_out)
    jdf = js.read.parquet(pq_out).filter(FILTERS[flt](JF))
    assert (read, total) == _jax_files_read(jdf, js.conf)


def test_pushdown_off_reads_every_file(tmp_path):
    t = _fact(np.random.default_rng(5))
    s = st.TorchSession({**CPU, "spark.rapids.sql.format.parquet."
                         "filterPushdown.enabled": "false"})
    out = str(tmp_path / "csv")
    s.create_dataframe(t).write.partition_by("k").csv(out)
    got = s.read.csv(out).filter(TF.col("k") == 2).to_arrow()
    assert set(got.column("k").to_pylist()) == {2}
    assert _port_files_read(s) == (4, 4)


def test_schema_puts_partition_columns_last(tmp_path):
    root = str(tmp_path / "s")
    for k in (1, 2):
        d = os.path.join(root, f"k={k}")
        os.makedirs(d)
        pq.write_table(pa.table({"k": [9], "v": [1.0]}),
                       os.path.join(d, "f.parquet"))
        with open(os.path.join(d, "f.csv"), "w") as f:
            f.write("k,v\n9,1.0\n")
    from spark_rapids_tpu.io.csv import read_csv_schema as jcsv
    from spark_rapids_tpu.io.parquet import read_schema as jpq
    from spark_rapids_tpu_torch.io.csv import read_csv_schema as tcsv
    from spark_rapids_tpu_torch.io.parquet import read_schema as tpq
    for j, t in ((jcsv, tcsv), (jpq, tpq)):
        assert [(f.name, f.dtype.name) for f in t(root)] == \
            [(f.name, f.dtype.name) for f in j(root)] == \
            [("v", "double"), ("k", "long")]
