"""ORC scans and parquet row-group pruning in the torch port against the
JAX package (tier-1: both read through pyarrow).

An ORC file of several stripes read whole and under filters: the
stripes each scan read (``numStripesRead`` of ``numStripesTotal``)
against the JAX package's, and the rows against the JAX session's; a
hive-partitioned ORC directory; and a parquet file of many row groups
under filters, the row groups read (``numRowGroupsRead``) against the
JAX package's.  The Filter stays in the plan, so a pruned scan and an
unpruned one give the same rows.
"""

import numpy as np
import pyarrow as pa
import pyarrow.orc as paorc
import pyarrow.parquet as pq
import pytest

import spark_rapids_tpu_torch as st
from spark_rapids_tpu import functions as JF
from spark_rapids_tpu.exec.base import ExecContext
from spark_rapids_tpu.plan.planner import plan_query as jplan
from spark_rapids_tpu_torch import functions as TF
from tests.compare import assert_tables_equal, tpu_session

CPU = {"spark.rapids.torch.device": "cpu"}

FILTERS = {
    "lt": lambda F: F.col("a") < 2000,
    "eq": lambda F: F.col("a") == 31337,
    "range": lambda F: (F.col("a") >= 10_000) & (F.col("a") <= 12_500),
    "gt_double": lambda F: F.col("c") > 45_000.5,
    "none": lambda F: F.col("b") > 0.0,
}


def _table(n=50_000, seed=2):
    rng = np.random.default_rng(seed)
    return pa.table({"a": pa.array(np.arange(n, dtype=np.int64)),
                     "b": pa.array(rng.normal(size=n)),
                     "c": pa.array(np.arange(n) + 0.5),
                     "s": pa.array(np.array(["x", "yy", "zzz"],
                                            dtype=object)[np.arange(n) % 3])})


def _jax_metrics(df, conf, names):
    result = jplan(df.plan, conf)
    scan = result.physical
    while scan.children:
        scan = scan.children[0]
    list(result.physical.execute_host(ExecContext(conf)))
    return tuple(scan.metrics[n].value for n in names)


def _port_metrics(session, names):
    scan = session._last_plan
    while scan.children:
        scan = scan.children[0]
    return tuple(int(scan.metrics[n]) for n in names)


def test_orc_reads_like_jax(tmp_path):
    t = _table(5000)
    p = str(tmp_path / "t.orc")
    paorc.write_table(t, p)
    got = st.TorchSession(CPU).read.orc(p).to_arrow()
    want = tpu_session().read.orc(p).to_arrow()
    assert got.schema == want.schema
    assert_tables_equal(got, want, ignore_order=False)


@pytest.mark.parametrize("flt", sorted(FILTERS))
def test_orc_stripe_pruning_matches_jax(tmp_path, flt):
    p = str(tmp_path / "s.orc")
    paorc.write_table(_table(), p, stripe_size=8 * 1024)
    names = ("numStripesRead", "numStripesTotal")
    js = tpu_session()
    jdf = js.read.orc(p).filter(FILTERS[flt](JF))
    want = jdf.to_arrow()
    s = st.TorchSession(CPU)
    got = s.read.orc(p).filter(FILTERS[flt](TF)).to_arrow()
    assert_tables_equal(got, want)
    read, total = _port_metrics(s, names)
    assert (read, total) == _jax_metrics(jdf, js.conf, names)
    assert total > 1
    if flt != "none":
        assert read < total


def test_partitioned_orc_matches_jax(tmp_path):
    t = _table(3000)
    t = t.append_column("g", pa.array(np.arange(3000) % 4, pa.int64()))
    out = str(tmp_path / "o")
    tpu_session().create_dataframe(t).write.partition_by("g").orc(out)
    want = tpu_session().read.orc(out).filter(JF.col("g") == 3).to_arrow()
    s = st.TorchSession(CPU)
    got = s.read.orc(out).filter(TF.col("g") == 3).to_arrow()
    assert got.schema == want.schema
    assert_tables_equal(got, want)
    assert _port_metrics(s, ("numFilesRead", "numFilesTotal")) == (1, 4)


@pytest.mark.parametrize("flt", sorted(FILTERS))
def test_parquet_row_group_pruning_matches_jax(tmp_path, flt):
    p = str(tmp_path / "r.parquet")
    pq.write_table(_table(), p, row_group_size=2500)
    names = ("numRowGroupsRead", "numRowGroupsTotal")
    js = tpu_session()
    jdf = js.read.parquet(p).filter(FILTERS[flt](JF))
    want = jdf.to_arrow()
    s = st.TorchSession(CPU)
    got = s.read.parquet(p).filter(FILTERS[flt](TF)).to_arrow()
    assert_tables_equal(got, want)
    read, total = _port_metrics(s, names)
    assert (read, total) == _jax_metrics(jdf, js.conf, names)
    assert total == 20
    if flt != "none":
        assert read < total


def test_pushdown_off_reads_every_row_group(tmp_path):
    p = str(tmp_path / "r.parquet")
    pq.write_table(_table(), p, row_group_size=2500)
    s = st.TorchSession({**CPU, "spark.rapids.sql.format.parquet."
                         "filterPushdown.enabled": "false"})
    got = s.read.parquet(p).filter(TF.col("a") < 2000).to_arrow()
    assert got.num_rows == 2000
    assert _port_metrics(s, ("numRowGroupsRead", "numRowGroupsTotal")) == \
        (20, 20)
