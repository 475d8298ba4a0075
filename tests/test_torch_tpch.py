"""The torch port's TPC-H slice against the JAX package.

``gen_tpch_numpy`` against ``gen_tpch``'s parquet, column for column; the
bench's six TPC-H queries (q1, q3, q5, q6, q10, q18) at 4,000 lineitem
rows through both packages' sessions from the same parquet files (and
through the port from the numpy tables); ``hash_join_1m``'s query at
20,000 fact rows; the join strategy each package picks; a limit with no
sort; and global aggregation, empty input included.  Tolerance: exact, except f64 sums
and averages after joins and aggregates (relative 1e-9,
``approx_float``), since the two packages add in different orders.
"""

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from spark_rapids_tpu import functions as F
from spark_rapids_tpu.api import col
from spark_rapids_tpu.bench.tpch import TPCH_QUERIES as JAX_QUERIES
from spark_rapids_tpu.bench.tpch import gen_tpch
from spark_rapids_tpu.bench.tpch import load_tables as jload
from tests.compare import assert_tables_equal, tpu_session

import spark_rapids_tpu_torch as st
from spark_rapids_tpu_torch import functions as TF
from spark_rapids_tpu_torch.bench.tpch import BENCH_QUERIES, TPCH_QUERIES, \
    gen_tpch_numpy
from spark_rapids_tpu_torch.bench.tpch import load_tables as tload
from tests.torch_threads import _one_torch_thread  # noqa: F401

LINEITEM = 4000


def _torch_session(extra=None):
    return st.TorchSession({"spark.rapids.torch.device": "cpu",
                            **(extra or {})})


def _find(plan, name):
    if type(plan).__name__ == name:
        return plan
    for c in plan.children:
        r = _find(c, name)
        if r is not None:
            return r
    return None


@pytest.fixture(scope="module")
def tpch(tmp_path_factory):
    """(parquet paths, numpy tables) of the same corpus."""
    paths = gen_tpch(str(tmp_path_factory.mktemp("tpch")),
                     lineitem_rows=LINEITEM)
    return paths, gen_tpch_numpy(LINEITEM)


def test_gen_tpch_numpy_equals_gen_tpch(tpch):
    paths, tables = tpch
    assert list(tables) == list(paths)
    for name, path in paths.items():
        want = pq.read_table(path)
        got = tables[name]
        assert list(got) == want.column_names, name
        for c in want.column_names:
            w = want.column(c).to_numpy(zero_copy_only=False)
            if pa.types.is_string(want.schema.field(c).type):
                assert got[c].dtype.kind == "U"
                assert got[c].tolist() == w.tolist(), (name, c)
            else:
                assert got[c].dtype == w.dtype, (name, c)
                np.testing.assert_array_equal(got[c], w, err_msg=c)


@pytest.mark.parametrize("qname", BENCH_QUERIES)
def test_tpch_query_matches_jax(tpch, qname):
    paths, tables = tpch
    want = JAX_QUERIES[qname](jload(tpu_session(), paths)).to_arrow()
    assert want.num_rows > 0
    got = TPCH_QUERIES[qname](tload(_torch_session(), paths)).to_arrow()
    assert_tables_equal(got, want, ignore_order=False, approx_float=True)
    from_numpy = TPCH_QUERIES[qname](tload(_torch_session(),
                                           tables)).to_arrow()
    assert_tables_equal(from_numpy, want, ignore_order=False,
                        approx_float=True)


def _hash_join_1m(c, fns, s, fact, dim):
    """bench.py:q_hash_join."""
    return (s.read.parquet(fact).join(s.read.parquet(dim), on="k",
                                      how="inner")
            .group_by(c("grp")).agg(fns.sum(c("v")).alias("s")))


@pytest.fixture(scope="module")
def hash_join_files(tmp_path_factory):
    """bench.py:gen_data's fact columns at 20,000 rows and its
    10,000-row dimension."""
    d = tmp_path_factory.mktemp("hash_join")
    rng = np.random.default_rng(7)
    n = 20_000
    fact, dim = str(d / "fact.parquet"), str(d / "dim.parquet")
    pq.write_table(pa.table({
        "k": pa.array(rng.integers(0, 1000, n), pa.int64()),
        "v": pa.array(rng.normal(size=n)),
        "w": pa.array(rng.normal(size=n).astype(np.float32))}), fact,
        row_group_size=4096)
    pq.write_table(pa.table({
        "k": pa.array(np.arange(10_000, dtype=np.int64)),
        "grp": pa.array(rng.integers(0, 50, 10_000), pa.int64())}), dim)
    return fact, dim


def test_hash_join_1m_matches_jax(hash_join_files):
    """The dense FK route into an update on the dense-slot kernel's plain
    version."""
    conf = {"spark.rapids.sql.reader.batchSizeRows": "4096",
            "spark.rapids.sql.batchSizeRows": "8192"}
    want = _hash_join_1m(col, F, tpu_session(conf),
                         *hash_join_files).to_arrow()
    ts = _torch_session(conf)
    got = _hash_join_1m(st.col, TF, ts, *hash_join_files).to_arrow()
    assert want.num_rows == 50
    assert_tables_equal(got, want, ignore_order=True, approx_float=True)
    join = _find(ts._last_plan, "TorchBroadcastHashJoinExec")
    assert join.route == "dense_fk"
    # 20,000 rows coalesce into stream batches of 8,192
    assert join.metrics["fkFastPathBatches"] == 3
    agg = _find(ts._last_plan, "TorchHashAggregateExec")
    assert agg.metrics["pallasAggBatches"] == 3  # 20,000 rows in 8,192s


def _jax_joins(plan):
    """[(exec, join type, build side's fields, took the FK route)]."""
    out = []
    if type(plan).__name__ in ("TpuHashJoinExec", "TpuBroadcastHashJoinExec"):
        out.append((type(plan).__name__[3:], plan.join_type,
                    plan.children[1].output_schema.names,
                    plan.metrics["fkFastPathBatches"].value > 0))
    for c in plan.children:
        out += _jax_joins(c)
    return out


def _torch_joins(plan):
    out = []
    if type(plan).__name__ in ("TorchHashJoinExec",
                               "TorchBroadcastHashJoinExec"):
        out.append((type(plan).__name__[5:], plan.join_type,
                    plan.children[1].output_schema.names,
                    plan.metrics["fkFastPathBatches"] > 0))
    for c in plan.children:
        out += _torch_joins(c)
    return out


@pytest.mark.parametrize("threshold", [None, 10_000, -1])
def test_join_strategy_matches_jax(tpch, hash_join_files, threshold):
    """Broadcast side, swap and FK route on hash_join_1m's shape and on
    q3's two joins: at the default threshold every side qualifies (the
    smaller is broadcast, q3's customers swapped in as the build); at
    10,000 bytes only the customers do (the files' sizes count, 5.7 KB
    against 14 KB of orders and 66 KB of dimension); at -1 nothing is
    broadcast."""
    conf = {} if threshold is None else \
        {"spark.sql.autoBroadcastJoinThreshold": str(threshold)}
    js, ts = tpu_session(conf), _torch_session(conf)
    _hash_join_1m(col, F, js, *hash_join_files).to_arrow()
    _hash_join_1m(st.col, TF, ts, *hash_join_files).to_arrow()
    want = _jax_joins(js._last_plan_result.physical)
    assert _torch_joins(ts._last_plan) == want
    kind = "BroadcastHashJoinExec" if threshold is None else "HashJoinExec"
    assert want == [(kind, "inner", ["k", "grp"], True)]

    paths, _ = tpch
    JAX_QUERIES["q3"](jload(js, paths)).to_arrow()
    TPCH_QUERIES["q3"](tload(ts, paths)).to_arrow()
    want = _jax_joins(js._last_plan_result.physical)
    assert _torch_joins(ts._last_plan) == want
    assert len(want) == 2


@pytest.mark.parametrize("n", [0, 700, 1500, 5000])
def test_limit_matches_jax(hash_join_files, n):
    """A limit with no sort under it passes the first rows of the child
    on in its order, across reader batches of 1,024 rows."""
    conf = {"spark.rapids.sql.reader.batchSizeRows": "1024"}

    def build(c, s):
        return s.read.parquet(hash_join_files[0]) \
            .filter(c("k") < 500).limit(n)
    want = build(col, tpu_session(conf)).to_arrow()
    got = build(st.col, _torch_session(conf)).to_arrow()
    assert want.num_rows == n
    assert_tables_equal(got, want, ignore_order=False)


@pytest.mark.parametrize("keep", ["all", "none"])
def test_global_aggregation_matches_jax(keep):
    """Over several update batches (a merge), and over empty input, where
    one row of initial values comes out: count 0, the rest null."""
    rng = np.random.default_rng(6)
    n = 3000
    t = pa.table({"v": pa.array(rng.normal(size=n),
                                mask=rng.random(n) < 0.1),
                  "i": pa.array(rng.integers(-50, 50, n).astype(np.int32)),
                  "k": pa.array(rng.integers(0, 9, n))})
    conf = {"spark.rapids.sql.batchSizeRows": "1024"}

    def build(c, fns, s):
        df = s.create_dataframe(t)
        if keep == "none":
            df = df.filter(c("k") > 100)
        return df.agg(fns.sum(c("v")).alias("s"),
                      fns.count(c("v")).alias("n"),
                      fns.min(c("i")).alias("lo"),
                      fns.max(c("v")).alias("hi"),
                      fns.avg(c("i")).alias("mean"),
                      fns.sum(c("i")).alias("si"))

    want = build(col, F, tpu_session(conf)).to_arrow()
    got = build(st.col, TF, _torch_session(conf)).to_arrow()
    assert want.num_rows == 1
    assert_tables_equal(got, want, ignore_order=False, approx_float=True)
