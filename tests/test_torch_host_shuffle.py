"""The port's host shuffle against the JAX package's
(``spark_rapids_tpu_torch/shuffle/stage.py``, ``worker.py``,
``plan/planner.py: host_shuffle_lower``, ``plan/adaptive.py``).

Analog of ``tests/test_host_shuffle.py``, the host-shuffle cases of
``tests/test_adaptive.py`` and the end-to-end cases of
``tests/test_faults.py``:

* planner: with ``spark.rapids.shuffle.workers.count`` 2 the port's plans
  put their host exchanges where the JAX planner does (the trees equal
  after the names are mapped: ``Tpu`` -> ``Torch``, the JAX root's
  ``DeviceToHost`` and its coalesce's target size dropped), over a
  group-by, a shuffled join, a broadcast join, a global aggregate and a
  single-file scan (not split); the AQE deferral; the default partition
  count and its conf; the stripes ``_restrict_to_split`` makes, hive
  values included;
* the stats-driven reduce groups equal the JAX package's on the JAX
  test's blocks;
* results (worker processes): a group-by and a join over multi-file
  parquet with 2 workers equal the JAX package's host-shuffle results
  (integers exact, float sums within ``approx_float``'s 1e-9 relative,
  the order-of-sums class of ``exec/pallas_agg.py``), and each reduce
  partition's rows equal the JAX package's exactly; a ``worker.kill`` in
  worker 1 and fetches that fail for good still give the same result,
  through the recompute paths; with adaptive execution on, the reduce
  uploads coalesce and the result stays;
* ``distributed_groupby`` equals the JAX package's on the same file with
  one worker killed (sums within 1e-9 relative, counts exact).

The JAX references run once a module.  Every run sets
``spark.rapids.shuffle.stage.timeout`` to 60 s, so a hang fails.
"""

import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from spark_rapids_tpu import faults as jfaults
from spark_rapids_tpu import functions as F
from spark_rapids_tpu.api import col
from spark_rapids_tpu.plan.planner import plan_query as jplan_query
from tests.compare import assert_tables_equal, tpu_session

import spark_rapids_tpu_torch as st
from spark_rapids_tpu_torch import faults
from spark_rapids_tpu_torch import functions as TF
from spark_rapids_tpu_torch.plan.planner import plan_query
from spark_rapids_tpu_torch.shuffle import manager as tmanager
from spark_rapids_tpu_torch.shuffle import stage as tstage
from spark_rapids_tpu_torch.shuffle import transport as ttransport
from tests.torch_threads import _one_torch_thread  # noqa: F401

WORKERS = {"spark.rapids.shuffle.workers.count": "2",
           "spark.rapids.shuffle.stage.timeout": "60"}
SHUFFLED_JOIN = {**WORKERS, "spark.sql.autoBroadcastJoinThreshold": "-1"}
AQE_ON = {"spark.rapids.sql.adaptive.enabled": "true"}
FAULT_TIMING = {
    "spark.rapids.faults.seed": "0",
    "spark.rapids.shuffle.timeout.connect": "2.0",
    "spark.rapids.shuffle.timeout.read": "5.0",
    "spark.rapids.shuffle.retry.backoff.base": "0.01",
    "spark.rapids.shuffle.retry.backoff.cap": "0.05",
    "spark.rapids.shuffle.worker.heartbeat.interval": "0.1",
    "spark.rapids.shuffle.worker.heartbeat.timeout": "3.0",
}


@pytest.fixture(autouse=True)
def _no_faults():
    faults.reset()
    jfaults.reset()
    yield
    faults.reset()
    jfaults.reset()


def _tsession(extra=None):
    return st.TorchSession({"spark.rapids.torch.device": "cpu",
                            **(extra or {})})


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    """A fact table over 4 parquet files and a dim table over 2 (the JAX
    test's layout), and a hive-partitioned copy of the fact table."""
    d = tmp_path_factory.mktemp("torch_host_shuffle")
    rng = np.random.default_rng(11)
    fact_dir, dim_dir, hive_dir = d / "fact", d / "dim", d / "hive"
    for p in (fact_dir, dim_dir, hive_dir):
        p.mkdir()
    for i in range(4):
        n = 800
        t = pa.table({"k": pa.array(rng.integers(0, 40, n), pa.int64()),
                      "v": pa.array(rng.normal(size=n))})
        pq.write_table(t, str(fact_dir / f"part-{i}.parquet"))
        (hive_dir / f"g={i % 2}").mkdir(exist_ok=True)
        pq.write_table(t, str(hive_dir / f"g={i % 2}" / f"p{i}.parquet"))
    keys = np.arange(40, dtype=np.int64)
    for i in range(2):
        sel = keys[i::2]
        pq.write_table(pa.table({"k": pa.array(sel),
                                 "grp": pa.array(sel % 5)}),
                       str(dim_dir / f"part-{i}.parquet"))
    return str(fact_dir), str(dim_dir), str(hive_dir)


def _groupby(s, fns, c, fact):
    return (s.read.parquet(fact).group_by(c("k"))
            .agg(fns.sum(c("v")).alias("sv"), fns.count(c("v")).alias("c"))
            .order_by(c("k")))


def _join(s, fns, c, fact, dim):
    return (s.read.parquet(fact).join(s.read.parquet(dim), on="k",
                                      how="inner")
            .group_by(c("grp"))
            .agg(fns.sum(c("v")).alias("sv"), fns.count(c("k")).alias("c"))
            .order_by(c("grp")))


# -- planner --------------------------------------------------------------------

def _normalize(tree: str) -> str:
    import re
    lines = [ln for ln in tree.splitlines() if ln.strip() != "DeviceToHost"]
    pad = min(len(ln) - len(ln.lstrip()) for ln in lines)
    out = "\n".join(ln[pad:] for ln in lines).replace("Tpu", "Torch")
    return re.sub(r" \[TargetSize\(\d+\)\]", "", out)


def _trees(build, conf):
    js = tpu_session(conf)
    ts = _tsession(conf)
    jtree = jplan_query(build(js, F, col).plan, js.conf).physical \
        .tree_string()
    ttree = plan_query(build(ts, TF, st.col).plan, ts.conf).tree_string()
    return _normalize(jtree), ttree


def test_exchanges_go_where_the_jax_planner_puts_them(tables, tmp_path):
    fact, dim, _ = tables
    one = str(tmp_path / "one.parquet")
    pq.write_table(pa.table({"k": pa.array([1, 2, 1], pa.int64()),
                             "v": pa.array([1.0, 2.0, 3.0])}), one)
    cases = [
        (lambda s, f, c: _groupby(s, f, c, fact), WORKERS, 1),
        (lambda s, f, c: (s.read.parquet(fact).filter(c("v") > 0)
                          .select(c("k"), (c("v") * 2).alias("w"))
                          .group_by(c("k")).agg(f.max(c("w")).alias("m"))),
         WORKERS, 1),
        (lambda s, f, c: _join(s, f, c, fact, dim), SHUFFLED_JOIN, 2),
        # a broadcast join's build side is never split
        (lambda s, f, c: _join(s, f, c, fact, dim), WORKERS, 0),
        # a global aggregate has no keys to shuffle by
        (lambda s, f, c: s.read.parquet(fact).agg(f.sum(c("v"))),
         WORKERS, 0),
        # a single file has no map split
        (lambda s, f, c: _groupby(s, f, c, one), WORKERS, 0),
    ]
    for build, conf, n in cases:
        jtree, ttree = _trees(build, conf)
        assert ttree == jtree, (ttree, jtree)
        assert ttree.count("TorchHostShuffleExchange") == n, ttree


def test_adaptive_join_planning_defers_to_the_workers(tables):
    fact, dim, _ = tables
    conf = {**SHUFFLED_JOIN, **AQE_ON}
    jtree, ttree = _trees(
        lambda s, f, c: s.read.parquet(fact).join(s.read.parquet(fact),
                                                  on="k"), conf)
    assert ttree == jtree
    assert ttree.count("TorchHostShuffleExchange") == 2, ttree
    assert "TorchShuffleExchange " not in ttree
    assert "TorchAdaptive" not in ttree  # nothing left for a stage


def test_default_partitions_and_their_conf(tables):
    from spark_rapids_tpu.exprs.base import UnresolvedAttribute
    from spark_rapids_tpu.shuffle.stage import TpuHostShuffleExchangeExec

    class _Stub:
        children = []
    for nparts, want in ((None, 6), (10, 10)):
        assert tstage.TorchHostShuffleExchangeExec(
            [], _Stub(), 3, num_partitions=nparts).num_partitions == want
        assert TpuHostShuffleExchangeExec(
            [UnresolvedAttribute("k")], _Stub(), 3,
            num_partitions=nparts).num_partitions == want
    fact = tables[0]
    jtree, ttree = _trees(
        lambda s, f, c: s.read.parquet(fact).group_by("k").agg(),
        {**WORKERS, "spark.rapids.shuffle.defaultNumPartitions": 5})
    assert ttree == jtree and "parts=5" in ttree


def test_stripes_equal_the_jax_stripes(tables):
    """``_restrict_to_split`` gives each worker the JAX package's files,
    with the hive values discovered again over its stripe."""
    from spark_rapids_tpu.shuffle.stage import \
        _restrict_to_split as jrestrict
    _, _, hive = tables
    js, ts = tpu_session(WORKERS), _tsession(WORKERS)
    jscan = jplan_query(js.read.parquet(hive).plan, js.conf).physical
    tscan = plan_query(ts.read.parquet(hive).plan, ts.conf)
    while not hasattr(jscan, "paths"):
        jscan = jscan.children[0]
    assert tstage.splittable(tscan)
    for idx in range(3):
        a, b = jrestrict(jscan, idx, 3), tstage._restrict_to_split(
            tscan, idx, 3)
        assert b.paths == a.paths
        assert b.part_schema.names == a.part_schema.names
        assert [list(v) for v in b.part_values] == \
            [list(v) for v in a.part_values]
    assert len(tscan.paths) == 4  # the plan itself is untouched


def test_reduce_groups_equal_the_jax_groups():
    """The JAX test's blocks: 0 and 1 merge under the advisory size,
    skewed partition 2 splits toward it, 3 stands alone."""
    from spark_rapids_tpu.conf import TpuConf
    from spark_rapids_tpu.shuffle.stage import \
        _reduce_upload_groups as jgroups
    from spark_rapids_tpu_torch.columnar.batch import \
        host_columns_from_numpy
    from spark_rapids_tpu_torch.conf import TorchConf
    from spark_rapids_tpu_torch.shuffle.serializer import HostBlock

    def rb(n):
        return pa.record_batch({"x": pa.array(np.zeros(n, np.int64))})

    def hb(n):
        return HostBlock(*host_columns_from_numpy(
            {"x": np.zeros(n, np.int64)}), n)

    settings = {
        "spark.rapids.sql.adaptive.advisoryPartitionSizeInBytes": "20000",
        "spark.rapids.sql.adaptive.skewJoin."
        "skewedPartitionThresholdInBytes": "1000",
        "spark.rapids.sql.adaptive.skewJoin.skewedPartitionFactor": "3",
    }
    sizes = {0: [10], 1: [10], 2: [1000] * 6, 3: [10]}
    for stats in (None, [80, 80, 48000, 80]):
        jg, jc, js_ = jgroups({p: [rb(n) for n in ns]
                               for p, ns in sizes.items()}, [0, 1, 2, 3],
                              TpuConf(dict(settings)), stats)
        tg, tc, ts_ = tstage._reduce_upload_groups(
            {p: [hb(n) for n in ns] for p, ns in sizes.items()},
            [0, 1, 2, 3], TorchConf(settings), stats)
        assert (tc, ts_) == (jc, js_) and jc == 1 and js_ >= 1
        assert [[b.num_rows for b in g] for g in tg] == \
            [[r.num_rows for r in g] for g in jg]


# -- results across worker processes ----------------------------------------------

def _capture(cls, sink):
    """Wrap ``cls.read_partitions`` to record each fetched partition's
    rows, keyed by (column names, partition)."""
    orig = cls.read_partitions

    def read_partitions(self, shuffle, parts):
        out = orig(self, shuffle, parts)
        for p, blocks in out.items():
            for b in blocks:
                if isinstance(b, pa.RecordBatch):
                    names = tuple(b.schema.names)
                    rows = list(zip(*[b.column(n).to_pylist()
                                      for n in names]))
                else:
                    names = tuple(b.schema.names)
                    rows = list(zip(*[b.cols[n][0].tolist()
                                      for n in names]))
                sink.setdefault((names, p), []).extend(rows)
        return out
    return orig, read_partitions


def _run_captured(cls, run):
    sink = {}
    orig, wrapped = _capture(cls, sink)
    cls.read_partitions = wrapped
    try:
        return run(), {k: sorted(v) for k, v in sink.items()}
    finally:
        cls.read_partitions = orig


# The JAX map side hashes a delta-encoded key's narrowed plane, not its
# values (ROADMAP.md §C, a gap of the reference found here): its
# partitions are the in-process exchange's only with the delta encoding
# off.  The port hashes values under every encoding.
JAX_BY_VALUE = {"spark.rapids.sql.compressed.delta.enabled": "false"}


@pytest.fixture(scope="module")
def jax_results(tables):
    """The JAX package's host-shuffle group-by and join, each reduce
    partition's rows with them."""
    from spark_rapids_tpu.shuffle.manager import TpuShuffleManager
    fact, dim, _ = tables
    out = {}
    for name, conf, build in (
            ("groupby", WORKERS, lambda s: _groupby(s, F, col, fact)),
            ("join", SHUFFLED_JOIN,
             lambda s: _join(s, F, col, fact, dim))):
        out[name] = _run_captured(
            TpuShuffleManager,
            lambda: build(tpu_session({**conf, **JAX_BY_VALUE})).to_arrow())
    return out


def _port_run(build, conf):
    s = _tsession(conf)
    table, parts = _run_captured(tmanager.TorchShuffleManager,
                                 lambda: build(s).to_arrow())
    return s, table, parts


def _exchanges(s):
    found = []

    def walk(n):
        if isinstance(n, tstage.TorchHostShuffleExchangeExec):
            found.append(n)
        for c in n.children:
            walk(c)
    walk(s._last_plan)
    return found


def _check_run(s, n_exchanges):
    exs = _exchanges(s)
    assert len(exs) == n_exchanges
    for ex in exs:
        run = ex.last_run
        assert len(run["workers"]) == 2
        for info in run["workers"].values():
            assert info["cuda_initialized"] is False
            assert not tstage.holds_card(info)
            assert info["pid"] != os.getpid()
            assert info["threads"] == tstage.worker_threads(2)
        assert run["native"] == ttransport.native_available()
    return exs


def test_groupby_equals_jax_partition_for_partition(tables, jax_results):
    fact = tables[0]
    jtable, jparts = jax_results["groupby"]
    s, table, parts = _port_run(lambda s: _groupby(s, TF, st.col, fact),
                                WORKERS)
    assert_tables_equal(table, jtable, ignore_order=False,
                        approx_float=True)
    assert parts == jparts and len(parts) == 4
    ex, = _check_run(s, 1)
    m = ex.metrics
    assert m["shuffleRowsWritten"] == 3200
    assert m["shuffleBlocksFetched"] > 0 and m["shuffleWireBytes"] > 0
    assert m["shufflePartitionBytes"] == m["shuffleRawBytes"] > 0
    assert m["shuffleMapRecomputes"] == 0


def test_join_equals_jax_partition_for_partition(tables, jax_results):
    fact, dim, _ = tables
    jtable, jparts = jax_results["join"]
    s, table, parts = _port_run(
        lambda s: _join(s, TF, st.col, fact, dim), SHUFFLED_JOIN)
    assert_tables_equal(table, jtable, ignore_order=False,
                        approx_float=True)
    assert parts == jparts and len(parts) == 8  # 4 partitions a side
    _check_run(s, 2)


def test_worker_kill_recomputes_the_map_stage(tables, jax_results):
    fact = tables[0]
    jtable, _ = jax_results["groupby"]
    conf = {**WORKERS, **FAULT_TIMING,
            "spark.rapids.faults.worker.kill": "count:1@w1",
            "spark.rapids.shuffle.fetch.retries": "1"}
    s, table, _ = _port_run(lambda s: _groupby(s, TF, st.col, fact), conf)
    assert_tables_equal(table, jtable, ignore_order=False,
                        approx_float=True)
    ex, = _exchanges(s)
    assert ex.metrics["shuffleMapRecomputes"] == 1


def test_failed_fetches_recompute_their_partitions(tables, jax_results):
    fact = tables[0]
    jtable, _ = jax_results["groupby"]
    conf = {**WORKERS, **FAULT_TIMING,
            "spark.rapids.faults.transport.fetch": "count:1+",
            "spark.rapids.shuffle.fetch.retries": "0",
            "spark.rapids.shuffle.peer.maxFailures": "1"}
    s, table, _ = _port_run(lambda s: _groupby(s, TF, st.col, fact), conf)
    assert_tables_equal(table, jtable, ignore_order=False,
                        approx_float=True)
    ex, = _exchanges(s)
    assert ex.metrics["shufflePartitionsRecomputed"] == 4
    assert ex.metrics["shuffleMapRecomputes"] == 0


def test_adaptive_reduce_groups_coalesce_and_keep_the_result(tables,
                                                             jax_results):
    fact = tables[0]
    jtable, _ = jax_results["groupby"]
    conf = {**WORKERS, **AQE_ON,
            "spark.rapids.sql.adaptive.skewJoin.enabled": "false"}
    s, table, _ = _port_run(lambda s: _groupby(s, TF, st.col, fact), conf)
    assert_tables_equal(table, jtable, ignore_order=False,
                        approx_float=True)
    ex, = _exchanges(s)
    assert ex.metrics["coalescedPartitions"] > 0
    assert ex.metrics["numOutputBatches"] < ex.metrics["shuffleBlocksFetched"]


def test_distributed_groupby_equals_jax_with_a_worker_killed(tmp_path):
    from spark_rapids_tpu.shuffle.worker import \
        distributed_groupby as jgroupby
    from spark_rapids_tpu_torch.shuffle.worker import distributed_groupby
    rng = np.random.default_rng(21)
    n = 20_000
    t = pa.table({"k": pa.array(rng.integers(0, 50, n).astype(np.int64)),
                  "v": pa.array(rng.normal(size=n))})
    path = str(tmp_path / "t.parquet")
    pq.write_table(t, path, row_group_size=2048)
    conf = {**FAULT_TIMING,
            "spark.rapids.faults.worker.kill": "count:2@w1",
            "spark.rapids.faults.serializer.deserialize": "count:1",
            "spark.rapids.shuffle.checksum": "crc32c"}
    rows, stats = distributed_groupby(path, "k", "v", n_workers=3,
                                      conf=conf, return_stats=True)
    jrows, jstats = jgroupby(path, "k", "v", n_workers=3, conf=conf,
                             return_stats=True)
    got = {r["k"]: (r["v_sum"], r["v_count"]) for r in rows}
    exp = {r["k"]: (r["v_sum"], r["v_count"]) for r in jrows}
    assert set(got) == set(exp) and len(got) == 50
    for k in exp:
        assert got[k][1] == exp[k][1]
        assert got[k][0] == pytest.approx(exp[k][0], rel=1e-9)
    for key in ("workers_lost", "rounds"):
        assert stats[key] == jstats[key], key
    assert stats["workers_lost"] == 1 and stats["corrupt_refetches"] >= 1


@pytest.mark.parametrize("mode", ["hash", "roundrobin"])
def test_partition_egress_equals_jax(mode):
    """The map egress (``partition_batch_to_host``) puts each row in the
    JAX package's partition, in its order, over an int64 and a string
    key with nulls, exactly; every live row lands in one block."""
    from spark_rapids_tpu.columnar.batch import \
        host_batch_to_device as jupload
    from spark_rapids_tpu.columnar.dtypes import Schema as JSchema
    from spark_rapids_tpu.exec.exchange import \
        partition_batch_to_host as jegress
    from spark_rapids_tpu.exprs.base import BoundReference as JRef
    from spark_rapids_tpu.columnar.dtypes import INT64 as JINT64, \
        STRING as JSTRING
    import torch
    from spark_rapids_tpu_torch.columnar.batch import \
        host_batch_to_device, host_columns_from_arrow
    from spark_rapids_tpu_torch.columnar.dtypes import INT64, STRING
    from spark_rapids_tpu_torch.exec.exchange import partition_batch_to_host
    from spark_rapids_tpu_torch.exprs.base import BoundReference
    rng = np.random.default_rng(4)
    n = 3000
    k = rng.integers(-50, 50, n)
    s = [None if i % 17 == 0 else f"key{i % 23}" for i in range(n)]
    rb = pa.record_batch({"k": pa.array(k, mask=rng.random(n) < 0.05),
                          "s": pa.array(s),
                          "v": pa.array(rng.normal(size=n))})
    jkeys = [JRef(0, JINT64, True, "k"), JRef(1, JSTRING, True, "s")]
    tkeys = [BoundReference(0, INT64, True, "k"),
             BoundReference(1, STRING, True, "s")]
    want = jegress(jupload(rb, JSchema.from_arrow(rb.schema)), 7, jkeys,
                   mode, rr_start=5)
    schema, cols = host_columns_from_arrow(rb)
    batch = host_batch_to_device(schema, cols, torch.device("cpu"))
    got = partition_batch_to_host(batch, 7, tkeys, mode, rr_start=5)
    assert len(got) == len(want) == 7
    assert sum(g.num_rows for g in got if g is not None) == n
    for w, g in zip(want, got):
        assert (w is None) == (g is None)
        if w is None:
            continue
        rows = list(zip(*[w.column(c).to_pylist() for c in "ksv"]))
        vals = [g.cols[c][0] for c in "ksv"]
        valid = [g.cols[c][1] for c in "ksv"]
        vals[1] = vals[1].to_pylist()
        mine = [tuple(None if not valid[j][i] else
                      (vals[j][i] if j == 1 else vals[j][i].item())
                      for j in range(3)) for i in range(g.num_rows)]
        assert mine == rows


@pytest.mark.parametrize("info,held", [
    ({"cuda_initialized": False, "card_files": []}, False),
    # cuInit alone (torch.cuda.is_available()) maps these, with no context
    ({"cuda_initialized": False,
      "card_files": ["/dev/nvidia0", "/dev/nvidiactl"]}, False),
    # a context made from C++ leaves torch's flag down but maps UVM
    ({"cuda_initialized": False,
      "card_files": ["/dev/nvidia-uvm", "/dev/nvidia0"]}, True),
    ({"cuda_initialized": True, "card_files": []}, True),
    ({"cuda_initialized": False}, False),
])
def test_holds_card_reads_both_reports(info, held):
    """A worker holds the card if torch says so or if it mapped the UVM
    device file; this process, on the CPU, maps no card file."""
    assert tstage.holds_card(info) is held
    assert "/dev/nvidia-uvm" not in tstage.card_files()
