"""The port's cost model and fragment placement against the JAX
package's (``plan/cost.py``, ``plan/placement.py``).

Analog of ``tests/test_placement.py``, at the JAX test's pinned link
constants (``REMOTE_LINK``: 94 ms pulls, 45 and 4 MB/s; ``LOCAL_LINK``:
0.5 ms, 100,000 MB/s) so that no probe runs and a decision is a pure
function of the plan:

* the static decision records equal the JAX package's field for field
  on the same logical plans: a 1,000-row string-heavy parquet scan, a
  50,000-row numeric aggregate, an in-memory table (Arrow and numpy),
  and TPC-H q1 and q6 at 4,000 lineitem rows, each in both regimes;
  the port's size estimates give the JAX package's bytes;
* results under ``placement.mode=cpu`` and ``cost`` equal the JAX
  package's, and a plan placed on the host pulls nothing;
* the default mode leaves plans, metrics and the placement stats as
  they were;
* the adaptive re-score demotes the remainder above a stage on the JAX
  test's input exactly where the JAX package does, and keeps it where
  it keeps it;
* the ``plan.place`` fault degrades to the device plan, counted;
* the units: link constants from the conf, the EWMA and the bytes of
  ``calibration.json``, ``score_ops``, ``op_class`` and ``step_class``
  on the same inputs, and the placement keys' JAX defaults.

Each test runs torch with one intra-op thread and starts from fresh
calibration, statistics and fault state in both packages.
"""

import json

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from spark_rapids_tpu import functions as F
from spark_rapids_tpu.api import col
from tests.compare import assert_tables_equal, tpu_session

import spark_rapids_tpu_torch as st
from spark_rapids_tpu_torch import functions as TF
from tests.torch_threads import _one_torch_thread  # noqa: F401

REMOTE_LINK = {
    "spark.rapids.sql.placement.pullLatencyMs": "94",
    "spark.rapids.sql.placement.h2dMBps": "45",
    "spark.rapids.sql.placement.d2hMBps": "4",
}
LOCAL_LINK = {
    "spark.rapids.sql.placement.pullLatencyMs": "0.5",
    "spark.rapids.sql.placement.h2dMBps": "100000",
    "spark.rapids.sql.placement.d2hMBps": "100000",
}
LINKS = {"remote": REMOTE_LINK, "local": LOCAL_LINK}


def cost_conf(link=REMOTE_LINK, **extra):
    return {"spark.rapids.sql.placement.mode": "cost", **link, **extra}


def _reset():
    from spark_rapids_tpu import faults as jfaults
    from spark_rapids_tpu.plan import cost as jcost
    from spark_rapids_tpu.plan import placement as jplace
    from spark_rapids_tpu_torch import faults
    from spark_rapids_tpu_torch.plan import cost, placement
    for mod in (jcost, cost):
        mod.reset()
    for mod in (jplace, placement):
        mod.reset_stats()
    for mod in (jfaults, faults):
        mod.reset()


@pytest.fixture(autouse=True)
def _fresh():
    _reset()
    yield
    _reset()


def _tsession(extra=None):
    return st.TorchSession({"spark.rapids.torch.device": "cpu",
                            **(extra or {})})


def _tiny_string_table(n=1000):
    rng = np.random.default_rng(5)
    return pa.table({
        "k": pa.array(rng.integers(0, 50, n), pa.int64()),
        "s": pa.array([f"name_{i % 13}" for i in range(n)]),
        "v": pa.array(rng.normal(size=n)),
    })


def _numeric_table(n=50_000):
    rng = np.random.default_rng(6)
    return pa.table({
        "k": pa.array(rng.integers(0, 1000, n), pa.int64()),
        "v": pa.array(rng.normal(size=n)),
    })


def _mixed_table(n=3000):
    """Every size class: a string with nulls, a boolean, int32, f64."""
    rng = np.random.default_rng(8)
    strs = [None if i % 7 == 0 else "x" * (i % 11) for i in range(n)]
    return pa.table({
        "s": pa.array(strs, pa.string()),
        "b": pa.array(rng.random(n) < 0.5),
        "i": pa.array(rng.integers(0, 9, n).astype(np.int32)),
        "v": pa.array(rng.normal(size=n)),
    })


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_placement")
    out = {}
    for name, t in (("tiny", _tiny_string_table()),
                    ("numeric", _numeric_table())):
        out[name] = str(root / f"{name}.parquet")
        pq.write_table(t, out[name])
    rng = np.random.default_rng(7)
    aqe = pa.table({"k": pa.array(rng.integers(0, 100, 4000), pa.int64()),
                    "v": pa.array(rng.normal(size=4000))})
    out["aqe"] = str(root / "aqe.parquet")
    pq.write_table(aqe, out["aqe"])
    return out


@pytest.fixture(scope="module")
def tpch(tmp_path_factory):
    from spark_rapids_tpu.bench.tpch import gen_tpch
    return gen_tpch(str(tmp_path_factory.mktemp("torch_place_tpch")),
                    lineitem_rows=4000)


# the JAX test's query shapes, each given (col, functions, session, data)
def _tiny_scan(c, f, s, d):
    return s.read.parquet(d["tiny"]).filter(c("k") < 25).select(
        c("s"), (c("v") + 1.0).alias("a"))


def _numeric_agg(c, f, s, d):
    return s.read.parquet(d["numeric"]).group_by(c("k")).agg(
        f.sum(c("v")).alias("sv"))


def _string_agg(c, f, s, d):
    return (s.read.parquet(d["tiny"]).filter(c("k") < 25)
            .group_by(c("s")).agg(f.sum(c("v")).alias("sv"),
                                  f.count(c("k")).alias("c"))
            .order_by(c("s")))


def _memory_arrow(c, f, s, d):
    return s.create_dataframe(_mixed_table()).filter(c("i") > 2).select(
        c("s"), c("b"), (c("v") * 2.0).alias("w"))


def _memory_numpy(c, f, s, d):
    t = _mixed_table()
    data = {"i": t.column("i").to_numpy(), "v": t.column("v").to_numpy()}
    return s.create_dataframe(data).select((c("v") + 1.0).alias("w"),
                                           c("i"))


def _substring(c, f, s, d):
    return s.read.parquet(d["tiny"]).select(
        f.substring(c("s"), 1, 4).alias("u"))


SHAPES = {"tiny_scan": _tiny_scan, "numeric_agg": _numeric_agg,
          "string_agg": _string_agg, "memory_arrow": _memory_arrow,
          "memory_numpy": _memory_numpy, "substring": _substring}


def _jax_run(build, conf, data):
    js = tpu_session(conf)
    try:
        out = build(col, F, js, data).to_arrow()
        return out, js._last_plan_result
    finally:
        js.stop()


@pytest.mark.parametrize("link", sorted(LINKS))
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_static_decisions_equal_jax(files, shape, link):
    conf = cost_conf(LINKS[link])
    jt, jres = _jax_run(SHAPES[shape], conf, files)
    _reset()
    ts = _tsession(conf)
    tt = SHAPES[shape](st.col, TF, ts, files).to_arrow()
    assert list(ts._last_plan.placement) == jres.placement
    assert jres.placement
    engine = jres.placement[0]["engine"]
    # a plan placed on the host runs there, every operator
    assert ts._last_plan.on_host == (engine == "cpu")
    assert_tables_equal(tt, jt, approx_float=True)


@pytest.mark.parametrize("qname", ["q1", "q6"])
@pytest.mark.parametrize("link", sorted(LINKS))
def test_tpch_decisions_and_results_equal_jax(tpch, qname, link):
    from spark_rapids_tpu.bench.tpch import TPCH_QUERIES as JQ
    from spark_rapids_tpu.bench.tpch import load_tables as jload
    from spark_rapids_tpu_torch.bench.tpch import TPCH_QUERIES, \
        load_tables
    conf = cost_conf(LINKS[link])
    js = tpu_session(conf)
    try:
        want = JQ[qname](jload(js, tpch)).to_arrow()
        jdec = js._last_plan_result.placement
    finally:
        js.stop()
    _reset()
    ts = _tsession(conf)
    got = TPCH_QUERIES[qname](load_tables(ts, tpch)).to_arrow()
    assert list(ts._last_plan.placement) == jdec
    assert_tables_equal(got, want, ignore_order=False, approx_float=True)


def test_estimates_give_the_jax_bytes(files):
    """``estimate_logical_size`` and the row width the static pass uses,
    on the same logical plans."""
    from spark_rapids_tpu.plan import cost as jcost
    from spark_rapids_tpu.plan.planner import \
        estimate_logical_size as jest
    from spark_rapids_tpu_torch.plan import cost
    from spark_rapids_tpu_torch.plan.planner import estimate_logical_size
    js, ts = tpu_session(), _tsession()
    try:
        for shape in SHAPES.values():
            jp = shape(col, F, js, files).plan
            tp = shape(st.col, TF, ts, files).plan
            while True:
                assert estimate_logical_size(tp) == jest(jp)
                assert cost.schema_row_width(tp.output_schema()) == \
                    jcost.schema_row_width(jp.output_schema())
                if not jp.children:
                    break
                jp, tp = jp.children[0], tp.children[0]
    finally:
        js.stop()


# ---------------------------------------------------------------------------
# mode=cpu and the default
# ---------------------------------------------------------------------------

def test_mode_cpu_runs_on_the_host_and_pulls_nothing(files):
    from spark_rapids_tpu_torch import native
    from spark_rapids_tpu_torch.columnar import transfer
    from spark_rapids_tpu_torch.plan import placement
    conf = {"spark.rapids.sql.placement.mode": "cpu"}
    jt, jres = _jax_run(_string_agg, conf, files)
    ts = _tsession(conf)
    native.reset_launches()
    pulls = transfer.d2h_stats()["pulls"]
    tt = _string_agg(st.col, TF, ts, files).to_arrow()
    assert transfer.d2h_stats()["pulls"] == pulls
    assert all(v == 0 for v in native.LAUNCHES.values())
    plan = ts._last_plan
    assert plan.on_host and list(plan.placement) == jres.placement
    st_ = placement.global_stats()
    assert st_["fragments_cpu"] == 1 and st_["fragments_tpu"] == 0
    assert_tables_equal(tt, jt, ignore_order=False, approx_float=True)


def test_default_mode_changes_nothing(files):
    """Unset and ``tpu`` plan, run and count alike, and never enter
    the placement module."""
    from spark_rapids_tpu_torch.plan import placement

    def run(extra):
        ts = _tsession(extra)
        df = _tiny_scan(st.col, TF, ts, files)
        explain = df.explain()
        out = df.to_arrow()
        prof = ts.last_query_profile()
        shape = []

        def walk(node, depth):
            shape.append((depth, node.describe, node.rows, node.batches,
                          sorted(k for k, v in node.metrics.items()
                                 if v and not k.lower().endswith(
                                     ("time", "ms", "hits")))))
            for c in node.children:
                walk(c, depth + 1)
        walk(prof.root, 0)
        return explain, out, shape, prof.placement, ts._last_plan

    ex0, out0, shape0, place0, plan0 = run({})
    ex1, out1, shape1, place1, plan1 = run(
        {"spark.rapids.sql.placement.mode": "tpu"})
    assert ex0 == ex1 and out0.equals(out1) and shape0 == shape1
    assert place0 == place1 == []
    assert not plan0.on_host and not plan1.on_host
    assert placement.global_stats()["fragments_scored"] == 0
    assert "Placement:" not in plan0.tree_string()


def test_explain_analyze_and_journal_show_the_decision(tmp_path):
    jdir = tmp_path / "journal"
    ts = _tsession(cost_conf(**{"spark.rapids.sql.obs.journalDir":
                                str(jdir)}))
    df = ts.create_dataframe(_tiny_string_table(200)).select(
        (st.col("v") + 1.0).alias("a"))
    txt = df.explain(analyze=True)
    assert "Placement:" in txt and "-> cpu" in txt
    from spark_rapids_tpu_torch.obs import journal
    journal.close()
    events = []
    for p in jdir.glob("*.jsonl"):
        with open(p, encoding="utf-8") as fh:
            events += [json.loads(line) for line in fh]
    placed = [e for e in events if e["event"] == "fragment_placed"]
    assert placed and placed[0]["engine"] == "cpu"
    assert placed[0]["phase"] == "static"
    snap = ts.engine_stats()["placement"]
    assert snap["fragments_cpu"] >= 1 and snap["queries_observed"] >= 1


# ---------------------------------------------------------------------------
# the adaptive re-score
# ---------------------------------------------------------------------------

def _aqe_conf(**extra):
    conf = cost_conf(REMOTE_LINK)
    conf["spark.rapids.sql.adaptive.enabled"] = "true"
    conf["spark.rapids.sql.placement.cpuRowsPerSec"] = "1000"
    conf["spark.rapids.sql.placement.h2dMBps"] = "100000"
    conf["spark.rapids.sql.placement.d2hMBps"] = "100000"
    conf.update(extra)
    return conf


def _aqe_query(c, s, path, selective):
    df = s.read.parquet(path)
    if selective:
        df = df.filter(c("k") < 1)
    return df.repartition(4, "k").select((c("v") * 2.0).alias("a"),
                                         c("k"))


def _aqe_run(conf, path, selective):
    from spark_rapids_tpu.plan import placement as jplace
    from spark_rapids_tpu.plan.adaptive import find_adaptive as jfind
    from spark_rapids_tpu_torch.plan import placement
    from spark_rapids_tpu_torch.plan.adaptive import find_adaptive
    js = tpu_session(conf)
    try:
        jt = _aqe_query(col, js, path, selective).to_arrow()
        jres = js._last_plan_result
        jdem = [r for r in jfind(jres.physical).reports
                if r.get("decision") == "placement_demoted"]
        jstats = jplace.global_stats()
    finally:
        js.stop()
    ts = _tsession(conf)
    tt = _aqe_query(st.col, ts, path, selective).to_arrow()
    tdem = [r for r in find_adaptive(ts._last_plan).reports
            if r.get("decision") == "placement_demoted"]
    assert [d["engine"] for d in ts._last_plan.placement] == \
        [d["engine"] for d in jres.placement] == ["tpu"]
    assert_tables_equal(tt, jt)
    return jdem, jstats, tdem, placement.global_stats(), ts


def test_aqe_demotes_where_jax_does(files):
    jdem, jstats, tdem, tstats, ts = _aqe_run(_aqe_conf(), files["aqe"],
                                              True)
    assert len(jdem) == len(tdem) == 1
    assert jstats["aqe_demotions"] == tstats["aqe_demotions"] == 1
    jd, td = jdem[0]["placement"], tdem[0]["placement"]
    for k in ("engine", "phase", "ops", "deciding", "rows"):
        assert td[k] == jd[k], k
    names = []

    def walk(n):
        names.append((type(n).__name__, n.on_host))
        for c in n.children:
            walk(c)
    walk(ts._last_plan)
    assert ("HostToDeviceExec", False) in names
    assert ("DeviceToHostExec", True) in names
    assert ("TorchProjectExec", True) in names
    assert ts.last_query_metrics().count("placementDemotions=1") == 1


def test_aqe_keeps_the_remainder_when_jax_does(files):
    jdem, jstats, tdem, tstats, _ = _aqe_run(_aqe_conf(), files["aqe"],
                                             False)
    assert jdem == tdem == []
    assert jstats["aqe_demotions"] == tstats["aqe_demotions"] == 0


def test_aqe_demotion_respects_gate(files):
    jdem, _, tdem, tstats, _ = _aqe_run(
        _aqe_conf(**{"spark.rapids.sql.placement.aqe.enabled": "false"}),
        files["aqe"], True)
    assert jdem == tdem == []
    assert tstats["aqe_demotions"] == 0


# ---------------------------------------------------------------------------
# the plan.place fault
# ---------------------------------------------------------------------------

@pytest.mark.faults
def test_plan_place_fault_runs_on_the_device(files):
    from spark_rapids_tpu_torch.plan import placement
    conf = cost_conf(**{"spark.rapids.faults.plan.place": "always",
                        "spark.rapids.faults.seed": "42"})
    jt, jres = _jax_run(_tiny_scan, conf, files)
    assert jres.placement == []
    ts = _tsession(conf)
    tt = _tiny_scan(st.col, TF, ts, files).to_arrow()
    assert list(ts._last_plan.placement) == [] and not ts._last_plan.on_host
    assert placement.global_stats()["place_faults"] >= 1
    assert_tables_equal(tt, jt)


@pytest.mark.faults
def test_plan_place_fault_skips_the_aqe_demotion(files):
    """count:2: the static pass runs, the re-score hits the fault."""
    conf = _aqe_conf(**{"spark.rapids.faults.plan.place": "count:2",
                        "spark.rapids.faults.seed": "42"})
    jdem, jstats, tdem, tstats, _ = _aqe_run(conf, files["aqe"], True)
    assert jdem == tdem == []
    assert jstats["aqe_demotions"] == tstats["aqe_demotions"] == 0
    assert tstats["place_faults"] >= 1


# ---------------------------------------------------------------------------
# units
# ---------------------------------------------------------------------------

def test_link_constants_read_from_conf_without_probe():
    from spark_rapids_tpu_torch.conf import TorchConf
    from spark_rapids_tpu_torch.plan import cost
    conf = TorchConf({"spark.rapids.sql.placement.h2dMBps": "45",
                      "spark.rapids.sql.placement.d2hMBps": "3.9",
                      "spark.rapids.sql.placement.pullLatencyMs": "94"})
    assert cost.link_constants(conf) == {
        "h2d_mbps": 45.0, "d2h_mbps": 3.9, "pull_latency_ms": 94.0,
        "probed": False}
    assert cost.effective_link_constants(conf) == \
        cost.link_constants(conf)
    assert cost._PROBE is None


def test_probe_link_measures_through_the_transfer_seams():
    """On this box the probe runs over the CPU (its numbers mean
    nothing here); it returns the JAX probe's keys and counts its pulls
    (a warm-up and a timed one of each size)."""
    from spark_rapids_tpu_torch.columnar import transfer
    from spark_rapids_tpu_torch.plan import cost
    pulls = transfer.d2h_stats()["pulls"]
    probe = cost.probe_link(torch.device("cpu"))
    assert set(probe) == {"h2d_mbps", "d2h_mbps", "d2h_latency_ms"}
    assert all(v > 0 for v in probe.values())
    assert transfer.d2h_stats()["pulls"] == pulls + 4
    assert cost.probe_link() == probe  # once a process


@pytest.mark.parametrize("mode", ["tpu", "cpu", "cost"])
def test_set_mode_and_calibration_active_equal_jax(mode):
    """The pair keeps the JAX names and answers; running a query under
    any mode leaves the port's process-wide mode alone (its operators
    count rows in every mode)."""
    from spark_rapids_tpu.plan import cost as jcost
    from spark_rapids_tpu_torch.plan import cost
    assert cost.calibration_active() is False
    for mod in (jcost, cost):
        mod.set_mode(mode)
    assert cost.calibration_active() == jcost.calibration_active()
    cost.set_mode("tpu")
    ts = _tsession({"spark.rapids.sql.placement.mode": mode})
    try:
        ts.create_dataframe({"a": np.arange(10, dtype=np.int64)}) \
            .filter(TF.col("a") > 3).collect()
    finally:
        ts.stop()
    assert cost.calibration_active() is False


OBSERVATIONS = [("cpu", "project", 1000, 0.001),
                ("cpu", "project", 3000, 0.001),
                ("tpu", "hashaggregate", 50_000, 0.002),
                ("cpu", "filter_str", 777, 0.0031),
                ("tpu", "project", 0, 0.1),  # no rows: ignored
                ("tpu", "project", 10, 1e-9)]  # no time: ignored


def test_calibration_ewma_and_file_equal_jax(tmp_path):
    from spark_rapids_tpu.plan.cost import CalibrationStore as J
    from spark_rapids_tpu_torch.plan.cost import CalibrationStore as T
    j, t = J(), T()
    for args in OBSERVATIONS:
        j.observe(*args)
        t.observe(*args)
    assert t.snapshot() == j.snapshot()
    assert t.rate("cpu", "project", 0.0) == pytest.approx(1.6e6)
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    j.save(str(tmp_path / "j"))
    t.save(str(tmp_path / "t"))
    assert (tmp_path / "t" / "calibration.json").read_bytes() == \
        (tmp_path / "j" / "calibration.json").read_bytes()
    fresh = T()
    fresh.load(str(tmp_path / "j"))
    assert fresh.rate("cpu", "project", 0.0) == pytest.approx(1.6e6)
    (tmp_path / "t" / "calibration.json").write_text("{not json")
    broken = T()
    broken.load(str(tmp_path / "t"))
    assert broken.rate("cpu", "project", 7.0) == 7.0


SCORES = [
    (["project", "filter"], 1000, 40_000, 40_000, REMOTE_LINK),
    (["project", "filter"], 50_000_000, 1 << 30, 1 << 30, LOCAL_LINK),
    (["project"], 10, 100, 3 << 30, LOCAL_LINK),
    (["sort", "hashaggregate", "localscan"], 123_456, 9_876_543,
     493_827, REMOTE_LINK),
    (["project_str", "filter_str"], 2000, 80_000, 4000, LOCAL_LINK),
]


@pytest.mark.parametrize("case", range(len(SCORES)))
def test_score_ops_equals_jax(case):
    from spark_rapids_tpu.conf import TpuConf
    from spark_rapids_tpu.plan import cost as jcost
    from spark_rapids_tpu_torch.conf import TorchConf
    from spark_rapids_tpu_torch.plan import cost
    classes, rows, bin_, bout, link = SCORES[case]
    jc, tc = jcost.CalibrationStore(), cost.CalibrationStore()
    for args in OBSERVATIONS:
        jc.observe(*args)
        tc.observe(*args)
    jconf, tconf = TpuConf(link), TorchConf(link)
    want = jcost.score_ops(classes, rows, bin_, bout, jconf,
                           jcost.link_constants(jconf), jc,
                           compile_ms=2.5)
    got = cost.score_ops(classes, rows, bin_, bout, tconf,
                         cost.link_constants(tconf), tc, compile_ms=2.5)
    assert got == want


def test_op_and_step_classes_equal_jax():
    from spark_rapids_tpu.exprs.base import bind_expression as jbind
    from spark_rapids_tpu.plan import cost as jcost
    from spark_rapids_tpu_torch.exprs.base import bind_expression as tbind
    from spark_rapids_tpu_torch.plan import cost
    for name in ("TpuProjectExec", "CpuFilterExec", "TpuHashAggregateExec",
                 "TpuStageExec", "HostToDeviceExec"):
        assert cost.op_class(name) == jcost.op_class(name)
        assert cost.op_class(name.replace("Tpu", "Torch").replace(
            "Cpu", "Torch")) == jcost.op_class(name)
    t = pa.table({"s": pa.array(["ab", "c"]), "v": pa.array([1.0, 2.0])})
    js, ts = tpu_session(), _tsession()
    try:
        jschema = js.create_dataframe(t).plan.output_schema()
        tschema = ts.create_dataframe(t).plan.output_schema()
        for make in (lambda c, f: c("v") + 1.0,
                     lambda c, f: f.substring(c("s"), 1, 1),
                     lambda c, f: f.contains(c("s"), "a" * 20),
                     lambda c, f: f.length(c("s")) > 1,
                     lambda c, f: f.upper(c("s"))):
            je = jbind(make(col, F).expr, jschema)
            te = tbind(make(st.col, TF).expr, tschema)
            for kind in ("project", "filter", "sort"):
                assert cost.step_class(kind, [te]) == \
                    jcost.step_class(kind, [je])
    finally:
        js.stop()


def test_placement_keys_have_the_jax_defaults():
    from spark_rapids_tpu import conf as jconf
    from spark_rapids_tpu_torch import conf as tconf
    for name in ("PLACEMENT_MODE", "PLACEMENT_H2D_MBPS",
                 "PLACEMENT_D2H_MBPS", "PLACEMENT_AGG_H2D_MBPS",
                 "PLACEMENT_AGG_D2H_MBPS", "PLACEMENT_PULL_LATENCY_MS",
                 "PLACEMENT_AQE_ENABLED", "PLACEMENT_CPU_ROWS_PER_SEC",
                 "PLACEMENT_TPU_ROWS_PER_SEC"):
        j, t = getattr(jconf, name), getattr(tconf, name)
        assert (t.key, t.default, t.conf_type) == \
            (j.key, j.default, j.conf_type)
    with pytest.raises(ValueError):
        tconf.TorchConf({"spark.rapids.sql.placement.mode": "gpu"})
