"""The torch port's query profiles, metrics and surfaces against the JAX
package.

Analogs of ``tests/test_obs.py`` (query profiles, the known metric
names) and ``tests/test_aux.py`` (``api_validation``,
``last_query_metrics``):

* ``explain(analyze=True)`` and ``last_query_profile().to_dict()`` count
  the same ``numOutputRows`` and ``numOutputBatches`` an operator as the
  JAX session's profile of the same query: a filter and project, a hash
  aggregate through K1's plain version, a broadcast join, a window, and
  TPC-H q3 with adaptive execution on.  The trees differ in three known
  ways, which ``_flat`` maps: the JAX package's ``DeviceToHost``
  transition at the root has no counterpart (the port's actions pull
  the root's batches themselves); a project, a filter and a fused
  stage all compare as ``Stage``; and a JAX stage
  directly under a shuffle exchange runs fused into the exchange's
  partition kernel and counts no output (0 rows, 0 batches), which the
  port, without that fusion, counts, so the pair is not compared.
* ``explain()`` without ``analyze`` runs nothing.
* ``legacy_lines()`` and ``render()`` give the JAX package's text byte
  for byte on the same tree.
* ``MetricSet`` refuses an unknown name; ``python -m
  spark_rapids_tpu_torch.obs`` prints the exposition; the spill
  journal's tier moves equal the JAX catalog's; ``api_validation``
  reports exactly the surfaces still missing.

Counts compare exactly; there is no float in them.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pyarrow as pa
import pytest

from spark_rapids_tpu import Window as JWindow
from spark_rapids_tpu import functions as F
from spark_rapids_tpu.api import col
from tests.compare import tpu_session

import spark_rapids_tpu_torch as st
from spark_rapids_tpu_torch import functions as TF
from spark_rapids_tpu_torch import native
from spark_rapids_tpu_torch.utils.metrics import Metric, MetricSet, \
    register_adhoc_metric

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port(extra=None):
    return st.TorchSession({"spark.rapids.torch.device": "cpu",
                            **(extra or {})})


def _tables(n=3000, seed=1):
    rng = np.random.default_rng(seed)
    fact = pa.table({"k": pa.array(rng.integers(0, 50, n), pa.int64()),
                     "v": pa.array(rng.normal(size=n)),
                     "g": pa.array(rng.integers(0, 7, n), pa.int64()),
                     "o": pa.array(np.arange(n), pa.int64())})
    dim = pa.table({"k": pa.array(np.arange(50), pa.int64()),
                    "name": pa.array([f"n{i}" for i in range(50)])})
    return fact, dim


QUERIES = {
    "filter_project": lambda c, f, w, df, dd: df.filter(c("v") > 0).select(
        "k", (c("v") * 2).alias("d")),
    "hash_agg": lambda c, f, w, df, dd: df.group_by("k").agg(
        f.sum(c("v")).alias("sv"), f.count(c("v")).alias("n")),
    "join": lambda c, f, w, df, dd: df.join(dd, on="k").group_by(
        "name").agg(f.sum(c("v")).alias("sv")),
    "window": lambda c, f, w, df, dd: df.select(
        "g", "o", f.sum(c("v")).over(
            w.partition_by("g").order_by("o")).alias("rs")),
}


def _norm(name: str) -> str:
    for p in ("Torch", "Tpu"):
        if name.startswith(p):
            name = name[len(p):]
    if name.endswith("Exec"):
        name = name[:-4]
    return "Stage" if name in ("Project", "Filter") else name


def _flat(root, jax: bool):
    """[(operator, rows, batches)] in tree order under the mapping of
    the module docstring; None where the pair is not compared."""
    out = []

    def walk(node, parent):
        name = _norm(node["name"])
        if jax and name in ("DeviceToHost", "HostToDevice"):
            for c in node["children"]:
                walk(c, parent)
            return
        fused = (jax and name == "Stage" and parent == "ShuffleExchange"
                 and node["rows"] == 0 and node["batches"] == 0)
        out.append((name, None if fused else node["rows"],
                    None if fused else node["batches"]))
        for c in node["children"]:
            walk(c, name)

    walk(root, None)
    return out


def _same_counts(got, want):
    assert [g[0] for g in got] == [w[0] for w in want], (got, want)
    for g, w in zip(got, want):
        if w[1] is not None:
            assert g == w, (g, w)


@pytest.mark.parametrize("qname", sorted(QUERIES))
def test_profile_counts_match_jax(qname):
    fact, dim = _tables()
    q = QUERIES[qname]
    js = tpu_session()
    want_rows = q(col, F, JWindow, js.create_dataframe(fact),
                  js.create_dataframe(dim)).to_arrow().num_rows
    jprof = js.last_query_profile().to_dict()
    ps = _port()
    df = q(st.col, TF, st.Window, ps.create_dataframe(fact),
           ps.create_dataframe(dim))
    txt = df.explain(analyze=True)
    assert txt.startswith("== Executed plan (query ")
    prof = ps.last_query_profile()
    d = prof.to_dict()
    assert d["plan"]["rows"] == want_rows == df.count()
    _same_counts(_flat(d["plan"], False), _flat(jprof["plan"], True))
    # the rendered tree carries the same counts, one line an operator
    lines = txt.splitlines()[1:]
    assert len(lines) == len(_flat(d["plan"], False))
    assert f"rows={want_rows} " in lines[0]
    if qname == "hash_agg":
        # K1's plain version ran the update (64 slots hold keys 0..49)
        assert "pallasAggBatches=1" in lines[0]


def test_profile_counts_match_jax_tpch_q3_with_aqe(tmp_path):
    from spark_rapids_tpu.bench.tpch import TPCH_QUERIES as JQ
    from spark_rapids_tpu.bench.tpch import gen_tpch
    from spark_rapids_tpu.bench.tpch import load_tables as jload
    from spark_rapids_tpu_torch.bench.tpch import TPCH_QUERIES as TQ
    from spark_rapids_tpu_torch.bench.tpch import load_tables as tload
    paths = gen_tpch(str(tmp_path), lineitem_rows=2000)
    conf = {"spark.rapids.sql.adaptive.enabled": "true"}
    js = tpu_session(conf)
    JQ["q3"](jload(js, paths)).collect()
    want = _flat(js.last_query_profile().to_dict()["plan"], True)
    ps = _port(conf)
    txt = TQ["q3"](tload(ps, paths)).explain(analyze=True)
    assert "TorchAdaptiveSparkPlan [stages=2]" in txt
    assert "TorchQueryStage [materialized]" in txt
    assert "time=" in txt and "self=" in txt
    got = _flat(ps.last_query_profile().to_dict()["plan"], False)
    _same_counts(got, want)
    assert any(r is None for _n, r, _b in want)  # the fused stage


def test_explain_without_analyze_runs_nothing():
    fact, dim = _tables(200)
    ps = _port()
    before = dict(native.LAUNCHES)
    txt = ps.create_dataframe(fact).filter(st.col("v") > 0).group_by(
        "k").agg(TF.count(st.col("v")).alias("c")).explain()
    assert ps.last_query_profile() is None and ps._last_plan is None
    assert dict(native.LAUNCHES) == before
    head, phys = txt.split("\n\nPhysical plan:\n")
    assert head.splitlines() == ["* Aggregate", "  * Filter",
                                 "    * LocalRelation"]
    assert phys.splitlines()[0].startswith(
        "TorchHashAggregate [keys=[k], aggs=[c]]")
    # the JAX package's text has the same shape
    jtxt = tpu_session().create_dataframe(fact).filter(col("v") > 0) \
        .group_by("k").agg(F.count(col("v")).alias("c")).explain()
    assert jtxt.split("\n\nPhysical plan:\n")[0] == head


def test_last_query_profile_tree_and_dict():
    fact, _ = _tables(500)
    ps = _port()
    assert ps.last_query_profile() is None
    assert ps.last_query_metrics() == "<no query executed>"
    ps.create_dataframe(fact).filter(st.col("v") > 0).collect()
    p = ps.last_query_profile()
    assert p.query_id and p.wall_ms > 0
    d = p.to_dict()
    assert d["query_id"] == p.query_id
    json.dumps(d)  # plain values only

    def walk(node):
        assert 0 <= node.self_time_ms <= node.time_ms + 1e-9
        for c in node.children:
            walk(c)
    walk(p.root)
    assert st.TorchSession.active() is ps


def test_failed_query_keeps_the_previous_profile():
    from spark_rapids_tpu_torch import faults
    fact, _ = _tables(500)
    ps = _port()
    ps.create_dataframe(fact).filter(st.col("v") > 0).collect()
    first = ps.last_query_profile().query_id
    ps.set_conf("spark.rapids.faults.kernel.launch", "always")
    try:
        with pytest.raises(faults.InjectedFault):
            ps.create_dataframe(fact).filter(st.col("v") > 0).collect()
    finally:
        faults.reset()
    assert ps.last_query_profile().query_id == first


def test_last_query_metrics_format_matches_jax():
    fact, _ = _tables(1000)

    def q(c, f, df):
        return df.filter(c("v") > 0).group_by("k").agg(
            f.count(c("v")).alias("c"))
    js = tpu_session()
    q(col, F, js.create_dataframe(fact)).collect()
    ps = _port()
    q(st.col, TF, ps.create_dataframe(fact)).collect()
    txt = ps.last_query_metrics()
    assert txt.splitlines()[0].startswith(
        "TorchHashAggregate [keys=[k], aggs=[c]]: ")
    assert "numOutputRows=50" in txt and "numOutputRows=50" in \
        js.last_query_metrics()
    # the seed rendering, verbatim from tests/test_obs.py, over the
    # port's live plan
    lines = []

    def walk(node, depth):
        parts = []
        for name, m in sorted(node.metrics.items()):
            if not m.value:
                continue
            if name.lower().endswith("time"):
                parts.append(f"{name}={m.value / 1e6:.1f}ms")
            else:
                parts.append(f"{name}={m.value}")
        lines.append("  " * depth + node.describe()
                     + (": " + ", ".join(parts) if parts else ""))
        for c in node.children:
            walk(c, depth + 1)
    walk(ps._last_plan, 0)
    assert txt == "\n".join(lines)


def _random_tree(pkg_profile, rng, depth=0):
    names = ["numOutputRows", "numOutputBatches", "totalTime",
             "hostSyncs", "buildTime", "pallasAggBatches", "semWaitMs"]
    metrics = {n: int(rng.integers(0, 3) and rng.integers(0, 10 ** 9))
               for n in names if rng.random() < 0.8}
    kids = [] if depth >= 2 else [
        _random_tree(pkg_profile, rng, depth + 1)
        for _ in range(int(rng.integers(0, 3)))]
    op = f"Op{int(rng.integers(0, 100))} [k={int(rng.integers(0, 9))}]"
    return pkg_profile.OperatorProfile(op.split()[0], op, metrics, kids)


@pytest.mark.parametrize("seed", range(5))
def test_profile_renderings_match_jax_byte_for_byte(seed):
    from spark_rapids_tpu.obs import profile as jprofile
    from spark_rapids_tpu_torch.obs import profile as tprofile
    jroot = _random_tree(jprofile, np.random.default_rng(seed))
    troot = _random_tree(tprofile, np.random.default_rng(seed))
    for qid, wall in ((None, None), (7, None), (12, 34.56)):
        j = jprofile.QueryProfile(jroot, query_id=qid, wall_ms=wall)
        t = tprofile.QueryProfile(troot, query_id=qid, wall_ms=wall)
        assert t.legacy_lines() == j.legacy_lines()
        assert t.render() == j.render()
        assert t.to_dict() == j.to_dict()


def test_metricset_rejects_unknown_names():
    with pytest.raises(KeyError, match="unknown metric name"):
        MetricSet("numOutputRowz")
    ms = MetricSet()
    with pytest.raises(KeyError, match="unknown metric name"):
        ms["totalTimee"]
    with pytest.raises(KeyError, match="unknown metric name"):
        ms["hostSync"] += 1


def test_metricset_adhoc_escape_hatches():
    ms = MetricSet("synthetic", adhoc=True)
    ms["another"].add(1)
    assert ms.snapshot()["another"] == 1
    register_adhoc_metric("blessedPortMetric")
    ms2 = MetricSet()
    ms2["blessedPortMetric"].add(2)
    assert ms2["blessedPortMetric"].value == 2


def test_metric_reads_as_an_int():
    ms = MetricSet(owner="TestOp")
    m = ms["hostSyncs"]
    ms["hostSyncs"] += 3
    ms["hostSyncs"] += 2
    assert ms["hostSyncs"] is m and m == 5 and m.value == 5
    assert m + 1 == 6 and 1 + m == 6 and sum([m, m]) == 10
    assert m * 3 == 15 and m < 6 and m >= 5 and int(m) == 5
    ms["hostSyncs"] = 0
    assert ms.get("hostSyncs") == 0 and ms.get("nothere", -1) == -1
    assert isinstance(m, Metric) and not m


def test_every_port_operator_metric_is_known():
    # the names the operators count are known (a run through each
    # family: scan, stage, aggregate on K1's plain path, joins,
    # exchange, window, sort and the coalesce's pull)
    from spark_rapids_tpu_torch.utils.metrics import KNOWN_METRICS
    fact, dim = _tables(2000)
    ps = _port({"spark.rapids.sql.adaptive.enabled": True,
                "spark.sql.autoBroadcastJoinThreshold": -1,
                "spark.rapids.sql.io.prefetch.enabled": True})
    df = ps.create_dataframe(fact)
    (df.join(ps.create_dataframe(dim), on="k").repartition(3, "g")
       .select("g", "o", TF.sum(st.col("v")).over(
           st.Window.partition_by("g").order_by("o")).alias("rs"))
       .group_by("g").agg(TF.max(st.col("rs")).alias("m"))
       .order_by("g").collect())

    def walk(node):
        for name, _ in node.metrics.items():
            assert name in KNOWN_METRICS, (node.node_name, name)
        for c in node.children:
            walk(c)
    walk(ps._last_plan)


def test_obs_module_prints_exposition():
    out = subprocess.run([sys.executable, "-m", "spark_rapids_tpu_torch.obs"],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    text = out.stdout
    assert "# TYPE spark_rapids_tpu_fleet_replicas gauge" in text
    assert "spark_rapids_tpu_server_submitted 0" in text
    for group in ("aqe", "lifecycle", "catalog", "server", "journal",
                  "fleet"):
        assert f"# TYPE spark_rapids_tpu_{group}_" in text, group
    for line in text.splitlines():
        assert line.startswith("# TYPE ") or \
            len(line.rsplit(" ", 1)) == 2, line


def _journal_moves(jdir):
    events = []
    for name in sorted(os.listdir(jdir)):
        with open(os.path.join(jdir, name), encoding="utf-8") as f:
            events += [json.loads(line) for line in f if line.strip()]
    return [(e["event"], e["tier_from"], e["tier_to"], e["bytes"])
            for e in events if e["event"].startswith("spill_")]


@pytest.mark.parametrize("spec", ["off", "count:2"])
def test_spill_journal_events_match_jax_catalog(tmp_path, spec):
    """The same handle through ``spill_all``, a promotion and
    ``spill_all`` again (``tests/test_torch_faults.py``'s sequence), with
    and without an injected failed demotion: the same tier-move events,
    field for field."""
    from spark_rapids_tpu import faults as jfaults
    from spark_rapids_tpu.obs import journal as jjournal
    from spark_rapids_tpu_torch import faults
    from spark_rapids_tpu_torch.obs import journal
    from tests.test_torch_faults import _demote_sequence, _jax_spillable, \
        _spillable
    conf = {"spark.rapids.faults.spill.demote": spec}
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jcat, jsb = _jax_spillable()
    cat, sb = _spillable()
    try:
        jjournal.configure(jdir)
        jfaults.configure_from_conf(conf)
        _demote_sequence(jcat, jsb, 2)
        jjournal.close()
        journal.configure(tdir)
        faults.configure_from_conf(conf)
        _demote_sequence(cat, sb, 2)
        journal.close()
    finally:
        jfaults.reset()
        faults.reset()
        jjournal.close()
        journal.close()
        sb.close()
        jsb.close()
    want = _journal_moves(jdir)
    assert want and _journal_moves(tdir) == want
    assert ("spill_promote", "host", "device", sb.size) in want


def test_api_validation_lists_only_the_pyarrow_surfaces():
    from spark_rapids_tpu.api_validation import EXPECTED as JEXPECTED
    from spark_rapids_tpu_torch.api_validation import EXCLUDED, EXPECTED, \
        validate
    missing = {c: r["missing"] for c, r in validate().items()
               if r["missing"]}
    # file I/O is ported (the CSV reader and writer without pyarrow):
    # nothing is missing, and a PR that loses a method fails
    assert missing == {}
    # the contract is the JAX package's, TpuSession read as
    # TorchSession, less the entries excluded by name
    jexp = {("TorchSession" if k == "TpuSession" else k): v
            for k, v in JEXPECTED.items()}
    assert set(jexp) == set(EXPECTED)
    for cls, members in jexp.items():
        dropped = set(EXCLUDED.get(cls, {}))
        assert EXPECTED[cls] == [m for m in members if m not in dropped]
    assert EXCLUDED == {"DataFrame": {"to_jax": EXCLUDED["DataFrame"][
        "to_jax"]}}
