"""The port's guarded mesh lowering (``spark.rapids.shuffle.mode=ici``,
``spark_rapids_tpu_torch/exec/meshexec.py: ici_lower``) against the JAX
package's.

Analog of ``tests/test_ici_shuffle.py`` and the ICI cases of
``tests/test_distjoin.py``.  The JAX sessions run over the tests' 8
virtual CPU devices, the port's over 8 shards on ``cpu``
(``parallel/mesh.py: virtual_pool(8)``):

* the mode rules and ``ici_mesh_width`` equal the JAX package's case by
  case, and the port's pool decides them (one device on ``cpu``);
* the lowered plans print as the JAX package's (``Tpu`` -> ``Torch``),
  host mode lowers nothing, AQE exchanges under a lowered join are
  unwrapped;
* results equal the JAX package's ``ici`` results (integers exact, f64
  sums within ``approx_float``'s 1e-9 relative): a group-by and sort in
  order, the shuffled join with broadcast off, widths 4, 2 and 1;
* the degrades: ``shuffle.ici.collective=always`` degrades every
  fragment, ``count:1`` only the first, ``maxStageBytes=1`` every one,
  ``shuffle.ici.hang`` under the watchdog, a device out-of-memory error
  (one raised in the pipeline) degrades and any other error surfaces;
  each counted by reason, logged to the journal, its rows unchanged;
* the acceptance numbers: the join and aggregate run 3 exchanges with
  no ``device_pull`` (the count matrices are host syncs), bytes counted;
  the per-shard bytes feed ``shufflePartitionBytes`` and the adaptive
  statistics;
* the keys of later slices (``shardedScan``, ``ooc``, ``health``) raise
  ``MeshNotPortedError`` on a mesh plan, and not on a plan without one.
"""

import re

import numpy as np
import pyarrow as pa
import pytest

from spark_rapids_tpu import faults as jfaults
from spark_rapids_tpu import functions as F
from spark_rapids_tpu.api import col
from spark_rapids_tpu.plan.planner import plan_query as jplan_query
from tests.compare import assert_tables_equal, tpu_session
from tests.torch_threads import _one_torch_thread  # noqa: F401

import spark_rapids_tpu_torch as st
from spark_rapids_tpu_torch import faults
from spark_rapids_tpu_torch import functions as TF
from spark_rapids_tpu_torch.conf import TorchConf
from spark_rapids_tpu_torch.exec import meshexec
from spark_rapids_tpu_torch.parallel.mesh import virtual_pool
from spark_rapids_tpu_torch.plan.planner import plan_query
from spark_rapids_tpu_torch.shuffle.manager import MeshNotPortedError, \
    ici_mesh_width, select_shuffle_mode

ICI = {"spark.rapids.shuffle.mode": "ici"}
POOL8 = {"spark.rapids.torch.device": "cpu"}
NO_BROADCAST = {"spark.sql.autoBroadcastJoinThreshold": "-1"}


@pytest.fixture(scope="module", autouse=True)
def _pool8():
    """The port's pool: 8 shards on ``cpu`` for every test here."""
    with virtual_pool(8):
        yield


@pytest.fixture(autouse=True)
def _fresh():
    faults.reset()
    jfaults.reset()
    meshexec.reset_ici_stats()
    yield
    faults.reset()
    jfaults.reset()


def _tsession(extra=None):
    return st.TorchSession({**POOL8, **(extra or {})})


def _table(n=4000, seed=0):
    rng = np.random.default_rng(seed)
    return pa.table({
        "k": pa.array(rng.integers(0, 37, n), pa.int64()),
        "v": pa.array(rng.normal(size=n)),
        "w": pa.array(rng.integers(-5, 5, n), pa.int64()),
    })


def _right(n=1500, seed=1):
    rng = np.random.default_rng(seed)
    return pa.table({"k": pa.array(rng.integers(0, 37, n), pa.int64()),
                     "u": pa.array(rng.normal(size=n))})


def _agg_sort(t):
    def build(s, f, c):
        return (s.create_dataframe(t).group_by(c("k"))
                .agg(f.sum(c("v")).alias("s"), f.count(c("w")).alias("c"))
                .order_by(c("k")))
    return build


def _join_agg(t1, t2):
    def build(s, f, c):
        return (s.create_dataframe(t1)
                .join(s.create_dataframe(t2), on="k", how="inner")
                .group_by(c("k")).agg(f.sum(c("u")).alias("su")))
    return build


def _metric(session, name):
    total = 0

    def walk(node):
        nonlocal total
        total += node.metrics.get(name)
        for c in node.children:
            walk(c)
    walk(session._last_plan)
    return total


def _run_both(build, conf, ignore_order=True):
    """The JAX package's result of ``build`` under ``conf`` against the
    port's -> the port's session."""
    js = tpu_session(conf)
    if any(k.startswith("spark.rapids.faults.") for k in conf):
        jfaults.configure_from_conf(conf)
    want = build(js, F, col).to_arrow()
    jfaults.reset()
    ts = _tsession(conf)
    got = build(ts, TF, st.col).to_arrow()
    assert want.num_rows > 0
    assert_tables_equal(got, want, ignore_order=ignore_order,
                        approx_float=True)
    return ts


def _normalize(tree: str) -> str:
    lines = [ln for ln in tree.splitlines() if ln.strip() != "DeviceToHost"]
    pad = min(len(ln) - len(ln.lstrip()) for ln in lines)
    out = "\n".join(ln[pad:] for ln in lines).replace("Tpu", "Torch")
    return re.sub(r" \[TargetSize\(\d+\)\]", "", out)


# -- the mode rules -------------------------------------------------------------

@pytest.mark.parametrize("conf,n", [
    ({}, 8), (ICI, 8), (ICI, 1), (ICI, 2),
    ({**ICI, "spark.rapids.shuffle.workers.count": 2}, 8),
    ({**ICI, "spark.rapids.sql.mesh.devices": 8}, 8),
])
def test_mode_rules_equal_jax(conf, n):
    from spark_rapids_tpu.conf import TpuConf
    from spark_rapids_tpu.shuffle.manager import \
        select_shuffle_mode as jselect
    assert select_shuffle_mode(TorchConf(conf), n_devices=n) == \
        jselect(TpuConf(dict(conf)), n_devices=n)


@pytest.mark.parametrize("width,want", [(0, 8), (4, 4), (99, 8)])
def test_mesh_width_equals_jax(width, want):
    from spark_rapids_tpu.conf import TpuConf
    from spark_rapids_tpu.shuffle.manager import ici_mesh_width as jwidth
    conf = {**ICI, "spark.rapids.shuffle.ici.devices": width}
    assert ici_mesh_width(TorchConf(conf), n_devices=8) == want == \
        jwidth(TpuConf(dict(conf)), n_devices=8)


def test_the_pool_decides_the_mode():
    cpu1 = TorchConf({**ICI, "spark.rapids.torch.device": "cpu"})
    with virtual_pool(0):
        assert select_shuffle_mode(cpu1) == "host"
    assert select_shuffle_mode(TorchConf({**ICI, **POOL8})) == "ici"
    assert ici_mesh_width(TorchConf({**ICI, **POOL8})) == 8


# -- plans ----------------------------------------------------------------------

def test_guarded_plan_equals_jax_and_host_mode_lowers_nothing():
    build = _agg_sort(_table())
    js, ts = tpu_session(ICI), _tsession(ICI)
    jtree = _normalize(jplan_query(build(js, F, col).plan, js.conf)
                       .physical.tree_string())
    plan = plan_query(build(ts, TF, st.col).plan, ts.conf)
    assert plan.tree_string() == jtree
    assert "TorchMeshAggregate" in jtree and "TorchMeshSort" in jtree
    assert plan.ici_fallback.describe().startswith("TorchSort")
    host = plan_query(build(_tsession(), TF, st.col).plan,
                      _tsession().conf).tree_string()
    assert "Mesh" not in host


def test_aqe_exchanges_under_a_lowered_join_are_unwrapped():
    from spark_rapids_tpu_torch.exec.exchange import TorchShuffleExchangeExec
    conf = {**ICI, **NO_BROADCAST,
            "spark.rapids.sql.adaptive.enabled": "true"}
    ts = _tsession(conf)
    q = ts.create_dataframe(_table(1000)).join(
        ts.create_dataframe(_right(800)), on="k", how="inner")
    plan = plan_query(q.plan, ts.conf)

    def find(node, cls):
        out = [node] if isinstance(node, cls) else []
        for c in node.children:
            out.extend(find(c, cls))
        return out
    joins = find(plan, meshexec.TorchMeshHashJoinExec)
    assert joins, plan.tree_string()
    for j in joins:
        assert not find(j, TorchShuffleExchangeExec), plan.tree_string()
    _run_both(lambda s, f, c: s.create_dataframe(_table(1000)).join(
        s.create_dataframe(_right(800)), on="k", how="inner"), conf)


# -- results --------------------------------------------------------------------

def test_agg_sort_equals_jax():
    ts = _run_both(_agg_sort(_table()), ICI, ignore_order=False)
    assert _metric(ts, "iciExchanges") == 2
    assert _metric(ts, "iciFallbacks") == 0


@pytest.mark.parametrize("width", [4, 2, 1])
def test_degraded_widths_equal_jax(width):
    conf = {**ICI, "spark.rapids.shuffle.ici.devices": str(width)}
    ts = _run_both(_agg_sort(_table(2500)), conf, ignore_order=False)
    tree = ts._last_plan.tree_string()
    if width >= 2:
        assert f"TorchMeshAggregate [mesh={width}" in tree
        assert _metric(ts, "iciExchanges") == 2
    else:
        assert "Mesh" not in tree


def test_join_and_aggregate_make_no_exchange_pull():
    """The hash exchanges read their count matrices as host syncs and
    pull nothing: 3 exchanges (the join's two sides and the aggregate),
    0 exchange pulls, bytes counted."""
    conf = {**ICI, **NO_BROADCAST}
    meshexec.reset_ici_stats()
    ts = _run_both(_join_agg(_table(3000), _right()), conf)
    got = meshexec.ici_stats()
    assert got["exchanges"] == 3 and got["exchange_pulls"] == 0, got
    assert got["bytes"] > 0 and got["fallbacks"] == 0, got
    assert _metric(ts, "iciExchanges") == 3
    join = [n for n in _walk(ts._last_plan)
            if type(n).__name__ == "TorchMeshHashJoinExec"][0]
    assert join.metrics["hostSyncs"] >= 2  # a count matrix a side


def _walk(node):
    yield node
    for c in node.children:
        yield from _walk(c)


def test_partition_bytes_feed_the_adaptive_statistics():
    from spark_rapids_tpu_torch.exec import aqe
    conf = {**ICI, "spark.rapids.sql.adaptive.enabled": "true"}
    ts = _tsession(conf)
    before = aqe.global_stats()["exchanges"]
    ts.create_dataframe(_table()).group_by(st.col("k")).agg(
        TF.sum(st.col("v")).alias("s")).to_arrow()
    assert _metric(ts, "shufflePartitionBytes") > 0
    assert aqe.global_stats()["exchanges"] == before + 1


# -- the degrades ---------------------------------------------------------------

def test_injected_fault_degrades_every_fragment():
    conf = {**ICI, "spark.rapids.faults.shuffle.ici.collective": "always"}
    ts = _run_both(_agg_sort(_table()), conf, ignore_order=False)
    assert _metric(ts, "iciFallbacks") == 2
    assert _metric(ts, "iciExchanges") == 0
    got = meshexec.ici_stats()
    assert got["fallbacks"] == got["fallbacks_injected"] == 2


def test_first_fault_degrades_only_the_first_fragment():
    conf = {**ICI, "spark.rapids.faults.shuffle.ici.collective": "count:1"}
    ts = _run_both(_agg_sort(_table()), conf, ignore_order=False)
    assert _metric(ts, "iciFallbacks") == 1
    assert _metric(ts, "iciExchanges") == 1


def test_over_budget_stage_keeps_the_single_device_path(tmp_path):
    import json
    import os
    from spark_rapids_tpu_torch.obs import journal
    conf = {**ICI, "spark.rapids.shuffle.ici.maxStageBytes": "1"}
    try:
        journal.configure(str(tmp_path))
        ts = _run_both(_agg_sort(_table()), conf, ignore_order=False)
    finally:
        journal.configure("")
    assert _metric(ts, "iciFallbacks") == 2
    assert _metric(ts, "iciExchanges") == 0
    assert meshexec.ici_stats()["fallbacks_over_budget"] == 2
    path = os.path.join(str(tmp_path), f"events-{os.getpid()}.jsonl")
    events = [json.loads(ln) for ln in open(path)]
    degrades = [e for e in events if e["event"] == "ici_fallback"]
    assert [e["code"] for e in degrades] == ["over_budget"] * 2
    assert {e["node"] for e in degrades} == {"TorchMeshAggregateExec",
                                             "TorchMeshSortExec"}


def test_wedged_exchange_degrades_under_the_watchdog():
    conf = {**ICI, "spark.rapids.faults.shuffle.ici.hang": "count:1",
            "spark.rapids.sql.watchdog.hangTimeoutMs": "300"}
    ts = _run_both(_agg_sort(_table(1000)), conf, ignore_order=False)
    assert _metric(ts, "iciFallbacks") == 1
    assert meshexec.ici_stats()["fallbacks_hang"] == 1


def test_device_oom_degrades_and_other_errors_surface(monkeypatch):
    import torch
    from spark_rapids_tpu_torch.parallel import distagg
    t = _table(1000)

    def boom(exc):
        def run_sharded(self, *a, **k):
            raise exc
        return run_sharded
    monkeypatch.setattr(distagg.DistributedAggregate, "run_sharded",
                        boom(torch.cuda.OutOfMemoryError("out of memory")))
    want = _agg_sort(t)(_tsession(), TF, st.col).to_arrow()
    ts = _tsession(ICI)
    got = _agg_sort(t)(ts, TF, st.col).to_arrow()
    assert got.equals(want)
    assert meshexec.ici_stats()["fallbacks_oom"] == 1
    monkeypatch.setattr(distagg.DistributedAggregate, "run_sharded",
                        boom(RuntimeError("a real bug")))
    with pytest.raises(RuntimeError, match="a real bug"):
        _agg_sort(t)(_tsession(ICI), TF, st.col).to_arrow()
    # the static lowering never degrades
    monkeypatch.setattr(distagg.DistributedAggregate, "run_sharded",
                        boom(torch.cuda.OutOfMemoryError("out of memory")))
    with pytest.raises(torch.cuda.OutOfMemoryError):
        _agg_sort(t)(_tsession({"spark.rapids.sql.mesh.devices": 8}), TF,
                     st.col).to_arrow()


# -- keys of later slices ---------------------------------------------------------

@pytest.mark.parametrize("key,queue", [
    ("spark.rapids.shuffle.ici.shardedScan.enabled", "A8b-2"),
    ("spark.rapids.sql.ooc.enabled", "A8b-2"),
    ("spark.rapids.health.enabled", "A8c"),
])
@pytest.mark.parametrize("mode", [ICI, {"spark.rapids.sql.mesh.devices": 8}],
                         ids=["ici", "mesh"])
def test_keys_of_later_slices_raise_on_a_mesh_plan(key, queue, mode):
    build = _agg_sort(_table(200))
    ts = _tsession({**mode, key: "true"})
    with pytest.raises(MeshNotPortedError, match=queue):
        build(ts, TF, st.col).to_arrow()
    # no mesh fragment, nothing to refuse
    plain = _tsession({key: "true"})
    assert build(plain, TF, st.col).to_arrow().num_rows == 37


def test_registry_has_an_ici_section():
    from spark_rapids_tpu.exec import meshexec as jmeshexec
    from spark_rapids_tpu_torch.obs import registry
    snap = registry.snapshot()["ici"]
    # the counters only A8b-2 and A8c move wait with them
    want = set(jmeshexec.ici_stats()) - {
        "sharded", "fallbacks_width", "fallbacks_ingest", "gather_pulls",
        "gather_overlap_ms"}
    assert set(snap) == want
