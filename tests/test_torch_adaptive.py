"""The torch port's adaptive query execution against the JAX package's.

Mirrors the in-process tests of ``tests/test_adaptive.py``: the same
Arrow tables (``tests/fuzzer.py``) go through a JAX session and a port
session on the CPU with ``spark.rapids.sql.adaptive.enabled`` on and
off; the results compare through ``assert_tables_equal``, and the
port's replan decisions (each pass's report: the decision, the
partition bytes before and the group bytes after, coalesced partitions,
skew splits, a fallback) and metric sums (``aqeReplans``,
``broadcastPromotions``, ``broadcastDemotions``, ``coalescedPartitions``,
``skewSplits``, ``shufflePartitionBytes``) must equal the JAX
package's.  Also: ``greedy_partition_groups`` against the JAX package's
over seeded random partition lists, the two byte estimators over every
dtype, the default-partitions rule, the stages' handles closed after a
query (also one that stops early), the ``plan.aqe`` profiler range, the
journal's events and the registry's ``aqe`` section.  The five
host-shuffle tests of ``tests/test_adaptive.py`` have no counterpart
(the host shuffle is queue A8); the skew fixture is eight numpy slices
of ``gen_skewed_table`` under a union, in both packages, instead of
parquet files.
"""

import json
import os

import numpy as np
import pyarrow as pa
import pytest

from spark_rapids_tpu import faults as jfaults
from spark_rapids_tpu.conf import TpuConf
from spark_rapids_tpu.plan import adaptive as jadaptive
from tests.compare import assert_tables_equal, sum_plan_metric, tpu_session
from tests.fuzzer import gen_skewed_table, gen_table

import spark_rapids_tpu_torch as st
from spark_rapids_tpu_torch import faults
from spark_rapids_tpu_torch.conf import TorchConf
from spark_rapids_tpu_torch.exec import aqe
from spark_rapids_tpu_torch.plan import adaptive
from spark_rapids_tpu_torch.plan.planner import plan_query
from tests.torch_threads import _one_torch_thread  # noqa: F401

AQE_ON = {"spark.rapids.sql.adaptive.enabled": "true"}
CPU = {"spark.rapids.torch.device": "cpu"}
METRICS = ("aqeReplans", "broadcastPromotions", "broadcastDemotions",
           "coalescedPartitions", "skewSplits", "shufflePartitionBytes")


@pytest.fixture(autouse=True)
def _reset_injectors():
    faults.reset()
    jfaults.reset()
    yield
    faults.reset()
    jfaults.reset()


def tsession(extra=None):
    return st.TorchSession({**CPU, **(extra or {})})


def _walk(plan):
    yield plan
    for c in plan.children:
        yield from _walk(c)


def tsum(session, name: str) -> int:
    return sum(n.metrics.get(name, 0) for n in _walk(session._last_plan))


def tcount(plan, cls_name: str) -> int:
    return sum(type(n).__name__ == cls_name for n in _walk(plan))


def _decisions(reports):
    """A replan report without the fallback's message (the two packages
    word their errors differently)."""
    keys = ("changed", "decision", "coalesced", "skew_splits",
            "partition_bytes", "group_bytes")
    return [{**{k: r.get(k) for k in keys}, "fallback": "fallback" in r}
            for r in reports]


def assert_same_decisions(ts, js):
    """The port's adaptive wrapper made the JAX package's decisions and
    counted the same metrics."""
    tw = adaptive.find_adaptive(ts._last_plan)
    jw = jadaptive.find_adaptive(js._last_plan_result.physical)
    assert (tw is None) == (jw is None)
    if tw is not None:
        assert _decisions(tw.reports) == _decisions(jw.reports)
    for m in METRICS:
        assert tsum(ts, m) == sum_plan_metric(js, m), m
    return tw, jw


def _join_tables():
    left = gen_table(7, [("k", pa.int64()), ("v", pa.float64())], 500,
                     null_prob=0.05)
    right = gen_table(8, [("k", pa.int64()), ("w", pa.int32())], 200,
                      null_prob=0.0)
    return left, right


def _build_join(s, left, right):
    return s.create_dataframe(left).join(s.create_dataframe(right), on="k")


def run_join(extra, left, right):
    """The join through both packages -> (port table, port session, JAX
    table, JAX session)."""
    ts, js = tsession(extra), tpu_session(dict(extra))
    return (_build_join(ts, left, right).to_arrow(), ts,
            _build_join(js, left, right).to_arrow(), js)


# -- off == static ----------------------------------------------------------

def test_adaptive_off_plans_have_no_aqe_nodes():
    left, right = _join_tables()
    t, ts, j, js = run_join({}, left, right)
    assert_tables_equal(t, j)
    plan = ts._last_plan
    assert adaptive.find_adaptive(plan) is None
    assert tcount(plan, "TorchQueryStageExec") == 0
    assert not any(getattr(n, "aqe_inserted", False) for n in _walk(plan))
    # the static strategy: the small right side broadcasts, in both
    assert tcount(plan, "TorchBroadcastHashJoinExec") == 1
    assert "TpuBroadcastHashJoin" in js._last_plan_result.physical \
        .tree_string()
    # the off conf plans exactly the tree an unset one does
    left_df = tsession({"spark.rapids.sql.adaptive.enabled": "false"})
    off = plan_query(_build_join(left_df, left, right).plan,
                     left_df.conf)
    unset = plan_query(_build_join(ts, left, right).plan, ts.conf)
    assert [type(n).__name__ for n in _walk(off)] == \
        [type(n).__name__ for n in _walk(unset)]


@pytest.mark.parametrize("extra", [{}, {
    "spark.sql.autoBroadcastJoinThreshold": -1}], ids=["bcast", "nobcast"])
def test_adaptive_on_matches_off_results(extra):
    left, right = _join_tables()
    t_off, _, _, _ = run_join(dict(extra), left, right)
    t_on, ts, j_on, js = run_join({**AQE_ON, **extra}, left, right)
    assert_tables_equal(t_on, t_off)
    assert_tables_equal(t_on, j_on)
    assert_same_decisions(ts, js)


# -- broadcast promotion and demotion --------------------------------------

def test_broadcast_promotion_reuses_stage_and_elides_stream_shuffle():
    left, right = _join_tables()
    t, ts, j, js = run_join(dict(AQE_ON), left, right)
    assert_tables_equal(t, j)
    tw, _ = assert_same_decisions(ts, js)
    assert tsum(ts, "aqeReplans") >= 1
    assert tsum(ts, "broadcastPromotions") == 1
    body = tw.children[0]
    assert tcount(body, "TorchBroadcastHashJoinExec") == 1
    # one exchange survives (the build stage's); the stream side was
    # never shuffled
    assert tcount(body, "TorchShuffleExchangeExec") == 1
    assert any(r.get("decision") == "broadcast_promoted"
               for r in tw.reports)


def test_broadcast_promotion_left_side_swaps_build():
    small = gen_table(9, [("k", pa.int64()), ("v", pa.float64())], 60,
                      null_prob=0.0)
    big = gen_table(10, [("k", pa.int64()), ("w", pa.int32())], 2_000,
                    null_prob=0.0)
    conf = {"spark.sql.autoBroadcastJoinThreshold": 4_000}
    t, ts, j, js = run_join({**AQE_ON, **conf}, small, big)
    tw, _ = assert_same_decisions(ts, js)
    assert tsum(ts, "broadcastPromotions") == 1
    body = tw.children[0]
    (join,) = [n for n in _walk(body)
               if type(n).__name__ == "TorchBroadcastHashJoinExec"]
    # the mirrored join streams the right side against the left stage
    assert type(join.children[1].children[0]).__name__ == \
        "TorchQueryStageExec"
    assert join.children[1].output_schema.names == ["k", "v"]
    t_off, _, _, _ = run_join(conf, small, big)
    assert_tables_equal(t, t_off)
    assert_tables_equal(t, j)


def test_broadcast_demotion_overrides_static_guess():
    left, right = _join_tables()
    thresh = (right.nbytes + 2800) // 2
    assert right.nbytes <= thresh < 2800
    conf = {"spark.sql.autoBroadcastJoinThreshold": thresh}
    t, ts, j, js = run_join({**AQE_ON, **conf}, left, right)
    tw, _ = assert_same_decisions(ts, js)
    assert tsum(ts, "broadcastDemotions") == 1
    assert tcount(tw.children[0], "TorchBroadcastHashJoinExec") == 0
    t_off, _, _, _ = run_join(conf, left, right)
    assert_tables_equal(t, t_off)
    assert_tables_equal(t, j)


# -- partition coalescing ---------------------------------------------------

def test_tiny_exchange_coalesces_below_default_partitions():
    left, right = _join_tables()
    nparts = 8
    t, ts, j, js = run_join({
        **AQE_ON, "spark.rapids.shuffle.defaultNumPartitions": nparts,
        "spark.sql.autoBroadcastJoinThreshold": -1}, left, right)
    assert_tables_equal(t, j)
    tw, _ = assert_same_decisions(ts, js)
    assert tsum(ts, "coalescedPartitions") > 0
    for rep in tw.reports:
        assert rep.get("group_bytes") is not None
        assert len(rep["group_bytes"]) < nparts, rep
    assert tsum(ts, "aqeReplans") >= 1


@pytest.mark.parametrize("min_parts", [1, 3, 6])
def test_min_partition_num_matches_jax(min_parts):
    """``coalescePartitions.minPartitionNum`` re-targets the merge so at
    least that many groups remain, as in the JAX package."""
    left, right = _join_tables()
    t, ts, j, js = run_join({
        **AQE_ON, "spark.sql.autoBroadcastJoinThreshold": -1,
        "spark.rapids.sql.adaptive.coalescePartitions.minPartitionNum":
            min_parts}, left, right)
    assert_tables_equal(t, j)
    tw, _ = assert_same_decisions(ts, js)
    for rep in tw.reports:
        nonempty = sum(1 for b in rep["partition_bytes"] if b > 0)
        # no group spec: the stage kept one group a partition
        groups = len(rep.get("group_bytes") or [0] * nonempty)
        assert groups >= min(min_parts, nonempty)


def test_coalescing_respects_user_repartition():
    left, _ = _join_tables()

    def build(s):
        return s.create_dataframe(left).repartition(6, "k")

    ts, js = tsession(AQE_ON), tpu_session(dict(AQE_ON))
    out = build(ts).to_arrow()
    assert out.num_rows == left.num_rows
    assert_tables_equal(out, build(js).to_arrow())
    tw, _ = assert_same_decisions(ts, js)
    assert tw is not None and len(tw.reports) == 1
    assert tsum(ts, "coalescedPartitions") == 0
    assert tsum(ts, "aqeReplans") == 0


def test_coalescing_conf_gate():
    left, right = _join_tables()
    t, ts, j, js = run_join({
        **AQE_ON, "spark.sql.autoBroadcastJoinThreshold": -1,
        "spark.rapids.sql.adaptive.coalescePartitions.enabled": "false"},
        left, right)
    assert_tables_equal(t, j)
    assert_same_decisions(ts, js)
    assert tsum(ts, "coalescedPartitions") == 0


# -- skew splits ------------------------------------------------------------

SKEW_CONF = {
    "spark.sql.autoBroadcastJoinThreshold": -1,
    "spark.rapids.sql.adaptive.advisoryPartitionSizeInBytes": "16384",
    "spark.rapids.sql.adaptive.skewJoin."
    "skewedPartitionThresholdInBytes": "8192",
    "spark.rapids.sql.adaptive.skewJoin.skewedPartitionFactor": "2",
}
SKEW_SLICES = 8


@pytest.fixture(scope="module")
def skew_slices():
    """The zipf fixture of ``tests/test_adaptive.py`` as eight numpy
    slices (views of one array each), so the fact side arrives in eight
    batches: the pieces a skew split regroups."""
    tbl = gen_skewed_table(11, 20_000, n_keys=16, zipf_a=1.6)
    cols = {c: tbl.column(c).to_numpy() for c in tbl.column_names}
    rows = tbl.num_rows // SKEW_SLICES
    return [{c: a[i * rows:(i + 1) * rows] for c, a in cols.items()}
            for i in range(SKEW_SLICES)]


def _dim():
    return {"k": np.arange(16, dtype=np.int64),
            "name": np.array([f"n{i}" for i in range(16)], dtype=object)}


def _skewed_fact(s, slices, torch_side: bool):
    def frame(d):
        return s.create_dataframe(d if torch_side else pa.table(d))
    df = frame(slices[0])
    for d in slices[1:]:
        df = df.union(frame(d))
    return df


def _skew_join(s, slices, torch_side: bool):
    dim = s.create_dataframe(_dim() if torch_side else pa.table(_dim()))
    return _skewed_fact(s, slices, torch_side).join(dim, on="k")


def run_skew_join(extra, slices):
    ts, js = tsession(extra), tpu_session(dict(extra))
    return (_skew_join(ts, slices, True).to_arrow(), ts,
            _skew_join(js, slices, False).to_arrow(), js)


def test_unsplit_skew_baseline_static_plan(skew_slices):
    """Without adaptive execution the hot key's partition is at least
    skewedPartitionFactor x the median: the fixture is skewed."""
    s = tsession(SKEW_CONF)
    _skewed_fact(s, skew_slices, True).repartition(8, "k").to_arrow()
    (ex,) = [n for n in _walk(s._last_plan)
             if type(n).__name__ == "TorchShuffleExchangeExec"]
    sizes = [b for b in ex.last_partition_bytes if b > 0]
    median = sorted(sizes)[len(sizes) // 2]
    factor = int(SKEW_CONF[
        "spark.rapids.sql.adaptive.skewJoin.skewedPartitionFactor"])
    assert max(sizes) >= factor * median
    js = tpu_session(dict(SKEW_CONF))
    _skewed_fact(js, skew_slices, False).repartition(8, "k").to_arrow()
    assert tsum(s, "shufflePartitionBytes") == \
        sum_plan_metric(js, "shufflePartitionBytes")


def test_skew_split_bounds_partition_bytes(skew_slices):
    t, ts, j, js = run_skew_join({**AQE_ON, **SKEW_CONF}, skew_slices)
    tw, _ = assert_same_decisions(ts, js)
    assert tsum(ts, "skewSplits") > 0
    stream = [r for r in tw.reports if r.get("decision") == "stream_side"]
    assert stream, tw.reports
    rep = stream[0]
    sizes = [b for b in rep["partition_bytes"] if b > 0]
    median = sorted(sizes)[len(sizes) // 2]
    assert max(sizes) >= 2 * median
    assert max(rep["group_bytes"]) <= 2 * median, rep
    t_off, _, _, _ = run_skew_join(dict(SKEW_CONF), skew_slices)
    assert_tables_equal(t, t_off)
    assert_tables_equal(t, j)


def test_skew_split_conf_gate(skew_slices):
    t, ts, j, js = run_skew_join({
        **AQE_ON, **SKEW_CONF,
        "spark.rapids.sql.adaptive.skewJoin.enabled": "false"}, skew_slices)
    assert_same_decisions(ts, js)
    assert tsum(ts, "skewSplits") == 0
    assert_tables_equal(t, j)


# -- the replan fault -------------------------------------------------------

@pytest.mark.faults
def test_replan_fault_falls_back_to_static_plan(aqe_fault_conf):
    """An injected ``aqe.replan`` failure changes nothing but the
    replan: every report is a fallback, aqeReplans stays 0, the join
    stays shuffled and the result is right, in both packages."""
    left, right = _join_tables()
    faults.configure_from_conf(aqe_fault_conf)
    jfaults.configure_from_conf(aqe_fault_conf)
    t, ts, j, js = run_join(dict(aqe_fault_conf), left, right)
    assert faults.injector().stats()["aqe.replan"]["fired"] == \
        jfaults.injector().stats()["aqe.replan"]["fired"] > 0
    tw, _ = assert_same_decisions(ts, js)
    assert tw.reports and all("fallback" in r for r in tw.reports)
    assert tsum(ts, "aqeReplans") == 0
    assert tsum(ts, "broadcastPromotions") == 0
    assert tcount(tw.children[0], "TorchBroadcastHashJoinExec") == 0
    faults.reset()
    jfaults.reset()
    t_off, _, _, _ = run_join({}, left, right)
    assert_tables_equal(t, t_off)
    assert_tables_equal(t, j)


# -- the default-partitions conf --------------------------------------------

@pytest.mark.parametrize("settings", [
    {}, {"spark.sql.shuffle.partitions": 5},
    {"spark.rapids.shuffle.defaultNumPartitions": 3},
    {"spark.sql.shuffle.partitions": 5,
     "spark.rapids.shuffle.defaultNumPartitions": 11}])
def test_default_num_partitions_conf(settings):
    """``aqe_initial_partitions``: defaultNumPartitions when set, else
    spark.sql.shuffle.partitions (8), as in the JAX package; the AQE join
    exchanges take it."""
    want = TpuConf(dict(settings)).aqe_initial_partitions
    assert TorchConf(dict(settings)).aqe_initial_partitions == want
    left, right = _join_tables()
    s = tsession({**AQE_ON, **settings,
                  "spark.sql.autoBroadcastJoinThreshold": -1})
    plan = plan_query(_build_join(s, left, right).plan, s.conf)
    exchanges = [n for n in _walk(plan)
                 if type(n).__name__ == "TorchShuffleExchangeExec"]
    assert len(exchanges) == 2
    assert all(e.aqe_inserted and e.num_partitions == want
               for e in exchanges)


def test_default_partitions_conf_validates():
    with pytest.raises(ValueError):
        TorchConf({"spark.rapids.shuffle.defaultNumPartitions": -1})
    with pytest.raises(ValueError):
        TorchConf({"spark.sql.shuffle.partitions": 0})


# -- non-join consumers -----------------------------------------------------

def test_adaptive_aggregate_over_repartition_matches_off():
    tbl = gen_skewed_table(13, 3_000, n_keys=12)

    def build(s):
        return s.create_dataframe(tbl).repartition(6, "k") \
            .group_by("k").agg()

    ts = tsession(AQE_ON)
    t_on = build(ts).to_arrow()
    t_off = build(tsession()).to_arrow()
    js = tpu_session(dict(AQE_ON))
    assert_tables_equal(t_on, t_off)
    assert_tables_equal(t_on, build(js).to_arrow())
    assert_same_decisions(ts, js)


# -- the sizing policy and the byte estimators ------------------------------

class _Conf:
    """The five keys the policy reads, under both packages' names."""

    def __init__(self, advisory, factor, threshold, coalesce, skew):
        self.settings = {
            "spark.rapids.sql.adaptive.advisoryPartitionSizeInBytes":
                advisory,
            "spark.rapids.sql.adaptive.skewJoin.skewedPartitionFactor":
                factor,
            "spark.rapids.sql.adaptive.skewJoin."
            "skewedPartitionThresholdInBytes": threshold,
            "spark.rapids.sql.adaptive.coalescePartitions.enabled":
                coalesce,
            "spark.rapids.sql.adaptive.skewJoin.enabled": skew}


@pytest.mark.parametrize("seed", range(12))
def test_greedy_partition_groups_matches_jax(seed):
    rng = np.random.default_rng(seed)
    nparts = int(rng.integers(1, 40))
    parts = []
    for pid in range(nparts):
        if rng.random() < 0.2:
            continue  # an empty partition
        pieces = [int(x) for x in rng.integers(
            1, 5_000, int(rng.integers(1, 9)))]
        if rng.random() < 0.15:
            pieces = [p * 50 for p in pieces]  # a hot partition
        parts.append((pid, sum(pieces), pieces))
    conf = _Conf(int(rng.integers(2_000, 60_000)), int(rng.integers(1, 6)),
                 int(rng.integers(1, 100_000)), bool(rng.random() < 0.8),
                 bool(rng.random() < 0.8)).settings
    tconf, jconf = TorchConf(conf), TpuConf(conf)
    total = sum(p[1] for p in parts)
    for allow_skew in (False, True):
        for merge in (None, max(1, total // 3)):
            stat = [p[1] for p in parts] if seed % 2 else None
            got = adaptive.greedy_partition_groups(
                parts, tconf, allow_skew, stat_sizes=stat,
                merge_target=merge)
            want = jadaptive.greedy_partition_groups(
                parts, jconf, allow_skew, stat_sizes=stat,
                merge_target=merge)
            assert got == want


def _dtype_table(n: int = 77) -> pa.Table:
    """One column of every dtype the port stores, with nulls."""
    import datetime as dt
    rng = np.random.default_rng(5)
    mask = rng.random(n) < 0.1

    def arr(values, t):
        return pa.array([None if m else v for v, m in zip(values, mask)],
                        t)
    return pa.table({
        "b": arr(rng.random(n) < 0.5, pa.bool_()),
        "i8": arr(rng.integers(-100, 100, n), pa.int8()),
        "i16": arr(rng.integers(-1000, 1000, n), pa.int16()),
        "i32": arr(rng.integers(-10**6, 10**6, n), pa.int32()),
        "i64": arr(rng.integers(-10**12, 10**12, n), pa.int64()),
        "f32": arr(rng.normal(size=n), pa.float32()),
        "f64": arr(rng.normal(size=n), pa.float64()),
        "d": arr([dt.date(2020, 1, 1) + dt.timedelta(days=int(x))
                  for x in rng.integers(0, 900, n)], pa.date32()),
        "ts": arr([dt.datetime(2021, 3, 4) + dt.timedelta(seconds=int(x))
                   for x in rng.integers(0, 10**6, n)],
                  pa.timestamp("us", tz="UTC")),
        "s": arr([("x" * int(x)) for x in rng.integers(0, 30, n)],
                 pa.string()),
    })


@pytest.mark.parametrize("col", ["b", "i8", "i16", "i32", "i64", "f32",
                                 "f64", "d", "ts", "s"])
def test_byte_estimators_agree_on_every_dtype(col):
    """The port's ``est_batch_bytes`` (element size) and the JAX
    package's (dtype byte width) give the same bytes for the same
    column, alone and after a partition step."""
    from spark_rapids_tpu.columnar.batch import host_batch_to_device as jup
    from spark_rapids_tpu.columnar.dtypes import Schema as JSchema
    from spark_rapids_tpu.exec.aqe import est_batch_bytes as jest
    from spark_rapids_tpu_torch.exec.exchange import est_batch_bytes
    tbl = _dtype_table().select([col])
    jb = jup(tbl.to_batches()[0], JSchema.from_arrow(tbl.schema))
    from spark_rapids_tpu_torch.exec.base import ExecContext
    s = tsession()
    plan = plan_query(s.create_dataframe(tbl).plan, s.conf)
    (tb,) = list(plan.execute(ExecContext(s.conf, s.device, s.runtime)))
    assert est_batch_bytes(tb) == jest(jb)
    # and through a hash exchange's pieces, in both packages
    ts, js = tsession(), tpu_session()
    ts.create_dataframe(tbl).repartition(4, col).to_arrow()
    js.create_dataframe(tbl).repartition(4, col).to_arrow()
    (tex,) = [n for n in _walk(ts._last_plan)
              if type(n).__name__ == "TorchShuffleExchangeExec"]
    jex = [n for n in _walk(js._last_plan_result.physical)
           if getattr(n, "last_partition_bytes", None) is not None]
    assert tex.last_partition_bytes == jex[0].last_partition_bytes


# -- lifetime, profiler range, journal, registry ----------------------------

def test_stage_handles_are_closed_after_the_query():
    left, right = _join_tables()
    s = tsession({**AQE_ON, "spark.sql.autoBroadcastJoinThreshold": -1})
    cat = s.runtime.catalog
    before = (cat.device_bytes, cat.audit_leaks(), cat.leak_count)
    _build_join(s, left, right).to_arrow()
    assert (cat.device_bytes, cat.audit_leaks(), cat.leak_count) == before
    # a consumer that stops early (a limit) closes the stages too
    _build_join(s, left, right).limit(3).to_arrow()
    assert (cat.device_bytes, cat.audit_leaks(), cat.leak_count) == before
    for stage in (n for n in _walk(s._last_plan)
                  if type(n).__name__ == "TorchQueryStageExec"):
        assert stage.buckets == []


def test_stage_handles_are_closed_when_the_query_fails(monkeypatch):
    from spark_rapids_tpu_torch.exec import joins
    left, right = _join_tables()
    s = tsession({**AQE_ON, "spark.sql.autoBroadcastJoinThreshold": -1})
    cat = s.runtime.catalog
    before = (cat.device_bytes, cat.audit_leaks())

    def boom(self, ctx, b_batch):
        raise RuntimeError("join failed")
        yield  # a generator, as the real one

    monkeypatch.setattr(joins.TorchHashJoinExec, "_join", boom)
    with pytest.raises(RuntimeError, match="join failed"):
        _build_join(s, left, right).to_arrow()
    assert (cat.device_bytes, cat.audit_leaks()) == before


def test_replan_runs_inside_the_plan_aqe_range():
    from torch.profiler import ProfilerActivity, profile
    left, right = _join_tables()
    s = tsession(AQE_ON)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _build_join(s, left, right).to_arrow()
    names = {e.key for e in prof.key_averages()}
    assert aqe.RANGE_PLAN_AQE in names
    assert "exchange.partition" in names


def test_journal_and_registry_record_the_replans(tmp_path):
    from spark_rapids_tpu_torch.obs import journal, registry
    left, right = _join_tables()
    aqe.reset_stats()
    s = tsession({**AQE_ON,
                  "spark.rapids.sql.obs.journalDir": str(tmp_path)})
    try:
        journal.configure(str(tmp_path))
        _build_join(s, left, right).to_arrow()
        path = journal.stats().get("path") or os.path.join(
            str(tmp_path), f"events-{os.getpid()}.jsonl")
    finally:
        journal.configure("")
    events = [json.loads(ln) for ln in open(path)]
    kinds = [e["event"] for e in events]
    assert "stage_materialize" in kinds
    (rep,) = [e for e in events if e["event"] == "aqe_replan"]
    assert rep["decision"] == "broadcast_promoted" and rep["changed"]
    snap = registry.snapshot()["aqe"]
    assert snap["replans"] == 1 and snap["broadcast_promotions"] == 1
    assert snap["exchanges"] == 1 and snap["max_partition_bytes"] > 0
    assert "spark_rapids_tpu_aqe_replans 1" in registry.prometheus_text()


# -- the TPC-H queries of the card's adaptive phase --------------------------

@pytest.fixture(scope="module")
def tpch_4000():
    from spark_rapids_tpu_torch.bench.tpch import gen_tpch_numpy
    return gen_tpch_numpy(4000)


@pytest.mark.parametrize("qname", ["q3", "q5", "q8", "q10", "q13", "q18"])
def test_tpch_adaptive_matches_jax(tpch_4000, qname):
    """The queries chip_smoke's adaptive phase runs, at 4,000 lineitem
    rows: adaptive on equals off, equals the JAX package's adaptive run,
    and every replan decision and metric is the JAX package's."""
    from spark_rapids_tpu.bench.tpch import TPCH_QUERIES as JQ
    from spark_rapids_tpu_torch.bench.tpch import TPCH_QUERIES as TQ
    from spark_rapids_tpu_torch.bench.tpch import load_tables
    ts, ts_off = tsession(AQE_ON), tsession()
    got = TQ[qname](load_tables(ts, tpch_4000)).to_arrow()
    off = TQ[qname](load_tables(ts_off, tpch_4000)).to_arrow()
    assert_tables_equal(got, off, ignore_order=False, approx_float=True)
    js = tpu_session(dict(AQE_ON))
    want = JQ[qname]({name: js.create_dataframe(pa.table(cols))
                      for name, cols in tpch_4000.items()}).to_arrow()
    assert_tables_equal(got, want, ignore_order=False, approx_float=True)
    tw, _ = assert_same_decisions(ts, js)
    assert tw is not None and tw.reports


def test_stage_bytes_count_toward_the_query_budget():
    """The stages' handles are the query's own: under a per-query device
    budget below the query's catalog peak (14,976 bytes without one, on
    this input) they spill to the host (budget spills counted) and the
    result is still the static one."""
    from spark_rapids_tpu_torch.runtime import TorchRuntime
    left, right = _join_tables()
    conf = {"spark.sql.autoBroadcastJoinThreshold": -1}
    want = _build_join(tsession(conf), left, right).to_arrow()
    TorchRuntime.reset()
    try:
        s = tsession({**AQE_ON, **conf,
                      "spark.rapids.server.query.maxDeviceBytes": 12_000})
        cat = s.runtime.catalog
        got = _build_join(s, left, right).to_arrow()
        assert cat.budget_spill_count > 0
        assert cat.budget_exceeded_count == 0
        assert cat.audit_leaks() == 0 and cat.device_bytes == 0
    finally:
        TorchRuntime.reset()
    assert_tables_equal(got, want)
