"""The torch port's serving fleet against the JAX package.

Analogs of the 14 tests of ``tests/test_fleet.py``, with the fleet on
``cpu``: R = 2 replica processes (spawned, each with its own
``TorchSession`` and server), every result held against the JAX
session's serial result of the same SQL over the same parquet files,
row for row (integer-valued floats, so sums are exact); replica
SIGKILL with every ticket right or typed; failover through the injected
``replica.fail`` site; attempt and budget exhaustion typed; a rolling
restart with no rejection; the fleet fault sites from conf with ``@r``
targeting; the disk result tier across replica processes; and the
replica health state machine, held against the JAX package's tracker
on the same outcome sequences.  Two tests of the port's own: a replica
on ``cuda`` without a card dies at boot, and its stats carry its own
kernel launches and process.

Replica processes are real, so boots cost seconds: the tests after the
fault test share one module-scoped fleet, ordered so the destructive
ones run last, each handing the fleet back healthy.  Every wait is
bounded.  A replica is held in flight with the replica-side
``replica.slow`` hold (``fleet/replica.py: SLOW_HOLD_S``), never with
a sleep race: the kill follows the dispatch while the replica holds.
"""

import glob
import json
import os
import pickle
import signal
import threading
import time
from types import SimpleNamespace

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from spark_rapids_tpu.fleet import ReplicaHealthTracker as JTracker
from tests.compare import tpu_session

import spark_rapids_tpu_torch as st
from spark_rapids_tpu_torch import faults
from spark_rapids_tpu_torch.conf import TorchConf
from spark_rapids_tpu_torch.errors import EngineError, ReplicaFailedError, \
    RetryBudgetExhaustedError
from spark_rapids_tpu_torch.faults import InjectedFault
from spark_rapids_tpu_torch.fleet import FleetRouter, ReplicaHealthTracker
from spark_rapids_tpu_torch.fleet import stats as fleet_stats
from spark_rapids_tpu_torch.fleet.health import OUTCOME_FAIL, OUTCOME_SLOW, \
    OUTCOME_SUCCESS
from spark_rapids_tpu_torch.obs import journal
from spark_rapids_tpu_torch.server.result_cache import DiskResultTier, \
    ResultCache
from tests.torch_threads import _one_torch_thread  # noqa: F401

WAIT_S = 120  # the bound on any one result

TEMPLATES = {
    "project_filter":
        "SELECT k, v * 2 AS dv, w FROM fact WHERE v > 0 AND w < 40",
    "groupby":
        "SELECT k, SUM(v) AS sv, COUNT(*) AS c FROM fact GROUP BY k",
    "sort_limit":
        "SELECT k, v FROM fact ORDER BY v DESC, k LIMIT 50",
}


def _port_conf(extra=None):
    return {"spark.rapids.torch.device": "cpu", **(extra or {})}


@pytest.fixture(scope="module")
def fleet_data(tmp_path_factory):
    """A fact table in two parquet files, integer-valued floats."""
    d = tmp_path_factory.mktemp("fleet")
    rng = np.random.default_rng(99)
    fact = d / "fact"
    fact.mkdir()
    for i in range(2):
        n = 800
        pq.write_table(pa.table({
            "k": pa.array(rng.integers(0, 20, n), pa.int64()),
            "v": pa.array(rng.integers(-400, 400, n).astype(np.float64)),
            "w": pa.array(rng.integers(0, 50, n), pa.int64()),
        }), str(fact / f"part-{i}.parquet"))
    return str(fact)


def _rows(table: pa.Table):
    return sorted(
        map(tuple, (r.values() for r in table.to_pylist())),
        key=lambda t: tuple((x is None, str(x)) for x in t))


def _frows(result):
    """A fleet result's rows (a ``HostResult``), as ``_rows`` reads a
    table."""
    return _rows(result.to_arrow())


@pytest.fixture(scope="module")
def oracle(fleet_data):
    """The JAX session's serial results."""
    s = tpu_session()
    s.read.parquet(fleet_data).create_or_replace_temp_view("fact")
    return {name: _rows(s.sql(q).to_arrow())
            for name, q in TEMPLATES.items()}


def _boot(fleet_data, extra=None):
    s = st.TorchSession(_port_conf({"spark.rapids.fleet.replicas": 2,
                                    **(extra or {})}))
    fleet = s.fleet()
    fleet.register_parquet_view("fact", fleet_data)
    return s, fleet


@pytest.fixture(scope="module")
def shared_fleet(fleet_data, oracle, tmp_path_factory):
    """The one R = 2 fleet the tests below share, in file order, with
    the disk result tier, tight heartbeats and short probation;
    teardown checks that the router closed."""
    base = tmp_path_factory.mktemp("shared_fleet")
    s, fleet = _boot(fleet_data, {
        "spark.rapids.fleet.heartbeat.intervalMs": 100,
        "spark.rapids.fleet.heartbeat.timeoutMs": 5000,
        "spark.rapids.fleet.health.probationMs": 500,
        "spark.rapids.fleet.retry.budgetPerMin": 100,
        "spark.rapids.fleet.resultCache.dir": str(base / "results"),
    })
    yield s, fleet
    s.stop()
    assert fleet.closed


def _wait_healthy(fleet, deadline_s=60.0):
    end = time.monotonic() + deadline_s
    while time.monotonic() < end:
        snap = fleet.health_snapshot()
        if not snap["quarantined"] and not snap["dead"]:
            return
        time.sleep(0.1)
    raise AssertionError(f"fleet did not recover: {fleet.health_snapshot()}")


# -- the gate, with no fleet -------------------------------------------------

def test_fleet_requires_conf_and_keys_are_result_neutral():
    s = st.TorchSession(_port_conf())
    with pytest.raises(RuntimeError, match="fleet.replicas"):
        s.fleet()
    from spark_rapids_tpu_torch.plan.fingerprint import conf_fingerprint
    base = TorchConf(_port_conf())
    fleeted = TorchConf(_port_conf({
        "spark.rapids.fleet.replicas": 3,
        "spark.rapids.fleet.routing.queueDepth": 4,
        "spark.rapids.fleet.heartbeat.intervalMs": 10}))
    assert conf_fingerprint(base) == conf_fingerprint(fleeted)


def test_cuda_replica_without_a_card_dies_at_boot():
    """The replica runs on the conf's device; on ``cuda`` without a card
    its session raises at boot, and the router fails typed instead of
    serving from the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    conf = TorchConf({"spark.rapids.torch.device": "cuda",
                      "spark.rapids.fleet.replicas": 1,
                      "spark.rapids.fleet.startupTimeoutMs": 60000})
    with pytest.raises(ReplicaFailedError, match="died during startup"):
        FleetRouter(SimpleNamespace(conf=conf))


# -- the fault sites from conf (a fleet of its own) --------------------------

@pytest.mark.faults
def test_fleet_fault_sites_fire_from_conf_with_r_targeting(
        fleet_data, fault_seed):
    s, fleet = _boot(fleet_data, {
        "spark.rapids.faults.seed": str(fault_seed),
        "spark.rapids.faults.fleet.route": "count:1",
        "spark.rapids.faults.replica.slow": "always@r1",
        "spark.rapids.fleet.retry.budgetPerMin": 0,
    })
    try:
        before = fleet_stats.global_stats()
        with pytest.raises(InjectedFault):
            fleet.submit("SELECT COUNT(*) AS c FROM fact")
        for _ in range(4):
            assert fleet.submit("SELECT COUNT(*) AS c FROM fact").result(
                timeout=WAIT_S).num_rows == 1
        after = fleet_stats.global_stats()
        assert after["route_faults"] >= before["route_faults"] + 1
        assert after["replica_slow_faults"] \
            >= before["replica_slow_faults"] + 1
        snap = fleet.health_snapshot()
        assert snap["scores"][1] < snap["scores"][0]
        streams = faults.injector().stats()
        assert streams.get("replica.slow@r1", {}).get("fired", 0) >= 1
        assert streams.get("replica.slow@r0", {}).get("fired", 0) == 0
        # budget 0: the first failover any tenant asks for is shed typed
        faults.configure({"replica.fail": "always"}, seed=fault_seed)
        with pytest.raises(RetryBudgetExhaustedError):
            fleet.submit(TEMPLATES["groupby"])
        faults.configure({}, seed=fault_seed)
        assert fleet.submit("SELECT COUNT(*) AS c FROM fact").result(
            timeout=WAIT_S).num_rows == 1
    finally:
        faults.reset()
        s.stop()


# -- the shared fleet --------------------------------------------------------

def test_fleet_concurrent_matches_jax_serial(shared_fleet, oracle):
    _, fleet = shared_fleet
    outcomes, errors = {}, []

    def client(cid):
        try:
            outcomes[cid] = {
                name: _frows(fleet.submit(q, tenant=f"t{cid % 2}")
                             .result(timeout=WAIT_S))
                for name, q in TEMPLATES.items()}
        except BaseException as e:
            errors.append(e)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=WAIT_S * 3)
    assert not errors, errors
    assert len(outcomes) == 2
    for got in outcomes.values():
        for name in TEMPLATES:
            assert got[name] == oracle[name], name
    assert fleet_stats.global_stats()["routed"] >= 6
    assert fleet.health_snapshot()["quarantined"] == []


def test_replica_stats_carry_launches_and_process(shared_fleet):
    _, fleet = shared_fleet
    pids = set()
    for idx in (0, 1):
        snap = fleet.replica_stats(idx)
        assert snap is not None
        assert set(snap["kernels"]["launches"]) == {"dense_slot_reduce",
                                                    "contains"}
        assert snap["process"]["device"] == "cpu"
        assert snap["process"]["pid"] == fleet.replica_pid(idx)
        assert snap["fleet"]["replicas"] == 0  # a replica routes nothing
        pids.add(snap["process"]["pid"])
    assert len(pids) == 2 and os.getpid() not in pids


def test_fleet_wide_disk_result_cache_shared_across_replicas(shared_fleet):
    _, fleet = shared_fleet
    q = "SELECT w, SUM(v) AS sv FROM fact GROUP BY w"

    def disk_counts():
        hits = inserts = 0
        for i in (0, 1):
            srv = fleet.replica_stats(i)["server"]
            hits += srv["disk_cache_hits"]
            inserts += srv["disk_cache_inserts"]
        return hits, inserts

    hits0, inserts0 = disk_counts()
    first = _frows(fleet.submit(q).result(timeout=WAIT_S))
    second = _frows(fleet.submit(q).result(timeout=WAIT_S))
    assert first == second
    hits1, inserts1 = disk_counts()
    assert inserts1 >= inserts0 + 1
    assert hits1 >= hits0 + 1


def test_rolling_restart_zero_rejections(shared_fleet, oracle):
    _, fleet = shared_fleet
    assert _frows(fleet.submit(TEMPLATES["groupby"]).result(
        timeout=WAIT_S)) == oracle["groupby"]
    old = {i: fleet.replica_pid(i) for i in (0, 1)}
    results, errors = [], []
    stop_clients = threading.Event()

    def client():
        while not stop_clients.is_set():
            try:
                r = fleet.submit(TEMPLATES["groupby"]).result(
                    timeout=WAIT_S)
                results.append(_frows(r) == oracle["groupby"])
            except BaseException as e:
                errors.append(e)
            time.sleep(0.05)

    t = threading.Thread(target=client)
    t.start()
    try:
        report = fleet.rolling_restart()
    finally:
        stop_clients.set()
        t.join(timeout=WAIT_S * 2)
    assert sorted(report) == [0, 1]
    assert all(v > 0.0 for v in report.values())
    assert not errors, errors
    assert results and all(results)
    assert all(fleet.replica_pid(i) != old[i] for i in (0, 1))
    assert _frows(fleet.submit(TEMPLATES["groupby"]).result(
        timeout=WAIT_S)) == oracle["groupby"]
    assert fleet_stats.global_stats()["rolling_restarts"] >= 1


@pytest.mark.faults
def test_injected_replica_fail_replays_on_healthy_replica(
        shared_fleet, oracle, tmp_path):
    _, fleet = shared_fleet
    journal.configure(str(tmp_path / "journal"))
    before = fleet_stats.global_stats()
    try:
        faults.configure({"replica.fail": "always@r0"}, seed=1)
        # a tenant with no routing history: its first pick is replica 0
        for _ in range(3):
            assert _frows(fleet.submit(
                TEMPLATES["groupby"], tenant="replay").result(
                    timeout=WAIT_S)) == oracle["groupby"]
        after = fleet_stats.global_stats()
        assert after["replica_fail_faults"] \
            >= before["replica_fail_faults"] + 1
        assert after["failovers"] >= before["failovers"] + 1
        streams = faults.injector().stats()
        assert streams.get("replica.fail@r0", {}).get("fired", 0) >= 1
        assert streams.get("replica.fail@r1", {}).get("fired", 0) == 0
    finally:
        faults.reset()
        journal.close()
    events = []
    for p in glob.glob(str(tmp_path / "journal" / "*.jsonl")):
        with open(p, encoding="utf-8") as f:
            events += [json.loads(line) for line in f if line.strip()]
    assert "replica_failover" in {e.get("event") for e in events}
    _wait_healthy(fleet)


@pytest.mark.faults
def test_retry_attempt_exhaustion_sheds_typed(shared_fleet):
    _, fleet = shared_fleet
    try:
        faults.configure({"replica.fail": "always"}, seed=1)
        with pytest.raises(ReplicaFailedError) as ei:
            fleet.submit(TEMPLATES["groupby"])
        rt = pickle.loads(pickle.dumps(ei.value))
        assert isinstance(rt, ReplicaFailedError)
        assert rt.replica == ei.value.replica
        assert str(rt) == str(ei.value)
    finally:
        faults.reset()
    _wait_healthy(fleet)
    assert fleet.submit("SELECT COUNT(*) AS c FROM fact").result(
        timeout=WAIT_S).num_rows == 1


def test_replica_sigkill_failover_zero_wrong_results(shared_fleet, oracle):
    _, fleet = shared_fleet
    _wait_healthy(fleet)
    for _ in range(2):
        assert _frows(fleet.submit(TEMPLATES["groupby"]).result(
            timeout=WAIT_S)) == oracle["groupby"]
    before = fleet_stats.global_stats()
    # replica 0 holds every query it gets for a second: its tickets are
    # in flight, unanswered, when it dies
    assert fleet.configure_faults({"replica.slow": "always@r0"}) == 2
    try:
        # tenants with no routing history: each alternates from 0
        tickets = [fleet.submit(TEMPLATES["groupby"], tenant=f"k{i % 2}")
                   for i in range(6)]
        assert fleet._inflight_count(0) >= 1
        os.kill(fleet.replica_pid(0), signal.SIGKILL)
        wrong = typed = correct = 0
        for tk in tickets:
            try:
                if _frows(tk.result(timeout=WAIT_S)) == oracle["groupby"]:
                    correct += 1
                else:
                    wrong += 1
            except EngineError:
                typed += 1
    finally:
        fleet.configure_faults({})
    assert wrong == 0, "a failed-over query surfaced wrong rows"
    assert correct + typed == 6 and correct >= 1
    after = fleet_stats.global_stats()
    assert after["replica_deaths"] >= before["replica_deaths"] + 1
    assert after["failovers"] >= before["failovers"] + 1
    assert 0 in fleet.health_snapshot()["dead"]
    assert _frows(fleet.submit(TEMPLATES["sort_limit"]).result(
        timeout=WAIT_S)) == oracle["sort_limit"]
    secs = fleet.replace_replica(0)
    assert secs > 0.0
    assert 0 not in fleet.health_snapshot()["dead"]
    assert _frows(fleet.submit(TEMPLATES["project_filter"]).result(
        timeout=WAIT_S)) == oracle["project_filter"]


# -- the disk result tier, with no fleet -------------------------------------

def _result(values):
    s = st.TorchSession(_port_conf())
    return s.create_dataframe({"x": np.asarray(values, np.int64)})._host()


def test_disk_tier_cross_instance_hit_and_corrupt_degrade(tmp_path):
    d = str(tmp_path / "tier")
    key = ("plan", "snap", "conf", (), ())
    res = _result([1, 2, 3])
    DiskResultTier(d, 1 << 20).put(key, res)
    t2 = DiskResultTier(d, 1 << 20)
    got = t2.lookup(key)
    assert got is not None and got.equals(res)
    assert t2.hits == 1
    path = glob.glob(os.path.join(d, "*.res"))[0]
    with open(path, "r+b") as f:
        f.seek(16)
        f.write(b"\xde\xad\xbe\xef")
    assert t2.lookup(key) is None
    assert t2.corrupt == 1
    assert not os.path.exists(path)
    DiskResultTier(d, 1 << 20).put(key, res)
    path = glob.glob(os.path.join(d, "*.res"))[0]
    with open(path, "wb") as f:
        f.write(b"NOTMAGIC")
    assert t2.lookup(key) is None
    assert t2.corrupt == 2


def test_disk_tier_byte_bound_evicts_lru(tmp_path):
    d = str(tmp_path / "tier")
    tier = DiskResultTier(d, 4096)
    res = _result(list(range(100)))
    for i in range(8):
        tier.put((f"k{i}",), res)
        time.sleep(0.01)  # distinct mtimes, a deterministic LRU order
    assert tier.evictions > 0
    total = sum(os.path.getsize(p)
                for p in glob.glob(os.path.join(d, "*.res")))
    assert total <= 4096
    assert tier.lookup(("k7",)) is not None


def test_result_cache_spill_through_respects_pins(tmp_path):
    d = str(tmp_path / "tier")
    cache = ResultCache(8, 1 << 20, disk=DiskResultTier(d, 1 << 20))
    res = _result([1])
    cache.put(("pinned",), res, pins=(object(),))
    assert glob.glob(os.path.join(d, "*.res")) == []
    cache.put(("pinless",), res)
    assert len(glob.glob(os.path.join(d, "*.res"))) == 1
    fresh = ResultCache(8, 1 << 20, disk=DiskResultTier(d, 1 << 20))
    assert fresh.lookup(("pinned",)) is None
    got = fresh.lookup(("pinless",))
    assert got is not None and got.equals(res)
    assert fresh.snapshot_stats()["disk"]["hits"] == 1
    assert fresh.lookup(("pinless",)) is not None
    assert fresh.snapshot_stats()["disk"]["hits"] == 1
    assert fresh.snapshot_stats()["hits"] == 1


# -- the health state machine, against the JAX package's ---------------------

def _both(**kw):
    return ReplicaHealthTracker(**kw), JTracker(**kw)


def _same(trackers, fn):
    a, b = (fn(t) for t in trackers)
    assert a == b
    return a


def test_health_two_consecutive_fails_quarantine():
    trs = _both(alpha=0.5, threshold=0.4, probation_ms=1)
    assert not _same(trs, lambda t: t.record(0, OUTCOME_FAIL))
    assert _same(trs, lambda t: t.record(0, OUTCOME_FAIL))
    assert _same(trs, lambda t: t.is_quarantined(0))
    assert _same(trs, lambda t: t.quarantined_set()) == frozenset({0})
    assert _same(trs, lambda t: (t.score(1), t.is_quarantined(1))) == \
        (1.0, False)


def test_health_probation_pass_relapse_and_restore():
    trs = _both(alpha=0.5, threshold=0.4, probation_ms=1)
    for t in trs:
        t.record(0, OUTCOME_FAIL)
        t.record(0, OUTCOME_FAIL)
    time.sleep(0.01)
    assert _same(trs, lambda t: t.due_for_probe()) == [0]
    assert _same(trs, lambda t: t.due_for_probe()) == []
    for t in trs:
        t.probe_result(0, ok=True)
    assert _same(trs, lambda t: (t.is_quarantined(0), t.on_probation(0))) \
        == (False, True)
    assert _same(trs, lambda t: t.score(0)) == pytest.approx(0.7)
    assert _same(trs, lambda t: t.record(0, OUTCOME_FAIL))
    time.sleep(0.01)
    assert _same(trs, lambda t: t.due_for_probe()) == [0]
    for t in trs:
        t.probe_result(0, ok=True)
    assert not _same(trs, lambda t: t.record(0, OUTCOME_SLOW))
    assert _same(trs, lambda t: t.on_probation(0))
    assert not _same(trs, lambda t: t.record(0, OUTCOME_SUCCESS))
    assert _same(trs, lambda t: t.snapshot())["probation"] == []


def test_health_failed_probe_restarts_window_and_forget_clears():
    trs = _both(alpha=0.5, threshold=0.4, probation_ms=10_000)
    for t in trs:
        t.force_quarantine(0)
    assert _same(trs, lambda t: (t.is_quarantined(0), t.score(0))) == \
        (True, 0.0)
    assert _same(trs, lambda t: t.due_for_probe()) == []
    for t in trs:
        t.probe_result(0, ok=False)
    assert _same(trs, lambda t: t.is_quarantined(0))
    for t in trs:
        t.forget(0)
    assert _same(trs, lambda t: (t.is_quarantined(0), t.score(0))) == \
        (False, 1.0)
    for t in trs:
        t.record(1, OUTCOME_SLOW, weight=1.0 / 8.0)
    assert _same(trs, lambda t: t.score(1)) > 0.9
    assert not _same(trs, lambda t: t.is_quarantined(1))
