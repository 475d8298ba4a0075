"""The torch port's fault injection against the JAX package.

Mirrors ``tests/test_faults.py`` where the port has the site: the
trigger grammar (count, first, prob@seed, always/off, @w<idx>) fires at
the same call indices as the JAX injector for the same spec and seed;
per-site prob streams stay independent; ``configure`` keeps counters for
the same spec; ``configure_from_conf``; ``corrupt``; an injected
``kernel.launch`` driving ``with_retry``'s relief; the same injection
(``count:1``) through a sort and an aggregate in both packages, whose
results stay equal (relative 1e-9 on f64 sums, which add in different
orders); ``spill.demote`` on the port's catalog and the JAX package's
giving the same return values, failure counts and tiers (a failed
demotion skips the handle); ``spill.promote`` leaving the handle whole;
``io.prefetch.decode`` surfacing at the consumer.  The port's injector is
process-wide, so every test here resets it after itself.
"""

import numpy as np
import pytest

from spark_rapids_tpu import faults as jfaults
from spark_rapids_tpu.faults import FaultInjector as JFaultInjector
from tests.compare import assert_tables_equal, tpu_session

import spark_rapids_tpu_torch as st
from spark_rapids_tpu_torch import faults
from spark_rapids_tpu_torch.faults import FaultInjector, InjectedFault

SEED = 1234


@pytest.fixture(autouse=True)
def _reset_torch_injector():
    faults.reset()
    yield
    faults.reset()


def _fires(cls, spec, calls, seed=0, worker=None, site="s"):
    inj = cls({site: spec}, seed=seed, worker=worker)
    return [inj.should_fire(site) for _ in range(calls)]


SPECS = ["count:3", "count:2,5", "count:4+", "first:2", "always", "off",
         "prob:0.3", "prob:0.05", "count:2@w1", "first:3@w0", "", " Always "]


@pytest.mark.parametrize("worker", [None, 0, 1])
@pytest.mark.parametrize("spec", SPECS)
def test_trigger_fires_at_the_jax_call_indices(spec, worker):
    got = _fires(FaultInjector, spec, 60, seed=SEED, worker=worker)
    want = _fires(JFaultInjector, spec, 60, seed=SEED, worker=worker)
    assert got == want


@pytest.mark.parametrize("site", ["kernel.launch", "spill.demote",
                                  "server.admit", "server.cache.lookup"])
def test_prob_stream_is_the_jax_stream_per_site(site):
    got = _fires(FaultInjector, "prob:0.5", 200, seed=SEED, site=site)
    want = _fires(JFaultInjector, "prob:0.5", 200, seed=SEED, site=site)
    assert got == want
    assert 50 < sum(got) < 150
    assert got != _fires(FaultInjector, "prob:0.5", 200, seed=SEED + 1,
                         site=site)


def test_prob_streams_independent_per_site():
    solo = _fires(FaultInjector, "prob:0.5", 50, seed=SEED, site="x")
    inj = FaultInjector({"x": "prob:0.5", "y": "prob:0.5"}, seed=SEED)
    paired = []
    for _ in range(50):
        paired.append(inj.should_fire("x"))
        inj.should_fire("y")
    assert solo == paired


@pytest.mark.parametrize("spec", ["sometimes", "count:x", "prob:"])
def test_bad_spec_rejected_like_jax(spec):
    with pytest.raises(ValueError):
        JFaultInjector({"s": spec})
    with pytest.raises(ValueError):
        FaultInjector({"s": spec})


def test_configure_idempotent_keeps_counters():
    inj = faults.configure({"s": "count:1+"}, seed=7)
    assert inj.should_fire("s")
    again = faults.configure({"s": "count:1+"}, seed=7)
    assert again is inj
    assert faults.configure({"s": "count:1+"}, seed=8) is not inj


def test_configure_from_conf_dict_and_stats():
    inj = faults.configure_from_conf({
        "spark.rapids.faults.server.admit": "count:2",
        "spark.rapids.faults.seed": "11",
        "spark.rapids.sql.batchSizeRows": "10",   # not a fault key
    })
    assert inj.seed == 11
    faults.maybe_fail("server.admit")
    with pytest.raises(InjectedFault) as ei:
        faults.maybe_fail("server.admit")
    assert ei.value.site == "server.admit"
    assert isinstance(ei.value, IOError)
    assert isinstance(ei.value, st.EngineError)
    assert inj.stats()["server.admit"] == {"calls": 2, "fired": 1}


def test_corrupt_flips_one_bit_only_when_fired():
    faults.configure({"x": "count:2"})
    jfaults.configure({"x": "count:2"})
    try:
        payload = b"abcdefgh"
        for _ in range(3):
            got = faults.corrupt("x", payload)
            assert got == jfaults.corrupt("x", payload)
        faults.configure({"x": "count:2"}, seed=1)
        assert faults.corrupt("x", payload) == payload
        mangled = faults.corrupt("x", payload)
        assert sum(a != b for a, b in zip(mangled, payload)) == 1
    finally:
        jfaults.reset()


class _FakeCatalog:
    def __init__(self):
        self.spill_all_calls = 0

    def spill_all(self):
        self.spill_all_calls += 1
        return 0


class _FakeCtx:
    def __init__(self):
        class _R:
            pass
        self.runtime = _R()
        self.runtime.catalog = _FakeCatalog()


def test_injected_kernel_oom_drives_spill_retry():
    from spark_rapids_tpu_torch.utils.retry import is_device_oom, with_retry
    faults.configure_from_conf({"spark.rapids.faults.kernel.launch":
                                "count:1"})
    ctx = _FakeCtx()
    assert with_retry(lambda b: b * 2, 21, ctx) == [42]
    assert ctx.runtime.catalog.spill_all_calls == 1
    assert faults.injector().stats()["kernel.launch"]["fired"] == 1
    assert is_device_oom(InjectedFault("kernel.launch",
                                       "RESOURCE_EXHAUSTED: x"))


# -- kernel.launch=count:1 through a sort and an aggregate, both packages ---

N = 5000


def _data():
    rng = np.random.default_rng(61)
    return {"k": rng.integers(0, 40, N).astype(np.int64),
            "v": rng.normal(size=N),
            "w": rng.integers(-1000, 1000, N).astype(np.int64)}


def _sort(s, F):
    return s.sql("SELECT k, v, w FROM t ORDER BY v DESC, k")


def _agg(s, F):
    return s.sql("SELECT k, SUM(v) AS sv, COUNT(*) AS c, MAX(w) AS mw "
                 "FROM t GROUP BY k")


@pytest.mark.parametrize("query", [_sort, _agg], ids=["sort", "aggregate"])
def test_kernel_launch_fault_on_sort_and_aggregate_matches_jax(query):
    import pyarrow as pa
    conf = {"spark.rapids.faults.kernel.launch": "count:1",
            "spark.rapids.faults.seed": str(SEED)}
    data = _data()
    js = tpu_session(conf)
    js.create_dataframe(pa.table(data)).create_or_replace_temp_view("t")
    try:
        want = query(js, None).to_arrow()
        jfired = jfaults.injector().stats()["kernel.launch"]["fired"]
    finally:
        jfaults.reset()
    ts = st.TorchSession({"spark.rapids.torch.device": "cpu", **conf})
    ts.create_dataframe(data).create_or_replace_temp_view("t")
    got = query(ts, None).to_arrow()
    assert faults.injector().stats()["kernel.launch"]["fired"] == 1
    assert jfired == 1
    assert_tables_equal(got, want, ignore_order=query is _agg,
                        approx_float=True)
    # the same query without the fault gives the same rows
    faults.reset()
    clean = st.TorchSession({"spark.rapids.torch.device": "cpu"})
    clean.create_dataframe(data).create_or_replace_temp_view("t")
    assert_tables_equal(got, query(clean, None).to_arrow(),
                        ignore_order=False)


# -- spill sites ------------------------------------------------------------

def _spillable():
    from spark_rapids_tpu_torch.columnar.batch import host_batch_to_device, \
        host_columns_from_numpy
    from spark_rapids_tpu_torch.memory.spill import BufferCatalog, \
        SpillableBatch
    import torch
    schema, cols = host_columns_from_numpy(
        {"a": np.arange(512, dtype=np.int64)})
    cat = BufferCatalog(device_budget_bytes=1 << 40)
    sb = SpillableBatch(host_batch_to_device(schema, cols,
                                             torch.device("cpu")), cat)
    return cat, sb


def _jax_spillable():
    from tests.test_faults import _spillable as jax_spillable
    return jax_spillable()


def _demote_sequence(cat, sb, spill_all_calls: int):
    """``spill_all`` called ``spill_all_calls`` times, each call's return
    value, failure count and the handle's tier after it, then a promotion
    and a second round, as one list."""
    out = []
    for _ in range(spill_all_calls):
        out.append((cat.spill_all(), cat.demote_failure_count, sb.tier))
    sb.get()
    out.append(("promoted", sb.tier))
    for _ in range(spill_all_calls):
        out.append((cat.spill_all(), cat.demote_failure_count, sb.tier))
    return out


def test_spill_demote_fault_raises_and_keeps_the_handle():
    """A failed demotion keeps the handle whole on its tier, as the JAX
    catalog does for the same ``spill.demote=count:1`` spec: the first
    ``spill_all`` returns 0 and counts one failure, the next moves the
    handle (the name is older than the port's bounded demotion; the
    call no longer raises)."""
    spec = {"spark.rapids.faults.spill.demote": "count:1"}
    jcat, jsb = _jax_spillable()
    cat, sb = _spillable()
    try:
        jfaults.configure_from_conf(spec)
        want = [(jcat.spill_all(), jcat.demote_failure_count, jsb.tier),
                (jcat.spill_all(), jcat.demote_failure_count, jsb.tier)]
        faults.configure_from_conf(spec)
        got = [(cat.spill_all(), cat.demote_failure_count, sb.tier),
               (cat.spill_all(), cat.demote_failure_count, sb.tier)]
        assert got == want == [(0, 1, "device"), (sb.size, 1, "host")]
    finally:
        jfaults.reset()
        sb.close()
        jsb.close()
    assert cat.audit_leaks() == 0


@pytest.mark.parametrize("spec", ["count:1", "count:2", "count:1,3",
                                  "first:2", "always", "off"])
def test_spill_demote_fault_matches_jax_catalog(spec):
    """The same ``spill.demote`` spec on the JAX catalog and the port's:
    the same ``spill_all`` return values, ``demote_failure_count`` and
    handle tiers, call after call."""
    conf = {"spark.rapids.faults.spill.demote": spec}
    jcat, jsb = _jax_spillable()
    cat, sb = _spillable()
    try:
        jfaults.configure_from_conf(conf)
        want = _demote_sequence(jcat, jsb, 3)
        faults.configure_from_conf(conf)
        got = _demote_sequence(cat, sb, 3)
        assert got == want
    finally:
        jfaults.reset()
        sb.close()
        jsb.close()
    assert cat.audit_leaks() == 0


def test_spill_promote_fault_leaves_handle_recoverable():
    cat, sb = _spillable()
    try:
        cat.spill_all()
        assert sb.tier == "host"
        faults.configure_from_conf({"spark.rapids.faults.spill.promote":
                                    "count:1"})
        with pytest.raises(InjectedFault):
            sb.get()
        assert sb.tier == "host"
        out = sb.get()
        assert out.num_rows == 512
        assert out.columns[0].data.tolist() == list(range(512))
    finally:
        sb.close()
    assert cat.audit_leaks() == 0


def test_prefetch_decode_fault_surfaces_at_the_consumer():
    from spark_rapids_tpu_torch.io.prefetch import FAULT_SITE_DECODE, \
        PrefetchIterator
    faults.configure_from_conf({"spark.rapids.faults.io.prefetch.decode":
                                "count:3"})
    it = PrefetchIterator(iter(range(10)), depth=1, name="fault-test",
                          fault_site=FAULT_SITE_DECODE)
    try:
        assert next(it) == 0 and next(it) == 1
        with pytest.raises(InjectedFault) as ei:
            next(it)
        assert ei.value.site == FAULT_SITE_DECODE
    finally:
        it.close()
    assert not it._thread.is_alive()
