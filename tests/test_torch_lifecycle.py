"""The torch port's query lifecycle against the JAX package.

Mirrors ``tests/test_lifecycle.py`` where the port has the path: the
error hierarchy; the cancel token's deadline and classification; the
registry's order, late registration and closer errors; the poll
interval; nested scopes; supervision off giving the same rows (and the
JAX package's); a deadline raising ``QueryTimeoutError`` in both
packages with the session serving the next query; a cancel at the pull
boundary and in the semaphore's wait; the background pull reclaimed by
its scope, by ``session.stop()``, and running under its query (a cancel
and a budget reach its thread); ``shutdown_all`` reaching another
thread's query; semaphore waits charged to the waiting query; the hang
watchdog and a deadline bounding an injected ``io.pipeline.hang``; and
the pull boundary wrapping every operator.  The port's injector is
process-wide, so every test resets it after itself.
"""

import threading
import time

import numpy as np
import pyarrow as pa
import pytest

import spark_rapids_tpu as jst
from spark_rapids_tpu import errors as jerrors
from tests.compare import assert_tables_equal

import spark_rapids_tpu_torch as st
from spark_rapids_tpu_torch import faults, lifecycle
from spark_rapids_tpu_torch.errors import (
    EngineError, QueryBudgetExceededError, QueryCancelledError,
    QueryHangError, QueryTimeoutError,
)


@pytest.fixture(autouse=True)
def _reset_torch_injector():
    faults.reset()
    yield
    faults.reset()


def _data(n=300):
    rng = np.random.default_rng(7)
    return {"k": rng.integers(0, 8, n).astype(np.int64),
            "v": rng.normal(size=n)}


def _session(extra=None, n=300):
    s = st.TorchSession({"spark.rapids.torch.device": "cpu",
                         **(extra or {})})
    s.create_dataframe(_data(n)).create_or_replace_temp_view("t")
    return s


def _jax_session(extra=None, n=300):
    s = jst.TpuSession({"spark.rapids.sql.incompatibleOps.enabled": "true",
                        **(extra or {})})
    s.create_dataframe(pa.table(_data(n))).create_or_replace_temp_view("t")
    return s


QUERY = "SELECT k, SUM(v) AS sv, COUNT(*) AS c FROM t GROUP BY k ORDER BY k"


# -- the error hierarchy -----------------------------------------------------

def test_error_hierarchy_matches_jax():
    pairs = [("EngineError", Exception), ("QueryCancelledError", "EngineError"),
             ("QueryTimeoutError", "QueryCancelledError"),
             ("AdmissionRejectedError", "EngineError"),
             ("QueryBudgetExceededError", "EngineError"),
             ("QueryHangError", "EngineError")]
    from spark_rapids_tpu_torch import errors as terrors
    for name, base in pairs:
        for mod in (terrors, jerrors):
            b = getattr(mod, base) if isinstance(base, str) else base
            assert issubclass(getattr(mod, name), b), (mod, name)
        # exported at the package root, as in the JAX package
        assert getattr(st, name) is getattr(terrors, name)
    assert issubclass(faults.InjectedFault, EngineError)
    assert issubclass(faults.InjectedFault, IOError)
    err = QueryHangError("x.site", 1.5)
    assert (err.site, err.timeout_s) == ("x.site", 1.5)
    assert "x.site" in str(err)


# -- token and context -------------------------------------------------------

def test_cancel_token_deadline_and_classification():
    tok = lifecycle.CancelToken(timeout_s=0.05)
    tok.check()
    time.sleep(0.08)
    assert tok.expired()
    with pytest.raises(QueryTimeoutError):
        tok.check()
    assert tok.timed_out
    with pytest.raises(QueryTimeoutError):
        tok.check()


def test_cancel_token_explicit_cancel():
    tok = lifecycle.CancelToken()
    tok.cancel("user abort")
    assert tok.cancelled and not tok.timed_out
    with pytest.raises(QueryCancelledError, match="user abort"):
        tok.check()


def test_registry_closes_in_registration_order_and_release():
    qc = lifecycle.QueryContext()
    order = []
    qc.register(lambda: order.append("a"), name="a")
    reg_b = qc.register(lambda: order.append("b"), name="b")
    qc.register(lambda: order.append("c"), name="c")
    reg_b.release()
    assert qc.live_resources == 2
    qc.finish()
    assert order == ["a", "c"]
    qc.finish()
    assert order == ["a", "c"]


def test_late_registration_into_finished_context_closes_on_arrival():
    qc = lifecycle.QueryContext()
    qc.finish()
    closed = []
    reg = qc.register(lambda: closed.append(True), name="late")
    assert closed == [True] and reg.rejected
    reg.release()


def test_registry_teardown_survives_closer_errors():
    qc = lifecycle.QueryContext()
    closed = []
    qc.register(lambda: (_ for _ in ()).throw(RuntimeError("boom")),
                name="bad")
    qc.register(lambda: closed.append(True), name="good")
    qc.finish()
    assert closed == [True]


def test_check_interval_conf_reaches_blocking_waits():
    from spark_rapids_tpu_torch.conf import TorchConf
    conf = TorchConf({"spark.rapids.sql.cancel.checkIntervalMs": "200"})
    with lifecycle.query_scope(conf) as qc:
        assert qc.check_interval_s == pytest.approx(0.2)
        assert lifecycle.poll_interval_s() == pytest.approx(0.2)
    assert lifecycle.poll_interval_s() == lifecycle.WAIT_POLL_S


def test_query_scope_nesting_reuses_outer():
    with lifecycle.query_scope(timeout_ms=0) as outer:
        with lifecycle.query_scope(timeout_ms=5) as inner:
            assert inner is outer
        assert lifecycle.current() is outer
    assert lifecycle.current() is None


# -- supervision off gives the same rows -------------------------------------

def test_supervision_off_is_byte_identical_and_matches_jax():
    base = _session().sql(QUERY)._host()
    supervised = _session({"spark.rapids.sql.queryTimeoutMs": "600000",
                           "spark.rapids.sql.watchdog.hangTimeoutMs": "0"}
                          ).sql(QUERY)._host()
    assert supervised.equals(base)
    js = _jax_session()
    try:
        want = js.sql(QUERY).to_arrow()
    finally:
        js.stop()
    assert_tables_equal(base.to_arrow(), want, ignore_order=False,
                        approx_float=True)


# -- deadlines --------------------------------------------------------------

def test_query_deadline_raises_the_jax_error_and_session_survives():
    js = _jax_session({"spark.rapids.sql.queryTimeoutMs": "1"})
    try:
        with pytest.raises(jerrors.QueryTimeoutError):
            js.sql(QUERY).to_arrow()
    finally:
        js.stop()
    lifecycle.reset_global_stats()
    s = _session({"spark.rapids.sql.queryTimeoutMs": "1",
                  "spark.rapids.sql.reader.batchSizeRows": "64"}, n=4000)
    with pytest.raises(QueryTimeoutError) as ei:
        s.sql(QUERY).collect()
    assert type(ei.value).__name__ == "QueryTimeoutError"
    assert lifecycle.global_stats()["timeouts"] == 1
    s.set_conf("spark.rapids.sql.queryTimeoutMs", "0")
    assert len(s.sql(QUERY).collect()) == 8
    assert s.runtime.catalog.audit_leaks() == 0


# -- cooperative cancellation -------------------------------------------------

def test_cancel_interrupts_pull_boundary():
    lifecycle.reset_global_stats()
    s = _session()
    with lifecycle.query_scope(timeout_ms=0) as qc:
        qc.cancel("test cancel")
        with pytest.raises(QueryCancelledError, match="test cancel"):
            s.sql(QUERY).collect()
    assert lifecycle.global_stats()["cancels"] >= 1


def test_cancel_interrupts_semaphore_wait():
    from spark_rapids_tpu_torch.runtime import TorchSemaphore
    sem = TorchSemaphore(1)
    entered = threading.Event()
    release = threading.Event()

    def holder():
        sem.acquire()
        entered.set()
        release.wait(timeout=10)
        sem.release()

    t = threading.Thread(target=holder, daemon=True)
    t.start()
    assert entered.wait(timeout=5)
    with lifecycle.query_scope(timeout_ms=0) as qc:
        qc.cancel("admission abort")
        with pytest.raises(QueryCancelledError):
            sem.acquire()
    release.set()
    t.join(timeout=5)
    sem.acquire()
    sem.release()
    assert sem.available() == 1


def test_semaphore_wait_charged_to_the_waiting_query():
    s = _session()
    sem = s.runtime.semaphore
    release = threading.Event()
    entered = []
    holders = []
    for _ in range(sem.permits):
        ev = threading.Event()

        def holder(ev=ev):
            sem.acquire()
            ev.set()
            release.wait(timeout=10)
            sem.release()

        t = threading.Thread(target=holder, daemon=True)
        t.start()
        holders.append(t)
        entered.append(ev)
    assert all(ev.wait(timeout=5) for ev in entered)
    timer = threading.Timer(0.3, release.set)
    timer.start()
    try:
        with lifecycle.query_scope(timeout_ms=0) as qc:
            assert len(s.sql(QUERY).collect()) == 8
    finally:
        release.set()
        timer.cancel()
        for t in holders:
            t.join(timeout=5)
    assert qc.sem_wait_ms >= 100
    assert s._last_plan.metrics["semWaitMs"] >= 100


# -- the background pull ------------------------------------------------------

def test_prefetch_thread_reclaimed_by_scope_teardown():
    from spark_rapids_tpu_torch.io.prefetch import PrefetchIterator
    with lifecycle.query_scope(timeout_ms=0) as qc:
        it = PrefetchIterator(iter(range(100)), depth=1, name="leak-test")
        assert next(it) == 0
        assert qc.live_resources >= 1
    assert not it._thread.is_alive()


def test_session_stop_joins_outstanding_threads():
    from spark_rapids_tpu_torch.io.prefetch import PrefetchIterator
    s = _session()
    assert len(s.sql(QUERY).collect()) == 8
    it = PrefetchIterator(iter(range(100)), depth=1, name="stop-test")
    assert next(it) == 0
    assert it._thread.is_alive()
    s.stop()
    assert not it._thread.is_alive()


def test_background_pull_runs_under_its_query():
    from spark_rapids_tpu_torch.io.prefetch import PrefetchIterator
    seen = []

    def source():
        for i in range(1000):
            seen.append(lifecycle.current())
            lifecycle.check_cancel()
            yield i

    with lifecycle.query_scope(timeout_ms=0) as qc:
        it = PrefetchIterator(source(), depth=1, name="adopt-test")
        assert next(it) == 0
        qc.cancel("stop the pull")
        with pytest.raises(QueryCancelledError, match="stop the pull"):
            for _ in it:
                pass
    assert seen and all(c is qc for c in seen)
    assert not it._thread.is_alive()


def test_query_with_the_pull_on_cancels_and_leaves_nothing():
    s = _session({"spark.rapids.sql.io.prefetch.enabled": "true",
                  "spark.rapids.sql.reader.batchSizeRows": "64"}, n=4000)
    want = _session(n=4000).sql(QUERY)._host()
    assert s.sql(QUERY)._host().equals(want)
    with lifecycle.query_scope(timeout_ms=0) as qc:
        qc.cancel("cancel with the pull on")
        with pytest.raises(QueryCancelledError):
            s.sql(QUERY).collect()
    assert s.runtime.catalog.audit_leaks() == 0
    assert not [t for t in threading.enumerate()
                if t.name.startswith("spark-rapids-torch-")]


def test_budget_reaches_handles_made_on_the_pull_thread():
    from spark_rapids_tpu_torch.conf import TorchConf
    from spark_rapids_tpu_torch.io.prefetch import PrefetchIterator
    from spark_rapids_tpu_torch.memory.spill import SpillableBatch
    s = _session()
    batch = s.range(1000)._execute()[1][0]
    cat = s.runtime.catalog
    made = []

    def source():
        made.append(SpillableBatch(batch, cat))
        yield 0

    conf = TorchConf({"spark.rapids.server.query.maxDeviceBytes": "1"})
    with lifecycle.query_scope(conf) as qc:
        it = PrefetchIterator(source(), depth=1, name="budget-test")
        assert next(it) == 0
        it.close()
    try:
        # made on the pull's thread, charged to the query: demoted under
        # the one-byte budget
        assert made[0].tier == "host"
        assert cat._info[id(made[0])]["query"] == qc.query_id
    finally:
        made[0].close()


def test_shutdown_all_reclaims_other_threads_contexts():
    started = threading.Event()
    unblock = threading.Event()
    seen = {}

    def worker():
        with lifecycle.query_scope(timeout_ms=0) as qc:
            closed = []
            qc.register(lambda: closed.append(True), name="r")
            seen["qc"], seen["closed"] = qc, closed
            started.set()
            unblock.wait(timeout=10)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    assert started.wait(timeout=5)
    try:
        lifecycle.shutdown_all()
        assert seen["closed"] == [True]
        assert seen["qc"].token.cancelled
    finally:
        unblock.set()
        t.join(timeout=5)


# -- the hang watchdog --------------------------------------------------------

def test_watchdog_bounds_injected_pull_hang_like_jax():
    conf = {"spark.rapids.faults.io.pipeline.hang": "always",
            "spark.rapids.sql.watchdog.hangTimeoutMs": "300"}
    lifecycle.reset_global_stats()
    s = _session(conf)
    t0 = time.monotonic()
    with pytest.raises(QueryHangError):
        s.sql("SELECT k, v FROM t WHERE v > 0").collect()
    assert time.monotonic() - t0 < 30
    assert lifecycle.global_stats()["watchdog_trips"] >= 1
    js = _jax_session(conf)
    try:
        with pytest.raises(jerrors.QueryHangError):
            js.sql("SELECT k, v FROM t WHERE v > 0").to_arrow()
    finally:
        js.stop()
        from spark_rapids_tpu import faults as jfaults
        jfaults.reset()


def test_deadline_interrupts_injected_hang_without_watchdog():
    s = _session({"spark.rapids.faults.io.pipeline.hang": "always",
                  "spark.rapids.sql.queryTimeoutMs": "700"})
    t0 = time.monotonic()
    with pytest.raises(QueryTimeoutError):
        s.sql("SELECT k, v FROM t WHERE v > 0").collect()
    assert time.monotonic() - t0 < 30


def test_supervise_passthrough_without_query_or_faults():
    assert lifecycle.current() is None
    assert lifecycle.supervise(lambda: 42) == 42


def test_supervise_propagates_fn_errors_through_watchdog():
    class Boom(RuntimeError):
        pass

    with lifecycle.query_scope(timeout_ms=0) as qc:
        qc.hang_timeout_s = 5.0  # the threaded path
        with pytest.raises(Boom):
            lifecycle.supervise(lambda: (_ for _ in ()).throw(Boom("x")))


def test_global_stats_shape():
    assert set(lifecycle.global_stats()) == {
        "queries", "timeouts", "cancels", "watchdog_trips", "teardown_ms"}


# -- the pull boundary ----------------------------------------------------------

def _exec_classes():
    import importlib
    import pkgutil
    import spark_rapids_tpu_torch
    from spark_rapids_tpu_torch.exec.base import TorchExec
    for m in pkgutil.walk_packages(spark_rapids_tpu_torch.__path__,
                                   "spark_rapids_tpu_torch."):
        if "server" not in m.name:
            importlib.import_module(m.name)
    out, todo = [], list(TorchExec.__subclasses__())
    while todo:
        c = todo.pop()
        out.append(c)
        todo.extend(c.__subclasses__())
    return out


def test_every_operator_output_passes_the_pull_boundary():
    classes = _exec_classes()
    assert len(classes) >= 15
    for cls in classes:
        if "execute" in cls.__dict__:
            fn = cls.__dict__["execute"]
            assert fn.__code__.co_name == "checked_execute", cls


def test_budget_error_is_typed_at_the_operator_that_registers():
    from spark_rapids_tpu_torch.conf import TorchConf
    s = _session(n=4000)
    conf = TorchConf({"spark.rapids.server.query.maxDeviceBytes": "1"})
    with lifecycle.query_scope(conf):
        with pytest.raises(QueryBudgetExceededError):
            s.sql("SELECT k, v FROM t ORDER BY v").collect()
    assert s.runtime.catalog.audit_leaks() == 0
