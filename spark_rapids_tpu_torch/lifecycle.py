"""Query lifecycle: deadlines, cooperative cancellation, the resource
registry and the hang watchdog.

Counterpart of ``spark_rapids_tpu/lifecycle.py``.

* ``QueryContext``: made by ``query_scope`` at each action of a
  ``DataFrame`` (``api.py``), it carries the query's deadline
  (``spark.rapids.sql.queryTimeoutMs``, 0 = none), a ``CancelToken``,
  its device budget (``spark.rapids.server.query.maxDeviceBytes``) and
  an ordered registry of what the query holds: the background pull's
  threads (``io/prefetch.py``), the watchdog's runners.
* Cooperative cancellation: ``check_cancel()`` runs at the pull
  boundary every operator's output passes (``exec/base.py``) and in
  every bounded wait (the device semaphore, the background pull's
  queue), so a cancel or a passed deadline surfaces as
  ``QueryCancelledError`` / ``QueryTimeoutError`` within a batch or a
  poll interval.  A kernel already launched, or a ``.item()`` sync,
  cannot be interrupted: ``supervise`` bounds such a call instead.
* Teardown: at the scope's end, on success or failure, registered
  resources close in registration order; a closer's error is logged and
  never hides the query's own outcome.  ``shutdown_all()`` (from
  ``session.stop()``) cancels and tears down every live query, on any
  thread, then closes what was registered outside a query.
* The active context is kept per thread, so concurrent queries (the
  session server's workers) have independent fault domains.  A thread
  a query starts runs under the query's context (``adopt``), so its
  checks see the query's token and its spill handles count toward the
  query's budget.

With no deadline, no cancel and no watchdog, execution is the same as
without supervision.  Not carried over: the JAX package's worker
process reaping (the host shuffle, queue A8) and its semaphore
telemetry flush (the port's semaphore counts its waits itself).
"""

from __future__ import annotations

import atexit
import contextlib
import itertools
import logging
import threading
import time
import weakref
from typing import Callable, Dict, Optional

from spark_rapids_tpu_torch import faults
from spark_rapids_tpu_torch.errors import (
    EngineError, QueryCancelledError, QueryHangError, QueryTimeoutError,
)

log = logging.getLogger("spark_rapids_tpu_torch.lifecycle")

# poll interval of the bounded waits when no query is supervised
WAIT_POLL_S = 0.05

FAULT_SITE_PIPELINE_HANG = "io.pipeline.hang"

# an injected hang with no watchdog and no deadline still ends
_PARK_CAP_S = 3600.0

WATCHDOG_THREAD_PREFIX = "spark-rapids-torch-watchdog-"

_STATS_LOCK = threading.Lock()
_STATS = {"queries": 0, "timeouts": 0, "cancels": 0, "watchdog_trips": 0,
          "teardown_ms": 0}


def _bump_global(key: str, v: int) -> None:
    if v:
        with _STATS_LOCK:
            _STATS[key] += int(v)


def global_stats() -> dict:
    with _STATS_LOCK:
        return dict(_STATS)


def reset_global_stats() -> None:
    with _STATS_LOCK:
        for k in _STATS:
            _STATS[k] = 0


class CancelToken:
    """A cooperative cancel flag with an optional deadline.  ``check()``
    raises the token's typed error once it is cancelled, and turns a
    passed deadline into a ``QueryTimeoutError`` (once; later checks
    raise the same class)."""

    def __init__(self, timeout_s: float = 0.0):
        self._event = threading.Event()
        self._lock = threading.Lock()
        self._reason = ""
        self._exc_type = QueryCancelledError
        self.timeout_s = max(0.0, float(timeout_s))
        self.deadline = (time.monotonic() + self.timeout_s
                         if self.timeout_s > 0 else None)

    def cancel(self, reason: str = "query cancelled",
               exc_type=QueryCancelledError) -> None:
        with self._lock:
            if not self._event.is_set():
                self._reason = reason
                self._exc_type = exc_type
            self._event.set()

    @property
    def cancelled(self) -> bool:
        return self._event.is_set()

    @property
    def timed_out(self) -> bool:
        return self._event.is_set() and issubclass(self._exc_type,
                                                   QueryTimeoutError)

    def remaining_s(self) -> Optional[float]:
        if self.deadline is None:
            return None
        return self.deadline - time.monotonic()

    def expired(self) -> bool:
        rem = self.remaining_s()
        return rem is not None and rem <= 0

    def check(self) -> None:
        if not self._event.is_set() and self.expired():
            self.cancel(f"query exceeded spark.rapids.sql.queryTimeoutMs "
                        f"({int(self.timeout_s * 1000)} ms)",
                        QueryTimeoutError)
        if self._event.is_set():
            with self._lock:
                raise self._exc_type(self._reason)


class _Registration:
    """One registered resource.  ``release()`` forgets it without
    closing it (it closed itself).  ``rejected``: the registry was
    already closed for good, the closer ran on arrival, and the
    registrant must not start the resource."""

    __slots__ = ("_owner", "_key", "rejected")

    def __init__(self, owner, key: int, rejected: bool = False):
        self._owner = owner
        self._key = key
        self.rejected = rejected

    def release(self) -> None:
        owner, self._owner = self._owner, None
        if owner is not None:
            owner._remove(self._key)


class _Registry:
    """Ordered closers: a query's, or the module-wide one for resources
    made outside any query."""

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._next = 0
        self._closed = False
        self._entries: Dict[int, tuple] = {}  # insertion = close order

    def add(self, close: Callable[[], None], kind: str,
            name: str) -> _Registration:
        with self._lock:
            if not self._closed:
                key = self._next
                self._next += 1
                self._entries[key] = (kind, name, close)
                return _Registration(self, key)
        # the registry closed for good (a teardown raced this on another
        # thread): close the resource now, or nothing ever would
        try:
            close()
        except Exception as e:
            log.warning("late registration of %s %r closed on arrival (%s) "
                        "and its closer failed: %s", kind, name, self.name, e)
        return _Registration(None, -1, rejected=True)

    def _remove(self, key: int) -> None:
        with self._lock:
            self._entries.pop(key, None)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def close_all(self, permanent: bool = False) -> int:
        """Close every entry in registration order, logging a closer's
        error; ``permanent`` closes the registry for good.  Returns the
        entries closed."""
        with self._lock:
            entries = list(self._entries.values())
            self._entries.clear()
            if permanent:
                self._closed = True
        for kind, name, close in entries:
            try:
                close()
            except Exception as e:
                log.warning("lifecycle teardown of %s %r (%s) failed: %s",
                            kind, name, self.name, e)
        return len(entries)


_QUERY_IDS = itertools.count(1)


class QueryContext:
    """A query's fault domain: deadline, cancel token, device budget and
    resource registry.  ``query_scope`` makes one; tests build them."""

    def __init__(self, timeout_ms: int = 0, hang_timeout_ms: int = 0,
                 check_interval_ms: int = 50, max_device_bytes: int = 0):
        self.query_id = next(_QUERY_IDS)
        self.token = CancelToken(timeout_ms / 1000.0)
        self.hang_timeout_s = max(0.0, hang_timeout_ms / 1000.0)
        self.check_interval_s = max(0.005, check_interval_ms / 1000.0)
        # enforced by the spill catalog when > 0 (memory/spill.py)
        self.max_device_bytes = max(0, int(max_device_bytes))
        self._registry = _Registry("query")
        self.sem_wait_ms = 0
        self.teardown_ms = 0.0
        self.started = time.monotonic()
        self.wall_ms = 0.0
        self.error: Optional[BaseException] = None
        self._finished = False
        self._finish_lock = threading.Lock()

    @classmethod
    def from_conf(cls, conf) -> "QueryContext":
        from spark_rapids_tpu_torch.conf import (
            CANCEL_CHECK_INTERVAL_MS, QUERY_TIMEOUT_MS,
            SERVER_QUERY_MAX_DEVICE_BYTES, WATCHDOG_HANG_TIMEOUT_MS,
        )
        return cls(timeout_ms=conf.get(QUERY_TIMEOUT_MS),
                   hang_timeout_ms=conf.get(WATCHDOG_HANG_TIMEOUT_MS),
                   check_interval_ms=conf.get(CANCEL_CHECK_INTERVAL_MS),
                   max_device_bytes=conf.get(SERVER_QUERY_MAX_DEVICE_BYTES))

    def register(self, close: Callable[[], None], kind: str = "resource",
                 name: str = "") -> _Registration:
        return self._registry.add(close, kind, name)

    @property
    def live_resources(self) -> int:
        return len(self._registry)

    def cancel(self, reason: str = "query cancelled") -> None:
        self.token.cancel(reason)

    def check(self) -> None:
        self.token.check()

    def finish(self) -> None:
        """Close the registered resources and record the query's stats;
        runs once, whichever thread gets here first."""
        with self._finish_lock:
            if self._finished:
                return
            self._finished = True
        self.wall_ms = (time.monotonic() - self.started) * 1e3
        t0 = time.perf_counter()
        self._registry.close_all(permanent=True)
        self.teardown_ms = (time.perf_counter() - t0) * 1e3
        _bump_global("queries", 1)
        _bump_global("teardown_ms", int(self.teardown_ms))
        if self.token.timed_out:
            _bump_global("timeouts", 1)
        elif self.token.cancelled:
            _bump_global("cancels", 1)
        self._observe_finish()

    def _observe_finish(self) -> None:
        try:
            from spark_rapids_tpu_torch.obs import journal, registry
            registry.record(registry.HIST_QUERY_WALL_US,
                            int(self.wall_ms * 1000))
            if not journal.enabled():
                return
            if self.token.timed_out:
                status = "timeout"
                journal.emit(journal.EVENT_QUERY_TIMEOUT,
                             query=self.query_id, reason=self.token._reason)
            elif self.token.cancelled:
                status = "cancelled"
                journal.emit(journal.EVENT_QUERY_CANCEL,
                             query=self.query_id, reason=self.token._reason)
            else:
                status = "error" if self.error is not None else "ok"
            if self.error is not None:
                journal.emit(journal.EVENT_QUERY_ERROR, query=self.query_id,
                             error=type(self.error).__name__,
                             message=str(self.error),
                             typed=isinstance(self.error, EngineError))
            journal.emit(journal.EVENT_QUERY_FINISH, query=self.query_id,
                         status=status, wall_ms=round(self.wall_ms, 3),
                         teardown_ms=round(self.teardown_ms, 3))
        except Exception as e:
            log.warning("query finish observation failed: %s", e)


# ---------------------------------------------------------------------------
# the current query of each thread
# ---------------------------------------------------------------------------

_CONTEXTS_LOCK = threading.Lock()
_CONTEXTS: Dict[int, QueryContext] = {}  # thread ident -> its query
_GLOBAL_REGISTRY = _Registry("global")


def current() -> Optional[QueryContext]:
    return _CONTEXTS.get(threading.get_ident())


def _set_current(qc: Optional[QueryContext]) -> Optional[QueryContext]:
    ident = threading.get_ident()
    with _CONTEXTS_LOCK:
        prev = _CONTEXTS.get(ident)
        if qc is None:
            _CONTEXTS.pop(ident, None)
        else:
            _CONTEXTS[ident] = qc
        return prev


@contextlib.contextmanager
def adopt(qc: Optional[QueryContext]):
    """Run the calling thread, one a query started, under that query's
    context (no-op for None); the query's scope still owns teardown."""
    if qc is None:
        yield
        return
    prev = _set_current(qc)
    try:
        yield
    finally:
        _set_current(prev)


def check_cancel() -> None:
    """The pull-boundary checkpoint: raises the thread's query's typed
    error once it is cancelled or past its deadline; one dict read when
    no query is supervised."""
    qc = current()
    if qc is not None:
        qc.check()


def cancel_requested() -> bool:
    """Whether the thread's query is cancelled or past its deadline (an
    abort predicate for a bounded wait)."""
    qc = current()
    return qc is not None and (qc.token.cancelled or qc.token.expired())


def poll_interval_s() -> float:
    """The poll slice of a bounded wait: the query's
    ``spark.rapids.sql.cancel.checkIntervalMs``, else ``WAIT_POLL_S``."""
    qc = current()
    return qc.check_interval_s if qc is not None else WAIT_POLL_S


def note_sem_wait(wait_ns: int) -> None:
    """Charge a semaphore wait to the waiting thread's query."""
    qc = current()
    if qc is not None:
        qc.sem_wait_ms += wait_ns // 1_000_000


def _configure_from_conf(conf) -> None:
    """Install what a query's conf sets process-wide, each only when
    its own keys are in the conf: a session that does not mention them
    leaves another session's injector or journal alone."""
    settings = conf.to_dict()
    if faults.has_fault_keys(conf):
        faults.configure_from_conf(settings)
    from spark_rapids_tpu_torch.conf import OBS_ENABLED, OBS_JOURNAL_DIR, \
        OBS_JOURNAL_MAX_EVENTS
    if OBS_ENABLED.key in settings:
        from spark_rapids_tpu_torch.obs import registry
        registry.set_enabled(conf.get(OBS_ENABLED))
    from spark_rapids_tpu_torch.obs import journal
    if OBS_JOURNAL_DIR.key in settings:
        journal.configure_from_conf(conf)
    elif OBS_JOURNAL_MAX_EVENTS.key in settings:
        journal.set_max_events(conf.get(OBS_JOURNAL_MAX_EVENTS))
    # the capacity ladder and the compile store are process-wide too; the
    # runtime outlives a session, so its start alone would miss a later
    # session's keys (the warm pool starts with a runtime or a server)
    from spark_rapids_tpu_torch import compile as compile_pkg
    compile_pkg.configure_from_conf(conf, start_warm=False)


@contextlib.contextmanager
def query_scope(conf=None, timeout_ms: Optional[int] = None):
    """A query's supervision scope.  A scope opened inside another
    reuses it: one query, one fault domain."""
    existing = current()
    if existing is not None:
        yield existing
        return
    if conf is not None:
        qc = QueryContext.from_conf(conf)
        _configure_from_conf(conf)
    else:
        qc = QueryContext(timeout_ms=timeout_ms or 0)
    from spark_rapids_tpu_torch.obs import journal
    if journal.enabled():
        journal.emit(journal.EVENT_QUERY_START, query=qc.query_id,
                     timeout_ms=int(qc.token.timeout_s * 1000),
                     hang_timeout_ms=int(qc.hang_timeout_s * 1000))
    prev = _set_current(qc)
    try:
        yield qc
    except BaseException as e:
        qc.error = e
        raise
    finally:
        _set_current(prev)
        qc.finish()


def register_resource(close: Callable[[], None], kind: str = "resource",
                      name: str = "") -> _Registration:
    """Register a closer with the thread's query, or with the module-wide
    registry outside a query; ``release()`` the handle once the resource
    closed itself."""
    qc = current()
    if qc is not None:
        return qc.register(close, kind, name)
    return _GLOBAL_REGISTRY.add(close, kind, name)


def register_thread(thread: threading.Thread,
                    stop: Optional[Callable[[], None]] = None,
                    join_timeout: float = 10.0) -> _Registration:
    """Register a thread: teardown calls ``stop`` and joins it, within
    ``join_timeout``."""
    def close():
        if stop is not None:
            stop()
        if thread.is_alive() and thread is not threading.current_thread():
            thread.join(timeout=join_timeout)
            if thread.is_alive():
                log.warning("lifecycle teardown: thread %r still alive "
                            "after %.1fs join", thread.name, join_timeout)
    return register_resource(close, kind="thread", name=thread.name)


_TRACKED_PROCS: "weakref.WeakSet" = weakref.WeakSet()


def track_process(proc) -> None:
    """Keep an engine-spawned process (a fleet replica), weakly, so that
    interpreter exit terminates it if its owner did not: the
    ``multiprocessing`` exit handler, which runs after ours, would join
    a live child without a bound."""
    _TRACKED_PROCS.add(proc)


def cancel_thread_queries(idents, reason: str) -> int:
    """Cancel the query each listed thread runs (the session server's
    close cancels its workers' queries so, and no other session's);
    each unwinds typed at its next checkpoint.  Returns how many."""
    idents = set(idents)
    with _CONTEXTS_LOCK:
        contexts = {id(qc): qc for ident, qc in _CONTEXTS.items()
                    if ident in idents}
    for qc in contexts.values():
        qc.cancel(reason)
    return len(contexts)


def shutdown_all() -> int:
    """Cancel and tear down every live query, whatever thread runs it,
    then close what was registered outside a query.  Each query's entry
    stays for its own thread's scope to pop, so that thread keeps seeing
    its token and unwinds typed.  Returns the resources closed."""
    with _CONTEXTS_LOCK:
        contexts = list({id(qc): qc for qc in _CONTEXTS.values()}.values())
    for qc in contexts:
        qc.cancel("session stopped")
    for qc in contexts:
        qc.finish()
    return len(contexts) + _GLOBAL_REGISTRY.close_all()


# ---------------------------------------------------------------------------
# the hang watchdog
# ---------------------------------------------------------------------------

def _park(gave_up: threading.Event, qc: Optional[QueryContext]) -> None:
    """The wedge an injected ``*.hang`` fault simulates: sleep in poll
    slices until the watchdog gives up, the query is cancelled or past
    its deadline, or the cap passes."""
    deadline = time.monotonic() + _PARK_CAP_S
    while time.monotonic() < deadline:
        if gave_up.is_set():
            return
        if qc is not None:
            qc.check()
        time.sleep(qc.check_interval_s if qc is not None else WAIT_POLL_S)


def supervise(fn: Callable, site: str = FAULT_SITE_PIPELINE_HANG):
    """``fn()`` bounded by the hang watchdog.  With no query watchdog and
    no fault at ``site`` it is a plain call.  A fired ``site`` trigger
    wedges the call (simulated).  With ``hangTimeoutMs`` > 0 the call
    runs on a supervised thread, and past the bound it raises
    ``QueryHangError`` (counted ``watchdog_trips``)."""
    qc = current()
    inj = faults.injector()
    fires = inj.enabled and inj.should_fire(site)
    timeout_s = qc.hang_timeout_s if qc is not None else 0.0
    if not fires and timeout_s <= 0:
        return fn()
    gave_up = threading.Event()

    def work():
        if fires:
            _park(gave_up, qc)
            if gave_up.is_set():
                return None  # given up on: the result is dead
        return fn()

    if timeout_s <= 0:
        return work()
    box: dict = {}
    done = threading.Event()

    def runner():
        with adopt(qc):
            try:
                box["value"] = work()
            except BaseException as e:
                box["error"] = e
            finally:
                done.set()

    t = threading.Thread(target=runner, name=WATCHDOG_THREAD_PREFIX + site,
                         daemon=True)
    reg = register_thread(t, stop=gave_up.set, join_timeout=1.0)
    if reg.rejected:
        if qc is not None:
            qc.check()
        raise QueryCancelledError(
            f"supervised call at {site} aborted by teardown")
    t.start()
    deadline = time.monotonic() + timeout_s
    slice_s = qc.check_interval_s if qc is not None else WAIT_POLL_S
    try:
        while not done.wait(timeout=slice_s):
            if qc is not None and (qc.token.cancelled or qc.token.expired()):
                gave_up.set()
                qc.check()
            if time.monotonic() > deadline:
                gave_up.set()
                _bump_global("watchdog_trips", 1)
                from spark_rapids_tpu_torch.obs import journal
                journal.emit(journal.EVENT_WATCHDOG_TRIP, site=site,
                             timeout_s=timeout_s)
                raise QueryHangError(site, timeout_s)
    finally:
        if done.is_set():
            reg.release()
    if "error" in box:
        raise box["error"]
    if fires and gave_up.is_set():
        # a teardown from another thread unparked the wedge: the runner
        # skipped the real work, so its None is no result
        if qc is not None:
            qc.check()
        raise QueryCancelledError(
            f"supervised call at {site} aborted by teardown")
    return box["value"]


def _at_exit(max_wait_s: float = 15.0) -> None:
    """Tear everything down at interpreter exit, and give a watchdog
    runner still inside device work a bounded time to return, and
    terminate the engine's processes still alive."""
    shutdown_all()
    for p in list(_TRACKED_PROCS):
        if p.is_alive():
            p.terminate()
            p.join(timeout=5)
            if p.is_alive():
                p.kill()
                p.join(timeout=5)
    deadline = time.monotonic() + max_wait_s
    for t in threading.enumerate():
        if not t.name.startswith(WATCHDOG_THREAD_PREFIX):
            continue
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            break
        t.join(timeout=remaining)


atexit.register(_at_exit)
