"""The multi-tenant session server.

Counterpart of ``spark_rapids_tpu/server/core.py``.  ``SessionServer``
takes SQL text, DataFrames and prepared statements with their bindings
(``submit``), admits them through the weighted-fair bounded queue
(``admission.py``) and runs them on a pool of worker threads, each
query through the same ``DataFrame`` path a single query takes: its own
``lifecycle.query_scope`` (deadline, cancel token, device budget,
resources), the device semaphore and the spill catalog.  So a result
from the server equals the one the session gives, bit for bit.

* A tenant's conf (its deadline, its budget) rides on a
  ``_TenantSession``: the base session's views, device and runtime with
  the tenant's keys laid over its conf for one query.
* A ticket (``ServerQuery``) ends with a ``HostResult`` or one error:
  ``AdmissionRejectedError``, ``QueryTimeoutError``,
  ``QueryCancelledError``, ``QueryBudgetExceededError``, an injected
  fault, or the query's own error.  Workers poll the queue, and
  ``close`` fails the tickets still queued, so no caller waits forever.
* Torch work from the workers shares the device's default stream, which
  serializes it as the JAX package's one device does; the spill
  catalog's transitions stay on that stream too.

* With ``spark.rapids.stream.enabled`` the server carries a
  standing-query registry (``streaming``, ``stream/standing.py``) and
  its poller thread, and with ``spark.rapids.stream.cache.maintain`` a
  stale result-cache entry whose input grew by new files on one leaf is
  maintained (the delta merged in, ``_try_maintain``) instead of
  recomputed.

Out of this slice, raising ``NotImplementedError`` when its key turns it
on (``ROADMAP.md``): the chip-health layer and the replay of chip-failed
queries (``spark.rapids.health.enabled``, queue A8).  The replay's keys,
``spark.rapids.server.retry.*``, are registered and engage only with
health.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional

from spark_rapids_tpu_torch import faults, lifecycle
from spark_rapids_tpu_torch.conf import (
    FLEET_RESULT_CACHE_DIR, FLEET_RESULT_CACHE_MAX_BYTES, HEALTH_ENABLED,
    QUERY_TIMEOUT_MS, SERVER_DEFAULT_WEIGHT, SERVER_MAX_CONCURRENCY,
    SERVER_QUERY_MAX_DEVICE_BYTES, SERVER_QUEUE_DEPTH, SERVER_RESULT_CACHE,
    SERVER_RESULT_CACHE_BYTES, SERVER_RESULT_CACHE_ENTRIES,
    SERVER_TENANT_PREFIX, SERVER_TENANT_TIMEOUT_MS, STREAM_CACHE_MAINTAIN,
    STREAM_ENABLED,
)
from spark_rapids_tpu_torch.errors import AdmissionRejectedError
from spark_rapids_tpu_torch.io.prefetch import THREAD_PREFIX
from spark_rapids_tpu_torch.obs import journal
from spark_rapids_tpu_torch.obs import registry as obs
from spark_rapids_tpu_torch.server import stats
from spark_rapids_tpu_torch.server.admission import FairAdmissionQueue
from spark_rapids_tpu_torch.server.prepared import PreparedStatement
from spark_rapids_tpu_torch.server.result_cache import DiskResultTier, \
    ResultCache

FAULT_SITE_ADMIT = "server.admit"

WORKER_THREAD_PREFIX = THREAD_PREFIX + "server-worker-"

# how long a stop can go unseen by an idle worker
_POLL_S = 0.1


class ServerQuery:
    """The ticket of one submitted query: ``result()`` waits for its
    ``HostResult`` or raises its one error."""

    __slots__ = ("tenant", "kind", "payload", "params", "timeout_ms",
                 "use_cache", "submitted_at", "started_at", "finished_at",
                 "cache_hit", "_done", "_result", "_error")

    def __init__(self, tenant: str, kind: str, payload, params: tuple,
                 timeout_ms: Optional[int], use_cache: bool = True):
        self.tenant = tenant
        self.use_cache = use_cache
        self.kind = kind            # "sql" | "df" | "prepared"
        self.payload = payload
        self.params = params
        self.timeout_ms = timeout_ms
        self.submitted_at = time.monotonic()
        self.started_at: Optional[float] = None
        self.finished_at: Optional[float] = None
        self.cache_hit = False
        self._done = threading.Event()
        self._result = None
        self._error: Optional[BaseException] = None

    def done(self) -> bool:
        return self._done.is_set()

    @property
    def latency_ms(self) -> Optional[float]:
        if self.finished_at is None:
            return None
        return (self.finished_at - self.submitted_at) * 1e3

    def result(self, timeout: Optional[float] = None):
        if not self._done.wait(timeout=timeout):
            raise TimeoutError(
                f"query not finished within {timeout}s (still "
                f"{'running' if self.started_at else 'queued'})")
        if self._error is not None:
            raise self._error
        return self._result

    def _complete(self, result) -> None:
        self.finished_at = time.monotonic()
        self._result = result
        self._done.set()

    def _fail(self, exc: BaseException) -> None:
        self.finished_at = time.monotonic()
        self._error = exc
        self._done.set()


class _TenantSession:
    """One query's view of the base session with a tenant's conf laid
    over: two tenants' deadlines or budgets differ without either
    changing the shared session."""

    def __init__(self, base, conf):
        self._base = base
        self.conf = conf
        self._last_plan = None
        self._last_query = None

    def __getattr__(self, name):
        return getattr(self._base, name)


class SessionServer:
    """A serving front end over one ``TorchSession``."""

    def __init__(self, session, max_concurrency: Optional[int] = None):
        conf = session.conf
        if conf.get(HEALTH_ENABLED):
            raise NotImplementedError(
                "spark.rapids.health.enabled: the chip failure domain and "
                "the replay of chip-failed queries are not in the torch "
                "port (ROADMAP.md, queue A8: the multi-GPU slice)")
        self.session = session
        self._streaming = None
        # the fault sites before any query (server.admit) need the
        # injector now; a conf without fault keys leaves it alone
        if faults.has_fault_keys(conf):
            faults.configure_from_conf(conf)
        # the compile store and its warm pool at server start, so a
        # restarted server or a fleet replica loads and launches its
        # kernels before its first query (compile/)
        from spark_rapids_tpu_torch import compile as compile_pkg
        compile_pkg.configure_from_conf(conf, session.device)
        self._draining = threading.Event()
        # close() and drain() claim the end under this lock, so racing
        # callers make one sweep of each
        self._close_lock = threading.Lock()
        self._queue = FairAdmissionQueue(conf.get(SERVER_QUEUE_DEPTH),
                                         conf.get(SERVER_DEFAULT_WEIGHT),
                                         self._tenant_weights(conf))
        self._cache: Optional[ResultCache] = None
        if conf.get(SERVER_RESULT_CACHE):
            disk_dir = conf.get(FLEET_RESULT_CACHE_DIR)
            disk = DiskResultTier(disk_dir, conf.get(
                FLEET_RESULT_CACHE_MAX_BYTES)) if disk_dir else None
            self._cache = ResultCache(conf.get(SERVER_RESULT_CACHE_ENTRIES),
                                      conf.get(SERVER_RESULT_CACHE_BYTES),
                                      disk=disk)
        if max_concurrency is None:
            n = conf.get(SERVER_MAX_CONCURRENCY)
            if n <= 0:
                # twice the device's permits: a query pulling its result
                # never leaves the device idle
                n = 2 * session.runtime.semaphore.permits
        else:
            n = int(max_concurrency)  # 0: no workers (tests drain by hand)
        self._closed = threading.Event()
        self._inflight = 0
        self._inflight_lock = threading.Lock()
        self._threads = []
        # session.stop() reaches close() through the lifecycle registry
        # too, so the workers are joined even if the caller forgets
        self._reg = lifecycle.register_resource(self.close, kind="server",
                                                name="session-server")
        if self._reg.rejected:
            self._closed.set()
            return
        for i in range(max(0, n)):
            t = threading.Thread(target=self._worker,
                                 name=f"{WORKER_THREAD_PREFIX}{i}",
                                 daemon=True)
            self._threads.append(t)
            t.start()
        if conf.get(STREAM_ENABLED):
            from spark_rapids_tpu_torch.stream.standing import \
                StandingQueryRegistry
            self._streaming = StandingQueryRegistry(self)
        stats.bump("servers")

    @staticmethod
    def _tenant_weights(conf) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for key, value in conf.to_dict().items():
            if key.startswith(SERVER_TENANT_PREFIX) \
                    and key.endswith(".weight"):
                out[key[len(SERVER_TENANT_PREFIX):-len(".weight")]] = \
                    int(value)
        return out

    @property
    def closed(self) -> bool:
        return self._closed.is_set()

    @property
    def streaming(self):
        """The standing-query registry; raises unless the server was
        built with ``spark.rapids.stream.enabled``."""
        if self._streaming is None:
            raise RuntimeError(
                "streaming is disabled: set spark.rapids.stream.enabled "
                "before building the server")
        return self._streaming

    # -- submission ---------------------------------------------------------

    def submit(self, query, tenant: str = "default",
               timeout_ms: Optional[int] = None,
               params: Optional[tuple] = None,
               use_cache: bool = True) -> ServerQuery:
        """Admit a query (SQL text, a DataFrame, or a PreparedStatement
        with ``params``) into the fair queue; its ticket (``use_cache``
        False: the result cache is neither read nor written).  Raises
        ``AdmissionRejectedError`` when it is shed, and ``InjectedFault``
        when the ``server.admit`` site fires: both before anything is
        queued."""
        if self._closed.is_set():
            raise AdmissionRejectedError(
                "session server is stopped; query not admitted")
        if self._draining.is_set():
            raise AdmissionRejectedError(
                "session server is draining; query not admitted")
        faults.maybe_fail(FAULT_SITE_ADMIT, "injected admission failure "
                          f"(tenant {tenant!r})")
        stats.bump("submitted")
        if isinstance(query, str):
            kind = "sql"
        elif isinstance(query, PreparedStatement):
            kind = "prepared"
        else:
            kind = "df"
        ticket = ServerQuery(tenant, kind, query, tuple(params or ()),
                             timeout_ms, use_cache)
        try:
            self._queue.offer(tenant, ticket)
        except AdmissionRejectedError:
            stats.bump("rejected")
            journal.emit(journal.EVENT_QUERY_REJECTED, tenant=tenant,
                         waiting=self._queue.size(), depth=self._queue.depth)
            raise
        stats.bump("admitted")
        journal.emit(journal.EVENT_QUERY_ADMITTED, tenant=tenant, kind=kind,
                     waiting=self._queue.size())
        return ticket

    def sql(self, sql: str, tenant: str = "default",
            timeout_ms: Optional[int] = None,
            result_timeout: Optional[float] = None,
            params: Optional[tuple] = None):
        """``submit`` and wait for the result."""
        return self.submit(sql, tenant=tenant, timeout_ms=timeout_ms,
                           params=params).result(result_timeout)

    def prepare(self, sql: str) -> PreparedStatement:
        return PreparedStatement(self.session, sql)

    # -- the workers --------------------------------------------------------

    def _worker(self) -> None:
        def claim():
            # under the queue's lock at the pop: a ticket is always
            # either queued (close fails it) or counted in flight
            with self._inflight_lock:
                self._inflight += 1

        while True:
            got = self._queue.take(timeout=_POLL_S, on_dispatch=claim)
            if got is None:
                if self._closed.is_set() or self._queue.closed:
                    return
                continue
            _tenant, ticket = got
            try:
                self._execute(ticket)
            finally:
                with self._inflight_lock:
                    self._inflight -= 1

    def _execute(self, ticket: ServerQuery) -> None:
        """Run one admitted query to its end on the ticket; the worker
        survives whatever the query raises."""
        ticket.started_at = time.monotonic()
        obs.record(obs.HIST_SERVER_ADMIT_WAIT_US,
                   int((ticket.started_at - ticket.submitted_at) * 1e6))
        try:
            view = _TenantSession(self.session, self._tenant_conf(
                ticket.tenant, ticket.timeout_ms))
            df = self._resolve(ticket, view)
            key = None
            pins: tuple = ()
            leaves = None
            if self._cache is not None and ticket.use_cache:
                maintain = self._streaming is not None \
                    and view.conf.get(STREAM_CACHE_MAINTAIN)
                key, pins, leaves = self._cache_key(
                    df, ticket.params, view.conf)
                if not maintain:
                    leaves = None
                if key is not None:
                    hit = self._cache.lookup(key)
                    if hit is not None:
                        journal.emit(journal.EVENT_CACHE_HIT,
                                     tenant=ticket.tenant)
                        ticket.cache_hit = True
                        stats.bump("completed")
                        ticket._complete(hit)
                        return
                    journal.emit(journal.EVENT_CACHE_MISS,
                                 tenant=ticket.tenant)
                    if maintain:
                        result = self._try_maintain(df, key, pins, leaves,
                                                    view, ticket.tenant)
                        if result is not None:
                            stats.bump("completed")
                            ticket._complete(result)
                            return
            result = df._host()
            if key is not None:
                self._cache.put(key, result, pins, leaves=leaves)
            stats.bump("completed")
            ticket._complete(result)
        except BaseException as e:
            stats.bump("failed")
            ticket._fail(e)

    def _resolve(self, ticket: ServerQuery, view: _TenantSession):
        from spark_rapids_tpu_torch.api import DataFrame
        if ticket.kind == "sql":
            from spark_rapids_tpu_torch.sql import parse_sql
            # SQL text may carry ? markers with the values in params
            return parse_sql(ticket.payload, view,
                             params=list(ticket.params)
                             if ticket.params else None)
        if ticket.kind == "prepared":
            return ticket.payload.bind(*ticket.params, session=view)
        # a DataFrame of the base session, moved onto the tenant's view
        return DataFrame(view, ticket.payload.plan)

    def _tenant_conf(self, tenant: str, timeout_ms: Optional[int]):
        """The base conf with the tenant's deadline and budget laid
        over, for the query's ``QueryContext``."""
        base = self.session.conf
        raw = base.to_dict()
        overlay: Dict[str, object] = {}
        if timeout_ms is None:
            per = raw.get(f"{SERVER_TENANT_PREFIX}{tenant}.timeoutMs")
            if per is not None:
                timeout_ms = int(per)
            elif base.get(SERVER_TENANT_TIMEOUT_MS) > 0:
                timeout_ms = base.get(SERVER_TENANT_TIMEOUT_MS)
        if timeout_ms is not None:
            overlay[QUERY_TIMEOUT_MS.key] = int(timeout_ms)
        budget = raw.get(f"{SERVER_TENANT_PREFIX}{tenant}.maxDeviceBytes")
        if budget is not None:
            overlay[SERVER_QUERY_MAX_DEVICE_BYTES.key] = int(budget)
        return base.with_settings(overlay) if overlay else base

    @staticmethod
    def _cache_key(df, params: tuple, conf):
        """``(key, pins, leaves)``; ``(None, (), None)`` when the query
        cannot be cached."""
        from spark_rapids_tpu_torch.plan.fingerprint import (
            bound_param_values, conf_fingerprint, plan_fingerprint,
            snapshot_detail,
        )
        snap, pins, leaves = snapshot_detail(df.plan)
        if snap is None:
            return None, (), None
        try:
            # the values read from the plan itself: a DataFrame made by
            # stmt.bind(x) and submitted with no params never meets
            # another binding's entry
            key = (plan_fingerprint(df.plan), snap, conf_fingerprint(conf),
                   params, bound_param_values(df.plan))
            hash(key)
        except (TypeError, ValueError, RecursionError):
            # an unhashable binding, or a plan too deep to fingerprint:
            # no caching
            return None, (), None
        return key, pins, leaves

    # -- maintained cache entries -------------------------------------------

    def _try_maintain(self, df, key, pins, leaves, view, tenant: str):
        """The stale entry of the same query maintained in place, when the
        live snapshot differs from its own by new files on one leaf only
        and the plan can be maintained; else None, counted a fallback,
        and the caller recomputes."""
        from spark_rapids_tpu_torch.stream import stats as stream_stats
        cand = self._cache.maintain_candidate(key)
        if cand is None:
            return None
        old_key, old_result, old_leaves = cand
        if leaves is None or len(old_leaves) != len(leaves):
            stream_stats.bump("cache_maintain_fallbacks")
            return None
        # one plan fingerprint, one leaf order: the snapshots zip
        changed = []
        for (new_leaf, new_pairs), (_old, old_pairs) in zip(leaves,
                                                            old_leaves):
            old_map, new_map = dict(old_pairs), dict(new_pairs)
            if any(new_map.get(p) != tok for p, tok in old_map.items()):
                stream_stats.bump("cache_maintain_fallbacks")
                return None  # a committed file changed or vanished
            appended = [p for p, _ in new_pairs if p not in old_map]
            if appended:
                changed.append((new_leaf, appended))
        if len(changed) != 1:
            stream_stats.bump("cache_maintain_fallbacks")
            return None
        leaf, appended = changed[0]
        result = self._maintain_delta(df, leaf, appended, old_result, view)
        if result is None:
            stream_stats.bump("cache_maintain_fallbacks")
            return None
        self._cache.replace(old_key, key, result, pins, leaves=leaves)
        stream_stats.bump("cache_maintains")
        journal.emit(journal.EVENT_CACHE_MAINTAIN, tenant=tenant,
                     files=len(appended))
        return result

    def _maintain_delta(self, df, leaf, appended, old_result, view):
        """The cached result with the appended files merged in, or None
        when the plan cannot be maintained without stored state: an
        append-mode plan (old ++ delta), or a mergeable aggregate whose
        result still holds its whole state (the chain above it only
        renames columns, and no Average)."""
        from spark_rapids_tpu_torch.api import DataFrame
        from spark_rapids_tpu_torch.exec.incremental import cast_result, \
            concat_results
        from spark_rapids_tpu_torch.plan import incremental as inc
        from spark_rapids_tpu_torch.stream.source import new_files_leaf
        rewrite, _ = inc.analyze(df.plan, stream_leaf=leaf)
        if rewrite is None:
            return None
        delta_leaf = new_files_leaf(leaf, appended)

        def run(plan):
            return DataFrame(view, plan)._host()

        if rewrite.kind == "append":
            return concat_results(old_result,
                                  run(rewrite.delta_plan(delta_leaf)))
        state = self._state_from_result(rewrite, old_result)
        if state is None:
            return None
        delta_state = run(rewrite.delta_state_plan(delta_leaf))
        merged = run(rewrite.merge_plan([state, delta_state]))
        return cast_result(run(rewrite.finalize_plan(merged)),
                           old_result.schema)

    @staticmethod
    def _state_from_result(rewrite, old_result):
        """The partial state rebuilt from a cached aggregate result, or
        None when the result does not determine it (an Average, or an
        upper chain that is not a bijection of column renames)."""
        from spark_rapids_tpu_torch.api import HostResult
        from spark_rapids_tpu_torch.columnar.dtypes import Field, Schema
        from spark_rapids_tpu_torch.exprs.base import Alias, \
            UnresolvedAttribute
        from spark_rapids_tpu_torch.plan import logical as lp
        if len(rewrite._state_aggs) != len(rewrite._agg.aggregates):
            return None
        agg_out = (list(rewrite._group_names)
                   + [a.out_name for a in rewrite._agg.aggregates])
        cols = [(n, n) for n in agg_out]
        for node in reversed(rewrite._upper):
            if not isinstance(node, lp.Project):
                return None  # a Filter drops groups: the state is gone
            byname = dict(cols)
            new = []
            for e in node.exprs:
                if isinstance(e, Alias) \
                        and isinstance(e.children[0], UnresolvedAttribute):
                    src, out = byname.get(e.children[0].col_name), \
                        e.out_name
                elif isinstance(e, UnresolvedAttribute):
                    src, out = byname.get(e.col_name), e.col_name
                else:
                    return None  # a computed column: not invertible
                if src is None:
                    return None
                new.append((out, src))
            cols = new
        srcs = [src for _, src in cols]
        if sorted(srcs) != sorted(agg_out):
            return None
        at = {src: i for i, (_, src) in enumerate(cols)}
        names = (list(rewrite._group_names)
                 + [a.out_name for a in rewrite._state_aggs])
        fields, out = [], {}
        for sn, src in zip(names, agg_out):
            f = old_result.schema[at[src]]
            fields.append(Field(sn, f.dtype, f.nullable))
            out[sn] = old_result.columns[f.name]
        return HostResult(Schema(fields), out)

    # -- stats and the end --------------------------------------------------

    def stats(self) -> dict:
        glob = stats.global_stats()
        out = {"workers": len(self._threads),
               "inflight": self._inflight,
               "closed": self._closed.is_set(),
               "draining": self._draining.is_set(),
               "queue": self._queue.stats(),
               "semaphore_available":
                   self.session.runtime.semaphore.available(),
               "prepared": glob["prepared"],
               "prepared_execs": glob["prepared_execs"]}
        if self._cache is not None:
            out["cache"] = self._cache.snapshot_stats()
        if self._streaming is not None:
            out["stream"] = self._streaming.stats()
        return out

    def drain(self, timeout: float = 60.0) -> float:
        """Stop admitting, fail the queued tickets typed, wait up to
        ``timeout`` for the queries in flight, then ``close()``; the
        milliseconds it took (0.0 when another caller got here first)."""
        with self._close_lock:
            if self._closed.is_set() or self._draining.is_set():
                return 0.0
            self._draining.set()
        t0 = time.perf_counter()
        journal.emit(journal.EVENT_SERVER_DRAIN, phase="start",
                     inflight=self._inflight, queued=self._queue.size())
        for _tenant, ticket in self._queue.close_and_drain():
            stats.bump("failed")
            ticket._fail(AdmissionRejectedError(
                "session server draining; queued query rejected"))
        deadline = time.monotonic() + max(0.0, float(timeout))
        while time.monotonic() < deadline:
            with self._inflight_lock:
                if self._inflight == 0:
                    break
            time.sleep(0.02)
        self.close()
        ms = (time.perf_counter() - t0) * 1e3
        journal.emit(journal.EVENT_SERVER_DRAIN, phase="done",
                     ms=round(ms, 3))
        return ms

    def close(self) -> None:
        """Stop admitting, fail the queued tickets typed, cancel the
        workers' queries in flight (theirs only), join the workers and
        drop the cache.  Runs once; ``session.stop()`` calls it."""
        with self._close_lock:
            if self._closed.is_set():
                return
            self._closed.set()
        streaming = getattr(self, "_streaming", None)
        if streaming is not None:
            # the poller first: it submits to the queue about to close
            streaming.close()
        for _tenant, ticket in self._queue.close_and_drain():
            stats.bump("failed")
            ticket._fail(AdmissionRejectedError(
                "session server stopped before the query was dispatched"))
        lifecycle.cancel_thread_queries(
            (t.ident for t in self._threads if t.ident is not None),
            "session server stopped")
        for t in self._threads:
            t.join(timeout=10.0)
        if self._cache is not None:
            self._cache.clear()
        reg = getattr(self, "_reg", None)
        if reg is not None:
            reg.release()
