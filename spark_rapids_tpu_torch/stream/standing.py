"""Standing queries: register and retire, bootstrap, and the poll loop.

Counterpart of ``spark_rapids_tpu/stream/standing.py``.  A
``StandingQueryRegistry`` hangs off one ``SessionServer``
(``server.streaming``, with ``spark.rapids.stream.enabled``):

* ``register_source(path, fmt)`` starts tailing a parquet, ORC or CSV
  root; ``register(query)`` takes SQL text, a DataFrame or a prepared
  statement with its values, binds it to the source tailing its file
  leaf (registering one for a plan of one leaf), analyzes it
  (``plan/incremental.py``) and bootstraps it over the source's
  committed snapshot, so the first poll's delta starts where the
  bootstrap ended;
* one poller thread (``THREAD_NAME``, registered with the lifecycle, so
  ``session.stop()`` joins it) ticks every
  ``spark.rapids.stream.pollIntervalMs``: each source polls (the
  ``stream.poll`` fault site: an injected failure skips the tick,
  counted, nothing committed) and every bound query refreshes through
  ``server.submit``, with the tenant's admission and budget and the
  result cache bypassed;
* a refresh is incremental (``exec/incremental.py``), or a counted full
  recompute (a plan that cannot be incremental, the kill switch, a
  rewritten file, or the repair of a failed refresh), or a counted
  error that sets ``needs_recompute``: the next tick rebuilds the query
  from the committed snapshot even when no data arrived.

A refresh's lag (detection to done) goes into the ``stream.freshness.us``
histogram.  Results are ``HostResult``s.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, List, Optional

from spark_rapids_tpu_torch import faults, lifecycle
from spark_rapids_tpu_torch.conf import STREAM_INCREMENTAL, \
    STREAM_MAX_FILES_PER_TICK, STREAM_POLL_INTERVAL_MS, \
    STREAM_REFRESH_TIMEOUT_MS
from spark_rapids_tpu_torch.exec.incremental import IncrementalState
from spark_rapids_tpu_torch.io.prefetch import THREAD_PREFIX
from spark_rapids_tpu_torch.obs import journal
from spark_rapids_tpu_torch.obs import registry as obs
from spark_rapids_tpu_torch.plan import logical as lp
from spark_rapids_tpu_torch.plan.incremental import analyze, file_leaves, \
    substitute_leaf
from spark_rapids_tpu_torch.stream import stats as stream_stats
from spark_rapids_tpu_torch.stream.source import MicroBatch, \
    TailingSource, empty_leaf, leaf_format, new_files_leaf

log = logging.getLogger("spark_rapids_tpu_torch.stream.standing")

THREAD_NAME = THREAD_PREFIX + "stream-poller"


def _base_leaf(leaf: lp.LogicalPlan, files: List[str]) -> lp.LogicalPlan:
    """``leaf`` pinned to a committed file list (none: an empty
    relation of its schema)."""
    return new_files_leaf(leaf, files) if files else empty_leaf(leaf)


class StandingQuery:
    """One registered continuous query and its maintained result."""

    def __init__(self, name: str, tenant: str, plan: lp.LogicalPlan,
                 source: TailingSource, leaf: lp.LogicalPlan,
                 inc: Optional[IncrementalState], reason: str):
        self.name = name
        self.tenant = tenant
        self.plan = plan
        self.source = source
        self.leaf = leaf
        self.inc = inc                  # None: a recompute-only plan
        self.reason = reason            # why not incremental ("" if it is)
        self.retired = threading.Event()
        self.needs_recompute = False
        self.refreshes = 0
        self.errors = 0
        self.last_lag_ms: Optional[float] = None
        self.last_refresh_at: Optional[float] = None
        self._result = None

    @property
    def incremental(self) -> bool:
        return self.inc is not None

    def result(self):
        """The maintained result (a ``HostResult``): the last successful
        refresh, the bootstrap's until data arrives."""
        if self._result is None:
            raise RuntimeError(
                f"standing query {self.name!r} has no result "
                "(bootstrap failed or query retired before bootstrap)")
        return self._result

    def stats(self) -> dict:
        return {"name": self.name, "tenant": self.tenant,
                "incremental": self.incremental,
                "refreshes": self.refreshes, "errors": self.errors,
                "needs_recompute": self.needs_recompute,
                "last_lag_ms": self.last_lag_ms,
                "retired": self.retired.is_set()}


class StandingQueryRegistry:
    """The tailing sources, standing queries and poll loop of one
    session server."""

    def __init__(self, server):
        conf = server.session.conf
        self._server = server
        self._interval = conf.get(STREAM_POLL_INTERVAL_MS) / 1e3
        self._max_files = conf.get(STREAM_MAX_FILES_PER_TICK)
        self._incremental_on = conf.get(STREAM_INCREMENTAL)
        self._refresh_timeout = conf.get(STREAM_REFRESH_TIMEOUT_MS) / 1e3
        self._lock = threading.Lock()
        # one tick at a time: the poller's and a caller's
        self._tick_lock = threading.Lock()
        self._sources: Dict[tuple, TailingSource] = {}
        self._queries: Dict[str, StandingQuery] = {}
        self._seq = 0
        self._closed = threading.Event()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, name=THREAD_NAME,
                                        daemon=True)
        self._reg = lifecycle.register_thread(
            self._thread, stop=self._stop.set, join_timeout=10.0)
        if self._reg.rejected:
            # teardown raced the server's start: the registry is born
            # closed and never starts its poller
            self._closed.set()
            self._stop.set()
            self._reg = None
        else:
            self._thread.start()

    # -- registration -------------------------------------------------------

    def register_source(self, path, fmt: str = "parquet") -> TailingSource:
        """Start tailing one root; once per (format, paths)."""
        if self._closed.is_set():
            raise RuntimeError("standing-query registry is closed")
        src = TailingSource(path, fmt, self._max_files,
                            device=self._server.session.device)
        with self._lock:
            existing = self._sources.get(src.key)
            if existing is not None:
                return existing
            self._sources[src.key] = src
            n = len(self._sources)
        stream_stats.bump("sources")
        stream_stats.set_gauge("sources_active", n)
        return src

    def _source_for(self, leaf: lp.LogicalPlan) -> Optional[TailingSource]:
        p = leaf.paths
        key = (leaf_format(leaf),
               tuple(p) if isinstance(p, (list, tuple)) else (p,))
        with self._lock:
            return self._sources.get(key)

    def register(self, query, name: Optional[str] = None,
                 tenant: str = "default",
                 params: tuple = ()) -> StandingQuery:
        """Register a standing query (SQL text, a DataFrame, or a
        PreparedStatement with ``params``) and bootstrap it over its
        source's committed snapshot."""
        if self._closed.is_set():
            raise RuntimeError("standing-query registry is closed")
        plan = self._resolve(query, params).plan
        leaves = file_leaves(plan)
        bound = [(lf, s) for lf in leaves
                 for s in (self._source_for(lf),) if s is not None]
        if len(bound) == 1:
            leaf, source = bound[0]
        elif not bound and len(leaves) == 1:
            leaf = leaves[0]
            source = self.register_source(leaf.paths, leaf_format(leaf))
        else:
            raise ValueError(
                "cannot bind the standing query to a tailing source: "
                f"{len(leaves)} file leaves, {len(bound)} matching "
                "registered sources (register_source the streamed root "
                "first; exactly one leaf must match)")
        rewrite, reason = None, "incremental refresh disabled (kill switch)"
        if self._incremental_on:
            rewrite, reason = analyze(plan, stream_leaf=leaf)
        with self._lock:
            if name is None:
                self._seq += 1
                name = f"sq-{self._seq}"
            if name in self._queries:
                raise ValueError(
                    f"standing query {name!r} already registered")
        q = StandingQuery(name, tenant, plan, source, leaf,
                          IncrementalState(rewrite)
                          if rewrite is not None else None, reason)
        self._bootstrap(q)
        with self._lock:
            if name in self._queries:
                raise ValueError(
                    f"standing query {name!r} already registered")
            self._queries[name] = q
            n = len(self._queries)
        stream_stats.bump("registered")
        stream_stats.set_gauge("standing_active", n)
        journal.emit(journal.EVENT_STANDING_REGISTER, name=name,
                     tenant=tenant, incremental=q.incremental,
                     reason=q.reason or None)
        return q

    def retire(self, name: str) -> None:
        with self._lock:
            q = self._queries.pop(name, None)
            n = len(self._queries)
        if q is None:
            raise KeyError(f"no standing query {name!r}")
        q.retired.set()
        stream_stats.bump("retired")
        stream_stats.set_gauge("standing_active", n)
        journal.emit(journal.EVENT_STANDING_RETIRE, name=name,
                     tenant=q.tenant, refreshes=q.refreshes)

    def query(self, name: str) -> StandingQuery:
        with self._lock:
            q = self._queries.get(name)
        if q is None:
            raise KeyError(f"no standing query {name!r}")
        return q

    def stats(self) -> dict:
        with self._lock:
            return {"sources": len(self._sources),
                    "queries": [q.stats() for q in self._queries.values()]}

    # -- execution ----------------------------------------------------------

    def _resolve(self, query, params: tuple):
        from spark_rapids_tpu_torch.api import DataFrame
        from spark_rapids_tpu_torch.server.prepared import PreparedStatement
        if isinstance(query, str):
            from spark_rapids_tpu_torch.sql import parse_sql
            return parse_sql(query, self._server.session,
                             params=list(params) if params else None)
        if isinstance(query, PreparedStatement):
            return query.bind(*params, session=self._server.session)
        if isinstance(query, DataFrame):
            return query
        raise TypeError(f"cannot register {type(query).__name__} as a "
                        "standing query")

    def _run(self, q: StandingQuery):
        """Each refresh step as a server submission of the query's
        tenant, the result cache bypassed."""
        def run(plan: lp.LogicalPlan):
            from spark_rapids_tpu_torch.api import DataFrame
            df = DataFrame(self._server.session, plan)
            ticket = self._server.submit(df, tenant=q.tenant,
                                         use_cache=False)
            return ticket.result(self._refresh_timeout)
        return run

    def _bootstrap(self, q: StandingQuery) -> None:
        base = _base_leaf(q.leaf, q.source.committed_files())
        run = self._run(q)
        if q.inc is not None:
            q._result = q.inc.bootstrap(run, base_leaf=base)
        else:
            q._result = run(substitute_leaf(q.plan, q.leaf, base))
        q.last_refresh_at = time.monotonic()

    def _recompute(self, q: StandingQuery, files: List[str]) -> None:
        base = _base_leaf(q.leaf, files)
        run = self._run(q)
        if q.inc is not None:
            fresh = IncrementalState(q.inc.rewrite)
            fresh.bootstrap(run, base_leaf=base)
            q.inc = fresh
            q._result = fresh.result
        else:
            q._result = run(substitute_leaf(q.plan, q.leaf, base))

    def _refresh(self, q: StandingQuery, batch: MicroBatch) -> bool:
        try:
            if (q.inc is None or q.needs_recompute or batch.rewritten
                    or not self._incremental_on):
                self._recompute(q, sorted(batch._snapshot))
                stream_stats.bump("recompute_refreshes")
            else:
                delta = q.source.delta_leaf(batch, q.leaf)
                q._result = q.inc.apply_delta(self._run(q), delta)
                stream_stats.bump("incremental_refreshes")
        except Exception as e:
            q.errors += 1
            q.needs_recompute = True
            stream_stats.bump("refresh_errors")
            log.warning("standing query %r refresh failed (%s); full "
                        "recompute on the next tick", q.name, e)
            return False
        q.needs_recompute = False
        q.refreshes += 1
        q.last_refresh_at = time.monotonic()
        lag = q.last_refresh_at - batch.detected_at
        q.last_lag_ms = lag * 1e3
        stream_stats.bump("refreshes")
        obs.record(obs.HIST_STREAM_FRESHNESS_US, int(lag * 1e6))
        return True

    # -- the poll loop ------------------------------------------------------

    def _loop(self) -> None:
        while not self._stop.wait(self._interval):
            if self._closed.is_set() or self._server.closed:
                return
            try:
                self.tick()
            except Exception:
                # the loop outlives anything a tick raises; the sources'
                # and queries' failures are counted inside
                log.exception("stream tick failed; continuing")

    def tick(self) -> int:
        """One poll over every source (the poller's, or a caller's for a
        deterministic tick); the number of micro-batches consumed."""
        with self._tick_lock:
            return self._tick()

    def _tick(self) -> int:
        with self._lock:
            sources = list(self._sources.values())
        consumed = 0
        for src in sources:
            if self._closed.is_set() or self._server.closed:
                break
            try:
                batch = src.poll()
            except faults.InjectedFault as e:
                stream_stats.bump("tick_faults")
                log.warning("tailing poll failed (%s); tick skipped, "
                            "snapshot not advanced", e)
                continue
            bound = self._bound(src)
            if batch is None:
                stream_stats.bump("empty_ticks")
                # repair: a query whose last refresh failed rebuilds
                # from the committed snapshot without new data
                for q in bound:
                    if q.needs_recompute and not q.retired.is_set():
                        try:
                            self._recompute(q, src.committed_files())
                        except Exception as e:
                            q.errors += 1
                            stream_stats.bump("refresh_errors")
                            log.warning("standing query %r repair "
                                        "recompute failed: %s", q.name, e)
                        else:
                            q.needs_recompute = False
                            q.refreshes += 1
                            stream_stats.bump("refreshes")
                            stream_stats.bump("recompute_refreshes")
                continue
            consumed += 1
            stream_stats.bump("ticks")
            stream_stats.bump("batch_files", len(batch.new_files))
            stream_stats.bump("batch_grown", len(batch.grown))
            journal.emit(journal.EVENT_STREAM_TICK, fmt=src.fmt,
                         paths=str(src.paths),
                         new_files=len(batch.new_files),
                         grown=len(batch.grown),
                         rewritten=len(batch.rewritten),
                         queries=len(bound))
            for q in bound:
                if not q.retired.is_set():
                    self._refresh(q, batch)
            # commit whatever the queries did: a failed one is flagged
            # needs_recompute and rebuilds from the committed snapshot,
            # and a successful one must never see this delta again
            src.commit(batch)
        return consumed

    def _bound(self, src: TailingSource) -> List[StandingQuery]:
        with self._lock:
            return [q for q in self._queries.values() if q.source is src]

    # -- the end ------------------------------------------------------------

    @property
    def closed(self) -> bool:
        return self._closed.is_set()

    def close(self) -> None:
        if self._closed.is_set():
            return
        self._closed.set()
        self._stop.set()
        if self._thread.is_alive() \
                and self._thread is not threading.current_thread():
            self._thread.join(timeout=10.0)
        reg, self._reg = self._reg, None
        if reg is not None:
            reg.release()
