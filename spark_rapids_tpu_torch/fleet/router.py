"""FleetRouter: the serving fleet's front door.

Counterpart of ``spark_rapids_tpu/fleet/router.py``.  R spawned replica
processes (``replica.py``), each with its own ``TorchSession`` and
``SessionServer``, behind one router; each replica is a failure domain.
The router spawns (``multiprocessing.get_context("spawn")``), never
forks: the parent may hold a CUDA context already, which a forked child
cannot use.

* **Routing and overflow**: tenant-aware stride routing with the
  admission queue's arithmetic (``server/admission.py``).  Each tenant
  keeps an exact ``Fraction`` virtual time a replica; a submit goes to
  the routable replica with the tenant's smallest time (the lower index
  on a tie, so placement is deterministic), whose time advances by
  1/weight; a replica on probation carries half weight.  A pick at its
  ``fleet.routing.queueDepth`` bound overflows to the next with room;
  only when every routable replica is full is the query shed
  (``AdmissionRejectedError``).  A replica's own queue-full shed
  re-routes the same way.
* **Health**: the pump thread reads heartbeats and
  ``Process.exitcode`` (a silent replica is terminated before it is
  declared dead) and feeds each replica's EWMA score
  (``fleet/health.py``) from dispatch outcomes and the injected
  ``replica.fail`` / ``replica.slow`` sites.  Below the threshold a
  replica is quarantined: routed around, probed after probation,
  re-admitted on probation.
* **Failover**: a query in flight on a dead or failed replica replays
  once on a healthy one under the tenant's rolling retry budget
  (``fleet.retry.*``).  Results come back whole through the status
  queue, so a query in flight has surfaced nothing.  Past the budget or
  the attempts it fails typed (``RetryBudgetExhaustedError`` /
  ``ReplicaFailedError``).
* **Rolling restart**: ``rolling_restart()`` takes one replica at a time
  out of routing, drains it (``SessionServer.drain()``; its rejected
  queued tickets re-route), boots the replacement and sends it a probe
  query before the slot takes traffic again.

The front door takes SQL (and ``?`` parameters): a DataFrame is an
object graph of one process, SQL text travels.  A result comes back as
the port's ``HostResult`` (numpy columns; no pyarrow on the card's
machine) over the status queue; the typed errors pickle whole
(``errors.py``).
"""

from __future__ import annotations

import logging
import multiprocessing as mp
import queue as _queue
import threading
import time
from fractions import Fraction
from typing import Dict, List, Optional, Set, Tuple

from spark_rapids_tpu_torch import faults, lifecycle
from spark_rapids_tpu_torch.conf import (
    FLEET_HEALTH_PROBATION_MS, FLEET_HEALTH_QUARANTINE_THRESHOLD,
    FLEET_HEALTH_SCORE_ALPHA, FLEET_HEARTBEAT_TIMEOUT_MS,
    FLEET_QUEUE_DEPTH, FLEET_REPLICAS, FLEET_RETRY_BUDGET_PER_MIN,
    FLEET_RETRY_MAX_ATTEMPTS, FLEET_STARTUP_TIMEOUT_MS, SERVER_ENABLED,
    TorchConf,
)
from spark_rapids_tpu_torch.errors import (
    AdmissionRejectedError, ReplicaFailedError,
    RetryBudgetExhaustedError,
)
from spark_rapids_tpu_torch.faults import InjectedFault
from spark_rapids_tpu_torch.fleet import stats
from spark_rapids_tpu_torch.fleet.health import (
    OUTCOME_FAIL, OUTCOME_SLOW, OUTCOME_SUCCESS, ReplicaHealthTracker,
)
from spark_rapids_tpu_torch.fleet.replica import _THREAD_PREFIX, \
    _replica_main
from spark_rapids_tpu_torch.obs import journal

log = logging.getLogger("spark_rapids_tpu_torch.fleet")

FAULT_SITE_ROUTE = "fleet.route"
FAULT_SITE_REPLICA_FAIL = "replica.fail"
FAULT_SITE_REPLICA_SLOW = "replica.slow"

# outcome credit a dispatch response earns: deliberately lighter than a
# full-strength success so persistent replica.slow marks (weight 1.0)
# can still drag a score toward quarantine between responses
_RESPONSE_WEIGHT = 0.25
_PROBE_TIMEOUT_S = 60.0
_POLL_S = 0.25


class FleetQuery:
    """One routed query's ticket: the client-facing handle.  Completion
    is an atomic first-writer-wins claim (the QueryContext.finish
    contract) — a failover resolving concurrently with a late replica
    response must produce exactly one outcome."""

    def __init__(self, tenant: str, sql: str, params: tuple):
        self.tenant = tenant
        self.sql = sql
        self.params = params
        self.attempts = 0
        self.replica: Optional[int] = None
        self.reroutes = 0
        self._done = threading.Event()
        self._finish_lock = threading.Lock()
        self._result = None
        self._error: Optional[BaseException] = None

    def _complete(self, result) -> bool:
        with self._finish_lock:
            if self._done.is_set():
                return False
            self._result = result
            self._done.set()
            return True

    def _fail(self, exc: BaseException) -> bool:
        with self._finish_lock:
            if self._done.is_set():
                return False
            self._error = exc
            self._done.set()
            return True

    @property
    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: Optional[float] = None):
        """Block for the outcome: the ``HostResult``, or the typed error
        raised.  A ``timeout`` expiring raises ``TimeoutError`` (not an
        EngineError: an unresolved ticket is the caller's bound, not the
        engine's verdict)."""
        if not self._done.wait(
                timeout if timeout is not None else 3600.0):
            raise TimeoutError(
                f"fleet query for tenant {self.tenant!r} unresolved "
                f"after {timeout}s")
        if self._error is not None:
            raise self._error
        return self._result


class _ReplicaSlot:
    """Router-side state for one replica index: the process, its task
    queue, and liveness bookkeeping.  A slot outlives any single
    process — rolling restart re-populates it."""

    def __init__(self, idx: int):
        self.idx = idx
        self.proc = None
        self.task_q = None
        self.ready = threading.Event()
        self.last_hb = time.monotonic()
        self.generation = 0


class FleetRouter:
    """Front door over R SessionServer replica processes; constructed
    via ``session.fleet()`` with ``spark.rapids.fleet.replicas`` >= 1.
    """

    def __init__(self, session):
        conf: TorchConf = session.conf
        self._n = int(conf.get(FLEET_REPLICAS))
        if self._n < 1:
            raise ValueError(
                "session.fleet() needs spark.rapids.fleet.replicas >= 1")
        self._conf = conf
        # conf-driven fault injection must reach the router's own fleet
        # sites (fleet.route fires before any replica sees the query;
        # replica.fail/slow are consulted at dispatch) — same per-key
        # guard as SessionServer: a conf with no fault keys leaves a
        # directly-configured injector alone
        if any(k.startswith(faults.FAULTS_PREFIX)
               for k in conf.to_dict()):
            faults.configure_from_conf(conf)
        # the router's journal events (replica_quarantine/_restore/
        # _failover, fleet_rolling_restart) are emitted outside any
        # query scope, so the journal must be configured here when the
        # conf asks for one
        if any(k.startswith("spark.rapids.sql.obs.")
               for k in conf.to_dict()):
            journal.configure_from_conf(conf)
        self._depth = int(conf.get(FLEET_QUEUE_DEPTH))
        self._hb_timeout = conf.get(FLEET_HEARTBEAT_TIMEOUT_MS) / 1000.0
        self._startup_s = conf.get(FLEET_STARTUP_TIMEOUT_MS) / 1000.0
        self._retry_max = int(conf.get(FLEET_RETRY_MAX_ATTEMPTS))
        self._retry_budget = int(conf.get(FLEET_RETRY_BUDGET_PER_MIN))
        self._health = ReplicaHealthTracker(
            alpha=conf.get(FLEET_HEALTH_SCORE_ALPHA),
            threshold=conf.get(FLEET_HEALTH_QUARANTINE_THRESHOLD),
            probation_ms=conf.get(FLEET_HEALTH_PROBATION_MS))
        self._pending_faults: Tuple[dict, int] = ({}, 0)

        self._lock = threading.Lock()
        self._closed = threading.Event()
        self._stop = threading.Event()
        # tenant -> replica -> exact virtual time (the stride clock)
        self._vtimes: Dict[str, Dict[int, Fraction]] = {}
        # tid -> (ticket-or-None-for-probe, replica, kind, deadline)
        self._inflight: Dict[int, Tuple] = {}
        self._tid = 0
        self._dead: Set[int] = set()
        # slots deliberately taken out of routing (drain in progress /
        # deliberate exit): their process ending is not a death
        self._retiring: Set[int] = set()
        self._replay_lock = threading.Lock()
        self._replay_times: Dict[str, List[float]] = {}
        # tid -> [threading.Event, payload] for command acks the caller
        # blocks on (drained / stats / faults_ok)
        self._sync: Dict[int, list] = {}

        # the replicas' conf: the session's, verbatim (the device, the
        # faults, obs and fleet.resultCache keys ship), with the server
        # forced on: a replica is a server
        self._replica_conf = dict(conf.to_dict())
        self._replica_conf[SERVER_ENABLED.key] = "true"
        self._view_specs: List[tuple] = []

        self._ctx = mp.get_context("spawn")
        self._status_q = self._ctx.Queue(maxsize=4096)
        self._slots = {i: _ReplicaSlot(i) for i in range(self._n)}

        self._reg = lifecycle.register_resource(
            self.close, kind="fleet", name=f"fleet[{self._n}]")
        if self._reg.rejected:
            self._closed.set()
            raise AdmissionRejectedError(
                "lifecycle registry is closed; fleet not started")

        stats.bump("fleets")
        stats.set_gauge("replicas", self._n)

        self._pump = threading.Thread(
            target=self._pump_loop, name=f"{_THREAD_PREFIX}-pump",
            daemon=True)
        lifecycle.register_thread(self._pump, stop=self._stop.set)
        self._pump.start()

        try:
            for i in range(self._n):
                self._spawn(i)
            deadline = time.monotonic() + self._startup_s
            for i in range(self._n):
                slot = self._slots[i]
                while not slot.ready.wait(timeout=0.2):
                    p = slot.proc
                    if p is not None and p.exitcode is not None:
                        # died during boot: fail fast, don't burn the
                        # whole startup window
                        raise ReplicaFailedError(
                            i, f"replica {i} died during startup "
                               f"(exitcode={p.exitcode})")
                    if time.monotonic() > deadline:
                        raise ReplicaFailedError(
                            i, f"replica {i} not ready within "
                               f"{self._startup_s:.0f}s of spawn")
        except BaseException:
            self.close()
            raise

    # -- replica processes --------------------------------------------------

    def _spawn(self, idx: int) -> None:
        slot = self._slots[idx]
        slot.ready.clear()
        slot.task_q = self._ctx.Queue(maxsize=max(64, 4 * self._depth))
        slot.generation += 1
        p = self._ctx.Process(
            target=_replica_main,
            args=(idx, self._replica_conf, list(self._view_specs),
                  slot.task_q, self._status_q),
            name=f"{_THREAD_PREFIX}-replica-{idx}")
        p.start()
        lifecycle.track_process(p)
        slot.proc = p
        slot.last_hb = time.monotonic()

    def _send(self, idx: int, msg: tuple) -> bool:
        try:
            self._slots[idx].task_q.put(msg, timeout=5.0)
            return True
        except (OSError, ValueError, _queue.Full) as e:
            log.warning("send to replica %d failed: %s", idx, e)
            return False

    def replica_pid(self, idx: int) -> Optional[int]:
        """The replica process's OS pid (bench/test kill targeting)."""
        p = self._slots[idx].proc
        return p.pid if p is not None else None

    # -- routing ------------------------------------------------------------

    def _routable(self, idx: int) -> bool:
        return idx not in self._dead and idx not in self._retiring \
            and not self._health.is_quarantined(idx)

    def _routable_count(self) -> int:
        return sum(1 for i in range(self._n) if self._routable(i))

    def _inflight_count(self, idx: int) -> int:
        return sum(1 for (_t, r, _k, _d) in self._inflight.values()
                   if r == idx)

    def _pick(self, tenant: str, exclude: Set[int]) -> Optional[int]:
        """The stride pick: smallest per-tenant vtime among routable
        replicas (index tiebreak), overflowing past full replicas;
        ``None`` = nothing routable has capacity.  Advances the pick's
        vtime under the lock, like FairAdmissionQueue._pick."""
        with self._lock:
            vt = self._vtimes.setdefault(tenant, {})
            order = sorted(
                (vt.get(i, Fraction(0)), i) for i in range(self._n)
                if self._routable(i) and i not in exclude)
            if not order:
                return None
            for pos, (_v, i) in enumerate(order):
                if self._inflight_count(i) < self._depth:
                    if pos > 0:
                        stats.bump("overflowed")
                    # probation replicas ramp at half weight
                    w = Fraction(1, 2) if self._health.on_probation(i) \
                        else Fraction(1)
                    vt[i] = vt.get(i, Fraction(0)) + 1 / w
                    return i
            return None

    def _allow_failover(self, tenant: str) -> bool:
        """Per-tenant rolling-minute failover budget (the server's
        replay budget promoted to the replica domain)."""
        now = time.monotonic()
        with self._replay_lock:
            window = self._replay_times.setdefault(tenant, [])
            window[:] = [t for t in window if now - t < 60.0]
            if len(window) >= self._retry_budget:
                return False
            window.append(now)
            return True

    def submit(self, sql: str, tenant: str = "default",
               params: Optional[tuple] = None) -> FleetQuery:
        """Route one SQL query (+ optional prepared-template params)
        into the fleet; returns its ticket.  Raises typed BEFORE
        anything is dispatched on an injected ``fleet.route`` fire or
        when every routable replica is at its queue bound (the
        server.admit contract one tier up)."""
        if self._closed.is_set():
            raise AdmissionRejectedError(
                "fleet router is stopped; query not routed")
        if faults.should_fire(FAULT_SITE_ROUTE):
            stats.bump("route_faults")
            raise InjectedFault(
                FAULT_SITE_ROUTE,
                f"injected routing failure (tenant {tenant!r})")
        stats.bump("submitted")
        ticket = FleetQuery(tenant, sql, tuple(params or ()))
        self._dispatch(ticket, exclude=set(), sync_raise=True)
        return ticket

    def _dispatch(self, ticket: FleetQuery, exclude: Set[int],
                  budget_free: bool = False,
                  sync_raise: bool = False) -> None:
        """Pick a replica and send the query, consulting the replica
        fault sites per dispatch; an injected replica.fail fails over
        inline (budget-gated) exactly like a mid-flight death.  On a
        shed, ``sync_raise`` (the submit path, caller on the stack)
        raises typed; the async re-dispatch paths resolve the ticket
        instead — the pump thread has no caller to raise to."""
        exclude = set(exclude)
        while True:
            r = self._pick(ticket.tenant, exclude)
            if r is None:
                err = AdmissionRejectedError(
                    "no routable fleet replica with queue capacity "
                    f"(tenant {ticket.tenant!r}); retry with backoff")
                stats.bump("rejected")
                if sync_raise:
                    raise err
                self._finish_failed(ticket, err)
                return
            if faults.should_fire(FAULT_SITE_REPLICA_SLOW, replica=r):
                stats.bump("replica_slow_faults")
                self._health.record(r, OUTCOME_SLOW)
            if faults.should_fire(FAULT_SITE_REPLICA_FAIL, replica=r):
                stats.bump("replica_fail_faults")
                ticket.attempts += 1
                self._health.record(r, OUTCOME_FAIL)
                if not self._failover_allowed(ticket, budget_free,
                                              sync_raise):
                    return  # ticket resolved typed inside
                stats.bump("failovers")
                if journal.enabled():
                    journal.emit(journal.EVENT_REPLICA_FAILOVER,
                                 tenant=ticket.tenant, replica=r,
                                 cause="injected")
                exclude.add(r)
                continue
            ticket.attempts += 1
            ticket.replica = r
            with self._lock:
                self._tid += 1
                tid = self._tid
                self._inflight[tid] = (ticket, r, "query", None)
            if not self._send(r, ("sql", tid, ticket.sql,
                                  ticket.tenant, ticket.params)):
                with self._lock:
                    self._inflight.pop(tid, None)
                self._health.record(r, OUTCOME_FAIL)
                if not self._failover_allowed(ticket, budget_free,
                                              sync_raise):
                    return
                exclude.add(r)
                continue
            stats.bump("routed")
            return

    def _failover_allowed(self, ticket: FleetQuery,
                          budget_free: bool,
                          sync_raise: bool = False) -> bool:
        """Gate one more dispatch attempt past the attempts bound and
        the budget.  A shed raises typed when the submitter is on the
        stack (``sync_raise``), else resolves the ticket typed and
        returns False — the pump thread has no caller to raise to."""
        err: Optional[BaseException] = None
        if ticket.attempts >= self._retry_max:
            err = ReplicaFailedError(
                ticket.replica if ticket.replica is not None else -1,
                f"query failed on replica {ticket.replica} and its "
                f"{self._retry_max}-attempt bound is spent")
        elif not budget_free \
                and not self._allow_failover(ticket.tenant):
            err = RetryBudgetExhaustedError(
                f"tenant {ticket.tenant!r} exhausted its "
                f"{self._retry_budget}/min replica-failover budget")
        if err is None:
            return True
        stats.bump("failovers_shed")
        if sync_raise:
            stats.bump("failed")
            raise err
        self._finish_failed(ticket, err)
        return False

    def _finish_failed(self, ticket: FleetQuery,
                       exc: BaseException) -> None:
        if ticket._fail(exc):
            stats.bump("failed")

    # -- the pump: responses, heartbeats, liveness, probation ---------------

    def _pump_loop(self) -> None:
        while not self._stop.is_set():
            try:
                msg = self._status_q.get(timeout=_POLL_S)
            except (_queue.Empty, OSError, ValueError):
                msg = None
            if msg is not None:
                try:
                    self._handle(msg)
                except Exception:
                    log.exception("fleet pump failed handling %r",
                                  msg[0] if msg else msg)
            self._check_liveness()
            self._promote_due()
            stats.set_gauge("healthy_replicas", self._routable_count())

    def _handle(self, msg: tuple) -> None:
        kind, idx, payload = msg
        slot = self._slots.get(idx)
        if slot is None:
            return
        if kind == "hb":
            slot.last_hb = time.monotonic()
            snap = payload or {}
            total = int(snap.get("chips_total", 0) or 0)
            bad = int(snap.get("chips_quarantined", 0) or 0)
            if total and bad:
                # a partially degraded mesh dents the replica score in
                # proportion — one bad chip of eight is a slow mark at
                # 1/8 weight, a fully dark mesh is a near-full one
                self._health.record(idx, OUTCOME_SLOW,
                                    weight=bad / total)
        elif kind == "ready":
            slot.last_hb = time.monotonic()
            slot.ready.set()
        elif kind in ("result", "error"):
            slot.last_hb = time.monotonic()
            tid = payload[0]
            with self._lock:
                entry = self._inflight.pop(tid, None)
            if entry is None:
                return  # a stale generation's reply: already failed over
            ticket, r, ikind, _deadline = entry
            if ikind == "probe":
                self._health.probe_result(r, kind == "result")
                self._resolve_sync(tid, kind == "result")
                return
            self._health.record(r, OUTCOME_SUCCESS,
                                weight=_RESPONSE_WEIGHT)
            if kind == "result":
                if ticket._complete(payload[1]):
                    stats.bump("completed")
                return
            exc = payload[1]
            if isinstance(exc, AdmissionRejectedError) and \
                    not isinstance(exc, RetryBudgetExhaustedError) and \
                    ticket.reroutes < self._n:
                # the replica's OWN fair queue shed it (drain in
                # progress, or its depth beaten before ours): re-route
                # to a sibling — cross-replica overflow before any
                # typed shed reaches the client.  Planned drains are
                # not failures, so no budget is consumed.
                ticket.reroutes += 1
                ticket.attempts -= 1  # the shed attempt never ran
                if journal.enabled():
                    journal.emit(journal.EVENT_REPLICA_FAILOVER,
                                 tenant=ticket.tenant, replica=r,
                                 cause="requeue")
                self._dispatch(ticket, exclude={r}, budget_free=True)
                return
            if ticket._fail(exc):
                stats.bump("failed")
        elif kind in ("drained", "stats", "faults_ok"):
            slot.last_hb = time.monotonic()
            if kind == "faults_ok":
                self._resolve_sync(payload, True)
            else:
                self._resolve_sync(payload[0], payload[1])
        elif kind == "fatal":
            log.error("replica %d fatal: %s", idx, payload)
        # view_ok is informational

    def _resolve_sync(self, tid: int, payload) -> None:
        with self._lock:
            entry = self._sync.pop(tid, None)
        if entry is not None:
            entry[1] = payload
            entry[0].set()

    def _check_liveness(self) -> None:
        now = time.monotonic()
        for idx, slot in self._slots.items():
            if idx in self._dead or idx in self._retiring:
                continue
            p = slot.proc
            if p is None:
                continue
            if p.exitcode is not None:
                self._on_replica_dead(idx, "exit", p.exitcode)
            elif not slot.ready.is_set():
                # booting (engine import takes seconds): no heartbeats
                # yet; death-before-ready surfaces as a typed startup
                # timeout, not a silence declaration
                continue
            elif now - slot.last_hb > self._hb_timeout:
                # terminate-before-declare: a silent-but-alive replica
                # is about to lose its queries to a sibling; two
                # replicas answering the same tid must never race
                p.terminate()
                p.join(timeout=5.0)
                self._on_replica_dead(idx, "heartbeat_timeout", None)

    def _on_replica_dead(self, idx: int, cause: str,
                         exitcode: Optional[int]) -> None:
        with self._lock:
            if idx in self._dead:
                return
            self._dead.add(idx)
            orphans = [(tid, t, k) for tid, (t, r, k, _d)
                       in list(self._inflight.items()) if r == idx]
            for tid, _t, _k in orphans:
                self._inflight.pop(tid, None)
        stats.bump("replica_deaths")
        log.warning("replica %d declared dead (%s, exitcode=%s); "
                    "failing over %d in-flight queries",
                    idx, cause, exitcode, len(orphans))
        self._health.record(idx, OUTCOME_FAIL)
        for tid, ticket, ikind in orphans:
            if ikind == "probe":
                self._health.probe_result(idx, False)
                self._resolve_sync(tid, False)
                continue
            if ticket is None or ticket.done:
                continue
            # in flight on a dead replica: results arrive whole, so
            # nothing was surfaced — eligible for exactly-once replay
            # under the tenant's budget
            ticket.attempts = max(ticket.attempts, 1)
            if not self._failover_allowed(ticket, budget_free=False):
                continue
            stats.bump("failovers")
            if journal.enabled():
                journal.emit(journal.EVENT_REPLICA_FAILOVER,
                             tenant=ticket.tenant, replica=idx,
                             cause=cause)
            self._dispatch(ticket, exclude={idx}, budget_free=True)

    def _promote_due(self) -> None:
        # probation probes for quarantined-but-alive replicas
        for idx in self._health.due_for_probe():
            if idx in self._dead or idx in self._retiring:
                self._health.probe_result(idx, False)
                continue
            stats.bump("probes")
            with self._lock:
                self._tid += 1
                tid = self._tid
                self._inflight[tid] = (
                    None, idx, "probe",
                    time.monotonic() + _PROBE_TIMEOUT_S)
            if not self._send(idx, ("probe", tid)):
                with self._lock:
                    self._inflight.pop(tid, None)
                self._health.probe_result(idx, False)
        # expire probes a wedged replica never answered
        now = time.monotonic()
        with self._lock:
            expired = [(tid, r) for tid, (_t, r, k, d)
                       in self._inflight.items()
                       if k == "probe" and d is not None and now > d]
            for tid, _r in expired:
                self._inflight.pop(tid, None)
        for _tid, r in expired:
            self._health.probe_result(r, False)

    # -- views --------------------------------------------------------------

    def register_parquet_view(self, name: str, path: str) -> None:
        """Register a parquet temp view on every replica, and on every
        later replacement (the spec is kept).  The replicas read it
        with pyarrow, so it serves only where pyarrow is installed."""
        self._broadcast_view(("parquet", name, path))

    def register_table_view(self, name: str, columns,
                            masks=None) -> None:
        """Register a table of numpy columns (``create_dataframe``'s
        dict, with its masks) as a temp view on every replica; it ships
        whole to each process."""
        payload = columns if masks is None else (columns, masks)
        self._broadcast_view(("table", name, payload))

    def _broadcast_view(self, spec: tuple) -> None:
        self._view_specs.append(spec)
        for idx in range(self._n):
            if idx not in self._dead:
                self._send(idx, ("view", spec))

    # -- command round trips ------------------------------------------------

    def _roundtrip(self, idx: int, kind: str,
                   timeout: float):
        """Send a synchronous command and block for its ack payload;
        None on timeout/send failure."""
        with self._lock:
            self._tid += 1
            tid = self._tid
            entry = [threading.Event(), None]
            self._sync[tid] = entry
        if kind == "faults":
            ok = self._send(idx, ("faults", tid, *self._pending_faults))
        else:
            ok = self._send(idx, (kind, tid))
        if not ok or not entry[0].wait(timeout):
            with self._lock:
                self._sync.pop(tid, None)
            return None
        return entry[1]

    def replica_stats(self, idx: int,
                      timeout: float = 30.0) -> Optional[dict]:
        """One replica's engine stats (its server's and catalog's
        counters), its kernel launches (``kernels``) and its process
        (``process``: pid, device, modules loaded), from its process."""
        return self._roundtrip(idx, "stats", timeout)

    def configure_faults(self, specs: Dict[str, str], seed: int = 0,
                         timeout: float = 30.0) -> int:
        """Reconfigure every live replica's fault injector mid-run
        (chaos schedules, bench fault windows); returns how many
        replicas acked."""
        self._pending_faults = (dict(specs), int(seed))
        acked = 0
        for idx in range(self._n):
            if idx in self._dead or idx in self._retiring:
                continue
            if self._roundtrip(idx, "faults", timeout) is not None:
                acked += 1
        return acked

    # -- rolling restart ----------------------------------------------------

    def probe(self, idx: int, timeout: float = 60.0) -> bool:
        """One probe query through replica ``idx``'s full serving path;
        True iff it returned a result."""
        with self._lock:
            self._tid += 1
            tid = self._tid
            entry = [threading.Event(), None]
            self._sync[tid] = entry
            self._inflight[tid] = (None, idx, "probe",
                                   time.monotonic() + timeout)
        stats.bump("probes")
        if not self._send(idx, ("probe", tid)) or \
                not entry[0].wait(timeout):
            with self._lock:
                self._sync.pop(tid, None)
                self._inflight.pop(tid, None)
            return False
        return bool(entry[1])

    def replace_replica(self, idx: int,
                        drain: bool = False) -> float:
        """Replace the process in slot ``idx`` with a new one, returning
        the seconds from its spawn to its probe passing (its time to
        hot: a replacement loads the kernels ``native.py`` built before,
        from the compile store's directory when the conf names one).
        With ``drain`` the incumbent drains first (its queued tickets
        re-route, untyped to the client); otherwise the incumbent (dead
        or doomed) is terminated.  The slot takes no traffic until the
        replacement passes its probe query."""
        slot = self._slots[idx]
        with self._lock:
            self._retiring.add(idx)
        try:
            was_dead = idx in self._dead
            if drain and not was_dead and slot.proc is not None and \
                    slot.proc.exitcode is None:
                self._roundtrip(idx, "drain", self._startup_s)
            if slot.proc is not None:
                slot.proc.join(timeout=10.0)
                if slot.proc.exitcode is None:
                    slot.proc.terminate()
                    slot.proc.join(timeout=5.0)
            t0 = time.monotonic()
            self._health.forget(idx)
            self._spawn(idx)
            if not slot.ready.wait(self._startup_s):
                raise ReplicaFailedError(
                    idx, f"replacement replica {idx} not ready within "
                         f"{self._startup_s:.0f}s")
            if not self.probe(idx, timeout=self._startup_s):
                raise ReplicaFailedError(
                    idx, f"replacement replica {idx} failed its "
                         "readiness probe; slot stays out of routing")
            hot_s = time.monotonic() - t0
        finally:
            with self._lock:
                self._retiring.discard(idx)
        with self._lock:
            self._dead.discard(idx)
        stats.bump("replica_restarts")
        return hot_s

    def rolling_restart(self) -> dict:
        """Rolling restart without downtime: one replica at a time leaves
        routing, drains, and is replaced by a process that must pass a
        probe query before it takes traffic.  Queued work is never shed
        typed: a draining replica's rejects re-route.  Returns each
        replica's seconds from spawn to hot."""
        if journal.enabled():
            journal.emit(journal.EVENT_FLEET_ROLLING_RESTART,
                         phase="start", replicas=self._n)
        hot = {}
        for idx in range(self._n):
            hot[idx] = self.replace_replica(idx, drain=True)
            if journal.enabled():
                journal.emit(journal.EVENT_FLEET_ROLLING_RESTART,
                             phase="replica", replica=idx,
                             hot_s=round(hot[idx], 3))
        stats.bump("rolling_restarts")
        if journal.enabled():
            journal.emit(journal.EVENT_FLEET_ROLLING_RESTART,
                         phase="done", replicas=self._n)
        return hot

    # -- teardown -----------------------------------------------------------

    @property
    def closed(self) -> bool:
        return self._closed.is_set()

    def health_snapshot(self) -> dict:
        snap = self._health.snapshot()
        snap["dead"] = sorted(self._dead)
        return snap

    def close(self) -> None:
        """Stop the fleet: idempotent first-claim (two supervisors —
        the owning session and a lifecycle registry — may both call)."""
        with self._lock:
            if self._closed.is_set():
                return
            self._closed.set()
        # stop the pump FIRST: replicas exiting on command must not be
        # declared dead and trigger a failover storm into a closing fleet
        self._stop.set()
        pump = getattr(self, "_pump", None)
        if pump is not None:
            pump.join(timeout=10.0)
        for slot in self._slots.values():
            if slot.task_q is not None:
                try:
                    slot.task_q.put_nowait(("exit", -1))
                except (OSError, ValueError, _queue.Full) as e:
                    log.debug("exit message to replica %d failed: %s",
                              slot.idx, e)
        for slot in self._slots.values():
            p = slot.proc
            if p is None:
                continue
            p.join(timeout=10.0)
            if p.exitcode is None:
                p.terminate()
                p.join(timeout=5.0)
        with self._lock:
            leftovers = [(t, k) for (t, _r, k, _d)
                         in self._inflight.values()]
            self._inflight.clear()
            syncs = list(self._sync.values())
            self._sync.clear()
        for ticket, ikind in leftovers:
            if ikind == "query" and ticket is not None:
                self._finish_failed(ticket, AdmissionRejectedError(
                    "fleet router stopped with the query in flight"))
        for entry in syncs:
            entry[0].set()
        for q in [self._status_q] + \
                [s.task_q for s in self._slots.values()
                 if s.task_q is not None]:
            try:
                q.close()
                q.join_thread()
            except (OSError, ValueError) as e:
                log.debug("fleet queue close failed: %s", e)
        self._reg.release()
