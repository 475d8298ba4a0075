"""The main of a fleet replica process.

Counterpart of ``spark_rapids_tpu/fleet/replica.py``.  One replica is
one spawned process with its own ``TorchSession`` and ``SessionServer``,
built from the conf dict the router ships: the replica runs on the
conf's ``spark.rapids.torch.device``, and a replica on ``cuda`` that
finds no card raises at boot (``TorchSession``) and dies before it is
ready; it never carries on on the CPU.  Each replica has its own CUDA
context and caching allocator on the card, and its own spill catalog
budgeted from the card's whole memory unless the conf sets
``spark.rapids.memory.tpu.budgetBytes``: replicas sharing a card share
that memory, so a deployment sets the budget to its share.  The
shipped conf carries the faults, obs and fleet keys, so the replica's
injector and journal run in its own process.  A kernel it needs loads
from ``spark_rapids_tpu_torch/_build/`` when ``native.py`` built it
there before, and is built otherwise (through a file of its own pid and
``os.replace``, so replicas that build at once do not tear a library).

The protocol (router -> ``task_q``, replica -> the shared ``status_q``):

  ("sql", tid, sql, tenant, params)  submit through the replica's server;
                                     a waiter thread posts ("result",
                                     idx, (tid, HostResult, tenant)) or
                                     ("error", idx, (tid, exc, tenant))
                                     when the ticket resolves, so the
                                     command loop never waits on a query.
                                     When ``replica.slow`` fires here
                                     (consulted with this replica's
                                     index, so ``always@r0`` slows
                                     replica 0 alone) the submit waits
                                     ``SLOW_HOLD_S`` on a timer: the
                                     query stays in flight, unanswered
  ("probe", tid)                     a small built-in query through the
                                     whole serving path (no view needed)
  ("view", spec)                     register a temp view; spec is
                                     ("table", name, columns): a dict of
                                     numpy arrays, or a (columns, masks)
                                     pair, shipped whole; or ("parquet",
                                     name, path), which needs pyarrow
                                     and so runs where it is installed
  ("faults", tid, specs, seed)       reconfigure the replica's injector
  ("stats", tid)                     the replica's engine stats, its
                                     kernel launches (``native.LAUNCHES``
                                     counts a process's own) and what
                                     the process is (pid, device,
                                     modules loaded)
  ("drain", tid)                     ``SessionServer.drain()``, then exit
  ("exit", -1)                       exit

The heartbeat thread sends ("hb", idx, snapshot) every
``fleet.heartbeat.intervalMs``; the injected ``worker.heartbeat`` site
silences it (a hung replica).  The snapshot reports ``chips_total``
(``torch.cuda.device_count()``, 0 on the CPU) and ``chips_quarantined``,
which stays 0: the port has no chip failure domain yet (``health.py``,
queue A8 in ``ROADMAP.md``).
"""

from __future__ import annotations

import queue as _queue
import threading

_THREAD_PREFIX = "spark-rapids-torch-fleet"
# how long a replica holds a query when its own replica.slow fires: a
# slow replica, its queries in flight and unanswered meanwhile (the JAX
# package's replica.slow only marks the health score, which the
# router's consult still does)
SLOW_HOLD_S = 1.0


def _health_snapshot(device) -> dict:
    """What each heartbeat carries for the router's rollup."""
    import torch
    return {
        "chips_total": torch.cuda.device_count()
        if device.type == "cuda" else 0,
        "chips_quarantined": 0,
    }


def _process_info(session) -> dict:
    import os
    import sys
    return {"pid": os.getpid(), "device": str(session.device),
            "modules": sorted(sys.modules)}


def _replica_main(idx: int, conf_dict: dict, view_specs: list,
                  task_q, status_q) -> None:
    import time

    import spark_rapids_tpu_torch as st
    from spark_rapids_tpu_torch import faults, lifecycle, native
    from spark_rapids_tpu_torch.conf import FLEET_HEARTBEAT_INTERVAL_MS, \
        TorchConf

    conf = TorchConf(dict(conf_dict or {}))
    session = st.TorchSession(dict(conf_dict or {}))
    try:
        server = session.server()
        for spec in view_specs or ():
            _register_view(session, spec)

        stop_hb = threading.Event()
        interval = conf.get(FLEET_HEARTBEAT_INTERVAL_MS) / 1000.0

        def _beat() -> None:
            while not stop_hb.wait(interval):
                if faults.should_fire("worker.heartbeat"):
                    return  # injected silence: a hung replica
                status_q.put(("hb", idx, _health_snapshot(session.device)))

        hb_thread = threading.Thread(target=_beat,
                                     name=f"{_THREAD_PREFIX}-beat",
                                     daemon=True)
        lifecycle.register_thread(hb_thread, stop=stop_hb.set)
        hb_thread.start()

        # the waiters: the command loop hands (tid, tenant, ticket) over
        # and goes on; a waiter parks on the ticket and posts the
        # outcome.  The bound keeps a flooded replica's backlog in the
        # server's fair queue (a typed shed), not in this hand-off.
        wait_q: _queue.Queue = _queue.Queue(maxsize=256)
        stop_wait = threading.Event()

        def _waiter() -> None:
            while not stop_wait.is_set():
                try:
                    tid, tenant, ticket = wait_q.get(timeout=1.0)
                except _queue.Empty:
                    continue
                try:
                    result = ticket.result(timeout=3600.0)
                    status_q.put(("result", idx, (tid, result, tenant)))
                except BaseException as e:
                    status_q.put(("error", idx,
                                  (tid, _portable(e), tenant)))

        waiters = []
        for w in range(4):
            t = threading.Thread(target=_waiter,
                                 name=f"{_THREAD_PREFIX}-wait-{idx}-{w}",
                                 daemon=True)
            lifecycle.register_thread(t, stop=stop_wait.set)
            t.start()
            waiters.append(t)

        def _submit(tid, sql, tenant, params) -> None:
            try:
                ticket = server.submit(sql, tenant=tenant, params=params)
            except BaseException as e:
                status_q.put(("error", idx, (tid, _portable(e), tenant)))
                return
            wait_q.put((tid, tenant, ticket))

        status_q.put(("ready", idx, None))

        def _next_cmd():
            # an orphaned replica (no command for an hour) exits
            deadline = time.monotonic() + 3600.0
            while time.monotonic() < deadline:
                try:
                    return task_q.get(timeout=1.0)
                except _queue.Empty:
                    continue
            return None

        try:
            while True:
                cmd = _next_cmd()
                if cmd is None or cmd[0] == "exit":
                    break
                kind = cmd[0]
                if kind == "sql":
                    args = cmd[1:]
                    if faults.should_fire("replica.slow", replica=idx):
                        timer = threading.Timer(SLOW_HOLD_S, _submit, args)
                        timer.name = f"{_THREAD_PREFIX}-slow-{idx}"
                        timer.daemon = True
                        timer.start()
                    else:
                        _submit(*args)
                elif kind == "probe":
                    _, tid = cmd
                    try:
                        ticket = server.submit(session.range(16),
                                               tenant="_probe")
                        wait_q.put((tid, "_probe", ticket))
                    except BaseException as e:
                        status_q.put(("error", idx,
                                      (tid, _portable(e), "_probe")))
                elif kind == "view":
                    _, spec = cmd
                    _register_view(session, spec)
                    status_q.put(("view_ok", idx, spec[1]))
                elif kind == "faults":
                    _, tid, specs, seed = cmd
                    faults.configure(specs, seed=seed)
                    status_q.put(("faults_ok", idx, tid))
                elif kind == "stats":
                    _, tid = cmd
                    from spark_rapids_tpu_torch.obs import registry
                    snap = registry.snapshot()
                    snap["kernels"] = {"launches": dict(native.LAUNCHES)}
                    snap["process"] = _process_info(session)
                    status_q.put(("stats", idx, (tid, snap)))
                elif kind == "drain":
                    _, tid = cmd
                    ms = server.drain()
                    status_q.put(("drained", idx, (tid, ms)))
                    break
        except Exception as e:  # unrecoverable: the router logs it
            status_q.put(("fatal", idx, f"{type(e).__name__}: {e}"))
        finally:
            stop_hb.set()
            # let the waiters post the outcomes already resolved (a
            # drain's rejected tickets must reach the router), bounded
            flush_deadline = time.monotonic() + 10.0
            while not wait_q.empty() and \
                    time.monotonic() < flush_deadline:
                time.sleep(0.05)
            stop_wait.set()
            for t in waiters:
                t.join(timeout=5.0)
    finally:
        session.stop()


def _register_view(session, spec) -> None:
    kind, name, payload = spec
    if kind == "parquet":
        session.read.parquet(payload).create_or_replace_temp_view(name)
    else:  # "table": numpy columns, with their masks when a pair
        cols, masks = payload if isinstance(payload, tuple) \
            else (payload, None)
        session.create_dataframe(cols, masks) \
            .create_or_replace_temp_view(name)


def _portable(e: BaseException) -> BaseException:
    """The exception if it survives a pickle round trip (the typed
    engine errors do), else a ``RuntimeError`` carrying its text: an
    error that cannot pickle must reach the client untyped, never stall
    the status queue's feeder thread."""
    import pickle
    try:
        pickle.loads(pickle.dumps(e))
        return e
    except Exception:
        return RuntimeError(f"{type(e).__name__}: {e}")
