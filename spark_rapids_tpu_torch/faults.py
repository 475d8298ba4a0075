"""Deterministic, conf-driven fault injection.

Counterpart of ``spark_rapids_tpu/faults.py``.  Each failure-capable
edge declares a named site and asks the process-wide injector whether
to fail, so tests and runs inject faults through
``spark.rapids.faults.<site>`` keys alone.  The sites the port wires:

  ``kernel.launch``        an operator's device work under ``with_retry``
                           and the fused stage's per-batch steps
                           (raises an injected out-of-memory error)
  ``spill.demote``         a device -> host or host -> disk demotion
  ``spill.promote``        a disk/host -> device promotion in ``get()``
  ``io.prefetch.decode``   a ``PrefetchIterator`` producer given the
                           site (the error surfaces at the consumer)
  ``io.pipeline.hang``     ``lifecycle.supervise``'s simulated wedge
  ``server.admit``         a session-server submit, before enqueue
  ``server.cache.lookup``  a result-cache lookup (degrades to a miss)
  ``aqe.replan``           an adaptive replan pass, before any rewrite
                           (the stage keeps the static plan and the
                           query still runs; ``aqeReplans`` stays)
  ``fleet.route``          a fleet router's submit, before any replica
                           is picked (raises typed; nothing dispatched)
  ``replica.fail``         a dispatch to a fleet replica (consulted once
                           a dispatch, with ``replica=``): the replica's
                           health score takes a failure and the query
                           fails over under the retry budget, else dies
                           typed (``ReplicaFailedError``)
  ``replica.slow``         a dispatch to a fleet replica: a slow mark on
                           its health score; the dispatch proceeds.  In
                           the replica's own process (a spec shipped by
                           ``FleetRouter.configure_faults``) it holds
                           the query for a second (``fleet/replica.py``)
  ``worker.heartbeat``     a fleet replica's heartbeat: the thread falls
                           silent (a hung replica)
  ``stream.poll``          a tailing source's poll, before anything is
                           diffed: the tick is skipped and counted, the
                           committed snapshot stays
  ``io.encode``            the ingest encoder's build of one column
                           (``columnar/encoding.py``): the column goes
                           up plain, counted in ``encode_faults``
  ``transfer.d2h``         a device -> host pull
                           (``columnar/transfer.py: device_pull``),
                           before anything is copied; the error reaches
                           the caller
  ``plan.place``           the placement pass and its adaptive re-score
                           (``plan/placement.py``): the plan runs on the
                           card, counted in ``place_faults``
  ``compile.store``        the compile store's lookup of a kernel
                           library (``compile/store.py``): a fresh nvcc
                           build, counted in ``compileStoreFaults``

  ``transport.connect``    a shuffle client's construction
                           (``shuffle/transport.py``), before it connects
  ``transport.fetch``      a shuffle client's fetch, before any byte
                           moves; the manager retries it on its backoff
  ``serializer.deserialize`` a fetched block before its decode: one bit
                           flipped (``corrupt``), so the checksum fails
                           and the manager refetches
  ``worker.kill``          a host shuffle map worker, before each batch
                           it partitions, and a ``distributed_groupby``
                           worker before each row group: SIGKILL itself
  ``worker.hang``          a ``distributed_groupby`` worker before each
                           row group: its heartbeats stop and it parks
                           until the watchdog terminates it

The JAX package's other sites (ICI, chip, ``ooc.partition``) belong to
modules the port does not have yet (``ROADMAP.md``, queues A8b and A8c).

Trigger grammar (the value of ``spark.rapids.faults.<site>``):

  ``count:3``    fire on the 3rd call to the site only
  ``count:2,5``  fire on calls 2 and 5
  ``count:4+``   fire on every call from the 4th onward
  ``first:2``    fire on calls 1 and 2
  ``prob:0.1``   fire with probability 0.1 a call, from the stream
                 ``random.Random(f"{seed}:{site}")`` with the seed
                 ``spark.rapids.faults.seed``: the JAX package's stream,
                 so both fire at the same calls
  ``always`` / ``off``

A spec may carry ``@w<idx>`` (``count:2@w1``), restricting it to the
host shuffle's worker process of that index: each worker declares its
index with ``set_worker_index`` before anything configures its
injector, so the spec the parent ships fires in worker 1 alone (its own
count of calls), and never in the parent, whose index is None.  A spec
with ``@r<idx>`` (``always@r1``) fires only on the fleet router's
consults for that replica, and counts that replica's consults apart
(``count:2@r1`` is replica 1's second), under the stream key
``<site>@r<idx>`` of ``stats()``.  Inside a replica process only
``replica.slow`` consults with ``replica=`` (the replica's own index),
so ``always@r0`` shipped to every replica slows replica 0 alone.
"""

from __future__ import annotations

import random
import threading
from typing import Any, Dict, Optional, Tuple

from spark_rapids_tpu_torch.errors import EngineError

FAULTS_PREFIX = "spark.rapids.faults."
SEED_KEY = "spark.rapids.faults.seed"


class InjectedFault(EngineError, IOError):
    """An error the injector raised at a named site: an ``IOError``, as
    a real transient failure would be, and an ``EngineError``."""

    def __init__(self, site: str, message: str = ""):
        super().__init__(message or f"injected fault at {site}")
        self.site = site


class _Trigger:
    """One parsed spec: decides per call number whether to fire."""

    def __init__(self, spec: str, site: str, seed: int,
                 worker: Optional[int]):
        self.spec = spec
        self.active = True
        self.replica: Optional[int] = None
        body = spec.strip()
        if "@" in body:
            body, target = body.rsplit("@", 1)
            target = target.strip()
            if target.startswith("w"):
                self.active = worker is not None and \
                    int(target[1:]) == worker
            elif target.startswith("r"):
                self.replica = int(target[1:])
            else:
                raise ValueError(f"bad target {target!r} in {spec!r} (the "
                                 "port takes @w<idx> and @r<idx>)")
        body = body.strip().lower()
        self._mode = None
        self._calls: Tuple[int, ...] = ()
        self._from = 0
        self._prob = 0.0
        self._rng = None
        if body in ("off", ""):
            self.active = False
        elif body == "always":
            self._mode = "always"
        elif body.startswith("count:"):
            arg = body[len("count:"):]
            if arg.endswith("+"):
                self._mode = "from"
                self._from = int(arg[:-1])
            else:
                self._mode = "calls"
                self._calls = tuple(int(x) for x in arg.split(","))
        elif body.startswith("first:"):
            self._mode = "first"
            self._from = int(body[len("first:"):])
        elif body.startswith("prob:"):
            self._mode = "prob"
            self._prob = float(body[len("prob:"):])
            # a stream a site: the same seed replays the same decisions
            # whatever the other sites do
            self._rng = random.Random(f"{seed}:{site}")
        else:
            raise ValueError(f"unrecognized fault spec {spec!r}")

    def fires(self, call_no: int, replica: Optional[int] = None) -> bool:
        if not self.active:
            return False
        if self.replica is not None and replica != self.replica:
            return False
        if self._mode == "always":
            return True
        if self._mode == "calls":
            return call_no in self._calls
        if self._mode == "from":
            return call_no >= self._from
        if self._mode == "first":
            return call_no <= self._from
        if self._mode == "prob":
            return self._rng.random() < self._prob
        return False


class FaultInjector:
    """Site -> trigger, with call and fire counters."""

    def __init__(self, specs: Optional[Dict[str, str]] = None,
                 seed: int = 0, worker: Optional[int] = None):
        self.seed = int(seed)
        self.worker = worker
        self._specs = dict(specs or {})
        self._lock = threading.Lock()
        self._triggers = {site: _Trigger(spec, site, self.seed, worker)
                          for site, spec in self._specs.items()}
        self.calls: Dict[str, int] = {}
        self.fired: Dict[str, int] = {}

    @property
    def enabled(self) -> bool:
        return any(t.active for t in self._triggers.values())

    def signature(self) -> tuple:
        return (tuple(sorted(self._specs.items())), self.seed, self.worker)

    def should_fire(self, site: str,
                    replica: Optional[int] = None) -> bool:
        """Count a call to ``site`` and say whether its trigger fires.  A
        replica-targeted spec counts the consults for its replica apart
        (stream ``<site>@r<idx>``)."""
        trig = self._triggers.get(site)
        with self._lock:
            n = self.calls.get(site, 0) + 1
            self.calls[site] = n
            stream = site
            if trig is not None and trig.replica is not None \
                    and replica is not None:
                stream = f"{site}@r{replica}"
                n = self.calls.get(stream, 0) + 1
                self.calls[stream] = n
            if trig is None or not trig.fires(n, replica=replica):
                return False
            self.fired[site] = self.fired.get(site, 0) + 1
            if stream != site:
                self.fired[stream] = self.fired.get(stream, 0) + 1
        # journaled outside the lock: which fault preceded which error
        from spark_rapids_tpu_torch.obs import journal
        if journal.enabled():
            extra = {} if replica is None else {"replica": replica}
            journal.emit(journal.EVENT_FAULT_FIRE, site=site, call=n,
                         worker=self.worker, **extra)
        return True

    def maybe_fail(self, site: str, message: str = "") -> None:
        if self.should_fire(site):
            raise InjectedFault(site, message)

    def maybe_fail_oom(self, site: str) -> None:
        """An injected error that ``utils/retry.is_device_oom`` takes for
        a device out-of-memory error (it matches the message)."""
        if self.should_fire(site):
            raise InjectedFault(
                site, f"RESOURCE_EXHAUSTED: injected fault at {site}")

    def corrupt(self, site: str, payload: bytes) -> bytes:
        """``payload`` with its middle byte's low bit flipped when the
        site fires, else unchanged."""
        if not payload or not self.should_fire(site):
            return payload
        buf = bytearray(payload)
        buf[len(buf) // 2] ^= 0x01
        return bytes(buf)

    def stats(self) -> Dict[str, Dict[str, int]]:
        with self._lock:
            return {site: {"calls": self.calls.get(site, 0),
                           "fired": self.fired.get(site, 0)}
                    for site in set(self.calls) | set(self._triggers)}


_INJECTOR = FaultInjector()
_CONFIG_LOCK = threading.Lock()
_WORKER_INDEX: Optional[int] = None


def set_worker_index(idx: Optional[int]) -> None:
    """Declare this process's shuffle worker index (once, at the
    worker's start, before anything configures the injector): every
    later ``configure_from_conf`` matches ``@w<idx>`` specs against
    it."""
    global _WORKER_INDEX
    _WORKER_INDEX = idx


def injector() -> FaultInjector:
    return _INJECTOR


def reset() -> None:
    """Drop every configured fault (test teardown)."""
    global _INJECTOR
    with _CONFIG_LOCK:
        _INJECTOR = FaultInjector()


def configure(specs: Dict[str, str], seed: int = 0,
              worker: Optional[int] = None) -> FaultInjector:
    """Install the process-wide injector.  The same (specs, seed,
    worker) keeps the live injector and its counters, so a new session
    or query with the same conf does not restart the counts."""
    global _INJECTOR
    with _CONFIG_LOCK:
        candidate = FaultInjector(specs, seed=seed, worker=worker)
        if candidate.signature() != _INJECTOR.signature():
            _INJECTOR = candidate
        return _INJECTOR


def configure_from_conf(conf: Any, worker: Optional[int] = None
                        ) -> FaultInjector:
    """Install the ``spark.rapids.faults.*`` keys of a TorchConf or a
    dict; a conf without them installs a disabled injector.  ``worker``
    defaults to the index ``set_worker_index`` declared."""
    if worker is None:
        worker = _WORKER_INDEX
    settings = conf if isinstance(conf, dict) else conf.to_dict()
    specs = {}
    seed = 0
    for key, value in settings.items():
        if not key.startswith(FAULTS_PREFIX):
            continue
        if key == SEED_KEY:
            seed = int(value)
        else:
            specs[key[len(FAULTS_PREFIX):]] = str(value)
    return configure(specs, seed=seed, worker=worker)


def has_fault_keys(conf) -> bool:
    return any(k.startswith(FAULTS_PREFIX) for k in conf.to_dict())


# -- the calls the sites make -----------------------------------------------

def maybe_fail(site: str, message: str = "") -> None:
    _INJECTOR.maybe_fail(site, message)


def maybe_fail_oom(site: str) -> None:
    _INJECTOR.maybe_fail_oom(site)


def should_fire(site: str, replica: Optional[int] = None) -> bool:
    return _INJECTOR.should_fire(site, replica=replica)


def corrupt(site: str, payload: bytes) -> bytes:
    return _INJECTOR.corrupt(site, payload)
