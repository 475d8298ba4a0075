"""Replica health: each replica's EWMA score, and the quarantine,
probation and restore state machine.

Counterpart of ``spark_rapids_tpu/fleet/health.py``, carried over rule
for rule; nothing here touches a tensor.  The scored unit is a whole
replica process.  Outcomes come from dispatch results, heartbeats and
the injected ``replica.fail`` / ``replica.slow`` sites:

* score' = alpha*outcome + (1-alpha)*score (1.0 clean, 0.25 slow,
  0.0 a failure of the replica);
* below ``fleet.health.quarantineThreshold`` the replica is
  quarantined: routed around, probed after ``fleet.health.probationMs``;
* a passing probe re-admits it on probation (one failure quarantines it
  again at once with a fresh window, one clean response restores full
  membership); a failing probe restarts the window.

The tracker belongs to one ``FleetRouter``: replica indices mean
something only to the router that spawned them.  The probe is a query
through the replica, so the router takes ``due_for_probe()``, sends the
probes and reports back through ``probe_result``.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, List

from spark_rapids_tpu_torch.fleet import stats as fleet_stats

# the outcome credits of the JAX package's chip domain
OUTCOME_SUCCESS = 1.0
OUTCOME_SLOW = 0.25
OUTCOME_FAIL = 0.0

log = logging.getLogger("spark_rapids_tpu_torch.fleet.health")


class ReplicaHealthTracker:
    """Per-replica EWMA scores + quarantine/probation state machine,
    owned by one FleetRouter (NOT process-global)."""

    def __init__(self, alpha: float = 0.5, threshold: float = 0.4,
                 probation_ms: int = 2000):
        self._lock = threading.Lock()
        self.alpha = float(alpha)
        self.threshold = float(threshold)
        self.probation_s = max(0.001, probation_ms / 1000.0)
        self._scores: Dict[int, float] = {}
        # replica -> monotonic time it entered (or re-entered) quarantine
        self._quarantined: Dict[int, float] = {}
        # replicas re-admitted on probation: next outcome decides
        self._probation: set = set()
        # replicas with a probe currently in flight: not re-picked by
        # due_for_probe until probe_result resolves them
        self._probing: set = set()

    # -- inspection ---------------------------------------------------------

    def score(self, replica: int) -> float:
        with self._lock:
            return self._scores.get(replica, 1.0)

    def is_quarantined(self, replica: int) -> bool:
        with self._lock:
            return replica in self._quarantined

    def on_probation(self, replica: int) -> bool:
        with self._lock:
            return replica in self._probation

    def quarantined_set(self) -> frozenset:
        with self._lock:
            return frozenset(self._quarantined)

    # -- scoring ------------------------------------------------------------

    def record(self, replica: int, outcome: float,
               weight: float = 1.0) -> bool:
        """Feed one outcome into ``replica``'s EWMA score; returns True
        when this observation quarantined the replica.  ``weight``
        scales the effective alpha: a heartbeat reporting some of its
        chips quarantined passes that fraction, so one chip out of eight
        dents the score instead of sinking it."""
        quarantined_now = False
        with self._lock:
            a = min(1.0, max(0.0, self.alpha * float(weight)))
            s = a * float(outcome) + \
                (1.0 - a) * self._scores.get(replica, 1.0)
            self._scores[replica] = s
            if replica in self._quarantined:
                return False
            # only a failed outcome relapses a probation replica; a slow
            # mark decays the score like any other slow outcome
            probation_relapse = replica in self._probation and \
                float(outcome) <= OUTCOME_FAIL
            if s < self.threshold or probation_relapse:
                self._quarantined[replica] = time.monotonic()
                self._probation.discard(replica)
                quarantined_now = True
            elif replica in self._probation and \
                    float(outcome) >= OUTCOME_SUCCESS:
                # a clean response ends probation: full member again
                self._probation.discard(replica)
                fleet_stats.bump("restores")
                from spark_rapids_tpu_torch.obs import journal
                if journal.enabled():
                    journal.emit(journal.EVENT_REPLICA_RESTORE,
                                 replica=replica)
        if quarantined_now:
            self._on_quarantine(replica, s)
        return quarantined_now

    def _on_quarantine(self, replica: int, score: float) -> None:
        fleet_stats.bump("quarantines")
        log.warning(
            "replica %d quarantined (fleet health score %.3f < %.3f); "
            "routed around until its probation probe passes",
            replica, score, self.threshold)
        from spark_rapids_tpu_torch.obs import journal
        if journal.enabled():
            journal.emit(journal.EVENT_REPLICA_QUARANTINE,
                         replica=replica, score=round(score, 4))

    def force_quarantine(self, replica: int) -> None:
        """Quarantine unconditionally (a dead replica being replaced:
        it must not be routable while its replacement boots)."""
        with self._lock:
            already = replica in self._quarantined
            self._quarantined[replica] = time.monotonic()
            self._probation.discard(replica)
            self._scores[replica] = 0.0
        if not already:
            self._on_quarantine(replica, 0.0)

    # -- probation ----------------------------------------------------------

    def due_for_probe(self) -> List[int]:
        """Quarantined replicas whose probation window elapsed and that
        have no probe in flight; each is marked in-flight until the
        router reports back through ``probe_result``."""
        now = time.monotonic()
        with self._lock:
            due = [r for r, t in self._quarantined.items()
                   if now - t >= self.probation_s
                   and r not in self._probing]
            self._probing.update(due)
        return due

    def probe_result(self, replica: int, ok: bool) -> None:
        """Resolve a probation probe: a pass re-admits the replica ON
        PROBATION with a neutral score, a failure restarts the
        quarantine window."""
        with self._lock:
            self._probing.discard(replica)
            if replica not in self._quarantined:
                return
            if ok:
                del self._quarantined[replica]
                self._probation.add(replica)
                # neutral re-entry score: above the threshold but below
                # full health — the probation rule (one failure
                # re-quarantines) carries the teeth
                self._scores[replica] = (1.0 + self.threshold) / 2.0
            else:
                self._quarantined[replica] = time.monotonic()
        from spark_rapids_tpu_torch.obs import journal
        if ok:
            fleet_stats.bump("restores")
            log.info("replica %d re-admitted on probation after "
                     "passing its probe query", replica)
            if journal.enabled():
                journal.emit(journal.EVENT_REPLICA_RESTORE,
                             replica=replica, probation=True)
        else:
            fleet_stats.bump("probe_failures")

    def forget(self, replica: int) -> None:
        """Drop all state for a replica slot (a fresh replacement
        process must start with a clean score, not inherit its
        predecessor's record)."""
        with self._lock:
            self._scores.pop(replica, None)
            self._quarantined.pop(replica, None)
            self._probation.discard(replica)
            self._probing.discard(replica)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "scores": {r: round(s, 4)
                           for r, s in sorted(self._scores.items())},
                "quarantined": sorted(self._quarantined),
                "probation": sorted(self._probation),
            }
