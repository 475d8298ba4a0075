"""Weighted-fair bounded admission queue.

Counterpart of ``spark_rapids_tpu/server/admission.py``.  The scheduler
in front of the device semaphore: the ``TorchSemaphore`` bounds the
tasks on the device at once but serves them in arrival order, so a
tenant with 500 queued queries would park everyone behind its backlog.

* Stride scheduling: each tenant carries a virtual time advanced by
  ``1/weight`` a dispatched query, and ``take()`` dispatches the
  backlogged tenant with the smallest (ties by name), so tenants are
  served in proportion to their weights
  (``spark.rapids.server.tenant.<name>.weight``, else
  ``spark.rapids.server.admission.defaultWeight``) however deep any
  backlog grows.  A tenant that went idle re-enters at the current
  virtual clock: no credit hoarded, no penalty.  The virtual times are
  exact fractions, so the tie order never drifts.
* Bounded depth: at most ``spark.rapids.server.admission.queueDepth``
  queries wait; an offer past it raises ``AdmissionRejectedError`` at
  once.

An offer never blocks and ``take`` polls with a timeout, so nothing in
the queue can wedge; the ``server.admit`` fault site fires before an
offer for the same reason.
"""

from __future__ import annotations

import threading
from collections import deque
from fractions import Fraction
from typing import Dict, List, Optional, Tuple

from spark_rapids_tpu_torch.errors import AdmissionRejectedError


class FairAdmissionQueue:
    """Bounded multi-tenant queue with stride-scheduled dequeue."""

    def __init__(self, depth: int, default_weight: int = 1,
                 weights: Optional[Dict[str, int]] = None):
        if depth <= 0:
            raise ValueError("admission queue depth must be positive")
        self.depth = int(depth)
        self.default_weight = max(1, int(default_weight))
        self._weights = {t: max(1, int(w))
                         for t, w in (weights or {}).items()}
        self._cv = threading.Condition()
        self._backlogs: Dict[str, deque] = {}
        # EXACT virtual times (Fraction): float 1/weight strides drift
        # (3 x 1/3 != 1.0), silently skewing the tie order between
        # tenants whose shares should balance exactly
        self._vtime: Dict[str, Fraction] = {}
        self._clock = Fraction(0)  # virtual time of the last dispatch
        self._size = 0
        self.closed = False
        # counters (server stats surface)
        self.offered = 0
        self.rejected = 0
        self.dispatched = 0
        self.per_tenant_dispatched: Dict[str, int] = {}

    def weight(self, tenant: str) -> int:
        return self._weights.get(tenant, self.default_weight)

    def size(self) -> int:
        with self._cv:
            return self._size

    def offer(self, tenant: str, item) -> None:
        """Admit ``item`` into ``tenant``'s backlog or shed it typed.
        Never blocks."""
        with self._cv:
            if self.closed:
                self.rejected += 1
                raise AdmissionRejectedError(
                    "session server is stopping; query not admitted")
            if self._size >= self.depth:
                self.rejected += 1
                raise AdmissionRejectedError(
                    f"admission queue full ({self._size}/{self.depth} "
                    "waiting; spark.rapids.server.admission.queueDepth)"
                    " — overload shed, retry with backoff")
            q = self._backlogs.get(tenant)
            if q is None:
                q = self._backlogs[tenant] = deque()
            if not q:
                # tenant (re-)enters at the current virtual clock: no
                # hoarded credit from idle time, no penalty either
                self._vtime[tenant] = max(
                    self._clock, self._vtime.get(tenant, Fraction(0)))
            q.append(item)
            self._size += 1
            self.offered += 1
            self._cv.notify()

    def _pick(self) -> Optional[str]:
        best = None
        best_v = Fraction(0)
        for tenant, q in self._backlogs.items():
            if not q:
                continue
            v = self._vtime.get(tenant, Fraction(0))
            # deterministic tie-break by name so tests can assert the
            # exact dispatch order
            if best is None or v < best_v or (v == best_v
                                              and tenant < best):
                best, best_v = tenant, v
        return best

    def take(self, timeout: float = 0.1, on_dispatch=None
             ) -> Optional[Tuple[str, object]]:
        """Dispatch the fair-share next (tenant, item), or None when
        nothing arrives within ``timeout`` (or the queue is closed and
        empty) — callers poll, so a dead producer can never park a
        worker thread forever.  ``on_dispatch`` (no-arg) runs UNDER the
        queue lock right after the pop: the server's workers bump their
        in-flight count there, so a ticket is always either still in
        the backlog (a drain typed-rejects it via close_and_drain) or
        already counted in-flight (a drain waits for it) — never
        invisible in the handoff between the two."""
        with self._cv:
            tenant = self._pick()
            if tenant is None:
                if self.closed:
                    return None
                self._cv.wait(timeout=timeout)
                tenant = self._pick()
                if tenant is None:
                    return None
            item = self._backlogs[tenant].popleft()
            self._size -= 1
            if on_dispatch is not None:
                on_dispatch()
            v = self._vtime.get(tenant, Fraction(0)) + \
                Fraction(1, self.weight(tenant))
            self._vtime[tenant] = v
            self._clock = max(self._clock, v)
            self.dispatched += 1
            self.per_tenant_dispatched[tenant] = \
                self.per_tenant_dispatched.get(tenant, 0) + 1
            return tenant, item

    def close_and_drain(self) -> List[Tuple[str, object]]:
        """Mark closed (further offers shed typed), wake every waiter,
        and hand back the still-queued items so the server can fail
        their tickets typed instead of stranding their callers."""
        with self._cv:
            self.closed = True
            drained = [(t, item) for t, q in self._backlogs.items()
                       for item in q]
            for q in self._backlogs.values():
                q.clear()
            self._size = 0
            self._cv.notify_all()
            return drained

    def stats(self) -> dict:
        with self._cv:
            return {"depth": self.depth, "waiting": self._size,
                    "offered": self.offered, "rejected": self.rejected,
                    "dispatched": self.dispatched,
                    "per_tenant": dict(self.per_tenant_dispatched)}
