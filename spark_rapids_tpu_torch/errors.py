"""The typed errors of the query lifecycle and the session server.

Counterpart of ``spark_rapids_tpu/errors.py``.  Every typed failure a
query can surface derives from ``EngineError``, so a caller (the session
server's ticket, a client of it) catches one base class and knows the
query failed in a supervised way: its threads, handles and permits were
reclaimed.  Not carried over: ``ChipFailedError``,
``ReplicaFailedError`` and ``RetryBudgetExhaustedError``, raised by the
chip-health, fleet and replay layers, which wait for the multi-GPU
slice (``ROADMAP.md``, queue A8 and A10's leftovers).
"""

from __future__ import annotations


class EngineError(Exception):
    """Base of every typed engine error (lifecycle, server, injection)."""


class QueryCancelledError(EngineError):
    """The query's cancel token was triggered (a cancel, a session stop,
    a server close, or a deadline: see ``QueryTimeoutError``), and a
    pull boundary or a bounded wait observed it."""


class QueryTimeoutError(QueryCancelledError):
    """The query passed its deadline (``spark.rapids.sql.queryTimeoutMs``
    or the server's per-tenant timeout).  A deadline is a cancellation,
    so callers that handle one handle the other."""


class AdmissionRejectedError(EngineError):
    """The session server shed the query before admitting it: its
    admission queue was full (``spark.rapids.server.admission.
    queueDepth``) or the server is stopping.  Nothing ran and nothing
    was held, so the caller may retry with backoff."""


class QueryBudgetExceededError(EngineError):
    """The query's device-resident bytes passed
    ``spark.rapids.server.query.maxDeviceBytes`` and spilling its own
    handles could not bring them back under it.  Raised through the
    query's cancel token, so every thread of the query unwinds typed."""


class QueryHangError(EngineError):
    """The hang watchdog (``spark.rapids.sql.watchdog.hangTimeoutMs``)
    gave up on a blocking call that did not return in time."""

    def __init__(self, site: str, timeout_s: float, message: str = ""):
        super().__init__(
            message or f"watchdog: blocking call at {site} exceeded "
                       f"{timeout_s:.1f}s hang timeout")
        self.site = site
        self.timeout_s = timeout_s
