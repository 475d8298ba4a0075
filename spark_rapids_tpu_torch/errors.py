"""The typed errors of the query lifecycle and the session server.

Counterpart of ``spark_rapids_tpu/errors.py``.  Every typed failure a
query can surface derives from ``EngineError``, so a caller (the session
server's ticket, a client of it) catches one base class and knows the
query failed in a supervised way: its threads, handles and permits were
reclaimed.  An error with more than a message in its constructor
defines ``__reduce__``, so that it pickles whole across a fleet
replica's status queue.  Not carried over: ``ChipFailedError``, raised
by the chip-health layer, which waits for the multi-GPU slice
(``ROADMAP.md``, queue A8).
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

    def __reduce__(self):
        # the default pickle calls the class with the message alone
        return (QueryHangError, (self.site, self.timeout_s, str(self)))


class ReplicaFailedError(EngineError):
    """A fleet replica process died, or failed, while the query was in
    flight on it.  The router replays the query once on a healthy
    replica when the tenant's budget allows; otherwise this error
    surfaces, and the caller retries with backoff as after a shed."""

    def __init__(self, replica: int, message: str = ""):
        super().__init__(
            message or f"replica {replica} failed while the query was "
                       "in flight")
        self.replica = int(replica)

    def __reduce__(self):
        return (ReplicaFailedError, (self.replica, str(self)))


class RetryBudgetExhaustedError(AdmissionRejectedError):
    """A tenant's replay budget (``spark.rapids.fleet.retry.
    budgetPerMin``) is spent: a query that would have replayed is shed
    instead.  An ``AdmissionRejectedError``: the caller retries with
    backoff."""
