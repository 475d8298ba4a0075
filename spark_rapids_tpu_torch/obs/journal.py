"""Structured engine event journal.

Counterpart of ``spark_rapids_tpu/obs/journal.py``.  A bounded JSONL
journal of typed events, gated on ``spark.rapids.sql.obs.journalDir``:
unset, no file is opened and ``emit`` is one ``None`` check.  One line
an event::

    {"event": "query_finish", "ts": <wall s>, "mono": <monotonic s>,
     "query": <query id or null>, ...fields}

Each process appends to its own ``events-<pid>.jsonl``; past
``spark.rapids.sql.obs.journal.maxEvents`` events are counted as
dropped.  The events are those the port's modules fire: the query
lifecycle's, fault fires, watchdog trips, the session server's
admission and cache outcomes, adaptive execution's stage
materializations and replan passes, the spill catalog's tier moves, and
the fleet router's quarantines, restores, failovers and rolling
restarts.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Optional

log = logging.getLogger("spark_rapids_tpu_torch.obs.journal")

EVENT_QUERY_START = "query_start"
EVENT_QUERY_FINISH = "query_finish"
EVENT_QUERY_CANCEL = "query_cancel"
EVENT_QUERY_TIMEOUT = "query_timeout"
EVENT_QUERY_ERROR = "query_error"
EVENT_STAGE_MATERIALIZE = "stage_materialize"
EVENT_AQE_REPLAN = "aqe_replan"
EVENT_FAULT_FIRE = "fault_fire"
EVENT_WATCHDOG_TRIP = "watchdog_trip"
EVENT_QUERY_ADMITTED = "query_admitted"
EVENT_QUERY_REJECTED = "query_rejected"
EVENT_CACHE_HIT = "cache_hit"
EVENT_CACHE_MISS = "cache_miss"
EVENT_SERVER_DRAIN = "server_drain"
EVENT_SPILL_DEMOTE = "spill_demote"
EVENT_SPILL_PROMOTE = "spill_promote"
# the serving fleet (fleet/), written by the router's process
EVENT_REPLICA_QUARANTINE = "replica_quarantine"
EVENT_REPLICA_RESTORE = "replica_restore"
EVENT_REPLICA_FAILOVER = "replica_failover"
EVENT_FLEET_ROLLING_RESTART = "fleet_rolling_restart"
# continuous queries (stream/)
EVENT_STREAM_TICK = "stream_tick"
EVENT_STANDING_REGISTER = "standing_register"
EVENT_STANDING_RETIRE = "standing_retire"
EVENT_CACHE_MAINTAIN = "cache_maintain"
# placement (plan/placement.py) and the compile warm pool (compile/warm.py)
EVENT_FRAGMENT_PLACED = "fragment_placed"
EVENT_COMPILE_WARM = "compile_warm"
# the host shuffle's distributed_groupby driver (shuffle/worker.py)
EVENT_WORKER_DEATH = "worker_death"

DEFAULT_MAX_EVENTS = 100_000

_LOCK = threading.Lock()
_FH = None          # the open file, or None: the journal is off
_PATH = ""
_DIR = ""
_MAX_EVENTS = 0
_WRITTEN = 0
_DROPPED = 0


def configure(journal_dir: str, max_events: Optional[int] = None) -> None:
    """Open (or keep) ``<journal_dir>/events-<pid>.jsonl``; an empty dir
    closes it.  The same dir keeps the open file and its counters;
    ``max_events=None`` leaves the cap as it is for the same dir and
    starts a new journal at ``DEFAULT_MAX_EVENTS``."""
    global _FH, _PATH, _DIR, _MAX_EVENTS, _WRITTEN, _DROPPED
    journal_dir = journal_dir or ""
    with _LOCK:
        if max_events is not None:
            _MAX_EVENTS = max(0, int(max_events))
        if journal_dir == _DIR:
            return
        if max_events is None:
            _MAX_EVENTS = DEFAULT_MAX_EVENTS
        _WRITTEN = _DROPPED = 0
        if _FH is not None:
            try:
                _FH.close()
            except OSError as e:
                log.warning("closing journal %s failed: %s", _PATH, e)
            _FH, _PATH = None, ""
        _DIR = journal_dir
        if not journal_dir:
            return
        try:
            os.makedirs(journal_dir, exist_ok=True)
            path = os.path.join(journal_dir, f"events-{os.getpid()}.jsonl")
            _FH = open(path, "a", encoding="utf-8")
            _PATH = path
        except OSError as e:
            # a bad journal dir never fails the query it observes
            log.warning("cannot open obs journal under %r: %s",
                        journal_dir, e)
            _FH, _DIR = None, ""


def set_max_events(max_events: int) -> None:
    global _MAX_EVENTS
    with _LOCK:
        _MAX_EVENTS = max(0, int(max_events))


def configure_from_conf(conf) -> None:
    from spark_rapids_tpu_torch.conf import OBS_JOURNAL_DIR, \
        OBS_JOURNAL_MAX_EVENTS
    configure(conf.get(OBS_JOURNAL_DIR),
              conf.get(OBS_JOURNAL_MAX_EVENTS)
              if OBS_JOURNAL_MAX_EVENTS.key in conf.to_dict() else None)


def enabled() -> bool:
    return _FH is not None


def emit(event: str, query: Optional[int] = None, **fields) -> None:
    """Append one event line; ``query`` defaults to the calling thread's
    query.  Never raises: a write error turns the journal off."""
    global _FH, _PATH, _DIR, _WRITTEN, _DROPPED
    if _FH is None:
        return
    if query is None:
        from spark_rapids_tpu_torch import lifecycle
        qc = lifecycle.current()
        query = qc.query_id if qc is not None else None
    rec = {"event": event, "ts": round(time.time(), 6),
           "mono": round(time.monotonic(), 6), "query": query}
    rec.update(fields)
    try:
        line = json.dumps(rec, separators=(",", ":"), default=str)
    except (TypeError, ValueError) as e:
        log.warning("unserializable journal event %r dropped: %s", event, e)
        return
    with _LOCK:
        if _FH is None:
            return
        if _MAX_EVENTS and _WRITTEN >= _MAX_EVENTS:
            _DROPPED += 1
            return
        try:
            _FH.write(line + "\n")
            _FH.flush()
            _WRITTEN += 1
        except OSError as e:
            log.warning("obs journal write failed, disabling: %s", e)
            try:
                _FH.close()
            except OSError:
                pass
            _FH, _DIR, _PATH = None, "", ""


def stats() -> dict:
    with _LOCK:
        return {"enabled": int(_FH is not None), "written": _WRITTEN,
                "dropped": _DROPPED, "path": _PATH}


def close() -> None:
    """Close the journal; the counters keep their totals."""
    global _FH, _DIR, _PATH
    with _LOCK:
        if _FH is not None:
            try:
                _FH.close()
            except OSError as e:
                log.warning("closing journal %s failed: %s", _PATH, e)
        _FH, _DIR, _PATH = None, "", ""
