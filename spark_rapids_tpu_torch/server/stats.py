"""Process-wide session-server counters.

Counterpart of ``spark_rapids_tpu/server/stats.py``: the one place the
stats snapshot (``obs/registry.py``, ``snapshot()["server"]``) reads
the server's counts from.  It imports nothing else of the server, so
the snapshot does not load the worker pool.
"""

from __future__ import annotations

import threading
from typing import Dict

_LOCK = threading.Lock()

_COUNTERS = {
    "servers": 0,          # SessionServer instances started
    "submitted": 0,        # submits past the server.admit fault site
    "admitted": 0,         # taken into the fair queue
    "rejected": 0,         # shed with AdmissionRejectedError
    "completed": 0,        # finished with a result (cache hits included)
    "failed": 0,           # finished with an error on the ticket
    "cache_hits": 0,
    "cache_misses": 0,
    "cache_evictions": 0,
    "cache_inserts": 0,
    "cache_faults": 0,     # server.cache.lookup faults, taken as misses
    "disk_cache_hits": 0,
    "disk_cache_misses": 0,
    "disk_cache_inserts": 0,
    "disk_cache_evictions": 0,
    "disk_cache_corrupt": 0,
    "prepared": 0,         # PreparedStatement handles made
    "prepared_execs": 0,   # bindings run through them
}

_GAUGES = {
    "cache_bytes": 0,
    "cache_entries": 0,
}


def bump(key: str, v: int = 1) -> None:
    if v:
        with _LOCK:
            _COUNTERS[key] += int(v)


def set_gauge(key: str, v: int) -> None:
    with _LOCK:
        _GAUGES[key] = int(v)


def global_stats() -> Dict[str, int]:
    with _LOCK:
        out = dict(_COUNTERS)
        out.update(_GAUGES)
        return out

