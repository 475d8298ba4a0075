"""Process-wide continuous-query counters.

Counterpart of ``spark_rapids_tpu/stream/stats.py``; the obs registry's
``stream`` section reads them.  All zero while
``spark.rapids.stream.enabled`` is unset.
"""

from __future__ import annotations

import threading
from typing import Dict

_LOCK = threading.Lock()

_COUNTERS = {
    "sources": 0,              # tailing sources registered
    "ticks": 0,                # polls that produced a micro-batch
    "empty_ticks": 0,          # polls that found nothing new
    "tick_faults": 0,          # injected stream.poll failures (tick skipped)
    "batch_files": 0,          # new files across all micro-batches
    "batch_grown": 0,          # grown files across all micro-batches
    "batch_rows": 0,           # delta rows read from grown tails
    "registered": 0,           # standing queries registered
    "retired": 0,              # standing queries retired
    "refreshes": 0,            # standing-query refreshes completed
    "incremental_refreshes": 0,   # ... by the delta merge
    "recompute_refreshes": 0,  # ... by a full recompute
    "refresh_errors": 0,       # refresh attempts that raised
    "cache_maintains": 0,      # result-cache entries maintained in place
    "cache_maintain_fallbacks": 0,  # maintenance candidates recomputed
}

_GAUGES = {
    "standing_active": 0,      # standing queries registered now
    "sources_active": 0,       # tailing sources watched now
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


def reset() -> None:
    with _LOCK:
        for k in _COUNTERS:
            _COUNTERS[k] = 0
        for k in _GAUGES:
            _GAUGES[k] = 0
