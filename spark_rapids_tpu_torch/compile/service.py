"""The compile stats.

Counterpart of ``spark_rapids_tpu/compile/service.py``, whose
``engine_jit`` and ``aot_compile`` have no torch analog (the port runs
its stages eagerly).  What carries over is the split of measured
compile time: ``cold_ms`` is the wall of ``native.py``'s nvcc builds,
``store_hit_ms`` that of loading a library the compile store already
held; ``snapshot`` is the registry's ``compile`` section.
"""

from __future__ import annotations

import threading

_LOCK = threading.Lock()
_STATS = {"builds": 0, "build_failures": 0, "store_loads": 0,
          "cold_ms": 0.0, "store_hit_ms": 0.0}


def note_build(ms: float, ok: bool = True) -> None:
    """One nvcc build of ``ms`` wall ms."""
    with _LOCK:
        if ok:
            _STATS["builds"] += 1
            _STATS["cold_ms"] += ms
        else:
            _STATS["build_failures"] += 1


def note_store_load(ms: float) -> None:
    """One library loaded from the compile store in ``ms``."""
    with _LOCK:
        _STATS["store_loads"] += 1
        _STATS["store_hit_ms"] += ms


def service_stats() -> dict:
    with _LOCK:
        out = dict(_STATS)
    out["cold_ms"] = round(out["cold_ms"], 1)
    out["store_hit_ms"] = round(out["store_hit_ms"], 3)
    return out


def reset_stats() -> None:
    with _LOCK:
        for k in _STATS:
            _STATS[k] = 0.0 if k.endswith("_ms") else 0


def snapshot() -> dict:
    """The registry's ``compile`` section: the store's counters, the
    build and load ms, the warm pool's counters and the ladder's
    bounds."""
    from spark_rapids_tpu_torch.compile import buckets, store, warm
    st = store.stats()
    svc = service_stats()
    wm = warm.stats()
    lad = buckets.stats()
    return {
        "storeEnabled": st["enabled"],
        "compileStoreHits": st["hits"],
        "compileStoreMisses": st["misses"],
        "compileStoreBytes": st["bytes"],
        "compileStoreEntries": st["entries"],
        "compileStoreCorrupt": st["corrupt"],
        "compileStoreFaults": st["faults"],
        "compileStoreIoErrors": st["io_errors"],
        "nvccBuilds": svc["builds"],
        "nvccBuildMs": svc["cold_ms"],
        "storeLoadMs": svc["store_hit_ms"],
        "warmPoolCompiles": wm["compiles"],
        "warmPoolErrors": wm["errors"],
        "bucketMinRows": lad["minRows"],
        "bucketMaxRows": lad["maxRows"],
    }
