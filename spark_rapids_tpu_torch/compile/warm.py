"""The warm pool: every kernel built or loaded, and launched once, at
startup.

Counterpart of ``spark_rapids_tpu/compile/warm.py``, which replays the
store's recorded stage compiles.  The port's compiles are its kernel
libraries, so with the compile store on, runtime start and server start
(``compile.configure_from_conf``) run one ``srt-compile-warm`` thread
that, for every kernel in ``native.KERNELS``, builds or loads its
library (``native.load``) and, on a card, launches it once through its
wrapper on a tiny input (counted in ``native.LAUNCHES`` like any
launch), so a restarted server's first query pays neither.  The thread is registered
with the lifecycle (``session.stop()`` stops and joins it), journals a
``compile_warm`` event a kernel, and counts a kernel that fails in
``errors``: the query path builds it for real.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Optional

log = logging.getLogger("spark_rapids_tpu_torch.compile.warm")

_LOCK = threading.Lock()
_STATS = {"compiles": 0, "errors": 0, "starts": 0}
_THREAD: Optional[threading.Thread] = None
_STOP: Optional[threading.Event] = None
# (store root, device) pairs this process warmed: the hook runs at
# runtime start, server start and every compile-conf query scope
_WARMED = set()


def _bump(key: str, v: int = 1) -> None:
    with _LOCK:
        _STATS[key] += v


def stats() -> dict:
    with _LOCK:
        return dict(_STATS)


def _launch_dense_slot_reduce(device) -> None:
    import torch

    from spark_rapids_tpu_torch.exec import pallas_agg as pag
    pag._kernel()
    if device.type == "cuda":
        gid = torch.arange(8, dtype=torch.int32, device=device)
        pag.dense_slot_reduce(
            gid, [torch.ones(8, dtype=torch.float64, device=device)],
            ["add"], 128)


def _launch_contains(device) -> None:
    import torch

    from spark_rapids_tpu_torch.exprs import pallas_strings as ps
    ps._kernel()
    if device.type == "cuda":
        chars = torch.zeros((8, 32), dtype=torch.uint8, device=device)
        ps.run_contains(chars, torch.full((8,), 32, dtype=torch.int32,
                                          device=device), b"x" * 16)


# kernel -> its warm-up: load (or build) the library, launch on a card
WARMERS = {"dense_slot_reduce": _launch_dense_slot_reduce,
           "contains": _launch_contains}


def _warm_one(name: str, device) -> bool:
    t0 = time.perf_counter()
    try:
        WARMERS[name](device)
        if device.type == "cuda":
            import torch
            torch.cuda.synchronize(device)
    except Exception as e:
        log.warning("warm-pool build of %s failed: %s", name, e)
        _bump("errors")
        return False
    _bump("compiles")
    from spark_rapids_tpu_torch.obs import journal
    if journal.enabled():
        journal.emit(journal.EVENT_COMPILE_WARM, key=name,
                     ms=round((time.perf_counter() - t0) * 1e3, 2))
    return True


def start_if_configured(conf, device=None) -> Optional[threading.Thread]:
    """Start the warm pool when the store is installed and
    ``spark.rapids.sql.compile.warm.enabled`` holds, once a (store,
    device) a process; returns its thread, or None."""
    global _THREAD, _STOP
    import torch

    from spark_rapids_tpu_torch import lifecycle, native
    from spark_rapids_tpu_torch.compile import store as store_mod
    from spark_rapids_tpu_torch.conf import COMPILE_WARM_ENABLED
    st = store_mod.current()
    if st is None or not conf.get(COMPILE_WARM_ENABLED):
        return None
    device = torch.device("cpu") if device is None else torch.device(device)
    key = (st.root, str(device))
    with _LOCK:
        if key in _WARMED:
            return None
        _WARMED.add(key)
    names = list(native.KERNELS)
    stop = threading.Event()

    def work():
        if device.type == "cuda":
            torch.cuda.set_device(device)
        for name in names:
            if stop.is_set():
                return
            _warm_one(name, device)

    t = threading.Thread(target=work, name="srt-compile-warm", daemon=True)
    # a launch cannot be interrupted: stop() flips the flag between
    # kernels and the join waits out the one in flight
    reg = lifecycle.register_thread(t, stop=stop.set, join_timeout=60.0)
    if reg.rejected:
        with _LOCK:
            _WARMED.discard(key)
        return None
    with _LOCK:
        _THREAD, _STOP = t, stop
        _STATS["starts"] += 1
    t.start()
    return t


def wait_idle(timeout: float = 120.0) -> bool:
    """Join the pool's thread; True when it is done."""
    t = _THREAD
    if t is None or not t.is_alive():
        return True
    t.join(timeout=timeout)
    return not t.is_alive()


def reset() -> None:
    """Stop and join the pool, and zero its counters (tests)."""
    global _THREAD, _STOP
    t, stop = _THREAD, _STOP
    if stop is not None:
        stop.set()
    if t is not None and t.is_alive():
        t.join(timeout=60.0)
    with _LOCK:
        _THREAD = None
        _STOP = None
        _WARMED.clear()
        for k in _STATS:
            _STATS[k] = 0
