"""Device runtime: the memory budget and the task admission semaphore.

Counterpart of ``spark_rapids_tpu/runtime.py``.  One ``TorchRuntime``
per process and device holds the two control points the JAX package
has: a budget (the card's total memory x
``spark.rapids.memory.tpu.allocFraction``, or
``spark.rapids.memory.tpu.budgetBytes``) that the spill catalog
(``memory/spill.py``) keeps the batches it tracks under, and a counted
semaphore (``spark.rapids.tpu.concurrentTasks``) that bounds the tasks
using the device at once.  PyTorch's caching allocator owns the card's
memory, as XLA owns the TPU's, so the budget is advisory: what exceeds
it demotes to the host, and an allocation that fails anyway raises
``torch.OutOfMemoryError``, which ``utils/retry.py`` handles.

On the CPU the budget assumes 16 GiB of device memory, as the JAX
package does, so both packages budget alike under one conf dict.  A new
runtime configures the compile store and starts its warm pool
(``compile/``) and, under ``placement.mode=cost``, probes the card's
link (``plan/cost.py: startup_probe``), as the JAX runtime does.  Not
carried over: the DOUBLE-as-float policy and the semaphore's resize
(the chip-health layer's, queue A8).  A wait for a permit polls the waiting
thread's query (``lifecycle.py``): a cancelled query, or one past its
deadline, raises its typed error out of the wait.

Each runtime owns the device scan cache (``ScanCache``,
``spark.rapids.sql.scan.deviceCacheEnabled``): the parquet, CSV and ORC
scans' device batches by file identities and scan shape, 8 entries, LRU,
as spillable handles in the runtime's catalog.  Where the JAX package's
``put`` over a key or an eviction closes handles that another query may
still be reading, the port counts an entry's readers and closes a
dropped entry's handles when its last reader is done; a second ``put``
of a key keeps the first entry.  ``shutdown`` clears it before the leak
audit, as the JAX package does.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
import warnings
from collections import OrderedDict
from typing import Dict, List, Optional

import torch

from spark_rapids_tpu_torch.conf import (
    ALLOC_FRACTION, BUDGET_BYTES, CONCURRENT_TASKS, HOST_SPILL_STORAGE_SIZE,
    PINNED_POOL_SIZE, POOLING_ENABLED, TorchConf,
)

# device memory the budget assumes where the device reports none (the
# CPU), as the JAX package assumes on its CPU platform
_CPU_DEVICE_BYTES = 16 * 1024 ** 3


class TorchSemaphore:
    """Counted admission of tasks to the device, re-entrant per thread:
    a thread that holds a permit takes it again without waiting, and
    gives it back when its outermost hold ends.  ``wait_count`` and
    ``wait_ns`` record the waits, so contention shows apart from work."""

    def __init__(self, permits: int):
        self.permits = max(1, int(permits))
        self._cv = threading.Condition()
        self._in_use = 0
        self._held = threading.local()
        self.acquire_count = 0
        self.wait_count = 0
        self.wait_ns = 0

    def acquire(self) -> None:
        depth = getattr(self._held, "depth", 0)
        if depth == 0:
            from spark_rapids_tpu_torch import lifecycle
            waited = None
            with self._cv:
                self.acquire_count += 1
                if self._in_use >= self.permits:
                    t0 = time.perf_counter_ns()
                    # bounded slices: the waiting query's cancel or
                    # deadline raises out of the wait, typed
                    while self._in_use >= self.permits:
                        self._cv.wait(timeout=lifecycle.poll_interval_s())
                        if self._in_use < self.permits:
                            break
                        lifecycle.check_cancel()
                    waited = time.perf_counter_ns() - t0
                    self.wait_count += 1
                    self.wait_ns += waited
                self._in_use += 1
            if waited is not None:
                lifecycle.note_sem_wait(waited)
                from spark_rapids_tpu_torch.obs import registry as obs
                obs.record(obs.HIST_SEM_WAIT_US, waited // 1000)
        self._held.depth = depth + 1

    def release(self) -> None:
        depth = getattr(self._held, "depth", 0)
        if depth <= 0:
            return
        self._held.depth = depth - 1
        if depth == 1:
            with self._cv:
                self._in_use -= 1
                self._cv.notify()

    def available(self) -> int:
        """Free permits now (advisory: another thread may take one)."""
        with self._cv:
            return max(0, self.permits - self._in_use)

    @contextlib.contextmanager
    def held(self):
        self.acquire()
        try:
            yield
        finally:
            self.release()


class ScanEntry:
    """One cached scan: its handles in batch order, the metrics the scan
    counted when it read them (replayed on a hit), and its readers."""

    __slots__ = ("handles", "metrics", "readers", "dropped")

    def __init__(self, handles: list, metrics: Dict[str, int]):
        self.handles = handles
        self.metrics = metrics
        self.readers = 0
        self.dropped = False

    def tier_bytes(self, tier: str) -> int:
        """The catalog's bytes of the handles on ``tier``."""
        return sum(h.size for h in self.handles if h.tier == tier)

    def close(self) -> None:
        for h in self.handles:
            h.close()


class ScanCache:
    """The device scan cache: key -> ``ScanEntry``, least recently used
    first, at most ``max_entries`` (the JAX package's ``_ScanCache``).
    ``get`` counts a reader on the entry it returns, which the caller
    gives back with ``release``; an entry that leaves the cache (evicted,
    invalidated, cleared) closes its handles once it has no reader."""

    def __init__(self, max_entries: int = 8):
        self.max_entries = max_entries
        self._lock = threading.Lock()
        self._entries: "OrderedDict[tuple, ScanEntry]" = OrderedDict()
        # entries dropped while a query still reads them
        self._draining: List[ScanEntry] = []
        self.hits = 0
        self.misses = 0

    def get(self, key) -> Optional[ScanEntry]:
        with self._lock:
            ent = self._entries.get(key)
            if ent is None:
                self.misses += 1
            else:
                self.hits += 1
                self._entries.move_to_end(key)
                ent.readers += 1
            return ent

    def release(self, ent: ScanEntry) -> None:
        with self._lock:
            ent.readers -= 1
            close = ent.dropped and ent.readers == 0
            if close:
                self._draining.remove(ent)
        if close:
            ent.close()

    def put(self, key, handles: list, metrics: Dict[str, int]) -> bool:
        """Store a scan's handles -> False when another query stored the
        key first (its entry stays, and the caller closes its own)."""
        with self._lock:
            if key in self._entries:
                self._entries.move_to_end(key)
                return False
            self._entries[key] = ScanEntry(handles, dict(metrics))
            out = []
            while len(self._entries) > self.max_entries:
                out.append(self._entries.popitem(last=False)[1])
        self._close(out)
        return True

    def _drop(self, keys) -> None:
        with self._lock:
            out = [self._entries.pop(k) for k in keys if k in self._entries]
        self._close(out)

    def _close(self, entries: List[ScanEntry]) -> None:
        with self._lock:
            for ent in entries:
                ent.dropped = True
            idle = [ent for ent in entries if ent.readers == 0]
            self._draining += [ent for ent in entries if ent.readers]
        for ent in idle:
            ent.close()

    def invalidate(self, key) -> None:
        self._drop([key])

    def invalidate_paths(self, root: str) -> None:
        """Drop every entry that names a file at or under ``root`` (a
        writer's output)."""
        root = os.path.abspath(root)
        under = root.rstrip(os.sep) + os.sep
        with self._lock:
            keys = [k for k in self._entries
                    if any(f[0] == root or f[0].startswith(under)
                           for f in k[1])]
        self._drop(keys)

    def clear(self) -> None:
        with self._lock:
            keys = list(self._entries)
        self._drop(keys)

    def keys(self) -> list:
        """The keys, least recently used first."""
        with self._lock:
            return list(self._entries)

    def storages(self) -> set:
        """The storages of every device plane the cache's entries hold,
        those of dropped entries still being read too (what
        ``encoding.unshare_batches`` copies before a result is handed
        to its caller)."""
        with self._lock:
            ents = list(self._entries.values()) + self._draining
        return {p for e in ents for h in e.handles
                for p in h.device_storages()}

    def stats(self) -> dict:
        with self._lock:
            ents = list(self._entries.values())
        out = {"entries": len(ents), "hits": self.hits,
               "misses": self.misses,
               "handles": sum(len(e.handles) for e in ents)}
        for tier in ("device", "host", "disk"):
            out[f"{tier}_bytes"] = sum(e.tier_bytes(tier) for e in ents)
        return out


def device_total_bytes(device: torch.device) -> int:
    """The card's total memory (``torch.cuda.mem_get_info``'s second
    value); the JAX package's 16 GiB on the CPU."""
    if device.type == "cuda":
        return int(torch.cuda.mem_get_info(device)[1])
    return _CPU_DEVICE_BYTES


class TorchRuntime:
    """The runtime of one device in this process: its budget, its spill
    catalog and its semaphore.  ``get_or_create`` returns the one made
    for the device first, with that first conf, as the JAX package's
    singleton does; ``reset`` drops them all (tests, and a new budget)."""

    _instances: Dict[str, "TorchRuntime"] = {}
    _lock = threading.Lock()

    def __init__(self, conf: TorchConf, device: torch.device):
        from spark_rapids_tpu_torch.memory.spill import BufferCatalog
        self.conf = conf
        self.device = torch.device(device)
        self.semaphore = TorchSemaphore(conf.get(CONCURRENT_TASKS))
        self.budget_bytes = int(device_total_bytes(self.device)
                                * conf.get(ALLOC_FRACTION))
        override = conf.get(BUDGET_BYTES)
        self.catalog = BufferCatalog(
            override if override > 0 else self.budget_bytes,
            conf.get(HOST_SPILL_STORAGE_SIZE),
            pinned_pool_bytes=conf.get(PINNED_POOL_SIZE),
            pooling_enabled=conf.get(POOLING_ENABLED))
        # the device scan cache: its entries live in the catalog, so
        # memory pressure demotes them (lowest priority) tier by tier
        self.scan_cache = ScanCache(max_entries=8)
        # the compile store and its warm pool (compile/), and placement's
        # link probe (plan/cost.py), from the conf that made the runtime
        from spark_rapids_tpu_torch import compile as compile_pkg
        from spark_rapids_tpu_torch.plan import cost
        compile_pkg.configure_from_conf(conf, self.device)
        cost.startup_probe(conf, self.device)

    @staticmethod
    def _key(device: torch.device) -> str:
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        return str(device)

    @classmethod
    def get_or_create(cls, conf: TorchConf,
                      device: torch.device) -> "TorchRuntime":
        key = cls._key(device)
        with cls._lock:
            rt = cls._instances.get(key)
            if rt is None:
                rt = cls._instances[key] = TorchRuntime(conf, device)
            return rt

    @classmethod
    def reset(cls) -> None:
        """Shut every runtime down and forget it."""
        with cls._lock:
            runtimes = list(cls._instances.values())
            cls._instances.clear()
        for rt in runtimes:
            rt.shutdown()

    def acquire_device(self):
        """A section that holds one of the device's permits."""
        return self.semaphore.held()

    @classmethod
    def invalidate_paths(cls, root: str) -> None:
        """Drop the scan cache entries naming files at or under ``root``
        in every runtime (a write replaced them: a same-size rewrite
        within the file system's timestamp tick may keep a file's
        identity)."""
        with cls._lock:
            runtimes = list(cls._instances.values())
        for rt in runtimes:
            rt.scan_cache.invalidate_paths(root)

    def shutdown(self) -> None:
        """Clear the scan cache, warn of handles still registered (an
        operator's leak), then close the catalog, which removes its
        spill directory."""
        self.scan_cache.clear()
        leaked = self.catalog.audit_leaks()
        if leaked:
            warnings.warn(f"{leaked} spillable batch(es) still registered "
                          "at runtime shutdown (operator leak)",
                          ResourceWarning)
        self.catalog.close()
