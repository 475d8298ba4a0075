"""Tiered spill: device -> pinned host -> disk.

Counterpart of ``spark_rapids_tpu/memory/spill.py``.  PyTorch's caching
allocator owns the card's memory, so there is no allocation hook to
intercept; as in the JAX package, operators register the batches they
hold between steps (coalesce's pending batches, aggregate partials, the
inputs of a sort or a window, a broadcast build) as ``SpillableBatch``
handles, and the ``BufferCatalog`` keeps the device bytes of those
handles under the runtime's budget by demoting them: the device planes
go to pinned host memory (validity and BOOLEAN planes bit-packed on the
device first, 8 rows a byte), and when the host tier passes
``spark.rapids.memory.host.spillStorageSize`` a host handle's planes go
to disk, one ``.npy`` file a plane, in a directory the catalog makes
with ``tempfile.mkdtemp`` and removes when it closes.  ``get()``
promotes a handle back, bit for bit.  Demotion takes the lowest
priority class first (``PRIORITY_*``) and the least recently used handle
within a class; a pinned handle (one being materialized) never demotes.

The device -> host copies are asynchronous copies into pinned memory on
the current stream; each handle records an event after them, and
anything that reads the host planes (a write to disk, a promotion) waits
on that event first.  A demotion that fails with an ``IOError`` or
``OSError`` (a full disk, an injected fault) is bounded, as in the JAX
package: the catalog counts it in ``demote_failure_count``, logs it,
leaves the handle whole on its tier and tries the next handle, so one
handle that cannot move never fails the operator that needed room; any
other error propagates.  The ``spill.demote`` and ``spill.promote``
fault sites (``faults.py``) fire before a transition changes anything;
a failed promotion raises.

Per-query budgets (``spark.rapids.server.query.maxDeviceBytes``, set by
the session server's tenant confs): a handle made under a query with a
budget carries the query's id, and when the query's device-resident
handles pass the budget, the query's own unpinned handles demote to the
host (priority class, then LRU, the new handle last) and never a
neighbour's; if that cannot bring it under (its handles are pinned, as
``materialize_all`` pins them), the query is cancelled through its
token with ``QueryBudgetExceededError``.  A promotion re-checks the
budget of the query that made the handle.

Each tier move is journaled (``spill_demote`` / ``spill_promote`` with
``tier_from``, ``tier_to`` and ``bytes``, the JAX package's events):
recorded under the catalog's lock as it happens, written after the lock
is released at the JAX package's sites (a promotion, ``spill_all``, a
query budget's demotions and ``reserve``).

An encoded string column spills its codes and validity and keeps its
shared dictionary on the device; a plane column (RLE, delta-narrowed or
bit-packed, ``columnar/encoding.py``) spills its compressed planes; each
comes back as the same class, never decoded.

Host staging admission (``HostStagingLimiter``, the JAX package's):
the catalog holds three limiters, each capped at
``spark.rapids.memory.pinnedPool.size`` while
``spark.rapids.memory.tpu.pooling.enabled`` is on (0 disables):
``staging`` bounds the tier transitions' host copies and the scans'
serial uploads, ``prefetch_staging`` the decoded batches a scan's
background decode holds, ``egress_staging`` the result pulls.  Three
waiter classes with no resource between them, so none can wait on
another.  The boolean planes a transition moves are packed by the
egress codec's ``bitpack_plane`` (``columnar/transfer.py``).

The device scan cache (``runtime.py: ScanCache``) holds its batches
here as ``PRIORITY_RECREATABLE`` handles, whose leak warning is
suppressed and whose writes are guarded (``guard_writes``): a batch the
cache shares across queries that a consumer wrote in place raises
``CachedBatchWrittenError`` at its next ``get``, where the JAX
package's arrays cannot be written at all.  ``audit_leaks`` leaves
those handles out: they outlive their query by design, and the runtime
clears the cache before its shutdown audit.

Not carried over yet: the conf-driven allocation log.
"""

from __future__ import annotations

import atexit
import contextlib
import itertools
import logging
import os
import shutil
import tempfile
import threading
import time
import warnings
import weakref
from typing import Dict, Iterable, List, Optional

import numpy as np
import torch

from spark_rapids_tpu_torch import faults, lifecycle
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.encoding import restore_column, \
    stored_planes
from spark_rapids_tpu_torch.columnar.transfer import bitpack_plane, \
    bitunpack_plane
from spark_rapids_tpu_torch.errors import QueryBudgetExceededError, \
    QueryCancelledError
from spark_rapids_tpu_torch.obs import journal

log = logging.getLogger("spark_rapids_tpu_torch.spill")

TIER_DEVICE = "device"
TIER_HOST = "host"
TIER_DISK = "disk"
# a move to a lower rank is a promotion
_TIER_RANK = {TIER_DEVICE: 0, TIER_HOST: 1, TIER_DISK: 2}

# Lower values demote first: re-creatable data before working batches,
# and a broadcast build every stream batch needs last.
PRIORITY_RECREATABLE = -100
PRIORITY_NORMAL = 0
PRIORITY_RETAIN = 100


class CachedBatchWrittenError(RuntimeError):
    """A guarded handle's batch was written in place since it was
    stored: an operator wrote into its input, and every later reader of
    the shared batch would see the write."""

class HostStagingLimiter:
    """At most ``cap`` bytes of host staging admitted at once (the JAX
    package's class; ``cap == 0`` disables it).  ``name`` is the waiter
    class ("spill", "prefetch", "egress"): its waits are recorded in
    the ``staging.<name>.wait.us`` histogram."""

    _ABORT_POLL_S = 0.05

    def __init__(self, cap_bytes: int = 0, name: str = ""):
        self.cap = max(0, int(cap_bytes))
        self.name = name
        self._inflight = 0
        self._cv = threading.Condition()
        self.wait_count = 0

    def acquire(self, nbytes: int, abort=None) -> int:
        """Wait until ``nbytes``, clamped to the cap so that one transfer
        always fits, are admitted; -> the bytes granted, for
        ``release``.  ``abort`` (default: the calling thread's query is
        cancelled or past its deadline) is polled while waiting: when it
        turns true the wait gives up holding nothing and -1 is
        returned.  ``cap == 0`` grants 0 at once."""
        if self.cap <= 0:
            return 0
        if abort is None:
            abort = lifecycle.cancel_requested
        ask = min(int(nbytes), self.cap)
        t0 = None
        try:
            with self._cv:
                if self._inflight + ask > self.cap:
                    self.wait_count += 1
                    t0 = time.perf_counter_ns()
                while self._inflight + ask > self.cap:
                    if abort():
                        return -1
                    self._cv.wait(timeout=self._ABORT_POLL_S)
                self._inflight += ask
            return ask
        finally:
            if t0 is not None and self.name:
                from spark_rapids_tpu_torch.obs import registry as obs
                hist = obs.STAGING_WAIT_HISTS.get(self.name)
                if hist is not None:
                    obs.record(hist, (time.perf_counter_ns() - t0) // 1000)

    def release(self, granted: int) -> None:
        if granted <= 0:
            return
        with self._cv:
            self._inflight -= granted
            self._cv.notify_all()

    @contextlib.contextmanager
    def limit(self, nbytes: int):
        """A section admitted for ``nbytes``; a wait the query's cancel
        ends raises its typed error (``QueryCancelledError`` or
        ``QueryTimeoutError``)."""
        granted = self.acquire(nbytes)
        if granted < 0:
            lifecycle.check_cancel()
            raise QueryCancelledError("host staging wait aborted")
        try:
            yield
        finally:
            self.release(granted)


class SpillableBatch:
    """A catalog-managed handle over one device batch.  ``priority``
    orders demotion across handles; the least recently used handle goes
    first within a class."""

    def __init__(self, batch: ColumnarBatch, catalog: "BufferCatalog",
                 priority: int = PRIORITY_NORMAL):
        self.priority = int(priority)
        self._catalog = catalog
        self.schema = batch.schema
        self.num_rows = batch.num_rows
        self.device = batch.device if batch.columns else None
        self._dtypes = [c.dtype for c in batch.columns]
        # an encoded column spills its codes and validity, never a dense
        # char matrix; its shared dictionary stays on the device in
        # _dicts (small, shared with other handles) and the column
        # re-wraps on the way back, as in the JAX package; a plane
        # column spills its compressed planes (_kinds: how to rebuild)
        stored = [stored_planes(c) for c in batch.columns]
        self._device: Optional[List[tuple]] = [p for p, _, _ in stored]
        self._dicts = [d for _, d, _ in stored]
        self._kinds = [k for _, _, k in stored]
        # host tier: CPU tensors; a bool plane is stored bit-packed and
        # its row count kept in _packed (0 for a plane stored as is)
        self._host: Optional[List[tuple]] = None
        self._packed: Optional[List[tuple]] = None
        self._ready: Optional[torch.cuda.Event] = None
        self._disk: Optional[List[tuple]] = None
        self.size = batch.size_bytes()
        self.tier = TIER_DEVICE
        self.pinned = False
        # guard_writes: the planes' version counters when last stored,
        # and whether a demotion found them changed
        self._versions: Optional[tuple] = None
        self._written = False
        catalog._register(self)

    @property
    def _cuda(self) -> bool:
        return self.device is not None and self.device.type == "cuda"

    # -- the write guard ------------------------------------------------------

    def _plane_versions(self) -> tuple:
        """The version counters of the device planes and of the shared
        dictionaries' planes (an in-place write bumps them)."""
        planes = tuple(-1 if a is None else a._version
                       for triple in self._device or () for a in triple)
        dicts = tuple((d.lengths._version, d.chars._version,
                       d.validity._version)
                      for d in self._dicts if d is not None)
        return planes, dicts

    def guard_writes(self) -> None:
        """From now on ``get`` raises ``CachedBatchWrittenError`` once a
        plane of the batch was written in place: its version counter
        moved, seen at ``get`` on the device or at a demotion (the host
        copy would keep the write).  A promotion records the new planes'
        counters."""
        with self._catalog._lock:
            self._versions = self._plane_versions()

    def _note_writes(self) -> None:
        if self._versions is not None and self._device is not None \
                and self._plane_versions() != self._versions:
            self._written = True

    # -- demotion (the catalog calls these under its lock) -------------------

    def _to_host(self) -> None:
        assert self._catalog._lock._is_owned(), \
            "catalog lock must be held for tier transitions"
        assert self.tier == TIER_DEVICE
        faults.maybe_fail("spill.demote", "injected device->host demotion "
                          f"failure ({self.size} bytes)")
        self._note_writes()
        cuda = self._cuda
        host, packed = [], []
        with self._catalog.staging.limit(self.size):
            for triple in self._device:
                planes, rows = [], []
                for a in triple:
                    if a is None:
                        planes.append(None)
                        rows.append(0)
                        continue
                    rows.append(a.shape[0] if a.dtype == torch.bool else 0)
                    if a.dtype == torch.bool:
                        a = bitpack_plane(a)
                    h = torch.empty(a.shape, dtype=a.dtype, pin_memory=cuda)
                    h.copy_(a, non_blocking=cuda)
                    planes.append(h)
                host.append(tuple(planes))
                packed.append(tuple(rows))
            if cuda:
                self._ready = torch.cuda.Event()
                self._ready.record(torch.cuda.current_stream(self.device))
        self._host, self._packed = host, packed
        self._device = None
        self.tier = TIER_HOST
        self._catalog._sync_info(self)

    def _wait_host(self) -> None:
        """The device -> host copies are complete past this call."""
        if self._ready is not None:
            self._ready.synchronize()
            self._ready = None

    def _to_disk(self) -> None:
        assert self._catalog._lock._is_owned(), \
            "catalog lock must be held for tier transitions"
        assert self.tier == TIER_HOST
        faults.maybe_fail("spill.demote", "injected host->disk demotion "
                          f"failure ({self.size} bytes)")
        self._wait_host()
        written: List[str] = []
        paths = []
        try:
            for triple in self._host:
                ps = []
                for h in triple:
                    if h is None:
                        ps.append(None)
                        continue
                    p = self._catalog._spill_path()
                    np.save(p, h.numpy())
                    written.append(p)
                    ps.append(p)
                paths.append(tuple(ps))
        except BaseException:
            for p in written:
                _unlink(p)
            raise
        self._disk = paths
        self._host = None
        self.tier = TIER_DISK
        self._catalog._sync_info(self)

    def _from_disk(self) -> None:
        assert self.tier == TIER_DISK
        self._host = [tuple(None if p is None else
                            torch.from_numpy(np.load(p)) for p in ps)
                      for ps in self._disk]
        for ps in self._disk:
            for p in ps:
                if p is not None:
                    _unlink(p)
        self._disk = None
        self.tier = TIER_HOST
        self._catalog._sync_info(self)

    def _from_host(self) -> None:
        assert self.tier == TIER_HOST
        self._wait_host()
        dev = []
        with self._catalog.staging.limit(self.size):
            for triple, rows in zip(self._host, self._packed):
                planes = []
                for h, n in zip(triple, rows):
                    if h is None:
                        planes.append(None)
                        continue
                    t = h.to(self.device, non_blocking=self._cuda)
                    planes.append(bitunpack_plane(t, n) if n else t)
                dev.append(tuple(planes))
        self._device = dev
        self._host = self._packed = None
        self.tier = TIER_DEVICE
        if self._versions is not None:
            self._versions = self._plane_versions()
        self._catalog._sync_info(self)

    # -- materialization ----------------------------------------------------

    def get(self) -> ColumnarBatch:
        """The batch on its device, promoted through the tiers; room is
        made first, so a promotion can demote colder handles (never this
        one: it is pinned meanwhile).  A promotion then re-checks the
        budget of the query that made the handle.  A guarded handle
        (``guard_writes``) whose planes were written raises
        ``CachedBatchWrittenError``."""
        cat = self._catalog
        with cat._lock:
            was_pinned = self.pinned
            self.pinned = True
        promoted = False
        try:
            if self.tier != TIER_DEVICE:
                faults.maybe_fail(
                    "spill.promote", f"injected {self.tier}->device "
                    f"promotion failure ({self.size} bytes)")
                promoted = True
                cat.reserve(self.size)
            with cat._lock:
                if self.tier == TIER_DISK:
                    self._from_disk()
                    cat._move(self.size, TIER_DISK, TIER_HOST)
                if self.tier == TIER_HOST:
                    self._from_host()
                    cat._move(self.size, TIER_HOST, TIER_DEVICE)
                    cat.unspill_count += 1
                self._note_writes()
                if self._written:
                    raise CachedBatchWrittenError(
                        f"a cached batch of {self.num_rows} rows "
                        f"({', '.join(self.schema.names)}) was written in "
                        "place since it was stored")
                cat._touch(self)
                cols = [restore_column(dt, planes, self.num_rows, dct, kind)
                        for dt, planes, dct, kind in zip(
                            self._dtypes, self._device, self._dicts,
                            self._kinds)]
                out = ColumnarBatch(cols, self.num_rows, self.schema)
        finally:
            with cat._lock:
                self.pinned = was_pinned
            # the moves a promotion made, the failed ones' excluded
            cat._emit_tier_moves()
        if promoted:
            # after the pin is back as the caller had it: the batch in
            # hand stays valid if the check demotes this handle again
            cat._enforce_promote_budget(self)
        return out

    def host_nbytes(self) -> int:
        """Bytes the host tier holds for this handle (bit-packed planes
        at 8 rows a byte; the budget counts the device bytes, ``size``)."""
        if self._host is None:
            return 0
        return sum(h.numel() * h.element_size() for triple in self._host
                   for h in triple if h is not None)

    def close(self) -> None:
        self._catalog._deregister(self)
        for ps in self._disk or ():
            for p in ps:
                if p is not None:
                    _unlink(p)
        self._device = self._host = self._disk = None

    def device_storages(self) -> set:
        """The storages (``untyped_storage().data_ptr()``) of the batch's
        device planes and of its dictionaries' planes."""
        with self._catalog._lock:
            planes = [a for triple in self._device or () for a in triple
                      if a is not None]
            planes += [p for d in self._dicts if d is not None
                       for p in (d.lengths, d.chars, d.validity)]
            return {a.untyped_storage().data_ptr() for a in planes}

    @property
    def suppress_leak_warning(self) -> bool:
        info = self._catalog._info.get(id(self))
        return bool(info and info["suppress"])

    @suppress_leak_warning.setter
    def suppress_leak_warning(self, v: bool) -> None:
        info = self._catalog._info.get(id(self))
        if info is not None:
            info["suppress"] = bool(v)


def _unlink(path: str) -> None:
    with contextlib.suppress(FileNotFoundError):
        os.unlink(path)


class BufferCatalog:
    """The registry of spillable handles and the budget over them: a
    device budget, then a host budget past which host handles go to
    disk.  The counters (``stats()``) say what moved between the tiers."""

    def __init__(self, device_budget_bytes: int,
                 host_budget_bytes: int = 1 << 30,
                 spill_dir: Optional[str] = None,
                 pinned_pool_bytes: int = 0,
                 pooling_enabled: bool = False):
        self.device_budget = int(device_budget_bytes)
        self.host_budget = int(host_budget_bytes)
        # the three host staging limiters (see the module docstring)
        cap = pinned_pool_bytes if pooling_enabled else 0
        self.staging = HostStagingLimiter(cap, name="spill")
        self.prefetch_staging = HostStagingLimiter(cap, name="prefetch")
        self.egress_staging = HostStagingLimiter(cap, name="egress")
        self._owns_dir = spill_dir is None
        self._spill_dir = spill_dir
        self._file_ids = itertools.count()
        self._lock = threading.RLock()
        # weak references, so that a dropped handle can be found out
        # (the leak warning) instead of kept alive; ``_info`` keeps what
        # the death callback needs
        self._lru: Dict[int, "weakref.ref"] = {}  # insertion = LRU order
        self._info: Dict[int, dict] = {}
        self.device_bytes = 0
        self.host_bytes = 0
        self.disk_bytes = 0
        self.peak_device_bytes = 0
        self.spill_to_host_count = 0
        self.spill_to_host_bytes = 0
        self.spill_to_disk_count = 0
        self.spill_to_disk_bytes = 0
        self.unspill_count = 0
        self.demote_failure_count = 0
        self.leak_count = 0
        # per-query budgets: demotions they forced, and queries they
        # cancelled because demotion could not satisfy them
        self.budget_spill_count = 0
        self.budget_exceeded_count = 0
        # tier moves not journaled yet: [(promote, from, to, bytes)]
        self._moves: List[tuple] = []

    def stats(self) -> dict:
        with self._lock:
            return {k: getattr(self, k) for k in (
                "device_bytes", "host_bytes", "disk_bytes",
                "peak_device_bytes", "spill_to_host_count",
                "spill_to_host_bytes", "spill_to_disk_count",
                "spill_to_disk_bytes", "unspill_count",
                "demote_failure_count", "leak_count",
                "budget_spill_count", "budget_exceeded_count")}

    @property
    def spill_dir(self) -> Optional[str]:
        """The directory of the disk tier, once a handle went there."""
        return self._spill_dir

    def _spill_path(self) -> str:
        if self._spill_dir is None:
            self._spill_dir = tempfile.mkdtemp(prefix="spark-rapids-torch-"
                                                      "spill-")
            # a process that ends without close() removes it too
            atexit.register(shutil.rmtree, self._spill_dir,
                            ignore_errors=True)
        return os.path.join(self._spill_dir,
                            f"plane-{next(self._file_ids)}.npy")

    def close(self) -> None:
        """Remove the spill directory the catalog made."""
        if self._owns_dir and self._spill_dir is not None:
            shutil.rmtree(self._spill_dir, ignore_errors=True)
            self._spill_dir = None

    def audit_leaks(self) -> int:
        """Handles still registered (none when every operator closed
        what it made), but the device scan cache's: a handle whose leak
        warning is suppressed outlives its query by design."""
        with self._lock:
            return sum(not self._info[k]["suppress"] for k in self._lru)

    # -- registry -----------------------------------------------------------

    def _register(self, sb: SpillableBatch) -> None:
        key = id(sb)
        with self._lock:
            self._lru[key] = weakref.ref(
                sb, lambda _r, k=key: self._on_dead(k))
            self._info[key] = {"tier": sb.tier, "size": sb.size,
                               "suppress": False, "disk": None}
            self.device_bytes += sb.size
            self.peak_device_bytes = max(self.peak_device_bytes,
                                         self.device_bytes)
        # the new bytes may pass the budget: demote colder handles
        self.reserve(0)
        # and the query's own budget, when it has one
        qc = lifecycle.current()
        if qc is not None and qc.max_device_bytes > 0:
            with self._lock:
                info = self._info.get(key)
                if info is not None:
                    info["query"] = qc.query_id
            self._enforce_query_budget(qc, sb)

    def _release_bytes(self, tier: str, size: int) -> None:
        if tier == TIER_DEVICE:
            self.device_bytes = max(0, self.device_bytes - size)
        elif tier == TIER_HOST:
            self.host_bytes = max(0, self.host_bytes - size)
        else:
            self.disk_bytes = max(0, self.disk_bytes - size)

    def _move(self, size: int, tier_from: str, tier_to: str) -> None:
        self._moves.append((_TIER_RANK[tier_to] < _TIER_RANK[tier_from],
                            tier_from, tier_to, size))
        self._release_bytes(tier_from, size)
        if tier_to == TIER_DEVICE:
            self.device_bytes += size
            self.peak_device_bytes = max(self.peak_device_bytes,
                                         self.device_bytes)
        elif tier_to == TIER_HOST:
            self.host_bytes += size
        else:
            self.disk_bytes += size

    def _emit_tier_moves(self) -> None:
        """Journal the tier moves recorded so far, outside the lock: a
        journal write is file I/O, which no allocation should wait for
        behind the catalog's lock."""
        with self._lock:
            moves, self._moves = self._moves, []
        if not moves or not journal.enabled():
            return
        for promote, tier_from, tier_to, nbytes in moves:
            journal.emit(journal.EVENT_SPILL_PROMOTE if promote
                         else journal.EVENT_SPILL_DEMOTE,
                         tier_from=tier_from, tier_to=tier_to,
                         bytes=nbytes)

    def _on_dead(self, key: int) -> None:
        """A handle was collected while still registered: an operator
        leaked it.  Its bytes and files go, and a ResourceWarning says so
        unless the handle suppressed it."""
        with self._lock:
            if key not in self._lru:
                return
            del self._lru[key]
            info = self._info.pop(key)
            self._release_bytes(info["tier"], info["size"])
            self.leak_count += 1
        for ps in info["disk"] or ():
            for p in ps:
                if p is not None:
                    _unlink(p)
        if not info["suppress"]:
            warnings.warn(
                f"SpillableBatch leaked without close() (tier="
                f"{info['tier']}, {info['size']} bytes): operators must "
                "close or materialize their handles", ResourceWarning,
                stacklevel=2)

    def _deregister(self, sb: SpillableBatch) -> None:
        with self._lock:
            if id(sb) in self._lru:
                del self._lru[id(sb)]
                self._info.pop(id(sb), None)
                self._release_bytes(sb.tier, sb.size)

    def _sync_info(self, sb: SpillableBatch) -> None:
        info = self._info.get(id(sb))
        if info is not None:
            info["tier"] = sb.tier
            info["disk"] = sb._disk

    def _touch(self, sb: SpillableBatch) -> None:
        if id(sb) in self._lru:
            self._lru[id(sb)] = self._lru.pop(id(sb))  # to the MRU end

    # -- budget enforcement -------------------------------------------------

    def _demote(self, sb: SpillableBatch, transition) -> bool:
        """Run one tier transition -> whether it moved the handle.  An
        ``IOError``/``OSError`` is counted and logged, and the handle
        stays whole on its tier; any other error propagates."""
        try:
            transition()
            return True
        except (IOError, OSError) as e:
            self.demote_failure_count += 1
            log.warning("spill demotion of %d bytes (tier %s) failed, "
                        "skipping the handle: %s", sb.size, sb.tier, e)
            return False

    def _demote_to_host(self, sb: SpillableBatch,
                        budget: bool = False) -> bool:
        if not self._demote(sb, sb._to_host):
            return False
        self._move(sb.size, TIER_DEVICE, TIER_HOST)
        self.spill_to_host_count += 1
        self.spill_to_host_bytes += sb.size
        if budget:
            self.budget_spill_count += 1
        return True

    def _demote_to_disk(self, sb: SpillableBatch) -> bool:
        if not self._demote(sb, sb._to_disk):
            return False
        self._move(sb.size, TIER_HOST, TIER_DISK)
        self.spill_to_disk_count += 1
        self.spill_to_disk_bytes += sb.size
        return True

    def _live(self, order: bool) -> List[SpillableBatch]:
        live = [sb for sb in (r() for r in self._lru.values())
                if sb is not None]
        if order:
            # priority class first, least recently used within a class
            # (sorted() is stable over the LRU order)
            live = sorted(live, key=lambda sb: sb.priority)
        return live

    def spill_all(self) -> int:
        """Demote every unpinned device handle to the host (the relief an
        out-of-memory retry asks for); the bytes demoted (a handle whose
        demotion failed is skipped and not counted)."""
        freed = 0
        with self._lock:
            for sb in self._live(order=False):
                if sb.tier == TIER_DEVICE and not sb.pinned \
                        and self._demote_to_host(sb):
                    freed += sb.size
            self._host_overflow()
        self._emit_tier_moves()
        return freed

    def query_device_bytes(self, query_id: int) -> int:
        """Device-resident bytes of the handles query ``query_id`` made
        under its budget."""
        with self._lock:
            return sum(info["size"] for info in self._info.values()
                       if info.get("query") == query_id
                       and info["tier"] == TIER_DEVICE)

    def _enforce_promote_budget(self, sb: SpillableBatch) -> None:
        """A promotion's check: only a handle the thread's query made
        counts toward its budget."""
        qc = lifecycle.current()
        if qc is None or qc.max_device_bytes <= 0:
            return
        info = self._info.get(id(sb))
        if info is None or info.get("query") != qc.query_id:
            return
        self._enforce_query_budget(qc, sb, close_on_fail=False)

    def _enforce_query_budget(self, qc, new_sb: SpillableBatch,
                              close_on_fail: bool = True) -> None:
        """Bring the query's device-resident bytes under its budget by
        demoting its own unpinned handles (priority class, then LRU, the
        new handle last); past that, cancel it through its token with
        ``QueryBudgetExceededError`` and raise."""
        budget = qc.max_device_bytes
        used = self.query_device_bytes(qc.query_id)
        if used <= budget:
            return
        with self._lock:
            own = []
            for pos, sb in enumerate(self._live(order=False)):
                if sb.tier != TIER_DEVICE or sb.pinned:
                    continue
                if self._info.get(id(sb), {}).get("query") != qc.query_id:
                    continue
                own.append((sb is new_sb, sb.priority, pos, sb))
            own.sort(key=lambda t: t[:3])
            demoted = False
            for _is_new, _prio, _pos, sb in own:
                if used <= budget:
                    break
                if self._demote_to_host(sb, budget=True):
                    used -= sb.size
                    demoted = True
            if demoted:
                # the host tier may now be past its own budget
                self._host_overflow()
        self._emit_tier_moves()
        if used > budget:
            self.budget_exceeded_count += 1
            if close_on_fail:
                # the constructor that raises cannot hand its caller the
                # handle to close
                new_sb.close()
            qc.token.cancel(
                f"query device-resident bytes ({used}) exceed "
                f"spark.rapids.server.query.maxDeviceBytes ({budget}) and "
                "its working set cannot spill further",
                QueryBudgetExceededError)
            qc.check()

    def reserve(self, nbytes: int) -> None:
        """Make room for ``nbytes`` of new device data: demote device
        handles to the host, then host handles past the host budget to
        disk.  If everything left is pinned, or a demotion fails, it
        returns anyway: the allocation may still succeed, and if it does
        not, the caller's retry handles the error."""
        with self._lock:
            if (self.device_bytes + nbytes <= self.device_budget
                    and self.host_bytes <= self.host_budget):
                return
            for sb in self._live(order=True):
                if self.device_bytes + nbytes <= self.device_budget:
                    break
                if sb.tier == TIER_DEVICE and not sb.pinned:
                    self._demote_to_host(sb)
            self._host_overflow()
        self._emit_tier_moves()

    def _host_overflow(self) -> None:
        for sb in self._live(order=True):
            if self.host_bytes <= self.host_budget:
                break
            if sb.tier == TIER_HOST and not sb.pinned:
                self._demote_to_disk(sb)


# ---------------------------------------------------------------------------
# operator helpers
# ---------------------------------------------------------------------------

def collect_spillable(batches: Iterable[ColumnarBatch],
                      ctx) -> List[SpillableBatch]:
    """Drain a child's batches into handles, so an operator that holds
    its whole input (a global sort, a window) stays within the budget
    while it collects.  On an error the handles made so far are closed."""
    cat = ctx.runtime.catalog
    out: List[SpillableBatch] = []
    try:
        for b in batches:
            out.append(SpillableBatch(b, cat))
    except BaseException:
        close_all(out)
        raise
    return out


def close_all(handles: Iterable[SpillableBatch]) -> None:
    for sb in handles:
        sb.close()


def materialize_all(handles: List[SpillableBatch],
                    ctx) -> List[ColumnarBatch]:
    """Every handle's batch back on the device (all pinned before room is
    made, so making room cannot demote one of them), then the handles
    closed."""
    cat = ctx.runtime.catalog
    with cat._lock:
        for sb in handles:
            sb.pinned = True
    try:
        cat.reserve(sum(sb.size for sb in handles
                        if sb.tier != TIER_DEVICE))
        return [sb.get() for sb in handles]
    finally:
        close_all(handles)
