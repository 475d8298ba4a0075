"""The session server's result cache.

Counterpart of ``spark_rapids_tpu/server/result_cache.py``.  A finished
result is keyed on

    (plan fingerprint, input snapshot fingerprint, conf fingerprint,
     bindings)

from ``plan/fingerprint.py``: the plan fingerprint masks the prepared
bindings (they ride in the key beside it), and the snapshot changes
when a scanned file is rewritten or a view's in-memory columns are
replaced, so a stale entry never hits; it ages out of the LRU.  An
entry pins the in-memory columns its snapshot names by ``id()``.  The
cache is bounded by entries and by bytes (``HostResult.nbytes``), least
recently used first out, with hit, miss, eviction and insert counters.
The ``server.cache.lookup`` fault site turns a lookup into a miss,
counted apart (``faults``): a broken cache costs a recompute, never a
wrong or failed query.

The result cached is the port's ``HostResult``, not an Arrow table (the
card's machine has no pyarrow).  ``DiskResultTier`` writes pinless
entries (those over files only) through to a directory
(``spark.rapids.fleet.resultCache.dir``), pickled with a magic and a
CRC32; a defect of any kind (bad magic, a CRC mismatch, a truncated
file, an unpickling error, another key) is a counted miss and the file
is removed.

An entry put with ``leaves`` (``plan/fingerprint.snapshot_detail``'s
file tokens) can be maintained: when the same plan under the same conf
and bindings misses on a new snapshot, ``maintain_candidate`` hands the
server the earlier result and tokens, and an append-only diff lets the
server merge the new files in (``replace``) instead of recomputing
(``spark.rapids.stream.cache.maintain``).  Such entries never go to
disk as maintainable ones.
"""

from __future__ import annotations

import hashlib
import logging
import os
import pickle
import struct
import threading
import zlib
from collections import OrderedDict
from typing import Optional, Tuple

from spark_rapids_tpu_torch import faults
from spark_rapids_tpu_torch.server import stats

FAULT_SITE_CACHE_LOOKUP = "server.cache.lookup"

log = logging.getLogger("spark_rapids_tpu_torch.server.result_cache")

_DISK_MAGIC = b"SRTRES1\n"
_DISK_SUFFIX = ".res"


class DiskResultTier:
    """An on-disk result store: atomic writes (a temporary file and a
    rename), reads checked for magic, CRC and key, bounded by bytes with
    the oldest files (mtime) removed first."""

    def __init__(self, directory: str, max_bytes: int):
        if max_bytes <= 0:
            raise ValueError("disk result tier byte bound must be positive")
        self.directory = str(directory)
        self.max_bytes = int(max_bytes)
        os.makedirs(self.directory, exist_ok=True)
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.inserts = 0
        self.evictions = 0
        self.corrupt = 0

    def _path(self, key) -> str:
        digest = hashlib.sha256(repr(key).encode()).hexdigest()
        return os.path.join(self.directory, digest + _DISK_SUFFIX)

    def lookup(self, key):
        path = self._path(key)
        try:
            with open(path, "rb") as f:
                blob = f.read()
        except OSError:
            self._count("misses", "disk_cache_misses")
            return None
        try:
            head = len(_DISK_MAGIC)
            if len(blob) < head + 4 or not blob.startswith(_DISK_MAGIC):
                raise ValueError("bad magic or truncated")
            (crc,) = struct.unpack("<I", blob[head:head + 4])
            payload = blob[head + 4:]
            if zlib.crc32(payload) & 0xFFFFFFFF != crc:
                raise ValueError("CRC mismatch")
            stored_key, result = pickle.loads(payload)
            if stored_key != key:
                raise ValueError("stored key mismatch")
        except Exception as e:
            self._count("corrupt", "disk_cache_corrupt")
            self._count("misses", "disk_cache_misses")
            log.warning("disk result entry %s unreadable (%s); removed, "
                        "taken as a miss", os.path.basename(path), e)
            try:
                os.remove(path)
            except OSError:
                pass
            return None
        self._count("hits", "disk_cache_hits")
        return result

    def put(self, key, result) -> None:
        try:
            payload = pickle.dumps((key, result))
        except Exception:
            return  # not picklable: memory only
        if len(payload) > self.max_bytes:
            return
        path = self._path(key)
        tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
        try:
            with open(tmp, "wb") as f:
                f.write(_DISK_MAGIC)
                f.write(struct.pack("<I", zlib.crc32(payload) & 0xFFFFFFFF))
                f.write(payload)
            os.replace(tmp, path)
        except OSError as e:
            log.warning("disk result write failed (%s); entry skipped", e)
            try:
                os.remove(tmp)
            except OSError:
                pass
            return
        self._count("inserts", "disk_cache_inserts")
        self._evict()

    def _evict(self) -> None:
        try:
            entries = []
            total = 0
            with os.scandir(self.directory) as it:
                for de in it:
                    if not de.name.endswith(_DISK_SUFFIX):
                        continue
                    try:
                        st = de.stat()
                    except OSError:
                        continue
                    entries.append((st.st_mtime_ns, de.path, st.st_size))
                    total += st.st_size
            for _mt, path, size in sorted(entries):
                if total <= self.max_bytes:
                    return
                try:
                    os.remove(path)
                except OSError:
                    continue
                self._count("evictions", "disk_cache_evictions")
                total -= size
        except OSError as e:
            log.warning("disk result eviction scan failed: %s", e)

    def _count(self, local: str, global_key: str) -> None:
        with self._lock:
            setattr(self, local, getattr(self, local) + 1)
        stats.bump(global_key)

    def snapshot_stats(self) -> dict:
        with self._lock:
            return {"dir": self.directory, "max_bytes": self.max_bytes,
                    "hits": self.hits, "misses": self.misses,
                    "inserts": self.inserts, "evictions": self.evictions,
                    "corrupt": self.corrupt}


def _part_key(key) -> tuple:
    """``key`` without its snapshot: what a cached result and the same
    query over a grown input share."""
    return (key[0],) + tuple(key[2:])


class ResultCache:
    """An LRU of key -> (result, nbytes, pins, leaves), bounded by
    entries and bytes.  With ``disk`` it writes pinless entries through
    and looks a memory miss up there (a disk hit moves into memory)."""

    def __init__(self, max_entries: int, max_bytes: int,
                 disk: Optional[DiskResultTier] = None):
        if max_entries <= 0 or max_bytes <= 0:
            raise ValueError("result cache bounds must be positive")
        self.max_entries = int(max_entries)
        self.max_bytes = int(max_bytes)
        self.disk = disk
        self._lock = threading.Lock()
        self._entries: "OrderedDict" = OrderedDict()
        # part key -> the key of the latest maintainable entry (pruned
        # when it turns out evicted)
        self._maintain: dict = {}
        self._bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.inserts = 0
        self.faults = 0

    def lookup(self, key):
        """The cached result for ``key``, or None (a miss).  An injected
        ``server.cache.lookup`` fault is a miss, counted apart."""
        if faults.should_fire(FAULT_SITE_CACHE_LOOKUP):
            with self._lock:
                self.faults += 1
                self.misses += 1
            stats.bump("cache_faults")
            stats.bump("cache_misses")
            return None
        with self._lock:
            ent = self._entries.get(key)
            if ent is None:
                self.misses += 1
            else:
                self._entries.move_to_end(key)
                self.hits += 1
        if ent is not None:
            stats.bump("cache_hits")
            return ent[0]
        stats.bump("cache_misses")
        if self.disk is not None:
            result = self.disk.lookup(key)
            if result is not None:
                self._insert(key, result, ())
                return result
        return None

    def put(self, key, result, pins: Tuple = (),
            leaves: Optional[tuple] = None) -> None:
        self._insert(key, result, pins, leaves)
        if self.disk is not None and not pins:
            # a pinned entry's key holds an id() of this process
            self.disk.put(key, result)

    def maintain_candidate(self, new_key):
        """``(old_key, result, leaves)`` of the latest maintainable entry
        of the same plan, conf and bindings under another snapshot, or
        None."""
        pk = _part_key(new_key)
        with self._lock:
            old_key = self._maintain.get(pk)
            if old_key is None or old_key == new_key:
                return None
            ent = self._entries.get(old_key)
            if ent is None or ent[3] is None:
                self._maintain.pop(pk, None)
                return None
            return old_key, ent[0], ent[3]

    def replace(self, old_key, new_key, result, pins: Tuple = (),
                leaves: Optional[tuple] = None) -> None:
        """A maintained entry under its new snapshot's key; the stale
        one goes (it can never hit again)."""
        with self._lock:
            old = self._entries.pop(old_key, None)
            if old is not None:
                self._bytes -= old[1]
        self.put(new_key, result, pins, leaves)

    def _insert(self, key, result, pins: Tuple,
                leaves: Optional[tuple] = None) -> None:
        nbytes = int(getattr(result, "nbytes", 0))
        if nbytes > self.max_bytes:
            return  # larger than the whole cache
        evicted = 0
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old[1]
            self._entries[key] = (result, nbytes, pins, leaves)
            self._bytes += nbytes
            if leaves is not None:
                self._maintain[_part_key(key)] = key
            while self._entries and (len(self._entries) > self.max_entries
                                     or self._bytes > self.max_bytes):
                _k, (_r, b, _p, _lv) = self._entries.popitem(last=False)
                self._bytes -= b
                self.evictions += 1
                evicted += 1
            self.inserts += 1
            entries, total = len(self._entries), self._bytes
        stats.bump("cache_inserts")
        stats.bump("cache_evictions", evicted)
        stats.set_gauge("cache_bytes", total)
        stats.set_gauge("cache_entries", entries)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._maintain.clear()
            self._bytes = 0
        stats.set_gauge("cache_bytes", 0)
        stats.set_gauge("cache_entries", 0)

    def snapshot_stats(self) -> dict:
        with self._lock:
            out = {"entries": len(self._entries), "bytes": self._bytes,
                   "hits": self.hits, "misses": self.misses,
                   "evictions": self.evictions, "inserts": self.inserts,
                   "faults": self.faults, "max_entries": self.max_entries,
                   "max_bytes": self.max_bytes}
        if self.disk is not None:
            out["disk"] = self.disk.snapshot_stats()
        return out
