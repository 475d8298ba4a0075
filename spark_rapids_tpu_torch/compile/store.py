"""The compile store: the nvcc-built kernel libraries, kept on disk.

Counterpart of ``spark_rapids_tpu/compile/store.py``.  The JAX store
keeps XLA executables and an index of stage triples; the port's one
compile is ``native.py``'s nvcc build of each hand kernel, so its store
keeps those libraries:

* ``<spark.rapids.sql.compile.cacheDir>/cuda/lib<kernel>-<digest>.so``:
  each library, named by the hash of its source, where ``native.py``
  builds it and loads it from while the store is installed;
* ``<cacheDir>/cuda/index.jsonl``: one line a build (the library's
  name, its bytes, the build ms, a timestamp), appended by every
  process sharing the directory.

``lookup`` classifies a library before ``native.py`` builds it: one the
index records at its present size is a hit (loaded, not built); any
other is a miss (built, then recorded).  Every failure degrades to a
counted fresh build, never a failed query: an injected
``compile.store`` fault (``faults``), a corrupt index line (skipped,
``corrupt``), a library whose size is not the recorded one (a truncated
write, ``corrupt``), a library that will not load (``native.py`` counts
it here and builds again) and a write that fails (``io_errors``).
``calibration.json`` (``plan/cost.py``) lives in ``<cacheDir>``.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import socket
import threading
import time
from typing import Dict, Optional

log = logging.getLogger("spark_rapids_tpu_torch.compile.store")

FAULT_SITE_STORE = "compile.store"

_LIB_DIR = "cuda"
_INDEX_NAME = "index.jsonl"


def host_fingerprint() -> str:
    """A short digest of the host's name and machine: libraries built
    for one host's toolkit never serve another's."""
    import platform
    raw = f"{socket.gethostname()}|{platform.machine()}"
    return hashlib.sha256(raw.encode()).hexdigest()[:12]


def default_store_dir() -> str:
    """``spark.rapids.sql.compile.cacheDir``'s default: under the
    user's cache directory, by host."""
    return os.path.join(os.path.expanduser("~"), ".cache", "srt-compile",
                        f"cuda-{host_fingerprint()}")


class KernelStore:
    """The libraries under ``root/cuda`` and their index (one store a
    process, installed by ``configure_from_conf``)."""

    def __init__(self, root: str):
        self.root = root
        self.lib_dir = os.path.join(root, _LIB_DIR)
        self.index_path = os.path.join(self.lib_dir, _INDEX_NAME)
        os.makedirs(self.lib_dir, exist_ok=True)
        self._lock = threading.Lock()
        # library file name -> bytes of its last recorded build
        self._seen: Dict[str, int] = {}
        self.hits = 0
        self.misses = 0
        self.faults = 0
        self.corrupt = 0
        self.io_errors = 0
        self.bytes_written = 0
        self._load_index()

    def _load_index(self) -> None:
        try:
            with open(self.index_path, encoding="utf-8") as fh:
                for line in fh:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                        key, nbytes = rec["key"], int(rec["bytes"])
                    except (ValueError, KeyError, TypeError):
                        # a torn or poisoned line costs one reuse, never
                        # a query
                        self.corrupt += 1
                        continue
                    self._seen[key] = nbytes
        except FileNotFoundError:
            pass
        except OSError as e:
            log.warning("cannot read the compile store's index %s: %s",
                        self.index_path, e)
            self.io_errors += 1

    def library_path(self, file_name: str) -> str:
        return os.path.join(self.lib_dir, file_name)

    def lookup(self, path: str) -> bool:
        """Whether the library at ``path`` may be loaded as it is (a
        counted hit) or must be built (a counted miss).  An injected
        ``compile.store`` fault is a counted fresh build."""
        from spark_rapids_tpu_torch import faults
        try:
            faults.maybe_fail(FAULT_SITE_STORE,
                              "injected compile-store failure")
        except faults.InjectedFault:
            with self._lock:
                self.faults += 1
                self.misses += 1
            return False
        key = os.path.basename(path)
        try:
            size = os.path.getsize(path)
        except OSError:
            size = -1
        with self._lock:
            recorded = self._seen.get(key)
            hit = recorded is not None and size == recorded
            if recorded is not None and size >= 0 and not hit:
                # recorded, but not at this size: a truncated write
                self.corrupt += 1
            if hit:
                self.hits += 1
            else:
                self.misses += 1
        return hit

    def record_build(self, path: str, build_ms: float) -> None:
        """Append one successful build to the index."""
        key = os.path.basename(path)
        try:
            nbytes = os.path.getsize(path)
            line = json.dumps({"key": key, "bytes": nbytes,
                               "ms": round(build_ms, 1),
                               "ts": round(time.time(), 3)},
                              separators=(",", ":")) + "\n"
            with open(self.index_path, "a", encoding="utf-8") as fh:
                fh.write(line)  # O_APPEND: one write for a short line
        except OSError as e:
            log.warning("compile-store write failed (the next process "
                        "builds again): %s", e)
            with self._lock:
                self.io_errors += 1
            return
        with self._lock:
            self.bytes_written += len(line)
            self._seen[key] = nbytes

    def note_corrupt(self) -> None:
        with self._lock:
            self.corrupt += 1

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"entries": len(self._seen), "hits": self.hits,
                    "misses": self.misses, "faults": self.faults,
                    "corrupt": self.corrupt, "io_errors": self.io_errors,
                    "bytes": self.bytes_written}


_STORE_LOCK = threading.Lock()
_STORE: Optional[KernelStore] = None


def current() -> Optional[KernelStore]:
    return _STORE


def install(cache_dir: str) -> Optional[KernelStore]:
    """Install the store at ``cache_dir`` (the same one again keeps its
    counters); None when the directory cannot be used."""
    global _STORE
    with _STORE_LOCK:
        if _STORE is not None and _STORE.root == cache_dir:
            return _STORE
        try:
            _STORE = KernelStore(cache_dir)
        except OSError as e:
            log.warning("cannot install the compile store at %r: %s",
                        cache_dir, e)
            _STORE = None
        return _STORE


def disable() -> None:
    global _STORE
    with _STORE_LOCK:
        _STORE = None


def reset() -> None:
    """Drop the installed store (tests)."""
    disable()


def configure_from_conf(conf) -> Optional[KernelStore]:
    """Install or drop the store from the conf, only when
    ``compile.store.enabled`` is set in it: the store is process-wide,
    and a session that does not name it leaves another's alone.  Fleet
    replicas and restarted servers get the directory with the conf."""
    from spark_rapids_tpu_torch.conf import COMPILE_CACHE_DIR, \
        COMPILE_STORE_ENABLED
    if COMPILE_STORE_ENABLED.key not in conf.to_dict():
        return _STORE
    if not conf.get(COMPILE_STORE_ENABLED):
        disable()
        return None
    return install(conf.get(COMPILE_CACHE_DIR) or default_store_dir())


def stats() -> Dict[str, int]:
    st = _STORE
    if st is None:
        return {"enabled": 0, "entries": 0, "hits": 0, "misses": 0,
                "faults": 0, "corrupt": 0, "io_errors": 0, "bytes": 0}
    out = {"enabled": 1}
    out.update(st.stats())
    return out
