"""Build, load and count the port's hand-written CUDA kernels.

Each kernel source under ``csrc/`` is compiled at first use with
``nvcc -gencode arch=compute_90a,code=sm_90a`` into a shared library with
a plain C interface, which is loaded with ``ctypes``.  The library lands
in ``_build/`` (listed in ``.gitignore``) under a name that carries the
hash of its source, so an edited source is never served a stale build.
A failed build raises with nvcc's stderr: there is no fallback.
``build_all`` starts one nvcc a source, all together, and waits for them.

With the compile store installed (``spark.rapids.sql.compile.store.
enabled``, ``compile/store.py``) the libraries live in
``<cacheDir>/cuda/`` instead, shared by the processes that name the
directory: one its index records at its present size is loaded, never
built (``compileStoreHits``); any other is built and recorded
(``compileStoreMisses``); one that will not load is counted corrupt and
built again.  ``compile/service.py`` keeps the nvcc ms against the load
ms.

``LAUNCHES`` counts, per kernel, the launches its wrapper made
(``count_launch``); a run resets it to show that its main path went
through the kernels.  ``load``, and with it ``build_all``, runs under
one process-wide lock, so threads that reach a kernel before it is
built (the session server's workers) build it once, not each into the
same temporary file.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Set

_PKG = os.path.dirname(os.path.abspath(__file__))
_BUILD_DIR = os.path.join(_PKG, "_build")

# kernel name -> (source under the package, the TPU kernel it replaces)
KERNELS: Dict[str, Dict[str, str]] = {
    "dense_slot_reduce": {
        "source": "csrc/dense_slot_reduce.cu",
        "replaces": "spark_rapids_tpu/exec/pallas_agg.py:139",
    },
    "contains": {
        "source": "csrc/contains.cu",
        "replaces": "spark_rapids_tpu/exprs/pallas_strings.py:69",
    },
}

LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}

_LOADED: Dict[str, ctypes.CDLL] = {}
# loads ``_LOADED`` answered (plan/cost.py: expected_compile_ms)
_LOAD_STATS = {"memo_hits": 0}


# held by load, build_all and the launch counts
_LOCK = threading.RLock()


def reset_launches() -> None:
    with _LOCK:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def count_launch(name: str) -> None:
    """Add one to ``name``'s count (a wrapper calls this where it
    launches its kernel)."""
    with _LOCK:
        LAUNCHES[name] += 1


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                           "bin", "nvcc")
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit on the machine that has the card")


def library_file(name: str) -> str:
    """The library's file name: the kernel's name and its source's
    hash, so an edited source is never served a stale build."""
    src = os.path.join(_PKG, KERNELS[name]["source"])
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return f"lib{name}-{digest}.so"


def _store():
    from spark_rapids_tpu_torch.compile import store
    return store.current()


def library_path(name: str) -> str:
    """Where the library is built and loaded from: the compile store's
    ``cuda/`` directory while one is installed, else ``_build/``."""
    st = _store()
    if st is not None:
        return st.library_path(library_file(name))
    return os.path.join(_BUILD_DIR, library_file(name))


def _open_library(path: str) -> ctypes.CDLL:
    """``ctypes.CDLL`` (a seam for tests without a toolkit)."""
    return ctypes.CDLL(path)


def _start_nvcc(src: str, out: str) -> subprocess.Popen:
    """One nvcc of ``src`` into ``out`` (a seam for tests without a
    toolkit)."""
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
           "-Xptxas", "-v", "-o", out, src]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def build_all(names=None) -> Dict[str, str]:
    """Compile the kernels' libraries that are not up to date, one nvcc
    each, all started together -> each kernel's ``-Xptxas -v`` report
    ('' when it was already built).  Raises with nvcc's stderr when any
    build fails, after every nvcc has ended."""
    with _LOCK:
        return _build_all(list(KERNELS) if names is None else list(names))


def _build_all(names, force: Set[str] = frozenset()) -> Dict[str, str]:
    from spark_rapids_tpu_torch.compile import service
    st = _store()
    os.makedirs(_BUILD_DIR if st is None else st.lib_dir, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if name not in force:
            if st is not None:
                if st.lookup(out):
                    continue
            elif os.path.exists(out):
                continue
        tmp = f"{out}.{os.getpid()}.tmp"
        procs[name] = (out, tmp, _start_nvcc(
            os.path.join(_PKG, KERNELS[name]["source"]), tmp))
    reports = {name: "" for name in names}
    failed = []
    for name, (out, tmp, proc) in procs.items():
        _, err = proc.communicate()
        # all started together: each one's wall from the common start
        ms = (time.perf_counter() - t0) * 1e3
        if proc.returncode != 0:
            service.note_build(ms, ok=False)
            failed.append(f"nvcc failed for {name} "
                          f"(exit {proc.returncode}):\n{err}")
            continue
        os.replace(tmp, out)
        service.note_build(ms)
        if st is not None:
            st.record_build(out, ms)
        reports[name] = err
    if failed:
        raise RuntimeError("\n".join(failed))
    return reports


def build(name: str) -> str:
    """Compile one kernel's library unless it is up to date -> nvcc's
    ``-Xptxas -v`` report ('' when it was already built)."""
    return build_all([name])[name]


def load(name: str, declare=None) -> ctypes.CDLL:
    """The kernel's library, built at first use (or loaded from the
    compile store); ``declare(lib)`` sets its functions' ctypes
    signatures once, before any thread gets it."""
    from spark_rapids_tpu_torch.compile import service
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is not None:
            _LOAD_STATS["memo_hits"] += 1
            return lib
        st = _store()
        hits = st.stats()["hits"] if st is not None else 0
        build(name)
        # a store hit: the library is loaded as the store holds it
        hit = st is not None and st.stats()["hits"] > hits
        path = library_path(name)
        t0 = time.perf_counter()
        try:
            lib = _open_library(path)
        except OSError:
            if st is None:
                raise
            # a library the store held that will not load: build anew
            st.note_corrupt()
            _build_all([name], force={name})
            hit = False
            lib = _open_library(path)
        if hit:
            service.note_store_load((time.perf_counter() - t0) * 1e3)
        if declare is not None:
            declare(lib)
        _LOADED[name] = lib
        return lib


def load_stats() -> Dict[str, int]:
    with _LOCK:
        return dict(_LOAD_STATS)


def unload_all() -> None:
    """Forget the loaded libraries, so the next ``load`` goes through
    the build and the store again (tests, and a new store)."""
    with _LOCK:
        _LOADED.clear()
        _LOAD_STATS["memo_hits"] = 0
