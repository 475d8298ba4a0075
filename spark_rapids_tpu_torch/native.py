"""Build, load and count the port's hand-written CUDA kernels.

Each kernel source under ``csrc/`` is compiled at first use with
``nvcc -gencode arch=compute_90a,code=sm_90a`` into a shared library with
a plain C interface, which is loaded with ``ctypes``.  The library lands
in ``_build/`` (listed in ``.gitignore``) under a name that carries the
hash of its source, so an edited source is never served a stale build.
A failed build raises with nvcc's stderr: there is no fallback.
``build_all`` starts one nvcc a source, all together, and waits for them.

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
from typing import Dict

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


def library_path(name: str) -> str:
    src = os.path.join(_PKG, KERNELS[name]["source"])
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(_BUILD_DIR, f"lib{name}-{digest}.so")


def build_all(names=None) -> Dict[str, str]:
    """Compile the kernels' libraries that are not up to date, one nvcc
    each, all started together -> each kernel's ``-Xptxas -v`` report
    ('' when it was already built).  Raises with nvcc's stderr when any
    build fails, after every nvcc has ended."""
    with _LOCK:
        return _build_all(list(KERNELS) if names is None else list(names))


def _build_all(names) -> Dict[str, str]:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", "-o", tmp,
               os.path.join(_PKG, KERNELS[name]["source"])]
        procs[name] = (out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    reports = {name: "" for name in names}
    failed = []
    for name, (out, tmp, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name} "
                          f"(exit {proc.returncode}):\n{err}")
            continue
        os.replace(tmp, out)
        reports[name] = err
    if failed:
        raise RuntimeError("\n".join(failed))
    return reports


def build(name: str) -> str:
    """Compile one kernel's library unless it is up to date -> nvcc's
    ``-Xptxas -v`` report ('' when it was already built)."""
    return build_all([name])[name]


def load(name: str, declare=None) -> ctypes.CDLL:
    """The kernel's library, built at first use; ``declare(lib)`` sets
    its functions' ctypes signatures once, before any thread gets it."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            build(name)
            lib = ctypes.CDLL(library_path(name))
            if declare is not None:
                declare(lib)
            _LOADED[name] = lib
        return lib
