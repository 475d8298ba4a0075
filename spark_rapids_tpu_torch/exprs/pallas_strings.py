"""Substring search with a long literal needle: the contains kernel.

Counterpart of ``spark_rapids_tpu/exprs/pallas_strings.py`` (the module
keeps its name so a reader finds it).  ``functions.contains`` routes a
literal needle of at least ``PALLAS_PATTERN_MIN`` bytes to
``PallasContains``; shorter ones keep ``Contains``' unrolled compare,
whose work grows with the needle.

``run_contains`` is the kernel's wrapper: on a CUDA tensor it launches
the hand-written Hopper kernel (``csrc/contains.cu``, which replaces the
TPU kernel ``_run_contains`` / ``_contains_kernel``) or raises; on a CPU
tensor it runs ``contains_reference``, the plain PyTorch version of the
same contract.  The JAX package probes its kernel once and degrades to
the XLA compare when the probe fails (``pallas_available``,
``reset_probe``); the port has no such fallback, so neither has a
counterpart here.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Callable, Tuple

import torch

from spark_rapids_tpu_torch import native
from spark_rapids_tpu_torch.exprs.base import ColVal
from spark_rapids_tpu_torch.exprs.strings import Contains, contains_unrolled

# needles at least this long route to the kernel; functions.contains
# reads it
PALLAS_PATTERN_MIN = 16

SHIFT_AND_MAX = 64      # longest needle of the Shift-And paths
NEEDLE_BYTES = 1024     # longest needle that goes to the kernel by value
_TILE_ROWS = 256        # rows a block takes at a time, at most
_TILE_SMEM = 48 * 1024  # shared memory a block aims at, so blocks share an SM
_SMEM_MAX = 232448      # bytes of shared memory one Hopper block may use
_SMEM_PER_SM = 233472   # bytes of shared memory one SM holds for its blocks
_SMEM_PER_BLOCK = 1024  # of which the card keeps this much for each block
_PATHS = {"shift_and32": 0, "shift_and64": 1, "long": 2}


@dataclass(frozen=True)
class ContainsPlan:
    """One launch's shape."""
    path: str      # "shift_and32", "shift_and64" or "long"
    rows: int      # rows a tile: thread t takes row t of each tile
    stride: int    # bytes of a thread's stage row
    stages: int    # stage rows a thread: 2 overlap a tile's copies
    threads: int   # threads a block
    smem: int      # bytes of dynamic shared memory a block
    grid: int      # blocks, one wave that walks the tiles


def plan_contains(width: int, k: int, rows: int, sms: int) -> ContainsPlan:
    """The kernel's launch shape for a (``rows``, ``width``) char matrix
    and a ``k``-byte needle, ``1 <= k <= width``, on a card of ``sms``
    SMs: Shift-And with a 32-bit state up to 32 bytes and a 64-bit one up
    to 64, the prefilter-and-compare path beyond.  A block holds the
    needle's 256-entry mask table and two stages of a tile's rows,
    ``width + 16`` bytes apart (16 at width 8): an odd number of 16-byte
    units from width 32 up, so 16-byte reads of rows t and t + 1 never
    share a bank; tiles of up to 256 rows near 48 KB; one stage when two
    would not fit.  Raises when one row does not fit a block's shared
    memory."""
    if k <= 32:
        path, table = "shift_and32", 256 * 4
    elif k <= SHIFT_AND_MAX:
        path, table = "shift_and64", 256 * 8
    else:
        path, table = "long", 0
    stride = width + 16 if width >= 16 else 16
    stages = 2
    tile = min(_TILE_ROWS, (_TILE_SMEM - table) // (stages * stride))
    if tile < 1:
        tile = 1
        if table + stages * stride > _SMEM_MAX:
            stages = 1
    smem = table + stages * tile * stride
    if smem > _SMEM_MAX:
        raise ValueError(f"string width {width} needs {smem} bytes of shared "
                         f"memory a block, over {_SMEM_MAX}")
    threads = -(-tile // 32) * 32
    per_sm = max(1, min(2048 // threads,
                        _SMEM_PER_SM // (smem + _SMEM_PER_BLOCK)))
    grid = max(1, min(-(-rows // tile), sms * per_sm))
    return ContainsPlan(path, tile, stride, stages, threads, smem, grid)


def contains_reference(chars: torch.Tensor, lengths: torch.Tensor,
                       pat: bytes) -> torch.Tensor:
    """Plain PyTorch version of the kernel: ``Contains``' unrolled
    compare (every edge case included)."""
    return contains_unrolled(chars, lengths, pat)


def _check(chars: torch.Tensor, lengths: torch.Tensor) -> None:
    if chars.dtype != torch.uint8 or chars.dim() != 2:
        raise TypeError(f"chars must be a 2-D uint8 tensor, got {chars.dtype} "
                        f"of shape {tuple(chars.shape)}")
    w = chars.shape[1]
    if w < 8 or w & (w - 1):
        raise ValueError(f"string width {w} is not a power of two >= 8")
    if lengths.shape != (chars.shape[0],) or lengths.dtype != torch.int32:
        raise TypeError(f"lengths must be ({chars.shape[0]},) int32, got "
                        f"{lengths.dtype} of shape {tuple(lengths.shape)}")
    if lengths.device != chars.device:
        raise ValueError("chars and lengths lie on different devices")


def _declare(lib: ctypes.CDLL) -> None:
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.contains_launch.argtypes = [vp, vp, ctypes.c_longlong, i, i, i, i, i,
                                    i, i, i, ctypes.c_char_p, vp, i, vp, vp]
    lib.contains_launch.restype = i
    lib.contains_error.argtypes = [i]
    lib.contains_error.restype = ctypes.c_char_p


def _kernel() -> ctypes.CDLL:
    return native.load("contains", _declare)


def prepare_contains(chars: torch.Tensor, lengths: torch.Tensor, pat: bytes
                     ) -> Tuple[Callable[[], None], torch.Tensor]:
    """The wrapper's host work for CUDA tensors, for ``1 <= len(pat) <=
    width``: checks, a contiguous 16-byte aligned char matrix, the output
    and the launch shape -> ``(launch, out)``.  ``launch()`` runs the
    kernel on the current stream and fills ``out`` (``torch.bool``); it
    may be called again on the same inputs.  A needle of up to 1 KB goes
    to the kernel by value; a longer one from a card buffer."""
    _check(chars, lengths)
    if chars.device.type != "cuda":
        raise RuntimeError(f"contains: no kernel for {chars.device.type} "
                           "tensors")
    rows, w = chars.shape
    pat = bytes(pat)
    k = len(pat)
    if not 1 <= k <= w:
        raise ValueError(f"needle of {k} bytes for width {w}: the caller "
                         "answers k == 0 and k > width without the kernel")
    lib = _kernel()
    dev = chars.device
    plan = plan_contains(w, k, rows, torch.cuda.get_device_properties(
        dev).multi_processor_count)
    chars = chars.contiguous()
    if chars.data_ptr() % 16:
        chars = chars.clone()
    lengths = lengths.contiguous()
    needle = (torch.tensor(list(pat), dtype=torch.uint8, device=dev)
              if k > NEEDLE_BYTES else None)
    out = torch.empty(rows, dtype=torch.bool, device=dev)

    def launch() -> None:
        if rows == 0:
            return
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.contains_launch(chars.data_ptr(), lengths.data_ptr(),
                                     rows, w, plan.rows, plan.stride,
                                     plan.stages, plan.grid, plan.threads,
                                     plan.smem, _PATHS[plan.path], pat,
                                     None if needle is None
                                     else needle.data_ptr(), k,
                                     out.data_ptr(), stream)
        if rc != 0:
            msg = lib.contains_error(rc).decode()
            raise RuntimeError(f"contains launch failed: CUDA error {rc} "
                               f"({msg})")
        native.count_launch("contains")

    return launch, out


def run_contains(chars: torch.Tensor, lengths: torch.Tensor,
                 pat: bytes) -> torch.Tensor:
    """(rows,) bool: whether ``pat`` occurs in each row of the (rows,
    width) char matrix before the row's length.  CUDA tensors launch the
    Hopper kernel (``k == 0`` and ``k > width`` are answered without
    it); CPU tensors run the plain version."""
    _check(chars, lengths)
    if chars.device.type == "cpu":
        return contains_reference(chars, lengths, pat)
    k, rows = len(pat), chars.shape[0]
    if k == 0:
        return torch.ones(rows, dtype=torch.bool, device=chars.device)
    if k > chars.shape[1]:
        return torch.zeros(rows, dtype=torch.bool, device=chars.device)
    launch, out = prepare_contains(chars, lengths, pat)
    launch()
    return out


class PallasContains(Contains):
    """``Contains`` through the kernel: the same result, with work that
    does not grow with the needle's length unrolled."""

    def key(self) -> str:
        return "Pallas" + super().key()

    def _match(self, c: ColVal) -> torch.Tensor:
        # the wrapper answers k == 0 and k > width before any launch
        return run_contains(c.chars, c.data, self.pat)
