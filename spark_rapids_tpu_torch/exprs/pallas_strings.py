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
from typing import Callable, Tuple

import torch

from spark_rapids_tpu_torch import native
from spark_rapids_tpu_torch.exprs.base import ColVal
from spark_rapids_tpu_torch.exprs.strings import Contains, contains_unrolled

# needles at least this long route to the kernel; functions.contains
# reads it
PALLAS_PATTERN_MIN = 16

_THREADS = 256          # 8 warps a block
_STAGE_BYTES = 512      # bytes a warp stages at once: 32 lanes x 16 B
_SMEM_DEFAULT = 48 * 1024
_SMEM_MAX = 232448      # bytes of shared memory one Hopper block may use
_THREADS_PER_SM = 2048


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


def _kernel() -> ctypes.CDLL:
    lib = native.load("contains")
    if lib.contains_launch.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.contains_launch.argtypes = [vp, vp, ctypes.c_longlong, i, i, vp,
                                        i, vp, i, i, i, vp]
        lib.contains_launch.restype = i
        lib.contains_error.argtypes = [i]
        lib.contains_error.restype = ctypes.c_char_p
    return lib


def prepare_contains(chars: torch.Tensor, lengths: torch.Tensor, pat: bytes
                     ) -> Tuple[Callable[[], None], torch.Tensor]:
    """The wrapper's host work for CUDA tensors, for ``1 <= len(pat) <=
    width``: checks, a contiguous 16-byte aligned char matrix, the needle
    on the card, the output and the launch shape -> ``(launch, out)``.
    ``launch()`` runs the kernel on the current stream and fills ``out``
    (``torch.bool``); it may be called again on the same inputs."""
    _check(chars, lengths)
    if chars.device.type != "cuda":
        raise RuntimeError(f"contains: no kernel for {chars.device.type} "
                           "tensors")
    rows, w = chars.shape
    k = len(pat)
    if not 1 <= k <= w:
        raise ValueError(f"needle of {k} bytes for width {w}: the caller "
                         "answers k == 0 and k > width without the kernel")
    lib = _kernel()
    dev = chars.device
    chars = chars.contiguous()
    if chars.data_ptr() % 16:
        chars = chars.clone()
    lengths = lengths.contiguous()
    needle = torch.tensor(list(pat), dtype=torch.uint8).to(dev)
    out = torch.empty(rows, dtype=torch.bool, device=dev)
    per_warp = min(32, max(1, _STAGE_BYTES // w))
    stage = per_warp * w
    pat_pad = (k + 15) // 16 * 16
    warps = max(1, min(_THREADS // 32, (_SMEM_DEFAULT - pat_pad) // stage))
    smem = pat_pad + warps * stage
    if smem > _SMEM_MAX:
        raise ValueError(f"string width {w} needs {smem} bytes of shared "
                         f"memory a block, over {_SMEM_MAX}")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    groups = -(-rows // per_warp)
    blocks = max(1, min(-(-groups // warps),
                        sms * (_THREADS_PER_SM // (32 * warps))))

    def launch() -> None:
        if rows == 0:
            return
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.contains_launch(chars.data_ptr(), lengths.data_ptr(),
                                     rows, w, per_warp, needle.data_ptr(), k,
                                     out.data_ptr(), blocks, 32 * warps,
                                     smem, stream)
        if rc != 0:
            msg = lib.contains_error(rc).decode()
            raise RuntimeError(f"contains launch failed: CUDA error {rc} "
                               f"({msg})")
        native.LAUNCHES["contains"] += 1

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
