"""Out-of-memory retry, with split-and-retry.

Counterpart of ``spark_rapids_tpu/utils/retry.py`` (``is_device_oom``,
``split_batch_half``, ``with_retry``, ``_split_with_relief``).  On a
device out-of-memory error an operator first asks the spill catalog to
demote everything it can and runs again; if that fails too, and the
operator allows it, it splits its input batch in half by rows and runs
each half the same way, to a bounded depth.  What no split absorbs
raises ``torch.OutOfMemoryError`` to the caller.

PyTorch raises an allocation failure synchronously, at the call that
allocates (after the caching allocator has freed its cache and tried
again), so the error surfaces inside the retry scope without the sync
the JAX package makes on every attempt for XLA's asynchronous dispatch.
An exception's traceback holds the failed attempt's frames, and with
them its tensors, so those frames are cleared before the relief and
the next attempt, which run after the ``except`` block has ended.

The ``kernel.launch`` fault site (``faults.py``) fires once at each
``with_retry`` call, before its first attempt (a split's halves each
call it again), and raises an injected out-of-memory error there; the
fused stage (``exec/stage.py``) fires it itself on every attempt and
passes ``fire_launch_site=False``, as in the JAX package.  Not carried
over: ``Backoff`` (the shuffle's, queue A8).
"""

from __future__ import annotations

import traceback
from typing import Callable, List, Optional

import torch

from spark_rapids_tpu_torch import faults


def is_device_oom(e: BaseException) -> bool:
    """True for ``torch.OutOfMemoryError`` and for the out-of-memory
    messages the JAX package matches."""
    if isinstance(e, torch.OutOfMemoryError):
        return True
    s = str(e)
    return ("RESOURCE_EXHAUSTED" in s or "Out of memory" in s
            or "out of memory" in s)


def split_batch_half(batch):
    """The first and the second half of ``batch``'s rows, each at the
    bucket capacity of its own count."""
    n = batch.num_rows
    mid = n // 2
    return [batch.slice_rows(0, mid), batch.slice_rows(mid, n - mid)]


def _relieve(ctx) -> None:
    if ctx is not None:
        ctx.runtime.catalog.spill_all()


def _attempt(fn: Callable, batch, fire_launch_site: bool = False) -> tuple:
    """``(True, fn(batch))``, or ``(False, error)`` after a device
    out-of-memory error; any other error propagates.  The error's
    frames are cleared first: their locals are the failed attempt's
    tensors, which must be free before the relief and the next try."""
    try:
        if fire_launch_site:
            faults.maybe_fail_oom("kernel.launch")
        return True, fn(batch)
    except Exception as e:  # narrowed by is_device_oom below
        if not is_device_oom(e):
            raise
        traceback.clear_frames(e.__traceback__)
        return False, e


def with_retry(fn: Callable, batch, ctx=None,
               split: Optional[Callable] = None,
               max_depth: int = 3, fire_launch_site: bool = True) -> List:
    """``[fn(batch)]``; on a device out-of-memory error, demote every
    spillable handle and run again, then (with ``split``) split the
    batch and recurse on each part, ``max_depth`` levels at most.  With
    ``split=None`` it retries without splitting, for an operator whose
    input must stay whole.  The results come in row order."""
    ok, res = _attempt(fn, batch, fire_launch_site)
    if ok:
        return [res]
    del res
    _relieve(ctx)
    ok, res = _attempt(fn, batch)
    if ok:
        return [res]
    if split is None or max_depth <= 0 or batch.num_rows <= 1:
        raise res
    del res
    out: List = []
    for part in _split_with_relief(split, batch, ctx):
        out.extend(with_retry(fn, part, ctx, split, max_depth - 1,
                              fire_launch_site))
    return out


def _split_with_relief(split: Callable, batch, ctx) -> List:
    """``split(batch)``, with one relief and retry if the halves, made
    while the whole batch is still alive, run out of memory themselves."""
    ok, halves = _attempt(split, batch)
    if ok:
        return halves
    del halves
    _relieve(ctx)
    return split(batch)
