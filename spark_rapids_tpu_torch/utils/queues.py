"""The bounded queue receive.

Counterpart of ``spark_rapids_tpu/utils/queues.py``.  Every blocking
``Queue.get`` of the port's shuffle carries a timeout
(``tests/test_torch_shuffle_lint.py``): a dead sender parks its receiver
for a bounded slice, never forever.  The parent and the worker
processes of the host shuffle share this one receive, so the slice and
the timeout's meaning cannot drift between them.
"""

from __future__ import annotations

import queue as _queue
import time as _time

_POLL_SLICE_S = 1.0


def bounded_q_get(q, timeout_s: float, what: str):
    """Receive from ``q``, polling in slices of a second; raises
    ``TimeoutError`` naming ``what`` once ``timeout_s`` (at least one
    second) passed with nothing received."""
    deadline = _time.monotonic() + max(1.0, float(timeout_s))
    while True:
        try:
            return q.get(timeout=_POLL_SLICE_S)
        except _queue.Empty:
            if _time.monotonic() > deadline:
                raise TimeoutError(
                    f"timed out after {timeout_s:.0f}s waiting for "
                    f"{what}") from None
