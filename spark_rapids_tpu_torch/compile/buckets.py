"""The power-of-two capacity ladder.

Counterpart of ``spark_rapids_tpu/compile/buckets.py``.  Every batch
capacity routes through ``bucket_capacity`` (``columnar/column.py``), so
both packages pad a batch alike:

* ``spark.rapids.sql.compile.buckets.minRows``: the smallest rung
  (default 8, the JAX package's floor);
* ``spark.rapids.sql.compile.buckets.maxRows``: the largest rung the
  coalesce's row target snaps down to (``snap_rows``; 0, the default,
  is unbounded).  A batch larger than it still gets a capacity that
  holds it.

Both bounds round up to powers of two.  With the keys unset the ladder
is the JAX package's default one and the coalesce's target is the conf
value as it is.
"""

from __future__ import annotations

import threading

_DEFAULT_MIN = 8
_DEFAULT_MAX = 0  # unbounded

_LOCK = threading.Lock()
_MIN = _DEFAULT_MIN
_MAX = _DEFAULT_MAX
_CONFIGURED = False


def _pow2_at_least(n: int) -> int:
    c = 1
    while c < n:
        c <<= 1
    return c


def configure(min_rows: int = _DEFAULT_MIN,
              max_rows: int = _DEFAULT_MAX) -> None:
    """Set the ladder's bounds (rounded up to powers of two)."""
    global _MIN, _MAX, _CONFIGURED
    with _LOCK:
        _MIN = _pow2_at_least(max(1, int(min_rows)))
        _MAX = _pow2_at_least(int(max_rows)) if max_rows > 0 else 0
        if _MAX and _MAX < _MIN:
            _MAX = _MIN
        _CONFIGURED = True


def configure_from_conf(conf) -> None:
    """Apply the ``spark.rapids.sql.compile.buckets.*`` keys, only when
    one is set: the ladder is process-wide, and a session that does not
    name it leaves another's bounds alone."""
    from spark_rapids_tpu_torch.conf import COMPILE_BUCKET_MAX_ROWS, \
        COMPILE_BUCKET_MIN_ROWS
    settings = conf.to_dict()
    if COMPILE_BUCKET_MIN_ROWS.key not in settings \
            and COMPILE_BUCKET_MAX_ROWS.key not in settings:
        return
    configure(conf.get(COMPILE_BUCKET_MIN_ROWS),
              conf.get(COMPILE_BUCKET_MAX_ROWS))


def reset() -> None:
    """Back to the default ladder (tests)."""
    global _MIN, _MAX, _CONFIGURED
    with _LOCK:
        _MIN = _DEFAULT_MIN
        _MAX = _DEFAULT_MAX
        _CONFIGURED = False


def configured() -> bool:
    return _CONFIGURED


def bucket_capacity(n: int) -> int:
    """The smallest rung >= ``n`` (and >= minRows); past maxRows the
    true next power of two, since a capacity must hold its rows."""
    c = _MIN
    while c < n:
        c <<= 1
    return c


def snap_rows(n: int) -> int:
    """The largest rung <= ``n`` (at least minRows, at most maxRows):
    the row target the coalesce fills toward, so its batches land on a
    rung."""
    n = max(1, int(n))
    c = _MIN
    while (c << 1) <= n:
        c <<= 1
    if _MAX and c > _MAX:
        c = _MAX
    return max(c, _MIN)


def stats() -> dict:
    with _LOCK:
        return {"minRows": _MIN, "maxRows": _MAX,
                "configured": int(_CONFIGURED)}
