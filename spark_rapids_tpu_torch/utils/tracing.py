"""Profiler ranges fused with metrics, on ``torch.profiler``.

Counterpart of ``spark_rapids_tpu/utils/tracing.py``.  ``annotation``
gives a ``torch.profiler.record_function`` range, ``trace_range`` one
that also adds its host wall time to a metric, and ``query_trace`` runs
one query under ``torch.profiler.profile`` and writes its Chrome trace
to ``spark.rapids.sql.trace.dir``.

A range is opened when the process-wide switch is on (set from
``spark.rapids.sql.trace.enabled`` for the length of a query by
``query_trace``) or when a ``torch.profiler`` capture is already
recording, so a caller that profiles a query itself sees the operators'
ranges without setting the conf.  Otherwise a range costs one flag
check and one call into the profiler's state.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import time

import torch
from torch.profiler import record_function

# the span names the port's operators open; shared so that traces of
# different operators aggregate under the same labels
SPAN_PREFETCH_WAIT = "io.prefetch.wait"
SPAN_H2D_OVERLAP = "io.h2d.overlap"
SPAN_COALESCE_PULL = "io.coalesce.pull"
SPAN_D2H_WAIT = "io.d2h.wait"
SPAN_D2H_OVERLAP = "io.d2h.overlap"
SPAN_PLAN_FUSION = "plan.fusion"
# one span a stats-driven replan pass (exec/aqe.py)
SPAN_PLAN_AQE = "plan.aqe"

_enabled = False
_CAPTURES = itertools.count(1)


def set_enabled(on: bool) -> None:
    """Flip the process-wide span switch."""
    global _enabled
    _enabled = bool(on)


def is_enabled() -> bool:
    return _enabled


def annotation(name: str):
    """A profiler range for ``name`` while tracing is on or a
    ``torch.profiler`` capture is recording, else None."""
    if _enabled or torch.autograd._profiler_enabled():
        return record_function(name)
    return None


@contextlib.contextmanager
def trace_range(name: str, metric=None):
    """A named range that adds its host wall time (ns) to ``metric``,
    traced or not."""
    start = time.perf_counter_ns()
    ann = annotation(name)
    if ann is not None:
        ann.__enter__()
    try:
        yield
    finally:
        if ann is not None:
            ann.__exit__(None, None, None)
        if metric is not None:
            metric.add(time.perf_counter_ns() - start)


@contextlib.contextmanager
def query_trace(conf):
    """One query's capture: with ``trace.enabled`` and a ``trace.dir``
    set, the query runs under ``torch.profiler.profile`` (the CPU, and
    the card when the session is on one) and one Chrome trace is
    written to ``<trace.dir>/query-<pid>-<n>.json``.  The span switch
    takes the conf's value for the query and gets its earlier value
    back after it, on an error as well.  The switch is process-wide:
    queries that overlap with different settings share the last one
    set, as in the JAX package.  A capture already recording (a caller's
    own ``torch.profiler``) is not nested: the query runs inside it."""
    from spark_rapids_tpu_torch.conf import TRACE_DIR, TRACE_ENABLED
    prev = is_enabled()
    on = conf.get(TRACE_ENABLED)
    set_enabled(on)
    logdir = conf.get(TRACE_DIR)
    try:
        if on and logdir and not torch.autograd._profiler_enabled():
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            os.makedirs(logdir, exist_ok=True)
            with profile(activities=acts) as prof:
                yield
            prof.export_chrome_trace(os.path.join(
                logdir, f"query-{os.getpid()}-{next(_CAPTURES)}.json"))
        else:
            yield
    finally:
        set_enabled(prev)
