"""Background pull of a batch iterator, one thread a stream.

Counterpart of ``spark_rapids_tpu/io/prefetch.py`` (``PrefetchIterator``,
``device_lookahead``).  ``PrefetchIterator`` drives a source iterator on
a thread of its own, up to ``depth`` items ahead of its consumer,
through a bounded queue:

- one producer keeps the source's order, so a run with the pull on and
  one with it off give the same batches in the same order;
- an error in the producer is raised, the same exception object, at
  the consumer's next ``__next__``;
- ``close()`` (or the end of the stream) stops the producer, drains the
  queue and joins the thread; the source is closed on the producer's
  thread, which is the one running it.

The producer runs on the consumer's device (the current device is per
thread in PyTorch).  On a card, it records an event on its stream after
each item, and the consumer's stream waits on that event before the
consumer touches the item; if the two streams differ, the item's tensors
are also recorded on the consumer's stream, so the allocator does not
reuse their memory while the consumer's work is pending.  No host sync
is added.

The iterator belongs to the query that made it (``lifecycle.py``): it
registers with the query's registry, so the query's teardown, or a
session stop, closes it; the producer runs under the query's context,
so the pull boundaries it drives see the query's cancel token and the
spill handles it makes count toward the query's budget; and the
consumer's wait polls the token.  Given ``fault_site``, the producer
asks the fault injector at each item (``io.prefetch.decode``), and an
injected error surfaces at the consumer like any other.

Given ``limiter`` and ``nbytes``, each item is admitted through the
limiter (the catalog's ``prefetch_staging``) before it may take queue
space, and its grant passes to the consumer: it is released when the
consumer pulls the next item (by then it has uploaded this one), so at
most ``depth + 2`` grants are held (queued, in the consumer's hand, and
one a producer parked on the full queue acquired).  The upload of a
granted item takes no second grant (``io/hostio.py: pipelined_scan``).

``maybe_prefetch`` runs a scan's host decode on such a thread while
``spark.rapids.sql.io.prefetch.enabled`` is on, ``spark.rapids.sql.io.
prefetch.batches`` deep; ``device_lookahead`` pulls the coalesce's
child one batch ahead.  ``global_stats`` are the process-wide counts of
the scans' decode (batches, stall and fill ms) and of the uploads'
overlap (``overlap_ms``, from ``columnar/transfer.py: pipelined_h2d``).
"""

from __future__ import annotations

import contextlib
import queue
import threading
import time
from typing import Callable, Iterator, Optional

import torch

from spark_rapids_tpu_torch import faults, lifecycle
from spark_rapids_tpu_torch.conf import IO_PREFETCH_BATCHES, \
    IO_PREFETCH_ENABLED
from spark_rapids_tpu_torch.errors import QueryCancelledError
from spark_rapids_tpu_torch.utils import tracing

# every thread the port starts has a name with this prefix
THREAD_PREFIX = "spark-rapids-torch-"

FAULT_SITE_DECODE = "io.prefetch.decode"

_GLOBAL_LOCK = threading.Lock()
_GLOBAL = {"batches": 0, "stall_ms": 0, "fill_ms": 0, "overlap_ms": 0}


def bump_global(key: str, v: int) -> None:
    if v:
        with _GLOBAL_LOCK:
            _GLOBAL[key] += int(v)


def global_stats() -> dict:
    """A snapshot of the process-wide decode and overlap counters."""
    with _GLOBAL_LOCK:
        return dict(_GLOBAL)


def reset_global_stats() -> None:
    with _GLOBAL_LOCK:
        for k in _GLOBAL:
            _GLOBAL[k] = 0


class _Done:
    __slots__ = ()


_DONE = _Done()


class _Failure:
    __slots__ = ("exc",)

    def __init__(self, exc: BaseException):
        self.exc = exc


def _item_tensors(item):
    for c in getattr(item, "columns", ()):
        for t in (c.data, c.validity, c.chars):
            if t is not None:
                yield t


class PrefetchIterator:
    """A bounded single-producer background iterator over ``source``
    (see the module docstring).  ``metrics``, a dict of counters, gets
    the items pulled (``prefetchBatches``) and the consumer's waits for
    them, the first one apart (``prefetchFillMs``, ``prefetchStallMs``);
    with ``bump_global`` so do the process-wide ``global_stats``."""

    _JOIN_TIMEOUT_S = 60.0
    _POLL_S = 0.05

    def __init__(self, source: Iterator, depth: int = 2,
                 name: str = "prefetch", device=None, metrics=None,
                 fault_site=None, limiter=None,
                 nbytes: Optional[Callable] = None,
                 span: str = tracing.SPAN_PREFETCH_WAIT,
                 bump_global: bool = True):
        self.depth = max(1, int(depth))
        self._source = source
        self._fault_site = fault_site
        self._limiter = limiter if nbytes is not None else None
        self._nbytes = nbytes
        self._span = span
        self._bump_global = bump_global
        self._prev_granted = 0  # the grant of the item the consumer holds
        self._query = lifecycle.current()
        self._device = None if device is None else torch.device(device)
        self._metrics = metrics
        self._q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        self._stop = threading.Event()
        self._done = False
        self.batches = 0
        # the first wait fills the pipe: nothing ran yet to overlap it
        self._filled = False
        self.fill_ns = 0
        self.stall_ns = 0
        self._thread = threading.Thread(target=self._run,
                                        name=THREAD_PREFIX + name,
                                        daemon=True)
        self._reg = lifecycle.register_resource(
            self.close, kind="prefetch", name=self._thread.name)
        if self._reg.rejected:
            # the query's teardown closed the registry while this was
            # being made: no producer, and the consumer gets a typed
            # error rather than an empty stream
            self._done = False
            self._q.put((_Failure(QueryCancelledError(
                "background pull made after its query's teardown")),
                None, None, 0))
            return
        self._thread.start()

    @property
    def _cuda(self) -> bool:
        return self._device is not None and self._device.type == "cuda"

    # -- producer -----------------------------------------------------------

    def _run(self) -> None:
        ctx = torch.cuda.device(self._device) if self._cuda \
            else contextlib.nullcontext()
        with ctx, lifecycle.adopt(self._query):
            granted = 0
            try:
                while not self._stop.is_set():
                    item = next(self._source)
                    if self._fault_site is not None:
                        faults.maybe_fail(
                            self._fault_site, "injected background "
                            f"decode failure at {self._fault_site}")
                    if self._limiter is not None:
                        granted = self._limiter.acquire(
                            self._nbytes(item), abort=self._stop.is_set)
                        if granted < 0:  # closed while waiting
                            granted = 0
                            break
                    if not self._put((item,) + self._mark() + (granted,)):
                        # the consumer went away: no one owns the grant
                        self._release(granted)
                        granted = 0
                        break
                    granted = 0
            except StopIteration:
                pass
            except BaseException as e:  # raised again by the consumer
                self._release(granted)
                self._put((_Failure(e), None, None, 0))
            finally:
                close = getattr(self._source, "close", None)
                if close is not None:
                    try:
                        close()
                    except BaseException as e:  # raised by the consumer
                        self._put((_Failure(e), None, None, 0))
                self._put((_DONE, None, None, 0))

    def _release(self, granted: int) -> None:
        if granted and self._limiter is not None:
            self._limiter.release(granted)

    def _mark(self):
        """(event, stream): where the item's device work ends."""
        if not self._cuda:
            return None, None
        stream = torch.cuda.current_stream(self._device)
        ev = torch.cuda.Event()
        ev.record(stream)
        return ev, stream

    def _put(self, wrapped) -> bool:
        """Put, unless the consumer stopped the stream (a failure or the
        end still goes in, where there is room)."""
        while True:
            if self._stop.is_set() and not isinstance(
                    wrapped[0], (_Done, _Failure)):
                return False
            try:
                self._q.put(wrapped, timeout=self._POLL_S)
                return True
            except queue.Full:
                if self._stop.is_set():
                    return False

    # -- consumer -----------------------------------------------------------

    def __iter__(self) -> "PrefetchIterator":
        return self

    def _release_prev(self) -> None:
        self._release(self._prev_granted)
        self._prev_granted = 0

    def __next__(self):
        if self._done:
            raise StopIteration
        # the consumer is done with the item it holds: its grant goes
        # back before the wait, since a producer parked on admission
        # may need exactly those bytes to make the next item
        self._release_prev()
        t0 = time.perf_counter_ns()
        with tracing.trace_range(self._span):
            while True:
                try:
                    item, ev, stream, granted = self._q.get(
                        timeout=lifecycle.poll_interval_s())
                    break
                except queue.Empty:
                    # a cancelled query, or one past its deadline, raises
                    # out of the wait
                    lifecycle.check_cancel()
                    if not self._thread.is_alive() and self._q.empty():
                        self._finish()
                        raise RuntimeError("the prefetch producer ended "
                                           "without a result")
        waited = time.perf_counter_ns() - t0
        if self._filled:
            self.stall_ns += waited
        else:
            self.fill_ns += waited
            self._filled = True
        if item is _DONE:
            self._finish()
            raise StopIteration
        if isinstance(item, _Failure):
            self._stop.set()
            self._finish()
            raise item.exc
        if ev is not None:
            cur = torch.cuda.current_stream(self._device)
            cur.wait_event(ev)
            if cur != stream:
                for t in _item_tensors(item):
                    t.record_stream(cur)
        self._prev_granted = granted
        self.batches += 1
        return item

    def _finish(self) -> None:
        if self._done:
            return
        self._done = True
        fill_ms = self.fill_ns // 1_000_000
        stall_ms = self.stall_ns // 1_000_000
        if self._metrics is not None:
            self._metrics["prefetchBatches"] += self.batches
            self._metrics["prefetchFillMs"] += fill_ms
            self._metrics["prefetchStallMs"] += stall_ms
        if self._bump_global:
            bump_global("batches", self.batches)
            bump_global("fill_ms", fill_ms)
            bump_global("stall_ms", stall_ms)

    def _drain(self) -> None:
        while True:
            try:
                got = self._q.get_nowait()
            except queue.Empty:
                return
            self._release(got[3])

    def close(self) -> None:
        """Stop the producer, drop what it queued (returning its grants)
        and join its thread."""
        self._stop.set()
        self._release_prev()
        self._drain()
        if self._thread.ident is not None \
                and self._thread is not threading.current_thread():
            self._thread.join(timeout=self._JOIN_TIMEOUT_S)
        self._drain()
        self._finish()
        reg = getattr(self, "_reg", None)
        if reg is not None:  # None while a rejected registration closes
            reg.release()
        if self._thread.is_alive():
            raise RuntimeError(f"prefetch thread {self._thread.name} did "
                               f"not stop within {self._JOIN_TIMEOUT_S} s")


def maybe_prefetch(source: Iterator, ctx, metrics=None,
                   nbytes: Optional[Callable] = None,
                   name: str = "scan-decode") -> Iterator:
    """A scan's host decode on a background thread,
    ``spark.rapids.sql.io.prefetch.batches`` deep, each item admitted
    through the catalog's prefetch staging limiter (sized by
    ``nbytes``); ``source`` itself when
    ``spark.rapids.sql.io.prefetch.enabled`` is off."""
    if not ctx.conf.get(IO_PREFETCH_ENABLED):
        return source
    return PrefetchIterator(
        source, depth=ctx.conf.get(IO_PREFETCH_BATCHES), name=name,
        device=ctx.device, metrics=metrics, fault_site=FAULT_SITE_DECODE,
        limiter=ctx.runtime.catalog.prefetch_staging, nbytes=nbytes)


def device_lookahead(source: Iterator, ctx, metrics=None,
                     name: str = "coalesce-pull") -> Iterator:
    """``source`` pulled one batch ahead on a background thread, on the
    context's device; ``source`` itself when
    ``spark.rapids.sql.io.prefetch.enabled`` is off.  Its batches were
    counted by the scans below, so it keeps no process-wide count."""
    if not ctx.conf.get(IO_PREFETCH_ENABLED):
        return source
    return PrefetchIterator(source, depth=1, name=name, device=ctx.device,
                            metrics=metrics,
                            span=tracing.SPAN_COALESCE_PULL,
                            bump_global=False)
