"""Host <-> device transfers: the pinned uploads, the one counted pull,
the double-buffered loops over both, and the packed result egress.

Counterpart of ``spark_rapids_tpu/columnar/transfer.py`` on one card.

* ``Upload``: one batch's host -> device copies.  On a card each plane's
  live rows are copied on the host into a pinned tensor (a ``copy_``,
  which releases the GIL, or numpy's copy for an array no one may write:
  both run without the GIL) and from there, with ``non_blocking=True``,
  on the device's copy stream into a device tensor of the bucket
  capacity whose tail is zeroed on the device.  The device tensor is
  allocated on the consumer's stream, the copy stream then waits for
  the consumer's work so far (the block the allocator just handed out
  may still be read by it: a kernel another thread enqueued before
  freeing it), and the tensor is recorded on the copy stream, so
  that freeing it early cannot hand its memory out while the copy
  writes it.  ``finish`` records an event on the copy stream; the
  consumer's stream waits on it (``await_upload``) before it reads the
  batch: at once for a plain upload, or as ``pipelined_h2d`` yields the
  batch, so that batch k + 1's copy runs beside batch k's kernels.
  PyTorch's caching host allocator records an event on a pinned block
  used by a ``non_blocking`` copy and reuses the block only once that
  event completed, so a pinned source freed early is safe.  On the CPU
  the plain path pads in numpy, as the port always did.
* ``start_host_copies`` / ``device_pull``: THE device -> host pull.
  ``start_host_copies`` is the dispatch half: on a card every CUDA
  tensor of the tree is copied with ``non_blocking=True`` into a pinned
  host tensor on the copy stream, which first waits for the producer's
  stream; it returns a ``Staged`` handle (the pinned tensors and the
  copy's event).  ``device_pull`` waits: it consults the
  ``transfer.d2h`` fault site, waits for the event under
  ``lifecycle.supervise`` (``io.pipeline.hang``, the hang watchdog),
  returns the tree as numpy and counts ``d2hPulls`` / ``d2hBytes``, the
  process-wide ``d2h_stats()`` and the ``transfer.device_pull.{us,
  bytes}`` histograms.  A numpy view of a pinned tensor is read only
  after its event: the one host wait of the pull.
* ``pipelined_h2d`` / ``pipelined_d2h``: the JAX package's
  double-buffered loops with its admission rules (see each).
* ``transfer_bucket`` and the pack codec (``pack_dispatch``,
  ``pack_finish``, ``pack_and_pull``): every result batch of a group in
  one pull, rows trimmed to ``transfer_bucket`` of the total, validity
  and BOOLEAN data bit-packed (little-endian), integer, DATE and
  TIMESTAMP columns delta-narrowed against their minimum to uint8,
  uint16 or uint32, string char matrices trimmed to the bucket of the
  longest value, an encoded string column as narrowed codes unified
  with ``encoding.unify_ordinals`` (the dictionary's host copy rebuilds
  the values), a plane column (RLE, delta, packed) dense through the
  counted late decode.  The port's batches know their row counts on the
  host, so a result at or below ``statsThresholdBytes`` takes one pull
  (no count crosses) and a larger one two: one for the stats (min, max,
  longest string) and one for the data, the JAX package's counts.  The
  pack and the stats are torch ops, as they are jitted jnp code in the
  JAX package.  ``pack_finish`` returns the port's host format,
  ``HostColumns``.

Not carried over: the partition egress (``pack_partitions_*``).  The
port's host shuffle partitions on the host, in its map workers, where
there is nothing to pull (``exec/exchange.py: partition_batch_to_host``).
Not ported here: ``place_on_device`` and ``parallel_device_pull``,
whose consumers (the mesh, the sharded scan) are queue A8b (ROADMAP.md).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from spark_rapids_tpu_torch import faults
from spark_rapids_tpu_torch.columnar.dtypes import (
    BOOLEAN, DATE, INT8, INT16, INT32, INT64, STRING, TIMESTAMP, DataType,
    Schema,
)
from spark_rapids_tpu_torch.utils.metrics import (
    METRIC_D2H_BYTES, METRIC_D2H_OVERLAP_MS, METRIC_D2H_PULLS,
    METRIC_H2D_OVERLAP_MS,
)

FAULT_SITE_D2H = "transfer.d2h"

# ---------------------------------------------------------------------------
# process-wide egress counters
# ---------------------------------------------------------------------------

_D2H_LOCK = threading.Lock()
_D2H_GLOBAL = {"pulls": 0, "bytes": 0, "overlap_ms": 0,
               # what a pull staged (wire) against the same result dense:
               # encoded columns decoded, integers not narrowed, booleans
               # and validity a byte a row (raw)
               "raw_bytes": 0, "wire_bytes": 0}


def _bump_d2h(key: str, v: int) -> None:
    if v:
        with _D2H_LOCK:
            _D2H_GLOBAL[key] += int(v)


def d2h_stats() -> dict:
    """A snapshot of the process-wide egress counters."""
    with _D2H_LOCK:
        return dict(_D2H_GLOBAL)


def reset_d2h_stats() -> None:
    with _D2H_LOCK:
        for k in _D2H_GLOBAL:
            _D2H_GLOBAL[k] = 0


# ---------------------------------------------------------------------------
# the copy stream and pinned staging
# ---------------------------------------------------------------------------

_STREAMS_LOCK = threading.Lock()
_COPY_STREAMS: Dict[int, "torch.cuda.Stream"] = {}

_TORCH_DTYPES = {np.dtype(k): v for k, v in (
    (np.bool_, torch.bool), (np.int8, torch.int8), (np.uint8, torch.uint8),
    (np.int16, torch.int16), (np.uint16, torch.uint16),
    (np.int32, torch.int32), (np.uint32, torch.uint32),
    (np.int64, torch.int64), (np.float32, torch.float32),
    (np.float64, torch.float64))}


def _copy_stream(device: torch.device) -> "torch.cuda.Stream":
    """The device's one copy stream, made at first use."""
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    with _STREAMS_LOCK:
        s = _COPY_STREAMS.get(idx)
        if s is None:
            s = _COPY_STREAMS[idx] = torch.cuda.Stream(device=idx)
        return s


def _to_pinned(values: np.ndarray) -> torch.Tensor:
    """A pinned host tensor holding ``values``.  A writable array copies
    in through torch's ``copy_``; one no one may write (an Arrow buffer,
    a frozen numpy column) through numpy's, since torch warns on a tensor
    over read-only memory.  Both copy without the GIL."""
    host = torch.empty(values.shape, dtype=_TORCH_DTYPES[values.dtype],
                       pin_memory=True)
    if values.size:
        if values.flags.writeable:
            host.copy_(torch.from_numpy(values))
        else:
            np.copyto(host.numpy(), values)
    return host


class Upload:
    """One batch's host -> device copies (see the module docstring).
    ``plane(values, capacity)`` -> the device tensor of ``capacity``
    rows, the live ones ``values``' and the rest zero; ``finish()``
    records the event that ``await_upload`` waits on (None on the CPU,
    or when nothing was copied)."""

    __slots__ = ("device", "cuda", "_stream")

    def __init__(self, device):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self._stream = None

    def plane(self, values: np.ndarray,
              capacity: Optional[int] = None) -> torch.Tensor:
        values = np.asarray(values)
        n = int(values.shape[0])
        cap = n if capacity is None else int(capacity)
        shape = (cap,) + tuple(values.shape[1:])
        if not self.cuda:
            out = np.zeros(shape, values.dtype)
            out[:n] = values
            return torch.from_numpy(out).to(self.device)
        if self._stream is None:
            self._stream = _copy_stream(self.device)
        host = _to_pinned(values)
        out = torch.empty(shape, dtype=host.dtype, device=self.device)
        # after the allocation: the block may have been freed by work the
        # consumer (on any thread) enqueued since an earlier plane
        self._stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self._stream):
            if n < cap:
                out[n:].zero_()
            if n:
                out[:n].copy_(host, non_blocking=True)
        out.record_stream(self._stream)
        return out

    def finish(self) -> Optional["torch.cuda.Event"]:
        if self._stream is None:
            return None
        ev = torch.cuda.Event()
        ev.record(self._stream)
        return ev


def await_event(ev: Optional["torch.cuda.Event"]) -> None:
    """The current stream waits for an upload's event (None: nothing)."""
    if ev is not None:
        torch.cuda.current_stream().wait_event(ev)


def await_upload(item) -> None:
    """The current stream waits for ``item``'s upload (its ``ready``
    event, which is then cleared); nothing for an item without one."""
    ev = getattr(item, "ready", None)
    if ev is not None:
        await_event(ev)
        item.ready = None


# ---------------------------------------------------------------------------
# the device -> host pull
# ---------------------------------------------------------------------------

def _tree_map(tree, fn):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(t, fn) for t in tree)
    if isinstance(tree, dict):
        return {k: _tree_map(v, fn) for k, v in tree.items()}
    return tree


def _tree_leaves(tree):
    if isinstance(tree, (np.ndarray, torch.Tensor)):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            yield from _tree_leaves(t)
    elif isinstance(tree, dict):
        for t in tree.values():
            yield from _tree_leaves(t)


class Staged:
    """A pull in flight: the tree with each CUDA tensor replaced by the
    pinned host tensor its copy lands in, and the copy's event (None
    when nothing was on a card)."""

    __slots__ = ("tree", "event")

    def __init__(self, tree, event):
        self.tree = tree
        self.event = event

    def nbytes(self) -> int:
        return sum(int(t.numel() * t.element_size())
                   for t in _tree_leaves(self.tree)
                   if isinstance(t, torch.Tensor))


def start_host_copies(tree) -> Staged:
    """Dispatch the device -> host copy of every tensor in ``tree``
    without waiting (the dispatch half of ``device_pull``)."""
    if isinstance(tree, Staged):
        return tree
    cuda = [t for t in _tree_leaves(tree)
            if isinstance(t, torch.Tensor) and t.is_cuda]
    if not cuda:
        return Staged(tree, None)
    producer = torch.cuda.current_stream(cuda[0].device)
    stream = _copy_stream(cuda[0].device)
    stream.wait_stream(producer)

    def copy(t: torch.Tensor) -> torch.Tensor:
        if not t.is_cuda:
            return t
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        with torch.cuda.stream(stream):
            host.copy_(t, non_blocking=True)
        # read on the copy stream: its memory waits for the copy
        t.record_stream(stream)
        return host

    staged = _tree_map(tree, copy)
    ev = torch.cuda.Event()
    ev.record(stream)
    return Staged(staged, ev)


def device_pull(tree, metrics=None):
    """THE device -> host pull: ``tree`` (tensors in nested lists, tuples
    and dicts, or a ``Staged`` handle) -> the same tree of numpy arrays.
    One call is one pull, the unit the egress paths minimize."""
    from spark_rapids_tpu_torch import lifecycle
    from spark_rapids_tpu_torch.obs import registry as obs
    faults.maybe_fail(FAULT_SITE_D2H, "injected device->host pull failure")
    t0 = time.perf_counter_ns()
    staged = start_host_copies(tree)

    def wait():
        if staged.event is not None:
            staged.event.synchronize()
        return _tree_map(staged.tree, lambda t: t.numpy())

    host = lifecycle.supervise(wait, lifecycle.FAULT_SITE_PIPELINE_HANG)
    pull_us = (time.perf_counter_ns() - t0) // 1000
    nbytes = sum(int(a.nbytes) for a in _tree_leaves(host))
    _bump_d2h("pulls", 1)
    _bump_d2h("bytes", nbytes)
    obs.record(obs.HIST_D2H_PULL_US, pull_us)
    obs.record(obs.HIST_D2H_PULL_BYTES, nbytes)
    if metrics is not None:
        metrics[METRIC_D2H_PULLS] += 1
        metrics[METRIC_D2H_BYTES] += nbytes
    return host


# ---------------------------------------------------------------------------
# the double-buffered loops
# ---------------------------------------------------------------------------

def pipelined_h2d(items, upload, runtime, metrics=None, enabled=True):
    """Upload each host item (``upload(item)`` dispatches it and returns
    what it made, with the upload's ``ready`` event) and yield it, the
    consumer's stream ordered after the copy.

    ``enabled``: batch k + 1's upload is dispatched before batch k is
    yielded, so k's kernels run beside k + 1's copy; at most two
    uploaded batches are live here (the pending one and the yielded
    one); the device permit is held only while an upload is dispatched.
    ``h2dOverlapMs`` adds the consumer's time inside a yield while the
    next upload was in flight (an ``io.h2d.overlap`` range).  Off, the
    serial loop: the permit is held across each upload and its yield.
    The ``transfer.pipelined_h2d.{us,bytes}`` histograms record each
    upload's dispatch time and size."""
    from spark_rapids_tpu_torch.io import prefetch
    from spark_rapids_tpu_torch.obs import registry as obs
    from spark_rapids_tpu_torch.utils import tracing

    def timed_upload(item):
        t0 = time.perf_counter_ns()
        b = upload(item)
        obs.record(obs.HIST_H2D_UPLOAD_US,
                   (time.perf_counter_ns() - t0) // 1000)
        size = getattr(b, "size_bytes", None)
        if callable(size):
            obs.record(obs.HIST_H2D_UPLOAD_BYTES, size())
        return b

    if not enabled:
        for item in items:
            with runtime.acquire_device():
                b = timed_upload(item)
                await_upload(b)
                yield b
        return
    pending = None
    overlap_ns = 0
    try:
        for item in items:
            with runtime.acquire_device():
                b = timed_upload(item)
            if pending is not None:
                await_upload(pending)
                t0 = time.perf_counter_ns()
                with tracing.trace_range(tracing.SPAN_H2D_OVERLAP):
                    yield pending
                overlap_ns += time.perf_counter_ns() - t0
            pending = b
        if pending is not None:
            await_upload(pending)
            yield pending
            pending = None
    finally:
        ms = overlap_ns // 1_000_000
        if metrics is not None:
            metrics[METRIC_H2D_OVERLAP_MS] += ms
        prefetch.bump_global("overlap_ms", ms)


def pipelined_d2h(items, dispatch, finish, ctx=None, metrics=None,
                  enabled=None, limiter=None, nbytes=None):
    """Yield ``finish(dispatch(item))`` for each item, thread-free:
    ``dispatch`` runs the item's device side and starts its host copies
    without waiting, ``finish`` waits for them and builds the host
    result.  Item k + 1 is dispatched before item k is finished, so its
    copy runs across k's finish and the consumer's work on k; at most
    two items' host bytes are live.  A blocking finish is admitted
    through the egress staging limiter (``ctx``'s catalog's
    ``egress_staging`` unless ``limiter`` is given, sized by
    ``nbytes(staged)``) for its own length only, never across a yield.
    ``enabled`` (default: ``spark.rapids.sql.io.egress.enabled``) False
    is the strictly serial loop.  The upstream iterator is closed on
    both settings.  ``d2hOverlapMs`` adds the consumer's time inside a
    yield while the next item's copy was in flight (``io.d2h.overlap``;
    each blocking finish is an ``io.d2h.wait`` range)."""
    from spark_rapids_tpu_torch.utils import tracing
    if enabled is None:
        from spark_rapids_tpu_torch.conf import IO_EGRESS_ENABLED
        enabled = ctx is not None and ctx.conf.get(IO_EGRESS_ENABLED)
    if not enabled:
        try:
            for item in items:
                yield finish(dispatch(item))
        finally:
            close = getattr(items, "close", None)
            if close is not None:
                close()
        return
    if limiter is None and ctx is not None:
        limiter = ctx.runtime.catalog.egress_staging

    def finish_admitted(staged):
        with tracing.trace_range(tracing.SPAN_D2H_WAIT):
            if limiter is not None and nbytes is not None:
                with limiter.limit(nbytes(staged)):
                    return finish(staged)
            return finish(staged)

    pending = None
    overlap_ns = 0
    try:
        for item in items:
            staged = dispatch(item)
            if pending is not None:
                out = finish_admitted(pending)
                pending = staged
                t0 = time.perf_counter_ns()
                with tracing.trace_range(tracing.SPAN_D2H_OVERLAP):
                    yield out
                overlap_ns += time.perf_counter_ns() - t0
            else:
                pending = staged
        if pending is not None:
            yield finish_admitted(pending)
            pending = None
    finally:
        close = getattr(items, "close", None)
        if close is not None:
            close()
        ms = overlap_ns // 1_000_000
        if metrics is not None:
            metrics[METRIC_D2H_OVERLAP_MS] += ms
        _bump_d2h("overlap_ms", ms)


def transfer_bucket(n: int) -> int:
    """Smallest quarter-power-of-two >= n that is a multiple of 8 (the
    JAX package's, bit for bit)."""
    n = max(8, int(n))
    if n <= 32:
        p = 8
        while p < n:
            p <<= 1
        return p
    p = 32
    while p < n:
        p <<= 1
    if p == n:
        return p
    # quarters of the next power of two: 1.25/1.5/1.75/2 * p/2
    half = p >> 1
    q = half >> 2
    for m in (half + q, half + 2 * q, half + 3 * q, p):
        if m >= n:
            return m
    return p


# ---------------------------------------------------------------------------
# the bit-packed planes (the egress and spill share them)
# ---------------------------------------------------------------------------

_BIT_WEIGHTS = (1, 2, 4, 8, 16, 32, 64, 128)


def bitpack_plane(plane: torch.Tensor) -> torch.Tensor:
    """(n,) bool -> (ceil(n / 8),) uint8 on the same device, row r in bit
    r % 8 of byte r // 8 (little-endian: ``np.unpackbits(...,
    bitorder="little")`` inverts it)."""
    n = plane.shape[0]
    bits = plane.to(torch.int32)
    if n % 8:
        bits = torch.cat([bits, bits.new_zeros(8 - n % 8)])
    w = torch.tensor(_BIT_WEIGHTS, dtype=torch.int32, device=plane.device)
    return (bits.view(-1, 8) * w).sum(1).to(torch.uint8)


def bitunpack_plane(packed: torch.Tensor, n: int) -> torch.Tensor:
    """``bitpack_plane``'s inverse on the packed plane's device: the first
    ``n`` rows as a bool plane."""
    w = torch.tensor(_BIT_WEIGHTS, dtype=torch.int32, device=packed.device)
    bits = (packed.to(torch.int32)[:, None] & w) != 0
    return bits.reshape(-1)[:n].contiguous()


def bitunpack_host(packed: np.ndarray, cap: int) -> np.ndarray:
    """``bitpack_plane``'s inverse on the host: (cap // 8,) uint8 ->
    (cap,) bool, exact."""
    return np.unpackbits(np.asarray(packed),
                         bitorder="little")[:cap].astype(np.bool_)


# ---------------------------------------------------------------------------
# the pack codec
# ---------------------------------------------------------------------------

_INT_LIKE = (INT8, INT16, INT32, INT64, DATE, TIMESTAMP)
# a narrowed plane crosses as the signed type of its width (torch's
# unsigned 16- and 32-bit types convert on few devices) and is read as
# the unsigned store on the host: the same bytes
_WIRE = {"uint8": torch.uint8, "uint16": torch.int16, "uint32": torch.int32}


class _ColPlan:
    """One column's wire plan: ``store`` the numpy dtype name the data
    crosses as (None: its own), ``base`` the delta base of a narrowed
    integer, ``width`` a plain string's char width, ``enc`` a dictionary
    column, whose ``dict`` (its ``DictPlanes``) rebuilds the values."""

    __slots__ = ("dtype", "base", "store", "width", "enc", "dict")

    def __init__(self, dtype: DataType, base: int = 0,
                 store: Optional[str] = None, width: int = 0,
                 enc: bool = False, dict_planes=None):
        self.dtype = dtype
        self.base = base
        self.store = store
        self.width = width
        self.enc = enc
        self.dict = dict_planes


def _narrow_store(rng: int) -> Optional[str]:
    """Smallest unsigned wire dtype holding [0, rng]."""
    if rng < (1 << 8):
        return "uint8"
    if rng < (1 << 16):
        return "uint16"
    if rng < (1 << 32):
        return "uint32"
    return None


def _bound_bytes(cols: list, cap: int) -> int:
    """A result's bytes before packing, from its first batch's columns at
    ``cap`` rows: what decides whether the stats pull pays."""
    from spark_rapids_tpu_torch.columnar.encoding import EncodedColumn
    total = 0
    for c in cols:
        if isinstance(c, EncodedColumn):
            total += cap * 4 + cap // 8
        elif c.chars is not None:
            total += cap * (4 + c.chars.shape[1]) + cap // 8
        else:
            total += cap * c.data.element_size() + cap // 8
    return total


def _egress_cols(batches):
    """Each batch's columns for the pack, an ordinal encoded in every
    batch unified onto one dictionary (codes stay codes on the wire)
    while compressed egress is on -> (columns, ordinal -> dictionary).
    Any other encoded or plane column densifies through the counted late
    decode when its planes are read."""
    from spark_rapids_tpu_torch.columnar import encoding
    cols = [list(b.columns) for b in batches]
    if not encoding.egress_enabled() \
            or not any(encoding.has_encoded(b) for b in batches):
        return cols, {}
    return cols, encoding.unify_ordinals(cols)


def _count_wire(planes, plans, out_cap: int) -> None:
    """The pull's raw and wire bytes into ``d2h_stats`` (see
    ``_D2H_GLOBAL``)."""
    wire = sum(int(t.numel() * t.element_size())
               for t in _tree_leaves(planes) if isinstance(t, torch.Tensor))
    raw = 0
    for p in plans:
        if p.enc:
            raw += out_cap * (4 + p.dict.width)
        elif p.dtype == STRING:
            raw += out_cap * (4 + max(1, p.width))
        elif p.dtype == BOOLEAN:
            raw += out_cap
        else:
            raw += out_cap * np.dtype(p.dtype.numpy_dtype).itemsize
        raw += out_cap  # a byte a row of validity
    _bump_d2h("wire_bytes", wire)
    _bump_d2h("raw_bytes", raw)


def _stats(flats, counts, dtypes, enc_dicts) -> torch.Tensor:
    """One int64 tensor of every batch's stats, in batch order: a plain
    string column's longest valid length, an int-like column's min and
    max over its valid rows (INT64_MAX and INT64_MIN where it has
    none); an encoded column has none."""
    lo_s = torch.iinfo(torch.int64).max
    hi_s = torch.iinfo(torch.int64).min
    outs = []
    for flat, c in zip(flats, counts):
        for ci, dt in enumerate(dtypes):
            if ci in enc_dicts:
                continue
            d, v, _ = flat[ci]
            m = v & (torch.arange(v.shape[0], device=v.device) < c)
            if dt == STRING:
                outs.append(torch.where(m, d, 0).max().to(torch.int64))
            elif dt in _INT_LIKE:
                x = d.to(torch.int64)
                outs.append(torch.where(m, x, lo_s).min())
                outs.append(torch.where(m, x, hi_s).max())
    if not outs:
        return torch.zeros(0, dtype=torch.int64)
    return torch.stack(outs)


def _pack(flats, counts, out_cap: int, dtypes, plans) -> tuple:
    """The wire planes: per column (data, validity bits, chars or None),
    every batch's live rows back to back at ``out_cap`` rows."""
    outs = []
    for ci, (dt, pl) in enumerate(zip(dtypes, plans)):
        d0, v0, _ = flats[0][ci]
        dev = v0.device
        data = torch.zeros(out_cap, dtype=d0.dtype, device=dev)
        valid = torch.zeros(out_cap, dtype=torch.bool, device=dev)
        chars = torch.zeros((out_cap, pl.width), dtype=torch.uint8,
                            device=dev) \
            if dt == STRING and not pl.enc else None
        off = 0
        for flat, c in zip(flats, counts):
            d, v, ch = flat[ci]
            data[off:off + c] = d[:c]
            valid[off:off + c] = v[:c]
            if chars is not None:
                w = min(pl.width, ch.shape[1])
                chars[off:off + c, :w] = ch[:c, :w]
            off += c
        vbytes = bitpack_plane(valid)
        if pl.enc or dt == STRING:
            x = torch.where(valid, data, 0)
            if pl.store is not None:
                x = x.to(_WIRE[pl.store])
            outs.append((x, vbytes, chars))
        elif dt == BOOLEAN:
            outs.append((bitpack_plane(valid & data.to(torch.bool)), vbytes,
                         None))
        elif pl.store is not None:
            x = torch.where(valid, data.to(torch.int64) - pl.base, 0)
            outs.append((x.to(_WIRE[pl.store]), vbytes, None))
        else:
            outs.append((data, vbytes, None))
    return tuple(outs)


def _unpack_column(dt: DataType, pl: _ColPlan, planes, n: int):
    """The wire planes of one column -> its host values and validity."""
    from spark_rapids_tpu_torch.columnar.batch import HostStrings
    data_w, vbytes, chars = planes
    if pl.store is not None:
        data_w = np.asarray(data_w).view(pl.store)
    valid = bitunpack_host(vbytes, n)
    if pl.enc:
        d = pl.dict
        idx = np.where(valid, np.asarray(data_w)[:n].astype(np.int64),
                       d.size).clip(0, d.capacity - 1)
        return HostStrings(d.host_chars[idx], d.host_lengths[idx]), valid
    if dt == STRING:
        return HostStrings(np.asarray(chars)[:n],
                           np.asarray(data_w)[:n].astype(np.int32)), valid
    if dt == BOOLEAN:
        return bitunpack_host(data_w, n), valid
    data = np.asarray(data_w)[:n]
    if pl.store is not None:
        data = (data.astype(np.int64) + pl.base).astype(dt.numpy_dtype)
    return data, valid


class _PackPending:
    """A pack dispatched: the wire planes' copies started
    (``staged``); ``pack_finish`` waits and unpacks.  ``ready`` holds an
    empty result that needs no pull."""

    __slots__ = ("staged", "n", "plans", "schema", "ready")

    def __init__(self, staged=None, n=0, plans=None, schema=None,
                 ready=None):
        self.staged = staged
        self.n = n
        self.plans = plans
        self.schema = schema
        self.ready = ready

    def wire_bytes(self) -> int:
        """Host bytes the finish pull stages (no sync)."""
        return 0 if self.staged is None else self.staged.nbytes()


def pack_finish(pending: _PackPending, metrics=None):
    """The blocking half of the pack: pull the staged planes (one pull)
    and unpack them -> ``HostColumns`` of exactly the live rows."""
    if pending.ready is not None:
        return pending.ready
    pulled = device_pull(pending.staged, metrics=metrics)
    return {f.name: _unpack_column(f.dtype, pl, planes, pending.n)
            for f, pl, planes in zip(pending.schema, pending.plans, pulled)}


def pack_and_pull(batches, schema: Schema, stats_threshold: int = 1 << 20,
                  metrics=None):
    """Every device batch in one pull (two for a result past
    ``stats_threshold`` bytes, whose stats pull narrows the data) ->
    ``HostColumns`` of exactly the live rows."""
    return pack_finish(pack_dispatch(batches, schema, stats_threshold,
                                     metrics=metrics), metrics=metrics)


def pack_dispatch(batches, schema: Schema, stats_threshold: int = 1 << 20,
                  metrics=None) -> _PackPending:
    """The dispatching half of the pack: decide each column's wire plan
    (a large result spends its stats pull here), pack, and start the
    copies to the host."""
    from spark_rapids_tpu_torch.columnar.batch import empty_host_values
    from spark_rapids_tpu_torch.columnar.encoding import col_planes
    if not batches:
        return _PackPending(ready={
            f.name: (empty_host_values(f.dtype), np.zeros(0, np.bool_))
            for f in schema})
    dtypes = [f.dtype for f in schema]
    all_cols, enc_dicts = _egress_cols(batches)
    flats = [[col_planes(c, ci in enc_dicts) for ci, c in enumerate(cols)]
             for cols in all_cols]
    counts = [b.num_rows for b in batches]
    total = sum(counts)
    out_cap = transfer_bucket(total)
    use_stats = _bound_bytes(all_cols[0], out_cap) > stats_threshold
    stats = iter(())
    if use_stats:
        pulled = device_pull(_stats(flats, counts, dtypes, enc_dicts),
                             metrics=metrics)
        stats = iter(pulled.tolist())
    # each batch's stats in column order: fold them column by column
    per_batch = [[] for _ in batches]
    if use_stats:
        for bi in range(len(batches)):
            for ci, dt in enumerate(dtypes):
                if ci in enc_dicts:
                    continue
                if dt == STRING:
                    per_batch[bi].append((ci, next(stats)))
                elif dt in _INT_LIKE:
                    per_batch[bi].append((ci, (next(stats), next(stats))))
    folded: Dict[int, object] = {}
    for entries in per_batch:
        for ci, s in entries:
            if dtypes[ci] == STRING:
                folded[ci] = max(folded.get(ci, 0), s)
            elif s[0] <= s[1]:  # the batch had valid values
                lo, hi = folded.get(ci, s)
                folded[ci] = (min(lo, s[0]), max(hi, s[1]))
    plans: List[_ColPlan] = []
    for ci, dt in enumerate(dtypes):
        if ci in enc_dicts:
            d = enc_dicts[ci]
            plans.append(_ColPlan(dt, 0, _narrow_store(max(0, d.size - 1)),
                                  enc=True, dict_planes=d))
        elif dt == STRING:
            widest = max(cols[ci].string_width for cols in all_cols)
            if use_stats:
                ml = folded.get(ci, 0)
                plans.append(_ColPlan(dt, 0, _narrow_store(max(0, ml)),
                                      min(transfer_bucket(max(1, ml)),
                                          widest)))
            else:
                plans.append(_ColPlan(dt, 0, None, widest))
        elif dt in _INT_LIKE and use_stats:
            lo, hi = folded.get(ci, (0, 0))
            st = _narrow_store(hi - lo)
            plans.append(_ColPlan(dt, lo if st is not None else 0, st))
        else:
            plans.append(_ColPlan(dt))
    planes = _pack(flats, counts, out_cap, dtypes, plans)
    _count_wire(planes, plans, out_cap)
    return _PackPending(start_host_copies(planes), total, plans, schema)
