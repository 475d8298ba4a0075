"""The device mesh, row sharding, the exchange and the gather.

Counterpart of ``spark_rapids_tpu/parallel/mesh.py``.  The JAX package's
mesh is one SPMD program over ``jax.devices()`` in one process; the
port's is one process over an ordered list of ``torch.device``s, one a
shard.  The pool it draws on (``visible_pool``) is
``torch.cuda.device_count()`` GPUs for a session on ``cuda`` and the one
CPU for a session on ``cpu``.  Inside ``virtual_pool(k)`` it is k shards
all on the session's own device: the part the XLA flag
``--xla_force_host_platform_device_count`` plays for the JAX tests.
That is for tests and the card script only, so it is no conf key: on
one device the shards add work and no bandwidth.

``shard_table`` cuts a batch into contiguous shards of ceil(n / N) rows,
in order, as the JAX version does; each shard is an ordinary batch at
the bucket capacity of its own rows, on its own device (the JAX version
stacks equal-capacity shards on a device axis, which the port does not
need).

``all_to_all`` is the exchange: ``buckets[s][d]`` holds the rows shard
``s`` sends to shard ``d``, in row order, and shard ``d`` receives their
concatenation over ``s = 0 .. N-1``, the order of
``jax.lax.all_to_all(..., tiled=True)``.  A bucket moves with
``.to(device, non_blocking=True)``, which on one card is no copy.
``exchange`` sizes every bucket of one exchange from one (N, N) matrix
of counts: one host sync, which the caller counts in ``hostSyncs``; it
makes no ``device_pull``.

``gather_stacked`` lays shard ``d``'s first ``counts[d]`` rows end to end
in shard order into one batch on the session's device.  The JAX gather
pulls every plane to the host and uploads the result again; the port's
stays on the card (ROADMAP §C, intended differences).
"""

from __future__ import annotations

import contextlib
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.column import DeviceColumn, \
    bucket_capacity
from spark_rapids_tpu_torch.columnar.dtypes import Schema

# shards of the pool on the session's own device (0: the devices
# themselves); set only inside ``virtual_pool``
_VIRTUAL_SHARDS = 0


@contextlib.contextmanager
def virtual_pool(shards: int) -> Iterator[None]:
    """Inside, for the whole process: the pool is ``shards`` shards, all
    on the session's own device (the tests' 8 on ``cpu``, the card
    script's 4 on one card); 0 restores the devices themselves."""
    global _VIRTUAL_SHARDS
    if shards < 0:
        raise ValueError(f"virtual_pool needs shards >= 0, got {shards}")
    before, _VIRTUAL_SHARDS = _VIRTUAL_SHARDS, shards
    try:
        yield
    finally:
        _VIRTUAL_SHARDS = before


class DeviceMesh:
    """A 1-D mesh over the data axis: an ordered list of devices, one a
    shard (a device may hold several shards)."""

    def __init__(self, devices: Sequence):
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("a mesh needs at least one device")

    @property
    def size(self) -> int:
        return len(self.devices)


def visible_pool(conf=None, device=None) -> List[torch.device]:
    """The devices a mesh may take, in order: inside ``virtual_pool(k)``,
    k > 0, k times the session's device; else ``cuda:0`` .. ``cuda:N-1``
    for a session on ``cuda`` and ``[cpu]`` for one on ``cpu``."""
    from spark_rapids_tpu_torch.conf import DEVICE, TorchConf
    conf = conf if conf is not None else TorchConf()
    dev = torch.device(device if device is not None else conf.get(DEVICE))
    if _VIRTUAL_SHARDS > 0:
        return [dev] * _VIRTUAL_SHARDS
    if dev.type == "cuda":
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        return [torch.device("cuda", i) for i in range(n)]
    return [dev]


def data_mesh(n_devices: Optional[int] = None,
              devices: Optional[list] = None, conf=None,
              device=None) -> DeviceMesh:
    """1-D mesh over the data axis: ``devices`` as given, else the first
    ``n_devices`` of the pool (all of it when None); a pool narrower than
    ``n_devices`` raises ``ValueError``, as the JAX package's does."""
    if devices is None:
        devices = visible_pool(conf, device)
        if n_devices is not None:
            if len(devices) < n_devices:
                raise ValueError(
                    f"need {n_devices} devices, have {len(devices)}")
            devices = devices[:n_devices]
    return DeviceMesh(devices)


def dense_batch(batch: ColumnarBatch) -> ColumnarBatch:
    """``batch`` with every encoded or plane column decoded
    (``columnar/encoding.py``): the mesh moves dense planes only, so
    every shard hashes and compares values, never codes."""
    if all(type(c) is DeviceColumn for c in batch.columns):
        return batch
    from spark_rapids_tpu_torch.columnar import encoding
    cvs = encoding.plane_view(batch.columns)
    return ColumnarBatch([DeviceColumn(c.dtype, cv.data, cv.validity,
                                       batch.num_rows, cv.chars)
                          for c, cv in zip(batch.columns, cvs)],
                         batch.num_rows, batch.schema)


def batch_to(batch: ColumnarBatch, device: torch.device) -> ColumnarBatch:
    """``batch`` on ``device``; the same batch when it is there already."""
    if batch.device == torch.device(device):
        return batch

    def mv(t):
        return None if t is None else t.to(device, non_blocking=True)
    return ColumnarBatch([DeviceColumn(c.dtype, mv(c.data), mv(c.validity),
                                       c.num_rows, mv(c.chars))
                          for c in batch.columns], batch.num_rows,
                         batch.schema)


def shard_table(batch: ColumnarBatch, n_dev: int,
                devices: Optional[Sequence] = None
                ) -> Tuple[List[ColumnarBatch], np.ndarray, int]:
    """Split ``batch`` into ``n_dev`` contiguous row shards of
    ceil(n / n_dev) rows (the last ones shorter or empty), shard ``d`` on
    ``devices[d]`` (default: the batch's device) -> (the shards, their
    row counts, the rows a full shard holds)."""
    batch = dense_batch(batch)
    n = batch.num_rows
    per = -(-max(n, 1) // n_dev)
    counts = np.zeros(n_dev, np.int64)
    shards = []
    for d in range(n_dev):
        lo, hi = d * per, min((d + 1) * per, n)
        m = max(0, hi - lo)
        counts[d] = m
        shard = batch.slice_rows(min(lo, n), m)
        if devices is not None:
            shard = batch_to(shard, devices[d])
        shards.append(shard)
    return shards, counts, per


def bucket_counts(pids: Sequence[Optional[torch.Tensor]], n_dev: int,
                  host_device: torch.device) -> np.ndarray:
    """The (n_dev, n_dev) matrix of rows shard ``s`` sends to shard ``d``
    from each shard's destination ids (``n_dev`` = a dead row; None = a
    shard with no rows), read back in one host sync."""
    rows = []
    for pid in pids:
        if pid is None:
            rows.append(torch.zeros(n_dev, dtype=torch.int64,
                                    device=host_device))
            continue
        rows.append(torch.bincount(pid, minlength=n_dev + 1)[:n_dev]
                    .to(host_device))
    return np.asarray(torch.stack(rows).tolist(), np.int64)


def all_to_all(buckets: Sequence[Sequence[Optional[ColumnarBatch]]],
               mesh: DeviceMesh) -> List[Optional[ColumnarBatch]]:
    """``buckets[s][d]``: the rows shard ``s`` sends to shard ``d`` (None
    for none) -> what each shard ``d`` receives: the concatenation over
    ``s`` in shard order, on ``mesh.devices[d]`` (None for nothing)."""
    from spark_rapids_tpu_torch.exec.coalesce import concat_batches
    out: List[Optional[ColumnarBatch]] = []
    for d, dev in enumerate(mesh.devices):
        parts = [batch_to(row[d], dev) for row in buckets
                 if row[d] is not None and row[d].num_rows]
        out.append(concat_batches(parts) if parts else None)
    return out


def exchange(shards: Sequence[Optional[ColumnarBatch]],
             pids: Sequence[Optional[torch.Tensor]], mesh: DeviceMesh,
             host_device: Optional[torch.device] = None):
    """Move every live row of shard ``s`` to shard ``pids[s][row]`` (a
    row whose id is ``mesh.size`` stays behind) -> (what each shard
    received, in ``all_to_all``'s order, or None; the (N, N) count
    matrix).  Each shard's rows are laid out by destination with one
    stable sort and one gather; the matrix is the exchange's one host
    sync."""
    n_dev = mesh.size
    host_device = host_device if host_device is not None \
        else mesh.devices[0]
    counts = bucket_counts(pids, n_dev, host_device)
    buckets: List[List[Optional[ColumnarBatch]]] = []
    for s, (shard, pid) in enumerate(zip(shards, pids)):
        row: List[Optional[ColumnarBatch]] = [None] * n_dev
        live_n = int(counts[s].sum())
        if shard is not None and live_n:
            perm = torch.sort(pid, stable=True).indices
            cap = bucket_capacity(live_n)
            idx = perm[:live_n]
            if cap > live_n:
                idx = torch.cat([idx, idx[-1:].expand(cap - live_n)])
            laid = shard.gather(idx, live_n)
            off = 0
            for d in range(n_dev):
                c = int(counts[s, d])
                if c:
                    row[d] = laid.slice_rows(off, c)
                off += c
        buckets.append(row)
    return all_to_all(buckets, mesh), counts


def gather_stacked(out_cols, counts, dtypes, schema: Optional[Schema] = None,
                   device=None) -> ColumnarBatch:
    """One batch of shard ``d``'s first ``counts[d]`` rows, in shard
    order, on ``device`` (default: shard 0's plane's device).
    ``out_cols``: one ``(data, validity, chars | None)`` a column, each
    plane indexable by shard (a stacked (n_dev, cap, ...) tensor or a
    list of per-shard tensors; a None entry is a shard with nothing).
    Each output plane is allocated once at ``bucket_capacity(total)``,
    the dead tail zero and invalid; string chars are padded to the
    widest shard's."""
    counts = np.asarray(counts, np.int64)
    n_dev = len(counts)
    total = int(counts.sum())
    cap = bucket_capacity(max(total, 1))
    cols = []
    for (data, valid, chars), dt in zip(out_cols, dtypes):
        live = [d for d in range(n_dev) if counts[d]]
        ref = next(data[d] for d in range(n_dev) if data[d] is not None)
        dev = torch.device(device) if device is not None else ref.device
        out_d = torch.zeros((cap,) + tuple(ref.shape[1:]), dtype=ref.dtype,
                            device=dev)
        out_v = torch.zeros(cap, dtype=torch.bool, device=dev)
        out_c = None
        if chars is not None:
            widths = [int(chars[d].shape[1]) for d in range(n_dev)
                      if chars[d] is not None]
            width = max(widths) if widths else 8
            out_c = torch.zeros((cap, width), dtype=torch.uint8, device=dev)
        off = 0
        for d in live:
            m = int(counts[d])
            out_d[off:off + m] = data[d][:m].to(dev, non_blocking=True)
            out_v[off:off + m] = valid[d][:m].to(dev, non_blocking=True)
            if out_c is not None:
                ch = chars[d]
                out_c[off:off + m, :ch.shape[1]] = \
                    ch[:m].to(dev, non_blocking=True)
            off += m
        cols.append(DeviceColumn(dt, out_d, out_v, total, out_c))
    return ColumnarBatch(cols, total, schema)


def gather_batches(batches: Sequence[Optional[ColumnarBatch]], dtypes,
                   schema: Optional[Schema] = None,
                   device=None) -> ColumnarBatch:
    """``gather_stacked`` over one batch a shard (None for a shard with
    no rows)."""
    if all(b is None for b in batches):
        if device is None:
            raise ValueError("gather_batches needs a device when every "
                             "shard is empty")
        from spark_rapids_tpu_torch.columnar.batch import empty_batch
        return empty_batch(schema, device)
    counts = [0 if b is None else b.num_rows for b in batches]
    planes = []
    for ci in range(len(dtypes)):
        cs = [None if b is None else b.columns[ci] for b in batches]
        planes.append(([None if c is None else c.data for c in cs],
                       [None if c is None else c.validity for c in cs],
                       None if all(c is None or c.chars is None for c in cs)
                       else [None if c is None else c.chars for c in cs]))
    return gather_stacked(planes, counts, dtypes, schema, device)
