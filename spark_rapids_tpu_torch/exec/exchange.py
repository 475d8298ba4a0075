"""The single-process shuffle exchange: hash, round-robin, single and
range partitioning.

Counterpart of ``spark_rapids_tpu/exec/exchange.py``
(``TpuShuffleExchangeExec`` and the functions it runs).  Each input batch
gets a partition id a row:

- hash: the join hash of the keys (``exec/joins.py: hash_keys``, bit for
  bit the JAX package's), taken as an unsigned 64-bit value mod n, as
  the JAX package computes it (``h.astype(uint64) % n``; not Spark's
  pmod).  CUDA torch has no unsigned 64-bit ``%``, so a negative hash
  adds ``2**64 mod n`` to its floor remainder;
- round-robin: the row's ordinal in the whole input mod n, its start
  carried from batch to batch;
- range: the number of bounds the row's sort-key tuple is above, the
  bounds sampled from the whole input first (``compute_range_bounds``);

then a stable sort by partition id lays the rows out partition by
partition, each partition's rows in input order, and one gather a
non-empty partition cuts them out (the partition counts are one host
sync a batch).  Single mode, and any mode with one partition, sends
every batch to partition 0.  The output is one batch a non-empty
partition, in partition order: its pieces from every input batch
concatenated.  The pieces wait as spillable handles of the catalog; the
range mode holds its whole input so too between its two passes.  The
partitioning of a batch runs under ``with_retry``: hash and range split
a batch that does not fit (their ids are per row), round-robin does not
(its ids depend on the row's position).  ``exchange.partition`` and
``exchange.range_bounds`` name the two halves in a torch.profiler
trace; ``shufflePartitionBytes`` adds up the partitions' estimated
bytes (hash, round-robin and single, as in the JAX package), through
``record_partition_sizes``, which also feeds the process-wide adaptive
statistics (``exec/aqe.py``), and ``last_partition_bytes`` keeps the
last run's sizes.  ``partition_buckets`` is the map side alone: the
buckets as spillable handles with each piece's bytes and rows, which an
adaptive query stage (``exec/aqe.py``) holds and regroups.
``aqe_inserted`` marks the exchanges the planner puts under a join when
adaptive execution is on: only those may coalesce or split.

``partition_batch_to_host`` is the host shuffle's map egress
(``shuffle/stage.py``): the same partition ids, the batch gathered along
their permutation and cut into one ``HostBlock`` a partition.  The JAX
package packs the permuted batch and pulls it in one transfer
(``pack_partitions_*``); the port's map workers run on the host, where
there is nothing to pull, so their blocks are the gathered planes.

Not carried over: the fused stage-and-partition kernel
(``partition_batch_fused``, XLA dispatch fusion, like the compile cache)
and the out-of-core ``salt`` (with ``exec/ooc.py``, queue A8b).
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar import encoding
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.column import bucket_capacity
from spark_rapids_tpu_torch.columnar.dtypes import STRING, Schema
from spark_rapids_tpu_torch.conf import MAX_STRING_WIDTH, RANGE_SAMPLE_SIZE
from spark_rapids_tpu_torch.exec.base import ExecContext, TorchExec
from spark_rapids_tpu_torch.exec.coalesce import concat_batches
from spark_rapids_tpu_torch.exec.joins import hash_keys
from spark_rapids_tpu_torch.exec.sortkeys import colval_sort_keys
from spark_rapids_tpu_torch.exprs.base import ColVal, Expression
from spark_rapids_tpu_torch.memory.spill import SpillableBatch, close_all, \
    collect_spillable, materialize_all
from spark_rapids_tpu_torch.utils import tracing
from spark_rapids_tpu_torch.utils.retry import split_batch_half, with_retry


def est_batch_bytes(b: ColumnarBatch) -> int:
    """A batch's bytes in the device layout, from its row count: a
    string its width, 4 length bytes and a validity byte a row, any other
    column its width and a validity byte."""
    total = 0
    for c in b.columns:
        # an encoded column counts at its dictionary's width, as dense
        if c.dtype == STRING:
            total += b.num_rows * (c.string_width + 4 + 1)
        else:
            total += b.num_rows * (c.data.element_size() + 1)
    return total


def record_partition_sizes(metrics, sizes: List[int]) -> None:
    """The one sink of an exchange's per-partition bytes: their sum to
    ``shufflePartitionBytes``, their shape to the process-wide adaptive
    statistics."""
    from spark_rapids_tpu_torch.exec.aqe import record_exchange_stats
    metrics["shufflePartitionBytes"] += sum(sizes)
    record_exchange_stats(sizes)


def unsigned_mod(h: torch.Tensor, n: int) -> torch.Tensor:
    """``h`` (int64) read as an unsigned 64-bit value, mod ``n``: a
    negative h is h + 2**64, so its remainder is h's floor remainder
    plus 2**64 mod n, mod n."""
    r = torch.remainder(h, n)
    return torch.where(h < 0, torch.remainder(r + (1 << 64) % n, n), r)


def pid_to_counts_perm(pid: torch.Tensor, live: torch.Tensor,
                       num_parts: int):
    """Partition id a row -> (the partitions' row counts on the host, the
    stable permutation that lays the rows out partition by partition);
    dead rows sort to the end.  One host sync."""
    pid = torch.where(live, pid.to(torch.int64),
                      torch.full_like(pid, num_parts, dtype=torch.int64))
    perm = torch.sort(pid, stable=True).indices
    counts = torch.bincount(pid, minlength=num_parts + 1)[:num_parts]
    return counts.tolist(), perm


def slice_partitions(batch: ColumnarBatch, counts: List[int],
                     perm: torch.Tensor) -> List[Optional[ColumnarBatch]]:
    """Each partition's rows, gathered out of the permutation at the
    bucket capacity of its count (None for an empty partition)."""
    out: List[Optional[ColumnarBatch]] = []
    off = 0
    for n in counts:
        if n == 0:
            out.append(None)
            continue
        cap = bucket_capacity(n)
        idx = perm[off:off + n]
        if cap > n:
            idx = torch.cat([idx, idx[-1:].expand(cap - n)])
        out.append(batch.gather(idx, n))
        off += n
    return out


def partition_ids(batch: ColumnarBatch, num_parts: int,
                  keys: Sequence[Expression], mode: str,
                  rr_start: int = 0):
    """-> (the partition id a row, which rows are live) by the hash of
    ``keys`` or round-robin from ``rr_start``."""
    cap, dev = batch.capacity, batch.device
    iota = torch.arange(cap, dtype=torch.int64, device=dev)
    live = iota < batch.num_rows
    if mode == "hash":
        # encoded key columns hash through per-code tables, bit for bit
        # the dense path's hash (columnar/encoding.py: stage_view)
        ctx, keys = encoding.eval_view(keys, batch, hashed=True)
        h, _valid, _ = hash_keys(keys, ctx)
        pid = unsigned_mod(h, num_parts)
    else:
        pid = (iota + rr_start) % num_parts
    return pid, live


def partition_batch(batch: ColumnarBatch, num_parts: int,
                    keys: Sequence[Expression], mode: str,
                    rr_start: int = 0) -> List[Optional[ColumnarBatch]]:
    """Split one batch into ``num_parts`` batches (None for an empty
    one) by the hash of ``keys`` or round-robin from ``rr_start``."""
    pid, live = partition_ids(batch, num_parts, keys, mode, rr_start)
    counts, perm = pid_to_counts_perm(pid, live, num_parts)
    return slice_partitions(batch, counts, perm)


def partition_batch_to_host(batch: ColumnarBatch, num_parts: int,
                            keys: Optional[Sequence[Expression]] = None,
                            mode: str = "hash", rr_start: int = 0) -> list:
    """The host shuffle's map egress: ``partition_batch``'s partition
    ids (hash without keys is round-robin), the batch gathered along
    their permutation and cut into one ``HostBlock`` a partition (None
    for an empty one).  ``batch`` lies on the host, as the map
    workers' batches do, so the gathered planes become the blocks'
    arrays with no pull and no copy."""
    from spark_rapids_tpu_torch.columnar.batch import host_batch_columns
    from spark_rapids_tpu_torch.shuffle.serializer import HostBlock
    if not (mode == "hash" and keys):
        mode, keys = "roundrobin", []
    pid, live = partition_ids(batch, num_parts, keys, mode, rr_start)
    counts, perm = pid_to_counts_perm(pid, live, num_parts)
    n = sum(counts)
    permuted = batch.gather(perm, n)
    block = HostBlock(batch.schema, host_batch_columns(permuted, copy=False),
                      n)
    out, off = [], 0
    for c in counts:
        out.append(block.slice(off, c) if c else None)
        off += c
    return out


def range_sort_keys(orders, batch: ColumnarBatch,
                    pad_width: int) -> List[torch.Tensor]:
    """The sort-key tensors of ``orders`` over ``batch``; string char
    matrices padded to ``pad_width``, so that every batch gives as many
    keys."""
    ctx, exprs = encoding.eval_view([e for e, _, _ in orders], batch)
    keys: List[torch.Tensor] = []
    for e, (_, asc, nf) in zip(exprs, orders):
        cv = e.emit(ctx)
        if e.dtype == STRING and cv.chars.shape[1] < pad_width:
            cv = ColVal(cv.data, cv.validity, torch.nn.functional.pad(
                cv.chars, (0, pad_width - cv.chars.shape[1])))
        keys.extend(colval_sort_keys(cv, e.dtype, asc, nf))
    return keys


def observed_key_width(orders, batch: ColumnarBatch, conf_max: int) -> int:
    """The width, a multiple of 4 capped at the conf's maximum, that the
    string keys' char matrices of this batch need."""
    strings = [e for e, _, _ in orders if e.dtype == STRING]
    if not strings:
        return 4
    ctx, strings = encoding.eval_view(strings, batch)
    widest = max([1] + [e.emit(ctx).chars.shape[1] for e in strings])
    return min(-(-widest // 4) * 4, -(-conf_max // 4) * 4)


def range_assign(keys: Sequence[torch.Tensor], bounds, num_rows: int,
                 num_parts: int):
    """Partition id a row: how many bound tuples its key tuple is above
    (Spark's RangePartitioner: the first bound >= the key) ->
    ``pid_to_counts_perm``."""
    cap = keys[0].shape[0]
    dev = keys[0].device
    nb = num_parts - 1
    eq = torch.ones((cap, nb), dtype=torch.bool, device=dev)
    gt = torch.zeros((cap, nb), dtype=torch.bool, device=dev)
    for k, b in zip(keys, bounds):
        br = torch.as_tensor(b, device=dev).to(k.dtype)[None, :]
        kc = k[:, None]
        gt = gt | (eq & (kc > br))
        eq = eq & (kc == br)
    pid = gt.sum(dim=1)
    live = torch.arange(cap, device=dev) < num_rows
    return pid_to_counts_perm(pid, live, num_parts)


def compute_range_bounds(key_rows: "list", num_parts: int,
                         sample_max: int = 10_000):
    """The ``num_parts - 1`` bound tuples from sampled key tuples, as the
    JAX package computes them (its ``compute_range_bounds``, line for
    line): ``key_rows`` is a list, a batch, of tuples of host key arrays
    (one a sort key, aligned by row); above ``sample_max`` rows a uniform
    subsample from ``default_rng(42)``; the bounds are the lexicographic
    order's rows at ``(i + 1) * n // num_parts``.  -> a tuple of arrays,
    one a key, or None when there is no row."""
    if not key_rows:
        return None
    nkeys = len(key_rows[0])
    cols = [np.concatenate([np.asarray(kr[i]) for kr in key_rows])
            for i in range(nkeys)]
    n = cols[0].shape[0]
    if n == 0:
        return None
    if n > sample_max:
        idx = np.random.default_rng(42).choice(n, sample_max, replace=False)
        cols = [c[idx] for c in cols]
        n = sample_max
    # np.lexsort's last key is the most significant
    order = np.lexsort(tuple(reversed(cols)))
    bounds = []
    pos = [min(n - 1, (i + 1) * n // num_parts)
           for i in range(num_parts - 1)]
    for c in cols:
        s = c[order]
        bounds.append(s[pos])
    return tuple(bounds)


def partition_batch_by_range(batch: ColumnarBatch, num_parts: int, orders,
                             pad_width: int, bounds
                             ) -> List[Optional[ColumnarBatch]]:
    """Split one batch along the bounds, its sort keys computed again."""
    keys = range_sort_keys(orders, batch, pad_width)
    counts, perm = range_assign(keys, bounds, batch.num_rows, num_parts)
    return slice_partitions(batch, counts, perm)


class TorchShuffleExchangeExec(TorchExec):
    """Re-buckets the rows into ``num_partitions`` output batches."""

    def __init__(self, num_partitions: int, keys: List[Expression],
                 mode: str, child: TorchExec, orders=None):
        super().__init__()
        self.num_partitions = max(1, int(num_partitions))
        self.keys = list(keys)
        self.orders = list(orders or [])  # [(expr, asc, nulls_first)]
        if mode == "range" and self.orders:
            self.mode = "range"
        else:
            self.mode = mode if (keys or mode == "single") else "roundrobin"
        self.children = [child]
        # the planner's join exchanges under adaptive execution: only
        # these may coalesce or split (a repartition(n) is the user's)
        self.aqe_inserted = False
        # each partition's estimated bytes in the last run (host ints)
        self.last_partition_bytes: Optional[List[int]] = None
        self.metrics["hostSyncs"] = 0
        self.metrics["shufflePartitionBytes"] = 0

    def describe(self) -> str:
        k = ", ".join(e.name for e in self.keys)
        if self.mode == "range":
            k = ", ".join(e.name + ("" if asc else " DESC")
                          for e, asc, _ in self.orders)
        return (f"TorchShuffleExchange [n={self.num_partitions}, "
                f"mode={self.mode}{', keys=' + k if k else ''}]")

    @property
    def output_schema(self) -> Schema:
        return self.children[0].output_schema

    def execute(self, ctx: ExecContext) -> Iterator[ColumnarBatch]:
        if self.mode == "range" and self.num_partitions > 1:
            parts = self._range_buckets(ctx)
        else:
            parts = self.partition_buckets(ctx)[0]
        try:
            for p in range(len(parts)):
                bucket, parts[p] = parts[p], []
                if bucket:
                    batches = materialize_all(bucket, ctx)
                    yield batches[0] if len(batches) == 1 else \
                        concat_batches(batches)
        finally:
            for bucket in parts:
                close_all(bucket)

    def _add(self, parts, pieces, ctx: ExecContext) -> None:
        cat = ctx.runtime.catalog
        for p, piece in enumerate(pieces):
            if piece is not None:
                parts[p].append(SpillableBatch(piece, cat))

    def partition_buckets(self, ctx: ExecContext):
        """The map side of hash, round-robin and single: every input
        batch's rows to their partitions' buckets -> (the buckets, a
        list of handles a partition; each piece's estimated bytes; each
        piece's rows), the sizes from the host row counts the partition
        step already read."""
        n = self.num_partitions
        parts: List[List[SpillableBatch]] = [[] for _ in range(n)]
        item_bytes: List[List[int]] = [[] for _ in range(n)]
        item_rows: List[List[int]] = [[] for _ in range(n)]

        def add(pieces) -> None:
            for p, piece in enumerate(pieces):
                if piece is not None:
                    item_bytes[p].append(est_batch_bytes(piece))
                    item_rows[p].append(piece.num_rows)
            self._add(parts, pieces, ctx)

        rr = 0
        try:
            for batch in self.children[0].execute(ctx):
                if n == 1 or self.mode == "single":
                    add([batch])
                    continue
                rr0 = rr
                rr += batch.num_rows
                with tracing.trace_range("exchange.partition"):
                    results = with_retry(
                        lambda b: partition_batch(b, n, self.keys,
                                                  self.mode, rr_start=rr0),
                        batch, ctx,
                        split=split_batch_half if self.mode == "hash"
                        else None)
                self.metrics["hostSyncs"] += len(results)
                for pieces in results:
                    add(pieces)
        except BaseException:
            for bucket in parts:
                close_all(bucket)
            raise
        self.last_partition_bytes = [sum(b) for b in item_bytes]
        record_partition_sizes(self.metrics, self.last_partition_bytes)
        return parts, item_bytes, item_rows

    def _range_buckets(self, ctx: ExecContext
                       ) -> List[List[SpillableBatch]]:
        """Two passes over the whole input, held as spillable handles:
        sample the sort keys to the bounds, then split every batch along
        them."""
        n = self.num_partitions
        handles = collect_spillable(self.children[0].execute(ctx), ctx)
        parts: List[List[SpillableBatch]] = [[] for _ in range(n)]
        try:
            if not handles:
                return parts
            with tracing.trace_range("exchange.range_bounds"):
                pad = 4
                for h in handles:
                    pad = max(pad, observed_key_width(
                        self.orders, h.get(), ctx.conf.get(MAX_STRING_WIDTH)))
                sample_max = ctx.conf.get(RANGE_SAMPLE_SIZE)
                total = sum(h.num_rows for h in handles)
                key_rows = []
                for h in handles:
                    b = h.get()
                    # an evenly spaced sample a batch, its share by rows
                    take = min(b.num_rows, max(
                        1, sample_max * b.num_rows // max(1, total)))
                    if take == 0 or b.num_rows == 0:
                        continue
                    idx = np.unique(np.linspace(
                        0, b.num_rows - 1, take).astype(np.int64))
                    at = torch.from_numpy(idx).to(b.device)
                    keys = range_sort_keys(self.orders, b, pad)
                    # one pull for every key's sample: float keys (as f64)
                    # travel as their bits beside the integer keys
                    floats = [k.is_floating_point() for k in keys]
                    host = torch.stack([
                        k[at].to(torch.float64).view(torch.int64) if fl
                        else k[at].to(torch.int64)
                        for k, fl in zip(keys, floats)]).cpu().numpy()
                    self.metrics["hostSyncs"] += 1
                    key_rows.append(tuple(
                        row.view(np.float64) if fl else row
                        for row, fl in zip(host, floats)))
                bounds = compute_range_bounds(key_rows, n, sample_max)
            if bounds is None:
                # no row to sample: the batches pass on as they came
                parts, handles = [[h] for h in handles], []
                return parts
            while handles:
                b = handles.pop(0)
                batch = materialize_all([b], ctx)[0]
                with tracing.trace_range("exchange.partition"):
                    results = with_retry(
                        lambda bb: partition_batch_by_range(
                            bb, n, self.orders, pad, bounds),
                        batch, ctx, split=split_batch_half)
                self.metrics["hostSyncs"] += len(results)
                for pieces in results:
                    self._add(parts, pieces, ctx)
        except BaseException:
            for bucket in parts:
                close_all(bucket)
            raise
        finally:
            close_all(handles)
        return parts
