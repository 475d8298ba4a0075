"""Batch coalescing and concatenation.

Counterpart of ``spark_rapids_tpu/exec/coalesce.py``.  ``concat_batches``
lays the live rows of several batches end to end in one batch whose
capacity is the bucket of their total; a string column's char matrices
are padded to the widest of them, as in the JAX package.  A column that
every batch holds dictionary-encoded goes onto one dictionary
(``columnar/encoding.py: unify_ordinals``) and concatenates as codes.
``TorchCoalesceBatchesExec`` accumulates batches up to the byte target
and row cap the JAX package uses before an aggregate, so both packages
hand the aggregate the same batches.  The port counts the rows a batch
holds; the JAX package counts a filtered batch by its pre-filter bound,
so after a filter the two can flush at different points.  The pending
batches are ``SpillableBatch``es, brought back by ``materialize_all``
before the concat, which holds a permit of the device's semaphore.  When
``spark.rapids.sql.io.prefetch.enabled`` is on (it is off by default) the
child is pulled one batch ahead on a background thread
(``io/prefetch.py: device_lookahead``).
"""

from __future__ import annotations

from typing import Iterator, List

import torch

from spark_rapids_tpu_torch.columnar import encoding
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.column import DeviceColumn, \
    bucket_capacity
from spark_rapids_tpu_torch.conf import BATCH_SIZE_BYTES, BATCH_SIZE_ROWS
from spark_rapids_tpu_torch.exec.base import ExecContext, TorchExec
from spark_rapids_tpu_torch.io.prefetch import device_lookahead
from spark_rapids_tpu_torch.memory.spill import SpillableBatch, close_all, \
    materialize_all


def concat_batches(batches: List[ColumnarBatch]) -> ColumnarBatch:
    """Concatenate the live rows of device batches (padding zeroed)."""
    if not batches:
        raise ValueError("concat_batches of empty list needs a batch")
    if len(batches) == 1:
        return batches[0]
    total = sum(b.num_rows for b in batches)
    cap = bucket_capacity(max(1, total))
    head = batches[0]
    # a column encoded in every batch goes onto one dictionary and
    # concatenates as codes; where only some batches hold it encoded,
    # those decode (counted late decodes)
    col_lists = [list(b.columns) for b in batches]
    shared = encoding.unify_ordinals(col_lists)
    cols = []
    for ci, hc in enumerate(col_lists[0]):
        dev = hc.validity.device
        planes = [encoding.col_planes(cl[ci], ci in shared)
                  for cl in col_lists]
        data = torch.zeros(cap, dtype=planes[0][0].dtype, device=dev)
        valid = torch.zeros(cap, dtype=torch.bool, device=dev)
        chars = None
        if planes[0][2] is not None:
            width = max(p[2].shape[1] for p in planes)
            chars = torch.zeros((cap, width), dtype=torch.uint8, device=dev)
        off = 0
        for b, (d, v, ch) in zip(batches, planes):
            n = b.num_rows
            data[off:off + n] = d[:n]
            valid[off:off + n] = v[:n]
            if chars is not None:
                chars[off:off + n, :ch.shape[1]] = ch[:n]
            off += n
        cols.append(encoding.EncodedColumn(data, valid, total, shared[ci])
                    if ci in shared else
                    DeviceColumn(hc.dtype, data, valid, total, chars))
    return ColumnarBatch(cols, total, head.schema)


class TorchCoalesceBatchesExec(TorchExec):
    """Accumulate input batches up to ``batchSizeBytes`` bytes and
    ``batchSizeRows`` rows, then concatenate them."""

    def __init__(self, child: TorchExec):
        super().__init__()
        self.children = [child]

    def describe(self) -> str:
        return "TorchCoalesceBatches"

    @property
    def output_schema(self):
        return self.children[0].output_schema

    def execute(self, ctx: ExecContext) -> Iterator[ColumnarBatch]:
        from spark_rapids_tpu_torch.compile import buckets
        target = ctx.conf.get(BATCH_SIZE_BYTES)
        # with the capacity ladder configured, the row target is a rung
        # (compile/buckets.py: snap_rows), as in the JAX package
        max_rows = buckets.snap_rows(ctx.conf.get(BATCH_SIZE_ROWS)) \
            if buckets.configured() else ctx.conf.get(BATCH_SIZE_ROWS)
        cat = ctx.runtime.catalog
        # pending batches are spillable while they wait for the goal
        pending: List[SpillableBatch] = []
        pending_bytes = pending_rows = 0
        src = device_lookahead(self.children[0].execute(ctx), ctx,
                               self.metrics)
        try:
            for b in src:
                if b.num_rows == 0:
                    continue
                if pending and (pending_bytes + b.size_bytes() > target
                                or pending_rows + b.num_rows > max_rows):
                    yield self._flush(pending, ctx)
                    pending, pending_bytes, pending_rows = [], 0, 0
                pending_bytes += b.size_bytes()
                pending_rows += b.num_rows
                pending.append(SpillableBatch(b, cat))
            if pending:
                yield self._flush(pending, ctx)
                pending = []
        except BaseException:
            close_all(pending)
            raise
        finally:
            src.close()

    def _flush(self, pending: List[SpillableBatch],
               ctx: ExecContext) -> ColumnarBatch:
        # staging before the permit: the promotion of a spilled batch may
        # wait on host staging, which must never happen while a permit
        # is held, or every other task waiting for one would starve
        flushed = materialize_all(pending, ctx)
        with ctx.runtime.acquire_device():
            return concat_batches(flushed)
