"""The local scan, the range, the union and the limit.

Counterpart of ``spark_rapids_tpu/exec/basic.py``: ``TorchLocalScanExec``
scans in-memory host columns, uploaded in batches of 1 << 20 rows, as in
the JAX package (whatever the reader conf says); ``TorchRangeExec`` makes
``[start, end)`` by ``step`` on the device in batches of 1 << 20 rows;
``TorchUnionExec`` streams its children's batches back to back;
``TorchLocalLimitExec`` passes batches on until the limit is reached.
Project and filter run inside the fused stage (``exec/stage.py``).  None
of them holds a batch, so none registers one with the spill catalog.
"""

from __future__ import annotations

from typing import Iterator

import torch

from spark_rapids_tpu_torch.columnar.batch import (
    ColumnarBatch, HostColumns, host_batch_to_device,
)
from spark_rapids_tpu_torch.columnar.column import DeviceColumn, \
    bucket_capacity
from spark_rapids_tpu_torch.columnar.dtypes import INT64, Field, Schema
from spark_rapids_tpu_torch.conf import MAX_STRING_WIDTH
from spark_rapids_tpu_torch.exec.base import ExecContext, TorchExec

BATCH_ROWS = 1 << 20


class TorchLocalScanExec(TorchExec):
    def __init__(self, schema: Schema, cols: HostColumns):
        super().__init__()
        self._schema = schema
        self.cols = cols
        self.children = []

    @property
    def output_schema(self) -> Schema:
        return self._schema

    def execute(self, ctx: ExecContext) -> Iterator[ColumnarBatch]:
        n = len(self.cols[self._schema[0].name][0]) if len(self._schema) \
            else 0
        max_w = ctx.conf.get(MAX_STRING_WIDTH)
        for start in range(0, n, BATCH_ROWS):
            part = {name: (v[start:start + BATCH_ROWS],
                           m[start:start + BATCH_ROWS])
                    for name, (v, m) in self.cols.items()}
            yield host_batch_to_device(self._schema, part, ctx.device, max_w)


class TorchRangeExec(TorchExec):
    """The int64 column ``id``: ``start`` to ``end`` (exclusive) by
    ``step``, ``-(-(end - start) // step)`` rows (none when that is not
    positive), made on the device in batches of ``BATCH_ROWS``.  A step
    of 0 raises ``ZeroDivisionError`` when the range runs, as in the JAX
    package."""

    def __init__(self, start: int, end: int, step: int = 1,
                 name: str = "id"):
        super().__init__()
        self.start, self.end, self.step = int(start), int(end), int(step)
        self.children = []
        self._schema = Schema([Field(name, INT64, nullable=False)])

    @property
    def output_schema(self) -> Schema:
        return self._schema

    def execute(self, ctx: ExecContext) -> Iterator[ColumnarBatch]:
        total = max(0, -(-(self.end - self.start) // self.step))
        for pos in range(0, total, BATCH_ROWS):
            n = min(BATCH_ROWS, total - pos)
            cap = bucket_capacity(n)
            iota = torch.arange(cap, dtype=torch.int64, device=ctx.device)
            data = iota * self.step + (self.start + pos * self.step)
            yield ColumnarBatch([DeviceColumn(INT64, data, iota < n, n)], n,
                                self._schema)


class TorchUnionExec(TorchExec):
    """UNION ALL: each child's batches in turn, under the first child's
    schema; no batch is concatenated (a coalesce above sizes them)."""

    def __init__(self, children):
        super().__init__()
        self.children = list(children)

    @property
    def output_schema(self) -> Schema:
        return self.children[0].output_schema

    def execute(self, ctx: ExecContext) -> Iterator[ColumnarBatch]:
        for child in self.children:
            yield from child.execute(ctx)


def head(batch: ColumnarBatch, n: int) -> ColumnarBatch:
    """The first ``min(n, num_rows)`` rows of ``batch``, at a capacity no
    larger than the bucket of ``n``."""
    n = min(n, batch.num_rows)
    cap = min(batch.capacity, bucket_capacity(max(1, n)))
    live = torch.arange(cap, device=batch.device) < n
    cols = [DeviceColumn(c.dtype, c.data[:cap], c.validity[:cap] & live, n,
                         None if c.chars is None else c.chars[:cap])
            for c in batch.columns]
    return ColumnarBatch(cols, n, batch.schema)


class TorchLocalLimitExec(TorchExec):
    """The first ``limit`` rows of the child, in its order."""

    def __init__(self, limit: int, child: TorchExec):
        super().__init__()
        self.limit = int(limit)
        self.children = [child]

    @property
    def output_schema(self) -> Schema:
        return self.children[0].output_schema

    def execute(self, ctx: ExecContext) -> Iterator[ColumnarBatch]:
        remaining = self.limit
        for batch in self.children[0].execute(ctx):
            if remaining <= 0:
                break
            out = head(batch, remaining)
            remaining -= out.num_rows
            yield out
