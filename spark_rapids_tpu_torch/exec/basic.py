"""The local scan and the limit.

Counterpart of ``spark_rapids_tpu/exec/basic.py``: ``TorchLocalScanExec``
scans in-memory host columns, uploaded in batches of 1 << 20 rows, as in
the JAX package (whatever the reader conf says); ``TorchLocalLimitExec``
passes batches on until the limit is reached.  Project and filter run
inside the fused stage (``exec/stage.py``).
"""

from __future__ import annotations

from typing import Iterator

import torch

from spark_rapids_tpu_torch.columnar.batch import (
    ColumnarBatch, HostColumns, host_batch_to_device,
)
from spark_rapids_tpu_torch.columnar.column import DeviceColumn, \
    bucket_capacity
from spark_rapids_tpu_torch.columnar.dtypes import Schema
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
