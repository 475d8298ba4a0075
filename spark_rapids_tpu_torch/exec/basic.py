"""The local scan.

Counterpart of ``spark_rapids_tpu/exec/basic.py:TpuLocalScanExec``: a
scan over in-memory host columns, uploaded in batches of 1 << 20 rows,
as in the JAX package (whatever the reader conf says).  Project and
filter run inside the fused stage (``exec/stage.py``).
"""

from __future__ import annotations

from typing import Iterator

from spark_rapids_tpu_torch.columnar.batch import (
    ColumnarBatch, HostColumns, host_batch_to_device,
)
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
