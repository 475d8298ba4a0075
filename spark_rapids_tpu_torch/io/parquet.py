"""Parquet scan.

Counterpart of ``spark_rapids_tpu/io/parquet.py:TpuParquetScanExec``:
pyarrow reads each file on the host in record batches of
``spark.rapids.sql.reader.batchSizeRows`` rows, combines them up to that
many rows, as the JAX package's host reader does, and each combined
batch is uploaded.  pyarrow is imported inside the functions that read,
so the rest of the port runs without it.  Row-group pruning by footer
statistics is not in this slice: every row group is read, and the
Filter above the scan does the filtering.
"""

from __future__ import annotations

import glob as _glob
import os
from typing import Iterator, List

from spark_rapids_tpu_torch.columnar.batch import (
    ColumnarBatch, host_batch_to_device, host_columns_from_arrow,
)
from spark_rapids_tpu_torch.columnar.dtypes import Schema
from spark_rapids_tpu_torch.conf import MAX_STRING_WIDTH, \
    READER_BATCH_SIZE_ROWS
from spark_rapids_tpu_torch.exec.base import ExecContext, TorchExec


def expand_paths(path) -> List[str]:
    if isinstance(path, (list, tuple)):
        return [f for p in path for f in expand_paths(p)]
    if os.path.isdir(path):
        return sorted(_glob.glob(os.path.join(path, "**", "*.parquet"),
                                 recursive=True))
    if any(ch in path for ch in "*?["):
        return sorted(_glob.glob(path))
    return [path]


def read_schema(paths) -> Schema:
    import pyarrow.parquet as pq
    files = expand_paths(paths)
    if not files:
        raise FileNotFoundError(f"no parquet files at {paths!r}")
    return Schema.from_arrow(pq.read_schema(files[0]))


def _combine(rbs):
    """Record batches -> one, or the one given."""
    import pyarrow as pa
    if len(rbs) == 1:
        return rbs[0]
    return pa.Table.from_batches(rbs).combine_chunks()


def coalesce_host_batches(it, target_rows: int):
    """Combine record batches host-side up to ``target_rows`` (a cap: a
    batch that would cross it flushes the buffer first)."""
    buf, n = [], 0
    for rb in it:
        if buf and n + rb.num_rows > target_rows:
            yield _combine(buf)
            buf, n = [], 0
        buf.append(rb)
        n += rb.num_rows
        if n >= target_rows:
            yield _combine(buf)
            buf, n = [], 0
    if buf:
        yield _combine(buf)


class TorchParquetScanExec(TorchExec):
    def __init__(self, paths, schema: Schema):
        super().__init__()
        self.paths = expand_paths(paths)
        self._schema = schema
        self.children = []

    def describe(self) -> str:
        return f"TorchParquetScan [{len(self.paths)} files]"

    @property
    def output_schema(self) -> Schema:
        return self._schema

    def execute(self, ctx: ExecContext) -> Iterator[ColumnarBatch]:
        import pyarrow.parquet as pq
        rows = ctx.conf.get(READER_BATCH_SIZE_ROWS)
        max_w = ctx.conf.get(MAX_STRING_WIDTH)
        names = self._schema.names
        for path in self.paths:
            f = pq.ParquetFile(path)
            it = (b for b in f.iter_batches(batch_size=rows, columns=names)
                  if b.num_rows)
            for rb in coalesce_host_batches(it, rows):
                _, cols = host_columns_from_arrow(rb)
                yield host_batch_to_device(self._schema, cols, ctx.device,
                                           max_w)
