"""Generate: explode and posexplode of a literal array.

Counterpart of ``spark_rapids_tpu/exec/generate.py`` (``generate_schema``,
``TpuGenerateExec``).  Each input row repeats once per array element:
output row ``j`` is input row ``j // n`` beside element ``j % n`` (and
its position, for posexplode), so an input batch of r rows gives one
batch of ``r * n``.  The elements are one small device column, uploaded
once a run and gathered with ``j % n``.  An empty array gives no rows,
or with ``outer`` one row per input row, its element (and position)
null.  The exec holds nothing but the array's elements.
"""

from __future__ import annotations

from typing import Iterator, List

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch, \
    strings_from_numpy, upload_column
from spark_rapids_tpu_torch.columnar.column import DeviceColumn, \
    bucket_capacity
from spark_rapids_tpu_torch.columnar.dtypes import INT32, STRING, Field, \
    Schema
from spark_rapids_tpu_torch.exec.base import ExecContext, TorchExec
from spark_rapids_tpu_torch.exprs.generators import Explode


def generate_schema(gen: Explode, child_schema: Schema,
                    names: List[str]) -> Schema:
    fields = list(child_schema)
    if gen.with_pos:
        fields.append(Field(names[0], INT32, gen.outer))
    fields.append(Field(names[-1], gen.dtype, gen.nullable))
    return Schema(fields)


def _elements(gen: Explode, device) -> DeviceColumn:
    """The array's elements as one device column; an empty array one
    null row, so that a gather has a source."""
    vals = gen.array.values or [None]
    valid = np.array([v is not None for v in vals], np.bool_)
    if gen.dtype == STRING:
        host, _ = strings_from_numpy(np.array(vals, dtype=object))
    else:
        host = np.array([0 if v is None else v for v in vals],
                        dtype=gen.dtype.numpy_dtype)
    return upload_column(gen.dtype, host, valid, bucket_capacity(len(vals)),
                         device)


class TorchGenerateExec(TorchExec):
    def __init__(self, gen: Explode, names: List[str], child: TorchExec):
        super().__init__()
        self.gen = gen
        self.names = list(names)
        self.children = [child]
        self._schema = generate_schema(gen, child.output_schema, names)

    @property
    def output_schema(self) -> Schema:
        return self._schema

    def execute(self, ctx: ExecContext) -> Iterator[ColumnarBatch]:
        gen = self.gen
        n_elem = len(gen.array.values)
        if n_elem == 0 and not gen.outer:
            return  # every row explodes to nothing
        rep = max(1, n_elem)
        elem = _elements(gen, ctx.device)
        for batch in self.children[0].execute(ctx):
            n_out = batch.num_rows * rep
            cap = bucket_capacity(n_out)
            j = torch.arange(cap, dtype=torch.int64, device=ctx.device)
            live = j < n_out
            src = torch.div(j, rep, rounding_mode="floor").clamp(
                max=batch.capacity - 1)
            cols = batch.gather(src, n_out).columns
            eidx = j % rep if n_elem else torch.full_like(j, -1)
            has = live & (eidx >= 0)
            if gen.with_pos:
                cols.append(DeviceColumn(INT32, eidx.to(torch.int32), has,
                                         n_out))
            at = eidx.clamp(min=0)
            cols.append(DeviceColumn(
                gen.dtype, elem.data[at], elem.validity[at] & has, n_out,
                None if elem.chars is None else elem.chars[at]))
            yield ColumnarBatch(cols, n_out, self._schema)
