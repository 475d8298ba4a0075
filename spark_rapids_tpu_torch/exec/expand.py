"""Expand: one output batch per (input batch, projection list).

Counterpart of ``spark_rapids_tpu/exec/expand.py`` (``expand_schema``,
``TpuExpandExec``).  Rollup and cube lower to an Expand under the
aggregate: each grouping set is one projection, which copies every input
column, masks the keys the set leaves out with a typed null and appends
the grouping id.  Every projection runs over the same resident input
batch, so an N-set expand sends N times the input rows on, batch by
batch, and holds nothing: the aggregate's coalesce and update phase see
them as a stream.  ``partition_id`` of a projection is the input batch's
ordinal, as in the JAX package.
"""

from __future__ import annotations

from typing import Iterator, List

from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.columnar.dtypes import Field, Schema
from spark_rapids_tpu_torch.exec.base import ExecContext, TorchExec
from spark_rapids_tpu_torch.exec.stage import emit_steps
from spark_rapids_tpu_torch.exprs.base import Expression, colvals


def expand_schema(projections: List[List[Expression]],
                  names: List[str]) -> Schema:
    """The first projection's types; a column is nullable when it is in
    any projection."""
    return Schema([Field(name, projections[0][i].dtype,
                         any(p[i].nullable for p in projections))
                   for i, name in enumerate(names)])


class TorchExpandExec(TorchExec):
    def __init__(self, projections: List[List[Expression]],
                 names: List[str], child: TorchExec):
        super().__init__()
        self.projections = [tuple(p) for p in projections]
        self.names = list(names)
        self.children = [child]
        self._schema = expand_schema(projections, names)

    def describe(self) -> str:
        return f"TorchExpand [{len(self.projections)} projections]"

    @property
    def output_schema(self) -> Schema:
        return self._schema

    def execute(self, ctx: ExecContext) -> Iterator[ColumnarBatch]:
        for pid, batch in enumerate(self.children[0].execute(ctx)):
            cvs = colvals(batch.columns)
            for proj in self.projections:
                cols, n = emit_steps([("project", proj)], cvs,
                                     batch.num_rows, batch.capacity,
                                     batch.device, pid)
                yield ColumnarBatch(
                    [DeviceColumn(f.dtype, cv.data, cv.validity, n, cv.chars)
                     for f, cv in zip(self._schema, cols)], n, self._schema)
