"""The fused filter + project stage.

Counterpart of ``spark_rapids_tpu/exec/stage.py`` (``emit_steps``,
``TpuStageExec``).  The planner collapses each maximal chain of project
and filter operators into one ``TorchStageExec``, which runs the chain
per batch.  The JAX package traces the chain into one XLA program; here
the steps run eagerly, one after the other, on the batch's device.

A filter computes the keep-mask and compacts every current column to the
front with a gather, keeping the input capacity: rows past the new count
are padding (invalid, holding the last row's data as in the JAX package),
so the batches downstream operators see keep the JAX package's shapes.
The new row count is read back to the host: one sync per filter.

Each batch runs under ``with_retry`` (``utils/retry.py``): on a device
out-of-memory error the spill catalog is relieved and the batch runs
again, then in halves, each half its own output batch.  A stage that
holds a nondeterministic expression (``rand``,
``monotonically_increasing_id``, ``spark_partition_id``) retries without
splitting, because their values depend on the row's position and the
batch's ordinal (``partition_id``), as in the JAX package.
"""

from __future__ import annotations

from typing import Iterator, List, Sequence, Tuple

import torch

from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.columnar.dtypes import Field, Schema
from spark_rapids_tpu_torch.exec.base import ExecContext, TorchExec
from spark_rapids_tpu_torch.exprs.base import ColVal, EvalContext, \
    Expression, colvals
from spark_rapids_tpu_torch.exprs.nondeterministic import \
    contains_nondeterministic
from spark_rapids_tpu_torch.utils.retry import split_batch_half, with_retry

# a step is ("project", (expr, ...)) or ("filter", (pred,))
Step = Tuple[str, Tuple[Expression, ...]]


def emit_steps(steps: Sequence[Step], cols: List[ColVal], num_rows: int,
               capacity: int, device, partition_id: int = 0
               ) -> Tuple[List[ColVal], int]:
    """Run the step chain over ``cols``; returns ``(cols, num_rows)``."""
    n = num_rows
    for kind, exprs in steps:
        ctx = EvalContext(cols, n, capacity, device, partition_id)
        live = torch.arange(capacity, device=device) < n
        if kind == "project":
            cols = [ColVal(o.data, o.validity & live, o.chars)
                    for o in (e.emit(ctx) for e in exprs)]
        else:
            p = exprs[0].emit(ctx)
            keep = p.data & p.validity & live
            kept = torch.nonzero(keep).squeeze(1)
            count = int(kept.numel())
            idx = torch.full((capacity,), capacity - 1, dtype=torch.int64,
                             device=device)
            idx[:count] = kept
            ok = torch.arange(capacity, device=device) < count
            # a string column's chars move with its rows
            cols = [ColVal(cv.data[idx], cv.validity[idx] & ok,
                           None if cv.chars is None else cv.chars[idx])
                    for cv in cols]
            n = count
    return cols, n


class TorchStageExec(TorchExec):
    """A fused chain of project/filter steps, run per input batch."""

    def __init__(self, steps: Sequence[Step], child: TorchExec):
        super().__init__()
        self.steps: List[Step] = [(k, tuple(es)) for k, es in steps]
        self.children = [child]
        schema = child.output_schema
        for kind, exprs in self.steps:
            if kind == "project":
                schema = Schema([Field(e.name, e.dtype, e.nullable)
                                 for e in exprs])
        self._schema = schema
        self._filters = sum(kind == "filter" for kind, _ in self.steps)
        self.nondeterministic = any(contains_nondeterministic(e)
                                    for _, es in self.steps for e in es)

    @property
    def output_schema(self) -> Schema:
        return self._schema

    def _run(self, batch: ColumnarBatch,
             partition_id: int = 0) -> ColumnarBatch:
        cols, n = emit_steps(self.steps, colvals(batch.columns),
                             batch.num_rows, batch.capacity, batch.device,
                             partition_id)
        out = [DeviceColumn(f.dtype, cv.data, cv.validity, n, cv.chars)
               for f, cv in zip(self._schema, cols)]
        return ColumnarBatch(out, n, self._schema)

    def execute(self, ctx: ExecContext) -> Iterator[ColumnarBatch]:
        # rows split freely under per-row project and filter steps, but
        # not under an expression that reads the row's position
        split = None if self.nondeterministic else split_batch_half
        for pid, batch in enumerate(self.children[0].execute(ctx)):
            results = with_retry(lambda b: self._run(b, pid), batch, ctx,
                                 split=split)
            self.metrics["stageDispatches"] += len(results)
            self.metrics["hostSyncs"] += self._filters * len(results)
            yield from results
