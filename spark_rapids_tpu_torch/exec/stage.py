"""The fused filter + project stage.

Counterpart of ``spark_rapids_tpu/exec/stage.py`` (``emit_steps``,
``TpuStageExec``).  The fusion pass (``plan/fusion.py``) collapses each
maximal chain of project and filter operators into one
``TorchStageExec``, which runs the chain per batch; a chain of one runs
as a ``TorchProjectExec`` or ``TorchFilterExec`` (``exec/basic.py``)
over the same code (``StepsExec``).  The JAX package traces the chain
into one XLA program; here the steps run eagerly, one after the other,
on the batch's device.

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
batch's ordinal (``partition_id``), as in the JAX package.  Each
attempt first asks the ``kernel.launch`` fault site (``faults.py``), as
the JAX package's fused kernel launch does.
"""

from __future__ import annotations

import threading
from typing import Iterator, List, Sequence, Tuple

import torch

from spark_rapids_tpu_torch import faults
from spark_rapids_tpu_torch.columnar import encoding
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.columnar.dtypes import Field, Schema
from spark_rapids_tpu_torch.exec.base import ExecContext, TorchExec
from spark_rapids_tpu_torch.exprs.base import ColVal, EvalContext, \
    Expression
from spark_rapids_tpu_torch.exprs.nondeterministic import \
    contains_nondeterministic
from spark_rapids_tpu_torch.utils.retry import split_batch_half, with_retry

# a step is ("project", (expr, ...)) or ("filter", (pred,))
Step = Tuple[str, Tuple[Expression, ...]]


def emit_steps(steps: Sequence[Step], cols: List[ColVal], num_rows: int,
               capacity: int, device, partition_id: int = 0,
               aux: Sequence[ColVal] = ()) -> Tuple[List[ColVal], int]:
    """Run the step chain over ``cols`` (``aux``: a code view's gather
    tables); returns ``(cols, num_rows)``."""
    n = num_rows
    for kind, exprs in steps:
        ctx = EvalContext(cols, n, capacity, device, partition_id, aux)
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


def run_steps(steps: Sequence[Step], batch: ColumnarBatch, schema: Schema,
              partition_id: int = 0) -> ColumnarBatch:
    """The step chain over one batch through its code view
    (``columnar/encoding.py: stage_view``): encoded columns run as
    codes, and an output that stays codes comes back encoded."""
    view = encoding.stage_view(steps, batch)
    cols, n = emit_steps(view.steps, view.cols, batch.num_rows,
                         batch.capacity, batch.device, partition_id,
                         view.aux)
    out = []
    for i, (f, cv) in enumerate(zip(schema, cols)):
        col = view.wrap_column(i, cv.data, cv.validity, n)
        out.append(col if col is not None else
                   DeviceColumn(f.dtype, cv.data, cv.validity, n, cv.chars))
    return ColumnarBatch(out, n, schema)


_STATS_LOCK = threading.Lock()
_STATS = {"stages": 0, "dispatches": 0, "fused_ops": 0}


def global_stats() -> dict:
    """The registry's ``fusion`` section: the fused stages run, their
    dispatches (one a batch) and the operators they folded."""
    with _STATS_LOCK:
        return dict(_STATS)


class StepsExec(TorchExec):
    """A chain of project/filter steps run per input batch: the code a
    fused ``TorchStageExec`` and the one-step ``TorchProjectExec`` and
    ``TorchFilterExec`` (``exec/basic.py``) share."""

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
        faults.maybe_fail_oom("kernel.launch")
        return run_steps(self.steps, batch, self._schema, partition_id)

    def _started(self) -> None:
        """The first batch is asked for."""

    def _dispatched(self, n: int) -> None:
        """``n`` output batches of one input batch ran."""

    def execute(self, ctx: ExecContext) -> Iterator[ColumnarBatch]:
        self._started()
        # rows split freely under per-row project and filter steps, but
        # not under an expression that reads the row's position
        split = None if self.nondeterministic else split_batch_half
        for pid, batch in enumerate(self.children[0].execute(ctx)):
            results = with_retry(lambda b: self._run(b, pid), batch, ctx,
                                 split=split, fire_launch_site=False)
            self._dispatched(len(results))
            self.metrics["hostSyncs"] += self._filters * len(results)
            yield from results


class TorchStageExec(StepsExec):
    """A fused chain of project/filter steps (``plan/fusion.py``), run
    per input batch; ``stageDispatches`` counts its batches and
    ``fusedOps`` its steps, as the JAX stage's do."""

    def describe(self) -> str:
        parts = [("Project[" + ", ".join(e.name for e in exprs) + "]")
                 if kind == "project" else f"Filter[{exprs[0].name}]"
                 for kind, exprs in self.steps]
        return "TorchStage [" + " -> ".join(parts) + "]"

    def _dispatched(self, n: int) -> None:
        self.metrics["stageDispatches"] += n
        with _STATS_LOCK:
            _STATS["dispatches"] += n

    def _started(self) -> None:
        self.metrics["fusedOps"] += len(self.steps)
        with _STATS_LOCK:
            _STATS["stages"] += 1
            _STATS["fused_ops"] += len(self.steps)
