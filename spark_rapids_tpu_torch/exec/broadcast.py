"""Broadcast exchange and broadcast hash join.

Counterpart of ``spark_rapids_tpu/exec/broadcast.py``.  On one card the
exchange concatenates its child into one device batch (the plan is built
anew for each action and the join executes its build side once, so
there is nothing to keep between executions); the join is the shared
hash-join core
(``exec/joins.py``) with that batch as its build side, streaming the
other side's batches through it.  The planner picks the side to
broadcast by its estimated size (``spark.sql.autoBroadcastJoinThreshold``)
and swaps the sides behind a reordering projection when only the left
side is small (``plan/planner.py``).  The build is a ``SpillableBatch``
at ``PRIORITY_RETAIN``, so it demotes after every working batch, and
``get()`` promotes it back.  The join closes the handle when its stream
ends or is closed, and the handle is also registered with the query's
lifecycle (``lifecycle.py``), as in the JAX package, so the query's
teardown reclaims a build whose stream was never closed.  The Arrow
serialization of the table, for multi-process executors, waits for the
exchange slice (queue A8).
"""

from __future__ import annotations

import contextlib
from typing import Iterator, List, Optional

from spark_rapids_tpu_torch import lifecycle
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.dtypes import Schema
from spark_rapids_tpu_torch.exec.base import ExecContext, TorchExec
from spark_rapids_tpu_torch.errors import QueryCancelledError
from spark_rapids_tpu_torch.exec.joins import TorchHashJoinExec, one_batch
from spark_rapids_tpu_torch.exprs.base import Expression
from spark_rapids_tpu_torch.memory.spill import PRIORITY_RETAIN, \
    SpillableBatch
from spark_rapids_tpu_torch.utils.metrics import METRIC_NUM_OUTPUT_BATCHES, \
    METRIC_NUM_OUTPUT_ROWS


class TorchBroadcastExchangeExec(TorchExec):
    """Yields its child's output as one device batch."""

    def __init__(self, child: TorchExec):
        super().__init__()
        self.children = [child]

    def describe(self) -> str:
        return "TorchBroadcastExchange"

    @property
    def output_schema(self) -> Schema:
        return self.children[0].output_schema

    @contextlib.contextmanager
    def materialize(self, ctx: ExecContext) -> Iterator[SpillableBatch]:
        """The build, for a join that holds it: the exchange's output,
        counted in its metrics as a pull of one batch would be."""
        with self._build(ctx) as handle:
            self.metrics[METRIC_NUM_OUTPUT_ROWS] += handle.num_rows
            self.metrics[METRIC_NUM_OUTPUT_BATCHES] += 1
            yield handle

    @contextlib.contextmanager
    def _build(self, ctx: ExecContext) -> Iterator[SpillableBatch]:
        """The child's output as one batch, registered with the spill
        catalog in the class that demotes last and with the query's
        lifecycle; closed when the block ends."""
        batch = one_batch(self.children[0], ctx)
        self.metrics["dataSize"] = batch.size_bytes()
        handle = SpillableBatch(batch, ctx.runtime.catalog,
                                priority=PRIORITY_RETAIN)
        reg = lifecycle.register_resource(handle.close, kind="broadcast",
                                          name="broadcast-build")
        if reg.rejected:  # closed on arrival by the query's teardown
            raise QueryCancelledError(
                "broadcast build raced its query's teardown")
        try:
            yield handle
        finally:
            handle.close()
            reg.release()

    def execute(self, ctx: ExecContext) -> Iterator[ColumnarBatch]:
        with self._build(ctx) as handle:
            yield handle.get()


class TorchBroadcastHashJoinExec(TorchHashJoinExec):
    """A hash join whose build side is a broadcast exchange."""

    def __init__(self, left: TorchExec, broadcast: TorchBroadcastExchangeExec,
                 left_keys: List[Expression], right_keys: List[Expression],
                 join_type: str = "inner",
                 condition: Optional[Expression] = None):
        if not isinstance(broadcast, TorchBroadcastExchangeExec):
            raise TypeError("the build side of a broadcast join must be a "
                            "broadcast exchange")
        super().__init__(left, broadcast, left_keys, right_keys, join_type,
                         condition)

    def execute(self, ctx: ExecContext) -> Iterator[ColumnarBatch]:
        # the build's handle lives as long as this query's stream: the
        # generator's end, or its close, releases it
        with self.children[1].materialize(ctx) as handle:
            yield from self._join(ctx, handle.get())
