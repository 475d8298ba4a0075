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
side is small (``plan/planner.py``).  The JAX package's spill-catalog
registration and Arrow serialization of the table serve its memory tiers
and multi-process executors, which the port does not have yet.
"""

from __future__ import annotations

from typing import Iterator, List, Optional

from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.dtypes import Schema
from spark_rapids_tpu_torch.exec.base import ExecContext, TorchExec
from spark_rapids_tpu_torch.exec.joins import TorchHashJoinExec, one_batch
from spark_rapids_tpu_torch.exprs.base import Expression


class TorchBroadcastExchangeExec(TorchExec):
    """Yields its child's output as one device batch."""

    def __init__(self, child: TorchExec):
        super().__init__()
        self.children = [child]

    @property
    def output_schema(self) -> Schema:
        return self.children[0].output_schema

    def execute(self, ctx: ExecContext) -> Iterator[ColumnarBatch]:
        batch = one_batch(self.children[0], ctx)
        self.metrics["dataSize"] = batch.size_bytes()
        yield batch


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
