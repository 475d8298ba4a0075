"""Global sort and top-N.

Counterpart of ``spark_rapids_tpu/exec/sort.py``.  ``TorchSortExec``
concatenates the whole input into one batch, sorts it by the order keys
(``exec/sortkeys.py``) and gathers every column, a string column's chars
included, by the permutation (a dictionary-encoded key sorts by its
codes, and encoded columns move as codes).  ``TorchTopNExec`` (a limit over a sort)
keeps the first ``limit`` rows of the sorted concatenation of what it
kept so far and the next batch, so it never holds more than the limit
and one batch.  The sort's input collects through the spill catalog
(``collect_spillable``); every sort runs under ``with_retry`` without a
split, since it needs its whole input at once.
"""

from __future__ import annotations

from typing import Iterator, List, Tuple

import torch

from spark_rapids_tpu_torch.columnar import encoding
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.dtypes import INT32, Schema
from spark_rapids_tpu_torch.exec.base import ExecContext, TorchExec
from spark_rapids_tpu_torch.exec.basic import head
from spark_rapids_tpu_torch.exec.coalesce import concat_batches
from spark_rapids_tpu_torch.exec.sortkeys import colval_sort_keys, \
    sort_permutation
from spark_rapids_tpu_torch.exprs.base import ColVal, Expression
from spark_rapids_tpu_torch.memory.spill import collect_spillable, \
    materialize_all
from spark_rapids_tpu_torch.utils.retry import with_retry


def sort_batch(orders: List[Tuple[Expression, bool, bool]],
               batch: ColumnarBatch) -> ColumnarBatch:
    """``batch``'s rows in ``orders``' order.  A key that is a bare
    reference to a dictionary-encoded column sorts by its codes (ranks:
    the strings' order, ties alike); other keys are evaluated through
    the batch's code view; the rows move as they are, codes as codes."""
    live = torch.arange(batch.capacity, device=batch.device) \
        < batch.num_rows
    coded = [encoding.encoded_ref(e, batch) for e, _, _ in orders]
    ctx, exprs = encoding.eval_view(
        [e for (e, _, _), c in zip(orders, coded) if c is None], batch)
    exprs = iter(exprs)
    keys = []
    for (expr, asc, nulls_first), col in zip(orders, coded):
        if col is not None:
            keys.extend(colval_sort_keys(ColVal(col.codes, col.validity),
                                         INT32, asc, nulls_first))
        else:
            keys.extend(colval_sort_keys(next(exprs).emit(ctx), expr.dtype,
                                         asc, nulls_first))
    perm = sort_permutation(keys, live_first=live)
    return batch.gather(perm, batch.num_rows)


def _orders_text(orders) -> str:
    return ", ".join(f"{e.name} {'ASC' if a else 'DESC'}"
                     for e, a, _ in orders)


class TorchSortExec(TorchExec):
    def __init__(self, orders: List[Tuple[Expression, bool, bool]],
                 child: TorchExec):
        super().__init__()
        self.orders = orders
        self.children = [child]

    def describe(self) -> str:
        return "TorchSort [" + _orders_text(self.orders) + "]"

    @property
    def output_schema(self) -> Schema:
        return self.children[0].output_schema

    def execute(self, ctx: ExecContext) -> Iterator[ColumnarBatch]:
        # the input collects as spillable handles, within the budget
        handles = collect_spillable(self.children[0].execute(ctx), ctx)
        if not handles:
            return
        batch = concat_batches(materialize_all(handles, ctx))
        # a global sort needs its whole input at once: relief, no split
        yield from with_retry(lambda b: sort_batch(self.orders, b), batch,
                              ctx)


class TorchTopNExec(TorchExec):
    """The first ``limit`` rows of the child in the order of ``orders``."""

    def __init__(self, orders: List[Tuple[Expression, bool, bool]],
                 limit: int, child: TorchExec):
        super().__init__()
        self.orders = orders
        self.limit = int(limit)
        self.children = [child]

    def describe(self) -> str:
        return f"TorchTopN [{self.limit}, " + _orders_text(self.orders) + "]"

    @property
    def output_schema(self) -> Schema:
        return self.children[0].output_schema

    def execute(self, ctx: ExecContext) -> Iterator[ColumnarBatch]:
        top = None
        for b in self.children[0].execute(ctx):
            cand = b if top is None else concat_batches([top, b])
            # one batch's sort: relief on a device out-of-memory error
            top = head(with_retry(lambda bb: sort_batch(self.orders, bb),
                                  cand, ctx)[0], self.limit)
        if top is not None and top.num_rows:
            yield top
