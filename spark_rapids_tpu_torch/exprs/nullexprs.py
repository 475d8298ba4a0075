"""Null-handling expressions.

Counterpart of ``spark_rapids_tpu/exprs/nullexprs.py``, trimmed to
``Coalesce``, which the full outer USING join needs for its key column.
"""

from __future__ import annotations

import torch

from spark_rapids_tpu_torch.columnar.dtypes import DataType, common_type
from spark_rapids_tpu_torch.exprs.base import ColVal, EvalContext, \
    Expression, align_chars
from spark_rapids_tpu_torch.exprs.cast import Cast


def _merge_colval(acc: ColVal, nxt: ColVal) -> ColVal:
    """``acc`` where it is valid, else ``nxt``: one coalesce step."""
    take = acc.validity
    chars = None
    if acc.chars is not None:
        ac, bc = align_chars(acc.chars, nxt.chars)
        chars = torch.where(take[:, None], ac, bc)
    return ColVal(torch.where(take, acc.data, nxt.data),
                  acc.validity | nxt.validity, chars)


class Coalesce(Expression):
    """The first non-null argument."""

    def __init__(self, *children: Expression):
        self.children = tuple(children)

    @property
    def dtype(self) -> DataType:
        return self.children[0].dtype

    @property
    def nullable(self) -> bool:
        return all(c.nullable for c in self.children)

    @property
    def name(self) -> str:
        return "coalesce(" + ", ".join(c.name for c in self.children) + ")"

    def coerce(self) -> Expression:
        target = self.children[0].dtype
        for c in self.children[1:]:
            ct = common_type(target, c.dtype)
            if ct is None and c.dtype != target:
                raise TypeError(f"coalesce type mismatch: {target} vs "
                                f"{c.dtype}")
            target = ct or target
        return self.with_children([c if c.dtype == target else Cast(c, target)
                                   for c in self.children])

    def emit(self, ctx: EvalContext) -> ColVal:
        acc = self.children[0].emit(ctx)
        for c in self.children[1:]:
            acc = _merge_colval(acc, c.emit(ctx))
        return acc
