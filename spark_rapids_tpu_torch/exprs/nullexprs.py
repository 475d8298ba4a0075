"""Null-handling expressions.

Counterpart of ``spark_rapids_tpu/exprs/nullexprs.py``, trimmed to
``Coalesce`` (``functions.coalesce``, and the full outer USING join's key
column) and ``NullOf`` (SQL's untyped ``NULL``).
"""

from __future__ import annotations

import torch

from spark_rapids_tpu_torch.columnar.dtypes import STRING, DataType, \
    common_type, device_dtype
from spark_rapids_tpu_torch.exprs.base import ColVal, EvalContext, \
    Expression, align_chars
from spark_rapids_tpu_torch.exprs.cast import cast_to


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
        return self.with_children([cast_to(c, target)
                                   for c in self.children])

    def emit(self, ctx: EvalContext) -> ColVal:
        acc = self.children[0].emit(ctx)
        for c in self.children[1:]:
            acc = _merge_colval(acc, c.emit(ctx))
        return acc


class NullOf(Expression):
    """A NULL whose type follows its sibling expression: the SQL front
    end's untyped NULL (``CASE ... ELSE NULL``, ``coalesce(x, NULL)``)
    takes the sibling's type at binding.  Its planes come from that type
    alone; the sibling is not evaluated."""

    def __init__(self, sibling: Expression):
        self.children = (sibling,)

    @property
    def dtype(self) -> DataType:
        return self.children[0].dtype

    @property
    def nullable(self) -> bool:
        return True

    @property
    def name(self) -> str:
        return "NULL"

    def emit(self, ctx: EvalContext) -> ColVal:
        cap, dev = ctx.capacity, ctx.device
        valid = torch.zeros(cap, dtype=torch.bool, device=dev)
        data = torch.zeros(cap, dtype=device_dtype(self.dtype), device=dev)
        chars = torch.zeros((cap, 8), dtype=torch.uint8, device=dev) \
            if self.dtype == STRING else None
        return ColVal(data, valid, chars)
