"""Null-handling expressions.

Counterpart of ``spark_rapids_tpu/exprs/nullexprs.py``: ``Coalesce``
(``functions.coalesce``, and the full outer USING join's key column),
``NaNvl``, ``AtLeastNNonNulls`` (a NaN counts as null) and ``NullOf``
(SQL's untyped ``NULL``).
"""

from __future__ import annotations

import torch

from spark_rapids_tpu_torch.columnar.dtypes import BOOLEAN, STRING, \
    DataType, common_type, device_dtype
from spark_rapids_tpu_torch.exprs.base import ColVal, EvalContext, \
    Expression, align_chars, fixed
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


class NaNvl(Expression):
    """nanvl(a, b): a unless a is NaN, then b."""

    def __init__(self, left: Expression, right: Expression):
        self.children = (left, right)

    @property
    def dtype(self) -> DataType:
        return self.children[0].dtype

    @property
    def name(self) -> str:
        return f"nanvl({self.children[0].name}, {self.children[1].name})"

    def coerce(self) -> Expression:
        t = self.children[0].dtype
        return self.with_children([self.children[0],
                                   cast_to(self.children[1], t)])

    def emit(self, ctx: EvalContext) -> ColVal:
        a = self.children[0].emit(ctx)
        b = self.children[1].emit(ctx)
        use_b = a.validity & torch.isnan(a.data)
        return fixed(torch.where(use_b, b.data, a.data),
                     torch.where(use_b, b.validity, a.validity))


class AtLeastNNonNulls(Expression):
    """Whether at least ``n`` of the children are neither null nor NaN
    (``df.na.drop``); never null."""

    def __init__(self, n: int, *children: Expression):
        self.n = n
        self.children = tuple(children)

    @property
    def dtype(self) -> DataType:
        return BOOLEAN

    @property
    def nullable(self) -> bool:
        return False

    @property
    def name(self) -> str:
        return (f"atleastnnonnulls({self.n}, "
                + ", ".join(c.name for c in self.children) + ")")

    def key(self) -> str:
        args = ",".join(c.key() for c in self.children)
        return f"AtLeastNNonNulls[{self.n}]({args})"

    def with_children(self, children):
        return AtLeastNNonNulls(self.n, *children)

    def emit(self, ctx: EvalContext) -> ColVal:
        count = torch.zeros(ctx.capacity, dtype=torch.int32,
                            device=ctx.device)
        for c in self.children:
            v = c.emit(ctx)
            ok = v.validity
            if c.dtype.is_floating:
                ok = ok & ~torch.isnan(v.data)
            count = count + ok.to(torch.int32)
        return fixed(count >= self.n, torch.ones_like(count, dtype=torch.bool))
