"""Conditional expressions: ``If`` and ``CaseWhen``.

Counterpart of ``spark_rapids_tpu/exprs/conditional.py``.  A null
condition counts as false, so it selects the next branch.  The branches'
values widen to their common numeric type (``when(c, 1).otherwise(0)``
stays INT32, ``when(c, col("volume")).otherwise(0.0)`` is DOUBLE), and a
string result selects whole rows of the char matrix.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from spark_rapids_tpu_torch.columnar.dtypes import DataType, common_type
from spark_rapids_tpu_torch.exprs.base import ColVal, EvalContext, \
    Expression, Literal, align_chars
from spark_rapids_tpu_torch.exprs.cast import cast_to


def _select(pred_true: torch.Tensor, a: ColVal, b: ColVal) -> ColVal:
    """``a`` where ``pred_true``, else ``b``, validity included."""
    chars = None
    if a.chars is not None:
        ac, bc = align_chars(a.chars, b.chars)
        chars = torch.where(pred_true[:, None], ac, bc)
    return ColVal(torch.where(pred_true, a.data, b.data),
                  torch.where(pred_true, a.validity, b.validity), chars)


class If(Expression):
    """if(pred, a, b); a null predicate selects ``b``."""

    def __init__(self, pred: Expression, left: Expression,
                 right: Expression):
        self.children = (pred, left, right)

    @property
    def dtype(self) -> DataType:
        return self.children[1].dtype

    @property
    def name(self) -> str:
        p, a, b = self.children
        return f"if({p.name}, {a.name}, {b.name})"

    def coerce(self) -> Expression:
        p, a, b = self.children
        if a.dtype == b.dtype:
            return self
        ct = common_type(a.dtype, b.dtype)
        if ct is None:
            raise TypeError(f"if branches differ: {a.dtype} vs {b.dtype}")
        return self.with_children([p, cast_to(a, ct), cast_to(b, ct)])

    def emit(self, ctx: EvalContext) -> ColVal:
        p = self.children[0].emit(ctx)
        a = self.children[1].emit(ctx)
        b = self.children[2].emit(ctx)
        return _select(p.validity & p.data, a, b)


class CaseWhen(Expression):
    """CASE WHEN c1 THEN v1 ... [ELSE e] END, evaluated as a right fold of
    selects; without an ELSE, rows no branch takes are null.  Children
    are flat: (c1, v1, c2, v2, ..., [e])."""

    def __init__(self, branches: Sequence[Tuple[Expression, Expression]],
                 else_value: Optional[Expression] = None):
        self.n_branches = len(branches)
        flat: List[Expression] = []
        for cond, val in branches:
            flat.extend((cond, val))
        self.has_else = else_value is not None
        if else_value is not None:
            flat.append(else_value)
        self.children = tuple(flat)

    def _branches(self):
        return [(self.children[2 * i], self.children[2 * i + 1])
                for i in range(self.n_branches)]

    def _else(self) -> Optional[Expression]:
        return self.children[-1] if self.has_else else None

    @property
    def dtype(self) -> DataType:
        return self.children[1].dtype

    @property
    def nullable(self) -> bool:
        if not self.has_else:
            return True
        return any(v.nullable for _, v in self._branches()) or \
            self._else().nullable

    @property
    def name(self) -> str:
        parts = [f"WHEN {c.name} THEN {v.name}" for c, v in self._branches()]
        if self.has_else:
            parts.append(f"ELSE {self._else().name}")
        return "CASE " + " ".join(parts) + " END"

    def key(self) -> str:
        args = ",".join(c.key() for c in self.children)
        return f"CaseWhen[{self.n_branches},{self.has_else}]({args})"

    def with_children(self, children):
        new = object.__new__(CaseWhen)
        new.n_branches = self.n_branches
        new.has_else = self.has_else
        new.children = tuple(children)
        return new

    def coerce(self) -> Expression:
        values = [v for _, v in self._branches()]
        if self.has_else:
            values.append(self._else())
        target = values[0].dtype
        for v in values[1:]:
            if v.dtype != target:
                ct = common_type(target, v.dtype)
                if ct is None:
                    raise TypeError("case branch type mismatch: "
                                    f"{target} vs {v.dtype}")
                target = ct
        children = list(self.children)
        value_slots = [2 * i + 1 for i in range(self.n_branches)]
        if self.has_else:
            value_slots.append(len(children) - 1)
        for i in value_slots:
            children[i] = cast_to(children[i], target)
        return self.with_children(children)

    def emit(self, ctx: EvalContext) -> ColVal:
        acc = self._else().emit(ctx) if self.has_else \
            else Literal(None, self.dtype).emit(ctx)
        for cond, val in reversed(self._branches()):
            p = cond.emit(ctx)
            acc = _select(p.validity & p.data, val.emit(ctx), acc)
        return acc
