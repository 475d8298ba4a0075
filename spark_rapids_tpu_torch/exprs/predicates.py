"""Comparison and boolean predicates.

Counterpart of ``spark_rapids_tpu/exprs/predicates.py``.  AND/OR follow
Kleene three-valued logic on the (data, validity) pair: ``false AND
null = false``, ``true OR null = true``.  Float comparisons follow Spark:
NaN = NaN is true and NaN is greater than every other value.  Strings
compare by their UTF-8 bytes (``string_compare``).  ``EqualNullSafe``
(``<=>``), ``IsNull`` and ``IsNotNull`` are never null; ``IsNaN`` is
null on a null input; ``In`` tests a list of literals.
"""

from __future__ import annotations

from typing import Sequence

import torch

from spark_rapids_tpu_torch.columnar.dtypes import BOOLEAN, STRING, \
    DataType, common_type, device_dtype
from spark_rapids_tpu_torch.exprs.base import ColVal, EvalContext, \
    Expression, Literal, align_chars, fixed
from spark_rapids_tpu_torch.exprs.cast import cast_to


def string_compare(a: ColVal, b: ColVal) -> torch.Tensor:
    """Per-row lexicographic compare of two string ColVals -> int32 in
    {-1, 0, 1}.  Bytes past a string's length count as -1, so a shorter
    string sorts before any extension of it and NUL bytes inside a string
    still compare as bytes."""
    ac, bc = align_chars(a.chars, b.chars)
    pos = torch.arange(ac.shape[1], device=ac.device)[None, :]
    av = torch.where(pos < a.data[:, None], ac.to(torch.int16), -1)
    bv = torch.where(pos < b.data[:, None], bc.to(torch.int16), -1)
    neq = av != bv
    # argmax returns the first of equal maxima: the first differing byte
    first = torch.argmax(neq.to(torch.uint8), dim=1, keepdim=True)
    d = (av.gather(1, first) - bv.gather(1, first))[:, 0]
    return torch.where(neq.any(dim=1), torch.sign(d),
                       torch.zeros_like(d)).to(torch.int32)


class BinaryComparison(Expression):
    symbol = "?"

    def __init__(self, left: Expression, right: Expression):
        self.children = (left, right)

    @property
    def left(self):
        return self.children[0]

    @property
    def right(self):
        return self.children[1]

    @property
    def dtype(self) -> DataType:
        return BOOLEAN

    @property
    def name(self) -> str:
        return f"({self.left.name} {self.symbol} {self.right.name})"

    def coerce(self) -> Expression:
        lt, rt = self.left.dtype, self.right.dtype
        if lt == rt:
            return self
        ct = common_type(lt, rt)
        if ct is None:
            raise TypeError(f"cannot compare {lt.name} and {rt.name}")
        left, right = cast_to(self.left, ct), cast_to(self.right, ct)
        return self.with_children([left, right])

    def emit(self, ctx: EvalContext) -> ColVal:
        a = self.left.emit(ctx)
        b = self.right.emit(ctx)
        valid = a.validity & b.validity
        if self.left.dtype == STRING:
            return fixed(self.compare_op(string_compare(a, b), 0), valid)
        if self.left.dtype.is_floating:
            # Spark's total order: derive (a < b, a == b) with NaN greatest
            an, bn = torch.isnan(a.data), torch.isnan(b.data)
            lt = ~an & (bn | (a.data < b.data))
            eq = (an & bn) | (~an & ~bn & (a.data == b.data))
            return fixed(self.from_total_order(lt, eq), valid)
        return fixed(self.compare_op(a.data, b.data), valid)

    def compare_op(self, a, b):
        raise NotImplementedError

    def from_total_order(self, lt, eq):
        raise NotImplementedError


class EqualTo(BinaryComparison):
    symbol = "="

    def compare_op(self, a, b):
        return a == b

    def from_total_order(self, lt, eq):
        return eq


class NotEqual(BinaryComparison):
    symbol = "!="

    def compare_op(self, a, b):
        return a != b

    def from_total_order(self, lt, eq):
        return ~eq


class LessThan(BinaryComparison):
    symbol = "<"

    def compare_op(self, a, b):
        return a < b

    def from_total_order(self, lt, eq):
        return lt


class LessThanOrEqual(BinaryComparison):
    symbol = "<="

    def compare_op(self, a, b):
        return a <= b

    def from_total_order(self, lt, eq):
        return lt | eq


class GreaterThan(BinaryComparison):
    symbol = ">"

    def compare_op(self, a, b):
        return a > b

    def from_total_order(self, lt, eq):
        return ~(lt | eq)


class GreaterThanOrEqual(BinaryComparison):
    symbol = ">="

    def compare_op(self, a, b):
        return a >= b

    def from_total_order(self, lt, eq):
        return ~lt


class EqualNullSafe(BinaryComparison):
    """``<=>``: null <=> null is true, null <=> x false; never null."""
    symbol = "<=>"

    @property
    def nullable(self) -> bool:
        return False

    def emit(self, ctx: EvalContext) -> ColVal:
        a = self.left.emit(ctx)
        b = self.right.emit(ctx)
        if self.left.dtype == STRING:
            eq = string_compare(a, b) == 0
        elif self.left.dtype.is_floating:
            an, bn = torch.isnan(a.data), torch.isnan(b.data)
            eq = (an & bn) | (~an & ~bn & (a.data == b.data))
        else:
            eq = a.data == b.data
        out = torch.where(a.validity & b.validity, eq,
                          ~a.validity & ~b.validity)
        return fixed(out, torch.ones_like(out))


class And(Expression):
    """Kleene AND."""

    def __init__(self, left: Expression, right: Expression):
        self.children = (left, right)

    @property
    def dtype(self) -> DataType:
        return BOOLEAN

    @property
    def name(self) -> str:
        return f"({self.children[0].name} AND {self.children[1].name})"

    def emit(self, ctx):
        a = self.children[0].emit(ctx)
        b = self.children[1].emit(ctx)
        known_false = (a.validity & ~a.data) | (b.validity & ~b.data)
        valid = (a.validity & b.validity) | known_false
        return fixed(~known_false & a.data & b.data, valid)


class Or(Expression):
    """Kleene OR."""

    def __init__(self, left: Expression, right: Expression):
        self.children = (left, right)

    @property
    def dtype(self) -> DataType:
        return BOOLEAN

    @property
    def name(self) -> str:
        return f"({self.children[0].name} OR {self.children[1].name})"

    def emit(self, ctx):
        a = self.children[0].emit(ctx)
        b = self.children[1].emit(ctx)
        known_true = (a.validity & a.data) | (b.validity & b.data)
        valid = (a.validity & b.validity) | known_true
        return fixed(known_true | a.data | b.data, valid)


class Not(Expression):
    def __init__(self, child: Expression):
        self.children = (child,)

    @property
    def dtype(self) -> DataType:
        return BOOLEAN

    @property
    def name(self) -> str:
        return f"(NOT {self.children[0].name})"

    def emit(self, ctx):
        c = self.children[0].emit(ctx)
        return fixed(~c.data, c.validity)


class IsNull(Expression):
    def __init__(self, child: Expression):
        self.children = (child,)

    @property
    def dtype(self) -> DataType:
        return BOOLEAN

    @property
    def nullable(self) -> bool:
        return False

    @property
    def name(self) -> str:
        return f"({self.children[0].name} IS NULL)"

    def emit(self, ctx):
        c = self.children[0].emit(ctx)
        return fixed(~c.validity, torch.ones_like(c.validity))


class IsNotNull(Expression):
    def __init__(self, child: Expression):
        self.children = (child,)

    @property
    def dtype(self) -> DataType:
        return BOOLEAN

    @property
    def nullable(self) -> bool:
        return False

    @property
    def name(self) -> str:
        return f"({self.children[0].name} IS NOT NULL)"

    def emit(self, ctx):
        c = self.children[0].emit(ctx)
        return fixed(c.validity, torch.ones_like(c.validity))


class IsNaN(Expression):
    def __init__(self, child: Expression):
        self.children = (child,)

    @property
    def dtype(self) -> DataType:
        return BOOLEAN

    @property
    def name(self) -> str:
        return f"isnan({self.children[0].name})"

    def emit(self, ctx: EvalContext) -> ColVal:
        c = self.children[0].emit(ctx)
        if not self.children[0].dtype.is_floating:
            return fixed(torch.zeros_like(c.validity), c.validity)
        return fixed(torch.isnan(c.data), c.validity)


class In(Expression):
    """value IN (literal, ...).  A null value gives null; a null in the
    list gives null where nothing matched (true where something did).
    A number in the list takes the value's type first, as the JAX
    package converts it; a string compares by its bytes."""

    def __init__(self, child: Expression, values: Sequence):
        self.children = (child,)
        self.values = tuple(values)

    @property
    def dtype(self) -> DataType:
        return BOOLEAN

    @property
    def name(self) -> str:
        return f"({self.children[0].name} IN {self.values!r})"

    def key(self) -> str:
        return f"in_set[{self.values!r}]({self.children[0].key()})"

    def with_children(self, children):
        return In(children[0], self.values)

    def emit(self, ctx):
        c = self.children[0].emit(ctx)
        child_t = self.children[0].dtype
        hit = torch.zeros(ctx.capacity, dtype=torch.bool, device=ctx.device)
        for v in self.values:
            if v is None:
                continue  # never matches; decides the validity below
            if child_t == STRING:
                hit = hit | (string_compare(c, Literal(v).emit(ctx)) == 0)
            else:
                hit = hit | (c.data == torch.tensor(
                    v, dtype=device_dtype(child_t), device=ctx.device))
        valid = c.validity
        if any(v is None for v in self.values):
            valid = valid & hit
        return fixed(hit, valid)
