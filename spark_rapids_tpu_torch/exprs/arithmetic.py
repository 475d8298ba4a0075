"""Arithmetic expressions with Spark null semantics.

Counterpart of ``spark_rapids_tpu/exprs/arithmetic.py`` (Add, Subtract,
Multiply, Divide, IntegralDivide, Remainder, Pmod, UnaryMinus, Abs): any
null operand gives null; x / 0, x div 0, x % 0 and pmod(x, 0) give
null.  Integral overflow wraps (non-ANSI Spark), as
torch integer arithmetic does.
"""

from __future__ import annotations

import torch

from spark_rapids_tpu_torch.columnar.dtypes import DataType, FLOAT64, \
    INT64, STRING, common_type
from spark_rapids_tpu_torch.exprs.base import ColVal, EvalContext, \
    Expression, fixed
from spark_rapids_tpu_torch.exprs.cast import cast_to


class BinaryArithmetic(Expression):
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
        return self.left.dtype

    @property
    def name(self) -> str:
        return f"({self.left.name} {self.symbol} {self.right.name})"

    def coerce(self) -> Expression:
        """Insert casts for numeric widening (findTightestCommonType)."""
        lt, rt = self.left.dtype, self.right.dtype
        if STRING in (lt, rt):
            raise NotImplementedError(
                f"{type(self).__name__} over strings is not in the torch "
                "port yet")
        if lt == rt:
            return self
        ct = common_type(lt, rt)
        if ct is None:
            raise TypeError(f"cannot apply {type(self).__name__} to "
                            f"{lt.name} and {rt.name}")
        left, right = cast_to(self.left, ct), cast_to(self.right, ct)
        return self.with_children([left, right])

    def emit(self, ctx: EvalContext) -> ColVal:
        a = self.left.emit(ctx)
        b = self.right.emit(ctx)
        return self.emit_binary(a, b)

    def emit_binary(self, a: ColVal, b: ColVal) -> ColVal:
        raise NotImplementedError


class Add(BinaryArithmetic):
    symbol = "+"

    def emit_binary(self, a, b):
        return fixed(a.data + b.data, a.validity & b.validity)


class Subtract(BinaryArithmetic):
    symbol = "-"

    def emit_binary(self, a, b):
        return fixed(a.data - b.data, a.validity & b.validity)


class Multiply(BinaryArithmetic):
    symbol = "*"

    def emit_binary(self, a, b):
        return fixed(a.data * b.data, a.validity & b.validity)


class Divide(BinaryArithmetic):
    """True division: DOUBLE output, x / 0 -> null."""
    symbol = "/"

    @property
    def dtype(self) -> DataType:
        return FLOAT64

    @property
    def nullable(self) -> bool:
        return True  # x / 0

    def coerce(self) -> Expression:
        return self.with_children(
            [cast_to(c, FLOAT64) for c in self.children])

    def emit_binary(self, a, b):
        zero = b.data == 0
        denom = torch.where(zero, torch.ones_like(b.data), b.data)
        return fixed(a.data / denom, a.validity & b.validity & ~zero)


class Remainder(BinaryArithmetic):
    """``%`` with Java semantics: the sign follows the dividend; x % 0 is
    null."""
    symbol = "%"

    @property
    def nullable(self) -> bool:
        return True  # x % 0

    def emit_binary(self, a, b):
        zero = b.data == 0
        # x % -1 is 0 like x % 1, which spares the integer division of
        # the type's minimum by -1 (a trap on the CPU)
        one = (b.data == -1) | zero
        denom = torch.where(one, torch.ones_like(b.data), b.data)
        return fixed(torch.fmod(a.data, denom), a.validity & b.validity
                     & ~zero)


def _trunc_div(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Integer division toward zero, with b == -1 taken as negation (the
    minimum divided by -1 wraps, as on the JVM, instead of trapping)."""
    neg_one = b == -1
    safe = torch.where(neg_one, torch.ones_like(b), b)
    return torch.where(neg_one, -a, torch.div(a, safe, rounding_mode="trunc"))


class IntegralDivide(BinaryArithmetic):
    """``div``: LONG, toward zero; x div 0 is null."""
    symbol = "div"

    @property
    def dtype(self) -> DataType:
        return INT64

    @property
    def nullable(self) -> bool:
        return True  # x div 0

    def coerce(self) -> Expression:
        return self.with_children([cast_to(c, INT64) for c in self.children])

    def emit_binary(self, a, b):
        zero = b.data == 0
        denom = torch.where(zero, torch.ones_like(b.data), b.data)
        return fixed(_trunc_div(a.data, denom),
                     a.validity & b.validity & ~zero)


class Pmod(BinaryArithmetic):
    """Positive modulo, as Spark: r = a % n (the dividend's sign); if
    r < 0 then (r + n) % n, so a negative n can still give a negative
    result (pmod(-10, -3) = -1).  pmod(x, 0) is null."""
    symbol = "pmod"

    @property
    def nullable(self) -> bool:
        return True

    def emit_binary(self, a, b):
        zero = b.data == 0
        n = torch.where(zero, torch.ones_like(b.data), b.data)
        if self.dtype.is_floating:
            r = torch.fmod(a.data, n)
            r = torch.where(r < 0, torch.fmod(r + n, n), r)
        else:
            r = a.data - n * _trunc_div(a.data, n)
            rn = r + n
            r = torch.where(r < 0, rn - n * _trunc_div(rn, n), r)
        return fixed(r, a.validity & b.validity & ~zero)


class Abs(Expression):
    def __init__(self, child: Expression):
        self.children = (child,)

    @property
    def dtype(self) -> DataType:
        return self.children[0].dtype

    @property
    def name(self) -> str:
        return f"abs({self.children[0].name})"

    def emit(self, ctx: EvalContext) -> ColVal:
        c = self.children[0].emit(ctx)
        return fixed(torch.abs(c.data), c.validity)


class UnaryMinus(Expression):
    def __init__(self, child: Expression):
        self.children = (child,)

    @property
    def dtype(self) -> DataType:
        return self.children[0].dtype

    @property
    def name(self) -> str:
        return f"(- {self.children[0].name})"

    def emit(self, ctx: EvalContext) -> ColVal:
        c = self.children[0].emit(ctx)
        return fixed(-c.data, c.validity)
