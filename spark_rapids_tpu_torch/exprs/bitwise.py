"""Bitwise expressions.

Counterpart of ``spark_rapids_tpu/exprs/bitwise.py``: ``&``, ``|``, ``^``
and ``~`` over integers, and the shifts.  A shift amount is cast to the
value's type and masked to its width (``bits - 1``), as Java's ``<<`` and
``>>`` do; ``>>>`` shifts in zeros, as the JAX package's cast to
``uint{bits}`` does, built here from signed ops because CUDA torch has no
unsigned shift of 16 to 64 bits.  Any null operand gives null.  As in the
JAX package, neither ``functions`` nor ``sql.py`` reaches them: a query
builds them as ``Column(ShiftLeft(...))``; every planner takes them, as
it takes every expression class.
"""

from __future__ import annotations

import torch

from spark_rapids_tpu_torch.columnar.dtypes import DataType
from spark_rapids_tpu_torch.exprs.arithmetic import BinaryArithmetic
from spark_rapids_tpu_torch.exprs.base import ColVal, Expression, fixed


class BitwiseAnd(BinaryArithmetic):
    symbol = "&"

    def emit_binary(self, a, b):
        return fixed(a.data & b.data, a.validity & b.validity)


class BitwiseOr(BinaryArithmetic):
    symbol = "|"

    def emit_binary(self, a, b):
        return fixed(a.data | b.data, a.validity & b.validity)


class BitwiseXor(BinaryArithmetic):
    symbol = "^"

    def emit_binary(self, a, b):
        return fixed(a.data ^ b.data, a.validity & b.validity)


class BitwiseNot(Expression):
    def __init__(self, child: Expression):
        self.children = (child,)

    @property
    def dtype(self) -> DataType:
        return self.children[0].dtype

    @property
    def name(self) -> str:
        return f"~{self.children[0].name}"

    def emit(self, ctx) -> ColVal:
        c = self.children[0].emit(ctx)
        return fixed(~c.data, c.validity)


def _bits(x: torch.Tensor) -> int:
    return x.element_size() * 8


class ShiftLeft(Expression):
    """``shiftleft(value, amount)``; the amount is masked to the value's
    width."""

    fname = "shiftleft"

    def __init__(self, left: Expression, right: Expression):
        self.children = (left, right)

    @property
    def dtype(self) -> DataType:
        return self.children[0].dtype

    @property
    def name(self) -> str:
        return (f"{self.fname}({self.children[0].name}, "
                f"{self.children[1].name})")

    def emit(self, ctx) -> ColVal:
        a = self.children[0].emit(ctx)
        b = self.children[1].emit(ctx)
        sh = b.data.to(a.data.dtype) & (_bits(a.data) - 1)
        return fixed(self.shift(a.data, sh), a.validity & b.validity)

    def shift(self, x: torch.Tensor, sh: torch.Tensor) -> torch.Tensor:
        return x << sh


class ShiftRight(ShiftLeft):
    """``shiftright``: arithmetic, the sign bit shifted in."""

    fname = "shiftright"

    def shift(self, x, sh):
        return x >> sh


class ShiftRightUnsigned(ShiftLeft):
    """``shiftrightunsigned``: zeros shifted in.  An arithmetic shift by
    ``s > 0`` keeps its low ``bits - s`` bits, the logical shift's, and
    the mask clears the rest; ``(1 << (bits - s)) - 1`` wraps to the
    type's maximum at ``s = 1`` of a 64-bit value, which is the mask
    wanted."""

    fname = "shiftrightunsigned"

    def shift(self, x, sh):
        s = sh.to(torch.int64)
        mask = ((1 << (_bits(x) - s.clamp(min=1))) - 1).to(x.dtype)
        return torch.where(s == 0, x, (x >> sh) & mask)
