"""Math expressions.

Counterpart of ``spark_rapids_tpu/exprs/math.py``: the unary DOUBLE
functions (a non-DOUBLE input is cast), ``Signum``, ``Floor`` and
``Ceil`` (LONG for a floating input, null where it is not finite),
``Pow`` and ``Atan2``.  The semantics are java.lang.Math's (log(0) is
-Inf, log(-1) and sqrt(-1) NaN), which torch's functions share; their
last bits may differ from XLA's CPU routines for the transcendental
ones (sqrt, floor, ceil and abs are exact in both).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar.dtypes import DataType, FLOAT64, INT64
from spark_rapids_tpu_torch.exprs.base import ColVal, EvalContext, \
    Expression, fixed
from spark_rapids_tpu_torch.exprs.cast import cast_to


class UnaryMath(Expression):
    """DOUBLE -> DOUBLE."""
    fn = None
    fname = "?"

    def __init__(self, child: Expression):
        self.children = (child,)

    @property
    def dtype(self) -> DataType:
        return FLOAT64

    @property
    def name(self) -> str:
        return f"{self.fname}({self.children[0].name})"

    def coerce(self) -> Expression:
        return self.with_children([cast_to(self.children[0], FLOAT64)])

    def emit(self, ctx: EvalContext) -> ColVal:
        c = self.children[0].emit(ctx)
        return fixed(type(self).fn(c.data), c.validity)


def _unary(name, fn):
    return type(name, (UnaryMath,), {"fn": staticmethod(fn),
                                     "fname": name.lower()})


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root.  The card's f64 sqrt is IEEE
    exact; PyTorch's CPU build computes it through a vector math library
    that is one ulp off for about 0.7 % of doubles, so a CPU tensor goes
    through numpy's (exact) instead."""
    if x.device.type == "cpu":
        with np.errstate(invalid="ignore"):
            return torch.from_numpy(np.sqrt(x.numpy()))
    return torch.sqrt(x)


def _cbrt(x):
    # a real cube root for negative inputs too
    return torch.sign(x) * torch.pow(torch.abs(x), 1.0 / 3.0)


Sqrt = _unary("Sqrt", _sqrt)
Cbrt = _unary("Cbrt", _cbrt)
Exp = _unary("Exp", torch.exp)
Expm1 = _unary("Expm1", torch.expm1)
Log = _unary("Log", torch.log)
Log2 = _unary("Log2", torch.log2)
Log10 = _unary("Log10", torch.log10)
Log1p = _unary("Log1p", torch.log1p)
Sin = _unary("Sin", torch.sin)
Cos = _unary("Cos", torch.cos)
Tan = _unary("Tan", torch.tan)
Asin = _unary("Asin", torch.asin)
Acos = _unary("Acos", torch.acos)
Atan = _unary("Atan", torch.atan)
Sinh = _unary("Sinh", torch.sinh)
Cosh = _unary("Cosh", torch.cosh)
Tanh = _unary("Tanh", torch.tanh)
Rint = _unary("Rint", torch.round)  # half to even, as rint
ToDegrees = _unary("ToDegrees", lambda x: x * (180.0 / math.pi))
ToRadians = _unary("ToRadians", lambda x: x * (math.pi / 180.0))


def _signum(x):
    # NaN keeps NaN, as jnp.sign (torch.sign gives 0)
    return torch.where(torch.isnan(x), x, torch.sign(x))


class Signum(UnaryMath):
    fname = "signum"
    fn = staticmethod(_signum)


def _round_to_long(c: ColVal, round_fn) -> ColVal:
    """floor/ceil of a double as LONG; a non-finite input is null."""
    finite = torch.isfinite(c.data)
    safe = torch.where(finite, c.data, torch.zeros_like(c.data))
    return fixed(round_fn(safe).to(torch.int64), c.validity & finite)


class Floor(Expression):
    """floor: LONG for a floating input, the input itself otherwise."""
    fname = "floor"
    round_fn = staticmethod(torch.floor)

    def __init__(self, child: Expression):
        self.children = (child,)

    @property
    def dtype(self) -> DataType:
        t = self.children[0].dtype
        return INT64 if t.is_floating else t

    @property
    def name(self) -> str:
        return f"{self.fname}({self.children[0].name})"

    def emit(self, ctx: EvalContext) -> ColVal:
        c = self.children[0].emit(ctx)
        if self.children[0].dtype.is_floating:
            return _round_to_long(c, type(self).round_fn)
        return c


class Ceil(Floor):
    fname = "ceil"
    round_fn = staticmethod(torch.ceil)


class _BinaryMath(Expression):
    fname = "?"

    def __init__(self, left: Expression, right: Expression):
        self.children = (left, right)

    @property
    def dtype(self) -> DataType:
        return FLOAT64

    @property
    def name(self) -> str:
        return (f"{self.fname}({self.children[0].name}, "
                f"{self.children[1].name})")

    def coerce(self) -> Expression:
        return self.with_children([cast_to(c, FLOAT64)
                                   for c in self.children])

    def emit(self, ctx: EvalContext) -> ColVal:
        a = self.children[0].emit(ctx)
        b = self.children[1].emit(ctx)
        return fixed(self.fn(a.data, b.data), a.validity & b.validity)


class Pow(_BinaryMath):
    fname = "pow"

    @staticmethod
    def fn(a, b):
        return torch.pow(a, b)


class Atan2(_BinaryMath):
    fname = "atan2"

    @staticmethod
    def fn(a, b):
        return torch.atan2(a, b)
