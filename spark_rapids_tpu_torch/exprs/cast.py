"""Casts between fixed-width numeric types.

Counterpart of ``spark_rapids_tpu/exprs/cast.py:_cast_fixed``, trimmed to
what coercion and the aggregate input projections need: numeric <->
numeric and boolean.  Float -> integral truncates toward zero and
saturates like the JVM's d2l/d2i (Spark non-ANSI), with NaN -> null;
integral narrowing wraps.
"""

from __future__ import annotations

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar.dtypes import BOOLEAN, DataType, \
    device_dtype
from spark_rapids_tpu_torch.exprs.base import ColVal, EvalContext, \
    Expression, fixed


def _check_supported(frm: DataType, to: DataType) -> None:
    """Raises on a cast the port lacks (string parsing among them)."""
    if frm != to and not ((frm.is_numeric or frm == BOOLEAN)
                          and (to.is_numeric or to == BOOLEAN)):
        raise NotImplementedError(f"cast {frm.name} -> {to.name}: later slice")


def cast_to(child: Expression, target: DataType) -> Expression:
    """``child`` as ``target``; raises when the plan is built on a cast the
    port lacks, so an implicit cast can never reinterpret a column."""
    if child.dtype == target:
        return child
    _check_supported(child.dtype, target)
    return Cast(child, target)


class Cast(Expression):
    def __init__(self, child: Expression, to: DataType):
        self.children = (child,)
        self.to = to

    @property
    def dtype(self) -> DataType:
        return self.to

    @property
    def name(self) -> str:
        return f"cast({self.children[0].name} as {self.to.name})"

    def key(self) -> str:
        return f"cast[{self.to.name},ansi=False]({self.children[0].key()})"

    def with_children(self, children):
        return Cast(children[0], self.to)

    def coerce(self) -> Expression:
        _check_supported(self.children[0].dtype, self.to)
        return self

    def emit(self, ctx: EvalContext) -> ColVal:
        frm, to = self.children[0].dtype, self.to
        _check_supported(frm, to)
        src = self.children[0].emit(ctx)
        if frm == to:
            return src
        data, valid = src.data, src.validity
        if to == BOOLEAN:
            out = data != 0
        elif frm.is_floating and to.is_integral:
            finite = torch.isfinite(data)
            valid = valid & finite
            info = np.iinfo(to.numpy_dtype)
            t = torch.trunc(torch.where(finite, data, torch.zeros_like(data)))
            t = t.to(torch.float64).clamp(float(info.min), float(info.max))
            out = t.to(device_dtype(to))
            # float64 cannot hold INT64_MAX: the clamp rounds it to 2^63,
            # which the conversion would wrap; pin the boundaries
            out = torch.where(t >= float(info.max),
                              torch.full_like(out, info.max), out)
            out = torch.where(t <= float(info.min),
                              torch.full_like(out, info.min), out)
        else:
            out = data.to(device_dtype(to))
        return fixed(out, valid)
