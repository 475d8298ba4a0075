"""Declarative aggregate functions.

Counterpart of ``spark_rapids_tpu/exprs/aggregates.py`` (Count, Sum, Min,
Max, Average, First, Last).  Each function declares its
``input_projection``, one update op and one merge op per buffer slot
("sum" | "min" | "max" | "count" | "first" | "last", and "first_any" |
"last_any" for First and Last that keep nulls), the buffer types, and
``evaluate(bufs)``, the finalization over buffer ColVals.  Min, Max,
First and Last take strings too: their value buffers carry the chars.
"""

from __future__ import annotations

from typing import List

import torch

from spark_rapids_tpu_torch.columnar.dtypes import DataType, FLOAT64, INT64
from spark_rapids_tpu_torch.exprs.base import ColVal, Expression
from spark_rapids_tpu_torch.exprs.cast import cast_to


class AggregateFunction(Expression):
    def __init__(self, child: Expression):
        self.children = (child,)

    @property
    def child(self) -> Expression:
        return self.children[0]

    @property
    def name(self) -> str:
        return f"{type(self).__name__.lower()}({self.child.name})"

    def input_projection(self) -> List[Expression]:
        return [self.child]

    def update_ops(self) -> List[str]:
        raise NotImplementedError

    def merge_ops(self) -> List[str]:
        raise NotImplementedError

    def buffer_dtypes(self) -> List[DataType]:
        raise NotImplementedError

    def evaluate(self, bufs: List[ColVal]) -> ColVal:
        raise NotImplementedError

    def emit(self, ctx):
        raise RuntimeError(f"{type(self).__name__} must be evaluated by an "
                           "aggregate exec, not a projection")


class Count(AggregateFunction):
    """count(expr): the number of non-null values."""

    @property
    def dtype(self) -> DataType:
        return INT64

    @property
    def nullable(self) -> bool:
        return False

    def update_ops(self):
        return ["count"]

    def merge_ops(self):
        return ["sum"]

    def buffer_dtypes(self):
        return [INT64]

    def evaluate(self, bufs):
        return ColVal(bufs[0].data, torch.ones_like(bufs[0].validity))


class Sum(AggregateFunction):
    """Spark: sum of integral -> long; sum of fractional -> double."""

    @property
    def dtype(self) -> DataType:
        return FLOAT64 if self.child.dtype.is_floating else INT64

    def input_projection(self):
        return [cast_to(self.child, self.dtype)]

    def update_ops(self):
        return ["sum", "count"]

    def merge_ops(self):
        return ["sum", "sum"]

    def buffer_dtypes(self):
        return [self.dtype, INT64]

    def evaluate(self, bufs):
        s, c = bufs
        return ColVal(s.data, c.data > 0)


class _Extremum(AggregateFunction):
    @property
    def dtype(self) -> DataType:
        return self.child.dtype

    def buffer_dtypes(self):
        return [self.child.dtype, INT64]

    def evaluate(self, bufs):
        v, c = bufs
        return ColVal(v.data, c.data > 0, v.chars)


class Min(_Extremum):
    def update_ops(self):
        return ["min", "count"]

    def merge_ops(self):
        return ["min", "sum"]


class Max(_Extremum):
    def update_ops(self):
        return ["max", "count"]

    def merge_ops(self):
        return ["max", "sum"]


class Average(AggregateFunction):
    """avg = sum / count, finalized."""

    @property
    def dtype(self) -> DataType:
        return FLOAT64

    def input_projection(self):
        return [cast_to(self.child, FLOAT64)]

    def update_ops(self):
        return ["sum", "count"]

    def merge_ops(self):
        return ["sum", "sum"]

    def buffer_dtypes(self):
        return [FLOAT64, INT64]

    def evaluate(self, bufs):
        s, c = bufs
        nonzero = c.data > 0
        denom = torch.where(nonzero, c.data, torch.ones_like(c.data))
        return ColVal(s.data / denom.to(s.data.dtype), nonzero)


class First(AggregateFunction):
    """first(expr): the first value of each group in input order; with
    ``ignore_nulls`` (Spark's default here, as in the JAX package) the
    first non-null one, else the first row's, null or not."""

    def __init__(self, child: Expression, ignore_nulls: bool = True):
        super().__init__(child)
        self.ignore_nulls = ignore_nulls

    _op = "first"

    def key(self) -> str:
        name = type(self).__name__
        return f"{name}[{self.ignore_nulls}]({self.child.key()})"

    def with_children(self, children):
        return type(self)(children[0], self.ignore_nulls)

    @property
    def dtype(self) -> DataType:
        return self.child.dtype

    def _value_op(self) -> str:
        return self._op if self.ignore_nulls else self._op + "_any"

    def update_ops(self):
        return [self._value_op(), "count"]

    def merge_ops(self):
        return [self._value_op(), "sum"]

    def buffer_dtypes(self):
        return [self.child.dtype, INT64]

    def evaluate(self, bufs):
        v, c = bufs
        if self.ignore_nulls:
            return ColVal(v.data, c.data > 0, v.chars)
        return ColVal(v.data, v.validity, v.chars)


class Last(First):
    """last(expr): the last value of each group (non-null with
    ``ignore_nulls``)."""

    _op = "last"
