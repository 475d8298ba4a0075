"""Column functions: ``col``, ``lit`` and the aggregates of this slice.

Counterpart of ``spark_rapids_tpu/functions.py``.
"""

from __future__ import annotations

from spark_rapids_tpu_torch.api import Column, _expr_or_name, col, lit
from spark_rapids_tpu_torch.exprs import aggregates as ag
from spark_rapids_tpu_torch.exprs.base import Literal

__all__ = ["col", "lit", "count", "sum", "min", "max", "avg"]


def count(c) -> Column:
    # `c == "*"` on a Column builds an expression, so test for str first
    e = Literal(1) if isinstance(c, str) and c == "*" else _expr_or_name(c)
    return Column(ag.Count(e))


def sum(c) -> Column:  # noqa: A001 - mirrors pyspark naming
    return Column(ag.Sum(_expr_or_name(c)))


def min(c) -> Column:  # noqa: A001
    return Column(ag.Min(_expr_or_name(c)))


def max(c) -> Column:  # noqa: A001
    return Column(ag.Max(_expr_or_name(c)))


def avg(c) -> Column:
    return Column(ag.Average(_expr_or_name(c)))

