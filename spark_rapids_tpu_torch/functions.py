"""Column functions: ``col``, ``lit``, the aggregates of this slice and
``contains``.

Counterpart of ``spark_rapids_tpu/functions.py``.
"""

from __future__ import annotations

from spark_rapids_tpu_torch.api import Column, _expr_or_name, col, lit
from spark_rapids_tpu_torch.exprs import aggregates as ag
from spark_rapids_tpu_torch.exprs import pallas_strings as ps
from spark_rapids_tpu_torch.exprs import strings as ss
from spark_rapids_tpu_torch.exprs.base import Literal

__all__ = ["col", "lit", "count", "sum", "min", "max", "avg", "contains"]


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


def contains(c, substr) -> Column:
    """Substring predicate.  A literal needle of at least
    ``PALLAS_PATTERN_MIN`` bytes runs the contains kernel; anything else
    keeps the unrolled compare, as in the JAX package."""
    pe = (substr if isinstance(substr, Column) else lit(substr)).expr
    is_static, pb = ss._static_pattern(pe)
    if is_static and pb is not None and len(pb) >= ps.PALLAS_PATTERN_MIN:
        return Column(ps.PallasContains(_expr_or_name(c), pe))
    return Column(ss.Contains(_expr_or_name(c), pe))
