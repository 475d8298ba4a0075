"""Column functions: ``col``, ``lit``, ``when``, the aggregates, the date
parts, ``length``, ``substring``, ``contains``, ``isnull``, ``coalesce``
and the window functions.

Counterpart of ``spark_rapids_tpu/functions.py``.
"""

from __future__ import annotations

from spark_rapids_tpu_torch.api import Column, _expr_or_name, _to_expr, \
    col, lit, when
from spark_rapids_tpu_torch.exprs import aggregates as ag
from spark_rapids_tpu_torch.exprs import datetime as dte
from spark_rapids_tpu_torch.exprs import nullexprs as ne
from spark_rapids_tpu_torch.exprs import pallas_strings as ps
from spark_rapids_tpu_torch.exprs import predicates as pr
from spark_rapids_tpu_torch.exprs import strings as ss
from spark_rapids_tpu_torch.exprs import windows as wn
from spark_rapids_tpu_torch.exprs.base import Literal

__all__ = ["col", "lit", "when", "count", "sum", "min", "max", "avg",
           "first", "last", "isnull", "coalesce", "year", "month", "dayofmonth",
           "dayofweek", "dayofyear", "quarter", "date_add", "date_sub",
           "datediff", "last_day", "length", "substring", "contains",
           "row_number", "rank", "dense_rank", "lag", "lead"]


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


def first(c, ignore_nulls: bool = True) -> Column:
    """Declared for the API; the port's execs do not evaluate it yet."""
    return Column(ag.First(_expr_or_name(c), ignore_nulls))


def last(c, ignore_nulls: bool = True) -> Column:
    """Declared for the API; the port's execs do not evaluate it yet."""
    return Column(ag.Last(_expr_or_name(c), ignore_nulls))


def isnull(c) -> Column:
    return Column(pr.IsNull(_expr_or_name(c)))


def coalesce(*cols) -> Column:
    """The first non-null of ``cols``."""
    return Column(ne.Coalesce(*[_to_expr(c) for c in cols]))


# dates (DATE columns; the TIMESTAMP parts wait for TIMESTAMP columns)
def year(c) -> Column:
    return Column(dte.Year(_expr_or_name(c)))


def month(c) -> Column:
    return Column(dte.Month(_expr_or_name(c)))


def dayofmonth(c) -> Column:
    return Column(dte.DayOfMonth(_expr_or_name(c)))


def dayofweek(c) -> Column:
    return Column(dte.DayOfWeek(_expr_or_name(c)))


def dayofyear(c) -> Column:
    return Column(dte.DayOfYear(_expr_or_name(c)))


def quarter(c) -> Column:
    return Column(dte.Quarter(_expr_or_name(c)))


def date_add(c, days) -> Column:
    return Column(dte.DateAdd(_expr_or_name(c), _expr_or_name(days)))


def date_sub(c, days) -> Column:
    return Column(dte.DateSub(_expr_or_name(c), _expr_or_name(days)))


def datediff(end, start) -> Column:
    return Column(dte.DateDiff(_expr_or_name(end), _expr_or_name(start)))


def last_day(c) -> Column:
    return Column(dte.LastDay(_expr_or_name(c)))


# strings
def length(c) -> Column:
    return Column(ss.StringLength(_expr_or_name(c)))


def substring(c, pos, length=None) -> Column:
    """``pos`` and ``length`` must be literals: any other raises when the
    query is planned."""
    ln = None if length is None else _to_expr(length)
    return Column(ss.Substring(_expr_or_name(c), _to_expr(pos), ln))


def contains(c, substr) -> Column:
    """Substring predicate.  A literal needle of at least
    ``PALLAS_PATTERN_MIN`` bytes runs the contains kernel; anything else
    keeps the unrolled compare, as in the JAX package."""
    pe = (substr if isinstance(substr, Column) else lit(substr)).expr
    is_static, pb = ss._static_pattern(pe)
    if is_static and pb is not None and len(pb) >= ps.PALLAS_PATTERN_MIN:
        return Column(ps.PallasContains(_expr_or_name(c), pe))
    return Column(ss.Contains(_expr_or_name(c), pe))


# window functions: use them through .over(Window...)
def row_number() -> Column:
    return Column(wn.RowNumber())


def rank() -> Column:
    return Column(wn.Rank())


def dense_rank() -> Column:
    return Column(wn.DenseRank())


def lag(c, offset: int = 1, default=None) -> Column:
    d = None if default is None else Literal(default)
    return Column(wn.Lag(_expr_or_name(c), offset, d))


def lead(c, offset: int = 1, default=None) -> Column:
    d = None if default is None else Literal(default)
    return Column(wn.Lead(_expr_or_name(c), offset, d))
