"""Column functions: ``col``, ``lit``, ``when``, the aggregates
(``first``/``last`` too), math (``pmod`` ... ``ceil``, ``abs``), null
and NaN tests, the date and time parts, the string functions (case,
trim, concat, locate, replace, substring_index, regexp_replace, rlike,
split_part, contains), the nondeterministic functions, the window
functions, ``grouping_id`` under rollup and cube, and the generators
(``array`` literals inside ``explode``, ``explode_outer``, ``posexplode``
and ``posexplode_outer``).

Counterpart of ``spark_rapids_tpu/functions.py``.  ``upper``, ``lower``,
``initcap`` and ``rand`` need ``spark.rapids.sql.incompatibleOps.enabled``
when the query is planned.
"""

from __future__ import annotations

from spark_rapids_tpu_torch.api import Column, _expr_or_name, _to_expr, \
    col, lit, when
from spark_rapids_tpu_torch.columnar.dtypes import from_name
from spark_rapids_tpu_torch.exprs import aggregates as ag
from spark_rapids_tpu_torch.exprs import arithmetic as ar
from spark_rapids_tpu_torch.exprs import datetime as dte
from spark_rapids_tpu_torch.exprs import generators as gn
from spark_rapids_tpu_torch.exprs import math as mt
from spark_rapids_tpu_torch.exprs import nondeterministic as nd
from spark_rapids_tpu_torch.exprs import nullexprs as ne
from spark_rapids_tpu_torch.exprs import pallas_strings as ps
from spark_rapids_tpu_torch.exprs import predicates as pr
from spark_rapids_tpu_torch.exprs import strings as ss
from spark_rapids_tpu_torch.exprs import windows as wn
from spark_rapids_tpu_torch.exprs.base import Literal, UnresolvedAttribute

__all__ = ["col", "lit", "when", "count", "sum", "min", "max", "avg",
           "first", "last", "pmod", "sqrt", "exp", "log", "pow", "floor",
           "ceil", "abs", "isnull", "isnan", "nanvl", "coalesce", "year",
           "month", "dayofmonth", "dayofweek", "dayofyear", "quarter",
           "hour", "minute", "second", "date_add", "date_sub", "datediff",
           "last_day", "unix_timestamp", "length", "substring", "upper",
           "lower", "initcap", "trim", "ltrim", "rtrim", "concat",
           "concat_ws", "locate", "instr", "replace", "substring_index",
           "regexp_replace", "rlike", "split_part", "contains", "rand",
           "monotonically_increasing_id", "spark_partition_id",
           "row_number", "rank", "dense_rank", "lag", "lead",
           "grouping_id", "array", "explode", "explode_outer",
           "posexplode", "posexplode_outer"]


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
    """The first (non-null, with ``ignore_nulls``) value of each group;
    not a window function in the port yet."""
    return Column(ag.First(_expr_or_name(c), ignore_nulls))


def last(c, ignore_nulls: bool = True) -> Column:
    return Column(ag.Last(_expr_or_name(c), ignore_nulls))


# math
def pmod(a, n) -> Column:
    return Column(ar.Pmod(_expr_or_name(a), _expr_or_name(n)))


def sqrt(c) -> Column:
    return Column(mt.Sqrt(_expr_or_name(c)))


def exp(c) -> Column:
    return Column(mt.Exp(_expr_or_name(c)))


def log(c) -> Column:
    return Column(mt.Log(_expr_or_name(c)))


def pow(c, p) -> Column:  # noqa: A001
    return Column(mt.Pow(_expr_or_name(c), _expr_or_name(p)))


def floor(c) -> Column:
    return Column(mt.Floor(_expr_or_name(c)))


def ceil(c) -> Column:
    return Column(mt.Ceil(_expr_or_name(c)))


def abs(c) -> Column:  # noqa: A001
    return Column(ar.Abs(_expr_or_name(c)))


def isnull(c) -> Column:
    return Column(pr.IsNull(_expr_or_name(c)))


def isnan(c) -> Column:
    return Column(pr.IsNaN(_expr_or_name(c)))


def nanvl(a, b) -> Column:
    return Column(ne.NaNvl(_expr_or_name(a), _expr_or_name(b)))


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


def hour(c) -> Column:
    return Column(dte.Hour(_expr_or_name(c)))


def minute(c) -> Column:
    return Column(dte.Minute(_expr_or_name(c)))


def second(c) -> Column:
    return Column(dte.Second(_expr_or_name(c)))


def unix_timestamp(c) -> Column:
    """Seconds since the epoch of a DATE or TIMESTAMP."""
    return Column(dte.UnixTimestampFromDateTime(_expr_or_name(c)))


# strings
def length(c) -> Column:
    return Column(ss.StringLength(_expr_or_name(c)))


def substring(c, pos, length=None) -> Column:
    """``pos`` and ``length``: ints or integer columns."""
    ln = None if length is None else _to_expr(length)
    return Column(ss.Substring(_expr_or_name(c), _to_expr(pos), ln))


def upper(c) -> Column:
    return Column(ss.Upper(_expr_or_name(c)))


def lower(c) -> Column:
    return Column(ss.Lower(_expr_or_name(c)))


def initcap(c) -> Column:
    return Column(ss.InitCap(_expr_or_name(c)))


def _trim_str(trim_str):
    return None if trim_str is None else Literal(trim_str)


def trim(c, trim_str: str = None) -> Column:
    return Column(ss.StringTrim(_expr_or_name(c), _trim_str(trim_str)))


def ltrim(c, trim_str: str = None) -> Column:
    return Column(ss.StringTrimLeft(_expr_or_name(c), _trim_str(trim_str)))


def rtrim(c, trim_str: str = None) -> Column:
    return Column(ss.StringTrimRight(_expr_or_name(c), _trim_str(trim_str)))


def concat(*cols) -> Column:
    return Column(ss.Concat(*[_expr_or_name(x) for x in cols]))


def concat_ws(sep: str, *cols) -> Column:
    return Column(ss.ConcatWs(_to_expr(sep),
                              *[_expr_or_name(x) for x in cols]))


def locate(substr: str, c, pos: int = 1) -> Column:
    return Column(ss.StringLocate(Literal(substr), _expr_or_name(c),
                                  Literal(pos)))


def instr(c, substr: str) -> Column:
    return Column(ss.StringLocate(Literal(substr), _expr_or_name(c),
                                  Literal(1)))


def replace(c, search, rep="") -> Column:
    return Column(ss.StringReplace(_expr_or_name(c), _to_expr(search),
                                   _to_expr(rep)))


def substring_index(c, delim: str, count: int) -> Column:
    return Column(ss.SubstringIndex(_expr_or_name(c), Literal(delim),
                                    Literal(count)))


def regexp_replace(c, pattern, rep) -> Column:
    return Column(ss.RegExpReplace(_expr_or_name(c), _to_expr(pattern),
                                   _to_expr(rep)))


def rlike(c, pattern) -> Column:
    return Column(ss.RLike(_expr_or_name(c), _to_expr(pattern)))


def split_part(c, delim: str, part: int) -> Column:
    return Column(ss.SplitPart(_expr_or_name(c), Literal(delim),
                               Literal(part)))


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


# nondeterministic
def rand(seed=None) -> Column:
    """Uniform in [0, 1) a row: the JAX package's threefry stream of
    (seed, partition).  No seed draws one, as the JAX package does."""
    if seed is None:
        import random as _random
        seed = _random.randint(0, 2 ** 31 - 1)
    return Column(nd.Rand(seed))


def monotonically_increasing_id() -> Column:
    return Column(nd.MonotonicallyIncreasingID())


def spark_partition_id() -> Column:
    return Column(nd.SparkPartitionID())


def grouping_id() -> Column:
    """The bitmask of the grouping keys a rollup or cube set leaves out
    (the expand's grouping-id column)."""
    from spark_rapids_tpu_torch.api import GROUPING_ID_COL
    return Column(UnresolvedAttribute(GROUPING_ID_COL))


def array(*vals, elem_dtype=None) -> Column:
    """A literal array, valid only inside explode() / posexplode();
    ``elem_dtype`` (a DataType or a Spark type name) types an empty or
    all-null array."""
    if isinstance(elem_dtype, str):
        elem_dtype = from_name(elem_dtype)
    return Column(gn.ArrayLiteral(
        [v.expr if isinstance(v, Column) else v for v in vals], elem_dtype))


def explode(c) -> Column:
    return Column(gn.Explode(_expr_or_name(c)))


def explode_outer(c) -> Column:
    return Column(gn.Explode(_expr_or_name(c), outer=True))


def posexplode(c) -> Column:
    return Column(gn.Explode(_expr_or_name(c), with_pos=True))


def posexplode_outer(c) -> Column:
    return Column(gn.Explode(_expr_or_name(c), with_pos=True, outer=True))
