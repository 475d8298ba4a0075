"""Date expressions over DATE columns (int32 days since 1970-01-01).

Counterpart of the DATE part of ``spark_rapids_tpu/exprs/datetime.py``:
``days_to_civil`` / ``civil_to_days`` (Howard Hinnant's branch-free
civil-date algorithms), the date parts ``Year`` to ``LastDay``, and
``DateAdd``, ``DateSub`` and ``DateDiff``.  The algorithms divide
negative day counts (dates before 1970), so every division floors
explicitly (``torch.div(..., rounding_mode="floor")``), as ``jnp``'s
``//`` does.  The port has no TIMESTAMP columns yet: a date part over a
TIMESTAMP input raises ``NotImplementedError`` when the planner binds
it, and the time-of-day parts are not here.
"""

from __future__ import annotations

import torch

from spark_rapids_tpu_torch.columnar.dtypes import DATE, INT32, TIMESTAMP, \
    DataType
from spark_rapids_tpu_torch.exprs.base import ColVal, EvalContext, \
    Expression, fixed


def _fdiv(a: torch.Tensor, b: int) -> torch.Tensor:
    return torch.div(a, b, rounding_mode="floor")


def days_to_civil(days: torch.Tensor):
    """days since the epoch -> (year, month, day), int32 each
    (Hinnant's civil_from_days)."""
    z = days.to(torch.int64) + 719468
    era = _fdiv(z, 146097)
    doe = z - era * 146097                      # [0, 146096]
    yoe = _fdiv(doe - _fdiv(doe, 1460) + _fdiv(doe, 36524)
                - _fdiv(doe, 146096), 365)      # [0, 399]
    y = yoe + era * 400
    doy = doe - (365 * yoe + _fdiv(yoe, 4) - _fdiv(yoe, 100))
    mp = _fdiv(5 * doy + 2, 153)                # [0, 11], March first
    d = doy - _fdiv(153 * mp + 2, 5) + 1
    m = mp + 3 - 12 * _fdiv(mp, 10)
    y = y + (m <= 2).to(torch.int64)
    return y.to(torch.int32), m.to(torch.int32), d.to(torch.int32)


def civil_to_days(y: torch.Tensor, m: torch.Tensor, d: torch.Tensor
                  ) -> torch.Tensor:
    """(year, month, day) -> int32 days since the epoch (Hinnant's
    days_from_civil)."""
    y = y.to(torch.int64) - (m <= 2).to(torch.int64)
    era = _fdiv(y, 400)
    yoe = y - era * 400
    mp = torch.where(m > 2, m - 3, m + 9).to(torch.int64)
    doy = _fdiv(153 * mp + 2, 5) + d.to(torch.int64) - 1
    doe = yoe * 365 + _fdiv(yoe, 4) - _fdiv(yoe, 100) + doy
    return (era * 146097 + doe - 719468).to(torch.int32)


class _DatePart(Expression):
    """A civil component of a DATE."""
    fname = "?"

    def __init__(self, child: Expression):
        self.children = (child,)

    @property
    def dtype(self) -> DataType:
        return INT32

    @property
    def name(self) -> str:
        return f"{self.fname}({self.children[0].name})"

    def coerce(self) -> Expression:
        if self.children[0].dtype == TIMESTAMP:
            raise NotImplementedError(
                f"{self.fname} over a TIMESTAMP: the torch port has no "
                "TIMESTAMP columns yet")
        return self

    def emit(self, ctx: EvalContext) -> ColVal:
        c = self.children[0].emit(ctx)
        return fixed(self.part(c.data), c.validity)

    def part(self, days: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError


class Year(_DatePart):
    fname = "year"

    def part(self, days):
        return days_to_civil(days)[0]


class Month(_DatePart):
    fname = "month"

    def part(self, days):
        return days_to_civil(days)[1]


class DayOfMonth(_DatePart):
    fname = "dayofmonth"

    def part(self, days):
        return days_to_civil(days)[2]


class DayOfWeek(_DatePart):
    """1 = Sunday ... 7 = Saturday (Spark); 1970-01-01 was a Thursday."""
    fname = "dayofweek"

    def part(self, days):
        return (torch.remainder(days.to(torch.int64) + 4, 7) + 1) \
            .to(torch.int32)


class WeekDay(_DatePart):
    """0 = Monday ... 6 = Sunday."""
    fname = "weekday"

    def part(self, days):
        return torch.remainder(days.to(torch.int64) + 3, 7).to(torch.int32)


class DayOfYear(_DatePart):
    fname = "dayofyear"

    def part(self, days):
        y = days_to_civil(days)[0]
        one = torch.ones_like(y)
        return (days - civil_to_days(y, one, one) + 1).to(torch.int32)


class Quarter(_DatePart):
    fname = "quarter"

    def part(self, days):
        m = days_to_civil(days)[1]
        return (_fdiv(m - 1, 3) + 1).to(torch.int32)


class LastDay(_DatePart):
    """The last day of the date's month, as a DATE."""
    fname = "last_day"

    @property
    def dtype(self) -> DataType:
        return DATE

    def part(self, days):
        y, m, _ = days_to_civil(days)
        ny = torch.where(m == 12, y + 1, y)
        nm = torch.where(m == 12, torch.ones_like(m), m + 1)
        return (civil_to_days(ny, nm, torch.ones_like(nm)) - 1) \
            .to(torch.int32)


class _DateArith(Expression):
    """A binary date function; null if either side is null."""
    fname = "?"

    def __init__(self, a: Expression, b: Expression):
        self.children = (a, b)

    @property
    def dtype(self) -> DataType:
        return DATE

    @property
    def name(self) -> str:
        a, b = self.children
        return f"{self.fname}({a.name}, {b.name})"

    def coerce(self) -> Expression:
        if TIMESTAMP in (c.dtype for c in self.children):
            raise NotImplementedError(
                f"{self.fname} over a TIMESTAMP: the torch port has no "
                "TIMESTAMP columns yet")
        return self

    def emit(self, ctx: EvalContext) -> ColVal:
        a = self.children[0].emit(ctx)
        b = self.children[1].emit(ctx)
        return fixed(self.combine(a.data, b.data), a.validity & b.validity)

    def combine(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError


class DateAdd(_DateArith):
    """date_add(date, days), computed in int64 and wrapped to int32."""
    fname = "date_add"

    def combine(self, a, b):
        return (a.to(torch.int64) + b.to(torch.int64)).to(torch.int32)


class DateSub(_DateArith):
    fname = "date_sub"

    def combine(self, a, b):
        return (a.to(torch.int64) - b.to(torch.int64)).to(torch.int32)


class DateDiff(_DateArith):
    """datediff(end, start): whole days, INT."""
    fname = "datediff"

    @property
    def dtype(self) -> DataType:
        return INT32

    def combine(self, a, b):
        return a - b
