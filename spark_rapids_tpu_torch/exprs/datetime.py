"""Date and time expressions over DATE (int32 days since 1970-01-01)
and TIMESTAMP (int64 microseconds since the epoch, UTC) columns.

Counterpart of ``spark_rapids_tpu/exprs/datetime.py``:
``days_to_civil`` / ``civil_to_days`` (Howard Hinnant's branch-free
civil-date algorithms), ``timestamp_to_days`` and
``timestamp_time_of_day``, the date parts ``Year`` to ``LastDay`` (over
a DATE or a TIMESTAMP's day), ``Hour``, ``Minute`` and ``Second``,
``DateAdd``, ``DateSub`` and ``DateDiff`` (a TIMESTAMP operand cast to
its DATE, as Spark casts it), ``UnixTimestampFromDateTime``, and
``TimeAdd``/``TimeSub`` by a literal count of microseconds.  The
algorithms divide negative counts (before 1970), so every division
floors explicitly (``torch.div(..., rounding_mode="floor")``), as
``jnp``'s ``//`` does.
"""

from __future__ import annotations

import torch

from spark_rapids_tpu_torch.columnar.dtypes import DATE, INT32, INT64, \
    TIMESTAMP, DataType
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


MICROS_PER_SECOND = 1_000_000
MICROS_PER_DAY = 86_400 * MICROS_PER_SECOND


def timestamp_to_days(us: torch.Tensor) -> torch.Tensor:
    return _fdiv(us, MICROS_PER_DAY).to(torch.int32)


def timestamp_time_of_day(us: torch.Tensor):
    """-> (hour, minute, second, micros) in UTC."""
    tod = us - timestamp_to_days(us).to(torch.int64) * MICROS_PER_DAY
    secs = _fdiv(tod, MICROS_PER_SECOND)
    micro = tod - secs * MICROS_PER_SECOND
    return (_fdiv(secs, 3600).to(torch.int32),
            _fdiv(torch.remainder(secs, 3600), 60).to(torch.int32),
            torch.remainder(secs, 60).to(torch.int32), micro)


class _DatePart(Expression):
    """A civil component of a DATE, or of a TIMESTAMP's day."""
    fname = "?"

    def __init__(self, child: Expression):
        self.children = (child,)

    @property
    def dtype(self) -> DataType:
        return INT32

    @property
    def name(self) -> str:
        return f"{self.fname}({self.children[0].name})"

    def emit(self, ctx: EvalContext) -> ColVal:
        c = self.children[0].emit(ctx)
        days = timestamp_to_days(c.data) \
            if self.children[0].dtype == TIMESTAMP else c.data
        return fixed(self.part(days), c.validity)

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
        from spark_rapids_tpu_torch.exprs.cast import cast_to
        if TIMESTAMP not in (c.dtype for c in self.children):
            return self
        # Spark casts a TIMESTAMP operand to its DATE
        return self.with_children([
            cast_to(c, DATE) if c.dtype == TIMESTAMP else c
            for c in self.children])

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


class _TimePart(Expression):
    """A time-of-day component of a TIMESTAMP, in UTC."""
    fname = "?"

    def __init__(self, child: Expression):
        self.children = (child,)

    @property
    def dtype(self) -> DataType:
        return INT32

    @property
    def name(self) -> str:
        return f"{self.fname}({self.children[0].name})"

    def emit(self, ctx: EvalContext) -> ColVal:
        c = self.children[0].emit(ctx)
        return fixed(self.pick(*timestamp_time_of_day(c.data)[:3]),
                     c.validity)


class Hour(_TimePart):
    fname = "hour"

    def pick(self, h, mi, s):
        return h


class Minute(_TimePart):
    fname = "minute"

    def pick(self, h, mi, s):
        return mi


class Second(_TimePart):
    fname = "second"

    def pick(self, h, mi, s):
        return s


class UnixTimestampFromDateTime(Expression):
    """unix_timestamp over a DATE or TIMESTAMP: seconds since the epoch,
    LONG."""

    def __init__(self, child: Expression):
        self.children = (child,)

    @property
    def dtype(self) -> DataType:
        return INT64

    @property
    def name(self) -> str:
        return f"unix_timestamp({self.children[0].name})"

    def emit(self, ctx: EvalContext) -> ColVal:
        c = self.children[0].emit(ctx)
        if self.children[0].dtype == DATE:
            secs = c.data.to(torch.int64) * 86_400
        else:
            secs = _fdiv(c.data, MICROS_PER_SECOND)
        return fixed(secs, c.validity)


class TimeSub(Expression):
    """timestamp - a literal interval of microseconds."""
    sign = -1

    def __init__(self, start: Expression, interval_us: int):
        self.children = (start,)
        self.interval_us = int(interval_us)

    @property
    def dtype(self) -> DataType:
        return TIMESTAMP

    @property
    def name(self) -> str:
        op = "+" if self.sign > 0 else "-"
        return (f"({self.children[0].name} {op} INTERVAL "
                f"{self.interval_us}us)")

    def key(self) -> str:
        return (f"{type(self).__name__}[{self.interval_us}]"
                f"({self.children[0].key()})")

    def with_children(self, children):
        return type(self)(children[0], self.interval_us)

    def emit(self, ctx: EvalContext) -> ColVal:
        c = self.children[0].emit(ctx)
        return fixed(c.data + self.sign * self.interval_us, c.validity)


class TimeAdd(TimeSub):
    """timestamp + a literal interval of microseconds."""
    sign = 1
