"""Window expressions: frames, ranking and offset functions, and the
``WindowExpression`` that binds a function to its spec.

Counterpart of ``spark_rapids_tpu/exprs/windows.py``.  A window
expression is ``func OVER (PARTITION BY ... ORDER BY ... frame)``; the
window exec (``exec/window.py``) evaluates every expression of one
(partition, order) spec over one sort, string-typed functions too (the
JAX package runs those on its CPU engine).  ``unsupported`` names the
one spec neither package runs, an offset RANGE frame over a non-numeric
order column; the planner raises ``ValueError`` on it.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

from spark_rapids_tpu_torch.columnar.dtypes import INT32, DataType
from spark_rapids_tpu_torch.exprs.aggregates import AggregateFunction, \
    First
from spark_rapids_tpu_torch.exprs.base import Expression, Literal

# bounds beyond this are unbounded (pyspark passes +-sys.maxsize for
# Window.unboundedPreceding / unboundedFollowing)
_UNBOUNDED_THRESHOLD = 1 << 40


class WindowFrame:
    """A ROWS or RANGE frame.  ``lower`` / ``upper`` are offsets from the
    current row (negative preceding, positive following, 0 the current
    row) or None for unbounded."""

    def __init__(self, kind: str, lower: Optional[int],
                 upper: Optional[int]):
        if kind not in ("rows", "range"):
            raise ValueError(f"frame kind {kind!r}: rows or range")
        if lower is not None and lower <= -_UNBOUNDED_THRESHOLD:
            lower = None
        if upper is not None and upper >= _UNBOUNDED_THRESHOLD:
            upper = None
        self.kind = kind
        self.lower = lower
        self.upper = upper

    @staticmethod
    def default(has_order: bool) -> "WindowFrame":
        """Spark's default: RANGE UNBOUNDED PRECEDING..CURRENT ROW with an
        order, the whole partition without one."""
        if has_order:
            return WindowFrame("range", None, 0)
        return WindowFrame("rows", None, None)

    @property
    def is_whole_partition(self) -> bool:
        return self.lower is None and self.upper is None

    @property
    def is_default_range(self) -> bool:
        return self.kind == "range" and self.lower is None and \
            self.upper == 0

    @property
    def is_offset_range(self) -> bool:
        """A RANGE frame whose bounds are values: not the default, not
        the whole partition."""
        return self.kind == "range" and not (
            self.is_default_range or self.is_whole_partition)

    def key(self) -> str:
        return f"{self.kind}[{self.lower},{self.upper}]"

    def __repr__(self):
        def b(v, side):
            if v is None:
                return f"unbounded {side}"
            if v == 0:
                return "current row"
            return f"{abs(v)} {'preceding' if v < 0 else 'following'}"
        return (f"{self.kind} between {b(self.lower, 'preceding')} "
                f"and {b(self.upper, 'following')}")


class WindowFunction(Expression):
    """A function that only a window exec evaluates."""

    needs_order = True

    def emit(self, ctx):
        raise RuntimeError(
            f"{type(self).__name__} must be evaluated by a window exec")


class _Ranking(WindowFunction):
    children = ()
    fname = "?"

    @property
    def dtype(self) -> DataType:
        return INT32

    @property
    def nullable(self) -> bool:
        return False

    @property
    def name(self) -> str:
        return f"{self.fname}()"

    def key(self) -> str:
        return type(self).__name__


class RowNumber(_Ranking):
    fname = "row_number"


class Rank(_Ranking):
    fname = "rank"


class DenseRank(_Ranking):
    fname = "dense_rank"


class Lag(WindowFunction):
    """The value ``offset`` rows before the current row in its partition,
    else ``default`` (a literal) or null."""

    def __init__(self, child: Expression, offset: int = 1,
                 default: Optional[Expression] = None):
        self.children = (child,) if default is None else (child, default)
        self.offset = int(offset)
        self.has_default = default is not None
        if self.has_default and not isinstance(default, Literal):
            raise ValueError("lag/lead default must be a literal")

    def with_children(self, children):
        return type(self)(children[0], self.offset,
                          children[1] if len(children) > 1 else None)

    @property
    def child(self) -> Expression:
        return self.children[0]

    @property
    def default(self) -> Optional[Expression]:
        return self.children[1] if self.has_default else None

    @property
    def dtype(self) -> DataType:
        return self.child.dtype

    @property
    def nullable(self) -> bool:
        return True

    @property
    def name(self) -> str:
        return (f"{type(self).__name__.lower()}({self.child.name}, "
                f"{self.offset})")

    def key(self) -> str:
        ds = self.children[1].key() if self.has_default else "-"
        return (f"{type(self).__name__}[{self.offset},{ds}]"
                f"({self.child.key()})")


class Lead(Lag):
    """The value ``offset`` rows after the current row."""


class WindowExpression(Expression):
    """``func`` OVER (PARTITION BY ... ORDER BY ... ``frame``).

    The children are flat, (func, *partition exprs, *order exprs), so the
    binder reaches every sub-expression; the counts rebuild the structure.
    ``orders`` holds (expr, ascending, nulls_first) triples."""

    def __init__(self, func: Expression,
                 partition_exprs: Sequence[Expression],
                 orders: Sequence[Tuple[Expression, bool, bool]],
                 frame: Optional[WindowFrame] = None):
        if not isinstance(func, (AggregateFunction, WindowFunction)):
            raise ValueError(
                f"{type(func).__name__} is not a window function or "
                "aggregate; cannot use .over()")
        if isinstance(func, WindowFunction) and func.needs_order and \
                not orders:
            raise ValueError(
                f"{func.name} requires a window ordering "
                "(Window.partition_by(...).order_by(...))")
        if isinstance(func, First) and func.ignore_nulls is False:
            raise ValueError(
                f"{type(func).__name__}(ignore_nulls=False) over a window "
                "is unsupported")
        self.func = func
        self.partition_exprs = list(partition_exprs)
        self.orders = [(e, bool(asc), bool(nf)) for e, asc, nf in orders]
        self.frame = frame if frame is not None \
            else WindowFrame.default(bool(orders))
        if self.frame.is_offset_range and len(self.orders) != 1:
            # Spark: offset RANGE frames need exactly one order column
            raise ValueError(
                "RANGE frames with offsets require exactly one ORDER BY "
                "expression")
        self.children = (func, *self.partition_exprs,
                         *[e for e, _, _ in self.orders])

    def with_children(self, children):
        np_ = len(self.partition_exprs)
        orders = [(e, asc, nf) for e, (_, asc, nf)
                  in zip(children[1 + np_:], self.orders)]
        return WindowExpression(children[0], list(children[1:1 + np_]),
                                orders, self.frame)

    @property
    def dtype(self) -> DataType:
        return self.func.dtype

    @property
    def nullable(self) -> bool:
        return self.func.nullable

    @property
    def name(self) -> str:
        parts = ", ".join(e.name for e in self.partition_exprs)
        orders = ", ".join(f"{e.name} {'ASC' if a else 'DESC'}"
                           for e, a, _ in self.orders)
        return (f"{self.func.name} OVER (partition by [{parts}] "
                f"order by [{orders}] {self.frame!r})")

    def key(self) -> str:
        return f"WindowExpression[{self.func.key()}|{self.spec_key()}|" \
            f"{self.frame.key()}]"

    def spec_key(self) -> str:
        """Window expressions with the same partition and order spec are
        evaluated by one exec over one sort (frames may differ)."""
        parts = ",".join(e.key() for e in self.partition_exprs)
        orders = ",".join(f"{e.key()}:{a}:{nf}"
                          for e, a, nf in self.orders)
        return f"{parts}|{orders}"

    @property
    def unsupported(self) -> Optional[str]:
        """Why this bound expression cannot run, or None: an offset RANGE
        frame over an order column that is not numeric, a date or a
        timestamp, which both of the JAX package's engines refuse with a
        ``ValueError``."""
        if self.frame.is_offset_range:
            odt = self.orders[0][0].dtype
            if not (odt.is_numeric or odt.name in ("date", "timestamp")):
                return ("offset RANGE frames need a numeric/date/timestamp "
                        "order column")
        return None

    def emit(self, ctx):
        raise RuntimeError("WindowExpression must be evaluated by a window "
                           "exec, not a projection")
