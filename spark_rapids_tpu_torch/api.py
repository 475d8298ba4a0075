"""DataFrame API, the user surface.

Counterpart of ``spark_rapids_tpu/api.py``, trimmed to what the port
runs: ``select``, ``with_column``, ``filter``, ``group_by(...).agg(...)``
and the global ``agg``, ``distinct``, ``order_by`` (with
``Column.asc()`` / ``desc()``), ``limit``, ``join`` on key names, the
string predicates, ``isin`` and null tests of ``Column``, ``when``,
window functions (``Column.over`` with a ``Window`` spec; each window
expression in a select, filter or sort list moves into an ``lp.Window``
node below it), temp views for ``session.sql`` and the actions
``collect``, ``to_arrow`` and ``to_torch``.  Actions plan the query (``plan/planner.py``) and run it
on the session's device.
"""

from __future__ import annotations

import contextlib
import datetime
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar.batch import (
    HostColumns, concat_host_values, device_batch_to_host,
    empty_host_values, host_columns_from_arrow, host_columns_from_numpy,
    host_columns_to_arrow,
)
from spark_rapids_tpu_torch.columnar.dtypes import DATE, STRING, DataType, \
    Schema, device_dtype
from spark_rapids_tpu_torch.exec.base import ExecContext
from spark_rapids_tpu_torch.exec.coalesce import concat_batches
from spark_rapids_tpu_torch.exprs import arithmetic as ar
from spark_rapids_tpu_torch.exprs import conditional as cond
from spark_rapids_tpu_torch.exprs import predicates as pr
from spark_rapids_tpu_torch.exprs import strings as ss
from spark_rapids_tpu_torch.exprs.base import Alias, BoundReference, \
    Expression, Literal, UnresolvedAttribute
from spark_rapids_tpu_torch.exprs.nullexprs import Coalesce
from spark_rapids_tpu_torch.exprs.windows import WindowExpression, \
    WindowFrame, WindowFunction
from spark_rapids_tpu_torch.plan import logical as lp
from spark_rapids_tpu_torch.plan.planner import plan_query


def _to_expr(v) -> Expression:
    if isinstance(v, Column):
        return v.expr
    if isinstance(v, Expression):
        return v
    return Literal(v)


class Column:
    """Expression wrapper with operator overloads."""

    def __init__(self, expr: Expression):
        self.expr = expr

    def __add__(self, o):
        return Column(ar.Add(self.expr, _to_expr(o)))

    def __radd__(self, o):
        return Column(ar.Add(_to_expr(o), self.expr))

    def __sub__(self, o):
        return Column(ar.Subtract(self.expr, _to_expr(o)))

    def __rsub__(self, o):
        return Column(ar.Subtract(_to_expr(o), self.expr))

    def __mul__(self, o):
        return Column(ar.Multiply(self.expr, _to_expr(o)))

    def __rmul__(self, o):
        return Column(ar.Multiply(_to_expr(o), self.expr))

    def __truediv__(self, o):
        return Column(ar.Divide(self.expr, _to_expr(o)))

    def __rtruediv__(self, o):
        return Column(ar.Divide(_to_expr(o), self.expr))

    def __eq__(self, o):  # type: ignore[override]
        return Column(pr.EqualTo(self.expr, _to_expr(o)))

    def __ne__(self, o):  # type: ignore[override]
        return Column(pr.NotEqual(self.expr, _to_expr(o)))

    def __lt__(self, o):
        return Column(pr.LessThan(self.expr, _to_expr(o)))

    def __le__(self, o):
        return Column(pr.LessThanOrEqual(self.expr, _to_expr(o)))

    def __gt__(self, o):
        return Column(pr.GreaterThan(self.expr, _to_expr(o)))

    def __ge__(self, o):
        return Column(pr.GreaterThanOrEqual(self.expr, _to_expr(o)))

    def __and__(self, o):
        return Column(pr.And(self.expr, _to_expr(o)))

    def __or__(self, o):
        return Column(pr.Or(self.expr, _to_expr(o)))

    def __invert__(self):
        return Column(pr.Not(self.expr))

    def is_null(self) -> "Column":
        return Column(pr.IsNull(self.expr))

    def is_not_null(self) -> "Column":
        return Column(pr.IsNotNull(self.expr))

    def isin(self, *values) -> "Column":
        """IN a list of literals, given one by one or as one list."""
        vals = values[0] if len(values) == 1 and \
            isinstance(values[0], (list, tuple)) else values
        return Column(pr.In(self.expr, list(vals)))

    # string predicates; the pattern must be a literal
    def startswith(self, other) -> "Column":
        return Column(ss.StartsWith(self.expr, _to_expr(other)))

    def endswith(self, other) -> "Column":
        return Column(ss.EndsWith(self.expr, _to_expr(other)))

    def contains(self, other) -> "Column":
        """Always the unrolled ``Contains``, whatever the needle's length,
        as in the JAX package; ``functions.contains`` routes long needles
        to the kernel."""
        return Column(ss.Contains(self.expr, _to_expr(other)))

    def alias(self, name: str) -> "Column":
        return Column(Alias(self.expr, name))

    # sort-direction markers read by order_by
    def asc(self) -> "_SortCol":
        return _SortCol(self.expr, True)

    def desc(self) -> "_SortCol":
        return _SortCol(self.expr, False)

    def over(self, window: "WindowSpec") -> "Column":
        """This aggregate or window function over ``window``."""
        func = self.expr
        if isinstance(func, Alias):
            func = func.children[0]
        return Column(WindowExpression(
            func, window._partition, window._orders, window._frame))

    def __repr__(self):
        return f"Column<{self.expr.name}>"


class _SortCol:
    """(expression, direction) marker made by ``Column.asc()`` and
    ``desc()``."""

    __slots__ = ("expr", "ascending")

    def __init__(self, expr: Expression, ascending: bool):
        self.expr = expr
        self.ascending = ascending


class WindowSpec:
    """An immutable window specification (pyspark's ``WindowSpec``)."""

    def __init__(self, partition=None, orders=None, frame=None):
        self._partition = list(partition or [])
        self._orders = list(orders or [])
        self._frame = frame

    @staticmethod
    def _to_order(c):
        if isinstance(c, _SortCol):
            # Spark's default null order: first ascending, last descending
            return (c.expr, c.ascending, c.ascending)
        return (_expr_or_name(c), True, True)

    def partition_by(self, *cols_) -> "WindowSpec":
        return WindowSpec(self._partition + [_expr_or_name(c) for c in cols_],
                          self._orders, self._frame)

    partitionBy = partition_by

    def order_by(self, *cols_) -> "WindowSpec":
        return WindowSpec(self._partition,
                          self._orders + [self._to_order(c) for c in cols_],
                          self._frame)

    orderBy = order_by

    def rows_between(self, start: int, end: int) -> "WindowSpec":
        return WindowSpec(self._partition, self._orders,
                          WindowFrame("rows", start, end))

    rowsBetween = rows_between

    def range_between(self, start: int, end: int) -> "WindowSpec":
        return WindowSpec(self._partition, self._orders,
                          WindowFrame("range", start, end))

    rangeBetween = range_between


class Window:
    """Entry points of a window spec, as pyspark's ``Window``."""

    unboundedPreceding = -(1 << 63)
    unboundedFollowing = (1 << 63) - 1
    currentRow = 0
    unbounded_preceding = unboundedPreceding
    unbounded_following = unboundedFollowing
    current_row = currentRow

    @staticmethod
    def partition_by(*cols_) -> WindowSpec:
        return WindowSpec().partition_by(*cols_)

    partitionBy = partition_by

    @staticmethod
    def order_by(*cols_) -> WindowSpec:
        return WindowSpec().order_by(*cols_)

    orderBy = order_by

    @staticmethod
    def rows_between(start: int, end: int) -> WindowSpec:
        return WindowSpec().rows_between(start, end)

    rowsBetween = rows_between

    @staticmethod
    def range_between(start: int, end: int) -> WindowSpec:
        return WindowSpec().range_between(start, end)

    rangeBetween = range_between


def _extract_window_exprs(exprs: List[Expression], plan: lp.LogicalPlan):
    """Move the window expressions of ``exprs`` into ``lp.Window`` nodes
    over ``plan``, one node per (partition, order) spec, and replace each
    with a reference to its column (Spark's ExtractWindowExpressions).
    A window expression that is a projected column (aliased or not) keeps
    its display name; one nested inside another expression gets
    ``__w<i>``.  -> (new exprs, new plan)."""
    found: dict = {}  # key -> (window expression, projected as a column)

    def scan(e: Expression, top: bool) -> None:
        if isinstance(e, Alias):
            scan(e.children[0], top)
            return
        if isinstance(e, WindowExpression):
            prev = found.get(e.key())
            found[e.key()] = (e, top or (prev is not None and prev[1]))
            return
        if isinstance(e, WindowFunction):
            raise ValueError(
                f"{e.name} is a window function and requires "
                ".over(Window.partition_by(...).order_by(...))")
        for c in e.children:
            scan(c, False)

    for e in exprs:
        scan(e, top=True)
    if not found:
        return exprs, plan
    assigned: dict = {}  # key -> column name
    groups: dict = {}    # spec key -> [(name, window expression)]
    for i, (wk, (w, top)) in enumerate(found.items()):
        name = w.name if top else f"__w{i}"
        assigned[wk] = name
        groups.setdefault(w.spec_key(), []).append((name, w))

    def walk(e: Expression) -> Expression:
        if isinstance(e, WindowExpression):
            return UnresolvedAttribute(assigned[e.key()])
        if not e.children:
            return e
        new = [walk(c) for c in e.children]
        if all(a is b for a, b in zip(new, e.children)):
            return e
        return e.with_children(new)

    for group in groups.values():
        plan = lp.Window(group, plan)
    return [walk(e) for e in exprs], plan


def _names(plan: lp.LogicalPlan) -> List[Expression]:
    return [UnresolvedAttribute(f.name) for f in plan.output_schema()]


def col(name: str) -> Column:
    return Column(UnresolvedAttribute(name))


def lit(value, dtype: Optional[DataType] = None) -> Column:
    return Column(Literal(value, dtype))


def when(cond_col: Column, value) -> "CaseWhenBuilder":
    """CASE WHEN: ``when(c1, v1).when(c2, v2).otherwise(e)``."""
    return CaseWhenBuilder([(cond_col.expr, _to_expr(value))])


class CaseWhenBuilder(Column):
    """A CASE WHEN with no ELSE yet (its unmatched rows are null)."""

    def __init__(self, branches):
        self._branches = branches
        super().__init__(cond.CaseWhen(branches))

    def when(self, cond_col: Column, value) -> "CaseWhenBuilder":
        return CaseWhenBuilder(
            self._branches + [(cond_col.expr, _to_expr(value))])

    def otherwise(self, value) -> Column:
        return Column(cond.CaseWhen(self._branches, _to_expr(value)))


def _expr_or_name(c) -> Expression:
    return UnresolvedAttribute(c) if isinstance(c, str) else _to_expr(c)


class DataFrame:
    """Lazy logical-plan builder; actions plan and execute."""

    def __init__(self, session, plan: lp.LogicalPlan):
        self.session = session
        self.plan = plan

    # -- transformations ----------------------------------------------------

    def select(self, *cols_) -> "DataFrame":
        exprs, plan = _extract_window_exprs(
            [_expr_or_name(c) for c in cols_], self.plan)
        return DataFrame(self.session, lp.Project(exprs, plan))

    def with_column(self, name: str, c: Column) -> "DataFrame":
        """Every column, with ``name`` replaced by ``c`` or appended."""
        exprs = [Alias(_to_expr(c), name) if e.col_name == name else e
                 for e in _names(self.plan)]
        if name not in self.plan.output_schema().names:
            exprs.append(Alias(_to_expr(c), name))
        exprs, plan = _extract_window_exprs(exprs, self.plan)
        return DataFrame(self.session, lp.Project(exprs, plan))

    def filter(self, cond) -> "DataFrame":
        (e,), plan = _extract_window_exprs([_to_expr(cond)], self.plan)
        out = lp.Filter(e, plan)
        if plan is not self.plan:
            # drop the window columns the predicate read
            out = lp.Project(_names(self.plan), out)
        return DataFrame(self.session, out)

    def order_by(self, *cols_, ascending=True) -> "DataFrame":
        ascs = ascending if isinstance(ascending, (list, tuple)) \
            else [ascending] * len(cols_)
        orders = []
        for c, asc in zip(cols_, ascs):
            if isinstance(c, _SortCol):
                # an asc()/desc() marker overrides the keyword
                c, asc = c.expr, c.ascending
            # Spark's default null order: first when ascending, else last
            orders.append((_expr_or_name(c), bool(asc), bool(asc)))
        keys, plan = _extract_window_exprs([e for e, _, _ in orders],
                                           self.plan)
        out = lp.Sort([(k, asc, nf) for k, (_, asc, nf) in zip(keys, orders)],
                      plan)
        if plan is not self.plan:
            # drop the window columns the sort read
            out = lp.Project(_names(self.plan), out)
        return DataFrame(self.session, out)

    def limit(self, n: int) -> "DataFrame":
        return DataFrame(self.session, lp.Limit(n, self.plan))

    def agg(self, *agg_cols) -> "DataFrame":
        """A global aggregation: one row over the whole input."""
        return GroupedData(self, []).agg(*agg_cols)

    def join(self, other: "DataFrame", on, how: str = "inner"
             ) -> "DataFrame":
        """Equi-join on the columns named in ``on`` (one name or a list),
        of type inner, left, right, full, semi or anti (pyspark's
        aliases accepted).  As in pyspark's USING join, each key appears
        once in the output: the left one for inner and left joins, the
        right one for right joins, and the first non-null of the two for
        full joins."""
        on = [on] if isinstance(on, str) else list(on)
        how = {"left_outer": "left", "right_outer": "right",
               "outer": "full", "full_outer": "full", "leftsemi": "semi",
               "left_semi": "semi", "leftanti": "anti",
               "left_anti": "anti"}.get(how, how)
        plan = lp.Join(self.plan, other.plan,
                       [UnresolvedAttribute(k) for k in on],
                       [UnresolvedAttribute(k) for k in on], how)
        if how in ("inner", "left", "right", "full"):
            lfields = self.plan.output_schema().fields
            rfields = other.plan.output_schema().fields
            nl = len(lfields)
            rpos = {f.name: i for i, f in enumerate(rfields)}
            exprs = []
            for i, f in enumerate(lfields + rfields):
                if f.name in on and i >= nl:
                    continue
                ref = BoundReference(i, f.dtype, True, f.name)
                if f.name in on and how in ("right", "full"):
                    rf = rfields[rpos[f.name]]
                    rref = BoundReference(nl + rpos[f.name], rf.dtype, True,
                                          rf.name)
                    ref = rref if how == "right" else Coalesce(ref, rref)
                exprs.append(Alias(ref, f.name))
            plan = lp.Project(exprs, plan)
        return DataFrame(self.session, plan)

    def group_by(self, *cols_) -> "GroupedData":
        return GroupedData(self, [_expr_or_name(c) for c in cols_])

    def create_or_replace_temp_view(self, name: str) -> None:
        """Register this DataFrame as view ``name`` for ``session.sql``."""
        self.session.register_view(name, self)

    createOrReplaceTempView = create_or_replace_temp_view

    def distinct(self) -> "DataFrame":
        """The distinct rows: an aggregate by every column, with no
        functions."""
        return DataFrame(self.session,
                         lp.Aggregate(_names(self.plan), [], self.plan))

    # -- actions ------------------------------------------------------------

    def _execute(self):
        """Plan and run the query; the device batches of its result."""
        root = plan_query(self.plan, self.session.conf)
        ctx = ExecContext(self.session.conf, self.session.device,
                          self.session.runtime)
        # closing the stream ends every operator's generator, and with
        # them the handles and threads they hold, on an error as well
        with contextlib.closing(root.execute(ctx)) as stream:
            batches = list(stream)
        self.session._last_plan = root
        return root.output_schema, batches

    def _host(self) -> Tuple[Schema, HostColumns]:
        schema, batches = self._execute()
        parts = [device_batch_to_host(b, schema) for b in batches]
        cols = {}
        for f in schema:
            if parts:
                cols[f.name] = (
                    concat_host_values([p[f.name][0] for p in parts]),
                    np.concatenate([p[f.name][1] for p in parts]))
            else:
                cols[f.name] = (empty_host_values(f.dtype),
                                np.zeros(0, np.bool_))
        return schema, cols

    def to_arrow(self):
        """The result as a pyarrow Table (imports pyarrow)."""
        return host_columns_to_arrow(*self._host())

    def collect(self) -> List[dict]:
        """The result as a list of row dicts (None for null); dates come
        back as ``datetime.date``, strings as ``str``."""
        schema, cols = self._host()
        out_cols = []
        for f in schema:
            values, valid = cols[f.name]
            if f.dtype == STRING:
                vals = values.to_pylist()
            else:
                vals = values.tolist()
            if f.dtype == DATE:
                epoch = datetime.date(1970, 1, 1)
                vals = [epoch + datetime.timedelta(days=d) for d in vals]
            out_cols.append([v if ok else None
                             for v, ok in zip(vals, valid.tolist())])
        return [dict(zip(schema.names, row)) for row in zip(*out_cols)]

    def to_torch(self) -> Tuple[Dict[str, object], Dict[str, torch.Tensor],
                                int]:
        """-> (columns, masks, num_rows): the result's data planes and
        validity masks, still on the session's device, trimmed to the
        row count (the counterpart of the JAX package's ``to_jax``).  A
        string column comes back as ``(lengths, chars)``."""
        schema, batches = self._execute()
        if not batches:
            dev = self.session.device
            cols = {}
            for f in schema:
                data = torch.empty(0, dtype=device_dtype(f.dtype), device=dev)
                cols[f.name] = data if f.dtype != STRING else \
                    (data, torch.zeros((0, 1), dtype=torch.uint8, device=dev))
            masks = {f.name: torch.empty(0, dtype=torch.bool, device=dev)
                     for f in schema}
            return cols, masks, 0
        batch = concat_batches(batches)
        n = batch.num_rows
        cols = {f.name: c.data[:n] if c.chars is None else
                (c.data[:n], c.chars[:n])
                for f, c in zip(schema, batch.columns)}
        masks = {f.name: c.validity[:n]
                 for f, c in zip(schema, batch.columns)}
        return cols, masks, n


class GroupedData:
    def __init__(self, df: DataFrame, groupings: List[Expression]):
        self.df = df
        self.groupings = groupings

    def agg(self, *agg_cols) -> DataFrame:
        return DataFrame(self.df.session, lp.Aggregate(
            self.groupings, [_to_expr(c) for c in agg_cols], self.df.plan))


class DataFrameReader:
    def __init__(self, session):
        self.session = session

    def parquet(self, *paths) -> DataFrame:
        from spark_rapids_tpu_torch.io.parquet import read_schema
        return DataFrame(self.session, lp.ParquetRelation(
            list(paths), read_schema(list(paths))))


def create_dataframe(session, data, masks=None) -> DataFrame:
    """A dict of numpy arrays (with optional validity masks, True =
    valid), or a pyarrow Table/RecordBatch -> DataFrame."""
    if isinstance(data, dict):
        schema, cols = host_columns_from_numpy(data, masks)
    elif type(data).__module__.split(".")[0] == "pyarrow":
        schema, cols = host_columns_from_arrow(data)
    else:
        raise TypeError(f"cannot build a DataFrame from {type(data)}")
    return DataFrame(session, lp.LocalRelation(schema, cols))
