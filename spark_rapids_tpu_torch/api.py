"""DataFrame API, the user surface.

Counterpart of ``spark_rapids_tpu/api.py``, trimmed to what the port
runs: ``select``, ``with_column``, ``filter``, ``group_by(...).agg(...)``
and the global ``agg``, ``distinct``, ``order_by`` (with
``Column.asc()`` / ``desc()``), ``limit``, ``join`` on key names or key
expressions and the cross join, the string predicates, ``like`` and
``rlike``, ``cast`` to every type, ``eq_null_safe``, ``isin``, ``is_nan``
and null tests of ``Column``, ``when``,
window functions (``Column.over`` with a ``Window`` spec; each window
expression in a select, filter or sort list moves into an ``lp.Window``
node below it), ``union``, ``rollup`` and ``cube`` (an ``lp.Expand`` under
the aggregate, with ``grouping_id``), explode and posexplode of a literal
array in a select (an ``lp.Generate`` below it), ``repartition`` and
``repartition_by_range``, ``session.range``, temp views for
``session.sql`` and the actions ``collect``, ``count``, ``head``,
``take``, ``first``, ``to_numpy``, ``to_arrow`` and ``to_torch``.  Actions plan the query (``plan/planner.py``) and run it
on the session's device, each inside its own ``lifecycle.query_scope``
(the query's deadline, cancel token, device budget and resources; the
pull of the result to the host included).  ``HostResult`` is a result
on the host, what the session server and prepared statements return.
"""

from __future__ import annotations

import contextlib
import datetime
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch import lifecycle
from spark_rapids_tpu_torch.columnar import encoding
from spark_rapids_tpu_torch.columnar.batch import (
    ColumnarBatch, HostColumns, HostStrings, concat_host_values,
    empty_host_values, host_columns_from_arrow,
    host_columns_from_numpy, host_columns_to_arrow,
)
from spark_rapids_tpu_torch.columnar.dtypes import DATE, STRING, \
    TIMESTAMP, DataType, Schema, device_dtype, from_name
from spark_rapids_tpu_torch.exec.base import ExecContext
from spark_rapids_tpu_torch.exec.coalesce import concat_batches
from spark_rapids_tpu_torch.exprs import arithmetic as ar
from spark_rapids_tpu_torch.exprs import conditional as cond
from spark_rapids_tpu_torch.exprs import predicates as pr
from spark_rapids_tpu_torch.exprs import strings as ss
from spark_rapids_tpu_torch.exprs.aggregates import Count
from spark_rapids_tpu_torch.exprs.base import Alias, BoundReference, \
    Expression, Literal, UnresolvedAttribute, bind_expression
from spark_rapids_tpu_torch.exprs.cast import Cast
from spark_rapids_tpu_torch.exprs.generators import find_generators, \
    find_stray_array_literals
from spark_rapids_tpu_torch.exprs.nullexprs import Coalesce
from spark_rapids_tpu_torch.io.writers import DataFrameWriter
from spark_rapids_tpu_torch.exprs.windows import WindowExpression, \
    WindowFrame, WindowFunction
from spark_rapids_tpu_torch.plan import logical as lp
from spark_rapids_tpu_torch.plan.planner import plan_query
from spark_rapids_tpu_torch.utils.tracing import query_trace


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

    def __mod__(self, o):
        return Column(ar.Remainder(self.expr, _to_expr(o)))

    def __neg__(self):
        return Column(ar.UnaryMinus(self.expr))

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

    def is_nan(self) -> "Column":
        return Column(pr.IsNaN(self.expr))

    isNaN = is_nan

    def eq_null_safe(self, o) -> "Column":
        """``<=>``: null-safe equality, never null."""
        return Column(pr.EqualNullSafe(self.expr, _to_expr(o)))

    eqNullSafe = eq_null_safe

    def cast(self, dtype) -> "Column":
        """Cast to a DataType or a Spark type name ("string", "date",
        ...); a gated cast raises at planning unless its key is on."""
        if isinstance(dtype, str):
            dtype = from_name(dtype)
        return Column(Cast(self.expr, dtype))

    def like(self, pattern: str) -> "Column":
        return Column(ss.Like(self.expr, _to_expr(pattern)))

    def rlike(self, pattern: str) -> "Column":
        return Column(ss.RLike(self.expr, _to_expr(pattern)))

    def substr(self, pos, length=None) -> "Column":
        """``pos`` and ``length`` may be ints or integer columns."""
        ln = None if length is None else _to_expr(length)
        return Column(ss.Substring(self.expr, _to_expr(pos), ln))

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


def _unique_name(base: str, names: set) -> str:
    """An internal column name not in ``names`` (and added to it)."""
    name, i = base, 0
    while name in names:
        i += 1
        name = f"{base.rstrip('_')}_{i}__" if base.endswith("__") \
            else f"{base}_{i}"
    names.add(name)
    return name


def _extract_generator(exprs: List[Expression], plan: lp.LogicalPlan):
    """Move the generator (explode / posexplode) of a select list into an
    ``lp.Generate`` node over ``plan`` and put references to its columns
    in its place (Spark's ExtractGenerator).  The generated columns take
    internal names unique against ``plan``'s and are aliased back above,
    so a generated column may replace one of the same name
    (``with_column("v", explode(...))``).  -> (new exprs, new plan)."""
    for e in exprs:
        if find_stray_array_literals(e):
            raise ValueError(
                "F.array(...) literals are only usable inside "
                "explode()/posexplode()")
    gens = [g for e in exprs for g in find_generators(e)]
    if not gens:
        return exprs, plan
    if len(gens) > 1:
        raise ValueError("only one generator (explode/posexplode) is "
                         "allowed per select")
    gen = gens[0]
    col_name = "col"
    for e in exprs:
        base = e.children[0] if isinstance(e, Alias) else e
        if base is gen and isinstance(e, Alias):
            col_name = e.name
        elif base is not gen and find_generators(e):
            raise ValueError(
                "explode()/posexplode() must be a top-level select "
                "column (optionally aliased), not nested in an "
                "expression")
    existing = {f.name for f in plan.output_schema()}
    pos_internal = _unique_name("__gen_pos__", existing) \
        if gen.with_pos else None
    col_internal = _unique_name(f"__gen_{col_name}__", existing)
    new_exprs: List[Expression] = []
    for e in exprs:
        base = e.children[0] if isinstance(e, Alias) else e
        if base is gen:
            if gen.with_pos:
                new_exprs.append(
                    Alias(UnresolvedAttribute(pos_internal), "pos"))
            new_exprs.append(
                Alias(UnresolvedAttribute(col_internal), col_name))
        else:
            new_exprs.append(e)
    names = [pos_internal, col_internal] if gen.with_pos \
        else [col_internal]
    return new_exprs, lp.Generate(gen, names, plan)


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


def _explain_lines(node: lp.LogicalPlan, depth: int = 0) -> List[str]:
    """The logical plan, one ``* <node>`` line a node, in the JAX
    planner's explain format; the port plans every node on its device
    or raises."""
    lines = ["  " * depth + "* " + node.node_name]
    for c in node.children:
        lines += _explain_lines(c, depth + 1)
    return lines


def _expr_or_name(c) -> Expression:
    return UnresolvedAttribute(c) if isinstance(c, str) else _to_expr(c)


class DataFrame:
    """Lazy logical-plan builder; actions plan and execute."""

    def __init__(self, session, plan: lp.LogicalPlan):
        self.session = session
        self.plan = plan

    # -- transformations ----------------------------------------------------

    def select(self, *cols_) -> "DataFrame":
        exprs, plan = _extract_generator([_expr_or_name(c) for c in cols_],
                                         self.plan)
        exprs, plan = _extract_window_exprs(exprs, plan)
        return DataFrame(self.session, lp.Project(exprs, plan))

    def with_column(self, name: str, c: Column) -> "DataFrame":
        """Every column, with ``name`` replaced by ``c`` or appended."""
        exprs = [Alias(_to_expr(c), name) if e.col_name == name else e
                 for e in _names(self.plan)]
        if name not in self.plan.output_schema().names:
            exprs.append(Alias(_to_expr(c), name))
        exprs, plan = _extract_generator(exprs, self.plan)
        exprs, plan = _extract_window_exprs(exprs, plan)
        return DataFrame(self.session, lp.Project(exprs, plan))

    def filter(self, cond) -> "DataFrame":
        if find_generators(_to_expr(cond)):
            raise ValueError(
                "explode()/posexplode() is not allowed in filter() — "
                "generators are only valid in select()/with_column()")
        (e,), plan = _extract_window_exprs([_to_expr(cond)], self.plan)
        out = lp.Filter(e, plan)
        if plan is not self.plan:
            # drop the window columns the predicate read
            out = lp.Project(_names(self.plan), out)
        return DataFrame(self.session, out)

    where = filter

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

    sort = order_by

    def limit(self, n: int) -> "DataFrame":
        return DataFrame(self.session, lp.Limit(n, self.plan))

    def union(self, other: "DataFrame") -> "DataFrame":
        """UNION ALL, by position, under this frame's column names."""
        return DataFrame(self.session, lp.Union([self.plan, other.plan]))

    def repartition(self, num_partitions: int, *cols_) -> "DataFrame":
        """``num_partitions`` partitions by the hash of ``cols_``, or
        round-robin without them; the result comes partition by
        partition, each partition's rows in their input order."""
        return DataFrame(self.session, lp.Repartition(
            num_partitions, [_expr_or_name(c) for c in cols_], self.plan))

    def repartition_by_range(self, num_partitions: int,
                             *cols_) -> "DataFrame":
        """``num_partitions`` partitions by ranges of the sort columns
        (``desc()`` markers honored; Spark's default null order), their
        bounds sampled from the input."""
        orders = []
        for c in cols_:
            if isinstance(c, _SortCol):
                orders.append((c.expr, c.ascending, c.ascending))
            else:
                orders.append((_expr_or_name(c), True, True))
        if not orders:
            raise ValueError("repartition_by_range needs at least one "
                             "sort column")
        return DataFrame(self.session, lp.Repartition(
            num_partitions, [], self.plan, mode="range", orders=orders))

    repartitionByRange = repartition_by_range

    def rollup(self, *cols_) -> "GroupedData":
        """Grouping sets (a, b), (a) and (): the keys dropped from the
        right."""
        return GroupedData(self, self._key_names(cols_), mode="rollup")

    def cube(self, *cols_) -> "GroupedData":
        """A grouping set for every subset of the keys."""
        return GroupedData(self, self._key_names(cols_), mode="cube")

    def _key_names(self, cols_) -> List[Expression]:
        exprs = [_expr_or_name(c) for c in cols_]
        if not all(isinstance(e, UnresolvedAttribute) for e in exprs):
            raise ValueError(
                "rollup/cube keys must be plain column references")
        return exprs

    def agg(self, *agg_cols) -> "DataFrame":
        """A global aggregation: one row over the whole input."""
        return GroupedData(self, []).agg(*agg_cols)

    def join(self, other: "DataFrame", on=None, how: str = "inner"
             ) -> "DataFrame":
        """Equi-join on ``on``: one key or a list, each a column name
        (the same name on both sides) or an expression bound against each
        side, of type inner, left, right, full, semi, anti or cross
        (pyspark's aliases accepted; a cross join pairs every row and
        takes no keys, or ignores them as the JAX package does).  As in
        pyspark's USING join, each named key appears once in the output:
        the left one for inner and left joins, the right one for right
        joins, and the first non-null of the two for full joins."""
        on = [] if on is None else [on] if isinstance(on, (str, Column,
                                                          Expression)) \
            else list(on)
        how = {"left_outer": "left", "right_outer": "right",
               "outer": "full", "full_outer": "full", "leftsemi": "semi",
               "left_semi": "semi", "leftanti": "anti",
               "left_anti": "anti"}.get(how, how)
        if not on and how != "cross":
            raise ValueError(f"a {how} join needs keys (on=...)")
        keys = [_expr_or_name(k) for k in on]
        plan = lp.Join(self.plan, other.plan, keys, list(keys), how)
        names = [k for k in on if isinstance(k, str)]
        if names and len(names) == len(on) and how in ("inner", "left",
                                                        "right", "full"):
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

    @property
    def schema(self) -> Schema:
        return self.plan.output_schema()

    @property
    def columns(self) -> List[str]:
        return self.plan.output_schema().names

    def count(self) -> int:
        """The number of rows (the result stays on the device)."""
        return sum(b.num_rows for b in self._execute()[1])

    def head(self, n: Optional[int] = None):
        """pyspark's contract: ``head()`` the first row (a dict) or None,
        ``head(n)`` a list of the first n rows."""
        if n is None:
            rows = self.limit(1).collect()
            return rows[0] if rows else None
        return self.limit(n).collect()

    def take(self, n: int) -> List[dict]:
        return self.limit(n).collect()

    def first(self):
        return self.head(1)

    def to_numpy(self) -> Dict[str, np.ndarray]:
        """The result as numpy arrays, a numpy masked array for a column
        with nulls; dates as datetime64[D], timestamps as datetime64[us],
        strings as an object array."""
        return self._host().to_numpy()

    @contextlib.contextmanager
    def _query(self):
        """The query's scope (``lifecycle.query_scope``) under its capture
        (``tracing.query_trace``); both reuse an enclosing one."""
        with lifecycle.query_scope(self.session.conf) as qc, \
                query_trace(self.session.conf):
            yield qc

    def _execute(self, egress: bool = False):
        """Plan and run the query, in its query scope -> (its schema, its
        result): the device batches, or with ``egress`` the host parts
        of the result egress (``exec/basic.py: device_to_host``, whose
        pull metrics go on the root operator).  The session keeps the
        plan and the query's context once the drain succeeded (a failed
        query leaves the earlier query's profile in place)."""
        from spark_rapids_tpu_torch.exec.basic import HostToDeviceExec, \
            device_to_host, host_egress
        conf = self.session.conf
        root = plan_query(self.plan, conf)
        schema = root.output_schema
        with self._query() as qc:
            ctx = ExecContext(conf, self.session.device,
                              self.session.runtime)
            run = root
            if root.on_host:
                # placed on the host (plan/placement.py): the result
                # egress pulls nothing, and device batches come up
                # through a counted upload
                if egress:
                    ctx = ctx.on_host()
                else:
                    run = HostToDeviceExec(root)
            # closing the stream ends every operator's generator, and
            # with them the handles and threads they hold, on an error
            # as well
            with contextlib.closing(run.execute(ctx)) as stream:
                if egress:
                    with contextlib.closing(
                            host_egress(stream, schema) if root.on_host
                            else device_to_host(stream, schema, ctx,
                                                root.metrics)) as parts:
                        out = list(parts)
                else:
                    out = list(stream)
        if qc.sem_wait_ms:
            root.metrics["semWaitMs"] += qc.sem_wait_ms
        self.session._last_plan = root
        self.session._last_query = qc
        if conf.placement_mode != "tpu":
            # the calibration feed and the cost-error accounting
            # (plan/cost.py, plan/placement.py); never under the
            # default mode
            from spark_rapids_tpu_torch.plan import cost, placement
            cost.observe_plan(root)
            placement.note_query(list(root.placement), qc.wall_ms,
                                 query_id=qc.query_id)
        return schema, out

    def to_device_batches(self) -> List[ColumnarBatch]:
        """Run the query and return its result's ``ColumnarBatch``es as
        they are, their tensors still on the session's device (the
        counterpart of the JAX package's handoff to ML code).  Planes
        that the device scan cache holds come back as copies, so a
        write into a returned tensor changes no later query's input."""
        return self._unshared(self._execute()[1])

    def _unshared(self, batches: List[ColumnarBatch]
                  ) -> List[ColumnarBatch]:
        """``batches`` with copies in place of the scan cache's planes
        (``encoding.unshare_batches``): torch tensors can be written,
        where the JAX package's arrays cannot."""
        return encoding.unshare_batches(
            batches, self.session.runtime.scan_cache.storages())

    def explain(self, analyze: bool = False) -> str:
        """The plan as text, also written to stdout.  ``analyze=False``
        plans without running anything: the logical plan (``*`` marks a
        node the port runs on its device, which is every node it
        plans), then ``Physical plan:`` and the operators' tree.
        ``analyze=True`` runs the query and renders the executed tree
        with each operator's rows, batches, wall and self time and
        every other non-zero metric (``obs/profile.py``)."""
        import sys
        if analyze:
            self._execute(egress=True)
            txt = self.session.last_query_profile().render()
        else:
            root = plan_query(self.plan, self.session.conf)
            txt = "\n".join(_explain_lines(self.plan)) + \
                "\n\nPhysical plan:\n" + root.tree_string()
        sys.stdout.write(txt + "\n")
        return txt

    def _host(self) -> "HostResult":
        """The result on the host, through the result egress in the
        query's scope (each pull bounded by the hang watchdog,
        ``transfer.device_pull``)."""
        schema, parts = self._execute(egress=True)
        cols = {}
        for f in schema:
            if parts:
                cols[f.name] = (
                    concat_host_values([p[f.name][0] for p in parts]),
                    np.concatenate([p[f.name][1] for p in parts]))
            else:
                cols[f.name] = (empty_host_values(f.dtype),
                                np.zeros(0, np.bool_))
        return HostResult(schema, cols)

    def to_arrow(self):
        """The result as a pyarrow Table (imports pyarrow)."""
        return self._host().to_arrow()

    def collect(self) -> List[dict]:
        """The result as a list of row dicts (None for null); dates come
        back as ``datetime.date``, timestamps as UTC
        ``datetime.datetime``, strings as ``str``."""
        return self._host().collect()

    @property
    def write(self) -> "DataFrameWriter":
        """A ``DataFrameWriter`` (``io/writers.py``)."""
        return DataFrameWriter(self)

    def to_torch(self) -> Tuple[Dict[str, object], Dict[str, torch.Tensor],
                                int]:
        """-> (columns, masks, num_rows): the result's data planes and
        validity masks, still on the session's device, trimmed to the
        row count (the counterpart of the JAX package's ``to_jax``).  A
        string column comes back as ``(lengths, chars)``.  Planes that
        the device scan cache holds come back as copies."""
        with self._query():
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
        batch, = self._unshared([concat_batches(batches)])
        n = batch.num_rows
        cols = {f.name: c.data[:n] if c.chars is None else
                (c.data[:n], c.chars[:n])
                for f, c in zip(schema, batch.columns)}
        masks = {f.name: c.validity[:n]
                 for f, c in zip(schema, batch.columns)}
        return cols, masks, n


class HostResult:
    """A query's result on the host: its schema and its columns
    (``HostColumns``: each a values array, or ``HostStrings``, and a
    validity array).  ``nbytes`` sizes it for the result cache."""

    __slots__ = ("schema", "columns")

    def __init__(self, schema: Schema, columns: HostColumns):
        self.schema = schema
        self.columns = columns

    @property
    def num_rows(self) -> int:
        if not self.schema.fields:
            return 0
        return len(self.columns[self.schema.fields[0].name][1])

    @property
    def nbytes(self) -> int:
        total = 0
        for values, valid in self.columns.values():
            total += valid.nbytes
            if isinstance(values, HostStrings):
                total += values.chars.nbytes + values.lengths.nbytes
            else:
                total += values.nbytes
        return int(total)

    def equals(self, other: "HostResult") -> bool:
        """Bit for bit: the same names and types, nulls at the same
        rows, and every valid value the same bytes (a float's bits, a
        string's bytes)."""
        if [(f.name, f.dtype) for f in self.schema] != \
                [(f.name, f.dtype) for f in other.schema]:
            return False
        for f in self.schema:
            (a, av), (b, bv) = self.columns[f.name], other.columns[f.name]
            if not np.array_equal(av, bv):
                return False
            if isinstance(a, HostStrings):
                la = np.where(av, a.lengths, 0)
                if not np.array_equal(la, np.where(bv, b.lengths, 0)):
                    return False
                w = min(a.width, b.width)
                inside = np.arange(max(a.width, b.width))[None, :] < \
                    la[:, None]
                if inside[:, w:].any() or not np.array_equal(
                        np.where(inside[:, :w], a.chars[:, :w], 0),
                        np.where(inside[:, :w], b.chars[:, :w], 0)):
                    return False
            elif not np.array_equal(a[av].view(np.uint8),
                                    b[bv].view(np.uint8)):
                return False
        return True

    def to_arrow(self):
        """A pyarrow Table (imports pyarrow)."""
        return host_columns_to_arrow(self.schema, self.columns)

    def to_numpy(self) -> Dict[str, np.ndarray]:
        """See ``DataFrame.to_numpy``."""
        out = {}
        for f in self.schema:
            values, valid = self.columns[f.name]
            if f.dtype == STRING:
                values = np.array(values.to_pylist(), dtype=object)
            elif f.dtype == DATE:
                values = values.astype("datetime64[D]")
            elif f.dtype == TIMESTAMP:
                values = values.astype("datetime64[us]")
            out[f.name] = values if valid.all() else \
                np.ma.masked_array(values, mask=~valid)
        return out

    def collect(self) -> List[dict]:
        """See ``DataFrame.collect``."""
        out_cols = []
        for f in self.schema:
            values, valid = self.columns[f.name]
            if f.dtype == STRING:
                vals = values.to_pylist()
            else:
                vals = values.tolist()
            ok = valid.tolist()
            if f.dtype == DATE:
                epoch = datetime.date(1970, 1, 1)
                vals = [epoch + datetime.timedelta(days=d) if o else None
                        for d, o in zip(vals, ok)]
            elif f.dtype == TIMESTAMP:
                epoch = datetime.datetime(1970, 1, 1,
                                          tzinfo=datetime.timezone.utc)
                vals = [epoch + datetime.timedelta(microseconds=u) if o
                        else None for u, o in zip(vals, ok)]
            out_cols.append([v if o else None for v, o in zip(vals, ok)])
        return [dict(zip(self.schema.names, row)) for row in zip(*out_cols)]


GROUPING_ID_COL = "__grouping_id__"


class GroupedData:
    def __init__(self, df: DataFrame, groupings: List[Expression],
                 mode: Optional[str] = None):
        self.df = df
        self.groupings = groupings
        self.mode = mode  # None, "rollup" or "cube"

    def agg(self, *agg_cols) -> DataFrame:
        aggs = [_to_expr(c) for c in agg_cols]
        if self.mode is None:
            return DataFrame(self.df.session, lp.Aggregate(
                self.groupings, aggs, self.df.plan))
        return self._grouping_sets_agg(aggs)

    def count(self) -> DataFrame:
        return self.agg(Column(Alias(Count(Literal(1)), "count")))

    def _grouping_sets_agg(self, aggs: List[Expression]) -> DataFrame:
        """rollup / cube -> an Expand (each row once a grouping set, the
        keys it leaves out masked to null in copies of the keys, and the
        grouping id), an Aggregate by the copies and the id, and a
        Project that names the copies as the keys (Spark's
        ResolveGroupingAnalytics).  The aggregates read the real
        columns, which pass through unmasked."""
        child_schema = self.df.plan.output_schema()
        key_names = [k.col_name for k in self.groupings]
        key_dtypes = [bind_expression(k, child_schema).dtype
                      for k in self.groupings]
        nk = len(key_names)
        if self.mode == "rollup":
            # the full set first, then keys dropped from the right
            masked_sets = [set(range(nk - i, nk)) for i in range(nk + 1)]
        else:
            masked_sets = [{i for i in range(nk)
                            if gid & (1 << (nk - 1 - i))}
                           for gid in range(1 << nk)]
        gk_names = [f"__gk_{kn}__" for kn in key_names]
        names = [f.name for f in child_schema] + gk_names + \
            [GROUPING_ID_COL]
        projections = []
        for masked in masked_sets:
            gid = sum(1 << (nk - 1 - i) for i in masked)
            proj: List[Expression] = [UnresolvedAttribute(f.name)
                                      for f in child_schema]
            for i, (kn, gkn, kd) in enumerate(zip(key_names, gk_names,
                                                  key_dtypes)):
                src = Literal(None, kd) if i in masked \
                    else UnresolvedAttribute(kn)
                proj.append(Alias(src, gkn))
            proj.append(Alias(Literal(gid), GROUPING_ID_COL))
            projections.append(proj)
        expand = lp.Expand(projections, names, self.df.plan)
        groupings = [UnresolvedAttribute(n) for n in gk_names] + \
            [UnresolvedAttribute(GROUPING_ID_COL)]
        # grouping_id() passes the id through; the rest aggregate
        out_cols: List[Tuple[Optional[str], Optional[str]]] = []
        real_aggs: List[Expression] = []
        for a in aggs:
            target = a.children[0] if isinstance(a, Alias) else a
            if isinstance(target, UnresolvedAttribute) and \
                    target.col_name == GROUPING_ID_COL:
                out_cols.append((a.name if isinstance(a, Alias)
                                 else "grouping_id()", GROUPING_ID_COL))
            else:
                real_aggs.append(a)
                out_cols.append((None, None))
        agg_plan = lp.Aggregate(groupings, real_aggs, expand)
        agg_out = agg_plan.output_schema().names[nk + 1:]
        final: List[Expression] = [
            Alias(UnresolvedAttribute(gkn), kn)
            for gkn, kn in zip(gk_names, key_names)]
        it = iter(agg_out)
        for disp, src in out_cols:
            if src is not None:
                final.append(Alias(UnresolvedAttribute(src), disp))
            else:
                final.append(UnresolvedAttribute(next(it)))
        return DataFrame(self.df.session, lp.Project(final, agg_plan))


class DataFrameReader:
    """``session.read``: ``schema`` (a user schema, applied by position
    to CSV), then ``parquet``, ``csv`` or ``orc``."""

    def __init__(self, session):
        self.session = session
        self._schema: Optional[Schema] = None

    def schema(self, schema: Schema) -> "DataFrameReader":
        self._schema = schema
        return self

    def parquet(self, *paths) -> DataFrame:
        from spark_rapids_tpu_torch.io.parquet import read_schema
        return DataFrame(self.session, lp.ParquetRelation(
            list(paths), self._schema or read_schema(list(paths))))

    def csv(self, *paths, header: bool = True, sep: str = ",") -> DataFrame:
        from spark_rapids_tpu_torch.io.csv import read_csv_relation
        return DataFrame(self.session, read_csv_relation(
            list(paths), self._schema, header=header, sep=sep))

    def orc(self, *paths) -> DataFrame:
        from spark_rapids_tpu_torch.io.orc import read_orc_relation
        return DataFrame(self.session, read_orc_relation(
            list(paths), self._schema))


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


def range_df(session, start: int, end: Optional[int] = None,
             step: int = 1) -> DataFrame:
    """``session.range``: ``range(n)`` is 0 to n - 1."""
    if end is None:
        start, end = 0, start
    return DataFrame(session, lp.Range(start, end, step))
