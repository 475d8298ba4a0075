"""DataFrame API, the user surface.

Counterpart of ``spark_rapids_tpu/api.py``, trimmed to what the port
runs: ``select``, ``filter``, ``group_by(...).agg(...)`` and the global
``agg``, ``order_by`` (with ``Column.asc()`` / ``desc()``), ``limit``,
``join`` on key names, the string predicates of ``Column`` and the
actions ``collect``, ``to_arrow`` and ``to_torch``.  Actions plan the
query (``plan/planner.py``) and run it on the session's device.
"""

from __future__ import annotations

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
from spark_rapids_tpu_torch.exprs import predicates as pr
from spark_rapids_tpu_torch.exprs import strings as ss
from spark_rapids_tpu_torch.exprs.base import Alias, BoundReference, \
    Expression, Literal, UnresolvedAttribute
from spark_rapids_tpu_torch.exprs.nullexprs import Coalesce
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

    def __repr__(self):
        return f"Column<{self.expr.name}>"


class _SortCol:
    """(expression, direction) marker made by ``Column.asc()`` and
    ``desc()``."""

    __slots__ = ("expr", "ascending")

    def __init__(self, expr: Expression, ascending: bool):
        self.expr = expr
        self.ascending = ascending


def col(name: str) -> Column:
    return Column(UnresolvedAttribute(name))


def lit(value, dtype: Optional[DataType] = None) -> Column:
    return Column(Literal(value, dtype))


def _expr_or_name(c) -> Expression:
    return UnresolvedAttribute(c) if isinstance(c, str) else _to_expr(c)


class DataFrame:
    """Lazy logical-plan builder; actions plan and execute."""

    def __init__(self, session, plan: lp.LogicalPlan):
        self.session = session
        self.plan = plan

    # -- transformations ----------------------------------------------------

    def select(self, *cols_) -> "DataFrame":
        return DataFrame(self.session,
                         lp.Project([_expr_or_name(c) for c in cols_],
                                    self.plan))

    def filter(self, cond) -> "DataFrame":
        return DataFrame(self.session, lp.Filter(_to_expr(cond), self.plan))

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
        return DataFrame(self.session, lp.Sort(orders, self.plan))

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

    # -- actions ------------------------------------------------------------

    def _execute(self):
        """Plan and run the query; the device batches of its result."""
        root = plan_query(self.plan, self.session.conf)
        ctx = ExecContext(self.session.conf, self.session.device)
        batches = list(root.execute(ctx))
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
