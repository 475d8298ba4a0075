"""Logical plan nodes produced by the DataFrame API.

Counterpart of ``spark_rapids_tpu/plan/logical.py``, trimmed to the nodes
the port lowers.  Expressions inside are unresolved (attributes by
name); the planner binds them against the child's output schema.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from spark_rapids_tpu_torch.columnar.batch import HostColumns
from spark_rapids_tpu_torch.columnar.dtypes import Field, Schema
from spark_rapids_tpu_torch.exprs.base import Expression, bind_expression


class LogicalPlan:
    children: List["LogicalPlan"] = []

    @property
    def node_name(self) -> str:
        return type(self).__name__

    def output_schema(self) -> Schema:
        raise NotImplementedError(type(self).__name__)


def _bound_schema(exprs: Sequence[Expression], child: LogicalPlan) -> Schema:
    schema = child.output_schema()
    bound = [bind_expression(e, schema) for e in exprs]
    return Schema([Field(e.name, e.dtype, e.nullable) for e in bound])


class LocalRelation(LogicalPlan):
    """In-memory host columns."""

    def __init__(self, schema: Schema, cols: HostColumns):
        self.schema = schema
        self.cols = cols
        self.children = []

    def output_schema(self) -> Schema:
        return self.schema


class ParquetRelation(LogicalPlan):
    def __init__(self, paths, schema: Schema):
        self.paths = paths
        self.schema = schema
        self.children = []

    def output_schema(self) -> Schema:
        return self.schema


class Project(LogicalPlan):
    def __init__(self, exprs: Sequence[Expression], child: LogicalPlan):
        self.exprs = list(exprs)
        self.children = [child]

    def output_schema(self) -> Schema:
        return _bound_schema(self.exprs, self.children[0])


class Filter(LogicalPlan):
    def __init__(self, pred: Expression, child: LogicalPlan):
        self.pred = pred
        self.children = [child]

    def output_schema(self) -> Schema:
        return self.children[0].output_schema()


class Sort(LogicalPlan):
    """orders: [(expr, ascending, nulls_first)]"""

    def __init__(self, orders: Sequence[Tuple[Expression, bool, bool]],
                 child: LogicalPlan):
        self.orders = list(orders)
        self.children = [child]

    def output_schema(self) -> Schema:
        return self.children[0].output_schema()


class Limit(LogicalPlan):
    def __init__(self, n: int, child: LogicalPlan):
        self.n = int(n)
        self.children = [child]

    def output_schema(self) -> Schema:
        return self.children[0].output_schema()


class Join(LogicalPlan):
    """An equi-join on ``left_keys[i] == right_keys[i]``; join_type is
    inner, cross (every pair; the keys are ignored), left, right, full,
    semi or anti.  ``condition``, over the join's output columns, keeps
    only the joined rows where it holds (inner and cross joins only; the
    planner raises on any other)."""

    def __init__(self, left: LogicalPlan, right: LogicalPlan,
                 left_keys: Sequence[Expression],
                 right_keys: Sequence[Expression], join_type: str = "inner",
                 condition: Optional[Expression] = None):
        self.children = [left, right]
        self.left_keys = list(left_keys)
        self.right_keys = list(right_keys)
        self.join_type = join_type
        self.condition = condition

    def output_schema(self) -> Schema:
        left, right = self.children
        jt = self.join_type
        if jt in ("semi", "anti"):
            return left.output_schema()
        lf = list(left.output_schema().fields)
        rf = list(right.output_schema().fields)
        if jt in ("right", "full"):
            lf = [Field(f.name, f.dtype, True) for f in lf]
        if jt in ("left", "full"):
            rf = [Field(f.name, f.dtype, True) for f in rf]
        return Schema(lf + rf)


class Aggregate(LogicalPlan):
    """groupings: grouping expressions; aggregates: aggregate functions,
    bare or under an Alias."""

    def __init__(self, groupings: Sequence[Expression],
                 aggregates: Sequence[Expression], child: LogicalPlan):
        self.groupings = list(groupings)
        self.aggregates = list(aggregates)
        self.children = [child]

    def output_schema(self) -> Schema:
        return _bound_schema(self.groupings + self.aggregates,
                             self.children[0])


class Window(LogicalPlan):
    """Appends one column per window expression to the child's columns;
    every expression of one node shares a (partition, order) spec (the
    API groups them).  window_cols: [(output name, WindowExpression)]."""

    def __init__(self, window_cols: Sequence[Tuple[str, Expression]],
                 child: LogicalPlan):
        self.window_cols = list(window_cols)
        self.children = [child]

    def output_schema(self) -> Schema:
        child_schema = self.children[0].output_schema()
        fields = list(child_schema.fields)
        for name, w in self.window_cols:
            b = bind_expression(w, child_schema)
            fields.append(Field(name, b.dtype, b.nullable))
        return Schema(fields)
