"""Logical plan nodes produced by the DataFrame API.

Counterpart of ``spark_rapids_tpu/plan/logical.py``, with the same node
set.  Expressions inside are unresolved (attributes by name); the
planner binds them against the child's output schema.  A file relation's
``pushed`` is a predicate ``plan/planner.py: push_scan_filters`` folded
into it from the Filter above: the scan prunes hive partitions, parquet
row groups and ORC stripes by it, and the Filter stays in the plan.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from spark_rapids_tpu_torch.columnar.batch import HostColumns
from spark_rapids_tpu_torch.columnar.dtypes import INT64, Field, Schema
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
    def __init__(self, paths, schema: Schema,
                 pushed: Optional[Expression] = None):
        self.paths = paths
        self.schema = schema
        self.pushed = pushed
        self.children = []

    def output_schema(self) -> Schema:
        return self.schema


class CsvRelation(LogicalPlan):
    """CSV files read with ``header`` and the delimiter ``sep``; the
    port prunes hive partitions by ``pushed`` (the JAX package's CSV
    scan reads every file and leaves it all to the Filter)."""

    def __init__(self, paths, schema: Schema, header: bool = True,
                 sep: str = ",", pushed: Optional[Expression] = None):
        self.paths = paths
        self.schema = schema
        self.header = header
        self.sep = sep
        self.pushed = pushed
        self.children = []

    def output_schema(self) -> Schema:
        return self.schema


class OrcRelation(LogicalPlan):
    def __init__(self, paths, schema: Schema,
                 pushed: Optional[Expression] = None):
        self.paths = paths
        self.schema = schema
        self.pushed = pushed
        self.children = []

    def output_schema(self) -> Schema:
        return self.schema


FILE_RELATIONS = (ParquetRelation, CsvRelation, OrcRelation)


def with_paths(rel: LogicalPlan, paths) -> LogicalPlan:
    """A file relation of the same kind, schema, options and pushed
    predicate over ``paths``."""
    if isinstance(rel, CsvRelation):
        return CsvRelation(paths, rel.schema, rel.header, rel.sep,
                           rel.pushed)
    return type(rel)(paths, rel.schema, rel.pushed)


class Range(LogicalPlan):
    """The int64 column ``id``: ``start`` to ``end`` (exclusive) by
    ``step``."""

    def __init__(self, start: int, end: int, step: int = 1):
        self.start, self.end, self.step = int(start), int(end), int(step)
        self.children = []

    def output_schema(self) -> Schema:
        return Schema([Field("id", INT64, nullable=False)])


class Union(LogicalPlan):
    """The children's rows back to back (UNION ALL), under the first
    child's schema."""

    def __init__(self, children: Sequence[LogicalPlan]):
        self.children = list(children)

    def output_schema(self) -> Schema:
        return self.children[0].output_schema()


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
    semi or anti.  ``condition``, over the left side's columns followed
    by the right side's, decides which key-matched pairs count: an inner
    or cross join keeps those rows, an outer join null-extends a row
    none of whose pairs holds, and a semi (anti) join keeps a left row
    with at least one (with no) pair where it holds."""

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


class Expand(LogicalPlan):
    """Every input row once per projection list, the grouping-sets
    primitive behind rollup and cube; ``names`` names the output
    columns."""

    def __init__(self, projections: Sequence[Sequence[Expression]],
                 names: Sequence[str], child: LogicalPlan):
        self.projections = [list(p) for p in projections]
        self.names = list(names)
        self.children = [child]

    def output_schema(self) -> Schema:
        from spark_rapids_tpu_torch.exec.expand import expand_schema
        schema = self.children[0].output_schema()
        return expand_schema([[bind_expression(e, schema) for e in p]
                              for p in self.projections], self.names)


class Generate(LogicalPlan):
    """explode / posexplode of a literal array, its column (and the
    position's) appended to the child's; ``names``: ([position name,]
    element name)."""

    def __init__(self, generator, names: Sequence[str],
                 child: LogicalPlan):
        self.generator = generator
        self.names = list(names)
        self.children = [child]

    def output_schema(self) -> Schema:
        from spark_rapids_tpu_torch.exec.generate import generate_schema
        return generate_schema(self.generator,
                               self.children[0].output_schema(), self.names)


class Repartition(LogicalPlan):
    """``mode``: hash, roundrobin, single or range.  Range partitioning
    carries sort ``orders`` [(expr, ascending, nulls_first)] instead of
    keys."""

    def __init__(self, num_partitions: int, keys: Sequence[Expression],
                 child: LogicalPlan, mode: str = "hash", orders=None):
        self.num_partitions = int(num_partitions)
        self.keys = list(keys)
        self.orders = list(orders or [])
        self.mode = mode
        self.children = [child]

    def output_schema(self) -> Schema:
        return self.children[0].output_schema()
