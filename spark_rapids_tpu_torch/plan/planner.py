"""Logical plan -> port operators.

Counterpart of ``spark_rapids_tpu/plan/planner.py:plan_query``.  It
lowers every node the JAX package lowers to its device but the CSV and
ORC relations: LocalRelation, ParquetRelation, Range, Union, Project,
Filter, Aggregate (grouped, global or distinct), Sort, Limit, Join,
Window (``TorchWindowExec``; an offset RANGE frame over a non-numeric
order column raises ``ValueError``, as both of the JAX package's engines
do), Expand, Generate and Repartition (``TorchShuffleExchangeExec``);
each maximal chain of Project and Filter becomes one fused
``TorchStageExec`` (the JAX package's fusion pass), an Aggregate and the
stream side of a join read their input through the coalesce the JAX
package inserts there, and a Limit over a Sort becomes a top-N.  A join
takes the JAX package's static strategy (``_plan_join``): broadcast the
right side when its estimated size is under
``spark.sql.autoBroadcastJoinThreshold``, else the left behind a swap,
else a hash join that builds on the right.  Before lowering,
``push_join_conditions`` moves the conjuncts of a Filter over an inner
join to the side they name, or into the join's condition.  Any other
node raises: there is no CPU engine to route it to, so a result always
comes from the device.

Every bound expression passes ``check_expression``: an incompatible
expression (``Upper``, ``Lower``, ``InitCap``, ``Rand``) needs
``spark.rapids.sql.incompatibleOps.enabled`` or its own
``spark.rapids.sql.expression.<Name>`` key, a gated cast its
``spark.rapids.sql.cast*`` key, and a nondeterministic expression may
stand only in a projection or a filter; otherwise it raises
``NotImplementedError`` (``ValueError`` for the placement, as in the JAX
package) naming the key.
"""

from __future__ import annotations

import copy
import os
from typing import List, Optional

import numpy as np

from spark_rapids_tpu_torch.columnar.dtypes import BOOLEAN, STRING, Field
from spark_rapids_tpu_torch.conf import BROADCAST_THRESHOLD, TorchConf
from spark_rapids_tpu_torch.exec.aggregate import TorchHashAggregateExec
from spark_rapids_tpu_torch.exec.base import TorchExec
from spark_rapids_tpu_torch.exec.basic import TorchLocalLimitExec, \
    TorchLocalScanExec, TorchRangeExec, TorchUnionExec
from spark_rapids_tpu_torch.exec.broadcast import \
    TorchBroadcastExchangeExec, TorchBroadcastHashJoinExec
from spark_rapids_tpu_torch.exec.coalesce import TorchCoalesceBatchesExec
from spark_rapids_tpu_torch.exec.exchange import TorchShuffleExchangeExec
from spark_rapids_tpu_torch.exec.expand import TorchExpandExec
from spark_rapids_tpu_torch.exec.generate import TorchGenerateExec
from spark_rapids_tpu_torch.exec.joins import TorchHashJoinExec
from spark_rapids_tpu_torch.exec.sort import TorchSortExec, TorchTopNExec
from spark_rapids_tpu_torch.exec.stage import TorchStageExec
from spark_rapids_tpu_torch.exec.window import TorchWindowExec
from spark_rapids_tpu_torch.exprs import predicates as pr
from spark_rapids_tpu_torch.exprs.base import BoundReference, Expression, \
    UnresolvedAttribute, bind_expression
from spark_rapids_tpu_torch.exprs.cast import Cast, gate_key
from spark_rapids_tpu_torch.exprs.nondeterministic import \
    contains_nondeterministic
from spark_rapids_tpu_torch.io.parquet import TorchParquetScanExec, \
    expand_paths
from spark_rapids_tpu_torch.plan import logical as lp

_NODES = (lp.Project, lp.Filter, lp.Aggregate, lp.Sort, lp.Limit, lp.Join,
          lp.Window, lp.Union, lp.Expand, lp.Generate, lp.Repartition)

# results that differ from Spark's in corner cases (the JAX package's
# incompat notes)
_INCOMPAT = {"Upper": "ASCII-only case conversion",
             "Lower": "ASCII-only case conversion",
             "InitCap": "ASCII-only case conversion",
             "Rand": "threefry RNG sequence differs from Spark XORShift"}


def check_expression(e: Expression, conf: TorchConf) -> None:
    """Raise on a bound expression the conf does not enable."""
    name = type(e).__name__
    if name in _INCOMPAT and not conf.is_expression_enabled(name, True):
        raise NotImplementedError(
            f"{name} ({_INCOMPAT[name]}) needs "
            "spark.rapids.sql.incompatibleOps.enabled or "
            f"spark.rapids.sql.expression.{name} (the torch port has no "
            "CPU engine to run it otherwise)")
    if isinstance(e, Cast):
        gate = gate_key(e.children[0].dtype, e.to)
        if gate is not None and not conf.get(gate):
            raise NotImplementedError(
                f"cast {e.children[0].dtype.name} -> {e.to.name} needs "
                f"{gate.key} (the torch port has no CPU engine to run it "
                "otherwise)")
    for c in e.children:
        check_expression(c, conf)


def _bind(e: Expression, schema, conf: TorchConf,
          placed: bool = False) -> Expression:
    """``bind_expression`` and ``check_expression``; ``placed``: the
    expression stands in a projection or a filter, where a
    nondeterministic one may."""
    bound = bind_expression(e, schema)
    check_expression(bound, conf)
    if not placed and contains_nondeterministic(bound):
        raise ValueError(
            "nondeterministic expressions (rand, monotonically_increasing_id,"
            " spark_partition_id) are only allowed in select()/"
            "with_column()/filter()")
    return bound


def _stage(step, child: TorchExec) -> TorchStageExec:
    if isinstance(child, TorchStageExec):
        return TorchStageExec(child.steps + [step], child.children[0])
    return TorchStageExec([step], child)


def plan_query(node: lp.LogicalPlan,
               conf: Optional[TorchConf] = None) -> TorchExec:
    """The query's operators, after ``push_join_conditions``."""
    conf = conf if conf is not None else TorchConf()
    return _lower(push_join_conditions(node), conf)


def _lower(node: lp.LogicalPlan, conf: TorchConf) -> TorchExec:
    if isinstance(node, lp.LocalRelation):
        return TorchLocalScanExec(node.schema, node.cols)
    if isinstance(node, lp.ParquetRelation):
        return TorchParquetScanExec(node.paths, node.schema)
    if isinstance(node, lp.Range):
        return TorchRangeExec(node.start, node.end, node.step)
    if not isinstance(node, _NODES):
        raise NotImplementedError(
            f"{node.node_name} is not in the torch port yet")
    if isinstance(node, lp.Join):
        return _plan_join(node, conf)
    if isinstance(node, lp.Union):
        return TorchUnionExec([_lower(c, conf) for c in node.children])
    if isinstance(node, lp.Limit) and isinstance(node.children[0], lp.Sort):
        # limit over sort: a top-N that never holds more than the limit
        # and one batch
        sort = node.children[0]
        schema = sort.children[0].output_schema()
        return TorchTopNExec(
            [(_bind(e, schema, conf), asc, nf)
             for e, asc, nf in sort.orders], node.n,
            _lower(sort.children[0], conf))
    child = _lower(node.children[0], conf)
    schema = node.children[0].output_schema()

    def bind(e, placed=False):
        return _bind(e, schema, conf, placed)

    if isinstance(node, lp.Project):
        return _stage(("project", tuple(bind(e, True) for e in node.exprs)),
                      child)
    if isinstance(node, lp.Filter):
        return _stage(("filter", (bind(node.pred, True),)), child)
    if isinstance(node, lp.Limit):
        return TorchLocalLimitExec(node.n, child)
    if isinstance(node, lp.Window):
        bound = [(name, bind(w)) for name, w in node.window_cols]
        for _, w in bound:
            if w.unsupported is not None:
                raise ValueError(w.unsupported)
        return TorchWindowExec(bound, child)
    if isinstance(node, lp.Expand):
        return TorchExpandExec([[bind(e) for e in p]
                                for p in node.projections], node.names,
                               child)
    if isinstance(node, lp.Generate):
        return TorchGenerateExec(node.generator, node.names, child)
    if isinstance(node, lp.Repartition):
        return TorchShuffleExchangeExec(
            node.num_partitions, [bind(e) for e in node.keys], node.mode,
            child, orders=[(bind(e), asc, nf)
                           for e, asc, nf in node.orders])
    if isinstance(node, lp.Aggregate):
        return TorchHashAggregateExec(
            [bind(e) for e in node.groupings],
            [bind(e) for e in node.aggregates],
            TorchCoalesceBatchesExec(child))
    return TorchSortExec([(bind(e), asc, nf) for e, asc, nf in node.orders],
                         child)


def _plan_join(n: lp.Join, conf: TorchConf) -> TorchExec:
    """The JAX package's static join strategy (its ``_plan_join`` without
    adaptive execution): broadcast the right side when its estimated size
    is under the threshold, else the left side (not for semi and anti
    joins, which must stream the left), the smaller one when both
    qualify; else a hash join that builds on the right.  A condition
    binds against the join's output columns."""
    jt = n.join_type
    if n.condition is not None and jt not in ("inner", "cross"):
        raise NotImplementedError(
            f"a join condition on a {jt} join is not supported (inner "
            "joins only, and cross joins)")
    left, right = (_lower(c, conf) for c in n.children)
    lkeys = [_bind(e, n.children[0].output_schema(), conf)
             for e in n.left_keys]
    rkeys = [_bind(e, n.children[1].output_schema(), conf)
             for e in n.right_keys]
    cond = None if n.condition is None else \
        _bind(n.condition, n.output_schema(), conf)
    thresh = conf.get(BROADCAST_THRESHOLD)
    if thresh >= 0:
        r_est = estimate_logical_size(n.children[1])
        l_est = estimate_logical_size(n.children[0])
        r_ok = r_est is not None and r_est <= thresh
        l_ok = l_est is not None and l_est <= thresh and jt in (
            "inner", "cross", "left", "right", "full")
        if r_ok and l_ok:
            if l_est < r_est:
                r_ok = False
            else:
                l_ok = False
        if r_ok:
            return TorchBroadcastHashJoinExec(
                TorchCoalesceBatchesExec(left),
                TorchBroadcastExchangeExec(right), lkeys, rkeys, jt, cond)
        if l_ok:
            return swapped_broadcast_join(
                right, TorchBroadcastExchangeExec(left), lkeys, rkeys, jt,
                len(n.children[0].output_schema()),
                n.output_schema().fields, cond)
    return TorchHashJoinExec(TorchCoalesceBatchesExec(left), right, lkeys,
                             rkeys, jt, cond)


def swapped_broadcast_join(stream: TorchExec,
                           build: TorchBroadcastExchangeExec, lkeys, rkeys,
                           jt: str, nl: int, out_fields: List[Field],
                           cond: Optional[Expression] = None) -> TorchExec:
    """The build-left broadcast: mirror the join type, stream the right
    side against the broadcast left side (the condition's ordinals moved
    onto that [right, left] layout), and restore the original column
    order with a projection.  ``nl``: the left input's field count;
    ``out_fields``: the unswapped join's output fields."""
    mirror = {"inner": "inner", "cross": "cross", "left": "right",
              "right": "left", "full": "full"}[jt]
    nr = len(out_fields) - nl

    def swap(e: Expression) -> Expression:
        if isinstance(e, BoundReference):
            o = e.ordinal
            return BoundReference(o + nr if o < nl else o - nl, e.dtype,
                                  e.nullable, e.col_name)
        return e.with_children([swap(c) for c in e.children]) \
            if e.children else e

    swapped = TorchBroadcastHashJoinExec(
        TorchCoalesceBatchesExec(stream), build, rkeys, lkeys, mirror,
        None if cond is None else swap(cond))
    reorder = tuple(BoundReference(nr + i if i < nl else i - nl, f.dtype,
                                   f.nullable, f.name)
                    for i, f in enumerate(out_fields))
    return _stage(("project", reorder), swapped)


def push_join_conditions(node: lp.LogicalPlan) -> lp.LogicalPlan:
    """Predicate pushdown through inner joins, as the JAX package's
    planner does it (Catalyst's PushPredicateThroughJoin): each conjunct
    of a Filter directly over an inner Join moves to the side whose
    columns it names alone, or, naming both sides, into the join's
    condition.  A conjunct that names a column both sides hold, or no
    column, stays in the Filter.  Nodes are rebuilt, never changed."""
    new_children = [push_join_conditions(c) for c in node.children]
    if any(a is not b for a, b in zip(new_children, node.children)):
        node = copy.copy(node)
        node.children = new_children
    if not (isinstance(node, lp.Filter)
            and isinstance(node.children[0], lp.Join)
            and node.children[0].join_type == "inner"):
        return node
    join = node.children[0]

    def conjuncts(e):
        if isinstance(e, pr.And):
            return conjuncts(e.children[0]) + conjuncts(e.children[1])
        return [e]

    def attr_names(e):
        out = {e.col_name} if isinstance(e, UnresolvedAttribute) else set()
        for c in e.children:
            out |= attr_names(c)
        return out

    def and_all(terms):
        acc = terms[0]
        for t in terms[1:]:
            acc = pr.And(acc, t)
        return acc

    lnames = set(join.children[0].output_schema().names)
    rnames = set(join.children[1].output_schema().names)
    ambiguous = lnames & rnames
    left_p, right_p, cond_p, keep = [], [], [], []
    for c in conjuncts(node.pred):
        refs = attr_names(c)
        if not refs or refs & ambiguous:
            keep.append(c)
        elif refs <= lnames:
            left_p.append(c)
        elif refs <= rnames:
            right_p.append(c)
        elif refs <= (lnames | rnames):
            cond_p.append(c)
        else:
            keep.append(c)
    if not (left_p or right_p or cond_p):
        return node
    new_left, new_right = join.children
    if left_p:
        new_left = push_join_conditions(lp.Filter(and_all(left_p), new_left))
    if right_p:
        new_right = push_join_conditions(
            lp.Filter(and_all(right_p), new_right))
    cond = join.condition
    for t in cond_p:
        cond = t if cond is None else pr.And(cond, t)
    new_join = lp.Join(new_left, new_right, join.left_keys,
                       join.right_keys, join.join_type, condition=cond)
    return lp.Filter(and_all(keep), new_join) if keep else new_join


def _host_bytes(dtype, values, valid) -> int:
    """Bytes an Arrow array of these host values holds: a string column
    its UTF-8 bytes and int32 offsets, a boolean one a bit a row, any
    other its fixed width; plus a validity bitmap when a value is
    null."""
    n = len(valid)
    if dtype == STRING:
        size = int(values.lengths.astype(np.int64).sum()) + 4 * (n + 1)
    elif dtype == BOOLEAN:
        size = (n + 7) // 8
    else:
        size = n * np.dtype(dtype.numpy_dtype).itemsize
    return size + ((n + 7) // 8 if not valid.all() else 0)


def estimate_logical_size(node: lp.LogicalPlan) -> Optional[int]:
    """Build-side size estimate in bytes for the join strategy, as the
    JAX package estimates it: a local relation the bytes its Arrow table
    would hold (so a numpy source and its Arrow twin choose alike), a
    parquet relation its files' sizes, a range 8 bytes a row, Filter,
    Limit and Project their
    child's (an upper bound); anything else unknown (None)."""
    if isinstance(node, lp.LocalRelation):
        return sum(_host_bytes(f.dtype, *node.cols[f.name])
                   for f in node.schema)
    if isinstance(node, lp.ParquetRelation):
        try:
            files = expand_paths(node.paths)
            # no files is an unknown size, never a size of zero
            return sum(os.path.getsize(f) for f in files) if files else None
        except OSError:
            return None
    if isinstance(node, lp.Range):
        # the JAX package's estimate, floor division and all
        return 8 * max(0, (node.end - node.start) // (node.step or 1))
    if isinstance(node, (lp.Filter, lp.Limit, lp.Project)):
        return estimate_logical_size(node.children[0])
    return None
