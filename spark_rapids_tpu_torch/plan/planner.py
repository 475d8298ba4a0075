"""Logical plan -> port operators.

Counterpart of ``spark_rapids_tpu/plan/planner.py:plan_query``.  It
lowers every node the JAX package lowers to its device:
LocalRelation, the parquet, CSV and ORC relations, Range, Union, Project,
Filter, Aggregate (grouped, global or distinct), Sort, Limit, Join,
Window (``TorchWindowExec``; an offset RANGE frame over a non-numeric
order column raises ``ValueError``, as both of the JAX package's engines
do), Expand, Generate and Repartition (``TorchShuffleExchangeExec``);
a Project or Filter lowers to a ``TorchProjectExec`` or
``TorchFilterExec``, and the fusion pass (``plan/fusion.py``) folds each
chain of them into fused ``TorchStageExec``s; an Aggregate and the
stream side of a join read their input through the coalesce the JAX
package inserts there, and a Limit over a Sort becomes a top-N.  A join
takes the JAX package's static strategy (``_plan_join``): broadcast the
right side when its estimated size is under
``spark.sql.autoBroadcastJoinThreshold``, else the left behind a swap,
else a hash join that builds on the right; with
``spark.rapids.sql.adaptive.enabled`` an equi-join shuffles both sides
instead and the plan runs under an adaptive wrapper that decides the
broadcast from measured bytes (``plan/adaptive.py``).  A join condition
runs on every join type (``exec/joins.py``).  Before lowering,
``push_join_conditions`` moves the conjuncts of a Filter over an inner
join to the side they name, or into the join's condition, and
``push_scan_filters`` (with ``spark.rapids.sql.format.parquet.
filterPushdown.enabled``, on by default) folds a Filter's predicate into
the file relation below it, whose scan prunes hive partitions, parquet
row groups and ORC stripes by it; the Filter stays.  Any other
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

from spark_rapids_tpu_torch.columnar.dtypes import BOOLEAN, STRING, Field, \
    Schema
from spark_rapids_tpu_torch.conf import ADAPTIVE_ENABLED, \
    BROADCAST_THRESHOLD, TorchConf
from spark_rapids_tpu_torch.exec.aggregate import TorchHashAggregateExec
from spark_rapids_tpu_torch.exec.base import TorchExec
from spark_rapids_tpu_torch.exec.basic import TorchFilterExec, \
    TorchLocalLimitExec, TorchLocalScanExec, TorchProjectExec, \
    TorchRangeExec, TorchUnionExec
from spark_rapids_tpu_torch.exec.broadcast import \
    TorchBroadcastExchangeExec, TorchBroadcastHashJoinExec
from spark_rapids_tpu_torch.exec.coalesce import TorchCoalesceBatchesExec
from spark_rapids_tpu_torch.exec.exchange import TorchShuffleExchangeExec
from spark_rapids_tpu_torch.exec.expand import TorchExpandExec
from spark_rapids_tpu_torch.exec.generate import TorchGenerateExec
from spark_rapids_tpu_torch.exec.joins import TorchHashJoinExec
from spark_rapids_tpu_torch.exec.sort import TorchSortExec, TorchTopNExec
from spark_rapids_tpu_torch.exec.window import TorchWindowExec
from spark_rapids_tpu_torch.exprs import predicates as pr
from spark_rapids_tpu_torch.exprs.base import BoundReference, Expression, \
    UnresolvedAttribute, bind_expression
from spark_rapids_tpu_torch.exprs.cast import Cast, gate_key
from spark_rapids_tpu_torch.exprs.nondeterministic import \
    contains_nondeterministic
from spark_rapids_tpu_torch.io.csv import TorchCsvScanExec, \
    expand_csv_paths
from spark_rapids_tpu_torch.io.orc import TorchOrcScanExec, \
    expand_orc_paths
from spark_rapids_tpu_torch.io.parquet import TorchParquetScanExec, \
    expand_paths
from spark_rapids_tpu_torch.plan import logical as lp
from spark_rapids_tpu_torch.plan.adaptive import insert_adaptive
from spark_rapids_tpu_torch.plan.fusion import fuse_physical

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
    if isinstance(e, Cast) and not e.implicit:
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


def plan_query(node: lp.LogicalPlan,
               conf: Optional[TorchConf] = None) -> TorchExec:
    """The query's operators, after ``push_join_conditions``, with the
    fusion pass applied (``plan/fusion.py``); under an adaptive wrapper
    when adaptive execution is on and the plan holds a shuffle exchange
    (``plan/adaptive.py: insert_adaptive``).  Under a placement mode
    other than ``tpu`` the placement pass scores the plan first
    (``plan/placement.py: place_fragments``): the root carries its
    decisions in ``placement``, and a plan placed on the host has every
    operator's ``on_host`` set, for the caller to run it there."""
    conf = conf if conf is not None else TorchConf()
    node = push_join_conditions(node)
    if conf.get_bool(
            "spark.rapids.sql.format.parquet.filterPushdown.enabled", True):
        node = push_scan_filters(node)
    decisions = []
    if conf.placement_mode != "tpu":
        from spark_rapids_tpu_torch.plan.placement import place_fragments
        decisions = place_fragments(node, conf)
    plan = insert_adaptive(fuse_physical(_lower(node, conf), conf), conf)
    if decisions:
        plan.placement = decisions
        if any(d["engine"] == "cpu" for d in decisions):
            mark_on_host(plan)
    return plan


def mark_on_host(plan: TorchExec) -> None:
    """Put every operator of ``plan`` on the host."""
    plan.on_host = True
    for c in plan.children:
        mark_on_host(c)


def _bind_pushed(rel) -> Optional[Expression]:
    """A relation's pushed predicate bound to its schema; pruning is only
    ever an optimization, so one that does not bind is dropped."""
    if rel.pushed is None:
        return None
    try:
        return bind_expression(rel.pushed, rel.schema)
    except Exception:
        return None


def push_scan_filters(node: lp.LogicalPlan) -> lp.LogicalPlan:
    """Fold each Filter's predicate into the file relation directly below
    it (through stacked Filters); nodes are rebuilt, never mutated."""
    kids = [push_scan_filters(c) for c in node.children]
    if isinstance(node, lp.Filter):
        below = kids[0]
        inner = below.children[0] if isinstance(below, lp.Filter) \
            else below
        if isinstance(inner, lp.FILE_RELATIONS):
            rel = copy.copy(inner)
            rel.pushed = node.pred if inner.pushed is None \
                else pr.And(inner.pushed, node.pred)
            if inner is below:
                return lp.Filter(node.pred, rel)
            return lp.Filter(node.pred, lp.Filter(below.pred, rel))
    if any(a is not b for a, b in zip(kids, node.children)):
        node = copy.copy(node)
        node.children = kids
    return node


def _lower(node: lp.LogicalPlan, conf: TorchConf) -> TorchExec:
    if isinstance(node, lp.LocalRelation):
        return TorchLocalScanExec(node.schema, node.cols)
    if isinstance(node, lp.ParquetRelation):
        return TorchParquetScanExec(node.paths, node.schema,
                                    _bind_pushed(node))
    if isinstance(node, lp.CsvRelation):
        return TorchCsvScanExec(node.paths, node.schema, node.header,
                                node.sep, _bind_pushed(node))
    if isinstance(node, lp.OrcRelation):
        return TorchOrcScanExec(node.paths, node.schema, _bind_pushed(node))
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
        return TorchProjectExec([bind(e, True) for e in node.exprs], child)
    if isinstance(node, lp.Filter):
        return TorchFilterExec(bind(node.pred, True), child)
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


def _static_broadcast_side(n: lp.Join, thresh: int) -> Optional[str]:
    """The side the static rule broadcasts, "right", "left" or None:
    the right side when its estimated size is under the threshold, else
    the left (not for semi and anti joins, which must stream the left),
    the smaller one when both qualify."""
    if thresh < 0:
        return None
    r_est = estimate_logical_size(n.children[1])
    l_est = estimate_logical_size(n.children[0])
    r_ok = r_est is not None and r_est <= thresh
    l_ok = l_est is not None and l_est <= thresh and n.join_type in (
        "inner", "cross", "left", "right", "full")
    if r_ok and l_ok:
        return "left" if l_est < r_est else "right"
    return "right" if r_ok else "left" if l_ok else None


def _plan_join(n: lp.Join, conf: TorchConf) -> TorchExec:
    """The JAX package's join strategy (its ``_plan_join``).  Static: the
    side ``_static_broadcast_side`` names is broadcast (the left one
    behind a swap); else a hash join that builds on the right.  With
    adaptive execution on, an equi-join instead shuffles both sides
    through AQE-inserted hash exchanges of ``aqe_initial_partitions`` and
    the broadcast decision waits for the measured bytes
    (``plan/adaptive.py``); the join records the side the static rule
    would have broadcast, so a contradiction counts as a demotion.  A
    condition binds against the left side's columns followed by the
    right side's, on every join type."""
    jt = n.join_type
    left, right = (_lower(c, conf) for c in n.children)
    lschema = n.children[0].output_schema()
    rschema = n.children[1].output_schema()
    lkeys = [_bind(e, lschema, conf) for e in n.left_keys]
    rkeys = [_bind(e, rschema, conf) for e in n.right_keys]
    cond = None if n.condition is None else \
        _bind(n.condition, Schema(lschema.fields + rschema.fields), conf)
    thresh = conf.get(BROADCAST_THRESHOLD)
    side = _static_broadcast_side(n, thresh)
    if conf.get(ADAPTIVE_ENABLED) and lkeys and rkeys:
        nparts = conf.aqe_initial_partitions
        if nparts > 1:
            lex = TorchShuffleExchangeExec(nparts, lkeys, "hash", left)
            rex = TorchShuffleExchangeExec(nparts, rkeys, "hash", right)
            lex.aqe_inserted = rex.aqe_inserted = True
            join = TorchHashJoinExec(TorchCoalesceBatchesExec(lex), rex,
                                     lkeys, rkeys, jt, cond)
            join.aqe_static_side = side
            return join
    if side == "right":
        return TorchBroadcastHashJoinExec(
            TorchCoalesceBatchesExec(left),
            TorchBroadcastExchangeExec(right), lkeys, rkeys, jt, cond)
    if side == "left":
        return swapped_broadcast_join(
            right, TorchBroadcastExchangeExec(left), lkeys, rkeys, jt,
            len(lschema), n.output_schema().fields, cond)
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
    return TorchProjectExec(list(reorder), swapped)


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
    """Bytes an Arrow array of these host values holds, as pyarrow's
    ``nbytes`` (25.0) counts them: a string column its UTF-8 bytes and
    an int32 offset a row, a boolean one a bit a row, any other its
    fixed width; plus a validity bitmap when a value is null."""
    n = len(valid)
    if dtype == STRING:
        size = int(values.lengths.astype(np.int64).sum()) + 4 * n
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
    if isinstance(node, lp.FILE_RELATIONS):
        expand = expand_csv_paths if isinstance(node, lp.CsvRelation) \
            else expand_orc_paths if isinstance(node, lp.OrcRelation) \
            else expand_paths
        try:
            files = expand(node.paths)
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
