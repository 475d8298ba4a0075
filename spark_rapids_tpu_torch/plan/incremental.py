"""Incrementalizability analysis for continuous queries.

Counterpart of ``spark_rapids_tpu/plan/incremental.py``.

Given a logical plan over one tailed file leaf, decide whether an
append micro-batch (new files / grown tails on that leaf) can be
folded into a maintained result without rescanning history, and build
the rewritten plans the refresh code (exec/incremental.py) runs:

* **agg mode** — the plan is ``[Project/Filter]* -> Aggregate ->
  row-local subtree over the stream leaf`` and every aggregate is one
  of Count/Sum/Min/Max/Average.  The maintained state is the output of
  the same subtree aggregated into PARTIAL columns (sum/count/min/max
  slots, Average's (double sum, count) pair — the exact decomposition
  exprs/aggregates.py declares as update/merge op pairs); a refresh
  aggregates ONLY the delta into the same partial shape, then merges
  old and delta state through one more group-by over their Union, and
  finalizes with a projection restoring the original output columns.
  The state is a ``HostResult``, held as an in-memory relation.

* **append mode** — every node on the path from the root to the
  stream leaf is append-linear (Project, Filter, or a Join whose
  stream side is the preserved/probe side and whose other side is
  static), so the delta rows of the ROOT are exactly the plan
  re-executed over the delta leaf: the maintained result is
  ``old ++ delta``.

Anything else — Sort/Limit/Window/Expand above the leaf,
First/Last/order-sensitive aggregates, a full outer join, multiple
tailed leaves — returns ``None`` with a reason, and the caller falls
back to a counted full recompute (``recompute_refreshes`` /
``cache_maintain_fallbacks``).
"""

from __future__ import annotations

import copy
from typing import List, Optional, Tuple

from spark_rapids_tpu_torch.columnar.dtypes import FLOAT64
from spark_rapids_tpu_torch.exprs import aggregates as ag
from spark_rapids_tpu_torch.exprs.arithmetic import Divide
from spark_rapids_tpu_torch.exprs.base import Alias, Expression, \
    UnresolvedAttribute, bind_expression
from spark_rapids_tpu_torch.exprs.cast import Cast
from spark_rapids_tpu_torch.plan import logical as lp

# the aggregate functions whose partial decomposition re-merges
# losslessly (sum-of-sums, sum-of-counts, min-of-mins, max-of-maxes);
# First/Last are order-sensitive and cannot ride a merge
_MERGEABLE_AGGS = (ag.Count, ag.Sum, ag.Min, ag.Max, ag.Average)

# nodes through which a leaf delta passes row-locally: the node's
# delta output is exactly the node applied to the delta input
_ROW_LOCAL = (lp.Project, lp.Filter)

FILE_RELATIONS = lp.FILE_RELATIONS


def file_leaves(plan: lp.LogicalPlan) -> List[lp.LogicalPlan]:
    """Every file-backed leaf relation in the plan, walk order."""
    out: List[lp.LogicalPlan] = []

    def walk(node: lp.LogicalPlan) -> None:
        if isinstance(node, FILE_RELATIONS):
            out.append(node)
        for c in node.children:
            walk(c)

    walk(plan)
    return out


def contains(plan: lp.LogicalPlan, leaf: lp.LogicalPlan) -> bool:
    if plan is leaf:
        return True
    return any(contains(c, leaf) for c in plan.children)


def substitute_leaf(plan: lp.LogicalPlan, leaf: lp.LogicalPlan,
                    replacement: lp.LogicalPlan) -> lp.LogicalPlan:
    """Rebuild the plan with ``leaf`` (by identity) swapped for
    ``replacement``; untouched subtrees are shared, never copied."""
    if plan is leaf:
        return replacement
    if not plan.children:
        return plan
    kids = [substitute_leaf(c, leaf, replacement) for c in plan.children]
    if all(a is b for a, b in zip(kids, plan.children)):
        return plan
    node = copy.copy(plan)
    node.children = kids
    return node


def _append_linear(node: lp.LogicalPlan, leaf: lp.LogicalPlan
                   ) -> Optional[str]:
    """None when every node on the path from ``node`` down to ``leaf``
    is append-linear, else the reason it is not."""
    if node is leaf:
        return None
    if isinstance(node, _ROW_LOCAL):
        return _append_linear(node.children[0], leaf)
    if isinstance(node, lp.Join):
        left, right = node.children
        on_left = contains(left, leaf)
        on_right = contains(right, leaf)
        if on_left and on_right:
            return "stream leaf reachable through both join sides"
        if node.join_type == "inner":
            pass  # either side appends
        elif node.join_type in ("left", "semi", "anti"):
            if not on_left:
                # appending build rows can rewrite or delete
                # already-emitted probe rows
                return (f"stream leaf on the build side of a "
                        f"{node.join_type} join")
        elif node.join_type == "right":
            if not on_right:
                return "stream leaf on the build side of a right join"
        else:
            return f"{node.join_type} join is not append-linear"
        return _append_linear(left if on_left else right, leaf)
    return f"{node.node_name} is not append-linear"


class IncrementalAggPlan:
    """Agg-mode rewrite: partial-state plan builders + finalize chain.

    The three plan builders all run through the normal engine (the
    merge group-by is an aggregate like any other, on the device, K1
    included), so a refresh inherits fusion, spill and supervision."""

    kind = "agg"

    def __init__(self, plan: lp.LogicalPlan, leaf: lp.LogicalPlan,
                 upper: List[lp.LogicalPlan], agg: lp.Aggregate,
                 group_names: List[str], state_aggs: List[Alias],
                 merge_aggs: List[Alias], finals: List[Expression]):
        self.plan = plan
        self.stream_leaf = leaf
        self._upper = upper            # root-to-agg chain, exclusive
        self._agg = agg
        self._group_names = group_names
        self._state_aggs = state_aggs
        self._merge_aggs = merge_aggs
        self._finals = finals

    def state_plan(self, child: Optional[lp.LogicalPlan] = None
                   ) -> lp.LogicalPlan:
        """Partial-state aggregate over ``child`` (default: the
        original input subtree; pass the delta-substituted subtree for
        a refresh)."""
        return lp.Aggregate(list(self._agg.groupings),
                            list(self._state_aggs),
                            child if child is not None
                            else self._agg.children[0])

    def delta_state_plan(self, delta_leaf: lp.LogicalPlan
                         ) -> lp.LogicalPlan:
        return self.state_plan(substitute_leaf(
            self._agg.children[0], self.stream_leaf, delta_leaf))

    def merge_plan(self, states) -> lp.LogicalPlan:
        """Group-by over the Union of partial states (``HostResult``s):
        the partial aggregate's merge ops (sum of sums ...) as a plain
        plan."""
        rels = [lp.LocalRelation(t.schema, t.columns) for t in states]
        child = rels[0] if len(rels) == 1 else lp.Union(rels)
        groups = [UnresolvedAttribute(n) for n in self._group_names]
        return lp.Aggregate(groups, list(self._merge_aggs), child)

    def finalize_plan(self, state) -> lp.LogicalPlan:
        """Original output columns from a merged state, with the plan's
        upper Project/Filter chain re-applied on top."""
        exprs = [UnresolvedAttribute(n) for n in self._group_names]
        exprs += list(self._finals)
        node: lp.LogicalPlan = lp.Project(
            exprs, lp.LocalRelation(state.schema, state.columns))
        for up in reversed(self._upper):
            rebuilt = copy.copy(up)
            rebuilt.children = [node]
            node = rebuilt
        return node


class IncrementalAppendPlan:
    """Append-mode rewrite: the delta of the root IS the plan over the
    delta leaf; the maintained result is ``old ++ delta``."""

    kind = "append"

    def __init__(self, plan: lp.LogicalPlan, leaf: lp.LogicalPlan):
        self.plan = plan
        self.stream_leaf = leaf

    def delta_plan(self, delta_leaf: lp.LogicalPlan) -> lp.LogicalPlan:
        return substitute_leaf(self.plan, self.stream_leaf, delta_leaf)


def _build_agg_rewrite(plan: lp.LogicalPlan, upper: List[lp.LogicalPlan],
                       agg: lp.Aggregate, leaf: lp.LogicalPlan
                       ) -> Tuple[Optional[IncrementalAggPlan], str]:
    child_schema = agg.children[0].output_schema()
    group_names: List[str] = []
    for g in agg.groupings:
        group_names.append(bind_expression(g, child_schema).name)
    state_aggs: List[Alias] = []
    merge_aggs: List[Alias] = []
    finals: List[Expression] = []
    for i, a in enumerate(agg.aggregates):
        if not isinstance(a, Alias) \
                or not isinstance(a.children[0], _MERGEABLE_AGGS) \
                or getattr(a.children[0], "is_distinct", False):
            return None, (f"aggregate {getattr(a, 'name', a)!r} has no "
                          "lossless partial merge")
        fn = a.children[0]
        x = fn.child
        if isinstance(fn, ag.Count):
            s = f"__sq{i}_c"
            state_aggs.append(Alias(ag.Count(x), s))
            merge_aggs.append(Alias(ag.Sum(UnresolvedAttribute(s)), s))
            finals.append(Alias(UnresolvedAttribute(s), a.out_name))
        elif isinstance(fn, ag.Sum):
            s = f"__sq{i}_s"
            state_aggs.append(Alias(ag.Sum(x), s))
            merge_aggs.append(Alias(ag.Sum(UnresolvedAttribute(s)), s))
            finals.append(Alias(UnresolvedAttribute(s), a.out_name))
        elif isinstance(fn, ag.Min):
            s = f"__sq{i}_m"
            state_aggs.append(Alias(ag.Min(x), s))
            merge_aggs.append(Alias(ag.Min(UnresolvedAttribute(s)), s))
            finals.append(Alias(UnresolvedAttribute(s), a.out_name))
        elif isinstance(fn, ag.Max):
            s = f"__sq{i}_x"
            state_aggs.append(Alias(ag.Max(x), s))
            merge_aggs.append(Alias(ag.Max(UnresolvedAttribute(s)), s))
            finals.append(Alias(UnresolvedAttribute(s), a.out_name))
        else:  # Average = (double sum, count) with a final divide
            s, c = f"__sq{i}_as", f"__sq{i}_ac"
            # unconditionally widen: the child is unbound here (no
            # dtype yet) and a FLOAT64->FLOAT64 cast is a no-op
            state_aggs.append(Alias(ag.Sum(Cast(x, FLOAT64)), s))
            state_aggs.append(Alias(ag.Count(x), c))
            merge_aggs.append(Alias(ag.Sum(UnresolvedAttribute(s)), s))
            merge_aggs.append(Alias(ag.Sum(UnresolvedAttribute(c)), c))
            finals.append(Alias(Divide(UnresolvedAttribute(s),
                                       UnresolvedAttribute(c)),
                                a.out_name))
    names = group_names + [a.name for a in state_aggs]
    if len(set(names)) != len(names):
        return None, "duplicate column names in the maintained state"
    return IncrementalAggPlan(plan, leaf, upper, agg, group_names,
                              state_aggs, merge_aggs, finals), ""


def analyze(plan: lp.LogicalPlan,
            stream_leaf: Optional[lp.LogicalPlan] = None):
    """``(rewrite, reason)``: an IncrementalAggPlan /
    IncrementalAppendPlan when the plan is incrementalizable over its
    tailed leaf, else ``(None, reason)``.  ``stream_leaf`` picks the
    tailed leaf by identity; with one file leaf in the plan it is
    inferred."""
    leaves = file_leaves(plan)
    if stream_leaf is None:
        if len(leaves) != 1:
            return None, (f"{len(leaves)} file leaves; the tailed one "
                          "must be designated")
        stream_leaf = leaves[0]
    elif not contains(plan, stream_leaf):
        return None, "designated stream leaf is not in the plan"

    # peel the upper Project/Filter chain down to an Aggregate: the
    # chain re-applies over the merged state at finalize (the state
    # holds EVERY group, so a HAVING-style filter stays correct)
    upper: List[lp.LogicalPlan] = []
    node = plan
    while isinstance(node, _ROW_LOCAL) \
            and not contains_aggregate_exprs(node):
        upper.append(node)
        node = node.children[0]
    if isinstance(node, lp.Aggregate):
        reason = _append_linear(node.children[0], stream_leaf)
        if reason is not None:
            return None, reason
        return _build_agg_rewrite(plan, upper, node, stream_leaf)

    reason = _append_linear(plan, stream_leaf)
    if reason is not None:
        return None, reason
    return IncrementalAppendPlan(plan, stream_leaf), ""


def contains_aggregate_exprs(node: lp.LogicalPlan) -> bool:
    """True when a Project/Filter node carries aggregate expressions
    (it would then not be a plain row-local wrapper)."""
    def has_agg(e: Expression) -> bool:
        if isinstance(e, ag.AggregateFunction):
            return True
        return any(has_agg(c) for c in e.children)

    for v in vars(node).values():
        if isinstance(v, Expression) and has_agg(v):
            return True
        if isinstance(v, list) and any(
                isinstance(x, Expression) and has_agg(x) for x in v):
            return True
    return False
