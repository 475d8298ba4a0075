"""Adaptive replanning rules.

Counterpart of ``spark_rapids_tpu/plan/adaptive.py``, the planner half
of adaptive execution (``exec/aqe.py`` runs it).  ``insert_adaptive``
wraps a plan that holds an in-process shuffle exchange in a
``TorchAdaptiveSparkPlanExec``; at execution the wrapper calls
``next_stage`` to pick and wrap the next exchange, then ``replan`` to
rewrite the rest of the plan from the stage's measured bytes.  Three
rules, each gated by its conf key as in Spark 3.x:

1. broadcast promotion and demotion (Spark's runtime join selection and
   DemoteBroadcastHashJoin): a join whose measured build side is under
   ``spark.sql.autoBroadcastJoinThreshold`` becomes a broadcast hash
   join over the materialized stage, and the stream side's pending
   exchange is removed, so its partition work never runs; a measured
   left side under it becomes the planner's swapped-broadcast shape
   (``plan/planner.py: swapped_broadcast_join``); a side the static
   rule would have broadcast that measures over the threshold stays
   shuffled and counts as a demotion;
2. partition coalescing (``adaptive.coalescePartitions.*``): adjacent
   small partitions merge toward ``advisoryPartitionSizeInBytes``;
3. skew splits (``adaptive.skewJoin.*``): a stream-side partition over
   ``max(skewedPartitionFactor x median, skewedPartitionThresholdInBytes)``
   splits at piece granularity.

Rules 2 and 3 apply to AQE-inserted exchanges only (``aqe_inserted``): a
``repartition(n)`` count is the user's.  Every rule keeps the row
sequence; only batch boundaries and the join's build side move.

After the rules, placement's re-score (``plan/placement.py:
aqe_rescore``, inert unless ``spark.rapids.sql.placement.mode=cost``)
may move the remainder above the stage to the host.

The host shuffle's exchange (``shuffle/stage.py``) ships its child to
worker processes, so nothing inside it is wrapped in a stage here
(``_subtree_has_exchange``, ``next_stage``); it groups its reduce
uploads from its own map-output statistics with the same
``greedy_partition_groups``.

Not carried over: ``unwrap_aqe_exchange`` (the mesh lowering, queue
A8b).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from spark_rapids_tpu_torch.conf import ADAPTIVE_ADVISORY_SIZE, \
    ADAPTIVE_COALESCE_ENABLED, ADAPTIVE_ENABLED, ADAPTIVE_MIN_PARTITIONS, \
    ADAPTIVE_SKEW_ENABLED, ADAPTIVE_SKEW_FACTOR, ADAPTIVE_SKEW_THRESHOLD, \
    BROADCAST_THRESHOLD
from spark_rapids_tpu_torch.exec.aqe import TorchAdaptiveSparkPlanExec, \
    TorchQueryStageExec, bump_global
from spark_rapids_tpu_torch.exec.base import TorchExec
from spark_rapids_tpu_torch.exec.broadcast import \
    TorchBroadcastExchangeExec, TorchBroadcastHashJoinExec
from spark_rapids_tpu_torch.exec.coalesce import TorchCoalesceBatchesExec
from spark_rapids_tpu_torch.exec.exchange import TorchShuffleExchangeExec
from spark_rapids_tpu_torch.exec.joins import TorchHashJoinExec


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------

def _subtree_has_exchange(node: TorchExec) -> bool:
    if isinstance(node, TorchShuffleExchangeExec) and node.mode != "range":
        return True
    from spark_rapids_tpu_torch.shuffle.stage import \
        TorchHostShuffleExchangeExec
    if isinstance(node, TorchHostShuffleExchangeExec):
        # its child is pickled to the workers: no stage inside it, and
        # the exchange adapts its own reduce grouping
        return False
    return any(_subtree_has_exchange(c) for c in node.children)


def insert_adaptive(plan: TorchExec, conf) -> TorchExec:
    """``plan`` under an adaptive wrapper when adaptive execution is on
    and the plan holds an exchange a stage can measure (a range
    exchange samples its whole input first and stays static)."""
    if conf.get(ADAPTIVE_ENABLED) and _subtree_has_exchange(plan):
        return TorchAdaptiveSparkPlanExec(plan, conf)
    return plan


def find_adaptive(plan: TorchExec) -> Optional[TorchAdaptiveSparkPlanExec]:
    """The first adaptive wrapper in a plan, or None."""
    if isinstance(plan, TorchAdaptiveSparkPlanExec):
        return plan
    for c in plan.children:
        found = find_adaptive(c)
        if found is not None:
            return found
    return None


# ---------------------------------------------------------------------------
# stage selection
# ---------------------------------------------------------------------------

def next_stage(root: TorchAdaptiveSparkPlanExec
               ) -> Optional[TorchQueryStageExec]:
    """Wrap the next exchange to materialize in place and return its
    stage, or None when none is left.  Deepest first (a stage's subtree
    holds no exchange not yet run), right children before left, so a
    join's build side runs before its stream side: the order that lets
    a small build side cancel the stream side's shuffle."""

    from spark_rapids_tpu_torch.shuffle.stage import \
        TorchHostShuffleExchangeExec

    def find(node, parent, idx):
        if isinstance(node, TorchQueryStageExec) and node.materialized:
            return None
        if isinstance(node, TorchHostShuffleExchangeExec):
            return None  # its fragment ships to the workers
        for i in reversed(range(len(node.children))):
            found = find(node.children[i], node, i)
            if found is not None:
                return found
        if isinstance(node, TorchShuffleExchangeExec) \
                and node.mode != "range" and parent is not None:
            return parent, idx, node
        return None

    found = find(root.children[0], root, 0)
    if found is None:
        return None
    parent, idx, exchange = found
    stage = TorchQueryStageExec(exchange)
    parent.children[idx] = stage
    return stage


# ---------------------------------------------------------------------------
# replanning
# ---------------------------------------------------------------------------

def _strip_coalesce(node: TorchExec) -> TorchExec:
    while isinstance(node, TorchCoalesceBatchesExec):
        node = node.children[0]
    return node


def _find_join_over(root, stage):
    """The hash join reading ``stage`` (through a coalesce or not) ->
    ``(its parent, its index there, the join, side)``, side 1 for the
    build and 0 for the stream, or None."""

    def walk(node, parent, idx):
        if type(node) is TorchHashJoinExec:
            for side in (1, 0):
                if _strip_coalesce(node.children[side]) is stage:
                    return parent, idx, node, side
        for i, c in enumerate(node.children):
            found = walk(c, node, i)
            if found is not None:
                return found
        return None

    return walk(root.children[0], root, 0)


def _elide_pending_exchange(node: TorchExec) -> bool:
    """Replace the first AQE-inserted exchange not yet run under
    ``node`` by its child, in place: a promotion makes the stream side's
    shuffle pointless, and its partition work never runs."""
    for i, c in enumerate(node.children):
        if isinstance(c, TorchShuffleExchangeExec) and c.aqe_inserted:
            node.children[i] = c.children[0]
            return True
        if isinstance(c, TorchQueryStageExec):
            continue  # already run: its cost is paid
        if _elide_pending_exchange(c):
            return True
    return False


def replan(root: TorchAdaptiveSparkPlanExec, stage: TorchQueryStageExec,
           conf, metrics) -> dict:
    """One pass after ``stage`` materialized: the join's strategy first
    (it decides whether the stage's grouping matters), then coalescing
    and skew splits on the stage itself."""
    from spark_rapids_tpu_torch.plan.planner import swapped_broadcast_join
    report = {"changed": False,
              "partition_bytes": list(stage.stats.partition_bytes)}
    thresh = conf.get(BROADCAST_THRESHOLD)
    promoted = False

    jinfo = _find_join_over(root, stage)
    if jinfo is not None:
        jparent, jidx, join, side = jinfo
        fits = thresh >= 0 and stage.stats.total_bytes <= thresh
        static_side = getattr(join, "aqe_static_side", None)
        this_side = "right" if side == 1 else "left"
        if side == 1 and fits:
            # the build side fits: a broadcast join over the stage (not
            # run again), and the stream side's shuffle goes
            new_join = TorchBroadcastHashJoinExec(
                join.children[0], TorchBroadcastExchangeExec(stage),
                join.left_keys, join.right_keys, join.join_type,
                join.condition)
            new_join.metrics = join.metrics
            _elide_pending_exchange(new_join)
            jparent.children[jidx] = new_join
            promoted = True
        elif side == 0 and fits and join.join_type in (
                "inner", "cross", "left", "right", "full"):
            # the left side fits: the static rule's swapped broadcast
            # over the left stage (semi and anti joins must stream the
            # left side, as in the static rule)
            nl = len(join.children[0].output_schema.fields)
            proj = swapped_broadcast_join(
                join.children[1], TorchBroadcastExchangeExec(stage),
                join.left_keys, join.right_keys, join.join_type, nl,
                join.output_schema.fields, join.condition)
            proj.children[0].metrics = join.metrics
            jparent.children[jidx] = proj
            promoted = True
        if promoted:
            metrics["broadcastPromotions"] += 1
            bump_global("broadcast_promotions", 1)
            report["changed"] = True
            report["decision"] = "broadcast_promoted"
        elif static_side == this_side:
            # the static estimate chose this side for broadcast, the
            # measured bytes did not: the shuffled join stands
            metrics["broadcastDemotions"] += 1
            bump_global("broadcast_demotions", 1)
            report["changed"] = True
            report["decision"] = "broadcast_demoted"
        elif side == 0:
            report["decision"] = "stream_side"

    if not promoted and stage.exchange.aqe_inserted:
        feeds_stream = jinfo is not None and jinfo[3] == 0
        groups, ncoal, nsplit = compute_groups(stage, conf,
                                               allow_skew=feeds_stream)
        if ncoal or nsplit:
            stage.output_groups = groups
            metrics["coalescedPartitions"] += ncoal
            metrics["skewSplits"] += nsplit
            bump_global("coalesced_partitions", ncoal)
            bump_global("skew_splits", nsplit)
            report["changed"] = True
            report["coalesced"] = ncoal
            report["skew_splits"] = nsplit
            report["group_bytes"] = [stage.group_bytes(g) for g in groups]
    if not promoted:
        # placement's re-score (plan/placement.py): with placement.mode
        # =cost, the measured bytes may move the remainder above the
        # stage to the host; inert otherwise, and a failure keeps the
        # plan as the rules above do
        from spark_rapids_tpu_torch.plan.placement import aqe_rescore
        pd = aqe_rescore(root, stage, conf, metrics)
        if pd is not None:
            report["changed"] = True
            report["decision"] = "placement_demoted"
            report["placement"] = pd
    return report


# ---------------------------------------------------------------------------
# coalescing and skew splits
# ---------------------------------------------------------------------------

def greedy_partition_groups(parts: List[tuple], conf, allow_skew: bool,
                            stat_sizes: Optional[List[int]] = None,
                            merge_target: Optional[int] = None
                            ) -> Tuple[List[list], int, int]:
    """The sizing policy: ``parts`` is ``(pid, total_bytes, [piece
    bytes...])`` a non-empty partition, in order; ``stat_sizes`` the
    whole exchange's partition bytes when ``parts`` is a window of it.
    A skewed partition (bytes over ``max(skewedPartitionFactor x median,
    skewedPartitionThresholdInBytes)``, skew allowed, more than one
    piece) makes one group a run of its pieces of about ``max(advisory,
    median)`` bytes; runs of other partitions merge while their bytes
    stay under the merge target (the advisory size).  -> ``(groups,
    partitions merged away, extra groups the splits made)``; each group
    a list of ``(pid, lo, hi)``, in partition and piece order."""
    sized = [s for s in (stat_sizes if stat_sizes
                         else [t[1] for t in parts]) if s > 0]
    if not sized:
        return [[(pid, 0, len(items))] for pid, _sz, items in parts], \
            0, 0
    median = sorted(sized)[len(sized) // 2]
    advisory = conf.get(ADAPTIVE_ADVISORY_SIZE)
    do_coalesce = conf.get(ADAPTIVE_COALESCE_ENABLED)
    do_skew = allow_skew and conf.get(ADAPTIVE_SKEW_ENABLED)
    skew_floor = max(conf.get(ADAPTIVE_SKEW_FACTOR) * median,
                     conf.get(ADAPTIVE_SKEW_THRESHOLD))
    # Spark's ShufflePartitionsUtil: split chunks aim at the larger of
    # the advisory size and the median partition
    split_target = max(advisory, median)
    if merge_target is None:
        merge_target = advisory

    groups: List[list] = []
    ncoal = nsplit = 0
    run: List[tuple] = []
    run_bytes = run_parts = 0

    def close_run():
        nonlocal run, run_bytes, run_parts, ncoal
        if run:
            groups.append(run)
            ncoal += run_parts - 1
        run, run_bytes, run_parts = [], 0, 0

    for pid, sz, items in parts:
        if do_skew and sz > skew_floor and len(items) > 1:
            # skewed: merges with no neighbour; its pieces regroup
            # toward the split target (one oversized piece stays whole)
            close_run()
            cur_lo, cur_bytes = 0, 0
            first = len(groups)
            for i, bb in enumerate(items):
                if i > cur_lo and cur_bytes + bb > split_target:
                    groups.append([(pid, cur_lo, i)])
                    cur_lo, cur_bytes = i, 0
                cur_bytes += bb
            groups.append([(pid, cur_lo, len(items))])
            nsplit += len(groups) - first - 1
            continue
        if not do_coalesce:
            close_run()
            groups.append([(pid, 0, len(items))])
            continue
        if run and run_bytes + sz > merge_target:
            close_run()
        run.append((pid, 0, len(items)))
        run_bytes += sz
        run_parts += 1
    close_run()
    return groups, ncoal, nsplit


def compute_groups(stage: TorchQueryStageExec, conf,
                   allow_skew: bool) -> Tuple[List[list], int, int]:
    """A stage's output groups from its measured bytes, at least
    ``coalescePartitions.minPartitionNum`` of them when coalescing."""
    sizes = stage.stats.partition_bytes
    parts = [(p, sizes[p], list(stage.item_bytes[p]))
             for p, bucket in enumerate(stage.buckets) if bucket]
    groups, ncoal, nsplit = greedy_partition_groups(parts, conf, allow_skew)
    min_parts = conf.get(ADAPTIVE_MIN_PARTITIONS)
    if conf.get(ADAPTIVE_COALESCE_ENABLED) and ncoal and \
            len(groups) < min_parts:
        # merged below the floor: again, with a target that leaves at
        # least minPartitionNum groups
        total = sum(s for s in sizes if s > 0)
        groups, ncoal, nsplit = greedy_partition_groups(
            parts, conf, allow_skew, merge_target=max(1, total // min_parts))
    return groups, ncoal, nsplit
