"""Adaptive query execution: query stages and the adaptive wrapper.

Counterpart of ``spark_rapids_tpu/exec/aqe.py`` (Spark 3.0's
AdaptiveSparkPlanExec).  With ``spark.rapids.sql.adaptive.enabled`` the
planner wraps a plan that holds an in-process shuffle exchange in a
``TorchAdaptiveSparkPlanExec`` (``plan/adaptive.py: insert_adaptive``).
At execution the wrapper repeatedly

1. picks the deepest exchange not yet run, a join's build (right) side
   before its stream side (``plan/adaptive.py: next_stage``), and wraps
   it in a ``TorchQueryStageExec``;
2. materializes the stage: the exchange's map side runs once and its
   buckets stay as the spill catalog's handles, the very buffering the
   static exchange does before it yields, so a stage boundary costs
   nothing more; the per-partition bytes come from the host row counts
   the partition step already read, so sizing a stage reads nothing
   back from the card;
3. replans the rest of the plan from those bytes (``replan``: broadcast
   promotion and demotion, partition coalescing, skew splits) inside
   the ``plan.aqe`` profiler range and behind the ``aqe.replan`` fault
   site.  A replan that fails falls back to the static plan for that
   stage: the stage yields one batch a partition and the join stays as
   planned; the query still runs on the card.

In this single-process engine every consumer reads an exchange's whole
output stream, so coalescing and skew splits only move batch
boundaries: the row sequence equals the static plan's.  A stage yields
one output group at a time and closes the handles of a group as it
consumes them; ``_release_stages`` closes what is left when the query
ends, fails or is cancelled, so a retained plan pins no shuffle.  The
handles are made in the query's scope, so its per-query budget and the
catalog's leak count see them as the query's own.

``record_exchange_stats``, ``global_stats`` and ``reset_stats`` keep the
process-wide statistics (``obs/registry.py``'s ``aqe`` section) under
one lock.
"""

from __future__ import annotations

import logging
import threading
from typing import Iterator, List, Optional

from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.dtypes import Schema
from spark_rapids_tpu_torch.exec.base import ExecContext, TorchExec
from spark_rapids_tpu_torch.exec.coalesce import concat_batches
from spark_rapids_tpu_torch.memory.spill import SpillableBatch, close_all, \
    materialize_all
from spark_rapids_tpu_torch.utils import tracing

log = logging.getLogger("spark_rapids_tpu_torch.aqe")

RANGE_PLAN_AQE = tracing.SPAN_PLAN_AQE


# ---------------------------------------------------------------------------
# process-wide statistics
# ---------------------------------------------------------------------------

_STATS_LOCK = threading.Lock()
_STATS = {
    "replans": 0,
    "coalesced_partitions": 0,
    "skew_splits": 0,
    "broadcast_promotions": 0,
    "broadcast_demotions": 0,
    "replan_fallbacks": 0,
    "exchanges": 0,
}
_MAX_PART_BYTES = 0
# one median an exchange, the newest kept
_EXCHANGE_MEDIANS: List[int] = []
_EXCHANGE_CAP = 1024


def bump_global(key: str, v: int) -> None:
    with _STATS_LOCK:
        _STATS[key] += v


def record_exchange_stats(sizes: List[int]) -> None:
    """One exchange's per-partition bytes into the process-wide stats
    (the largest and the median non-empty partition)."""
    global _MAX_PART_BYTES
    nonempty = sorted(s for s in sizes if s > 0)
    if not nonempty:
        return
    med = nonempty[len(nonempty) // 2]
    with _STATS_LOCK:
        _STATS["exchanges"] += 1
        _MAX_PART_BYTES = max(_MAX_PART_BYTES, nonempty[-1])
        _EXCHANGE_MEDIANS.append(med)
        if len(_EXCHANGE_MEDIANS) > _EXCHANGE_CAP:
            del _EXCHANGE_MEDIANS[0]


def global_stats() -> dict:
    with _STATS_LOCK:
        out = dict(_STATS)
        out["max_partition_bytes"] = _MAX_PART_BYTES
        meds = sorted(_EXCHANGE_MEDIANS)
        out["median_partition_bytes"] = meds[len(meds) // 2] if meds \
            else 0
    return out


def reset_stats() -> None:
    global _MAX_PART_BYTES
    with _STATS_LOCK:
        for k in _STATS:
            _STATS[k] = 0
        _MAX_PART_BYTES = 0
        _EXCHANGE_MEDIANS.clear()


# ---------------------------------------------------------------------------
# query stage
# ---------------------------------------------------------------------------

class StageStats:
    """What one materialized exchange measured."""

    __slots__ = ("partition_bytes", "partition_rows", "total_bytes")

    def __init__(self, partition_bytes: List[int],
                 partition_rows: List[int]):
        self.partition_bytes = partition_bytes
        self.partition_rows = partition_rows
        self.total_bytes = sum(partition_bytes)


class TorchQueryStageExec(TorchExec):
    """A materialized shuffle exchange (Spark's ShuffleQueryStageExec).
    ``materialize`` runs the exchange's map side and keeps its buckets as
    spillable handles with each piece's bytes and rows; the replanner
    reads ``stats`` and may set ``output_groups``, which says how the
    pieces concatenate into output batches: one group a partition (the
    static output, and the fallback), adjacent partitions in one group
    (coalesced), or one partition's pieces over several groups (a skew
    split).  A group is a list of ``(partition, lo, hi)`` piece ranges,
    in partition and piece order, so the rows come out in the static
    plan's sequence."""

    def __init__(self, exchange: TorchExec):
        super().__init__()
        self.children = [exchange]
        self.materialized = False
        self.buckets: List[List[Optional[SpillableBatch]]] = []
        self.item_bytes: List[List[int]] = []
        self.stats: Optional[StageStats] = None
        self.output_groups: Optional[List[list]] = None

    @property
    def exchange(self) -> TorchExec:
        return self.children[0]

    def describe(self) -> str:
        state = "materialized" if self.materialized else "pending"
        return f"TorchQueryStage [{state}]"

    @property
    def output_schema(self) -> Schema:
        return self.children[0].output_schema

    def materialize(self, ctx: ExecContext) -> StageStats:
        """Run the map side once and measure it."""
        if self.materialized:
            return self.stats
        buckets, item_bytes, item_rows = \
            self.exchange.partition_buckets(ctx)
        self.buckets = [list(b) for b in buckets]
        self.item_bytes = item_bytes
        rows = [sum(r) for r in item_rows]
        # shufflePartitionBytes was recorded by the exchange itself; a
        # second count here would double every adaptive exchange's
        self.stats = StageStats(list(self.exchange.last_partition_bytes),
                                rows)
        self.materialized = True
        from spark_rapids_tpu_torch.obs import journal
        if journal.enabled():
            journal.emit(journal.EVENT_STAGE_MATERIALIZE,
                         partitions=len(self.buckets),
                         total_bytes=self.stats.total_bytes,
                         rows=sum(rows))
        return self.stats

    def identity_groups(self) -> List[list]:
        """One group a non-empty partition: the static output."""
        return [[(p, 0, len(bucket))]
                for p, bucket in enumerate(self.buckets) if bucket]

    def group_bytes(self, group: list) -> int:
        return sum(sum(self.item_bytes[p][lo:hi]) for p, lo, hi in group)

    def execute(self, ctx: ExecContext) -> Iterator[ColumnarBatch]:
        if not self.materialized:
            self.materialize(ctx)
        groups = self.output_groups
        if groups is None:
            groups = self.identity_groups()
        for group in groups:
            # the group's handles leave the buckets before they are
            # brought back: materialize_all closes them, and the groups
            # are disjoint, so nothing is closed twice
            handles = []
            for p, lo, hi in group:
                bucket = self.buckets[p]
                for i in range(lo, hi):
                    if bucket[i] is not None:
                        handles.append(bucket[i])
                        bucket[i] = None
            if not handles:
                continue
            batches = materialize_all(handles, ctx)
            out = batches[0] if len(batches) == 1 else \
                concat_batches(batches)
            del batches
            yield out


def release_stages(plan: TorchExec) -> None:
    """Close every materialized stage's remaining handles under ``plan``
    (the end of a query, whichever way it ended)."""
    if isinstance(plan, TorchQueryStageExec):
        for bucket in plan.buckets:
            close_all(h for h in bucket if h is not None)
        plan.buckets = []
    for c in plan.children:
        release_stages(c)


# ---------------------------------------------------------------------------
# the adaptive wrapper
# ---------------------------------------------------------------------------

class TorchAdaptiveSparkPlanExec(TorchExec):
    """Owns the plan below it: materializes one stage at a time and
    replans the rest (``plan/adaptive.py``) before the next stage or the
    final plan runs.  ``reports`` holds one dict a replan pass."""

    def __init__(self, child: TorchExec, conf):
        super().__init__()
        self.children = [child]
        self.conf = conf
        self.reports: List[dict] = []

    def describe(self) -> str:
        return f"TorchAdaptiveSparkPlan [stages={len(self.reports)}]"

    @property
    def output_schema(self) -> Schema:
        return self.children[0].output_schema

    @staticmethod
    def _journal_replan(report: dict) -> None:
        """One ``aqe_replan`` event a pass: the decision, and the bytes a
        partition before and a group after."""
        from spark_rapids_tpu_torch.obs import journal
        if not journal.enabled():
            return
        journal.emit(
            journal.EVENT_AQE_REPLAN,
            changed=bool(report.get("changed")),
            decision=report.get("decision"),
            coalesced=report.get("coalesced", 0),
            skew_splits=report.get("skew_splits", 0),
            before_partition_bytes=report.get("partition_bytes"),
            after_group_bytes=report.get("group_bytes"),
            fallback=report.get("fallback"))

    def execute(self, ctx: ExecContext) -> Iterator[ColumnarBatch]:
        from spark_rapids_tpu_torch import faults
        from spark_rapids_tpu_torch.plan import adaptive as rules
        try:
            while True:
                stage = rules.next_stage(self)
                if stage is None:
                    break
                stage.materialize(ctx)
                try:
                    with tracing.trace_range(RANGE_PLAN_AQE):
                        faults.maybe_fail("aqe.replan")
                        report = rules.replan(self, stage, ctx.conf,
                                              self.metrics)
                    if report.get("changed"):
                        self.metrics["aqeReplans"] += 1
                        bump_global("replans", 1)
                    self._journal_replan(report)
                except Exception as e:
                    # a failed replan never fails the query: the stage
                    # already holds the static output (one group a
                    # partition) and the plan below is the static one
                    log.warning("adaptive replan failed (%s: %s); the "
                                "stage keeps the static plan",
                                type(e).__name__, e)
                    bump_global("replan_fallbacks", 1)
                    stage.output_groups = None
                    report = {"changed": False,
                              "fallback": f"{type(e).__name__}: {e}"}
                    self._journal_replan(report)
                self.reports.append(report)
            yield from self.children[0].execute(ctx)
        finally:
            release_stages(self.children[0])
