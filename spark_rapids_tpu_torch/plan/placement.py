"""Cost-based fragment placement.

Counterpart of ``spark_rapids_tpu/plan/placement.py``, the decision half
of placement (the numbers are ``plan/cost.py``'s).  Two passes, one
scoring formula, one fault site (``plan.place``), the JAX package's
decision records:

* **Static pass** (``place_fragments``), inside ``plan_query`` before
  lowering.  The JAX pass scores each maximal subtree of nodes its
  device engine takes; the port lowers every node, so each plan is one
  fragment, the whole tree, scored with the estimated input bytes
  (``plan/planner.py: estimate_logical_size``).  A plan the host wins
  runs whole on the host: the same operators under an ``ExecContext``
  on ``torch.device("cpu")`` and its runtime (``plan_query`` marks
  them ``on_host``), where the JAX package lowers it to its pyarrow
  CPU engine, which the port does not have.  Its result needs no pull,
  and K1 and K2 take their plain versions there, as the JAX CPU engine
  runs no Pallas.
* **AQE re-score** (``aqe_rescore``), from the replan pass after each
  stage materializes (``plan/adaptive.py: replan``): the remainder
  above the stage, a unary chain of the operators
  ``_convertible_types`` names, is scored again with the stage's
  measured bytes, and where the host now wins it runs there: its
  operators over host tensors, between a ``DeviceToHostExec`` of the
  stage and a ``HostToDeviceExec`` under the adaptive wrapper
  (``exec/basic.py``), counted in ``placementDemotions``.

``spark.rapids.sql.placement.mode`` gates both: ``tpu`` (the default)
never enters this module, ``cpu`` puts every plan on the host, ``cost``
scores.  This is no fallback: a missing card still fails at session
creation, and a demotion is a decision the conf asked for, shown in
``explain(analyze=True)``, journaled (``fragment_placed``) and counted
(``global_stats``, the registry's ``placement`` section).  An injected
``plan.place`` fault, or any error in either pass, runs the plan on
the card, counted in ``place_faults``.
"""

from __future__ import annotations

import logging
import threading
from typing import List, Optional, Tuple

from spark_rapids_tpu_torch.conf import PLACEMENT_AQE_ENABLED
from spark_rapids_tpu_torch.plan import cost

log = logging.getLogger("spark_rapids_tpu_torch.plan.placement")

FAULT_SITE_PLACE = "plan.place"

# ---------------------------------------------------------------------------
# process-wide statistics (the registry's `placement` section)
# ---------------------------------------------------------------------------

_STATS_LOCK = threading.Lock()
_STATS = {
    "fragments_scored": 0,
    "fragments_tpu": 0,
    "fragments_cpu": 0,
    "aqe_demotions": 0,
    "place_faults": 0,
    "queries_observed": 0,
    "projected_ms": 0.0,
    "actual_ms": 0.0,
}


def _bump(key: str, v) -> None:
    with _STATS_LOCK:
        _STATS[key] += v


def global_stats() -> dict:
    with _STATS_LOCK:
        out = dict(_STATS)
    out["projected_ms"] = round(out["projected_ms"], 1)
    out["actual_ms"] = round(out["actual_ms"], 1)
    from spark_rapids_tpu_torch.obs import registry
    err = registry.histogram(
        registry.HIST_PLACEMENT_COST_ERROR_PCT).snapshot()
    out["cost_error_p50_pct"] = err["p50"]
    out["cost_error_p99_pct"] = err["p99"]
    return out


def reset_stats() -> None:
    with _STATS_LOCK:
        for k in _STATS:
            _STATS[k] = 0.0 if k.endswith("_ms") else 0


def note_query(decisions: List[dict], wall_ms: Optional[float],
               query_id: Optional[int] = None) -> None:
    """After a query ran: its ``fragment_placed`` journal lines (here, so
    they carry the query's id) and the chosen engines' projected ms
    against the measured wall, into the cost-error histogram."""
    if not decisions:
        return
    for d in decisions:
        _journal_decision(d, query_id=query_id)
    if not wall_ms:
        return
    projected = sum(d["cpu_ms"] if d["engine"] == "cpu" else d["tpu_ms"]
                    for d in decisions)
    with _STATS_LOCK:
        _STATS["queries_observed"] += 1
        _STATS["projected_ms"] += projected
        _STATS["actual_ms"] += wall_ms
    from spark_rapids_tpu_torch.obs import registry
    registry.record(registry.HIST_PLACEMENT_COST_ERROR_PCT,
                    abs(projected - wall_ms) / wall_ms * 100.0)


def _journal_decision(decision: dict,
                      query_id: Optional[int] = None) -> None:
    from spark_rapids_tpu_torch.obs import journal
    if journal.enabled():
        journal.emit(journal.EVENT_FRAGMENT_PLACED, query=query_id, **{
            k: decision.get(k) for k in (
                "phase", "fragment", "ops", "classes", "engine",
                "tpu_ms", "cpu_ms", "deciding", "rows", "bytes_in",
                "bytes_out")})


# ---------------------------------------------------------------------------
# the static pass
# ---------------------------------------------------------------------------

def _collect_fragments(root) -> List[List]:
    """The plan's fragments, each root first: one, every logical node
    in pre-order (the port lowers every node to the device, so the JAX
    package's maximal device subtree is the whole tree)."""
    frag: List = []

    def gather(n):
        frag.append(n)
        for c in n.children:
            gather(c)

    gather(root)
    return [frag]


def _fragment_input(frag: List) -> Tuple[Optional[int], int]:
    """(estimated input bytes, estimated input rows) of the fragment's
    leaves; ``(None, 0)`` when any is unknown, which keeps the fragment
    on the card."""
    from spark_rapids_tpu_torch.plan.planner import estimate_logical_size
    bytes_in = 0
    rows = 0.0
    for n in frag:
        if n.children:
            continue
        est = estimate_logical_size(n)
        if est is None:
            return None, 0
        bytes_in += est
        try:
            width = cost.schema_row_width(n.output_schema())
        except Exception:
            width = 16
        rows += est / width
    return bytes_in, int(rows)


def _logical_class(node) -> str:
    """A logical node's class, string-aware (``cost.step_class``)."""
    cls = cost.LOGICAL_CLASS.get(node.node_name, "project")
    exprs = getattr(node, "exprs", None)
    if exprs is None:
        pred = getattr(node, "pred", None)
        exprs = [pred] if pred is not None else []
    return cost.step_class(cls, exprs)


def _score_fragment(frag: List, conf, consts, calib) -> dict:
    from spark_rapids_tpu_torch.plan import logical as lp
    from spark_rapids_tpu_torch.plan.planner import estimate_logical_size
    decision = {"phase": "static", "fragment": frag[0].node_name,
                "ops": len(frag)}
    bytes_in, rows = _fragment_input(frag)
    if bytes_in is None:
        decision.update({"engine": "tpu", "deciding": "unknown_size",
                         "tpu_ms": 0.0, "cpu_ms": 0.0, "rows": 0,
                         "bytes_in": 0, "bytes_out": 0})
        return decision
    bytes_out = estimate_logical_size(frag[0])
    if bytes_out is None:
        has_agg = any(isinstance(n, lp.Aggregate) for n in frag)
        # an aggregate collapses its output; anything else passes its
        # input through, an upper bound
        bytes_out = int(bytes_in * 0.05) if has_agg else bytes_in
    classes = [_logical_class(n) for n in frag]
    decision["classes"] = classes
    decision.update(cost.score_ops(
        classes, rows, bytes_in, bytes_out, conf, consts, calib,
        compile_ms=cost.expected_compile_ms()))
    return decision


def place_fragments(root, conf) -> List[dict]:
    """The static pass (mode ``cost`` or ``cpu``) over the logical plan
    ``root``: one decision record a fragment (the JAX package's
    fields).  An injected ``plan.place`` fault or any error returns no
    decision, so the plan runs on the card (``place_faults``)."""
    from spark_rapids_tpu_torch import faults
    # the pass runs at planning, before the query's scope installs the
    # conf's injector: install it here so a plan.place fault fires on
    # the first query too
    if faults.has_fault_keys(conf):
        faults.configure_from_conf(conf)
    decisions: List[dict] = []
    try:
        faults.maybe_fail(FAULT_SITE_PLACE,
                          "injected placement-pass failure")
        frags = _collect_fragments(root)
        if conf.placement_mode == "cpu":
            for frag in frags:
                decisions.append({
                    "phase": "static", "fragment": frag[0].node_name,
                    "ops": len(frag), "engine": "cpu",
                    "tpu_ms": 0.0, "cpu_ms": 0.0, "deciding": "mode",
                    "rows": 0, "bytes_in": 0, "bytes_out": 0})
        else:
            consts = cost.effective_link_constants(conf)
            calib = cost.calibration()
            decisions = [_score_fragment(frag, conf, consts, calib)
                         for frag in frags]
    except Exception as e:
        _bump("place_faults", 1)
        log.warning("placement pass failed (%s: %s); the plan runs on "
                    "the card", type(e).__name__, e)
        return []
    with _STATS_LOCK:
        _STATS["fragments_scored"] += len(decisions)
        _STATS["fragments_cpu"] += sum(
            1 for d in decisions if d["engine"] == "cpu")
        _STATS["fragments_tpu"] += sum(
            1 for d in decisions if d["engine"] == "tpu")
    return decisions


# ---------------------------------------------------------------------------
# the adaptive re-score: a remainder the estimate got wrong
# ---------------------------------------------------------------------------

class _Unconvertible(Exception):
    """The remainder holds an operator that does not move to the host
    here (a join, a pending exchange, a window): the plan stays."""


def _convertible_types():
    from spark_rapids_tpu_torch.exec.aggregate import TorchHashAggregateExec
    from spark_rapids_tpu_torch.exec.basic import TorchFilterExec, \
        TorchLocalLimitExec, TorchProjectExec
    from spark_rapids_tpu_torch.exec.coalesce import TorchCoalesceBatchesExec
    from spark_rapids_tpu_torch.exec.sort import TorchSortExec
    from spark_rapids_tpu_torch.exec.stage import TorchStageExec
    return (TorchProjectExec, TorchFilterExec, TorchStageExec,
            TorchCoalesceBatchesExec, TorchSortExec, TorchHashAggregateExec,
            TorchLocalLimitExec)


def _remainder_classes(node, stage) -> List[str]:
    """The classes of the unary chain from the wrapper's child down to
    ``stage``; raises ``_Unconvertible`` on anything else, so no
    pending exchange ever moves to the host."""
    from spark_rapids_tpu_torch.exec.coalesce import TorchCoalesceBatchesExec
    from spark_rapids_tpu_torch.exec.stage import TorchStageExec
    out: List[str] = []
    while node is not stage:
        if not isinstance(node, _convertible_types()) or not node.children:
            raise _Unconvertible(node.node_name)
        if isinstance(node, TorchStageExec):
            out.extend(cost.step_class(kind, exprs)
                       for kind, exprs in node.steps)
        elif not isinstance(node, TorchCoalesceBatchesExec):
            cls = cost.op_class(node.node_name)
            exprs = getattr(node, "exprs", None)
            if exprs is None:
                pred = getattr(node, "pred", None)
                exprs = [pred] if pred is not None else []
            out.append(cost.step_class(cls, exprs))
        node = node.children[0]
    return out


def _demote_physical(node, stage):
    """Put the remainder chain above ``stage`` on the host: its own
    operators, ``on_host``, over a ``DeviceToHostExec`` of the stage
    (the JAX package converts each to its CPU engine's analog)."""
    from spark_rapids_tpu_torch.exec.basic import DeviceToHostExec
    if node is stage:
        pull = DeviceToHostExec(stage)
        pull.on_host = True
        return pull
    node.children[0] = _demote_physical(node.children[0], stage)
    node.on_host = True
    return node


def aqe_rescore(root, stage, conf, metrics) -> Optional[dict]:
    """Score the remainder above the just-materialized ``stage`` again
    with its measured bytes (the static formula: would the static
    decision have differed had it known them) and, where the host wins,
    run it there.  Returns the decision on a demotion, else None.  An
    injected ``plan.place`` fault or any error keeps the plan."""
    if conf.placement_mode != "cost" or not conf.get(PLACEMENT_AQE_ENABLED) \
            or root.on_host:
        return None
    from spark_rapids_tpu_torch import faults
    from spark_rapids_tpu_torch.exec.basic import HostToDeviceExec
    try:
        faults.maybe_fail(FAULT_SITE_PLACE,
                          "injected placement re-score failure")
        remainder = root.children[0]
        classes = _remainder_classes(remainder, stage)
        if not classes:
            # only the stage and batching above it: a demotion would
            # move bytes down and up and no work
            return None
        measured = stage.stats.total_bytes
        rows = sum(stage.stats.partition_rows)
        has_agg = "hashaggregate" in classes
        bytes_out = int(measured * 0.05) if has_agg else measured
        d = cost.score_ops(classes, rows, measured, bytes_out, conf,
                           cost.effective_link_constants(conf),
                           cost.calibration(),
                           compile_ms=cost.expected_compile_ms())
        d.update({"phase": "aqe", "fragment": remainder.node_name,
                  "ops": len(classes)})
        if d["engine"] != "cpu":
            return None
        root.children[0] = HostToDeviceExec(
            _demote_physical(remainder, stage))
        metrics["placementDemotions"] += 1
        _bump("aqe_demotions", 1)
        _journal_decision(d)
        return d
    except _Unconvertible as e:
        log.debug("placement re-score skipped (remainder not movable at "
                  "%s)", e)
        return None
    except Exception as e:
        _bump("place_faults", 1)
        log.warning("placement re-score failed (%s: %s); keeping the "
                    "plan", type(e).__name__, e)
        return None
