"""The fusion pass: collapse project/filter chains into stages.

Counterpart of ``spark_rapids_tpu/plan/fusion.py``.  It runs over the
physical plan after lowering and before the adaptive wrapper, where the
JAX planner runs it (after its lowering passes, before coalesce
insertion; the port's planner puts each coalesce in while it lowers,
and a coalesce never stands inside a project/filter chain).  Bottom up,
each maximal chain of ``TorchProjectExec`` and ``TorchFilterExec`` folds
into ``TorchStageExec``s of at most ``spark.rapids.sql.fusion.maxOps``
steps each, and a chain of one is turned back into its own operator, so
a lone project or filter keeps its name and metrics.  With
``spark.rapids.sql.fusion.enabled`` false the plan is returned as it
is, every operator on its own.  The pass opens the ``plan.fusion``
range.
"""

from __future__ import annotations

from spark_rapids_tpu_torch.conf import FUSION_ENABLED, FUSION_MAX_OPS, \
    TorchConf
from spark_rapids_tpu_torch.exec import basic as tb
from spark_rapids_tpu_torch.exec.base import TorchExec
from spark_rapids_tpu_torch.exec.stage import TorchStageExec
from spark_rapids_tpu_torch.utils import tracing


def fuse_physical(plan: TorchExec, conf: TorchConf) -> TorchExec:
    """Whole-stage fusion of ``plan`` (the plan itself when off)."""
    if not conf.get(FUSION_ENABLED):
        return plan
    with tracing.trace_range(tracing.SPAN_PLAN_FUSION):
        return _unwrap_singletons(_collapse(plan, conf.get(FUSION_MAX_OPS)))


def _step_of(node: TorchExec):
    if isinstance(node, tb.TorchProjectExec):
        return ("project", tuple(node.exprs))
    if isinstance(node, tb.TorchFilterExec):
        return ("filter", (node.pred,))
    return None


def _collapse(node: TorchExec, max_ops: int) -> TorchExec:
    node.children = [_collapse(c, max_ops) for c in node.children]
    step = _step_of(node)
    if step is None:
        return node
    child = node.children[0]
    if isinstance(child, TorchStageExec) and len(child.steps) < max_ops:
        # the chain below already collapsed: this step joins it
        return TorchStageExec(child.steps + [step], child.children[0])
    return TorchStageExec([step], child)


def _unwrap_singletons(node: TorchExec) -> TorchExec:
    node.children = [_unwrap_singletons(c) for c in node.children]
    if isinstance(node, TorchStageExec) and len(node.steps) == 1:
        kind, exprs = node.steps[0]
        if kind == "project":
            return tb.TorchProjectExec(list(exprs), node.children[0])
        return tb.TorchFilterExec(exprs[0], node.children[0])
    return node
