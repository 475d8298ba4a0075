"""Logical plan -> port operators.

Counterpart of ``spark_rapids_tpu/plan/planner.py:plan_query``, trimmed
to this slice.  It lowers LocalRelation, ParquetRelation, Project,
Filter, Aggregate and Sort; each maximal chain of Project and Filter
becomes one fused ``TorchStageExec`` (the JAX package's fusion pass),
and an Aggregate reads its input through the coalesce the JAX package
inserts there.  Any other node raises: there is no CPU engine to route
it to, so a result always comes from the device.
"""

from __future__ import annotations

from spark_rapids_tpu_torch.exec.aggregate import TorchHashAggregateExec
from spark_rapids_tpu_torch.exec.base import TorchExec
from spark_rapids_tpu_torch.exec.basic import TorchLocalScanExec
from spark_rapids_tpu_torch.exec.coalesce import TorchCoalesceBatchesExec
from spark_rapids_tpu_torch.exec.sort import TorchSortExec
from spark_rapids_tpu_torch.exec.stage import TorchStageExec
from spark_rapids_tpu_torch.exprs.base import bind_expression
from spark_rapids_tpu_torch.io.parquet import TorchParquetScanExec
from spark_rapids_tpu_torch.plan import logical as lp


def _stage(step, child: TorchExec) -> TorchStageExec:
    if isinstance(child, TorchStageExec):
        return TorchStageExec(child.steps + [step], child.children[0])
    return TorchStageExec([step], child)


def plan_query(node: lp.LogicalPlan) -> TorchExec:
    if isinstance(node, lp.LocalRelation):
        return TorchLocalScanExec(node.schema, node.cols)
    if isinstance(node, lp.ParquetRelation):
        return TorchParquetScanExec(node.paths, node.schema)
    if not isinstance(node, (lp.Project, lp.Filter, lp.Aggregate, lp.Sort)):
        raise NotImplementedError(
            f"{node.node_name} is not in the torch port yet")
    child = plan_query(node.children[0])
    schema = node.children[0].output_schema()

    def bind(e):
        return bind_expression(e, schema)

    if isinstance(node, lp.Project):
        return _stage(("project", tuple(bind(e) for e in node.exprs)),
                      child)
    if isinstance(node, lp.Filter):
        return _stage(("filter", (bind(node.pred),)), child)
    if isinstance(node, lp.Aggregate):
        if not node.groupings:
            raise NotImplementedError(
                "global aggregation is not in the torch port yet")
        return TorchHashAggregateExec(
            [bind(e) for e in node.groupings],
            [bind(e) for e in node.aggregates],
            TorchCoalesceBatchesExec(child))
    return TorchSortExec([(bind(e), asc, nf) for e, asc, nf in node.orders],
                         child)
