"""Physical plan node protocol.

Counterpart of ``spark_rapids_tpu/exec/base.py``.  Every operator of the
port streams ``ColumnarBatch``es on its context's device: there is no
CPU engine to fall back to.  The same operators run over host tensors
where the placement pass puts a plan, or the remainder above an
adaptive stage, on the host (``plan/placement.py``, through the
``HostToDeviceExec`` and ``DeviceToHostExec`` transitions of
``exec/basic.py``).  ``ExecContext`` carries the session's conf, its
``torch.device`` and the device's ``TorchRuntime`` (the spill catalog
and the semaphore, ``runtime.py``).

Every operator's output passes one pull boundary: ``TorchExec`` wraps
the ``execute`` each subclass defines (``__init_subclass__``) so that
the batches it yields go through ``_pull_boundary``, the counterpart of
the JAX package's ``_count_output``.  There a cancelled query, or one
past its deadline, raises its typed error (``lifecycle.check_cancel``)
within one batch of work, and closing the stream closes the operator's
own generator.  The boundary also counts the operator's
``numOutputRows`` and ``numOutputBatches`` (``batch.num_rows`` is a
host int, so counting reads nothing back from the card) and adds the
host wall time of each pull to ``totalTime``.  That time is host wall,
as in the JAX package, whose dispatch is asynchronous too: it includes
the children's pulls and whatever the card made the host wait for, and
it is not device time.
"""

from __future__ import annotations

import functools
import time
from typing import Iterator, List, Optional

import torch

from spark_rapids_tpu_torch import lifecycle
from spark_rapids_tpu_torch.columnar import encoding
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.dtypes import Schema
from spark_rapids_tpu_torch.conf import TorchConf
from spark_rapids_tpu_torch.runtime import TorchRuntime
from spark_rapids_tpu_torch.utils.metrics import METRIC_NUM_OUTPUT_BATCHES, \
    METRIC_NUM_OUTPUT_ROWS, METRIC_TOTAL_TIME, MetricSet


class ExecContext:
    """Per-query execution context: the conf, the device and its runtime
    (by default the process's runtime of that device).  ``parent``: the
    device context a host section of the plan runs inside
    (``exec/basic.py: HostToDeviceExec``), else None."""

    __slots__ = ("conf", "device", "runtime", "parent")

    def __init__(self, conf: TorchConf, device: torch.device,
                 runtime: Optional[TorchRuntime] = None,
                 parent: Optional["ExecContext"] = None):
        self.conf = conf
        self.device = device
        self.runtime = runtime if runtime is not None else \
            TorchRuntime.get_or_create(conf, device)
        self.parent = parent
        # the compressed domain's switches are process-wide, installed at
        # every execution entry, as the JAX package's ExecContext does
        encoding.set_conf(conf)

    def on_host(self) -> "ExecContext":
        """This query's context on the host: ``torch.device("cpu")`` and
        its runtime, with this one as its parent."""
        cpu = torch.device("cpu")
        return ExecContext(self.conf, cpu,
                           TorchRuntime.get_or_create(self.conf, cpu),
                           parent=self)


def _pull_boundary(execute):
    """``execute`` with its output passed through ``_checked``."""
    @functools.wraps(execute)
    def checked_execute(self, ctx):
        return _checked(execute(self, ctx), self.metrics)
    return checked_execute


def _checked(stream: Iterator[ColumnarBatch],
             metrics: MetricSet) -> Iterator[ColumnarBatch]:
    rows = metrics[METRIC_NUM_OUTPUT_ROWS]
    batches = metrics[METRIC_NUM_OUTPUT_BATCHES]
    total = metrics[METRIC_TOTAL_TIME]
    it = iter(stream)
    try:
        while True:
            t0 = time.perf_counter_ns()
            try:
                batch = next(it)
            except StopIteration:
                return
            finally:
                total.add(time.perf_counter_ns() - t0)
            lifecycle.check_cancel()
            rows.add(batch.num_rows)
            batches.add(1)
            yield batch
    finally:
        close = getattr(stream, "close", None)
        if close is not None:
            close()


class TorchExec:
    """A physical operator.  ``metrics`` is its ``MetricSet``.
    ``on_host``: the placement pass put it on the host
    (``plan/placement.py``); ``placement``: a plan root's static
    placement decisions (none under the default mode)."""

    children: List["TorchExec"] = []
    on_host = False
    placement: tuple = ()

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        if "execute" in cls.__dict__:
            cls.execute = _pull_boundary(cls.__dict__["execute"])

    def __init__(self):
        self.metrics = MetricSet(owner=self.node_name)

    @property
    def node_name(self) -> str:
        return type(self).__name__

    def describe(self) -> str:
        """One line naming the operator and what sets it apart (keys,
        join type, route, partitioning), as the JAX operator's does."""
        return self.node_name

    def tree_string(self, indent: int = 0) -> str:
        pad = "  " * indent
        lines = [f"{pad}{self.describe()}"]
        for c in self.children:
            lines.append(c.tree_string(indent + 1))
        return "\n".join(lines)

    @property
    def output_schema(self) -> Schema:
        raise NotImplementedError(type(self).__name__)

    def execute(self, ctx: ExecContext) -> Iterator[ColumnarBatch]:
        raise NotImplementedError(type(self).__name__)


