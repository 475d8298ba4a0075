"""Physical plan node protocol.

Counterpart of ``spark_rapids_tpu/exec/base.py``.  Every operator of the
port streams device ``ColumnarBatch``es: there is no CPU engine to fall
back to and no host/device transition node.  ``ExecContext`` carries the
session's conf, its ``torch.device`` and the device's ``TorchRuntime``
(the spill catalog and the semaphore, ``runtime.py``).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Iterator, List, Optional

import torch

from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.dtypes import Schema
from spark_rapids_tpu_torch.conf import TorchConf
from spark_rapids_tpu_torch.runtime import TorchRuntime


class ExecContext:
    """Per-query execution context: the conf, the device and its runtime
    (by default the process's runtime of that device)."""

    __slots__ = ("conf", "device", "runtime")

    def __init__(self, conf: TorchConf, device: torch.device,
                 runtime: Optional[TorchRuntime] = None):
        self.conf = conf
        self.device = device
        self.runtime = runtime if runtime is not None else \
            TorchRuntime.get_or_create(conf, device)


class TorchExec:
    """A physical operator.  ``metrics`` maps a metric name to a count."""

    children: List["TorchExec"] = []

    def __init__(self):
        self.metrics = defaultdict(int)

    @property
    def output_schema(self) -> Schema:
        raise NotImplementedError(type(self).__name__)

    def execute(self, ctx: ExecContext) -> Iterator[ColumnarBatch]:
        raise NotImplementedError(type(self).__name__)


