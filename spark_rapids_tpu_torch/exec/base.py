"""Physical plan node protocol.

Counterpart of ``spark_rapids_tpu/exec/base.py``.  Every operator of the
port streams device ``ColumnarBatch``es: there is no CPU engine to fall
back to and no host/device transition node.  ``ExecContext`` carries the
session's conf and its ``torch.device``.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Iterator, List

import torch

from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.dtypes import Schema
from spark_rapids_tpu_torch.conf import TorchConf


class ExecContext:
    """Per-query execution context: the conf and the device."""

    __slots__ = ("conf", "device")

    def __init__(self, conf: TorchConf, device: torch.device):
        self.conf = conf
        self.device = device


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


