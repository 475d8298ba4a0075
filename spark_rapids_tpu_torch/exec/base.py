"""Physical plan node protocol.

Counterpart of ``spark_rapids_tpu/exec/base.py``.  Every operator of the
port streams device ``ColumnarBatch``es: there is no CPU engine to fall
back to and no host/device transition node.  ``ExecContext`` carries the
session's conf, its ``torch.device`` and the device's ``TorchRuntime``
(the spill catalog and the semaphore, ``runtime.py``).

Every operator's output passes one pull boundary: ``TorchExec`` wraps
the ``execute`` each subclass defines (``__init_subclass__``) so that
the batches it yields go through ``_pull_boundary``, the counterpart of
the JAX package's ``_count_output``.  There a cancelled query, or one
past its deadline, raises its typed error (``lifecycle.check_cancel``)
within one batch of work, and closing the stream closes the operator's
own generator.
"""

from __future__ import annotations

import functools
from collections import defaultdict
from typing import Iterator, List, Optional

import torch

from spark_rapids_tpu_torch import lifecycle
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


def _pull_boundary(execute):
    """``execute`` with its output passed through ``_checked``."""
    @functools.wraps(execute)
    def checked_execute(self, ctx):
        return _checked(execute(self, ctx))
    return checked_execute


def _checked(stream: Iterator[ColumnarBatch]) -> Iterator[ColumnarBatch]:
    try:
        for batch in stream:
            lifecycle.check_cancel()
            yield batch
    finally:
        close = getattr(stream, "close", None)
        if close is not None:
            close()


class TorchExec:
    """A physical operator.  ``metrics`` maps a metric name to a count."""

    children: List["TorchExec"] = []

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        if "execute" in cls.__dict__:
            cls.execute = _pull_boundary(cls.__dict__["execute"])

    def __init__(self):
        self.metrics = defaultdict(int)

    @property
    def output_schema(self) -> Schema:
        raise NotImplementedError(type(self).__name__)

    def execute(self, ctx: ExecContext) -> Iterator[ColumnarBatch]:
        raise NotImplementedError(type(self).__name__)


