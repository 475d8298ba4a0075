"""Typed configuration registry.

Counterpart of ``spark_rapids_tpu/conf.py``, trimmed to the keys the
port reads.  Keys the two packages share keep the JAX package's names,
so one conf dict drives both in the tests; keys the port does not know
are kept and ignored.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional


class ConfEntry:
    """One registered configuration key."""

    def __init__(self, key: str, default: Any, doc: str, conf_type: type,
                 validator: Optional[Callable[[Any], Optional[str]]] = None):
        self.key = key
        self.default = default
        self.doc = doc
        self.conf_type = conf_type
        self.validator = validator

    def convert(self, raw: Any) -> Any:
        if self.conf_type is bool and not isinstance(raw, bool):
            return str(raw).strip().lower() in ("true", "1", "yes")
        return self.conf_type(raw)


_REGISTRY: Dict[str, ConfEntry] = {}


def register(key: str, default: Any, doc: str, conf_type: type = str,
             validator=None) -> ConfEntry:
    entry = ConfEntry(key, default, doc, conf_type, validator)
    _REGISTRY[key] = entry
    return entry


def _positive(v) -> Optional[str]:
    return None if v > 0 else "must be positive"


DEVICE = register(
    "spark.rapids.torch.device", "cuda",
    "torch device the session runs on. The default is the card; a "
    "session on 'cuda' without a usable card fails at creation. Tests "
    "pass 'cpu', which runs each kernel's plain PyTorch version.")

BATCH_SIZE_BYTES = register(
    "spark.rapids.sql.batchSizeBytes", 2147483647,
    "Target device batch size in bytes for the coalesce before an "
    "aggregate.", int, _positive)

BATCH_SIZE_ROWS = register(
    "spark.rapids.sql.batchSizeRows", 1 << 20,
    "Row cap of a coalesced device batch.", int, _positive)

READER_BATCH_SIZE_ROWS = register(
    "spark.rapids.sql.reader.batchSizeRows", 1 << 20,
    "Row cap of one batch a file scan uploads.", int, _positive)

MAX_STRING_WIDTH = register(
    "spark.rapids.sql.maxDeviceStringWidth", 512,
    "Widest string column (bytes, after rounding up to a power of two) "
    "that a batch may hold on the device; uploading a wider one raises, "
    "as in the JAX package.", int, _positive)

BROADCAST_THRESHOLD = register(
    "spark.sql.autoBroadcastJoinThreshold", 10 * 1024 * 1024,
    "Largest estimated size in bytes of a join side that is broadcast "
    "(built once into one device batch); -1 disables broadcast.", int)

PALLAS_AGG = register(
    "spark.rapids.sql.tpu.pallas.agg.enabled", True,
    "Run the update phase of a single-integer-key aggregate whose key "
    "domain fits 1024 slots through the dense-slot kernel instead of "
    "the sorted-segment path.", bool)


def _fraction(v) -> Optional[str]:
    return None if 0.0 < v <= 1.0 else "must be in (0, 1]"


CONCURRENT_TASKS = register(
    "spark.rapids.tpu.concurrentTasks", 2,
    "Number of tasks the device semaphore admits at once (runtime.py; "
    "the JAX package's key and default).", int, _positive)

ALLOC_FRACTION = register(
    "spark.rapids.memory.tpu.allocFraction", 0.9,
    "Fraction of the card's total memory the spill catalog budgets for "
    "the batches it tracks.", float, _fraction)

BUDGET_BYTES = register(
    "spark.rapids.memory.tpu.budgetBytes", 0,
    "Explicit device budget of the spill catalog in bytes; 0 derives it "
    "from the card's total memory x allocFraction.", int)

HOST_SPILL_STORAGE_SIZE = register(
    "spark.rapids.memory.host.spillStorageSize", 1 << 30,
    "Bytes of pinned host memory holding spilled device batches before "
    "they demote to disk.", int)

IO_PREFETCH_ENABLED = register(
    "spark.rapids.sql.io.prefetch.enabled", False,
    "Pull the child of a coalesce on a background thread one batch "
    "ahead of the concat (io/prefetch.py: device_lookahead); false runs "
    "the child in the consumer's thread.  Both give the same batches in "
    "the same order.  Off by default, unlike the JAX package: the local "
    "scan uploads on the thread that pulls it, so the pull has nothing "
    "to overlap and only adds a thread hand-off a batch (PERF.md).", bool)


class TorchConf:
    """Immutable view over a conf dict."""

    def __init__(self, settings: Optional[Dict[str, Any]] = None):
        self._settings = dict(settings or {})
        for key, raw in self._settings.items():
            entry = _REGISTRY.get(key)
            if entry is not None and entry.validator is not None:
                err = entry.validator(entry.convert(raw))
                if err:
                    raise ValueError(f"{key}: {err} (got {raw!r})")

    def get(self, entry: ConfEntry) -> Any:
        raw = self._settings.get(entry.key)
        return entry.default if raw is None else entry.convert(raw)

    def set(self, key: str, value: Any) -> "TorchConf":
        return TorchConf({**self._settings, key: value})
