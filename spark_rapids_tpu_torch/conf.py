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
