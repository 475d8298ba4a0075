"""Continuous queries: tailing sources, incremental maintenance and
standing queries (counterpart of ``spark_rapids_tpu/stream``).

Behind ``spark.rapids.stream.enabled``: with it unset the session
server builds no registry and starts no poller, and nothing here is
imported but the counters (``stats``).
"""

_LAZY = {
    "MicroBatch": "spark_rapids_tpu_torch.stream.source",
    "TailingSource": "spark_rapids_tpu_torch.stream.source",
    "new_files_leaf": "spark_rapids_tpu_torch.stream.source",
    "StandingQuery": "spark_rapids_tpu_torch.stream.standing",
    "StandingQueryRegistry": "spark_rapids_tpu_torch.stream.standing",
}

__all__ = sorted(_LAZY) + ["stats"]


def __getattr__(name: str):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}")
    import importlib
    return getattr(importlib.import_module(mod), name)
