"""TorchSession, the user entry point.

Counterpart of ``spark_rapids_tpu/session.py``.  A session holds its conf
and the ``torch.device`` it runs on, taken from
``spark.rapids.torch.device`` (default ``"cuda"``).  A session on the
card when no card is usable fails at creation: nothing moves to the CPU
because the GPU is absent.  Pass ``"cpu"`` to run every kernel's plain
PyTorch version, as the tests do.  Sessions on one device share its
``TorchRuntime`` (``runtime.py``), made with the conf of the first of
them.  ``sql`` runs a SELECT over the views
registered with ``DataFrame.create_or_replace_temp_view``
(``spark_rapids_tpu_torch/sql.py`` says which SQL it takes; the rest
raises).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from spark_rapids_tpu_torch.conf import DEVICE, TorchConf
from spark_rapids_tpu_torch.runtime import TorchRuntime


class TorchSession:
    def __init__(self, conf: Optional[Dict[str, Any]] = None):
        self.conf = TorchConf(conf)
        self.device = torch.device(self.conf.get(DEVICE))
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"{DEVICE.key}={self.device} but torch.cuda.is_available() "
                "is false; set it to 'cpu' to run on the CPU")
        # the device's runtime: the spill catalog and the semaphore
        self.runtime = TorchRuntime.get_or_create(self.conf, self.device)
        # the physical plan of the last query run, for its metrics
        self._last_plan = None
        self._views: Dict[str, Any] = {}  # temp views, by lower-case name

    @classmethod
    def builder(cls) -> "_Builder":
        return _Builder()

    def set_conf(self, key: str, value) -> None:
        self.conf = self.conf.set(key, value)

    @property
    def read(self):
        from spark_rapids_tpu_torch.api import DataFrameReader
        return DataFrameReader(self)

    def create_dataframe(self, data, masks=None):
        from spark_rapids_tpu_torch.api import create_dataframe
        return create_dataframe(self, data, masks)

    # -- the SQL catalog ----------------------------------------------------

    def register_view(self, name: str, df) -> None:
        self._views[name.lower()] = df

    def drop_view(self, name: str) -> None:
        self._views.pop(name.lower(), None)

    def table(self, name: str):
        """The DataFrame registered as view ``name``."""
        df = self._views.get(name.lower())
        if df is None:
            raise ValueError(
                f"table or view not found: {name} (register with "
                "df.create_or_replace_temp_view)")
        return df

    def sql(self, query: str):
        """A SQL SELECT over the session's views -> DataFrame.  What the
        port cannot run raises ``SqlError`` here, or
        ``NotImplementedError`` when the query is planned."""
        from spark_rapids_tpu_torch.sql import parse_sql
        return parse_sql(query, self)


class _Builder:
    def __init__(self):
        self._conf: Dict[str, Any] = {}

    def config(self, key: str, value) -> "_Builder":
        self._conf[key] = value
        return self

    def get_or_create(self) -> TorchSession:
        """A new session with the conf given (the port keeps no
        process-wide active session)."""
        return TorchSession(self._conf)
