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
raises); ``prepare`` a SELECT with ``?`` markers; ``server()`` starts the
session's multi-tenant ``SessionServer`` (``server/``) and ``fleet()`` a
``FleetRouter`` over ``spark.rapids.fleet.replicas`` replica processes
(``fleet/``).  ``last_query_profile()`` and ``last_query_metrics()``
read the executed plan of the session's last query (``obs/profile.py``);
``TorchSession.active()`` is the session made last.  ``stop()`` closes
the fleet and the server, then cancels and tears down every live query
through ``lifecycle.shutdown_all``; the device's runtime, shared by the
sessions on the device, stays (``TorchRuntime.reset`` drops it).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from spark_rapids_tpu_torch.conf import DEVICE, FLEET_REPLICAS, \
    SERVER_ENABLED, TorchConf
from spark_rapids_tpu_torch.runtime import TorchRuntime


class TorchSession:
    _active: Optional["TorchSession"] = None

    def __init__(self, conf: Optional[Dict[str, Any]] = None):
        self.conf = TorchConf(conf)
        self.device = torch.device(self.conf.get(DEVICE))
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"{DEVICE.key}={self.device} but torch.cuda.is_available() "
                "is false; set it to 'cpu' to run on the CPU")
        if self.device.type == "cuda" and self.device.index is None:
            # an explicit card: the threads a query runs on (the server's
            # workers, the background pull) each have a current device
            # of their own
            self.device = torch.device("cuda", torch.cuda.current_device())
        # the device's runtime: the spill catalog and the semaphore
        self.runtime = TorchRuntime.get_or_create(self.conf, self.device)
        # the physical plan of the last query that ran to its end, and
        # that query's context (its id, and its wall time once its scope
        # closed): stamped only after the drain succeeded
        self._last_plan = None
        self._last_query = None
        self._views: Dict[str, Any] = {}  # temp views, by lower-case name
        self._server = None  # the SessionServer, made by server()
        self._fleet = None  # the FleetRouter, made by fleet()
        TorchSession._active = self

    @classmethod
    def builder(cls) -> "_Builder":
        return _Builder()

    @classmethod
    def active(cls) -> "TorchSession":
        """The session made last, or a new one with the default conf
        (on the card) when there is none."""
        if cls._active is None:
            cls._active = TorchSession()
        return cls._active

    def last_query_profile(self):
        """The ``QueryProfile`` of the last query that ran to its end
        (``render()``, ``to_dict()``), or None before the first."""
        if self._last_plan is None:
            return None
        from spark_rapids_tpu_torch.obs.profile import QueryProfile
        qc = self._last_query
        return QueryProfile.from_plan(
            self._last_plan,
            query_id=qc.query_id if qc is not None else None,
            wall_ms=qc.wall_ms if qc is not None else None,
            placement=list(self._last_plan.placement))

    def last_query_metrics(self) -> str:
        """The last query's operator metrics, one line an operator with
        its non-zero metrics (times in ms): the JAX package's format."""
        p = self.last_query_profile()
        if p is None:
            return "<no query executed>"
        return "\n".join(p.legacy_lines())

    def set_conf(self, key: str, value) -> None:
        self.conf = self.conf.set(key, value)

    @property
    def read(self):
        from spark_rapids_tpu_torch.api import DataFrameReader
        return DataFrameReader(self)

    def create_dataframe(self, data, masks=None):
        from spark_rapids_tpu_torch.api import create_dataframe
        return create_dataframe(self, data, masks)

    def range(self, start: int, end: Optional[int] = None, step: int = 1):
        """The int64 column ``id`` from ``start`` to ``end`` (exclusive)
        by ``step``, made on the device; ``range(n)`` is 0 to n - 1."""
        from spark_rapids_tpu_torch.api import range_df
        return range_df(self, start, end, step)

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

    def prepare(self, query: str):
        """A ``PreparedStatement`` of a SELECT with ``?`` markers: parsed
        once a binding type signature, run by ``.execute(*values)`` or
        ``.bind(*values)``, or submitted to ``server()`` with its
        values."""
        from spark_rapids_tpu_torch.server.prepared import PreparedStatement
        return PreparedStatement(self, query)

    def server(self, max_concurrency: Optional[int] = None):
        """The session's ``SessionServer``, started at the first call:
        fair bounded admission, per-tenant deadlines and device budgets,
        prepared statements and the result cache.  Refused when
        ``spark.rapids.server.enabled`` is set false."""
        if not self.conf.get_bool(SERVER_ENABLED.key, default=True):
            raise RuntimeError(f"{SERVER_ENABLED.key} is false; the session "
                               "server is disabled for this session")
        if self._server is None or self._server.closed:
            from spark_rapids_tpu_torch.server import SessionServer
            self._server = SessionServer(self,
                                         max_concurrency=max_concurrency)
        return self._server

    def engine_stats(self) -> dict:
        """The process-wide stats snapshot (``obs/registry.py``): the
        lifecycle's, the spill catalogs', the server's and the journal's
        counters and the histograms."""
        from spark_rapids_tpu_torch.obs import registry
        return registry.snapshot()

    def fleet(self):
        """The session's ``FleetRouter`` over
        ``spark.rapids.fleet.replicas`` spawned replica processes, each
        with its own session and server (started at the first call):
        tenant-aware routing with overflow, replica quarantine and
        probation, one replay of a query in flight on a failed replica
        under the per-tenant budget, and ``rolling_restart()``.  Refused
        while the key is unset or below 1."""
        if self.conf.get(FLEET_REPLICAS) < 1:
            raise RuntimeError(
                f"{FLEET_REPLICAS.key} is unset (or < 1); set it to the "
                "number of replicas before calling fleet()")
        if self._fleet is None or self._fleet.closed:
            from spark_rapids_tpu_torch.fleet import FleetRouter
            self._fleet = FleetRouter(self)
        return self._fleet

    def stop(self) -> None:
        """Close the fleet and the server, then cancel and tear down
        every live query and every resource registered outside one."""
        if self._fleet is not None:
            # its replicas are whole processes with sessions of their
            # own: closed before this process's serving plane
            self._fleet.close()
            self._fleet = None
        if self._server is not None:
            # first, so its queued tickets fail typed before the sweep
            self._server.close()
            self._server = None
        from spark_rapids_tpu_torch import lifecycle
        lifecycle.shutdown_all()
        if TorchSession._active is self:
            TorchSession._active = None


class _Builder:
    def __init__(self):
        self._conf: Dict[str, Any] = {}

    def config(self, key: str, value) -> "_Builder":
        self._conf[key] = value
        return self

    def get_or_create(self) -> TorchSession:
        """A new session with the conf given."""
        return TorchSession(self._conf)
