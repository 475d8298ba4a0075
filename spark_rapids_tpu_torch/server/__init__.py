"""The multi-tenant session server over one ``TorchSession``.

Counterpart of ``spark_rapids_tpu/server/``: fair bounded admission
ahead of the device semaphore (``admission.py``), per-tenant deadlines
and device budgets, prepared ``?`` statements (``prepared.py``) and a
plan-fingerprint result cache (``result_cache.py``), run by a pool of
worker threads (``core.py``).

    server = session.server()
    stmt = server.prepare("SELECT k, SUM(v) FROM t WHERE v > ? GROUP BY k")
    ticket = server.submit(stmt, tenant="dashboards", params=(0.5,))
    result = ticket.result()            # a HostResult
"""

from spark_rapids_tpu_torch.errors import AdmissionRejectedError, \
    QueryBudgetExceededError
from spark_rapids_tpu_torch.server.admission import FairAdmissionQueue
from spark_rapids_tpu_torch.server.core import ServerQuery, SessionServer
from spark_rapids_tpu_torch.server.prepared import PreparedStatement
from spark_rapids_tpu_torch.server.result_cache import ResultCache

__all__ = [
    "SessionServer", "ServerQuery", "PreparedStatement",
    "FairAdmissionQueue", "ResultCache", "AdmissionRejectedError",
    "QueryBudgetExceededError",
]
