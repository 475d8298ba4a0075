"""Two master keys the port used to ignore, against the JAX package.

* ``spark.rapids.sql.concurrentTpuTasks`` (the legacy alias of
  ``spark.rapids.tpu.concurrentTasks``): a positive value sizes the
  runtime's semaphore, in both packages; 0 defers to the new key.
* ``spark.rapids.sql.enabled=false``: the JAX package runs every node on
  its CPU engine; the port, which has none, runs the whole plan on its
  own operators over host tensors, as
  ``spark.rapids.sql.placement.mode=cpu`` does.  The rows equal the JAX
  session's with the key off (integers exact, f64 sums within
  ``approx_float``'s 1e-9 relative), no kernel is launched, no pull is
  made, and the mesh keys lower nothing there.
"""

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu import functions as F
from spark_rapids_tpu.api import col
from tests.compare import assert_tables_equal, cpu_session
from tests.torch_threads import _one_torch_thread  # noqa: F401

import spark_rapids_tpu_torch as st
from spark_rapids_tpu_torch import functions as TF
from spark_rapids_tpu_torch.conf import TorchConf
from spark_rapids_tpu_torch.runtime import TorchRuntime


@pytest.mark.parametrize("settings,permits", [
    ({"spark.rapids.sql.concurrentTpuTasks": 4}, 4),
    ({"spark.rapids.sql.concurrentTpuTasks": 4,
      "spark.rapids.tpu.concurrentTasks": 3}, 4),
    ({"spark.rapids.sql.concurrentTpuTasks": 0,
      "spark.rapids.tpu.concurrentTasks": 3}, 3),
    ({}, 2),
])
def test_legacy_concurrent_tasks_alias_sizes_the_semaphore(settings,
                                                           permits):
    from spark_rapids_tpu.conf import TpuConf
    from spark_rapids_tpu.runtime import TpuRuntime
    TpuRuntime.reset()
    try:
        assert TpuRuntime.get_or_create(TpuConf(dict(settings))) \
            .semaphore.permits == permits
    finally:
        TpuRuntime.reset()
    rt = TorchRuntime(TorchConf(settings), torch.device("cpu"))
    assert rt.semaphore.permits == permits


def _tables():
    rng = np.random.default_rng(12)
    n = 3000
    fact = pa.table({"k": pa.array(rng.integers(0, 40, n), pa.int64()),
                     "v": pa.array(rng.normal(size=n)),
                     "s": pa.array([f"s{i % 7}" for i in range(n)])})
    dim = pa.table({"k": pa.array(np.arange(40, dtype=np.int64)),
                    "grp": pa.array(rng.integers(0, 5, 40), pa.int64())})
    return fact, dim


def _query(s, f, c, fact, dim):
    return (s.create_dataframe(fact).filter(c("v") > -1.0)
            .join(s.create_dataframe(dim), on="k", how="inner")
            .group_by(c("grp"), c("s"))
            .agg(f.sum(c("v")).alias("sv"), f.count(c("k")).alias("n"))
            .order_by(c("grp"), c("s")))


@pytest.mark.parametrize("extra", [{}, {"spark.rapids.sql.mesh.devices": 8}],
                         ids=["plain", "mesh_keys"])
def test_sql_disabled_runs_on_the_host_and_equals_jax(extra):
    from spark_rapids_tpu_torch import native
    from spark_rapids_tpu_torch.columnar import transfer
    from spark_rapids_tpu_torch.parallel.mesh import virtual_pool
    fact, dim = _tables()
    want = _query(cpu_session(), F, col, fact, dim).to_arrow()
    ts = st.TorchSession({"spark.rapids.torch.device": "cpu",
                          "spark.rapids.sql.enabled": "false", **extra})
    native.reset_launches()
    pulls = transfer.d2h_stats()["pulls"]
    with virtual_pool(8 if extra else 0):
        got = _query(ts, TF, st.col, fact, dim).to_arrow()
    assert transfer.d2h_stats()["pulls"] == pulls
    assert all(v == 0 for v in native.LAUNCHES.values())
    plan = ts._last_plan
    assert plan.on_host and "Mesh" not in plan.tree_string()
    assert_tables_equal(got, want, ignore_order=False, approx_float=True)


def test_sql_enabled_by_default_runs_on_the_device():
    fact, dim = _tables()
    ts = st.TorchSession({"spark.rapids.torch.device": "cpu"})
    _query(ts, TF, st.col, fact, dim).to_arrow()
    assert not ts._last_plan.on_host
