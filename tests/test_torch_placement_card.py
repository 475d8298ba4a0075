"""Placement, fusion and the compile store on the card.

* ``placement.mode=cpu`` runs a K1 aggregate on the host: its result is
  the card's (floats within 1e-9), with no kernel launched and nothing
  pulled; ``cost`` with the probed link constants gives the card's
  result too;
* an adaptive demotion moves the remainder above a stage to the host
  between its two counted transitions, the result the card's;
* fusion on, off and at maxOps 2 give the same rows bit for bit;
* the compile store: the kernels nvcc builds into an empty directory
  are loaded, not built, by a second process over it (simulated by
  forgetting the loaded libraries and the store), and launch.

Marked ``cuda``: each test skips itself without a card.  The file
imports neither JAX nor pyarrow, so it runs on the card's machine:

    python -m pytest tests/test_torch_placement_card.py -q --noconftest
"""

import numpy as np
import pytest
import torch

import spark_rapids_tpu_torch as st
from spark_rapids_tpu_torch import functions as F
from spark_rapids_tpu_torch import native

pytestmark = pytest.mark.cuda


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the placement is between it and "
                    "the host")


def _data(n=200_000, seed=3):
    rng = np.random.default_rng(seed)
    return {"k": rng.integers(0, 1000, n), "v": rng.normal(size=n),
            "w": rng.normal(size=n).astype(np.float32)}


def _agg(df):
    c = st.col
    return (df.filter(c("v") > -1.0).group_by("k")
              .agg(F.count(c("v")).alias("n"), F.sum(c("v")).alias("s"),
                   F.max(c("w")).alias("mx")).order_by("k"))


def _same(a, b, rtol=1e-9):
    assert a.schema.names == b.schema.names and a.num_rows == b.num_rows
    for name in a.schema.names:
        (x, vx), (y, vy) = a.columns[name], b.columns[name]
        assert np.array_equal(vx, vy)
        if x.dtype.kind == "f":
            assert np.allclose(x[vx], y[vy], rtol=rtol, atol=0.0)
        else:
            assert np.array_equal(x[vx], y[vy])


def test_modes_agree_and_the_host_pulls_nothing():
    _card()
    from spark_rapids_tpu_torch.columnar import transfer
    data = _data()
    base = _agg(st.TorchSession({}).create_dataframe(data))._host()
    for mode in ("cpu", "cost"):
        s = st.TorchSession({"spark.rapids.sql.placement.mode": mode})
        native.reset_launches()
        pulls = transfer.d2h_stats()["pulls"]
        got = _agg(s.create_dataframe(data))._host()
        _same(got, base)
        if mode == "cpu":
            assert s._last_plan.on_host
            assert not any(native.LAUNCHES.values())
            assert transfer.d2h_stats()["pulls"] == pulls
        assert s._last_plan.placement[0]["engine"] in ("tpu", "cpu")


def test_adaptive_demotion_on_the_card():
    _card()
    from spark_rapids_tpu_torch.plan.adaptive import find_adaptive
    rng = np.random.default_rng(7)
    data = {"k": rng.integers(0, 100, 4000), "v": rng.normal(size=4000)}
    c = st.col

    def q(s):
        return (s.create_dataframe(data).filter(c("k") < 1)
                .repartition(4, "k").select((c("v") * 2.0).alias("a"),
                                            c("k")))
    aqe = {"spark.rapids.sql.adaptive.enabled": "true"}
    want = q(st.TorchSession(aqe))._host()
    s = st.TorchSession({**aqe, "spark.rapids.sql.placement.mode": "cost",
                         "spark.rapids.sql.placement.pullLatencyMs": "94",
                         "spark.rapids.sql.placement.h2dMBps": "100000",
                         "spark.rapids.sql.placement.d2hMBps": "100000",
                         "spark.rapids.sql.placement.cpuRowsPerSec":
                             "1000"})
    got = q(s)._host()
    _same(got, want)
    assert any(r.get("decision") == "placement_demoted"
               for r in find_adaptive(s._last_plan).reports)


@pytest.mark.parametrize("extra", [
    {"spark.rapids.sql.fusion.enabled": "false"},
    {"spark.rapids.sql.fusion.maxOps": "2"}])
def test_fusion_settings_agree_bit_for_bit(extra):
    _card()
    c = st.col
    data = _data()

    def q(s):
        return (s.create_dataframe(data)
                .select((c("v") * 2.0).alias("v2"), c("k"), c("w"))
                .filter((c("v2") > 0.0) & (c("k") < 900))
                .select((c("v2") + 1.0).alias("a"),
                        (c("w") * 0.5).alias("b"), c("k")))
    assert q(st.TorchSession(extra))._host().equals(
        q(st.TorchSession({}))._host())


def test_store_loads_what_it_built(tmp_path):
    _card()
    from spark_rapids_tpu_torch.compile import store, warm
    from spark_rapids_tpu_torch.conf import TorchConf
    from spark_rapids_tpu_torch import compile as compile_pkg
    conf = TorchConf({"spark.rapids.sql.compile.store.enabled": "true",
                      "spark.rapids.sql.compile.cacheDir": str(tmp_path),
                      "spark.rapids.sql.compile.warm.enabled": "false"})
    try:
        native.unload_all()
        compile_pkg.configure_from_conf(conf)
        native.build_all()
        assert store.current().stats()["misses"] == len(native.KERNELS)
        native.unload_all()
        store.reset()
        compile_pkg.configure_from_conf(conf)
        device = torch.device("cuda", torch.cuda.current_device())
        native.reset_launches()
        for name in native.KERNELS:
            warm.WARMERS[name](device)
        torch.cuda.synchronize()
        assert store.current().stats()["hits"] == len(native.KERNELS)
        assert store.current().stats()["misses"] == 0
        assert all(v == 1 for v in native.LAUNCHES.values())
    finally:
        store.reset()
        native.unload_all()
