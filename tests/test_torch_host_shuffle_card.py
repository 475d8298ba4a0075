"""The host shuffle's reduce side on the card.

* a group-by over 8 CSV files with 2 map worker processes: the map side
  runs on the host, the reduce here on the card, K1 launched there, the
  result the in-process query's (integers exact, floats within 1e-9
  relative, the order-of-sums class of ``exec/pallas_agg.py``);
* no worker reports a CUDA context, and the transport is the native one;
* a join whose two sides both shuffle gives the in-process result.

Marked ``cuda``: each test skips itself without a card.  The file
imports neither JAX nor pyarrow, so it runs on the card's machine:

    python -m pytest tests/test_torch_host_shuffle_card.py -q --noconftest
"""

import numpy as np
import pytest
import torch

import spark_rapids_tpu_torch as st
from spark_rapids_tpu_torch import functions as F
from spark_rapids_tpu_torch import native

pytestmark = pytest.mark.cuda

WORKERS = {"spark.rapids.shuffle.workers.count": 2,
           "spark.rapids.shuffle.stage.timeout": 120,
           "spark.rapids.sql.scan.deviceCacheEnabled": False,
           "spark.sql.autoBroadcastJoinThreshold": -1}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the reduce side runs on it")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    root = tmp_path_factory.mktemp("host_shuffle_card")
    rng = np.random.default_rng(9)
    s = st.TorchSession({})
    n = 400_000
    data = {"k": rng.integers(0, 1000, n), "v": rng.normal(size=n),
            "w": rng.normal(size=n).astype(np.float32)}
    dim = {"k": np.arange(1000, dtype=np.int64),
           "grp": rng.integers(0, 50, 1000)}
    for name, cols in (("fact", data), ("dim", dim)):
        rows = len(cols["k"])
        for i in range(8):
            lo, hi = i * rows // 8, (i + 1) * rows // 8
            s.create_dataframe({k: v[lo:hi] for k, v in cols.items()}) \
                .write.mode("append").csv(str(root / name))
    return str(root / "fact"), str(root / "dim")


def _exchanges(plan):
    out = [plan] if type(plan).__name__ == \
        "TorchHostShuffleExchangeExec" else []
    for c in plan.children:
        out += _exchanges(c)
    return out


def _same(a, b, rtol=1e-9):
    assert a.schema.names == b.schema.names and a.num_rows == b.num_rows
    for name in a.schema.names:
        (x, vx), (y, vy) = a.columns[name], b.columns[name]
        assert np.array_equal(vx, vy)
        if x.dtype.kind == "f":
            assert np.allclose(x[vx], y[vy], rtol=rtol, atol=0.0)
        else:
            assert np.array_equal(x[vx], y[vy])


def test_groupby_reduces_on_the_card_with_k1(files):
    _card()
    fact, _ = files
    c = st.col

    def q(s):
        return (s.read.csv(fact).group_by("k")
                .agg(F.count(c("v")).alias("n"), F.sum(c("v")).alias("s"),
                     F.max(c("w")).alias("mx")).order_by("k"))
    s = st.TorchSession(WORKERS)
    native.reset_launches()
    got = q(s)._host()
    assert native.LAUNCHES["dense_slot_reduce"] > 0
    ex, = _exchanges(s._last_plan)
    infos = list(ex.last_run["workers"].values())
    assert len(infos) == 2
    assert not any(i["cuda_initialized"] for i in infos)
    assert not any("/dev/nvidia-uvm" in i["card_files"] for i in infos)
    assert ex.last_run["native"] is True
    assert ex.metrics["shuffleRowsWritten"] == 400_000
    _same(got, q(st.TorchSession({}))._host())
    assert got.num_rows == 1000


def test_join_with_both_sides_shuffled_equals_in_process(files):
    _card()
    fact, dim = files
    c = st.col

    def q(s):
        return (s.read.csv(fact).join(s.read.csv(dim), on="k")
                .group_by("grp").agg(F.sum(c("v")).alias("s"))
                .order_by("grp"))
    s = st.TorchSession(WORKERS)
    got = q(s)._host()
    assert len(_exchanges(s._last_plan)) == 2
    _same(got, q(st.TorchSession({}))._host())
