"""The port's planner-lowered mesh plans (``spark.rapids.sql.mesh.devices``,
``spark_rapids_tpu_torch/exec/meshexec.py: mesh_lower``) against the JAX
package's.

Analog of ``tests/test_meshplan.py``.  The JAX sessions run over the
tests' 8 virtual CPU devices, the port's over 8 shards on ``cpu``
(``parallel/mesh.py: virtual_pool(8)``):

* the plans print alike once ``Tpu`` reads ``Torch`` (the JAX root's
  ``DeviceToHost`` dropped): a group-by under a sort, and the fact ⋈
  dimension → group-by → order-by shape whose broadcast join lowers to
  the shuffled mesh join over the broadcast exchange, with no coalesce;
* ``mesh.devices=16`` over a pool of 8 keeps the single-device plan in
  both packages, with no error;
* the C1 regression: ``group_by("k").agg(sum("v"))`` over 100 rows at
  ``mesh.devices=8`` plans ``TorchMeshAggregate [mesh=8, keys=[k]]``
  over the scan, where the port used to run it on one device;
* results against the JAX package's mesh sessions: a group-by and sort
  in order (``ignore_order=False``), the fact-fact join, the left,
  right, full, semi and anti joins, TPC-H q3 and q5 at 8,000 lineitem
  rows, and the join and sort under the JAX test's 96 KiB device
  budget.  Integers exact; f64 sums within ``approx_float``'s 1e-9
  relative, the order-of-sums class of ``exec/pallas_agg.py``.
"""

import re

import numpy as np
import pyarrow as pa
import pytest

from spark_rapids_tpu import functions as F
from spark_rapids_tpu.api import col
from spark_rapids_tpu.bench.tpch import TPCH_QUERIES as JAX_QUERIES
from spark_rapids_tpu.bench.tpch import gen_tpch
from spark_rapids_tpu.bench.tpch import load_tables as jload
from spark_rapids_tpu.plan.planner import plan_query as jplan_query
from tests.compare import assert_tables_equal, tpu_session
from tests.torch_threads import _one_torch_thread  # noqa: F401

import spark_rapids_tpu_torch as st
from spark_rapids_tpu_torch import functions as TF
from spark_rapids_tpu_torch.bench.tpch import TPCH_QUERIES
from spark_rapids_tpu_torch.bench.tpch import load_tables as tload
from spark_rapids_tpu_torch.memory.spill import SpillableBatch
from spark_rapids_tpu_torch.parallel.mesh import virtual_pool
from spark_rapids_tpu_torch.plan.planner import plan_query
from spark_rapids_tpu_torch.runtime import TorchRuntime

MESH = {"spark.rapids.sql.mesh.devices": 8}
POOL8 = {"spark.rapids.torch.device": "cpu"}


@pytest.fixture(scope="module", autouse=True)
def _pool8():
    """The port's pool: 8 shards on ``cpu`` for every test here."""
    with virtual_pool(8):
        yield


def _tsession(extra=None):
    return st.TorchSession({**POOL8, **(extra or {})})


def _normalize(tree: str) -> str:
    lines = [ln for ln in tree.splitlines() if ln.strip() != "DeviceToHost"]
    pad = min(len(ln) - len(ln.lstrip()) for ln in lines)
    out = "\n".join(ln[pad:] for ln in lines).replace("Tpu", "Torch")
    return re.sub(r" \[TargetSize\(\d+\)\]", "", out)


def _trees(build, conf):
    js, ts = tpu_session(conf), _tsession(conf)
    jtree = jplan_query(build(js, F, col).plan, js.conf).physical \
        .tree_string()
    return _normalize(jtree), plan_query(build(ts, TF, st.col).plan,
                                         ts.conf).tree_string()


def _run_both(build, conf, ignore_order=True):
    """The JAX package's and the port's results of ``build`` under
    ``conf`` -> the port's session."""
    want = build(tpu_session(conf), F, col).to_arrow()
    ts = _tsession(conf)
    got = build(ts, TF, st.col).to_arrow()
    assert want.num_rows > 0
    assert_tables_equal(got, want, ignore_order=ignore_order,
                        approx_float=True)
    return ts


def _table(n=4000, seed=0):
    rng = np.random.default_rng(seed)
    return pa.table({
        "k": pa.array(rng.integers(0, 37, n), pa.int64()),
        "v": pa.array(rng.normal(size=n)),
        "w": pa.array(rng.integers(-5, 5, n), pa.int64()),
    })


def _fact_dim(seed=1):
    rng = np.random.default_rng(seed)
    fact = pa.table({"k": pa.array(rng.integers(0, 120, 2000), pa.int64()),
                     "v": pa.array(rng.normal(size=2000))})
    dim = pa.table({"k": pa.array(np.arange(100, dtype=np.int64)),
                    "grp": pa.array(rng.integers(0, 7, 100), pa.int64())})
    return fact, dim


def _groupby_sort(t):
    def build(s, f, c):
        return (s.create_dataframe(t).group_by(c("k"))
                .agg(f.count(c("v")).alias("c"), f.sum(c("v")).alias("s"),
                     f.min(c("w")).alias("mn"), f.max(c("v")).alias("mx"),
                     f.avg(c("v")).alias("a"))
                .order_by(c("k")))
    return build


def _star(fact, dim):
    def build(s, f, c):
        return (s.create_dataframe(fact)
                .join(s.create_dataframe(dim), on="k", how="inner")
                .group_by(c("grp")).agg(f.sum(c("v")).alias("s"))
                .order_by(c("grp")))
    return build


# -- plans --------------------------------------------------------------------

def test_groupby_sort_plan_equals_jax():
    jtree, ttree = _trees(_groupby_sort(_table()), MESH)
    assert ttree == jtree
    assert ttree.splitlines()[0] == "TorchMeshSort [mesh=8, k ASC]"
    assert "TorchMeshAggregate [mesh=8, keys=[k]]" in ttree


def test_broadcast_join_lowers_to_the_mesh_join_as_in_jax():
    """Finding 2 of the slice: the broadcast join is a hash join, so the
    mesh lowering rewrites it to the shuffled mesh join, which drains
    the broadcast exchange as its right side; no coalesce is left."""
    jtree, ttree = _trees(_star(*_fact_dim()), MESH)
    assert ttree == jtree
    assert ttree == "\n".join([
        "TorchMeshSort [mesh=8, grp ASC]",
        "  TorchMeshAggregate [mesh=8, keys=[grp]]",
        "    TorchProject [k, v, grp]",
        "      TorchMeshHashJoin [mesh=8, inner, k=k]",
        "        TorchLocalScan [rows=2000]",
        "        TorchBroadcastExchange",
        "          TorchLocalScan [rows=100]"])


def test_mesh_wider_than_the_pool_keeps_the_single_device_plan():
    """Finding 1: ``mesh.devices=16`` over 8 devices plans as if the key
    were unset, in both packages, and runs with no error."""
    build = _star(*_fact_dim())
    jwide, twide = _trees(build, {"spark.rapids.sql.mesh.devices": 16})
    jnone, tnone = _trees(build, {})
    assert twide == tnone and jwide == jnone
    assert "Mesh" not in twide and "TorchBroadcastHashJoin" in twide
    _run_both(build, {"spark.rapids.sql.mesh.devices": 16},
              ignore_order=False)


def test_c1_mesh_devices_lowers_the_aggregate():
    """C1: a conf that asks for the mesh gets it (the port used to run
    this on one device with no error)."""
    rng = np.random.default_rng(7)
    t = pa.table({"k": pa.array(rng.integers(0, 10, 100), pa.int64()),
                  "v": pa.array(rng.normal(size=100))})

    def build(s, f, c):
        return s.create_dataframe(t).group_by("k").agg(f.sum("v"))
    jtree, ttree = _trees(build, MESH)
    assert ttree == jtree == "\n".join([
        "TorchMeshAggregate [mesh=8, keys=[k]]",
        "  TorchLocalScan [rows=100]"])
    ts = _run_both(build, MESH)
    agg = ts._last_plan
    assert agg.metrics["iciExchanges"] == 1
    # each shard's update took the dense-slot path (K1's plain version
    # on the CPU)
    assert agg.metrics["pallasAggBatches"] == 8


# -- results ------------------------------------------------------------------

def test_groupby_sort_in_order_equals_jax():
    ts = _run_both(_groupby_sort(_table()), MESH, ignore_order=False)
    plan = ts._last_plan
    assert type(plan).__name__ == "TorchMeshSortExec"
    # min over an int64 keeps the update on the sorted path, as in the
    # JAX package (its kernel takes no 64-bit min or max)
    agg = plan.children[0]
    assert agg.metrics["pallasAggBatches"] == 0
    assert agg.metrics["iciExchanges"] == plan.metrics["iciExchanges"] == 1


def test_star_join_equals_jax():
    ts = _run_both(_star(*_fact_dim()), MESH, ignore_order=False)
    assert ts._last_plan.children[0].children[0].children[0] \
        .metrics["iciExchanges"] == 2


def test_fact_fact_join_equals_jax():
    t1 = _table(3000, seed=2)
    rng = np.random.default_rng(3)
    t2 = pa.table({"k": pa.array(rng.integers(0, 37, 2000), pa.int64()),
                   "u": pa.array(rng.normal(size=2000))})

    def build(s, f, c):
        return (s.create_dataframe(t1)
                .join(s.create_dataframe(t2), on="k", how="inner")
                .group_by(c("k")).agg(f.count(c("u")).alias("c"),
                                      f.sum(c("u")).alias("su")))
    _run_both(build, MESH)


@pytest.mark.parametrize("how", ["left", "right", "full", "semi", "anti"])
def test_outer_semi_anti_joins_equal_jax(how):
    rng = np.random.default_rng(4)
    t1 = pa.table({"k": pa.array(rng.integers(0, 50, 1500), pa.int64()),
                   "v": pa.array(rng.normal(size=1500))})
    t2 = pa.table({"k": pa.array(rng.integers(25, 75, 800), pa.int64()),
                   "u": pa.array(rng.normal(size=800))})

    def build(s, f, c):
        return s.create_dataframe(t1).join(s.create_dataframe(t2), on="k",
                                           how=how)
    jtree, ttree = _trees(build, MESH)
    assert ttree == jtree and f"TorchMeshHashJoin [mesh=8, {how}" in ttree
    _run_both(build, MESH)


@pytest.fixture(scope="module")
def tpch_paths(tmp_path_factory):
    return gen_tpch(str(tmp_path_factory.mktemp("torch_tpch_mesh")),
                    lineitem_rows=8_000)


@pytest.mark.parametrize("qname", ["q3", "q5"])
def test_tpch_equals_jax(tpch_paths, qname):
    want = JAX_QUERIES[qname](jload(tpu_session(MESH), tpch_paths)) \
        .to_arrow()
    ts = _tsession(MESH)
    got = TPCH_QUERIES[qname](tload(ts, tpch_paths)).to_arrow()
    assert want.num_rows > 0
    assert_tables_equal(got, want, approx_float=True)
    assert "TorchMesh" in ts._last_plan.tree_string()


@pytest.fixture
def tiny_budget():
    TorchRuntime.reset()
    moves = []
    real = SpillableBatch._to_host

    def counted(self, *a, **k):
        moves.append(1)
        return real(self, *a, **k)
    SpillableBatch._to_host = counted
    yield moves
    SpillableBatch._to_host = real
    TorchRuntime.reset()


def test_join_under_tiny_budget_spills_and_equals_jax(tiny_budget):
    rng = np.random.default_rng(5)
    n = 4000
    fact = pa.table({"k": pa.array(rng.integers(0, 64, n), pa.int64()),
                     "v": pa.array(rng.normal(size=n))})
    dim = pa.table({"k": pa.array(np.arange(64, dtype=np.int64)),
                    "grp": pa.array(rng.integers(0, 5, 64), pa.int64())})
    conf = {**MESH, "spark.rapids.memory.tpu.budgetBytes": str(96 * 1024)}

    def build(s, f, c):
        return (s.create_dataframe(fact)
                .join(s.create_dataframe(dim), on="k", how="inner")
                .group_by(c("grp")).agg(f.sum(c("v")).alias("s"),
                                        f.count(c("k")).alias("c"))
                .order_by(c("grp")))
    jtree, ttree = _trees(build, conf)
    assert ttree == jtree and "TorchMeshHashJoin" in ttree
    _run_both(build, conf, ignore_order=False)
    assert tiny_budget, "the drained inputs never left the device"


def test_sort_under_tiny_budget_spills_and_equals_jax(tiny_budget):
    t = _table(6000, seed=6)
    conf = {**MESH, "spark.rapids.memory.tpu.budgetBytes": str(96 * 1024)}

    def build(s, f, c):
        return s.create_dataframe(t).order_by(c("k"), c("v"))
    jtree, ttree = _trees(build, conf)
    assert ttree == jtree and "TorchMeshSort" in ttree
    _run_both(build, conf, ignore_order=False)
