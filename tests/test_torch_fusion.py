"""The port's fusion pass (``plan/fusion.py``) against the JAX package's.

Analog of ``tests/test_fusion.py``.  The same queries run through both
packages under ``spark.rapids.sql.fusion.enabled`` on and off,
``spark.rapids.sql.fusion.maxOps=2`` and a 20-operator chain, over one
4,000-row parquet file read in 1,500-row batches:

* the plans have the JAX package's shape: the project, filter and stage
  operators in tree order, ``Tpu`` read as ``Torch``, each with the same
  step count (the 20-operator chain splits 16 + 4; a chain of one is a
  ``TorchProjectExec`` or ``TorchFilterExec``);
* the results equal the JAX package's (f64 exact: the chains' float
  constants are powers of two, so their products are exact in both);
* a fused stage dispatches once a batch and counts its steps in
  ``fusedOps``, as the JAX stage does;
* the pass opens the ``plan.fusion`` range.

Each test runs torch with one intra-op thread.
"""

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from spark_rapids_tpu import functions as F
from spark_rapids_tpu.api import col
from tests.compare import assert_tables_equal, tpu_session

import spark_rapids_tpu_torch as st
from spark_rapids_tpu_torch import functions as TF
from spark_rapids_tpu_torch.plan import fusion
from tests.torch_threads import _one_torch_thread  # noqa: F401

N = 4000
BATCH = {"spark.rapids.sql.reader.batchSizeRows": "1500"}


@pytest.fixture(scope="module")
def path(tmp_path_factory):
    rng = np.random.default_rng(11)
    t = pa.table({
        "k": pa.array(rng.integers(0, 100, N), pa.int64()),
        "v": pa.array(rng.normal(size=N)),
        "w": pa.array(rng.normal(size=N).astype(np.float32)),
    })
    p = str(tmp_path_factory.mktemp("torch_fusion") / "t.parquet")
    pq.write_table(t, p, row_group_size=1500)
    return p


def _chain(c, df):
    """The JAX test's project -> filter -> project chain."""
    return (df.select((c("v") * 2.0).alias("v2"),
                      (c("v") + c("w")).alias("vw"), c("k"))
              .filter((c("v2") > 0.0) & (c("k") < 90))
              .select((c("v2") + 1.0).alias("a"),
                      (c("vw") * 0.5).alias("b"), c("k")))


def _long_chain(n):
    def q(c, f, df):
        for i in range(n):
            df = df.select((c("v") + float(i)).alias("v"), c("k"))
        return df
    return q


QUERIES = {
    "chain": lambda c, f, df: _chain(c, df),
    "lone_filter": lambda c, f, df: df.filter(c("k") < 50),
    "lone_project": lambda c, f, df: df.select((c("v") * 4.0).alias("x")),
    # an aggregate splits two chains
    "two_chains": lambda c, f, df: (
        _chain(c, df).group_by("k").agg(f.count(c("a")).alias("n"))
        .filter(c("n") > 1).select(c("k"), (c("n") * 2).alias("m"))),
    "six_selects": _long_chain(6),
    "twenty_ops": _long_chain(20),
}

SETTINGS = {
    "on": {},
    "off": {"spark.rapids.sql.fusion.enabled": "false"},
    "max2": {"spark.rapids.sql.fusion.maxOps": "2"},
}


def _shape(root, prefix):
    """[(operator, steps)] of the project/filter/stage operators in tree
    order, the package prefix dropped."""
    out = []

    def walk(n):
        name = type(n).__name__[len(prefix):]
        if name in ("ProjectExec", "FilterExec"):
            out.append((name, 1))
        elif name == "StageExec":
            out.append((name, len(n.steps)))
        for c in n.children:
            walk(c)
    walk(root)
    return out


def _run(qname, extra, path):
    conf = {**BATCH, **extra}
    js = tpu_session(conf)
    try:
        jt = QUERIES[qname](col, F, js.read.parquet(path)).to_arrow()
        jshape = _shape(js._last_plan_result.physical, "Tpu")
    finally:
        js.stop()
    ts = st.TorchSession({"spark.rapids.torch.device": "cpu", **conf})
    tt = QUERIES[qname](st.col, TF, ts.read.parquet(path)).to_arrow()
    return jt, jshape, tt, ts


@pytest.mark.parametrize("setting", sorted(SETTINGS))
@pytest.mark.parametrize("qname", sorted(QUERIES))
def test_plan_shape_and_rows_match_jax(path, qname, setting):
    jt, jshape, tt, ts = _run(qname, SETTINGS[setting], path)
    assert _shape(ts._last_plan, "Torch") == jshape
    assert_tables_equal(tt, jt, ignore_order=False)


def test_twenty_op_chain_splits_sixteen_and_four(path):
    _, jshape, _, ts = _run("twenty_ops", {}, path)
    assert _shape(ts._last_plan, "Torch") == jshape == \
        [("StageExec", 4), ("StageExec", 16)]


def test_lone_operators_keep_their_names(path):
    for qname, want in (("lone_filter", "TorchFilterExec"),
                        ("lone_project", "TorchProjectExec")):
        _, _, _, ts = _run(qname, {}, path)
        names = []

        def walk(n):
            names.append(type(n).__name__)
            for c in n.children:
                walk(c)
        walk(ts._last_plan)
        assert want in names and "TorchStageExec" not in names
        assert ts.last_query_profile().root.describe.startswith(
            want[:-4])


def test_single_dispatch_per_batch(path):
    """The JAX test's acceptance shape: one stage of three steps, one
    dispatch a batch."""
    _, _, _, ts = _run("chain", {}, path)
    stage = ts._last_plan
    while type(stage).__name__ != "TorchStageExec":
        stage = stage.children[0]
    snap = stage.metrics.snapshot()
    assert snap["fusedOps"] == 3
    assert snap["numOutputBatches"] == 3  # 4,000 rows in 1,500-row reads
    assert snap["stageDispatches"] == snap["numOutputBatches"]


def test_lone_operators_count_no_stage_dispatch(path):
    """A TorchFilterExec, like the JAX TpuFilterExec, is no stage: it
    counts output batches but no stageDispatches."""
    _, _, _, ts = _run("lone_filter", {}, path)
    snap = ts._last_plan.metrics.snapshot()
    assert snap.get("stageDispatches", 0) == 0
    assert snap["numOutputBatches"] == 3


def test_fusion_opens_the_plan_fusion_range(path, monkeypatch):
    opened = []
    real = fusion.tracing.trace_range

    def spy(name, metric=None):
        opened.append(name)
        return real(name, metric)
    monkeypatch.setattr(fusion.tracing, "trace_range", spy)
    ts = st.TorchSession({"spark.rapids.torch.device": "cpu"})
    _chain(st.col, ts.read.parquet(path)).count()
    assert opened == ["plan.fusion"]
    opened.clear()
    off = st.TorchSession({"spark.rapids.torch.device": "cpu",
                           "spark.rapids.sql.fusion.enabled": "false"})
    _chain(st.col, off.read.parquet(path)).count()
    assert opened == []


def test_fusion_keys_have_the_jax_defaults():
    from spark_rapids_tpu import conf as jconf
    from spark_rapids_tpu_torch import conf as tconf
    for name in ("FUSION_ENABLED", "FUSION_MAX_OPS"):
        j, t = getattr(jconf, name), getattr(tconf, name)
        assert (t.key, t.default) == (j.key, j.default)
