"""The torch port's first slice end to end against the JAX package.

Both headline queries of ``bench.py`` (``project_filter_1m`` and
``hash_agg_sort_2m``) run at 5,000 rows from one parquet file through
both packages' sessions, with 1,024-row reader and coalesce batches so
that several update batches and the merge run.  Tolerance: exact, except
f64 sums (relative 1e-9, ``approx_float``).  The fused stage is also
held against the JAX package's ``emit_steps`` on carried-across planes.
"""

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import jax.numpy as jnp

from spark_rapids_tpu import functions as F
from spark_rapids_tpu.api import col
from spark_rapids_tpu.columnar import dtypes as jdt
from spark_rapids_tpu.columnar.batch import host_batch_to_device as jupload
from spark_rapids_tpu.exec.stage import emit_steps as jemit
from spark_rapids_tpu.exprs.base import ColVal as JColVal
from spark_rapids_tpu.exprs.base import bind_expression as jbind
from tests.compare import assert_tables_equal, tpu_session

import spark_rapids_tpu_torch as st
from spark_rapids_tpu_torch import functions as TF
from spark_rapids_tpu_torch.columnar import dtypes as tdt
from spark_rapids_tpu_torch.columnar.interop import batch_from_planes
from spark_rapids_tpu_torch.exec.stage import emit_steps as temit
from spark_rapids_tpu_torch.exprs.base import ColVal
from spark_rapids_tpu_torch.exprs.base import bind_expression as tbind

N = 5000
CONF = {"spark.rapids.sql.reader.batchSizeRows": "1024",
        "spark.rapids.sql.batchSizeRows": "1024"}


def _table(n=N, seed=7):
    """bench.py:gen_data's columns, with some nulls."""
    rng = np.random.default_rng(seed)
    return pa.table({
        "k": pa.array(rng.integers(0, 1000, n), pa.int64(),
                      mask=rng.random(n) < 0.02),
        "v": pa.array(rng.normal(size=n), mask=rng.random(n) < 0.02),
        "w": pa.array(rng.normal(size=n).astype(np.float32)),
    })


@pytest.fixture(scope="module")
def path(tmp_path_factory):
    p = str(tmp_path_factory.mktemp("slice") / "main.parquet")
    pq.write_table(_table(), p, row_group_size=1000)
    return p


def project_filter(c, s, p):
    df = s.read.parquet(p)
    return (df.filter((c("v") > 0.0) & (c("k") < 900))
              .select((c("v") * 2.0 + 1.0).alias("a"),
                      (c("v") + c("w")).alias("b"), c("k")))


def agg_sort(c, fns, s, p):
    return (s.read.parquet(p).group_by(c("k"))
            .agg(fns.count(c("v")).alias("cnt"), fns.sum(c("v")).alias("s"),
                 fns.max(c("w")).alias("mx"))
            .order_by(c("k")))


def _torch_session():
    return st.TorchSession({"spark.rapids.torch.device": "cpu", **CONF})


def _find(plan, name):
    if type(plan).__name__ == name:
        return plan
    for c in plan.children:
        r = _find(c, name)
        if r is not None:
            return r
    return None


def test_project_filter_matches_jax(path):
    jt = project_filter(col, tpu_session(CONF), path).to_arrow()
    ts = _torch_session()
    tt = project_filter(st.col, ts, path).to_arrow()
    assert tt.num_rows > 0
    assert_tables_equal(tt, jt, ignore_order=False)
    stage = _find(ts._last_plan, "TorchStageExec")
    assert [k for k, _ in stage.steps] == ["filter", "project"]
    assert stage.metrics["stageDispatches"] == 5  # one per reader batch


def test_hash_agg_sort_matches_jax(path):
    js = tpu_session(CONF)
    jt = agg_sort(col, F, js, path).to_arrow()
    ts = _torch_session()
    tt = agg_sort(st.col, TF, ts, path).to_arrow()
    assert_tables_equal(tt, jt, ignore_order=False, approx_float=True)
    jused = _find(js._last_plan_result.physical, "TpuHashAggregateExec") \
        .metrics["pallasAggBatches"].value
    # every one of the five update batches takes the dense-slot path; the
    # JAX package stops probing key ranges after two fresh batches (a
    # guard against its host link's latency), so it counts fewer
    tagg = _find(ts._last_plan, "TorchHashAggregateExec")
    assert tagg.metrics["pallasAggBatches"] == 5 and jused > 0
    keys = tt.column("k").to_pylist()
    assert keys[0] is None and keys[1:] == sorted(keys[1:])


def test_slice_matches_numpy_without_pyarrow_input():
    """The numpy path (no Arrow anywhere) against numpy arithmetic."""
    rng = np.random.default_rng(7)
    k = rng.integers(0, 1000, N)
    v = rng.normal(size=N)
    w = rng.normal(size=N).astype(np.float32)
    s = st.TorchSession({"spark.rapids.torch.device": "cpu"})
    df = s.create_dataframe({"k": k, "v": v, "w": w})
    cols, masks, n = (df.filter((st.col("v") > 0.0) & (st.col("k") < 900))
                      .select((st.col("v") * 2.0 + 1.0).alias("a"),
                              (st.col("v") + st.col("w")).alias("b"),
                              st.col("k")).to_torch())
    keep = (v > 0) & (k < 900)
    assert n == keep.sum()
    np.testing.assert_array_equal(cols["a"].numpy(), v[keep] * 2.0 + 1.0)
    np.testing.assert_array_equal(cols["b"].numpy(),
                                  v[keep] + w[keep].astype(np.float64))
    np.testing.assert_array_equal(cols["k"].numpy(), k[keep])
    rows = (df.group_by(st.col("k"))
              .agg(TF.count(st.col("v")).alias("cnt"),
                   TF.sum(st.col("v")).alias("s"),
                   TF.max(st.col("w")).alias("mx"))
              .order_by(st.col("k")).collect())
    uniq = np.unique(k)
    assert [r["k"] for r in rows] == uniq.tolist()
    assert [r["cnt"] for r in rows] == np.bincount(k)[uniq].tolist()
    np.testing.assert_allclose([r["s"] for r in rows],
                               np.bincount(k, weights=v)[uniq], rtol=1e-9,
                               atol=1e-12)
    mx = np.full(1000, -np.inf, np.float32)
    np.maximum.at(mx, k, w)
    assert [r["mx"] for r in rows] == mx[uniq].tolist()


def test_stage_matches_jax_emit_steps():
    """The fused filter + project over the same capacity-padded planes:
    same row count, identical valid values."""
    t = _table(3000, seed=2)
    jb = jupload(t, jdt.Schema.from_arrow(t.schema))
    planes = [(np.asarray(c.data), np.asarray(c.validity))
              for c in jb.columns]
    tb = batch_from_planes(planes, [tdt.INT64, tdt.FLOAT64, tdt.FLOAT32],
                           jb.num_rows, jb.capacity, "cpu",
                           names=t.column_names)

    def steps(c, bind, schema):
        pred = bind(((c("v") > 0.0) & (c("k") < 900)).expr, schema)
        proj = [bind(e.expr, schema) for e in
                ((c("v") * 2.0 + 1.0).alias("a"),
                 (c("v") + c("w")).alias("b"), c("k"))]
        return [("filter", (pred,)), ("project", tuple(proj))]

    jcols, jn = jemit(steps(col, jbind, jdt.Schema.from_arrow(t.schema)),
                      [JColVal(d, v, None) for d, v in
                       ((jnp.asarray(d), jnp.asarray(v))
                        for d, v in planes)],
                      jb.num_rows, jb.capacity, 0, ())
    tcols, tn = temit(steps(st.col, tbind, tb.schema),
                      [ColVal(c.data, c.validity) for c in tb.columns],
                      tb.num_rows, tb.capacity, "cpu")
    assert tn == int(jn)
    for jc, tc in zip(jcols, tcols):
        jv = np.asarray(jc.validity)
        np.testing.assert_array_equal(tc.validity.numpy(), jv)
        np.testing.assert_array_equal(tc.data.numpy()[jv],
                                      np.asarray(jc.data)[jv])


@pytest.mark.parametrize("ascending", [True, False])
def test_order_by_matches_jax(ascending):
    """Spark's order: nulls first ascending (last descending), NaN
    greatest, -0.0 equal to 0.0, ties in input order; exact."""
    rng = np.random.default_rng(4)
    n = 600
    f = rng.normal(size=n)
    f[rng.random(n) < 0.1] = np.nan
    f[rng.random(n) < 0.1] = -0.0
    f[rng.random(n) < 0.1] = 0.0
    t = pa.table({"f": pa.array(f, mask=rng.random(n) < 0.05),
                  "i": pa.array(rng.integers(-3, 3, n).astype(np.int32),
                                mask=rng.random(n) < 0.05),
                  "row": pa.array(np.arange(n))})

    def build(c, s):
        return s.create_dataframe(t).order_by(c("i"), c("f"),
                                              ascending=ascending)
    jt = build(col, tpu_session()).to_arrow()
    tt = build(st.col, st.TorchSession(
        {"spark.rapids.torch.device": "cpu"})).to_arrow()
    assert_tables_equal(tt, jt, ignore_order=False)


def test_planner_refuses_what_the_slice_lacks():
    """No CPU engine to route to: a cross join is refused by name."""
    s = st.TorchSession({"spark.rapids.torch.device": "cpu"})
    df = s.create_dataframe({"k": np.arange(4), "v": np.arange(4.0)})
    with pytest.raises(NotImplementedError, match="cross join"):
        df.join(df, on="k", how="cross").collect()
