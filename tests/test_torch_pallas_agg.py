"""The dense-slot group-by of the torch port against the JAX package.

The same seeded numpy inputs go through the JAX package (its Pallas
kernel ``_pallas_reduce`` in interpret mode on the CPU, and its plain
form ``_xla_reduce``) and through the port (``dense_slot_reduce`` on CPU
tensors, which runs its plain PyTorch version).  Tolerances: counts,
integer sums and min/max exact; float sums relative 1e-12 (the two sum
in different orders); query results through ``assert_tables_equal``
(exact, or relative 1e-9 where ``approx_float``).  The kernel itself is
compared with its plain version only where a card is present.
"""

import datetime as dt

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import jax.numpy as jnp

from spark_rapids_tpu import functions as F
from spark_rapids_tpu.api import col
from spark_rapids_tpu.columnar import dtypes as jdt
from spark_rapids_tpu.columnar.batch import host_batch_to_device
from spark_rapids_tpu.exec import aggregate as jagg
from spark_rapids_tpu.exec import pallas_agg as jpag
from spark_rapids_tpu.exprs import aggregates as jag
from spark_rapids_tpu.exprs.base import BoundReference as JRef
from spark_rapids_tpu.exprs.base import _batch_signature, _flatten_batch
from tests.compare import assert_tables_equal, tpu_session

import chip_smoke
import spark_rapids_tpu_torch as st
from spark_rapids_tpu_torch import functions as TF
from spark_rapids_tpu_torch import native
from spark_rapids_tpu_torch.columnar import dtypes as tdt
from spark_rapids_tpu_torch.columnar.interop import batch_from_planes
from spark_rapids_tpu_torch.exec import aggregate as tagg
from spark_rapids_tpu_torch.exec import pallas_agg as tpag
from spark_rapids_tpu_torch.exprs import aggregates as tag
from spark_rapids_tpu_torch.exprs.base import BoundReference as TRef
from spark_rapids_tpu_torch.exprs.base import ColVal

# every plane dtype x op the JAX make_update emits (int64 sums are f64
# limbs there; the port's int64 plane is checked against numpy below)
COMBOS = [("int32", "add"), ("int32", "min"), ("int32", "max"),
          ("float32", "min"), ("float32", "max"),
          ("float64", "add"), ("float64", "min"), ("float64", "max")]


def _planes(rng, capacity):
    out = []
    for dtype, _op in COMBOS:
        if dtype == "int32":
            out.append(rng.integers(-1000, 1000, capacity).astype(np.int32))
        else:
            out.append(rng.normal(size=capacity).astype(dtype))
    return out


def _assert_reduced(got, want, dtype, op, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype, what
    if dtype.startswith("float") and op == "add":
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12,
                                   err_msg=what)
    else:
        np.testing.assert_array_equal(got, want, err_msg=what)


@pytest.mark.parametrize("K", [128, 1024])
def test_dense_slot_reduce_reference_matches_jax(K):
    rng = np.random.default_rng(K)
    capacity = 1024
    # leave some slots empty so the neutrals are compared too
    gid = rng.integers(0, K - K // 8, capacity).astype(np.int32)
    # rows outside [0, K) add to no slot, in both packages
    out_of_range = rng.random(capacity) < 0.1
    gid[out_of_range] = rng.choice(
        np.array([-1, -7, K, K + 5, 1 << 30], np.int32),
        int(out_of_range.sum()))
    planes = _planes(rng, capacity)
    ops = tuple(op for _, op in COMBOS)
    jplanes = tuple(jnp.asarray(p) for p in planes)
    pallas = jpag._pallas_reduce(jnp.asarray(gid), jplanes, ops, K, capacity)
    xla = jpag._xla_reduce(jnp.asarray(gid), jplanes, ops, K)
    ours = tpag.dense_slot_reduce(torch.from_numpy(gid),
                                  [torch.from_numpy(p) for p in planes],
                                  list(ops), K)
    for (dtype, op), o, p, x in zip(COMBOS, ours, pallas, xla):
        _assert_reduced(o.numpy(), p, dtype, op, f"{dtype} {op} vs pallas")
        _assert_reduced(o.numpy(), x, dtype, op, f"{dtype} {op} vs xla")


def test_dense_slot_reduce_int64_sum_wraps():
    """The port's int64 sum plane wraps like Java (numpy int64 add)."""
    rng = np.random.default_rng(11)
    gid = rng.integers(0, 128, 4096).astype(np.int32)
    v = rng.integers(-(1 << 62), 1 << 62, 4096, dtype=np.int64)
    want = np.zeros(128, np.int64)
    np.add.at(want, gid, v)
    got = tpag.dense_slot_reduce(torch.from_numpy(gid),
                                 [torch.from_numpy(v)], ["add"], 128)[0]
    np.testing.assert_array_equal(got.numpy(), want)


def test_update_planes_of_the_headline_aggregate():
    """hash_agg_sort_2m's query gives the kernel gid and eight planes
    (Sum and Max each carry a count plane), which fit one launch."""
    rng = np.random.default_rng(7)
    n = 3000
    data = {"k": rng.integers(0, 1000, n), "v": rng.normal(size=n),
            "w": rng.normal(size=n).astype(np.float32)}
    from spark_rapids_tpu_torch.exec.base import ExecContext
    from spark_rapids_tpu_torch.plan.planner import plan_query
    s = _tsession()
    c = st.col
    q = s.create_dataframe(data).group_by(c("k")).agg(
        TF.count(c("v")).alias("cnt"), TF.sum(c("v")).alias("s"),
        TF.max(c("w")).alias("mx")).order_by(c("k"))
    agg = plan_query(q.plan).children[0]
    batch = next(agg.children[0].execute(ExecContext(s.conf, s.device)))
    cols = [ColVal(x.data, x.validity) for x in batch.columns]
    lo, hi = tpag.key_range(agg.spec.groupings[0], cols, batch.num_rows,
                            batch.capacity)
    K = tpag.slot_count(lo, hi)
    assert K == 1024
    gid, planes, ops, _ = tpag.update_planes(agg.spec, cols, batch.num_rows,
                                             batch.capacity, lo, K)
    assert gid.dtype == torch.int32
    i32, f32, f64 = torch.int32, torch.float32, torch.float64
    assert [(p.dtype, op) for p, op in zip(planes, ops)] == [
        (i32, "add"), (i32, "add"), (f64, "add"), (i32, "add"),
        (f32, "max"), (i32, "max"), (i32, "max"), (i32, "add")]
    assert tpag._plane_groups(planes, K) == [list(range(8))]


@pytest.mark.parametrize("dtype,n,K,sizes", [
    (torch.float64, 40, 1024, [28, 12]),   # shared-memory budget
    (torch.int32, 33, 128, [32, 1]),       # planes per launch
    (torch.int32, 6, 1024, [6]),           # the main path: one launch
])
def test_plane_groups_split_wide_specs(dtype, n, K, sizes):
    """A spec whose accumulators pass one block's shared memory splits
    into plane groups, in order, one kernel launch each."""
    planes = [torch.zeros(8, dtype=dtype) for _ in range(n)]
    groups = tpag._plane_groups(planes, K)
    assert [len(g) for g in groups] == sizes
    assert [j for g in groups for j in g] == list(range(n))


# the main path's eight planes: occupancy, count, sum (f64), the sum's
# count, max (f32), has-NaN, has-non-NaN, the max's count
MAIN_PATH_SIZES = [4, 4, 8, 4, 4, 4, 4, 4]


@pytest.mark.parametrize("K", [128, 1024])
@pytest.mark.parametrize("sizes", [MAIN_PATH_SIZES, [4] * 32, [8] * 32,
                                   [8, 4] * 16, [8] * 40 + [4, 4], [4]])
def test_launch_plan_fits_shared_memory(K, sizes):
    """Every launch of a spec fits one Hopper block's shared memory
    (232,448 bytes), takes at most 32 planes, covers the planes in order,
    and its grid is at most one wave of a 132-SM card and no more blocks
    than tiles."""
    for n in (1, 4099, (1 << 20) - 37, 1 << 20):
        for shape in ({}, {"threads": 512, "blocks_per_sm": 2},
                      {"threads": 256, "blocks_per_sm": 4}):
            plans = tpag.launch_plan(sizes, K, n, 132, **shape)
            assert [j for p in plans for j in p.planes] == \
                list(range(len(sizes)))
            for p in plans:
                assert len(p.planes) <= 32
                assert p.smem == sum((K * sizes[j] + 15) // 16 * 16
                                     for j in p.planes) <= 232448
                assert p.tile == 8 * p.threads
                assert 1 <= p.grid <= 132 * (2048 // p.threads)
                assert p.grid <= -(-n // p.tile)


def test_launch_plan_of_the_main_path():
    """The main path's spec is one launch of one 1024-thread block an SM,
    each block one tile of 8192 rows of the 2^20-row batch."""
    (plan,) = tpag.launch_plan(MAIN_PATH_SIZES, 1024, 1 << 20, 132)
    assert plan.planes == tuple(range(8))
    assert (plan.threads, plan.tile, plan.grid) == (1024, 8192, 128)
    assert plan.smem == 1024 * 36


@pytest.mark.parametrize("n,sms,grid", [
    (1 << 20, 132, 128), ((1 << 20) - 37, 132, 128), (32_000_000, 132, 132),
    (1, 132, 1), (0, 132, 1), (1 << 20, 114, 114)])
def test_fixed_order_grid_depends_on_rows_and_card(n, sms, grid):
    """The float adds' fixed-order pass takes one block a tile of 8,192
    rows, at most one an SM: its grid, and so the order of each float
    sum, follows from the row count and the card alone."""
    assert tpag.fsum_grid(n, sms) == grid


def _jax_batch(table):
    return host_batch_to_device(table, jdt.Schema.from_arrow(table.schema))


def _carry(jbatch, dtypes):
    planes = [(np.asarray(c.data), np.asarray(c.validity))
              for c in jbatch.columns]
    return batch_from_planes(planes, dtypes, jbatch.num_rows,
                             jbatch.capacity, "cpu")


def _specs(case):
    """(table, JAX spec, port spec) for one make_update case."""
    rng = np.random.default_rng(3)
    n = 3000
    keys = pa.array([None if rng.random() < 0.1 else int(x)
                     for x in rng.integers(-20, 20, n)], pa.int64())
    if case == "float":
        vals = rng.normal(size=n)
        vals[rng.random(n) < 0.05] = np.nan
        vals[:40] = -0.0
        v = pa.array(vals, mask=rng.random(n) < 0.07)
        table = pa.table({"k": keys, "v": v})
        fns = [("c", jag.Count, tag.Count), ("s", jag.Sum, tag.Sum),
               ("mn", jag.Min, tag.Min), ("mx", jag.Max, tag.Max),
               ("a", jag.Average, tag.Average)]
        vt = (jdt.FLOAT64, tdt.FLOAT64)
    elif case == "int":
        big = rng.integers(-(1 << 62), 1 << 62, n, dtype=np.int64)
        table = pa.table({"k": keys, "v": pa.array(big, pa.int64()),
                          "i8": pa.array(rng.integers(-128, 128, n),
                                         pa.int8(),
                                         mask=rng.random(n) < 0.2)})
        fns = [("s", jag.Sum, tag.Sum)]
        vt = (jdt.INT64, tdt.INT64)
    else:  # date key
        base = dt.date(2020, 1, 1)
        table = pa.table({
            "k": pa.array([base + dt.timedelta(days=int(d))
                           for d in rng.integers(0, 9, n)]),
            "v": pa.array(rng.normal(size=n))})
        fns = [("c", jag.Count, tag.Count)]
        vt = (jdt.FLOAT64, tdt.FLOAT64)
    kt = (jdt.DATE, tdt.DATE) if case == "date" else (jdt.INT64, tdt.INT64)
    jaggs = [(name, jf(JRef(1, vt[0], True, "v"))) for name, jf, _ in fns]
    taggs = [(name, tf(TRef(1, vt[1], True, "v"))) for name, _, tf in fns]
    if case == "int":
        jaggs += [("mn8", jag.Min(JRef(2, jdt.INT8, True, "i8"))),
                  ("mx8", jag.Max(JRef(2, jdt.INT8, True, "i8")))]
        taggs += [("mn8", tag.Min(TRef(2, tdt.INT8, True, "i8"))),
                  ("mx8", tag.Max(TRef(2, tdt.INT8, True, "i8")))]
    jspec = jagg._AggSpec([JRef(0, kt[0], True, "k")], jaggs)
    tspec = tagg._AggSpec([TRef(0, kt[1], True, "k")], taggs)
    return table, jspec, tspec


def _assert_colvals_equal(n, got: ColVal, want, what):
    gv, wv = got.validity[:n].numpy(), np.asarray(want.validity)[:n]
    np.testing.assert_array_equal(gv, wv, err_msg=what)
    gd, wd = got.data[:n].numpy()[gv], np.asarray(want.data)[:n][wv]
    assert gd.dtype == wd.dtype, what
    if gd.dtype.kind == "f":
        # float sums differ in order only; NaN where NaN
        np.testing.assert_allclose(gd, wd, rtol=1e-12, atol=1e-12,
                                   equal_nan=True, err_msg=what)
    else:
        np.testing.assert_array_equal(gd, wd, err_msg=what)


@pytest.mark.parametrize("case", ["float", "int", "date"])
def test_make_update_matches_jax(case):
    table, jspec, tspec = _specs(case)
    jb = _jax_batch(table)
    tb = _carry(jb, [tdt.DATE if case == "date" else tdt.INT64]
                + [{"double": tdt.FLOAT64, "long": tdt.INT64,
                    "byte": tdt.INT8}[c.dtype.name]
                   for c in jb.columns[1:]])
    assert jpag.supports(jspec) and tpag.supports(tspec)
    lo, hi = jpag.key_range(jspec.groupings[0], jb)
    tcols = [ColVal(c.data, c.validity) for c in tb.columns]
    assert tpag.key_range(tspec.groupings[0], tcols, tb.num_rows,
                          tb.capacity) == (lo, hi)
    jfn = jpag.make_update(jspec, _batch_signature(jb), jb.capacity, lo, hi)
    jn, jkeys, jbufs = jfn(_flatten_batch(jb), jb.rows_traced,
                           jnp.int64(lo))
    tfn = tpag.make_update(tspec, tb.capacity, lo, hi)
    tn, tkeys, tbufs = tfn(tcols, tb.num_rows, lo)
    assert tn == int(jn)
    for i, (g, w) in enumerate(zip(tkeys + tbufs, jkeys + jbufs)):
        _assert_colvals_equal(tn, g, w, f"{case} output {i}")


# -- counterparts of tests/test_pallas_agg.py, through both sessions -------

def _tsession(extra=None):
    conf = {"spark.rapids.torch.device": "cpu"}
    conf.update(extra or {})
    return st.TorchSession(conf)


def _agg_exec(plan):
    if type(plan).__name__ in ("TpuHashAggregateExec",
                               "TorchHashAggregateExec"):
        return plan
    for c in plan.children:
        r = _agg_exec(c)
        if r is not None:
            return r
    return None


def _both(build_jax, build_torch, conf=None, pallas="true"):
    """Run one query through both packages -> (jax table, torch table,
    jax pallasAggBatches, torch pallasAggBatches)."""
    js = tpu_session(conf)
    js.set_conf("spark.rapids.sql.tpu.pallas.agg.enabled", pallas)
    jt = build_jax(js).to_arrow()
    ts = _tsession(conf)
    ts.set_conf("spark.rapids.sql.tpu.pallas.agg.enabled", pallas)
    tt = build_torch(ts).to_arrow()
    jused = _agg_exec(js._last_plan_result.physical) \
        .metrics["pallasAggBatches"].value
    tused = _agg_exec(ts._last_plan).metrics["pallasAggBatches"]
    return jt, tt, jused, tused


def _table(n=5000, lo=-20, hi=20, null_keys=0.1, seed=0):
    rng = np.random.default_rng(seed)
    keys = [None if rng.random() < null_keys
            else int(x) for x in rng.integers(lo, hi, n)]
    vals = [None if rng.random() < 0.07 else float(x)
            for x in rng.normal(size=n)]
    return pa.table({"k": pa.array(keys, pa.int64()),
                     "v": pa.array(vals, pa.float64())})


def _five(pkg_col, fns, t):
    def build(s):
        return s.create_dataframe(t).group_by("k").agg(
            fns.count(pkg_col("v")).alias("c"),
            fns.sum(pkg_col("v")).alias("s"),
            fns.min(pkg_col("v")).alias("mn"),
            fns.max(pkg_col("v")).alias("mx"),
            fns.avg(pkg_col("v")).alias("a"))
    return build


def test_torch_pallas_agg_matches_sorted_kernel():
    t = _table()
    jt, fast, _, used_fast = _both(_five(col, F, t), _five(st.col, TF, t))
    assert used_fast > 0, "dense-slot path was not taken"
    _, slow, _, used_slow = _both(_five(col, F, t), _five(st.col, TF, t),
                                  pallas="false")
    assert used_slow == 0
    assert_tables_equal(fast, slow, approx_float=True)
    assert_tables_equal(fast, jt, approx_float=True)
    assert_tables_equal(slow, jt, approx_float=True)


def test_torch_pallas_agg_compare_jax():
    t = _table(seed=3)

    def build(c, fns):
        return lambda s: s.create_dataframe(t).group_by("k").agg(
            fns.count(c("v")).alias("c"), fns.sum(c("v")).alias("s"),
            fns.avg(c("v")).alias("a"))
    jt, tt, _, tused = _both(build(col, F), build(st.col, TF))
    assert tused > 0
    assert_tables_equal(tt, jt, approx_float=True)


def test_torch_pallas_agg_nan_min_max_semantics():
    t = pa.table({
        "k": pa.array([0, 0, 1, 1, 2], pa.int64()),
        "v": pa.array([1.0, float("nan"), float("nan"), float("nan"),
                       5.0]),
    })
    jt, tt, _, used = _both(_five(col, F, t), _five(st.col, TF, t))
    assert used > 0
    assert_tables_equal(tt, jt)
    by_k = {r["k"]: r for r in tt.to_pylist()}
    assert by_k[0]["mn"] == 1.0 and np.isnan(by_k[0]["mx"])
    assert np.isnan(by_k[1]["mn"]) and np.isnan(by_k[1]["mx"])
    assert by_k[2]["mn"] == 5.0 and by_k[2]["mx"] == 5.0


def test_torch_pallas_agg_int_sums_exact():
    big = 1 << 62
    t = pa.table({"k": pa.array([0, 0, 1], pa.int64()),
                  "v": pa.array([big, big, 7], pa.int64())})

    def build(c, fns):
        return lambda s: s.create_dataframe(t).group_by("k").agg(
            fns.sum(c("v")).alias("s"))
    jt, tt, _, used = _both(build(col, F), build(st.col, TF))
    assert used > 0
    assert_tables_equal(tt, jt)
    out = {r["k"]: r["s"] for r in tt.to_pylist()}
    assert out[0] == -(1 << 63)  # 2^62 + 2^62 wraps to INT64_MIN
    assert out[1] == 7


def test_torch_pallas_agg_wide_domain_falls_back():
    rng = np.random.default_rng(1)
    t = pa.table({
        "k": pa.array(rng.integers(0, 10**9, 3000), pa.int64()),
        "v": pa.array(rng.normal(size=3000)),
    })
    jt, tt, jused, used = _both(_five(col, F, t), _five(st.col, TF, t))
    assert used == jused == 0  # domain too wide -> sorted path
    assert_tables_equal(tt, jt, approx_float=True)


def test_torch_pallas_agg_date_key():
    base = dt.date(2020, 1, 1)
    t = pa.table({
        "k": pa.array([base + dt.timedelta(days=i % 7)
                       for i in range(500)]),
        "v": pa.array(np.arange(500, dtype=np.float64)),
    })

    def build(c, fns):
        return lambda s: s.create_dataframe(t).group_by("k").agg(
            fns.count(c("v")).alias("c"))
    jt, tt, _, used = _both(build(col, F), build(st.col, TF))
    assert used > 0
    assert tt.num_rows == 7
    assert_tables_equal(tt, jt)


def test_torch_pallas_agg_multi_batch_merge(tmp_path):
    """Dense-slot updates per row-group batch, sorted merge combines."""
    rng = np.random.default_rng(5)
    n = 40_000
    t = pa.table({"k": pa.array(rng.integers(-5, 6, n), pa.int64()),
                  "v": pa.array(rng.normal(size=n))})
    p = str(tmp_path / "m.parquet")
    pq.write_table(t, p, row_group_size=8_000)
    conf = {"spark.rapids.sql.reader.batchSizeRows": "8192",
            "spark.rapids.sql.batchSizeBytes": "131072"}

    def build(c, fns):
        return lambda s: s.read.parquet(p).group_by("k").agg(
            fns.sum(c("v")).alias("s"), fns.count(c("v")).alias("c"))
    jt, tt, _, used = _both(build(col, F), build(st.col, TF), conf)
    assert used == 5  # one per row-group batch
    assert tt.num_rows == 11
    assert sum(tt.column("c").to_pylist()) == n
    assert_tables_equal(tt, jt, approx_float=True)


def test_torch_pallas_agg_narrow_int_all_null_group_merge(tmp_path):
    """An all-null narrow-int group's min/max sentinel must survive the
    cast back and lose the cross-batch merge."""
    t = pa.table({
        "k": pa.array([1, 1, 1, 1], pa.int64()),
        "v": pa.array([None, None, 5, -7], pa.int8()),
    })
    p = str(tmp_path / "n.parquet")
    pq.write_table(t, p, row_group_size=2)  # batch1 all-null, batch2 real
    conf = {"spark.rapids.sql.reader.batchSizeRows": "2",
            "spark.rapids.sql.batchSizeBytes": "64"}

    def build(c, fns):
        return lambda s: s.read.parquet(p).group_by("k").agg(
            fns.min(c("v")).alias("mn"), fns.max(c("v")).alias("mx"))
    jt, tt, _, used = _both(build(col, F), build(st.col, TF), conf)
    assert used >= 1
    assert tt.to_pylist() == [{"k": 1, "mn": -7, "mx": 5}]
    assert_tables_equal(tt, jt)


@pytest.mark.cuda
def test_dense_slot_kernel_matches_plain_version_on_card():
    """The CUDA kernel against its plain version on the same card
    tensors: integer and min/max planes exact, f64 sums within 1e-12 of
    the per-slot sum of |v| (atomics add in another order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    rng = np.random.default_rng(0)
    capacity, K = 1 << 16, 1024
    gid_np = rng.integers(0, K - 24, capacity).astype(np.int32)
    gid_np[rng.random(capacity) < 0.01] = -3    # ignored, as is K + 7
    gid_np[rng.random(capacity) < 0.01] = K + 7
    gid = torch.from_numpy(gid_np).cuda()
    planes = [torch.from_numpy(p).cuda() for p in _planes(rng, capacity)]
    planes.append(torch.from_numpy(
        rng.integers(-(1 << 62), 1 << 62, capacity, dtype=np.int64)).cuda())
    ops = [op for _, op in COMBOS] + ["add"]
    before = native.LAUNCHES["dense_slot_reduce"]
    got = tpag.dense_slot_reduce(gid, planes, ops, K)
    torch.cuda.synchronize()
    assert native.LAUNCHES["dense_slot_reduce"] == before + 1
    want = tpag.dense_slot_reduce_reference(gid, planes, ops, K)
    for p, op, g, w in zip(planes, ops, got, want):
        if p.dtype == torch.float64 and op == "add":
            scale = tpag.dense_slot_reduce_reference(
                gid, [p.abs()], ["add"], K)[0]
            assert torch.all((g - w).abs() <= 1e-12 * scale + 1e-300)
        else:
            assert torch.equal(g, w), (p.dtype, op)
    # the edge specs chip_smoke.py holds on the card: all rows on one slot,
    # K = 128, plane groups, NaN / signed zeros / infinities under min and
    # max, wrapping int64 sums, gids of -1 and K + 3, a ragged row count
    # and planes off 16-byte alignment; one launch a plane group
    for name, g, p, o, k in chip_smoke.dsr_edge_specs(
            torch, np.random.default_rng(1)):
        before = native.LAUNCHES["dense_slot_reduce"]
        got = tpag.dense_slot_reduce(g, p, o, k)
        torch.cuda.synchronize()
        assert native.LAUNCHES["dense_slot_reduce"] == \
            before + len(tpag._plane_groups(p, k)), name
        chip_smoke.compare_kernel(torch, tpag, g, p, o, k, got)


@pytest.mark.cuda
def test_dense_slot_kernel_float_sums_repeat_on_card():
    """The kernel's float sums take one fixed order: f64 and f32 add
    planes come out bit for bit alike over 5 calls, with every row on two
    slots (TPC-H q8's batch) and over 1,024 slots with a ragged row
    count; the f64 sums stay within 1e-12 of each slot's sum of |v| from
    the plain version's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    rng = np.random.default_rng(2)
    for n, K, slots in ((1 << 20, 128, 2), ((1 << 20) - 37, 1024, 1024)):
        gid = torch.from_numpy(rng.integers(1, 1 + slots, n)
                               .astype(np.int32)).cuda()
        v = rng.normal(size=n) * 10.0 ** rng.integers(-3, 4, n)
        planes = [torch.ones(n, dtype=torch.int32, device="cuda"),
                  torch.from_numpy(v).cuda(),
                  torch.from_numpy(v.astype(np.float32)).cuda(),
                  torch.from_numpy(-v).cuda()]
        ops = ["add", "add", "add", "add"]
        first = tpag.dense_slot_reduce(gid, planes, ops, K)
        for _ in range(4):
            again = tpag.dense_slot_reduce(gid, planes, ops, K)
            for a, b in zip(first, again):
                assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))
        # the plain version's f64 sums, with the f32 plane left out (its
        # rounding has no bound compare_kernel states)
        keep = [0, 1, 3]
        chip_smoke.compare_kernel(torch, tpag, gid, [planes[j] for j in keep],
                                  [ops[j] for j in keep], K,
                                  [first[j] for j in keep])
