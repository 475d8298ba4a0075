"""The port's mesh pipelines (``spark_rapids_tpu_torch/parallel/``)
against the JAX package's.

Analog of ``tests/test_parallel.py``, ``tests/test_distsort.py`` and the
direct cases of ``tests/test_distjoin.py``.  The JAX side runs over the
tests' 8 virtual CPU devices (``tests/conftest.py``), the port over 8
shards on ``cpu`` (``parallel/mesh.py: virtual_pool(8)``), on the same
inputs:

* ``DistributedAggregate``: the JAX package's rows in the JAX package's
  order (integer and string keys, null keys, one row, three rows over
  eight shards, every row on one shard), counts, min and max exact, f64
  sums within 1e-9 relative (the order-of-sums class of
  ``exec/pallas_agg.py``);
* ``DistributedSort``: ints with nulls, descending floats with NaN and
  strings, row for row equal to the JAX package's output;
* ``DistributedHashJoin``: every join type against the JAX package's
  rows, compared without order (the two lay their blocks out
  differently), and the zipf-skewed inner join's pair counts exact;
* ``DistributedBroadcastJoinAggregate`` against the JAX package's, its
  duplicate build keys raising in both;
* ``gather_stacked``'s edges plane for plane against the JAX
  package's, the exchange's order, ``data_mesh`` raising
  ``ValueError`` in both, the pool rules and the dry run.
"""

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.columnar.batch import \
    host_batch_to_device as jhost_batch_to_device
from spark_rapids_tpu.columnar.dtypes import Schema as JSchema
from spark_rapids_tpu.exprs import aggregates as jagg
from spark_rapids_tpu.exprs.base import Alias as JAlias
from spark_rapids_tpu.exprs.base import BoundReference as JRef
from spark_rapids_tpu.parallel import data_mesh as jdata_mesh
from tests.fuzzer import gen_skewed_table
from tests.torch_threads import _one_torch_thread  # noqa: F401

from spark_rapids_tpu_torch.columnar.batch import host_batch_to_device, \
    host_columns_from_arrow
from spark_rapids_tpu_torch.columnar.dtypes import FLOAT64, INT64, STRING
from spark_rapids_tpu_torch.conf import TorchConf
from spark_rapids_tpu_torch.exprs import aggregates as tagg
from spark_rapids_tpu_torch.exprs.base import Alias, BoundReference
from spark_rapids_tpu_torch.parallel import DistributedAggregate, \
    DistributedBroadcastJoinAggregate, data_mesh
from spark_rapids_tpu_torch.parallel import mesh as tmesh

CPU = torch.device("cpu")
CONF8 = TorchConf({"spark.rapids.torch.device": "cpu"})
JTYPES = {"int64": "INT64", "double": "FLOAT64", "string": "STRING"}


@pytest.fixture(scope="module", autouse=True)
def _pool8():
    with tmesh.virtual_pool(8):
        yield


@pytest.fixture(scope="module")
def jmesh():
    return jdata_mesh(8)


@pytest.fixture(scope="module")
def tmesh8():
    return data_mesh(8, conf=CONF8)


def _jbatch(table: pa.Table):
    schema = JSchema.from_arrow(table.schema)
    return jhost_batch_to_device(table.combine_chunks().to_batches()[0],
                                 schema), schema


def _tbatch(table: pa.Table):
    schema, cols = host_columns_from_arrow(table)
    return host_batch_to_device(schema, cols, CPU), schema


def _rows(batch, jax_side: bool):
    """The batch's rows in order: tuples of Python values, None for
    null, strings decoded."""
    n = batch.num_rows
    cols = []
    for c in batch.columns:
        if jax_side:
            data, valid = np.asarray(c.data)[:n], np.asarray(c.validity)[:n]
            chars = None if c.chars is None else np.asarray(c.chars)[:n]
        else:
            data, valid = c.data[:n].numpy(), c.validity[:n].numpy()
            chars = None if c.chars is None else c.chars[:n].numpy()
        if chars is not None:
            vals = [bytes(chars[i][:data[i]]).decode() for i in range(n)]
        else:
            vals = data.tolist()
        cols.append([v if ok else None for v, ok in zip(vals, valid)])
    return list(zip(*cols))


def _close(a, b) -> bool:
    if a is None or b is None:
        return a is None and b is None
    if isinstance(a, float):
        if np.isnan(a) or np.isnan(b):
            return bool(np.isnan(a) and np.isnan(b))
        return abs(a - b) <= 1e-9 * max(1.0, abs(b))
    return a == b


def _assert_rows(got, want, ordered=True):
    assert len(got) == len(want)
    if not ordered:
        key = lambda r: tuple((v is None, str(type(v)), v if v is not None
                               else 0) for v in r)  # noqa: E731
        got, want = sorted(got, key=key), sorted(want, key=key)
    for g, w in zip(got, want):
        assert all(_close(a, b) for a, b in zip(g, w)), (g, w)


# -- DistributedAggregate ------------------------------------------------------

def _agg_pair(jmesh, tmesh8, table, keys, aggs_of):
    """Run one grouped aggregation through both packages -> (JAX rows,
    port rows, the port's pipeline)."""
    from spark_rapids_tpu.columnar import dtypes as jdt
    from spark_rapids_tpu.parallel import DistributedAggregate as JDA
    jb, _ = _jbatch(table)
    tb, _ = _tbatch(table)
    names = table.column_names
    jtypes = [getattr(jdt, JTYPES[str(table.schema.field(n).type)])
              for n in names]
    ttypes = [{"INT64": INT64, "FLOAT64": FLOAT64, "STRING": STRING}[
        JTYPES[str(table.schema.field(n).type)]] for n in names]
    jrefs = [JRef(i, t, True, n) for i, (n, t) in enumerate(zip(names,
                                                                jtypes))]
    trefs = [BoundReference(i, t, True, n)
             for i, (n, t) in enumerate(zip(names, ttypes))]
    jd = JDA([jrefs[i] for i in keys], aggs_of(jagg, JAlias, jrefs),
             mesh=jmesh)
    td = DistributedAggregate([trefs[i] for i in keys],
                              aggs_of(tagg, Alias, trefs), mesh=tmesh8,
                              conf=CONF8)
    return _rows(jd.run(jb), True), _rows(td.run(tb), False), td


def _four(m, A, r):
    return [A(m.Count(r[1]), "cnt"), A(m.Sum(r[1]), "s"),
            A(m.Min(r[1]), "mn"), A(m.Max(r[1]), "mx")]


def test_groupby_rows_and_order_equal_jax(jmesh, tmesh8):
    rng = np.random.default_rng(1)
    n = 4000
    table = pa.table({
        "k": pa.array(rng.integers(0, 97, n), pa.int64()),
        "v": pa.array(np.where(rng.random(n) < 0.1, None,
                               rng.integers(-1000, 1000, n).astype(float))),
    })
    want, got, td = _agg_pair(jmesh, tmesh8, table, [0], _four)
    assert len(got) == 97
    _assert_rows(got, want, ordered=True)
    # each shard's partial update took the dense-slot path (K1's plain
    # version here), and the exchange read one count matrix
    assert td.metrics["pallasAggBatches"] == 8
    assert td.last_counts.shape == (8, 8)


def test_groupby_string_and_null_keys_equal_jax(jmesh, tmesh8):
    rng = np.random.default_rng(2)
    n = 1000
    table = pa.table({
        "s": pa.array([f"grp-{i % 13}" if i % 29 else None
                       for i in range(n)]),
        "v": pa.array(rng.integers(0, 100, n).astype("int64")),
    })
    want, got, _ = _agg_pair(
        jmesh, tmesh8, table, [0],
        lambda m, A, r: [A(m.Count(r[1]), "cnt"), A(m.Sum(r[1]), "sum")])
    assert len(got) == 14 and any(r[0] is None for r in got)
    _assert_rows(got, want, ordered=True)


@pytest.mark.parametrize("keys", [[5], [5, 6, 5], [7] * 300],
                         ids=["one_row", "fewer_rows_than_shards",
                              "one_key_on_one_shard"])
def test_groupby_tiny_and_one_shard_inputs_equal_jax(jmesh, tmesh8, keys):
    table = pa.table({"k": pa.array(keys, pa.int64()),
                      "v": pa.array([float(i) for i in range(len(keys))])})
    want, got, td = _agg_pair(
        jmesh, tmesh8, table, [0],
        lambda m, A, r: [A(m.Sum(r[1]), "s"), A(m.Count(r[1]), "c")])
    _assert_rows(got, want, ordered=True)
    # every group lands on the one shard its key hashes to
    assert 1 <= (td.last_counts.sum(axis=0) > 0).sum() <= len(set(keys))


def test_groupby_empty_input_gives_no_rows(tmesh8):
    tb, _ = _tbatch(pa.table({"k": pa.array([], pa.int64()),
                              "v": pa.array([], pa.float64())}))
    k, v = BoundReference(0, INT64, True, "k"), \
        BoundReference(1, FLOAT64, True, "v")
    out = DistributedAggregate([k], [Alias(tagg.Sum(v), "s")], mesh=tmesh8,
                               conf=CONF8).run(tb)
    assert out.num_rows == 0 and len(out.columns) == 2


def test_broadcast_join_aggregate_equals_jax(jmesh, tmesh8):
    from spark_rapids_tpu.columnar import dtypes as jdt
    from spark_rapids_tpu.parallel import \
        DistributedBroadcastJoinAggregate as JBJ
    rng = np.random.default_rng(21)
    n = 64 * 8
    fact = pa.table({"k": pa.array(rng.integers(0, 30, n), pa.int64()),
                     "v": pa.array(rng.normal(size=n))})
    dim = pa.table({"k": pa.array(np.arange(20, dtype=np.int64)),
                    "grp": pa.array([f"g{i % 3}" for i in range(20)])})
    jd = JBJ(_jbatch(dim)[0], [JRef(0, jdt.INT64, True, "k")],
             [JRef(0, jdt.INT64, True, "k")],
             [JRef(3, jdt.STRING, True, "grp")],
             [JAlias(jagg.Count(JRef(1, jdt.FLOAT64, True, "v")), "c"),
              JAlias(jagg.Sum(JRef(1, jdt.FLOAT64, True, "v")), "s")],
             mesh=jmesh)
    v = BoundReference(1, FLOAT64, True, "v")
    td = DistributedBroadcastJoinAggregate(
        _tbatch(dim)[0], [BoundReference(0, INT64, True, "k")],
        [BoundReference(0, INT64, True, "k")],
        [BoundReference(3, STRING, True, "grp")],
        [Alias(tagg.Count(v), "c"), Alias(tagg.Sum(v), "s")], mesh=tmesh8,
        conf=CONF8)
    want = _rows(jd.run(_jbatch(fact)[0]), True)
    got = _rows(td.run(_tbatch(fact)[0]), False)
    assert len(got) == 3
    _assert_rows(got, want, ordered=True)


def test_duplicate_build_keys_raise_in_both(jmesh, tmesh8):
    from spark_rapids_tpu.columnar import dtypes as jdt
    from spark_rapids_tpu.parallel import \
        DistributedBroadcastJoinAggregate as JBJ
    dim = pa.table({"k": pa.array([1, 1], pa.int64()),
                    "g": pa.array([0, 1], pa.int64())})
    with pytest.raises(ValueError):
        JBJ(_jbatch(dim)[0], [JRef(0, jdt.INT64, True, "k")],
            [JRef(0, jdt.INT64, True, "k")],
            [JRef(2, jdt.INT64, True, "g")], [], mesh=jmesh)
    with pytest.raises(ValueError, match="unique build-side keys"):
        DistributedBroadcastJoinAggregate(
            _tbatch(dim)[0], [BoundReference(0, INT64, True, "k")],
            [BoundReference(0, INT64, True, "k")],
            [BoundReference(2, INT64, True, "g")], [], mesh=tmesh8,
            conf=CONF8)


# -- DistributedSort -----------------------------------------------------------

def _sort_tables():
    rng = np.random.default_rng(4)
    n = 4000
    ints = pa.table({
        "v": pa.array([None if rng.random() < 0.07 else int(x)
                       for x in rng.integers(-10_000, 10_000, n)],
                      pa.int64()),
        "tag": pa.array(np.arange(n, dtype=np.int64))})
    rng = np.random.default_rng(9)
    floats = pa.table({"v": pa.array(
        [float("nan") if rng.random() < 0.05 else float(x)
         for x in rng.normal(size=3000)], pa.float64())})
    rng = np.random.default_rng(2)
    words = pa.table({"s": pa.array(
        [f"w{int(x):04d}" for x in rng.integers(0, 500, 2000)])})
    return {"ints_nulls_first": (ints, True, True),
            "floats_desc_nan": (floats, False, False),
            "strings": (words, True, True)}


@pytest.mark.parametrize("case", list(_sort_tables()))
def test_distributed_sort_equals_jax(jmesh, tmesh8, case):
    from spark_rapids_tpu.columnar import dtypes as jdt
    from spark_rapids_tpu.parallel.distsort import DistributedSort as JDS
    from spark_rapids_tpu_torch.parallel.distsort import DistributedSort
    table, asc, nf = _sort_tables()[case]
    ftype = JTYPES[str(table.schema.field(0).type)]
    jb, js = _jbatch(table)
    tb, ts = _tbatch(table)
    jds = JDS([(JRef(0, getattr(jdt, ftype), True, "v"), asc, nf)], js,
              mesh=jmesh)
    tds = DistributedSort(
        [(BoundReference(0, {"INT64": INT64, "FLOAT64": FLOAT64,
                             "STRING": STRING}[ftype], True, "v"), asc, nf)],
        ts, mesh=tmesh8)
    want = _rows(jds.run(jb), True)
    got = _rows(tds.run(tb), False)
    assert len(got) == table.num_rows
    # the sort keys row for row (ties may order their other columns
    # apart), every row once
    _assert_rows([r[:1] for r in got], [r[:1] for r in want], ordered=True)
    _assert_rows(got, want, ordered=False)
    assert tds.metrics["d2hPulls"] == 1  # the bounds sample


def test_distributed_sort_passes_empty_input_through(tmesh8):
    from spark_rapids_tpu_torch.parallel.distsort import DistributedSort
    tb, ts = _tbatch(pa.table({"v": pa.array([], pa.int64())}))
    ds = DistributedSort([(BoundReference(0, INT64, True, "v"), True, True)],
                         ts, mesh=tmesh8)
    assert ds.run(tb) is tb


# -- DistributedHashJoin -------------------------------------------------------

def _join_tables():
    rng = np.random.default_rng(3)
    left = pa.table({"k": pa.array(rng.integers(0, 50, 2500), pa.int64()),
                     "v": pa.array(rng.normal(size=2500))})
    right = pa.table({"k": pa.array(rng.integers(25, 75, 1200), pa.int64()),
                      "u": pa.array(rng.integers(-100, 100, 1200),
                                    pa.int64())})
    return left, right


def _hash_join_pair(jmesh, tmesh8, left, right, how):
    from spark_rapids_tpu.columnar import dtypes as jdt
    from spark_rapids_tpu.parallel.distjoin import DistributedHashJoin as JHJ
    from spark_rapids_tpu_torch.parallel.distjoin import DistributedHashJoin
    jl, jls = _jbatch(left)
    jr, jrs = _jbatch(right)
    tl, tls = _tbatch(left)
    tr, trs = _tbatch(right)
    jd = JHJ([JRef(0, jdt.INT64, True, "k")], [JRef(0, jdt.INT64, True, "k")],
             jls, jrs, join_type=how, mesh=jmesh)
    td = DistributedHashJoin([BoundReference(0, INT64, True, "k")],
                             [BoundReference(0, INT64, True, "k")], tls, trs,
                             join_type=how, mesh=tmesh8, conf=CONF8)
    return _rows(jd.run(jl, jr), True), _rows(td.run(tl, tr), False), td


@pytest.mark.parametrize("how", ["inner", "left", "right", "full", "semi",
                                 "anti"])
def test_hash_join_every_type_equals_jax(jmesh, tmesh8, how):
    left, right = _join_tables()
    want, got, td = _hash_join_pair(jmesh, tmesh8, left, right, how)
    assert len(got) > 0
    _assert_rows(got, want, ordered=False)
    # the two exchanges' count matrices hold every row once
    lc, rc = td.last_counts
    assert lc.sum() == left.num_rows and rc.sum() == right.num_rows


def test_hash_join_skewed_keys_pair_counts_exact(tmesh8):
    from spark_rapids_tpu_torch.parallel.distjoin import DistributedHashJoin
    left = gen_skewed_table(17, 1500, n_keys=16, zipf_a=1.5)
    right = gen_skewed_table(18, 700, n_keys=16, zipf_a=1.0)
    tl, tls = _tbatch(left)
    tr, trs = _tbatch(right)
    td = DistributedHashJoin([BoundReference(0, INT64, True, "k")],
                             [BoundReference(0, INT64, True, "k")], tls, trs,
                             mesh=tmesh8, conf=CONF8)
    out = td.run(tl, tr)
    lk = np.asarray(left.column("k"))
    rk = np.asarray(right.column("k"))
    assert out.num_rows == sum(int((rk == k).sum()) for k in lk)
    got = dict(zip(*np.unique(out.columns[0].data[:out.num_rows].numpy(),
                              return_counts=True)))
    for k in np.unique(lk):
        assert got.get(k, 0) == int((lk == k).sum()) * int((rk == k).sum())


# -- the mesh's pieces ---------------------------------------------------------

@pytest.mark.parametrize("counts", [[5, 0, 3, 0, 0, 2, 0, 0],
                                    [0, 0, 0, 37, 0, 0, 0, 0], [0] * 8],
                         ids=["empty_shards", "one_shard", "no_rows"])
def test_gather_stacked_edges_equal_jax(counts):
    import jax.numpy as jnp
    from spark_rapids_tpu.columnar import dtypes as jdt
    from spark_rapids_tpu.parallel.mesh import \
        gather_stacked as jgather_stacked
    rng = np.random.default_rng(0)
    n_dev, cap = 8, 64
    data = np.zeros((n_dev, cap), np.int64)
    valid = np.zeros((n_dev, cap), bool)
    chars = np.zeros((n_dev, cap, 4), np.uint8)
    for d, m in enumerate(counts):
        data[d, :m] = rng.integers(0, 1000, m)
        valid[d, :m] = True
        chars[d, :m] = rng.integers(97, 123, (m, 4))
    want = jgather_stacked(
        [(jnp.asarray(data), jnp.asarray(valid), jnp.asarray(chars))],
        np.asarray(counts), [jdt.STRING])
    got = tmesh.gather_stacked(
        [(torch.from_numpy(data), torch.from_numpy(valid),
          torch.from_numpy(chars))], counts, [STRING])
    assert got.num_rows == want.num_rows == sum(counts)
    assert got.capacity == want.capacity
    for a, b in ((got.columns[0].data, want.columns[0].data),
                 (got.columns[0].validity, want.columns[0].validity),
                 (got.columns[0].chars, want.columns[0].chars)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_all_to_all_order_is_jax_tiled_order(tmesh8):
    """Shard d receives buckets[0][d], buckets[1][d], ... in that order
    (``jax.lax.all_to_all(..., tiled=True)``)."""
    from spark_rapids_tpu_torch.columnar.batch import host_columns_from_numpy

    def batch(vals):
        s, c = host_columns_from_numpy({"x": np.asarray(vals, np.int64)})
        return host_batch_to_device(s, c, CPU)
    buckets = [[batch([10 * s + d]) if (s + d) % 3 else None
                for d in range(8)] for s in range(8)]
    recv = tmesh.all_to_all(buckets, tmesh8)
    for d in range(8):
        want = [10 * s + d for s in range(8) if (s + d) % 3]
        got = [] if recv[d] is None else \
            recv[d].columns[0].data[:recv[d].num_rows].tolist()
        assert got == want


def test_shard_table_cuts_contiguous_shards():
    tb, _ = _tbatch(pa.table({"x": pa.array(np.arange(21), pa.int64())}))
    shards, counts, per = tmesh.shard_table(tb, 8)
    assert per == 3 and counts.tolist() == [3, 3, 3, 3, 3, 3, 3, 0]
    assert [s.columns[0].data[:s.num_rows].tolist() for s in shards][:2] \
        == [[0, 1, 2], [3, 4, 5]]


def test_a_shard_update_hands_k1_its_live_rows_only():
    """A shard holds fewer rows than its capacity.  The dense-slot update
    hands K1 its live rows only: padding rows would all land on the null
    slot, and on the card a tail of them piles that slot's atomics onto
    the kernel's last blocks."""
    from spark_rapids_tpu_torch.columnar.encoding import plane_view
    from spark_rapids_tpu_torch.exec import pallas_agg as pag
    from spark_rapids_tpu_torch.exec.aggregate import TorchHashAggregateExec
    rng = np.random.default_rng(3)
    kk = rng.integers(0, 50, 1000)
    tb, _ = _tbatch(pa.table({"k": pa.array(kk, pa.int64()),
                              "v": pa.array(rng.normal(size=1000))}))
    shard = tmesh.shard_table(tb, 8)[0][0]
    assert shard.num_rows == 125 < shard.capacity
    k = BoundReference(0, INT64, True, "k")
    v = BoundReference(1, FLOAT64, True, "v")
    spec = TorchHashAggregateExec(
        [k], [Alias(tagg.Sum(v), "s"), Alias(tagg.Max(v), "m")], None).spec
    cols = plane_view(shard.columns)
    lo, hi = pag.key_range(spec.groupings[0], cols, shard.num_rows,
                           shard.capacity)
    K = pag.slot_count(lo, hi)
    gid, planes, ops, _ = pag.update_planes(spec, cols, shard.num_rows,
                                            shard.capacity, lo, K)
    assert gid.numel() == 125 and all(p.numel() == 125 for p in planes)
    occupancy = pag.dense_slot_reduce(gid, planes, ops, K)[0]
    assert occupancy.tolist() == np.bincount(kk[:125] - lo + 1,
                                             minlength=K).tolist()


def test_data_mesh_too_wide_raises_in_both():
    with pytest.raises(ValueError):
        jdata_mesh(16)
    with pytest.raises(ValueError, match="need 16 devices, have 8"):
        data_mesh(16, conf=CONF8)
    # a session on cpu has one device, and a cuda session without a card
    # none
    with tmesh.virtual_pool(0), pytest.raises(ValueError, match="have 1"):
        data_mesh(2, conf=CONF8)
    assert data_mesh(8, conf=CONF8).devices == [CPU] * 8


def test_pool_rules():
    assert tmesh.visible_pool(CONF8) == [CPU] * 8
    with tmesh.virtual_pool(0):
        assert tmesh.visible_pool(CONF8) == [CPU]
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        assert len(tmesh.visible_pool(TorchConf())) == n
        with tmesh.virtual_pool(3):
            assert tmesh.visible_pool(CONF8) == [CPU] * 3
        assert tmesh.visible_pool(CONF8) == [CPU]
    with pytest.raises(ValueError):
        with tmesh.virtual_pool(-1):
            pass


def test_dryrun_multichip():
    from spark_rapids_tpu_torch.parallel.dryrun import dryrun_multichip
    out = dryrun_multichip(8, "cpu")
    assert out == {"groupby_groups": 23, "broadcast_join_groups": 4,
                   "sort_rows": 512, "sql_groups": 4}


def test_dryrun_runs_on_the_card_unless_asked_for_cpu(monkeypatch):
    """Like every entry point of the port, the dry run takes the conf's
    device, the card, when the caller names none; its shards are its
    own virtual pool, which it puts back."""
    from spark_rapids_tpu_torch.parallel import dryrun
    seen = []
    monkeypatch.setattr(dryrun, "_dryrun", lambda n, dev: seen.append(
        (n, dev, tmesh.visible_pool(device=dev))))
    with tmesh.virtual_pool(0):
        dryrun.dryrun_multichip(4)
        dryrun.dryrun_multichip(2, "cpu")
        assert tmesh.visible_pool(CONF8) == [CPU]
    cuda = torch.device("cuda")
    assert seen == [(4, cuda, [cuda] * 4), (2, CPU, [CPU] * 2)]


_MESH_PROBE = """
import sys
from spark_rapids_tpu_torch.parallel.dryrun import dryrun_multichip
dryrun_multichip(4, "cpu")
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "pyarrow",
                                    "spark_rapids_tpu"))
print("BAD=" + ",".join(bad))
"""


def test_mesh_queries_load_no_jax_pyarrow_or_jax_package():
    """The dry run's pipelines and its mesh and ``ici`` sessions, in a
    process of their own, load no ``jax*``, no pyarrow and no module of
    the JAX package."""
    import os
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", _MESH_PROBE], cwd=repo,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "BAD=\n" in out.stdout, out.stdout
