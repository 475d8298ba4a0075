"""Dictionary-encoded string columns in the torch port against the JAX
package, both with compressed execution on (the JAX package's default).

The contract of ``tests/test_compressed.py``, held across the packages:

* the local, parquet, ORC and CSV scans and the hash and range
  exchanges give the same bytes, in the same order, with compressed
  execution on and off, and the JAX package's rows;
* fuzzed dictionary shapes (low and high cardinality) through a filter
  and a group-by equal the JAX package's, with as many encoded columns;
* shared and disjoint dictionaries in inner and left-outer equi-joins;
* a group-by on one encoded key decodes nothing (``late_decodes`` 0)
  and takes the dense-slot kernel where the JAX package takes it for
  the same key as integer codes (the JAX package asks its kernel's
  ``supports`` before its code view, so its string keys never reach the
  kernel: ROADMAP.md C);
* an injected ``io.encode`` fault sends the column the plain way,
  counted, the result unchanged; a dictionary-heavy scan's wire bytes
  are at most half its raw bytes;
* TPC-H q1 and q3 and TPCx-BB q3 run with encoded columns and equal the
  JAX package's;
* the encoder's primitives: rank codes, unify, ``rekey_for_join``, the
  device encoder (the CSV scan's) against the host encoder, an encoded
  batch through the spill tiers and split under retry, the partition of
  every row of a hash exchange over codes.

Tolerances: integers, strings, booleans and row order exact; float sums
within ``assert_tables_equal``'s ``approx_float`` class (rel 1e-9, abs
1e-12) where the query's own test uses it (TPC-H, TPCx-BB), exact
elsewhere.  Inputs are made from seeds with numpy (``gen_dict_table``
draws from a numpy generator).
"""

import numpy as np
import pyarrow as pa
import pyarrow.csv as pacsv
import pyarrow.orc as paorc
import pyarrow.parquet as pq
import pytest
import torch

import spark_rapids_tpu_torch as st
from spark_rapids_tpu import functions as JF
from spark_rapids_tpu.columnar.dtypes import STRING as JSTRING
from spark_rapids_tpu.columnar import encoding as jenc
from spark_rapids_tpu_torch import functions as TF
from spark_rapids_tpu_torch.columnar import encoding as tenc
from spark_rapids_tpu_torch.columnar.batch import device_batch_to_host, \
    host_columns_from_arrow, strings_from_numpy
from spark_rapids_tpu_torch.columnar.dtypes import STRING
from tests.compare import assert_tables_equal, tpu_session
from tests.fuzzer import gen_dict_table
from tests.torch_threads import _one_torch_thread  # noqa: F401

CPU = {"spark.rapids.torch.device": "cpu"}
ON = {"spark.rapids.sql.compressed.enabled": "true",
      # the JAX package's plane encodings (not in this slice) off, so its
      # encodedColumns count strings alone; its scan cache off, so every
      # scan ingests afresh
      "spark.rapids.sql.compressed.rle.enabled": "false",
      "spark.rapids.sql.compressed.delta.enabled": "false",
      "spark.rapids.sql.compressed.packedBool.enabled": "false",
      "spark.rapids.sql.scan.deviceCacheEnabled": "false"}
OFF = {**ON, "spark.rapids.sql.compressed.enabled": "false"}


def _ts(conf=None):
    return st.TorchSession({**CPU, **(conf or ON)})


def _js(conf=None):
    return tpu_session(dict(conf or ON))


def _nodes(plan):
    yield plan
    for c in plan.children:
        yield from _nodes(c)


def _port_metric(session, name: str) -> int:
    return sum(int(n.metrics.get(name, 0))
               for n in _nodes(session._last_plan))


def _jax_metric(session, name: str) -> int:
    from tests.compare import sum_plan_metric
    return sum_plan_metric(session, name)


@pytest.fixture(scope="module")
def dict_paths(tmp_path_factory):
    """The dictionary-heavy table of tests/test_compressed.py in every
    scan format (the CSV one without nulls)."""
    d = tmp_path_factory.mktemp("tcompressed")
    tbl = gen_dict_table(11, 4000, cardinality=12, null_prob=0.08)
    paths = {"table": tbl}
    paths["parquet"] = str(d / "t.parquet")
    pq.write_table(tbl, paths["parquet"], row_group_size=1024)
    paths["orc"] = str(d / "t.orc")
    paorc.write_table(tbl, paths["orc"])
    paths["csv"] = str(d / "t.csv")
    pacsv.write_csv(gen_dict_table(12, 4000, cardinality=12,
                                   null_prob=0.0), paths["csv"])
    return paths


def _read(s, fmt, paths):
    if fmt == "local":
        return s.create_dataframe(paths["table"])
    return getattr(s.read, fmt)(paths[fmt])


# ---------------------------------------------------------------------------
# on == off, and the JAX package's bytes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", ["local", "parquet", "orc", "csv"])
def test_scan_on_off_byte_identical(dict_paths, fmt):
    before = tenc.compressed_stats()
    on = _read(_ts(ON), fmt, dict_paths).to_arrow()
    after = tenc.compressed_stats()
    off = _read(_ts(OFF), fmt, dict_paths).to_arrow()
    assert on.equals(off), f"{fmt} scan differs between compressed on/off"
    assert after["encoded_columns"] > before["encoded_columns"], fmt
    assert after["late_decodes"] == before["late_decodes"], fmt
    want = _read(_js(ON), fmt, dict_paths).to_arrow()
    assert_tables_equal(on, want, ignore_order=False)


@pytest.mark.parametrize("mode", ["hash", "range"])
def test_exchange_on_off_byte_identical(dict_paths, mode):
    def q(s):
        df = _read(s, "parquet", dict_paths)
        if mode == "hash":
            return df.repartition(4, "k")
        return df.order_by("k", "v")

    on = q(_ts(ON)).to_arrow()
    off = q(_ts(OFF)).to_arrow()
    assert on.equals(off), f"{mode} exchange differs between on and off"
    assert_tables_equal(on, q(_js(ON)).to_arrow(), ignore_order=False)


def test_hash_partitions_over_codes_are_the_dense_ones(dict_paths):
    """Every row of an encoded batch goes to the partition the dense
    path sends it to, through the per-code hash tables."""
    from spark_rapids_tpu_torch.exec.exchange import partition_batch
    from spark_rapids_tpu_torch.exprs.base import BoundReference
    schema, cols = host_columns_from_arrow(dict_paths["table"])
    from spark_rapids_tpu_torch.columnar.batch import host_batch_to_device
    enc = tenc.IngestEncoder("cpu", max_dict_fraction=0.5)
    b_enc = host_batch_to_device(schema, cols, "cpu", None, enc)
    b_dense = host_batch_to_device(schema, cols, "cpu")
    assert tenc.is_encoded(b_enc.columns[0])
    assert tenc.is_encoded(b_enc.columns[1])
    keys = [BoundReference(0, STRING, True, "k"),
            BoundReference(2, schema[2].dtype, True, "v"),
            BoundReference(1, STRING, True, "g")]
    before = tenc.compressed_stats()["late_decodes"]
    p_enc = partition_batch(b_enc, 7, keys, "hash")
    assert tenc.compressed_stats()["late_decodes"] == before
    p_dense = partition_batch(b_dense, 7, keys, "hash")
    for a, b in zip(p_enc, p_dense):
        assert (a is None) == (b is None)
        if a is None:
            continue
        assert tenc.is_encoded(a.columns[0])
        ha, hb = device_batch_to_host(a, schema), device_batch_to_host(
            b, schema)
        for name in schema.names:
            va, vb = ha[name], hb[name]
            assert np.array_equal(va[1], vb[1]), name
            if hasattr(va[0], "to_pylist"):
                assert va[0].to_pylist() == vb[0].to_pylist(), name
            else:
                assert np.array_equal(va[0], vb[0]), name


# ---------------------------------------------------------------------------
# fuzzed dictionary shapes against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("card", [4, 400, 1800])
def test_fuzz_dict_shapes_vs_jax(tmp_path, card):
    """Low cardinality (dictionary-heavy), near maxDictFraction's edge,
    and past it (the column rides plain): the same rows and as many
    encoded columns as the JAX package."""
    tbl = gen_dict_table(card * 7 + 1, 3000, cardinality=card)
    p = str(tmp_path / "fz.parquet")
    pq.write_table(tbl, p, row_group_size=777)
    sql = ("SELECT k, COUNT(*) AS c, SUM(v) AS sv, MIN(g) AS mg "
           "FROM fz WHERE k <> 'val_0001_' AND v > -500 GROUP BY k")
    js = _js()
    js.register_view("fz", js.read.parquet(p))
    want = js.sql(sql).to_arrow()
    ts = _ts()
    ts.register_view("fz", ts.read.parquet(p))
    got = ts.sql(sql).to_arrow()
    assert_tables_equal(got, want, ignore_order=False)
    assert _port_metric(ts, "encodedColumns") == \
        _jax_metric(js, "encodedColumns")
    off = _ts(OFF)
    off.register_view("fz", off.read.parquet(p))
    assert got.equals(off.sql(sql).to_arrow())


@pytest.mark.parametrize("name,build", [
    ("eq", lambda F, df: df.filter(F.col("k") == "val_0003_xxxxx")),
    ("isin", lambda F, df: df.filter(F.col("k").isin(
        "val_0002_xxxxxxxxx", "val_0007_"))),
    ("startswith", lambda F, df: df.filter(F.col("g").startswith("val_000"))),
    ("contains16", lambda F, df: df.filter(
        F.contains(F.col("k"), "val_0005_xxxxxxx"))),
    ("like", lambda F, df: df.filter(F.col("k").like("%_0004_%"))),
    ("project", lambda F, df: df.select(
        F.concat(F.col("k"), F.col("k")).alias("u"), F.length(F.col("g")).alias("n"),
        F.substring(F.col("k"), 2, 5).alias("s"), F.col("k"), F.col("v"))),
    ("two_columns", lambda F, df: df.filter(
        F.concat(F.col("k"), F.col("g")) != "val_0001_val_0001_")
        .select(F.col("k"), F.col("g"))),
    ("value_domain", lambda F, df: df.select(
        (F.length(F.col("k")) + F.col("v")).alias("x"), F.col("g"))),
])
def test_stage_over_dictionary_vs_jax(dict_paths, name, build):
    """Predicates become code-set membership, projections per-code
    tables, two-column subtrees one composed table; the rows are the
    JAX package's and the dense path's."""
    before = tenc.compressed_stats()
    got = build(TF, _read(_ts(), "parquet", dict_paths)).to_arrow()
    after = tenc.compressed_stats()
    assert after["code_stages"] > before["code_stages"]
    want = build(JF, _read(_js(), "parquet", dict_paths)).to_arrow()
    assert_tables_equal(got, want, ignore_order=False)
    off = build(TF, _read(_ts(OFF), "parquet", dict_paths)).to_arrow()
    assert got.equals(off)
    if name == "two_columns":
        assert after["composed_gathers"] > before["composed_gathers"]
        # with the composed table off, each column gathers alone
        capped = build(TF, _read(_ts({**ON, "spark.rapids.sql.compressed."
                                      "maxComposedCells": 0}),
                                 "parquet", dict_paths)).to_arrow()
        assert capped.equals(got)


# ---------------------------------------------------------------------------
# joins over codes
# ---------------------------------------------------------------------------

def _join_files(tmp_path, shared: bool):
    rng = np.random.default_rng(7)
    n = 2500
    left_vals = [f"key{i}" for i in range(12)]
    right_vals = left_vals if shared else [f"key{i}" for i in range(6, 24)]
    lt = pa.table({
        "k": pa.array([left_vals[i] for i in
                       rng.integers(0, len(left_vals), n)]),
        "v": pa.array(rng.integers(0, 1000, n), pa.int64()),
        "s": pa.array([["a", "bb", "ccc"][i] for i in
                       rng.integers(0, 3, n)]),
    })
    rt = pa.table({
        "k2": pa.array(right_vals),
        "w": pa.array(np.arange(len(right_vals)), pa.int64()),
        "t": pa.array(["x", "y"] * (len(right_vals) // 2)),
    })
    # each build key three times: a dictionary-shaped build column (a
    # unique one has as many values as rows and rides plain)
    rt = pa.concat_tables([rt] * 3)
    lp, rp = str(tmp_path / "l.parquet"), str(tmp_path / "r.parquet")
    pq.write_table(lt, lp)
    pq.write_table(rt, rp)
    return lp, rp


@pytest.mark.parametrize("how", ["inner", "left"])
@pytest.mark.parametrize("shared", [True, False])
def test_join_shared_vs_disjoint_dictionary(tmp_path, shared, how):
    lp, rp = _join_files(tmp_path, shared)
    sql = ("SELECT l.k, l.v, l.s, r.w, r.t FROM l "
           + ("JOIN" if how == "inner" else "LEFT JOIN")
           + " r ON l.k = r.k2")

    def run(s):
        s.register_view("l", s.read.parquet(lp))
        s.register_view("r", s.read.parquet(rp))
        return s.sql(sql).to_arrow()

    before = tenc.compressed_stats()["late_decodes"]
    got = run(_ts())
    assert tenc.compressed_stats()["late_decodes"] == before
    assert_tables_equal(got, run(_js()))
    assert got.equals(run(_ts(OFF)))


def test_join_key_pair_sharing_an_ordinal_goes_dense(tmp_path):
    """Two key pairs over one stream column (l.k = r.a AND l.k = r.b)
    drop to the dense keys instead of re-keying the column twice."""
    rng = np.random.default_rng(9)
    lt = pa.table({"k": pa.array([f"key{i}" for i in
                                  rng.integers(0, 6, 400)]),
                   "v": pa.array(rng.integers(0, 50, 400), pa.int64())})
    rt = pa.table({"a": pa.array([f"key{i}" for i in range(6)]),
                   "b": pa.array([f"key{i}" for i in range(6)]),
                   "w": pa.array(np.arange(6), pa.int64())})
    lp, rp = str(tmp_path / "l.parquet"), str(tmp_path / "r.parquet")
    pq.write_table(lt, lp)
    pq.write_table(rt, rp)

    def run(s):
        s.register_view("l", s.read.parquet(lp))
        s.register_view("r", s.read.parquet(rp))
        return s.sql("SELECT l.k, l.v, r.w FROM l JOIN r "
                     "ON l.k = r.a AND l.k = r.b").to_arrow()

    assert_tables_equal(run(_ts()), run(_js()))


def test_join_stream_batch_arriving_dense(tmp_path):
    """A stream batch whose key column the encoder declined (too many
    distinct values for its rows) joins through the dense keys against
    an encoded build."""
    n = 1 << 10
    rng = np.random.default_rng(4)
    keys = np.array([f"k{i:04d}" for i in range(n)])
    left = {"k": np.concatenate([keys[rng.integers(0, 8, 3 * n)], keys]),
            "v": np.arange(4 * n)}
    right = {"k": np.tile(keys[:8], 3), "w": np.arange(24)}
    from spark_rapids_tpu_torch.exec import basic
    saved = basic.BATCH_ROWS
    basic.BATCH_ROWS = n
    try:
        ts = _ts()
        got = ts.create_dataframe(left).join(
            ts.create_dataframe(right), "k").to_arrow()
    finally:
        basic.BATCH_ROWS = saved
    js = _js()
    want = js.create_dataframe(pa.table(left)).join(
        js.create_dataframe(pa.table(right)), "k").to_arrow()
    assert_tables_equal(got, want)


# ---------------------------------------------------------------------------
# the aggregate over codes, and K1's route
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", ["local", "parquet"])
def test_dict_key_group_by_zero_late_decodes(dict_paths, fmt):
    ts = _ts()
    before = tenc.compressed_stats()
    df = _read(ts, fmt, dict_paths).group_by("k").agg(
        TF.count(TF.col("v")).alias("c"), TF.sum(TF.col("v")).alias("sv"),
        TF.max(TF.col("f")).alias("mf"))
    got = df.to_arrow()
    after = tenc.compressed_stats()
    assert got.num_rows > 0
    assert after["encoded_columns"] > before["encoded_columns"]
    assert after["late_decodes"] == before["late_decodes"], \
        "a dict-key group-by stays in the code domain end to end"
    assert after["d2h_wire_bytes"] > before["d2h_wire_bytes"]
    assert _port_metric(ts, "encodedColumns") > 0
    assert _port_metric(ts, "pallasAggBatches") == 1
    js = _js()
    want = _read(js, fmt, dict_paths).group_by("k").agg(
        JF.count(JF.col("v")).alias("c"), JF.sum(JF.col("v")).alias("sv"),
        JF.max(JF.col("f")).alias("mf")).to_arrow()
    assert_tables_equal(got, want, ignore_order=False)


def _codes_of(values: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """Each value's rank among the distinct valid values (a null's 0)."""
    uniq = np.unique(values[valid])
    return np.where(valid, np.searchsorted(uniq, values), 0)


@pytest.mark.parametrize("card,rows", [(7, 5000), (300, 5000),
                                       (3000, 5000), (7, 5)])
def test_k1_route_matches_jax_over_codes(card, rows):
    """The port's route for a group-by on one encoded key is the JAX
    package's for the same key given as its integer codes: the dense-slot
    kernel when the codes fit 1024 slots, else the sorted path; a
    declined column (too many values) goes the sorted way in both.
    With compressed execution off, the string key takes the sorted path
    in both packages."""
    rng = np.random.default_rng(card)
    vocab = np.array([f"mode {i:05d}" for i in range(card)])
    k = vocab[rng.integers(0, card, rows)]
    valid = rng.random(rows) > 0.05
    v = rng.integers(-100, 100, rows)
    f = rng.normal(size=rows)
    ts = _ts()
    got = ts.create_dataframe({"k": k, "v": v, "f": f},
                              masks={"k": valid}).group_by("k").agg(
        TF.count(TF.col("v")).alias("c"), TF.sum(TF.col("f")).alias("sf"),
        TF.min(TF.col("v")).alias("mn")).to_arrow()
    encoded = _port_metric(ts, "encodedColumns") > 0
    kcodes = _codes_of(k, valid) if encoded else None
    js = _js()
    jt = pa.table({"k": pa.array(kcodes.astype(np.int32), mask=~valid)
                   if encoded else pa.array(k, mask=~valid),
                   "v": v, "f": f})
    jres = js.create_dataframe(jt).group_by("k").agg(
        JF.count(JF.col("v")).alias("c"), JF.sum(JF.col("f")).alias("sf"),
        JF.min(JF.col("v")).alias("mn")).to_arrow()
    assert _port_metric(ts, "pallasAggBatches") == \
        _jax_metric(js, "pallasAggBatches")
    if encoded:
        assert got.column("k").to_pylist() == [
            None if c is None else np.unique(k[valid])[c]
            for c in jres.column("k").to_pylist()]
        got = got.drop_columns(["k"])
        jres = jres.drop_columns(["k"])
    assert_tables_equal(got, jres, ignore_order=False)
    off = _ts(OFF)
    off.create_dataframe({"k": k, "v": v, "f": f},
                         masks={"k": valid}).group_by("k").agg(
        TF.count(TF.col("v")).alias("c")).to_arrow()
    js2 = _js(OFF)
    js2.create_dataframe(pa.table({"k": pa.array(k, mask=~valid)})) \
        .group_by("k").agg(JF.count(JF.col("k")).alias("c")).to_arrow()
    assert _port_metric(off, "pallasAggBatches") == \
        _jax_metric(js2, "pallasAggBatches") == 0


def test_group_by_key_read_by_an_aggregate_stays_dense(dict_paths):
    """A key column an aggregate also reads (min(k)) keeps its dense
    planes (counted late decodes), with the JAX package's result."""
    got = _read(_ts(), "parquet", dict_paths).group_by("k").agg(
        TF.min(TF.col("k")).alias("mk"), TF.count(TF.col("g")).alias("c")) \
        .to_arrow()
    want = _read(_js(), "parquet", dict_paths).group_by("k").agg(
        JF.min(JF.col("k")).alias("mk"), JF.count(JF.col("g")).alias("c")) \
        .to_arrow()
    assert_tables_equal(got, want, ignore_order=False)


# ---------------------------------------------------------------------------
# faults, wire bytes, switches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", ["local", "parquet"])
def test_io_encode_fault_degrades_to_plain(dict_paths, fmt):
    conf = {**ON, "spark.rapids.faults.io.encode": "count:1"}
    before = tenc.compressed_stats()
    faulted = _read(_ts(conf), fmt, dict_paths).to_arrow()
    after = tenc.compressed_stats()
    assert after["encode_faults"] == before["encode_faults"] + 1
    assert after["plain_columns"] > before["plain_columns"]
    from spark_rapids_tpu_torch import faults
    faults.configure({})
    clean = _read(_ts(), fmt, dict_paths).to_arrow()
    assert faulted.equals(clean)
    if fmt == "parquet":
        jb = jenc.compressed_stats()["encode_faults"]
        _read(_js(conf), fmt, dict_paths).to_arrow()
        assert jenc.compressed_stats()["encode_faults"] == jb + 1


@pytest.mark.parametrize("fmt", ["local", "parquet"])
def test_dict_heavy_scan_wire_ratio(dict_paths, fmt):
    before = tenc.compressed_stats()
    _read(_ts(), fmt, dict_paths).to_arrow()
    after = tenc.compressed_stats()
    raw = after["h2d_raw_bytes"] - before["h2d_raw_bytes"]
    wire = after["h2d_wire_bytes"] - before["h2d_wire_bytes"]
    assert raw > 0
    assert wire / raw <= 0.5, f"wire {wire} / raw {raw}"


def test_compressed_off_builds_no_encoded_column(dict_paths):
    before = tenc.compressed_stats()
    ts = _ts(OFF)
    batches = _read(ts, "parquet", dict_paths).to_device_batches()
    assert not any(tenc.has_encoded(b) for b in batches)
    assert tenc.compressed_stats()["encoded_columns"] == \
        before["encoded_columns"]
    assert _port_metric(ts, "encodedColumns") == 0


def test_egress_off_decodes_on_device(dict_paths):
    conf = {**ON, "spark.rapids.sql.compressed.egress": "false"}
    before = tenc.compressed_stats()
    got = _read(_ts(conf), "parquet", dict_paths).to_arrow()
    after = tenc.compressed_stats()
    assert after["d2h_wire_bytes"] == before["d2h_wire_bytes"]
    assert after["late_decodes"] > before["late_decodes"]
    assert got.equals(_read(_ts(), "parquet", dict_paths).to_arrow())


def test_engine_stats_carries_compressed_counters():
    snap = _ts().engine_stats()
    assert "compressed" in snap
    for key in ("encodedColumns", "lateDecodes", "fusedDecodes",
                "compressedBytesSaved", "h2d_raw_bytes", "h2d_wire_bytes"):
        assert key in snap["compressed"], key
    jsnap = _js().engine_stats()["compressed"]
    assert {"encodedColumns", "lateDecodes", "compressedBytesSaved"} \
        <= set(jsnap)


# ---------------------------------------------------------------------------
# TPC-H and TPCx-BB with encoded columns
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tpch(tmp_path_factory):
    from spark_rapids_tpu.bench.tpch import gen_tpch
    from spark_rapids_tpu_torch.bench.tpch import gen_tpch_numpy
    d = tmp_path_factory.mktemp("tpch_comp")
    return gen_tpch(str(d), lineitem_rows=4000), gen_tpch_numpy(4000)


@pytest.mark.parametrize("qname", ["q1", "q3", "q12", "q16"])
def test_tpch_encoded_matches_jax(tpch, qname):
    from spark_rapids_tpu.bench.tpch import TPCH_QUERIES as JQ
    from spark_rapids_tpu.bench.tpch import load_tables as jload
    from spark_rapids_tpu_torch.bench.tpch import TPCH_QUERIES as TQ
    from spark_rapids_tpu_torch.bench.tpch import load_tables as tload
    paths, tables = tpch
    want = JQ[qname](jload(_js(), paths)).to_arrow()
    for source in (paths, tables):
        before = tenc.compressed_stats()["encoded_columns"]
        got = TQ[qname](tload(_ts(), source)).to_arrow()
        assert tenc.compressed_stats()["encoded_columns"] > before, qname
        assert_tables_equal(got, want, ignore_order=False,
                            approx_float=True)
        off = TQ[qname](tload(_ts(OFF), source)).to_arrow()
        assert_tables_equal(got, off, ignore_order=False,
                            approx_float=True)


def test_tpcxbb_q3_encoded_matches_jax(tmp_path_factory):
    from spark_rapids_tpu.bench.tpcxbb import TPCXBB_QUERIES as JQ
    from spark_rapids_tpu.bench.tpcxbb import gen_tpcxbb
    from spark_rapids_tpu.bench.tpcxbb import register_views as jreg
    from spark_rapids_tpu_torch.bench.tpcxbb import TPCXBB_QUERIES as TQ
    from spark_rapids_tpu_torch.bench.tpcxbb import register_views as treg
    paths = gen_tpcxbb(str(tmp_path_factory.mktemp("xbb_comp")),
                       sales_rows=6_000)
    js = _js()
    jreg(js, paths)
    want = js.sql(JQ["q3"]).to_arrow()
    ts = _ts()
    treg(ts, paths)
    before = tenc.compressed_stats()["encoded_columns"]
    got = ts.sql(TQ["q3"]).to_arrow()
    assert tenc.compressed_stats()["encoded_columns"] > before
    assert_tables_equal(got, want, ignore_order=False, approx_float=True)


# ---------------------------------------------------------------------------
# the primitives
# ---------------------------------------------------------------------------

def _host(values):
    """numpy object values (None = null) -> (HostStrings, validity)."""
    return strings_from_numpy(np.asarray(values, dtype=object))


def test_rank_code_invariant():
    """Codes are ranks over the sorted dictionary, as the JAX encoder
    makes them for the same values."""
    vals = ["pear", "apple", "pear", None, "fig", "apple"]
    hs, valid = _host(vals)
    col = tenc.IngestEncoder("cpu", max_dict_fraction=1.0).upload_column(
        hs, valid, STRING, 8)
    assert list(col.dict.values) == ["apple", "fig", "pear"]
    jcol = jenc.IngestEncoder(max_dict_fraction=1.0).upload_column(
        pa.array(vals), JSTRING, 8)
    assert list(jcol.dict.values) == list(col.dict.values)
    jcodes = np.asarray(jcol.codes)[:6]
    assert col.codes[:6].tolist() == jcodes.tolist() == [2, 0, 2, 0, 1, 0]
    assert col.validity[:6].tolist() == [True, True, True, False, True,
                                         True]
    dense = col.decoded()
    assert dense.data[:6].tolist() == [4, 5, 4, 0, 3, 5]
    assert bytes(dense.chars[1, :5].tolist()) == b"apple"


@pytest.mark.parametrize("frac,n_distinct,rows", [
    (0.5, 4, 8), (0.5, 5, 8), (0.25, 2, 9), (1.0, 9, 9), (0.5, 1, 2)])
def test_encoder_decisions_match_jax(frac, n_distinct, rows):
    """The distinct-count limit max(1, int(n * maxDictFraction)) and the
    null handling decide as the JAX encoder does."""
    vals = [f"v{i % n_distinct}" for i in range(rows)]
    vals[0] = None
    hs, valid = _host(vals)
    got = tenc.IngestEncoder("cpu", max_dict_fraction=frac).upload_column(
        hs, valid, STRING, 16)
    want = jenc.IngestEncoder(max_dict_fraction=frac).upload_column(
        pa.array(vals, pa.string()), JSTRING, 16)
    assert (got is None) == (want is None)
    if got is not None:
        assert list(got.dict.values) == list(want.dict.values)
        assert got.codes[:rows].tolist() == \
            np.asarray(want.codes)[:rows].tolist()


def test_all_null_column_encodes_with_an_empty_dictionary():
    """A batch whose string column is all null encodes with an empty
    dictionary (the JAX encoder raises IndexError there, ROADMAP.md C);
    the rows are the dense path's."""
    hs, valid = _host([None, None, None])
    col = tenc.IngestEncoder("cpu").upload_column(hs, valid, STRING, 8)
    assert col is not None and col.dict.size == 0
    assert not col.validity.any()
    t = pa.table({"s": pa.array([None] * 5, pa.string()),
                  "v": pa.array(np.arange(5))})
    on = _ts().create_dataframe(t).to_arrow()
    assert on.equals(_ts(OFF).create_dataframe(t).to_arrow())
    assert on.column("s").null_count == 5


def test_dictionary_wider_than_the_device_limit_goes_plain():
    hs, valid = _host(["x" * 40, "y", "x" * 40, "y"])
    enc = tenc.IngestEncoder("cpu", max_dict_fraction=1.0,
                             max_string_width=32)
    before = tenc.compressed_stats()["plain_columns"]
    assert enc.upload_column(hs, valid, STRING, 8) is None
    assert tenc.compressed_stats()["plain_columns"] == before + 1


def test_local_scan_memo_holds_no_host_array():
    """The local scan's encodings outlive a query but not the table: they
    hold none of its host arrays, so once the DataFrame and its session
    are gone the chars are freed and the entry goes with them."""
    import gc
    import weakref
    gc.collect()
    vals = np.asarray([f"v{i % 3}" for i in range(64)], dtype=object)
    s = _ts()
    df = s.create_dataframe({"s": vals, "v": np.arange(64)})
    chars = df.plan.cols["s"][0].chars
    addr = chars.__array_interface__["data"][0]
    owner = weakref.ref(tenc._owner(chars))

    def held():
        return [k for k in tenc._MEMO if k[0][0] == addr]

    first = df.to_arrow()
    assert len(held()) == 1
    hits = tenc.compressed_stats()["host_encode_ns"]
    assert df.to_arrow().equals(first)          # served by the memo
    assert tenc.compressed_stats()["host_encode_ns"] == hits
    s.stop()
    del df, s, chars
    gc.collect()
    assert owner() is None
    assert held() == []


def test_unify_and_rekey_for_join():
    enc = tenc.IngestEncoder("cpu", max_dict_fraction=1.0)
    a = enc.upload_column(*_host(["a", "b", "a", "c"]), STRING, 4)
    b = enc.upload_column(*_host(["b", "d", "d", "b"]), STRING, 4)
    unified, union = tenc.unify_columns([a, b])
    assert list(union.values) == ["a", "b", "c", "d"]
    assert unified[0].codes[:4].tolist() == [0, 1, 0, 2]
    assert unified[1].codes[:4].tolist() == [1, 3, 3, 1]
    rk = tenc.rekey_for_join(b, a.dict)
    rb = rk.data[:4].tolist()
    assert rb[0] == 1 and rb[3] == 1            # 'b' -> a's code 1
    assert rb[1] >= a.dict.size and rb[2] >= a.dict.size
    # the JAX package's primitives on the same values
    je = jenc.IngestEncoder(max_dict_fraction=1.0)
    ja = je.upload_column(pa.array(["a", "b", "a", "c"]), JSTRING, 4)
    jb = je.upload_column(pa.array(["b", "d", "d", "b"]), JSTRING, 4)
    junified, junion = jenc.unify_columns([ja, jb])
    assert list(junion.values) == list(union.values)
    for t, j in zip(unified, junified):
        assert t.codes[:4].tolist() == np.asarray(j.codes)[:4].tolist()
    jr = np.asarray(jenc.rekey_for_join(jb, ja.dict).data)[:4]
    assert rb == jr.tolist()


def test_rekey_translation_built_once_a_dictionary_pair(monkeypatch):
    """A join re-keys every stream batch over one dictionary with one
    translation: the union of the two dictionaries is sorted once."""
    enc = tenc.IngestEncoder("cpu", max_dict_fraction=1.0)
    a = enc.upload_column(*_host(["a", "b", "a", "c"]), STRING, 4)
    b = enc.upload_column(*_host(["b", "d", "d", "b"]), STRING, 4)
    real, calls = tenc._union_rows, []

    def counted(dicts):
        calls.append(len(dicts))
        return real(dicts)

    monkeypatch.setattr(tenc, "_union_rows", counted)
    first = tenc.rekey_for_join(b, a.dict).data
    again = tenc.rekey_for_join(b, a.dict).data
    assert calls == [2]
    assert torch.equal(first, again)


def _strings(rng, n: int) -> list:
    """Values that order by bytes in every way that matters: prefixes,
    embedded NULs ('a' before 'a\\0'), bytes >= 0x80 (non-ASCII), lengths
    across 8-byte words, and a null now and then."""
    pool = ["", "a", "a\x00", "a\x00\x00", "ab", "b", "zz", "é", "ü",
            "ÿ", "abcdefgh", "abcdefghi", "abcdefgh\x00", "日本",
            "longer value past sixteen bytes", "longer value past sixteen",
            "x" * 8, "x" * 9, "\x7f", "\x80"]
    pool += [f"w{i:03d}" for i in range(30)]
    idx = rng.integers(0, len(pool), n)
    return [None if rng.random() < 0.05 else pool[i] for i in idx]


@pytest.mark.parametrize("seed,rows,pool", [
    (0, 3000, None), (1, 3000, None), (2, 20000, None),
    # narrow values (one 8-byte word a row), few of them, and one
    # value seen once near the end
    (3, 20000, ["A", "N", "R", "A\x00"]), (4, 20000, ["A", "N", "R"])])
def test_device_encoder_matches_host_encoder(seed, rows, pool):
    """The CSV scan's encoder (torch ops over the char matrix on the
    device) makes the dictionary and codes the host encoder makes for the
    same strings."""
    from spark_rapids_tpu_torch.columnar.batch import upload_column
    rng = np.random.default_rng(seed)
    if pool is None:
        vals = _strings(rng, rows)
    else:
        vals = [pool[i] for i in rng.integers(0, len(pool), rows)]
        if seed == 4:
            vals[rows - 7] = "Q"
    cap = 1 << (rows - 1).bit_length()
    hs, valid = _host(vals)
    host = tenc.IngestEncoder("cpu", max_dict_fraction=0.5).upload_column(
        hs, valid, STRING, cap)
    dense = upload_column(STRING, hs, valid, cap, "cpu")
    dev = tenc.encode_on_device(dense, 0.5)
    assert tenc.is_encoded(dev) and host is not None
    assert dev.dict.size == host.dict.size
    assert np.array_equal(dev.dict.host_lengths, host.dict.host_lengths)
    assert np.array_equal(dev.dict.host_chars, host.dict.host_chars)
    assert torch.equal(dev.codes, host.codes)
    assert torch.equal(dev.validity, host.validity)
    # and the values are the sorted distinct strings
    want = sorted({v.encode() for v in vals if v is not None})
    assert [v.encode("utf-8", "surrogateescape")
            for v in dev.dict.values] == want
    # past the fraction both go plain
    frac = 0.5 * len(want) / rows
    assert tenc.encode_on_device(dense, frac) is dense
    assert tenc.IngestEncoder("cpu", max_dict_fraction=frac) \
        .upload_column(hs, valid, STRING, cap) is None


def test_device_encoder_exact_path_on_hash_collision(monkeypatch):
    """A hash collision between two values falls back to the exact sort
    of the rows, on the host and on the device."""
    rng = np.random.default_rng(5)
    vals = _strings(rng, 500)
    hs, valid = _host(vals)
    from spark_rapids_tpu_torch.columnar.batch import upload_column
    dense = upload_column(STRING, hs, valid, 512, "cpu")
    want = tenc.encode_on_device(dense, 0.5)
    real = torch.unique

    def colliding(t, *a, **kw):
        if t.dim() == 1 and t.dtype == torch.int64 and "dim" not in kw:
            t = t & 0xF     # force collisions among the hashes
        return real(t, *a, **kw)

    monkeypatch.setattr(torch, "unique", colliding)
    got = tenc.encode_on_device(dense, 0.5)
    assert torch.equal(got.codes, want.codes)
    assert np.array_equal(got.dict.host_chars, want.dict.host_chars)


def _encoded_batch(seed=3, n=3000):
    from spark_rapids_tpu_torch.columnar.batch import host_batch_to_device
    schema, cols = host_columns_from_arrow(gen_dict_table(seed, n))
    enc = tenc.IngestEncoder("cpu", max_dict_fraction=0.5)
    return schema, host_batch_to_device(schema, cols, "cpu", None, enc)


def test_encoded_batch_through_spill_tiers():
    """An encoded batch's codes and validity go to the host and to disk
    and come back encoded on the same dictionary, bit for bit."""
    from spark_rapids_tpu_torch.memory.spill import BufferCatalog, \
        SpillableBatch
    schema, batch = _encoded_batch()
    want = device_batch_to_host(batch, schema)
    cat = BufferCatalog(1 << 30, 1 << 30)
    sb = SpillableBatch(batch, cat)
    try:
        with cat._lock:
            sb._to_host()
            sb._to_disk()
        late = tenc.compressed_stats()["late_decodes"]
        back = sb.get()
        assert tenc.compressed_stats()["late_decodes"] == late
        assert tenc.is_encoded(back.columns[0])
        assert back.columns[0].dict is batch.columns[0].dict
        got = device_batch_to_host(back, schema)
        for name in schema.names:
            assert np.array_equal(got[name][1], want[name][1])
            if hasattr(want[name][0], "to_pylist"):
                assert got[name][0].to_pylist() == want[name][0].to_pylist()
    finally:
        sb.close()
        cat.close()


def test_encoded_batch_split_under_retry():
    """An out-of-memory split halves an encoded batch into encoded
    halves whose rows are the batch's."""
    from spark_rapids_tpu_torch.utils.retry import split_batch_half
    schema, batch = _encoded_batch(n=4096)
    halves = split_batch_half(batch)
    assert all(tenc.is_encoded(h.columns[0]) for h in halves)
    want = device_batch_to_host(batch, schema)["k"][0].to_pylist()
    got = sum((device_batch_to_host(h, schema)["k"][0].to_pylist()
               for h in halves), [])
    assert got == want


def test_concat_unifies_dictionaries():
    """Batches of one column on different dictionaries concatenate as
    codes on their union; a batch holding the column dense decodes the
    encoded ones (counted)."""
    from spark_rapids_tpu_torch.exec.coalesce import concat_batches
    from spark_rapids_tpu_torch.columnar.batch import host_batch_to_device
    from spark_rapids_tpu_torch.columnar.dtypes import Field, Schema
    schema = Schema([Field("s", STRING, True)])
    enc = tenc.IngestEncoder("cpu", max_dict_fraction=1.0)
    parts = [["b", "a", "b"], ["c", None, "a", "d"]]
    batches = [host_batch_to_device(schema, {"s": _host(p)}, "cpu", None,
                                    enc) for p in parts]
    out = concat_batches(batches)
    assert tenc.is_encoded(out.columns[0])
    assert list(out.columns[0].dict.values) == ["a", "b", "c", "d"]
    hs, valid = device_batch_to_host(out, schema)["s"]
    assert [v if ok else None for v, ok in zip(hs.to_pylist(), valid)] \
        == ["b", "a", "b", "c", None, "a", "d"]
    dense = host_batch_to_device(schema, {"s": _host(["e"])}, "cpu")
    late = tenc.compressed_stats()["late_decodes"]
    mixed = concat_batches(batches + [dense])
    assert not tenc.is_encoded(mixed.columns[0])
    assert tenc.compressed_stats()["late_decodes"] == late + 2
    hs, valid = device_batch_to_host(mixed, schema)["s"]
    assert [v if ok else None for v, ok in zip(hs.to_pylist(), valid)] \
        == ["b", "a", "b", "c", None, "a", "d", "e"]
