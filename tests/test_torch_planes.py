"""The plane encodings (RLE, delta-narrowed and bit-packed columns) in
the torch port against the JAX package, both with their keys on (the
default) and the JAX package's scan cache off, so that every scan
ingests afresh.

The contract of ``tests/test_compressed.py``'s plane tests, held across
the packages:

* ``_plane_table``'s four columns (``r`` runs, ``q`` a small-step
  cumsum, ``b`` booleans with nulls, ``v`` floats) through parquet, ORC
  and the local scan take the encodings the JAX scan of the same file
  takes, with the same counters and raw/wire bytes (the JAX package's
  local scan uploads plain planes, so its parquet scan is the local
  scan's reference);
  each key alone switched off leaves the result byte-identical, and all
  off equals the JAX package's rows;
* a group-by over the RLE column decodes in the update (no late
  decode), and K1 takes an RLE key in its domain as the JAX package's
  route does, with the same result;
* an injected ``io.encode`` fault sends the column plain, counted, the
  result unchanged;
* the encoder's decisions (kind, runs, run capacity, store type, wire
  bytes) and the three decodes equal the JAX package's over seeded
  columns; an INT32 column's int16 deltas summing past 2^31 decode
  exactly;
* each plane kind through the spill tiers and the retry split; a batch
  mixing plane and dictionary columns through a stage; the CSV scan
  (numeric columns plain, decoded on the device); TPC-H q3 and q18;
* a dictionary whose fingerprint collides with an earlier batch's is
  not reused for other values.

Tolerances: integers, booleans, strings and row order exact; float sums
within ``assert_tables_equal``'s ``approx_float`` class (rel 1e-9, abs
1e-12) for TPC-H, exact elsewhere.  Inputs are made from seeds with
numpy.
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
from spark_rapids_tpu.columnar import encoding as jenc
from spark_rapids_tpu.columnar.dtypes import BOOLEAN as JBOOLEAN
from spark_rapids_tpu.columnar.dtypes import INT32 as JINT32
from spark_rapids_tpu.columnar.dtypes import INT64 as JINT64
from spark_rapids_tpu_torch import functions as TF
from spark_rapids_tpu_torch.columnar import encoding as tenc
from spark_rapids_tpu_torch.columnar.batch import device_batch_to_host, \
    host_batch_to_device, host_columns_from_arrow, strings_from_numpy
from spark_rapids_tpu_torch.columnar.dtypes import BOOLEAN, INT32, INT64, \
    Field, Schema, STRING
from tests.compare import assert_tables_equal, sum_plan_metric, tpu_session
from tests.test_compressed import _plane_table
from tests.torch_threads import _one_torch_thread  # noqa: F401

CPU = {"spark.rapids.torch.device": "cpu"}
ON = {"spark.rapids.sql.compressed.enabled": "true",
      "spark.rapids.sql.scan.deviceCacheEnabled": "false"}
OFF = {**ON, "spark.rapids.sql.compressed.enabled": "false"}
KEYS = {"rle": ("spark.rapids.sql.compressed.rle.enabled", "rle_columns"),
        "delta": ("spark.rapids.sql.compressed.delta.enabled",
                  "delta_columns"),
        "packed_bool": ("spark.rapids.sql.compressed.packedBool.enabled",
                        "packed_bool_columns")}
ALL_OFF = {**ON, **{k: "false" for k, _ in KEYS.values()}}
COUNTERS = ("rle_columns", "delta_columns", "packed_bool_columns",
            "h2d_raw_bytes", "h2d_wire_bytes", "plain_columns",
            "encoded_columns")


def _ts(conf=None):
    return st.TorchSession({**CPU, **(ON if conf is None else conf)})


def _js(conf=None):
    return tpu_session(dict(ON if conf is None else conf))


def _nodes(plan):
    yield plan
    for c in plan.children:
        yield from _nodes(c)


def _port_metric(session, name: str) -> int:
    return sum(int(n.metrics.get(name, 0))
               for n in _nodes(session._last_plan))


def _since(stats_fn, before) -> dict:
    after = stats_fn()
    return {k: after[k] - before[k] for k in after if k in before}


@pytest.fixture(scope="module")
def plane_paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("tplanes")
    tbl = _plane_table()
    path = str(d / "planes.parquet")
    pq.write_table(tbl, path, row_group_size=1024)
    orc = str(d / "planes.orc")
    paorc.write_table(tbl, orc)
    return {"table": tbl, "parquet": path, "orc": orc}


def _read(s, fmt, paths):
    if fmt == "local":
        return s.create_dataframe(paths["table"])
    return getattr(s.read, fmt)(paths[fmt])


@pytest.fixture(autouse=True)
def _fresh_memo():
    # a local scan of the same arrays in an earlier test would be served
    # by the memo, which counts no host encode but every byte again
    tenc.clear_memo()
    yield


# ---------------------------------------------------------------------------
# the scans: encodings, counters, bytes, switches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", ["local", "parquet", "orc"])
def test_plane_encodings_match_jax(plane_paths, fmt):
    before = tenc.compressed_stats()
    got = _read(_ts(), fmt, plane_paths).to_arrow()
    port = _since(tenc.compressed_stats, before)
    jb = jenc.compressed_stats()
    want = _read(_js(), "parquet" if fmt == "local" else fmt,
                 plane_paths).to_arrow()
    jax = _since(jenc.compressed_stats, jb)
    for key in COUNTERS:
        assert port[key] == jax[key], (key, port[key], jax[key])
    for key in ("rle_columns", "delta_columns", "packed_bool_columns"):
        assert port[key] == 1, key
    assert 0 < port["h2d_wire_bytes"] < port["h2d_raw_bytes"]
    assert got.equals(want)


@pytest.mark.parametrize("fmt", ["local", "parquet"])
@pytest.mark.parametrize("enc", sorted(KEYS))
def test_plane_key_off_byte_identical(plane_paths, fmt, enc):
    key, counter = KEYS[enc]
    on = _read(_ts(), fmt, plane_paths).to_arrow()
    before = tenc.compressed_stats()
    off = _read(_ts({**ON, key: "false"}), fmt, plane_paths).to_arrow()
    after = tenc.compressed_stats()
    assert after[counter] == before[counter], f"{key}=false kept {counter}"
    others = [c for _, c in KEYS.values() if c != counter]
    assert all(after[c] > before[c] for c in others)
    assert on.equals(off)


@pytest.mark.parametrize("fmt", ["local", "parquet"])
def test_plane_all_off_matches_jax(plane_paths, fmt):
    on = _read(_ts(), fmt, plane_paths).to_arrow()
    before = tenc.compressed_stats()
    off = _read(_ts(ALL_OFF), fmt, plane_paths).to_arrow()
    master_off = _read(_ts(OFF), fmt, plane_paths).to_arrow()
    after = tenc.compressed_stats()
    assert all(after[c] == before[c] for _, c in KEYS.values())
    assert on.equals(off) and on.equals(master_off)
    want = _read(_js(ALL_OFF), "parquet", plane_paths).to_arrow()
    assert_tables_equal(off, want, ignore_order=False)


@pytest.mark.parametrize("fmt", ["local", "parquet"])
def test_plane_group_by_zero_late_decodes(plane_paths, fmt):
    def q(s, F):
        return _read(s, fmt, plane_paths).group_by("r").agg(
            F.sum(F.col("q")).alias("sq"),
            F.count(F.col("b")).alias("nb")).order_by("r")

    before = tenc.compressed_stats()
    df = q(_ts(), TF)
    got = df.to_arrow()
    port = _since(tenc.compressed_stats, before)
    assert port["rle_columns"] == 1
    assert port["fused_decodes"] > 0
    assert port["late_decodes"] == 0, \
        "a plane column decodes in the update, not through the late decode"
    want = q(_js(), JF).to_arrow()
    assert_tables_equal(got, want, ignore_order=False)


def _k1_table(seed: int, rows: int = 6000):
    """A fact table sorted by its key: ``k`` in [0, 300), clustered, so
    that it rides RLE and fits K1's 1024 slots."""
    rng = np.random.default_rng(seed)
    k = np.sort(rng.integers(0, 300, rows)).astype(np.int64)
    kvalid = rng.random(rows) > 0.02
    return pa.table({
        "k": pa.array(k, mask=~kvalid),
        "v": pa.array(rng.integers(-100, 100, rows).astype(np.int32)),
        "f": pa.array(rng.normal(size=rows))})


@pytest.mark.parametrize("seed", [1, 2])
def test_k1_route_over_rle_key_matches_jax(tmp_path, seed):
    path = str(tmp_path / "k1.parquet")
    pq.write_table(_k1_table(seed), path)

    def q(s, F):
        return s.read.parquet(path).group_by("k").agg(
            F.count(F.col("v")).alias("c"), F.sum(F.col("v")).alias("sv"),
            F.min(F.col("v")).alias("mn"),
            F.max(F.col("f")).alias("mf")).order_by("k")

    ts = _ts()
    before = tenc.compressed_stats()
    got = q(ts, TF).to_arrow()
    port = _since(tenc.compressed_stats, before)
    assert port["rle_columns"] >= 1
    assert port["late_decodes"] == 0
    assert _port_metric(ts, "pallasAggBatches") > 0
    js = _js()
    jb = jenc.compressed_stats()
    want = q(js, JF).to_arrow()
    assert jenc.compressed_stats()["rle_columns"] > jb["rle_columns"]
    assert _port_metric(ts, "pallasAggBatches") == \
        sum_plan_metric(js, "pallasAggBatches")
    assert_tables_equal(got, want, ignore_order=False)


@pytest.mark.parametrize("fmt", ["local", "parquet"])
def test_plane_encode_fault_degrades_to_plain(plane_paths, fmt):
    conf = {**ON, "spark.rapids.faults.io.encode": "count:1"}
    before = tenc.compressed_stats()
    faulted = _read(_ts(conf), fmt, plane_paths).to_arrow()
    port = _since(tenc.compressed_stats, before)
    from spark_rapids_tpu_torch import faults
    faults.configure({})
    assert port["encode_faults"] == 1
    assert port["plain_columns"] == 1
    # the first column (r) went plain: its plain bytes in raw and wire
    assert port["rle_columns"] == 0
    assert port["delta_columns"] == port["packed_bool_columns"] == 1
    clean = _read(_ts(), fmt, plane_paths).to_arrow()
    assert faulted.equals(clean)
    jb = jenc.compressed_stats()
    _read(_js(conf), "parquet", plane_paths).to_arrow()
    jax = _since(jenc.compressed_stats, jb)
    for key in ("encode_faults", "plain_columns", "rle_columns",
                "delta_columns", "packed_bool_columns", "h2d_raw_bytes",
                "h2d_wire_bytes"):
        assert port[key] == jax[key], key


def _edit_table(n: int = 3000):
    """Writable numpy columns that take each plane kind, and a mask."""
    rng = np.random.default_rng(29)
    data = {"k": np.sort(rng.integers(0, 40, n)).astype(np.int64),
            "q": np.cumsum(rng.integers(0, 3, n)).astype(np.int64),
            "b": rng.random(n) < 0.3}
    return data, {"k": rng.random(n) > 0.1}


def _masked_rows(data, masks) -> dict:
    return {name: [None if m is not None and not m[i] else v.item()
                   for i, v in enumerate(vals)]
            for name, vals in data.items()
            for m in [masks.get(name)]}


def test_local_scan_follows_in_place_edits():
    """A user's numpy column or mask edited in place between two queries:
    the same DataFrame run again, and a new one over the same arrays,
    read the new values (a writable array's plane decision is not kept
    across scans)."""
    data, masks = _edit_table()
    ts = _ts()
    df = ts.create_dataframe(data, masks)
    before = tenc.compressed_stats()
    first = df.to_arrow()
    port = _since(tenc.compressed_stats, before)
    assert [port[c] for _, c in KEYS.values()] == [1, 1, 1]
    assert first.to_pydict() == _masked_rows(data, masks)
    data["k"][:100] = 77
    data["q"] += 3
    np.logical_not(data["b"], out=data["b"])
    masks["k"][5] = not masks["k"][5]
    want = _masked_rows(data, masks)
    assert df.to_arrow().to_pydict() == want
    assert ts.create_dataframe(data, masks).to_arrow().to_pydict() == want
    agg = df.group_by("k").agg(TF.sum(TF.col("q")).alias("sq")) \
        .order_by("k").to_arrow()
    js = _js()
    jwant = js.create_dataframe(pa.table(
        {"k": pa.array(data["k"], mask=~masks["k"]), "q": data["q"],
         "b": data["b"]})).group_by("k").agg(
        JF.sum(JF.col("q")).alias("sq")).order_by("k").to_arrow()
    assert_tables_equal(agg, jwant, ignore_order=False)


@pytest.mark.parametrize("source", ["arrow", "read_only_numpy",
                                    "writable_numpy"])
def test_local_scan_keeps_planes_of_read_only_arrays(source):
    """The local scan keeps a plane decision, and skips the host encode
    on the next scan, only over arrays no one can write: an Arrow
    table's buffers or numpy arrays their user froze; the memo's host
    bytes are reported and go with ``clear_memo``."""
    data, _ = _edit_table()
    if source == "arrow":
        data = pa.table(data)
    elif source == "read_only_numpy":
        for v in data.values():
            v.flags.writeable = False
    df = _ts().create_dataframe(data)
    first = df.to_arrow()
    assert tenc.compressed_stats()["memo_host_bytes"] \
        == (0 if source == "writable_numpy" else
            sum(a.nbytes for e in tenc._MEMO.values()
                if isinstance(e[0], tuple) for a in e[0][1]))
    before = tenc.compressed_stats()
    assert df.to_arrow().equals(first)
    port = _since(tenc.compressed_stats, before)
    assert [port[c] for _, c in KEYS.values()] == [1, 1, 1]
    assert (port["host_encode_ns"] == 0) == (source != "writable_numpy")
    tenc.clear_memo()
    assert tenc.compressed_stats()["memo_host_bytes"] == 0


def test_memo_bounded_in_bytes(monkeypatch):
    """Past its byte bound the memo drops its oldest entries: what it
    holds stays under the bound, and the scans stay right."""
    from spark_rapids_tpu_torch.exec import basic
    monkeypatch.setattr(basic, "BATCH_ROWS", 512)
    data, _ = _edit_table(4096)
    tbl = pa.table(data)
    df = _ts().create_dataframe(tbl)
    df.to_arrow()
    held = tenc.compressed_stats()["memo_host_bytes"]
    assert held > 0
    tenc.clear_memo()
    monkeypatch.setattr(tenc, "_MEMO_BOUND_BYTES", held // 2)
    got = df.to_arrow()
    assert 0 < tenc.compressed_stats()["memo_host_bytes"] <= held // 2
    assert got.to_pydict() == tbl.to_pydict()


def test_engine_stats_carry_plane_counters():
    snap = _ts().engine_stats()["compressed"]
    for key in ("rle_columns", "delta_columns", "packed_bool_columns",
                "fusedDecodes", "lateDecodes"):
        assert key in snap, key
    jsnap = _js().engine_stats()["compressed"]
    assert {"rle_columns", "delta_columns", "packed_bool_columns"} \
        <= set(jsnap)


@pytest.mark.parametrize("conf,planes", [
    ({}, True),
    ({"spark.rapids.sql.compressed.ingest": "false"}, False),
    ({"spark.rapids.sql.compressed.enabled": "false"}, False)])
def test_plane_keys_gate_on_ingest(plane_paths, conf, planes):
    """Each plane key is on only while compressed.enabled and
    compressed.ingest are, as the JAX package's set_conf gates them."""
    before = tenc.compressed_stats()
    _read(_ts({**ON, **conf}), "local", plane_paths).to_arrow()
    after = tenc.compressed_stats()
    won = sum(after[c] - before[c] for _, c in KEYS.values())
    assert won == (3 if planes else 0)


# ---------------------------------------------------------------------------
# the encoder and the decodes against the JAX package's
# ---------------------------------------------------------------------------

def _column_cases():
    rng = np.random.default_rng(41)
    big = np.sort(rng.integers(-2 ** 31, 2 ** 31 - 1, 3000)).astype(np.int32)
    return {
        "int32_sorted_nulls": (np.sort(rng.integers(0, 40, 3000))
                               .astype(np.int32), rng.random(3000) > 0.1,
                               INT32),
        "int64_small_steps": (np.cumsum(rng.integers(0, 3, 3000))
                              .astype(np.int64), None, INT64),
        "int32_int16_steps": (np.cumsum(rng.integers(-900, 900, 3000))
                              .astype(np.int32), None, INT32),
        "int64_random": (rng.integers(-2 ** 40, 2 ** 40, 3000), None, INT64),
        "int32_spread_sorted": (big, None, INT32),
        "int64_constant": (np.full(3000, 7, np.int64), None, INT64),
        "int64_constant_nulls": (np.full(3000, -3, np.int64),
                                 rng.random(3000) > 0.5, INT64),
        "int32_one_row": (np.array([12345], np.int32), None, INT32),
        "int32_past_pow2": (np.arange(1025, dtype=np.int32) // 7, None,
                            INT32),
        "int64_runs_past_pow2": (np.repeat(np.arange(129, dtype=np.int64)
                                           * 100000, 8)[:1025], None, INT64),
        "bool_nulls": (rng.random(3000) < 0.3, rng.random(3000) > 0.2,
                       BOOLEAN),
        "bool_one_row": (np.array([True]), None, BOOLEAN),
        "bool_past_pow2": (rng.random(1025) < 0.5, None, BOOLEAN),
    }


_JTYPES = {"int": (JINT32, pa.int32()), "long": (JINT64, pa.int64()),
           "boolean": (JBOOLEAN, pa.bool_())}


@pytest.mark.parametrize("case", sorted(_column_cases()))
def test_encoder_decisions_match_jax(monkeypatch, case):
    values, valid, dtype = _column_cases()[case]
    n = len(values)
    valid = np.ones(n, np.bool_) if valid is None else valid
    from spark_rapids_tpu_torch.columnar.column import bucket_capacity
    cap = bucket_capacity(n)
    for mod in (tenc, jenc):
        for name in ("_RLE", "_DELTA", "_PACKED"):
            monkeypatch.setattr(mod, name, True)
    jt, at = _JTYPES[dtype.name]
    jarr = pa.array(values, type=at, mask=None if valid.all() else ~valid)
    jb = jenc.compressed_stats()
    want = jenc.IngestEncoder().upload_column(jarr, jt, cap)
    jax = _since(jenc.compressed_stats, jb)
    tb = tenc.compressed_stats()
    got = tenc.IngestEncoder("cpu").upload_column(values, valid, dtype, cap)
    port = _since(tenc.compressed_stats, tb)
    assert (got is None) == (want is None)
    for key in ("h2d_raw_bytes", "h2d_wire_bytes", "rle_columns",
                "delta_columns", "packed_bool_columns"):
        assert port[key] == jax[key], key
    if got is None:
        return
    assert type(got).__name__ == type(want).__name__
    if isinstance(got, tenc.RleColumn):
        assert got.num_runs == want.num_runs
        assert got.run_values.shape[0] == want.run_values.shape[0]
        assert got.run_ends.tolist() == np.asarray(want.run_ends).tolist()
        assert got.run_values.tolist() == \
            np.asarray(want.run_values).tolist()
    elif isinstance(got, tenc.DeltaColumn):
        assert str(got.deltas.dtype).split(".")[-1] == str(want.deltas.dtype)
        assert got.deltas.tolist() == np.asarray(want.deltas).tolist()
        assert got.base.tolist() == np.asarray(want.base).tolist()
    else:
        assert got.packed.tolist() == np.asarray(want.packed).tolist()
    dense = got.decoded()
    jdense = np.asarray(want._dense_planes())
    assert dense.data.tolist() == jdense.tolist()
    assert dense.validity.tolist() == np.asarray(want.validity).tolist()
    assert np.array_equal(dense.data[:n][torch.from_numpy(valid)].numpy(),
                          values[valid])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rle_decode_matches_jax(seed):
    import jax.numpy as jnp
    rng = np.random.default_rng(seed)
    cap, n = 4096, int(rng.integers(1, 4096))
    runs = int(rng.integers(1, min(n, 300) + 1))
    ends = np.sort(rng.choice(np.arange(1, n), runs - 1, replace=False)) \
        if runs > 1 else np.zeros(0, np.int64)
    rcap = 512
    re_ = np.full(rcap, cap, np.int32)
    re_[:runs] = np.append(ends, n)
    rv = np.zeros(rcap, np.int64)
    rv[:runs] = rng.integers(-2 ** 62, 2 ** 62, runs)
    valid = np.zeros(cap, np.bool_)
    valid[:n] = rng.random(n) > 0.1
    got = tenc._rle_dense(torch.from_numpy(rv), torch.from_numpy(re_), cap)
    want = jenc._rle_dense(jnp.asarray(rv), jnp.asarray(re_),
                           jnp.asarray(valid), cap, rcap)
    assert got.tolist() == np.asarray(want).tolist()
    assert got[n:].eq(0).all()      # rows past n decode to 0


@pytest.mark.parametrize("store,dtype,seed", [
    (np.int8, np.int64, 0), (np.int16, np.int64, 1), (np.int8, np.int32, 2),
    (np.int16, np.int32, 3)])
def test_delta_decode_matches_jax(store, dtype, seed):
    import jax.numpy as jnp
    rng = np.random.default_rng(seed)
    cap = 1 << 12
    n = cap - int(rng.integers(0, 100))
    lim = np.iinfo(store).max
    deltas = np.zeros(cap, store)
    deltas[1:n] = rng.integers(-lim, lim, n - 1)
    base = np.asarray([rng.integers(-1000, 1000)], dtype)
    valid = np.arange(cap) < n
    got = tenc._delta_dense(torch.from_numpy(deltas), torch.from_numpy(base),
                            torch.from_numpy(valid))
    want = jenc._delta_dense(jnp.asarray(deltas), jnp.asarray(base),
                             jnp.asarray(valid), jnp.dtype(dtype))
    assert got.dtype == torch.from_numpy(base).dtype
    assert got.tolist() == np.asarray(want).tolist()
    assert got[n:].eq(0).all()


def test_int32_delta_sum_past_2_31_decodes_exactly(monkeypatch):
    """An INT32 column whose int16 deltas sum past 2^31 over the batch:
    the running sum wraps in int32, as the JAX package's does, and base
    plus it is the exact value."""
    import jax.numpy as jnp
    n = 1 << 17
    values = (-2 ** 31 + 10 + 30000 * np.arange(n, dtype=np.int64)) \
        .astype(np.int32)
    assert 30000 * (n - 1) > 2 ** 31
    monkeypatch.setattr(tenc, "_DELTA", True)
    monkeypatch.setattr(tenc, "_RLE", True)
    col = tenc.IngestEncoder("cpu").upload_column(
        values, np.ones(n, np.bool_), INT32, n)
    assert isinstance(col, tenc.DeltaColumn)
    assert col.deltas.dtype == torch.int16
    assert np.array_equal(col.decoded().data.numpy(), values)
    want = jenc._delta_dense(jnp.asarray(col.deltas.numpy()),
                             jnp.asarray(col.base.numpy()),
                             jnp.asarray(col.validity.numpy()),
                             jnp.dtype(np.int32))
    assert np.array_equal(np.asarray(want), values)


@pytest.mark.parametrize("seed,cap", [(0, 8), (1, 1024), (2, 4096)])
def test_packed_decode_matches_jax(seed, cap):
    import jax.numpy as jnp
    rng = np.random.default_rng(seed)
    packed = rng.integers(0, 256, cap // 8).astype(np.uint8)
    got = tenc._packed_dense(torch.from_numpy(packed), cap)
    want = jenc._packed_dense(jnp.asarray(packed), cap)
    assert got.dtype == torch.bool
    assert got.tolist() == np.asarray(want).tolist()


# ---------------------------------------------------------------------------
# spill, retry split, a mixed stage, CSV, TPC-H
# ---------------------------------------------------------------------------

def _plane_batch(monkeypatch, n=3000):
    """A batch of one column of each plane kind, a dictionary-encoded
    string column and a plain float column, from ``_plane_table``."""
    for name in ("_RLE", "_DELTA", "_PACKED"):
        monkeypatch.setattr(tenc, name, True)
    tbl = _plane_table(n).append_column(
        "s", pa.array(np.random.default_rng(3).choice(
            ["MAIL", "SHIP", "AIR", None], n)))
    schema, cols = host_columns_from_arrow(tbl)
    enc = tenc.IngestEncoder("cpu", max_dict_fraction=0.5)
    batch = host_batch_to_device(schema, cols, "cpu", None, enc)
    kinds = [type(c).__name__ for c in batch.columns]
    assert kinds == ["RleColumn", "DeltaColumn", "PackedBoolColumn",
                     "DeviceColumn", "EncodedColumn"], kinds
    return schema, batch


def test_plane_batch_through_spill_tiers(monkeypatch):
    """Each plane kind spills its compressed planes to the host and to
    disk and comes back as the same class, decoded nowhere, bit for
    bit."""
    from spark_rapids_tpu_torch.memory.spill import BufferCatalog, \
        SpillableBatch
    schema, batch = _plane_batch(monkeypatch)
    cat = BufferCatalog(1 << 30, 1 << 30)
    sb = SpillableBatch(batch, cat)
    try:
        assert sb.size == batch.size_bytes()
        with cat._lock:
            sb._to_host()
            assert sb.host_nbytes() < sum(
                c.validity.numel() * 9 for c in batch.columns)
            sb._to_disk()
        late = tenc.compressed_stats()["late_decodes"]
        back = sb.get()
        assert tenc.compressed_stats()["late_decodes"] == late
        for a, b in zip(back.columns, batch.columns):
            assert type(a) is type(b)
        r0, r1 = back.columns[0], batch.columns[0]
        assert r0.num_runs == r1.num_runs
        assert torch.equal(r0.run_values, r1.run_values)
        assert torch.equal(r0.run_ends, r1.run_ends)
        assert torch.equal(back.columns[1].deltas, batch.columns[1].deltas)
        assert torch.equal(back.columns[1].base, batch.columns[1].base)
        assert torch.equal(back.columns[2].packed, batch.columns[2].packed)
        got = device_batch_to_host(back, schema)
        want = device_batch_to_host(batch, schema)
        for name in schema.names:
            assert np.array_equal(got[name][1], want[name][1])
            g, w = got[name][0], want[name][0]
            if hasattr(w, "to_pylist"):
                assert g.to_pylist() == w.to_pylist()
            else:
                assert np.array_equal(g[want[name][1]], w[want[name][1]])
    finally:
        sb.close()
        cat.close()


def test_plane_batch_split_under_retry(monkeypatch):
    """The retry split halves a plane batch through each column's
    decode (counted late, once a column: the halves share it) into
    dense halves whose rows are the batch's."""
    from spark_rapids_tpu_torch.utils.retry import split_batch_half
    schema, batch = _plane_batch(monkeypatch, n=4096)
    late = tenc.compressed_stats()["late_decodes"]
    halves = split_batch_half(batch)
    assert tenc.compressed_stats()["late_decodes"] == late + 3
    want = device_batch_to_host(batch, schema)
    assert [h.num_rows for h in halves] == [2048, 2048]
    assert tenc.is_encoded(halves[0].columns[4])
    for name in ("r", "q", "b", "v"):
        vals = np.concatenate([device_batch_to_host(h, schema)[name][0]
                               for h in halves])
        valid = np.concatenate([device_batch_to_host(h, schema)[name][1]
                                for h in halves])
        assert np.array_equal(valid, want[name][1])
        assert np.array_equal(vals[valid], want[name][0][valid])


def test_stage_over_planes_and_dictionary_matches_jax(tmp_path):
    """A batch mixing plane columns and a dictionary-encoded string
    column through a fused stage: the planes decode in the stage's own
    pass, the bare string reference stays codes, and the rows are the
    JAX package's."""
    rng = np.random.default_rng(17)
    n = 5000
    tbl = pa.table({
        "s": pa.array(rng.choice(["MAIL", "SHIP", "AIR", "RAIL"], n)),
        "k": pa.array(np.sort(rng.integers(0, 60, n)).astype(np.int64)),
        "q": pa.array(np.cumsum(rng.integers(0, 4, n)).astype(np.int32)),
        "b": pa.array(rng.random(n) < 0.4),
        "v": pa.array(rng.normal(size=n))})
    path = str(tmp_path / "mixed.parquet")
    pq.write_table(tbl, path)

    def q(s, F):
        return s.read.parquet(path).filter(
            F.col("b") & (F.col("s") != "RAIL")).select(
            F.col("s"), F.col("k"), (F.col("q") + F.col("k")).alias("qk"),
            (F.col("v") * 2.0).alias("v2"))

    ts = _ts()
    before = tenc.compressed_stats()
    df = q(ts, TF)
    batches = df.to_device_batches()
    assert tenc.is_encoded(batches[0].columns[0])
    got = df.to_arrow()
    port = _since(tenc.compressed_stats, before)
    assert port["rle_columns"] >= 1 and port["delta_columns"] >= 1 \
        and port["packed_bool_columns"] >= 1 and port["encoded_columns"] >= 1
    assert port["fused_decodes"] >= 3
    want = q(_js(), JF).to_arrow()
    assert_tables_equal(got, want, ignore_order=False)


def test_csv_numeric_columns_stay_plain_and_match_jax(tmp_path):
    """The CSV scan decodes its numeric columns on the device, so none
    crosses the link and none takes a plane encoding (the JAX CSV scan
    encodes them on the host: ROADMAP.md C); the rows are the JAX
    package's."""
    rng = np.random.default_rng(23)
    n = 3000
    tbl = pa.table({
        "k": pa.array(np.sort(rng.integers(0, 30, n)).astype(np.int64)),
        "q": pa.array(np.arange(n, dtype=np.int64)),
        "s": pa.array(rng.choice(["x", "y", "z"], n)),
        "v": pa.array(rng.normal(size=n))})
    path = str(tmp_path / "t.csv")
    pacsv.write_csv(tbl, path)
    before = tenc.compressed_stats()
    ts = _ts()
    got = ts.read.csv(path).to_arrow()
    agg = ts.read.csv(path).group_by("k").agg(
        TF.sum(TF.col("q")).alias("sq")).order_by("k").to_arrow()
    port = _since(tenc.compressed_stats, before)
    assert all(port[c] == 0 for _, c in KEYS.values())
    assert port["encoded_columns"] > 0
    js = _js()
    assert_tables_equal(got, js.read.csv(path).to_arrow(),
                        ignore_order=False)
    assert_tables_equal(agg, js.read.csv(path).group_by("k").agg(
        JF.sum(JF.col("q")).alias("sq")).order_by("k").to_arrow(),
        ignore_order=False)


@pytest.fixture(scope="module")
def tpch(tmp_path_factory):
    from spark_rapids_tpu.bench.tpch import gen_tpch
    from spark_rapids_tpu_torch.bench.tpch import gen_tpch_numpy
    d = tmp_path_factory.mktemp("tpch_planes")
    return gen_tpch(str(d), lineitem_rows=4000), gen_tpch_numpy(4000)


@pytest.mark.parametrize("qname", ["q3", "q18"])
def test_tpch_with_planes_matches_jax(tpch, qname):
    from spark_rapids_tpu.bench.tpch import TPCH_QUERIES as JQ
    from spark_rapids_tpu.bench.tpch import load_tables as jload
    from spark_rapids_tpu_torch.bench.tpch import TPCH_QUERIES as TQ
    from spark_rapids_tpu_torch.bench.tpch import load_tables as tload
    paths, tables = tpch
    want = JQ[qname](jload(_js(), paths)).to_arrow()
    for source in (paths, tables):
        before = tenc.compressed_stats()
        got = TQ[qname](tload(_ts(), source)).to_arrow()
        port = _since(tenc.compressed_stats, before)
        assert port["delta_columns"] > 0 and port["rle_columns"] > 0, port
        assert_tables_equal(got, want, ignore_order=False,
                            approx_float=True)
        off = TQ[qname](tload(_ts(ALL_OFF), source)).to_arrow()
        assert_tables_equal(got, off, ignore_order=False,
                            approx_float=True)


# ---------------------------------------------------------------------------
# the dictionary reuse repair
# ---------------------------------------------------------------------------

def test_dictionary_fingerprint_collision_builds_its_own(monkeypatch):
    """Two batches whose dictionaries have the same size and, forced
    here, the same fingerprint: the second gets its own dictionary
    (values compared on a fingerprint hit), and the query's rows are
    the JAX package's."""
    monkeypatch.setattr(tenc, "_fingerprint", lambda chars, lengths: 7)
    schema = Schema([Field("s", STRING, True)])
    enc = tenc.IngestEncoder("cpu", max_dict_fraction=1.0)
    parts = [["a", "b", "a", "b"], ["c", "d", "d", "c"]]
    batches = [host_batch_to_device(
        schema, {"s": strings_from_numpy(np.asarray(p, dtype=object))},
        "cpu", None, enc) for p in parts]
    d0, d1 = (b.columns[0].dict for b in batches)
    assert d0 is not d1
    assert list(d1.values) == ["c", "d"]
    assert device_batch_to_host(batches[1], schema)["s"][0].to_pylist() \
        == parts[1]
    # the same values again share the first dictionary
    again = host_batch_to_device(
        schema, {"s": strings_from_numpy(np.asarray(parts[1][::-1],
                                                    dtype=object))},
        "cpu", None, enc)
    assert again.columns[0].dict is d1

    from spark_rapids_tpu_torch.exec import basic
    monkeypatch.setattr(basic, "BATCH_ROWS", 4)
    data = {"s": np.asarray(sum(parts, []), dtype=object),
            "v": np.arange(8, dtype=np.int64)}
    ts = _ts()
    got = ts.create_dataframe(data).group_by("s").agg(
        TF.sum(TF.col("v")).alias("sv")).order_by("s").to_arrow()
    want = _js().create_dataframe(pa.table(data)).group_by("s").agg(
        JF.sum(JF.col("v")).alias("sv")).order_by("s").to_arrow()
    assert got.column("s").to_pylist() == ["a", "b", "c", "d"]
    assert_tables_equal(got, want, ignore_order=False)
