"""The device scan cache of the torch port against the JAX package's
(``spark.rapids.sql.scan.deviceCacheEnabled``).

The same tables, made from a seed with numpy, are written as parquet,
ORC and CSV, and both packages read them with the cache on: each scan
read twice gives the JAX package's rows on both reads, the second read
is a hit, and the replayed ``numRowGroups*`` / ``numStripes*`` and
``scanCacheHits`` equal the JAX package's (the JAX CSV scan counts no
hit; the port's does).  Then eviction at the ninth key in the JAX
package's order, a changed file and a same-size overwrite read anew,
the key false uploading every time and equal to the key on bit for bit,
compressed ingest and the plane keys on against off never sharing an
entry, a limit and an error mid-read storing nothing and leaking
nothing, an injected ``io.encode`` fault, an entry demoted to the host
and the disk and hit again (every kind of column back as the same
class, bit for bit), the ``_version`` guard raising on a write in place, writes into what
``to_torch`` and ``to_device_batches`` hand out never reaching the
cache, concurrent
misses and an eviction under a reader, and a standing aggregate over a
tailed CSV root whose ticks hit, against a full recompute and the JAX
package's standing query.

The conftest's leak audit reads the JAX runtime only, so each test here
stops its port sessions and resets the port's runtime itself.
"""

import os
import threading

import numpy as np
import pyarrow as pa
import pyarrow.csv as pacsv
import pyarrow.orc as paorc
import pyarrow.parquet as pq
import pytest
import torch

import spark_rapids_tpu as jst
import spark_rapids_tpu_torch as st
from spark_rapids_tpu import functions as JF
from spark_rapids_tpu_torch import functions as TF
from spark_rapids_tpu_torch.columnar import encoding as tenc
from spark_rapids_tpu_torch.memory.spill import TIER_DEVICE, \
    CachedBatchWrittenError
from spark_rapids_tpu_torch.runtime import TorchRuntime
from tests.compare import assert_tables_equal, tpu_session
from tests.torch_threads import _one_torch_thread  # noqa: F401

CPU = {"spark.rapids.torch.device": "cpu"}
OFF = {"spark.rapids.sql.scan.deviceCacheEnabled": "false"}
FORMATS = ("parquet", "orc", "csv")
PRUNE = {"parquet": ("numRowGroupsTotal", "numRowGroupsRead"),
         "orc": ("numStripesTotal", "numStripesRead"), "csv": ()}
# what a read that uploads counts on its scan
UPLOADS = {"parquet": ("encodedColumns",), "orc": ("encodedColumns",),
           "csv": ("encodedColumns", "uploadTime", "csvReadTime")}


@pytest.fixture(autouse=True)
def _fresh_runtime(monkeypatch):
    # the CSV scan's host read unit at 64 KiB, as tests/test_torch_csv.py
    # sets it: each file spans several ranges, and no 128 MiB buffer is
    # zeroed a read
    from spark_rapids_tpu_torch.io import csv as tcsv
    monkeypatch.setattr(tcsv, "RANGE_BYTES", 64 << 10)
    TorchRuntime.reset()
    yield
    from spark_rapids_tpu_torch import faults
    faults.reset()
    TorchRuntime.reset()


def _table(n=6000, seed=5):
    """Sorted ids (delta), clustered int32 keys (RLE), doubles, a
    4-value string (dictionary), a wide-cardinality string (a char
    matrix), a boolean (bit-packed)."""
    rng = np.random.default_rng(seed)
    return pa.table({
        "id": pa.array(np.arange(n, dtype=np.int64)),
        "k": pa.array(np.repeat(np.arange(n // 500, dtype=np.int32), 500)),
        "v": pa.array(np.round(rng.normal(size=n), 6)),
        "s": pa.array(np.array(["AIR", "MAIL", "RAIL", "SHIP"],
                               dtype=object)[rng.integers(0, 4, n)]),
        "c": pa.array([f"c{x:09d}" for x in rng.integers(0, 10 ** 9, n)]),
        "f": pa.array(rng.random(n) < 0.3),
    })


def _write(fmt: str, path: str, t: pa.Table) -> str:
    if fmt == "parquet":
        pq.write_table(t, path, row_group_size=1000)
    elif fmt == "orc":
        paorc.write_table(t, path, stripe_size=16 * 1024)
    else:
        pacsv.write_csv(t, path)
    return path


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("scan_cache")
    t = _table()
    return {fmt: _write(fmt, str(d / f"t.{fmt}"), t) for fmt in FORMATS}


def _session(extra=None):
    return st.TorchSession({**CPU, **(extra or {})})


def _read(s, fmt, path):
    return getattr(s.read, fmt)(path)


def _leaf(plan):
    while plan.children:
        plan = plan.children[0]
    return plan


def _port_scan(s, names):
    scan = _leaf(s._last_plan)
    return tuple(int(scan.metrics[n]) for n in names)


def _jax_scan(js, names):
    scan = _leaf(js._last_plan_result.physical)
    return tuple(scan.metrics[n].value for n in names)


def _query(F, df, fmt):
    """A filter the parquet and ORC scans push down (row groups and
    stripes pruned), then the rows."""
    return df.filter(F.col("id") < 2500) if fmt != "csv" else \
        df.filter(F.col("k") < 3)


def _cache(s):
    return s.runtime.scan_cache


def _only_the_cache_registered(s):
    """No operator's handle left (the leak audit leaves the cache's out),
    and every byte the catalog holds is an entry's."""
    cat, stats = s.runtime.catalog, _cache(s).stats()
    assert cat.audit_leaks() == 0
    assert (cat.device_bytes, cat.host_bytes, cat.disk_bytes) == \
        (stats["device_bytes"], stats["host_bytes"], stats["disk_bytes"])


# ---------------------------------------------------------------------------
# each scan read twice against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", FORMATS)
def test_read_twice_matches_jax(files, fmt):
    path = files[fmt]
    names = PRUNE[fmt] + ("scanCacheHits",)
    js = tpu_session()
    s = _session()
    try:
        got, want, ports, jaxes = [], [], [], []
        for _ in range(2):
            got.append(_query(TF, _read(s, fmt, path), fmt).to_arrow())
            ports.append(_port_scan(s, names))
            want.append(_query(JF, _read(js, fmt, path), fmt).to_arrow())
            jaxes.append(_jax_scan(js, names))
        for g in got:
            assert_tables_equal(g, want[0], ignore_order=False)
        assert_tables_equal(want[1], want[0], ignore_order=False)
        assert got[0].equals(got[1])
        assert [p[-1] for p in ports] == [0, 1]
        # the pruning counts replayed on the hit, as the JAX package's
        assert [p[:-1] for p in ports] == [j[:-1] for j in jaxes]
        if fmt != "csv":
            assert [j[-1] for j in jaxes] == [0, 1]
            assert ports[0][1] < ports[0][0]
        else:
            # the JAX CSV scan passes no metrics to its cache: a hit
            # there counts nothing (ROADMAP.md C)
            assert [j[-1] for j in jaxes] == [0, 0]
        st_ = _cache(s).stats()
        assert (st_["entries"], st_["hits"], st_["misses"]) == (1, 1, 1)
    finally:
        s.stop()


@pytest.mark.parametrize("fmt", FORMATS)
def test_hit_uploads_nothing(files, fmt):
    """A hit replays the pruning counts and nothing else of the read:
    the ingest encoder's count, and the CSV's upload and host read
    timers, stay at 0."""
    s = _session()
    try:
        timers = UPLOADS[fmt]
        _read(s, fmt, files[fmt]).to_arrow()
        first = _port_scan(s, timers)
        _read(s, fmt, files[fmt]).to_arrow()
        assert all(v > 0 for v in first)
        assert _port_scan(s, timers) == (0,) * len(timers)
    finally:
        s.stop()


def test_eviction_at_the_ninth_key_in_jax_order(tmp_path):
    from spark_rapids_tpu.runtime import TpuRuntime
    t = _table(500)
    paths = [_write("parquet", str(tmp_path / f"e{i}.parquet"), t)
             for i in range(9)]
    js = tpu_session()
    s = _session()
    try:
        order = list(range(8)) + [0, 8]
        for i in order:
            _read(s, "parquet", paths[i]).to_arrow()
            _read(js, "parquet", paths[i]).to_arrow()
        mine = [os.path.basename(k[1][0][0]) for k in _cache(s).keys()]
        jcache = TpuRuntime._instance.scan_cache
        theirs = [os.path.basename(k[1][0][0]) for k in jcache._order
                  if os.path.dirname(k[1][0][0]) == str(tmp_path)]
        assert mine == theirs
        assert mine == [f"e{i}.parquet" for i in (2, 3, 4, 5, 6, 7, 0, 8)]
        # the evicted key misses in both, and its handles were closed
        _read(s, "parquet", paths[1]).to_arrow()
        _read(js, "parquet", paths[1]).to_arrow()
        assert _port_scan(s, ("scanCacheHits",)) == (0,)
        assert _jax_scan(js, ("scanCacheHits",)) == (0,)
        _only_the_cache_registered(s)
    finally:
        s.stop()


# ---------------------------------------------------------------------------
# invalidation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", FORMATS)
def test_changed_file_misses(tmp_path, fmt):
    path = _write(fmt, str(tmp_path / f"t.{fmt}"), _table(2000, 1))
    s = _session()
    js = tpu_session()
    try:
        _read(s, fmt, path).to_arrow()
        _write(fmt, path, _table(3000, 2))
        got = _read(s, fmt, path).to_arrow()
        assert _port_scan(s, ("scanCacheHits",)) == (0,)
        assert got.num_rows == 3000
        assert_tables_equal(got, _read(js, fmt, path).to_arrow(),
                            ignore_order=False)
    finally:
        s.stop()


def test_same_size_overwrite_by_the_writer_reads_anew(tmp_path):
    """The port's writer drops the entries naming its path: contents of
    the same size, rewritten at once, are read anew even where the
    file's (mtime_ns, size, inode) came back the same."""
    out = str(tmp_path / "w")
    s = _session()
    try:
        a = {"x": np.arange(10, 90, dtype=np.int64)}
        b = {"x": np.arange(89, 9, -1, dtype=np.int64)}
        s.create_dataframe(a).write.csv(out)
        assert _read(s, "csv", out).to_numpy()["x"].tolist() == \
            a["x"].tolist()
        assert _cache(s).stats()["entries"] == 1
        f = os.path.join(out, "part-00000.csv")
        size = os.path.getsize(f)
        s.create_dataframe(b).write.mode("overwrite").csv(out)
        assert os.path.getsize(f) == size
        assert _cache(s).stats()["entries"] == 0
        assert _read(s, "csv", out).to_numpy()["x"].tolist() == \
            b["x"].tolist()
        # and an append adds a file the key names
        s.create_dataframe(a).write.mode("append").csv(out)
        assert len(_read(s, "csv", out).to_numpy()["x"]) == 160
    finally:
        s.stop()


def test_invalidate_paths_drops_only_entries_under_the_root(tmp_path):
    t = _table(500)
    (tmp_path / "a").mkdir()
    (tmp_path / "ab").mkdir()
    pa_ = _write("parquet", str(tmp_path / "a" / "x.parquet"), t)
    pb = _write("parquet", str(tmp_path / "ab" / "x.parquet"), t)
    s = _session()
    try:
        _read(s, "parquet", pa_).to_arrow()
        _read(s, "parquet", pb).to_arrow()
        TorchRuntime.invalidate_paths(str(tmp_path / "a"))
        left = [k[1][0][0] for k in _cache(s).keys()]
        assert left == [os.path.abspath(pb)]
    finally:
        s.stop()


# ---------------------------------------------------------------------------
# the key off, and what the key separates
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", FORMATS)
def test_key_off_uploads_every_time_and_equals_on(files, fmt):
    off = _session(OFF)
    on = _session()
    try:
        offs = []
        for _ in range(2):
            offs.append(_read(off, fmt, files[fmt]).to_arrow())
            assert _port_scan(off, ("scanCacheHits",)) == (0,)
            assert all(v > 0 for v in _port_scan(off, UPLOADS[fmt]))
        assert _cache(off).stats()["entries"] == 0
        ons = [_read(on, fmt, files[fmt]).to_arrow() for _ in range(2)]
        assert _port_scan(on, ("scanCacheHits",)) == (1,)
        for t in offs[1:] + ons:
            assert t.equals(offs[0])
    finally:
        off.stop()
        on.stop()


def _kinds(s, fmt, path):
    return [[type(c).__name__ for c in b.columns]
            for b in _read(s, fmt, path).to_device_batches()]


@pytest.mark.parametrize("switch", [
    {"spark.rapids.sql.compressed.ingest": "false"},
    {"spark.rapids.sql.compressed.enabled": "false"},
    {"spark.rapids.sql.compressed.rle.enabled": "false"},
    {"spark.rapids.sql.compressed.delta.enabled": "false"},
    {"spark.rapids.sql.compressed.packedBool.enabled": "false"},
    {"spark.rapids.sql.compressed.maxDictFraction": "0.0001"},
    {"spark.rapids.sql.reader.batchSizeRows": "1024"},
    {"spark.rapids.sql.maxDeviceStringWidth": "256"},
], ids=lambda d: next(iter(d)).rsplit(".", 2)[-2] + "." +
    next(iter(d)).rsplit(".", 1)[-1])
def test_switches_never_share_an_entry(files, switch):
    on, other = _session(), _session(switch)
    try:
        want = _kinds(on, "parquet", files["parquet"])
        got = _kinds(other, "parquet", files["parquet"])
        assert _port_scan(other, ("scanCacheHits",)) == (0,)
        assert _cache(on).stats()["entries"] == 2
        if "batchSizeRows" not in next(iter(switch)) \
                and "StringWidth" not in next(iter(switch)):
            assert got != want
        # each session's next read hits its own entry
        assert _kinds(on, "parquet", files["parquet"]) == want
        assert _port_scan(on, ("scanCacheHits",)) == (1,)
        assert _kinds(other, "parquet", files["parquet"]) == got
        assert _port_scan(other, ("scanCacheHits",)) == (1,)
        assert _read(other, "parquet", files["parquet"]).to_arrow().equals(
            _read(on, "parquet", files["parquet"]).to_arrow())
    finally:
        on.stop()
        other.stop()


def test_csv_header_and_separator_are_in_the_key(tmp_path):
    p = str(tmp_path / "t.csv")
    with open(p, "w") as f:
        f.write("a,b\n1,2\n3,4\n")
    s = _session()
    try:
        with_header = _read(s, "csv", p).to_numpy()
        no_header = s.read.csv(p, header=False).to_numpy()
        assert with_header["a"].tolist() == [1, 3]
        assert len(next(iter(no_header.values()))) == 3
        assert _cache(s).stats()["entries"] == 2
    finally:
        s.stop()


# ---------------------------------------------------------------------------
# reads stopped early, faults, spills
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", FORMATS)
def test_limit_stores_nothing_and_leaks_nothing(files, fmt):
    s = _session({"spark.rapids.sql.reader.batchSizeRows": "1000"})
    try:
        got = _read(s, fmt, files[fmt]).limit(5).to_arrow()
        assert got.num_rows == 5
        cat = s.runtime.catalog
        assert _cache(s).stats()["entries"] == 0
        assert cat.audit_leaks() == 0 and cat.device_bytes == 0
        # the whole read stores, and the limit after it is served by it
        _read(s, fmt, files[fmt]).to_arrow()
        again = _read(s, fmt, files[fmt]).limit(5).to_arrow()
        assert again.equals(got)
        assert _port_scan(s, ("scanCacheHits",)) == (1,)
        assert _cache(s).stats()["handles"] > 1
        _only_the_cache_registered(s)
    finally:
        s.stop()


def test_error_mid_read_stores_nothing(files, monkeypatch):
    from spark_rapids_tpu_torch.io import hostio
    real = hostio.pipelined_scan
    calls = []

    def failing(*args, **kwargs):
        for i, b in enumerate(real(*args, **kwargs)):
            if i == 2:
                calls.append(i)
                raise OSError("injected read failure")
            yield b
    monkeypatch.setattr("spark_rapids_tpu_torch.io.parquet.pipelined_scan",
                        failing)
    s = _session({"spark.rapids.sql.reader.batchSizeRows": "1000"})
    try:
        with pytest.raises(OSError):
            _read(s, "parquet", files["parquet"]).to_arrow()
        assert calls
        assert _cache(s).stats()["entries"] == 0
        _only_the_cache_registered(s)
    finally:
        s.stop()


@pytest.mark.parametrize("fmt", ["parquet", "csv"])
def test_encode_fault_read_is_served_alike(files, fmt):
    """An injected ``io.encode`` fault sends one column the plain way;
    that read is what the cache keeps (as in the JAX package), and its
    hit gives the same rows as a clean read."""
    from spark_rapids_tpu_torch import faults
    s = _session({"spark.rapids.faults.io.encode": "count:1"})
    try:
        before = tenc.compressed_stats()["encode_faults"]
        faulted = _read(s, fmt, files[fmt]).to_arrow()
        assert tenc.compressed_stats()["encode_faults"] == before + 1
        faults.reset()
        hit = _read(s, fmt, files[fmt]).to_arrow()
        assert _port_scan(s, ("scanCacheHits",)) == (1,)
        clean = _read(_session(OFF), fmt, files[fmt]).to_arrow()
        assert faulted.equals(clean) and hit.equals(clean)
        want = _read(tpu_session(OFF), fmt, files[fmt]).to_arrow()
        assert_tables_equal(hit, want, ignore_order=False)
    finally:
        s.stop()


def _planes(batches):
    from spark_rapids_tpu_torch.columnar.encoding import stored_planes
    return [[(type(c).__name__, stored_planes(c)) for c in b.columns]
            for b in batches]


def _same_planes(a, b):
    assert len(a) == len(b)
    for ba, bb in zip(a, b):
        for (ka, (pa_, da, kda)), (kb, (pb, db, kdb)) in zip(ba, bb):
            assert ka == kb and kda == kdb
            assert (da is None) == (db is None)
            for x, y in zip(pa_, pb):
                assert (x is None) == (y is None)
                if x is not None:
                    assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("tier", ["host", "disk"])
def test_every_column_kind_spills_and_comes_back(files, tier):
    s = _session({"spark.rapids.sql.reader.batchSizeRows": "2048"})
    try:
        df = _read(s, "parquet", files["parquet"])
        first = _planes(df.to_device_batches())
        kinds = {k for b in first for k, _ in b}
        assert {"EncodedColumn", "RleColumn", "DeltaColumn",
                "PackedBoolColumn", "DeviceColumn"} <= kinds
        assert any(p[0][2] is not None for b in first for k, p in b
                   if k == "DeviceColumn")  # a char matrix rides plain
        cat = s.runtime.catalog
        if tier == "disk":
            cat.host_budget = 0
        cat.spill_all()
        ent = next(iter(_cache(s)._entries.values()))
        assert {h.tier for h in ent.handles} == {tier}
        assert ent.tier_bytes("device") == 0
        got = df.to_device_batches()
        assert _port_scan(s, ("scanCacheHits",)) == (1,)
        assert all(b.device == s.runtime.device for b in got)
        assert {h.tier for h in ent.handles} == {TIER_DEVICE}
        _same_planes(_planes(got), first)
        assert cat.stats()["unspill_count"] >= len(ent.handles)
    finally:
        s.stop()


@pytest.mark.parametrize("fmt", FORMATS)
def test_budget_demotes_the_entry_before_the_query(fmt, files):
    """A device budget below the entry's bytes: the entry (the lowest
    priority) goes to the host and the disk first, and its hit returns
    the same rows and encodings, against the JAX package's."""
    conf = {"spark.rapids.memory.tpu.budgetBytes": str(96 * 1024),
            "spark.rapids.memory.host.spillStorageSize": str(64 * 1024),
            "spark.rapids.sql.reader.batchSizeRows": "1024"}
    s = _session(conf)
    try:
        q = _query(TF, _read(s, fmt, files[fmt]), fmt)
        kinds_first = _kinds(s, fmt, files[fmt])
        first = q.to_arrow()
        cat = s.runtime.catalog
        assert cat.stats()["spill_to_host_count"] > 0
        hit = q.to_arrow()
        assert _port_scan(s, ("scanCacheHits",)) == (1,)
        assert hit.equals(first)
        assert _kinds(s, fmt, files[fmt]) == kinds_first
        assert cat.stats()["unspill_count"] > 0
        want = _query(JF, _read(tpu_session(), fmt, files[fmt]),
                      fmt).to_arrow()
        assert_tables_equal(hit, want, ignore_order=False)
    finally:
        s.stop()


# ---------------------------------------------------------------------------
# the _version guard
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("where", ["device", "demoted"])
def test_version_guard_raises_on_a_write_in_place(files, where):
    s = _session()
    try:
        df = _read(s, "parquet", files["parquet"])
        want = df.to_arrow()
        ent = next(iter(_cache(s)._entries.values()))
        b = ent.handles[0].get()
        v = b.columns[b.schema.field_index("v")]
        v.data.mul_(2.0)          # what no operator may do to its input
        if where == "demoted":
            s.runtime.catalog.spill_all()
        with pytest.raises(CachedBatchWrittenError):
            df.to_arrow()
        # the written entry is dropped, not read again: the next read is
        # a miss and reads the file
        assert _cache(s).stats()["entries"] == 0
        got = df.to_arrow()
        assert _port_scan(s, ("scanCacheHits",)) == (0,)
        assert got.equals(want)
    finally:
        s.stop()


def _write_everything(how, df):
    """Hand the read's result out by ``how`` and write into every tensor
    handed out, as a caller of the API may."""
    if how in ("to_torch_add", "to_torch_numpy"):
        cols, masks, _ = df.to_torch()
        out = [t for c in cols.values()
               for t in (c if isinstance(c, tuple) else (c,))]
        out += list(masks.values())
    else:
        out = []
        for b in df.to_device_batches():
            for c in b.columns:
                planes, dct, _ = tenc.stored_planes(c)
                out += [a for a in planes if a is not None]
                if dct is not None:
                    out += [dct.lengths, dct.chars, dct.validity]
    for t in out:
        if how == "to_torch_numpy":
            t.numpy()[...] = 0        # no version counter sees this
        else:
            t.copy_(torch.zeros_like(t))


@pytest.mark.parametrize("how", ["to_torch_add", "to_torch_numpy",
                                 "device_batches"])
@pytest.mark.parametrize("fmt", FORMATS)
def test_results_handed_out_are_not_the_cached_planes(files, fmt, how):
    """``to_torch`` and ``to_device_batches`` hand out copies of the
    planes the cache holds: a write into them, counted by torch or
    through numpy, leaves every later read of the file with the file's
    values, served by the cache."""
    s = _session()
    try:
        df = _read(s, fmt, files[fmt])
        want = _read(tpu_session(OFF), fmt, files[fmt]).to_arrow()
        for run in range(2):      # the miss, then the hit
            _write_everything(how, df)
            assert _port_scan(s, ("scanCacheHits",)) == (run,)
        got = df.to_arrow()
        assert _port_scan(s, ("scanCacheHits",)) == (1,)
        assert_tables_equal(got, want, ignore_order=False)
        _only_the_cache_registered(s)
    finally:
        s.stop()


FAMILIES = {
    "project_filter": lambda F, df: df.filter(F.col("v") > 0.1).select(
        "id", (F.col("v") * 2).alias("v2"), "s"),
    "agg": lambda F, df: df.group_by("s").agg(
        F.count(F.col("v")).alias("n"), F.sum(F.col("v")).alias("sv"),
        F.min(F.col("c")).alias("mc")).order_by("s"),
    "agg_int_key": lambda F, df: df.group_by("k").agg(
        F.sum(F.col("id")).alias("si"), F.max(F.col("v")).alias("mv"))
        .order_by("k"),
    "sort": lambda F, df: df.order_by(F.col("c").desc()).limit(50),
    "strings": lambda F, df: df.filter(F.col("c").contains("12")).select(
        "c", F.length(F.col("c")).alias("n")),
    "window": lambda F, df: df.with_column(
        "r", F.row_number().over(
            st.Window.partition_by("s").order_by("id"))).filter(
                F.col("r") <= 3),
    "join": lambda F, df: df.join(
        df.group_by("s").agg(F.avg(F.col("v")).alias("av")), "s").filter(
            F.col("v") > F.col("av")).select("id", "s"),
    "flag": lambda F, df: df.filter(F.col("f")).group_by("k").agg(
        F.count(F.col("id")).alias("n")).order_by("k"),
}


@pytest.mark.parametrize("fmt", FORMATS)
def test_every_query_family_twice_equals_the_key_off(files, fmt):
    """Each family of queries twice over one cached table (a write in
    place into a cached batch would raise or change the second run),
    against a session with the key off."""
    on, off = _session(), _session(OFF)
    try:
        for name, build in FAMILIES.items():
            want = build(TF, _read(off, fmt, files[fmt])).to_arrow()
            for run in range(2):
                hits = _cache(on).stats()["hits"]
                got = build(TF, _read(on, fmt, files[fmt])).to_arrow()
                assert got.equals(want), name
            # the second run is served by the cache (a pushed filter
            # keys an entry of its own)
            assert _cache(on).stats()["hits"] > hits, name
        stats = _cache(on).stats()
        assert stats["misses"] == stats["entries"]
    finally:
        on.stop()
        off.stop()


# ---------------------------------------------------------------------------
# concurrency
# ---------------------------------------------------------------------------

def test_concurrent_misses_keep_one_entry_and_leak_nothing(files):
    s = _session({"spark.rapids.sql.reader.batchSizeRows": "1000"})
    try:
        want = _read(_session(OFF), "csv", files["csv"]).to_arrow()
        gate = threading.Barrier(4)
        out, errs = [None] * 4, []

        def run(i):
            try:
                gate.wait()
                out[i] = _read(s, "csv", files["csv"]).to_arrow()
            except BaseException as e:   # noqa: BLE001 (reported below)
                errs.append(e)
        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errs
        assert all(t.equals(want) for t in out)
        stats = _cache(s).stats()
        assert stats["entries"] == 1
        assert stats["handles"] == 6
        _only_the_cache_registered(s)
    finally:
        s.stop()


def test_server_clients_over_one_csv(files):
    s = _session()
    try:
        q = ("SELECT s, COUNT(*) AS n, SUM(v) AS sv FROM t GROUP BY s "
             "ORDER BY s")
        _read(s, "csv", files["csv"]).create_or_replace_temp_view("t")
        serial = s.sql(q).to_arrow()
        server = s.server(max_concurrency=4)
        try:
            tickets = [server.submit(q, use_cache=False) for _ in range(8)]
            for tk in tickets:
                assert tk.result(timeout=120).to_arrow().equals(serial)
        finally:
            server.close()
        assert _cache(s).stats()["entries"] == 1
        assert _cache(s).stats()["hits"] >= 8
    finally:
        s.stop()


def test_eviction_under_a_reader_closes_after_it(tmp_path):
    t = _table(3000)
    paths = [_write("parquet", str(tmp_path / f"r{i}.parquet"), t)
             for i in range(9)]
    s = _session({"spark.rapids.sql.reader.batchSizeRows": "1000"})
    try:
        want = _read(s, "parquet", paths[0]).to_arrow()
        # a reader holds the entry of paths[0] while eight other reads
        # evict it
        from spark_rapids_tpu_torch.exec.base import ExecContext
        from spark_rapids_tpu_torch.plan.planner import plan_query
        scan = _leaf(plan_query(_read(s, "parquet", paths[0]).plan,
                                s.conf))
        stream = scan.execute(ExecContext(s.conf, s.device))
        held = [next(stream)]
        for p in paths[1:]:
            _read(s, "parquet", p).to_arrow()
        assert all(os.path.basename(k[1][0][0]) != "r0.parquet"
                   for k in _cache(s).keys())
        # the evicted entry's planes count as shared while it is read
        # (the API copies them), and no longer once it is closed
        read = {a.untyped_storage().data_ptr()
                for a in tenc.stored_planes(held[0].columns[0])[0]
                if a is not None}
        assert read <= _cache(s).storages()
        held += list(stream)
        assert not read & _cache(s).storages()
        assert sum(b.num_rows for b in held) == want.num_rows
        _only_the_cache_registered(s)
    finally:
        s.stop()


# ---------------------------------------------------------------------------
# a standing aggregate over a tailed CSV root
# ---------------------------------------------------------------------------

def _rows(result):
    table = result if isinstance(result, pa.Table) else result.to_arrow()
    return sorted(map(tuple, (r.values() for r in table.to_pylist())),
                  key=lambda t: tuple((x is None, str(x)) for x in t))


def _part(rng, n):
    return pa.table({"g": pa.array(rng.choice(["a", "b", "c", "d"], n)),
                     "v": pa.array(rng.integers(-50, 50, n)
                                   .astype(np.float64) + 0.5)})


def test_tailed_csv_root_ticks_hit_and_equal_a_recompute(tmp_path):
    from spark_rapids_tpu_torch.stream import stats as stream_stats
    fact = str(tmp_path / "fact")
    os.makedirs(fact)
    rng = np.random.default_rng(9)
    pacsv.write_csv(_part(rng, 300), os.path.join(fact, "part-0.csv"))
    agg = ("SELECT g, SUM(v) AS sv, COUNT(*) AS c, MIN(v) AS mn "
           "FROM fact GROUP BY g")
    agg2 = "SELECT g, MAX(v) AS mx FROM fact GROUP BY g"
    conf = {"spark.rapids.server.enabled": "true",
            "spark.rapids.stream.enabled": "true",
            "spark.rapids.stream.pollIntervalMs": "60000"}
    stream_stats.reset()
    s = _session(conf)
    off = _session(OFF)
    js = jst.TpuSession(conf)
    try:
        for sess in (s, off, js):
            sess.read.csv(fact).create_or_replace_temp_view("fact")
        server, jserver = s.server(max_concurrency=2), \
            js.server(max_concurrency=2)
        try:
            reg, jreg = server.streaming, jserver.streaming
            reg.register_source(fact, "csv")
            jreg.register_source(fact, "csv")
            qa, qb = reg.register(agg, name="agg"), \
                reg.register(agg2, name="agg2")
            ja = jreg.register(agg, name="agg")
            assert qa.incremental and qb.incremental
            for step in range(3):
                pacsv.write_csv(_part(rng, int(rng.integers(50, 200))),
                                os.path.join(fact, f"part-{step + 1}.csv"))
                hits = _cache(s).stats()["hits"]
                assert reg.tick() == 1 and jreg.tick() == 1
                # both standing queries read the tick's new file: the
                # second read is a hit
                assert _cache(s).stats()["hits"] > hits
                want = _rows(off.sql(agg))
                assert _rows(qa.result()) == want == _rows(s.sql(agg))
                assert _rows(qa.result()) == _rows(ja.result())
                assert _rows(qb.result()) == _rows(off.sql(agg2))
            # a grown file rides as an in-memory tail; the full recompute
            # misses (the file's identity changed) and reads it whole
            with open(os.path.join(fact, "part-1.csv"), "a") as f:
                f.write('"a",1000.5\n')
            assert reg.tick() == 1 and jreg.tick() == 1
            assert stream_stats.global_stats()["batch_grown"] == 1
            assert _rows(qa.result()) == _rows(off.sql(agg)) == \
                _rows(s.sql(agg)) == _rows(ja.result())
        finally:
            server.close()
            jserver.close()
    finally:
        s.stop()
        off.stop()
        js.stop()
