"""The transfer path (``columnar/transfer.py``, the staging limiters,
``maybe_prefetch`` and ``pipelined_scan``) in the torch port against the
JAX package, on the CPU.

* ``transfer_bucket`` and ``bitpack_plane`` / ``bitunpack_host`` bit for
  bit over seeded inputs;
* ``pack_and_pull`` against the JAX ``pack_and_pull`` on the same batches
  (a parquet scan of a table of every type: int8 to int64, DATE,
  TIMESTAMP, DOUBLE, BOOLEAN, plain and dictionary strings, RLE, delta
  and packed columns, nulls, an all-null int column, in three batches;
  with an empty batch; only empty batches; none), the threshold at 0
  and at 1 GiB: the values, and ``d2h_stats``' pulls, wire bytes and
  raw bytes exactly;
* ``HostStagingLimiter`` step by step against the JAX class;
* ``pipelined_h2d`` / ``pipelined_d2h``: order, dispatch ahead, upstream
  closed on a consumer error, on equal to off, and against the JAX
  loops;
* the local, parquet, ORC and CSV scans with prefetch on and off: the
  same batches in the same order, equal to the JAX session's result,
  also at ``concurrentTasks=1`` with prefetch on under a deadline;
* an injected ``transfer.d2h`` failure raises what the JAX package
  raises; a query's ``d2hPulls`` equal the JAX ``DeviceToHostExec``'s;
  the registry's ``prefetch`` and ``d2h`` sections and histograms.

Tolerances: none; every comparison is exact.  Inputs are made from
seeds with numpy.
"""

import threading
import time

import numpy as np
import pyarrow as pa
import pyarrow.csv as pacsv
import pyarrow.orc as paorc
import pyarrow.parquet as pq
import pytest
import torch

import spark_rapids_tpu_torch as st
from spark_rapids_tpu import faults as jfaults
from spark_rapids_tpu import lifecycle as jlife
from spark_rapids_tpu.columnar import transfer as jtr
from spark_rapids_tpu.memory.spill import HostStagingLimiter as JLimiter
from spark_rapids_tpu_torch import faults as tfaults
from spark_rapids_tpu_torch import functions as TF
from spark_rapids_tpu_torch import lifecycle as tlife
from spark_rapids_tpu_torch.columnar import encoding as tenc
from spark_rapids_tpu_torch.columnar import transfer as ttr
from spark_rapids_tpu_torch.columnar.batch import device_batch_to_host, \
    host_batch_to_device, host_columns_from_arrow, host_columns_to_arrow
from spark_rapids_tpu_torch.errors import QueryCancelledError, \
    QueryTimeoutError
from spark_rapids_tpu_torch.io import prefetch as tpre
from spark_rapids_tpu_torch.memory.spill import HostStagingLimiter
from spark_rapids_tpu_torch.obs import registry as treg
from spark_rapids_tpu_torch.runtime import TorchRuntime
from spark_rapids_tpu import functions as JF
from tests.compare import assert_tables_equal, tpu_session
from tests.torch_threads import _one_torch_thread  # noqa: F401

CPU = {"spark.rapids.torch.device": "cpu"}
# the JAX scan cache off, so that each JAX scan ingests afresh; small
# reader batches, so that a scan yields several
BASE = {"spark.rapids.sql.compressed.enabled": "true",
        "spark.rapids.sql.scan.deviceCacheEnabled": "false",
        "spark.rapids.sql.reader.batchSizeRows": "2048"}
PREFETCH = {"true": {**BASE, "spark.rapids.sql.io.prefetch.enabled": "true"},
            "false": {**BASE,
                      "spark.rapids.sql.io.prefetch.enabled": "false"}}
N = 6000


def _ts(conf=None):
    return st.TorchSession({**CPU, **(BASE if conf is None else conf)})


def _js(conf=None):
    return tpu_session(dict(BASE if conf is None else conf))


def _table(n: int = N, seed: int = 17) -> pa.Table:
    """Every type the pack plans: small and wide integers, dates,
    timestamps, doubles and booleans with nulls, a plain and a
    dictionary string column, an RLE (sorted runs) and a delta (a small
    step cumsum, no nulls) column, and an all-null int column."""
    rng = np.random.default_rng(seed)
    nulls = rng.random(n) < 0.1
    words = [f"w{i:03d}" for i in range(12)]
    return pa.table({
        "i8": pa.array(rng.integers(-100, 100, n).astype(np.int8),
                       mask=nulls),
        "i16": pa.array(rng.integers(-3000, 30000, n).astype(np.int16)),
        "i32": pa.array(rng.integers(-2 ** 31, 2 ** 31 - 1, n)
                        .astype(np.int32), mask=nulls),
        "i64": pa.array(rng.integers(-2 ** 60, 2 ** 60, n)),
        "d": pa.array(rng.integers(8000, 11000, n).astype(np.int32),
                      pa.date32()),
        "ts": pa.array(rng.integers(0, 10 ** 15, n), pa.timestamp("us")),
        "f": pa.array(rng.normal(size=n), mask=rng.random(n) < 0.2),
        "b": pa.array(rng.random(n) < 0.4, mask=rng.random(n) < 0.1),
        "s": pa.array([None if i % 17 == 0 else
                       f"text-{int(x)}-{'x' * (int(x) % 23)}"
                       for i, x in enumerate(rng.integers(0, 10 ** 6, n))]),
        "e": pa.array([None if i % 11 == 0 else words[int(x)] for i, x in
                       enumerate(rng.integers(0, len(words), n))]),
        "r": pa.array(np.sort(rng.integers(0, 40, n)).astype(np.int64)),
        "q": pa.array(np.cumsum(rng.integers(0, 3, n)).astype(np.int32)),
        "z": pa.nulls(n, pa.int32()),
    })


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("ttransfer")
    t = _table()
    out = {"table": t, "parquet": str(d / "t.parquet"),
           "orc": str(d / "t.orc"), "csv": str(d / "t.csv")}
    pq.write_table(t, out["parquet"], row_group_size=1000)
    paorc.write_table(t, out["orc"])
    # the CSV scans read what pyarrow writes, less the all-null column
    # (pyarrow infers it as its null type, which both packages refuse)
    # and the naive timestamps (which the JAX CSV scan refuses,
    # ROADMAP.md C)
    pacsv.write_csv(t.drop_columns(["z", "ts"]), out["csv"])
    return out


@pytest.fixture(autouse=True)
def _reset():
    tenc.clear_memo()
    yield
    tfaults.reset()
    jfaults.reset()


def _jd2h():
    s = jtr.d2h_stats()
    return {k: s[k] for k in ("pulls", "wire_bytes", "raw_bytes")}


def _td2h():
    s = ttr.d2h_stats()
    return {k: s[k] for k in ("pulls", "wire_bytes", "raw_bytes")}


def _delta(after, before):
    return {k: after[k] - before[k] for k in after}


# ---------------------------------------------------------------------------
# transfer_bucket, bitpack
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 31, 32, 33, 40, 41, 47, 48,
                               63, 64, 65, 100, 1000, 1023, 1024, 1025,
                               5000, 6000, (1 << 20) + 1])
def test_transfer_bucket_matches_jax(n):
    assert ttr.transfer_bucket(n) == jtr.transfer_bucket(n)


@pytest.mark.parametrize("cap", [8, 64, 4096])
def test_bitpack_plane_matches_jax(cap):
    import jax.numpy as jnp
    bits = np.random.default_rng(cap).random(cap) < 0.5
    got = ttr.bitpack_plane(torch.from_numpy(bits)).numpy()
    want = np.asarray(jtr.bitpack_plane(jnp.asarray(bits)))
    assert got.dtype == np.uint8 and np.array_equal(got, want)
    assert np.array_equal(ttr.bitunpack_host(got, cap),
                          jtr.bitunpack_host(want, cap))
    assert np.array_equal(ttr.bitunpack_host(got, cap), bits)
    assert np.array_equal(
        ttr.bitunpack_plane(torch.from_numpy(got), cap).numpy(), bits)


# ---------------------------------------------------------------------------
# the pack
# ---------------------------------------------------------------------------

def _batches(paths, case):
    """(port batches, JAX batches, port schema, JAX schema) of a case,
    on the CPU, built the same way in both packages."""
    from spark_rapids_tpu.columnar.batch import \
        host_batch_to_device as jh2d
    from spark_rapids_tpu.columnar.dtypes import Schema as JSchema
    tdf = _ts().read.parquet(paths["parquet"])
    jdf = _js().read.parquet(paths["parquet"])
    tschema, jschema = tdf.plan.output_schema(), jdf.plan.output_schema()
    tb, jb = [], []
    if case in ("scan", "scan_and_empty"):
        tb, jb = tdf.to_device_batches(), jdf.to_device_batches()
        assert len(tb) == len(jb) == 3
    if case in ("scan_and_empty", "empty"):
        t0 = paths["table"].slice(0, 0)
        _, cols = host_columns_from_arrow(t0)
        tb.insert(0, host_batch_to_device(tschema, cols, "cpu"))
        jb.insert(0, jh2d(t0.to_batches()[0] if t0.to_batches() else
                          pa.RecordBatch.from_arrays(
                              [pa.array([], f.type) for f in t0.schema],
                              schema=t0.schema),
                          JSchema.from_arrow(t0.schema)))
    return tb, jb, tschema, jschema


@pytest.fixture
def jax_int_like(monkeypatch):
    """The JAX pack as its docstring describes it: its ``_int_like``
    tests the names ``int8`` to ``int64``, which its own integer types
    do not carry (``byte``, ``short``, ``int``, ``long``), so as it
    stands it narrows only DATE and TIMESTAMP columns (ROADMAP.md C).
    The port narrows every int-like column; the reference is held to
    that here, its compiled stats and pack kernels dropped around it."""
    names = {"byte", "short", "int", "long", "date", "timestamp"}
    jtr._STATS_CACHE.clear()
    jtr._PACK_CACHE.clear()
    monkeypatch.setattr(jtr, "_int_like", lambda dt: dt.name in names)
    yield
    jtr._STATS_CACHE.clear()
    jtr._PACK_CACHE.clear()


@pytest.mark.parametrize("threshold", [0, 1 << 30])
@pytest.mark.parametrize("case", ["scan", "scan_and_empty", "empty",
                                  "none"])
def test_pack_and_pull_matches_jax(paths, case, threshold, jax_int_like):
    tb, jb, tschema, jschema = _batches(paths, case)
    if case == "scan":
        kinds = {type(c).__name__ for b in tb for c in b.columns}
        assert {"EncodedColumn", "RleColumn", "DeltaColumn",
                "PackedBoolColumn", "DeviceColumn"} <= kinds
    jb0, tb0 = _jd2h(), _td2h()
    want = jtr.pack_and_pull(jb, jschema, threshold)
    jd = _delta(_jd2h(), jb0)
    got = ttr.pack_and_pull(tb, tschema, threshold)
    td = _delta(_td2h(), tb0)
    assert td == jd, (td, jd)
    want_pulls = 0 if case == "none" else (2 if threshold == 0 else 1)
    assert td["pulls"] == want_pulls
    rows = sum(b.num_rows for b in tb)
    assert all(len(v) == rows for _, v in got.values())
    assert_tables_equal(host_columns_to_arrow(tschema, got),
                        pa.Table.from_batches([want]), ignore_order=False)


def test_pack_narrows_and_trims(paths):
    """Above the threshold the stats narrow each int-like column to the
    JAX plan's store and trim the strings (wire < raw); below it the
    planes ride whole."""
    tb, _, tschema, _ = _batches(paths, "scan")
    pend = ttr.pack_dispatch(tb, tschema, 0)
    stores = {f.name: p.store for f, p in zip(tschema, pend.plans)}
    assert stores["i8"] == "uint8" and stores["r"] == "uint8"
    assert stores["d"] == "uint16" and stores["i32"] == "uint32"
    assert stores["i64"] is None and stores["f"] is None
    assert stores["e"] == "uint8"
    before = _td2h()
    ttr.pack_finish(pend)
    assert _td2h()["pulls"] == before["pulls"] + 1
    small = ttr.pack_dispatch(tb, tschema, 1 << 30)
    assert all(p.store is None for f, p in zip(tschema, small.plans)
               if f.name != "e")


# ---------------------------------------------------------------------------
# the staging limiters
# ---------------------------------------------------------------------------

def _limiter_trace(cls, steps):
    lim = cls(100, name="")
    out = []
    for op, arg in steps:
        if op == "acquire":
            out.append(lim.acquire(arg, abort=lambda: True))
        else:
            lim.release(arg)
            out.append(lim._inflight)
    return out


@pytest.mark.parametrize("steps", [
    [("acquire", 40), ("acquire", 60), ("acquire", 1), ("release", 60),
     ("acquire", 1)],
    [("acquire", 500), ("acquire", 1), ("release", 100), ("acquire", 100)],
    [("acquire", 0), ("acquire", 100), ("release", 100), ("acquire", 30)],
])
def test_staging_limiter_matches_jax(steps):
    """Clamped grants, a blocked acquire that aborts (-1, nothing held),
    release accounting: step for step the JAX class's."""
    assert _limiter_trace(HostStagingLimiter, steps) == \
        _limiter_trace(JLimiter, steps)


def test_staging_limiter_cap_zero_grants_at_once():
    for cls in (HostStagingLimiter, JLimiter):
        lim = cls(0)
        assert lim.acquire(1 << 40, abort=lambda: False) == 0
        with lim.limit(1 << 40):
            pass


def test_staging_limiter_wait_is_released_and_recorded():
    treg.reset_histograms()
    lim = HostStagingLimiter(10, name="egress")
    assert lim.acquire(10) == 10
    got = []
    t = threading.Thread(target=lambda: got.append(lim.acquire(5)))
    t.start()
    time.sleep(0.2)
    assert got == []
    lim.release(10)
    t.join(timeout=10)
    assert not t.is_alive() and got == [5]
    assert lim.wait_count == 1
    assert treg.histogram_snapshots()["staging.egress.wait.us"]["count"] == 1


@pytest.mark.parametrize("kind", ["cancel", "deadline"])
def test_staging_limit_raises_typed_on_cancel(kind):
    """A wait the query's cancel or deadline ends raises the typed error,
    as the JAX package's does."""
    from spark_rapids_tpu import errors as jerr
    want = {"cancel": (QueryCancelledError, jerr.QueryCancelledError),
            "deadline": (QueryTimeoutError, jerr.QueryTimeoutError)}[kind]
    for cls, life, exc in ((HostStagingLimiter, tlife, want[0]),
                           (JLimiter, jlife, want[1])):
        lim = cls(10)
        lim.acquire(10, abort=lambda: False)
        with life.query_scope(timeout_ms=1 if kind == "deadline"
                              else None) as qc:
            if kind == "cancel":
                qc.cancel("stop")
            else:
                time.sleep(0.01)
            with pytest.raises(exc):
                with lim.limit(5):
                    pass


def test_pinned_pool_caps_the_three_limiters(paths):
    TorchRuntime.reset()
    try:
        conf = {**BASE, "spark.rapids.memory.pinnedPool.size": str(64 << 20)}
        s = _ts(conf)
        cat = s.runtime.catalog
        assert cat.staging.cap == cat.prefetch_staging.cap == \
            cat.egress_staging.cap == 64 << 20
        assert (cat.staging.name, cat.prefetch_staging.name,
                cat.egress_staging.name) == ("spill", "prefetch", "egress")
        got = s.read.parquet(paths["parquet"]).to_arrow()
        TorchRuntime.reset()
        off = _ts({**conf, "spark.rapids.memory.tpu.pooling.enabled":
                   "false"})
        assert off.runtime.catalog.staging.cap == 0
        assert got.equals(off.read.parquet(paths["parquet"]).to_arrow())
    finally:
        TorchRuntime.reset()


# ---------------------------------------------------------------------------
# the double-buffered loops
# ---------------------------------------------------------------------------

class _Item:
    __slots__ = ("v", "ready")

    def __init__(self, v):
        self.v = v
        self.ready = None


def test_pipelined_h2d_dispatches_ahead_and_keeps_order():
    rt = TorchRuntime.get_or_create(_ts().conf, torch.device("cpu"))
    uploaded = []

    def upload(i):
        uploaded.append(i)
        return _Item(i)

    seen = []
    for item in ttr.pipelined_h2d(iter(range(10)), upload, rt, None, True):
        # batch k + 1's upload went out before batch k was yielded
        assert uploaded[-1] == min(item.v + 1, 9)
        seen.append(item.v)
    assert seen == list(range(10))
    serial = [i.v for i in ttr.pipelined_h2d(iter(range(10)),
                                             lambda i: _Item(i), rt, None,
                                             False)]
    assert serial == seen


@pytest.mark.parametrize("enabled", [True, False])
def test_pipelined_d2h_matches_jax(enabled):
    got = list(ttr.pipelined_d2h(iter(range(20)), lambda i: i * 3,
                                 lambda i: i + 1, enabled=enabled))
    want = list(jtr.pipelined_d2h(iter(range(20)), lambda i: i * 3,
                                  lambda i: i + 1, enabled=enabled))
    assert got == want == [i * 3 + 1 for i in range(20)]


def test_pipelined_d2h_finishes_after_next_dispatch():
    dispatched, finished = [], []

    def fin(i):
        if i < 19:
            assert (i + 1) in dispatched
        finished.append(i)
        return i

    list(ttr.pipelined_d2h(iter(range(20)),
                           lambda i: dispatched.append(i) or i, fin,
                           enabled=True))
    assert dispatched == finished == list(range(20))


@pytest.mark.parametrize("enabled", [True, False])
@pytest.mark.parametrize("loop", ["h2d", "d2h"])
def test_loops_close_upstream_on_consumer_error(loop, enabled):
    closed = []

    def src():
        try:
            yield from range(100)
        finally:
            closed.append(True)

    if loop == "h2d":
        rt = TorchRuntime.get_or_create(_ts().conf, torch.device("cpu"))
        it = ttr.pipelined_h2d(src(), _Item, rt, None, enabled)
    else:
        it = ttr.pipelined_d2h(src(), lambda i: i, _Item, enabled=enabled)
    with pytest.raises(ZeroDivisionError):
        for item in it:
            if item.v == 3:
                1 / 0
    it.close()
    assert closed == [True]


def test_prefetch_grants_are_released_and_bounded():
    """The JAX grant model: an item's grant is held until the consumer
    pulls the next one, at most depth + 2 grants are ever held, and
    close returns every one."""
    lim = HostStagingLimiter(1 << 20)
    peak = []
    held = lambda: lim._inflight // 10  # noqa: E731

    def src():
        for i in range(30):
            peak.append(held())
            yield i

    it = tpre.PrefetchIterator(src(), depth=2, limiter=lim,
                               nbytes=lambda i: 10)
    out = []
    for i in it:
        assert held() >= 1  # the item in hand is still admitted
        out.append(i)
        time.sleep(0.002)
    assert out == list(range(30))
    assert max(peak) <= 2 + 2
    assert lim._inflight == 0
    it2 = tpre.PrefetchIterator(iter(range(30)), depth=2, limiter=lim,
                                nbytes=lambda i: 10)
    next(it2)
    it2.close()
    assert lim._inflight == 0


# ---------------------------------------------------------------------------
# the scans through pipelined_scan
# ---------------------------------------------------------------------------

def _read(s, fmt, paths):
    if fmt == "local":
        return s.create_dataframe(paths["table"])
    return getattr(s.read, fmt)(paths[fmt])


def _small_units(monkeypatch):
    """Several host items a scan: the local scan's slices and the CSV
    scan's byte ranges made small."""
    from spark_rapids_tpu_torch.exec import basic as tbasic
    from spark_rapids_tpu_torch.io import csv as tcsv
    monkeypatch.setattr(tbasic, "BATCH_ROWS", 2048)
    monkeypatch.setattr(tcsv, "RANGE_BYTES", 64 << 10)


def _host_batches(df):
    return [device_batch_to_host(b) for b in df.to_device_batches()]


def _same_host(a, b) -> bool:
    if a.keys() != b.keys():
        return False
    for name in a:
        (av, am), (bv, bm) = a[name], b[name]
        if not np.array_equal(am, bm):
            return False
        if hasattr(av, "chars"):
            if not (np.array_equal(av.lengths, bv.lengths)
                    and np.array_equal(av.chars, bv.chars)):
                return False
        elif not np.array_equal(av, bv, equal_nan=av.dtype.kind == "f"):
            return False
    return True


@pytest.mark.parametrize("fmt", ["local", "parquet", "orc", "csv"])
def test_scan_prefetch_on_equals_off_and_jax(paths, fmt, monkeypatch):
    _small_units(monkeypatch)
    on = _host_batches(_read(_ts(PREFETCH["true"]), fmt, paths))
    off = _host_batches(_read(_ts(PREFETCH["false"]), fmt, paths))
    assert len(on) == len(off) > 1
    assert all(_same_host(a, b) for a, b in zip(on, off))
    got = _read(_ts(PREFETCH["true"]), fmt, paths).to_arrow()
    want = _read(_js(PREFETCH["true"]), fmt, paths).to_arrow()
    assert_tables_equal(got, want, ignore_order=False)


@pytest.mark.parametrize("fmt", ["local", "parquet", "csv"])
def test_scan_prefetch_counts_overlap_and_batches(paths, fmt, monkeypatch):
    _small_units(monkeypatch)
    tpre.reset_global_stats()
    s = _ts(PREFETCH["true"])
    df = _read(s, fmt, paths)
    df.to_arrow()
    scan = s._last_plan
    while scan.children:
        scan = scan.children[0]
    assert int(scan.metrics["prefetchBatches"]) > 1
    assert int(scan.metrics["h2dOverlapMs"]) >= 0
    assert tpre.global_stats()["batches"] >= int(
        scan.metrics["prefetchBatches"])


def test_concurrent_tasks_one_with_prefetch_finishes(paths):
    """At one permit, with prefetch on, a grouped query (the coalesce's
    background pull over a pipelined scan) ends under a deadline."""
    TorchRuntime.reset()
    conf = {**PREFETCH["true"], "spark.rapids.tpu.concurrentTasks": "1",
            "spark.rapids.sql.queryTimeoutMs": "120000"}
    box = {}

    def run():
        s = _ts(conf)
        box["got"] = s.read.parquet(paths["parquet"]).group_by(
            TF.col("e")).agg(TF.sum(TF.col("i64")).alias("x"),
                             TF.count(TF.col("f")).alias("n")) \
            .order_by(TF.col("e")).to_arrow()

    try:
        t = threading.Thread(target=run, daemon=True)
        t.start()
        t.join(timeout=120)
        assert not t.is_alive(), "the query did not finish at one permit"
        want = _js(PREFETCH["true"]).read.parquet(paths["parquet"]) \
            .group_by(JF.col("e")).agg(JF.sum(JF.col("i64")).alias("x"),
                                       JF.count(JF.col("f")).alias("n")) \
            .order_by(JF.col("e")).to_arrow()
        assert_tables_equal(box["got"], want, ignore_order=False)
    finally:
        TorchRuntime.reset()


# ---------------------------------------------------------------------------
# the egress: faults, pull counts, the registry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pack", ["true", "false"])
def test_injected_d2h_failure_raises_as_jax(paths, pack):
    conf = {**BASE, "spark.rapids.sql.transfer.pack.enabled": pack,
            "spark.rapids.faults.transfer.d2h": "always"}
    with pytest.raises(tfaults.InjectedFault) as te:
        _ts(conf).read.parquet(paths["parquet"]).to_arrow()
    with pytest.raises(jfaults.InjectedFault) as je:
        _js(conf).read.parquet(paths["parquet"]).to_arrow()
    assert te.value.site == je.value.site == "transfer.d2h"
    assert issubclass(type(te.value), IOError) and \
        issubclass(type(je.value), IOError)


def _jax_pulls(s) -> int:
    return int(s._last_plan_result.physical.metrics["d2hPulls"].value)


@pytest.mark.parametrize("threshold", [str(1 << 30), "1"])
@pytest.mark.parametrize("query", ["rows", "group_by"])
def test_query_d2h_pulls_match_jax(paths, query, threshold):
    conf = {**BASE, "spark.rapids.sql.transfer.pack.enabled": "true",
            "spark.rapids.sql.transfer.statsThresholdBytes": threshold}

    def build(s, F):
        df = s.read.parquet(paths["parquet"])
        if query == "group_by":
            return df.group_by(F.col("e")).agg(
                F.sum(F.col("i16")).alias("x"))
        return df.select(F.col("i32"), F.col("s"), F.col("d"))

    ts, js = _ts(conf), _js(conf)
    got = build(ts, TF).to_arrow()
    want = build(js, JF).to_arrow()
    assert_tables_equal(got, want)
    pulls = int(ts._last_plan.metrics["d2hPulls"])
    assert pulls == _jax_pulls(js) == (1 if threshold != "1" else 2)
    assert int(ts._last_plan.metrics["d2hBytes"]) > 0


def test_pack_off_pulls_each_batch_once(paths):
    """Off (the port's default, PERF.md) each result batch is one pull;
    on, the three are one, with the same rows."""
    ts = _ts()
    got = ts.read.parquet(paths["parquet"]).to_arrow()
    assert int(ts._last_plan.metrics["d2hPulls"]) == 3
    on = _ts({**BASE, "spark.rapids.sql.transfer.pack.enabled": "true"})
    assert got.equals(on.read.parquet(paths["parquet"]).to_arrow())
    assert int(on._last_plan.metrics["d2hPulls"]) == 1


@pytest.mark.parametrize("pack", ["true", "false"])
@pytest.mark.parametrize("egress", ["true", "false"])
def test_egress_serial_equals_pipelined(paths, egress, pack):
    conf = {**BASE, "spark.rapids.sql.io.egress.enabled": egress,
            "spark.rapids.sql.transfer.pack.enabled": pack,
            "spark.rapids.sql.reader.batchSizeRows": "512"}
    got = _ts(conf).read.parquet(paths["parquet"]).to_arrow()
    assert got.equals(_ts().read.parquet(paths["parquet"]).to_arrow())


def test_engine_stats_prefetch_and_d2h_sections(paths):
    s = _ts(PREFETCH["true"])
    before = ttr.d2h_stats()
    s.read.parquet(paths["parquet"]).to_arrow()
    snap = s.engine_stats()
    assert snap["d2h"]["pulls"] > before["pulls"]
    assert snap["prefetch"]["batches"] > 0
    assert snap["compressed"]["d2h_wire_bytes"] == snap["d2h"]["wire_bytes"]
    hist = snap["histograms"]
    assert hist["transfer.device_pull.us"]["count"] > 0
    assert hist["transfer.pipelined_h2d.bytes"]["count"] > 0


def test_explain_analyze_shows_the_pulls(paths, capsys):
    txt = _ts().read.parquet(paths["parquet"]).explain(analyze=True)
    assert "d2hPulls" in txt
