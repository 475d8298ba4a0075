"""The torch port's device runtime, tiered spill and background pull.

Analogs of ``tests/test_spill.py`` for the port
(``spark_rapids_tpu_torch/runtime.py``, ``memory/spill.py``,
``io/prefetch.py``), on the CPU, where the "device" tier is CPU memory
and the code paths are the card's but for pinning and events:

- a batch of every column type, nulls and strings (empty, non-ASCII,
  embedded NUL) included, goes device -> host -> disk -> device and comes
  back bit for bit (NaN payloads and string lengths too); the host tier
  holds the validity and BOOLEAN planes at 8 rows a byte, and the disk
  tier one ``.npy`` a plane, in a directory the catalog removes;
- demotion by priority class, then least recently used, never a pinned
  handle; ``spill_all``; a spill that fails is counted and skipped,
  leaving the handle whole, as in the JAX package; the leak warning;
- the runtime's budget (16 GiB x allocFraction on the CPU, as in the
  JAX package, or budgetBytes) and one runtime a device;
- the aggregate, the sort, the window, a broadcast join and the hash
  and range exchanges under the JAX package's tiny-budget conf
  (``tests/test_spill.py:17``, 200 KiB of device and 150 KiB of host),
  each equal to the JAX package under the
  same conf dict, with bytes on the host and the disk tiers, once with
  the device scan cache at its default (on: its entries take the
  lowest priority and the operators' own moves are counted apart) and
  once with it off;
- the semaphore: re-entrant in a thread, one permit shared by two
  threads' queries with no deadlock;
- ``device_lookahead``: order kept, the producer's exception raised in
  the consumer, no thread of the port's left, the pull off giving the
  same result, and off unless the conf turns it on.

Tolerance: exact, except the aggregate's float sums (relative 1e-9,
``approx_float``: a spilled run sums its partials in the same order, but
the JAX package's order differs) and the window's running sums (1e-12 of
the input's sum of |v|, as ``tests/test_torch_window.py`` holds them).
"""

import collections
import gc
import glob
import os
import threading
import time
import warnings

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from spark_rapids_tpu import Window as JWindow
from spark_rapids_tpu import functions as F
from spark_rapids_tpu.runtime import TpuRuntime
from tests.compare import assert_tables_equal, tpu_session

import spark_rapids_tpu_torch as st
from spark_rapids_tpu_torch import functions as TF
from spark_rapids_tpu_torch.columnar.batch import host_batch_to_device, \
    host_columns_from_numpy
from spark_rapids_tpu_torch.conf import IO_PREFETCH_ENABLED, TorchConf
from spark_rapids_tpu_torch.io.prefetch import THREAD_PREFIX, \
    PrefetchIterator, device_lookahead
from spark_rapids_tpu_torch.memory import spill
from spark_rapids_tpu_torch.memory.spill import (
    PRIORITY_RECREATABLE, PRIORITY_RETAIN, TIER_DEVICE, TIER_DISK,
    TIER_HOST, BufferCatalog, SpillableBatch,
)
from spark_rapids_tpu_torch.runtime import TorchRuntime, TorchSemaphore
from tests.torch_threads import _one_torch_thread  # noqa: F401

TINY = {"spark.rapids.memory.tpu.budgetBytes": str(200 * 1024),
        "spark.rapids.memory.host.spillStorageSize": str(150 * 1024),
        "spark.rapids.sql.test.enabled": "false",
        "spark.rapids.sql.reader.batchSizeRows": "4096",
        "spark.rapids.sql.batchSizeBytes": str(256 * 1024)}
SCAN_CACHE_OFF = {"spark.rapids.sql.scan.deviceCacheEnabled": "false"}
CPU = {"spark.rapids.torch.device": "cpu"}


def _port_threads():
    return [t.name for t in threading.enumerate()
            if t.name.startswith(THREAD_PREFIX)]


# ---------------------------------------------------------------------------
# the tiers
# ---------------------------------------------------------------------------

def _column(kind: str, n: int, rng):
    if kind == "string":
        pool = np.array(["", "a", "héllo wörld", "x\x00y", "日本語テキスト",
                         "a much longer string of forty-odd characters"],
                        dtype=object)
        return pool[rng.integers(0, len(pool), n)]
    if kind == "bool":
        return rng.random(n) < 0.5
    if kind == "date":
        return rng.integers(-20000, 20000, n).astype("datetime64[D]")
    if kind in ("float32", "float64"):
        v = rng.normal(size=n).astype(kind)
        v[::7] = np.nan
        v[1::11] = -0.0
        v[2::13] = np.inf
        return v
    info = np.iinfo(kind)
    return rng.integers(info.min, info.max, n, dtype=kind, endpoint=True)


KINDS = ["bool", "int8", "int16", "int32", "int64", "float32", "float64",
         "date", "string"]


def _batch(n: int, kinds=KINDS, seed: int = 0):
    rng = np.random.default_rng(seed)
    data = {f"c_{k}": _column(k, n, rng) for k in kinds}
    masks = {name: rng.random(n) >= 0.15 for name in data}
    schema, cols = host_columns_from_numpy(data, masks)
    return host_batch_to_device(schema, cols, torch.device("cpu"))


def _planes(batch):
    out = []
    for c in batch.columns:
        for t in (c.data, c.validity, c.chars):
            out.append(None if t is None else t.clone())
    return out


def _same_bits(a, b) -> bool:
    if a is None or b is None:
        return a is None and b is None
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype.is_floating_point:  # NaN payloads and signed zeros too
        view = torch.int32 if a.element_size() == 4 else torch.int64
        return torch.equal(a.view(view), b.view(view))
    return torch.equal(a, b)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("last_tier", [TIER_HOST, TIER_DISK])
def test_tier_round_trip_is_bit_for_bit(kind, last_tier):
    batch = _batch(3000, [kind], seed=KINDS.index(kind))
    before = _planes(batch)
    cat = BufferCatalog(1 << 40)
    sb = SpillableBatch(batch, cat)
    del batch
    with cat._lock:
        cat._demote_to_host(sb)
    assert sb.tier == TIER_HOST and sb._device is None
    if kind == "bool":  # data and validity at 8 rows a byte
        assert sb.host_nbytes() == 2 * 4096 // 8
    if last_tier == TIER_DISK:
        with cat._lock:
            cat._demote_to_disk(sb)
        assert sb.tier == TIER_DISK and sb._host is None
        files = glob.glob(os.path.join(cat.spill_dir, "*.npy"))
        assert len(files) == (3 if kind == "string" else 2)
    out = sb.get()
    assert sb.tier == TIER_DEVICE and cat.unspill_count == 1
    assert out.num_rows == 3000
    after = _planes(out)
    assert len(after) == len(before)
    for a, b in zip(before, after):
        assert _same_bits(a, b)
    sb.close()
    assert cat.device_bytes == cat.host_bytes == cat.disk_bytes == 0
    if last_tier == TIER_DISK:
        assert not glob.glob(os.path.join(cat.spill_dir, "*.npy"))
        d = cat.spill_dir
        cat.close()
        assert not os.path.exists(d)


def test_whole_batch_of_every_type_through_disk():
    batch = _batch(5000)
    before = _planes(batch)
    cat = BufferCatalog(1, host_budget_bytes=1)  # everything spills
    sb = SpillableBatch(batch, cat)
    del batch
    assert sb.tier == TIER_DISK
    assert cat.spill_to_host_count == cat.spill_to_disk_count == 1
    assert cat.spill_to_host_bytes == cat.spill_to_disk_bytes == sb.size
    assert cat.disk_bytes == sb.size and cat.peak_device_bytes == sb.size
    out = sb.get()
    for a, b in zip(before, _planes(out)):
        assert _same_bits(a, b)
    sb.close()
    cat.close()


def _handle(cat, rows=8192, priority=0):
    data = {"v": np.arange(rows, dtype=np.int64)}
    schema, cols = host_columns_from_numpy(data)
    return SpillableBatch(host_batch_to_device(schema, cols,
                                               torch.device("cpu")),
                          cat, priority=priority)


def test_demotion_takes_priority_then_lru():
    size = _handle(BufferCatalog(1 << 40)).size
    # the budget holds four handles and a half
    cat = BufferCatalog(size * 4 + size // 2)
    retain = _handle(cat, priority=PRIORITY_RETAIN)
    old, mid = _handle(cat), _handle(cat)
    recreatable = _handle(cat, priority=PRIORITY_RECREATABLE)
    # most recently used, but in the class that demotes first
    cat._touch(recreatable)
    cat.reserve(size)
    assert recreatable.tier == TIER_HOST
    assert old.tier == mid.tier == retain.tier == TIER_DEVICE
    # within a class the least recently used goes first
    cat._touch(old)
    cat.reserve(2 * size)
    assert mid.tier == TIER_HOST
    assert old.tier == retain.tier == TIER_DEVICE
    # the class that demotes last goes last
    cat.reserve(4 * size)
    assert old.tier == retain.tier == TIER_HOST
    for h in (retain, old, mid, recreatable):
        h.close()
    assert cat.device_bytes == cat.host_bytes == 0


def test_pinned_handle_stays_on_the_device():
    cat = BufferCatalog(1 << 40)
    pinned, free = _handle(cat), _handle(cat)
    pinned.pinned = True
    freed = cat.spill_all()
    assert freed == free.size
    assert pinned.tier == TIER_DEVICE and free.tier == TIER_HOST
    cat.device_budget = 0
    cat.reserve(1)  # nothing left to demote: it returns anyway
    assert pinned.tier == TIER_DEVICE
    # materializing pins the handles before it makes room
    out = spill.materialize_all([free], _Ctx(cat))
    assert out[0].num_rows == 8192 and cat.audit_leaks() == 1
    pinned.close()


class _Ctx:
    def __init__(self, cat):
        class _R:
            pass
        self.runtime = _R()
        self.runtime.catalog = cat


def test_spill_all_and_host_overflow_reach_disk():
    cat = BufferCatalog(1 << 40, host_budget_bytes=1)
    hs = [_handle(cat) for _ in range(3)]
    assert cat.spill_all() == sum(h.size for h in hs)
    # past the host budget every host handle goes on to disk
    assert all(h.tier == TIER_DISK for h in hs)
    assert cat.spill_to_disk_count == 3 and cat.host_bytes == 0
    assert [int(h.get().columns[0].data[5]) for h in hs] == [5, 5, 5]
    spill.close_all(hs)
    assert cat.audit_leaks() == 0
    cat.close()


def test_collect_spillable_closes_what_it_made_on_error():
    cat = BufferCatalog(1 << 40)

    def batches():
        yield _batch(100, ["int64"])
        raise ValueError("child failed")

    with pytest.raises(ValueError, match="child failed"):
        spill.collect_spillable(batches(), _Ctx(cat))
    assert cat.audit_leaks() == 0 and cat.device_bytes == 0


def test_failed_spill_raises_and_keeps_the_handle(monkeypatch):
    cat = BufferCatalog(1 << 40, host_budget_bytes=1 << 40)
    sb = _handle(cat)
    cat.spill_all()

    def full(*_a, **_k):
        raise OSError(28, "No space left on device")

    monkeypatch.setattr(spill.np, "save", full)
    cat.host_budget = 0
    # bounded, as in the JAX package: counted, the handle skipped and
    # left whole on its tier, nothing raised (the name is older than
    # the bounded demotion)
    cat.reserve(0)
    assert cat.demote_failure_count == 1
    assert sb.tier == TIER_HOST and cat.host_bytes == sb.size
    assert cat.disk_bytes == 0 and cat.spill_to_disk_count == 0
    monkeypatch.undo()
    cat.reserve(0)
    assert sb.tier == "disk" and cat.demote_failure_count == 1
    assert torch.equal(sb.get().columns[0].data,
                       torch.arange(8192, dtype=torch.int64))
    sb.close()
    cat.close()


def test_leak_warning_on_unclosed_handle():
    cat = BufferCatalog(1 << 40)
    sb = _handle(cat)
    assert cat.audit_leaks() == 1
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        del sb
        gc.collect()
    assert any(issubclass(c.category, ResourceWarning) for c in caught)
    assert cat.leak_count == 1 and cat.audit_leaks() == 0
    assert cat.device_bytes == 0
    sb2 = _handle(cat)
    sb2.suppress_leak_warning = True
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        del sb2
        gc.collect()
    assert not any(issubclass(c.category, ResourceWarning) for c in caught)
    assert cat.leak_count == 2


def test_runtime_shutdown_warns_of_leaks():
    rt = TorchRuntime(TorchConf(CPU), torch.device("cpu"))
    sb = _handle(rt.catalog)
    with pytest.warns(ResourceWarning, match="still registered"):
        rt.shutdown()
    sb.close()


def test_tier_transition_requires_catalog_lock():
    cat = BufferCatalog(1 << 40)
    sb = _handle(cat)
    with pytest.raises(AssertionError):
        sb._to_host()
    sb.close()


# ---------------------------------------------------------------------------
# the runtime
# ---------------------------------------------------------------------------

@pytest.fixture
def fresh_runtimes():
    TorchRuntime.reset()
    TpuRuntime.reset()
    yield
    TorchRuntime.reset()
    TpuRuntime.reset()


def test_runtime_budget_and_one_runtime_a_device(fresh_runtimes):
    s = st.TorchSession(CPU)
    rt = s.runtime
    assert rt.budget_bytes == int(16 * 1024 ** 3 * 0.9)
    assert rt.catalog.device_budget == rt.budget_bytes
    assert rt.catalog.host_budget == 1 << 30
    assert rt.semaphore.permits == 2
    # the JAX package budgets the same from the same conf dict
    assert TpuRuntime.get_or_create(tpu_session().conf).hbm_budget_bytes \
        == rt.budget_bytes
    assert st.TorchSession({**CPU, **TINY}).runtime is rt
    TorchRuntime.reset()
    s2 = st.TorchSession({**CPU, **TINY,
                          "spark.rapids.memory.tpu.allocFraction": "0.5",
                          "spark.rapids.tpu.concurrentTasks": "1"})
    assert s2.runtime is not rt
    assert s2.runtime.budget_bytes == 8 * 1024 ** 3
    assert s2.runtime.catalog.device_budget == 200 * 1024
    assert s2.runtime.catalog.host_budget == 150 * 1024
    assert s2.runtime.semaphore.permits == 1


# ---------------------------------------------------------------------------
# queries under the tiny budget, against the JAX package
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    """A 40,000-row fact table (ten 4,096-row reader batches) and a
    1,000-row dimension, as parquet for both packages."""
    d = tmp_path_factory.mktemp("tiny")
    rng = np.random.default_rng(17)
    n = 40_000
    fact = pa.table({
        "k": pa.array(rng.integers(0, 1000, n), pa.int64(),
                      mask=rng.random(n) < 0.02),
        "v": pa.array(rng.normal(size=n), mask=rng.random(n) < 0.02),
        "s": pa.array([f"s{i % 37}" for i in range(n)]),
    })
    dim = pa.table({"k": pa.array(np.arange(1000), pa.int64()),
                    "grp": pa.array(rng.integers(0, 50, 1000), pa.int64())})
    paths = {"fact": str(d / "fact.parquet"), "dim": str(d / "dim.parquet")}
    pq.write_table(fact, paths["fact"], row_group_size=4096)
    pq.write_table(dim, paths["dim"])
    return paths


def q_agg(fns, W, s, p):
    return s.read.parquet(p["fact"]).group_by("k").agg(
        fns.sum(fns.col("v")).alias("sv"), fns.count(fns.col("v")).alias("c"),
        fns.max(fns.col("v")).alias("mx"))


def q_sort(fns, W, s, p):
    return s.read.parquet(p["fact"]).order_by(fns.col("v"), fns.col("s"))


def q_window(fns, W, s, p):
    w = W.partition_by("k").order_by("v")
    return s.read.parquet(p["fact"]).select(
        fns.col("k"), fns.col("v"), fns.col("s"),
        fns.row_number().over(w).alias("rn"),
        fns.sum(fns.col("v")).over(w).alias("run"))


def q_broadcast_join(fns, W, s, p):
    fact = s.read.parquet(p["fact"])
    dim = s.read.parquet(p["dim"])
    return fact.join(dim, on="k").group_by("grp").agg(
        fns.sum(fns.col("v")).alias("sv"), fns.count(fns.col("v")).alias("c"))


def q_exchange_hash(fns, W, s, p):
    return s.read.parquet(p["fact"]).repartition(8, "k").select(
        fns.col("k"), fns.col("v"), fns.col("s"),
        fns.spark_partition_id().alias("p"))


def q_exchange_range(fns, W, s, p):
    return s.read.parquet(p["fact"]).repartition_by_range(
        8, fns.col("v").desc(), "s").select(
        fns.col("k"), fns.col("v"), fns.col("s"),
        fns.spark_partition_id().alias("p"))


QUERIES = {"aggregate": q_agg, "sort": q_sort, "window": q_window,
           "broadcast_join": q_broadcast_join,
           "exchange_hash": q_exchange_hash,
           "exchange_range": q_exchange_range}


def _jax_result(query, tables, conf):
    TpuRuntime.reset()
    try:
        return query(F, JWindow, tpu_session(conf), tables).to_arrow()
    finally:
        TpuRuntime.reset()


def _own_moves(monkeypatch) -> collections.Counter:
    """The tier moves of the operators' own handles, by method: those of
    the device scan cache (its handles are the only ones at
    ``PRIORITY_RECREATABLE``) are left out."""
    moves = collections.Counter()
    for name in ("_to_host", "_to_disk", "_from_host"):
        def counted(self, _orig=getattr(SpillableBatch, name), _name=name):
            if self.priority != PRIORITY_RECREATABLE:
                moves[_name] += 1
            return _orig(self)
        monkeypatch.setattr(SpillableBatch, name, counted)
    return moves


@pytest.mark.parametrize("qname", list(QUERIES))
def test_tiny_budget_equals_the_jax_package(qname, tables, fresh_runtimes,
                                            monkeypatch):
    _tiny_budget_case(qname, tables, {}, monkeypatch)


@pytest.mark.parametrize("qname", list(QUERIES))
def test_tiny_budget_with_the_scan_cache_off_equals_the_jax_package(
        qname, tables, fresh_runtimes, monkeypatch):
    _tiny_budget_case(qname, tables, SCAN_CACHE_OFF, monkeypatch)


def _tiny_budget_case(qname, tables, extra, monkeypatch):
    query = QUERIES[qname]
    conf = {**TINY, **extra}
    want = _jax_result(query, tables, conf)
    moves = _own_moves(monkeypatch)
    s = st.TorchSession({**CPU, **conf})
    got = query(TF, st.Window, s, tables).to_arrow()
    stats = s.runtime.catalog.stats()
    cache = s.runtime.scan_cache.stats()
    assert moves["_to_host"] > 0, (moves, stats)
    if qname in ("sort", "window"):  # the whole input is collected
        assert moves["_to_disk"] > 0, (moves, stats)
        assert moves["_from_host"] > 0, (moves, stats)
    assert s.runtime.catalog.audit_leaks() == 0
    # what the catalog still holds is the cache's entries' (none off)
    assert cache["entries"] == (0 if extra else
                                1 + (qname == "broadcast_join"))
    assert (stats["device_bytes"], stats["host_bytes"]) == \
        (cache["device_bytes"], cache["host_bytes"])
    if not extra:  # the entries, the lowest priority, left the device
        assert cache["device_bytes"] == 0 < cache["disk_bytes"], cache
    if qname == "sort" or qname.startswith("exchange"):
        # an exchange's partitions come in order, each in input order
        assert got.equals(want)
    elif qname == "window":
        scale = float(np.nansum(np.abs(
            got.column("v").to_numpy(zero_copy_only=False))))
        key = ["k", "rn"]
        g = got.sort_by([(c, "ascending") for c in key])
        w = want.sort_by([(c, "ascending") for c in key])
        for c in ("k", "v", "s", "rn"):
            assert g.column(c).equals(w.column(c)), c
        gr = g.column("run").to_numpy(zero_copy_only=False)
        wr = w.column("run").to_numpy(zero_copy_only=False)
        assert np.array_equal(np.isnan(gr), np.isnan(wr))
        assert np.nanmax(np.abs(gr - wr)) <= 1e-12 * scale
    else:
        assert_tables_equal(got, want, approx_float=True)
    # the same query at the default budget moves nothing between tiers
    TorchRuntime.reset()
    s_big = st.TorchSession({**CPU, **extra})
    again = query(TF, st.Window, s_big, tables).to_arrow()
    assert s_big.runtime.catalog.spill_to_host_count == 0
    # (not the range exchange: its bounds come from a sample of each
    # scan batch, and the tiny budget cuts the scan into other batches,
    # in both packages)
    if qname in ("sort", "exchange_hash"):
        assert again.equals(got)
    assert not _port_threads()


# ---------------------------------------------------------------------------
# the semaphore
# ---------------------------------------------------------------------------

def test_semaphore_is_reentrant_in_a_thread():
    sem = TorchSemaphore(1)
    entered = threading.Event()
    with sem.held():
        with sem.held():  # the same thread takes it again at once
            pass
        assert sem.available() == 0

        def other():
            with sem.held():
                entered.set()

        t = threading.Thread(target=other)
        t.start()
        time.sleep(0.1)
        assert not entered.is_set()  # held by the outer section still
    t.join(timeout=10)
    assert entered.is_set() and not t.is_alive()
    assert sem.wait_count == 1 and sem.wait_ns > 0
    assert sem.available() == 1


def test_one_permit_two_threads_no_deadlock(fresh_runtimes, tables):
    conf = {**CPU, "spark.rapids.tpu.concurrentTasks": "1",
            "spark.rapids.sql.reader.batchSizeRows": "4096",
            "spark.rapids.sql.batchSizeRows": "8192"}
    s = st.TorchSession(conf)
    assert s.runtime.semaphore.permits == 1
    want = q_agg(TF, st.Window, s, tables).to_arrow()
    got, errors = {}, []

    def run(i):
        try:
            got[i] = q_agg(TF, st.Window, st.TorchSession(conf),
                           tables).to_arrow()
        except BaseException as e:  # reported by the assert below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads), "deadlock"
    assert not errors, errors
    for i in range(2):
        assert got[i].equals(want)
    assert s.runtime.semaphore.acquire_count >= 3
    assert not _port_threads()


# ---------------------------------------------------------------------------
# device_lookahead
# ---------------------------------------------------------------------------

def test_prefetch_keeps_order_and_joins_its_thread():
    items = list(range(50))
    it = PrefetchIterator(iter(items), depth=2, name="test-order")
    assert list(it) == items
    it.close()
    assert not _port_threads()
    # closed early: the producer stops and the source is closed
    closed = threading.Event()

    def source():
        try:
            yield from range(10 ** 6)
        finally:
            closed.set()

    it = PrefetchIterator(source(), depth=1, name="test-close")
    assert [next(it) for _ in range(3)] == [0, 1, 2]
    it.close()
    assert closed.is_set() and not _port_threads()


def test_prefetch_raises_the_producers_error_in_the_consumer():
    boom = ValueError("decode failed")

    def source():
        yield 1
        raise boom

    it = PrefetchIterator(source(), depth=1, name="test-error")
    assert next(it) == 1
    with pytest.raises(ValueError) as info:
        next(it)
    assert info.value is boom
    it.close()
    assert not _port_threads()


def test_lookahead_off_gives_the_same_result(fresh_runtimes, tables):
    conf = {**CPU, "spark.rapids.sql.reader.batchSizeRows": "4096",
            "spark.rapids.sql.batchSizeRows": "8192"}
    results = {}
    for on in ("true", "false"):
        s = st.TorchSession({**conf,
                             "spark.rapids.sql.io.prefetch.enabled": on})
        df = q_agg(TF, st.Window, s, tables)
        results[on] = df.to_arrow()
        coalesce = _find(s._last_plan, "TorchCoalesceBatchesExec")
        assert coalesce.metrics["prefetchBatches"] == \
            (10 if on == "true" else 0)
        assert not _port_threads()
    assert results["true"].equals(results["false"])
    ctx = type("Ctx", (), {})()
    ctx.conf = TorchConf({"spark.rapids.sql.io.prefetch.enabled": "false"})
    src = iter([1, 2])
    assert device_lookahead(src, ctx) is src


def test_lookahead_is_off_by_default(fresh_runtimes, tables):
    # the local scan uploads on the thread that pulls it, so a pull ahead
    # has nothing to overlap: the coalesce pulls its child itself
    s = st.TorchSession({**CPU, "spark.rapids.sql.reader.batchSizeRows":
                         "4096"})
    assert s.conf.get(IO_PREFETCH_ENABLED) is False
    started = []
    real = PrefetchIterator.__init__

    def spy(self, *args, **kwargs):
        started.append(kwargs.get("name"))
        real(self, *args, **kwargs)

    PrefetchIterator.__init__ = spy
    try:
        q_agg(TF, st.Window, s, tables).to_arrow()
    finally:
        PrefetchIterator.__init__ = real
    coalesce = _find(s._last_plan, "TorchCoalesceBatchesExec")
    assert coalesce.metrics["prefetchBatches"] == 0 and not started
    assert not _port_threads()


def test_an_error_in_the_child_leaves_no_thread(fresh_runtimes, tables):
    s = st.TorchSession({**CPU, "spark.rapids.sql.reader.batchSizeRows":
                         "4096"})
    df = q_agg(TF, st.Window, s, tables)
    from spark_rapids_tpu_torch.io import parquet as pq_mod
    real = pq_mod.host_batch_to_device
    calls = []

    def failing(*a, **k):
        calls.append(1)
        if len(calls) == 3:
            raise ValueError("upload failed")
        return real(*a, **k)

    pq_mod.host_batch_to_device = failing
    try:
        with pytest.raises(ValueError, match="upload failed"):
            df.to_arrow()
    finally:
        pq_mod.host_batch_to_device = real
    assert not _port_threads()
    assert s.runtime.catalog.audit_leaks() == 0


def _find(plan, name):
    if type(plan).__name__ == name:
        return plan
    for c in plan.children:
        r = _find(c, name)
        if r is not None:
            return r
    return None
