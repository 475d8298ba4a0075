"""The port's compile package (``compile/``) against the JAX package's.

Analog of ``tests/test_compile.py``, where the port has a torch analog:

* the capacity ladder: ``bucket_capacity`` and ``snap_rows`` equal the
  JAX package's under the same ``spark.rapids.sql.compile.buckets.*``
  keys, every batch capacity routes through it, and the coalesce's row
  target snaps onto a rung as the JAX coalesce's does; results with a
  raised floor equal the JAX package's;
* the store over ``native.py``'s kernel libraries, with the nvcc step
  stubbed (this box has no toolkit): a first process builds and
  records, a second over the same directory builds nothing and loads;
  a truncated library, a corrupt index line, a library that will not
  load and the ``compile.store`` fault each degrade to a counted fresh
  build; a query under the store runs; the server's start installs the
  store from its conf; off by default;
* the warm pool: one supervised ``srt-compile-warm`` thread that builds
  or loads every kernel, journals it, and leaves no thread after
  ``session.stop()``;
* the compile keys' JAX defaults.

Each test runs torch with one intra-op thread.
"""

import json
import os
import threading

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.api import col
from tests.compare import assert_tables_equal, tpu_session

import spark_rapids_tpu_torch as st
from spark_rapids_tpu_torch import native
from spark_rapids_tpu_torch.compile import buckets, service, store, warm
from tests.torch_threads import _one_torch_thread  # noqa: F401

LIB_BYTES = 4096


class _FakeProc:
    returncode = 0

    def communicate(self):
        return "", "ptxas info    : Used 32 registers"


class _FakeLib:
    """Takes the ctypes declarations a wrapper makes."""

    def __getattr__(self, name):
        fn = type("Fn", (), {})()
        object.__setattr__(self, name, fn)
        return fn


@pytest.fixture
def stub_nvcc(monkeypatch):
    """nvcc writes ``LIB_BYTES`` bytes; loading a library checks it is
    whole.  -> the list of sources built."""
    built = []

    def start(src, out):
        built.append(os.path.basename(src))
        with open(out, "wb") as fh:
            fh.write(b"\x7fELF" + bytes(LIB_BYTES - 4))
        return _FakeProc()

    def open_library(path):
        if os.path.getsize(path) != LIB_BYTES:
            raise OSError(f"{path}: invalid ELF header")
        return _FakeLib()

    monkeypatch.setattr(native, "_start_nvcc", start)
    monkeypatch.setattr(native, "_open_library", open_library)
    return built


def _reset_all():
    from spark_rapids_tpu_torch import faults
    warm.reset()
    store.reset()
    buckets.reset()
    service.reset_stats()
    native.unload_all()
    faults.reset()


@pytest.fixture(autouse=True)
def _fresh():
    from spark_rapids_tpu.compile import buckets as jbuckets
    _reset_all()
    yield
    _reset_all()
    jbuckets.reset()


def _store_conf(root, **extra):
    return {"spark.rapids.sql.compile.store.enabled": "true",
            "spark.rapids.sql.compile.cacheDir": str(root),
            "spark.rapids.sql.compile.warm.enabled": "false", **extra}


def _install(root, **extra):
    from spark_rapids_tpu_torch.conf import TorchConf
    from spark_rapids_tpu_torch import compile as compile_pkg
    compile_pkg.configure_from_conf(TorchConf(_store_conf(root, **extra)))
    return store.current()


def _restart(root):
    """A new process over the same directory: nothing loaded, a store
    read from the disk."""
    native.unload_all()
    store.reset()
    return _install(root)


# ---------------------------------------------------------------------------
# the capacity ladder
# ---------------------------------------------------------------------------

LADDERS = [(8, 0), (4096, 1 << 20), (100, 3000), (1, 1), (64, 16)]


@pytest.mark.parametrize("bounds", LADDERS)
def test_ladder_equals_jax(bounds):
    from spark_rapids_tpu.compile import buckets as jbuckets
    from spark_rapids_tpu_torch.columnar.column import bucket_capacity
    jbuckets.configure(*bounds)
    buckets.configure(*bounds)
    assert buckets.stats() == jbuckets.stats()
    for n in list(range(0, 70)) + [4095, 4096, 4097, 3_000_000,
                                   (1 << 20) + 1]:
        assert buckets.bucket_capacity(n) == jbuckets.bucket_capacity(n)
        assert bucket_capacity(n) == jbuckets.bucket_capacity(n)
        assert buckets.snap_rows(n) == jbuckets.snap_rows(n)


def test_ladder_keys_apply_only_when_set():
    from spark_rapids_tpu.compile import buckets as jbuckets
    from spark_rapids_tpu.conf import TpuConf
    from spark_rapids_tpu_torch.conf import TorchConf
    keys = {"spark.rapids.sql.compile.buckets.minRows": "4000",
            "spark.rapids.sql.compile.buckets.maxRows": "70000"}
    jbuckets.configure_from_conf(TpuConf(keys))
    buckets.configure_from_conf(TorchConf(keys))
    assert buckets.stats() == jbuckets.stats() == {
        "minRows": 4096, "maxRows": 1 << 17, "configured": 1}
    buckets.configure_from_conf(TorchConf({}))  # no key: left alone
    assert buckets.stats()["minRows"] == 4096


def test_raised_floor_pads_and_matches_jax():
    rng = np.random.default_rng(5)
    t = pa.table({"k": pa.array(rng.integers(0, 9, 600), pa.int64()),
                  "v": pa.array(rng.normal(size=600))})
    conf = {"spark.rapids.sql.compile.buckets.minRows": "4096"}
    js = tpu_session(conf)
    try:
        want = js.create_dataframe(t).filter(col("k") > 2).to_arrow()
    finally:
        js.stop()
    ts = st.TorchSession({"spark.rapids.torch.device": "cpu", **conf})
    df = ts.create_dataframe(t).filter(st.col("k") > 2)
    batches = df.to_device_batches()
    assert [b.capacity for b in batches] == [4096]
    assert_tables_equal(df.to_arrow(), want, ignore_order=False)
    assert buckets.stats()["minRows"] == 4096


def test_coalesce_target_snaps_onto_a_rung():
    """batchSizeRows 3,000 with the ladder configured: the coalesce
    fills toward 2,048 (snap_rows), as the JAX coalesce does; unset, it
    keeps 3,000."""
    from spark_rapids_tpu_torch import functions as TF
    data = {"k": np.arange(20_000) % 7, "v": np.ones(20_000)}
    rows = {}
    for label, extra in (("plain", {}), ("ladder", {
            "spark.rapids.sql.compile.buckets.maxRows": "1048576"})):
        buckets.reset()
        ts = st.TorchSession({
            "spark.rapids.torch.device": "cpu",
            "spark.rapids.sql.batchSizeRows": "3000",
            "spark.rapids.sql.reader.batchSizeRows": "1000", **extra})
        from spark_rapids_tpu_torch.exec import basic
        old = basic.BATCH_ROWS
        basic.BATCH_ROWS = 1000
        try:
            ts.create_dataframe(data).group_by("k").agg(
                TF.sum(st.col("v")).alias("s")).count()
        finally:
            basic.BATCH_ROWS = old
        node = ts._last_plan
        while type(node).__name__ != "TorchCoalesceBatchesExec":
            node = node.children[0]
        m = node.metrics.snapshot()
        rows[label] = m["numOutputRows"] / m["numOutputBatches"]
    assert rows["plain"] == 20_000 / 7  # 3,000-row flushes, 7 batches
    assert rows["ladder"] == 20_000 / 10  # 2,000-row flushes


# ---------------------------------------------------------------------------
# the store
# ---------------------------------------------------------------------------

def _index(root):
    with open(os.path.join(root, "cuda", "index.jsonl"),
              encoding="utf-8") as fh:
        return [line for line in fh.read().splitlines() if line]


def test_store_off_by_default():
    from spark_rapids_tpu_torch.conf import TorchConf
    from spark_rapids_tpu_torch import compile as compile_pkg
    compile_pkg.configure_from_conf(TorchConf({}))
    assert store.current() is None
    assert os.path.dirname(native.library_path("contains")).endswith(
        "_build")
    assert service.snapshot()["storeEnabled"] == 0


def test_second_process_builds_nothing(tmp_path, stub_nvcc):
    st_ = _install(tmp_path)
    assert native.library_path("contains").startswith(
        os.path.join(str(tmp_path), "cuda"))
    native.load("contains")
    native.load("dense_slot_reduce")
    native.load("contains")  # this process's own copy
    assert sorted(stub_nvcc) == ["contains.cu", "dense_slot_reduce.cu"]
    assert st_.stats()["misses"] == 2 and st_.stats()["hits"] == 0
    assert native.load_stats()["memo_hits"] == 1
    assert len(_index(tmp_path)) == 2
    assert service.service_stats()["builds"] == 2
    assert service.service_stats()["cold_ms"] >= 0

    st2 = _restart(tmp_path)
    native.load("contains")
    native.load("dense_slot_reduce")
    assert len(stub_nvcc) == 2  # no nvcc in the second process
    assert st2.stats()["hits"] == 2 and st2.stats()["misses"] == 0
    assert service.service_stats()["store_loads"] == 2
    snap = service.snapshot()
    assert snap["compileStoreHits"] == 2 and snap["storeEnabled"] == 1
    assert st.TorchSession({"spark.rapids.torch.device": "cpu"}) \
        .engine_stats()["compile"]["compileStoreHits"] == 2


def test_truncated_library_builds_anew(tmp_path, stub_nvcc):
    _install(tmp_path)
    native.load("contains")
    path = native.library_path("contains")
    with open(path, "r+b") as fh:
        fh.truncate(100)
    st2 = _restart(tmp_path)
    native.load("contains")
    assert stub_nvcc == ["contains.cu", "contains.cu"]
    assert st2.stats()["corrupt"] == 1 and st2.stats()["misses"] == 1
    assert os.path.getsize(path) == LIB_BYTES


def test_library_that_will_not_load_builds_anew(tmp_path, stub_nvcc,
                                                monkeypatch):
    _install(tmp_path)
    native.load("contains")
    st2 = _restart(tmp_path)
    real = native._open_library
    calls = []

    def flaky(path):
        calls.append(path)
        if len(calls) == 1:
            raise OSError("cannot open shared object file")
        return real(path)
    monkeypatch.setattr(native, "_open_library", flaky)
    native.load("contains")
    assert len(calls) == 2 and stub_nvcc == ["contains.cu"] * 2
    assert st2.stats()["hits"] == 1 and st2.stats()["corrupt"] == 1


def test_corrupt_index_lines_are_skipped(tmp_path, stub_nvcc):
    _install(tmp_path)
    native.load("contains")
    with open(os.path.join(tmp_path, "cuda", "index.jsonl"), "a",
              encoding="utf-8") as fh:
        fh.write("{torn\n")
        fh.write(json.dumps({"no": "key"}) + "\n")
    st2 = _restart(tmp_path)
    assert st2.stats()["corrupt"] == 2
    native.load("contains")
    assert stub_nvcc == ["contains.cu"] and st2.stats()["hits"] == 1


@pytest.mark.faults
def test_store_fault_degrades_to_a_counted_build(tmp_path, stub_nvcc):
    from spark_rapids_tpu_torch import faults
    _install(tmp_path)
    native.load("contains")
    faults.configure({"compile.store": "always"}, seed=42)
    st2 = _restart(tmp_path)
    native.load("contains")
    assert stub_nvcc == ["contains.cu"] * 2
    assert st2.stats()["faults"] == 1 and st2.stats()["misses"] == 1
    # a query under the faulted store runs and is right
    faults.configure({"compile.store": "always"}, seed=42)
    ts = st.TorchSession({"spark.rapids.torch.device": "cpu",
                          **_store_conf(tmp_path)})
    data = {"k": np.arange(100) % 5, "v": np.arange(100.0)}
    out = ts.create_dataframe(data).filter(st.col("k") > 2).to_numpy()
    assert int(out["k"].size) == 40


def test_server_start_installs_the_store(tmp_path):
    ts = st.TorchSession({"spark.rapids.torch.device": "cpu"})
    ts.conf = ts.conf.with_settings(_store_conf(tmp_path))
    assert store.current() is None
    server = ts.server()
    try:
        assert store.current() is not None
        assert store.current().root == str(tmp_path)
    finally:
        server.close()
        ts.stop()


def test_compile_keys_have_the_jax_defaults():
    from spark_rapids_tpu import conf as jconf
    from spark_rapids_tpu_torch import conf as tconf
    assert tconf.COMPILE_PREFIX == jconf.COMPILE_PREFIX
    for name in ("COMPILE_STORE_ENABLED", "COMPILE_CACHE_DIR",
                 "COMPILE_BUCKET_MIN_ROWS", "COMPILE_BUCKET_MAX_ROWS",
                 "COMPILE_WARM_ENABLED"):
        j, t = getattr(jconf, name), getattr(tconf, name)
        assert (t.key, t.default, t.conf_type) == \
            (j.key, j.default, j.conf_type)


# ---------------------------------------------------------------------------
# the warm pool
# ---------------------------------------------------------------------------

def test_warm_pool_builds_every_kernel_and_journals(tmp_path, stub_nvcc):
    from spark_rapids_tpu_torch.conf import TorchConf
    from spark_rapids_tpu_torch.obs import journal
    jdir = tmp_path / "journal"
    journal.configure_from_conf(TorchConf(
        {"spark.rapids.sql.obs.journalDir": str(jdir)}))
    try:
        st_ = _install(tmp_path / "store")
        t = warm.start_if_configured(
            TorchConf(_store_conf(tmp_path / "store", **{
                "spark.rapids.sql.compile.warm.enabled": "true"})),
            torch.device("cpu"))
        assert t is not None and t.name.startswith("srt-compile-")
        assert warm.wait_idle()
    finally:
        journal.close()
    assert warm.stats()["compiles"] == 2 and warm.stats()["errors"] == 0
    assert sorted(stub_nvcc) == ["contains.cu", "dense_slot_reduce.cu"]
    assert st_.stats()["misses"] == 2
    events = []
    for p in jdir.glob("*.jsonl"):
        with open(p, encoding="utf-8") as fh:
            events += [json.loads(line) for line in fh]
    assert sorted(e["key"] for e in events
                  if e["event"] == "compile_warm") == \
        ["contains", "dense_slot_reduce"]
    # once a (store, device) a process
    assert warm.start_if_configured(TorchConf(_store_conf(
        tmp_path / "store", **{"spark.rapids.sql.compile.warm.enabled":
                               "true"})), torch.device("cpu")) is None


def test_warm_pool_starts_with_the_runtime_and_stops_with_the_session(
        tmp_path, stub_nvcc):
    from spark_rapids_tpu_torch.runtime import TorchRuntime
    TorchRuntime.reset()
    try:
        ts = st.TorchSession({
            "spark.rapids.torch.device": "cpu",
            **_store_conf(tmp_path, **{
                "spark.rapids.sql.compile.warm.enabled": "true"})})
        assert warm.stats()["starts"] == 1
        ts.stop()
        assert not any(t.name.startswith("srt-compile")
                       for t in threading.enumerate() if t.is_alive())
        assert warm.stats()["errors"] == 0
    finally:
        TorchRuntime.reset()
