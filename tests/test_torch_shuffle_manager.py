"""The port's shuffle manager against the JAX package's
(``spark_rapids_tpu_torch/shuffle/manager.py``).

Analog of ``tests/test_shuffle_worker.py``'s manager tests and
``tests/test_faults.py``'s manager failure plane.  Each scenario runs on
a JAX ``TpuShuffleManager`` and on a ``TorchShuffleManager`` with the
same settings and the same ``spark.rapids.faults.*`` spec, which fires
at the same calls in both; the outcome (rows, the raised error) and the
failure counters of ``stats()`` (transient retries, corrupt refetches,
fetch failures, blacklist events) must be equal.  Also: the in-flight
window, the metadata cap, the Python transport's bounce buffers, a
three-manager hash shuffle, ``partition_sizes``, the conf's timeouts
and ``select_shuffle_mode``'s rules.  Exact comparisons throughout.
"""

import numpy as np
import pyarrow as pa
import pytest

from spark_rapids_tpu import faults as jfaults
from spark_rapids_tpu.shuffle.manager import (
    FetchFailedError as JFetchFailed, TpuShuffleManager,
)

from spark_rapids_tpu_torch import faults
from spark_rapids_tpu_torch.columnar.batch import host_columns_from_arrow
from spark_rapids_tpu_torch.conf import TorchConf
from spark_rapids_tpu_torch.shuffle.manager import FetchFailedError, \
    MeshNotPortedError, TorchShuffleManager, select_shuffle_mode
from spark_rapids_tpu_torch.shuffle.serializer import HostBlock
from tests.torch_threads import _one_torch_thread  # noqa: F401

FAST = {"backoff_base": 0.005, "backoff_cap": 0.02}
COUNTERS = ("transient_retries", "corrupt_refetches", "fetch_failures",
            "blacklist_events")


@pytest.fixture(autouse=True)
def _no_faults():
    faults.reset()
    jfaults.reset()
    yield
    faults.reset()
    jfaults.reset()


def _block(rb) -> HostBlock:
    schema, cols = host_columns_from_arrow(rb)
    return HostBlock(schema, cols, rb.num_rows)


class _Side:
    """One package's manager, its block type and its fault module."""

    def __init__(self, jax: bool, **kw):
        cls = TpuShuffleManager if jax else TorchShuffleManager
        self.jax = jax
        self.mgr = cls(port=0, **{**FAST, **kw})
        self.mgr.register_peers([self.mgr.server.port])
        self.faults = jfaults if jax else faults
        self.error = JFetchFailed if jax else FetchFailedError

    def write(self, sh, map_id, part, rb):
        self.mgr.write_partition(sh, map_id, part,
                                 rb if self.jax else _block(rb))

    def rows(self, sh, part) -> int:
        return sum(b.num_rows for b in self.mgr.read_partition(sh, part))

    def counters(self):
        st = self.mgr.stats()
        return {k: st[k] for k in COUNTERS}, \
            st["blacklisted_peers"] == [self.mgr.server.port]


def _both(scenario, **kw):
    """Run ``scenario(side)`` on each package -> the two results, which
    must be equal, with each side's counters."""
    out = []
    for jax in (True, False):
        side = _Side(jax, **kw)
        try:
            out.append((scenario(side), side.counters()))
        finally:
            side.faults.reset()
            side.mgr.stop()
    assert out[0] == out[1], out
    return out[1]


def _rb(n):
    return pa.record_batch({"a": pa.array(np.arange(n), pa.int64())})


def test_injected_fetch_fault_is_retried_and_counted():
    def sc(s):
        sh = s.mgr.new_shuffle_id()
        s.write(sh, 0, 0, _rb(3))
        s.faults.configure_from_conf(
            {"spark.rapids.faults.transport.fetch": "count:1"})
        return s.rows(sh, 0)
    rows, (counters, _) = _both(sc, fetch_retries=2)
    assert rows == 3 and counters["transient_retries"] == 1


def test_corrupt_block_is_refetched_and_counted_apart():
    def sc(s):
        sh = s.mgr.new_shuffle_id()
        s.write(sh, 0, 0, _rb(1000))
        s.faults.configure_from_conf(
            {"spark.rapids.faults.serializer.deserialize": "count:1"})
        return s.rows(sh, 0)
    rows, (counters, _) = _both(sc, checksum="crc32c")
    assert rows == 1000
    assert counters["corrupt_refetches"] == 1
    assert counters["transient_retries"] == 0


def test_unrecoverable_corruption_becomes_fetch_failed():
    def sc(s):
        sh = s.mgr.new_shuffle_id()
        s.write(sh, 0, 0, _rb(1))
        s.faults.configure_from_conf(
            {"spark.rapids.faults.serializer.deserialize": "count:1+"})
        with pytest.raises(s.error):
            s.rows(sh, 0)
        return "raised"
    _, (counters, _) = _both(sc, checksum="crc32c", corrupt_refetches=1)
    assert counters["corrupt_refetches"] == 2


def test_persistently_corrupt_peer_is_blacklisted():
    def sc(s):
        sh = s.mgr.new_shuffle_id()
        for p in (0, 1, 2):
            s.write(sh, 0, p, _rb(1))
        s.faults.configure_from_conf(
            {"spark.rapids.faults.serializer.deserialize": "count:1+"})
        for p in (0, 1):
            with pytest.raises(s.error):
                s.rows(sh, p)
        with pytest.raises(s.error, match="blacklisted"):
            s.rows(sh, 2)
        return "raised"
    _, (counters, blacklisted) = _both(
        sc, checksum="crc32c", corrupt_refetches=0, peer_max_failures=2)
    assert counters["blacklist_events"] == 1 and blacklisted


def test_repeated_failures_blacklist_then_fail_fast():
    def sc(s):
        sh = s.mgr.new_shuffle_id()
        s.write(sh, 0, 0, _rb(1))
        s.faults.configure_from_conf(
            {"spark.rapids.faults.transport.fetch": "count:1+"})
        for _ in range(2):
            with pytest.raises(s.error):
                s.rows(sh, 0)
        before = s.faults.injector().stats()["transport.fetch"]["calls"]
        with pytest.raises(s.error, match="blacklisted"):
            s.rows(sh, 0)
        after = s.faults.injector().stats()["transport.fetch"]["calls"]
        return before, after
    (before, after), (counters, blacklisted) = _both(
        sc, fetch_retries=0, peer_max_failures=2)
    assert before == after == 2  # the fail-fast path makes no call
    assert counters["blacklist_events"] == 1 and blacklisted


def test_success_resets_the_consecutive_count():
    def sc(s):
        sh = s.mgr.new_shuffle_id()
        s.write(sh, 0, 0, _rb(1))
        s.faults.configure_from_conf(
            {"spark.rapids.faults.transport.fetch": "count:1,3"})
        with pytest.raises(s.error):
            s.rows(sh, 0)
        got = s.rows(sh, 0)
        with pytest.raises(s.error):
            s.rows(sh, 0)
        return got
    got, (counters, _) = _both(sc, fetch_retries=0, peer_max_failures=2)
    assert got == 1 and counters["blacklist_events"] == 0


def test_fetch_failure_surfaces_after_retries():
    def sc(s):
        sh = s.mgr.new_shuffle_id()
        s.write(sh, 0, 0, _rb(3))
        s.mgr.server.stop()  # the (own) peer's server goes away
        with pytest.raises(s.error):
            s.rows(sh, 0)
        return "raised"
    _, (counters, _) = _both(sc, fetch_retries=1)
    assert counters["transient_retries"] == 1
    assert counters["fetch_failures"] == 1


def test_stat_and_inflight_throttle():
    mgr = TorchShuffleManager(port=0, max_bytes_in_flight=1 << 20,
                              threads=3)
    try:
        mgr.register_peers([mgr.server.port])
        sh = mgr.new_shuffle_id()
        block = _block(_rb(5000))
        for part in range(4):
            mgr.write_partition(sh, 0, part, block)
        assert mgr._clients[0].stat(sh, 2) > 0
        out = mgr.read_partitions(sh, [0, 1, 2, 3])
        assert {p: sum(b.num_rows for b in bs) for p, bs in out.items()} \
            == {p: 5000 for p in range(4)}
        assert mgr._inflight == 0
        st = mgr.stats()
        assert st["blocks_written"] == 4
        assert st["raw_bytes_written"] == 4 * 8 * 5000
    finally:
        mgr.stop()


def test_inflight_window_serializes_fetches_larger_than_it():
    """A window smaller than two partitions' stats lets one fetch at a
    time through, and every fetch still completes."""
    mgr = TorchShuffleManager(port=0, max_bytes_in_flight=4096, threads=4,
                              codec="none", checksum="off")
    try:
        mgr.register_peers([mgr.server.port])
        sh = mgr.new_shuffle_id()
        for part in range(6):
            mgr.write_partition(sh, 0, part, _block(_rb(1000)))
        out = mgr.read_partitions(sh, list(range(6)))
        assert all(sum(b.num_rows for b in bs) == 1000
                   for bs in out.values())
        assert mgr._inflight == 0
    finally:
        mgr.stop()


def test_metadata_size_cap():
    wide = pa.record_batch({f"very_long_column_name_{i}": pa.array([1])
                            for i in range(32)})
    for cls, blk in ((TpuShuffleManager, wide),
                     (TorchShuffleManager, _block(wide))):
        mgr = cls(port=0, max_metadata_size=64)
        try:
            mgr.register_peers([mgr.server.port])
            with pytest.raises(ValueError, match="maxMetadataSize"):
                mgr.write_partition(1, 0, 0, blk)
        finally:
            mgr.stop()


def test_python_transport_bounce_buffers():
    mgr = TorchShuffleManager(port=0, prefer_native=False, bounce_count=2,
                              bounce_size=4096)
    try:
        assert not mgr.native
        mgr.register_peers([mgr.server.port])
        sh = mgr.new_shuffle_id()
        mgr.write_partition(sh, 0, 0, _block(_rb(40_000)))
        assert sum(b.num_rows for b in mgr.read_partition(sh, 0)) == 40_000
    finally:
        mgr.stop()


def test_three_managers_hash_shuffle():
    """Three managers partition their rows and push blocks to the
    owners; each partition reassembles exactly its rows."""
    n_workers, n_parts = 3, 6
    mgrs = [TorchShuffleManager(port=0) for _ in range(n_workers)]
    try:
        ports = [m.server.port for m in mgrs]
        for m in mgrs:
            m.register_peers(ports)
        sh = mgrs[0].new_shuffle_id()
        assert len({m.new_shuffle_id() for m in mgrs}) == n_workers
        rng = np.random.default_rng(3)
        expect = {p: [] for p in range(n_parts)}
        for w, m in enumerate(mgrs):
            keys = rng.integers(0, 1000, 500)
            vals = rng.normal(size=500)
            for p in range(n_parts):
                sel = keys % n_parts == p
                expect[p] += list(zip(keys[sel].tolist(),
                                      vals[sel].tolist()))
                m.write_partition(sh, w, p, _block(pa.record_batch(
                    {"k": pa.array(keys[sel]), "v": pa.array(vals[sel])})))
        for p in range(n_parts):
            got = []
            for b in mgrs[p % n_workers].read_partition(sh, p):
                got += list(zip(b.cols["k"][0].tolist(),
                                b.cols["v"][0].tolist()))
            assert sorted(got) == sorted(expect[p])
    finally:
        for m in mgrs:
            m.stop()


def test_partition_sizes_report_the_map_output_index():
    for cls, blk in ((TpuShuffleManager, _rb(3)),
                     (TorchShuffleManager, _block(_rb(3)))):
        mgr = cls(port=0, threads=1)
        try:
            mgr.register_peers([mgr.server.port])
            mgr.write_partition(1, 0, 0, blk)
            sizes = mgr.partition_sizes(1, [0, 1])
            assert sizes[0] > 0 and sizes[1] == 0
        finally:
            mgr.stop()


def test_conf_threads_through_the_manager():
    conf = {"spark.rapids.shuffle.timeout.connect": "2.0",
            "spark.rapids.shuffle.timeout.read": "5.0",
            "spark.rapids.shuffle.fetch.retries": "5",
            "spark.rapids.shuffle.compression.codec": "lz4",
            "spark.rapids.shuffle.maxBytesInFlight": "12345"}
    from spark_rapids_tpu.conf import TpuConf
    ref = TpuShuffleManager.from_conf(TpuConf(dict(conf)), port=0)
    mgr = TorchShuffleManager.from_conf(TorchConf(conf), port=0)
    try:
        for attr in ("connect_timeout", "read_timeout", "fetch_retries",
                     "codec", "max_bytes_in_flight", "max_metadata_size",
                     "threads", "corrupt_refetches", "peer_max_failures",
                     "checksum"):
            assert getattr(mgr, attr) == getattr(ref, attr), attr
    finally:
        ref.stop()
        mgr.stop()


def test_conf_keys_keep_the_jax_defaults():
    from spark_rapids_tpu import conf as jconf
    from spark_rapids_tpu_torch import conf as tconf
    keys = [k for k in tconf._REGISTRY if k.startswith("spark.rapids.shuffle")]
    assert len(keys) >= 21
    for k in keys:
        assert tconf._REGISTRY[k].default == jconf._REGISTRY[k].default, k
    with pytest.raises(ValueError):
        TorchConf({"spark.rapids.shuffle.retry.backoff.jitter": "1.5"})
    with pytest.raises(ValueError):
        TorchConf({"spark.rapids.shuffle.checksum": "md5"})


@pytest.mark.parametrize("conf,n,want", [
    ({}, 4, "host"),
    ({"spark.rapids.shuffle.mode": "ici"}, 1, "host"),
    ({"spark.rapids.shuffle.mode": "ici",
      "spark.rapids.shuffle.workers.count": 2}, 4, "host"),
    ({"spark.rapids.shuffle.mode": "ici",
      "spark.rapids.sql.mesh.devices": 2}, 4, "host"),
    ({"spark.rapids.shuffle.mode": "ici"}, 2, "ici"),
])
def test_shuffle_mode_rules_match_jax(conf, n, want):
    from spark_rapids_tpu.conf import TpuConf
    from spark_rapids_tpu.shuffle.manager import select_shuffle_mode as jsel
    assert jsel(TpuConf(dict(conf)), n_devices=n) == want
    if want == "ici":
        with pytest.raises(MeshNotPortedError, match="A8b"):
            select_shuffle_mode(TorchConf(conf), n_devices=n)
    else:
        assert select_shuffle_mode(TorchConf(conf), n_devices=n) == want
