"""The device scan cache on the card: a CSV scan's batches kept on the
device across queries.

* an entry demoted to pinned host memory and hit again comes back on
  the card, its aggregate (the dense-slot kernel's update) equal to a
  read with the key off, floats bit for bit;
* a cached batch written in place on the card raises
  ``CachedBatchWrittenError`` at the next read, and the read after it
  reads the file again;
* two threads that miss the same key together get equal results, and
  one entry stays, nothing else registered;
* what ``to_torch`` and ``to_device_batches`` hand out, written in
  place and through a DLPack hand-off, leaves the next read (a hit)
  with the file's values.

Marked ``cuda``: each test skips itself without a card.  The file
imports neither JAX nor pyarrow, so it runs on the card's machine:

    python -m pytest tests/test_torch_scan_cache_card.py -q --noconftest
"""

import threading

import numpy as np
import pytest
import torch

import spark_rapids_tpu_torch as st
from spark_rapids_tpu_torch import functions as F
from spark_rapids_tpu_torch.memory.spill import TIER_DEVICE, TIER_HOST, \
    CachedBatchWrittenError
from spark_rapids_tpu_torch.runtime import TorchRuntime

OFF = {"spark.rapids.sql.scan.deviceCacheEnabled": "false"}
ROWS = {"spark.rapids.sql.reader.batchSizeRows": str(1 << 16)}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cached batches live on it")


@pytest.fixture
def csv_root(tmp_path):
    _card()
    TorchRuntime.reset()
    rng = np.random.default_rng(3)
    n = 200_000
    data = {"k": rng.integers(0, 1000, n),
            "v": rng.normal(size=n),
            "s": np.array(["AIR", "MAIL", "RAIL", "SHIP"])[
                rng.integers(0, 4, n)]}
    path = str(tmp_path / "t")
    st.TorchSession(OFF).create_dataframe(data).write.csv(path)
    yield path
    TorchRuntime.reset()


def _agg(df):
    return (df.group_by("k").agg(F.count(st.col("v")).alias("n"),
                                 F.sum(st.col("v")).alias("sv"))
              .order_by("k"))


@pytest.mark.cuda
def test_hit_after_a_demotion_to_host(csv_root):
    s = st.TorchSession(ROWS)
    off = _agg(st.TorchSession({**OFF, **ROWS}).read.csv(csv_root))._host()
    first = _agg(s.read.csv(csv_root))._host()
    cache = s.runtime.scan_cache
    ent = next(iter(cache._entries.values()))
    assert len(ent.handles) == 4
    s.runtime.catalog.spill_all()
    assert {h.tier for h in ent.handles} == {TIER_HOST}
    again = _agg(s.read.csv(csv_root))._host()
    assert cache.stats()["hits"] == 1
    assert {h.tier for h in ent.handles} == {TIER_DEVICE}
    assert all(b.device.type == "cuda"
               for b in s.read.csv(csv_root).to_device_batches())
    assert first.equals(off) and again.equals(off)


@pytest.mark.cuda
def test_version_guard_on_the_card(csv_root):
    s = st.TorchSession(ROWS)
    df = s.read.csv(csv_root)
    want = df._host()
    ent = next(iter(s.runtime.scan_cache._entries.values()))
    b = ent.handles[1].get()
    c = b.columns[b.schema.field_index("k")]
    assert c.data.is_cuda
    c.data.add_(1)
    with pytest.raises(CachedBatchWrittenError):
        df._host()
    assert df._host().equals(want)
    assert s.runtime.scan_cache.stats()["misses"] == 2


@pytest.mark.cuda
def test_two_threads_miss_together(csv_root):
    s = st.TorchSession(ROWS)
    off = _agg(st.TorchSession({**OFF, **ROWS}).read.csv(csv_root))._host()
    gate = threading.Barrier(2)
    out, errs = [None, None], []

    def run(i):
        try:
            gate.wait()
            out[i] = _agg(s.read.csv(csv_root))._host()
        except BaseException as e:  # noqa: BLE001 (reported below)
            errs.append(e)
    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errs
    assert out[0].equals(off) and out[1].equals(off)
    stats = s.runtime.scan_cache.stats()
    assert stats["entries"] == 1 and stats["handles"] == 4
    # no other handle left, and every byte the catalog holds the entry's
    cat = s.runtime.catalog
    assert cat.audit_leaks() == 0
    assert cat.device_bytes == stats["device_bytes"]


@pytest.mark.cuda
def test_writes_into_results_handed_out_miss_the_cache(csv_root):
    from torch.utils.dlpack import from_dlpack, to_dlpack
    s = st.TorchSession(ROWS)
    df = s.read.csv(csv_root)
    want = df._host()
    cols, masks, _ = df.to_torch()
    assert cols["k"].is_cuda
    cols["k"].add_(1)
    from_dlpack(to_dlpack(cols["v"])).zero_()
    for b in df.to_device_batches():
        for c in b.columns:
            c.validity.zero_()
    assert s.runtime.scan_cache.stats()["hits"] == 2
    assert df._host().equals(want)
    assert s.runtime.scan_cache.stats()["hits"] == 3
