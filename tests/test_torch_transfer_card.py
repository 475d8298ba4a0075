"""The transfer path on the card: pinned, stream-ordered uploads and
pulls, and the pack, against the plain path on the same data.

* a batch uploaded through ``transfer.Upload`` (its planes pinned,
  checked with ``is_pinned()``, copied on the copy stream) while a long
  kernel is queued ahead of it on the consumer's stream, its host arrays
  overwritten and new pinned buffers filled with garbage before the
  copies can have run, equals the CPU path's tensors bit for bit;
* ``start_host_copies`` stages into pinned tensors, and ``device_pull``
  after a long kernel returns what ``.cpu()`` does;
* the pack (``pack_and_pull``, the stats threshold at 0 and at 1 GiB)
  over random batches of every plain type equals ``.cpu()`` of the
  planes;
* a parquet-free query through the local scan with prefetch on equals
  the same query with it off.

Marked ``cuda``: each test skips itself without a card.  The file
imports neither JAX nor pyarrow, so it runs on the card's machine:

    python -m pytest tests/test_torch_transfer_card.py -q --noconftest
"""

import numpy as np
import pytest
import torch

import spark_rapids_tpu_torch as st
from spark_rapids_tpu_torch import functions as F
from spark_rapids_tpu_torch.columnar import transfer
from spark_rapids_tpu_torch.columnar.batch import host_batch_to_device, \
    host_columns_from_numpy
from spark_rapids_tpu_torch.columnar.dtypes import STRING


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the pinned copies have no CPU mode")


def _long_kernel():
    """About a second of work queued on the current stream."""
    a = torch.randn(4096, 4096, device="cuda")
    for _ in range(40):
        a = a @ a
        a = a / a.abs().max()
    return a


def _columns(n: int, seed: int):
    rng = np.random.default_rng(seed)
    data = {
        "i32": rng.integers(-2 ** 31, 2 ** 31 - 1, n).astype(np.int32),
        "i64": rng.integers(-2 ** 62, 2 ** 62, n),
        "f": rng.normal(size=n),
        "b": rng.random(n) < 0.5,
        "s": np.array([f"v{x}-" + "y" * (x % 29)
                       for x in rng.integers(0, 10 ** 6, n)], dtype=str),
        "d": rng.integers(0, 20000, n).astype("datetime64[D]"),
    }
    masks = {k: rng.random(n) > 0.1 for k in data}
    return host_columns_from_numpy(data, masks)


def _planes(batch):
    return [(c.data, c.validity, c.chars) for c in batch.columns]


def _equal(a, b) -> bool:
    for (ad, av, ac), (bd, bv, bc) in zip(_planes(a), _planes(b)):
        if not (torch.equal(ad.cpu(), bd.cpu())
                and torch.equal(av.cpu(), bv.cpu())):
            return False
        if (ac is None) != (bc is None) or (
                ac is not None and not torch.equal(ac.cpu(), bc.cpu())):
            return False
    return True


@pytest.mark.cuda
def test_pinned_staging():
    _card()
    host = transfer._to_pinned(np.arange(1000, dtype=np.int64))
    assert host.is_pinned()
    t = torch.arange(1000, device="cuda")
    staged = transfer.start_host_copies((t, [t * 2]))
    assert staged.tree[0].is_pinned() and staged.tree[1][0].is_pinned()
    got = transfer.device_pull(staged)
    assert np.array_equal(got[1][0], np.arange(1000) * 2)


@pytest.mark.cuda
@pytest.mark.parametrize("defer", [False, True])
def test_upload_behind_a_long_kernel_equals_the_plain_path(defer):
    _card()
    schema, cols = _columns((1 << 20) + 5, 3)
    want = host_batch_to_device(schema, cols, "cpu")
    keep = {k: (v.copy() if isinstance(v, np.ndarray) else v, m.copy())
            for k, (v, m) in cols.items()}
    _long_kernel()
    got = host_batch_to_device(schema, keep, "cuda", defer=defer)
    # overwrite what the copies read from, and take pinned blocks the
    # allocator might hand out again, before the copies can have run
    for v, m in keep.values():
        m[:] = False
        if isinstance(v, np.ndarray):
            v[:] = 0
    junk = [transfer._to_pinned(np.full(1 << 22, 255, np.uint8))
            for _ in range(8)]
    del junk
    if defer:
        assert got.ready is not None
        transfer.await_upload(got)
    torch.cuda.synchronize()
    assert _equal(got, want)


@pytest.mark.cuda
def test_pull_behind_a_long_kernel_equals_cpu():
    _card()
    _long_kernel()
    t = torch.randint(0, 1 << 30, (1 << 22,), device="cuda")
    u = t * 3 + 1
    got = transfer.device_pull({"u": u, "t": t[:100]})
    assert np.array_equal(got["u"], u.cpu().numpy())
    assert np.array_equal(got["t"], t[:100].cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("threshold", [0, 1 << 30])
def test_pack_equals_cpu_over_random_batches(threshold):
    _card()
    batches = []
    for seed, n in ((1, 5000), (2, 0), (3, 70000), (4, 1)):
        schema, cols = _columns(n, seed)
        batches.append(host_batch_to_device(schema, cols, "cuda"))
    got = transfer.pack_and_pull(batches, schema, threshold)
    for f in schema:
        ci = schema.field_index(f.name)
        valid = np.concatenate([b.columns[ci].validity[:b.num_rows].cpu()
                                .numpy() for b in batches])
        assert np.array_equal(got[f.name][1], valid)
        if f.dtype == STRING:
            lens = np.concatenate([b.columns[ci].data[:b.num_rows].cpu()
                                   .numpy() for b in batches])
            assert np.array_equal(np.where(valid, got[f.name][0].lengths, 0),
                                  np.where(valid, lens, 0))
            rows = [bytes(r[:n]) for b in batches for r, n in zip(
                b.columns[ci].chars[:b.num_rows].cpu().numpy(),
                b.columns[ci].data[:b.num_rows].cpu().numpy())]
            hs = got[f.name][0]
            back = [bytes(r[:n]) for r, n in zip(hs.chars, hs.lengths)]
            assert [r for r, v in zip(back, valid) if v] == \
                [r for r, v in zip(rows, valid) if v]
            continue
        data = np.concatenate([b.columns[ci].data[:b.num_rows].cpu().numpy()
                               for b in batches])
        assert np.array_equal(got[f.name][0][valid], data[valid])


@pytest.mark.cuda
@pytest.mark.parametrize("run", range(3))
def test_local_scan_prefetch_on_equals_off(run):
    """Prefetch on, the uploads run on the coalesce's background thread
    while the consumer's thread frees and launches on the same stream:
    the dictionary codes the group-by indexes with must land whole."""
    _card()
    n = 6 * (1 << 20) + 7
    schema, cols = _columns(n, 9 + run)
    data = {f.name: cols[f.name][0] for f in schema if f.dtype != STRING}
    rng = np.random.default_rng(run)
    data["e"] = np.array(["alpha", "beta", "gamma", "delta"])[
        rng.integers(0, 4, n)]
    out = {}
    for on in ("true", "false"):
        s = st.TorchSession({"spark.rapids.sql.io.prefetch.enabled": on})
        df = s.create_dataframe(data)
        out[on] = df.filter(F.col("i32") > 0).group_by(F.col("e"), F.col("b")) \
            .agg(F.sum(F.col("i64")).alias("x"),
                 F.count(F.col("f")).alias("n")) \
            .order_by(F.col("e"), F.col("b"))._host()
    assert out["true"].equals(out["false"])
    keep = data["i32"] > 0
    assert int(out["true"].columns["n"][0].sum()) == int(keep.sum())
