"""The plane encodings' decodes and K1 over a decoded RLE key, on the
card.

The three decodes (``_rle_dense``, ``_delta_dense``, ``_packed_dense``,
torch ops) on CUDA tensors equal the same calls on the CPU bit for bit,
an INT32 column whose int16 deltas sum past 2^31 included; K1 on the
update batch of a group-by over an RLE key (decoded in the update by
``plane_view``) against its plain PyTorch version on the same card
tensors: counts, integer sums and maxima exactly, f64 sums within 1e-12
of each slot's sum of |v|.  Marked ``cuda``: each test skips itself
without a card.  The file imports neither JAX nor pyarrow, so it runs
on the card's machine:

    python -m pytest tests/test_torch_planes_card.py -q --noconftest
"""

import numpy as np
import pytest
import torch

import spark_rapids_tpu_torch as st
from spark_rapids_tpu_torch import functions as F
from spark_rapids_tpu_torch import native
from spark_rapids_tpu_torch.columnar import encoding
from spark_rapids_tpu_torch.columnar.dtypes import BOOLEAN, INT32, INT64


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")


def _encode(monkeypatch, values, valid, dtype, device):
    for name in ("_RLE", "_DELTA", "_PACKED"):
        monkeypatch.setattr(encoding, name, True)
    from spark_rapids_tpu_torch.columnar.column import bucket_capacity
    return encoding.IngestEncoder(device).upload_column(
        values, valid, dtype, bucket_capacity(len(values)))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["rle", "delta_int8", "delta_int32_wrap",
                                  "packed"])
def test_decodes_on_the_card_equal_the_cpu(monkeypatch, case):
    _card()
    rng = np.random.default_rng(12)
    n = (1 << 20) + 3
    valid = np.ones(n, np.bool_)
    if case == "rle":
        values = np.sort(rng.integers(0, 1000, n)).astype(np.int64)
        valid = rng.random(n) > 0.05
        dtype, kind = INT64, encoding.RleColumn
    elif case == "delta_int8":
        values = np.cumsum(rng.integers(0, 3, n)).astype(np.int64)
        dtype, kind = INT64, encoding.DeltaColumn
    elif case == "delta_int32_wrap":
        values = (-2 ** 31 + 10 + 2000 * np.arange(n, dtype=np.int64)) \
            .astype(np.int32)
        dtype, kind = INT32, encoding.DeltaColumn
    else:
        values = rng.random(n) < 0.3
        valid = rng.random(n) > 0.1
        dtype, kind = BOOLEAN, encoding.PackedBoolColumn
    got = _encode(monkeypatch, values, valid, dtype, "cuda")
    want = _encode(monkeypatch, values, valid, dtype, "cpu")
    assert isinstance(got, kind) and isinstance(want, kind)
    dense = got.dense_data()
    torch.cuda.synchronize()
    assert dense.is_cuda
    assert torch.equal(dense.cpu(), want.dense_data())
    assert np.array_equal(dense[:n].cpu().numpy()[valid], values[valid])


@pytest.mark.cuda
def test_dense_slot_kernel_over_a_decoded_rle_key():
    _card()
    from spark_rapids_tpu_torch.exec import pallas_agg as pag
    from spark_rapids_tpu_torch.exec.base import ExecContext
    from spark_rapids_tpu_torch.plan.planner import plan_query
    rng = np.random.default_rng(13)
    n = 1 << 20
    data = {"k": np.sort(rng.integers(0, 1000, n)),
            "v": rng.normal(size=n),
            "w": rng.integers(-50, 50, n).astype(np.int32)}
    s = st.TorchSession({})
    q = s.create_dataframe(data).group_by("k").agg(
        F.count(F.col("v")).alias("c"), F.sum(F.col("v")).alias("s"),
        F.max(F.col("w")).alias("mx"))
    before = native.LAUNCHES["dense_slot_reduce"]
    late = encoding.compressed_stats()["late_decodes"]
    rows = q.collect()
    torch.cuda.synchronize()
    assert native.LAUNCHES["dense_slot_reduce"] > before
    assert encoding.compressed_stats()["late_decodes"] == late
    assert len(rows) == len(np.unique(data["k"]))
    agg = plan_query(q.plan)
    while type(agg).__name__ != "TorchHashAggregateExec":
        agg = agg.children[0]
    batch = next(iter(agg.children[0].execute(ExecContext(s.conf,
                                                          s.device))))
    assert isinstance(batch.columns[0], encoding.RleColumn)
    spec, vbatch, _ = agg._agg_view("update", batch)
    cols = encoding.plane_view(vbatch.columns)
    lo, hi = pag.key_range(spec.groupings[0], cols, vbatch.num_rows,
                           vbatch.capacity)
    K = pag.slot_count(lo, hi)
    gid, planes, ops, _ = pag.update_planes(spec, cols, vbatch.num_rows,
                                            vbatch.capacity, lo, K)
    got = pag.dense_slot_reduce(gid, planes, ops, K)
    want = pag.dense_slot_reduce_reference(gid, planes, ops, K)
    for p, op, g, w in zip(planes, ops, got, want):
        if p.dtype.is_floating_point and op == "add":
            scale = pag.dense_slot_reduce_reference(gid, [p.abs()], ["add"],
                                                    K)[0]
            assert torch.all((g - w).abs() <= 1e-12 * scale + 1e-300)
        else:
            assert torch.equal(g, w), (p.dtype, op)
