"""The kernels under dictionary-encoded columns, on the card.

K2 on a dictionary's planes (a ``contains`` over an encoded column
evaluates once over its dictionary) and K1 on a code-domain update batch
(a group-by on one encoded key), each against its plain PyTorch version
on the same card tensors; K2 exactly, K1's counts, integer sums and
maxima exactly and its f64 sums within 1e-12 of each slot's sum of
|v|.  Marked ``cuda``: each test skips itself without a card.  The file
imports neither JAX nor pyarrow, so it runs on the card's machine:

    python -m pytest tests/test_torch_compressed_card.py -q
"""

import numpy as np
import pytest
import torch

import spark_rapids_tpu_torch as st
from spark_rapids_tpu_torch import functions as F
from spark_rapids_tpu_torch import native
from spark_rapids_tpu_torch.columnar import encoding
from spark_rapids_tpu_torch.columnar.batch import strings_from_numpy
from spark_rapids_tpu_torch.columnar.dtypes import STRING

SHIP_INSTRUCT = np.array(["DELIVER IN PERSON", "COLLECT COD", "NONE",
                          "TAKE BACK RETURN"])


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")


@pytest.mark.cuda
def test_contains_kernel_on_the_dictionary():
    _card()
    from spark_rapids_tpu_torch.exprs import pallas_strings as ps
    rng = np.random.default_rng(8)
    n = 1 << 18
    data = {"s": SHIP_INSTRUCT[rng.integers(0, 4, n)],
            "v": rng.integers(0, 9, n)}
    s = st.TorchSession({})
    before = native.LAUNCHES["contains"]
    got = s.create_dataframe(data).filter(
        F.contains(F.col("s"), "DELIVER IN PERSON")).agg(
        F.count(F.col("v")).alias("c")).collect()
    torch.cuda.synchronize()
    assert got == [{"c": int((data["s"] == "DELIVER IN PERSON").sum())}]
    assert native.LAUNCHES["contains"] == before + 1
    hs, valid = strings_from_numpy(SHIP_INSTRUCT)
    col = encoding.IngestEncoder("cuda", max_dict_fraction=1.0) \
        .upload_column(hs, valid, STRING, 8)
    d = col.dict
    for pat in (b"DELIVER IN PERSON", b"TAKE BACK RETURN",
                b"COLLECT COD AND MORE"):
        assert torch.equal(ps.run_contains(d.chars, d.lengths, pat),
                           ps.contains_reference(d.chars, d.lengths, pat))


@pytest.mark.cuda
def test_dense_slot_kernel_on_a_code_domain_batch():
    _card()
    from spark_rapids_tpu_torch.exec import pallas_agg as pag
    from spark_rapids_tpu_torch.exprs.base import colvals
    rng = np.random.default_rng(9)
    n = 1 << 18
    modes = np.array(["AIR", "FOB", "MAIL", "RAIL", "REG AIR", "SHIP",
                      "TRUCK"])
    data = {"m": modes[rng.integers(0, 7, n)], "q": rng.normal(size=n),
            "k": rng.integers(0, 50, n).astype(np.int32)}
    s = st.TorchSession({})
    q = s.create_dataframe(data).group_by("m").agg(
        F.count(F.col("k")).alias("c"), F.sum(F.col("q")).alias("s"),
        F.max(F.col("k")).alias("mx"))
    before = native.LAUNCHES["dense_slot_reduce"]
    rows = q.collect()
    torch.cuda.synchronize()
    assert native.LAUNCHES["dense_slot_reduce"] > before
    assert [r["m"] for r in rows] == list(modes)
    # the update batch through the aggregate's own code view
    from spark_rapids_tpu_torch.exec.base import ExecContext
    from spark_rapids_tpu_torch.plan.planner import plan_query
    root = plan_query(q.plan)
    agg = root
    while type(agg).__name__ != "TorchHashAggregateExec":
        agg = agg.children[0]
    batch = next(iter(agg.children[0].execute(ExecContext(s.conf,
                                                          s.device))))
    spec, vbatch, wrap = agg._agg_view("update", batch)
    assert wrap and pag.supports(spec)
    cols = colvals(vbatch.columns)
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
