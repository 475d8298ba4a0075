"""The torch port's other sixteen TPC-H queries against the JAX package.

q2, q4, q7, q8, q9, q11, q12, q13, q14, q15, q16, q17, q19, q20, q21 and
q22 (the six ``bench.py`` runs are in ``tests/test_torch_tpch.py``) at
4,000 lineitem rows, through both packages' sessions from the same
parquet files and through the port from ``gen_tpch_numpy``'s tables.
q2 runs at 20,000 rows: at 4,000 no part passes its filters.  They
exercise CASE WHEN (q8, q12, q14), ``year`` (q7, q8, q9), ``isin`` (q16,
q22), ``substring`` (q22), ``distinct`` (q16, q21), constant-key joins
of a one-row aggregate (q11, q15, q22), a left join whose count skips
the nulls it makes (q13) and two-key joins (q9, q20).  Tolerance: exact,
except f64 sums and averages (relative 1e-9, ``approx_float``), since
the two packages add in different orders.  Also: the aggregate's
sorted path adds float sums in one fixed order (row order on the CPU;
the same sums bit for bit on every call on the card, a ``cuda`` test),
since Q15 compares two evaluations of one sum for equality.
"""

import numpy as np
import pytest
import torch

from spark_rapids_tpu.bench.tpch import TPCH_QUERIES as JAX_QUERIES
from spark_rapids_tpu.bench.tpch import gen_tpch
from spark_rapids_tpu.bench.tpch import load_tables as jload
from tests.compare import assert_tables_equal, tpu_session

import spark_rapids_tpu_torch as st
from spark_rapids_tpu_torch.bench.tpch import BENCH_QUERIES, TPCH_QUERIES, \
    gen_tpch_numpy
from spark_rapids_tpu_torch.bench.tpch import load_tables as tload
from spark_rapids_tpu_torch.exec.aggregate import _segment
from tests.torch_threads import _one_torch_thread  # noqa: F401

ROWS = {"q2": 20_000}
OTHERS = [q for q in TPCH_QUERIES if q not in BENCH_QUERIES]


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """{lineitem rows: (parquet paths, numpy tables)} of each size."""
    out = {}
    for rows in sorted({ROWS.get(q, 4000) for q in OTHERS}):
        paths = gen_tpch(str(tmp_path_factory.mktemp(f"tpch{rows}")),
                         lineitem_rows=rows)
        out[rows] = paths, gen_tpch_numpy(rows)
    return out


def test_all_22_queries_are_ported():
    assert list(TPCH_QUERIES) == list(JAX_QUERIES)
    assert len(OTHERS) == 16


@pytest.mark.parametrize("qname", OTHERS)
def test_tpch_query_matches_jax(corpora, qname):
    paths, tables = corpora[ROWS.get(qname, 4000)]
    want = JAX_QUERIES[qname](jload(tpu_session(), paths)).to_arrow()
    assert want.num_rows > 0
    session = st.TorchSession({"spark.rapids.torch.device": "cpu"})
    got = TPCH_QUERIES[qname](tload(session, paths)).to_arrow()
    assert_tables_equal(got, want, ignore_order=False, approx_float=True)
    from_numpy = TPCH_QUERIES[qname](tload(session, tables)).to_arrow()
    assert_tables_equal(from_numpy, want, ignore_order=False,
                        approx_float=True)


def _sorted_sums(device):
    """A float sum a group on the aggregate's sorted path: 2^16 rows of
    revenue-like values in 3,000 groups -> (gid, values, sums)."""
    rng = np.random.default_rng(15)
    gid = torch.from_numpy(np.sort(rng.integers(0, 3000, 1 << 16))) \
        .to(device)
    v = torch.from_numpy(rng.uniform(900, 105_000, 1 << 16)).to(device)
    return gid, v, _segment("add", v, gid, 1 << 16)


def test_sorted_path_float_sums_add_in_row_order():
    """Q15 keeps the suppliers whose revenue sum equals the maximum of a
    second evaluation of the same sum, so the sorted path's float sums
    take one fixed order: on the CPU, row order, bit for bit what
    ``index_add_`` gives."""
    gid, v, got = _sorted_sums("cpu")
    want = torch.zeros_like(got).index_add_(0, gid, v)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_sorted_path_float_sums_repeat_on_the_card():
    """On the card the same sums come out bit for bit alike on every
    call (``index_add_``'s atomics gave a new rounding each time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the sums' order on the card")
    first = _sorted_sums("cuda")[2]
    for _ in range(4):
        assert torch.equal(_sorted_sums("cuda")[2], first)
    gid, v, cpu = _sorted_sums("cpu")
    torch.testing.assert_close(first.cpu(), cpu, rtol=1e-12, atol=0)
