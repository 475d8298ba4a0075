"""The torch port's mortgage ETL against the JAX package.

``gen_mortgage_numpy`` against ``gen_mortgage``'s parquet, column for
column; ``mortgage_etl`` through both packages from the same parquet
files, and through the port from the numpy tables, at 24,000 performance
rows (1,000 loans).  Tolerance: exact, except f64 averages (relative
1e-9, ``approx_float``), since the two packages add in different orders.
"""

import pyarrow.parquet as pq
import pytest

from spark_rapids_tpu.bench.mortgage import gen_mortgage
from spark_rapids_tpu.bench.mortgage import mortgage_etl as jax_etl
from tests.compare import assert_tables_equal, tpu_session

import spark_rapids_tpu_torch as st
from spark_rapids_tpu_torch.bench.mortgage import gen_mortgage_numpy, \
    mortgage_etl

PERF_ROWS = 24_000


@pytest.fixture(scope="module")
def mortgage(tmp_path_factory):
    """(parquet paths, numpy tables) of the same corpus."""
    paths = gen_mortgage(str(tmp_path_factory.mktemp("mortgage")),
                         perf_rows=PERF_ROWS)
    return paths, gen_mortgage_numpy(PERF_ROWS)


def test_gen_mortgage_numpy_equals_gen_mortgage(mortgage):
    paths, tables = mortgage
    assert list(tables) == list(paths)
    for name, path in paths.items():
        want = pq.read_table(path)
        got = tables[name]
        assert list(got) == want.column_names, name
        for c in want.column_names:
            w = want.column(c).to_numpy(zero_copy_only=False)
            if w.dtype.kind != "O":
                assert got[c].dtype == w.dtype, (name, c)
            assert got[c].tolist() == w.tolist(), (name, c)


def test_mortgage_etl_matches_jax(mortgage):
    paths, tables = mortgage
    want = jax_etl(tpu_session(), paths).to_arrow()
    loans = PERF_ROWS // 24
    assert sum(want.column("loans").to_pylist()) == loans
    session = st.TorchSession({"spark.rapids.torch.device": "cpu"})
    for source in (paths, tables):
        got = mortgage_etl(session, source).to_arrow()
        assert_tables_equal(got, want, ignore_order=False,
                            approx_float=True)
