"""The torch port's shuffle exchange against the JAX package.

``repartition`` by the hash of int, string and float keys (NaN, -0.0,
subnormal-free), null keys and several keys; round-robin over several
input batches (its start carried from batch to batch); single mode;
``repartition_by_range`` ascending and descending, with nulls, over a
string key, over more than 10,000 rows in several batches, and with
``spark.rapids.sql.rangePartitioning.sampleSize`` set in both sessions
(at 2, below one row a batch, the ``default_rng(42)`` subsample of the
pooled sample runs); each collected whole
with ``spark_partition_id()`` beside the rows.  Both packages return the
partitions in order, each partition's rows in input order, and number a
batch after the exchange by its ordinal (empty partitions skipped), so
rows compare exactly and in order.  Also: ``compute_range_bounds``
against the JAX package's on random key tuples, the unsigned remainder
at INT64_MIN and -1, and ``shufflePartitionBytes``.
"""

import jax
import numpy as np
import pyarrow as pa
import pytest

from spark_rapids_tpu import api as japi
from spark_rapids_tpu import functions as F
from spark_rapids_tpu.plan import logical as jlp
from tests.compare import assert_tables_equal, tpu_session

import spark_rapids_tpu_torch as st
from spark_rapids_tpu_torch import api as tapi
from spark_rapids_tpu_torch import functions as TF
from spark_rapids_tpu_torch.plan import logical as tlp
from tests.torch_threads import _one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True, scope="module")
def _drop_compiled_kernels():
    """After this file, drop the JAX package's compiled executables (its
    kernel caches and jax's own), as ``tests/conftest.py`` does between
    files once they pile up: the JAX side of these parity tests compiles
    a kernel for each new shape, and a worker process that holds too
    many crashes XLA."""
    yield
    from spark_rapids_tpu.utils import kernel_cache
    with kernel_cache._REGISTRY_LOCK:
        caches = list(kernel_cache._REGISTRY)
    for c in caches:
        c.clear()
    jax.clear_caches()


WORDS = np.array(["", "apple", "banana split", "cherry", "é", "zz top",
                  "a rather long value of thirty bytes"], dtype=object)


def _table(n, seed):
    rng = np.random.default_rng(seed)
    f = rng.normal(size=n)
    f[rng.random(n) < 0.05] = np.nan
    f[rng.random(n) < 0.05] = -0.0
    f[rng.random(n) < 0.05] = 0.0
    return pa.table({
        "i": pa.array(rng.integers(-1000, 1000, n), pa.int64(),
                      mask=rng.random(n) < 0.07),
        "j": pa.array(rng.integers(0, 5, n), pa.int32()),
        "s": pa.array(WORDS[rng.integers(0, len(WORDS), n)].tolist(),
                      mask=rng.random(n) < 0.07),
        "f": pa.array(f, mask=rng.random(n) < 0.05),
        "d": pa.array(rng.integers(8000, 9000, n).astype(np.int32),
                      pa.int32()).cast(pa.date32()),
    })


def _port():
    return st.TorchSession({"spark.rapids.torch.device": "cpu"})


def _frames(s, tables):
    df = s.create_dataframe(tables[0])
    for t in tables[1:]:
        df = df.union(s.create_dataframe(t))
    return df


def _check(build, tables):
    want = build(F, _frames(tpu_session(), tables)).to_arrow()
    got = build(TF, _frames(_port(), tables)).to_arrow()
    assert got.schema == want.schema
    assert_tables_equal(got, want, ignore_order=False)
    return got


def _with_pid(f, df):
    return df.select(*df.columns, f.spark_partition_id().alias("pid"))


HASH_KEYS = {"int": ["i"], "string": ["s"], "float": ["f"], "date": ["d"],
             "several": ["j", "s", "f"]}


@pytest.mark.parametrize("keys", sorted(HASH_KEYS))
def test_hash_repartition_matches_jax(keys):
    tables = [_table(1500, 1), _table(900, 2)]
    got = _check(lambda f, df: _with_pid(
        f, df.repartition(6, *HASH_KEYS[keys])), tables)
    assert got.num_rows == 2400


def test_round_robin_and_single_match_jax():
    tables = [_table(700, 3), _table(501, 4), _table(333, 5)]
    got = _check(lambda f, df: _with_pid(f, df.repartition(5)), tables)
    assert sorted(set(got.column("pid").to_pylist())) == [0, 1, 2, 3, 4]
    # one partition: every batch concatenated into one
    got = _check(lambda f, df: _with_pid(f, df.repartition(1, "i")), tables)
    assert set(got.column("pid").to_pylist()) == {0}

    def single(f, df):
        lp, api = (jlp, japi) if f is F else (tlp, tapi)
        return _with_pid(f, api.DataFrame(df.session, lp.Repartition(
            4, [], df.plan, mode="single")))
    _check(single, tables)


RANGE_ORDERS = {
    "float_asc": lambda f: [f.col("f")],
    "float_desc": lambda f: [f.col("f").desc()],
    "int_nulls_desc": lambda f: [f.col("i").desc(), "j"],
    "string": lambda f: ["s"],
    "string_desc_date": lambda f: [f.col("s").desc(), f.col("d")],
}


@pytest.mark.parametrize("name", sorted(RANGE_ORDERS))
def test_range_repartition_matches_jax(name):
    tables = [_table(1200, 6), _table(800, 7)]
    _check(lambda f, df: _with_pid(
        f, df.repartition_by_range(5, *RANGE_ORDERS[name](f))), tables)


def test_range_repartition_subsamples_as_jax():
    """More than 10,000 rows over three batches: the bounds come from
    each batch's share of the 10,000 samples (the shares are floored, so
    the pooled sample stays within the default size)."""
    tables = [_table(5000, 8), _table(4000, 9), _table(3500, 10)]
    got = _check(lambda f, df: _with_pid(
        f, df.repartition_by_range(8, f.col("i").desc(), "s")), tables)
    assert got.num_rows == 12_500
    # the partitions' key ranges do not overlap
    i = got.column("i").to_pylist()
    pid = got.column("pid").to_pylist()
    hi = {}
    for v, p in zip(i, pid):
        if v is not None:
            hi.setdefault(p, []).append(v)
    parts = sorted(hi)
    for a, b in zip(parts, parts[1:]):
        assert min(hi[a]) >= max(hi[b])


@pytest.mark.parametrize("size", [500, 2])
def test_range_sample_size_key_matches_jax(size, monkeypatch):
    """The sample size key set in both sessions.  At 500 the batches
    sample fewer rows than at the default; at 2 each of the three
    batches still gives one row, so the pooled sample of 3 is above the
    key and the ``default_rng(42)`` subsample runs."""
    from spark_rapids_tpu_torch.exec import exchange as tex
    real, pooled = tex.compute_range_bounds, []

    def spy(key_rows, num_parts, sample_max=10_000):
        pooled.append((sum(len(k[0]) for k in key_rows), sample_max))
        return real(key_rows, num_parts, sample_max)
    monkeypatch.setattr(tex, "compute_range_bounds", spy)
    key = "spark.rapids.sql.rangePartitioning.sampleSize"
    tables = [_table(5000, 8), _table(4000, 9), _table(3500, 10)]

    def build(f, df):
        return _with_pid(f, df.repartition_by_range(
            8, f.col("i").desc(), "s"))
    want = build(F, _frames(tpu_session({key: size}), tables)).to_arrow()
    got = build(TF, _frames(st.TorchSession(
        {"spark.rapids.torch.device": "cpu", key: size}), tables)).to_arrow()
    assert got.schema == want.schema
    assert_tables_equal(got, want, ignore_order=False)
    rows, used = pooled[-1]
    assert used == size and (rows > size) == (size == 2)
    # the key moved the bounds: the partition ids differ from the default's
    default = build(TF, _frames(_port(), tables)).to_arrow()
    assert got.column("pid").to_pylist() != default.column(
        "pid").to_pylist()


def test_compute_range_bounds_matches_jax():
    from spark_rapids_tpu.exec.exchange import compute_range_bounds as jcrb
    from spark_rapids_tpu_torch.exec.exchange import \
        compute_range_bounds as tcrb
    rng = np.random.default_rng(12)
    for n_batches, rows, parts, sample in [(1, 50, 4, 10_000),
                                           (3, 6000, 7, 10_000),
                                           (4, 900, 16, 1000),
                                           (2, 3, 8, 10_000)]:
        key_rows = [(rng.integers(0, 2, rows).astype(np.int32),
                     rng.integers(-5, 5, rows),
                     rng.normal(size=rows))
                    for _ in range(n_batches)]
        want = jcrb(key_rows, parts, sample_max=sample)
        got = tcrb(key_rows, parts, sample_max=sample)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert np.array_equal(g, w)
    assert tcrb([], 4) is None and jcrb([], 4) is None


def test_unsigned_mod_edges():
    import torch
    from spark_rapids_tpu_torch.exec.exchange import unsigned_mod
    h = np.array([np.iinfo(np.int64).min, -1, -2, 0, 1,
                  np.iinfo(np.int64).max, -12345678901234567], np.int64)
    for n in (1, 2, 3, 6, 7, 16, 200):
        got = unsigned_mod(torch.from_numpy(h), n).numpy()
        want = (h.astype(np.uint64) % np.uint64(n)).astype(np.int64)
        assert np.array_equal(got, want), n


def test_partition_bytes_metric():
    s = _port()
    df = s.create_dataframe(_table(1000, 11))
    df.repartition(4, "j").count()
    ex = s._last_plan
    while type(ex).__name__ != "TorchShuffleExchangeExec":
        ex = ex.children[0]
    # 1000 rows: i 9 bytes, j 5, f 9, d 5, and s its width + 5
    width = 64
    assert ex.metrics["shufflePartitionBytes"] == 1000 * (9 + 5 + 9 + 5) \
        + 1000 * (width + 5)
    assert ex.metrics["hostSyncs"] == 1
