"""``rand``, ``monotonically_increasing_id`` and ``spark_partition_id``
in the torch port against the JAX package.

``rand(seed)`` is the JAX package's threefry stream keyed by (seed,
partition), where the partition is the batch's ordinal in its stage's
input: bit for bit equal (compared as int64 bit patterns) for several
seeds (negative and above 2^32 too), over one batch and over several
(parquet row groups read 512 rows a batch), after a filter in the same
stage, and against ``jax.random.uniform`` itself.  The ids and partition
numbers are exact.  A stage that holds a nondeterministic expression
retries an injected out-of-memory error without splitting its batch
(``exec/stage.py``), so its values do not change, and a nondeterministic
expression outside a projection or filter is refused, as in the JAX
package.
"""

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import jax
import jax.numpy as jnp

from spark_rapids_tpu import functions as F
from spark_rapids_tpu.api import col
from tests.compare import assert_tables_equal, tpu_session

import spark_rapids_tpu_torch as st
from spark_rapids_tpu_torch import functions as TF
from spark_rapids_tpu_torch.exec import stage as stage_mod
from spark_rapids_tpu_torch.exprs.nondeterministic import uniform_doubles

CONF = {"spark.rapids.sql.incompatibleOps.enabled": True,
        "spark.rapids.sql.reader.batchSizeRows": 512}
SEEDS = [0, 42, -7, 2 ** 40 + 5]


def _port():
    return st.TorchSession({"spark.rapids.torch.device": "cpu", **CONF})


def _bits(table, name):
    return np.asarray(table.column(name).to_numpy(zero_copy_only=False),
                      np.float64).view(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_stream_equals_jax_random_uniform(seed):
    for pid in (0, 1, 5):
        key = jax.random.fold_in(jax.random.PRNGKey(seed),
                                 jnp.asarray(pid, jnp.uint32))
        want = np.asarray(jax.random.uniform(key, (4096,),
                                             dtype=jnp.float64))
        got = uniform_doubles(seed, pid, 4096, "cpu").numpy()
        assert np.array_equal(got.view(np.int64), want.view(np.int64))


@pytest.fixture(scope="module")
def parquet_path(tmp_path_factory):
    rng = np.random.default_rng(4)
    n = 3000
    t = pa.table({"id": pa.array(np.arange(n)),
                  "v": pa.array(rng.normal(size=n))})
    path = str(tmp_path_factory.mktemp("rand") / "t.parquet")
    pq.write_table(t, path, row_group_size=512)
    return path


@pytest.mark.parametrize("seed", SEEDS)
def test_rand_over_batches_matches_jax_bit_for_bit(parquet_path, seed):
    def build(c, fns, s):
        return s.read.parquet(parquet_path).select(
            "id", fns.rand(seed).alias("r"),
            fns.monotonically_increasing_id().alias("mid"),
            fns.spark_partition_id().alias("pid")).to_arrow()
    want = build(col, F, tpu_session(CONF))
    got = build(st.col, TF, _port())
    assert got.column("id").to_pylist() == want.column("id").to_pylist()
    assert np.array_equal(_bits(got, "r"), _bits(want, "r"))
    assert_tables_equal(got.drop(["r"]), want.drop(["r"]),
                        ignore_order=False)
    assert set(got.column("pid").to_pylist()) == set(range(6))


def test_rand_after_a_filter_matches_jax(parquet_path):
    def build(c, fns, s):
        return s.read.parquet(parquet_path).filter(c("v") > 0).select(
            "id", fns.rand(11).alias("r")).to_arrow()
    want = build(col, F, tpu_session(CONF))
    got = build(st.col, TF, _port())
    assert np.array_equal(_bits(got, "r"), _bits(want, "r"))


def test_rand_through_sql_matches_jax():
    t = pa.table({"k": pa.array(np.arange(700) % 9)})
    js, ts = tpu_session(CONF), _port()
    js.create_dataframe(t).create_or_replace_temp_view("t")
    ts.create_dataframe(t).create_or_replace_temp_view("t")
    q = "SELECT k, rand(42) r FROM t WHERE k > 2"
    assert np.array_equal(_bits(ts.sql(q).to_arrow(), "r"),
                          _bits(js.sql(q).to_arrow(), "r"))


def test_nondeterministic_stage_retries_without_splitting(monkeypatch,
                                                          parquet_path):
    """An injected device OOM on each batch's first attempt: the stage
    retries the whole batch (no halves), so the ids and the stream stay
    those of the run without the error."""
    s = _port()

    def run():
        return s.read.parquet(parquet_path).select(
            TF.rand(5).alias("r"),
            TF.monotonically_increasing_id().alias("mid")).to_arrow()
    want = run()
    real = stage_mod.emit_steps
    seen = []

    def failing(steps, cols, num_rows, *a, **k):
        seen.append(num_rows)
        if len(seen) % 2:
            raise torch.OutOfMemoryError("CUDA out of memory (injected)")
        return real(steps, cols, num_rows, *a, **k)
    monkeypatch.setattr(stage_mod, "emit_steps", failing)
    got = run()
    assert np.array_equal(_bits(got, "r"), _bits(want, "r"))
    assert got.column("mid").to_pylist() == want.column("mid").to_pylist()
    # every attempt saw a whole batch
    assert set(seen) <= {512, 3000 - 5 * 512}


def test_nondeterministic_outside_a_projection_is_refused():
    df = _port().create_dataframe({"k": np.arange(10)})
    with pytest.raises(ValueError, match="nondeterministic"):
        df.group_by("k").agg(TF.sum(TF.rand(1)).alias("s")).collect()
