"""The torch port's out-of-memory retry against the JAX package.

Analogs of ``tests/test_oom_retry.py`` for the port
(``spark_rapids_tpu_torch/utils/retry.py`` and the operators that call
it).  Each retry site raises ``torch.OutOfMemoryError`` from its own
work, injected from outside the package by wrapping the function the
site runs:

- the fused stage (``exec/stage.py: emit_steps``), the aggregate's
  update on the sorted route (``exec/aggregate.py: make_agg_body``) and
  on the dense-slot route (``exec/pallas_agg.py: make_update``), the FK
  and general join probes (``TorchHashJoinExec._fk``, ``._general``)
  fail twice, so relief fails too and the batch splits; the sort
  (``exec/sort.py: sort_batch``) and the window
  (``TorchWindowExec._window``) fail once and retry whole; the
  exchange's hash and range partitioning (``exec/exchange.py:
  partition_batch``, ``partition_batch_by_range``) split, its
  round-robin partitioning retries whole (a row's partition depends on
  its position);
- each result equals the JAX package's on the same input, uninjected,
  and the port's own uninjected run;
- an error that is not an out-of-memory error propagates at once, with
  no retry, at every site; an out-of-memory error that persists raises
  ``torch.OutOfMemoryError`` where no split is allowed, and splits to
  the depth it needs where one is;
- ``with_retry`` itself: the relief before the second attempt, the
  split's own relief, and the failed attempt's tensors freed before the
  next attempt runs.

Tolerance: exact, except float sums, which a split adds in another
order (relative 1e-9, ``approx_float``), and the window's running sums
(1e-12 of the input's sum of |v|).
"""

import weakref

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu import Window as JWindow
from spark_rapids_tpu import functions as F
from tests.compare import assert_tables_equal, tpu_session

import spark_rapids_tpu_torch as st
from spark_rapids_tpu_torch import functions as TF
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch, \
    host_batch_to_device, host_columns_from_numpy
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.exec import aggregate as agg_mod
from spark_rapids_tpu_torch.exec import exchange as exch_mod
from spark_rapids_tpu_torch.exec import pallas_agg as pag
from spark_rapids_tpu_torch.exec import sort as sort_mod
from spark_rapids_tpu_torch.exec import stage as stage_mod
from spark_rapids_tpu_torch.exec.joins import TorchHashJoinExec
from spark_rapids_tpu_torch.exec.window import TorchWindowExec
from spark_rapids_tpu_torch.utils.retry import is_device_oom, \
    split_batch_half, with_retry

N = 3000
CPU = {"spark.rapids.torch.device": "cpu"}


def _fact(n=N, seed=29):
    rng = np.random.default_rng(seed)
    return pa.table({
        "k": pa.array(rng.integers(0, 1000, n), pa.int64(),
                      mask=rng.random(n) < 0.02),
        "k2": pa.array(rng.integers(0, 1_000_000, n) // 40, pa.int64()),
        "v": pa.array(rng.normal(size=n), mask=rng.random(n) < 0.02),
        "w": pa.array(rng.normal(size=n).astype(np.float32)),
        "s": pa.array([f"item-{i % 53}" for i in range(n)]),
    })


def _dim(seed=31):
    rng = np.random.default_rng(seed)
    return pa.table({"k": pa.array(np.arange(1000), pa.int64()),
                     "grp": pa.array(rng.integers(0, 50, 1000), pa.int64())})


def q_stage(fns, W, fact, dim):
    return fact.filter(fns.col("v") > 0.0).select(
        fns.col("k"), (fns.col("v") * 2.0 + 1.0).alias("a"), fns.col("s"))


def q_agg_sorted(fns, W, fact, dim):
    return fact.group_by("k2").agg(
        fns.sum(fns.col("v")).alias("sv"), fns.count(fns.col("v")).alias("c"),
        fns.max(fns.col("w")).alias("mx"), fns.min(fns.col("k")).alias("mn"))


def q_agg_dense(fns, W, fact, dim):
    return fact.group_by("k").agg(
        fns.sum(fns.col("v")).alias("sv"), fns.count(fns.col("v")).alias("c"),
        fns.max(fns.col("w")).alias("mx"), fns.min(fns.col("v")).alias("mn"))


def q_join_fk(fns, W, fact, dim):
    return fact.join(dim, on="k")


def q_join_general(fns, W, fact, dim):
    return fact.join(dim, on="k", how="left")


def q_sort(fns, W, fact, dim):
    return fact.order_by(fns.col("v"), fns.col("s"), fns.col("k2"))


def q_window(fns, W, fact, dim):
    w = W.partition_by("k").order_by("k2")
    return fact.select(fns.col("k"), fns.col("k2"), fns.col("v"),
                       fns.row_number().over(w).alias("rn"),
                       fns.sum(fns.col("v")).over(w).alias("run"))


def q_exchange_hash(fns, W, fact, dim):
    return fact.repartition(4, "k2").select(
        fns.col("k"), fns.col("k2"), fns.col("s"),
        fns.spark_partition_id().alias("p"))


def q_exchange_range(fns, W, fact, dim):
    return fact.repartition_by_range(4, fns.col("v").desc()).select(
        fns.col("k"), fns.col("v"), fns.spark_partition_id().alias("p"))


def q_exchange_roundrobin(fns, W, fact, dim):
    return fact.repartition(4).select(
        fns.col("k"), fns.col("s"), fns.spark_partition_id().alias("p"))


def _rows_arg(i):
    return lambda a, k: a[i]


def _rows_of_batch(i):
    return lambda a, k: a[i].num_rows


class _Factory:
    """Wraps a factory (``make_agg_body``, ``make_update``) so that the
    function it makes is wrapped by ``inject``; ``update_only`` leaves
    the merge's functions alone."""

    def __init__(self, real, inject, update_only):
        self.real, self.inject, self.update_only = real, inject, update_only

    def __call__(self, *a, **k):
        fn = self.real(*a, **k)
        if self.update_only and a[1] != "update":
            return fn
        return self.inject.wrap(fn, _rows_arg(1))


# site -> (query, owner, attribute, how the site's rows are read, factory
# that needs its made function wrapped (None: wrap the attribute), split)
SITES = {
    "stage": (q_stage, stage_mod, "emit_steps", _rows_arg(2), None, True),
    "aggregate_sorted": (q_agg_sorted, agg_mod, "make_agg_body", None,
                         "update", True),
    "aggregate_dense": (q_agg_dense, pag, "make_update", None, "all",
                        True),
    "join_fk": (q_join_fk, TorchHashJoinExec, "_fk", _rows_of_batch(1),
                None, True),
    "join_general": (q_join_general, TorchHashJoinExec, "_general",
                     _rows_of_batch(1), None, True),
    "sort": (q_sort, sort_mod, "sort_batch", _rows_of_batch(1), None,
             False),
    "window": (q_window, TorchWindowExec, "_window", _rows_of_batch(1),
               None, False),
    "exchange_hash": (q_exchange_hash, exch_mod, "partition_batch",
                      _rows_of_batch(0), None, True),
    "exchange_range": (q_exchange_range, exch_mod,
                       "partition_batch_by_range", _rows_of_batch(0), None,
                       True),
    "exchange_roundrobin": (q_exchange_roundrobin, exch_mod,
                            "partition_batch", _rows_of_batch(0), None,
                            False),
}


class _Inject:
    """Raises ``make_error()`` on the first ``fails`` calls, and on every
    call whose rows exceed ``rows_over``; counts calls and their rows."""

    def __init__(self, fails=0, rows_over=None,
                 make_error=lambda: torch.OutOfMemoryError(
                     "CUDA out of memory. Tried to allocate 2.00 GiB "
                     "(injected)")):
        self.left = fails
        self.rows_over = rows_over
        self.make_error = make_error
        self.rows = []
        self.failed = 0

    def wrap(self, fn, rows_of):
        def wrapper(*a, **k):
            rows = rows_of(a, k)
            self.rows.append(rows)
            if self.left > 0 or (self.rows_over is not None
                                 and rows > self.rows_over):
                self.left = max(0, self.left - 1)
                self.failed += 1
                raise self.make_error()
            return fn(*a, **k)
        return wrapper


def _install(monkeypatch, site, inject):
    _q, owner, attr, rows_of, factory, _split = SITES[site]
    real = getattr(owner, attr)
    if factory is not None:
        monkeypatch.setattr(owner, attr,
                            _Factory(real, inject, factory == "update"))
    else:
        monkeypatch.setattr(owner, attr, inject.wrap(real, rows_of))


def _port(query):
    s = st.TorchSession(CPU)
    fact, dim = _fact(), _dim()
    df = query(TF, st.Window, s.create_dataframe(fact),
               s.create_dataframe(dim))
    return df.to_arrow(), s


@pytest.fixture(scope="module")
def jax_results():
    s = tpu_session()
    out = {}
    for site, (query, *_rest) in SITES.items():
        out[site] = query(F, JWindow, s.create_dataframe(_fact()),
                          s.create_dataframe(_dim())).to_arrow()
    return out


def _check(site, got, want):
    if site == "window":
        key = [("k", "ascending"), ("rn", "ascending")]
        g, w = got.sort_by(key), want.sort_by(key)
        for c in ("k", "k2", "v", "rn"):
            assert g.column(c).equals(w.column(c)), c
        gr = g.column("run").to_numpy(zero_copy_only=False)
        wr = w.column("run").to_numpy(zero_copy_only=False)
        scale = float(np.nansum(np.abs(
            g.column("v").to_numpy(zero_copy_only=False))))
        assert np.array_equal(np.isnan(gr), np.isnan(wr))
        assert np.nanmax(np.abs(gr - wr)) <= 1e-12 * scale
    elif site == "sort" or site.startswith("exchange"):
        # the rows come in one order: a split's halves partition each
        # row as the whole batch does, the first half's rows first
        assert got.equals(want)
    else:
        assert_tables_equal(got, want, approx_float=True)


@pytest.mark.parametrize("site", list(SITES))
def test_injected_oom_equals_the_jax_package(site, jax_results,
                                             monkeypatch):
    plain, _ = _port(SITES[site][0])
    splits = SITES[site][5]
    inject = _Inject(fails=2 if splits else 1)
    _install(monkeypatch, site, inject)
    got, s = _port(SITES[site][0])
    if splits:
        # whole, whole after relief, then the two halves
        assert inject.failed == 2
        assert inject.rows[:2] == [inject.rows[0]] * 2
        assert sorted(inject.rows[2:4]) == sorted(
            [inject.rows[0] // 2, inject.rows[0] - inject.rows[0] // 2])
    else:
        assert inject.failed == 1 and inject.rows == [N, N]
    _check(site, got, jax_results[site])
    _check(site, got, plain)
    if site == "aggregate_dense":
        # both halves took the dense-slot kernel at their own capacity
        agg = _find(s._last_plan, "TorchHashAggregateExec")
        assert agg.metrics["pallasAggBatches"] == 2
    assert s.runtime.catalog.audit_leaks() == 0


@pytest.mark.parametrize("site", list(SITES))
def test_other_errors_propagate_without_retry(site, monkeypatch):
    inject = _Inject(fails=1, make_error=lambda: ValueError("not memory"))
    _install(monkeypatch, site, inject)
    with pytest.raises(ValueError, match="not memory"):
        _port(SITES[site][0])
    assert len(inject.rows) == 1


@pytest.mark.parametrize("site", ["join_fk", "aggregate_dense", "stage"])
def test_persistent_oom_splits_to_the_depth_it_needs(site, jax_results,
                                                     monkeypatch):
    inject = _Inject(rows_over=N // 3)
    _install(monkeypatch, site, inject)
    got, _ = _port(SITES[site][0])
    # 3000 -> 1500 -> 750 rows: two levels of halves
    assert max(r for r in inject.rows if r <= N // 3) <= N // 4 + 1
    assert sum(1 for r in inject.rows if r <= N // 3) == 4
    _check(site, got, jax_results[site])


@pytest.mark.parametrize("site", ["sort", "window"])
def test_persistent_oom_without_a_split_raises(site, monkeypatch):
    inject = _Inject(rows_over=0)
    _install(monkeypatch, site, inject)
    with pytest.raises(torch.OutOfMemoryError, match="injected"):
        _port(SITES[site][0])
    assert inject.rows == [N, N]  # the attempt and the one after relief


def test_persistent_oom_past_the_split_depth_raises(monkeypatch):
    inject = _Inject(rows_over=1)
    _install(monkeypatch, "join_fk", inject)
    with pytest.raises(torch.OutOfMemoryError):
        _port(q_join_fk)


# ---------------------------------------------------------------------------
# with_retry and the split
# ---------------------------------------------------------------------------

class _Catalog:
    def __init__(self):
        self.spill_all_calls = 0

    def spill_all(self):
        self.spill_all_calls += 1
        return 0


class _Ctx:
    def __init__(self):
        class _R:
            pass
        self.runtime = _R()
        self.runtime.catalog = _Catalog()


class _Rows:
    def __init__(self, n):
        self.num_rows = n


def _halves(b):
    return [_Rows(b.num_rows // 2), _Rows(b.num_rows - b.num_rows // 2)]


def test_is_device_oom():
    assert is_device_oom(torch.OutOfMemoryError("anything"))
    assert is_device_oom(RuntimeError("CUDA out of memory. Tried to ..."))
    assert is_device_oom(RuntimeError("RESOURCE_EXHAUSTED: hbm"))
    assert is_device_oom(RuntimeError("Out of memory while allocating"))
    assert not is_device_oom(ValueError("bad input"))
    assert not is_device_oom(RuntimeError("CUDA error: misaligned address"))


def test_relief_runs_before_the_second_attempt():
    ctx = _Ctx()
    calls = []

    def fn(b):
        calls.append(ctx.runtime.catalog.spill_all_calls)
        if len(calls) == 1:
            raise torch.OutOfMemoryError("once")
        return b.num_rows

    assert with_retry(fn, _Rows(8), ctx) == [8]
    assert calls == [0, 1]


def test_split_gets_its_own_relief():
    ctx = _Ctx()
    split_calls = []

    def flaky_split(b):
        split_calls.append(b.num_rows)
        if len(split_calls) == 1:
            raise torch.OutOfMemoryError("halves")
        return _halves(b)

    def fn(b):
        if b.num_rows > 4:
            raise torch.OutOfMemoryError("too big")
        return b.num_rows

    assert with_retry(fn, _Rows(8), ctx, split=flaky_split) == [4, 4]
    assert split_calls == [8, 8]
    assert ctx.runtime.catalog.spill_all_calls == 2


def test_failed_attempts_tensors_are_freed_before_the_retry():
    seen = []

    def fn(b):
        if not seen:
            big = torch.empty(1 << 20)
            seen.append(weakref.ref(big))
            raise torch.OutOfMemoryError("after an allocation")
        # the first attempt's tensor is gone by the time it runs again
        seen.append(seen[0]() is None)
        return b.num_rows

    assert with_retry(fn, _Rows(8), _Ctx()) == [8]
    assert seen[1] is True


def test_split_batch_half_keeps_every_row_and_column():
    rng = np.random.default_rng(3)
    n = 1000
    data = {"i": rng.integers(-5, 5, n), "f": rng.normal(size=n),
            "s": np.array([("x" * (i % 40)) or None for i in range(n)],
                          dtype=object)}
    schema, cols = host_columns_from_numpy(
        data, {"f": rng.random(n) > 0.1})
    b = host_batch_to_device(schema, cols, torch.device("cpu"))
    lo, hi = split_batch_half(b)
    assert (lo.num_rows, hi.num_rows) == (500, 500)
    assert lo.capacity == hi.capacity == 512 and b.capacity == 1024
    for part, start in ((lo, 0), (hi, 500)):
        for c, pc in zip(b.columns, part.columns):
            assert torch.equal(pc.data[:500], c.data[start:start + 500])
            assert torch.equal(pc.validity[:500],
                               c.validity[start:start + 500])
            assert not pc.validity[500:].any()
            if c.chars is not None:
                assert pc.string_width == c.string_width
                assert torch.equal(pc.chars[:500],
                                   c.chars[start:start + 500])
                assert not pc.chars[500:].any()
    # the halves of a full bucket are views of the batch's planes
    full = ColumnarBatch([DeviceColumn(c.dtype, c.data[:1000].repeat(2)[
        :1024], c.validity.clone(), 1024, c.chars) for c in b.columns],
        1024, b.schema)
    lo, hi = split_batch_half(full)
    for c, lc, hc in zip(full.columns, lo.columns, hi.columns):
        assert lc.data.data_ptr() == c.data.data_ptr()
        assert hc.data.data_ptr() == c.data[512:].data_ptr()
        assert torch.equal(hc.validity, c.validity[512:])
    odd = b.slice_rows(1, 3)
    assert odd.num_rows == 3 and odd.capacity == 8
    with pytest.raises(ValueError):
        b.slice_rows(900, 200)


def test_dense_slot_kernel_takes_a_split_half():
    """The dense-slot update on a split half, at the half's capacity,
    equals the update on the whole batch restricted to the half's rows:
    every count, integer sum, min and max exact."""
    rng = np.random.default_rng(5)
    n = 4096
    data = {"k": rng.integers(0, 1000, n), "i": rng.integers(-9, 9, n),
            "w": rng.normal(size=n).astype(np.float32)}
    schema, cols = host_columns_from_numpy(data)
    b = host_batch_to_device(schema, cols, torch.device("cpu"))
    s = st.TorchSession(CPU)
    df = s.create_dataframe(data).group_by("k").agg(
        TF.count(TF.col("i")).alias("c"), TF.sum(TF.col("i")).alias("si"),
        TF.max(TF.col("w")).alias("mx"))
    df.to_arrow()
    agg = _find(s._last_plan, "TorchHashAggregateExec")
    lo, hi = split_batch_half(b)
    for half, sl in ((lo, slice(0, n // 2)), (hi, slice(n // 2, n))):
        out = agg._run_phase("update", half, s.conf)
        assert out.capacity == 1024  # K = 1024 slots for keys 0..999
        keys = data["k"][sl]
        got_keys = out.columns[0].data[:out.num_rows].numpy()
        assert np.array_equal(got_keys, np.unique(keys))
        counts = out.columns[1].data[:out.num_rows].numpy()
        assert np.array_equal(counts, np.unique(keys, return_counts=True)[1])
    assert agg.metrics["pallasAggBatches"] == 3


def _find(plan, name):
    if type(plan).__name__ == name:
        return plan
    for c in plan.children:
        r = _find(c, name)
        if r is not None:
            return r
    return None
