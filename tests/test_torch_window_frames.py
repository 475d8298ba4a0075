"""The torch port's window min, max, first and last over every frame
shape, and its string-typed window functions, against the JAX package.

Min and max select a row and return its value, so the row chosen among
tied values shows in the sign of a zero: the JAX package takes the
latest tied row in a frame from the partition's start (its forward
scan), and the earliest in a frame to the partition's end (the reverse
scan), in one bounded on both sides (the sparse table) and in an offset
RANGE frame.  The values hold NaN, -0.0 and 0.0, +-inf and nulls, the
order keys tie, and every frame shape runs: the default RANGE frame, the
whole partition, ROWS from the start, ROWS to the end, ROWS bounded on
both sides (also a frame that can be empty), and RANGE offsets over an
integer, a double and a date order column.  Floats compare exactly, sign
of zero included; the others exactly.

String-typed lag, lead (with a default), count, min, max, first and last
run on the JAX package's CPU engine and on the port's device path.  An
offset RANGE frame over a string order column raises ``ValueError`` in
both packages.
"""

import math

import jax
import numpy as np
import pyarrow as pa
import pytest

from spark_rapids_tpu import Window as JWindow
from spark_rapids_tpu import functions as F
from tests.compare import assert_tables_equal, tpu_session

import spark_rapids_tpu_torch as st
from spark_rapids_tpu_torch import functions as TF
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


JAX = (F, JWindow)
PORT = (TF, st.Window)
U_PRE, U_FOL = JWindow.unboundedPreceding, JWindow.unboundedFollowing

SPECIALS = [np.nan, -0.0, 0.0, np.inf, -np.inf]


def _table(n=900, seed=4):
    rng = np.random.default_rng(seed)
    v = np.round(rng.normal(size=n), 1)
    pick = rng.random(n)
    v[pick < 0.25] = np.array(SPECIALS)[rng.integers(0, 5, n)][pick < 0.25]
    w = rng.integers(-3, 3, n).astype(np.float32) * 0.0  # signed zeros
    w[rng.random(n) < 0.5] *= -1
    return pa.table({
        "g": pa.array(rng.integers(0, 6, n), pa.int64()),
        "o": pa.array(rng.integers(0, 40, n), pa.int64()),  # ties
        "of": pa.array(rng.integers(0, 40, n) * 0.5,
                       mask=rng.random(n) < 0.05),
        "od": pa.array(rng.integers(9000, 9040, n).astype(np.int32),
                       pa.int32()).cast(pa.date32()),
        "v": pa.array(v, mask=rng.random(n) < 0.1),
        "w": pa.array(np.where(rng.random(n) < 0.3, -0.0, w), pa.float32()),
        "i": pa.array(rng.integers(-20, 20, n), pa.int64(),
                      mask=rng.random(n) < 0.1),
        "s": pa.array(np.array(["", "b", "ab", "abc", "zz", "é", "a b"],
                               dtype=object)[rng.integers(0, 7, n)].tolist(),
                      mask=rng.random(n) < 0.1),
    })


def _signs(col):
    return [None if x is None or (isinstance(x, float) and math.isnan(x))
            else math.copysign(1.0, x) if isinstance(x, float) else x
            for x in col.to_pylist()]


def _check(build, t=None, jconf=None):
    t = _table() if t is None else t
    want = build(JAX, tpu_session(jconf).create_dataframe(t)).to_arrow()
    got = build(PORT, st.TorchSession(
        {"spark.rapids.torch.device": "cpu"}).create_dataframe(t)).to_arrow()
    assert got.schema == want.schema
    assert_tables_equal(got, want, ignore_order=False)
    for name in want.column_names:
        if pa.types.is_floating(want.schema.field(name).type):
            assert _signs(got.column(name)) == _signs(want.column(name)), \
                name
    return got


FRAMES = {
    "default": None,
    "whole": ("rows", U_PRE, U_FOL),
    "from_start": ("rows", U_PRE, 1),
    "to_end": ("rows", -1, U_FOL),
    "bounded": ("rows", -3, 2),
    "ahead": ("rows", 2, 4),  # may be empty
    "range_int": ("range", -3, 2),
    "range_int_preceding": ("range", U_PRE, 4),
    "range_int_following": ("range", -2, U_FOL),
}


@pytest.mark.parametrize("frame", sorted(FRAMES))
def test_frame_extrema_match_jax(frame):
    fr = FRAMES[frame]

    def build(a, df):
        w = a[1].partition_by("g").order_by("o")
        if fr is not None:
            w = getattr(w, f"{fr[0]}_between")(fr[1], fr[2])
        f = a[0]
        return df.select(
            "g", "o",
            f.min(f.col("v")).over(w).alias("min_v"),
            f.max(f.col("v")).over(w).alias("max_v"),
            f.min(f.col("w")).over(w).alias("min_w"),
            f.max(f.col("w")).over(w).alias("max_w"),
            f.min(f.col("i")).over(w).alias("min_i"),
            f.max(f.col("i")).over(w).alias("max_i"),
            f.first(f.col("v")).over(w).alias("first_v"),
            f.first(f.col("i")).over(w).alias("first_i"))
    _check(build)


@pytest.mark.parametrize("order", ["of", "od"])
def test_range_offsets_over_double_and_date_match_jax(order):
    def build(a, df):
        f = a[0]
        w = a[1].partition_by("g").order_by(f.col(order).desc()) \
            .range_between(-2, 1)
        return df.select(
            "g", order, f.min(f.col("v")).over(w).alias("lo"),
            f.max(f.col("w")).over(w).alias("hi"),
            f.first(f.col("i")).over(w).alias("fi"))
    _check(build)


STRING_FRAMES = {
    "default": None,
    "whole": ("rows", U_PRE, U_FOL),
    "to_end": ("rows", 0, U_FOL),
    "bounded": ("rows", -5, 0),
    "range_int": ("range", -2, 3),
}


@pytest.mark.parametrize("frame", sorted(STRING_FRAMES))
def test_string_window_functions_match_jax(frame):
    fr = STRING_FRAMES[frame]

    def build(a, df):
        f = a[0]
        base = a[1].partition_by("g").order_by("o")
        w = base if fr is None else \
            getattr(base, f"{fr[0]}_between")(fr[1], fr[2])
        return df.select(
            "g", "o", "s",
            f.lag(f.col("s")).over(base).alias("lag1"),
            f.lead(f.col("s"), 2, "none").over(base).alias("lead2"),
            f.count(f.col("s")).over(w).alias("n"),
            f.min(f.col("s")).over(w).alias("lo"),
            f.max(f.col("s")).over(w).alias("hi"),
            f.first(f.col("s")).over(w).alias("fs"))
    _check(build, jconf={"spark.rapids.sql.test.enabled": False})


MIRRORED = {
    "rows_bounded": ("rows", -3, 2),
    "rows_from_start": ("rows", U_PRE, 1),
    "rows_to_end": ("rows", -2, U_FOL),
    "whole": ("rows", U_PRE, U_FOL),
    "range": ("range", -7, 4),
}


@pytest.mark.parametrize("frame", sorted(MIRRORED))
def test_last_is_the_mirrored_first(frame):
    """``last`` is held against the JAX package's ``first`` over the
    mirrored frame in the reversed order, since the JAX package's own
    window ``last`` returns the frame's first value (its ``Last``
    subclasses ``First``, and both of its engines test for ``First``
    before ``Last``).  The order key is unique, so the reversed order
    is the descending one."""
    kind, lo, hi = MIRRORED[frame]
    rng = np.random.default_rng(9)
    n = 700
    t = _table(n, 13).append_column("u", pa.array(
        rng.permutation(n) * 3, pa.int64()))

    def mirror(b):
        return {U_PRE: U_FOL, U_FOL: U_PRE}.get(b, -b)

    def build(a, df, fn, w):
        f = a[0]
        return df.select("u", *[getattr(f, fn)(f.col(c)).over(w).alias(c)
                                for c in ("v", "w", "i", "s")])
    jw = JWindow.partition_by("g").order_by(F.col("u").desc())
    jw = getattr(jw, f"{kind}_between")(mirror(hi), mirror(lo))
    want = build(JAX, tpu_session({"spark.rapids.sql.test.enabled": False})
                 .create_dataframe(t), "first", jw).to_arrow()
    pw = getattr(st.Window.partition_by("g").order_by("u"),
                 f"{kind}_between")(lo, hi)
    got = build(PORT, st.TorchSession({"spark.rapids.torch.device": "cpu"})
                .create_dataframe(t), "last", pw).to_arrow()
    assert_tables_equal(got, want, ignore_order=False)
    for name in ("v", "w"):
        assert _signs(got.column(name)) == _signs(want.column(name))


def test_offset_range_over_string_order_raises_in_both():
    t = _table(40)
    for (f, win), s in ((JAX, tpu_session(
            {"spark.rapids.sql.test.enabled": False})),
            (PORT, st.TorchSession({"spark.rapids.torch.device": "cpu"}))):
        w = win.partition_by("g").order_by("s").range_between(-1, 1)
        q = s.create_dataframe(t).select(
            f.count(f.col("v")).over(w).alias("n"))
        with pytest.raises(ValueError, match="offset RANGE frames need"):
            q.collect()


def test_sparse_table_depth_follows_the_rows_frame():
    """A ROWS frame 5 wide builds 3 levels over its rank column; the
    value-searched RANGE frame the full depth of the batch."""
    import torch
    from spark_rapids_tpu_torch.exec import window as tw
    built = []
    real = tw._sparse_table

    def spy(*args, **kw):
        table = real(*args, **kw)
        built.append(table.shape[0])
        return table

    tw._sparse_table = spy
    try:
        df = st.TorchSession({"spark.rapids.torch.device": "cpu"}) \
            .create_dataframe(_table(300))
        w = st.Window.partition_by("g").order_by("o")
        df.select(TF.min(TF.col("v")).over(w.rows_between(-2, 2))
                  .alias("m")).collect()
        df.select(TF.min(TF.col("v")).over(w.range_between(-2, 2))
                  .alias("m")).collect()
    finally:
        tw._sparse_table = real
    # a level 0 and the levels above it; 300 rows: capacity 512, 9 levels
    assert built == [1 + 3, 1 + 9]
