"""The torch port's window functions against the JAX package.

Analogs of ``tests/test_window.py`` for what the port runs: the ranking
functions; count, sum and avg over the default RANGE frame, ROWS frames
(running, sliding, suffix, strictly ahead), the whole partition and
value-based RANGE offsets (asc and desc, nulls and NaN among the order
values, an unbounded side, a bound that misses every value); a window
with no partition; desc order and integer sums; ``lag`` / ``lead`` with
defaults; null and string partition keys, null order keys; a window
over an expression; windows inside ``filter`` and ``order_by``; the
column names; a date order column under a RANGE offset; and
``bench.py``'s ``window_1m`` query at 20,000 rows; min, max and first
over a sliding frame, and last against Spark's definition.  What the
port cannot run raises: ``rank`` without an order and a bare window
function (as in the JAX package), and an offset RANGE frame over a
string order column (``ValueError``, as in the JAX package).

Both packages keep the input's row order and gain one column a
function, so results compare row for row.  Tolerance: ranks, counts,
lag/lead values and integer sums exact; a float sum or average within
``1e-12 * sum(|v|)`` over the whole input.  Both packages take a frame
sum as the difference of two global prefix sums in sorted order, so each
carries rounding on the scale of the prefix of |v| up to the frame's
end, which the whole input's sum of |v| bounds.
"""

import numpy as np
import pyarrow as pa
import pytest

from spark_rapids_tpu import Window as JWindow
from spark_rapids_tpu import functions as F
from tests.compare import tpu_session

import spark_rapids_tpu_torch as st
from spark_rapids_tpu_torch import functions as TF

JAX = (F, JWindow)
PORT = (TF, st.Window)
REL = 1e-12


def _port_session():
    return st.TorchSession({"spark.rapids.torch.device": "cpu"})


def _table(n=200, seed=3, with_nulls=True):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=n)
    return pa.table({
        "g": pa.array(rng.integers(0, 7, n), pa.int64()),
        "o": pa.array(rng.integers(0, 25, n), pa.int64()),  # ties
        "v": pa.array(v, pa.float64(),
                      mask=with_nulls and (rng.random(n) < 0.12)),
        "i": pa.array(rng.integers(-100, 100, n), pa.int64()),
    })


def _scale(table) -> float:
    if "v" not in table.column_names:
        return 0.0  # no float column to sum
    return float(np.nansum(np.abs(np.asarray(
        table.column("v").to_numpy(zero_copy_only=False), np.float64))))


def _check(table, build):
    """``build(api, df)`` through both packages; -> the port's table."""
    want = build(JAX, tpu_session().create_dataframe(table)).to_arrow()
    got = build(PORT, _port_session().create_dataframe(table)).to_arrow()
    assert got.schema == want.schema
    assert got.num_rows == want.num_rows
    atol = REL * _scale(table)
    for name in want.column_names:
        g, w = got.column(name).to_pylist(), want.column(name).to_pylist()
        if pa.types.is_floating(want.schema.field(name).type):
            assert [x is None for x in g] == [x is None for x in w], name
            a = np.array([np.nan if x is None else x for x in g])
            b = np.array([np.nan if x is None else x for x in w])
            np.testing.assert_allclose(a, b, rtol=0, atol=atol,
                                       equal_nan=True, err_msg=name)
        else:
            assert g == w, name
    return got


W = (lambda a: a[1].partition_by("g").order_by("o"))
W_TOTAL = (lambda a: a[1].partition_by("g").order_by("o", "i"))


@pytest.mark.parametrize("fn", ["row_number", "rank", "dense_rank"])
def test_ranking_functions(fn):
    # row_number over (o, i) is a total order; rank and dense_rank see
    # the ties in o
    _check(_table(), lambda a, df: df
           .with_column("r", getattr(a[0], fn)().over(W_TOTAL(a)))
           .with_column("r_ties", getattr(a[0], fn)().over(W(a))))


FRAMES = {
    "default": None,
    "rows_run": ("rows", JWindow.unboundedPreceding, 0),
    "sliding": ("rows", -3, 2),
    "suffix": ("rows", -2, JWindow.unboundedFollowing),
    "ahead": ("rows", 1, 3),  # can be empty
}


@pytest.mark.parametrize("frame", list(FRAMES))
def test_frame_aggregates(frame):
    fr = FRAMES[frame]

    def build(a, df):
        w = W(a) if fr is None else W(a).rows_between(fr[1], fr[2])
        return df.select("g", "o", *[
            getattr(a[0], f)(a[0].col("v")).over(w).alias(f)
            for f in ("count", "sum", "avg")])
    _check(_table(), build)


def test_whole_partition_frame():
    _check(_table(), lambda a, df: df.select(
        "g", a[0].sum(a[0].col("v")).over(a[1].partition_by("g"))
        .alias("s"),
        a[0].count(a[0].col("v")).over(a[1].partition_by("g")).alias("c")))


def test_global_window_no_partition():
    _check(_table(n=60), lambda a, df: df
           .with_column("rn", a[0].row_number().over(
               a[1].order_by("o", "i")))
           .with_column("s", a[0].sum(a[0].col("i")).over(
               a[1].order_by("o", "i"))))


def test_desc_order_and_int_aggregates():
    def build(a, df):
        w = a[1].partition_by("g").order_by(a[0].col("o").desc(), "i")
        return df.select("g", "o", "i",
                         a[0].row_number().over(w).alias("rn"),
                         a[0].sum(a[0].col("i")).over(w).alias("s"),
                         a[0].count("*").over(w).alias("n"))
    got = _check(_table(), build)
    assert got.schema.field("s").type == pa.int64()


def test_lag_lead_with_defaults():
    _check(_table(), lambda a, df: df.select(
        "g", "o", "i",
        a[0].lag(a[0].col("v"), 1).over(W_TOTAL(a)).alias("lg"),
        a[0].lag(a[0].col("i"), 3, -1).over(W_TOTAL(a)).alias("lg3"),
        a[0].lead(a[0].col("v"), 2).over(W_TOTAL(a)).alias("ld"),
        a[0].lead(a[0].col("i"), 1, 0).over(W_TOTAL(a)).alias("ld1")))


def test_lag_lead_exact_values():
    t = pa.table({"g": pa.array([0, 0, 0, 0], pa.int64()),
                  "o": pa.array([1, 2, 3, 4], pa.int64()),
                  "v": pa.array([10.0, 20.0, 30.0, 40.0])})
    got = _check(t, lambda a, df: df
                 .with_column("lg", a[0].lag(a[0].col("v"), 1).over(W(a)))
                 .with_column("ld", a[0].lead(a[0].col("v"), 1).over(W(a))))
    assert got.column("lg").to_pylist() == [None, 10.0, 20.0, 30.0]
    assert got.column("ld").to_pylist() == [20.0, 30.0, 40.0, None]


def test_null_partition_and_order_keys():
    t = pa.table({
        "g": pa.array([1, None, 1, None, 2, 2, None], pa.int64()),
        "o": pa.array([3, 1, None, 2, None, 1, 1], pa.int64()),
        "v": pa.array([1.0, 2.0, 3.0, 4.0, 5.0, None, 7.0], pa.float64()),
    })
    _check(t, lambda a, df: df.select(
        "g", "o", a[0].row_number().over(W(a)).alias("rn"),
        a[0].rank().over(W(a)).alias("rk"),
        a[0].sum(a[0].col("v")).over(W(a)).alias("s")))


def test_window_over_expression_and_composition():
    _check(_table(), lambda a, df: df.with_column(
        "z", a[0].sum(a[0].col("i") * 2).over(W_TOTAL(a)) + 1))


def test_rank_requires_order():
    with pytest.raises(ValueError):
        TF.rank().over(st.Window.partition_by("g"))


def test_bare_window_function_rejected():
    df = _port_session().create_dataframe(_table(n=10))
    with pytest.raises(ValueError):
        df.select(TF.row_number())


def test_window_in_filter_and_order_by():
    t = _table(n=80)
    # the top two of each group
    got = _check(t, lambda a, df: df.filter(
        a[0].row_number().over(W_TOTAL(a)) <= 2))
    assert got.column_names == ["g", "o", "v", "i"]
    got = _check(t, lambda a, df: df.order_by(
        a[0].rank().over(W_TOTAL(a)), "g"))
    assert got.column_names == ["g", "o", "v", "i"]


def test_window_column_names():
    got = _check(_table(n=20), lambda a, df: df.select(
        "g", a[0].row_number().over(W_TOTAL(a)),
        (a[0].sum(a[0].col("v")).over(W_TOTAL(a)) + 1).alias("a"),
        a[0].sum(a[0].col("v")).over(W_TOTAL(a))))
    names = got.column_names
    assert names[0] == "g" and "row_number()" in names[1]
    assert names[2] == "a" and "sum(v)" in names[3]
    assert not any("__w" in n for n in names)


@pytest.mark.parametrize("bounds", [(-5, 5), (-10, 0), (0, 8),
                                    (JWindow.unboundedPreceding, 3)],
                         ids=["pm5", "trailing", "leading", "unb_to_3"])
@pytest.mark.parametrize("desc", [False, True], ids=["asc", "desc"])
def test_range_offset_frames(bounds, desc):
    """Value-based RANGE frames over a numeric order column, with nulls
    in the value column."""
    def build(a, df):
        order = a[0].col("o").desc() if desc else "o"
        w = a[1].partition_by("g").order_by(order).range_between(*bounds)
        return df.select("g", "o", *[
            getattr(a[0], f)(a[0].col("v")).over(w).alias(f)
            for f in ("count", "sum", "avg")])
    _check(_table(), build)


def test_range_offset_frame_null_and_nan_order_rows():
    """Null and NaN order rows see exactly their peer group; a float
    order column with offsets."""
    t = pa.table({
        "g": pa.array([0, 0, 0, 0, 0, 1, 1, 1], pa.int64()),
        "o": pa.array([None, None, 1.0, 3.0, 10.0, float("nan"), 2.0,
                       float("nan")]),
        "v": pa.array([1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0]),
    })
    got = _check(t, lambda a, df: df.with_column(
        "sv", a[0].sum(a[0].col("v")).over(
            a[1].partition_by("g").order_by("o").range_between(-2, 2))))
    assert got.column("sv").to_pylist() == [3.0, 3.0, 12.0, 12.0, 16.0,
                                            160.0, 64.0, 160.0]


def test_range_unbounded_side_and_missed_bound():
    """An unbounded side is the partition's edge, null rows included; a
    bounded side that misses every value lands on the null run's edge."""
    t = pa.table({"g": pa.array([0, 0, 0], pa.int64()),
                  "o": pa.array([None, 1, 2], pa.int64()),
                  "v": pa.array([10.0, 1.0, 2.0])})

    def build(lo, hi):
        return lambda a, df: df.with_column(
            "sv", a[0].sum(a[0].col("v")).over(
                a[1].partition_by("g").order_by("o").range_between(lo, hi)))
    got = _check(t, build(JWindow.unboundedPreceding, 3))
    assert got.column("sv").to_pylist() == [10.0, 13.0, 13.0]
    got = _check(t, build(JWindow.unboundedPreceding, -10))
    assert got.column("sv").to_pylist() == [10.0, 10.0, 10.0]


def test_string_partition_keys():
    rng = np.random.default_rng(9)
    names = np.array(["", "a", "é", "a\x00", "long partition name", None],
                     dtype=object)
    t = pa.table({"s": pa.array(names[rng.integers(0, 6, 120)].tolist()),
                  "o": pa.array(rng.integers(0, 9, 120), pa.int64()),
                  "i": pa.array(rng.integers(-9, 9, 120), pa.int64())})
    _check(t, lambda a, df: df.select(
        "s", "o", a[0].dense_rank().over(
            a[1].partition_by("s").order_by("o")).alias("dr"),
        a[0].sum(a[0].col("i")).over(
            a[1].partition_by("s").order_by("o")).alias("run")))


def test_range_offset_over_a_date_order():
    rng = np.random.default_rng(4)
    t = pa.table({"g": pa.array(rng.integers(0, 3, 90), pa.int64()),
                  "d": pa.array(rng.integers(9000, 9040, 90).astype(np.int32),
                                pa.int32()).cast(pa.date32()),
                  "v": pa.array(rng.normal(size=90))})
    _check(t, lambda a, df: df.with_column(
        "s", a[0].sum(a[0].col("v")).over(
            a[1].partition_by("g").order_by("d").range_between(-3, 1))))


def test_window_1m_query():
    """``bench.py:q_window`` at 20,000 rows of ``gen_data``'s columns."""
    rng = np.random.default_rng(7)
    n = 20_000
    t = pa.table({"k": pa.array(rng.integers(0, 1000, n), pa.int64()),
                  "v": pa.array(rng.normal(size=n)),
                  "w": pa.array(rng.normal(size=n).astype(np.float32))})

    def build(a, df):
        w = a[1].partition_by("k").order_by("v")
        return (df.with_column("rn", a[0].row_number().over(w))
                .with_column("run", a[0].sum(a[0].col("v")).over(w))
                .filter(a[0].col("rn") <= 5))
    got = _check(t, build)
    assert got.num_rows == 5 * 1000


def _last_rows_reference(table, lo: int, hi: int):
    """Spark's ``last(v)`` (nulls ignored) over ROWS lo..hi of the
    partition by g in order o, ties in input order, in input order."""
    g = np.asarray(table.column("g").to_numpy())
    o = np.asarray(table.column("o").to_numpy())
    v = table.column("v").to_pylist()
    out = [None] * len(v)
    order = np.lexsort((o, g))
    for part in np.unique(g):
        rows = [r for r in order if g[r] == part]
        for j, r in enumerate(rows):
            frame = rows[max(0, j + lo):max(0, j + hi + 1)]
            vals = [v[q] for q in frame if v[q] is not None]
            out[r] = vals[-1] if vals else None
    return out


@pytest.mark.parametrize("fn", ["min", "max", "first", "last"])
def test_frame_extrema_raise_at_planning(fn):
    """Min, max, first and last over a frame, which the planner once
    refused, run equal to the JAX package's; ``last`` is held against
    Spark's definition, since the JAX package's window ``last`` returns
    the frame's first value (its ``Last`` subclasses ``First``)."""
    def build(a, df):
        w = a[1].partition_by("g").order_by("o").rows_between(-1, 1)
        return df.with_column("m", getattr(a[0], fn)(a[0].col("v")).over(w))
    if fn != "last":
        _check(_table(), build)
        return
    t = _table()
    got = build(PORT, _port_session().create_dataframe(t)).to_arrow()
    assert got.column("m").to_pylist() == _last_rows_reference(t, -1, 1)


def test_string_window_function_raises_at_planning():
    """String-typed window functions run now (``test_torch_window_frames
    .py``); an offset RANGE frame over a string order column still
    raises, a ``ValueError`` as in the JAX package."""
    df = _port_session().create_dataframe(
        {"g": np.array([1, 1, 2]), "o": np.array([1, 2, 3]),
         "s": np.array(["b", "a", "z"])})
    w = st.Window.partition_by("g").order_by("s").range_between(-1, 1)
    q = df.with_column("p", TF.count(st.col("o")).over(w))
    with pytest.raises(ValueError, match="offset RANGE frames need"):
        q.collect()
