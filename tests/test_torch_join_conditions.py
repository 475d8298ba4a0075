"""Join conditions on left, right, full, semi and anti joins.

The port evaluates such a condition over each stream row's verified
candidate pairs (``exec/joins.py: _pair_condition``), before it counts
the matches, so an outer join null-extends a row none of whose pairs
holds the condition, a semi join keeps a row with at least one and an
anti join a row with none.  The JAX package refuses a condition on
these join types on both of its engines (its device join, and its CPU
engine's ``CpuHashJoinExec``), and its SQL parser refuses the ON terms,
so the reference is built from what the JAX session does compute: the
inner join under the same keys and condition (its device path), whose
pairs carry each side's row id (``lid``, ``rid``).  A left row whose id
is in no such pair is null-extended (left, full) or kept (anti), a
right row likewise (right, full), and a semi join keeps the left rows
that appear.  Every join type runs with conditions that name the left
side, the right side, both, and nullable strings; with and without
equi keys (a keyless join pairs every row; its reference is the JAX
package's cross join under the condition); through the broadcast, the
swapped-broadcast, the shuffled and the adaptive plan shapes.  TPC-H
Q13's official text (``LEFT OUTER JOIN orders ON c_custkey = o_custkey
AND o_comment NOT LIKE '%special%requests%'``) runs through the port's
``session.sql`` over ``gen_tpch_numpy`` at 4,000 lineitem rows, with
adaptive execution off and on, against the JAX session's SQL with the
condition moved into a filtered subquery (the same result, as the
condition names the right side only).
"""

import numpy as np
import pyarrow as pa
import pytest

from spark_rapids_tpu.api import DataFrame as JDataFrame
from spark_rapids_tpu.exprs import predicates as jpr
from spark_rapids_tpu.exprs.base import Literal as JLiteral
from spark_rapids_tpu.exprs.base import UnresolvedAttribute as JAttr
from spark_rapids_tpu.plan import logical as jlp
from tests.compare import assert_tables_equal, tpu_session

import spark_rapids_tpu_torch as st
from spark_rapids_tpu_torch.api import DataFrame as TDataFrame
from spark_rapids_tpu_torch.exprs import predicates as tpr
from spark_rapids_tpu_torch.exprs.base import Literal as TLiteral
from spark_rapids_tpu_torch.exprs.base import UnresolvedAttribute as TAttr
from spark_rapids_tpu_torch.plan import logical as tlp
from spark_rapids_tpu_torch.plan.adaptive import find_adaptive
from tests.torch_threads import _one_torch_thread  # noqa: F401

CPU = {"spark.rapids.torch.device": "cpu"}
JOIN_TYPES = ["left", "right", "full", "semi", "anti", "inner"]
LEFT_COLS = ["lid", "k", "v", "s"]
RIGHT_COLS = ["rid", "k2", "w", "t"]


def _side(seed: int, n: int, names, nkeys: int = 12) -> pa.Table:
    """An id, a nullable int64 key with duplicates, a nullable double
    and a nullable string, from ``default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    rid, key, val, txt = names

    def nulls(p):
        return rng.random(n) < p
    k = rng.integers(0, nkeys, n)
    kn = nulls(0.08)
    v = rng.normal(size=n)
    vn = nulls(0.1)
    s = rng.choice(["a", "b", "c", "xyz"], n)
    sn = nulls(0.1)
    return pa.table({
        rid: pa.array(np.arange(n, dtype=np.int64)),
        key: pa.array([None if m else int(x) for x, m in zip(k, kn)],
                      pa.int64()),
        val: pa.array([None if m else float(x) for x, m in zip(v, vn)],
                      pa.float64()),
        txt: pa.array([None if m else str(x) for x, m in zip(s, sn)],
                      pa.string()),
    })


# (left rows, right rows) of each table variant; "swap" makes the left
# side the small one, so only it fits the swapped shape's threshold
SIZES = {"base": (300, 120), "swap": (120, 300), "keyless": (60, 40)}


def tables(variant: str):
    nl, nr = SIZES[variant]
    return _side(1, nl, LEFT_COLS), _side(2, nr, RIGHT_COLS)


def condition(name: str, pkg: str):
    """The condition ``name`` as the JAX package's (``pkg="jax"``) or
    the port's expression."""
    pr, A, L = (jpr, JAttr, JLiteral) if pkg == "jax" \
        else (tpr, TAttr, TLiteral)
    if name == "left_only":
        return pr.GreaterThan(A("v"), L(0.0))
    if name == "right_only":
        return pr.LessThan(A("w"), L(0.5))
    if name == "both":
        return pr.GreaterThan(A("v"), A("w"))
    if name == "nullable_strings":
        # null unless both strings are there; null counts as false
        return pr.Or(pr.Not(pr.EqualTo(A("s"), A("t"))), pr.IsNull(A("v")))
    raise ValueError(name)


CONDITIONS = ["left_only", "right_only", "both", "nullable_strings"]

_REFS = {}


def _nulls_like(table: pa.Table, n: int) -> dict:
    return {f.name: pa.nulls(n, f.type) for f in table.schema}


def reference(variant: str, cond: str, keyless: bool = False) -> dict:
    """{join type: expected table}, from the JAX session's inner (or
    cross) join under the condition and the row ids of its pairs."""
    key = (variant, cond, keyless)
    if key in _REFS:
        return _REFS[key]
    left, right = tables(variant)
    js = tpu_session()
    lp_, rp_ = (js.create_dataframe(t).plan for t in (left, right))
    plan = jlp.Join(lp_, rp_, [] if keyless else [JAttr("k")],
                    [] if keyless else [JAttr("k2")],
                    "cross" if keyless else "inner",
                    condition=condition(cond, "jax"))
    pairs = JDataFrame(js, plan).to_arrow()
    assert pairs.column_names == LEFT_COLS + RIGHT_COLS
    lids = set(pairs.column("lid").to_pylist())
    rids = set(pairs.column("rid").to_pylist())
    lmask = np.array([i in lids for i in left.column("lid").to_pylist()])
    rmask = np.array([i in rids for i in right.column("rid").to_pylist()])
    l_un = left.filter(pa.array(~lmask))
    r_un = right.filter(pa.array(~rmask))
    l_ext = pa.table({**{c: l_un.column(c) for c in LEFT_COLS},
                      **_nulls_like(right, l_un.num_rows)})
    r_ext = pa.table({**_nulls_like(left, r_un.num_rows),
                      **{c: r_un.column(c) for c in RIGHT_COLS}})
    pairs = pairs.cast(l_ext.schema)
    out = {"inner": pairs,
           "left": pa.concat_tables([pairs, l_ext]),
           "right": pa.concat_tables([pairs, r_ext.cast(l_ext.schema)]),
           "full": pa.concat_tables([pairs, l_ext, r_ext.cast(
               l_ext.schema)]),
           "semi": left.filter(pa.array(lmask)),
           "anti": l_un}
    _REFS[key] = out
    return out


SHAPES = {
    # the right side (120 rows) under the default threshold
    "broadcast": ("base", {}),
    # only the left side (120 rows) under the threshold: the swapped
    # broadcast for left, right and full joins
    "swapped": ("swap", {"spark.sql.autoBroadcastJoinThreshold": 4_000}),
    "shuffled": ("base", {"spark.sql.autoBroadcastJoinThreshold": -1}),
    # adaptive: both sides shuffled, the build promoted at run time
    "adaptive": ("base", {"spark.rapids.sql.adaptive.enabled": "true"}),
    "adaptive_shuffled": ("base", {
        "spark.rapids.sql.adaptive.enabled": "true",
        "spark.sql.autoBroadcastJoinThreshold": -1}),
}


def _walk(plan):
    yield plan
    for c in plan.children:
        yield from _walk(c)


def port_join(variant, conf, jt, cond, keyless=False):
    left, right = tables(variant)
    ts = st.TorchSession({**CPU, **conf})
    lp_, rp_ = (ts.create_dataframe(t).plan for t in (left, right))
    plan = tlp.Join(lp_, rp_, [] if keyless else [TAttr("k")],
                    [] if keyless else [TAttr("k2")], jt,
                    condition=condition(cond, "torch"))
    return TDataFrame(ts, plan).to_arrow(), ts


def _check_shape(shape: str, jt: str, ts) -> None:
    nodes = list(_walk(ts._last_plan))
    joins = [n for n in nodes if hasattr(n, "join_type")]
    (join,) = joins
    kind = type(join).__name__
    if shape == "broadcast":
        assert kind == "TorchBroadcastHashJoinExec" and join.join_type == jt
    elif shape == "swapped":
        mirror = {"left": "right", "right": "left"}.get(jt, jt)
        if jt in ("semi", "anti"):
            assert kind == "TorchHashJoinExec"  # never swapped
        else:
            assert kind == "TorchBroadcastHashJoinExec"
            assert join.join_type == mirror
            assert join.output_schema.names[:4] == RIGHT_COLS
    elif shape == "shuffled":
        assert kind == "TorchHashJoinExec"
    else:
        assert find_adaptive(ts._last_plan) is not None
    if jt != "inner":
        assert join.route == "general"


@pytest.mark.parametrize("jt", JOIN_TYPES)
@pytest.mark.parametrize("cond", CONDITIONS)
@pytest.mark.parametrize("shape", list(SHAPES))
def test_join_condition_matches_jax(shape, cond, jt):
    variant, conf = SHAPES[shape]
    got, ts = port_join(variant, conf, jt, cond)
    want = reference(variant, cond)[jt]
    assert got.column_names == want.column_names
    assert_tables_equal(got, want)
    _check_shape(shape, jt, ts)


@pytest.mark.parametrize("jt", JOIN_TYPES)
@pytest.mark.parametrize("cond", ["both", "nullable_strings"])
def test_keyless_join_condition_matches_jax(cond, jt):
    """No equi keys: every pair is a candidate and the condition alone
    decides (the broadcast and the shuffled shapes)."""
    want = reference("keyless", cond, keyless=True)[jt]
    for conf in ({}, {"spark.sql.autoBroadcastJoinThreshold": -1}):
        got, _ = port_join("keyless", conf, jt, cond, keyless=True)
        assert_tables_equal(got, want)


def test_null_extension_is_per_row_not_per_pair():
    """A stream row with three key matches that all fail the condition
    is null-extended once; a build row's matches count only the pairs
    that hold (a right join emits a build row unmatched when its only
    key match fails)."""
    ts = st.TorchSession(CPU)
    left = ts.create_dataframe({"k": np.array([1, 2], np.int64),
                                "v": np.array([0.0, 5.0])})
    right = ts.create_dataframe({"k2": np.array([1, 1, 1, 2], np.int64),
                                 "w": np.array([1.0, 2.0, 3.0, 4.0])})
    cond = tpr.GreaterThan(TAttr("v"), TAttr("w"))

    def run(jt):
        plan = tlp.Join(left.plan, right.plan, [TAttr("k")], [TAttr("k2")],
                        jt, condition=cond)
        return sorted(TDataFrame(ts, plan).collect(),
                      key=lambda r: tuple((x is None, x)
                                          for x in r.values()))

    assert run("left") == [
        {"k": 1, "v": 0.0, "k2": None, "w": None},
        {"k": 2, "v": 5.0, "k2": 2, "w": 4.0}]
    assert run("right") == [
        {"k": 2, "v": 5.0, "k2": 2, "w": 4.0},
        {"k": None, "v": None, "k2": 1, "w": 1.0},
        {"k": None, "v": None, "k2": 1, "w": 2.0},
        {"k": None, "v": None, "k2": 1, "w": 3.0}]
    assert len(run("full")) == 5
    assert run("semi") == [{"k": 2, "v": 5.0}]
    assert run("anti") == [{"k": 1, "v": 0.0}]


def test_condition_binds_against_both_sides_on_semi_and_anti():
    """A semi or anti join's output holds the left side alone, yet its
    condition names the right side's columns: it binds against the left
    fields followed by the right fields."""
    from spark_rapids_tpu_torch.exprs.base import BoundReference
    from spark_rapids_tpu_torch.plan.planner import plan_query
    left, right = tables("base")
    ts = st.TorchSession(CPU)
    lp_, rp_ = (ts.create_dataframe(t).plan for t in (left, right))
    for jt in ("semi", "anti"):
        plan = plan_query(tlp.Join(lp_, rp_, [TAttr("k")], [TAttr("k2")],
                                   jt, condition=condition("both",
                                                           "torch")),
                          ts.conf)
        (join,) = [n for n in _walk(plan) if hasattr(n, "join_type")]
        refs = sorted(c.ordinal for c in join.condition.children
                      if isinstance(c, BoundReference))
        assert refs == [2, 6]  # v, then w after the left's four fields
        assert join.output_schema.names == LEFT_COLS


# -- TPC-H Q13's official text ----------------------------------------------

Q13_OFFICIAL = """
    SELECT c_count, COUNT(*) AS custdist FROM (
      SELECT c_custkey, COUNT(o_orderkey) AS c_count
      FROM customer LEFT OUTER JOIN orders
        ON c_custkey = o_custkey
        AND o_comment NOT LIKE '%special%requests%'
      GROUP BY c_custkey) c_orders
    GROUP BY c_count ORDER BY custdist DESC, c_count DESC"""

# the same query with the condition, which names orders alone, moved
# into a filtered subquery: the text the JAX package's parser takes
Q13_FILTERED = """
    SELECT c_count, COUNT(*) AS custdist FROM (
      SELECT c_custkey, COUNT(o_orderkey) AS c_count
      FROM customer LEFT OUTER JOIN (
        SELECT o_custkey, o_orderkey FROM orders
        WHERE o_comment NOT LIKE '%special%requests%') o
        ON c_custkey = o_custkey
      GROUP BY c_custkey) c_orders
    GROUP BY c_count ORDER BY custdist DESC, c_count DESC"""


@pytest.fixture(scope="module")
def q13_tables():
    from spark_rapids_tpu_torch.bench.tpch import gen_tpch_numpy
    t = gen_tpch_numpy(4000)
    return {name: t[name] for name in ("customer", "orders")}


def _views(session, tabs, arrow: bool):
    for name, cols in tabs.items():
        data = pa.table(cols) if arrow else cols
        session.create_dataframe(data).create_or_replace_temp_view(name)


def test_tpch_q13_official_text_matches_jax(q13_tables):
    from spark_rapids_tpu.sql import SqlError as JSqlError
    js = tpu_session()
    _views(js, q13_tables, arrow=True)
    want = js.sql(Q13_FILTERED).to_arrow()
    assert want.num_rows > 1
    with pytest.raises(JSqlError):
        js.sql(Q13_OFFICIAL)
    for conf in ({}, {"spark.rapids.sql.adaptive.enabled": "true"},
                 {"spark.rapids.sql.adaptive.enabled": "true",
                  "spark.sql.autoBroadcastJoinThreshold": -1}):
        ts = st.TorchSession({**CPU, **conf})
        _views(ts, q13_tables, arrow=False)
        got = ts.sql(Q13_OFFICIAL).to_arrow()
        assert_tables_equal(got, want, ignore_order=False)
        (join,) = [n for n in _walk(ts._last_plan)
                   if hasattr(n, "join_type")]
        assert join.condition is not None
        assert join.join_type in ("left", "right")
