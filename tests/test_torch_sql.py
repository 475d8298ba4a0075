"""The torch port's SQL front end against the JAX package's.

The same Arrow tables are views of a JAX session and of a port session
on the CPU; each statement runs through both ``session.sql`` and the
results compare through ``assert_tables_equal`` (exact, except f64 sums
and averages at relative 1e-9, ``approx_float``, since the two packages
add in different orders).  The statements are the analogs of
``tests/test_sql.py``'s that the port lowers: filters and projections,
CASE (searched and simple), CAST, BETWEEN, IN, IS [NOT] NULL, ``%`` and
unary minus, untyped NULLs, GROUP BY expressions and ordinals, HAVING
over aggregate expressions, every join type through ON and USING, join
conditions, subqueries, DISTINCT, ORDER BY with NULLS FIRST/LAST, and
window functions.  Also: ``push_join_conditions`` gives the JAX
package's plan shapes, and what the port lacks raises ``SqlError`` when
parsed or ``NotImplementedError`` when planned.
"""

import datetime as dt

import numpy as np
import pyarrow as pa
import pytest

from spark_rapids_tpu.plan import planner as jplanner
from tests.compare import assert_tables_equal, tpu_session

import spark_rapids_tpu_torch as st
from spark_rapids_tpu_torch import functions as F
from spark_rapids_tpu_torch.columnar.batch import host_batch_to_device, \
    host_columns_from_numpy
from spark_rapids_tpu_torch.columnar.dtypes import FLOAT64, STRING
from spark_rapids_tpu_torch.exec.joins import TorchHashJoinExec
from spark_rapids_tpu_torch.exprs.base import BoundReference, EvalContext, \
    colvals
from spark_rapids_tpu_torch.exprs.cast import Cast
from spark_rapids_tpu_torch.exprs import predicates as tpr
from spark_rapids_tpu_torch.plan import logical as tlp
from spark_rapids_tpu_torch.plan import planner as tplanner
from spark_rapids_tpu_torch.sql import SqlError
from tests.torch_threads import _one_torch_thread  # noqa: F401


def _tables():
    rng = np.random.default_rng(3)
    n = 300
    items = pa.table({
        "id": pa.array(np.arange(n, dtype=np.int64)),
        "k": pa.array(rng.integers(0, 6, n), pa.int64()),
        "v": pa.array([None if rng.random() < 0.05 else float(x)
                       for x in rng.normal(size=n)]),
        "name": pa.array([f"item{i % 9}" for i in range(n)]),
        "d": pa.array([dt.date(2020, 1, 1) + dt.timedelta(days=i % 40)
                       for i in range(n)]),
    })
    dim = pa.table({
        "k": pa.array(np.arange(6, dtype=np.int64)),
        "grp": pa.array(["a", "b", "a", "c", "b", "a"]),
        "w": pa.array([0.5, -0.5, 0.0, 1.0, -1.0, 0.25]),
    })
    return {"items": items, "dim": dim}


@pytest.fixture(scope="module")
def sessions():
    """(the JAX package's session, the port's CPU session), each with
    the views items and dim."""
    tables = _tables()
    js = tpu_session()
    ts = st.TorchSession({"spark.rapids.torch.device": "cpu"})
    for name, t in tables.items():
        js.create_dataframe(t).create_or_replace_temp_view(name)
        ts.create_dataframe(t).create_or_replace_temp_view(name)
    return js, ts


# (name, SQL, whether its rows come in one defined order)
CASES = [
    ("select_where_order_limit",
     "SELECT id, name, v * 2 AS dv FROM items WHERE v > 0 AND k < 4 "
     "ORDER BY dv DESC, id LIMIT 5", True),
    ("expressions", """
      SELECT id, CAST(k AS DOUBLE) kd,
             CASE WHEN v > 0 THEN 'pos' WHEN v IS NULL THEN 'null'
                  ELSE 'neg' END sign,
             CASE k WHEN 1 THEN 'one' WHEN 2 THEN 'two' END simple,
             k BETWEEN 2 AND 4 bet, k NOT BETWEEN 2 AND 4 nbet,
             k IN (1, 3, 5) odd, k NOT IN (2, -1) notin,
             substring(name, 5) suffix, length(name) ln,
             -v neg, -k nk, (k - 3) % 4 m, v % 0.5 fm, k % (k - 2) z,
             CASE WHEN k > 3 THEN v ELSE NULL END nv,
             coalesce(NULL, v, 0.0) cv, nvl(v, -1.0) nvl_v,
             isnull(v) isn, v IS NOT NULL nn
      FROM items WHERE NOT (k = 0) AND id < 200
      ORDER BY id""", True),
    ("dates", """
      SELECT id, year(d) y, month(d) mo, dayofmonth(d) dd,
             datediff(d, DATE '2020-01-15') dd15,
             date_add(d, 3) d3, d >= DATE '2020-02-01' late
      FROM items WHERE d BETWEEN DATE '2020-01-10' AND DATE '2020-02-05'
      ORDER BY id""", True),
    ("group_by_having",
     "SELECT k, COUNT(*) n, COUNT(v) nv, SUM(v) sv, AVG(v) av, MIN(d) md, "
     "MAX(v) mx FROM items GROUP BY k HAVING COUNT(*) > 10 ORDER BY k",
     True),
    ("having_over_aggregate_expressions", """
      SELECT grp, SUM(v) / COUNT(v) a, COUNT(*) n
      FROM items i JOIN dim d ON i.k = d.k
      GROUP BY grp HAVING SUM(v) / COUNT(v) > -1 AND MAX(v) > 0
      ORDER BY grp""", True),
    ("global_aggregate_expression",
     "SELECT 100 * SUM(v) / COUNT(v) AS scaled_avg, MIN(k) lo "
     "FROM items WHERE v IS NOT NULL", True),
    ("group_by_ordinal",
     "SELECT k % 3 AS m, COUNT(*) n, SUM(v) s FROM items GROUP BY 1 "
     "ORDER BY 1", True),
    ("group_by_expressions", """
      SELECT year(d) y, month(d) mo, COUNT(*) c FROM items
      GROUP BY year(d), month(d) ORDER BY y, mo""", True),
    ("order_by_aggregate",
     "SELECT grp, COUNT(*) AS c FROM items JOIN dim USING (k) "
     "GROUP BY grp ORDER BY COUNT(*) DESC, grp", True),
    ("inner_join_on", """
      SELECT d.grp, COUNT(*) n FROM items i JOIN dim d ON i.k = d.k
      WHERE i.v IS NOT NULL GROUP BY d.grp ORDER BY d.grp""", True),
    ("join_using",
     "SELECT grp, COUNT(*) n FROM items JOIN dim USING (k) "
     "GROUP BY grp ORDER BY grp", True),
    ("left_join_subquery", """
      SELECT d.k, d.grp, t.id FROM dim d LEFT JOIN
        (SELECT k AS tk, id FROM items WHERE k < 2 AND id < 40) t
        ON d.k = t.tk""", False),
    ("right_join", """
      SELECT t.id, d.grp FROM
        (SELECT k AS tk, id FROM items WHERE id < 50 AND k > 1) t
        RIGHT JOIN dim d ON t.tk = d.k""", False),
    ("full_join", """
      SELECT t.id, d.grp FROM
        (SELECT k AS tk, id FROM items WHERE id < 30 AND k < 4) t
        FULL OUTER JOIN (SELECT k, grp FROM dim WHERE k > 1) d
        ON t.tk = d.k""", False),
    ("semi_join",
     "SELECT k, grp FROM dim LEFT SEMI JOIN "
     "(SELECT k FROM items WHERE v > 1.5) t USING (k) ORDER BY k", True),
    ("anti_join",
     "SELECT k, grp FROM dim LEFT ANTI JOIN "
     "(SELECT k FROM items WHERE v > 2.2) t USING (k) ORDER BY k", True),
    ("join_condition_on", """
      SELECT i.id, d.grp FROM items i JOIN dim d
        ON i.k = d.k AND i.v > d.w AND d.grp <> 'c'
      ORDER BY i.id""", True),
    ("join_condition_pushed_from_where", """
      SELECT i.id, d.w FROM items i JOIN dim d ON i.k = d.k
      WHERE i.v < d.w AND d.grp = 'a' AND i.id > 20
      ORDER BY i.id""", True),
    ("subquery_and_distinct", """
      SELECT DISTINCT grp FROM (
        SELECT d.grp grp, i.v FROM items i JOIN dim d ON i.k = d.k
      ) t WHERE v > 0 ORDER BY grp""", True),
    ("order_nulls_last",
     "SELECT id, v FROM items ORDER BY v ASC NULLS LAST, id LIMIT 20",
     True),
    ("order_nulls_first",
     "SELECT id, v FROM items ORDER BY v DESC NULLS FIRST, id LIMIT 20",
     True),
    ("window_functions", """
      SELECT id, k, v,
             ROW_NUMBER() OVER (PARTITION BY k ORDER BY v DESC NULLS LAST,
                                id) rn,
             RANK() OVER (PARTITION BY k ORDER BY name) rk,
             SUM(v) OVER (PARTITION BY k ORDER BY id
                          ROWS BETWEEN 2 PRECEDING AND CURRENT ROW) s3,
             COUNT(*) OVER (PARTITION BY name) cnt,
             LAG(v, 1) OVER (PARTITION BY k ORDER BY id) lg
      FROM items ORDER BY id""", True),
    ("window_filtered_in_subquery", """
      SELECT k, id, rn FROM (
        SELECT k, id, ROW_NUMBER() OVER (PARTITION BY k ORDER BY id) rn
        FROM items) t
      WHERE rn <= 2 ORDER BY k, rn""", True),
]


@pytest.mark.parametrize("name,sql,ordered", CASES,
                         ids=[c[0] for c in CASES])
def test_sql_matches_jax(sessions, name, sql, ordered):
    js, ts = sessions
    want = js.sql(sql).to_arrow()
    assert want.num_rows > 0, name
    got = ts.sql(sql).to_arrow()
    assert_tables_equal(got, want, ignore_order=not ordered,
                        approx_float=True)


# -- push_join_conditions ----------------------------------------------------

def _names(e):
    out = {e.col_name} if type(e).__name__ == "UnresolvedAttribute" \
        else set()
    for c in e.children:
        out |= _names(c)
    return out


def _shape(plan):
    """A package-neutral rendering of a logical plan: node names, join
    types and keys, and the columns each filter and condition names."""
    kind = type(plan).__name__
    if kind == "Join":
        cond = None if plan.condition is None else sorted(
            _names(plan.condition))
        head = (kind, plan.join_type,
                [sorted(_names(k)) for k in plan.left_keys],
                [sorted(_names(k)) for k in plan.right_keys], cond)
    elif kind == "Filter":
        head = (kind, sorted(_names(plan.pred)))
    else:
        head = (kind,)
    return (head, [_shape(c) for c in plan.children])


PUSH_CASES = [
    # a band across the join: into the condition
    "SELECT COUNT(*) c FROM items i JOIN dim d ON i.k = d.k "
    "WHERE i.v > d.w AND i.v < d.w + 1.0",
    # one side each, and a conjunct over both
    "SELECT i.id FROM items i JOIN dim d ON i.k = d.k "
    "WHERE i.id < 100 AND d.grp = 'a' AND i.v > d.w",
    # through two joins
    """SELECT i.id FROM items i JOIN dim d ON i.k = d.k
       JOIN (SELECT k AS k2, w AS w2 FROM dim) e ON d.k = e.k2
       WHERE i.v < e.w2 AND d.w > 0 AND i.id > 5""",
    # an OR over both sides, and a column both sides hold stays put
    "SELECT grp FROM items JOIN dim USING (k) WHERE v > 0 OR grp = 'b'",
]


@pytest.mark.parametrize("sql", PUSH_CASES)
def test_push_join_conditions_matches_jax_plan_shape(sessions, sql):
    js, ts = sessions
    want = _shape(jplanner.push_join_conditions(js.sql(sql).plan))
    got = _shape(tplanner.push_join_conditions(ts.sql(sql).plan))
    assert got == want


def test_pushed_condition_reaches_the_join_exec(sessions):
    """A band over both sides of an inner join filters inside the join
    operator, whatever route the join takes."""
    _, ts = sessions
    df = ts.sql(PUSH_CASES[0])
    root = tplanner.plan_query(df.plan, ts.conf)

    def joins(p):
        out = [p] if isinstance(p, TorchHashJoinExec) else []
        for c in p.children:
            out += joins(c)
        return out
    (join,) = joins(root)
    assert join.condition is not None
    assert df.collect()[0]["c"] > 0


# -- what the port lacks raises --------------------------------------------

UNPORTED = [
    # a marker with no values bound raises in both packages (a bound one
    # runs: tests/test_torch_server.py)
    "SELECT id FROM items WHERE k = ?",
    # an unknown function (an ON condition on an outer join, which stood
    # here, runs now: test_outer_join_on_condition_sql_matches_jax)
    "SELECT no_such_function(id) FROM items",
    # the JAX package's SQL parses neither UNION nor explode (both run
    # through the DataFrame API)
    "SELECT id FROM items UNION SELECT id FROM dim",
    "SELECT explode(array(1, 2)) e FROM items",
]


@pytest.mark.parametrize("sql", UNPORTED)
def test_unported_sql_raises_when_parsed(sessions, sql):
    _, ts = sessions
    with pytest.raises(SqlError):
        ts.sql(sql)


# the statements the port refused when parsed until it had their
# expressions, now run through both packages (rand with a seed, and a
# DATE cast to compare with a TIMESTAMP literal, as the JAX package
# needs them); the incompatible ones under incompatibleOps
LIFTED = [
    "SELECT id, rand(7) r FROM items",
    "SELECT upper(name) u FROM items",
    "SELECT concat(name, 'x') c FROM items",
    "SELECT regexp_replace(name, 'i', 'j') r FROM items",
    "SELECT sqrt(k) r FROM items",
    "SELECT name FROM items WHERE name LIKE 'item%'",
    "SELECT name || '!' b FROM items",
    "SELECT i.id FROM items i CROSS JOIN dim d",
    "SELECT id FROM items WHERE CAST(d AS TIMESTAMP) > "
    "TIMESTAMP '2020-01-01 00:00:00'",
    "SELECT CAST(k AS STRING) s FROM items",
    "SELECT k, first(v) f FROM items GROUP BY k",
]


@pytest.fixture(scope="module")
def incompat_sessions():
    conf = {"spark.rapids.sql.incompatibleOps.enabled": True}
    js = tpu_session(conf)
    ts = st.TorchSession({"spark.rapids.torch.device": "cpu", **conf})
    for name, t in _tables().items():
        js.create_dataframe(t).create_or_replace_temp_view(name)
        ts.create_dataframe(t).create_or_replace_temp_view(name)
    return js, ts


@pytest.mark.parametrize("sql", LIFTED)
def test_lifted_sql_matches_jax(incompat_sessions, sql):
    """Exact: rand is bit for bit, the rest moves or renders values
    (sqrt is correctly rounded in both)."""
    js, ts = incompat_sessions
    assert_tables_equal(ts.sql(sql).to_arrow(), js.sql(sql).to_arrow(),
                        ignore_order=True)


def test_condition_on_outer_join_raises_when_planned(sessions):
    """A join condition on a join that is not inner plans and runs on the
    card's path (the name is older than the port's pair evaluation): its
    rows are the JAX session's inner join under the same condition, with
    the left rows (items, by id) or right rows (dim, by k) that no pair
    holds null-extended, kept (anti) or dropped (semi)."""
    from spark_rapids_tpu.api import DataFrame as JDataFrame
    from spark_rapids_tpu.exprs import predicates as jpr
    from spark_rapids_tpu.exprs.base import UnresolvedAttribute as JAttr
    from spark_rapids_tpu.plan import logical as jlp
    js, ts = sessions
    items, dim = ts.table("items"), ts.table("dim")
    # dim's k renamed, so that the two sides' names differ
    dim2 = dim.select(st.col("k").alias("dk"), "grp", "w")
    from spark_rapids_tpu.api import col as jcol
    jdim2 = js.table("dim").select(jcol("k").alias("dk"), "grp", "w")
    pairs = JDataFrame(js, jlp.Join(
        js.table("items").plan, jdim2.plan, [JAttr("k")], [JAttr("dk")],
        "inner", condition=jpr.GreaterThan(JAttr("v"), JAttr("w")))) \
        .to_arrow()
    ids = set(pairs.column("id").to_pylist())
    dks = set(pairs.column("dk").to_pylist())
    cond = tpr.GreaterThan(st.col("v").expr, st.col("w").expr)
    for how in ("left", "right", "full", "semi", "anti"):
        plan = tlp.Join(items.plan, dim2.plan, [st.col("k").expr],
                        [st.col("dk").expr], how, condition=cond)
        tplanner.plan_query(plan, ts.conf)
        got = st.api.DataFrame(ts, plan).to_arrow()
        left_ids = [r["id"] for r in got.to_pylist()
                    if r.get("dk") is None and r["id"] is not None]
        if how in ("semi", "anti"):
            want = sorted(i for i in js.table("items").to_arrow()
                          .column("id").to_pylist()
                          if (i in ids) == (how == "semi"))
            assert sorted(got.column("id").to_pylist()) == want
            continue
        matched = [r for r in got.to_pylist()
                   if r["id"] is not None and r.get("dk") is not None]
        assert len(matched) == pairs.num_rows
        if how in ("left", "full"):
            assert sorted(left_ids) == sorted(
                i for i in range(300) if i not in ids)
        right_only = [r["dk"] for r in got.to_pylist() if r["id"] is None]
        if how in ("right", "full"):
            assert sorted(right_only) == sorted(
                k for k in range(6) if k not in dks)


def test_outer_join_on_condition_sql_matches_jax(sessions):
    """The ON condition of an outer join through ``session.sql``: the
    JAX package's parser refuses the text, so its reference is the same
    query with the condition, which names the right side only, moved
    into a filtered subquery."""
    js, ts = sessions
    got = ts.sql("SELECT d.k, i.id FROM dim d LEFT JOIN "
                 "(SELECT k AS ik, id, v FROM items) i "
                 "ON d.k = i.ik AND i.v > 0").to_arrow()
    want = js.sql("SELECT d.k, i.id FROM dim d LEFT JOIN "
                  "(SELECT k AS ik, id FROM items WHERE v > 0) i "
                  "ON d.k = i.ik").to_arrow()
    assert_tables_equal(got, want, ignore_order=True)


def test_cast_the_port_lacks_raises_when_planned(sessions):
    _, ts = sessions
    df = ts.sql("SELECT CAST(d AS INT) di FROM items")
    with pytest.raises(NotImplementedError, match="cast date"):
        tplanner.plan_query(df.plan, ts.conf)


STRING_AS_NUMBER_SQL = [
    "SELECT SUM(name) s FROM items",
    "SELECT k, AVG(name) a FROM items GROUP BY k",
    "SELECT name / 2 h FROM items",
    "SELECT id, SUM(name) OVER (PARTITION BY k ORDER BY id) s FROM items",
]


def _window_jax_session():
    """The JAX package runs a string-typed window function on its CPU
    engine, so its window cases need ``test.enabled`` off."""
    js = tpu_session({"spark.rapids.sql.test.enabled": False})
    for name, t in _tables().items():
        js.create_dataframe(t).create_or_replace_temp_view(name)
    return js


@pytest.mark.parametrize("sql", STRING_AS_NUMBER_SQL)
def test_string_read_as_number_raises_through_sql(sessions, sql):
    """An aggregate or a division reads a string as a number through the
    cast from a string, as in the JAX package (the name is older than
    the port's casts: the query raised until they came).  ``name``'s
    values do not parse, so each is null, in both packages."""
    js, ts = sessions
    if "OVER" in sql:
        js = _window_jax_session()
    want = js.sql(sql).to_arrow()
    got = ts.sql(sql).to_arrow()
    assert got.schema.types == want.schema.types
    assert_tables_equal(got, want, ignore_order=False)


STRING_AS_NUMBER_API = {
    "sum": lambda c, f, w, df: df.agg(f.sum(c("name"))),
    "grouped_avg": lambda c, f, w, df: df.group_by("k").agg(
        f.avg(c("name"))),
    "divide": lambda c, f, w, df: df.select((c("name") / 2).alias("h")),
    "window_sum": lambda c, f, w, df: df.select(f.sum(c("name")).over(
        w.partition_by("k").order_by("id")).alias("s")),
}


@pytest.mark.parametrize("name", sorted(STRING_AS_NUMBER_API))
def test_string_read_as_number_raises_through_api(sessions, name):
    from spark_rapids_tpu import Window as JWindow
    from spark_rapids_tpu import functions as JF
    from spark_rapids_tpu.api import col as jcol
    js, ts = sessions
    if name == "window_sum":
        js = _window_jax_session()
    build = STRING_AS_NUMBER_API[name]
    want = build(jcol, JF, JWindow, js.table("items")).to_arrow()
    got = build(st.col, F, st.Window, ts.table("items")).to_arrow()
    assert got.schema.types == want.schema.types
    assert_tables_equal(got, want, ignore_order=False)


def test_cast_the_port_lacks_raises_when_emitted():
    """A Cast that a plan builds after binding, and so never coerces,
    still refuses when it is evaluated (float -> string has no device
    cast, in either package)."""
    schema, cols = host_columns_from_numpy({"f": np.array([1.5, 2.0])})
    batch = host_batch_to_device(schema, cols, "cpu")
    ctx = EvalContext(colvals(batch.columns), batch.num_rows,
                      batch.columns[0].capacity, "cpu")
    cast = Cast(BoundReference(0, FLOAT64), STRING)
    with pytest.raises(NotImplementedError, match="cast double"):
        cast.emit(ctx)


def test_unknown_view_raises(sessions):
    _, ts = sessions
    with pytest.raises(ValueError, match="not found"):
        ts.sql("SELECT * FROM nowhere")
    ts.create_dataframe({"x": np.arange(3)}).create_or_replace_temp_view(
        "Tmp")
    assert ts.sql("SELECT x FROM tmp").collect()[2] == {"x": 2}
    ts.drop_view("TMP")
    with pytest.raises(ValueError, match="not found"):
        ts.table("tmp")
