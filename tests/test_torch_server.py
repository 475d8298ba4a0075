"""The torch port's session server against the JAX package.

Mirrors ``tests/test_server.py`` scenario by scenario, on the same
inputs in both packages (TPC-H at 4,000 lineitem rows and TPCx-BB at
10,000 store_sales rows, written once as parquet; small numpy tables
elsewhere):

- four concurrent clients under two tenants (weights 2 and 1) get, for
  each class of ``bench_serve.py``'s mix (tpch_q1, tpch_q6, tpcxbb_q7,
  the prepared Q6 and top-k templates with their bindings, and the
  group-by template the card's run takes through the dense-slot
  kernel), the port's serial result bit for bit, and the JAX package's
  serverless result (relative 1e-9 on f64 sums, which add in different
  orders: ``tests/compare.py``'s ``assert_tables_equal``);
- prepared statements equal ``session.prepare(...).execute(...)`` of the
  JAX package for every binding (float, int32, int64, date, string),
  parse once a type signature, and raise the same validation errors;
- the fair queue dispatches in the JAX queue's order for the same
  offers; the result cache's hits, misses and evictions follow the JAX
  cache's over the same calls; ``conf_fingerprint`` ignores the same
  keys; a rewritten parquet file, or a view registered anew, is a miss;
- timeouts, cancels, budgets and admission sheds surface typed, the
  ``server.admit`` and ``server.cache.lookup`` faults behave as in the
  JAX package, and nothing (threads, handles, permits) is left after
  ``close`` and ``stop``;
- the chip-health and stream keys raise on a server, and on a fleet's
  replica at its boot; ``native.load`` builds once from four threads.

No test waits without a bound (``ticket.result(timeout=...)``,
``thread.join(timeout)``).  The port's injector and journal are
process-wide, so every test resets them after itself.
"""

import datetime
import json
import os
import threading
import time

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import spark_rapids_tpu as jst
from spark_rapids_tpu.bench.tpch import TPCH_QUERIES as JAX_TPCH
from spark_rapids_tpu.bench.tpch import gen_tpch
from spark_rapids_tpu.bench.tpch import load_tables as jload
from spark_rapids_tpu.bench.tpcxbb import TPCXBB_QUERIES as JAX_XBB
from spark_rapids_tpu.bench.tpcxbb import gen_tpcxbb
from spark_rapids_tpu.bench.tpcxbb import register_views as jregister
from spark_rapids_tpu.sql import SqlError as JSqlError
from tests.compare import assert_tables_equal, tpu_session

import spark_rapids_tpu_torch as st
from spark_rapids_tpu_torch import faults, native
from spark_rapids_tpu_torch.bench.tpch import TPCH_QUERIES
from spark_rapids_tpu_torch.bench.tpch import load_tables as tload
from spark_rapids_tpu_torch.bench.tpcxbb import TPCXBB_QUERIES
from spark_rapids_tpu_torch.bench.tpcxbb import register_views
from spark_rapids_tpu_torch.errors import (
    AdmissionRejectedError, EngineError, QueryBudgetExceededError,
    QueryCancelledError, QueryTimeoutError,
)
from spark_rapids_tpu_torch.faults import InjectedFault
from spark_rapids_tpu_torch.obs import journal
from spark_rapids_tpu_torch.sql import SqlError
from tests.torch_threads import _one_torch_thread  # noqa: F401

LINEITEM = 4000
SALES = 10_000
CPU = {"spark.rapids.torch.device": "cpu"}

# bench_serve.py's prepared templates and bindings, and the group-by
# template that takes the dense-slot kernel on the card
PREP_Q6 = ("SELECT SUM(l_extendedprice * l_discount) AS revenue "
           "FROM lineitem WHERE l_discount >= ? AND l_discount <= ? "
           "AND l_quantity < ?")
PREP_TOPK = ("SELECT l_orderkey, SUM(l_quantity) AS q FROM lineitem "
             "WHERE l_quantity > ? GROUP BY l_orderkey")
PREP_KAGG = ("SELECT k, COUNT(*) AS c, SUM(v) AS s, MAX(v) AS m FROM agg "
             "WHERE v > ? GROUP BY k")
Q6_BINDINGS = [(0.02, 0.06, 24.0), (0.03, 0.07, 30.0), (0.01, 0.05, 20.0)]
TOPK_BINDINGS = [(30.0,), (35.0,), (40.0,)]
KAGG_BINDINGS = [(-0.5,), (0.0,), (0.5,)]


@pytest.fixture(autouse=True)
def _reset_process_state():
    faults.reset()
    yield
    faults.reset()
    journal.close()


def _agg_data(n=20_000):
    rng = np.random.default_rng(7)
    return {"k": rng.integers(0, 1000, n).astype(np.int64),
            "v": rng.normal(size=n)}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("serve")
    return {"tpch": gen_tpch(str(d / "tpch"), lineitem_rows=LINEITEM),
            "tpcxbb": gen_tpcxbb(str(d / "tpcxbb"), sales_rows=SALES),
            "agg": _agg_data()}


def _torch_session(corpus, extra=None):
    s = st.TorchSession({**CPU, **(extra or {})})
    tables = tload(s, corpus["tpch"])
    tables["lineitem"].create_or_replace_temp_view("lineitem")
    register_views(s, corpus["tpcxbb"])
    s.create_dataframe(corpus["agg"]).create_or_replace_temp_view("agg")
    return s, tables


def _classes(tables):
    """(class name, tenant, submit args) of the mix, with the tables
    the DataFrame classes are built on."""
    items = [("tpch_q1", "batch", TPCH_QUERIES["q1"](tables)),
             ("tpch_q6", "interactive", TPCH_QUERIES["q6"](tables)),
             ("tpcxbb_q7", "interactive", TPCXBB_QUERIES["q7"])]
    for i, b in enumerate(Q6_BINDINGS):
        items.append((f"prep_q6_{i}", "interactive", (PREP_Q6, b)))
    for i, b in enumerate(TOPK_BINDINGS):
        items.append((f"prep_topk_{i}", "interactive", (PREP_TOPK, b)))
    for i, b in enumerate(KAGG_BINDINGS):
        items.append((f"prep_kagg_{i}", "batch", (PREP_KAGG, b)))
    return items


@pytest.fixture(scope="module")
def jax_oracle(corpus):
    """Each class's result through the JAX package, serially, with no
    server."""
    js = tpu_session({})
    jt = jload(js, corpus["tpch"])
    jt["lineitem"].create_or_replace_temp_view("lineitem")
    jregister(js, corpus["tpcxbb"])
    js.create_dataframe(pa.table(corpus["agg"])) \
        .create_or_replace_temp_view("agg")
    out = {"tpch_q1": JAX_TPCH["q1"](jt).to_arrow(),
           "tpch_q6": JAX_TPCH["q6"](jt).to_arrow(),
           "tpcxbb_q7": js.sql(JAX_XBB["q7"]).to_arrow()}
    for name, sql, binds in (("q6", PREP_Q6, Q6_BINDINGS),
                             ("topk", PREP_TOPK, TOPK_BINDINGS),
                             ("kagg", PREP_KAGG, KAGG_BINDINGS)):
        stmt = js.prepare(sql)
        for i, b in enumerate(binds):
            out[f"prep_{name}_{i}"] = stmt.execute(*b)
    return out


def _submit(server, spec, tenant, stmts):
    if isinstance(spec, tuple):
        sql, binding = spec
        return server.submit(stmts[sql], tenant=tenant, params=binding)
    return server.submit(spec, tenant=tenant)


def _serial(session, spec):
    if isinstance(spec, tuple):
        sql, binding = spec
        return session.prepare(sql).execute(*binding)
    if isinstance(spec, str):
        return session.sql(spec)._host()
    return spec._host()


def test_concurrent_server_equals_serial_and_jax(corpus, jax_oracle):
    s, tables = _torch_session(corpus, {
        "spark.rapids.server.tenant.batch.weight": "2",
        "spark.rapids.server.tenant.interactive.weight": "1",
        # every query runs: results, not cache hits, are compared
        "spark.rapids.server.resultCache.enabled": "false"})
    try:
        classes = _classes(tables)
        serial = {name: _serial(s, spec) for name, _, spec in classes}
        for name, _, _ in classes:
            assert_tables_equal(serial[name].to_arrow(), jax_oracle[name],
                                ignore_order=True, approx_float=True)
        server = s.server(max_concurrency=4)
        stmts = {sql: server.prepare(sql)
                 for sql in (PREP_Q6, PREP_TOPK, PREP_KAGG)}
        got = []
        errors = []
        lock = threading.Lock()

        def client(cid):
            try:
                for i in range(6):
                    name, tenant, spec = classes[(cid * 6 + i)
                                                 % len(classes)]
                    res = _submit(server, spec, tenant,
                                  stmts).result(timeout=300)
                    with lock:
                        got.append((name, res))
            except BaseException as e:
                errors.append(e)

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        assert not errors, errors
        assert len(got) == 24
        for name, res in got:
            assert res.equals(serial[name]), name
        q = server.stats()["queue"]
        assert q["dispatched"] == q["offered"] == 24
        assert set(q["per_tenant"]) == {"batch", "interactive"}
        # re-binding parsed one template a signature
        assert all(stmt.template_count == 1 for stmt in stmts.values())
    finally:
        s.stop()
    assert not [t.name for t in threading.enumerate()
                if t.name.startswith("spark-rapids-torch-")]


# -- prepared statements ------------------------------------------------------

PREPARED = [
    ("SELECT l_orderkey, l_quantity FROM lineitem WHERE l_quantity > ? "
     "AND l_discount < ?", [(30.0, 0.05), (45.0, 0.1)]),
    ("SELECT l_suppkey, COUNT(*) AS c FROM lineitem WHERE l_suppkey > ? "
     "GROUP BY l_suppkey", [(2,), (30,)]),
    ("SELECT COUNT(*) AS c FROM lineitem WHERE l_orderkey < ?",
     [(5_000_000_000,), (-5_000_000_000,)]),
    ("SELECT l_returnflag, COUNT(*) AS c FROM lineitem WHERE l_shipdate <= "
     "? GROUP BY l_returnflag", [(datetime.date(1995, 1, 1),),
                                 (datetime.date(1998, 9, 2),)]),
    ("SELECT COUNT(*) AS c FROM lineitem WHERE l_returnflag = ?",
     [("R",), ("N",)]),
    ("SELECT l_quantity * ? AS x FROM lineitem WHERE l_quantity > ? "
     "ORDER BY x LIMIT 7", [(2.0, 40.0), (3, 41.0)]),
]


@pytest.mark.parametrize("sql,bindings", PREPARED)
def test_prepared_statement_matches_jax_for_every_binding(corpus, sql,
                                                          bindings):
    js = tpu_session({})
    jload(js, corpus["tpch"])["lineitem"].create_or_replace_temp_view(
        "lineitem")
    jstmt = js.prepare(sql)
    s, _ = _torch_session(corpus)
    stmt = s.prepare(sql)
    assert stmt.num_params == jstmt.num_params
    sigs = set()
    for b in bindings:
        want = jstmt.execute(*b)
        got = stmt.execute(*b)
        assert_tables_equal(got.to_arrow(), want,
                            ignore_order="ORDER BY" not in sql,
                            approx_float=True)
        sigs.add(stmt._type_signature(b))
        assert stmt.template_count == len(sigs)
    # the same binding again parses nothing and gives the same rows
    again = stmt.execute(*bindings[0])
    assert stmt.template_count == len(sigs)
    assert again.equals(stmt.execute(*bindings[0]))


def test_prepared_statement_validation_matches_jax():
    data = {"v": np.array([1.0, 2.0])}
    js = tpu_session({})
    js.create_dataframe(pa.table(data)).create_or_replace_temp_view("t")
    s = st.TorchSession(CPU)
    s.create_dataframe(data).create_or_replace_temp_view("t")
    jstmt = js.prepare("SELECT v FROM t WHERE v > ?")
    stmt = s.prepare("SELECT v FROM t WHERE v > ?")
    for bad in [(), (1.0, 2.0), (None,)]:
        with pytest.raises(ValueError) as je:
            jstmt.execute(*bad)
        with pytest.raises(ValueError) as te:
            stmt.execute(*bad)
        assert type(te.value).__name__ == type(je.value).__name__
    with pytest.raises(JSqlError):
        js.sql("SELECT v FROM t WHERE v > ?")
    with pytest.raises(SqlError):
        s.sql("SELECT v FROM t WHERE v > ?")
    from spark_rapids_tpu_torch.sql import count_params, parse_sql
    assert count_params("SELECT '?' AS q, v FROM t WHERE v > ? -- ?") == 1
    with pytest.raises(SqlError, match="marker"):
        parse_sql("SELECT v FROM t WHERE v > ?", s, params=[1.0, 2.0])
    with pytest.raises(SqlError, match="NULL"):
        parse_sql("SELECT v FROM t WHERE v > ?", s, params=[None])


# -- the fair queue and the result cache against the JAX package's ------------

@pytest.mark.parametrize("weights,offers", [
    ({"b": 3}, [("a", 8), ("b", 12)]),
    ({"a": 2, "c": 5}, [("a", 5), ("b", 5), ("c", 10)]),
    ({}, [("z", 3), ("a", 3), ("m", 3)]),
])
def test_fair_queue_dispatch_order_matches_jax(weights, offers):
    from spark_rapids_tpu.server.admission import FairAdmissionQueue as JQ
    from spark_rapids_tpu_torch.server.admission import FairAdmissionQueue

    def order(cls):
        q = cls(depth=64, default_weight=1, weights=weights)
        for tenant, n in offers:
            for i in range(n):
                q.offer(tenant, f"{tenant}{i}")
        took = []
        while True:
            got = q.take(timeout=0.01)
            if got is None:
                break
            took.append(got)
            if len(took) == 4:
                q.offer("late", "late0")  # re-enters at the clock
        return took, q.stats()

    assert order(FairAdmissionQueue) == order(JQ)


def test_fair_queue_sheds_past_its_depth_like_jax():
    from spark_rapids_tpu.errors import AdmissionRejectedError as JRej
    from spark_rapids_tpu.server.admission import FairAdmissionQueue as JQ
    from spark_rapids_tpu_torch.server.admission import FairAdmissionQueue
    for cls, err in ((FairAdmissionQueue, AdmissionRejectedError),
                     (JQ, JRej)):
        q = cls(depth=2)
        q.offer("a", 1)
        q.offer("a", 2)
        with pytest.raises(err):
            q.offer("b", 3)
        assert [t for t, _ in q.close_and_drain()] == ["a", "a"]
        with pytest.raises(err):
            q.offer("a", 4)


class _Sized:
    def __init__(self, nbytes):
        self.nbytes = nbytes


def test_result_cache_follows_the_jax_cache():
    from spark_rapids_tpu.server.result_cache import ResultCache as JCache
    from spark_rapids_tpu_torch.server.result_cache import ResultCache
    calls = [("put", "k1", 100), ("put", "k2", 100), ("get", "k1"),
             ("put", "k3", 100), ("get", "k2"), ("get", "k3"),
             ("put", "k4", 900), ("get", "k1"), ("get", "k4"),
             ("put", "big", 5000), ("get", "big"), ("put", "k1", 50),
             ("get", "k1"), ("get", "k3")]

    def run(cls):
        cache = cls(max_entries=3, max_bytes=1000)
        values = {}
        seen = []
        for op in calls:
            if op[0] == "put":
                values[op[1]] = _Sized(op[2])
                cache.put(op[1], values[op[1]])
            else:
                hit = cache.lookup(op[1])
                seen.append(hit is values.get(op[1]) if hit else None)
        st_ = cache.snapshot_stats()
        return seen, {k: st_[k] for k in ("entries", "bytes", "hits",
                                          "misses", "evictions",
                                          "inserts")}

    assert run(ResultCache) == run(JCache)


def test_conf_fingerprint_ignores_the_jax_keys():
    from spark_rapids_tpu.conf import TpuConf
    from spark_rapids_tpu.plan.fingerprint import conf_fingerprint as jfp
    from spark_rapids_tpu_torch.conf import TorchConf
    from spark_rapids_tpu_torch.plan.fingerprint import conf_fingerprint
    base = {"spark.rapids.sql.batchSizeRows": "1024"}
    changes = [("spark.rapids.sql.queryTimeoutMs", "5000"),
               ("spark.rapids.sql.cancel.checkIntervalMs", "7"),
               ("spark.rapids.sql.watchdog.hangTimeoutMs", "9"),
               ("spark.rapids.server.resultCache.maxEntries", "4"),
               ("spark.rapids.server.tenant.a.maxDeviceBytes", "1"),
               ("spark.rapids.sql.obs.enabled", "false"),
               ("spark.rapids.fleet.resultCache.dir", "/x"),
               ("spark.rapids.stream.enabled", "true"),
               ("spark.rapids.sql.batchSizeRows", "2048"),
               ("spark.rapids.sql.incompatibleOps.enabled", "true"),
               ("spark.rapids.faults.kernel.launch", "count:1")]
    for key, value in changes:
        same_t = conf_fingerprint(TorchConf(base)) == conf_fingerprint(
            TorchConf({**base, key: value}))
        same_j = jfp(TpuConf(base)) == jfp(TpuConf({**base, key: value}))
        assert same_t == same_j, key


def test_plan_fingerprint_masks_bindings_not_literals():
    from spark_rapids_tpu_torch.plan.fingerprint import (
        bind_params, bound_param_values, plan_fingerprint,
        snapshot_fingerprint,
    )
    s = st.TorchSession(CPU)
    s.create_dataframe(_agg_data(100)).create_or_replace_temp_view("agg")
    a = s.prepare(PREP_KAGG).bind(0.5).plan
    b = bind_params(a, [1.5])
    assert plan_fingerprint(a) == plan_fingerprint(b)
    assert bound_param_values(a) == ((0, 0.5),)
    assert bound_param_values(b) == ((0, 1.5),)
    assert bound_param_values(a) == ((0, 0.5),)   # the template unchanged
    lit_a = s.sql("SELECT k FROM agg WHERE v > 0.5").plan
    lit_b = s.sql("SELECT k FROM agg WHERE v > 1.5").plan
    assert plan_fingerprint(lit_a) != plan_fingerprint(lit_b)
    cast_a = s.sql("SELECT CAST(k AS INT) c FROM agg").plan
    cast_b = s.sql("SELECT CAST(k AS DOUBLE) c FROM agg").plan
    assert plan_fingerprint(cast_a) != plan_fingerprint(cast_b)
    snap, pins = snapshot_fingerprint(a)
    assert snap is not None and len(pins) == 1
    assert snapshot_fingerprint(s.range(10).plan)[0] is not None


# -- the result cache through the server -------------------------------------

def test_result_cache_hits_and_invalidation_match_jax(tmp_path):
    p = str(tmp_path / "t.parquet")

    def write(n):
        pq.write_table(pa.table({
            "k": pa.array(np.arange(n) % 10, pa.int64()),
            "v": pa.array(np.arange(n).astype(np.float64))}), p)

    q = "SELECT k, SUM(v) AS sv FROM t GROUP BY k"

    def drive(session):
        session.read.parquet(p).create_or_replace_temp_view("t")
        server = session.server(max_concurrency=1)
        flags = []
        rows = []
        write(200)
        for sql, params in [(q, None), (q, None),
                            ("SELECT k FROM t WHERE v > ?", (10.0,)),
                            ("SELECT k FROM t WHERE v > ?", (150.0,)),
                            ("SELECT k FROM t WHERE v > ?", (150.0,))]:
            tk = server.submit(sql, params=params)
            res = tk.result(timeout=300)
            flags.append(tk.cache_hit)
            rows.append(res.num_rows)
        time.sleep(0.01)
        write(100)
        tk = server.submit(q)
        rows.append(tk.result(timeout=300).num_rows)
        flags.append(tk.cache_hit)
        cache = server.stats()["cache"]
        session.stop()
        return flags, rows, (cache["hits"], cache["misses"])

    write(200)
    jdir = str(tmp_path / "journal")
    got = drive(st.TorchSession({**CPU,
                                 "spark.rapids.sql.obs.journalDir": jdir}))
    want = drive(jst.TpuSession({}))
    assert got == want
    assert got[0] == [False, True, False, False, True, False]
    events = []
    for fn in os.listdir(jdir):
        with open(os.path.join(jdir, fn)) as f:
            events += [json.loads(line)["event"] for line in f]
    for ev in ("query_admitted", "cache_miss", "cache_hit", "query_start",
               "query_finish"):
        assert ev in events, ev


def test_reregistered_view_turns_a_hit_into_a_miss():
    s = st.TorchSession(CPU)
    data = _agg_data(500)
    s.create_dataframe(data).create_or_replace_temp_view("agg")
    server = s.server(max_concurrency=1)
    q = "SELECT k, COUNT(*) AS c FROM agg GROUP BY k"
    first = server.submit(q)
    r1 = first.result(timeout=60)
    again = server.submit(q)
    assert again.result(timeout=60).equals(r1) and again.cache_hit
    s.create_dataframe({k: v.copy() for k, v in data.items()}) \
        .create_or_replace_temp_view("agg")
    fresh = server.submit(q)
    assert fresh.result(timeout=60).equals(r1) and not fresh.cache_hit
    s.stop()


def test_sql_params_and_df_binding_never_share_an_entry(corpus):
    s, _ = _torch_session(corpus)
    try:
        want = s.sql("SELECT k, v FROM agg WHERE v > 0.25")._host()
        server = s.server(max_concurrency=2)
        got = server.submit("SELECT k, v FROM agg WHERE v > ?",
                            params=(0.25,)).result(timeout=60)
        assert got.equals(want)
        assert server.sql("SELECT k, v FROM agg WHERE v > ?",
                          params=(0.25,), result_timeout=60).equals(want)
        stmt = s.prepare("SELECT k, v FROM agg WHERE v > ?")
        ra = server.submit(stmt.bind(0.0)).result(timeout=60)
        rb = server.submit(stmt.bind(0.25)).result(timeout=60)
        assert ra.num_rows != rb.num_rows and rb.equals(want)
        again = server.submit(stmt.bind(0.25))
        assert again.result(timeout=60).equals(rb) and again.cache_hit
    finally:
        s.stop()


def test_disk_tier_round_trip_and_corruption(tmp_path):
    from spark_rapids_tpu_torch.server.result_cache import DiskResultTier, \
        ResultCache
    s = st.TorchSession(CPU)
    res = s.range(100)._host()
    disk = DiskResultTier(str(tmp_path / "res"), 1 << 20)
    ResultCache(4, 1 << 20, disk=disk).put(("k",), res)
    fresh = ResultCache(4, 1 << 20, disk=disk)
    assert fresh.lookup(("k",)).equals(res)
    (path,) = [os.path.join(disk.directory, f)
               for f in os.listdir(disk.directory)]
    with open(path, "r+b") as f:
        f.seek(-3, os.SEEK_END)
        f.write(b"xyz")
    assert ResultCache(4, 1 << 20, disk=disk).lookup(("k",)) is None
    assert disk.corrupt == 1 and not os.listdir(disk.directory)
    s.stop()


# -- typed errors ---------------------------------------------------------------

def test_timeout_is_typed_and_the_next_query_is_served(corpus):
    s, tables = _torch_session(corpus, {
        "spark.rapids.sql.reader.batchSizeRows": "256"})
    try:
        server = s.server(max_concurrency=2)
        with pytest.raises(QueryTimeoutError):
            server.submit(TPCH_QUERIES["q1"](tables),
                          timeout_ms=1).result(timeout=120)
        ok = server.submit(TPCH_QUERIES["q6"](tables)).result(timeout=120)
        assert ok.num_rows == 1
        assert s.runtime.catalog.audit_leaks() == 0
    finally:
        s.stop()


def test_cancel_from_close_is_typed(corpus):
    s, tables = _torch_session(corpus, {
        "spark.rapids.faults.io.pipeline.hang": "always"})
    try:
        server = s.server(max_concurrency=1)
        tk = server.submit("SELECT k, v FROM agg WHERE v > 0")
        deadline = time.monotonic() + 10
        while server.stats()["inflight"] == 0 \
                and time.monotonic() < deadline:
            time.sleep(0.01)
        assert server.stats()["inflight"] == 1
        t0 = time.monotonic()
        server.close()
        assert time.monotonic() - t0 < 8.0
        with pytest.raises(QueryCancelledError):
            tk.result(timeout=30)
    finally:
        s.stop()


def test_budget_is_typed_and_the_neighbour_is_unharmed(corpus):
    s, tables = _torch_session(corpus, {
        "spark.rapids.server.tenant.greedy.maxDeviceBytes": "1"})
    try:
        want = s.sql("SELECT k, v FROM agg ORDER BY v, k LIMIT 50")._host()

        def held():
            # device bytes net of the device scan cache's entries
            return s.runtime.catalog.device_bytes - \
                s.runtime.scan_cache.stats()["device_bytes"]
        before = held()
        server = s.server(max_concurrency=2)
        greedy = server.submit("SELECT l_orderkey, l_extendedprice FROM "
                               "lineitem ORDER BY l_extendedprice, "
                               "l_orderkey", tenant="greedy")
        ok = server.submit("SELECT k, v FROM agg ORDER BY v, k LIMIT 50",
                           tenant="polite")
        assert ok.result(timeout=120).equals(want)
        with pytest.raises(QueryBudgetExceededError):
            greedy.result(timeout=120)
        assert s.runtime.catalog.stats()["budget_exceeded_count"] >= 1
        assert held() == before
    finally:
        s.stop()


def test_admission_rejection_and_close_are_typed(corpus):
    s, _ = _torch_session(corpus, {
        "spark.rapids.server.admission.queueDepth": "2"})
    try:
        server = s.server(max_concurrency=0)
        t1 = server.submit("SELECT k FROM agg")
        t2 = server.submit("SELECT v FROM agg")
        with pytest.raises(AdmissionRejectedError):
            server.submit("SELECT k, v FROM agg")
        server.close()
        for tk in (t1, t2):
            with pytest.raises(AdmissionRejectedError):
                tk.result(timeout=5)
        with pytest.raises(AdmissionRejectedError):
            server.submit("SELECT k FROM agg")
    finally:
        s.stop()


def test_admit_fault_sheds_typed_and_the_queue_serves(corpus):
    s, _ = _torch_session(corpus, {
        "spark.rapids.faults.server.admit": "count:1"})
    try:
        server = s.server(max_concurrency=2)
        with pytest.raises(InjectedFault) as ei:
            server.submit("SELECT k, v FROM agg WHERE v > 0")
        assert isinstance(ei.value, EngineError)
        assert server.stats()["queue"]["waiting"] == 0
        out = server.submit("SELECT k, v FROM agg WHERE v > 0").result(
            timeout=60)
        assert out.num_rows > 0
    finally:
        s.stop()


def test_cache_lookup_fault_degrades_to_a_counted_miss(corpus):
    s, _ = _torch_session(corpus, {
        "spark.rapids.faults.server.cache.lookup": "always"})
    try:
        server = s.server(max_concurrency=1)
        q = "SELECT k, SUM(v) AS s FROM agg GROUP BY k"
        r1 = server.sql(q, result_timeout=60)
        r2 = server.sql(q, result_timeout=60)
        assert r1.equals(r2)
        cache = server.stats()["cache"]
        assert cache["hits"] == 0 and cache["faults"] == 2
    finally:
        s.stop()


def test_concurrent_timeouts_release_threads_permits_and_memory(corpus):
    s, tables = _torch_session(corpus, {
        "spark.rapids.server.tenant.defaultTimeoutMs": "1",
        "spark.rapids.sql.reader.batchSizeRows": "256"})
    cat = s.runtime.catalog

    def held():
        # net of the device scan cache's entries (a hit may promote one)
        c = s.runtime.scan_cache.stats()
        return (cat.device_bytes - c["device_bytes"],
                cat.host_bytes - c["host_bytes"], cat.audit_leaks())
    before = held()
    try:
        server = s.server(max_concurrency=4)
        tickets = [server.submit(TPCH_QUERIES["q1"](tables), tenant=f"t{i}")
                   for i in range(4)]
        for tk in tickets:
            with pytest.raises(QueryCancelledError):
                tk.result(timeout=120)
        server.close()
        assert s.runtime.semaphore.available() == \
            s.runtime.semaphore.permits
        assert held() == before
    finally:
        s.stop()
    assert not [t.name for t in threading.enumerate()
                if t.name.startswith("spark-rapids-torch-")]


def test_server_closes_with_session_stop(corpus):
    s, _ = _torch_session(corpus)
    server = s.server(max_concurrency=2)
    assert not server.closed
    s.stop()
    assert server.closed
    assert not [t.name for t in threading.enumerate()
                if t.name.startswith("spark-rapids-torch-")]


def test_concurrent_drain_and_close_claim_once(corpus):
    s, _ = _torch_session(corpus)
    try:
        server = s.server(max_concurrency=2)
        results = []
        barrier = threading.Barrier(4)

        def drainer():
            barrier.wait(timeout=30)
            results.append(server.drain(timeout=10.0))

        threads = [threading.Thread(target=drainer) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert len([ms for ms in results if ms > 0.0]) == 1, results
        assert server.closed and server.drain() == 0.0
    finally:
        s.stop()
    s, _ = _torch_session(corpus)
    try:
        server = s.server(max_concurrency=2)
        threads = [threading.Thread(target=server.close) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert server.closed
        with pytest.raises(AdmissionRejectedError):
            server.submit("SELECT k FROM agg")
    finally:
        s.stop()


# -- what the port refuses ------------------------------------------------------

@pytest.mark.parametrize("key", ["spark.rapids.health.enabled",
                                 "spark.rapids.stream.enabled"])
def test_unported_layers_raise_on_a_server(key):
    s = st.TorchSession({**CPU, key: "true"})
    if key == "spark.rapids.stream.enabled":
        # continuous queries are ported: the server comes up with its
        # standing-query registry and its poller, and stops both
        server = s.server()
        assert not server.streaming.closed
        s.stop()
        assert server.streaming.closed
        assert not [t.name for t in threading.enumerate()
                    if t.name.startswith("spark-rapids-torch-")]
        return
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        s.server()
    s.stop()
    # a fleet's replica is a server: built with the key on, it raises at
    # boot and the fleet fails typed (the fleet itself is ported)
    from spark_rapids_tpu_torch.errors import ReplicaFailedError
    s = st.TorchSession({**CPU, key: "true",
                         "spark.rapids.fleet.replicas": 1})
    with pytest.raises(ReplicaFailedError, match="died during startup"):
        s.fleet()
    s.stop()
    assert not [t.name for t in threading.enumerate()
                if t.name.startswith("spark-rapids-torch-")]


def test_server_enabled_false_refuses_like_jax():
    js = jst.TpuSession({"spark.rapids.server.enabled": "false"})
    with pytest.raises(RuntimeError):
        js.server()
    js.stop()
    s = st.TorchSession({**CPU, "spark.rapids.server.enabled": "false"})
    with pytest.raises(RuntimeError):
        s.server()
    s.stop()


def test_cuda_session_without_a_card_still_raises():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        st.TorchSession({"spark.rapids.server.enabled": "true"})


# -- thread safety ---------------------------------------------------------------

def test_native_load_builds_once_from_four_threads(monkeypatch):
    calls = []
    gate = threading.Barrier(4)

    def fake_build_all(names=None):
        calls.append(list(names))
        time.sleep(0.2)   # long enough for every thread to arrive
        return {n: "" for n in names}

    sentinel = object()
    monkeypatch.setattr(native, "build_all", fake_build_all)
    monkeypatch.setattr(native.ctypes, "CDLL", lambda path: sentinel)
    monkeypatch.setattr(native, "_LOADED", {})
    got = []

    def worker():
        gate.wait(timeout=10)
        got.append(native.load("contains"))

    threads = [threading.Thread(target=worker) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert calls == [["contains"]]
    assert got == [sentinel] * 4


def test_launch_counts_add_up_across_threads():
    import sys
    native.reset_launches()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)   # switch threads as often as possible
    try:
        def bump():
            for _ in range(2000):
                native.count_launch("contains")

        threads = [threading.Thread(target=bump) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert native.LAUNCHES["contains"] == 32000
    finally:
        sys.setswitchinterval(interval)
        native.reset_launches()


def test_stats_snapshot_and_prometheus_text(corpus):
    from spark_rapids_tpu_torch.obs import registry
    s, _ = _torch_session(corpus)
    try:
        server = s.server(max_concurrency=1)
        server.sql("SELECT k FROM agg WHERE v > 1", result_timeout=60)
        snap = s.engine_stats()
        assert set(snap) == {"aqe", "lifecycle", "catalog", "server",
                             "fleet", "stream", "journal", "histograms",
                             "compressed", "prefetch", "d2h", "fusion",
                             "compile", "placement"}
        assert snap["server"]["completed"] >= 1
        assert snap["histograms"]["server.admit.wait.us"]["count"] >= 1
        assert snap["histograms"]["query.wall.us"]["count"] >= 1
        text = registry.prometheus_text()
        assert "spark_rapids_tpu_server_completed" in text
        assert 'spark_rapids_tpu_server_admit_wait_us{quantile="0.99"}' \
            in text
    finally:
        s.stop()
