"""Continuous queries in the torch port against the JAX package's.

The one-process cases of ``tests/test_stream.py`` on the port: the
tailing source's diff and commit, the backlog drained oldest first, a
shrunk file as a rewrite, the parquet tail marker against forged stats;
streaming off by default and inert; the standing-query lifecycle with
incremental refreshes equal to a recompute; the ``stream.poll`` fault
skipped and healed; a grown CSV file read from its committed size and
the repair after a failed refresh; result-cache maintenance (append,
then the fallback on a rewrite); the live poller thread, joined at
stop; and a fuzzed schedule of appended CSV files (null-heavy, new keys
arriving) whose every refresh equals the JAX package's standing query
over the same files and the port's own full recompute.  The roots are
CSV (the port's main path, no pyarrow) unless a case is about parquet.
"""

import json
import os
import threading
import time

import numpy as np
import pyarrow as pa
import pyarrow.csv as pacsv
import pyarrow.parquet as pq
import pytest

import spark_rapids_tpu as jst
import spark_rapids_tpu_torch as st
from spark_rapids_tpu_torch.stream import stats as stream_stats
from spark_rapids_tpu_torch.stream.source import TailingSource
from tests.torch_threads import _one_torch_thread  # noqa: F401

CPU = {"spark.rapids.torch.device": "cpu"}
STREAM = {**CPU, "spark.rapids.server.enabled": "true",
          "spark.rapids.stream.enabled": "true",
          "spark.rapids.stream.pollIntervalMs": "60000"}

AGG_Q = ("SELECT g, SUM(v) AS sv, COUNT(*) AS c, AVG(v) AS a, "
         "MIN(v) AS mn FROM fact GROUP BY g")
MAINT_Q = ("SELECT g, SUM(v) AS sv, COUNT(*) AS c, MIN(v) AS mn "
           "FROM fact GROUP BY g")
PROJ_Q = "SELECT g, v * 2 AS dv FROM fact WHERE v > 0"
SORT_Q = "SELECT g, v FROM fact ORDER BY v DESC, g LIMIT 7"


@pytest.fixture(autouse=True)
def _fresh_stats():
    stream_stats.reset()
    yield
    from spark_rapids_tpu_torch import faults
    faults.reset()


def _rows(result):
    table = result if isinstance(result, pa.Table) else result.to_arrow()
    return sorted(map(tuple, (r.values() for r in table.to_pylist())),
                  key=lambda t: tuple((x is None, str(x)) for x in t))


def _part_table(rng, n=200, keys=("a", "b", "c")):
    return pa.table({
        "g": pa.array(rng.choice(list(keys), n)),
        "v": pa.array(rng.integers(-50, 50, n).astype(np.float64) + 0.5)})


def _write_part(d, i, rng, n=200, keys=("a", "b", "c"), fmt="csv"):
    t = _part_table(rng, n, keys)
    path = os.path.join(d, f"part-{i}.{fmt}")
    if fmt == "csv":
        pacsv.write_csv(t, path)
    else:
        pq.write_table(t, path)
    return path


# ---------------------------------------------------------------------------
# the tailing source
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", ["csv", "parquet"])
def test_tailing_source_diff_and_commit(tmp_path, fmt):
    d = str(tmp_path)
    rng = np.random.default_rng(1)
    _write_part(d, 0, rng, fmt=fmt)
    src = TailingSource(d, fmt)
    assert src.poll() is None
    _write_part(d, 1, rng, fmt=fmt)
    batch = src.poll()
    assert [os.path.basename(f) for f in batch.new_files] == \
        [f"part-1.{fmt}"]
    assert not batch.grown and not batch.rewritten
    # poll() does not advance: the same delta until commit
    assert src.poll().new_files == batch.new_files
    src.commit(batch)
    assert src.poll() is None
    assert sorted(os.path.basename(f) for f in src.committed_files()) == \
        [f"part-0.{fmt}", f"part-1.{fmt}"]


def test_tailing_source_backlog_drains_oldest_first(tmp_path):
    d = str(tmp_path)
    rng = np.random.default_rng(2)
    _write_part(d, 0, rng, n=10)
    src = TailingSource(d, "csv", max_files_per_tick=2)
    for i in range(1, 6):
        _write_part(d, i, rng, n=10)
    seen = []
    for _ in range(3):
        batch = src.poll()
        assert len(batch.new_files) <= 2
        seen += batch.new_files
        src.commit(batch)
    assert [os.path.basename(f) for f in seen] == \
        [f"part-{i}.csv" for i in range(1, 6)]
    assert src.poll() is None


@pytest.mark.parametrize("fmt", ["csv", "parquet"])
def test_tailing_source_shrink_is_rewritten_not_append(tmp_path, fmt):
    d = str(tmp_path)
    p = os.path.join(d, f"p.{fmt}")
    t = pa.table({"v": pa.array(np.arange(100, dtype=np.int64))})
    write = pacsv.write_csv if fmt == "csv" else pq.write_table
    write(t, p)
    src = TailingSource(d, fmt)
    write(t.slice(0, 5), p)
    batch = src.poll()
    assert batch.rewritten == [p] and not batch.new_files
    os.remove(p)
    src.commit(batch)
    assert src.poll().rewritten == [p]


def test_parquet_tail_marker_catches_forged_stats(tmp_path):
    d = str(tmp_path)
    p = os.path.join(d, "p.parquet")
    pq.write_table(pa.table({"v": pa.array([1, 2, 3], pa.int64())}), p)
    st0 = os.stat(p)
    src = TailingSource(d, "parquet")
    from spark_rapids_tpu_torch.columnar.dtypes import INT64, Field, Schema
    from spark_rapids_tpu_torch.plan import fingerprint, logical as lp
    schema = Schema([Field("v", INT64)])
    tok0 = dict(fingerprint.leaf_file_tokens(
        lp.ParquetRelation([p], schema)))[p]
    pq.write_table(pa.table({"v": pa.array([9, 9, 9], pa.int64())}), p)
    if os.path.getsize(p) < st0.st_size:
        with open(p, "ab") as f:
            f.write(b"\0" * (st0.st_size - os.path.getsize(p)))
    os.utime(p, ns=(st0.st_atime_ns, st0.st_mtime_ns))
    forged = os.stat(p)
    if forged.st_size == st0.st_size and \
            forged.st_mtime_ns == st0.st_mtime_ns:
        tok1 = dict(fingerprint.leaf_file_tokens(
            lp.ParquetRelation([p], schema)))[p]
        assert tok1 != tok0
        batch = src.poll()
        assert batch is not None and p in batch.rewritten


def test_file_tokens_match_jax_for_every_format(tmp_path):
    from spark_rapids_tpu.columnar.dtypes import Schema as JSchema
    from spark_rapids_tpu.plan import fingerprint as jfp, logical as jlp
    from spark_rapids_tpu_torch.columnar.dtypes import Schema
    from spark_rapids_tpu_torch.plan import fingerprint as tfp, \
        logical as tlp
    rng = np.random.default_rng(3)
    d = str(tmp_path)
    for fmt in ("csv", "parquet"):
        _write_part(d, 0, rng, fmt=fmt)
    import pyarrow.orc as paorc
    paorc.write_table(_part_table(rng), os.path.join(d, "part-0.orc"))
    for j, t in ((jlp.CsvRelation, tlp.CsvRelation),
                 (jlp.ParquetRelation, tlp.ParquetRelation),
                 (jlp.OrcRelation, tlp.OrcRelation)):
        assert tfp.leaf_file_tokens(t([d], Schema([]))) == \
            jfp.leaf_file_tokens(j([d], JSchema([])))


# ---------------------------------------------------------------------------
# off by default
# ---------------------------------------------------------------------------

def test_stream_off_by_default_is_inert(tmp_path):
    rng = np.random.default_rng(3)
    _write_part(str(tmp_path), 0, rng, n=20)
    s = st.TorchSession(CPU)
    try:
        s.read.csv(str(tmp_path)).create_or_replace_temp_view("f")
        server = s.server(max_concurrency=1)
        try:
            with pytest.raises(RuntimeError, match="streaming is disabled"):
                server.streaming
            assert server.submit("SELECT COUNT(*) AS c FROM f").result(60) \
                is not None
            assert not any(t.name.endswith("stream-poller")
                           for t in threading.enumerate())
            es = s.engine_stats()
            assert set(es["stream"]) == set(stream_stats.global_stats())
            assert all(v == 0 for v in es["stream"].values())
            assert "stream" not in server.stats()
        finally:
            server.close()
    finally:
        s.stop()


# ---------------------------------------------------------------------------
# standing queries
# ---------------------------------------------------------------------------

def test_standing_query_lifecycle_and_parity(tmp_path):
    fact = str(tmp_path / "fact")
    os.makedirs(fact)
    rng = np.random.default_rng(4)
    _write_part(fact, 0, rng)
    s = st.TorchSession({**STREAM,
                         "spark.rapids.sql.obs.journalDir":
                             str(tmp_path / "j")})
    try:
        s.read.csv(fact).create_or_replace_temp_view("fact")
        server = s.server(max_concurrency=2)
        try:
            reg = server.streaming
            reg.register_source(fact, "csv")
            qa = reg.register(AGG_Q, name="agg", tenant="t0")
            qp = reg.register(PROJ_Q, name="proj")
            qs = reg.register(SORT_Q, name="sort")
            assert qa.incremental and qp.incremental
            assert not qs.incremental and qs.reason
            assert _rows(qa.result()) == _rows(s.sql(AGG_Q))
            _write_part(fact, 1, rng, keys=("b", "c", "d", "e"))
            # the histogram is process-wide: an earlier test in this
            # worker may have recorded into it
            fresh0 = s.engine_stats()["histograms"].get(
                "stream.freshness.us", {"count": 0})["count"]
            assert reg.tick() == 1
            for q, sql in ((qa, AGG_Q), (qp, PROJ_Q), (qs, SORT_Q)):
                assert _rows(q.result()) == _rows(s.sql(sql)), q.name
            gs = stream_stats.global_stats()
            assert gs["ticks"] == 1
            assert gs["incremental_refreshes"] == 2
            assert gs["recompute_refreshes"] == 1
            assert gs["standing_active"] == 3
            assert qa.last_lag_ms is not None
            assert "stream" in server.stats()
            fresh = s.engine_stats()["histograms"]["stream.freshness.us"]
            assert fresh["count"] - fresh0 == 3
            reg.retire("sort")
            with pytest.raises(KeyError):
                reg.query("sort")
            assert stream_stats.global_stats()["standing_active"] == 2
        finally:
            server.close()
        assert reg.closed
    finally:
        s.stop()
    from spark_rapids_tpu_torch.obs import journal
    journal.close()
    events = []
    for fn in os.listdir(str(tmp_path / "j")):
        with open(str(tmp_path / "j" / fn)) as f:
            events += [json.loads(ln) for ln in f]
    kinds = {e["event"] for e in events}
    assert {"standing_register", "stream_tick", "standing_retire"} <= kinds
    tick = next(e for e in events if e["event"] == "stream_tick")
    assert tick["new_files"] == 1 and tick["queries"] == 3


def test_stream_poll_fault_skips_tick_then_heals(tmp_path):
    fact = str(tmp_path / "fact")
    os.makedirs(fact)
    rng = np.random.default_rng(5)
    _write_part(fact, 0, rng, n=50)
    s = st.TorchSession({**STREAM,
                         "spark.rapids.faults.stream.poll": "count:1"})
    try:
        s.read.csv(fact).create_or_replace_temp_view("fact")
        server = s.server(max_concurrency=2)
        try:
            reg = server.streaming
            reg.register_source(fact, "csv")
            q = reg.register(AGG_Q, name="agg")
            _write_part(fact, 1, rng, n=50)
            assert reg.tick() == 0
            gs = stream_stats.global_stats()
            assert gs["tick_faults"] == 1 and gs["ticks"] == 0
            assert reg.tick() == 1
            assert _rows(q.result()) == _rows(s.sql(AGG_Q))
        finally:
            server.close()
    finally:
        s.stop()


def test_grown_csv_tail_and_repair_after_refresh_error(tmp_path):
    ev = str(tmp_path / "ev.csv")
    with open(ev, "w") as f:
        f.write("g,v\na,10.5\nb,20.0\n")
    sql = "SELECT g, SUM(v) AS sv, COUNT(*) AS c FROM fact GROUP BY g"
    s = st.TorchSession(STREAM)
    js = jst.TpuSession({"spark.rapids.server.enabled": "true",
                         "spark.rapids.stream.enabled": "true",
                         "spark.rapids.stream.pollIntervalMs": "60000"})
    try:
        s.read.csv(ev).create_or_replace_temp_view("fact")
        js.read.csv(ev).create_or_replace_temp_view("fact")
        server, jserver = s.server(max_concurrency=2), \
            js.server(max_concurrency=2)
        try:
            reg, jreg = server.streaming, jserver.streaming
            reg.register_source(ev, "csv")
            jreg.register_source(ev, "csv")
            q = reg.register(sql, name="csvagg")
            jq = jreg.register(sql, name="csvagg")
            assert q.incremental
            with open(ev, "a") as f:
                f.write("a,5.5\nc,7.0\n")
            assert reg.tick() == 1 and jreg.tick() == 1
            assert _rows(q.result()) == _rows(s.sql(sql)) == \
                _rows(jq.result())
            assert stream_stats.global_stats()["batch_rows"] == 2
            assert stream_stats.global_stats()["batch_grown"] == 1
            q.needs_recompute = True
            q.errors += 1
            assert reg.tick() == 0
            assert not q.needs_recompute
            assert _rows(q.result()) == _rows(s.sql(sql))
        finally:
            server.close()
            jserver.close()
    finally:
        s.stop()
        js.stop()


def test_failed_refresh_sets_needs_recompute(tmp_path, monkeypatch):
    fact = str(tmp_path / "fact")
    os.makedirs(fact)
    rng = np.random.default_rng(9)
    _write_part(fact, 0, rng, n=40)
    s = st.TorchSession(STREAM)
    try:
        s.read.csv(fact).create_or_replace_temp_view("fact")
        server = s.server(max_concurrency=2)
        try:
            reg = server.streaming
            q = reg.register(AGG_Q, name="agg")
            _write_part(fact, 1, rng, n=40)
            from spark_rapids_tpu_torch.exec import incremental
            monkeypatch.setattr(incremental.IncrementalState, "apply_delta",
                                lambda *a: (_ for _ in ()).throw(
                                    RuntimeError("refresh broke")))
            assert reg.tick() == 1
            assert q.needs_recompute and q.errors == 1
            assert stream_stats.global_stats()["refresh_errors"] == 1
            monkeypatch.undo()
            assert reg.tick() == 0
            assert not q.needs_recompute
            assert _rows(q.result()) == _rows(s.sql(AGG_Q))
        finally:
            server.close()
    finally:
        s.stop()


def test_registration_by_dataframe_and_prepared_statement(tmp_path):
    fact = str(tmp_path / "fact")
    os.makedirs(fact)
    rng = np.random.default_rng(10)
    _write_part(fact, 0, rng, n=60)
    s = st.TorchSession(STREAM)
    try:
        df = s.read.csv(fact)
        df.create_or_replace_temp_view("fact")
        server = s.server(max_concurrency=2)
        try:
            reg = server.streaming
            from spark_rapids_tpu_torch import functions as F
            qd = reg.register(df.group_by("g").agg(
                F.max(F.col("v")).alias("mx")), name="df")
            stmt = server.prepare("SELECT g, v FROM fact WHERE v > ?")
            qp = reg.register(stmt, name="prep", params=(10.0,))
            assert qd.incremental and qp.incremental
            _write_part(fact, 1, rng, n=60, keys=("c", "q"))
            assert reg.tick() == 1
            assert _rows(qd.result()) == _rows(
                s.sql("SELECT g, MAX(v) AS mx FROM fact GROUP BY g"))
            assert _rows(qp.result()) == _rows(
                s.sql("SELECT g, v FROM fact WHERE v > 10.0"))
            with pytest.raises(ValueError, match="already registered"):
                reg.register(AGG_Q, name="df")
        finally:
            server.close()
    finally:
        s.stop()


# ---------------------------------------------------------------------------
# result-cache maintenance
# ---------------------------------------------------------------------------

def test_cache_maintain_append_and_rewrite_fallback(tmp_path):
    fact = str(tmp_path / "fact")
    os.makedirs(fact)
    rng = np.random.default_rng(6)
    _write_part(fact, 0, rng)
    s = st.TorchSession({**STREAM,
                         "spark.rapids.server.resultCache.enabled": "true",
                         "spark.rapids.stream.cache.maintain": "true",
                         "spark.rapids.sql.obs.journalDir":
                             str(tmp_path / "j")})
    oracle = st.TorchSession(CPU)
    try:
        s.read.csv(fact).create_or_replace_temp_view("fact")
        oracle.read.csv(fact).create_or_replace_temp_view("fact")
        server = s.server(max_concurrency=2)
        try:
            server.submit(MAINT_Q).result(60)
            t2 = server.submit(MAINT_Q)
            assert t2.result(60) is not None and t2.cache_hit
            _write_part(fact, 1, rng, keys=("c", "d", "e"))
            r3 = server.submit(MAINT_Q).result(60)
            gs = stream_stats.global_stats()
            assert gs["cache_maintains"] == 1, gs
            assert _rows(r3) == _rows(oracle.sql(MAINT_Q))
            t4 = server.submit(MAINT_Q)
            assert t4.result(60) is not None and t4.cache_hit
            _write_part(fact, 0, rng, n=37)
            r5 = server.submit(MAINT_Q).result(60)
            gs = stream_stats.global_stats()
            assert gs["cache_maintains"] == 1
            assert gs["cache_maintain_fallbacks"] >= 1
            assert _rows(r5) == _rows(oracle.sql(MAINT_Q))
            server.submit(PROJ_Q).result(60)
            _write_part(fact, 2, rng)
            r6 = server.submit(PROJ_Q).result(60)
            assert stream_stats.global_stats()["cache_maintains"] == 2
            assert _rows(r6) == _rows(oracle.sql(PROJ_Q))
            # an Average's state is wider than its result: a fallback
            server.submit(AGG_Q).result(60)
            _write_part(fact, 3, rng)
            before = stream_stats.global_stats()
            assert _rows(server.submit(AGG_Q).result(60)) == \
                _rows(oracle.sql(AGG_Q))
            after = stream_stats.global_stats()
            assert after["cache_maintains"] == before["cache_maintains"]
            assert after["cache_maintain_fallbacks"] == \
                before["cache_maintain_fallbacks"] + 1
        finally:
            server.close()
    finally:
        s.stop()
        oracle.stop()
    from spark_rapids_tpu_torch.obs import journal
    journal.close()
    events = []
    for fn in os.listdir(str(tmp_path / "j")):
        with open(str(tmp_path / "j" / fn)) as f:
            events += [json.loads(ln) for ln in f]
    maintains = [e for e in events if e["event"] == "cache_maintain"]
    assert len(maintains) == 2 and all(e["files"] == 1 for e in maintains)


# ---------------------------------------------------------------------------
# the live poller and the fuzzed schedule
# ---------------------------------------------------------------------------

def test_live_poller_thread_refreshes_and_joins(tmp_path):
    fact = str(tmp_path / "fact")
    os.makedirs(fact)
    rng = np.random.default_rng(7)
    _write_part(fact, 0, rng, n=60)
    s = st.TorchSession({**STREAM, "spark.rapids.stream.pollIntervalMs":
                         "50"})
    try:
        s.read.csv(fact).create_or_replace_temp_view("fact")
        server = s.server(max_concurrency=2)
        try:
            reg = server.streaming
            reg.register_source(fact, "csv")
            q = reg.register(AGG_Q, name="live")
            _write_part(fact, 1, rng, n=60)
            deadline = time.monotonic() + 60
            while q.refreshes < 1 and time.monotonic() < deadline:
                time.sleep(0.02)
            assert q.refreshes >= 1, "the poller thread never refreshed"
            assert q.last_lag_ms is not None
            assert _rows(q.result()) == _rows(s.sql(AGG_Q))
        finally:
            server.close()
        assert reg.closed
    finally:
        s.stop()
    assert not any(t.name.endswith("stream-poller")
                   for t in threading.enumerate())


def _fuzz_part(rng, keys, n):
    g = [None if rng.random() < 0.25 else str(rng.choice(keys))
         for _ in range(n)]
    v = [None if rng.random() < 0.25 else float(rng.integers(-100, 100))
         + 0.25 for _ in range(n)]
    return pa.table({"g": pa.array(g, pa.string()),
                     "v": pa.array(v, pa.float64())})


def test_fuzzed_append_schedule_matches_jax_and_recompute(tmp_path):
    fact = str(tmp_path / "fact")
    os.makedirs(fact)
    rng = np.random.default_rng(8)
    pacsv.write_csv(_fuzz_part(rng, ["a", "b"], 150),
                    os.path.join(fact, "part-0.csv"))
    queries = {
        "agg": ("SELECT g, SUM(v) AS sv, COUNT(*) AS c, AVG(v) AS a, "
                "MIN(v) AS mn, MAX(v) AS mx FROM fact GROUP BY g"),
        "proj": "SELECT g, v * 2 AS dv FROM fact WHERE v > 0",
        "sort": "SELECT g, v FROM fact ORDER BY v DESC, g LIMIT 11",
    }
    s = st.TorchSession(STREAM)
    js = jst.TpuSession({"spark.rapids.server.enabled": "true",
                         "spark.rapids.stream.enabled": "true",
                         "spark.rapids.stream.pollIntervalMs": "60000"})
    try:
        s.read.csv(fact).create_or_replace_temp_view("fact")
        js.read.csv(fact).create_or_replace_temp_view("fact")
        server, jserver = s.server(max_concurrency=2), \
            js.server(max_concurrency=2)
        try:
            reg, jreg = server.streaming, jserver.streaming
            reg.register_source(fact, "csv")
            jreg.register_source(fact, "csv")
            sqs = {n: reg.register(q, name=n) for n, q in queries.items()}
            jqs = {n: jreg.register(q, name=n) for n, q in queries.items()}
            assert sqs["agg"].incremental and not sqs["sort"].incremental
            alphabet = ["a", "b"]
            for step in range(4):
                alphabet.append(f"k{step}")
                for j in range(int(rng.integers(1, 3))):
                    pacsv.write_csv(
                        _fuzz_part(rng, alphabet, int(rng.integers(20, 150))),
                        os.path.join(fact, f"part-{step + 1}-{j}.csv"))
                assert reg.tick() == 1 and jreg.tick() == 1
                for name, sql in queries.items():
                    got = _rows(sqs[name].result())
                    assert got == _rows(s.sql(sql)), (step, name)
                    assert got == _rows(jqs[name].result()), (step, name)
            gs = stream_stats.global_stats()
            assert gs["incremental_refreshes"] >= 8
            assert gs["recompute_refreshes"] >= 4
        finally:
            server.close()
            jserver.close()
    finally:
        s.stop()
        js.stop()
