"""The torch port's band-aware join probe against the JAX package.

A many-to-many inner join on a key whose ON clause (or a WHERE pushed
into it) also bounds one integer-like build column by stream-side
expressions: the build sorts by (key hash, band column) and each stream
row's candidates narrow to the band's sub-range of its equi run
(``exec/joins.py``: ``extract_band``, ``_band_range``).  Held against
the JAX package (which narrows the same way) through ``session.sql``:
strict and non-strict lower and upper bounds, one bound alone, a
constant added to the build column or the bound (shifted keys), DATE
and INT bands, null bounds and null band values, broadcast and hash
join strategies, and hash collisions forced onto most keys (the
colliding rows ride along inside the narrowed range and the key check
drops them).  The probe must lay out fewer candidate pairs than the
equi probe on the same input, with the same result.  Tolerance: exact
(a join moves values).
"""

import datetime as dt

import numpy as np
import pyarrow as pa
import pytest

from tests.compare import assert_tables_equal, tpu_session

import spark_rapids_tpu_torch as st
from spark_rapids_tpu_torch.exec import joins as tj
from spark_rapids_tpu_torch.exec.joins import TorchHashJoinExec


def _tables(seed=12, n_stream=1500, n_build=2500, keys=40):
    rng = np.random.default_rng(seed)
    day0 = dt.date(2001, 1, 1)

    def days(n):
        return [day0 + dt.timedelta(days=int(x))
                for x in rng.integers(0, 60, n)]
    s = pa.table({
        "sk": pa.array(rng.integers(0, keys, n_stream),
                       mask=rng.random(n_stream) < 0.03),
        "sd": pa.array(days(n_stream), mask=rng.random(n_stream) < 0.03),
        "sv": pa.array(rng.integers(0, 100, n_stream).astype(np.int32),
                       mask=rng.random(n_stream) < 0.03),
        "sid": pa.array(np.arange(n_stream)),
    })
    b = pa.table({
        "bk": pa.array(rng.integers(0, keys, n_build)),
        "bd": pa.array(days(n_build), mask=rng.random(n_build) < 0.03),
        "bv": pa.array(rng.integers(0, 100, n_build).astype(np.int32),
                       mask=rng.random(n_build) < 0.03),
        "bid": pa.array(np.arange(n_build)),
    })
    return {"s": s, "b": b}


BANDS = {
    "date_window": "b.bd > s.sd AND b.bd <= date_add(s.sd, 10)",
    "date_window_closed": "b.bd >= date_sub(s.sd, 3) AND b.bd <= s.sd",
    "int_strict": "b.bv > s.sv AND b.bv < s.sv + 20",
    "int_lower_only": "b.bv >= s.sv",
    "int_upper_only": "s.sv > b.bv",
    "shifted_build": "b.bv + 5 > s.sv AND b.bv - 3 <= s.sv",
    "with_residual": "b.bv > s.sv AND b.bid % 3 = 0",
}

SQL = ("SELECT s.sid, b.bid FROM s JOIN b ON s.sk = b.bk AND {band}")


def _sessions(conf=None):
    conf = conf or {}
    js = tpu_session(conf)
    ts = st.TorchSession({"spark.rapids.torch.device": "cpu", **conf})
    for name, t in _tables().items():
        js.create_dataframe(t).create_or_replace_temp_view(name)
        ts.create_dataframe(t).create_or_replace_temp_view(name)
    return js, ts


def _joins(plan):
    out = [plan] if isinstance(plan, TorchHashJoinExec) else []
    for c in plan.children:
        out += _joins(c)
    return out


@pytest.fixture(scope="module")
def hash_sessions():
    # no broadcast: a hash join building on b
    return _sessions({"spark.sql.autoBroadcastJoinThreshold": -1})


@pytest.mark.parametrize("name", sorted(BANDS))
def test_band_join_matches_jax(hash_sessions, name):
    js, ts = hash_sessions
    q = SQL.format(band=BANDS[name])
    got = ts.sql(q).to_arrow()
    assert_tables_equal(got, js.sql(q).to_arrow(), ignore_order=True)
    (join,) = _joins(ts._last_plan)
    assert join.band is not None
    assert join.metrics["bandJoinProbes"] >= 1


def test_band_through_broadcast_matches_jax():
    """The build side broadcast (on the right, or swapped onto the
    left), the band's ordinals remapped with the condition."""
    js, ts = _sessions()
    for q in (SQL.format(band=BANDS["date_window"]),
              "SELECT s.sid, b.bid FROM b JOIN s ON s.sk = b.bk AND "
              "s.sv > b.bv AND s.sv <= b.bv + 7"):
        assert_tables_equal(ts.sql(q).to_arrow(), js.sql(q).to_arrow(),
                            ignore_order=True)


def test_band_narrows_the_candidate_pairs(hash_sessions, monkeypatch):
    """The same query with the band extraction turned off lays out every
    equi pair; with it, far fewer, and the rows are the same.  The band
    costs no host sync: its searches are bounded by the build's longest
    run, which the probe reads already."""
    _, ts = hash_sessions
    q = SQL.format(band=BANDS["date_window"])
    banded = ts.sql(q).to_arrow()
    (join,) = _joins(ts._last_plan)
    narrowed = join.metrics["joinCandidates"]
    band_syncs = join.metrics["hostSyncs"]
    monkeypatch.setattr(tj, "extract_band", lambda *a: None)
    equi = ts.sql(q).to_arrow()
    (join,) = _joins(ts._last_plan)
    assert join.band is None
    assert narrowed * 3 < join.metrics["joinCandidates"]
    assert band_syncs == join.metrics["hostSyncs"]
    assert_tables_equal(banded, equi, ignore_order=True)


def test_band_with_hash_collisions_matches_jax(hash_sessions, monkeypatch):
    """A port hash that collides for most keys: other keys' rows share
    each run and ride along inside the band's range; the key check drops
    them."""
    js, ts = hash_sessions
    q = SQL.format(band=BANDS["int_strict"])
    want = js.sql(q).to_arrow()
    real = tj.hash_colval
    monkeypatch.setattr(tj, "hash_colval", lambda cv, dt: real(cv, dt) & 3)
    assert_tables_equal(ts.sql(q).to_arrow(), want, ignore_order=True)


def test_extract_band_reads_strictness_and_shifts():
    from spark_rapids_tpu_torch.columnar.dtypes import INT32, Field
    from spark_rapids_tpu_torch.exprs import predicates as pr
    from spark_rapids_tpu_torch.exprs.arithmetic import Add, Subtract
    from spark_rapids_tpu_torch.exprs.base import BoundReference, Literal
    s_v = BoundReference(0, INT32)
    b_v = BoundReference(1, INT32)
    cond = pr.And(pr.GreaterThan(Add(b_v, Literal(5)), s_v),
                  pr.LessThanOrEqual(Subtract(b_v, Literal(3)), s_v))
    band = tj.extract_band(cond, 1, [Field("bv", INT32)])
    assert (band.build_ord, band.lower_strict, band.lower_shift,
            band.upper_strict, band.upper_shift) == (0, True, 5, False, -3)
    # both sides of one comparison in the build: no band
    assert tj.extract_band(pr.GreaterThan(b_v, Add(b_v, Literal(1))), 1,
                           [Field("bv", INT32)]) is None
