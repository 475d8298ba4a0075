"""The torch port's joins against the JAX package.

The join hash bit for bit for every key type, key equality, string
comparisons, each join route (dense FK, hashed FK, general) and each join
type (inner, left, right, full, semi, anti) through both packages'
sessions from the same parquet files, with null keys, NaN and -0.0 float
keys, duplicate build keys, empty sides and forced hash collisions.
Tolerance: exact (a join moves values, it computes none).
"""

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import jax.numpy as jnp

from spark_rapids_tpu.api import col
from spark_rapids_tpu.api import lit as jlit
from spark_rapids_tpu.columnar import dtypes as jdt
from spark_rapids_tpu.exec.joins import _hash_colval as jhash_colval
from spark_rapids_tpu.exec.joins import _hash_keys as jhash_keys
from spark_rapids_tpu.exec.joins import _keys_equal as jkeys_equal
from spark_rapids_tpu.exprs.base import BoundReference as JRef
from spark_rapids_tpu.exprs.base import ColVal as JColVal
from spark_rapids_tpu.exprs.base import EvalContext as JEvalContext
from spark_rapids_tpu.exprs.predicates import string_compare as jcompare
from tests.compare import assert_tables_equal, tpu_session

import chip_smoke
import spark_rapids_tpu_torch as st
from spark_rapids_tpu_torch.columnar import dtypes as tdt
from spark_rapids_tpu_torch.exec import joins as tj
from spark_rapids_tpu_torch.exprs.base import BoundReference, ColVal, \
    EvalContext
from spark_rapids_tpu_torch.exprs.predicates import string_compare
from tests.torch_threads import _one_torch_thread  # noqa: F401

JOIN_TYPES = ["inner", "left", "right", "full", "semi", "anti"]


def _torch_session(extra=None):
    return st.TorchSession({"spark.rapids.torch.device": "cpu",
                            **(extra or {})})


def _find_all(plan, name):
    out = [plan] if type(plan).__name__ == name else []
    for c in plan.children:
        out += _find_all(c, name)
    return out


# ---------------------------------------------------------------------------
# the hash, bit for bit
# ---------------------------------------------------------------------------

# the same float specials and strings chip_smoke.py's hash_device check
# holds on the card
_float_values = chip_smoke.float_keys
_string_planes = chip_smoke.string_planes
STRINGS = chip_smoke.HASH_STRINGS


def _key_cases():
    rng = np.random.default_rng(5)
    n = 4000
    ints = rng.integers(-(1 << 63), (1 << 63) - 1, n, dtype=np.int64)
    ints[:4] = [-(1 << 63), (1 << 63) - 1, 0, -1]
    i32 = rng.integers(-(1 << 31), (1 << 31) - 1, n).astype(np.int32)
    i32[:3] = [-(1 << 31), (1 << 31) - 1, -1]
    return {
        "int32": (i32, jdt.INT32, tdt.INT32),
        "int64": (ints, jdt.INT64, tdt.INT64),
        "date": (rng.integers(-30000, 30000, n).astype(np.int32), jdt.DATE,
                 tdt.DATE),
        "bool": (rng.random(n) < 0.5, jdt.BOOLEAN, tdt.BOOLEAN),
        "float32": (_float_values(rng, np.float32), jdt.FLOAT32,
                    tdt.FLOAT32),
        "float64": (_float_values(rng, np.float64), jdt.FLOAT64,
                    tdt.FLOAT64),
    }


@pytest.mark.parametrize("kind", list(_key_cases()))
def test_hash_colval_matches_jax_bit_for_bit(kind):
    values, jt, tt = _key_cases()[kind]
    valid = np.ones(values.shape[0], bool)
    want = np.asarray(jhash_colval(
        JColVal(jnp.asarray(values), jnp.asarray(valid), None), jt))
    got = tj.hash_colval(ColVal(torch.from_numpy(values.copy()),
                                torch.from_numpy(valid)), tt).numpy()
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("width", [8, 16, 64])
def test_string_hash_matches_jax_at_any_width(width):
    values = [v for v in STRINGS if len(v.encode()) <= width]
    lengths, chars = _string_planes(values, width)
    valid = np.ones(len(values), bool)
    want = np.asarray(jhash_colval(
        JColVal(jnp.asarray(lengths), jnp.asarray(valid),
                jnp.asarray(chars)), jdt.STRING))
    got = tj.hash_colval(ColVal(torch.from_numpy(lengths),
                                torch.from_numpy(valid),
                                torch.from_numpy(chars)), tdt.STRING).numpy()
    np.testing.assert_array_equal(got, want)
    # the same value hashes equal at every width
    l8, c8 = _string_planes(values[:5], 8)
    narrow = tj.hash_colval(ColVal(torch.from_numpy(l8),
                                   torch.ones(5, dtype=torch.bool),
                                   torch.from_numpy(c8)), tdt.STRING)
    np.testing.assert_array_equal(narrow.numpy(), got[:5])


def test_multi_key_hash_matches_jax():
    """``hash_keys`` over an int64, a string and a f64 key, with nulls:
    the combined hash and the all-keys-valid mask."""
    rng = np.random.default_rng(8)
    n = 64
    ints = rng.integers(-50, 50, n).astype(np.int64)
    lengths, chars = _string_planes(
        [STRINGS[i] for i in rng.integers(0, len(STRINGS), n)], 64)
    floats = _float_values(rng, np.float64)[:n]
    valids = [rng.random(n) < 0.8 for _ in range(3)]
    j_cols = [JColVal(jnp.asarray(ints), jnp.asarray(valids[0]), None),
              JColVal(jnp.asarray(lengths), jnp.asarray(valids[1]),
                      jnp.asarray(chars)),
              JColVal(jnp.asarray(floats), jnp.asarray(valids[2]), None)]
    t_cols = [ColVal(torch.from_numpy(ints), torch.from_numpy(valids[0])),
              ColVal(torch.from_numpy(lengths), torch.from_numpy(valids[1]),
                     torch.from_numpy(chars)),
              ColVal(torch.from_numpy(floats), torch.from_numpy(valids[2]))]
    j_keys = [JRef(0, jdt.INT64), JRef(1, jdt.STRING), JRef(2, jdt.FLOAT64)]
    t_keys = [BoundReference(0, tdt.INT64), BoundReference(1, tdt.STRING),
              BoundReference(2, tdt.FLOAT64)]
    jh, jv, _ = jhash_keys(j_keys, JEvalContext(j_cols, n, n))
    th, tv, _ = tj.hash_keys(t_keys, EvalContext(t_cols, n, n, "cpu"))
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("kind", ["float32", "float64", "string"])
def test_keys_equal_matches_jax(kind):
    """Every pair of the special values: NaN equals NaN, -0.0 and
    subnormals equal 0.0, strings by their bytes."""
    if kind == "string":
        lengths, chars = _string_planes(STRINGS, 64)
        a = np.repeat(np.arange(len(STRINGS)), len(STRINGS))
        b = np.tile(np.arange(len(STRINGS)), len(STRINGS))
        ja = JColVal(jnp.asarray(lengths[a]), None, jnp.asarray(chars[a]))
        jb = JColVal(jnp.asarray(lengths[b]), None, jnp.asarray(chars[b]))
        ta = ColVal(torch.from_numpy(lengths[a]), None,
                    torch.from_numpy(chars[a]))
        tb = ColVal(torch.from_numpy(lengths[b]), None,
                    torch.from_numpy(chars[b]))
        jt, tt = jdt.STRING, tdt.STRING
    else:
        values, jt, tt = _key_cases()[kind]
        v = values[:15]
        a, b = np.repeat(v, v.size), np.tile(v, v.size)
        ja = JColVal(jnp.asarray(a), None, None)
        jb = JColVal(jnp.asarray(b), None, None)
        ta = ColVal(torch.from_numpy(a.copy()), None)
        tb = ColVal(torch.from_numpy(b.copy()), None)
    want = np.asarray(jkeys_equal(ja, jb, jt))
    np.testing.assert_array_equal(tj.keys_equal(ta, tb, tt).numpy(), want)


# ---------------------------------------------------------------------------
# string comparisons
# ---------------------------------------------------------------------------

def test_string_compare_matches_jax():
    """Every pair of STRINGS (prefixes, embedded NUL, UTF-8), the two
    sides at different widths."""
    la, ca = _string_planes(STRINGS, 64)
    lb, cb = _string_planes(STRINGS, 128)
    a = np.repeat(np.arange(len(STRINGS)), len(STRINGS))
    b = np.tile(np.arange(len(STRINGS)), len(STRINGS))
    want = np.asarray(jcompare(
        JColVal(jnp.asarray(la[a]), None, jnp.asarray(ca[a])),
        JColVal(jnp.asarray(lb[b]), None, jnp.asarray(cb[b]))))
    got = string_compare(
        ColVal(torch.from_numpy(la[a]), None, torch.from_numpy(ca[a])),
        ColVal(torch.from_numpy(lb[b]), None, torch.from_numpy(cb[b])))
    np.testing.assert_array_equal(got.numpy(), want)
    assert set(want.tolist()) == {-1, 0, 1}


@pytest.mark.parametrize("op", ["==", "!=", "<", "<=", ">", ">="])
def test_string_comparisons_match_jax(op):
    """Column against literal and column against column, with nulls."""
    rng = np.random.default_rng(12)
    n = 300
    pool = STRINGS + ["BUILDING", "BUILD", "BUILDINGS", "R", "ASIA"]
    t = pa.table({
        "a": pa.array([pool[i] for i in rng.integers(0, len(pool), n)],
                      mask=rng.random(n) < 0.1),
        "b": pa.array([pool[i] for i in rng.integers(0, len(pool), n)],
                      mask=rng.random(n) < 0.1),
        "i": pa.array(np.arange(n))})

    def cmp(x, y):
        return {"==": x == y, "!=": x != y, "<": x < y, "<=": x <= y,
                ">": x > y, ">=": x >= y}[op]

    def build(c, lit, s):
        df = s.create_dataframe(t)
        return df.select(c("i"), cmp(c("a"), lit("BUILDING")).alias("x"),
                         cmp(c("a"), c("b")).alias("y"))

    want = build(col, jlit, tpu_session()).to_arrow()
    got = build(st.col, st.lit, _torch_session()).to_arrow()
    assert_tables_equal(got, want, ignore_order=False)


def test_date_literal_matches_jax():
    import datetime as dt
    days = np.arange(9199, 9209, dtype=np.int32)
    t = pa.table({"d": pa.array(days, pa.int32()).cast(pa.date32())})

    def build(c, lit, s):
        return s.create_dataframe(t).filter(c("d") < lit(dt.date(1995, 3,
                                                                 15)))
    want = build(col, jlit, tpu_session()).to_arrow()
    got = build(st.col, st.lit, _torch_session()).to_arrow()
    assert_tables_equal(got, want, ignore_order=False)
    assert got.num_rows == 9204 - 9199  # 1995-03-15 is day 9204


# ---------------------------------------------------------------------------
# joins through both sessions
# ---------------------------------------------------------------------------

def _stream_table(n=1500, seed=3):
    rng = np.random.default_rng(seed)
    kf = rng.integers(0, 40, n).astype(np.float64) / 4
    kf[rng.random(n) < 0.05] = np.nan
    kf[rng.random(n) < 0.05] = -0.0
    return pa.table({
        "k": pa.array(rng.integers(-5, 320, n), pa.int64(),
                      mask=rng.random(n) < 0.05),
        "ks": pa.array([f"key{i}" for i in rng.integers(0, 320, n)],
                       mask=rng.random(n) < 0.05),
        "kf": pa.array(kf, mask=rng.random(n) < 0.03),
        "sv": pa.array(np.arange(n)),
    })


def _build_tables(seed=4):
    rng = np.random.default_rng(seed)
    n = 300
    perm = rng.permutation(n)
    unique = pa.table({
        "k": pa.array(perm.astype(np.int64)),
        "ks": pa.array([f"key{i}" for i in perm]),
        "kf": pa.array(perm / 4.0),
        "bv": pa.array(rng.normal(size=n)),
        "bs": pa.array([f"b{i}" for i in range(n)]),
    })
    m = 420
    kf = rng.integers(0, 50, m).astype(np.float64) / 4
    kf[:6] = [np.nan, -np.nan, 0.0, -0.0, 0.0, np.nan]
    dup = pa.table({
        "k": pa.array(rng.integers(0, 200, m), pa.int64(),
                      mask=rng.random(m) < 0.05),
        "ks": pa.array([f"key{i}" for i in rng.integers(0, 200, m)],
                       mask=rng.random(m) < 0.05),
        "kf": pa.array(kf, mask=np.r_[np.zeros(6, bool),
                                      rng.random(m - 6) < 0.05]),
        "bv": pa.array(rng.normal(size=m)),
        "bs": pa.array([f"d{i}" for i in range(m)]),
    })
    return unique, dup


@pytest.fixture(scope="module")
def join_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("joins")
    unique, dup = _build_tables()
    out = {}
    for name, t in (("stream", _stream_table()), ("unique", unique),
                    ("dup", dup)):
        out[name] = str(d / f"{name}.parquet")
        pq.write_table(t, out[name], row_group_size=512)
    return out


def _join(c, s, files, build, on, how, keep_stream=None):
    stream = s.read.parquet(files["stream"])
    if keep_stream is not None:
        stream = stream.filter(keep_stream(c))
    keys = [on] if isinstance(on, str) else on
    b = s.read.parquet(files[build]).select(*keys, "bv", "bs")
    return stream.join(b, on=on, how=how)


# (build table, key, join type) -> the route the port takes: an inner
# join on unique build keys takes an FK route, every other join the
# general one (outer, semi and anti joins run on the duplicate builds)
CASES = [("unique", "k", "inner", "dense_fk"),
         ("unique", "ks", "inner", "fk")] + [
    (build, on, how, "general") for on in ("k", "kf", ["k", "ks"])
    for build, how in [("dup", h) for h in JOIN_TYPES]]


@pytest.mark.parametrize("build,on,how,route", CASES,
                         ids=lambda v: v if isinstance(v, str)
                         else "+".join(v))
def test_join_matches_jax(join_files, build, on, how, route):
    conf = {"spark.rapids.sql.reader.batchSizeRows": "512"}
    want = _join(col, tpu_session(conf), join_files, build, on,
                 how).to_arrow()
    ts = _torch_session(conf)
    got = _join(st.col, ts, join_files, build, on, how).to_arrow()
    assert_tables_equal(got, want, ignore_order=True)
    assert got.num_rows > 0
    (join,) = _find_all(ts._last_plan, "TorchBroadcastHashJoinExec")
    assert join.route == route


@pytest.mark.parametrize("how", JOIN_TYPES)
@pytest.mark.parametrize("empty", ["build", "stream"])
def test_join_with_an_empty_side_matches_jax(join_files, how, empty):
    def build(c, s):
        stream = s.read.parquet(join_files["stream"])
        b = s.read.parquet(join_files["unique"]).select("k", "bv", "bs")
        if empty == "build":
            b = b.filter(c("k") < -100)
        else:
            stream = stream.filter(c("sv") < -1)
        return stream.join(b, on="k", how=how)
    want = build(col, tpu_session()).to_arrow()
    got = build(st.col, _torch_session()).to_arrow()
    assert_tables_equal(got, want, ignore_order=True)


@pytest.mark.parametrize("how", ["inner", "full", "anti"])
def test_hash_collisions_are_rejected(join_files, monkeypatch, how):
    """A port hash that collides for most keys: the probe sees duplicate
    hashes (so no FK route), and the key check drops every candidate
    whose keys differ; the results still equal the JAX package's."""
    want = _join(col, tpu_session(), join_files, "unique", "ks",
                 how).to_arrow()
    real = tj.hash_colval
    monkeypatch.setattr(tj, "hash_colval",
                        lambda cv, dt: real(cv, dt) & 3)
    ts = _torch_session()
    got = _join(st.col, ts, join_files, "unique", "ks", how).to_arrow()
    assert_tables_equal(got, want, ignore_order=True)
    (join,) = _find_all(ts._last_plan, "TorchBroadcastHashJoinExec")
    assert join.route == "general"
