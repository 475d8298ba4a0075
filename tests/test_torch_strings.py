"""The torch port's string slice against the JAX package.

String ingest (Arrow and numpy), the pattern predicates (``StartsWith``,
``EndsWith``, ``Contains``, ``PallasContains``), the contains kernel's
plain version, the routing of ``functions.contains``, string group-by
keys and sorts, and both text queries of ``chip_smoke.py`` run through
both packages on the CPU.  The JAX side's contains kernel runs in Pallas
interpret mode, as the JAX package's own tests run it.  Tolerance:
exact, bit for bit for char planes; only f64 sums and averages compare
within relative 1e-9 (``approx_float``), since the two packages add in
different orders.  The hand-written kernel itself is compared with its
plain version only where a card is present.
"""

import types

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import jax.numpy as jnp

from spark_rapids_tpu import functions as F
from spark_rapids_tpu.api import col
from spark_rapids_tpu.api import lit as jlit
from spark_rapids_tpu.columnar import dtypes as jdt
from spark_rapids_tpu.columnar.batch import host_batch_to_device as jupload
from spark_rapids_tpu.exprs import pallas_strings as jps
from spark_rapids_tpu.exprs import strings as jss
from spark_rapids_tpu.exprs.base import BoundReference as JRef
from spark_rapids_tpu.exprs.base import ColVal as JColVal
from spark_rapids_tpu.exprs.base import Literal as JLit
from tests.compare import assert_tables_equal, tpu_session
from tests.fuzzer import gen_string_table

import chip_smoke
import spark_rapids_tpu_torch as st
from spark_rapids_tpu_torch import functions as TF
from spark_rapids_tpu_torch import native
from spark_rapids_tpu_torch.columnar import dtypes as tdt
from spark_rapids_tpu_torch.columnar.batch import (
    device_batch_to_host, host_batch_to_device, host_columns_from_arrow,
    host_columns_from_numpy, host_columns_to_arrow,
)
from spark_rapids_tpu_torch.columnar.interop import batch_from_planes
from spark_rapids_tpu_torch.exprs import pallas_strings as tps
from spark_rapids_tpu_torch.exprs import strings as tss
from spark_rapids_tpu_torch.exprs.base import BoundReference, ColVal, \
    Literal
from tests.torch_threads import _one_torch_thread  # noqa: F401

CONF = {"spark.rapids.sql.reader.batchSizeRows": "1024",
        "spark.rapids.sql.batchSizeRows": "1024"}
JAX_API = types.SimpleNamespace(col=col)

# multi-byte UTF-8, embedded NUL, empty strings, nulls, and a string of
# exactly maxDeviceStringWidth (512) bytes
EDGE = ["", "a", "abc", "héllo wörld", "中文字符", "a\x00b", "\x00",
        "z\x00", "🎉emoji🎉", None, "  padded  ", "é" * 256, "%literal%"]


def _torch_session(extra=None):
    return st.TorchSession({"spark.rapids.torch.device": "cpu",
                            **(extra or {})})


def _jax_planes(table):
    jb = jupload(table, jdt.Schema.from_arrow(table.schema),
                 max_string_width=512)
    return jb, [(np.asarray(c.data), np.asarray(c.validity),
                 None if c.chars is None else np.asarray(c.chars))
                for c in jb.columns]


# ---------------------------------------------------------------------------
# ingest and pull
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rows", [slice(None), slice(2, 9)],
                         ids=["whole", "sliced"])
def test_arrow_ingest_matches_jax_bit_for_bit(rows):
    """Arrow strings, also from a sliced table (a non-zero array
    offset), give the JAX package's planes and come back unchanged."""
    table = pa.table({"s": pa.array(EDGE, pa.string())})
    table = table.slice(rows.start or 0, (rows.stop or len(EDGE))
                        - (rows.start or 0))
    jb, [(lengths, valid, chars)] = _jax_planes(table)
    schema, cols = host_columns_from_arrow(table)
    tb = host_batch_to_device(schema, cols, "cpu", max_string_width=512)
    c = tb.columns[0]
    assert c.string_width == chars.shape[1]
    np.testing.assert_array_equal(c.data.numpy(), lengths)
    np.testing.assert_array_equal(c.validity.numpy(), valid)
    np.testing.assert_array_equal(c.chars.numpy(), chars)
    back = host_columns_to_arrow(schema, device_batch_to_host(tb))
    assert back.column("s").to_pylist() == EDGE[rows]


def test_too_wide_strings_raise_in_both_packages():
    table = pa.table({"s": pa.array(["x", "y" * 513])})
    with pytest.raises(ValueError, match="maxDeviceStringWidth"):
        _jax_planes(table)
    schema, cols = host_columns_from_arrow(table)
    with pytest.raises(ValueError, match="maxDeviceStringWidth"):
        host_batch_to_device(schema, cols, "cpu", max_string_width=512)


@pytest.mark.parametrize("kind", ["U", "S", "object"])
def test_numpy_ingest_roundtrip(kind):
    """numpy U, S and object arrays through upload and pull give back
    their strings: a U or S value up to its first NUL (as pyarrow reads
    it), an object array's whole, nulls and NULs included."""
    vals = [v for v in EDGE if v is not None]
    if kind == "S":
        arr = np.array([v.encode("utf-8") for v in vals])
        want = [v.split("\x00")[0] for v in vals]
    elif kind == "U":
        arr = np.array(vals)
        want = [v.split("\x00")[0] for v in vals]
    else:
        arr = np.array(EDGE, dtype=object)
        want = EDGE
    schema, cols = host_columns_from_numpy({"s": arr})
    tb = host_batch_to_device(schema, cols, "cpu", max_string_width=512)
    values, valid = device_batch_to_host(tb)["s"]
    got = [v if ok else None for v, ok in zip(values.to_pylist(), valid)]
    assert got == want


def test_numpy_ingest_matches_jax_planes():
    """A ``U`` array gives the JAX package's planes (which reads it
    through ``pa.table``) bit for bit, values with a NUL inside or at
    either end included: both cut such a value at its first NUL."""
    rng = np.random.default_rng(5)
    words = np.array(["", "a", "héllo", "中文", "special requests",
                      "🎉", "x" * 40, "a\x00b", "\x00tail", "é\x00中文",
                      "z\x00", "x" * 30 + "\x00" + "y" * 9])
    arr = words[rng.integers(0, len(words), 3000)]
    _, [(lengths, valid, chars)] = _jax_planes(pa.table({"s": arr}))
    schema, cols = host_columns_from_numpy({"s": arr})
    c = host_batch_to_device(schema, cols, "cpu").columns[0]
    np.testing.assert_array_equal(c.data.numpy(), lengths)
    np.testing.assert_array_equal(c.validity.numpy(), valid)
    np.testing.assert_array_equal(c.chars.numpy(), chars)


def test_interop_carries_string_planes():
    table = pa.table({"s": pa.array(EDGE), "v": pa.array(range(len(EDGE)))})
    jb, planes = _jax_planes(table)
    tb = batch_from_planes([planes[0], planes[1][:2]],
                           [tdt.STRING, tdt.INT64], jb.num_rows,
                           jb.capacity, "cpu", names=["s", "v"])
    np.testing.assert_array_equal(tb.columns[0].chars.numpy(), planes[0][2])
    back = host_columns_to_arrow(tb.schema, device_batch_to_host(tb))
    assert back.column("s").to_pylist() == EDGE


# ---------------------------------------------------------------------------
# the contains kernel's plain version against the JAX kernel
# ---------------------------------------------------------------------------

def _char_matrix(needle: bytes, rows=96, width=32, seed=0):
    """A char matrix with junk bytes past every length; ``needle`` is
    planted inside some rows (some ending exactly at the length) and
    just past the length of others, where it must not count."""
    rng = np.random.default_rng(seed)
    chars = rng.integers(0x61, 0x64, (rows, width)).astype(np.uint8)
    chars[rng.random((rows, width)) < 0.1] = 0xC3
    lengths = rng.integers(0, width + 1, rows).astype(np.int32)
    k = len(needle)
    p = np.frombuffer(needle, np.uint8)
    for r in range(rows):
        if k == 0:
            break
        if r % 3 == 0 and lengths[r] >= k:       # ends at the length
            chars[r, lengths[r] - k:lengths[r]] = p
        elif r % 3 == 1 and lengths[r] >= k:
            chars[r, :k] = p
        elif lengths[r] + k <= width:            # past the length
            chars[r, lengths[r]:lengths[r] + k] = p
    valid = rng.random(rows) < 0.9
    return chars, lengths, valid


NEEDLES = [b"abcabcabcabcabca", b"ab\xc3", b"a", b"c" * 32,
           bytes(range(0x61, 0x61 + 16)) + b"abcabcabcabcabca"]


@pytest.mark.parametrize("needle", NEEDLES, ids=lambda n: f"k{len(n)}")
def test_plain_contains_matches_jax_kernel(needle):
    """The plain version against JAX ``_run_contains`` (the Pallas kernel,
    interpreted) and ``Contains._match`` on one char matrix, junk past
    the lengths included; k == width and a needle ending at the length
    are among the cases."""
    chars, lengths, valid = _char_matrix(needle)
    want = np.asarray(jps._run_contains(jnp.asarray(chars),
                                        jnp.asarray(lengths), needle))
    # the needle need not be valid UTF-8: set its bytes directly
    jmatch = jss.Contains(JRef(0, jdt.STRING), JLit("x"))
    jmatch.pat = needle
    want_match = np.asarray(jmatch._match(JColVal(
        jnp.asarray(lengths), jnp.asarray(valid), jnp.asarray(chars))))
    np.testing.assert_array_equal(want, want_match)
    got = tps.contains_reference(torch.from_numpy(chars),
                                 torch.from_numpy(lengths), needle)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.any() and not want.all()


@pytest.mark.parametrize("k", [0, 33])
def test_contains_edge_needles_match_jax(k):
    """k == 0 is true for every row and k > width false, in ``_match``
    of both packages, in the plain version and in ``PallasContains``."""
    needle = b"a" * k
    chars, lengths, valid = _char_matrix(needle)
    jc = jss.Contains(JRef(0, jdt.STRING), JLit(needle.decode()))
    want = np.asarray(jc._match(JColVal(jnp.asarray(lengths),
                                        jnp.asarray(valid),
                                        jnp.asarray(chars))))
    assert want.all() if k == 0 else not want.any()
    cv = ColVal(torch.from_numpy(lengths), torch.from_numpy(valid),
                torch.from_numpy(chars))
    for cls in (tss.Contains, tps.PallasContains):
        e = cls(BoundReference(0, tdt.STRING), Literal(needle.decode()))
        np.testing.assert_array_equal(e._match(cv).numpy(), want)
    got = tps.run_contains(cv.chars, cv.data, needle)
    np.testing.assert_array_equal(got.numpy(), want)


def test_contains_routing_matches_jax():
    long_, short = "x" * tps.PALLAS_PATTERN_MIN, "x" * 15
    assert tps.PALLAS_PATTERN_MIN == jps.PALLAS_PATTERN_MIN == 16
    pairs = [(TF.contains(st.col("s"), long_), F.contains(col("s"), long_)),
             (TF.contains(st.col("s"), short), F.contains(col("s"), short)),
             (st.col("s").contains(long_), col("s").contains(long_)),
             (TF.contains(st.col("s"), st.lit(None, tdt.STRING)),
              F.contains(col("s"), jlit(None, jdt.STRING)))]
    names = [type(t.expr).__name__ for t, _ in pairs]
    assert names == ["PallasContains", "Contains", "Contains", "Contains"]
    assert names == [type(j.expr).__name__ for _, j in pairs]
    assert pairs[0][0].expr.key() == pairs[0][1].expr.key()
    with pytest.raises(NotImplementedError, match="literal"):
        TF.contains(st.col("s"), st.col("t"))


@pytest.mark.cuda
def test_contains_kernel_matches_plain_version_on_card():
    """The CUDA kernel against its plain version on the same card
    tensors, exactly, for widths 8 to 1024 and junk past the lengths."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    for width, needle in ((8, b"abcab"), (64, b"abcabcabcabcabca"),
                          (512, b"ab\xc3" * 6), (1024, b"c" * 1024)):
        chars, lengths, _ = _char_matrix(needle, rows=4099, width=width)
        c = torch.from_numpy(chars).cuda()
        ln = torch.from_numpy(lengths).cuda()
        before = native.LAUNCHES["contains"]
        got = tps.run_contains(c, ln, needle)
        torch.cuda.synchronize()
        assert native.LAUNCHES["contains"] == before + 1
        assert torch.equal(got, tps.contains_reference(c, ln, needle))
    # the edge specs chip_smoke.py holds on the card: needles at window 0,
    # at the last window and one byte past the length; k = 1 to 65 and
    # k = width; repetitive text; widths 8 to 1024; lengths past the width
    # and row counts off the tile
    for name, c, ln, p in chip_smoke.contains_specs(
            torch, np.random.default_rng(2)):
        got = tps.run_contains(c, ln, p)
        torch.cuda.synchronize()
        assert torch.equal(got, tps.contains_reference(c, ln, p)), name


def _first_design_smem(width: int, k: int) -> int:
    """Shared memory a block of the first contains kernel took."""
    per_warp = min(32, max(1, 512 // width))
    pat = (k + 15) // 16 * 16
    warps = max(1, min(8, (48 * 1024 - pat) // (per_warp * width)))
    return pat + warps * per_warp * width


@pytest.mark.parametrize("width", [8 << i for i in range(10)])
def test_contains_plan_fits_shared_memory(width):
    """For every width from 8 to 4096 and needles of 1 to 65 bytes and
    of the width: the block fits 232,448 bytes of shared memory, rows
    are 16-byte aligned at an odd number of 16-byte units from width 32
    up (thread t's and t + 1's 16-byte reads meet no bank conflict), the
    path follows the needle's length, and the grid is one wave."""
    rows = 1 << 20
    for k in sorted({1, 3, 16, 32, 33, 64, 65, width}):
        if k > width:
            continue
        p = tps.plan_contains(width, k, rows, 132)
        table = {"shift_and32": 1024, "shift_and64": 2048, "long": 0}
        assert p.path == ("shift_and32" if k <= 32 else
                          "shift_and64" if k <= 64 else "long")
        assert p.smem == table[p.path] + p.stages * p.rows * p.stride
        assert p.smem <= 232448
        assert p.stride % 16 == 0 and p.stride >= max(width, 16)
        if width >= 32:
            assert (p.stride // 16) % 2 == 1
        assert p.stages == 2
        assert 1 <= p.rows <= p.threads <= 256 and p.threads % 32 == 0
        assert 1 <= p.grid <= -(-rows // p.rows)


def test_contains_plan_paths_by_needle_length():
    """Shift-And takes needles up to 64 bytes (a 32-bit state up to 32),
    the prefilter-and-compare path longer ones."""
    paths = [tps.plan_contains(128, k, 100, 132).path
             for k in (1, 32, 33, 64, 65, 128)]
    assert paths == ["shift_and32", "shift_and32", "shift_and64",
                     "shift_and64", "long", "long"]
    assert tps.SHIFT_AND_MAX == 64


def test_contains_plan_raises_past_shared_memory_as_before():
    """The widths whose block passes the shared-memory budget are the
    first design's: up to 2^17 fit (one row a tile, one stage at 2^17),
    2^18 raises."""
    for width in (8 << i for i in range(16)):
        old_raises = _first_design_smem(width, 16) > 232448
        try:
            tps.plan_contains(width, 16, 4, 132)
            raised = False
        except ValueError as e:
            assert "shared memory" in str(e)
            raised = True
        assert raised == old_raises, width
    assert tps.plan_contains(1 << 17, 16, 4, 132).stages == 1
    with pytest.raises(ValueError, match="shared memory"):
        tps.plan_contains(1 << 18, 16, 4, 132)


# ---------------------------------------------------------------------------
# queries through both sessions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [3, 17])
def test_pattern_predicates_match_jax(seed):
    """StartsWith, EndsWith and Contains, short and long, over the
    needle-planted fuzz column (the needles of ``tests/test_strings.py``)."""
    t = gen_string_table(seed, 600).select(["s"])

    def query(c, fns, s):
        return s.create_dataframe(t).select(
            fns.contains(c("s"), "qu").alias("a"),
            fns.contains(c("s"), "%").alias("b"),
            fns.contains(c("s"), "").alias("c"),
            fns.contains(c("s"), "the needle is long enough!").alias("d"),
            c("s").startswith("a").alias("sw"),
            c("s").endswith("9").alias("ew"),
            c("s").contains("bc").alias("ct"),
            c("s").startswith("").alias("sw0"),
            c("s").endswith("enough!").alias("ew7"))

    jt = query(col, F, tpu_session()).to_arrow()
    tt = query(st.col, TF, _torch_session()).to_arrow()
    assert_tables_equal(tt, jt, ignore_order=False)
    assert 0 < sum(bool(x) for x in tt.column("d").to_pylist()) < t.num_rows


def test_utf8_pattern_predicates_match_jax():
    t = pa.table({"s": pa.array(EDGE)})

    def query(c, s):
        return s.create_dataframe(t).select(
            c("s").startswith("hé").alias("sw"),
            c("s").endswith("符").alias("ew"),
            c("s").contains("中").alias("ct"),
            c("s").contains("\x00").alias("nul"),
            c("s").contains("é" * 8).alias("long"))

    assert_tables_equal(query(st.col, _torch_session()).to_arrow(),
                        query(col, tpu_session()).to_arrow(),
                        ignore_order=False)


def test_string_group_by_and_sort_match_jax(tmp_path):
    """String keys of different widths in different batches (8 and 64
    bytes), nulls and a trailing NUL among them: the coalesce pads, the
    merge groups, and the sort orders them as the JAX package does."""
    rng = np.random.default_rng(11)
    # "a", "a\x00" and "" differ only in their lengths
    short = np.array(["a", "b", "", "ab", "é", "a\x00"], dtype=object)
    long_ = np.array(["a", "b" * 40, "ab", "abc" * 10, "中文字符", "abd"])
    vals = np.concatenate([short[rng.integers(0, 6, 1024)],
                           long_[rng.integers(0, 6, 2000)]]).astype(object)
    vals[rng.random(vals.size) < 0.05] = None
    t = pa.table({"s": pa.array(vals.tolist(), pa.string()),
                  "v": pa.array(rng.integers(-50, 50, vals.size))})
    p = str(tmp_path / "keys.parquet")
    pq.write_table(t, p, row_group_size=1024)

    def query(c, fns, s):
        return (s.read.parquet(p).group_by(c("s"))
                .agg(fns.count(c("v")).alias("n"), fns.sum(c("v")).alias("t"),
                     fns.count(c("s")).alias("ns"))
                .order_by(c("s")))

    jt = query(col, F, tpu_session(CONF)).to_arrow()
    ts = _torch_session(CONF)
    tt = query(st.col, TF, ts).to_arrow()
    assert_tables_equal(tt, jt, ignore_order=False)
    assert tt.column("s").to_pylist()[0] is None
    desc = ts.read.parquet(p).select("s").order_by("s", ascending=False)
    jdesc = tpu_session(CONF).read.parquet(p).select("s").order_by(
        "s", ascending=False)
    assert_tables_equal(desc.to_arrow(), jdesc.to_arrow(), ignore_order=False)


@pytest.fixture(scope="module")
def lineitem(tmp_path_factory):
    data = chip_smoke.gen_lineitem(4000, chip_smoke.SEED + 2)[0]
    p = str(tmp_path_factory.mktemp("lineitem") / "lineitem.parquet")
    pq.write_table(pa.table(data), p, row_group_size=1000)
    return data, p


def _frames(source, data, path, js, ts):
    if source == "parquet":   # 1,024-row batches
        return js.read.parquet(path), ts.read.parquet(path)
    return js.create_dataframe(data), ts.create_dataframe(data)


def _find(plan, name):
    if type(plan).__name__ == name:
        return plan
    for c in plan.children:
        r = _find(c, name)
        if r is not None:
            return r
    return None


@pytest.mark.parametrize("source", ["parquet", "numpy"])
def test_text_filter_agg_matches_jax(lineitem, source):
    """chip_smoke's text_filter_agg_6m at 4,000 rows."""
    data, path = lineitem
    js, ts = tpu_session(CONF), _torch_session(CONF)
    jdf, tdf = _frames(source, data, path, js, ts)
    jt = chip_smoke.text_agg_query(JAX_API, F, jdf).to_arrow()
    tt = chip_smoke.text_agg_query(st, TF, tdf).to_arrow()
    assert_tables_equal(tt, jt, ignore_order=False, approx_float=True)
    assert tt.num_rows == 6 and sum(tt.column("count_order").to_pylist()) > 0
    # a lone filter: the fusion pass leaves it a TorchFilterExec, as the
    # JAX pass leaves a TpuFilterExec, one output batch an input batch
    filt = _find(ts._last_plan, "TorchFilterExec")
    assert type(filt.pred).__name__ == "PallasContains"
    assert filt.metrics["numOutputBatches"] == \
        (4 if source == "parquet" else 1)


@pytest.mark.parametrize("source", ["parquet", "numpy"])
def test_text_filter_project_matches_jax(lineitem, source):
    """chip_smoke's text_filter_project_6m at 4,000 rows: every row and
    every string byte for byte, also as ``to_torch``'s (lengths, chars)
    against JAX ``to_jax``."""
    data, path = lineitem
    js, ts = tpu_session(CONF), _torch_session(CONF)
    jdf, tdf = _frames(source, data, path, js, ts)
    jq = chip_smoke.text_project_query(JAX_API, F, jdf)
    tq = chip_smoke.text_project_query(st, TF, tdf)
    jt, tt = jq.to_arrow(), tq.to_arrow()
    assert_tables_equal(tt, jt, ignore_order=False)
    assert tt.num_rows > 0
    jcols, _, jn = jq.to_jax()
    tcols, _, tn = tq.to_torch()
    assert tn == jn == tt.num_rows
    jlen, jchars = (np.asarray(a) for a in jcols["l_comment"])
    tlen, tchars = (t.numpy() for t in tcols["l_comment"])
    np.testing.assert_array_equal(tlen, jlen)
    inside = np.arange(tchars.shape[1])[None, :] < tlen[:, None]
    np.testing.assert_array_equal(tchars[inside], jchars[inside])
