"""The port's block transport and serializer against the JAX package's
(``spark_rapids_tpu_torch/shuffle/transport.py``, ``serializer.py``).

Analog of ``tests/test_shuffle_transport.py`` and the serializer half of
``tests/test_faults.py``:

* put / fetch / stat / drop round trips over the native and the Python
  transport, and each against the other;
* the wire protocol is the JAX package's: the port's client puts and
  fetches through the JAX package's server and the JAX client through
  the port's, native and Python (the bytes must be equal);
* the native library is built into the port's ``_build/`` under its
  source's hash, never into ``native/``;
* timeouts bound a stalled peer on both sides;
* the serializer round-trips every column type the port has, with
  nulls and with no rows, under each checksum and codec; truncated,
  bit-flipped and reordered frames and a wrong checksum raise
  ``BlockCorruptError``; a frame the process cannot decode by design (a
  zstd frame without zstandard, an Arrow IPC frame) raises
  ``FrameUnavailableError``;
* ``Backoff`` gives the JAX package's delays for the same seed, and
  ``bounded_q_get`` times out.

Every comparison is exact (bytes, values, delays).
"""

import os
import queue
import socket
import struct
import threading
import time
import zlib

import numpy as np
import pytest

from spark_rapids_tpu import faults as jfaults
from spark_rapids_tpu.shuffle import transport as jtransport
from spark_rapids_tpu.utils.retry import Backoff as JBackoff

from spark_rapids_tpu_torch import faults
from spark_rapids_tpu_torch.columnar.batch import HostStrings, \
    host_columns_from_numpy
from spark_rapids_tpu_torch.columnar.dtypes import BOOLEAN, DATE, FLOAT32, \
    FLOAT64, INT8, INT16, INT32, INT64, STRING, TIMESTAMP, Field, Schema
from spark_rapids_tpu_torch.shuffle import serializer as ser
from spark_rapids_tpu_torch.shuffle import transport
from spark_rapids_tpu_torch.utils.queues import bounded_q_get
from spark_rapids_tpu_torch.utils.retry import Backoff
from tests.torch_threads import _one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE = [True, False] if transport.native_available() else [False]
IDS = ["native" if m else "python" for m in NATIVE]


@pytest.fixture(autouse=True)
def _no_faults():
    faults.reset()
    jfaults.reset()
    yield
    faults.reset()
    jfaults.reset()


@pytest.mark.parametrize("native", NATIVE, ids=IDS)
def test_put_fetch_roundtrip(native):
    srv = transport.ShuffleServer(prefer_native=native)
    try:
        assert srv.native == native
        cli = transport.ShuffleClient(srv.port, prefer_native=native)
        payloads = {m: bytes([m]) * (1000 + m) for m in range(5)}
        for m, p in payloads.items():
            cli.put(7, m, 3, p)
        cli.put(7, 0, 4, b"other-partition")
        cli.put(8, 0, 3, b"other-shuffle")
        assert dict(cli.fetch(7, 3)) == payloads
        assert cli.stat(7, 3) == sum(len(p) for p in payloads.values())
        assert dict(cli.fetch(7, 4)) == {0: b"other-partition"}
        assert cli.fetch(7, 99) == []
        assert srv.bytes_in > 0 and srv.bytes_out > 0
        cli.drop(7)
        assert cli.fetch(7, 3) == [] and cli.stat(7, 3) == 0
        assert dict(cli.fetch(8, 3)) == {0: b"other-shuffle"}
        cli.close()
    finally:
        srv.stop()


def _cross(server, client_cls, srv_native, cli_native):
    srv = server(prefer_native=srv_native)
    try:
        cli = client_cls(srv.port, prefer_native=cli_native)
        blocks = {m: os.urandom(300 + 17 * m) for m in range(4)}
        for m, p in blocks.items():
            cli.put(3, m, 1, p)
        cli.put(3, 9, 2, b"")
        got = cli.fetch(3, 1)
        assert [m for m, _ in got] == sorted(blocks)
        assert {m: bytes(p) for m, p in got} == blocks
        assert cli.stat(3, 1) == sum(len(p) for p in blocks.values())
        assert [(m, bytes(p)) for m, p in cli.fetch(3, 2)] == [(9, b"")]
        cli.drop(3)
        assert cli.fetch(3, 1) == []
        cli.close()
    finally:
        srv.stop()


@pytest.mark.parametrize("srv_native", NATIVE, ids=IDS)
@pytest.mark.parametrize("cli_native", NATIVE, ids=IDS)
def test_port_client_talks_to_the_jax_server(srv_native, cli_native):
    if srv_native and not jtransport.native_available():
        pytest.skip("the JAX package's native transport did not build")
    _cross(jtransport.ShuffleServer, transport.ShuffleClient, srv_native,
           cli_native)


@pytest.mark.parametrize("srv_native", NATIVE, ids=IDS)
@pytest.mark.parametrize("cli_native", NATIVE, ids=IDS)
def test_jax_client_talks_to_the_port_server(srv_native, cli_native):
    if cli_native and not jtransport.native_available():
        pytest.skip("the JAX package's native transport did not build")
    _cross(transport.ShuffleServer, jtransport.ShuffleClient, srv_native,
           cli_native)


def test_native_library_builds_into_the_ports_build_dir():
    if not transport.native_available():
        pytest.skip(f"no native transport: {transport.build_error()}")
    path = transport.library_path()
    assert os.path.dirname(path) == os.path.join(
        REPO, "spark_rapids_tpu_torch", "_build")
    assert os.path.exists(path)
    import hashlib
    with open(os.path.join(REPO, "native", "transport.cc"), "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    assert os.path.basename(path) == f"libsrt_transport-{digest}.so"


def test_read_timeout_bounds_a_stalled_peer():
    stall = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    stall.bind(("127.0.0.1", 0))
    stall.listen(1)
    accepted = []
    t = threading.Thread(target=lambda: accepted.append(stall.accept()),
                         daemon=True)
    t.start()
    try:
        c = transport.ShuffleClient(stall.getsockname()[1],
                                    prefer_native=False,
                                    connect_timeout=2.0, read_timeout=0.5)
        start = time.monotonic()
        with pytest.raises((socket.timeout, OSError)):
            c.fetch(1, 0)
        assert time.monotonic() - start < 5.0
        c.close()
    finally:
        stall.close()
        for conn, _ in accepted:
            conn.close()
        t.join(timeout=5)


@pytest.mark.parametrize("native", NATIVE, ids=IDS)
def test_server_bounds_a_stall_mid_frame(native):
    srv = transport.ShuffleServer(port=0, prefer_native=native,
                                  read_timeout=0.5)
    try:
        s = socket.create_connection(("127.0.0.1", srv.port), timeout=5)
        s.sendall(b"P")  # a frame begun, then nothing
        s.settimeout(10)
        start = time.monotonic()
        assert s.recv(1) == b""  # the server hung up
        assert time.monotonic() - start < 5.0
        s.close()
    finally:
        srv.stop()


def test_connect_fault_site_fires_before_connecting():
    faults.configure({"transport.connect": "count:1"})
    with pytest.raises(faults.InjectedFault):
        transport.ShuffleClient(1, prefer_native=False)


# -- the serializer -------------------------------------------------------------

def _all_types_block(n: int = 257):
    rng = np.random.default_rng(5)
    data = {
        "b": rng.random(n) < 0.5,
        "i8": rng.integers(-128, 127, n).astype(np.int8),
        "i16": rng.integers(-3000, 3000, n).astype(np.int16),
        "i32": rng.integers(-10**6, 10**6, n).astype(np.int32),
        "i64": rng.integers(-10**12, 10**12, n),
        "f32": rng.normal(size=n).astype(np.float32),
        "f64": np.where(rng.random(n) < 0.05, np.nan, rng.normal(size=n)),
        "s": np.array([f"row-{i}" * (i % 4) + ("é" if i % 5 else "")
                       for i in range(n)], dtype=object),
    }
    masks = {k: rng.random(n) > 0.1 for k in data}
    schema, cols = host_columns_from_numpy(data, masks)
    fields = list(schema.fields)
    # the two types numpy tables do not make: DATE and TIMESTAMP
    cols["d"] = (rng.integers(0, 20000, n).astype(np.int32),
                 rng.random(n) > 0.1)
    cols["ts"] = (rng.integers(0, 10**15, n), rng.random(n) > 0.1)
    fields += [Field("d", DATE), Field("ts", TIMESTAMP)]
    schema = Schema(fields)
    assert {f.dtype for f in schema} == {BOOLEAN, INT8, INT16, INT32, INT64,
                                         FLOAT32, FLOAT64, STRING, DATE,
                                         TIMESTAMP}
    return ser.HostBlock(schema, cols, n)


def _assert_blocks_equal(a, b):
    assert a.schema == b.schema and a.num_rows == b.num_rows
    for f in a.schema:
        va, ma = a.cols[f.name]
        vb, mb = b.cols[f.name]
        np.testing.assert_array_equal(ma, mb)
        if f.dtype == STRING:
            la, lb = va.to_pylist(), vb.to_pylist()
            assert [x for x, m in zip(la, ma) if m] == \
                [x for x, m in zip(lb, mb) if m]
        else:
            assert vb.dtype == np.dtype(f.dtype.numpy_dtype)
            np.testing.assert_array_equal(va[ma], vb[mb])


@pytest.mark.parametrize("checksum", ["crc32c", "crc32", None])
@pytest.mark.parametrize("codec", ["zstd", None])
@pytest.mark.parametrize("rows", [257, 1, 0])
def test_serializer_round_trips_every_type(checksum, codec, rows):
    block = _all_types_block(max(rows, 1))
    if rows == 0:
        block = block.slice(0, 0)
    frame = ser.serialize_block(block, codec=codec, checksum=checksum)
    out = ser.deserialize_blocks([(0, frame)])
    if rows == 0:
        assert out == []  # blocks without rows are dropped, as in JAX
        assert ser.decode_frame(ser._unwrap(frame)).num_rows == 0
        return
    assert len(out) == 1
    _assert_blocks_equal(block, out[0])


def test_mixed_envelopes_decode_side_by_side_in_map_order():
    block = _all_types_block(64)
    frames = [(2, ser.serialize_block(block, checksum="crc32")),
              (0, ser.serialize_block(block, checksum="crc32c")),
              (1, ser.serialize_block(block, codec="zstd", checksum=None))]
    out = ser.deserialize_blocks(frames)
    assert len(out) == 3
    for b in out:
        _assert_blocks_equal(block, b)


def test_checksum_degrades_as_in_jax(monkeypatch):
    from spark_rapids_tpu.shuffle import serializer as jser
    for algo in ("crc32c", "crc32", "off", None):
        assert ser.resolve_checksum(algo) == jser.resolve_checksum(algo)
    monkeypatch.setattr(ser, "_crc32c", None)
    monkeypatch.setattr(jser, "_crc32c", None)
    assert ser.resolve_checksum("crc32c") == jser.resolve_checksum(
        "crc32c") == "crc32"
    assert ser.checksum_available("crc32c") is False


def _corruptions(frame, rng, per_kind=25):
    """Truncations, bit flips and chunk swaps of one frame (the JAX
    test's)."""
    n = len(frame)
    for _ in range(per_kind):
        yield frame[:int(rng.integers(1, n))]
    for _ in range(per_kind):
        pos = int(rng.integers(0, n))
        buf = bytearray(frame)
        buf[pos] ^= 1 << int(rng.integers(0, 8))
        yield bytes(buf)
    for _ in range(per_kind):
        chunk = int(rng.integers(1, max(2, n // 4)))
        i = int(rng.integers(0, n - 2 * chunk))
        j = int(rng.integers(i + chunk, n - chunk + 1))
        buf = bytearray(frame)
        buf[i:i + chunk], buf[j:j + chunk] = \
            frame[j:j + chunk], frame[i:i + chunk]
        if bytes(buf) != frame:
            yield bytes(buf)


@pytest.mark.parametrize("checksum", ["crc32c", "crc32"])
@pytest.mark.parametrize("codec", ["zstd", None])
def test_corrupted_frames_raise_the_typed_error(checksum, codec):
    frame = ser.serialize_block(_all_types_block(), codec=codec,
                                checksum=checksum)
    rng = np.random.default_rng(1234)
    checked = 0
    for mangled in _corruptions(frame, rng):
        with pytest.raises(ser.BlockCorruptError):
            ser.deserialize_blocks([(3, mangled)])
        checked += 1
    assert checked >= 70


def test_truncation_without_checksum_is_typed():
    frame = ser.serialize_block(_all_types_block(), checksum=None)
    rng = np.random.default_rng(99)
    for _ in range(40):
        cut = int(rng.integers(1, len(frame) - 1))
        with pytest.raises(ser.BlockCorruptError):
            ser.deserialize_blocks([(0, frame[:cut])])


def test_wrong_checksum_is_corruption():
    inner = ser.encode_frame(_all_types_block(16))
    for algo, crc in ((2, (zlib.crc32(inner) + 1) & 0xFFFFFFFF),
                      (7, zlib.crc32(inner) & 0xFFFFFFFF)):
        frame = b"SRTC" + struct.pack("<BI", algo, crc) + inner
        with pytest.raises(ser.BlockCorruptError):
            ser.deserialize_blocks([(0, frame)])


def test_frames_this_process_cannot_decode_are_not_corruption(monkeypatch):
    block = _all_types_block(16)
    frame = ser.serialize_block(block, codec="zstd", checksum="crc32")
    if ser.codec_available():
        monkeypatch.setattr(ser, "_zstd", None)
    else:
        inner = b"SRTZ" + b"\x28\xb5\x2f\xfd" + b"\x00" * 16
        frame = b"SRTC" + struct.pack(
            "<BI", 2, zlib.crc32(inner) & 0xFFFFFFFF) + inner
    with pytest.raises(ser.CodecUnavailableError):
        ser.deserialize_blocks([(0, frame)])
    # an Arrow IPC frame from the JAX package
    import pyarrow as pa
    from spark_rapids_tpu.shuffle.serializer import serialize_batch
    ipc = serialize_batch(pa.record_batch({"a": pa.array([1, 2])}),
                          codec=None, checksum="crc32")
    with pytest.raises(ser.FrameUnavailableError):
        ser.deserialize_blocks([(0, ipc)])


def test_corruption_fault_site_flips_one_bit():
    faults.configure({"serializer.deserialize": "count:1"})
    frame = ser.serialize_block(_all_types_block(8), checksum="crc32")
    with pytest.raises(ser.BlockCorruptError):
        ser.deserialize_blocks([(0, frame)])
    assert len(ser.deserialize_blocks([(0, frame)])) == 1


def test_host_block_nbytes_counts_as_arrow():
    """``HostBlock.nbytes`` is pyarrow's ``nbytes`` of the same rows (the
    reduce grouping sizes blocks by it, as the JAX package does)."""
    import pyarrow as pa
    from spark_rapids_tpu_torch.columnar.batch import host_columns_to_arrow
    block = _all_types_block(100)
    table = host_columns_to_arrow(block.schema, block.cols)
    assert block.nbytes == table.nbytes


def test_strings_keep_embedded_nuls_and_width():
    vals = HostStrings(np.array([[97, 0, 98, 0], [0, 0, 0, 0]], np.uint8),
                       np.array([3, 0], np.int32))
    schema = Schema([Field("s", STRING)])
    block = ser.HostBlock(schema, {"s": (vals, np.array([True, True]))}, 2)
    out = ser.deserialize_blocks([(0, ser.serialize_block(block))])[0]
    got, _ = out.cols["s"]
    assert got.lengths.tolist() == [3, 0]
    assert got.chars[0, :3].tolist() == [97, 0, 98]


# -- helpers ----------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 7, 1234])
def test_backoff_replays_the_jax_delays(seed):
    ours = Backoff(0.05, 2.0, 0.2, seed=seed)
    ref = JBackoff(0.05, 2.0, 0.2, seed=seed)
    assert [ours.delay(k) for k in range(12)] == \
        [ref.delay(k) for k in range(12)]
    flat = Backoff(0.1, 0.4, 0.0)
    assert [flat.delay(k) for k in range(4)] == [0.1, 0.2, 0.4, 0.4]


def test_bounded_q_get_times_out_and_returns():
    q = queue.Queue()
    q.put(5)
    assert bounded_q_get(q, 1.0, "x") == 5
    start = time.monotonic()
    with pytest.raises(TimeoutError, match="waiting for the thing"):
        bounded_q_get(q, 1.0, "the thing")
    assert time.monotonic() - start < 4.0
