"""Host blocks on the wire: the shuffle's serializer.

Counterpart of ``spark_rapids_tpu/shuffle/serializer.py``.  The JAX
package's inner frame is Arrow IPC; the port's main path has no pyarrow
(the card's machine has none), so its inner frame is its own
(``ROADMAP.md`` §C, an intended difference):

  ``SRTF`` u32le header length, the header (UTF-8 JSON: ``rows``, each
  field's ``name``, type name and nullability, and each plane's numpy
  dtype string and byte length), then the planes' raw little-endian
  bytes end to end.  A column has a validity plane (``np.packbits``,
  little bit order) and its values: a fixed-width column its values, a
  STRING column its int64 offsets and its UTF-8 bytes.  Nothing is
  pickled.

The envelope is the JAX package's, decoded outermost magic first:

  ``SRTC`` u8 algo, u32le crc, inner    the crc covers the inner frame;
                                        algo 1 = CRC32C, 2 = zlib CRC32
  ``SRTZ`` zstd stream                  a compressed inner frame
  ``SRTF`` ...                          the port's frame

with the JAX package's degrade rules: ``crc32c`` is zlib's ``crc32``
where ``google_crc32c`` is missing (``resolve_checksum``), and ``zstd``
is no compression where ``zstandard`` is (``codec_available``).  Every
decode failure (a checksum mismatch, a truncated, reordered or
bit-flipped frame or zstd stream, planes that do not add up) raises the
typed ``BlockCorruptError``, never wrong rows; a frame this process
cannot decode by design (a CRC32C or zstd frame without its module, an
Arrow IPC frame from the JAX package) raises ``FrameUnavailableError``.
``serializer.deserialize`` is the corruption fault site.
"""

from __future__ import annotations

import json
import struct
import zlib
from typing import List, Optional, Tuple

import numpy as np

from spark_rapids_tpu_torch import faults
from spark_rapids_tpu_torch.columnar.batch import HostColumns, \
    HostStrings, strings_from_bytes
from spark_rapids_tpu_torch.columnar.dtypes import BOOLEAN, STRING, \
    Field, Schema, from_name
from spark_rapids_tpu_torch.errors import EngineError

_FRAME_MAGIC = b"SRTF"
_ZSTD_MAGIC = b"SRTZ"
_CRC_MAGIC = b"SRTC"
_ARROW_IPC = b"\xff\xff\xff\xff"
_ALGO_CRC32C = 1
_ALGO_CRC32 = 2

try:
    import zstandard as _zstd
except ImportError:  # not on every machine: the codec degrades to none
    _zstd = None

try:
    import google_crc32c as _crc32c
except ImportError:  # not on every machine: crc32c degrades to crc32
    _crc32c = None


class FrameUnavailableError(EngineError, RuntimeError):
    """This process cannot decode the frame by design (a deployment
    mismatch, not corruption): refetching cannot help, so the manager
    neither spends its refetches on it nor blames the peer."""


class ChecksumUnavailableError(FrameUnavailableError):
    """The frame's checksum algorithm has no implementation here."""


class CodecUnavailableError(FrameUnavailableError):
    """The frame's codec module is not importable here."""


class BlockCorruptError(EngineError, IOError):
    """A block failed its checksum or its decode: the manager refetches
    the stored copy, counted apart from connection retries."""

    def __init__(self, map_id: Optional[int], cause: str):
        where = f" (map {map_id})" if map_id is not None else ""
        super().__init__(f"corrupt shuffle block{where}: {cause}")
        self.map_id = map_id
        self.cause = cause

    def __reduce__(self):
        return (BlockCorruptError, (self.map_id, self.cause))


class HostBlock:
    """One partition's rows on the host: ``schema`` and ``cols`` (the
    port's host format, name -> (values, validity))."""

    __slots__ = ("schema", "cols", "num_rows")

    def __init__(self, schema: Schema, cols: HostColumns,
                 num_rows: Optional[int] = None):
        self.schema = schema
        self.cols = cols
        self.num_rows = num_rows if num_rows is not None else (
            len(cols[schema[0].name][1]) if len(schema) else 0)

    @property
    def nbytes(self) -> int:
        """The bytes an Arrow batch of these rows holds, as pyarrow's
        ``nbytes`` counts them (the JAX package sizes its reduce groups
        by that): a string column its valid rows' UTF-8 bytes and an
        int32 offset a row, a boolean one a bit a row, any other its
        width; plus a validity bitmap where a value is null."""
        n = self.num_rows
        total = 0
        for f in self.schema:
            values, valid = self.cols[f.name]
            if f.dtype == STRING:
                total += int(values.lengths[valid].astype(np.int64).sum()) \
                    + 4 * n
            elif f.dtype == BOOLEAN:
                total += (n + 7) // 8
            else:
                total += n * np.dtype(f.dtype.numpy_dtype).itemsize
            if not valid.all():
                total += (n + 7) // 8
        return total

    def slice(self, start: int, n: int) -> "HostBlock":
        return HostBlock(self.schema, {
            f.name: (self.cols[f.name][0][start:start + n],
                     self.cols[f.name][1][start:start + n])
            for f in self.schema}, n)

    def header_bytes(self) -> int:
        """The size of the frame header's schema: what
        ``spark.rapids.shuffle.maxMetadataSize`` caps."""
        return len(_schema_json(self.schema).encode())


def _schema_json(schema: Schema) -> str:
    return json.dumps([[f.name, f.dtype.name, bool(f.nullable)]
                       for f in schema], separators=(",", ":"))


def codec_available() -> bool:
    return _zstd is not None


def checksum_available(algo: str) -> bool:
    return algo == "crc32" or (algo == "crc32c" and _crc32c is not None)


def resolve_checksum(algo: Optional[str]) -> Optional[str]:
    """The conf's algorithm -> the one used: ``crc32c`` degrades to
    zlib's ``crc32`` without google-crc32c; ``off`` is None."""
    algo = (algo or "off").lower()
    if algo == "off":
        return None
    if algo == "crc32c" and _crc32c is None:
        return "crc32"
    return algo


def _crc(algo_id: int, data: bytes) -> int:
    if algo_id == _ALGO_CRC32C:
        if _crc32c is None:
            raise ChecksumUnavailableError(
                "received a CRC32C-checksummed shuffle frame but "
                "google-crc32c is unavailable in this process")
        return _crc32c.value(data) & 0xFFFFFFFF
    return zlib.crc32(data) & 0xFFFFFFFF


def _planes(block: HostBlock) -> List[np.ndarray]:
    out = []
    for f in block.schema:
        values, valid = block.cols[f.name]
        out.append(np.packbits(np.asarray(valid, np.bool_),
                               bitorder="little"))
        if f.dtype == STRING:
            offsets, data = values.to_bytes()
            out.extend([offsets.astype("<i8"), data.astype(np.uint8)])
        else:
            dt = np.dtype(np.bool_ if f.dtype == BOOLEAN
                          else f.dtype.numpy_dtype).newbyteorder("<")
            out.append(np.ascontiguousarray(values, dtype=dt))
    return out


def encode_frame(block: HostBlock) -> bytes:
    """The port's inner frame of ``block``."""
    planes = _planes(block)
    header = json.dumps({
        "rows": int(block.num_rows),
        "schema": json.loads(_schema_json(block.schema)),
        "planes": [[p.dtype.str, int(p.nbytes)] for p in planes],
    }, separators=(",", ":")).encode()
    return b"".join([_FRAME_MAGIC, struct.pack("<I", len(header)), header,
                     *(p.tobytes() for p in planes)])


def decode_frame(raw) -> HostBlock:
    """The port's inner frame -> the block; raises on any structural
    mismatch (the caller types it)."""
    raw = memoryview(raw)
    if bytes(raw[:4]) != _FRAME_MAGIC:
        raise ValueError("not a port shuffle frame")
    (hlen,) = struct.unpack_from("<I", raw, 4)
    if 8 + hlen > len(raw):
        raise ValueError("header runs past the frame")
    header = json.loads(bytes(raw[8:8 + hlen]).decode())
    rows = int(header["rows"])
    fields = [Field(n, from_name(t), bool(nl))
              for n, t, nl in header["schema"]]
    specs = header["planes"]
    if sum(int(nb) for _, nb in specs) != len(raw) - 8 - hlen:
        raise ValueError("planes do not add up to the frame's length")
    off = 8 + hlen
    planes = []
    for dstr, nb in specs:
        dt = np.dtype(dstr)
        nb = int(nb)
        if nb % dt.itemsize:
            raise ValueError(f"plane of {nb} bytes is not {dstr}")
        planes.append(np.frombuffer(raw[off:off + nb], dtype=dt).copy())
        off += nb
    it = iter(planes)
    cols = {}
    for f in fields:
        bits = next(it)
        if bits.dtype != np.uint8 or bits.shape[0] != (rows + 7) // 8:
            raise ValueError(f"validity of {f.name!r} has the wrong size")
        valid = np.unpackbits(bits, count=rows, bitorder="little") \
            .astype(np.bool_)
        if f.dtype == STRING:
            offsets, data = next(it), next(it)
            if offsets.dtype != np.dtype("<i8") \
                    or offsets.shape[0] != rows + 1 or offsets[0] != 0 \
                    or offsets[-1] != data.shape[0] \
                    or (np.diff(offsets) < 0).any():
                raise ValueError(f"offsets of {f.name!r} are not sound")
            values = strings_from_bytes(offsets, data) if rows else \
                HostStrings(np.zeros((0, 8), np.uint8),
                            np.zeros(0, np.int32))
        else:
            values = next(it)
            want = np.dtype(np.bool_ if f.dtype == BOOLEAN
                            else f.dtype.numpy_dtype).newbyteorder("<")
            if values.dtype != want or values.shape[0] != rows:
                raise ValueError(f"values of {f.name!r} have the wrong "
                                 "type or length")
            values = values.astype(want.newbyteorder("="), copy=False)
        cols[f.name] = (values, valid)
    if next(it, None) is not None:
        raise ValueError("more planes than the schema has")
    return HostBlock(Schema(fields), cols, rows)


def serialize_block(block: HostBlock, codec: Optional[str] = None,
                    level: int = 3, checksum: Optional[str] = None) -> bytes:
    """Block -> wire frame.  ``codec`` "zstd" compresses (where zstandard
    is), ``checksum`` "crc32c" / "crc32" wraps it in ``SRTC``."""
    frame = encode_frame(block)
    if codec == "zstd" and _zstd is not None:
        frame = _ZSTD_MAGIC + \
            _zstd.ZstdCompressor(level=level).compress(frame)
    checksum = resolve_checksum(checksum)
    if checksum is not None:
        algo_id = _ALGO_CRC32C if checksum == "crc32c" else _ALGO_CRC32
        frame = _CRC_MAGIC + struct.pack(
            "<BI", algo_id, _crc(algo_id, frame)) + frame
    return frame


def _unwrap(payload: bytes) -> bytes:
    """Outer envelope -> the inner frame, checksums verified."""
    if payload[:4] == _CRC_MAGIC:
        if len(payload) < 9:
            raise IOError("truncated checksum header")
        algo_id, expect = struct.unpack_from("<BI", payload, 4)
        inner = payload[9:]
        if algo_id not in (_ALGO_CRC32C, _ALGO_CRC32):
            # a flipped bit in the algo byte lands here: corruption,
            # which a refetch repairs
            raise IOError(f"unknown checksum algorithm id {algo_id}")
        got = _crc(algo_id, inner)
        if got != expect:
            raise IOError(f"checksum mismatch: stored {expect:#010x}, "
                          f"computed {got:#010x}")
        payload = inner
    if payload[:4] == _ZSTD_MAGIC:
        if _zstd is None:
            raise CodecUnavailableError(
                "received a zstd shuffle frame but the zstandard module "
                "is unavailable in this process")
        return _zstd.ZstdDecompressor().decompress(payload[4:])
    if payload[:4] == _ARROW_IPC:
        raise FrameUnavailableError(
            "received an Arrow IPC shuffle frame: the port decodes its "
            "own frames only")
    return payload


def deserialize_blocks(blocks: List[Tuple[int, bytes]]) -> List[HostBlock]:
    """[(map_id, frame)] -> the blocks with rows, in map order.  Raises
    ``BlockCorruptError`` on any checksum or decode failure."""
    out: List[HostBlock] = []
    for map_id, payload in sorted(blocks, key=lambda t: t[0]):
        if not payload:
            continue
        payload = faults.corrupt("serializer.deserialize", payload)
        try:
            block = decode_frame(_unwrap(payload))
        except (BlockCorruptError, FrameUnavailableError):
            raise
        except Exception as e:  # every payload-shaped failure, typed
            raise BlockCorruptError(map_id, f"{type(e).__name__}: {e}")
        if block.num_rows:
            out.append(block)
    return out
