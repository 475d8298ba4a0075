"""The shuffle's block transport: the native TCP data plane through
ctypes, and a Python server and client that speak the same protocol.

Counterpart of ``spark_rapids_tpu/shuffle/transport.py``.  The native
side is the repo's ``native/transport.cc`` (a block store keyed by
shuffle, map and partition; one thread a connection), which the port
compiles at first use with ``g++`` into ``_build/`` under a name that
carries the hash of the source, as ``native.py`` names its kernels; it
never writes into ``native/``.  Where no toolchain builds it, the Python
implementation speaks the identical wire protocol, so either side of a
connection may be either, and the JAX package's servers and clients
talk to the port's:

  PUT   ``P`` [u32 shuffle][u32 map][u32 part][u64 len][payload] -> 0x01
  FETCH ``F`` [u32 shuffle][u32 part] ->
        [u32 n] then per block [u32 map][u64 len][payload]
  STAT  ``S`` [u32 shuffle][u32 part] -> [u64 bytes stored]
  DROP  ``D`` [u32 shuffle] -> 0x01

Every receive is bounded: a client's connect by ``connect_timeout`` and
each read by ``read_timeout``; a server bounds every read once a frame
has begun (the idle wait between two requests is unbounded, as peers
keep their connections open across the map/reduce gap, and ``stop``
closes those connections).  The ``transport.connect`` and
``transport.fetch`` fault sites fire at a client's construction and at
each fetch.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import logging
import os
import socket
import struct
import subprocess
import threading
import time
from typing import Dict, List, Optional, Tuple

from spark_rapids_tpu_torch import faults

DEFAULT_CONNECT_TIMEOUT = 5.0
DEFAULT_READ_TIMEOUT = 30.0

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_BUILD_DIR = os.path.join(_PKG, "_build")
SOURCE = os.path.join(os.path.dirname(_PKG), "native", "transport.cc")

log = logging.getLogger("spark_rapids_tpu_torch.shuffle")

_lib = None
_lib_lock = threading.Lock()
_build_error: Optional[str] = None


def library_path() -> str:
    """``_build/libsrt_transport-<hash of the source>.so``."""
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(_BUILD_DIR, f"libsrt_transport-{digest}.so")


def _declare(lib) -> None:
    lib.srt_server_start_t.restype = ctypes.c_void_p
    lib.srt_server_start_t.argtypes = [ctypes.c_uint16, ctypes.c_uint32]
    lib.srt_server_port.restype = ctypes.c_uint16
    lib.srt_server_port.argtypes = [ctypes.c_void_p]
    lib.srt_server_bytes_in.restype = ctypes.c_uint64
    lib.srt_server_bytes_in.argtypes = [ctypes.c_void_p]
    lib.srt_server_bytes_out.restype = ctypes.c_uint64
    lib.srt_server_bytes_out.argtypes = [ctypes.c_void_p]
    lib.srt_server_stop.argtypes = [ctypes.c_void_p]
    lib.srt_connect_t.restype = ctypes.c_int
    lib.srt_connect_t.argtypes = [ctypes.c_uint16, ctypes.c_uint32,
                                  ctypes.c_uint32]
    lib.srt_put.restype = ctypes.c_int
    lib.srt_put.argtypes = [ctypes.c_int, ctypes.c_uint32, ctypes.c_uint32,
                            ctypes.c_uint32, ctypes.c_char_p,
                            ctypes.c_uint64]
    lib.srt_fetch_size.restype = ctypes.c_int64
    lib.srt_fetch_size.argtypes = [ctypes.c_int, ctypes.c_uint32,
                                   ctypes.c_uint32]
    lib.srt_stat.restype = ctypes.c_int64
    lib.srt_stat.argtypes = [ctypes.c_int, ctypes.c_uint32, ctypes.c_uint32]
    lib.srt_fetch_read.restype = ctypes.c_int
    lib.srt_fetch_read.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
    lib.srt_drop.restype = ctypes.c_int
    lib.srt_drop.argtypes = [ctypes.c_int, ctypes.c_uint32]
    lib.srt_close.argtypes = [ctypes.c_int]


def _load_native():
    """Build (once a source) and load the native transport; None, with
    the reason kept in ``build_error()``, where it cannot be built."""
    global _lib, _build_error
    with _lib_lock:
        if _lib is not None or _build_error is not None:
            return _lib
        try:
            out = library_path()
            if not os.path.exists(out):
                os.makedirs(_BUILD_DIR, exist_ok=True)
                # a process's own temporary name, then one rename: the
                # worker processes may build beside each other
                tmp = f"{out}.{os.getpid()}.tmp"
                subprocess.run(
                    ["g++", "-O2", "-shared", "-fPIC", "-std=c++17",
                     "-pthread", "-o", tmp, SOURCE],
                    check=True, capture_output=True, timeout=120)
                os.replace(tmp, out)
            lib = ctypes.CDLL(out)
            _declare(lib)
            _lib = lib
        except (OSError, subprocess.SubprocessError) as e:
            _build_error = f"{type(e).__name__}: {e}"
            _lib = None
        return _lib


def native_available() -> bool:
    return _load_native() is not None


def build_error() -> Optional[str]:
    """Why the native transport is not in use, or None."""
    _load_native()
    return _build_error


# ---------------------------------------------------------------------------
# the Python implementation of the same protocol
# ---------------------------------------------------------------------------

def _read_full(sock: socket.socket, n: int,
               pool: Optional["BounceBufferPool"] = None):
    """Exactly ``n`` bytes from ``sock`` (bytes, or a bytearray through
    ``pool``), or None at end of stream.  With a pool the payload lands
    in one destination in pool-sized reads while holding a pool slot."""
    if pool is None:
        buf = bytearray()
        while len(buf) < n:
            chunk = sock.recv(n - len(buf))
            if not chunk:
                return None
            buf += chunk
        return bytes(buf)
    out = bytearray(n)
    view = memoryview(out)
    off = 0
    with pool.acquire():
        while off < n:
            want = min(n - off, pool.size)
            got = sock.recv_into(view[off:off + want], want)
            if got <= 0:
                return None
            off += got
    return out


class BounceBufferPool:
    """Bounded staging slots for payload reads: at most ``count`` reads
    stage at once, each draining the socket in ``size``-byte chunks
    (``spark.rapids.shuffle.bounceBuffers.*``)."""

    def __init__(self, count: int = 8, size: int = 4 * 1024 * 1024):
        self.size = max(4096, int(size))
        self._sem = threading.Semaphore(max(1, int(count)))

    @contextlib.contextmanager
    def acquire(self):
        self._sem.acquire()
        try:
            yield
        finally:
            self._sem.release()


class _PyServer:
    def __init__(self, port: int = 0,
                 read_timeout: float = DEFAULT_READ_TIMEOUT):
        from spark_rapids_tpu_torch import lifecycle
        self.read_timeout = read_timeout
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind(("127.0.0.1", port))
        self._sock.listen(128)
        self.port = self._sock.getsockname()[1]
        self._blocks: Dict[Tuple[int, int, int], bytes] = {}
        self._mu = threading.Lock()
        self.bytes_in = 0
        self.bytes_out = 0
        self._running = True
        self._threads: List[threading.Thread] = []
        self._conns: List[socket.socket] = []
        self._accept = threading.Thread(target=self._accept_loop,
                                        name="srt-shuffle-accept",
                                        daemon=True)
        self._reg = lifecycle.register_resource(
            self.stop, kind="transport", name="shuffle-server")
        if self._reg.rejected:
            # a teardown raced the construction: stop() already ran
            return
        self._accept.start()

    def _accept_loop(self):
        while self._running:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                break
            t = threading.Thread(target=self._serve, args=(conn,),
                                 name="srt-shuffle-serve", daemon=True)
            with self._mu:
                if not self._running:
                    conn.close()
                    break
                self._conns.append(conn)
            t.start()
            self._threads = [x for x in self._threads if x.is_alive()]
            self._threads.append(t)

    def _serve(self, conn: socket.socket):
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        try:
            while True:
                # idle between requests is unbounded; once a frame has
                # begun every read is bounded
                conn.settimeout(None)
                magic = _read_full(conn, 1)
                if not magic:
                    return
                conn.settimeout(self.read_timeout or None)
                if not self._handle(conn, magic):
                    return
        except OSError as e:
            log.debug("shuffle server connection ended: %s", e)
        finally:
            conn.close()
            with self._mu:
                if conn in self._conns:
                    self._conns.remove(conn)

    def _handle(self, conn: socket.socket, magic: bytes) -> bool:
        """Answer one request; False ends the connection."""
        if magic == b"P":
            hdr = _read_full(conn, 20)
            if hdr is None:
                return False
            sh, mp, pt, length = struct.unpack("<IIIQ", hdr)
            payload = _read_full(conn, length) if length else b""
            if payload is None:
                return False
            with self._mu:
                self._blocks[(sh, mp, pt)] = payload
                self.bytes_in += length
            conn.sendall(b"\x01")
        elif magic in (b"F", b"S"):
            hdr = _read_full(conn, 8)
            if hdr is None:
                return False
            sh, pt = struct.unpack("<II", hdr)
            with self._mu:
                out = sorted((k[1], v) for k, v in self._blocks.items()
                             if k[0] == sh and k[2] == pt)
            if magic == b"S":
                conn.sendall(struct.pack("<Q", sum(len(v) for _, v in out)))
                return True
            conn.sendall(struct.pack("<I", len(out)))
            for mp, payload in out:
                conn.sendall(struct.pack("<IQ", mp, len(payload)))
                if payload:
                    conn.sendall(payload)
                self.bytes_out += len(payload)
        elif magic == b"D":
            hdr = _read_full(conn, 4)
            if hdr is None:
                return False
            (sh,) = struct.unpack("<I", hdr)
            with self._mu:
                for k in [k for k in self._blocks if k[0] == sh]:
                    del self._blocks[k]
            conn.sendall(b"\x01")
        else:
            return False
        return True

    def stop(self):
        self._running = False
        reg = getattr(self, "_reg", None)
        if reg is not None:
            reg.release()
        # shutdown wakes the thread blocked in accept(); close alone
        # does not on Linux
        for op in (lambda: self._sock.shutdown(socket.SHUT_RDWR),
                   self._sock.close):
            try:
                op()
            except OSError as e:
                log.debug("shuffle server socket teardown: %s", e)
        with self._mu:
            conns, self._conns = self._conns, []
        for c in conns:
            try:
                c.close()
            except OSError as e:
                log.debug("closing a shuffle connection: %s", e)
        # one shared 2 s budget across every join
        deadline = time.monotonic() + 2.0
        for t in (*self._threads, self._accept):
            if t.is_alive():
                t.join(timeout=max(0.0, deadline - time.monotonic()))


class ShuffleServer:
    """A block server: holds map output blocks and serves partition
    fetches; native where ``g++`` built the library, else Python."""

    def __init__(self, port: int = 0, prefer_native: bool = True,
                 read_timeout: float = DEFAULT_READ_TIMEOUT):
        lib = _load_native() if prefer_native else None
        if lib is not None:
            self._h = lib.srt_server_start_t(
                port, int(max(0.0, read_timeout) * 1000))
            if not self._h:
                raise RuntimeError("native shuffle server failed to start")
            self._lib = lib
            self._py = None
            self.port = lib.srt_server_port(self._h)
            self.native = True
        else:
            self._py = _PyServer(port, read_timeout=read_timeout)
            self.port = self._py.port
            self.native = False

    @property
    def bytes_in(self) -> int:
        if self._py is not None:
            return self._py.bytes_in
        return self._lib.srt_server_bytes_in(self._h)

    @property
    def bytes_out(self) -> int:
        if self._py is not None:
            return self._py.bytes_out
        return self._lib.srt_server_bytes_out(self._h)

    def stop(self) -> None:
        if self._py is not None:
            self._py.stop()
        elif self._h:
            self._lib.srt_server_stop(self._h)
            self._h = None


class ShuffleClient:
    """One connection to a peer's block server."""

    def __init__(self, port: int, prefer_native: bool = True,
                 bounce_pool: Optional[BounceBufferPool] = None,
                 connect_timeout: float = DEFAULT_CONNECT_TIMEOUT,
                 read_timeout: float = DEFAULT_READ_TIMEOUT):
        faults.maybe_fail("transport.connect",
                          f"injected connect failure to port {port}")
        lib = _load_native() if prefer_native else None
        self._pool = bounce_pool
        self.native = lib is not None
        if lib is not None:
            self._fd = lib.srt_connect_t(
                port, int(max(0.0, connect_timeout) * 1000),
                int(max(0.0, read_timeout) * 1000))
            if self._fd < 0:
                raise ConnectionError(f"cannot reach shuffle port {port}")
            self._lib = lib
            self._sock = None
        else:
            self._sock = socket.create_connection(
                ("127.0.0.1", port),
                timeout=connect_timeout if connect_timeout > 0 else None)
            self._sock.settimeout(read_timeout if read_timeout > 0
                                  else None)
            self._sock.setsockopt(socket.IPPROTO_TCP,
                                  socket.TCP_NODELAY, 1)
            self._lib = None

    def stat(self, shuffle: int, part: int) -> int:
        """The bytes the peer stores for (shuffle, part): what the
        in-flight window reserves before the fetch."""
        if self._lib is not None:
            size = self._lib.srt_stat(self._fd, shuffle, part)
            if size < 0:
                raise IOError("shuffle stat failed")
            return int(size)
        self._sock.sendall(b"S" + struct.pack("<II", shuffle, part))
        raw = _read_full(self._sock, 8)
        if raw is None:
            raise IOError("shuffle stat failed")
        return struct.unpack("<Q", raw)[0]

    def put(self, shuffle: int, map_id: int, part: int,
            payload: bytes) -> None:
        if self._lib is not None:
            if self._lib.srt_put(self._fd, shuffle, map_id, part, payload,
                                 len(payload)) != 0:
                raise IOError("shuffle put failed")
            return
        self._sock.sendall(b"P" + struct.pack("<IIIQ", shuffle, map_id,
                                              part, len(payload)))
        if payload:
            self._sock.sendall(payload)
        if _read_full(self._sock, 1) != b"\x01":
            raise IOError("shuffle put failed")

    def fetch(self, shuffle: int, part: int) -> List[Tuple[int, bytes]]:
        """-> [(map_id, payload)] of one reduce partition."""
        faults.maybe_fail(
            "transport.fetch",
            f"injected fetch failure (shuffle {shuffle}, part {part})")
        if self._lib is not None:
            size = self._lib.srt_fetch_size(self._fd, shuffle, part)
            if size < 0:
                raise IOError("shuffle fetch failed")
            buf = ctypes.create_string_buffer(int(size))
            if self._lib.srt_fetch_read(buf, size) != 0:
                raise IOError("shuffle fetch read failed")
            raw = memoryview(buf.raw)
            (n,) = struct.unpack_from("<I", raw, 0)
            off = 4
            out = []
            for _ in range(n):
                mp, ln = struct.unpack_from("<IQ", raw, off)
                off += 12
                out.append((mp, bytes(raw[off:off + ln])))
                off += ln
            return out
        self._sock.sendall(b"F" + struct.pack("<II", shuffle, part))
        nb = _read_full(self._sock, 4)
        if nb is None:
            raise IOError("shuffle fetch failed")
        (n,) = struct.unpack("<I", nb)
        out = []
        for _ in range(n):
            hdr = _read_full(self._sock, 12)
            if hdr is None:
                raise IOError("shuffle fetch truncated")
            mp, ln = struct.unpack("<IQ", hdr)
            payload = _read_full(self._sock, ln, self._pool) if ln else b""
            if payload is None:
                raise IOError("shuffle fetch truncated")
            out.append((mp, bytes(payload)))
        return out

    def drop(self, shuffle: int) -> None:
        if self._lib is not None:
            if self._lib.srt_drop(self._fd, shuffle) != 0:
                raise IOError("shuffle drop failed")
            return
        self._sock.sendall(b"D" + struct.pack("<I", shuffle))
        if _read_full(self._sock, 1) != b"\x01":
            raise IOError("shuffle drop failed")

    def close(self) -> None:
        if self._lib is not None:
            if self._fd >= 0:
                self._lib.srt_close(self._fd)
                self._fd = -1
        elif self._sock is not None:
            self._sock.close()
            self._sock = None
