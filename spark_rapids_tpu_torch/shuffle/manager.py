"""The shuffle manager: the metadata plane over the block transport.

Counterpart of ``spark_rapids_tpu/shuffle/manager.py``.  One
``TorchShuffleManager`` a process (the exchange's parent and each map
worker): ``register_peers`` connects a client to every peer's server
(its own included), partition ``p`` lives on peer ``p % n``; the map
side calls ``write_partition`` a (map, partition) block, the reduce side
``read_partition`` or ``read_partitions`` to gather a partition's blocks
from its owner.

The failure plane is the JAX package's: a failed peer operation retries
on a fresh connection after an exponential, jittered ``Backoff``
(``fetch.retries``), then raises ``FetchFailedError``; a block that
fails its checksum or decode is refetched (``corrupt.refetches``),
counted apart; ``peer.maxFailures`` consecutive failures blacklist the
peer so its later fetches fail at once into the stage's recompute.  A
fetch first reserves its peer's stat under ``maxBytesInFlight``, and a
block's header schema is capped by ``maxMetadataSize``.  ``stats()``
gives the counters, which ``stop`` adds to the process-wide
``global_stats()`` (the registry's ``shuffle`` section).

``select_shuffle_mode`` keeps the JAX package's rules, one for one.
Where they elect ``ici`` (the mesh exchange) the port raises
``MeshNotPortedError``: the mesh is queue A8b, and a conf that asks for
it on two or more GPUs must not quietly take the host path.
"""

from __future__ import annotations

import itertools
import logging
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence

from spark_rapids_tpu_torch import faults
from spark_rapids_tpu_torch.errors import EngineError
from spark_rapids_tpu_torch.faults import InjectedFault
from spark_rapids_tpu_torch.shuffle.serializer import BlockCorruptError, \
    HostBlock, codec_available, deserialize_blocks, resolve_checksum, \
    serialize_block
from spark_rapids_tpu_torch.shuffle.transport import \
    DEFAULT_CONNECT_TIMEOUT, DEFAULT_READ_TIMEOUT, BounceBufferPool, \
    ShuffleClient, ShuffleServer
from spark_rapids_tpu_torch.utils.retry import Backoff

log = logging.getLogger("spark_rapids_tpu_torch.shuffle")


class FetchFailedError(EngineError, IOError):
    """A peer operation failed after its retries (Spark's
    FetchFailedException: the stage recomputes the map work)."""

    def __init__(self, port: int, shuffle: int, part: int, cause):
        super().__init__(
            f"shuffle fetch failed: peer port {port}, shuffle {shuffle}, "
            f"partition {part}: {cause}")
        self.port = port
        self.shuffle = shuffle
        self.part = part
        self.cause = str(cause)

    def __reduce__(self):
        return (FetchFailedError,
                (self.port, self.shuffle, self.part, self.cause))


class MeshNotPortedError(EngineError, NotImplementedError):
    """``spark.rapids.shuffle.mode=ici`` qualified (two or more GPUs, no
    map workers, no explicit mesh), but the port's mesh exchange is
    queue A8b."""


# the recoverable failures the shuffle plane itself makes, which a map
# parent answers with ring re-form or map recompute; a scan's
# FileNotFoundError is not one of them (a rerun fails the same way)
TRANSPORT_ERRORS = (FetchFailedError, ConnectionError, TimeoutError,
                    InjectedFault)

SHUFFLE_MODE_HOST = "host"
SHUFFLE_MODE_ICI = "ici"


def select_shuffle_mode(conf, n_devices: Optional[int] = None) -> str:
    """The shuffle mode this session takes: ``host`` unless the conf
    asks for ``ici``, there are no map workers
    (``workers.count`` <= 1), no explicit mesh (``mesh.devices`` <= 1)
    and at least two devices (``torch.cuda.device_count()`` unless
    given).  Where all hold, the JAX package lowers onto its mesh; the
    port raises ``MeshNotPortedError``."""
    from spark_rapids_tpu_torch.conf import HOST_SHUFFLE_WORKERS, \
        MESH_DEVICES, SHUFFLE_MODE
    if str(conf.get(SHUFFLE_MODE)).strip().lower() != SHUFFLE_MODE_ICI:
        return SHUFFLE_MODE_HOST
    if conf.get(HOST_SHUFFLE_WORKERS) > 1:
        return SHUFFLE_MODE_HOST
    if conf.get(MESH_DEVICES) > 1:
        return SHUFFLE_MODE_HOST
    if n_devices is None:
        import torch
        n_devices = torch.cuda.device_count() \
            if torch.cuda.is_available() else 1
    if n_devices < 2:
        return SHUFFLE_MODE_HOST
    raise MeshNotPortedError(
        f"spark.rapids.shuffle.mode=ici on {n_devices} GPUs needs the mesh "
        "exchange, which the torch port has not yet (queue A8b: "
        "parallel/, exec/meshexec.py); set spark.rapids.shuffle.mode=host")


# -- process-wide stats (the registry's ``shuffle`` section) ------------------

_GLOBAL_LOCK = threading.Lock()
_GLOBAL_KEYS = ("exchanges", "workers_spawned", "blocks_written",
                "bytes_written", "raw_bytes_written", "map_recomputes",
                "partitions_recomputed", "transient_retries",
                "corrupt_refetches", "fetch_failures", "blacklist_events",
                "native_managers", "python_managers")
_GLOBAL: Dict[str, int] = {k: 0 for k in _GLOBAL_KEYS}


def bump_global(key: str, v: int = 1) -> None:
    with _GLOBAL_LOCK:
        _GLOBAL[key] += int(v)


def global_stats() -> dict:
    with _GLOBAL_LOCK:
        return dict(_GLOBAL)


def reset_global_stats() -> None:
    with _GLOBAL_LOCK:
        for k in _GLOBAL:
            _GLOBAL[k] = 0


class _PeerHealth:
    __slots__ = ("consecutive", "total", "blacklisted")

    def __init__(self):
        self.consecutive = 0
        self.total = 0
        self.blacklisted = False


class TorchShuffleManager:
    """One process's end of the shuffle: its block server, a client a
    peer, the retry and blacklist state and the in-flight window."""

    def __init__(self, port: int = 0, prefer_native: bool = True,
                 max_bytes_in_flight: int = 1 << 30,
                 max_metadata_size: int = 50 * 1024,
                 bounce_count: int = 8,
                 bounce_size: int = 4 * 1024 * 1024,
                 threads: int = 4,
                 fetch_retries: int = 3,
                 codec: str = "zstd",
                 connect_timeout: float = DEFAULT_CONNECT_TIMEOUT,
                 read_timeout: float = DEFAULT_READ_TIMEOUT,
                 backoff_base: float = 0.05,
                 backoff_cap: float = 2.0,
                 backoff_jitter: float = 0.2,
                 backoff_seed: Optional[int] = None,
                 checksum: str = "crc32c",
                 corrupt_refetches: int = 2,
                 peer_max_failures: int = 3):
        self.server = ShuffleServer(port, prefer_native=prefer_native,
                                    read_timeout=read_timeout)
        self.prefer_native = prefer_native
        self.max_bytes_in_flight = int(max_bytes_in_flight)
        self.max_metadata_size = int(max_metadata_size)
        self.threads = max(1, int(threads))
        self.fetch_retries = max(0, int(fetch_retries))
        self.connect_timeout = float(connect_timeout)
        self.read_timeout = float(read_timeout)
        self.corrupt_refetches = max(0, int(corrupt_refetches))
        self.peer_max_failures = max(1, int(peer_max_failures))
        self.checksum = checksum
        self._backoff = Backoff(backoff_base, backoff_cap, backoff_jitter,
                                seed=backoff_seed)
        if codec == "lz4":  # no lz4 module: the best available codec
            codec = "zstd"
        self.codec = codec if codec != "zstd" or codec_available() \
            else "none"
        self._bounce = BounceBufferPool(bounce_count, bounce_size)
        self._clients: Dict[int, Optional[ShuffleClient]] = {}
        self._client_locks: Dict[int, threading.Lock] = {}
        self._lock = threading.Lock()
        self._local_ids = itertools.count(0)
        self._self_index = 0
        self._ports: List[int] = [self.server.port]
        self._health: Dict[int, _PeerHealth] = {}
        self._stats_lock = threading.Lock()
        self.retry_count = 0
        self.corrupt_refetch_count = 0
        self.fetch_failed_count = 0
        self.blacklist_count = 0
        self.blocks_written = 0
        self.bytes_written = 0
        self.raw_bytes_written = 0
        self._inflight = 0
        self._inflight_cv = threading.Condition()
        self._stopped = False
        bump_global("native_managers" if self.server.native
                    else "python_managers")

    @property
    def native(self) -> bool:
        """The block server (and so every client) is the native one."""
        return self.server.native

    @property
    def checksum_in_effect(self) -> Optional[str]:
        return resolve_checksum(self.checksum)

    @classmethod
    def from_conf(cls, conf, port: int = 0, prefer_native: bool = True,
                  fetch_retries: Optional[int] = None
                  ) -> "TorchShuffleManager":
        """From a TorchConf's ``spark.rapids.shuffle.*`` keys; installs
        the conf's ``spark.rapids.faults.*`` spec for this process."""
        from spark_rapids_tpu_torch.conf import \
            MULTITHREADED_SHUFFLE_THREADS, SHUFFLE_BOUNCE_BUFFER_COUNT, \
            SHUFFLE_BOUNCE_BUFFER_SIZE, SHUFFLE_CHECKSUM, \
            SHUFFLE_COMPRESSION_CODEC, SHUFFLE_CONNECT_TIMEOUT, \
            SHUFFLE_CORRUPT_REFETCHES, SHUFFLE_FETCH_RETRIES, \
            SHUFFLE_MAX_INFLIGHT_BYTES, SHUFFLE_MAX_METADATA_SIZE, \
            SHUFFLE_PEER_MAX_FAILURES, SHUFFLE_READ_TIMEOUT, \
            SHUFFLE_RETRY_BACKOFF_BASE, SHUFFLE_RETRY_BACKOFF_CAP, \
            SHUFFLE_RETRY_BACKOFF_JITTER
        faults.configure_from_conf(conf)
        return cls(
            port=port, prefer_native=prefer_native,
            max_bytes_in_flight=conf.get(SHUFFLE_MAX_INFLIGHT_BYTES),
            max_metadata_size=conf.get(SHUFFLE_MAX_METADATA_SIZE),
            bounce_count=conf.get(SHUFFLE_BOUNCE_BUFFER_COUNT),
            bounce_size=conf.get(SHUFFLE_BOUNCE_BUFFER_SIZE),
            threads=conf.get(MULTITHREADED_SHUFFLE_THREADS),
            fetch_retries=(conf.get(SHUFFLE_FETCH_RETRIES)
                           if fetch_retries is None else fetch_retries),
            codec=conf.get(SHUFFLE_COMPRESSION_CODEC),
            connect_timeout=conf.get(SHUFFLE_CONNECT_TIMEOUT),
            read_timeout=conf.get(SHUFFLE_READ_TIMEOUT),
            backoff_base=conf.get(SHUFFLE_RETRY_BACKOFF_BASE),
            backoff_cap=conf.get(SHUFFLE_RETRY_BACKOFF_CAP),
            backoff_jitter=conf.get(SHUFFLE_RETRY_BACKOFF_JITTER),
            checksum=conf.get(SHUFFLE_CHECKSUM),
            corrupt_refetches=conf.get(SHUFFLE_CORRUPT_REFETCHES),
            peer_max_failures=conf.get(SHUFFLE_PEER_MAX_FAILURES))

    # -- topology -------------------------------------------------------------

    def _connect(self, port: int) -> ShuffleClient:
        return ShuffleClient(port, prefer_native=self.prefer_native,
                             bounce_pool=self._bounce,
                             connect_timeout=self.connect_timeout,
                             read_timeout=self.read_timeout)

    def register_peers(self, ports: Sequence[int]) -> None:
        """``ports[i]`` is peer i's server; this manager's own port must
        be among them (the shuffle ids stripe by its index).  A second
        call (a re-formed ring) closes the old clients and resets the
        peers' health."""
        if self.server.port not in ports:
            raise ValueError(
                f"own server port {self.server.port} missing from peer "
                "list; shuffle-id striping would collide")
        self._close_clients()
        self._ports = list(ports)
        self._self_index = self._ports.index(self.server.port)
        self._health = {i: _PeerHealth() for i in range(len(self._ports))}
        for i, p in enumerate(self._ports):
            self._client_locks[i] = threading.Lock()
            self._clients[i] = self._connect(p)

    def _close_clients(self) -> None:
        for i, c in list(self._clients.items()):
            if c is None:
                continue
            try:
                c.close()
            except OSError as e:
                log.debug("closing shuffle client %d: %s", i, e)
        self._clients.clear()
        self._client_locks.clear()

    @property
    def num_workers(self) -> int:
        return len(self._ports)

    def new_shuffle_id(self) -> int:
        """Unique without a coordinator: peer i allocates i + 1,
        i + 1 + n, ..."""
        return 1 + self._self_index + next(self._local_ids) * \
            self.num_workers

    # -- map side -------------------------------------------------------------

    def write_partition(self, shuffle: int, map_id: int, part: int,
                        block: HostBlock) -> int:
        """Push one map output block to the partition's owner -> the
        frame's bytes on the wire."""
        if block.header_bytes() > self.max_metadata_size:
            raise ValueError(
                "serialized block schema exceeds "
                "spark.rapids.shuffle.maxMetadataSize "
                f"({self.max_metadata_size} bytes); raise the conf or "
                "trim the schema")
        owner = part % self.num_workers
        payload = serialize_block(
            block, codec=None if self.codec == "none" else self.codec,
            checksum=self.checksum)
        self._with_retries(owner, shuffle, part,
                           lambda c: c.put(shuffle, map_id, part, payload),
                           op="put")
        with self._stats_lock:
            self.blocks_written += 1
            self.bytes_written += len(payload)
            self.raw_bytes_written += block.nbytes
        return len(payload)

    # -- reduce side ----------------------------------------------------------

    def _record_failure(self, owner: int) -> None:
        with self._stats_lock:
            h = self._health.setdefault(owner, _PeerHealth())
            h.consecutive += 1
            h.total += 1
            self.fetch_failed_count += 1
            if not h.blacklisted and \
                    h.consecutive >= self.peer_max_failures:
                h.blacklisted = True
                self.blacklist_count += 1
                log.warning("shuffle peer port %d blacklisted after %d "
                            "consecutive failures", self._ports[owner],
                            h.consecutive)

    def _record_success(self, owner: int) -> None:
        with self._stats_lock:
            self._health.setdefault(owner, _PeerHealth()).consecutive = 0

    def peer_blacklisted(self, owner: int) -> bool:
        h = self._health.get(owner)
        return bool(h and h.blacklisted)

    def _with_retries(self, owner: int, shuffle: int, part: int, fn,
                      op: str = "fetch", record_success: bool = True):
        """One peer operation, retried on a fresh connection after the
        backoff; ``FetchFailedError`` once the retries are spent, or at
        once for a blacklisted peer."""
        if self.peer_blacklisted(owner):
            raise FetchFailedError(
                self._ports[owner], shuffle, part,
                "peer is blacklisted "
                f"(>{self.peer_max_failures - 1} consecutive failures)")
        last = None
        for attempt in range(self.fetch_retries + 1):
            try:
                with self._client_locks[owner]:
                    client = self._clients[owner]
                    if client is None:  # torn down by a failed attempt
                        client = self._connect(self._ports[owner])
                        self._clients[owner] = client
                    result = fn(client)
                if record_success:
                    # only an op whose payload is validated clears the
                    # peer's failures; a fetch is credited after decode
                    self._record_success(owner)
                return result
            except (IOError, OSError, ConnectionError) as e:
                last = e
                log.warning("shuffle %s attempt %d/%d against peer port %d "
                            "(shuffle %d, part %d) failed: %s: %s", op,
                            attempt + 1, self.fetch_retries + 1,
                            self._ports[owner], shuffle, part,
                            type(e).__name__, e)
                if attempt >= self.fetch_retries:
                    break
                with self._stats_lock:
                    self.retry_count += 1
                self._backoff.sleep(attempt)
                # drop the dead connection now, reconnect lazily: a
                # closed client left in place could alias another
                # thread's new connection through a recycled fd
                with self._client_locks[owner]:
                    stale, self._clients[owner] = self._clients[owner], None
                if stale is not None:
                    try:
                        stale.close()
                    except OSError as e2:
                        log.debug("closing failed shuffle client %d: %s",
                                  owner, e2)
        self._record_failure(owner)
        raise FetchFailedError(self._ports[owner], shuffle, part, last)

    def read_partition(self, shuffle: int, part: int) -> List[HostBlock]:
        """Every map block of one reduce partition, in map order."""
        owner = part % self.num_workers
        last_corrupt = None
        for refetch in range(self.corrupt_refetches + 1):
            size = self._with_retries(owner, shuffle, part,
                                      lambda c: c.stat(shuffle, part),
                                      op="stat", record_success=False)
            self._reserve_inflight(size)
            try:
                blocks = self._with_retries(
                    owner, shuffle, part, lambda c: c.fetch(shuffle, part),
                    record_success=False)
            finally:
                self._release_inflight(size)
            try:
                out = deserialize_blocks(blocks)
                self._record_success(owner)
                return out
            except BlockCorruptError as e:
                # the stored copy is usually whole: refetch, counted
                # apart from the transient retries
                last_corrupt = e
                with self._stats_lock:
                    self.corrupt_refetch_count += 1
                log.warning("corrupt shuffle block from peer port %d "
                            "(shuffle %d, part %d), refetch %d/%d: %s",
                            self._ports[owner], shuffle, part, refetch + 1,
                            self.corrupt_refetches, e)
        self._record_failure(owner)
        raise FetchFailedError(self._ports[owner], shuffle, part,
                               last_corrupt)

    def partition_sizes(self, shuffle: int,
                        parts: Sequence[int]) -> List[int]:
        """Each partition's stored bytes at its owner (one stat each, no
        payload): advisory sizes, 0 for an owner that cannot answer."""
        out = []
        for p in parts:
            owner = p % self.num_workers
            try:
                out.append(int(self._with_retries(
                    owner, shuffle, p, lambda c, _p=p: c.stat(shuffle, _p),
                    op="stat", record_success=False)))
            except FetchFailedError:
                out.append(0)
        return out

    def read_partitions(self, shuffle: int, parts: Sequence[int]
                        ) -> Dict[int, List[HostBlock]]:
        """Several partitions fetched at once on ``threads`` threads,
        under the in-flight window."""
        with ThreadPoolExecutor(max_workers=self.threads,
                                thread_name_prefix="srt-fetch") as ex:
            futs = {p: ex.submit(self.read_partition, shuffle, p)
                    for p in parts}
            return {p: fut.result() for p, fut in futs.items()}

    def _reserve_inflight(self, size: int) -> None:
        size = min(size, self.max_bytes_in_flight)  # one fetch always fits
        with self._inflight_cv:
            while self._inflight + size > self.max_bytes_in_flight:
                # the fetches that hold the window release it within
                # their read timeout; the wait re-checks each second
                self._inflight_cv.wait(timeout=1.0)
            self._inflight += size

    def _release_inflight(self, size: int) -> None:
        size = min(size, self.max_bytes_in_flight)
        with self._inflight_cv:
            self._inflight -= size
            self._inflight_cv.notify_all()

    # -- stats ----------------------------------------------------------------

    def stats(self) -> Dict[str, object]:
        with self._stats_lock:
            return {
                "transient_retries": self.retry_count,
                "corrupt_refetches": self.corrupt_refetch_count,
                "fetch_failures": self.fetch_failed_count,
                "blacklist_events": self.blacklist_count,
                "blacklisted_peers": [
                    self._ports[i] for i, h in self._health.items()
                    if h.blacklisted and i < len(self._ports)],
                "blocks_written": self.blocks_written,
                "bytes_written": self.bytes_written,
                "raw_bytes_written": self.raw_bytes_written,
            }

    def drop_local(self, shuffle: int) -> None:
        """Drop a shuffle's blocks from this process's own server."""
        i = self._self_index
        with self._client_locks[i]:
            c = self._clients[i]
            if c is None:
                c = self._connect(self._ports[i])
                self._clients[i] = c
            c.drop(shuffle)

    def stop(self) -> None:
        with self._lock:
            if self._stopped:
                return
            self._stopped = True
            for i in list(self._clients):
                with self._client_locks[i]:
                    c = self._clients[i]
                    if c is not None:
                        c.close()
            self._clients.clear()
        self.server.stop()
        st = self.stats()
        for k in ("transient_retries", "corrupt_refetches", "fetch_failures",
                  "blacklist_events", "blocks_written", "bytes_written",
                  "raw_bytes_written"):
            bump_global(k, st[k])
