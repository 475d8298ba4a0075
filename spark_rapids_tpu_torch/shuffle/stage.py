"""The engine's host shuffle: an exchange whose map side runs in worker
processes on the host and whose reduce side runs on the session's
device.

Counterpart of ``spark_rapids_tpu/shuffle/stage.py``.  The planner puts
a ``TorchHostShuffleExchangeExec`` under an aggregate or a join when
``spark.rapids.shuffle.workers.count`` > 1 and the fragment below is
map-splittable (``plan/planner.py: host_shuffle_lower``).  At execution:

* the map side: N ``spawn``ed worker processes each run the pickled
  fragment over their stripe of the scan's files (``_restrict_to_split``)
  on the port's own operators over host tensors, under an
  ``ExecContext`` on ``torch.device("cpu")``, as the JAX package's
  workers pin themselves to its CPU backend.  Each batch is partitioned
  by the join hash (``exec/exchange.py: partition_batch_to_host``, the
  in-process exchange's ids bit for bit, gathered and cut on the host
  with no pull) and its blocks go through the worker's
  ``TorchShuffleManager`` to their owners.  A worker never touches the
  card: the fragment is pickled with every
  CUDA tensor moved to the host (``_dumps``), each worker runs with
  ``worker_threads(N)`` intra-op threads (the cores over N, at most
  the parent's own count), and it reports
  ``torch.cuda.is_initialized()`` and the card's device files it has
  mapped (``card_files``) at its end; the exchange raises if one made a
  CUDA context (``holds_card``).
* the reduce side, in the parent: every partition is fetched from its
  owner through the manager's threaded, in-flight-bounded fetch, in
  windows of ``multiThreaded.threads`` partitions; each block (or, with
  adaptive execution on, each group of blocks the map-output statistics
  make, ``_reduce_upload_groups``) is uploaded under the catalog's
  host-staging budget and streams on as an ordinary device batch.
* failures: a worker that dies or fails its transport, or a fetch that
  fails for good, reroutes to the map work re-run in the parent
  (``spark.rapids.shuffle.recompute.enabled``): the whole map stage, or
  just the lost partitions' rows (``_recompute_partitions``).

The exchange's metrics: ``shuffleRowsWritten``,
``shufflePartitionBytes`` (the workers' per-partition bytes, into the
adaptive statistics), ``shuffleMapTime``, ``shuffleFetchTime``,
``uploadTime``, ``shuffleBlocksFetched``, ``shuffleWireBytes``,
``shuffleRawBytes``, ``shuffleMapRecomputes`` and
``shufflePartitionsRecomputed``; ``last_run`` keeps the last run's
worker reports (pids, threads, CUDA state, transport, codec, checksum).
"""

from __future__ import annotations

import copy
import io
import logging
import multiprocessing as mp
import os
import pickle
import time
from typing import Iterator, List, Optional

import torch

from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.dtypes import Schema
from spark_rapids_tpu_torch.exec.base import ExecContext, TorchExec
from spark_rapids_tpu_torch.exprs.base import Expression
from spark_rapids_tpu_torch.utils.metrics import \
    METRIC_COALESCED_PARTITIONS, METRIC_SHUFFLE_BLOCKS_FETCHED, \
    METRIC_SHUFFLE_FETCH_TIME, METRIC_SHUFFLE_MAP_RECOMPUTES, \
    METRIC_SHUFFLE_MAP_TIME, METRIC_SHUFFLE_PARTITION_BYTES, \
    METRIC_SHUFFLE_PARTITIONS_RECOMPUTED, METRIC_SHUFFLE_RAW_BYTES, \
    METRIC_SHUFFLE_ROWS_WRITTEN, METRIC_SHUFFLE_WIRE_BYTES, \
    METRIC_SKEW_SPLITS, METRIC_UPLOAD_TIME
from spark_rapids_tpu_torch.utils.queues import bounded_q_get

_SHUFFLE_ID = 11  # one shuffle an exchange run; ids are scoped to a run
_START_TIMEOUT_S = 120.0

log = logging.getLogger("spark_rapids_tpu_torch.shuffle")


class _MapStageFailed(RuntimeError):
    """A map worker died, never started, or lost a peer: the recoverable
    map-stage failure, which reruns the map work in the parent."""


class WorkerTouchedCardError(RuntimeError):
    """A map worker reported a CUDA context: it must run on the host."""


# -- the fragment --------------------------------------------------------------

def _host_tensor(t: torch.Tensor) -> torch.Tensor:
    return t


class _HostPickler(pickle.Pickler):
    """Pickles a tensor that lies on a card as its host copy: unpickling
    a CUDA tensor would make a CUDA context in the worker."""

    def reducer_override(self, obj):
        if isinstance(obj, torch.Tensor) and obj.device.type != "cpu":
            return _host_tensor, (obj.detach().cpu(),)
        return NotImplemented


def _dumps(obj) -> bytes:
    buf = io.BytesIO()
    _HostPickler(buf, protocol=pickle.HIGHEST_PROTOCOL).dump(obj)
    return buf.getvalue()


def _scan_nodes(plan) -> List:
    """Every file scan (a node with a ``paths`` list) of a fragment."""
    out = []

    def walk(n):
        if isinstance(getattr(n, "paths", None), list):
            out.append(n)
        for c in n.children:
            walk(c)
    walk(plan)
    return out


def _splittable_types():
    from spark_rapids_tpu_torch.exec.basic import TorchFilterExec, \
        TorchProjectExec
    from spark_rapids_tpu_torch.exec.coalesce import TorchCoalesceBatchesExec
    from spark_rapids_tpu_torch.exec.stage import TorchStageExec
    return (TorchFilterExec, TorchProjectExec, TorchCoalesceBatchesExec,
            TorchStageExec)


def splittable(plan) -> bool:
    """A fragment splits across map workers when it is a linear chain of
    per-row operators (filter, project, fused stage, coalesce) over ONE
    scan of more than one file: striping files through a join or an
    aggregate would change what it computes."""
    node = plan
    safe = _splittable_types()
    while True:
        if isinstance(getattr(node, "paths", None), list):
            return len(node.paths) > 1 and not node.children
        if not isinstance(node, safe) or len(node.children) != 1:
            return False
        node = node.children[0]


def _restrict_to_split(plan, idx: int, n: int):
    """A deep copy of the fragment with every scan restricted to its
    ``idx``-th stripe of files (round robin); the hive partition values
    are discovered again over the stripe."""
    from spark_rapids_tpu_torch.io import hivepart
    plan = copy.deepcopy(plan)
    for s in _scan_nodes(plan):
        stripe = s.paths[idx::n]
        s.paths = stripe
        if getattr(s, "part_schema", None):
            s.part_schema, s.part_values = hivepart.discover(
                getattr(s, "roots", stripe), stripe)
    return plan


def card_files() -> List[str]:
    """The card's device files this process has mapped
    (``/proc/self/maps``).  A CUDA context maps ``/dev/nvidia-uvm``;
    ``torch.cuda.is_initialized()`` misses a context made from C++ (a
    pinned allocation) or by another library, this does not."""
    try:
        with open("/proc/self/maps") as f:
            return sorted({ln.split()[-1] for ln in f
                           if "/dev/nvidia" in ln})
    except OSError:
        return []


def holds_card(info: dict) -> bool:
    """Whether a map worker's report says it made a CUDA context."""
    return bool(info.get("cuda_initialized")) \
        or "/dev/nvidia-uvm" in info.get("card_files", ())


def worker_threads(n_workers: int) -> int:
    """Intra-op threads a map worker runs with: the machine's cores
    shared among the workers, so N workers do not oversubscribe, and no
    more than the session's process runs with itself."""
    return max(1, min(torch.get_num_threads(),
                      (os.cpu_count() or 1) // max(1, n_workers)))


# -- the map worker ------------------------------------------------------------

def _worker_main(idx: int, n_workers: int, plan_blob: bytes,
                 keys_blob: bytes, num_parts: int, conf_dict: dict,
                 threads: int, port_q, ports_q, done_q) -> None:
    from spark_rapids_tpu_torch import faults, lifecycle
    from spark_rapids_tpu_torch.conf import SHUFFLE_STAGE_TIMEOUT, TorchConf
    from spark_rapids_tpu_torch.exec.exchange import partition_batch_to_host
    from spark_rapids_tpu_torch.obs import journal
    from spark_rapids_tpu_torch.shuffle.manager import TRANSPORT_ERRORS, \
        TorchShuffleManager

    torch.set_num_threads(threads)
    faults.set_worker_index(idx)
    # the worker's operators run on the host: its conf says so too
    conf = TorchConf({**conf_dict, "spark.rapids.torch.device": "cpu"})
    journal.configure_from_conf(conf)
    t_start = time.perf_counter()
    mgr = TorchShuffleManager.from_conf(conf, port=0)
    port_q.put((idx, mgr.server.port))
    try:
        # bounded: a parent that died before sending the list must not
        # park this process forever
        ports = bounded_q_get(ports_q, _START_TIMEOUT_S,
                              "peer port list from the parent")
        mgr.register_peers(ports)
        plan = pickle.loads(plan_blob)
        keys = pickle.loads(keys_blob)
        frag = _restrict_to_split(plan, idx, n_workers)
        wrote = [0] * num_parts
        wrote_bytes = [0] * num_parts
        mode = "hash" if keys else "roundrobin"

        with lifecycle.query_scope(conf):
            ctx = ExecContext(conf, torch.device("cpu"))
            batches = frag.execute(ctx)
            # the round-robin start carries on from batch to batch
            rr = 0
            try:
                for bno, batch in enumerate(batches):
                    if faults.should_fire("worker.kill"):
                        import signal
                        os.kill(os.getpid(), signal.SIGKILL)
                    blocks = partition_batch_to_host(
                        batch, num_parts, keys or None, mode, rr)
                    rr += batch.num_rows
                    # map ids stripe by worker and batch: the store keys
                    # a block by (shuffle, map, part)
                    map_id = idx + n_workers * bno
                    for p, block in enumerate(blocks):
                        if block is not None:
                            mgr.write_partition(_SHUFFLE_ID, map_id, p,
                                                block)
                            wrote[p] += block.num_rows
                            wrote_bytes[p] += block.nbytes
            finally:
                batches.close()
        info = {"pid": os.getpid(), "threads": torch.get_num_threads(),
                "cuda_initialized": bool(torch.cuda.is_initialized()),
                "card_files": card_files(), "native": mgr.native, "codec": mgr.codec,
                "checksum": mgr.checksum_in_effect,
                "map_s": time.perf_counter() - t_start,
                "stats": mgr.stats()}
        done_q.put((idx, sum(wrote), wrote_bytes, None, info))
        # hold the server open until the parent has reduced; bounded so
        # an orphaned worker ends on its own
        try:
            bounded_q_get(ports_q, conf.get(SHUFFLE_STAGE_TIMEOUT),
                          "reduce-complete release from the parent")
        except TimeoutError as te:
            log.warning("map worker %d: %s; shutting the block server "
                        "down anyway", idx, te)
    except Exception as e:  # surface the failure to the parent
        # a peer that died under our writes is the recoverable kind
        kind = "transport" if isinstance(e, TRANSPORT_ERRORS) else "error"
        done_q.put((idx, -1, None, f"{kind}:{type(e).__name__}: {e}",
                    {"pid": os.getpid(),
                     "cuda_initialized": bool(torch.cuda.is_initialized()),
                     "card_files": card_files()}))
    finally:
        mgr.stop()


# -- the reduce side -----------------------------------------------------------

def _concat_blocks(blocks: List) -> List:
    """Same-schema blocks as one block (one upload)."""
    from spark_rapids_tpu_torch.columnar.batch import concat_host_values
    from spark_rapids_tpu_torch.shuffle.serializer import HostBlock
    if len(blocks) <= 1:
        return list(blocks)
    import numpy as np
    schema = blocks[0].schema
    return [HostBlock(schema, {
        f.name: (concat_host_values([b.cols[f.name][0] for b in blocks]),
                 np.concatenate([b.cols[f.name][1] for b in blocks]))
        for f in schema}, sum(b.num_rows for b in blocks))]


def _reduce_upload_groups(fetched, parts, conf,
                          all_part_bytes: Optional[List[int]]):
    """One fetch window's blocks grouped into uploads by the map-output
    statistics, with the in-process stage's greedy policy
    (``plan/adaptive.py: greedy_partition_groups``) at block grain:
    adjacent small partitions share an upload, a skewed partition's
    blocks split into groups of about the target bytes.  The skew median
    is the whole exchange's reported sizes when given.  -> (groups of
    blocks, partitions merged away, skew splits)."""
    from spark_rapids_tpu_torch.plan.adaptive import greedy_partition_groups
    blocks = {p: [b for b in fetched.get(p, []) if b.num_rows]
              for p in parts}
    part_list = [(p, sum(b.nbytes for b in blocks[p]),
                  [b.nbytes for b in blocks[p]])
                 for p in parts if blocks[p]]
    groups, ncoal, nsplit = greedy_partition_groups(
        part_list, conf, allow_skew=True, stat_sizes=all_part_bytes)
    return [[b for p, lo, hi in g for b in blocks[p][lo:hi]]
            for g in groups], ncoal, nsplit


class TorchHostShuffleExchangeExec(TorchExec):
    """Partitions its child's rows across worker processes through the
    shuffle transport and streams the fetched partitions back as device
    batches (the JAX ``TpuHostShuffleExchangeExec``)."""

    def __init__(self, keys: List[Expression], child: TorchExec,
                 workers: int, num_partitions: Optional[int] = None):
        super().__init__()
        self.keys = list(keys)
        self.children = [child]
        self.workers = max(2, int(workers))
        # the planner's spark.rapids.shuffle.defaultNumPartitions, else
        # workers x 2
        self.num_partitions = int(num_partitions or self.workers * 2)
        self.last_partition_bytes: Optional[List[int]] = None
        self.last_run: dict = {}

    @property
    def output_schema(self) -> Schema:
        return self.children[0].output_schema

    def describe(self) -> str:
        k = ", ".join(e.name for e in self.keys)
        return (f"TorchHostShuffleExchange [workers={self.workers}, "
                f"parts={self.num_partitions}"
                + (f", keys={k}" if k else "") + "]")

    def execute(self, ctx: ExecContext) -> Iterator[ColumnarBatch]:
        from spark_rapids_tpu_torch import lifecycle
        from spark_rapids_tpu_torch.conf import SHUFFLE_RECOMPUTE_ENABLED
        from spark_rapids_tpu_torch.errors import QueryCancelledError
        from spark_rapids_tpu_torch.shuffle.manager import \
            TorchShuffleManager, bump_global

        n = self.workers
        recompute = ctx.conf.get(SHUFFLE_RECOMPUTE_ENABLED)
        plan_blob = _dumps(self.children[0])
        keys_blob = _dumps(self.keys)
        # workers run the map side only: never another host shuffle
        conf_dict = {**ctx.conf.to_dict(),
                     "spark.rapids.shuffle.workers.count": 0}
        threads = worker_threads(n)
        mgr = TorchShuffleManager.from_conf(ctx.conf, port=0)
        mp_ctx = mp.get_context("spawn")
        port_q = mp_ctx.Queue()
        ports_qs = [mp_ctx.Queue() for _ in range(n)]
        done_q = mp_ctx.Queue()
        procs: List = []

        def reclaim():
            # the query's closer: a cancelled query, or a stream dropped
            # mid-way, still ends the workers and the manager
            for q in ports_qs:
                try:
                    q.put(None)
                except (OSError, ValueError) as e:
                    log.debug("worker release message failed: %s", e)
            for p in procs:
                if p.is_alive():
                    p.terminate()
                p.join(timeout=5)
                if p.is_alive():
                    p.kill()
                    p.join(timeout=5)
            mgr.stop()

        reg = lifecycle.register_resource(reclaim, kind="workers",
                                          name="host-shuffle-map")
        if reg.rejected:
            raise QueryCancelledError(
                "host shuffle exchange construction raced query teardown")
        bump_global("exchanges")
        self.last_run = {"workers": {}, "worker_threads": threads,
                         "native": mgr.native, "codec": mgr.codec,
                         "checksum": mgr.checksum_in_effect,
                         "parent_pid": os.getpid()}
        try:
            map_failed = None
            try:
                with self.metrics.timed(METRIC_SHUFFLE_MAP_TIME):
                    self._map_stage(ctx, mgr, mp_ctx, procs, port_q,
                                    ports_qs, done_q, plan_blob, keys_blob,
                                    conf_dict, threads)
            except _MapStageFailed as e:
                if not recompute:
                    raise RuntimeError(str(e)) from None
                map_failed = e
            if map_failed is not None:
                # the map stage is incomplete and maybe partly visible:
                # the child's rows, run again here, are the exchange's
                # output whole
                log.warning("%s; recomputing the map stage in-process "
                            "(spark.rapids.shuffle.recompute.enabled)",
                            map_failed)
                self.metrics[METRIC_SHUFFLE_MAP_RECOMPUTES] += 1
                bump_global("map_recomputes")
                yield from self.children[0].execute(ctx)
                return
            yield from self._reduce(ctx, mgr, recompute)
        finally:
            reg.release()
            if lifecycle.cancel_requested():
                reclaim()
            else:
                for q in ports_qs:
                    try:
                        q.put(None)  # release the workers' servers
                    except (OSError, ValueError) as e:
                        log.debug("worker release message failed: %s", e)
                for p in procs:
                    p.join(timeout=30)
                    if p.is_alive():
                        p.terminate()
                        p.join(timeout=5)
                mgr.stop()

    def _map_stage(self, ctx, mgr, mp_ctx, procs, port_q, ports_qs, done_q,
                   plan_blob, keys_blob, conf_dict, threads) -> None:
        import queue as _queue
        from spark_rapids_tpu_torch import lifecycle
        from spark_rapids_tpu_torch.conf import SHUFFLE_STAGE_TIMEOUT
        from spark_rapids_tpu_torch.exec.aqe import record_exchange_stats
        from spark_rapids_tpu_torch.shuffle.manager import TRANSPORT_ERRORS, \
            bump_global
        n = self.workers
        for i in range(n):
            p = mp_ctx.Process(
                target=_worker_main, name=f"srt-shuffle-map-{i}",
                args=(i, n, plan_blob, keys_blob, self.num_partitions,
                      conf_dict, threads, port_q, ports_qs[i], done_q))
            p.start()
            lifecycle.track_process(p)
            procs.append(p)
        bump_global("workers_spawned", n)
        map_timeout = ctx.conf.get(SHUFFLE_STAGE_TIMEOUT)
        deadline = time.monotonic() + map_timeout
        start_deadline = time.monotonic() + _START_TIMEOUT_S

        def dead_pids():
            return [p.pid for p in procs
                    if not p.is_alive() and p.exitcode]

        ports = {}
        while len(ports) < n:
            lifecycle.check_cancel()
            try:
                i, port = port_q.get(timeout=0.5)
                ports[i] = port
                continue
            except _queue.Empty:
                pass
            if dead_pids():
                raise _MapStageFailed(
                    "host shuffle map worker process(es) died during "
                    f"startup (pids {dead_pids()})")
            if time.monotonic() > start_deadline:
                raise RuntimeError(
                    f"host shuffle worker startup timed out "
                    f"({_START_TIMEOUT_S:.0f}s): {n - len(ports)} of {n} "
                    "workers never reported a transport port")
        # the parent is peer 0, so a fetch of its own partitions stays
        # local; the workers follow
        port_list = [mgr.server.port] + [ports[i] for i in range(n)]
        try:
            mgr.register_peers(port_list)
        except TRANSPORT_ERRORS as e:
            # a worker that died between its port report and our connect
            raise _MapStageFailed("cannot connect to host shuffle "
                                  f"worker(s) ({type(e).__name__}: {e})"
                                  ) from e
        for q in ports_qs:
            q.put(port_list)
        rows_written = 0
        part_bytes = [0] * self.num_partitions
        done = 0
        while done < n:
            lifecycle.check_cancel()
            try:
                i, wrote, wbytes, err, info = done_q.get(timeout=1)
            except _queue.Empty:
                # a hard-killed worker fails fast, not at the timeout
                if dead_pids():
                    raise _MapStageFailed(
                        f"host shuffle map worker process(es) died (pids "
                        f"{dead_pids()}) before reporting results")
                if time.monotonic() > deadline:
                    raise RuntimeError(
                        f"host shuffle map stage timed out after "
                        f"{map_timeout}s waiting for {n - done} of {n} "
                        "workers (spark.rapids.shuffle.stage.timeout)"
                    ) from None
                continue
            self.last_run["workers"][i] = info
            if holds_card(info):
                raise WorkerTouchedCardError(
                    f"host shuffle map worker {i} (pid {info.get('pid')}) "
                    "made a CUDA context (torch.cuda.is_initialized() "
                    f"{info.get('cuda_initialized')}, mapped "
                    f"{info.get('card_files')}): map workers run on the "
                    "host")
            if err is not None:
                if err.startswith("transport:"):
                    # a survivor's writes failed because a peer died
                    raise _MapStageFailed(
                        f"host shuffle map worker {i} hit a transport "
                        f"failure ({err[len('transport:'):]})")
                raise RuntimeError(
                    f"host shuffle map worker {i} failed: {err}")
            rows_written += wrote
            for p, b in enumerate(wbytes):
                part_bytes[p] += b
            # the workers' writes into this process's registry
            for k in ("blocks_written", "bytes_written",
                      "raw_bytes_written", "transient_retries"):
                bump_global(k, info["stats"].get(k, 0))
            done += 1
        self.metrics[METRIC_SHUFFLE_ROWS_WRITTEN] += rows_written
        self.last_partition_bytes = part_bytes
        self.metrics[METRIC_SHUFFLE_PARTITION_BYTES] += sum(part_bytes)
        record_exchange_stats(part_bytes)

    def _reduce(self, ctx: ExecContext, mgr, recompute: bool
                ) -> Iterator[ColumnarBatch]:
        from spark_rapids_tpu_torch.columnar.batch import \
            host_batch_to_device
        from spark_rapids_tpu_torch.conf import ADAPTIVE_ENABLED, \
            MAX_STRING_WIDTH
        from spark_rapids_tpu_torch.exec.aqe import bump_global as aqe_bump
        from spark_rapids_tpu_torch.shuffle.manager import FetchFailedError, \
            bump_global
        adaptive = ctx.conf.get(ADAPTIVE_ENABLED)
        max_w = ctx.conf.get(MAX_STRING_WIDTH)
        chunk = max(1, mgr.threads)
        if adaptive and self.last_partition_bytes is None:
            self.last_partition_bytes = mgr.partition_sizes(
                _SHUFFLE_ID, list(range(self.num_partitions)))
        lost: List[int] = []
        yielded_any = False
        for start in range(0, self.num_partitions, chunk):
            parts = list(range(start, min(start + chunk,
                                          self.num_partitions)))
            try:
                with self.metrics.timed(METRIC_SHUFFLE_FETCH_TIME):
                    fetched = mgr.read_partitions(_SHUFFLE_ID, parts)
            except FetchFailedError as e:
                # a peer died or was blacklisted after its maps: this
                # window's partitions are recomputed whole, never mixed
                if not recompute:
                    raise
                log.warning("reduce fetch failed (%s); partitions %s will "
                            "be recomputed from the map input", e, parts)
                lost.extend(parts)
                continue
            for p in parts:
                blocks = fetched.get(p, [])
                self.metrics[METRIC_SHUFFLE_BLOCKS_FETCHED] += len(blocks)
                self.metrics[METRIC_SHUFFLE_RAW_BYTES] += \
                    sum(b.nbytes for b in blocks)
            if adaptive:
                # batch boundaries move; the row sequence is the same
                groups, ncoal, nsplit = _reduce_upload_groups(
                    fetched, parts, ctx.conf, self.last_partition_bytes)
                if ncoal or nsplit:
                    self.metrics[METRIC_COALESCED_PARTITIONS] += ncoal
                    self.metrics[METRIC_SKEW_SPLITS] += nsplit
                    aqe_bump("coalesced_partitions", ncoal)
                    aqe_bump("skew_splits", nsplit)
                uploads = [b for g in groups for b in _concat_blocks(g)]
            else:
                uploads = [b for p in parts for b in fetched.get(p, [])
                           if b.num_rows]
            for block in uploads:
                # the staging budget covers the upload, never the yield
                with ctx.runtime.catalog.staging.limit(block.nbytes), \
                        self.metrics.timed(METRIC_UPLOAD_TIME):
                    b = host_batch_to_device(self.output_schema, block.cols,
                                             ctx.device, max_w)
                yielded_any = True
                yield b
        self.metrics[METRIC_SHUFFLE_WIRE_BYTES] += sum(
            int(w.get("stats", {}).get("bytes_written", 0))
            for w in self.last_run["workers"].values())
        if lost:
            self.metrics[METRIC_SHUFFLE_PARTITIONS_RECOMPUTED] += len(lost)
            bump_global("partitions_recomputed", len(lost))
            yield from self._recompute_partitions(ctx, lost, yielded_any)

    def _recompute_partitions(self, ctx: ExecContext, lost_parts: List[int],
                              yielded_any: bool
                              ) -> Iterator[ColumnarBatch]:
        """The lost partitions' rows, from the child run again here.
        Sound for hash partitioning (a row's partition does not depend
        on which process mapped it); round robin can only rerun whole,
        and only while nothing was yielded yet."""
        from spark_rapids_tpu_torch.exec.exchange import partition_batch
        from spark_rapids_tpu_torch.utils.retry import split_batch_half, \
            with_retry
        child = self.children[0]
        if not self.keys:
            if yielded_any:
                raise RuntimeError(
                    "cannot recompute round-robin-partitioned shuffle "
                    "output after partial results were consumed; rerun "
                    "the query")
            yield from child.execute(ctx)
            return
        lost = set(lost_parts)
        for batch in child.execute(ctx):
            for pieces in with_retry(
                    lambda b: partition_batch(b, self.num_partitions,
                                              self.keys, "hash"),
                    batch, ctx, split=split_batch_half):
                for p in sorted(lost):
                    piece = pieces[p]
                    if piece is not None and piece.num_rows:
                        yield piece
