"""A group-by across worker processes that survives a worker's death.

Counterpart of ``spark_rapids_tpu/shuffle/worker.py``: N spawned
processes, each with its own ``TorchShuffleManager``, run a map ->
shuffle -> reduce sum and count of one column by one int64 key over a
parquet file's row groups.  It proves the transport stack under real
process isolation; each process computes on the host (numpy), and it
reads parquet, so it runs where pyarrow is (tier-1), as the port's
parquet reader does.

The failure model is the JAX package's (Spark's map-stage recompute):
workers are command loops the parent drives through queues, with no
barrier a SIGKILLed worker could deadlock.  Each worker heartbeats; the
parent's ``_Watchdog`` reads heartbeat recency and ``exitcode`` and, when
a worker dies or falls silent (terminated first), re-forms the ring from
the survivors and runs the map round again with the dead worker's row
groups reassigned (a fresh shuffle id a round hides stale blocks).  A
reduce fetch that fails for good (``FetchFailedError``) recomputes just
its partitions from the source file.  Every wait is bounded: queue gets
by ``bounded_q_get`` or a timeout, joins by a timeout and a terminate.
"""

from __future__ import annotations

import logging
import multiprocessing as mp
import os
import queue as _queue
import signal
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

log = logging.getLogger("spark_rapids_tpu_torch.shuffle")


def _hash_pids(keys: np.ndarray, n_parts: int) -> np.ndarray:
    """The JAX package's partitioner over int64 keys, fixed across
    rounds (a partition does not depend on how many workers live)."""
    return ((keys * np.int64(2654435761)) & np.int64((1 << 31) - 1)) \
        % np.int64(n_parts)


def _block(table):
    from spark_rapids_tpu_torch.columnar.batch import host_columns_from_arrow
    from spark_rapids_tpu_torch.shuffle.serializer import HostBlock
    schema, cols = host_columns_from_arrow(table)
    return HostBlock(schema, cols, table.num_rows)


def _keys(table, group_col: str) -> np.ndarray:
    return table.column(group_col).to_numpy(
        zero_copy_only=False).astype(np.int64)


def _recompute_partitions(parquet_path: str, group_col: str, agg_col: str,
                          parts: List[int], n_parts: int) -> Dict[int, list]:
    """The lost partitions' rows from the source file: one read and one
    hash pass for all of them."""
    import pyarrow as pa
    import pyarrow.parquet as pq
    table = pq.read_table(parquet_path, columns=[group_col, agg_col])
    pids = _hash_pids(_keys(table, group_col), n_parts)
    return {p: [_block(table.filter(pa.array(pids == p)))] for p in parts}


def _group_rows(blocks: list, group_col: str, agg_col: str) -> List[dict]:
    """Sum and count of the valid ``agg_col`` values by ``group_col``
    (null keys group together), as pyarrow's group_by gives them."""
    keys = np.concatenate([b.cols[group_col][0] for b in blocks])
    kval = np.concatenate([b.cols[group_col][1] for b in blocks])
    vals = np.concatenate([b.cols[agg_col][0] for b in blocks]) \
        .astype(np.float64)
    vval = np.concatenate([b.cols[agg_col][1] for b in blocks])
    rows = []
    for has_key in (True, False):
        sel = kval == has_key
        if not sel.any():
            continue
        uniq, inv = np.unique(keys[sel], return_inverse=True)
        ok = vval[sel]
        sums = np.bincount(inv, weights=np.where(ok, vals[sel], 0.0),
                           minlength=len(uniq))
        counts = np.bincount(inv, weights=ok, minlength=len(uniq))
        for k, sm, c in zip(uniq.tolist(), sums.tolist(), counts.tolist()):
            rows.append({group_col: k if has_key else None,
                         f"{agg_col}_sum": sm if c else None,
                         f"{agg_col}_count": int(c)})
    return rows


def _worker_main(idx: int, parquet_path: str, group_col: str, agg_col: str,
                 port_q, task_q, status_q, conf_dict) -> None:
    import pyarrow as pa
    import pyarrow.parquet as pq

    from spark_rapids_tpu_torch import faults, lifecycle
    from spark_rapids_tpu_torch.conf import SHUFFLE_RECOMPUTE_ENABLED, \
        WORKER_HEARTBEAT_INTERVAL, TorchConf
    from spark_rapids_tpu_torch.shuffle.manager import TRANSPORT_ERRORS, \
        FetchFailedError, TorchShuffleManager
    from spark_rapids_tpu_torch.utils.queues import bounded_q_get

    faults.set_worker_index(idx)
    conf = TorchConf(dict(conf_dict or {}))
    mgr = TorchShuffleManager.from_conf(conf, port=0)
    recompute_enabled = conf.get(SHUFFLE_RECOMPUTE_ENABLED)
    prev_shuffle_id: Optional[int] = None
    stop_hb = threading.Event()

    def beat():
        interval = conf.get(WORKER_HEARTBEAT_INTERVAL)
        while not stop_hb.wait(interval):
            if faults.should_fire("worker.heartbeat"):
                return  # injected silence: a hung worker
            status_q.put(("hb", idx, None))

    hb = threading.Thread(target=beat, name="srt-worker-beat", daemon=True)
    lifecycle.register_thread(hb, stop=stop_hb.set)
    hb.start()
    port_q.put((idx, mgr.server.port))
    recomputes = 0
    try:
        while True:
            try:
                # an orphaned worker (its parent SIGKILLed) ends on its own
                cmd = bounded_q_get(task_q, 3600.0, "parent command")
            except TimeoutError:
                break
            if cmd is None or cmd[0] == "exit":
                break
            kind, rnd = cmd[0], cmd[1]
            if kind == "map":
                _, _, shuffle_id, ports, groups, n_parts = cmd
                try:
                    mgr.register_peers(ports)
                    if prev_shuffle_id not in (None, shuffle_id):
                        # the prior round was aborted: free its blocks
                        try:
                            mgr.drop_local(prev_shuffle_id)
                        except OSError as e:
                            log.warning("dropping aborted round's blocks "
                                        "(shuffle %d) failed: %s",
                                        prev_shuffle_id, e)
                    prev_shuffle_id = shuffle_id
                    f = pq.ParquetFile(parquet_path)
                    for g in groups:
                        if faults.should_fire("worker.kill"):
                            os.kill(os.getpid(), signal.SIGKILL)
                        if faults.should_fire("worker.hang"):
                            # silence the heartbeats and park until the
                            # watchdog terminates this process
                            stop_hb.set()
                            time.sleep(3600)
                        tbl = f.read_row_groups([g],
                                                columns=[group_col, agg_col])
                        pids = _hash_pids(_keys(tbl, group_col), n_parts)
                        for p in range(n_parts):
                            part = tbl.filter(pa.array(pids == p))
                            if part.num_rows:
                                # map id = row group: unique in a round
                                # whichever worker maps it
                                mgr.write_partition(shuffle_id, g, p,
                                                    _block(part))
                    status_q.put(("map_done", idx, rnd))
                except TRANSPORT_ERRORS as e:
                    # a peer died under our writes: soft-fail the round
                    status_q.put(("map_failed", idx,
                                  (rnd, f"{type(e).__name__}: {e}")))
            elif kind == "reduce":
                _, _, shuffle_id, parts, n_parts = cmd
                fetched: Dict[int, list] = {}
                lost: List[int] = []
                for p in parts:
                    try:
                        fetched[p] = mgr.read_partition(shuffle_id, p)
                    except FetchFailedError:
                        if not recompute_enabled:
                            raise
                        lost.append(p)
                if lost:
                    fetched.update(_recompute_partitions(
                        parquet_path, group_col, agg_col, lost, n_parts))
                    recomputes += len(lost)
                out_rows: List[dict] = []
                for p in parts:
                    if fetched.get(p):
                        out_rows.extend(_group_rows(fetched[p], group_col,
                                                    agg_col))
                stats = mgr.stats()
                stats["recomputed_partitions"] = recomputes
                status_q.put(("result", idx, (rnd, out_rows, stats)))
    except Exception as e:  # unrecoverable: surface it to the parent
        status_q.put(("error", idx, f"{type(e).__name__}: {e}"))
    finally:
        stop_hb.set()
        mgr.stop()


class _Watchdog:
    """The parent's view of its workers' liveness: heartbeat recency and
    ``exitcode``.  A silent worker that is still alive is terminated
    before it is declared dead: its stripe is about to be reassigned,
    and two workers must never write the same map ids."""

    def __init__(self, procs: Dict[int, mp.Process], hb_timeout: float):
        self.procs = procs
        self.hb_timeout = hb_timeout
        self.last_hb = {i: time.monotonic() for i in procs}

    def beat(self, idx: int) -> None:
        self.last_hb[idx] = time.monotonic()

    def dead_workers(self, live) -> List[int]:
        from spark_rapids_tpu_torch.obs import journal
        now = time.monotonic()
        dead = []
        for i in list(live):
            p = self.procs[i]
            if p.exitcode is not None:
                dead.append(i)
                if journal.enabled():
                    journal.emit(journal.EVENT_WORKER_DEATH, worker=i,
                                 cause="exit", exitcode=p.exitcode)
            elif now - self.last_hb[i] > self.hb_timeout:
                p.terminate()
                p.join(timeout=5)
                dead.append(i)
                if journal.enabled():
                    journal.emit(journal.EVENT_WORKER_DEATH, worker=i,
                                 cause="heartbeat_timeout",
                                 silent_s=round(now - self.last_hb[i], 3))
        return dead


def distributed_groupby(parquet_path: str, group_col: str, agg_col: str,
                        n_workers: int = 2, timeout: float = 120.0,
                        conf: dict = None, return_stats: bool = False):
    """Sum and count of ``agg_col`` by ``group_col`` across ``n_workers``
    processes exchanging map output through the transport -> the rows
    (``{group_col, <agg>_sum, <agg>_count}``), or ``(rows, stats)``.
    ``conf`` carries ``spark.rapids.shuffle.*`` and
    ``spark.rapids.faults.*`` to every worker.  A dead worker's row
    groups go to the survivors and the round runs again."""
    import pyarrow.parquet as pq

    from spark_rapids_tpu_torch import lifecycle
    from spark_rapids_tpu_torch.conf import WORKER_HEARTBEAT_TIMEOUT, \
        TorchConf
    hb_timeout = TorchConf(dict(conf or {})).get(WORKER_HEARTBEAT_TIMEOUT)
    n_parts = n_workers  # fixed across rounds: partitions never move
    num_groups = pq.ParquetFile(parquet_path).metadata.num_row_groups
    ctx = mp.get_context("spawn")
    port_q = ctx.Queue()
    status_q = ctx.Queue()
    task_qs = {i: ctx.Queue() for i in range(n_workers)}
    procs: Dict[int, mp.Process] = {}
    for i in range(n_workers):
        p = ctx.Process(target=_worker_main, name=f"srt-groupby-{i}",
                        args=(i, parquet_path, group_col, agg_col, port_q,
                              task_qs[i], status_q, conf))
        p.start()
        lifecycle.track_process(p)
        procs[i] = p
    stats = {"rounds": 0, "workers_lost": 0, "recomputed_partitions": 0,
             "corrupt_refetches": 0, "transient_retries": 0,
             "blacklist_events": 0, "workers": {}}
    deadline = time.monotonic() + timeout
    watchdog = _Watchdog(procs, hb_timeout)

    def check_deadline(what: str) -> None:
        if time.monotonic() > deadline:
            raise RuntimeError(f"host shuffle {what} timed out after "
                               f"{timeout}s")

    def poll(live) -> Tuple[Optional[tuple], List[int]]:
        try:
            msg = status_q.get(timeout=0.25)
        except _queue.Empty:
            msg = None
        if msg is not None and msg[0] == "hb":
            watchdog.beat(msg[1])
            msg = None
        if msg is not None and msg[0] == "error":
            raise RuntimeError(
                f"host shuffle worker {msg[1]} failed: {msg[2]}")
        return msg, watchdog.dead_workers(live)

    try:
        live: Dict[int, int] = {}
        pending = set(range(n_workers))
        while pending:
            check_deadline("worker startup")
            try:
                idx, port = port_q.get(timeout=0.25)
                live[idx] = port
                watchdog.beat(idx)  # the startup's imports are no hang
                pending.discard(idx)
            except _queue.Empty:
                for i in [i for i in pending
                          if procs[i].exitcode is not None]:
                    pending.discard(i)
                    stats["workers_lost"] += 1
        rows: List[dict] = []
        rnd = 0
        while True:
            if not live:
                raise RuntimeError(
                    "all host shuffle workers died; cannot recover")
            check_deadline(f"round {rnd}")
            stats["rounds"] += 1
            shuffle_id = 7 + rnd  # a fresh id a round
            order = sorted(live)
            ports = [live[i] for i in order]
            for pos, i in enumerate(order):
                task_qs[i].put(("map", rnd, shuffle_id, ports,
                                list(range(num_groups))[pos::len(order)],
                                n_parts))
            responded: set = set()
            soft_fail = False
            dead: List[int] = []
            while len(responded) < len(order) and not dead:
                check_deadline(f"map round {rnd}")
                msg, dead = poll(live)
                if msg is None:
                    continue
                kind, idx, payload = msg
                if kind == "map_done" and payload == rnd:
                    responded.add(idx)
                elif kind == "map_failed" and payload[0] == rnd:
                    responded.add(idx)
                    soft_fail = True
            if dead or soft_fail:
                for i in dead:
                    del live[i]
                    stats["workers_lost"] += 1
                rnd += 1
                continue
            for pos, i in enumerate(order):
                task_qs[i].put(("reduce", rnd, shuffle_id,
                                list(range(n_parts))[pos::len(order)],
                                n_parts))
            results: Dict[int, Tuple] = {}
            dead = []
            while len(results) < len(order) and not dead:
                check_deadline(f"reduce round {rnd}")
                msg, dead = poll(live)
                if msg is None:
                    continue
                kind, idx, payload = msg
                if kind == "result" and payload[0] == rnd:
                    results[idx] = (payload[1], payload[2])
            if dead:
                for i in dead:
                    del live[i]
                    results.pop(i, None)
                    stats["workers_lost"] += 1
                rnd += 1
                continue
            # only the committed round's counters: a worker's are
            # cumulative over its rounds
            for idx, (part_rows, wstats) in results.items():
                stats["workers"][idx] = wstats
                for k in ("recomputed_partitions", "corrupt_refetches",
                          "transient_retries", "blacklist_events"):
                    stats[k] += int(wstats.get(k, 0))
                rows.extend(part_rows)
            break
    finally:
        for i, q in task_qs.items():
            try:
                q.put(("exit", -1))
            except (OSError, ValueError) as e:
                log.debug("exit message to worker %d failed: %s", i, e)
        for p in procs.values():
            p.join(timeout=10)
            if p.is_alive():
                p.terminate()
                p.join(timeout=5)
    return (rows, stats) if return_stats else rows
