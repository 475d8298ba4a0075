"""Process-wide histograms and the engine-stats snapshot.

Counterpart of ``spark_rapids_tpu/obs/registry.py`` (with the JAX
package's ``utils/metrics.Histogram``).  ``record(name, value)`` adds
one observation to a shared log2 histogram; ``snapshot()`` gathers the
stats of the port's modules (lifecycle, the spill catalogs, the session
server, the journal) and the histograms; ``prometheus_text()`` renders
the snapshot in Prometheus' text format.  Units ride in the histogram's
name (``*.us``).  Recording is gated by ``spark.rapids.sql.obs.enabled``
(set at query-scope entry): off, ``record`` is one flag read.  The
``fusion`` (``exec/stage.py``), ``compile`` (``compile/service.py``)
and ``placement`` (``plan/placement.py``) sections are the JAX
package's; its sections for modules the port lacks (ooc, the kernel
cache, ICI, health) are left out until queues A8b and A8c; ``shuffle``
(``shuffle/manager.py: global_stats``, the host shuffle's exchanges,
workers, blocks, wire and raw bytes, recomputes and the managers'
failure counters) is the port's own; ``prefetch``
(``io/prefetch.py: global_stats``) and ``d2h``
(``columnar/transfer.py: d2h_stats``) are kept.
"""

from __future__ import annotations

import threading
from typing import Dict, List

# one device -> host pull (columnar/transfer.py: device_pull) and one
# upload's dispatch (pipelined_h2d)
HIST_D2H_PULL_US = "transfer.device_pull.us"
HIST_D2H_PULL_BYTES = "transfer.device_pull.bytes"
HIST_H2D_UPLOAD_US = "transfer.pipelined_h2d.us"
HIST_H2D_UPLOAD_BYTES = "transfer.pipelined_h2d.bytes"
HIST_SEM_WAIT_US = "tpu.semaphore.wait.us"
# a host staging limiter's admission waits, by waiter class
# (memory/spill.py: HostStagingLimiter)
HIST_STAGING_SPILL_WAIT_US = "staging.spill.wait.us"
HIST_STAGING_PREFETCH_WAIT_US = "staging.prefetch.wait.us"
HIST_STAGING_EGRESS_WAIT_US = "staging.egress.wait.us"
STAGING_WAIT_HISTS = {
    "spill": HIST_STAGING_SPILL_WAIT_US,
    "prefetch": HIST_STAGING_PREFETCH_WAIT_US,
    "egress": HIST_STAGING_EGRESS_WAIT_US,
}
HIST_QUERY_WALL_US = "query.wall.us"
# submit -> dispatch through the session server's fair admission queue
HIST_SERVER_ADMIT_WAIT_US = "server.admit.wait.us"
# a standing query's micro-batch detected -> its refresh done
HIST_STREAM_FRESHNESS_US = "stream.freshness.us"
# a cost-placed query's |projected - actual| / actual, in percent
# (plan/placement.py: note_query)
HIST_PLACEMENT_COST_ERROR_PCT = "placement.cost_error.pct"


class Histogram:
    """Fixed-bucket log2 histogram: bucket ``b`` holds the values whose
    ``bit_length()`` is ``b`` ([2^(b-1), 2^b)), bucket 0 holds zero;
    ``snapshot()`` estimates p50/p90/p99 by the bucket's midpoint."""

    NBUCKETS = 64
    QUANTILES = (0.5, 0.9, 0.99)

    __slots__ = ("name", "_counts", "_count", "_sum", "_lock")

    def __init__(self, name: str = ""):
        self.name = name
        self._counts: List[int] = [0] * self.NBUCKETS
        self._count = 0
        self._sum = 0
        self._lock = threading.Lock()

    def record(self, value) -> None:
        v = max(0, int(value))
        b = min(v.bit_length(), self.NBUCKETS - 1)
        with self._lock:
            self._counts[b] += 1
            self._count += 1
            self._sum += v

    @staticmethod
    def _bucket_mid(b: int) -> int:
        if b <= 0:
            return 0
        lo = 1 << (b - 1)
        return lo + (lo >> 1)

    def snapshot(self) -> Dict[str, int]:
        """{"count", "sum", "mean", "p50", "p90", "p99"} (zeros when
        empty)."""
        with self._lock:
            counts = list(self._counts)
            n = self._count
            total = self._sum
        out = {"count": n, "sum": total, "mean": (total // n) if n else 0}
        targets = {f"p{int(q * 100)}": q * n for q in self.QUANTILES}
        mids = {k: 0 for k in targets}
        found = set()
        cum = 0
        for b, c in enumerate(counts):
            if not c:
                continue
            cum += c
            for key, tgt in targets.items():
                if key not in found and cum >= tgt:
                    found.add(key)
                    mids[key] = self._bucket_mid(b)
        out.update(mids)
        return out

    def reset(self) -> None:
        with self._lock:
            self._counts = [0] * self.NBUCKETS
            self._count = 0
            self._sum = 0


_ENABLED = True
_HIST_LOCK = threading.Lock()
_HISTOGRAMS: Dict[str, Histogram] = {}


def set_enabled(on: bool) -> None:
    global _ENABLED
    _ENABLED = bool(on)


def histogram(name: str) -> Histogram:
    """The process-wide histogram ``name``, made at first use."""
    with _HIST_LOCK:
        h = _HISTOGRAMS.get(name)
        if h is None:
            h = _HISTOGRAMS[name] = Histogram(name)
        return h


def record(name: str, value) -> None:
    if _ENABLED:
        histogram(name).record(value)


def histogram_snapshots() -> Dict[str, dict]:
    with _HIST_LOCK:
        hists = dict(_HISTOGRAMS)
    return {name: h.snapshot() for name, h in sorted(hists.items())}


def reset_histograms() -> None:
    with _HIST_LOCK:
        hists = list(_HISTOGRAMS.values())
    for h in hists:
        h.reset()


def _catalog_stats() -> dict:
    """The spill catalogs' gauges and counters, summed over the
    process's runtimes (one a device)."""
    from spark_rapids_tpu_torch.runtime import TorchRuntime
    with TorchRuntime._lock:
        runtimes = list(TorchRuntime._instances.values())
    keys = ("device_bytes", "host_bytes", "disk_bytes",
            "spill_to_host_count", "spill_to_disk_count", "unspill_count",
            "demote_failure_count", "budget_spill_count",
            "budget_exceeded_count")
    out = {k: 0 for k in keys}
    for rt in runtimes:
        st = rt.catalog.stats()
        for k in keys:
            out[k] += st[k]
    return out


def _compressed_stats() -> dict:
    from spark_rapids_tpu_torch.columnar import encoding
    raw = encoding.compressed_stats()
    out = {"encodedColumns": raw.pop("encoded_columns"),
           "lateDecodes": raw.pop("late_decodes"),
           "fusedDecodes": raw.pop("fused_decodes"),
           "compressedBytesSaved": raw.pop("bytes_saved")}
    out.update(raw)
    return out


def snapshot() -> dict:
    """The engine-stats dict: one key a module, and the histograms."""
    from spark_rapids_tpu_torch import lifecycle
    from spark_rapids_tpu_torch.columnar import transfer
    from spark_rapids_tpu_torch.compile import service as compile_service
    from spark_rapids_tpu_torch.exec import aqe, stage
    from spark_rapids_tpu_torch.plan import placement
    from spark_rapids_tpu_torch.io import prefetch
    from spark_rapids_tpu_torch.fleet import stats as fleet_stats
    from spark_rapids_tpu_torch.obs import journal
    from spark_rapids_tpu_torch.server import stats as server_stats
    from spark_rapids_tpu_torch.shuffle import manager as shuffle_manager
    from spark_rapids_tpu_torch.stream import stats as stream_stats
    return {
        # the scans' background decode and double-buffered uploads:
        # batches, stall and fill ms, overlap ms
        "prefetch": prefetch.global_stats(),
        # the result pulls: pulls, bytes, overlap ms, raw and wire bytes
        "d2h": transfer.d2h_stats(),
        # compressed-domain execution (columnar/encoding.py):
        # encodedColumns (columns ingested as codes), lateDecodes (the
        # counted escape hatch), compressedBytesSaved (raw less wire,
        # both directions) and the raw counters beside them
        "compressed": _compressed_stats(),
        # adaptive execution: replans, coalesced partitions, skew
        # splits, promotions, demotions, fallbacks, exchanges seen and
        # the largest and median partition bytes
        "aqe": aqe.global_stats(),
        # fused stages run, their dispatches and the operators they
        # folded (plan/fusion.py)
        "fusion": stage.global_stats(),
        # the compile store over the kernel libraries: hits, misses,
        # corrupt and faults, nvcc and load ms, the warm pool, the
        # capacity ladder's bounds
        "compile": compile_service.snapshot(),
        # fragment placement: fragments scored and placed, AQE
        # demotions, degraded passes, projected against actual ms and
        # the cost error's quantiles
        "placement": placement.global_stats(),
        "lifecycle": lifecycle.global_stats(),
        "catalog": _catalog_stats(),
        "server": server_stats.global_stats(),
        # the fleet router's counters (routing, overflow, failovers,
        # quarantines, restarts); zero outside a router's process
        "fleet": fleet_stats.global_stats(),
        # continuous queries: sources, ticks, refreshes by kind, cache
        # maintenance; all zero while spark.rapids.stream.enabled is off
        "stream": stream_stats.global_stats(),
        # the host shuffle: exchanges, workers spawned, blocks and their
        # wire and raw bytes, map and partition recomputes, the
        # managers' retries, refetches, fetch failures and blacklists,
        # and how many managers ran the native transport
        "shuffle": shuffle_manager.global_stats(),
        "journal": journal.stats(),
        "histograms": histogram_snapshots(),
    }


_PREFIX = "spark_rapids_tpu"


def _sanitize(name: str) -> str:
    return "".join(c if c.isalnum() or c == "_" else "_" for c in name)


def prometheus_text() -> str:
    """``snapshot()`` in Prometheus text format: each numeric stat a
    gauge ``spark_rapids_tpu_<group>_<key>``, each histogram a summary
    with ``quantile`` labels and ``_count`` / ``_sum`` series (the JAX
    package's names, so one scrape config reads both)."""
    snap = snapshot()
    lines = []
    for group, stats in snap.items():
        if group == "histograms":
            continue
        for key, value in sorted(stats.items()):
            if isinstance(value, bool):
                value = int(value)
            if not isinstance(value, (int, float)):
                continue
            metric = f"{_PREFIX}_{_sanitize(group)}_{_sanitize(key)}"
            lines.append(f"# TYPE {metric} gauge")
            lines.append(f"{metric} {value}")
    for name, snp in snap["histograms"].items():
        metric = f"{_PREFIX}_{_sanitize(name)}"
        lines.append(f"# TYPE {metric} summary")
        for q in ("p50", "p90", "p99"):
            lines.append(f'{metric}{{quantile="{int(q[1:]) / 100}"}} '
                         f'{snp[q]}')
        lines.append(f"{metric}_count {snp['count']}")
        lines.append(f"{metric}_sum {snp['sum']}")
    return "\n".join(lines) + "\n"
