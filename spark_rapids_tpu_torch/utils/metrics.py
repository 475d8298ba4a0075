"""Per-operator SQL metrics.

Counterpart of ``spark_rapids_tpu/utils/metrics.py``: the metric names
an operator may count (``METRIC_*``), ``Metric`` (an additive counter),
``MetricSet`` (one operator's metrics, refusing a name that is not
known unless it is marked ad hoc) and ``_Timer`` (host wall time of a
section, under a profiler range while tracing is on).  ``Histogram``
lives in ``obs/registry.py``.

Every count the port makes is a host int (``ColumnarBatch.num_rows``,
numbers an operator already read back), so a ``Metric`` holds no
pending device values and reading one never syncs the card.  A
``Metric`` takes part in integer arithmetic and comparisons through its
value, so an operator's ``metrics[name] += n`` and a caller's
``metrics[name] == 3`` read as they would over ints.
"""

from __future__ import annotations

import functools
import threading
import time
from typing import Dict

METRIC_NUM_OUTPUT_ROWS = "numOutputRows"
METRIC_NUM_OUTPUT_BATCHES = "numOutputBatches"
METRIC_NUM_INPUT_ROWS = "numInputRows"
METRIC_NUM_INPUT_BATCHES = "numInputBatches"
# host wall time, ns (the names ending in "time" render as ms)
METRIC_TOTAL_TIME = "totalTime"
METRIC_PEAK_DEVICE_MEMORY = "peakDeviceMemory"
# the coalesce's background pull (io/prefetch.py); the *Ms names carry
# milliseconds
METRIC_PREFETCH_BATCHES = "prefetchBatches"
METRIC_PREFETCH_STALL_MS = "prefetchStallMs"
METRIC_PREFETCH_FILL_MS = "prefetchFillMs"
METRIC_H2D_OVERLAP_MS = "h2dOverlapMs"
METRIC_D2H_PULLS = "d2hPulls"
METRIC_D2H_BYTES = "d2hBytes"
METRIC_D2H_OVERLAP_MS = "d2hOverlapMs"
METRIC_FUSED_OPS = "fusedOps"
METRIC_STAGE_DISPATCHES = "stageDispatches"
METRIC_XLA_COMPILE_MS = "xlaCompileMs"
# adaptive execution (exec/aqe.py, plan/adaptive.py)
METRIC_AQE_REPLANS = "aqeReplans"
METRIC_COALESCED_PARTITIONS = "coalescedPartitions"
METRIC_SKEW_SPLITS = "skewSplits"
METRIC_BROADCAST_PROMOTIONS = "broadcastPromotions"
METRIC_BROADCAST_DEMOTIONS = "broadcastDemotions"
METRIC_SHUFFLE_PARTITION_BYTES = "shufflePartitionBytes"
METRIC_PLACEMENT_DEMOTIONS = "placementDemotions"
METRIC_ICI_EXCHANGES = "iciExchanges"
METRIC_ICI_BYTES = "iciBytes"
METRIC_ICI_FALLBACKS = "iciFallbacks"
METRIC_ICI_SHARDED_SCANS = "iciShardedScans"
METRIC_ICI_SHARDED_SHARDS = "iciShardedShards"
# operator-specific metrics
METRIC_COMPUTE_AGG_TIME = "computeAggTime"
METRIC_CONCAT_TIME = "concatTime"
METRIC_BUILD_TIME = "buildTime"
METRIC_JOIN_TIME = "joinTime"
METRIC_BROADCAST_TIME = "broadcastTime"
METRIC_SAMPLE_TIME = "sampleTime"
METRIC_UPLOAD_TIME = "uploadTime"
METRIC_SEM_WAIT_MS = "semWaitMs"
METRIC_DATA_SIZE = "dataSize"
METRIC_PALLAS_AGG_BATCHES = "pallasAggBatches"
METRIC_FK_FAST_PATH_BATCHES = "fkFastPathBatches"
METRIC_BAND_JOIN_PROBES = "bandJoinProbes"
METRIC_SCAN_CACHE_HITS = "scanCacheHits"
METRIC_NUM_FILES_READ = "numFilesRead"
METRIC_NUM_FILES_TOTAL = "numFilesTotal"
METRIC_NUM_ROW_GROUPS_READ = "numRowGroupsRead"
METRIC_NUM_ROW_GROUPS_TOTAL = "numRowGroupsTotal"
METRIC_NUM_STRIPES_READ = "numStripesRead"
METRIC_NUM_STRIPES_TOTAL = "numStripesTotal"
METRIC_ENCODED_COLUMNS = "encodedColumns"
METRIC_LATE_DECODES = "lateDecodes"
METRIC_COMPRESSED_BYTES_SAVED = "compressedBytesSaved"
METRIC_SHUFFLE_ROWS_WRITTEN = "shuffleRowsWritten"
# the host shuffle (shuffle/stage.py): the map stage's and the reduce
# fetches' host wall (ns), the blocks fetched and their wire and raw
# (Arrow-counted) bytes
METRIC_SHUFFLE_MAP_TIME = "shuffleMapTime"
METRIC_SHUFFLE_FETCH_TIME = "shuffleFetchTime"
METRIC_SHUFFLE_BLOCKS_FETCHED = "shuffleBlocksFetched"
METRIC_SHUFFLE_WIRE_BYTES = "shuffleWireBytes"
METRIC_SHUFFLE_RAW_BYTES = "shuffleRawBytes"
METRIC_SHUFFLE_MAP_RECOMPUTES = "shuffleMapRecomputes"
METRIC_SHUFFLE_PARTITIONS_RECOMPUTED = "shufflePartitionsRecomputed"
METRIC_OOC_PARTITIONS = "oocPartitions"
METRIC_OOC_SPILL_BYTES = "oocSpillBytes"
METRIC_OOC_RECURSIONS = "oocRecursions"
METRIC_OOC_FALLBACKS = "oocFallbacks"
# the port's own: the numbers an operator read back from the card, and
# the candidate pairs the general and cross join routes lay out
METRIC_HOST_SYNCS = "hostSyncs"
# the CSV decode (io/csv.py): double fields converted by the exact host
# path, and host wall of the file reads (ns)
METRIC_CSV_SLOW_FLOAT_FIELDS = "csvSlowFloatFields"
METRIC_CSV_READ_TIME = "csvReadTime"
METRIC_JOIN_CANDIDATES = "joinCandidates"


def _collect_known_metrics() -> frozenset:
    return frozenset(v for k, v in globals().items()
                     if k.startswith("METRIC_") and isinstance(v, str))


# every metric name an operator may count: ``MetricSet`` refuses any
# other, so a misspelt name fails where it is used
KNOWN_METRICS = _collect_known_metrics()

_ADHOC_LOCK = threading.Lock()
_ADHOC_METRICS = set()


def register_adhoc_metric(name: str) -> None:
    """Permit ``name`` outside the ``METRIC_*`` names, process-wide
    (tests, experiments)."""
    with _ADHOC_LOCK:
        _ADHOC_METRICS.add(name)


@functools.total_ordering
class Metric:
    """An additive metric: ns for times, a count otherwise."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = 0
        self._lock = threading.Lock()

    def __getstate__(self):
        """A plan ships to the host shuffle's worker processes by pickle
        (``shuffle/stage.py``): the lock stays behind."""
        return {"name": self.name, "_value": self._value}

    def __setstate__(self, state):
        self.name = state["name"]
        self._value = state["_value"]
        self._lock = threading.Lock()

    def add(self, v) -> None:
        with self._lock:
            self._value += int(v)

    @property
    def value(self) -> int:
        return self._value

    # the int protocol: ``ms[name] += n`` adds in place (``MetricSet``
    # keeps the same object), everything else reads the value
    def __iadd__(self, v):
        self.add(v)
        return self

    def __index__(self) -> int:
        return self._value

    __int__ = __index__

    def __eq__(self, other) -> bool:
        return self._value == _value_of(other)

    def __lt__(self, other) -> bool:
        return self._value < _value_of(other)

    def __hash__(self):
        return id(self)

    def __add__(self, other):
        return self._value + _value_of(other)

    __radd__ = __add__

    def __mul__(self, other):
        return self._value * _value_of(other)

    __rmul__ = __mul__

    def __bool__(self) -> bool:
        return bool(self._value)

    def __repr__(self) -> str:
        return f"Metric({self.name}={self._value})"


def _value_of(v):
    return v.value if isinstance(v, Metric) else v


class MetricSet:
    """The metrics of one physical operator.  ``ms[name]`` makes a
    metric on first use, for a known name only; ``adhoc=True`` or
    ``register_adhoc_metric`` let other names through."""

    def __init__(self, *names: str, owner: str = "", adhoc: bool = False):
        base = (METRIC_NUM_OUTPUT_ROWS, METRIC_NUM_OUTPUT_BATCHES,
                METRIC_TOTAL_TIME)
        self._adhoc = adhoc
        for n in names:
            self._check(n)
        self._metrics: Dict[str, Metric] = {
            n: Metric(n) for n in (*base, *names)}
        self.owner = owner

    def _check(self, name: str) -> None:
        if self._adhoc or name in KNOWN_METRICS:
            return
        with _ADHOC_LOCK:
            if name in _ADHOC_METRICS:
                return
        raise KeyError(
            f"unknown metric name {name!r}: add a METRIC_* constant in "
            "spark_rapids_tpu_torch/utils/metrics.py; tests may use "
            "MetricSet(adhoc=True) or register_adhoc_metric()")

    def __getitem__(self, name: str) -> Metric:
        m = self._metrics.get(name)
        if m is None:
            self._check(name)
            m = self._metrics.setdefault(name, Metric(name))
        return m

    def __setitem__(self, name: str, value) -> None:
        """``ms[name] += n`` hands the same ``Metric`` back; an int sets
        the value."""
        m = self[name]
        if value is not m:
            with m._lock:
                m._value = int(value)

    def get(self, name: str, default=0):
        m = self._metrics.get(name)
        return default if m is None else m.value

    def timed(self, name: str) -> "_Timer":
        return _Timer(self[name], self.owner)

    def items(self):
        return self._metrics.items()

    def snapshot(self) -> Dict[str, int]:
        return {n: m.value for n, m in self._metrics.items()}


class _Timer:
    """Adds a section's host wall time (ns) to its metric; while tracing
    is on the section is also a profiler range named
    ``<owner>.<metric>``."""

    __slots__ = ("_metric", "_start", "_ann", "_owner")

    def __init__(self, metric: Metric, owner: str = ""):
        self._metric = metric
        self._owner = owner
        self._start = 0
        self._ann = None

    def __enter__(self):
        self._start = time.perf_counter_ns()
        from spark_rapids_tpu_torch.utils import tracing
        name = (f"{self._owner}.{self._metric.name}" if self._owner
                else self._metric.name)
        self._ann = tracing.annotation(name)
        if self._ann is not None:
            self._ann.__enter__()
        return self

    def __exit__(self, *exc):
        if self._ann is not None:
            self._ann.__exit__(*exc)
        self._metric.add(time.perf_counter_ns() - self._start)
        return False
