"""Typed configuration registry.

Counterpart of ``spark_rapids_tpu/conf.py``, trimmed to the keys the
port reads.  Keys the two packages share keep the JAX package's names,
so one conf dict drives both in the tests; keys the port does not know
are kept and ignored.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional


class ConfEntry:
    """One registered configuration key."""

    def __init__(self, key: str, default: Any, doc: str, conf_type: type,
                 validator: Optional[Callable[[Any], Optional[str]]] = None):
        self.key = key
        self.default = default
        self.doc = doc
        self.conf_type = conf_type
        self.validator = validator

    def convert(self, raw: Any) -> Any:
        if self.conf_type is bool and not isinstance(raw, bool):
            return str(raw).strip().lower() in ("true", "1", "yes")
        return self.conf_type(raw)


_REGISTRY: Dict[str, ConfEntry] = {}


def register(key: str, default: Any, doc: str, conf_type: type = str,
             validator=None) -> ConfEntry:
    entry = ConfEntry(key, default, doc, conf_type, validator)
    _REGISTRY[key] = entry
    return entry


def _positive(v) -> Optional[str]:
    return None if v > 0 else "must be positive"


def _non_negative(v) -> Optional[str]:
    return None if v >= 0 else "must be >= 0"


DEVICE = register(
    "spark.rapids.torch.device", "cuda",
    "torch device the session runs on. The default is the card; a "
    "session on 'cuda' without a usable card fails at creation. Tests "
    "pass 'cpu', which runs each kernel's plain PyTorch version.")

BATCH_SIZE_BYTES = register(
    "spark.rapids.sql.batchSizeBytes", 2147483647,
    "Target device batch size in bytes for the coalesce before an "
    "aggregate.", int, _positive)

BATCH_SIZE_ROWS = register(
    "spark.rapids.sql.batchSizeRows", 1 << 20,
    "Row cap of a coalesced device batch.", int, _positive)

READER_BATCH_SIZE_ROWS = register(
    "spark.rapids.sql.reader.batchSizeRows", 1 << 20,
    "Row cap of one batch a file scan uploads.", int, _positive)

MAX_STRING_WIDTH = register(
    "spark.rapids.sql.maxDeviceStringWidth", 512,
    "Widest string column (bytes, after rounding up to a power of two) "
    "that a batch may hold on the device; uploading a wider one raises, "
    "as in the JAX package.", int, _positive)

BROADCAST_THRESHOLD = register(
    "spark.sql.autoBroadcastJoinThreshold", 10 * 1024 * 1024,
    "Largest estimated size in bytes of a join side that is broadcast "
    "(built once into one device batch); -1 disables broadcast.", int)

SHUFFLE_PARTITIONS = register(
    "spark.sql.shuffle.partitions", 8,
    "Number of partitions of the shuffle exchanges the planner inserts "
    "(Spark's core conf; here the AQE join exchanges).", int, _positive)

SHUFFLE_DEFAULT_NUM_PARTITIONS = register(
    "spark.rapids.shuffle.defaultNumPartitions", 0,
    "Reduce-partition count of the shuffle exchanges that carry no "
    "count of their own: the host shuffle's (0 = workers x 2) and the "
    "AQE-inserted join exchanges' (0 = spark.sql.shuffle.partitions).",
    int, _non_negative)

# -- adaptive query execution (exec/aqe.py, plan/adaptive.py) ----------------

ADAPTIVE_ENABLED = register(
    "spark.rapids.sql.adaptive.enabled", False,
    "Adaptive query execution: each in-process shuffle exchange becomes "
    "a query stage whose measured per-partition bytes replan the rest of "
    "the plan (partition coalescing, skew-split joins, broadcast "
    "promotion and demotion against spark.sql.autoBroadcastJoinThreshold)."
    "  Off by default, as in Spark 3.0 and the JAX package; off, no "
    "adaptive node is built and plans are the static ones.", bool)

ADAPTIVE_COALESCE_ENABLED = register(
    "spark.rapids.sql.adaptive.coalescePartitions.enabled", True,
    "With adaptive.enabled: merge adjacent undersized reduce partitions "
    "toward advisoryPartitionSizeInBytes (Spark's "
    "CoalesceShufflePartitions).  Only AQE-inserted exchanges coalesce; "
    "an explicit repartition(n) count is a user contract.", bool)

ADAPTIVE_ADVISORY_SIZE = register(
    "spark.rapids.sql.adaptive.advisoryPartitionSizeInBytes",
    64 * 1024 * 1024,
    "Target bytes of a reduce partition for coalescing, and the split "
    "target of a skewed one.", int, _positive)

ADAPTIVE_MIN_PARTITIONS = register(
    "spark.rapids.sql.adaptive.coalescePartitions.minPartitionNum", 1,
    "Fewest reduce partitions coalescing may merge down to.", int,
    _positive)

ADAPTIVE_SKEW_ENABLED = register(
    "spark.rapids.sql.adaptive.skewJoin.enabled", True,
    "With adaptive.enabled: a reduce partition on the stream side of a "
    "join whose bytes pass max(skewedPartitionFactor x median, "
    "skewedPartitionThresholdInBytes) splits into sub-partitions, each "
    "probing the whole build side (Spark's OptimizeSkewedJoin).", bool)

ADAPTIVE_SKEW_FACTOR = register(
    "spark.rapids.sql.adaptive.skewJoin.skewedPartitionFactor", 5,
    "A partition is skewed when its bytes pass this multiple of the "
    "median non-empty partition's (and the threshold below).", int,
    _positive)

ADAPTIVE_SKEW_THRESHOLD = register(
    "spark.rapids.sql.adaptive.skewJoin.skewedPartitionThresholdInBytes",
    256 * 1024 * 1024,
    "Absolute floor of skew: a partition below it never splits.", int,
    _positive)


PALLAS_AGG = register(
    "spark.rapids.sql.tpu.pallas.agg.enabled", True,
    "Run the update phase of a single-integer-key aggregate whose key "
    "domain fits 1024 slots through the dense-slot kernel instead of "
    "the sorted-segment path.", bool)


COMPRESSED_ENABLED = register(
    "spark.rapids.sql.compressed.enabled", True,
    "Master switch for compressed-domain execution "
    "(columnar/encoding.py): dictionary-encoded string columns cross "
    "to the device as int32 codes and one small dictionary, the fused "
    "stage rewrites predicates and projections over them to per-code "
    "gathers of tables evaluated once over the dictionary, group-by "
    "keys group by code (rank codes keep the output order), equi-join "
    "keys compare as codes, and the exchange, coalesce, spill and the "
    "result pull carry codes.  false = no column is ever encoded and "
    "every result is the dense engine's.", bool)

COMPRESSED_INGEST = register(
    "spark.rapids.sql.compressed.ingest", True,
    "With compressed.enabled: the local, parquet, ORC and CSV scans "
    "upload a low-cardinality string column as codes and a dictionary "
    "instead of its char matrix.  An injected io.encode fault (or an "
    "I/O error while encoding) sends that column the plain way, "
    "counted in encode_faults.  false = every column rides the plain "
    "path, and no compressed-domain path engages.", bool)

COMPRESSED_EGRESS = register(
    "spark.rapids.sql.compressed.egress", True,
    "With compressed.enabled: the result pull brings an encoded "
    "column's codes and validity to the host and looks its strings up "
    "in the dictionary's host copy.  false = the column decodes on the "
    "device first and its char matrix crosses (the same strings).",
    bool)


def _fraction(v) -> Optional[str]:
    return None if 0.0 < v <= 1.0 else "must be in (0, 1]"


COMPRESSED_MAX_DICT_FRACTION = register(
    "spark.rapids.sql.compressed.maxDictFraction", 0.5,
    "Encode a string column only when its distinct-value count is at "
    "most this fraction of the batch's rows (at least 1): past it the "
    "dictionary stops paying for the codes and the column rides the "
    "plain path.", float, _fraction)

COMPRESSED_MAX_COMPOSED_CELLS = register(
    "spark.rapids.sql.compressed.maxComposedCells", 65536,
    "Upper bound on the table of a two-column dictionary rewrite: a "
    "deterministic subtree over two encoded columns evaluates once per "
    "(code1, code2) pair, (size1 + 1) x (size2 + 1) cells with the "
    "null slots, and becomes one gather by the combined code.  Pairs "
    "past it keep the one-column rewrites; 0 disables the composed "
    "rewrite.", int, _non_negative)

COMPRESSED_RLE = register(
    "spark.rapids.sql.compressed.rle.enabled", True,
    "With compressed.ingest: the local, parquet and ORC scans upload an "
    "INT32 or INT64 column as run values and cumulative run ends when "
    "that crosses fewer bytes than the plain planes and the delta "
    "encoding: a sorted or clustered column crosses as a few runs, and "
    "the fused stage and the aggregate's update decode it in their own "
    "pass (a searchsorted gather, counted in fused_decodes).  An "
    "injected io.encode fault sends the column the plain way, counted.  "
    "false = integer columns never ride RLE (the same results).", bool)

COMPRESSED_DELTA = register(
    "spark.rapids.sql.compressed.delta.enabled", True,
    "With compressed.ingest: upload a null-free INT32 or INT64 column as "
    "its first value and int8 or int16 row-to-row deltas when every "
    "delta fits the narrow type and that crosses the fewest bytes: "
    "monotonic ids and near-sorted keys cross at 1 or 2 bytes a row, "
    "and the consuming stage or update decodes them (a cumsum, counted "
    "in fused_decodes).  Columns with nulls or wide deltas ride plain.  "
    "false = never delta-encode (the same results).", bool)

COMPRESSED_PACKED_BOOL = register(
    "spark.rapids.sql.compressed.packedBool.enabled", True,
    "With compressed.ingest: upload a BOOLEAN column bit-packed (8 rows "
    "a byte) and unpack it inside the consuming stage or update "
    "(counted in fused_decodes).  false = booleans ride their plain "
    "one-byte planes (the same results).", bool)

CONCURRENT_TASKS = register(
    "spark.rapids.tpu.concurrentTasks", 2,
    "Number of tasks the device semaphore admits at once (runtime.py; "
    "the JAX package's key and default).", int, _positive)

CONCURRENT_TPU_TASKS = register(
    "spark.rapids.sql.concurrentTpuTasks", 0,
    "Legacy alias for spark.rapids.tpu.concurrentTasks: a positive value "
    "overrides that key when the runtime sizes its semaphore; 0 defers "
    "(the JAX package's key and rule).", int, _non_negative)

SQL_ENABLED = register(
    "spark.rapids.sql.enabled", True,
    "Master switch of the device engine.  false runs the whole plan on "
    "the port's own operators over host tensors, as "
    "spark.rapids.sql.placement.mode=cpu runs it: no kernel is launched "
    "and the result egress pulls nothing (the JAX package sends every "
    "node to its CPU engine, which the port does not have).", bool)

ALLOC_FRACTION = register(
    "spark.rapids.memory.tpu.allocFraction", 0.9,
    "Fraction of the card's total memory the spill catalog budgets for "
    "the batches it tracks.", float, _fraction)

BUDGET_BYTES = register(
    "spark.rapids.memory.tpu.budgetBytes", 0,
    "Explicit device budget of the spill catalog in bytes; 0 derives it "
    "from the card's total memory x allocFraction.", int)

HOST_SPILL_STORAGE_SIZE = register(
    "spark.rapids.memory.host.spillStorageSize", 1 << 30,
    "Bytes of pinned host memory holding spilled device batches before "
    "they demote to disk.", int)

IO_PREFETCH_ENABLED = register(
    "spark.rapids.sql.io.prefetch.enabled", False,
    "Decode the file scans' next host batches (and the CSV scan's next "
    "byte ranges) on a background thread, double-buffer the uploads of "
    "every scan so that batch k + 1's copy is dispatched before batch k "
    "is yielded (columnar/transfer.py: pipelined_h2d), and pull the "
    "child of a coalesce one batch ahead (io/prefetch.py: "
    "device_lookahead); false runs the serial decode -> upload -> "
    "yield loop.  Both give the same batches in the same order.  Off "
    "by default, unlike the JAX package: on an H100 (700 W) the warm "
    "SF1 queries ran slower with it on, q1 0.349 to 0.464 s against "
    "0.284 to 0.358 s off, q6 0.300 to 0.381 against 0.202 to 0.255, "
    "q3 0.492 to 0.528 against 0.318 to 0.466 (chip_smoke.py phase 26; "
    "PERF.md): the local scan's host work holds the thread that would "
    "overlap it.", bool)

IO_PREFETCH_BATCHES = register(
    "spark.rapids.sql.io.prefetch.batches", 2,
    "Depth of the background decode queue: how many decoded host "
    "batches a scan may hold ahead of its consumer.  Each queued batch "
    "is admitted through the prefetch staging limiter "
    "(spark.rapids.memory.pinnedPool.size) first, so at most depth + 2 "
    "batches' grants are held (queued, in the consumer's hand, and one "
    "a producer parked on the full queue acquired).", int, _positive)

IO_EGRESS_ENABLED = register(
    "spark.rapids.sql.io.egress.enabled", True,
    "Double-buffered result egress (columnar/transfer.py: "
    "pipelined_d2h): group k + 1's pack and device -> host copy are "
    "dispatched before group k's blocking pull, each pull admitted "
    "through the egress staging limiter for its own length only; false "
    "is the strictly serial pull-then-yield loop.  Both give the same "
    "result.", bool)

PINNED_POOL_SIZE = register(
    "spark.rapids.memory.pinnedPool.size", 0,
    "Bytes of host staging each of the three staging limiters admits "
    "at once (spill, scan prefetch, egress; memory/spill.py) while "
    "spark.rapids.memory.tpu.pooling.enabled is on; 0 disables.", int,
    _non_negative)

POOLING_ENABLED = register(
    "spark.rapids.memory.tpu.pooling.enabled", True,
    "Cap the host staging limiters at spark.rapids.memory.pinnedPool."
    "size (the JAX package's key and default).", bool)

TRANSFER_PACK_ENABLED = register(
    "spark.rapids.sql.transfer.pack.enabled", False,
    "Pack a query's result batches on the device (concatenated, rows "
    "trimmed to a quarter-power-of-two bucket, validity and booleans "
    "bit-packed, integers delta-narrowed, string widths trimmed) and "
    "pull them in one pull a group of up to 256 MB; false pulls each "
    "batch's planes as they are (columnar/transfer.py).  Off by "
    "default, unlike the JAX package: on an H100 (700 W) "
    "project_filter_1m's 450,303-row result crossed 0.68 of its raw "
    "bytes packed but came back in 0.0132 to 0.0196 s against 0.0099 "
    "to 0.0139 s unpacked (chip_smoke.py phase 26; PERF.md): the "
    "stats pull and the pack's launches cost more than the bytes they "
    "save on the card's host link.", bool)

TRANSFER_STATS_THRESHOLD = register(
    "spark.rapids.sql.transfer.statsThresholdBytes", 1 << 20,
    "A packed result larger than this spends one extra small pull on "
    "(min, max, longest string) stats to narrow the data pull; at or "
    "below it one pull carries the data.", int, _positive)

SCAN_DEVICE_CACHE = register(
    "spark.rapids.sql.scan.deviceCacheEnabled", True,
    "Keep the parquet, CSV and ORC scans' device batches on the card "
    "across queries (runtime.py: the scan cache, 8 entries, LRU), keyed "
    "by each file's identity (path, mtime_ns, size, inode) and the "
    "scan's shape and encodings, held in the spill catalog at the "
    "lowest priority, so that memory pressure demotes them first; a "
    "repeated read serves them and counts scanCacheHits.  The local "
    "scan is not cached.", bool)

RANGE_SAMPLE_SIZE = register(
    "spark.rapids.sql.rangePartitioning.sampleSize", 10_000,
    "Most rows sampled to compute the bounds of a range repartition "
    "(exec/exchange.py: compute_range_bounds).", int, _positive)

# -- whole-stage fusion (plan/fusion.py) --------------------------------------

FUSION_ENABLED = register(
    "spark.rapids.sql.fusion.enabled", True,
    "Collapse each maximal chain of project and filter operators into "
    "one fused stage (exec/stage.py: TorchStageExec) that runs the "
    "chain per batch; a chain of one stays a TorchProjectExec or "
    "TorchFilterExec.  false keeps every operator on its own.", bool)

FUSION_MAX_OPS = register(
    "spark.rapids.sql.fusion.maxOps", 16,
    "Most operators folded into one fused stage; a longer chain splits "
    "into several stages.", int, _positive)

# -- the compile store over the kernel libraries (compile/) -------------------
#
# All off by default: with spark.rapids.sql.compile.* unset no store
# exists, native.py builds into its _build/ directory, and the capacity
# ladder keeps its bounds.

COMPILE_PREFIX = "spark.rapids.sql.compile."

COMPILE_STORE_ENABLED = register(
    "spark.rapids.sql.compile.store.enabled", False,
    "Keep the nvcc-built kernel libraries (native.py) in a store under "
    "spark.rapids.sql.compile.cacheDir (cuda/ and its index.jsonl), "
    "shared by every process that names the directory (fleet "
    "replicas, restarted servers): a library the index records is "
    "loaded, never built again (compileStoreHits; a build counts "
    "compileStoreMisses).  A truncated library, a corrupt index line "
    "or an injected compile.store fault degrades to a counted fresh "
    "build.", bool)

COMPILE_CACHE_DIR = register(
    "spark.rapids.sql.compile.cacheDir", "",
    "Directory of the compile store.  Empty (the default): "
    "~/.cache/srt-compile/cuda-<host fingerprint>.  Only read when "
    "compile.store.enabled.", str)

COMPILE_BUCKET_MIN_ROWS = register(
    "spark.rapids.sql.compile.buckets.minRows", 8,
    "Smallest rung of the power-of-two capacity ladder every batch "
    "capacity routes through (compile/buckets.py), rounded up to a "
    "power of two; 8 is the JAX package's floor.", int, _positive)

COMPILE_BUCKET_MAX_ROWS = register(
    "spark.rapids.sql.compile.buckets.maxRows", 0,
    "Largest ladder rung the coalesce's row target snaps down to "
    "(rounded up to a power of two; 0, the default, is unbounded).  A "
    "batch larger than it still gets a capacity that holds it.", int,
    _non_negative)

COMPILE_WARM_ENABLED = register(
    "spark.rapids.sql.compile.warm.enabled", True,
    "With the store on: at runtime or server start, build or load every "
    "kernel library and launch each kernel once on a tiny input, on a "
    "lifecycle-supervised srt-compile-warm thread, so the first query "
    "pays neither (warmPoolCompiles).  Inert unless "
    "compile.store.enabled.", bool)

# -- fragment placement (plan/cost.py, plan/placement.py) ---------------------
#
# The engine keys stay the JAX package's: "tpu" names the card the
# session runs on, "cpu" the port's own operators over host tensors.


def _one_of(*options):
    folded = tuple(o.upper() for o in options)

    def check(v):
        return None if str(v).upper() in folded else \
            f"must be one of {options}"
    return check


PLACEMENT_MODE = register(
    "spark.rapids.sql.placement.mode", "tpu",
    "Fragment placement.  'tpu' (the default): every plan runs on the "
    "session's device, and the placement pass never runs.  'cost': the "
    "plan (one fragment: the port lowers every node) is scored with "
    "the cost model (link bytes over the measured rates, the pull "
    "latency, calibrated rows/s) and, where the host wins, runs on "
    "the port's own operators over host tensors (the same operators, "
    "on torch.device('cpu') and its runtime); with adaptive execution "
    "the remainder above a materialized stage is scored again with "
    "its measured bytes.  'cpu': every plan runs on the host.  'tpu' "
    "in a decision names the card.  An injected plan.place fault "
    "degrades to the device plan, counted.", str,
    _one_of("tpu", "cost", "cpu"))

PLACEMENT_H2D_MBPS = register(
    "spark.rapids.sql.placement.h2dMBps", 0.0,
    "Host-to-card rate (MB/s) the cost model charges a fragment's input "
    "with.  0 (the default): measured once a process "
    "(plan/cost.py: probe_link); set it to pin decisions.", float,
    _non_negative)

PLACEMENT_D2H_MBPS = register(
    "spark.rapids.sql.placement.d2hMBps", 0.0,
    "Card-to-host rate (MB/s) the cost model charges a fragment's "
    "result with.  0 (the default): measured by the probe.", float,
    _non_negative)

PLACEMENT_AGG_H2D_MBPS = register(
    "spark.rapids.sql.placement.aggregateH2dMBps", 0.0,
    "Aggregate host-to-card rate across cards for a sharded scan; read "
    "only by a mesh session (ROADMAP.md, queue A8), so unused on one "
    "card.", float, _non_negative)

PLACEMENT_AGG_D2H_MBPS = register(
    "spark.rapids.sql.placement.aggregateD2hMBps", 0.0,
    "Aggregate card-to-host rate across cards; unused on one card "
    "(queue A8).", float, _non_negative)

PLACEMENT_PULL_LATENCY_MS = register(
    "spark.rapids.sql.placement.pullLatencyMs", -1.0,
    "Fixed latency (ms) of one card-to-host pull the cost model "
    "charges.  Negative (the default): measured by the probe; 0 is a "
    "valid pinned value.", float)

PLACEMENT_AQE_ENABLED = register(
    "spark.rapids.sql.placement.aqe.enabled", True,
    "With placement.mode=cost and adaptive execution on: after each "
    "query stage materializes, score the remainder above it again with "
    "its measured bytes, and run it on the host (between a counted "
    "DeviceToHostExec and HostToDeviceExec) where that wins; "
    "placementDemotions counts it.  An error or a plan.place fault "
    "keeps the plan.", bool)

PLACEMENT_CPU_ROWS_PER_SEC = register(
    "spark.rapids.sql.placement.cpuRowsPerSec", 5_000_000,
    "Prior host throughput (rows/s an operator) of the cost model; "
    "executed queries blend measured rates over it (EWMA 0.3, kept in "
    "calibration.json beside the compile store when there is one).",
    int, _positive)

PLACEMENT_TPU_ROWS_PER_SEC = register(
    "spark.rapids.sql.placement.tpuRowsPerSec", 50_000_000,
    "Prior card throughput (rows/s an operator) of the cost model; "
    "calibrated as cpuRowsPerSec is.", int, _positive)


INCOMPATIBLE_OPS = register(
    "spark.rapids.sql.incompatibleOps.enabled", False,
    "Enable the expressions whose results differ from Spark in corner "
    "cases: Upper, Lower and InitCap (ASCII only) and Rand (threefry, "
    "not Spark's XORShift).  One of them is also enabled by its own key, "
    "spark.rapids.sql.expression.<Name>.  With it off such an expression "
    "raises when the query is planned (the JAX package runs it on its "
    "CPU engine, which the port has not).", bool)

CAST_STRING_TO_INTEGER = register(
    "spark.rapids.sql.castStringToInteger.enabled", False,
    "Enable the string -> integral cast; off, it raises at planning.",
    bool)

CAST_STRING_TO_FLOAT = register(
    "spark.rapids.sql.castStringToFloat.enabled", False,
    "Enable the string -> float cast (a result may sit a few ulp from "
    "Java's parser); off, it raises at planning.", bool)

CAST_STRING_TO_TIMESTAMP = register(
    "spark.rapids.sql.castStringToTimestamp.enabled", False,
    "Enable the string -> timestamp and string -> date casts; off, they "
    "raise at planning.", bool)


# -- the query lifecycle (lifecycle.py) --------------------------------------

QUERY_TIMEOUT_MS = register(
    "spark.rapids.sql.queryTimeoutMs", 0,
    "Per-query deadline in milliseconds: every operator's output (the "
    "pull boundary, exec/base.py) and every bounded wait (the device "
    "semaphore, the background pull's queue, the hang watchdog) checks "
    "the query's cancel token and raises QueryTimeoutError once it has "
    "passed; the query's registered resources then close in "
    "registration order.  0 disables the deadline.", int, _non_negative)

CANCEL_CHECK_INTERVAL_MS = register(
    "spark.rapids.sql.cancel.checkIntervalMs", 50,
    "Poll interval of the lifecycle's bounded waits: the longest a "
    "cancel or a passed deadline goes unseen by a wait that nothing "
    "wakes.", int, _positive)

WATCHDOG_HANG_TIMEOUT_MS = register(
    "spark.rapids.sql.watchdog.hangTimeoutMs", 0,
    "Bound in milliseconds on a blocking call run through "
    "lifecycle.supervise (fault site io.pipeline.hang): when > 0 the "
    "call runs on a supervised thread, and one that passes the bound "
    "raises QueryHangError.  0 runs the call inline.", int, _non_negative)

# -- fault injection (faults.py) ---------------------------------------------

FAULTS_SEED = register(
    "spark.rapids.faults.seed", 0,
    "Seed of the prob:p fault triggers (spark.rapids.faults.<site>); "
    "count and first triggers do not use it.", int)

# -- observability (obs/) ----------------------------------------------------

OBS_ENABLED = register(
    "spark.rapids.sql.obs.enabled", True,
    "Record the log2 histograms of obs/registry.py (semaphore waits, "
    "query wall time, the server's admission waits); false makes each "
    "record one flag check.", bool)

OBS_JOURNAL_DIR = register(
    "spark.rapids.sql.obs.journalDir", "",
    "When set, append a JSONL journal of typed engine events (query "
    "start/finish/cancel/timeout/error, fault fires, watchdog trips, "
    "admissions and cache outcomes) to <dir>/events-<pid>.jsonl.  Empty "
    "disables it.", str)

OBS_JOURNAL_MAX_EVENTS = register(
    "spark.rapids.sql.obs.journal.maxEvents", 100_000,
    "Cap on the events one process writes to the journal; past it "
    "events are counted as dropped.", int, _positive)

TRACE_ENABLED = register(
    "spark.rapids.sql.trace.enabled", False,
    "Open the operators' named ranges (torch.profiler record_function) "
    "for each query; they are open anyway while a torch.profiler "
    "capture records.", bool)

TRACE_DIR = register(
    "spark.rapids.sql.trace.dir", "",
    "When set (and trace.enabled), each collect(), to_torch() and "
    "to_device_batches() runs under torch.profiler.profile and writes "
    "one Chrome trace a query to this directory.", str)

# -- the session server (server/) --------------------------------------------
#
# Per-tenant overrides are raw keys, tenant names being user data:
# spark.rapids.server.tenant.<name>.weight / .timeoutMs / .maxDeviceBytes.
SERVER_TENANT_PREFIX = "spark.rapids.server.tenant."

SERVER_ENABLED = register(
    "spark.rapids.server.enabled", False,
    "The session server's switch.  Calling session.server() is itself "
    "the opt-in, as in the JAX package; setting this key false makes "
    "session.server() refuse.", bool)

SERVER_MAX_CONCURRENCY = register(
    "spark.rapids.server.maxConcurrency", 0,
    "Worker threads that run admitted queries at once (each still "
    "passes the device semaphore); 0 derives 2 x "
    "spark.rapids.tpu.concurrentTasks.", int, _non_negative)

SERVER_QUEUE_DEPTH = register(
    "spark.rapids.server.admission.queueDepth", 64,
    "Most queries waiting in the fair admission queue; a submit past it "
    "is shed with AdmissionRejectedError.", int, _positive)

SERVER_DEFAULT_WEIGHT = register(
    "spark.rapids.server.admission.defaultWeight", 1,
    "Fair-share weight of a tenant without its own "
    "spark.rapids.server.tenant.<name>.weight (stride scheduling).",
    int, _positive)

SERVER_TENANT_TIMEOUT_MS = register(
    "spark.rapids.server.tenant.defaultTimeoutMs", 0,
    "Deadline of a server query whose tenant has no "
    "spark.rapids.server.tenant.<name>.timeoutMs; 0 defers to "
    "spark.rapids.sql.queryTimeoutMs.", int, _non_negative)

SERVER_QUERY_MAX_DEVICE_BYTES = register(
    "spark.rapids.server.query.maxDeviceBytes", 0,
    "Device-resident byte budget of one query over the spill catalog's "
    "handles: past it the query spills its own handles, then fails with "
    "QueryBudgetExceededError.  0 disables it.", int, _non_negative)

SERVER_RESULT_CACHE = register(
    "spark.rapids.server.resultCache.enabled", True,
    "Cache server results by (plan fingerprint with the prepared "
    "bindings masked, input snapshot, conf fingerprint, bindings).",
    bool)

SERVER_RESULT_CACHE_ENTRIES = register(
    "spark.rapids.server.resultCache.maxEntries", 64,
    "Entry bound of the result cache.", int, _positive)

SERVER_RESULT_CACHE_BYTES = register(
    "spark.rapids.server.resultCache.maxBytes", 256 * 1024 * 1024,
    "Byte bound of the result cache (host result bytes); the least "
    "recently used entries go past either bound.", int, _positive)

SERVER_RETRY_MAX_ATTEMPTS = register(
    "spark.rapids.server.retry.maxAttempts", 2,
    "Attempts of a server query a chip failure kills.  Replay engages "
    "only under spark.rapids.health.enabled, which the port refuses "
    "(ROADMAP.md, queue A8), so the port reads and never uses it.",
    int, _positive)

SERVER_RETRY_BUDGET_PER_MIN = register(
    "spark.rapids.server.retry.budgetPerMin", 10,
    "Replays a tenant may make a rolling minute (see "
    "spark.rapids.server.retry.maxAttempts).", int, _non_negative)

# -- the serving fleet (fleet/) ----------------------------------------------
#
# All off by default: with spark.rapids.fleet.replicas unset
# session.fleet() refuses and no replica process starts.

FLEET_REPLICAS = register(
    "spark.rapids.fleet.replicas", 0,
    "Number of replica processes the fleet router (session.fleet()) "
    "spawns, each with its own session and server on the conf's device "
    "and each a failure domain: a replica dying takes only its queries "
    "in flight, which fail over to the others.  0 (the default): no "
    "fleet, session.fleet() refuses.", int, _non_negative)

FLEET_QUEUE_DEPTH = register(
    "spark.rapids.fleet.routing.queueDepth", 16,
    "Bound on the queries the router has in flight on one replica.  A "
    "full replica's traffic overflows to the other healthy replicas; "
    "only when every healthy replica is at its bound is a query shed "
    "(AdmissionRejectedError).", int, _positive)

FLEET_HEARTBEAT_INTERVAL_MS = register(
    "spark.rapids.fleet.heartbeat.intervalMs", 200,
    "How often each replica's heartbeat thread reports to the router.",
    int, _positive)

FLEET_HEARTBEAT_TIMEOUT_MS = register(
    "spark.rapids.fleet.heartbeat.timeoutMs", 10000,
    "Heartbeat silence after which the router terminates a replica that "
    "looks alive and declares it dead: its queries in flight fail over "
    "and it takes no more traffic.  An exit code declares death at "
    "once.", int, _positive)

FLEET_HEALTH_SCORE_ALPHA = register(
    "spark.rapids.fleet.health.scoreAlpha", 0.5,
    "EWMA weight of a replica's newest outcome in its health score: "
    "score' = alpha*outcome + (1-alpha)*score, outcome 1.0 for a clean "
    "response, 0.25 for a slow mark (replica.slow), 0.0 for a failure "
    "of the replica.", float, _fraction)

FLEET_HEALTH_QUARANTINE_THRESHOLD = register(
    "spark.rapids.fleet.health.quarantineThreshold", 0.4,
    "Health score below which a replica is quarantined: routed around, "
    "probed after probationMs, re-admitted on probation.", float,
    _fraction)

FLEET_HEALTH_PROBATION_MS = register(
    "spark.rapids.fleet.health.probationMs", 2000,
    "Quarantine before the router probes a replica: a passing probe "
    "re-admits it on probation (one failure quarantines it again, one "
    "clean response restores it), a failing one restarts the window.",
    int, _positive)

FLEET_RETRY_MAX_ATTEMPTS = register(
    "spark.rapids.fleet.retry.maxAttempts", 2,
    "Dispatch attempts of a query whose replica dies or fails while it "
    "is in flight: 2 replays it once on a healthy replica, 1 never.  "
    "Past the bound, or the tenant's budget, it fails typed "
    "(ReplicaFailedError).", int, _positive)

FLEET_RETRY_BUDGET_PER_MIN = register(
    "spark.rapids.fleet.retry.budgetPerMin", 10,
    "Replays a tenant may make a rolling minute; one past it is shed "
    "with RetryBudgetExhaustedError, so a crash-looping replica cannot "
    "double every tenant's load.", int, _non_negative)

FLEET_STARTUP_TIMEOUT_MS = register(
    "spark.rapids.fleet.startupTimeoutMs", 180000,
    "Bound on one replica process getting ready (spawn, imports, its "
    "session and server, and for a replacement its probe query).  A "
    "replica past it is terminated and the fleet's construction or the "
    "replacement fails typed.", int, _positive)

FLEET_RESULT_CACHE_DIR = register(
    "spark.rapids.fleet.resultCache.dir", "",
    "Directory of the on-disk result tier the result cache spills "
    "through (entries over in-memory relations stay in memory).  Empty "
    "disables it.", str)

FLEET_RESULT_CACHE_MAX_BYTES = register(
    "spark.rapids.fleet.resultCache.maxBytes", 256 * 1024 * 1024,
    "Byte bound of the on-disk result tier.", int, _positive)

# the key of a layer the port does not have; a server built with it on
# raises (server/core.py) instead of running without it
HEALTH_ENABLED = register(
    "spark.rapids.health.enabled", False,
    "The JAX package's chip failure domain (queue A8c); the port raises "
    "NotImplementedError when a server is built with it on, and on a "
    "plan that holds a mesh fragment.", bool)

STREAM_ENABLED = register(
    "spark.rapids.stream.enabled", False,
    "Continuous queries: the session server gains tailing sources (a "
    "poller diffing registered parquet, ORC or CSV roots into append "
    "micro-batches), standing queries refreshed incrementally through "
    "the partial-aggregate merge, and maintained result-cache entries.  "
    "Off (the default): no poller thread and no registry.", bool)

STREAM_POLL_INTERVAL_MS = register(
    "spark.rapids.stream.pollIntervalMs", 1000,
    "Milliseconds between tailing-source polls.", int, _positive)

STREAM_MAX_FILES_PER_TICK = register(
    "spark.rapids.stream.maxFilesPerTick", 64,
    "New files one micro-batch may carry; a larger backlog drains over "
    "the following ticks, oldest first.  Grown files always drain whole.",
    int, _positive)

STREAM_INCREMENTAL = register(
    "spark.rapids.stream.incremental.enabled", True,
    "Refresh standing queries incrementally where the plan allows "
    "(Count/Sum/Min/Max/Average group-bys, append-linear project, filter "
    "and stream-side join chains over one tailed leaf); false makes "
    "every refresh a full recompute (counted), with equal results.",
    bool)

STREAM_CACHE_MAINTAIN = register(
    "spark.rapids.stream.cache.maintain", False,
    "Maintain a result-cache entry whose snapshot differs by new files "
    "on exactly one scanned leaf: the delta merges into the cached "
    "result instead of invalidating it.  Any other change falls back "
    "to a miss and a recompute, counted.  Needs "
    "spark.rapids.stream.enabled.", bool)

STREAM_REFRESH_TIMEOUT_MS = register(
    "spark.rapids.stream.refreshTimeoutMs", 60000,
    "Bound on one standing-query refresh's wait; one that misses it is "
    "a counted refresh error and the query recomputes on the next tick.",
    int, _positive)

# -- the host shuffle (shuffle/) ------------------------------------------------
#
# The JAX package's keys, defaults and validators
# (spark_rapids_tpu/conf.py:554-814).  Off by default: with
# spark.rapids.shuffle.workers.count at 0 or 1 no worker process starts.


def _fraction_inclusive(v) -> Optional[str]:
    return None if 0.0 <= v <= 1.0 else "must be in [0, 1]"


SHUFFLE_MODE = register(
    "spark.rapids.shuffle.mode", "host",
    "Shuffle data plane.  'host': partition blocks move through host "
    "memory (in-process gathers, or the socket transport with "
    "spark.rapids.shuffle.workers.count > 1).  'ici': with no map "
    "workers, no explicit spark.rapids.sql.mesh.devices and a pool of "
    "two or more devices (parallel/mesh.py: visible_pool), the planner "
    "lowers grouped aggregates, global sorts and equi-joins onto the "
    "mesh exchange (exec/meshexec.py: ici_lower), each fragment keeping "
    "its single-device operator as the host-path fallback; otherwise "
    "the host path stays, as in the JAX package.", str,
    _one_of("host", "ici"))

MESH_DEVICES = register(
    "spark.rapids.sql.mesh.devices", 0,
    "Width of the device mesh.  Above 1, and with a pool at least that "
    "wide, the planner lowers grouped aggregates, global sorts and "
    "equi-joins onto that many shards (exec/meshexec.py: mesh_lower, "
    "the static lowering: no fallback); a narrower pool keeps the "
    "single-device plan, as in the JAX package.", int, _non_negative)

SHUFFLE_ICI_DEVICES = register(
    "spark.rapids.shuffle.ici.devices", 0,
    "Width of the mesh that spark.rapids.shuffle.mode=ici exchanges run "
    "over; 0 = the whole pool, a larger value is capped at the pool.",
    int, _non_negative)

SHUFFLE_ICI_MAX_STAGE_BYTES = register(
    "spark.rapids.shuffle.ici.maxStageBytes", 1 << 30,
    "Estimated input bytes above which a spark.rapids.shuffle.mode=ici "
    "fragment keeps its single-device path (counted iciFallbacks, "
    "reason over_budget); checked at execution against the drained "
    "input.", int, _positive)

SHUFFLE_ICI_SHARDED_SCAN = register(
    "spark.rapids.shuffle.ici.shardedScan.enabled", False,
    "The sharded scan ingest of mesh fragments: queue A8b-2, not in the "
    "port yet.  true raises on a plan that holds a mesh fragment.",
    bool)

OOC_ENABLED = register(
    "spark.rapids.sql.ooc.enabled", False,
    "Out-of-core mesh fragments: queue A8b-2, not in the port yet.  "
    "true raises on a plan that holds a mesh fragment.", bool)

HOST_SHUFFLE_WORKERS = register(
    "spark.rapids.shuffle.workers.count", 0,
    "Worker processes the host shuffle spreads map-side work (scan, the "
    "work below the exchange, hash partitioning) across, each on "
    "torch.device('cpu'); 0 or 1 = in-process execution.  The reduce "
    "side runs in the parent, on the session's device.", int)

SHUFFLE_MAX_METADATA_SIZE = register(
    "spark.rapids.shuffle.maxMetadataSize", 50 * 1024,
    "Largest frame header schema (bytes) a block may carry; a wider one "
    "raises at the write.", int, _positive)

SHUFFLE_MAX_INFLIGHT_BYTES = register(
    "spark.rapids.shuffle.maxBytesInFlight", 1024 * 1024 * 1024,
    "Bytes of fetches in flight at once (each fetch reserves its peer's "
    "stat first; one fetch always fits).", int, _positive)

SHUFFLE_BOUNCE_BUFFER_SIZE = register(
    "spark.rapids.shuffle.bounceBuffers.size", 4 * 1024 * 1024,
    "Chunk size of the Python transport's payload reads.", int, _positive)

SHUFFLE_BOUNCE_BUFFER_COUNT = register(
    "spark.rapids.shuffle.bounceBuffers.count", 8,
    "Payload reads the Python transport stages at once.", int, _positive)

SHUFFLE_COMPRESSION_CODEC = register(
    "spark.rapids.shuffle.compression.codec", "zstd",
    "Codec of shuffle blocks: none, lz4 or zstd.  Frames say their "
    "codec; lz4 is zstd, and zstd is none where the zstandard module is "
    "missing (the card's machine has none).", str,
    _one_of("none", "lz4", "zstd"))

SHUFFLE_CONNECT_TIMEOUT = register(
    "spark.rapids.shuffle.timeout.connect", 5.0,
    "Seconds a client waits for a TCP connect to a peer.", float,
    _positive)

SHUFFLE_READ_TIMEOUT = register(
    "spark.rapids.shuffle.timeout.read", 30.0,
    "Seconds a client (and a server mid-frame) waits for the next "
    "bytes before it takes the peer for dead.", float, _positive)

SHUFFLE_FETCH_RETRIES = register(
    "spark.rapids.shuffle.fetch.retries", 3,
    "Retries of a failed peer operation before it surfaces as "
    "FetchFailedError.", int, _non_negative)

SHUFFLE_RETRY_BACKOFF_BASE = register(
    "spark.rapids.shuffle.retry.backoff.base", 0.05,
    "Base delay (s) of the backoff between retries (attempt k sleeps "
    "about base x 2^k, capped and jittered).", float, _positive)

SHUFFLE_RETRY_BACKOFF_CAP = register(
    "spark.rapids.shuffle.retry.backoff.cap", 2.0,
    "Longest single backoff delay (s).", float, _positive)

SHUFFLE_RETRY_BACKOFF_JITTER = register(
    "spark.rapids.shuffle.retry.backoff.jitter", 0.2,
    "Jitter fraction: each delay is scaled by a uniform factor in "
    "[1 - jitter, 1].", float, _fraction_inclusive)

SHUFFLE_CHECKSUM = register(
    "spark.rapids.shuffle.checksum", "crc32c",
    "Checksum stamped on blocks and verified at decode: crc32c, crc32 or "
    "off; crc32c is zlib's crc32 where google-crc32c is missing.  A "
    "mismatch refetches the block.", str, _one_of("crc32c", "crc32", "off"))

SHUFFLE_CORRUPT_REFETCHES = register(
    "spark.rapids.shuffle.corrupt.refetches", 2,
    "Refetches of a block that failed its checksum or decode before "
    "FetchFailedError.", int, _non_negative)

SHUFFLE_PEER_MAX_FAILURES = register(
    "spark.rapids.shuffle.peer.maxFailures", 3,
    "Consecutive failed fetches from one peer before it is blacklisted "
    "and its fetches fail fast.", int, _positive)

SHUFFLE_RECOMPUTE_ENABLED = register(
    "spark.rapids.shuffle.recompute.enabled", True,
    "Re-run the map work in the parent (on its device) when a map worker "
    "dies or a reduce fetch fails for good, instead of failing the "
    "query.", bool)

SHUFFLE_STAGE_TIMEOUT = register(
    "spark.rapids.shuffle.stage.timeout", 3600.0,
    "Seconds the exchange waits for its map stage.", float, _positive)

WORKER_HEARTBEAT_INTERVAL = register(
    "spark.rapids.shuffle.worker.heartbeat.interval", 0.5,
    "Seconds between a distributed_groupby worker's heartbeats.", float,
    _positive)

WORKER_HEARTBEAT_TIMEOUT = register(
    "spark.rapids.shuffle.worker.heartbeat.timeout", 20.0,
    "Seconds of silence (the process alive) before a worker is taken "
    "for hung, terminated and its stripe reassigned.", float, _positive)

MULTITHREADED_SHUFFLE_THREADS = register(
    "spark.rapids.shuffle.multiThreaded.threads", 4,
    "Threads that fetch reduce partitions at once.", int, _positive)


class TorchConf:
    """Immutable view over a conf dict."""

    def __init__(self, settings: Optional[Dict[str, Any]] = None):
        self._settings = dict(settings or {})
        for key, raw in self._settings.items():
            entry = _REGISTRY.get(key)
            if entry is not None and entry.validator is not None:
                err = entry.validator(entry.convert(raw))
                if err:
                    raise ValueError(f"{key}: {err} (got {raw!r})")

    def get(self, entry: ConfEntry) -> Any:
        raw = self._settings.get(entry.key)
        return entry.default if raw is None else entry.convert(raw)

    def is_expression_enabled(self, name: str, incompat: bool) -> bool:
        """The JAX package's rule: ``spark.rapids.sql.expression.<name>``
        when set, else incompatibleOps for an incompatible expression."""
        raw = self._settings.get(f"spark.rapids.sql.expression.{name}")
        if raw is not None:
            return str(raw).strip().lower() in ("true", "1", "yes")
        return self.get(INCOMPATIBLE_OPS) if incompat else True

    def set(self, key: str, value: Any) -> "TorchConf":
        return TorchConf({**self._settings, key: value})

    def with_settings(self, settings: Dict[str, Any]) -> "TorchConf":
        return TorchConf({**self._settings, **settings})

    def to_dict(self) -> Dict[str, Any]:
        return dict(self._settings)

    @property
    def aqe_initial_partitions(self) -> int:
        """Partitions of an AQE-inserted exchange:
        ``spark.rapids.shuffle.defaultNumPartitions`` when set, else
        ``spark.sql.shuffle.partitions``."""
        n = self.get(SHUFFLE_DEFAULT_NUM_PARTITIONS)
        return n if n > 0 else self.get(SHUFFLE_PARTITIONS)

    @property
    def placement_mode(self) -> str:
        return str(self.get(PLACEMENT_MODE)).strip().lower()

    @property
    def concurrent_tasks(self) -> int:
        """The semaphore's permits: the legacy
        ``spark.rapids.sql.concurrentTpuTasks`` when positive, else
        ``spark.rapids.tpu.concurrentTasks`` (the JAX package's rule)."""
        legacy = self.get(CONCURRENT_TPU_TASKS)
        return legacy if legacy > 0 else self.get(CONCURRENT_TASKS)

    def get_bool(self, key: str, default: bool = True) -> bool:
        """A raw key as a boolean, ``default`` when it is unset."""
        raw = self._settings.get(key)
        if raw is None:
            return default
        if isinstance(raw, bool):
            return raw
        return str(raw).strip().lower() in ("true", "1", "yes")
