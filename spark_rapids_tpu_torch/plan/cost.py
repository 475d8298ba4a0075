"""The measured cost model of fragment placement.

Counterpart of ``spark_rapids_tpu/plan/cost.py``, the numbers half of
the placement pass (``plan/placement.py``).  Three inputs:

* **Link constants**: the card's host-to-card and card-to-host rates and
  the fixed latency of one pull.  ``probe_link()`` measures them once a
  process: a 4 MiB upload through ``columnar/transfer.py``'s pinned
  ``Upload``, its pull back through ``device_pull`` and a one-element
  pull, each between ``torch.cuda.synchronize`` calls.  The
  ``spark.rapids.sql.placement.{h2dMBps,d2hMBps,pullLatencyMs}`` keys
  override the probe, which is what pins decisions in tests.  On one
  card ``effective_link_constants`` is ``link_constants``: the
  aggregate rates of a mesh (``probe_link_aggregate``,
  ``aggregate_link_constants``) come with the multi-card slice
  (``ROADMAP.md``, queue A8).
* **Per-operator-class throughput**: a ``CalibrationStore`` of EWMA
  rows/s per (engine, operator class) learned from executed plans,
  persisted as ``calibration.json`` beside the compile store when one
  is installed (``compile/store.py``).  The engine keys are the JAX
  package's: ``tpu`` is the card, ``cpu`` the port's own operators
  over host tensors, so the two packages' files compare field for
  field.  The ``spark.rapids.sql.placement.{cpu,tpu}RowsPerSec`` priors
  seed classes not yet measured.
* **Expected compile cost**: read from the compile store's counters.
  The port compiles no stage; its one compile is ``native.py``'s nvcc
  build, so this is zero without a store or on an expected hit, else
  the average nvcc build's milliseconds scaled by the store's miss
  ratio (the in-process library loads in its denominator).

``score_ops`` combines them as the JAX package does:

    tpu_ms = bytes_in / h2d_bw + pull_latency + bytes_out / d2h_bw
             + sum(rows / tpu_rate(op)) + compile
    cpu_ms = sum(rows / cpu_rate(op))

The out-of-core terms of the JAX formula engage only inside a mesh
(``ooc_budget`` is 0 until queue A8), so they never appear here.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Dict, List, Optional

import numpy as np

log = logging.getLogger("spark_rapids_tpu_torch.plan.cost")

# ---------------------------------------------------------------------------
# link constants: the one-shot probe and the conf overrides
# ---------------------------------------------------------------------------

_PROBE_LOCK = threading.Lock()
_PROBE: Optional[dict] = None
_PROBE_BYTES = 1 << 22


def _probe_device(device=None):
    import torch
    if device is not None:
        return torch.device(device)
    if torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def probe_link(device=None) -> dict:
    """Measure the host-to-card and card-to-host rates and the fixed
    latency of one pull, once a process, through the port's own
    transfer seams (``Upload``, ``device_pull``, so the probe's pulls
    are counted like any other).  Each transfer runs once untimed at
    its own size first: a first pinned buffer of a size costs a
    ``cudaHostAlloc``, which torch's host allocator then keeps, so a
    cold probe charges the link with an allocation the queries after
    it do not pay.  ``device``: the card (default the
    current CUDA device, else the CPU, where the numbers mean
    nothing)."""
    global _PROBE
    with _PROBE_LOCK:
        if _PROBE is not None:
            return dict(_PROBE)
        import torch

        from spark_rapids_tpu_torch.columnar.transfer import Upload, \
            await_event, device_pull
        dev = _probe_device(device)

        def sync():
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

        def upload(values):
            up = Upload(dev)
            out = up.plane(values)
            await_event(up.finish())
            return out

        h = np.random.default_rng(0).integers(
            0, 255, _PROBE_BYTES).astype(np.uint8)
        d = upload(h)  # warm: the pinned buffers of this size
        y = d + 1
        z = torch.zeros(8, dtype=torch.uint8, device=dev) + 1
        device_pull(y)
        device_pull(z)
        sync()
        t0 = time.perf_counter()
        d = upload(h)
        sync()
        out = {"h2d_mbps": round(
            _PROBE_BYTES / (time.perf_counter() - t0) / 1e6, 1)}
        y = d + 1
        sync()
        t0 = time.perf_counter()
        device_pull(y)
        out["d2h_mbps"] = round(
            _PROBE_BYTES / (time.perf_counter() - t0) / 1e6, 1)
        sync()
        t0 = time.perf_counter()
        device_pull(z)
        out["d2h_latency_ms"] = round((time.perf_counter() - t0) * 1e3, 3)
        _PROBE = out
        return dict(out)


def effective_link_constants(conf) -> dict:
    """The constants ``place_fragments`` and ``aqe_rescore`` score with:
    ``link_constants``.  The JAX package widens them to a mesh's
    aggregate rates when its fragments ingest sharded
    (``mesh_ingest_qualified``), which no session on one card does
    (queue A8)."""
    return link_constants(conf)


def link_constants(conf) -> dict:
    """The link constants transfers are charged with: the
    ``spark.rapids.sql.placement.{h2dMBps,d2hMBps,pullLatencyMs}`` keys
    where set, the one-shot probe for whatever is left."""
    from spark_rapids_tpu_torch.conf import PLACEMENT_D2H_MBPS, \
        PLACEMENT_H2D_MBPS, PLACEMENT_PULL_LATENCY_MS
    h2d = float(conf.get(PLACEMENT_H2D_MBPS))
    d2h = float(conf.get(PLACEMENT_D2H_MBPS))
    lat = float(conf.get(PLACEMENT_PULL_LATENCY_MS))
    probed = False
    if h2d <= 0 or d2h <= 0 or lat < 0:
        probe = probe_link()
        probed = True
        if h2d <= 0:
            h2d = probe["h2d_mbps"]
        if d2h <= 0:
            d2h = probe["d2h_mbps"]
        if lat < 0:
            lat = probe["d2h_latency_ms"]
    return {"h2d_mbps": h2d, "d2h_mbps": d2h, "pull_latency_ms": lat,
            "probed": probed}


def startup_probe(conf, device=None) -> None:
    """At runtime start: with ``placement.mode=cost`` on a card and a
    link constant left to measure, pay the probe now, not in the first
    query's planning.  Never raises."""
    try:
        if conf.placement_mode != "cost" or device is None \
                or device.type != "cuda":
            return
        with _PROBE_LOCK:
            if _PROBE is not None:
                return
        link_constants(conf)
    except Exception as e:
        log.warning("placement link probe failed (it runs again at the "
                    "first scoring): %s", e)


# ---------------------------------------------------------------------------
# calibration: EWMA rows/s per (engine, operator class)
# ---------------------------------------------------------------------------

_CAL_ALPHA = 0.3
_CAL_FILE = "calibration.json"

# the process-wide placement mode.  The JAX package sets it at every
# ExecContext so that its CPU operators count rows only while it is not
# "tpu"; the port's operators always count (exec/base.py: _checked) and
# the calibration feed reads the query's conf (api.py), so no port code
# sets it: the pair keeps the JAX names for callers of the module
_MODE = "tpu"


def set_mode(mode: str) -> None:
    """Process-wide, like every switch set at an execution entry:
    sessions of different placement modes in one process are not
    supported, and a server's tenants share one session's conf."""
    global _MODE
    _MODE = mode


def calibration_active() -> bool:
    return _MODE != "tpu"


class CalibrationStore:
    """Measured throughput per (engine, operator class): an EWMA of the
    rows/s executed plans showed, persisted beside the compile store
    when one is installed."""

    def __init__(self):
        self._lock = threading.Lock()
        self._rates: Dict[str, float] = {}   # "engine:class" -> rows/s
        self._counts: Dict[str, int] = {}
        self._loaded_dir: Optional[str] = None
        self._dirty = False

    def observe(self, engine: str, op_class: str, rows: int,
                seconds: float) -> None:
        if rows <= 0 or seconds <= 1e-7:
            return
        key = f"{engine}:{op_class}"
        rate = rows / seconds
        with self._lock:
            prev = self._rates.get(key)
            self._rates[key] = rate if prev is None else \
                _CAL_ALPHA * rate + (1 - _CAL_ALPHA) * prev
            self._counts[key] = self._counts.get(key, 0) + 1
            self._dirty = True

    def rate(self, engine: str, op_class: str, default: float) -> float:
        with self._lock:
            return self._rates.get(f"{engine}:{op_class}", default)

    def snapshot(self) -> Dict[str, dict]:
        with self._lock:
            return {k: {"rows_per_sec": round(r, 1),
                        "observations": self._counts.get(k, 0)}
                    for k, r in sorted(self._rates.items())}

    # every failure to read or write the file leaves the priors and the
    # in-process rates standing, never a query

    def load(self, root: str) -> None:
        path = os.path.join(root, _CAL_FILE)
        try:
            with open(path, encoding="utf-8") as fh:
                raw = json.load(fh)
            with self._lock:
                for key, ent in raw.items():
                    if key not in self._rates:
                        self._rates[key] = float(ent["rate"])
                        self._counts[key] = int(ent.get("n", 1))
                self._loaded_dir = root
        except FileNotFoundError:
            with self._lock:
                self._loaded_dir = root
        except (OSError, ValueError, KeyError, TypeError) as e:
            log.warning("cannot read calibration store %s (priors "
                        "stand): %s", path, e)
            with self._lock:
                self._loaded_dir = root

    def save(self, root: str) -> None:
        path = os.path.join(root, _CAL_FILE)
        tmp = path + f".tmp{os.getpid()}"
        with self._lock:
            if not self._dirty:
                return
            payload = {k: {"rate": round(r, 3),
                           "n": self._counts.get(k, 1)}
                       for k, r in self._rates.items()}
            self._dirty = False
        try:
            with open(tmp, "w", encoding="utf-8") as fh:
                json.dump(payload, fh, separators=(",", ":"))
            os.replace(tmp, path)  # atomic for concurrent readers
        except OSError as e:
            log.warning("calibration save failed (rates stay in this "
                        "process): %s", e)


_CAL = CalibrationStore()


def calibration() -> CalibrationStore:
    """The process-wide calibration store, loaded from the compile
    store's directory when one is installed."""
    from spark_rapids_tpu_torch.compile import store as compile_store
    st = compile_store.current()
    if st is not None and _CAL._loaded_dir != st.root:
        _CAL.load(st.root)
    return _CAL


def reset() -> None:
    """Forget the learned rates, the probe and the mode (tests)."""
    global _CAL, _PROBE, _MODE
    _CAL = CalibrationStore()
    with _PROBE_LOCK:
        _PROBE = None
    _MODE = "tpu"


# ---------------------------------------------------------------------------
# operator classes and sizes
# ---------------------------------------------------------------------------

def op_class(name: str) -> str:
    """Engine-neutral class key: ``TorchProjectExec``, ``TpuProjectExec``
    and ``CpuProjectExec`` all score as ``project``."""
    for pre in ("Torch", "Tpu", "Cpu"):
        if name.startswith(pre):
            name = name[len(pre):]
            break
    if name.endswith("Exec"):
        name = name[:-4]
    return name.lower()


# logical node -> the class its operators calibrate under
LOGICAL_CLASS = {
    "Project": "project", "Filter": "filter", "Union": "union",
    "Limit": "locallimit", "LocalRelation": "localscan",
    "ParquetRelation": "parquetscan", "CsvRelation": "csvscan",
    "OrcRelation": "orcscan", "Range": "range", "Sort": "sort",
    "Aggregate": "hashaggregate", "Join": "hashjoin",
    "Repartition": "shuffleexchange", "Window": "window",
    "Expand": "expand", "Generate": "generate",
}

# expression modules whose kernels score under the string classes
# (``project_str``, ``filter_str``): a char-matrix kernel's rows/s is
# nothing like an arithmetic projection's
_STRING_EXPR_MODULES = ("exprs.strings", "exprs.pallas_strings")


def _has_string_kernel(exprs) -> bool:
    stack = list(exprs or ())
    while stack:
        e = stack.pop()
        mod = type(e).__module__ or ""
        if mod.endswith(_STRING_EXPR_MODULES):
            return True
        stack.extend(getattr(e, "children", ()) or ())
    return False


def step_class(kind: str, exprs) -> str:
    """The class of one stage step (or one project/filter given its
    expressions): ``project_str``/``filter_str`` where the expressions
    hold a string kernel.  The scorer and the calibration feed both use
    it, so a fragment is scored under the class its run measures."""
    if kind in ("project", "filter") and _has_string_kernel(exprs):
        return kind + "_str"
    return kind


def estimate_batch_size_bytes(schema, num_rows: int,
                              avg_string_len: int = 32) -> int:
    """Planning bytes of a batch (the JAX package's
    ``columnar/batch.py: estimate_batch_size_bytes``): a string 32 bytes
    and a length and a validity byte, any other type its width and a
    validity byte."""
    from spark_rapids_tpu_torch.columnar.dtypes import STRING
    total = 0
    for f in schema:
        if f.dtype == STRING:
            total += num_rows * (avg_string_len + 4 + 1)
        else:
            width = np.dtype(f.dtype.numpy_dtype).itemsize \
                if f.dtype.numpy_dtype else 0
            total += num_rows * (width + 1)
    return total


def schema_row_width(schema) -> int:
    """Estimated bytes a row, the rows <-> bytes bridge for sizes that
    arrive in bytes (file sizes)."""
    return max(1, estimate_batch_size_bytes(schema, 1))


def expected_compile_ms() -> float:
    """Expected build cost of a fresh fragment: zero without a compile
    store or with no miss, else the average nvcc build's ms scaled by
    the store's miss ratio, whose denominator counts the libraries this
    process already held (those loads never reach the store)."""
    from spark_rapids_tpu_torch import native
    from spark_rapids_tpu_torch.compile import service, store
    st = store.current()
    if st is None:
        return 0.0
    s = st.stats()
    total = s["hits"] + s["misses"] + native.load_stats()["memo_hits"]
    if total == 0 or s["misses"] == 0:
        return 0.0
    avg_cold = service.service_stats()["cold_ms"] / max(1, s["misses"])
    return avg_cold * (s["misses"] / total)


# ---------------------------------------------------------------------------
# scoring
# ---------------------------------------------------------------------------

# the result egress's pull group (exec/basic.py: EGRESS_GROUP_BYTES)
_PACK_GROUP_BYTES = 256 << 20


def score_ops(op_classes: List[str], rows: int, bytes_in: int,
              bytes_out: int, conf, consts: dict,
              calib: CalibrationStore,
              compile_ms: float = 0.0,
              ooc_budget: int = 0) -> dict:
    """Score one fragment both ways and pick the engine, with the JAX
    package's formula and decision record (the ``fragment_placed``
    journal line): the engine, both projections, and the deciding term
    (the largest card term when the host wins, ``cpu_compute`` when the
    card keeps it).  The static pass gives estimated sizes, the
    adaptive re-score measured ones."""
    from spark_rapids_tpu_torch.conf import PLACEMENT_CPU_ROWS_PER_SEC, \
        PLACEMENT_TPU_ROWS_PER_SEC
    cpu_prior = float(conf.get(PLACEMENT_CPU_ROWS_PER_SEC))
    tpu_prior = float(conf.get(PLACEMENT_TPU_ROWS_PER_SEC))

    def bw_ms(nbytes: int, mbps: float) -> float:
        return nbytes / (mbps * 1000.0) if mbps > 0 else 0.0

    pulls = 1 + int(bytes_out // _PACK_GROUP_BYTES)
    terms = {
        "h2d": bw_ms(bytes_in, consts["h2d_mbps"]),
        # once: the pull groups are pipelined, so only the first pull's
        # round trip shows (pulls stays in the record)
        "pull_latency": consts["pull_latency_ms"],
        "d2h": bw_ms(bytes_out, consts["d2h_mbps"]),
        "tpu_kernel": sum(
            rows / max(1.0, calib.rate("tpu", c, tpu_prior))
            for c in op_classes) * 1e3,
        "compile": compile_ms,
    }
    if ooc_budget > 0 and bytes_in > ooc_budget:
        # the out-of-core legs: every input byte down and back up once
        terms["ooc_spill"] = bw_ms(bytes_in, consts["d2h_mbps"])
        terms["ooc_promote"] = bw_ms(bytes_in, consts["h2d_mbps"])
    tpu_ms = sum(terms.values())
    cpu_ms = sum(rows / max(1.0, calib.rate("cpu", c, cpu_prior))
                 for c in op_classes) * 1e3
    if cpu_ms < tpu_ms:
        engine = "cpu"
        deciding = max(terms, key=terms.get)
    else:
        engine = "tpu"
        deciding = "cpu_compute"
    return {"engine": engine,
            "tpu_ms": round(tpu_ms, 3), "cpu_ms": round(cpu_ms, 3),
            "deciding": deciding, "rows": int(rows),
            "bytes_in": int(bytes_in), "bytes_out": int(bytes_out),
            "pulls": pulls,
            "terms": {k: round(v, 3) for k, v in terms.items()}}


# ---------------------------------------------------------------------------
# the calibration feed
# ---------------------------------------------------------------------------

def observe_plan(physical) -> None:
    """Feed an executed plan's per-operator throughput into the
    calibration store.  Each operator's ``totalTime`` is host wall of
    its pulls, its children's included (``exec/base.py``), so its own
    time is that less its children's, on either engine (the JAX
    package's device operators time themselves alone).  Rates key on
    input rows (the children's output; a leaf's own), the rows
    ``score_ops`` charges; an operator ``on_host`` calibrates the
    ``cpu`` engine, any other ``tpu``.  Never raises."""
    cal = calibration()
    try:
        _observe_node(physical, cal)
    except Exception as e:
        log.warning("placement calibration observe failed (rates "
                    "unchanged): %s", e)
        return
    from spark_rapids_tpu_torch.compile import store as compile_store
    st = compile_store.current()
    if st is not None:
        cal.save(st.root)


def _observe_node(node, cal: CalibrationStore) -> dict:
    snaps = [_observe_node(c, cal) for c in node.children]
    snap = node.metrics.snapshot()
    total_ns = snap.get("totalTime", 0)
    rows = snap.get("numOutputRows", 0)
    in_rows = sum(s.get("numOutputRows", 0) for s in snaps) or rows
    if total_ns and in_rows:
        self_ns = max(0, total_ns - sum(s.get("totalTime", 0)
                                        for s in snaps))
        engine = "cpu" if node.on_host else "tpu"
        steps = getattr(node, "steps", None)
        if steps and len(steps) > 1:
            # a fused stage ran its steps in one pass: each step's class
            # gets an even share of its time
            share = (self_ns / len(steps)) / 1e9
            for kind, exprs in steps:
                cal.observe(engine, step_class(kind, exprs), in_rows,
                            share)
        else:
            cls = op_class(node.node_name)
            exprs = getattr(node, "exprs", None)
            if exprs is None:
                exprs = getattr(node, "projections", None) or \
                    [getattr(node, "condition", None)]
            cls = step_class(cls, [e for e in exprs if e is not None])
            cal.observe(engine, cls, in_rows, self_ns / 1e9)
    return snap
