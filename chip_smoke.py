#!/usr/bin/env python3
"""Drive the torch port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device: the card's name, ``nvidia-smi``'s name and power limit, and
   the torch and CUDA versions;
2. build: every hand-written kernel of the port, compiled from
   ``spark_rapids_tpu_torch/csrc`` with nvcc, with its seconds;
3. kernel: the dense-slot kernel against its plain PyTorch version on
   the same card tensors: first on the inputs the main path gives it
   (the aggregate's own plane construction on the first 2^20-row update
   batch of hash_agg_sort_2m: K = 1024, eight planes), then on a spec
   with an int64 sum, a f64 min with NaN flags, nulls, all-null groups
   and rows whose slot lies outside [0, K).  Integer and min/max planes
   must match exactly, f64 sums within 1e-12 of each slot's sum of |v|.
   Each time is the median of 20 samples of 20 calls back to back
   between one pair of CUDA events:
   ``ms`` repeats only the kernel's launches (its host work done once),
   ``wrapper_ms`` the whole wrapper; ``device_us`` is each CUDA
   kernel's device time from torch.profiler;
4. project_filter_1m and 5. hash_agg_sort_2m: ``bench.py``'s two
   headline queries through the port's session at 1,000,000 and
   2,000,000 rows of ``bench.py:gen_data``'s columns (seed 7), checked
   against numpy; rows/s is over a whole query, upload and result
   included, median of 3 runs after one warm-up;
6. hash_agg_32m: the same aggregate at 32,000,000 rows (31 batches of
   2^20 rows, about 640 MB of columns on the card), checked the same way.

The launch counts are reset just before phase 4 and read after phase 6,
so they show that the main path went through each kernel.  Then one JSON
line lists every kernel, the ``nvidia-smi`` line follows, and the last
line is ``{"ok": true, "device": {...}}``.  Any failed check raises, and
the script exits nonzero without that line; it also exits nonzero when
no card is usable or the port's package is not beside it.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

SEED = 7
# device memory rates from NVIDIA's data sheets, bytes/s
_MEM_RATE = (("H200", 4.8e12), ("H100 PCIE", 2.0e12), ("H100 NVL", 3.9e12),
             ("H100", 3.35e12))
_F32_RATE = 67e12  # H100 SXM float32 outside the tensor cores, op/s


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def mem_rate(name: str) -> float:
    upper = name.upper()
    for key, rate in _MEM_RATE:
        if key in upper:
            return rate
    raise RuntimeError(f"no memory rate on record for {name!r}")


def per_call_ms(torch, fn, calls: int = 20, samples: int = 20,
                warm: int = 5) -> float:
    """Milliseconds a call of ``fn``: ``calls`` calls back to back between
    one pair of CUDA events, so the card's queue stays full when a call's
    host work is shorter than its device work; median of ``samples``."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return float(np.median(times))


def device_us(torch, fn, prefix: str, calls: int = 20):
    """Mean device microseconds of each CUDA kernel whose name starts with
    ``prefix`` over ``calls`` calls of ``fn``, read with torch.profiler;
    None when the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        total = getattr(e, "device_time_total", None)
        if total is None:
            total = getattr(e, "cuda_time_total", 0)
        if e.key.startswith(prefix) and total > 0:
            out[e.key] = total / e.count
    return out or None


def group_stats(k: np.ndarray, v: np.ndarray, w: np.ndarray):
    """numpy reference of group_by(k).agg(count(v), sum(v), max(w))."""
    order = np.argsort(k, kind="stable")
    ks = k[order]
    starts = np.flatnonzero(np.r_[True, ks[1:] != ks[:-1]])
    keys = ks[starts]
    counts = np.diff(np.r_[starts, len(ks)])
    sums = np.add.reduceat(v[order], starts)
    maxes = np.maximum.reduceat(w[order], starts)
    return keys, counts, sums, maxes


# -- phase 3 ---------------------------------------------------------------

def agg_query(st, F, df):
    """hash_agg_sort_2m's query."""
    col = st.col
    return (df.group_by(col("k"))
              .agg(F.count(col("v")).alias("cnt"), F.sum(col("v")).alias("s"),
                   F.max(col("w")).alias("mx"))
              .order_by(col("k")))


def main_path_inputs(st, F, pag, session, data):
    """What the main path gives the kernel: the aggregate's own plane
    construction on the first update batch of hash_agg_sort_2m's query
    -> (gid, planes, ops, K)."""
    from spark_rapids_tpu_torch.exec.base import ExecContext
    from spark_rapids_tpu_torch.exprs.base import ColVal
    from spark_rapids_tpu_torch.plan.planner import plan_query
    root = plan_query(agg_query(st, F, session.create_dataframe(data)).plan)
    agg = root.children[0]
    check(type(agg).__name__ == "TorchHashAggregateExec", "plan shape")
    batch = next(agg.children[0].execute(
        ExecContext(session.conf, session.device)))
    cols = [ColVal(c.data, c.validity) for c in batch.columns]
    lo, hi = pag.key_range(agg.spec.groupings[0], cols, batch.num_rows,
                           batch.capacity)
    K = pag.slot_count(lo, hi)
    gid, planes, ops, _ = pag.update_planes(agg.spec, cols, batch.num_rows,
                                            batch.capacity, lo, K)
    return gid, planes, ops, K


def wide_inputs(torch, rng, K: int):
    """A spec with an int64 sum, a f64 min with NaN flags, nulls,
    all-null groups and rows outside [0, K), which both versions ignore
    -> (gid, planes, ops, K)."""
    cap = 1 << 20
    keys = rng.integers(0, 600, cap)
    null_key = rng.random(cap) < 0.1
    gid = np.where(null_key, 0, keys + 1).astype(np.int32)
    gid[rng.random(cap) < 0.01] = -1
    gid[rng.random(cap) < 0.01] = K + 3
    valid = (rng.random(cap) < 0.9) & ~((keys >= 100) & (keys < 110))
    big = rng.integers(-(1 << 62), 1 << 62, cap, dtype=np.int64)
    f = rng.normal(size=cap)
    f[rng.random(cap) < 0.05] = np.nan
    nan = np.isnan(f)
    planes = [np.ones(cap, np.int32), np.where(valid, big, 0),
              np.where(valid & ~nan, f, np.inf),
              (valid & nan).astype(np.int32),
              (valid & ~nan).astype(np.int32), valid.astype(np.int32)]
    return (torch.from_numpy(gid).cuda(),
            [torch.from_numpy(np.ascontiguousarray(p)).cuda()
             for p in planes],
            ["add", "add", "min", "max", "max", "add"], K)


def compare_kernel(torch, pag, gid, planes, ops, K: int) -> float:
    got = pag.dense_slot_reduce(gid, planes, ops, K)
    torch.cuda.synchronize()
    want = pag.dense_slot_reduce_reference(gid, planes, ops, K)
    worst = 0.0
    for j, (p, op, g, w) in enumerate(zip(planes, ops, got, want)):
        if p.dtype == torch.float64 and op == "add":
            scale = pag.dense_slot_reduce_reference(gid, [p.abs()], ["add"],
                                                    K)[0]
            err = (g - w).abs()
            check(bool(torch.all(err <= 1e-12 * scale)),
                  f"plane {j} ({p.dtype} {op}): f64 sum off by more than "
                  "1e-12 of the slot's sum of |v|")
            worst = max(worst, float(err.max()))
        else:
            same = (g == w) | (torch.isnan(g) & torch.isnan(w)) \
                if p.dtype.is_floating_point else g == w
            check(bool(torch.all(same)),
                  f"plane {j} ({p.dtype} {op}) differs from the plain version")
    return worst


def phase_kernel(torch, st, F, pag, session, data, rate: float) -> dict:
    gid, planes, ops, K = main_path_inputs(st, F, pag, session, data)
    wide = wide_inputs(torch, np.random.default_rng(SEED), 1024)
    errs = [compare_kernel(torch, pag, *spec)
            for spec in ((gid, planes, ops, K), wide)]

    idx = gid.to(torch.int64)
    outs = [torch.empty(K, dtype=p.dtype, device="cuda") for p in planes]
    reduce = {"add": "sum", "min": "amin", "max": "amax"}

    def library():
        for o, p, op in zip(outs, planes, ops):
            o.scatter_reduce_(0, idx, p, reduce=reduce[op])

    # the kernel's own time: its host work (checks, allocations, C
    # arguments) is done once, then only the launches repeat
    launch, _ = pag.prepare_launch(gid, planes, ops, K)
    n = gid.numel()
    # each input read once, each (K,) output written once
    nbytes = gid.element_size() * n + sum(
        p.element_size() * (n + K) for p in planes)
    bytes_ms = nbytes / rate * 1e3
    ops_ms = n * len(planes) / _F32_RATE * 1e3
    result = {
        "ms": per_call_ms(torch, launch),
        "wrapper_ms": per_call_ms(torch, lambda: pag.dense_slot_reduce(
            gid, planes, ops, K)),
        "plain_ms": per_call_ms(torch, lambda: pag.dense_slot_reduce_reference(
            gid, planes, ops, K)),
        "library_ms": per_call_ms(torch, library),
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "max_abs_err": max(errs),
    }
    emit("kernel", name="dense_slot_reduce", capacity=n, K=K,
         planes=[f"{str(p.dtype)[6:]} {op}" for p, op in zip(planes, ops)],
         bytes=nbytes, device_us=device_us(torch, launch, "dsr_"),
         **result)
    return result


# -- phases 4 to 6 ---------------------------------------------------------

def gen_data(n_main: int, n_agg: int):
    """bench.py:gen_data's main and main4 columns, from seed 7."""
    rng = np.random.default_rng(SEED)
    main = {"k": rng.integers(0, 1000, n_main), "v": rng.normal(size=n_main),
            "w": rng.normal(size=n_main).astype(np.float32)}
    agg = {"k": rng.integers(0, 1000, n_agg), "v": rng.normal(size=n_agg),
           "w": rng.normal(size=n_agg).astype(np.float32)}
    return main, agg


def run_timed(torch, query, runs: int):
    """Warm up once, then time ``runs`` whole queries; -> (result,
    seconds of each timed run)."""
    out = query.to_torch()
    torch.cuda.synchronize()
    secs = []
    for _ in range(runs):
        t0 = time.perf_counter()
        out = query.to_torch()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    return out, secs


def phase_project_filter(torch, st, session, data) -> None:
    col = st.col
    df = session.create_dataframe(data)
    q = (df.filter((col("v") > 0.0) & (col("k") < 900))
           .select((col("v") * 2.0 + 1.0).alias("a"),
                   (col("v") + col("w")).alias("b"), col("k")))
    (cols, masks, n), secs = run_timed(torch, q, 3)
    k, v, w = data["k"], data["v"], data["w"]
    keep = (v > 0.0) & (k < 900)
    check(n == int(keep.sum()), f"row count {n} != {int(keep.sum())}")
    check(all(bool(m.all()) for m in masks.values()), "unexpected nulls")
    check(np.array_equal(cols["a"].cpu().numpy(), v[keep] * 2.0 + 1.0), "a")
    check(np.array_equal(cols["b"].cpu().numpy(),
                         v[keep] + w[keep].astype(np.float64)), "b")
    check(np.array_equal(cols["k"].cpu().numpy(), k[keep]), "k")
    rows = len(k)
    emit("project_filter_1m", rows=rows, out_rows=n,
         seconds=secs, rows_per_s=rows / float(np.median(secs)))


def phase_agg(torch, st, F, native, session, data, name: str,
              runs: int) -> None:
    q = agg_query(st, F, session.create_dataframe(data))
    before = native.LAUNCHES["dense_slot_reduce"]
    (cols, masks, n), secs = run_timed(torch, q, runs)
    launches = native.LAUNCHES["dense_slot_reduce"] - before
    agg = session._last_plan.children[0]
    check(type(agg).__name__ == "TorchHashAggregateExec", "plan shape")
    dense = agg.metrics["pallasAggBatches"]
    check(dense > 0, "no update batch took the dense-slot kernel")
    # one launch per update batch (the eight planes fit one plane group),
    # over the warm-up run and the timed runs
    check(launches == dense * (runs + 1),
          f"{launches} kernel launches for {dense} dense batches a run")
    keys, counts, sums, maxes = group_stats(data["k"], data["v"],
                                            data["w"])
    check(n == len(keys), f"{n} groups, numpy has {len(keys)}")
    check(np.array_equal(cols["k"].cpu().numpy(), keys), "keys")
    check(np.array_equal(cols["cnt"].cpu().numpy(), counts), "counts")
    check(np.array_equal(cols["mx"].cpu().numpy(), maxes), "max")
    check(np.allclose(cols["s"].cpu().numpy(), sums, rtol=1e-9, atol=0),
          "sums beyond rtol 1e-9")
    rows = len(data["k"])
    emit(name, rows=rows, groups=n, update_batches=dense,
         kernel_launches=launches, host_syncs_per_run=agg.metrics[
             "hostSyncs"], seconds=secs,
         rows_per_s=rows / float(np.median(secs)))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check "
              "runs on an NVIDIA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import spark_rapids_tpu_torch as st
    from spark_rapids_tpu_torch import functions as F
    from spark_rapids_tpu_torch import native
    from spark_rapids_tpu_torch.exec import pallas_agg as pag

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    emit("device", kind=name, nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, count=torch.cuda.device_count())
    rate = mem_rate(name)

    t0 = time.perf_counter()
    reports = {k: native.build(k) for k in native.KERNELS}
    emit("build", seconds=time.perf_counter() - t0,
         ptxas={k: [ln.strip() for ln in r.splitlines()
                    if "registers" in ln or "smem" in ln]
                for k, r in reports.items()})

    main_data, agg_data = gen_data(1_000_000, 2_000_000)
    session = st.TorchSession.builder().get_or_create()
    kern = phase_kernel(torch, st, F, pag, session, agg_data, rate)

    native.reset_launches()
    phase_project_filter(torch, st, session, main_data)
    phase_agg(torch, st, F, native, session, agg_data, "hash_agg_sort_2m", 3)
    rng = np.random.default_rng(SEED + 1)
    n = 32_000_000
    big = {"k": rng.integers(0, 1000, n), "v": rng.normal(size=n),
           "w": rng.normal(size=n).astype(np.float32)}
    phase_agg(torch, st, F, native, session, big, "hash_agg_32m", 1)
    launches = dict(native.LAUNCHES)
    check(all(v > 0 for v in launches.values()),
          f"a kernel of the main path never launched: {launches}")

    kernels = []
    for kname, info in native.KERNELS.items():
        kernels.append({
            "name": kname, "route": "cuda",
            "source": "spark_rapids_tpu_torch/" + info["source"],
            "replaces": info["replaces"], "launches": launches[kname],
            "max_abs_err": kern["max_abs_err"], "ms": kern["ms"],
            "plain_ms": kern["plain_ms"], "bound_ms": kern["bound_ms"],
            "bound_by": kern["bound_by"], "library_ms": kern["library_ms"],
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
