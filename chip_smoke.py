#!/usr/bin/env python3
"""Drive the torch port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py [--package-root DIR] [--kernels-only]
                          [--sass-dir DIR] [--layer-cost] [--string-paths]

Phases, each printing one JSON line:

1. device: the card's name, ``nvidia-smi``'s name and power limit, and
   the torch and CUDA versions;
2. build: every hand-written kernel of the port, compiled from
   ``spark_rapids_tpu_torch/csrc`` with nvcc, one process a source, all
   started together, with their seconds and ptxas' registers, spills
   and stack; sass: each library's atomic and CAS instructions counted
   by opcode (``cuobjdump -sass``; the listings go to ``--sass-dir``);
3. kernel: the dense-slot kernel against its plain PyTorch version on
   the same card tensors, on the inputs the main path gives it (the
   aggregate's own plane construction on the first 2^20-row update
   batch of hash_agg_sort_2m: K = 1024, eight planes).  Integer and
   min/max planes must match exactly (NaN matching NaN), f64 sums within
   1e-12 of each slot's sum of |v|.  Each warm time is the median of 20
   samples of 20 calls back to back between one pair of CUDA events:
   ``ms`` repeats only the kernel's launches (its host work done once),
   ``wrapper_ms`` the whole wrapper; ``cold_ms`` is the median of 20
   single launches, each after a 134 MB write that evicts the inputs
   from L2; ``device_us`` is each CUDA kernel's device time from
   torch.profiler.  kernel_shapes: the same at other launch shapes.
   kernel_edges: the edge specs (a spec with an int64 sum and NaN flags,
   all rows on one slot, K = 128, plane groups, NaN / signed zeros /
   infinities under float min and max, wrapping int64 sums, gids of -1
   and K + 3, a ragged row count, planes off 16-byte alignment);
   kernel_path: the same comparison, and the warm and plain times, on
   the inputs hash_join_1m gives the kernel (its first update batch: the
   join's output, the slots of grp, three planes);
4. kernel: the contains kernel against its plain version, exactly, on
   the first 2^20-row batch of text_filter_agg_6m's ``l_comment`` from
   the port's own ingest (W = 64, the 16-byte needle), timed the same
   way; kernel_edges: needles at window 0, at the last window and one
   byte past the length, k = 1 to 65 and k = W, repetitive text, widths
   8 to 1024, lengths past W, row counts off the tile, UTF-8 bytes;
5. project_filter_1m and 6. hash_agg_sort_2m: ``bench.py``'s two
   headline queries through the port's session at 1,000,000 and
   2,000,000 rows of ``bench.py:gen_data``'s columns (seed 7), checked
   against numpy; rows/s is over a whole query, upload and result
   included, median of 3 runs after one warm-up;
7. hash_agg_32m: the same aggregate at 32,000,000 rows (31 batches of
   2^20 rows, about 640 MB of columns on the card), checked the same way;
8. text_filter_agg_6m and 9. text_filter_project_6m: a lineitem-shaped
   table of 6,001,215 rows (TPC-H SF1's lineitem count; ``l_comment`` is
   synthetic text of 10 to 43 bytes, 2 % of it holding the phrase
   "special requests") through TPC-H Q1's grouping and aggregates over a
   contains filter with a 16-byte needle (the contains kernel, once a
   batch), and through a 7-byte needle's filter and a projection whose
   strings come back whole; checked against numpy, timed as phase 5
   over 2 runs;
10. hash_join_1m: ``bench.py``'s join query, the 1,000,000-row fact
   table of phase 5 against its 10,000-row dimension (the next draw of
   the seed-7 stream) on ``k``, then ``group_by(grp)`` with a sum: the
   dimension broadcast on the dense FK route, the update through the
   dense-slot kernel; checked against numpy, its launches and host syncs
   counted, timed as phase 5;
11. tpch_q1 to tpch_q18: the bench's six TPC-H queries (q1, q3, q5, q6,
   q10, q18) over ``gen_tpch_numpy(6_001_215)`` (SF1's lineitem count;
   orders 1,500,303, customer 150,030, part 120,024, supplier 60,012,
   partsupp 480,096 rows), each checked against a numpy version of the
   query (keys, counts, dates and strings exact, f64 within rtol 1e-9, a
   top-N's order exact but among revenues tied within that tolerance),
   one warm-up and 2 timed runs, with the host syncs of a run;
12. window_1m: ``bench.py:q_window`` on phase 5's 1,000,000-row table
   (row_number and a running sum of v over partition_by(k).order_by(v),
   then rn <= 5), checked against numpy (a lexsort by (k, v)): the
   5,000 rows and rn exact, each running sum within 1e-10 of the sum of
   |v| over the sorted rows up to it (a prefix sum's n * eps bound at
   2^20 rows); timed as phase 5;
13. tpch_q2 to tpch_q22: the other sixteen TPC-H queries over the same
   tables, each timed as phase 11 and checked against the same query
   through the port on a CPU session over the same tables, run once
   (integers and strings exact, f64 within rtol 1e-9, q11's top-N order
   exact but among values tied within that tolerance); repeat_sums runs
   q15's revenue subquery 5 times on the card, its float sums bit for bit
   alike (q15 keeps the suppliers whose sum equals their maximum);
   kernel_path holds the dense-slot kernel against its plain version on
   the first update batch of q8 (by year) and of q13's outer aggregate
   (by c_count);
14. mortgage_etl: ``bench.py``'s mortgage pipeline (a per-loan aggregate
   of conditional max and min, a left join, ``coalesce``, a rollup by two
   string keys) over ``gen_mortgage_numpy(600_000)`` (bench.py:68's
   size), checked against the same pipeline on a CPU session over the
   same tables, timed as phase 11;
15. tpcxbb_q1 to tpcxbb_q30: the 25 TPCx-BB queries through
   ``session.sql`` over views of ``gen_tpcxbb_numpy(750_000)`` (bench.py:
   69's store_sales rows), the bench's lead queries first, each checked
   against the same SQL on a CPU session over the same tables, timed as
   phase 11 (f64 within rtol 1e-9; rows tied on the float sum that q6,
   q13 and q25 order their top 100 by compare as a set), with the
   candidate pairs the joins laid out a run (q3 and q8 through the
   band-aware probe);
16. breadth: the expressions behind SQL and ``functions``, through
   ``session.sql`` with ``incompatibleOps`` and the cast gates on
   (``BREADTH_CONF``): TPC-H's own text predicates (q9 ``LIKE
   '%green%'``, q13 ``NOT LIKE '%special%requests%'``, q14 ``LIKE
   'PROMO%'``, q16 ``NOT LIKE 'MEDIUM POLISHED%'``, q22's customer side
   with ``substring`` and a CROSS JOIN to its average) over phase 11's
   tables, and over all 6,001,215 lineitem rows, each grouped to a small
   result: case conversion, concat_ws/trim/replace, substring_index,
   regexp_replace and RLIKE on phase 8's ``l_comment``, casts to and from
   strings, a TIMESTAMP column built from l_shipdate and l_orderkey as
   numpy datetime64[us] (hour/minute/second, unix_timestamp, a TIMESTAMP
   literal, ``GROUP BY hour(ts)`` through the dense-slot kernel), math,
   isnan/nanvl/``<=>``, first/last and string min/max by l_orderkey
   (1.5 M groups), and the first 2^20 values of rand(42) and
   monotonically_increasing_id(); each timed as phase 11 and checked
   against a CPU session over the same tables (integers, strings,
   booleans exact; rand and the case and comment queries bit for bit;
   other f64 within rtol 1e-9); kernel_path holds the dense-slot kernel
   on the hour(ts) aggregate's batch;
17. memory: the device runtime, the tiered spill and the out-of-memory
   retry.  memory_tiers: window_1m and tpch_q18 (SF1) on a fresh runtime
   at the default budget, then with the device budget at a quarter of
   the first run's spill-catalog peak and the host tier at an eighth of
   it, so bytes reach the host and the disk; each run checked against
   numpy as phases 11 and 12 check them, the two runs' integers,
   strings and nulls equal (window_1m's running sums bit for bit, as
   they add in a fixed order), the tier counters and both times printed.
   oom_retry: a function whose peak is two (2^20, 512) int64
   temporaries, under a ballast that leaves three quarters of it free:
   ``with_retry`` catches two real ``torch.OutOfMemoryError``s (the whole
   batch, then after relief) and splits; the halves equal the unsplit
   call, the failed attempt's memory is back before the retry, and the
   ballast's after it.  oom_query: hash_agg_32m's aggregate with 2^24-row
   update batches, its first update under a ballast that leaves three
   quarters of that update's peak (measured on a run without it): a
   real error caught, the batch split onto the dense-slot kernel, the
   result equal to the run without it (sums within rtol 1e-9).  inject:
   every retry site (stage, the aggregate on both routes, the FK and
   general join probes, sort, window) raises ``torch.OutOfMemoryError``
   twice where a split follows, once where the input stays whole, and
   each query equals its run without the error (the window's running
   sums bit for bit).  lookahead:
   hash_agg_sort_2m and hash_join_1m with the coalesce's background pull
   on (it is off by default) equal to their default runs, with batches
   pulled on the pull's thread.  memory_threads: no thread of the port's
   is left.  After it, kernel_path also holds the
   dense-slot kernel against its plain version on the first half of
   hash_agg_sort_2m's first update batch (2^19 rows at capacity 2^19),
   as an out-of-memory split hands it over;
18. operators: every logical operator of the JAX package's device
   engine, timed as phase 11 and checked row for row (integers,
   strings, dates and nulls exact, f64 within rtol 1e-9).
   range_agg_linear_keys and range_agg_512: Spark's AggregateBenchmark
   size, ``session.range(20 << 22)`` (83,886,080 ids in 80 batches made
   on the card), grouped by ``id & 65535`` (sum, on the sorted route) and
   by ``id & 511`` (count, sum, avg, through the dense-slot kernel on
   every batch: keys 0 to 1023 and the null slot would need 1025
   slots), both checked exactly against the closed form.  Then over
   phase 11's tables, with what TPC-H defines and ``gen_tpch_numpy``
   leaves out added (``operator_tables``: ``l_linenumber``,
   ``l_shipinstruct``, ``o_totalprice``), each against the same query on
   a CPU session: rollup_q1 (Q1's filter and aggregates over
   ``rollup(l_returnflag, l_linestatus)`` with ``grouping_id()``, three
   grouping sets through Expand), cube_shipmode (``cube(l_shipmode,
   l_linenumber)`` over lineitem, four sets), union_channels (TPC-DS
   q5/q77's UNION ALL of channels: lineitem, orders, returns, grouped by
   tag and year), explode_horizons (``posexplode(array(7, 30, 90))`` of
   orders, ``date_add`` by the element, grouped by position through the
   dense-slot kernel; then ``explode_outer`` of an empty typed array over
   nation), repartition_hash and repartition_roundrobin (orders into 16
   partitions with ``spark_partition_id()``, collected whole, the
   round-robin partitions within a row of each other), repartition_range
   (by ``o_totalprice`` descending; the partitions' price ranges must not
   overlap), window_frames (lineitem by supplier: a frame min, a running
   max, a suffix last, a RANGE first over 30 days, a string lag and a
   string max; collected whole, ordered by (l_orderkey, l_linenumber),
   with its peak device memory, and each function's own peak above the
   query without it, ``window_peaks``) and bitwise_keys (``&``, ``^``,
   ``<<``, ``~`` and ``>>>`` summed by ``l_orderkey & 7``).  After it,
   kernel_path holds the dense-slot kernel against its plain version on
   the first update batch of range_agg_512, explode_horizons and
   bitwise_keys, the phase's three paths through it.

The dense-slot kernel's float sums take one fixed order: every
comparison of it with its plain version (phase 3, its edge specs and
kernel_path) also calls it 5 times and fails unless the float-add planes
come out bit for bit alike (``float_sum_results_of_5``).

Each path of phases 5 to 18 runs with the launch counts set to 0 just
before it and read just after (one ``launches`` line each), so they
show that the main path went through each kernel.  Two checks follow
that hold the joins' device-dependent work on the card to the same
calls on the CPU, exactly: hash_device (the join hash of every key
type, with float specials and strings at three widths, key equality
over every pair of specials, and a three-key hash with nulls) and
join_routes (the dense FK, hashed FK and general routes, and inner,
left, right, full, semi and anti joins, over a stream side of two
batches).  A trace phase then
runs the text queries, hash_join_1m, tpch_q3, window_1m, tpcxbb_q3 (the
largest join, through the band-aware probe), mortgage_etl,
cube_shipmode, repartition_hash and window_frames once more
under torch.profiler and prints each one's wall time, the card's busy
time, its largest device entries, its longest idle gaps and the port's
named ranges (``join.*``, ``window.*``, ``exchange.*``); a join query's
trace without a ``join.*`` range, window_1m's or window_frames' without
a ``window.*`` one, or repartition_hash's without an ``exchange.*`` one,
fails the run.  Then one JSON
line lists every kernel (its launches summed over the paths), the ``nvidia-smi`` line follows, and the last
line is ``{"ok": true, "device": {...}}``.  Any failed check raises, and
the script exits nonzero without that line; it also exits nonzero when
no card is usable or the port's package is not beside it.

``--package-root DIR`` drives the package under DIR instead (another
checkout, to time an older commit's kernels the same way);
``--kernels-only`` stops after phase 4's main-path comparisons and
times, without edge specs or queries.  ``--layer-cost`` builds the
kernels, times hash_agg_sort_2m, hash_join_1m, tpch_q3 and window_1m as
phases 6, 10, 11 and 12 do (with the coalesce's background pull off, as
by default, on, and on with a 0.1 ms thread switch interval), and
tpcxbb_q3 and tpcxbb_q8 as phase 15 does (pull off), and stops;
with
``--package-root`` it sets another commit's times beside these in one
call.  ``--string-paths`` builds nothing: it holds LIKE/RLIKE's literal
run search against the code-point NFA and replace's in-place path
against its spread path on the breadth queries' own columns, times
each, then times those queries with the general paths forced and not,
and stops.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np

SEED = 7
LINEITEM_ROWS = 6_001_215
RANGES = ("join.", "window.", "exchange.")  # the port's profiler ranges
DIM_ROWS = 10_000
NEEDLE = "special requests"   # TPC-H Q13's two words as one 16-byte needle
SHORT_NEEDLE = "special"
# lowercase words for the synthetic l_comment text; neither needle word
# is among them, so every needle in the text was planted
WORDS = ("the quick final furious pending regular express ironic bold even "
         "silent careful blithe slyly fluffily quickly carefully deposits "
         "accounts packages theodolites instructions foxes pinto beans "
         "dolphins platelets asymptotes courts dependencies excuses ideas "
         "sauternes somas warthogs frays sheaves tithes epitaphs dugouts "
         "across about above after against along among around before "
         "behind beneath beside between beyond during except from inside "
         "into near outside over past since through toward under until "
         "upon within without").split()
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


def cold_ms(torch, fn, samples: int = 20, flush_bytes: int = 128 << 20
            ) -> float:
    """Milliseconds of one call of ``fn`` with its inputs out of L2:
    before each call, outside the events, a write of ``flush_bytes``
    (more than twice the 50 MB L2) evicts them; one pair of CUDA events a
    call, median of ``samples``."""
    flush = torch.empty(flush_bytes, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    times = []
    for i in range(samples):
        flush.fill_(i & 0xFF)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    del flush
    return float(np.median(times))


def device_us(torch, fn, name: str, calls: int = 20):
    """Mean device microseconds of each CUDA kernel whose name holds
    ``name`` over ``calls`` calls of ``fn``, read with torch.profiler;
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
        if name in e.key and total > 0:
            out[e.key] = total / e.count
    return out or None


def _toolkit(tool: str):
    """A CUDA toolkit program, from PATH or CUDA_HOME; None if missing."""
    import shutil
    found = shutil.which(tool)
    if found:
        return found
    path = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin",
                        tool)
    return path if os.path.exists(path) else None


def sass_summary(native, sass_dir=None) -> dict:
    """Each kernel library's atomic and CAS instructions, counted by
    opcode for each of its CUDA functions, from ``cuobjdump -sass``; the
    whole listing goes to ``sass_dir`` when one is given."""
    import re
    tool = _toolkit("cuobjdump")
    if tool is None:
        return {"error": "cuobjdump not found"}
    op_re = re.compile(r"^\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                       r"([A-Z][A-Z0-9_.]*)")
    out = {}
    for name in native.KERNELS:
        text = subprocess.run([tool, "-sass", native.library_path(name)],
                              capture_output=True, text=True, timeout=120,
                              check=True).stdout
        if sass_dir:
            os.makedirs(sass_dir, exist_ok=True)
            with open(os.path.join(sass_dir, f"{name}.sass"), "w") as f:
                f.write(text)
        funcs, cur = {}, None
        for line in text.splitlines():
            if "Function :" in line:
                cur = funcs.setdefault(line.split("Function :")[1].strip(), {})
                continue
            m = op_re.match(line)
            if cur is not None and m and m.group(1).startswith(
                    ("ATOM", "RED", "CAS")):
                cur[m.group(1)] = cur.get(m.group(1), 0) + 1
        out[name] = funcs
    return out


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


def main_path_inputs(pag, session, query, half: bool = False):
    """What a path gives the kernel: the aggregate's own plane
    construction on the first update batch of ``query`` that takes the
    dense-slot path, from the root-most aggregate down (its input, a
    join's output included); with ``half``, on the first half of that
    batch that an out-of-memory split would give it -> (gid, planes,
    ops, K)."""
    from spark_rapids_tpu_torch.exec.base import ExecContext
    from spark_rapids_tpu_torch.exprs.base import colvals
    from spark_rapids_tpu_torch.plan.planner import plan_query
    # the batch the aggregate exec's own routing would send
    # (TorchHashAggregateExec._try_pallas_update)
    for agg in _plan_nodes(plan_query(query.plan), "TorchHashAggregateExec"):
        if not pag.supports(agg.spec):
            continue
        for batch in agg.children[0].execute(
                ExecContext(session.conf, session.device)):
            if half:
                from spark_rapids_tpu_torch.utils.retry import \
                    split_batch_half
                batch = split_batch_half(batch)[0]
            if batch.capacity > pag.max_capacity(agg.spec):
                continue
            cols = colvals(batch.columns)
            rng = pag.key_range(agg.spec.groupings[0], cols, batch.num_rows,
                                batch.capacity)
            if rng is None:
                continue
            if not pag.fits(*rng):
                break
            lo, _ = rng
            K = pag.slot_count(*rng)
            gid, planes, ops, _ = pag.update_planes(
                agg.spec, cols, batch.num_rows, batch.capacity, lo, K)
            return gid, planes, ops, K
    check(False, "no batch of the query takes the dense-slot path")


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


def compare_kernel(torch, pag, gid, planes, ops, K: int, got=None) -> float:
    """The kernel's outputs (``got``, else a call of the wrapper) against
    the plain version: f64 sums within 1e-12 of each slot's sum of |v|,
    every other plane equal under ``==`` with NaN matching NaN -> the
    largest f64 sum error."""
    if got is None:
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


def _main_like(rng, gid: np.ndarray):
    """The main path's eight planes and ops, drawn at random for ``gid``."""
    n = gid.size
    valid = rng.random(n) < 0.9
    f = rng.normal(size=n).astype(np.float32)
    planes = [np.ones(n, np.int32), valid.astype(np.int32),
              np.where(valid, rng.normal(size=n), 0.0),
              valid.astype(np.int32),
              np.where(valid, f, -np.inf).astype(np.float32),
              np.zeros(n, np.int32), valid.astype(np.int32),
              valid.astype(np.int32)]
    return planes, ["add", "add", "add", "add", "max", "max", "max", "add"]


def dsr_edge_specs(torch, rng):
    """The dense-slot kernel's edge specs -> [(name, gid, planes, ops, K)]
    on the card: all rows on one slot, K = 128, a spec that splits into
    plane groups, float min/max over NaN, signed zeros and infinities,
    int64 sums that wrap, gids of -1 and K + 3, a row count that is not a
    multiple of the tile, and planes that are not 16-byte aligned."""
    def card(*arrays):
        return [torch.from_numpy(np.ascontiguousarray(a)).cuda()
                for a in arrays]

    K, n = 1024, 1 << 18
    specs = []
    f = rng.normal(size=n)
    gid, *planes = card(np.full(n, 7, np.int32), np.ones(n, np.int32),
                        rng.integers(-1000, 1000, n).astype(np.int32), f,
                        f.astype(np.float32), (-f).astype(np.float32))
    specs.append(("one_slot", gid, planes, ["add", "max", "add", "max",
                                            "min"], K))

    g = rng.integers(0, 128, 1 << 20).astype(np.int32)
    planes, ops = _main_like(rng, g)
    specs.append(("K128", *card(g), card(*planes), ops, 128))

    g = rng.integers(0, K, n >> 1).astype(np.int32)
    wide = [rng.normal(size=n >> 1) for _ in range(40)]
    wide += [np.ones(n >> 1, np.int32), rng.normal(size=n >> 1)
             .astype(np.float32)]
    specs.append(("plane_groups", *card(g), card(*wide),
                  ["add"] * 41 + ["max"], K))

    nan_neg = np.copysign(np.nan, -1.0)
    special = np.array([np.nan, nan_neg, -0.0, 0.0, np.inf, -np.inf])
    g = rng.integers(0, 1000, n + 5).astype(np.int32)
    v = rng.normal(size=n + 5)
    pick = rng.random(n + 5) < 0.3
    v[pick] = rng.choice(special, int(pick.sum()))
    # slots 1000-1009 see only signed zeros, 1010-1019 only infinities,
    # 1020-1023 only NaN and zeros
    for lo, pool in ((1000, special[2:4]), (1010, special[4:]),
                     (1020, special[:4])):
        rows = rng.random(n + 5) < 0.01
        g[rows] = rng.integers(lo, min(lo + 10, K), int(rows.sum()))
        v[rows] = rng.choice(pool, int(rows.sum()))
    specs.append(("float_specials", *card(g),
                  card(v.astype(np.float32), v.astype(np.float32), v, v),
                  ["min", "max", "min", "max"], K))

    g = rng.integers(0, K, n).astype(np.int32)
    big = rng.integers(1 << 61, (1 << 63) - 1, n, dtype=np.int64)
    big[rng.random(n) < 0.3] *= -1
    specs.append(("int64_wrap", *card(g), card(big, big, big),
                  ["add", "min", "max"], K))

    g = rng.integers(0, K, n).astype(np.int32)
    g[rng.random(n) < 0.15] = -1
    g[rng.random(n) < 0.15] = K + 3
    planes, ops = _main_like(rng, g)
    specs.append(("gid_outside", *card(g), card(*planes), ops, K))

    g = rng.integers(0, 1000, (1 << 20) - 37).astype(np.int32)
    planes, ops = _main_like(rng, g)
    specs.append(("ragged_rows", *card(g), card(*planes), ops, K))

    # views one element into their storage: 4 or 8 bytes off alignment
    g = rng.integers(0, 1000, n).astype(np.int32)
    planes, ops = _main_like(rng, g)
    gid, *planes = card(g, *planes)
    specs.append(("unaligned", gid[1:], [p[1:] for p in planes], ops, K))
    return specs


def float_sum_repeats(torch, pag, gid, planes, ops, K: int, calls: int = 5):
    """The kernel's float-add planes over ``calls`` calls on the same
    inputs -> (how many planes, how many distinct results, bit for bit):
    the sums take one fixed order, so one result is right."""
    sums = [j for j, (p, op) in enumerate(zip(planes, ops))
            if p.is_floating_point() and op == "add"]
    results = {b"".join(o[j].view(torch.int64 if o[j].element_size() == 8
                                  else torch.int32).cpu().numpy().tobytes()
                        for j in sums)
               for o in (pag.dense_slot_reduce(gid, planes, ops, K)
                         for _ in range(calls))}
    return len(sums), len(results)


def phase_kernel(torch, pag, session, query, rate: float,
                 edges: bool = True) -> dict:
    gid, planes, ops, K = main_path_inputs(pag, session, query)
    err = compare_kernel(torch, pag, gid, planes, ops, K)

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
        "cold_ms": cold_ms(torch, launch),
        "wrapper_ms": per_call_ms(torch, lambda: pag.dense_slot_reduce(
            gid, planes, ops, K)),
        "plain_ms": per_call_ms(torch, lambda: pag.dense_slot_reduce_reference(
            gid, planes, ops, K)),
        "library_ms": per_call_ms(torch, library),
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "max_abs_err": err,
    }
    fsum_planes, repeats = float_sum_repeats(torch, pag, gid, planes, ops, K)
    emit("kernel", name="dense_slot_reduce", capacity=n, K=K,
         planes=[f"{str(p.dtype)[6:]} {op}" for p, op in zip(planes, ops)],
         bytes=nbytes, device_us=device_us(torch, launch, "dsr_"),
         float_sum_planes=fsum_planes, float_sum_results_of_5=repeats,
         **result)
    check(repeats == 1, f"the kernel's float sums differ between calls: "
          f"{repeats} results of 5")
    if hasattr(pag, "launch_plan"):
        emit("kernel_shapes", name="dense_slot_reduce",
             shapes=kernel_shapes(torch, pag, gid, planes, ops, K))
    if edges:
        checked = []
        for name, g, p, o, k in [("wide", *wide_inputs(
                torch, np.random.default_rng(SEED), 1024))] + dsr_edge_specs(
                    torch, np.random.default_rng(SEED + 4)):
            result["max_abs_err"] = max(result["max_abs_err"],
                                        compare_kernel(torch, pag, g, p, o, k))
            _, repeats = float_sum_repeats(torch, pag, g, p, o, k)
            check(repeats == 1, f"{name}: the kernel's float sums differ "
                  f"between calls: {repeats} results of 5")
            checked.append({"spec": name, "rows": g.numel(), "K": k,
                            "planes": len(p)})
        emit("kernel_edges", name="dense_slot_reduce", specs=checked,
             max_abs_err=result["max_abs_err"])
    return result


def phase_kernel_path(torch, pag, session, query, path: str,
                      half: bool = False) -> float:
    """The dense-slot kernel against its plain version on the inputs
    another path gives it (``query``'s first update batch, or with
    ``half`` that batch's first half), timed as phase 3 -> the largest
    f64 sum error."""
    gid, planes, ops, K = main_path_inputs(pag, session, query, half)
    err = compare_kernel(torch, pag, gid, planes, ops, K)
    launch, _ = pag.prepare_launch(gid, planes, ops, K)
    fsum_planes, repeats = float_sum_repeats(torch, pag, gid, planes, ops, K)
    emit("kernel_path", name="dense_slot_reduce", path=path, half=half,
         capacity=gid.numel(), K=K,
         planes=[f"{str(p.dtype)[6:]} {op}" for p, op in zip(planes, ops)],
         max_abs_err=err, ms=per_call_ms(torch, launch),
         cold_ms=cold_ms(torch, launch),
         plain_ms=per_call_ms(torch, lambda: pag.dense_slot_reduce_reference(
             gid, planes, ops, K)),
         float_sum_planes=fsum_planes, float_sum_results_of_5=repeats)
    check(repeats == 1, f"{path}: the kernel's float sums differ between "
          f"calls: {repeats} results of 5")
    return err


def kernel_shapes(torch, pag, gid, planes, ops, K: int):
    """The dense-slot kernel's time at other launch shapes (threads a
    block, blocks an SM) on the main path's inputs, each checked against
    the plain version first."""
    out = []
    for threads, per_sm in ((1024, 1), (512, 2), (256, 4)):
        launch, got = pag.prepare_launch(gid, planes, ops, K, threads=threads,
                                         blocks_per_sm=per_sm)
        launch()
        compare_kernel(torch, pag, gid, planes, ops, K, got)
        plans = pag.launch_plan(
            [p.element_size() for p in planes], K, gid.numel(),
            torch.cuda.get_device_properties(0).multi_processor_count,
            threads=threads, blocks_per_sm=per_sm)
        out.append({"threads": threads, "blocks_per_sm": per_sm,
                    "grid": [p.grid for p in plans],
                    "ms": per_call_ms(torch, launch),
                    "cold_ms": cold_ms(torch, launch)})
    return out


# -- phase 4 ---------------------------------------------------------------

def gen_lineitem(n: int, seed: int):
    """A lineitem-shaped table at TPC-H's widths, from numpy -> (columns
    as numpy arrays, the l_comment byte matrix (n, 43), its lengths, the
    returnflag and linestatus codes).  l_comment is synthetic: each row
    takes 10 to 43 bytes of a stream of WORDS at a random offset, and
    about 2 % of the rows get NEEDLE at a random offset that fits (drawn
    among the rows long enough to hold it)."""
    rng = np.random.default_rng(seed)
    vocab = [w.encode() + b" " for w in WORDS]
    vbytes = np.frombuffer(b"".join(vocab), np.uint8)
    vlen = np.array([len(w) for w in vocab])
    voff = np.cumsum(vlen) - vlen
    ids = rng.integers(0, len(vocab), max(4096, n // 2))
    wl = vlen[ids]
    stream = vbytes[np.repeat(voff[ids] - (np.cumsum(wl) - wl), wl)
                    + np.arange(int(wl.sum()))]
    lengths = rng.integers(10, 44, n)
    chars = np.zeros((n, 43), np.uint8)
    start = rng.integers(0, stream.size - 43, n)
    for a in range(0, n, 1 << 20):
        b = min(n, a + (1 << 20))
        idx = start[a:b, None] + np.arange(43)[None, :]
        chars[a:b] = np.where(np.arange(43)[None, :] < lengths[a:b, None],
                              stream[idx], 0)
    needle = np.frombuffer(NEEDLE.encode(), np.uint8)
    fits = lengths >= needle.size
    planted = np.flatnonzero(fits & (rng.random(n) < 0.02 / fits.mean()))
    at = (rng.random(planted.size)
          * (lengths[planted] - needle.size + 1)).astype(np.int64)
    chars[planted[:, None], at[:, None] + np.arange(needle.size)] = needle
    rf = rng.integers(0, 3, n)
    ls = rng.integers(0, 2, n)
    qty = rng.integers(1, 51, n).astype(np.float64)
    price = np.round(qty * rng.uniform(900.0, 2100.0, n), 2)
    data = {"l_returnflag": np.array(list("ANR"))[rf],
            "l_linestatus": np.array(list("FO"))[ls],
            "l_quantity": qty, "l_extendedprice": price,
            "l_comment": chars.view("S43").ravel().astype("U43")}
    return data, chars, lengths, rf, ls


def text_agg_query(st, F, df):
    """TPC-H Q1's grouping and aggregates over the long-needle filter."""
    col = st.col
    return (df.filter(F.contains(col("l_comment"), NEEDLE))
              .group_by("l_returnflag", "l_linestatus")
              .agg(F.count(col("l_quantity")).alias("count_order"),
                   F.sum(col("l_quantity")).alias("sum_qty"),
                   F.sum(col("l_extendedprice")).alias("sum_base_price"),
                   F.avg(col("l_extendedprice")).alias("avg_price"))
              .order_by("l_returnflag", "l_linestatus"))


def text_project_query(st, F, df):
    col = st.col
    return (df.filter(F.contains(col("l_comment"), SHORT_NEEDLE)
                      & (col("l_quantity") < 25.0))
              .select("l_returnflag", "l_comment", "l_extendedprice"))


def contains_edge_inputs(torch, rng):
    """W = 512, UTF-8 bytes >= 0x80, junk past every length (the needle
    itself planted just past some), and needles of 16 bytes and of W ->
    [(chars, lengths, needle)]."""
    rows, W = 1 << 16, 512
    chars = rng.integers(0x61, 0x64, (rows, W)).astype(np.uint8)
    chars[rng.random((rows, W)) < 0.1] = 0xC3
    chars[rng.random((rows, W)) < 0.05] = 0xA9
    lengths = rng.integers(0, W + 1, rows).astype(np.int32)
    specs = []
    for pat in (b"ab\xc3\xa9" * 4, bytes(rng.integers(0x61, 0x63, W)
                                        .astype(np.uint8))):
        c = chars.copy()
        p = np.frombuffer(pat, np.uint8)
        k = p.size
        for r in range(0, rows, 5):
            if lengths[r] >= k:        # inside the length: a hit
                j = rng.integers(0, lengths[r] - k + 1)
                c[r, j:j + k] = p
            elif lengths[r] + k <= W:  # past it: must not count
                c[r, lengths[r]:lengths[r] + k] = p
        specs.append((torch.from_numpy(c).cuda(),
                      torch.from_numpy(lengths).cuda(), pat))
    return specs


def scan_batch(session, df):
    """The first batch the port's own local scan uploads for ``df``."""
    from spark_rapids_tpu_torch.exec.base import ExecContext
    from spark_rapids_tpu_torch.plan.planner import plan_query
    node = plan_query(df.plan)
    while node.children:
        node = node.children[0]
    check(type(node).__name__ == "TorchLocalScanExec", "plan shape")
    return next(node.execute(ExecContext(session.conf, session.device)))


def planted(torch, rng, rows: int, W: int, pat: bytes, text=None):
    """A (rows, W) char matrix of random lowercase letters (or ``text``),
    lengths from -2 to W + 8 (some negative, some past W), and ``pat``
    planted at window 0 of a quarter of the rows that can hold it, at the
    last window ``len - k`` of another quarter, and one byte past the
    length of a third, where it must not count -> (chars, lengths, pat)
    on the card."""
    k = len(pat)
    chars = rng.integers(0x61, 0x7B, (rows, W)).astype(np.uint8) \
        if text is None else text
    lengths = rng.integers(-2, W + 9, rows).astype(np.int32)
    ln = np.clip(lengths, 0, W)
    p = np.frombuffer(pat, np.uint8)
    r = np.arange(rows)
    for which, start, ok in ((0, 0 * ln, ln >= k), (1, ln - k, ln >= k),
                             (2, ln - k + 1, (ln >= k - 1) & (ln < W))):
        sel = np.flatnonzero((r % 4 == which) & ok)
        chars[sel[:, None], start[sel, None] + np.arange(k)] = p
    return (torch.from_numpy(chars).cuda(), torch.from_numpy(lengths).cuda(),
            pat)


def contains_specs(torch, rng):
    """The contains kernel's edge specs -> [(name, chars, lengths, pat)]:
    needles at window 0, at the last window and one byte past the length;
    k = 1, 3, 4, 5, 31, 32, 33, 63, 64, 65 and k = W (both Shift-And
    states and the long path); a needle past 1 KB (the card-buffer
    path); repetitive text (``aaaa...ab``); W = 8, 16, 512, 1024 and
    2048; lengths past W; row counts that are not a multiple of a tile;
    and the W = 512 spec with UTF-8 bytes."""
    rows = (1 << 14) + 5

    def needle(k):
        return bytes(rng.integers(0x61, 0x7B, k).astype(np.uint8))

    specs = [(f"W128_k{k}", *planted(torch, rng, rows, 128, needle(k)))
             for k in (1, 3, 4, 5, 31, 32, 33, 63, 64, 65, 128)]
    for k in (16, 40):
        text = np.full((rows, 64), ord("a"), np.uint8)
        text[np.arange(rows), rng.integers(0, 64, rows)] = ord("b")
        specs.append((f"repetitive_k{k}", *planted(
            torch, rng, rows, 64, b"a" * (k - 1) + b"b", text)))
    for W, k in ((8, 5), (8, 8), (16, 3), (16, 16), (64, 16), (512, 16),
                 (512, 200), (1024, 16), (1024, 1024), (2048, 1100)):
        specs.append((f"W{W}_k{k}", *planted(torch, rng, rows, W,
                                             needle(k))))
    specs += [(f"utf8_W512_k{len(p)}", c, ln, p)
              for c, ln, p in contains_edge_inputs(torch, rng)]
    return specs


def phase_contains(torch, ps, session, df, rate: float,
                   edges: bool = True) -> dict:
    batch = scan_batch(session, df)
    comment = batch.columns[batch.schema.field_index("l_comment")]
    chars, lengths = comment.chars, comment.data
    pat = NEEDLE.encode()
    got = ps.run_contains(chars, lengths, pat)
    torch.cuda.synchronize()
    want = ps.contains_reference(chars, lengths, pat)
    check(torch.equal(got, want), "contains kernel differs from its plain "
          "version on the main path's batch")

    launch, _ = ps.prepare_contains(chars, lengths, pat)
    rows, W = chars.shape
    k = len(pat)
    # what the function must move: each length read once, the first
    # len[r] bytes of every row that can hold the needle, the needle,
    # and one output byte a row; the full char plane beside it
    ln = lengths.clamp(0, W).to(torch.int64)
    need = int(ln[ln >= k].sum())
    nbytes = 4 * rows + need + k + rows
    full = 4 * rows + rows * W + k + rows
    windows = int((ln - k + 1).clamp(min=0).sum())
    bytes_ms = nbytes / rate * 1e3
    ops_ms = windows / _F32_RATE * 1e3
    result = {
        "ms": per_call_ms(torch, launch),
        "cold_ms": cold_ms(torch, launch),
        "wrapper_ms": per_call_ms(torch, lambda: ps.run_contains(
            chars, lengths, pat)),
        "plain_ms": per_call_ms(torch, lambda: ps.contains_reference(
            chars, lengths, pat)),
        "library_ms": None,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "max_abs_err": 0.0,
    }
    emit("kernel", name="contains", rows=rows, width=W, needle_bytes=k,
         hits=int(want.sum()), bytes=nbytes, full_bytes=full,
         full_bound_ms=full / rate * 1e3,
         device_us=device_us(torch, launch, "contains_"), **result)
    if edges:
        checked = []
        for name, c, ln, p in contains_specs(torch,
                                             np.random.default_rng(SEED + 3)):
            got = ps.run_contains(c, ln, p)
            torch.cuda.synchronize()
            want = ps.contains_reference(c, ln, p)
            check(torch.equal(got, want),
                  f"contains kernel differs from its plain version on {name}")
            checked.append({"spec": name, "rows": c.shape[0],
                            "hits": int(want.sum())})
        emit("kernel_edges", name="contains", specs=checked)
    return result


# -- phases 5 to 9 ---------------------------------------------------------

def gen_data(n_main: int, n_agg: int):
    """bench.py:gen_data's main, main4 and dim columns, from seed 7 (the
    fact table of hash_join_1m is main, as JOIN_ROWS == N_ROWS there)."""
    rng = np.random.default_rng(SEED)
    main = {"k": rng.integers(0, 1000, n_main), "v": rng.normal(size=n_main),
            "w": rng.normal(size=n_main).astype(np.float32)}
    agg = {"k": rng.integers(0, 1000, n_agg), "v": rng.normal(size=n_agg),
           "w": rng.normal(size=n_agg).astype(np.float32)}
    dim = {"k": np.arange(DIM_ROWS, dtype=np.int64),
           "grp": rng.integers(0, 50, DIM_ROWS)}
    return main, agg, dim


def gen_big(n: int = 32_000_000):
    """hash_agg_32m's columns (seed 8)."""
    rng = np.random.default_rng(SEED + 1)
    return {"k": rng.integers(0, 1000, n), "v": rng.normal(size=n),
            "w": rng.normal(size=n).astype(np.float32)}


def layer_cost(torch, st, F, native, main, agg_data, dim, name) -> int:
    """``--layer-cost``: hash_agg_sort_2m, hash_join_1m, tpch_q3,
    window_1m, tpcxbb_q3 and tpcxbb_q8 (the band-aware probe's queries,
    with their candidate pairs) at the default conf, each timed and its
    host syncs counted as in the full run; then the first four again
    with the coalesce's
    background pull on (``spark.rapids.sql.io.prefetch.enabled``, a key
    a package without it ignores), and with it on and the interpreter's
    thread switch interval at 0.1 ms instead of 5 ms, to show how much
    of the pull's cost is a thread waiting for the GIL."""
    from spark_rapids_tpu_torch.bench.tpch import gen_tpch_numpy, \
        load_tables
    from spark_rapids_tpu_torch.bench.tpcxbb import gen_tpcxbb_numpy, \
        register_views
    tpch = gen_tpch_numpy(LINEITEM_ROWS)
    xbb = gen_tpcxbb_numpy(TPCXBB_SALES_ROWS)
    cpu = st.TorchSession({"spark.rapids.torch.device": "cpu"})
    register_views(cpu, xbb)
    default_switch = sys.getswitchinterval()
    pull = {"spark.rapids.sql.io.prefetch.enabled": True}
    for conf, switch in (({}, default_switch), (pull, default_switch),
                         (pull, 1e-4)):
        emit("layer_cost", conf=conf, switch_interval_s=switch)
        sys.setswitchinterval(switch)
        try:
            session = st.TorchSession(conf)
            phase_agg(torch, st, F, native, session, agg_data,
                      "hash_agg_sort_2m", 3)
            phase_hash_join(torch, st, F, native, session, main, dim)
            phase_tpch(torch, st, native, session, tpch,
                       load_tables(session, tpch), "q3")
            phase_window(torch, st, F, session, main)
            if not conf:
                # the band-aware probe's queries (the parent lays out
                # every equi pair)
                register_views(session, xbb)
                for qname in ("q3", "q8"):
                    phase_tpcxbb(torch, session, cpu, qname,
                                 TPCXBB_SALES_ROWS)
                band_off(torch, session, cpu)
        finally:
            sys.setswitchinterval(default_switch)
    pull_cost(torch, st, main)
    print(json.dumps({"ok": True, "layer_cost": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def band_off(torch, session, cpu) -> None:
    """tpcxbb_q3 and q8 with the band extraction turned off, in a package
    that has it: the equi pairs the parent lays out, against the same
    query's banded run (``phase_tpcxbb``'s line before this one)."""
    from spark_rapids_tpu_torch.exec import joins
    real = getattr(joins, "extract_band", None)
    if real is None:
        return
    joins.extract_band = lambda *a: None
    try:
        for qname in ("q3", "q8"):
            emit("band_off", query=qname)
            phase_tpcxbb(torch, session, cpu, qname, TPCXBB_SALES_ROWS)
    finally:
        joins.extract_band = real


# the LIKE/RLIKE inputs of the breadth queries: (table, column, query,
# operator, pattern)
LIKE_INPUTS = (("part", "p_name", "tpch_q9_like", "LIKE", "%green%"),
               ("orders", "o_comment", "tpch_q13_not_like", "LIKE",
                "%special%requests%"),
               ("part", "p_type", "tpch_q14_like", "LIKE", "PROMO%"),
               ("part", "p_type", "tpch_q16_not_like", "LIKE",
                "MEDIUM POLISHED%"),
               ("lineitem_text", "l_comment", "comment_regex", "RLIKE",
                "special.*requests"))


def string_paths(torch, st, name) -> int:
    """``--string-paths``: LIKE/RLIKE's two matchers (a search per
    literal run, ``_segment_match``, and the code-point NFA,
    ``_nfa_match``) and replace's two paths (in place when the
    replacement is as long as the search, else spread) on the card, on
    the breadth queries' own columns at SF1: each pair held equal and
    timed in one call, then the queries themselves with the second of
    each pair forced."""
    from spark_rapids_tpu_torch.bench.tpch import gen_tpch_numpy
    from spark_rapids_tpu_torch.exprs import strings as S
    from spark_rapids_tpu_torch.exprs.base import colvals
    tpch = gen_tpch_numpy(LINEITEM_ROWS)
    line = gen_lineitem(LINEITEM_ROWS, SEED + 2)[0]
    session = st.TorchSession.builder().get_or_create()
    text = dict(tpch, lineitem_text=line)

    def column(table, col):
        df = session.create_dataframe({col: text[table][col]})
        return colvals(scan_batch(session, df).columns)[0]

    for table, col, qname, op, pattern in LIKE_INPUTS:
        c = column(table, col)
        toks = S._parse_like(pattern, "\\") if op == "LIKE" \
            else S._parse_regex_lite(pattern)
        plan = S._segments(toks)
        check(plan is not None, f"{pattern!r}: not a pattern of runs")
        seg = S._segment_match(c, *plan)
        check(torch.equal(seg, S._nfa_match(c, toks)),
              f"{col} {op} {pattern!r}: the matchers disagree")
        emit("like_matchers", query=qname, column=col, rows=c.data.shape[0],
             width=c.chars.shape[1], pattern=pattern,
             matches=int(seg.sum()),
             segment_ms=per_call_ms(torch, lambda: S._segment_match(
                 c, *plan), calls=5, samples=10),
             nfa_ms=per_call_ms(torch, lambda: S._nfa_match(c, toks),
                                calls=5, samples=10))
    c = column("lineitem", "l_shipmode")
    sel = S._greedy_select(S._match_windows(c.chars, c.data, b"AIR"), b"AIR")
    a, b = S._replace_in_place(c, sel, b"air"), \
        S._replace_spread(c, sel, 3, b"air")
    check(torch.equal(a.data, b.data) and torch.equal(
        a.chars[:, :b.chars.shape[1]], b.chars),
        "replace: the two paths disagree")
    emit("replace_paths", column="l_shipmode", rows=c.data.shape[0],
         width=c.chars.shape[1], matches=int(sel.sum()),
         in_place_ms=per_call_ms(
             torch, lambda: S._replace_in_place(c, sel, b"air"), calls=5,
             samples=10),
         spread_ms=per_call_ms(
             torch, lambda: S._replace_spread(c, sel, 3, b"air"), calls=5,
             samples=10))
    # the queries end to end, each path in turn, in one session pair
    gpu, cpu = breadth_sessions(st, tpch, line)
    sqls = dict((q, sql) for q, sql, _ in BREADTH_QUERIES)
    queries = [q for _, _, q, _, _ in LIKE_INPUTS] + ["concat_trim_replace"]
    segments, in_place = S._segments, S._replace_in_place
    forced = {"fast": {},
              "nfa_spread": {"_segments": lambda toks: None,
                             "_replace_in_place": lambda c, sel, rep:
                             S._replace_spread(c, sel, len(rep), rep)}}
    want = {q: cpu.sql(sqls[q]).to_torch() for q in queries}
    try:
        for mode in ("fast", "nfa_spread", "nfa_spread", "fast"):
            for attr, fn in forced[mode].items():
                setattr(S, attr, fn)
            for q in queries:
                got, secs = run_timed(torch, gpu.sql(sqls[q]), 2)
                same_result(torch, to_device(want[q], "cuda"), got,
                            f"string paths {q} ({mode})", float_rtol=1e-9)
                emit("string_paths_query", query=q, mode=mode, seconds=secs)
            S._segments, S._replace_in_place = segments, in_place
    finally:
        S._segments, S._replace_in_place = segments, in_place
    print(json.dumps({"ok": True, "string_paths": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def pull_cost(torch, st, main, samples: int = 20) -> None:
    """The background pull's own cost (a package without
    ``io/prefetch.py`` skips it): milliseconds, median of ``samples``, of
    a pull over nothing (thread start, join, and on the card the thread's
    device context), with and without the device; and of the local scan
    of ``main`` (1,000,000 rows, one batch) read serially and through a
    pull."""
    try:
        from spark_rapids_tpu_torch.io.prefetch import PrefetchIterator
    except ImportError:
        return
    from spark_rapids_tpu_torch.exec.base import ExecContext
    from spark_rapids_tpu_torch.plan.planner import plan_query
    session = st.TorchSession()
    scan = plan_query(session.create_dataframe(main).plan)
    ctx = ExecContext(session.conf, session.device)

    def timed(fn):
        fn()
        times = []
        for _ in range(samples):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(times))

    def pull(source, device):
        it = PrefetchIterator(source, depth=1, device=device)
        for _ in it:
            pass
        it.close()

    emit("pull_cost", plan=type(scan).__name__,
         empty_ms=timed(lambda: pull(iter(()), None)),
         empty_on_device_ms=timed(lambda: pull(iter(()), "cuda")),
         scan_serial_ms=timed(lambda: list(scan.execute(ctx))),
         scan_pulled_ms=timed(lambda: pull(scan.execute(ctx), "cuda")))


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


def string_keys(torch, lengths_chars, n: int) -> np.ndarray:
    """A one-byte string column from to_torch -> its bytes (checking
    that every string is one byte long)."""
    lengths, chars = lengths_chars
    check(bool(torch.all(lengths == 1)), "a key is not one byte long")
    return chars[:n, 0].cpu().numpy()


def phase_text_agg(torch, st, F, native, session, df, line, name: str,
                   runs: int = 3) -> None:
    data, chars, lengths, rf, ls = line
    q = text_agg_query(st, F, df)
    before = native.LAUNCHES["contains"]
    (cols, masks, n), secs = run_timed(torch, q, runs)
    launches = native.LAUNCHES["contains"] - before
    stage = session._last_plan
    while type(stage).__name__ != "TorchStageExec":
        stage = stage.children[0]
    batches = stage.metrics["stageDispatches"]
    check(launches == batches * (runs + 1),
          f"{launches} contains launches for {batches} batches a run")
    # numpy: np.char.find over the raw bytes, the groups by code
    raw = chars.view("S43").ravel()
    hit = np.char.find(raw, NEEDLE.encode()) >= 0
    key = (rf * 2 + ls)[hit]
    qty = data["l_quantity"][hit]
    price = data["l_extendedprice"][hit]
    present = np.flatnonzero(np.bincount(key, minlength=6))
    counts = np.bincount(key, minlength=6)[present]
    sum_qty = np.bincount(key, qty, minlength=6)[present]
    sum_price = np.bincount(key, price, minlength=6)[present]
    check(n == present.size, f"{n} groups, numpy has {present.size}")
    check(np.array_equal(string_keys(torch, cols["l_returnflag"], n),
                         np.frombuffer(b"ANR", np.uint8)[present // 2]),
          "l_returnflag keys")
    check(np.array_equal(string_keys(torch, cols["l_linestatus"], n),
                         np.frombuffer(b"FO", np.uint8)[present % 2]),
          "l_linestatus keys")
    check(np.array_equal(cols["count_order"].cpu().numpy(), counts),
          "counts")
    check(np.array_equal(cols["sum_qty"].cpu().numpy(), sum_qty),
          "quantity sums")
    check(np.allclose(cols["sum_base_price"].cpu().numpy(), sum_price,
                      rtol=1e-9, atol=0), "price sums beyond rtol 1e-9")
    check(np.allclose(cols["avg_price"].cpu().numpy(), sum_price / counts,
                      rtol=1e-9, atol=0), "price averages beyond rtol 1e-9")
    rows = len(rf)
    emit(name, rows=rows, matched=int(hit.sum()), groups=n, batches=batches,
         contains_launches=launches, seconds=secs,
         rows_per_s=rows / float(np.median(secs)))


def phase_text_project(torch, st, F, native, session, df, line, name: str,
                       runs: int = 3) -> None:
    data, chars, lengths, rf, _ = line
    q = text_project_query(st, F, df)
    before = native.LAUNCHES["contains"]
    (cols, masks, n), secs = run_timed(torch, q, runs)
    check(native.LAUNCHES["contains"] == before,
          "the 7-byte needle launched the contains kernel")
    raw = chars.view("S43").ravel()
    keep = (np.char.find(raw, SHORT_NEEDLE.encode()) >= 0) \
        & (data["l_quantity"] < 25.0)
    check(n == int(keep.sum()), f"row count {n} != {int(keep.sum())}")
    check(all(bool(m.all()) for m in masks.values()), "unexpected nulls")
    check(np.array_equal(string_keys(torch, cols["l_returnflag"], n),
                         np.frombuffer(b"ANR", np.uint8)[rf[keep]]),
          "l_returnflag")
    got_len, got_chars = (t.cpu().numpy() for t in cols["l_comment"])
    check(np.array_equal(got_len, lengths[keep]), "l_comment lengths")
    width = got_chars.shape[1]
    inside = np.arange(width)[None, :] < got_len[:, None]
    want = np.zeros((n, width), np.uint8)
    want[:, :min(43, width)] = chars[keep][:, :width]
    check(np.array_equal(np.where(inside, got_chars, 0), want),
          "l_comment bytes")
    check(np.array_equal(cols["l_extendedprice"].cpu().numpy(),
                         data["l_extendedprice"][keep]), "l_extendedprice")
    rows = len(rf)
    emit(name, rows=rows, out_rows=n, string_width=width, seconds=secs,
         rows_per_s=rows / float(np.median(secs)))


# -- hash_join_1m and the TPC-H queries --------------------------------------

def hash_join_query(st, F, fact, dim):
    """bench.py:q_hash_join."""
    return (fact.join(dim, on="k", how="inner")
                .group_by(st.col("grp"))
                .agg(F.sum(st.col("v")).alias("s")))


def _plan_nodes(plan, name: str):
    out = [plan] if type(plan).__name__ == name else []
    for c in plan.children:
        out += _plan_nodes(c, name)
    return out


def host_syncs(plan) -> int:
    """The host syncs of one run: every operator's ``hostSyncs``."""
    return plan.metrics.get("hostSyncs", 0) + sum(host_syncs(c)
                                                  for c in plan.children)


def phase_hash_join(torch, st, F, native, session, main, dim,
                    runs: int = 3) -> None:
    fact_df = session.create_dataframe(main)
    dim_df = session.create_dataframe(dim)
    q = hash_join_query(st, F, fact_df, dim_df)
    before = native.LAUNCHES["dense_slot_reduce"]
    (cols, masks, n), secs = run_timed(torch, q, runs)
    launches = native.LAUNCHES["dense_slot_reduce"] - before
    plan = session._last_plan
    (join,) = _plan_nodes(plan, "TorchBroadcastHashJoinExec")
    check(join.route == "dense_fk",
          f"the join took the {join.route} route, not dense_fk")
    check(type(join.children[1]).__name__ == "TorchBroadcastExchangeExec"
          and join.children[1].output_schema.names == ["k", "grp"],
          "the dimension is not the broadcast build side")
    (agg,) = _plan_nodes(plan, "TorchHashAggregateExec")
    dense = agg.metrics["pallasAggBatches"]
    check(dense > 0, "no update batch took the dense-slot kernel")
    check(launches == dense * (runs + 1),
          f"{launches} kernel launches for {dense} dense batches a run")
    fk = join.metrics["fkFastPathBatches"]
    syncs = host_syncs(plan)
    # the build probe, one row count a stream batch, and the key range
    # and group count of each dense batch (plus the merge's count)
    want_syncs = 1 + fk + 2 * dense + (1 if dense > 1 else 0)
    check(syncs == want_syncs, f"{syncs} host syncs a run, not {want_syncs}")
    grp = dim["grp"][main["k"]]
    want_s = np.bincount(grp, main["v"], minlength=50)
    present = np.flatnonzero(np.bincount(grp, minlength=50))
    got_g = cols["grp"].cpu().numpy()
    order = np.argsort(got_g)
    check(n == present.size and np.array_equal(got_g[order], present),
          "groups differ from numpy's")
    check(bool(all(m.all() for m in masks.values())), "unexpected nulls")
    check(np.allclose(cols["s"].cpu().numpy()[order], want_s[present],
                      rtol=1e-9, atol=0), "sums beyond rtol 1e-9")
    rows = len(main["k"])
    emit("hash_join_1m", rows=rows + len(dim["k"]), fact_rows=rows,
         dim_rows=len(dim["k"]), groups=n, route=join.route,
         fk_batches=fk, update_batches=dense, kernel_launches=launches,
         host_syncs_per_run=syncs, seconds=secs,
         rows_per_s=(rows + len(dim["k"])) / float(np.median(secs)))


# strings the join hash and key equality must treat alike on every
# device: 0 to 40 bytes, on both sides of each 8-byte block, with NULs
# and multi-byte UTF-8
HASH_STRINGS = ["", "a", "ab", "abc", "abcd", "abcde", "abcdef", "abcdefg",
                "abcdefgh", "abcdefghi", "x" * 16, "y" * 17, "a\x00b",
                "\x00", "h\u00e9llo", "\u4e2d\u6587\u5b57\u7b26",
                "0123456789abcdef", "0123456789abcdefg", "z" * 40]


def _float_bits(bits: int, dtype):
    udt = np.uint64 if dtype == np.float64 else np.uint32
    return np.array([bits], udt).view(dtype)[0]


def float_keys(rng, dtype, n: int = 4000):
    """Random floats over the whole exponent range, led by the specials:
    signed zeros, NaN of both signs and other payloads, infinities,
    subnormals and (for f64) values past f32's range."""
    if dtype == np.float64:
        x = rng.normal(size=n) * 10.0 ** rng.integers(-320, 308, n)
        special = [0.0, -0.0, np.nan, -np.nan, np.inf, -np.inf, 5e-324,
                   -5e-324, 1e-310, -2.2e-308, 3.5e38, -1e300, 1e-39,
                   _float_bits(0x7FF0000000000123, dtype),
                   _float_bits(0xFFF8000000000042, dtype)]
    else:
        x = rng.normal(size=n) * 10.0 ** rng.integers(-45, 38, n)
        special = [0.0, -0.0, np.nan, -np.nan, np.inf, -np.inf, 1e-45,
                   -1e-40, 1.17e-38, 3e38, _float_bits(0x7F800123, dtype),
                   _float_bits(0xFFC00042, dtype)]
    with np.errstate(over="ignore"):
        x = x.astype(dtype)
    x[:len(special)] = np.array(special, dtype)
    return x


def string_planes(values, width: int):
    """(lengths int32, chars uint8 (rows, width)) of ``values``."""
    enc = [v.encode("utf-8") for v in values]
    chars = np.zeros((len(enc), width), np.uint8)
    for i, b in enumerate(enc):
        chars[i, :len(b)] = np.frombuffer(b, np.uint8)
    return np.array([len(b) for b in enc], np.int32), chars


def phase_hash_device(torch, device: str = "cuda") -> None:
    """The join hash and key equality on the card against the same calls
    on the CPU, bit for bit: every key type, the float specials, strings
    at widths 8, 16 and 64, every pair of specials under ``keys_equal``,
    and a three-key hash with nulls.  The CPU result is the one the tests
    hold equal to the JAX package's; the card keeps subnormals and views
    bytes its own way, so only a run there shows the hash unchanged."""
    from spark_rapids_tpu_torch.columnar import dtypes as dt
    from spark_rapids_tpu_torch.exec import joins
    from spark_rapids_tpu_torch.exprs.base import BoundReference, ColVal, \
        EvalContext

    def colval(arrays, device, valid=None):
        t = [torch.from_numpy(np.ascontiguousarray(a)).to(device)
             for a in arrays]
        v = torch.ones(t[0].shape[0], dtype=torch.bool) if valid is None \
            else torch.from_numpy(valid)
        return ColVal(t[0], v.to(device), t[1] if len(t) > 1 else None)

    rng = np.random.default_rng(SEED + 5)
    n = 4000
    i64 = rng.integers(-(1 << 63), (1 << 63) - 1, n, dtype=np.int64)
    i64[:4] = [-(1 << 63), (1 << 63) - 1, 0, -1]
    i32 = rng.integers(-(1 << 31), (1 << 31) - 1, n).astype(np.int32)
    i32[:3] = [-(1 << 31), (1 << 31) - 1, -1]
    cases = {"int32": ([i32], dt.INT32), "int64": ([i64], dt.INT64),
             "date": ([rng.integers(-30000, 30000, n).astype(np.int32)],
                      dt.DATE),
             "bool": ([rng.random(n) < 0.5], dt.BOOLEAN),
             "float32": ([float_keys(rng, np.float32)], dt.FLOAT32),
             "float64": ([float_keys(rng, np.float64)], dt.FLOAT64)}
    for w in (8, 16, 64):
        cases[f"string_w{w}"] = (string_planes(
            [v for v in HASH_STRINGS if len(v.encode()) <= w], w), dt.STRING)
    for name, (arrays, dtype) in cases.items():
        want = joins.hash_colval(colval(arrays, "cpu"), dtype)
        got = joins.hash_colval(colval(arrays, device), dtype).cpu()
        check(torch.equal(got, want),
              f"the hash of {name} keys differs between the card and the CPU")

    pairs = {}
    m = len(HASH_STRINGS)
    lengths, chars = string_planes(HASH_STRINGS, 64)
    a, b = np.repeat(np.arange(m), m), np.tile(np.arange(m), m)
    pairs["string"] = ([lengths[a], chars[a]], [lengths[b], chars[b]],
                       dt.STRING)
    for name in ("float32", "float64"):
        (v,), dtype = cases[name]
        v = v[:15]
        pairs[name] = ([np.repeat(v, v.size)], [np.tile(v, v.size)], dtype)
    for name, (x, y, dtype) in pairs.items():
        want = joins.keys_equal(colval(x, "cpu"), colval(y, "cpu"), dtype)
        got = joins.keys_equal(colval(x, device), colval(y, device),
                               dtype).cpu()
        check(torch.equal(got, want), f"keys_equal over {name} pairs "
              "differs between the card and the CPU")

    k = 64
    strings = string_planes([HASH_STRINGS[i] for i in
                             rng.integers(0, m, k)], 64)
    arrays = [[rng.integers(-50, 50, k).astype(np.int64)], list(strings),
              [cases["float64"][0][0][:k]]]
    valids = [rng.random(k) < 0.8 for _ in arrays]
    keys = [BoundReference(0, dt.INT64), BoundReference(1, dt.STRING),
            BoundReference(2, dt.FLOAT64)]
    out = []
    for dev in (device, "cpu"):
        cvs = [colval(x, dev, v) for x, v in zip(arrays, valids)]
        h, valid, _ = joins.hash_keys(keys, EvalContext(cvs, k, k, dev))
        out.append((h.cpu(), valid.cpu()))
    check(all(torch.equal(g, w) for g, w in zip(*out)),
          "the three-key hash differs between the card and the CPU")
    emit("hash_device", hash_cases=list(cases), rows_per_case=n,
         keys_equal_pairs={p: len(x[0]) for p, (x, _, _) in pairs.items()},
         multi_key_rows=k)


def join_tables(rng, n_stream: int):
    """A stream side and two build sides, as numpy columns with masks:
    ``unique`` (300 rows, each key once) and ``dup`` (420 rows,
    duplicate keys, NaN of both signs and -0.0 among the float keys),
    with null keys on both sides -> {name: (data, masks)}."""
    n = n_stream
    kf = rng.integers(0, 320, n).astype(np.float64) / 4
    kf[rng.random(n) < 0.05] = np.nan
    kf[rng.random(n) < 0.05] = -0.0
    stream = ({"k": rng.integers(-5, 320, n),
               "ks": np.char.add("key", rng.integers(0, 320, n).astype(str)),
               "kf": kf, "sv": np.arange(n)},
              {"k": rng.random(n) >= 0.05, "ks": rng.random(n) >= 0.05,
               "kf": rng.random(n) >= 0.03})
    u = 300
    perm = rng.permutation(u)
    unique = ({"k": perm.astype(np.int64),
               "ks": np.char.add("key", perm.astype(str)), "kf": perm / 4.0,
               "bv": rng.normal(size=u),
               "bs": np.char.add("b", np.arange(u).astype(str)),
               "bi": np.arange(u)}, None)
    d = 420
    kf = rng.integers(0, 200, d).astype(np.float64) / 4
    kf[:6] = [np.nan, -np.nan, 0.0, -0.0, 0.0, np.nan]
    dup = ({"k": rng.integers(0, 200, d),
            "ks": np.char.add("key", rng.integers(0, 200, d).astype(str)),
            "kf": kf, "bv": rng.normal(size=d),
            "bs": np.char.add("d", np.arange(d).astype(str)),
            "bi": np.arange(d)},
           {"k": rng.random(d) >= 0.05, "ks": rng.random(d) >= 0.05,
            "kf": np.r_[np.ones(6, bool), rng.random(d - 6) >= 0.05]})
    # the last three rows repeat rows 6 to 8 under every key, so each
    # key of the dup build holds a duplicate
    for c in ("k", "ks", "kf"):
        dup[0][c][-3:] = dup[0][c][6:9]
        dup[1][c][6:9] = dup[1][c][-3:] = True
    return {"stream": stream, "unique": unique, "dup": dup}


def _canonical(torch, result):
    """to_torch's result -> ({name: [tensors on the host]}, n), rows
    ordered by the stream row ``sv`` and the build row ``bi`` (which
    together name each output row): floats as their bits, strings as
    lengths and chars zeroed past each length, null rows zeroed.  The
    work runs where the result lies."""
    cols, masks, n = result
    out = {}
    for name, c in cols.items():
        mask = masks[name][:n]
        if isinstance(c, tuple):
            lengths, chars = c[0][:n].to(torch.int64), c[1][:n]
            inside = torch.arange(chars.shape[1], device=chars.device)[
                None, :] < lengths[:, None]
            planes = [lengths, torch.where(inside & mask[:, None], chars, 0)]
        else:
            data = c[:n]
            if data.dtype.is_floating_point:
                data = data.view(torch.int64 if data.element_size() == 8
                                 else torch.int32)
            planes = [data]
        out[name] = [torch.where(mask.view(-1, *[1] * (p.dim() - 1)), p, 0)
                     for p in planes[:1]] + planes[1:] + [mask]
    key = torch.zeros(n, dtype=torch.int64, device=mask.device)
    for c in ("sv", "bi"):
        if c in out:
            data, mask = out[c][0], out[c][-1]
            key = key * (1 << 21) + torch.where(mask, data + 1, 0)
    order = torch.argsort(key)
    return {k: [p[order].cpu() for p in v] for k, v in out.items()}, n


def phase_join_routes(torch, st, session, n_stream: int = (1 << 20) + 3000
                      ) -> None:
    """Every join route and type on the card against the same query in a
    CPU session: the dense FK route, the hashed FK route with a string
    key, and the general route over an integer, a float and a two-key
    (integer and string) key under inner, left, right, full, semi and
    anti joins.  The stream side spans two batches, so right and full
    joins carry their matched-build mask across batches.  Results equal
    exactly, row for row, and each join takes the expected route."""
    cpu = st.TorchSession({"spark.rapids.torch.device": "cpu"})
    tables = join_tables(np.random.default_rng(SEED + 6), n_stream)
    cases = [("unique", "k", "inner", "dense_fk"),
             ("unique", "ks", "inner", "fk")] + [
        ("dup", on, how, "general") for on in ("k", "kf", ("k", "ks"))
        for how in ("inner", "left", "right", "full", "semi", "anti")]
    dfs = {s: {t: s.create_dataframe(*tables[t]) for t in tables}
           for s in (session, cpu)}
    done = []
    for build, on, how, route in cases:
        keys = [on] if isinstance(on, str) else list(on)
        results = {}
        for s in (session, cpu):
            b = dfs[s][build].select(*keys, "bv", "bs", "bi")
            results[s] = _canonical(torch, dfs[s]["stream"].join(
                b, on=on if isinstance(on, str) else keys,
                how=how).to_torch())
        (joins,) = _plan_nodes(session._last_plan,
                               "TorchBroadcastHashJoinExec")
        what = f"{how} join on {'+'.join(keys)} ({build} build)"
        check(joins.route == route,
              f"{what} took the {joins.route} route, not {route}")
        (got, n), (want, n_cpu) = results[session], results[cpu]
        check(n == n_cpu and n > 0, f"{what}: {n} rows, the CPU has {n_cpu}")
        check(list(got) == list(want) and all(
            len(got[c]) == len(want[c]) and all(
                torch.equal(g, w) for g, w in zip(got[c], want[c]))
            for c in got),
            f"{what} differs between the card and the CPU")
        done.append({"on": "+".join(keys), "how": how, "route": route,
                     "rows": n})
    emit("join_routes", stream_rows=n_stream, cases=done)


def _day(text: str) -> int:
    return int(np.datetime64(text, "D").astype(np.int64))


def _texts(torch, lengths_chars, n: int):
    """A string column from to_torch -> its first ``n`` values."""
    lengths, chars = (t[:n].cpu().numpy() for t in lengths_chars)
    return [bytes(r[:ln]).decode("utf-8") for r, ln in zip(chars, lengths)]


def _top(order_keys, limit: int):
    """Row indices of the first ``limit`` rows under ``np.lexsort``'s
    ``order_keys`` (last key most significant)."""
    return np.lexsort(order_keys)[:limit]


def tpch_reference(T, qname: str):
    """numpy's answer to the query over the same tables -> (columns in
    the query's output order, the number of leading rows whose order a
    top-N fixes, or None for a full ordered result)."""
    li, o, c = T["lineitem"], T["orders"], T["customer"]
    ship = li["l_shipdate"].astype(np.int64)
    odate = o["o_orderdate"].astype(np.int64)
    price, disc = li["l_extendedprice"], li["l_discount"]
    vol = price * (1.0 - disc)
    okey = li["l_orderkey"]
    if qname == "q1":
        m = ship <= _day("1998-09-02")
        rf = np.searchsorted(["A", "N", "R"], li["l_returnflag"][m])
        ls = np.searchsorted(["F", "O"], li["l_linestatus"][m])
        g = rf * 2 + ls
        cnt = np.bincount(g, minlength=6)
        keep = np.flatnonzero(cnt)
        qty, p, d = li["l_quantity"][m], price[m], disc[m]

        def s(x):
            return np.bincount(g, x, minlength=6)[keep]
        cnt = cnt[keep]
        dp = p * (1.0 - d)
        return {"l_returnflag": [["A", "N", "R"][k // 2] for k in keep],
                "l_linestatus": [["F", "O"][k % 2] for k in keep],
                "sum_qty": s(qty), "sum_base_price": s(p),
                "sum_disc_price": s(dp),
                "sum_charge": s(dp * (1.0 + li["l_tax"][m])),
                "avg_qty": s(qty) / cnt, "avg_price": s(p) / cnt,
                "avg_disc": s(d) / cnt, "count_order": cnt}, None
    if qname == "q3":
        cust_ok = c["c_mktsegment"] == "BUILDING"
        ord_ok = (odate < _day("1995-03-15")) & cust_ok[o["o_custkey"]]
        m = (ship > _day("1995-03-15")) & ord_ok[okey]
        n_orders = len(odate)
        rev = np.bincount(okey[m], vol[m], minlength=n_orders)
        has = np.bincount(okey[m], minlength=n_orders) > 0
        keys = np.flatnonzero(has)
        top = keys[_top((odate[keys], -rev[keys]), 10)]
        return {"o_orderkey": top, "o_orderdate": odate[top],
                "o_shippriority": o["o_shippriority"][top],
                "revenue": rev[top]}, 10
    if qname == "q5":
        s_nat = T["supplier"]["s_nationkey"][li["l_suppkey"]]
        c_nat = c["c_nationkey"][o["o_custkey"][okey]]
        ord_ok = (odate >= _day("1994-01-01")) & (odate < _day("1995-01-01"))
        asia = T["nation"]["n_regionkey"][s_nat] == 2  # r_name ASIA
        m = ord_ok[okey] & (c_nat == s_nat) & asia
        rev = np.bincount(s_nat[m], vol[m], minlength=25)
        nations = np.flatnonzero(np.bincount(s_nat[m], minlength=25))
        nations = nations[np.argsort(-rev[nations], kind="stable")]
        return {"n_name": [T["nation"]["n_name"][k] for k in nations],
                "revenue": rev[nations]}, None
    if qname == "q6":
        m = ((ship >= _day("1994-01-01")) & (ship < _day("1995-01-01"))
             & (disc >= 0.05) & (disc <= 0.07) & (li["l_quantity"] < 24.0))
        return {"revenue": np.array([np.sum(price[m] * disc[m])])}, None
    if qname == "q10":
        ord_ok = (odate >= _day("1993-10-01")) & (odate < _day("1994-01-01"))
        m = (li["l_returnflag"] == "R") & ord_ok[okey]
        cust = o["o_custkey"][okey[m]]
        n_cust = len(c["c_custkey"])
        rev = np.bincount(cust, vol[m], minlength=n_cust)
        keys = np.flatnonzero(np.bincount(cust, minlength=n_cust))
        top = keys[_top((-rev[keys],), 20)]
        nation = T["nation"]["n_name"]
        return {"c_custkey": top, "c_name": list(c["c_name"][top]),
                "c_acctbal": c["c_acctbal"][top],
                "n_name": list(nation[c["c_nationkey"][top]]),
                "revenue": rev[top]}, 20
    if qname == "q18":
        qty = np.bincount(okey, li["l_quantity"], minlength=len(odate))
        big = np.flatnonzero(qty > 212.0)
        top = big[_top((big, -qty[big]), 100)]
        cust = o["o_custkey"][top]
        return {"c_name": list(c["c_name"][cust]), "c_custkey": cust,
                "o_orderkey": top, "o_orderdate": odate[top],
                "total_qty": qty[top]}, 100
    raise KeyError(qname)


def check_tpch(torch, cols, masks, n: int, want, limit, qname: str,
               tie_key: str = "revenue") -> None:
    """The port's result against the reference's (numpy's, or the CPU
    session's): row count, no nulls, floats within rtol 1e-9, everything
    else exact.  In a top-N (``limit``) ordered by the float ``tie_key``,
    rows whose value ties with a neighbour's within rtol 1e-9 may come in
    either order, so they compare as a set; every other row compares in
    place."""
    rows = len(next(iter(want.values())))
    check(n == rows, f"{qname}: {n} rows, the reference has {rows}")
    check(bool(all(m[:n].all() for m in masks.values())),
          f"{qname}: unexpected nulls")
    tied = np.zeros(rows, bool)
    if limit is not None and tie_key in want:
        near = np.isclose(want[tie_key][1:], want[tie_key][:-1],
                          rtol=1e-9, atol=0)
        tied[1:] |= near
        tied[:-1] |= near
    for name, w in want.items():
        g = cols[name]
        g = np.asarray(_texts(torch, g, n)) if isinstance(g, tuple) \
            else g[:n].cpu().numpy()
        w = np.asarray(w)
        if w.dtype.kind == "f":
            check(np.allclose(g[~tied], w[~tied], rtol=1e-9, atol=0)
                  and np.allclose(np.sort(g[tied]), np.sort(w[tied]),
                                  rtol=1e-9, atol=0),
                  f"{qname}: {name} beyond rtol 1e-9")
            continue
        check(np.array_equal(g[~tied], w[~tied])
              and sorted(g[tied].tolist()) == sorted(w[tied].tolist()),
              f"{qname}: {name} differs from the reference's")


# the float a top-N of the CPU-checked queries orders by, and its limit
TIE_KEYS = {"q11": ("part_value", 100)}


def host_result(torch, result, what: str) -> dict:
    """to_torch's result -> {name: numpy values (strings as str)}, with
    no null allowed."""
    cols, masks, n = result
    check(bool(all(m[:n].all() for m in masks.values())),
          f"{what}: unexpected nulls")
    return {name: np.asarray(_texts(torch, c, n)) if isinstance(c, tuple)
            else c[:n].cpu().numpy() for name, c in cols.items()}


def phase_tpch(torch, st, native, session, T, tables, qname: str,
               runs: int = 2, cpu_tables=None) -> None:
    """One TPC-H query on the card, checked against numpy's version
    (``tpch_reference``) or, given ``cpu_tables``, against the same
    query on a CPU session, run once."""
    from spark_rapids_tpu_torch.bench.tpch import TPCH_QUERIES
    q = TPCH_QUERIES[qname](tables)
    (cols, masks, n), secs = run_timed(torch, q, runs)
    plan = session._last_plan
    cpu_s = None
    if cpu_tables is None:
        want, limit = tpch_reference(T, qname)
        tie_key = "revenue"
    else:
        t0 = time.perf_counter()
        want = host_result(torch, TPCH_QUERIES[qname](cpu_tables).to_torch(),
                           f"{qname} on the CPU")
        cpu_s = time.perf_counter() - t0
        tie_key, limit = TIE_KEYS.get(qname, ("", None))
    check_tpch(torch, cols, masks, n, want, limit, qname, tie_key)
    joins = [(type(j).__name__, j.join_type, j.route)
             for j in _plan_nodes(plan, "TorchBroadcastHashJoinExec")
             + _plan_nodes(plan, "TorchHashJoinExec")]
    aggs = _plan_nodes(plan, "TorchHashAggregateExec")
    rows = len(T["lineitem"]["l_orderkey"])
    emit(f"tpch_{qname}", lineitem_rows=rows, out_rows=n, joins=joins,
         dense_slot_batches=sum(a.metrics["pallasAggBatches"] for a in aggs),
         host_syncs_per_run=host_syncs(plan), seconds=secs,
         rows_per_s=rows / float(np.median(secs)), cpu_seconds=cpu_s)


def phase_repeat_sums(torch, st, F, session, tables, runs: int = 5) -> None:
    """TPC-H Q15's revenue subquery (a float sum a supplier, on the sorted
    path at SF1) several times on the card: the sums must agree bit for
    bit, or Q15's equality with their maximum drops rows.  Beside it, the
    sorted path's segment sum and ``index_add_`` (the atomic add it
    replaced) on 2^18 sorted rows in 60,000 groups, each ``runs`` times:
    the distinct results of each."""
    import datetime
    from spark_rapids_tpu_torch.exec.aggregate import _segment
    rng = np.random.default_rng(SEED + 7)
    gid = torch.from_numpy(np.sort(rng.integers(0, 60_000, 1 << 18))).cuda()
    v = torch.from_numpy(rng.uniform(900, 105_000, 1 << 18)).cuda()

    def distinct(fn):
        return len({fn().view(torch.int64).cpu().numpy().tobytes()
                    for _ in range(runs)})
    segment = distinct(lambda: _segment("add", v, gid, 60_000))
    atomic = distinct(lambda: torch.zeros(60_000, dtype=torch.float64,
                                          device="cuda").index_add_(0, gid, v))
    check(segment == 1, f"the sorted path's sums differ between calls: "
          f"{segment} results of {runs}")
    col, lit = st.col, st.lit
    rev = (tables["lineitem"].filter(
        (col("l_shipdate") >= lit(datetime.date(1996, 1, 1)))
        & (col("l_shipdate") < lit(datetime.date(1996, 4, 1))))
        .select(col("l_suppkey").alias("s_suppkey"),
                (col("l_extendedprice")
                 * (lit(1.0) - col("l_discount"))).alias("v"))
        .group_by("s_suppkey").agg(F.sum(col("v")).alias("total_revenue")))
    seen = set()
    for _ in range(runs):
        cols, _, n = rev.to_torch()
        seen.add(cols["total_revenue"][:n].view(torch.int64).cpu().numpy()
                 .tobytes())
    check(len(seen) == 1, f"q15's revenue sums differ between runs: "
          f"{len(seen)} results of {runs}")
    emit("repeat_sums", query="tpch_q15 revenue", groups=n, runs=runs,
         distinct_results=len(seen), segment_sum_results=segment,
         index_add_results=atomic)


# -- mortgage_etl and the TPCx-BB queries -------------------------------------

MORTGAGE_PERF_ROWS = 600_000   # bench.py:68
TPCXBB_SALES_ROWS = 750_000    # bench.py:69
# a float the TPCx-BB queries order a top-N by, and the limit
TPCXBB_TIE_KEYS = {"q6": ("web_amt", 100), "q13": ("amt_2002", 100),
                   "q25": ("monetary", 100)}


def phase_mortgage(torch, session, cpu, tables, runs: int = 2) -> None:
    """mortgage_etl on the card, checked against the same pipeline on a
    CPU session over the same tables, run once."""
    from spark_rapids_tpu_torch.bench.mortgage import mortgage_etl
    q = mortgage_etl(session, tables)
    (cols, masks, n), secs = run_timed(torch, q, runs)
    plan = session._last_plan
    t0 = time.perf_counter()
    want = host_result(torch, mortgage_etl(cpu, tables).to_torch(),
                       "mortgage_etl on the CPU")
    cpu_s = time.perf_counter() - t0
    check(n > 0, "mortgage_etl: no rows")
    check_tpch(torch, cols, masks, n, want, None, "mortgage_etl")
    loans = len(tables["acq"]["loan_id"])
    check(int(cols["loans"][:n].sum()) == loans,
          "mortgage_etl: the rollup does not count every loan")
    rows = len(tables["perf"]["loan_id"])
    aggs = _plan_nodes(plan, "TorchHashAggregateExec")
    emit("mortgage_etl", perf_rows=rows, loans=loans, out_rows=n,
         joins=[(type(j).__name__, j.join_type, j.route)
                for j in _plan_nodes(plan, "TorchBroadcastHashJoinExec")
                + _plan_nodes(plan, "TorchHashJoinExec")],
         dense_slot_batches=sum(a.metrics["pallasAggBatches"] for a in aggs),
         host_syncs_per_run=host_syncs(plan), seconds=secs,
         rows_per_s=rows / float(np.median(secs)), cpu_seconds=cpu_s)


def phase_tpcxbb(torch, session, cpu, qname: str, sales_rows: int,
                 runs: int = 2) -> None:
    """One TPCx-BB query through ``session.sql`` on the card, checked
    against the same SQL on a CPU session over the same tables, run
    once: integers and strings exact, f64 within rtol 1e-9, rows tied on
    the float a top-N orders by compared as a set."""
    from spark_rapids_tpu_torch.bench.tpcxbb import TPCXBB_QUERIES
    sql = TPCXBB_QUERIES[qname]
    (cols, masks, n), secs = run_timed(torch, session.sql(sql), runs)
    plan = session._last_plan
    t0 = time.perf_counter()
    want = host_result(torch, cpu.sql(sql).to_torch(), f"{qname} on the CPU")
    cpu_s = time.perf_counter() - t0
    tie_key, limit = TPCXBB_TIE_KEYS.get(qname, ("", None))
    check_tpch(torch, cols, masks, n, want, limit, f"tpcxbb_{qname}",
               tie_key)
    joins = _plan_nodes(plan, "TorchBroadcastHashJoinExec") \
        + _plan_nodes(plan, "TorchHashJoinExec")
    aggs = _plan_nodes(plan, "TorchHashAggregateExec")
    emit(f"tpcxbb_{qname}", sales_rows=sales_rows, out_rows=n,
         joins=[(type(j).__name__, j.join_type, j.route,
                 j.condition is not None) for j in joins],
         # pairs the general and cross routes laid out in the last run
         # (each run plans anew), and the batches it probed with a band
         join_candidates_per_run=sum(j.metrics["joinCandidates"]
                                     for j in joins),
         band_probes=sum(j.metrics["bandJoinProbes"] for j in joins),
         dense_slot_batches=sum(a.metrics["pallasAggBatches"] for a in aggs),
         host_syncs_per_run=host_syncs(plan), seconds=secs,
         rows_per_s=sales_rows / float(np.median(secs)), cpu_seconds=cpu_s)


# -- breadth: the expressions behind SQL and functions, at SF1 --------------

# what the breadth phase turns on: the incompatible expressions (upper,
# initcap, rand) and every cast gate that has a device cast
BREADTH_CONF = {"spark.rapids.sql.incompatibleOps.enabled": True,
                "spark.rapids.sql.castStringToInteger.enabled": True,
                "spark.rapids.sql.castStringToFloat.enabled": True,
                "spark.rapids.sql.castStringToTimestamp.enabled": True,
                "spark.rapids.sql.castFloatToString.enabled": True}
BREADTH_CODES = "('13', '31', '23', '29', '30', '18', '17')"

# (name, SQL, whether its floats must repeat bit for bit): TPC-H's own
# text predicates, then each expression family over every lineitem row,
# grouped to a small result
BREADTH_QUERIES = [
    ("tpch_q9_like", """
        SELECT n_name, year(o_orderdate) AS o_year,
               SUM(l_extendedprice * (1 - l_discount)
                   - ps_supplycost * l_quantity) AS sum_profit
        FROM lineitem JOIN part ON l_partkey = p_partkey
          JOIN supplier ON l_suppkey = s_suppkey
          JOIN partsupp ON l_suppkey = ps_suppkey AND l_partkey = ps_partkey
          JOIN orders ON l_orderkey = o_orderkey
          JOIN nation ON s_nationkey = n_nationkey
        WHERE p_name LIKE '%green%'
        GROUP BY n_name, year(o_orderdate)
        ORDER BY n_name, o_year DESC""", False),
    ("tpch_q13_not_like", """
        SELECT c_count, COUNT(*) AS custdist FROM (
          SELECT c_custkey, COUNT(o_orderkey) AS c_count
          FROM customer LEFT JOIN (
            SELECT o_custkey, o_orderkey FROM orders
            WHERE o_comment NOT LIKE '%special%requests%') o
            ON c_custkey = o_custkey
          GROUP BY c_custkey) c_orders
        GROUP BY c_count ORDER BY custdist DESC, c_count DESC""", False),
    ("tpch_q14_like", """
        SELECT 100.0 * SUM(CASE WHEN p_type LIKE 'PROMO%'
                                THEN l_extendedprice * (1 - l_discount)
                                ELSE 0.0 END)
               / SUM(l_extendedprice * (1 - l_discount)) AS promo_revenue
        FROM lineitem JOIN part ON l_partkey = p_partkey
        WHERE l_shipdate >= DATE '1995-09-01'
          AND l_shipdate < DATE '1995-10-01'""", False),
    ("tpch_q16_not_like", """
        SELECT p_brand, p_type, p_size, COUNT(*) AS supplier_cnt FROM (
          SELECT DISTINCT p_brand, p_type, p_size, ps_suppkey
          FROM partsupp JOIN part ON ps_partkey = p_partkey
          WHERE p_brand <> 'Brand#45'
            AND p_type NOT LIKE 'MEDIUM POLISHED%'
            AND p_size IN (49, 14, 23, 45, 19, 3, 36, 9)) ps
        GROUP BY p_brand, p_type, p_size
        ORDER BY supplier_cnt DESC, p_brand, p_type, p_size""", False),
    ("tpch_q22_cross", f"""
        SELECT cntrycode, COUNT(*) AS numcust, SUM(c_acctbal) AS totacctbal
        FROM (
          SELECT substring(c_phone, 1, 2) AS cntrycode, c_acctbal
          FROM customer CROSS JOIN (
            SELECT AVG(c_acctbal) AS avg_bal FROM customer
            WHERE c_acctbal > 0.0
              AND substring(c_phone, 1, 2) IN {BREADTH_CODES}) a
          WHERE substring(c_phone, 1, 2) IN {BREADTH_CODES}
            AND c_acctbal > avg_bal) custsale
        GROUP BY cntrycode ORDER BY cntrycode""", False),
    ("case", """
        SELECT m, ic, COUNT(*) AS n FROM (
          SELECT upper(l_shipmode) AS m, initcap(lower(l_shipmode)) AS ic
          FROM lineitem) x
        GROUP BY m, ic ORDER BY m, ic""", True),
    ("concat_trim_replace", """
        SELECT flags, COUNT(*) AS n, SUM(l_quantity) AS q, MAX(t) AS t,
               MIN(r) AS r, SUM(length(t) + length(r)) AS chars FROM (
          SELECT concat_ws('|', l_returnflag, l_linestatus) AS flags,
                 trim(concat('  ', l_shipmode, ' ')) AS t,
                 replace(l_shipmode, 'AIR', 'air') AS r,
                 l_quantity
          FROM lineitem) x
        GROUP BY flags ORDER BY flags""", False),
    ("comment_regex", """
        SELECT w, COUNT(*) AS n, SUM(sr) AS special, MAX(rr) AS mx,
               SUM(length(rr)) AS chars FROM (
          SELECT substring_index(l_comment, ' ', 1) AS w,
                 CASE WHEN l_comment RLIKE 'special.*requests'
                      THEN 1 ELSE 0 END AS sr,
                 regexp_replace(l_comment, 'the', 'THE') AS rr
          FROM lineitem_text) x
        GROUP BY w ORDER BY w""", True),
    ("casts", """
        SELECT ym, COUNT(*) AS n, SUM(qd) AS q, SUM(same) AS same FROM (
          SELECT substring(CAST(l_shipdate AS STRING), 1, 7) AS ym,
                 CAST(CAST(CAST(l_quantity AS INT) AS STRING) AS DOUBLE)
                   AS qd,
                 CASE WHEN CAST(CAST(l_shipdate AS STRING) AS DATE)
                           = l_shipdate THEN 1 ELSE 0 END AS same
          FROM lineitem) x
        GROUP BY ym ORDER BY ym""", False),
    ("timestamp_hour", """
        SELECT hour(l_ts) AS h, SUM(l_quantity) AS q,
               MAX(l_extendedprice) AS mx, COUNT(*) AS n
        FROM lineitem_ts GROUP BY hour(l_ts) ORDER BY h""", False),
    ("timestamp_parts", """
        SELECT COUNT(*) AS n, SUM(minute(l_ts)) AS mi, SUM(second(l_ts)) AS se,
               MIN(unix_timestamp(l_ts)) AS lo, MAX(unix_timestamp(l_ts)) AS hi,
               SUM(CASE WHEN l_ts >= TIMESTAMP '1995-06-17 12:00:00'
                        THEN 1 ELSE 0 END) AS later,
               MIN(CAST(l_ts AS STRING)) AS first_ts
        FROM lineitem_ts""", False),
    ("math_nan_null_safe", """
        SELECT pm, COUNT(*) AS n, SUM(sq) AS sq, SUM(lg) AS lg, SUM(pw) AS pw,
               MIN(fl) AS fl, MAX(ce) AS ce, SUM(ab) AS ab, SUM(nan) AS nan,
               SUM(nv) AS nv, SUM(eq) AS eq FROM (
          SELECT pmod(l_orderkey, 7) AS pm, sqrt(l_quantity) AS sq,
                 log(l_extendedprice) AS lg, pow(l_tax, 2) AS pw,
                 floor(l_extendedprice / 7) AS fl,
                 ceil(l_extendedprice / 7) AS ce,
                 abs(l_quantity - 25) AS ab,
                 CASE WHEN isnan(sqrt(l_quantity - 25.5)) THEN 1 ELSE 0 END
                   AS nan,
                 nanvl(sqrt(l_quantity - 25.5), -1.0) AS nv,
                 CASE WHEN l_discount <=> 0.05 THEN 1 ELSE 0 END AS eq
          FROM lineitem) x
        GROUP BY pm ORDER BY pm""", False),
    ("first_last_extrema", """
        SELECT COUNT(*) AS groups, SUM(fq) AS fq, SUM(lq) AS lq,
               MIN(fm) AS fm, MAX(lm) AS lm, MIN(mn) AS mn, MAX(mx) AS mx,
               SUM(CASE WHEN mn = mx THEN 1 ELSE 0 END) AS one_mode
        FROM (
          SELECT l_orderkey, first(l_quantity) AS fq, last(l_quantity) AS lq,
                 first(l_shipmode) AS fm, last(l_shipmode) AS lm,
                 min(l_shipmode) AS mn, max(l_shipmode) AS mx
          FROM lineitem GROUP BY l_orderkey) g""", False),
    ("rand_ids", """
        SELECT rand(42) AS r, monotonically_increasing_id() AS id,
               spark_partition_id() AS p
        FROM lineitem LIMIT 1048576""", True),
]


def breadth_sessions(st, tpch, line, device: str = "cuda"):
    """(card session, CPU session), each with BREADTH_CONF and the views
    of the SF1 tables, ``lineitem_text`` (the text queries' lineitem,
    with l_comment) and ``lineitem_ts`` (a TIMESTAMP built here as numpy
    datetime64[us] from l_shipdate and l_orderkey)."""
    from spark_rapids_tpu_torch.bench.tpch import load_tables
    li = tpch["lineitem"]
    days = li["l_shipdate"].astype("datetime64[D]").astype(np.int64)
    okey = li["l_orderkey"]
    us = days * 86_400_000_000 + (okey * 7919 % 86_400) * 1_000_000 \
        + okey % 1_000_000
    ts_table = {"l_orderkey": okey, "l_quantity": li["l_quantity"],
                "l_extendedprice": li["l_extendedprice"],
                "l_ts": us.astype("datetime64[us]")}
    out = []
    for dev in (device, "cpu"):
        s = st.TorchSession({**BREADTH_CONF, "spark.rapids.torch.device": dev})
        for name, df in load_tables(s, tpch).items():
            df.create_or_replace_temp_view(name)
        s.create_dataframe(line).create_or_replace_temp_view("lineitem_text")
        s.create_dataframe(ts_table).create_or_replace_temp_view(
            "lineitem_ts")
        out.append(s)
    return out


def to_device(result, device):
    """A ``to_torch`` result's planes moved to ``device``."""
    cols, masks, n = result
    move = (lambda t: tuple(x.to(device) for x in t)
            if isinstance(t, tuple) else t.to(device))
    return ({k: move(v) for k, v in cols.items()},
            {k: v.to(device) for k, v in masks.items()}, n)


def phase_breadth(torch, st, gpu, cpu, runs: int = 2) -> None:
    """Each breadth query through ``session.sql`` on the card (one
    warm-up, ``runs`` timed) against the same SQL on the CPU session:
    integers, strings, booleans, dates and timestamps exact; rand and
    the queries marked so bit for bit; other f64 within rtol 1e-9 (the
    two devices' sums and transcendental functions may round apart)."""
    for qname, sql, bitwise in BREADTH_QUERIES:
        (cols, masks, n), secs = run_timed(torch, gpu.sql(sql), runs)
        plan = gpu._last_plan
        t0 = time.perf_counter()
        device = next(iter(masks.values())).device
        want = to_device(cpu.sql(sql).to_torch(), device)
        cpu_s = time.perf_counter() - t0
        check(n > 0, f"breadth {qname}: no rows")
        floats_alike = same_result(torch, want, (cols, masks, n),
                                   f"breadth {qname}",
                                   float_rtol=0.0 if bitwise else 1e-9)
        joins = _plan_nodes(plan, "TorchBroadcastHashJoinExec") \
            + _plan_nodes(plan, "TorchHashJoinExec")
        aggs = _plan_nodes(plan, "TorchHashAggregateExec")
        emit("breadth", query=qname, out_rows=n,
             joins=[(j.join_type, j.route) for j in joins],
             dense_slot_batches=sum(a.metrics["pallasAggBatches"]
                                    for a in aggs),
             floats_bit_for_bit=floats_alike,
             host_syncs_per_run=host_syncs(plan), seconds=secs,
             cpu_seconds=cpu_s)


# -- window_1m ---------------------------------------------------------------

def window_query(st, F, df):
    """bench.py:q_window: row_number and a running sum of v over each
    partition of k in the order of v, then each partition's first five
    rows."""
    w = st.Window.partition_by("k").order_by("v")
    return (df.with_column("rn", F.row_number().over(w))
              .with_column("run", F.sum(st.col("v")).over(w))
              .filter(st.col("rn") <= 5))


def window_reference(main):
    """numpy's answer to window_query -> (the input rows of the result, in
    input order; their rn; their running sums; the sum of |v| over the
    sorted rows up to each)."""
    k, v = main["k"], main["v"]
    order = np.lexsort((v, k))  # stable, as the port's sort is
    ks, vs = k[order], v[order]
    # no two rows tie on (k, v), so each row's frame ends at itself
    check(not np.any((ks[1:] == ks[:-1]) & (vs[1:] == vs[:-1])),
          "rows tie on (k, v)")
    start = np.r_[True, ks[1:] != ks[:-1]]
    first = np.flatnonzero(start)
    rn = np.arange(len(k)) - first[np.cumsum(start) - 1] + 1
    idx = np.flatnonzero(rn <= 5)
    run = vs[idx].copy()
    for j in range(2, 6):  # each partition's rows 2 to 5 follow row j - 1
        at = np.flatnonzero(rn[idx] == j)
        run[at] += run[at - 1]
    scale = np.cumsum(np.abs(vs))[idx]
    back = np.argsort(order[idx])
    return order[idx][back], rn[idx][back], run[back], scale[back]


def check_window(result, main) -> np.ndarray:
    """window_query's result against numpy's (``window_reference``): the
    rows and rn exact, each running sum within 1e-10 of its prefix of
    |v| -> the running sums' errors."""
    cols, masks, n = result
    rows, rn, run, scale = window_reference(main)
    check(n == len(rows), f"window_1m: {n} rows, numpy has {len(rows)}")
    check(bool(all(m[:n].all() for m in masks.values())),
          "window_1m: unexpected nulls")
    for c in ("k", "v", "w"):
        check(np.array_equal(cols[c][:n].cpu().numpy(), main[c][rows]),
              f"window_1m: {c} differs from numpy's rows")
    check(np.array_equal(cols["rn"][:n].cpu().numpy(), rn),
          "window_1m: rn differs from numpy's")
    err = np.abs(cols["run"][:n].cpu().numpy() - run)
    check(bool(np.all(err <= 1e-10 * scale)),
          "window_1m: a running sum is off by more than 1e-10 of its "
          "prefix of |v|")
    return err / scale


def phase_window(torch, st, F, session, main, runs: int = 3) -> None:
    q = window_query(st, F, session.create_dataframe(main))
    (cols, masks, n), secs = run_timed(torch, q, runs)
    rows, _, run, scale = window_reference(main)
    check_window((cols, masks, n), main)
    err = np.abs(cols["run"][:n].cpu().numpy() - run)
    plan = session._last_plan
    check(len(_plan_nodes(plan, "TorchWindowExec")) == 2,
          "window_1m: not two window execs")
    rows_in = len(main["k"])
    emit("window_1m", rows=rows_in, out_rows=n,
         partitions=int(np.unique(main["k"]).size),
         max_run_err=float(err.max()), max_run_rel=float(
             (err / scale).max()),
         host_syncs_per_run=host_syncs(plan), seconds=secs,
         rows_per_s=rows_in / float(np.median(secs)))


def idle_gaps(events, top: int = 5):
    """The longest stretches between device entries of a trace in which
    the card ran nothing -> [{ms, after, before}], longest first."""
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in events)
    gaps = []
    if spans:
        end, last = spans[0][1], spans[0][2]
        for start, stop, what in spans[1:]:
            if start > end:
                gaps.append((start - end, last, what))
            if stop > end:
                end, last = stop, what
    gaps.sort(reverse=True)
    return [{"ms": g / 1e3, "after": a[:60], "before": b[:60]}
            for g, a, b in gaps[:top]]


def phase_trace(torch, query, name: str, top: int = 8,
                expect: str = "") -> None:
    """One run of ``query`` under torch.profiler: its wall seconds, the
    card's busy seconds (kernels and copies), the largest device entries,
    the longest idle gaps between them, and the host time and device span
    of each of the port's named ranges (the join's build and route, the
    window's sort and evaluation), so the device's idle share shows how
    far the host holds the card back and the ranges what a join or a
    window takes of it.  Fails when no host range starting with
    ``expect`` (``join.``, ``window.``) shows in the trace."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        query.to_torch()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    averages = prof.key_averages()
    # the port's named ranges (join.build, window.sort, ...) appear twice: as
    # host ranges, and as device spans around what they launched, which
    # are not device work of their own
    dev = [e for e in averages if e.device_type == DeviceType.CUDA
           and not e.key.startswith(RANGES)]
    busy = sum(e.self_device_time_total for e in dev) / 1e6
    # kernels whose names share their first 80 characters add up
    by_name = {}
    for e in dev:
        by_name[e.key[:80]] = by_name.get(e.key[:80], 0.0) \
            + e.self_device_time_total
    tops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    ranges = {}
    for e in averages:
        if e.key.startswith(RANGES):
            r = ranges.setdefault(e.key, {})
            if e.device_type == DeviceType.CUDA:
                r["device_span_ms"] = e.self_device_time_total / 1e3
            else:
                r["count"] = e.count
                r["host_ms"] = e.cpu_time_total / 1e3
    emit("trace", query=name, wall_s=wall, device_busy_s=busy,
         device_idle_share=1.0 - busy / wall, top_device_us=dict(tops),
         ranges=ranges,
         idle_gaps=idle_gaps([e for e in prof.events()
                              if e.device_type == DeviceType.CUDA
                              and not e.name.startswith(RANGES)]))
    check(not expect or any(k.startswith(expect) and "host_ms" in r
                            for k, r in ranges.items()),
          f"{name}: no {expect}* range in the trace")


# -- the memory phase --------------------------------------------------------

def fresh_session(st, conf=None):
    """A session on a runtime of its own (every runtime reset first), so
    its spill catalog's budget and counters are this run's."""
    from spark_rapids_tpu_torch.runtime import TorchRuntime
    TorchRuntime.reset()
    return st.TorchSession(conf or {})


def same_result(torch, a, b, what: str, float_rtol=0.0) -> bool:
    """Two ``to_torch`` results alike: the same rows, and every plane
    bit for bit (strings: lengths and chars), except the float planes
    when ``float_rtol`` is a tolerance (they agree within it) or None
    (the caller checks them another way) -> whether every plane is bit
    for bit alike."""
    (ca, ma, na), (cb, mb, nb) = a, b
    check(na == nb, f"{what}: {na} rows against {nb}")
    bitwise = True
    for name in ca:
        check(torch.equal(ma[name][:na], mb[name][:nb]),
              f"{what}: the nulls of {name} differ")
        x, y = ca[name], cb[name]
        if isinstance(x, tuple):
            check(torch.equal(x[0][:na], y[0][:nb])
                  and torch.equal(x[1][:na], y[1][:nb]),
                  f"{what}: the strings of {name} differ")
        elif x.dtype.is_floating_point:
            bits = torch.int32 if x.element_size() == 4 else torch.int64
            same = torch.equal(x[:na].view(bits), y[:nb].view(bits))
            bitwise = bitwise and same
            if float_rtol == 0.0:
                check(same, f"{what}: {name} differs bit for bit")
            elif float_rtol is not None:
                check(bool(torch.allclose(x[:na], y[:nb], rtol=float_rtol,
                                          atol=0.0, equal_nan=True)),
                      f"{what}: {name} beyond rtol {float_rtol}")
        else:
            check(torch.equal(x[:na], y[:nb]), f"{what}: {name} differs")
    return bitwise


def tier_runs(torch, st, build, name: str, verify,
              float_rtol=None) -> None:
    """``build(session)``'s query at the default budget, then with the
    device budget at a quarter of the first run's catalog peak and the
    host tier at an eighth of it: bytes reach the host and the disk.
    ``verify`` holds each run to the reference; the two runs' integers,
    strings and nulls are equal, and their floats too with
    ``float_rtol=0.0`` (else whether they are bit for bit alike is
    printed)."""
    runs = []
    conf = None
    for budget in ("default", "quarter"):
        s = fresh_session(st, conf)
        q = build(s)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = q.to_torch()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        verify(out)
        cat = s.runtime.catalog
        check(cat.audit_leaks() == 0, f"{name}: handles left registered")
        runs.append({"budget": budget,
                     "device_budget_bytes": cat.device_budget,
                     "host_budget_bytes": cat.host_budget,
                     "seconds": secs, **cat.stats()})
        if budget == "default":
            want, peak = out, cat.peak_device_bytes
            check(cat.spill_to_host_count == 0,
                  f"{name}: spilled at the default budget")
            conf = {"spark.rapids.memory.tpu.budgetBytes": peak // 4,
                    "spark.rapids.memory.host.spillStorageSize": peak // 8}
        else:
            bitwise = same_result(torch, want, out, f"{name} spilled",
                                  float_rtol=float_rtol)
            check(cat.spill_to_host_bytes > 0 and cat.spill_to_disk_bytes > 0
                  and cat.unspill_count > 0,
                  f"{name}: the quarter budget moved no bytes to the host "
                  f"and the disk: {cat.stats()}")
    emit("memory_tiers", query=name, peak_device_bytes=peak,
         floats_bit_for_bit=bitwise, runs=runs)


class OomCounter:
    """Wraps the port's ``is_device_oom`` to count the real
    ``torch.OutOfMemoryError``s ``with_retry`` catches (instrumentation of
    this script; the package counts nothing of the kind)."""

    def __init__(self, torch, retry):
        self.torch, self.retry = torch, retry
        self.real = retry.is_device_oom
        self.caught = 0

    def __enter__(self):
        def counting(e):
            ok = self.real(e)
            if ok and isinstance(e, self.torch.OutOfMemoryError):
                self.caught += 1
            return ok
        self.retry.is_device_oom = counting
        return self

    def __exit__(self, *exc):
        self.retry.is_device_oom = self.real
        return False


def phase_oom_retry(torch, st, session) -> None:
    """A real out-of-memory error inside ``with_retry``: a function whose
    peak is two (rows, 512) int64 temporaries (8 GiB for 2^20 rows, 4 GiB
    for a half) under a ballast that leaves 6 GiB free.  The whole batch
    fails, relief does not help, the halves fit; their results equal the
    unsplit call's off the ballast, the failed attempt's memory is back
    before the next attempt starts, and the ballast's memory is back
    after it is freed."""
    from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
    from spark_rapids_tpu_torch.columnar.column import DeviceColumn
    from spark_rapids_tpu_torch.columnar.dtypes import INT64
    from spark_rapids_tpu_torch.exec.base import ExecContext
    from spark_rapids_tpu_torch.utils import retry
    n, width = 1 << 20, 512
    temp = n * width * 8
    x = torch.arange(n, dtype=torch.int64, device="cuda") % 1999 - 999
    w = torch.arange(1, width + 1, dtype=torch.int64, device="cuda")
    batch = ColumnarBatch([DeviceColumn(
        INT64, x, torch.ones(n, dtype=torch.bool, device="cuda"), n)], n)
    entry, rows, splits = [], [], []

    def fn(b):
        entry.append(torch.cuda.memory_allocated())
        rows.append(b.num_rows)
        v = b.columns[0].data[:b.num_rows]
        t1 = v[:, None] * w[None, :]
        t2 = t1 + v[:, None]
        return t2.sum(1) - t1.sum(1) * 2

    def split(b):
        splits.append(b.num_rows)
        return retry.split_batch_half(b)

    want = fn(batch)
    entry.clear()
    rows.clear()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    free0, total = torch.cuda.mem_get_info()
    ballast = torch.empty(free0 - temp * 3 // 2, dtype=torch.uint8,
                          device="cuda")
    left = torch.cuda.mem_get_info()[0]
    ctx = ExecContext(session.conf, session.device)
    with OomCounter(torch, retry) as oom:
        got = retry.with_retry(fn, batch, ctx, split=split)
    torch.cuda.synchronize()
    del ballast
    torch.cuda.empty_cache()
    free1 = torch.cuda.mem_get_info()[0]
    check(oom.caught == 2, f"with_retry caught {oom.caught} real "
          "out-of-memory errors, not 2 (the whole batch, then after relief)")
    check(splits == [n] and rows == [n, n, n // 2, n // 2],
          f"attempts over {rows} rows, splits of {splits}")
    check(entry[1] <= entry[0], "the failed attempt's memory was not back "
          f"before the next attempt: {entry[0]} then {entry[1]} bytes")
    check(torch.equal(torch.cat(got), want),
          "the halves' results differ from the unsplit call's")
    check(free1 >= free0 - (256 << 20), f"{free0 - free1} bytes not back "
          "after the ballast was freed")
    emit("oom_retry", rows=n, temp_bytes=temp, total_bytes=total,
         free_bytes=free0, free_under_ballast=left, caught=oom.caught,
         attempt_rows=rows, allocated_at_attempts=entry,
         free_after_bytes=free1)


def phase_oom_query(torch, st, F, data) -> None:
    """A real out-of-memory error in hash_agg_32m's aggregate: with
    2^24-row update batches, the first batch's update runs under a
    ballast that leaves three quarters of that update's peak (measured
    on a run without it), so the whole batch fails and its halves, views
    of it, fit.  The result equals the run without a ballast: keys,
    counts and maxima exact, sums within rtol 1e-9 (the halves' partials
    add in another order)."""
    from spark_rapids_tpu_torch.exec import aggregate as agg_mod
    from spark_rapids_tpu_torch.utils import retry
    real = agg_mod.with_retry
    conf = {"spark.rapids.sql.batchSizeRows": 1 << 24}
    peaks = []

    def measuring(fn, batch, ctx=None, split=None, max_depth=3):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = real(fn, batch, ctx, split, max_depth)
        torch.cuda.synchronize()
        peaks.append(torch.cuda.max_memory_allocated() - base)
        return out

    state = {"first": True, "left": 0}

    def ballasted(fn, batch, ctx=None, split=None, max_depth=3):
        if not state["first"]:
            return real(fn, batch, ctx, split, max_depth)
        state["first"] = False
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        free = torch.cuda.mem_get_info()[0]
        ballast = torch.empty(max(0, free - peaks[0] * 3 // 4),
                              dtype=torch.uint8, device="cuda")
        state["left"] = torch.cuda.mem_get_info()[0]
        try:
            return real(fn, batch, ctx, split, max_depth)
        finally:
            # give the ballast's segment back: left in the cache, later
            # tensors split it, it can never be released, and the
            # allocator finds no room for a new segment of small blocks
            del ballast
            torch.cuda.empty_cache()

    results, secs, dense = [], [], []
    for hook in (measuring, ballasted):
        s = fresh_session(st, conf)
        q = agg_query(st, F, s.create_dataframe(data))
        agg_mod.with_retry = hook
        try:
            with OomCounter(torch, retry) as oom:
                t0 = time.perf_counter()
                results.append(q.to_torch())
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
        finally:
            agg_mod.with_retry = real
        (agg,) = _plan_nodes(s._last_plan, "TorchHashAggregateExec")
        dense.append(agg.metrics["pallasAggBatches"])
        if hook is measuring:
            check(oom.caught == 0, "an out-of-memory error without ballast")
    check(oom.caught >= 1, "no out-of-memory error caught under the ballast")
    check(dense == [2, 3], f"dense-slot update batches {dense}: the first "
          "batch did not split into two halves on the kernel")
    same_result(torch, results[0], results[1], "hash_agg_32m under ballast",
                float_rtol=1e-9)
    emit("oom_query", query="hash_agg_32m", rows=len(data["k"]),
         batch_rows=1 << 24, update_peak_bytes=peaks[0],
         free_under_ballast=state["left"], caught=oom.caught,
         dense_batches=dense, seconds=secs)


class Inject:
    """Makes a retry site raise ``torch.OutOfMemoryError`` on its first
    ``fails`` calls, by wrapping the function the site runs (``owner``'s
    ``attr``; ``made``: wrap what that factory returns instead); records
    the rows of each call."""

    def __init__(self, torch, owner, attr, fails: int, rows_at,
                 made: bool = False):
        self.torch, self.owner, self.attr = torch, owner, attr
        self.left, self.rows_at, self.made = fails, rows_at, made
        self.real = getattr(owner, attr)
        self.rows = []

    def _wrap(self, fn):
        def wrapper(*a, **k):
            self.rows.append(self.rows_at(a))
            if self.left > 0:
                self.left -= 1
                raise self.torch.OutOfMemoryError(
                    "CUDA out of memory (injected by chip_smoke)")
            return fn(*a, **k)
        return wrapper

    def __enter__(self):
        if self.made:
            real = self.real

            def factory(*a, **k):
                fn = real(*a, **k)
                # the aggregate's merge makes its function here too
                if len(a) > 1 and a[1] == "merge":
                    return fn
                return self._wrap(fn)
            setattr(self.owner, self.attr, factory)
        else:
            setattr(self.owner, self.attr, self._wrap(self.real))
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.attr, self.real)
        return False


def sorted_agg_query(st, F, df):
    """An aggregate by two keys, so it takes the sorted-segment route."""
    col = st.col
    return (df.group_by(col("k"), (col("v") > 0.0).alias("pos"))
              .agg(F.count(col("v")).alias("cnt"), F.sum(col("v")).alias("s"),
                   F.max(col("w")).alias("mx")))


def phase_inject(torch, st, F, session, main, agg_data, dim) -> None:
    """Every retry site raises ``torch.OutOfMemoryError`` on the card,
    twice where a split follows (the attempt and the one after relief),
    once where the input must stay whole; each query equals its run
    without the error (bit for bit, the window's running sums too; an
    aggregate's float sums within rtol 1e-9, since its halves' partials
    add in another order)."""
    from spark_rapids_tpu_torch.exec import aggregate as agg_mod
    from spark_rapids_tpu_torch.exec import pallas_agg as pag_mod
    from spark_rapids_tpu_torch.exec import sort as sort_mod
    from spark_rapids_tpu_torch.exec import stage as stage_mod
    from spark_rapids_tpu_torch.exec.joins import TorchHashJoinExec
    from spark_rapids_tpu_torch.exec.window import TorchWindowExec
    col = st.col
    main_df = session.create_dataframe(main)
    agg_df = session.create_dataframe(agg_data)
    dim_df = session.create_dataframe(dim)

    def project(df):
        return (df.filter((col("v") > 0.0) & (col("k") < 900))
                  .select((col("v") * 2.0 + 1.0).alias("a"), col("k")))

    def batch_rows(i):
        return lambda a: a[i].num_rows

    sites = [
        ("stage", project(main_df), stage_mod, "emit_steps", 2,
         lambda a: a[2], False),
        ("aggregate_dense", agg_query(st, F, agg_df), pag_mod,
         "make_update", 2, lambda a: a[1], True),
        ("aggregate_sorted", sorted_agg_query(st, F, agg_df), agg_mod,
         "make_agg_body", 2, lambda a: a[1], True),
        ("join_fk", hash_join_query(st, F, main_df, dim_df),
         TorchHashJoinExec, "_fk", 2, batch_rows(1), False),
        ("join_general", main_df.join(dim_df, on="k", how="left")
         .group_by(col("grp")).agg(F.sum(col("v")).alias("s")),
         TorchHashJoinExec, "_general", 2, batch_rows(1), False),
        ("sort", agg_df.order_by(col("v")), sort_mod, "sort_batch", 1,
         batch_rows(1), False),
        ("window", window_query(st, F, main_df), TorchWindowExec, "_window",
         1, batch_rows(1), False),
    ]
    out = []
    for name, q, owner, attr, fails, rows_at, made in sites:
        want = q.to_torch()
        with Inject(torch, owner, attr, fails, rows_at, made) as inj:
            got = q.to_torch()
        torch.cuda.synchronize()
        check(inj.left == 0, f"{name}: the injected error never fired")
        if fails == 2:
            whole = inj.rows[0]
            check(inj.rows[1] == whole and sorted(inj.rows[2:4]) == sorted(
                [whole // 2, whole - whole // 2]),
                f"{name}: attempts over {inj.rows} rows, not a split")
        else:
            check(inj.rows[:2] == [inj.rows[0]] * 2,
                  f"{name}: attempts over {inj.rows} rows")
        if name == "window":
            check_window(want, main)
            check_window(got, main)
        bitwise = same_result(
            torch, want, got, f"{name} after an injected error",
            float_rtol=1e-9 if name.startswith("aggregate") else 0.0)
        out.append({"site": name, "fails": fails,
                    "attempt_rows": inj.rows[:4], "out_rows": got[2],
                    "floats_bit_for_bit": bitwise})
    emit("inject", sites=out)


def phase_lookahead(torch, st, F, main, agg_data, dim) -> None:
    """The coalesce's background pull (off by default) turned on:
    hash_agg_sort_2m and hash_join_1m through it equal to the default
    run, each with batches pulled on the pull's thread."""
    def pulled(plan):
        return plan.metrics.get("prefetchBatches", 0) + sum(
            pulled(c) for c in plan.children)

    out = []
    for name, make in (
            ("hash_agg_sort_2m",
             lambda s: agg_query(st, F, s.create_dataframe(agg_data))),
            ("hash_join_1m",
             lambda s: hash_join_query(st, F, s.create_dataframe(main),
                                       s.create_dataframe(dim)))):
        want = make(st.TorchSession()).to_torch()
        on = st.TorchSession({"spark.rapids.sql.io.prefetch.enabled": True})
        got = make(on).to_torch()
        n = pulled(on._last_plan)
        check(n > 0, f"{name}: no batch went through the pull")
        bitwise = same_result(torch, want, got, f"{name} with the pull on",
                              float_rtol=1e-9)
        out.append({"query": name, "batches_pulled": n,
                    "floats_bit_for_bit": bitwise})
    emit("lookahead", queries=out)


def phase_memory(torch, st, F, session, main, agg_data, dim, big, tpch
                 ) -> None:
    """The memory phase: tiers at full size, a real out-of-memory error
    inside ``with_retry`` and inside hash_agg_32m's aggregate, injected
    errors at every retry site, two queries through the background pull;
    no thread of the port's left after it."""
    from spark_rapids_tpu_torch.bench.tpch import TPCH_QUERIES, load_tables
    from spark_rapids_tpu_torch.io.prefetch import THREAD_PREFIX
    # the window's float running sums add in a fixed order: bit for bit
    tier_runs(torch, st, lambda s: window_query(
        st, F, s.create_dataframe(main)), "window_1m",
        lambda out: check_window(out, main), float_rtol=0.0)
    want, limit = tpch_reference(tpch, "q18")
    tier_runs(torch, st, lambda s: TPCH_QUERIES["q18"](
        load_tables(s, tpch)), "tpch_q18",
        lambda out: check_tpch(torch, *out, want, limit, "q18"))
    phase_oom_retry(torch, st, session)
    phase_oom_query(torch, st, F, big)
    phase_inject(torch, st, F, fresh_session(st), main, agg_data, dim)
    phase_lookahead(torch, st, F, main, agg_data, dim)
    left = [t.name for t in threading.enumerate()
            if t.name.startswith(THREAD_PREFIX)]
    check(not left, f"threads of the port left: {left}")
    emit("memory_threads", port_threads_left=left)


# -- the operators phase -----------------------------------------------------

RANGE_ROWS = 20 << 22   # Spark's AggregateBenchmark: N = 20 << 22
SHIP_INSTRUCT = ["DELIVER IN PERSON", "COLLECT COD", "NONE",
                 "TAKE BACK RETURN"]  # TPC-H's L_SHIPINSTRUCT values


def operator_tables(tpch, seed: int = SEED + 12):
    """Phase 11's tables with what TPC-H defines and ``gen_tpch_numpy``
    leaves out: lineitem's ``l_linenumber`` (1, 2, ... within each order,
    in row order) and ``l_shipinstruct`` (drawn from ``seed``), orders'
    ``o_totalprice`` (the sum over its lines of extendedprice x (1 + tax)
    x (1 - discount), to the cent)."""
    li, od = dict(tpch["lineitem"]), dict(tpch["orders"])
    okey = li["l_orderkey"]
    order = np.argsort(okey, kind="stable")
    ks = okey[order]
    start = np.r_[True, ks[1:] != ks[:-1]]
    first = np.flatnonzero(start)
    line = np.empty(len(okey), np.int32)
    line[order] = np.arange(len(okey)) - first[np.cumsum(start) - 1] + 1
    li["l_linenumber"] = line
    rng = np.random.default_rng(seed)
    li["l_shipinstruct"] = np.array(SHIP_INSTRUCT)[
        rng.integers(0, len(SHIP_INSTRUCT), len(okey))]
    charge = li["l_extendedprice"] * (1 + li["l_tax"]) \
        * (1 - li["l_discount"])
    od["o_totalprice"] = np.round(np.bincount(
        okey, weights=charge, minlength=len(od["o_orderkey"])), 2)
    return {**tpch, "lineitem": li, "orders": od}


def bitwise(name: str, st, *args):
    """A bitwise expression of the port as a Column (neither functions
    nor SQL reaches them, as in the JAX package)."""
    from spark_rapids_tpu_torch.exprs import bitwise as bw
    return st.Column(getattr(bw, name)(*[
        a.expr if isinstance(a, st.Column) else st.lit(a).expr
        for a in args]))


def op_range_linear(st, F, s, rows: int = RANGE_ROWS):
    idc = st.col("id")
    return (s.range(rows)
            .select(idc, bitwise("BitwiseAnd", st, idc, 65535).alias("k"))
            .group_by("k").agg(F.sum(idc).alias("s")))


def op_range_512(st, F, s, rows: int = RANGE_ROWS):
    # AggregateBenchmark's 1,000-key shape cut to 512 keys: with the null
    # slot, 513 of the kernel's 1024 slots (keys 0 to 1023 would need
    # 1025, and both packages route those to the sorted path)
    idc = st.col("id")
    return (s.range(rows)
            .select(idc, bitwise("BitwiseAnd", st, idc, 511).alias("k"))
            .group_by("k").agg(F.count(idc).alias("n"),
                               F.sum(idc).alias("s"), F.avg(idc).alias("a")))


def op_rollup_q1(st, F, t):
    import datetime as dt
    col, lit = st.col, st.lit
    disc_price = col("l_extendedprice") * (lit(1.0) - col("l_discount"))
    charge = disc_price * (lit(1.0) + col("l_tax"))
    return (t["lineitem"]
            .filter(col("l_shipdate") <= lit(dt.date(1998, 9, 2)))
            .rollup("l_returnflag", "l_linestatus")
            .agg(F.sum(col("l_quantity")).alias("sum_qty"),
                 F.sum(col("l_extendedprice")).alias("sum_base_price"),
                 F.sum(disc_price).alias("sum_disc_price"),
                 F.sum(charge).alias("sum_charge"),
                 F.avg(col("l_quantity")).alias("avg_qty"),
                 F.avg(col("l_extendedprice")).alias("avg_price"),
                 F.avg(col("l_discount")).alias("avg_disc"),
                 F.count(lit(1)).alias("count_order"),
                 F.grouping_id().alias("gid"))
            .order_by("l_returnflag", "l_linestatus", "gid"))


def op_cube_shipmode(st, F, t):
    col = st.col
    return (t["lineitem"].cube("l_shipmode", "l_linenumber")
            .agg(F.sum(col("l_extendedprice")).alias("price"),
                 F.avg(col("l_discount")).alias("disc"),
                 F.count("*").alias("n"), F.grouping_id().alias("gid"))
            .order_by("l_shipmode", "l_linenumber", "gid"))


def op_union_channels(st, F, t):
    col, lit = st.col, st.lit
    li, od = t["lineitem"], t["orders"]
    amt = col("l_extendedprice") * (lit(1.0) - col("l_discount"))
    line = li.select(col("l_shipdate").alias("d"), amt.alias("amt"),
                     lit("line").alias("tag"))
    orders = od.select(col("o_orderdate").alias("d"),
                       col("o_totalprice").alias("amt"),
                       lit("order").alias("tag"))
    returns = li.filter(col("l_returnflag") == lit("R")).select(
        col("l_shipdate").alias("d"), (-amt).alias("amt"),
        lit("return").alias("tag"))
    return (line.union(orders).union(returns)
            .group_by("tag", F.year(col("d")).alias("yr"))
            .agg(F.sum(col("amt")).alias("amt"), F.count("*").alias("n"))
            .order_by("tag", "yr"))


def op_explode_horizons(st, F, t):
    col = st.col
    return (t["orders"]
            .select("o_orderkey", "o_orderdate", "o_totalprice",
                    F.posexplode(F.array(7, 30, 90)))
            .with_column("due", F.date_add(col("o_orderdate"), "col"))
            .group_by("pos")
            .agg(F.count("*").alias("n"),
                 F.sum(col("o_totalprice")).alias("value"),
                 F.min(col("due")).alias("first_due"),
                 F.max(col("due")).alias("last_due"))
            .order_by("pos"))


def op_explode_outer_nation(st, F, t):
    return t["nation"].select("n_nationkey", "n_name", F.explode_outer(
        F.array(elem_dtype="int")).alias("h"))


def op_repartition_hash(st, F, t):
    return t["orders"].repartition(16, "o_custkey").select(
        "o_orderkey", "o_custkey", F.spark_partition_id().alias("pid"))


def op_repartition_rr(st, F, t):
    return t["orders"].repartition(16).select(
        "o_orderkey", "o_custkey", F.spark_partition_id().alias("pid"))


def op_repartition_range(st, F, t):
    return t["orders"].repartition_by_range(
        16, st.col("o_totalprice").desc()).select(
        "o_orderkey", "o_totalprice", F.spark_partition_id().alias("pid"))


def window_frame_cols(st, F) -> dict:
    """window_frames' six window functions, by their output names."""
    col, W = st.col, st.Window
    spec = W.partition_by("l_suppkey").order_by(
        "l_shipdate", "l_orderkey", "l_linenumber")
    by_day = W.partition_by("l_suppkey").order_by("l_shipdate")
    return {
        "min_price": F.min(col("l_extendedprice")).over(
            spec.rows_between(-3, 3)),
        "max_disc": F.max(col("l_discount")).over(spec.rows_between(
            W.unboundedPreceding, W.currentRow)),
        "last_tax": F.last(col("l_tax")).over(spec.rows_between(
            W.currentRow, W.unboundedFollowing)),
        "first_qty": F.first(col("l_quantity")).over(
            by_day.range_between(-30, 0)),
        "prev_mode": F.lag(col("l_shipmode")).over(spec),
        "max_instruct": F.max(col("l_shipinstruct")).over(
            spec.rows_between(-5, 0))}


def op_window_frames(st, F, t, only=None):
    """window_frames; with ``only`` (names of ``window_frame_cols``) just
    those functions."""
    cols = [c.alias(n) for n, c in window_frame_cols(st, F).items()
            if only is None or n in only]
    return (t["lineitem"].select("l_orderkey", "l_linenumber", *cols)
            .order_by("l_orderkey", "l_linenumber"))


def window_peaks(torch, st, F, t) -> None:
    """window_frames' peak device memory split by what holds it: the
    query with no window function (the scan, the sort by key and the
    result), then each function alone, as bytes above the memory held
    before the run."""
    out = {}
    for name in [None] + list(window_frame_cols(st, F)):
        q = op_window_frames(st, F, t, only=[] if name is None else [name])
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        q.to_torch()
        torch.cuda.synchronize()
        out[name or "no_window"] = int(torch.cuda.max_memory_allocated()
                                       - base)
    emit("window_peaks", bytes_above_resident=out)


def op_bitwise_keys(st, F, t):
    col = st.col
    return (t["lineitem"].select(
        bitwise("BitwiseAnd", st, col("l_orderkey"), 7).alias("k"),
        bitwise("BitwiseXor", st, bitwise(
            "BitwiseAnd", st, col("l_orderkey"), 255), col("l_partkey"))
        .alias("x"),
        bitwise("ShiftLeft", st, col("l_partkey"), 3).alias("shl"),
        bitwise("BitwiseNot", st, col("l_suppkey")).alias("inv"),
        bitwise("ShiftRightUnsigned", st, -col("l_orderkey"), 5)
        .alias("shru"))
        .group_by("k")
        .agg(F.sum(col("x")).alias("x"), F.sum(col("shl")).alias("shl"),
             F.sum(col("inv")).alias("inv"), F.sum(col("shru")).alias("shru"),
             F.count("*").alias("n"))
        .order_by("k"))


def same_rows(torch, got, want, what: str, rtol: float = 1e-9) -> None:
    """Two ``to_torch`` results equal row for row: the same rows and
    nulls; over the valid rows integers, dates and strings exact, floats
    within ``rtol`` (NaN equal to NaN)."""
    (cg, mg, ng), (cw, mw, nw) = got, want
    check(ng == nw, f"{what}: {ng} rows against {nw}")
    check(list(cg) == list(cw), f"{what}: columns {list(cg)} / {list(cw)}")
    for name in cw:
        vg, vw = mg[name][:ng], mw[name][:nw].to(mg[name].device)
        check(torch.equal(vg, vw), f"{what}: the nulls of {name} differ")
        x, y = cg[name], cw[name]
        if isinstance(x, tuple):
            lg, lw = x[0][:ng], y[0][:nw].to(x[0].device)
            check(torch.equal(lg[vg], lw[vg]),
                  f"{what}: the lengths of {name} differ")
            w = max(x[1].shape[1], y[1].shape[1])
            pad = torch.nn.functional.pad
            a = pad(x[1][:ng], (0, w - x[1].shape[1]))
            b = pad(y[1][:nw].to(a.device), (0, w - y[1].shape[1]))
            inside = (torch.arange(w, device=a.device)[None, :]
                      < lg[:, None]) & vg[:, None]
            check(torch.equal(torch.where(inside, a, 0),
                              torch.where(inside, b, 0)),
                  f"{what}: the strings of {name} differ")
            continue
        a, b = x[:ng][vg], y[:nw].to(x.device)[vg]
        if a.dtype.is_floating_point:
            check(bool(torch.allclose(a, b, rtol=rtol, atol=0.0,
                                      equal_nan=True)),
                  f"{what}: {name} beyond rtol {rtol}")
        else:
            check(torch.equal(a, b), f"{what}: {name} differs")


def run_operator(torch, session, query_fn, name: str, rows_in: int,
                 runs: int = 2, cpu_query=None, peak: bool = False):
    """One operator query on the card: one warm-up and ``runs`` timed
    runs, then ``cpu_query`` (the same query on the CPU session) run once
    and compared row for row -> the card's result."""
    if peak:
        torch.cuda.reset_peak_memory_stats()
    out, secs = run_timed(torch, query_fn(session), runs)
    plan = session._last_plan
    fields = {}
    if peak:
        fields["peak_device_bytes"] = int(torch.cuda.max_memory_allocated())
    cpu_s = None
    if cpu_query is not None:
        t0 = time.perf_counter()
        want = cpu_query.to_torch()
        cpu_s = time.perf_counter() - t0
        same_rows(torch, out, want, name)
    aggs = _plan_nodes(plan, "TorchHashAggregateExec")
    ex = _plan_nodes(plan, "TorchShuffleExchangeExec")
    if ex:
        fields["shuffle_partition_bytes"] = [
            e.metrics["shufflePartitionBytes"] for e in ex]
    emit("operators", query=name, rows=rows_in, out_rows=out[2],
         dense_slot_batches=sum(a.metrics["pallasAggBatches"] for a in aggs),
         host_syncs_per_run=host_syncs(plan), seconds=secs,
         rows_per_s=rows_in / float(np.median(secs)), cpu_seconds=cpu_s,
         **fields)
    return out


def phase_range_aggs(torch, st, F, session, rows: int = RANGE_ROWS) -> None:
    """range_agg_linear_keys and range_agg_512, each checked exactly
    against the closed form over ``rows`` ids."""
    ids = np.arange(rows, dtype=np.int64)
    for name, fn, mask in (("range_agg_linear_keys", op_range_linear, 65535),
                           ("range_agg_512", op_range_512, 511)):
        cols, masks, n = run_operator(
            torch, session, lambda s: fn(st, F, s, rows), name, rows)
        k = cols["k"][:n].cpu().numpy()
        order = np.argsort(k)
        counts = np.bincount(ids & mask, minlength=mask + 1)
        # id = k + (mask + 1) j for j < counts[k]: the sum of a key's ids
        keys = np.arange(mask + 1, dtype=np.int64)
        sums = counts * keys + (mask + 1) * (counts * (counts - 1) // 2)
        check(np.array_equal(k[order], keys),
              f"{name}: keys differ from the closed form's")
        check(np.array_equal(cols["s"][:n].cpu().numpy()[order], sums),
              f"{name}: sums differ from the closed form's")
        if "n" in cols:
            check(np.array_equal(cols["n"][:n].cpu().numpy()[order], counts),
                  f"{name}: counts differ")
            check(np.array_equal(cols["a"][:n].cpu().numpy()[order],
                                 sums / counts),
                  f"{name}: averages differ")


# name -> (query over the tables, the table whose rows it counts)
OPERATOR_QUERIES = {
    "rollup_q1": (op_rollup_q1, "lineitem"),
    "cube_shipmode": (op_cube_shipmode, "lineitem"),
    "union_channels": (op_union_channels, "lineitem"),
    "explode_horizons": (op_explode_horizons, "orders"),
    "repartition_hash": (op_repartition_hash, "orders"),
    "repartition_range": (op_repartition_range, "orders"),
    "window_frames": (op_window_frames, "lineitem"),
    "bitwise_keys": (op_bitwise_keys, "lineitem"),
}


def phase_operator(torch, st, F, session, t_gpu, t_cpu, name: str,
                   rows: int) -> None:
    """One of phase 18's table queries on the card against the CPU
    session, with the checks of its own."""
    fn = OPERATOR_QUERIES[name][0]
    out = run_operator(torch, session, lambda s: fn(st, F, t_gpu), name,
                       rows, cpu_query=fn(st, F, t_cpu),
                       peak=name == "window_frames")
    cols, masks, n = out
    if name == "window_frames":
        window_peaks(torch, st, F, t_gpu)
    elif name == "explode_horizons":
        check(n == 3, "explode_horizons: not three horizons")
        nat = run_operator(torch, session, lambda s: op_explode_outer_nation(
            st, F, t_gpu), "explode_outer_nation", 25,
            cpu_query=op_explode_outer_nation(st, F, t_cpu))
        check(nat[2] == 25 and not bool(nat[1]["h"][:25].any()),
              "explode_outer over nation: not 25 rows each with a null")
    elif name == "repartition_hash":
        rr = run_operator(torch, session, lambda s: op_repartition_rr(
            st, F, t_gpu), "repartition_roundrobin", rows,
            cpu_query=op_repartition_rr(st, F, t_cpu))
        sizes = np.bincount(rr[0]["pid"][:rr[2]].cpu().numpy(),
                            minlength=16)
        check(rr[2] == n and sizes.max() - sizes.min() <= 1,
              "repartition(16): round-robin partitions differ by more "
              "than a row")
    elif name == "repartition_range":
        pid = cols["pid"][:n].cpu().numpy()
        price = cols["o_totalprice"][:n].cpu().numpy()
        check(bool(np.all(np.diff(pid) >= 0)),
              "repartition_range: partitions out of order")
        lo = [price[pid == p].min() for p in np.unique(pid)]
        hi = [price[pid == p].max() for p in np.unique(pid)]
        check(all(lo[i] >= hi[i + 1] for i in range(len(lo) - 1)),
              "repartition_range: partitions' price ranges overlap")
        emit("repartition_range_parts", partitions=int(len(lo)),
             rows=[int((pid == p).sum()) for p in np.unique(pid)])


def parse_args(argv):
    import argparse
    ap = argparse.ArgumentParser(
        description="Drive the torch port's main path on one NVIDIA card.")
    ap.add_argument("--package-root",
                    default=os.path.dirname(os.path.abspath(__file__)),
                    help="directory that holds the spark_rapids_tpu_torch "
                         "package to drive (default: this script's)")
    ap.add_argument("--kernels-only", action="store_true",
                    help="build, compare and time the kernels on the main "
                         "path's inputs, then stop: no edge specs, no "
                         "queries")
    ap.add_argument("--sass-dir",
                    help="write each kernel library's SASS listing there")
    ap.add_argument("--layer-cost", action="store_true",
                    help="build the kernels, then time hash_agg_sort_2m, "
                         "hash_join_1m, tpch_q3 and window_1m as the full "
                         "run does, and stop (to set one package's times "
                         "beside another's in one call)")
    ap.add_argument("--string-paths", action="store_true",
                    help="time LIKE/RLIKE's two matchers and replace's "
                         "two paths on the breadth queries' columns and "
                         "the queries with each, and stop")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    start = time.perf_counter()
    args = parse_args(sys.argv[1:] if argv is None else argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check "
              "runs on an NVIDIA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.package_root))
    import spark_rapids_tpu_torch as st
    from spark_rapids_tpu_torch import functions as F
    from spark_rapids_tpu_torch import native
    from spark_rapids_tpu_torch.exec import pallas_agg as pag
    from spark_rapids_tpu_torch.exprs import pallas_strings as ps

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    emit("device", kind=name, nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, count=torch.cuda.device_count(),
         package=os.path.dirname(os.path.abspath(st.__file__)))
    rate = mem_rate(name)
    if args.string_paths:
        return string_paths(torch, st, name)

    t0 = time.perf_counter()
    reports = native.build_all()
    emit("build", seconds=time.perf_counter() - t0,
         ptxas={k: [ln.strip() for ln in r.splitlines()
                    if any(w in ln for w in ("registers", "smem", "spill",
                                             "stack", "Compiling"))]
                for k, r in reports.items()})
    emit("sass", atomics=sass_summary(native, args.sass_dir))

    main_data, agg_data, dim_data = gen_data(1_000_000, 2_000_000)
    if args.layer_cost:
        return layer_cost(torch, st, F, native, main_data, agg_data,
                          dim_data, name)
    t0 = time.perf_counter()
    line = gen_lineitem(LINEITEM_ROWS, SEED + 2)
    session = st.TorchSession.builder().get_or_create()
    line_df = session.create_dataframe(line[0])
    emit("lineitem", rows=LINEITEM_ROWS, seconds=time.perf_counter() - t0)
    edges = not args.kernels_only
    kern = {"dense_slot_reduce": phase_kernel(
                torch, pag, session, agg_query(
                    st, F, session.create_dataframe(agg_data)), rate, edges),
            "contains": phase_contains(torch, ps, session, line_df, rate,
                                       edges)}
    # hash_join_1m gives the dense-slot kernel a shape of its own: the
    # join's output batch, the slots of grp, three planes
    dsr = kern["dense_slot_reduce"]
    dsr["max_abs_err"] = max(dsr["max_abs_err"], phase_kernel_path(
        torch, pag, session, hash_join_query(
            st, F, session.create_dataframe(main_data),
            session.create_dataframe(dim_data)), "hash_join_1m"))
    if args.kernels_only:
        print(json.dumps({"ok": True, "kernels_only": True, "device": {
            "platform": "gpu", "kind": name,
            "count": torch.cuda.device_count()}}), flush=True)
        return 0

    # each path of the main path runs with the launch counts set to 0
    # just before it and read just after; the kernels line adds them up
    launches = {k: 0 for k in native.KERNELS}

    def drive(path: str, fn, *fn_args) -> None:
        native.reset_launches()
        fn(*fn_args)
        emit("launches", path=path, counts=dict(native.LAUNCHES))
        for k, v in native.LAUNCHES.items():
            launches[k] += v

    drive("project_filter_1m", phase_project_filter, torch, st, session,
          main_data)
    drive("hash_agg_sort_2m", phase_agg, torch, st, F, native, session,
          agg_data, "hash_agg_sort_2m", 3)
    big = gen_big()
    drive("hash_agg_32m", phase_agg, torch, st, F, native, session, big,
          "hash_agg_32m", 1)
    del big
    drive("text_filter_agg_6m", phase_text_agg, torch, st, F, native,
          session, line_df, line, "text_filter_agg_6m", 2)
    drive("text_filter_project_6m", phase_text_project, torch, st, F,
          native, session, line_df, line, "text_filter_project_6m", 2)
    drive("hash_join_1m", phase_hash_join, torch, st, F, native, session,
          main_data, dim_data)
    from spark_rapids_tpu_torch.bench.tpch import BENCH_QUERIES, \
        TPCH_QUERIES, gen_tpch_numpy, load_tables
    t0 = time.perf_counter()
    tpch = gen_tpch_numpy(LINEITEM_ROWS)
    tpch_dfs = load_tables(session, tpch)
    emit("tpch_data", lineitem_rows=LINEITEM_ROWS,
         rows={t: len(next(iter(c.values()))) for t, c in tpch.items()},
         seconds=time.perf_counter() - t0)
    for qname in BENCH_QUERIES:
        drive(f"tpch_{qname}", phase_tpch, torch, st, native, session, tpch,
              tpch_dfs, qname)
    drive("window_1m", phase_window, torch, st, F, session, main_data)
    cpu_dfs = load_tables(st.TorchSession({"spark.rapids.torch.device":
                                           "cpu"}), tpch)
    for qname in TPCH_QUERIES:
        if qname not in BENCH_QUERIES:
            drive(f"tpch_{qname}", phase_tpch, torch, st, native, session,
                  tpch, tpch_dfs, qname, 2, cpu_dfs)
    from spark_rapids_tpu_torch.bench.mortgage import gen_mortgage_numpy
    from spark_rapids_tpu_torch.bench.tpcxbb import LEAD_QUERIES, \
        TPCXBB_QUERIES, gen_tpcxbb_numpy, register_views
    cpu = st.TorchSession({"spark.rapids.torch.device": "cpu"})
    t0 = time.perf_counter()
    mortgage = gen_mortgage_numpy(MORTGAGE_PERF_ROWS)
    xbb = gen_tpcxbb_numpy(TPCXBB_SALES_ROWS)
    register_views(session, xbb)
    register_views(cpu, xbb)
    emit("sql_data", mortgage_perf_rows=MORTGAGE_PERF_ROWS,
         tpcxbb_sales_rows=TPCXBB_SALES_ROWS,
         rows={t: len(next(iter(c.values()))) for t, c in xbb.items()},
         seconds=time.perf_counter() - t0)
    drive("mortgage_etl", phase_mortgage, torch, session, cpu, mortgage)
    # the bench's lead queries first, as bench.py:_tpcxbb_suites runs them
    for qname in list(LEAD_QUERIES) + [q for q in TPCXBB_QUERIES
                                       if q not in LEAD_QUERIES]:
        drive(f"tpcxbb_{qname}", phase_tpcxbb, torch, session, cpu, qname,
              TPCXBB_SALES_ROWS)
    gpu_b, cpu_b = breadth_sessions(st, tpch, line[0])
    emit("breadth_conf", conf=BREADTH_CONF)
    drive("breadth", phase_breadth, torch, st, gpu_b, cpu_b)
    drive("memory", phase_memory, torch, st, F, session, main_data,
          agg_data, dim_data, gen_big(), tpch)
    drive("range_aggs", phase_range_aggs, torch, st, F, session)
    t0 = time.perf_counter()
    ops = operator_tables(tpch)
    ops_gpu, ops_cpu = (load_tables(s, ops) for s in (session, cpu))
    emit("operator_data", seconds=time.perf_counter() - t0,
         lineitem_columns=sorted(ops["lineitem"]),
         orders_columns=sorted(ops["orders"]))
    for qname, (_, table) in OPERATOR_QUERIES.items():
        drive(qname, phase_operator, torch, st, F, session, ops_gpu,
              ops_cpu, qname, len(next(iter(ops[table].values()))))
    check(all(v > 0 for v in launches.values()),
          f"a kernel of the main path never launched: {launches}")
    phase_repeat_sums(torch, st, F, session, tpch_dfs)
    # q8, q13, TPCx-BB q2, the hour group-by and phase 18's three paths
    # through the kernel give it shapes of their own
    hour_sql = dict((q, sql) for q, sql, _ in BREADTH_QUERIES)[
        "timestamp_hour"]
    for path, query in [("tpch_q8", TPCH_QUERIES["q8"](tpch_dfs)),
                        ("tpch_q13", TPCH_QUERIES["q13"](tpch_dfs)),
                        ("tpcxbb_q2", session.sql(TPCXBB_QUERIES["q2"])),
                        ("breadth_timestamp_hour", gpu_b.sql(hour_sql)),
                        ("range_agg_512", op_range_512(st, F, session)),
                        ("explode_horizons",
                         op_explode_horizons(st, F, ops_gpu)),
                        ("bitwise_keys", op_bitwise_keys(st, F, ops_gpu))]:
        dsr["max_abs_err"] = max(dsr["max_abs_err"], phase_kernel_path(
            torch, pag, session, query, path))
    # the first half of hash_agg_sort_2m's first update batch, at the
    # half's capacity, as an out-of-memory split hands it to the kernel
    dsr["max_abs_err"] = max(dsr["max_abs_err"], phase_kernel_path(
        torch, pag, session, agg_query(st, F, session.create_dataframe(
            agg_data)), "hash_agg_sort_2m", half=True))
    phase_hash_device(torch)
    phase_join_routes(torch, st, session)
    phase_trace(torch, text_agg_query(st, F, line_df), "text_filter_agg_6m")
    phase_trace(torch, text_project_query(st, F, line_df),
                "text_filter_project_6m")
    phase_trace(torch, hash_join_query(st, F, session.create_dataframe(
        main_data), session.create_dataframe(dim_data)), "hash_join_1m",
        expect="join.")
    phase_trace(torch, TPCH_QUERIES["q3"](tpch_dfs), "tpch_q3",
                expect="join.")
    phase_trace(torch, window_query(st, F, session.create_dataframe(
        main_data)), "window_1m", expect="window.")
    from spark_rapids_tpu_torch.bench.mortgage import mortgage_etl
    phase_trace(torch, session.sql(TPCXBB_QUERIES["q3"]), "tpcxbb_q3",
                expect="join.")
    phase_trace(torch, mortgage_etl(session, mortgage), "mortgage_etl",
                expect="join.")
    phase_trace(torch, op_cube_shipmode(st, F, ops_gpu), "cube_shipmode")
    phase_trace(torch, op_repartition_hash(st, F, ops_gpu),
                "repartition_hash", expect="exchange.")
    phase_trace(torch, op_window_frames(st, F, ops_gpu), "window_frames",
                expect="window.")

    emit("total", seconds=time.perf_counter() - start)
    kernels = []
    for kname, info in native.KERNELS.items():
        k = kern[kname]
        kernels.append({
            "name": kname, "route": "cuda",
            "source": "spark_rapids_tpu_torch/" + info["source"],
            "replaces": info["replaces"], "launches": launches[kname],
            "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "cold_ms": k["cold_ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": k["library_ms"],
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
