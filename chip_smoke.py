#!/usr/bin/env python3
"""Drive the torch port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py [--package-root DIR] [--kernels-only]
                          [--sass-dir DIR] [--layer-cost] [--string-paths]
                          [--files-only] [--compressed-only]
                          [--planes-only] [--transfer-only]
                          [--scan-cache-only] [--placement-only]
                          [--shuffle-only]

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
   one warm-up and 1 timed run, with the host syncs of a run;
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
   bitwise_keys, the phase's three paths through it;
19. serve: the session server (``session.server()``) over
   ``bench_serve.py``'s mix at the sizes above: tpch_q1 and tpch_q6 over
   phase 11's tables, tpcxbb_q7 and mortgage_etl over phase 14's and
   15's, PREP_Q6 and PREP_TOPK with their three bindings each, and two
   classes that take the kernels inside the server: prep_kagg (a ``?``
   template grouped by ``k`` over hash_agg_sort_2m's 2,000,000 rows,
   three bindings; K1) and text_filter_agg_6m submitted as a DataFrame
   (K2).  Each class runs once serially without the server (the
   prepared ones checked against a CPU session, within rtol 1e-9 on
   f64); then 4 closed-loop clients submit 12 queries each, round-robin
   over the classes, under two tenants weighted 2 (interactive) and 1
   (batch), first with the result cache off (all 48 run) and then on;
   every result must equal its class's serial result bit for bit, and
   K1 and K2 must launch from the server's queries.  Each pass prints
   p50/p99 latency a class, queries/s, admission waits, cache hits and
   misses and the kernels' launches, with the card's name and power
   limit.  tpch_q6 is then traced alone, on the caller's thread and
   through a server's one worker (nothing runs beside the profiler).
   Then the checks: a re-submitted query hits the cache and
   misses once its view is registered anew; re-binding a prepared
   statement keeps one template; ``submit(..., timeout_ms=1)`` on
   tpch_q1 raises ``QueryTimeoutError`` and the next query is right; a
   tenant with ``maxDeviceBytes=1`` running a full ORDER BY over
   lineitem raises ``QueryBudgetExceededError`` while a budget-less one
   finishes right; ``spark.rapids.faults.server.admit=count:1`` sheds
   the first submit typed; ``server.cache.lookup=always`` keeps results
   right and counts its faults; the catalog's device bytes return to
   their value after each check that ends a query early, and no
   ``spark-rapids-torch-*`` thread is left after ``close()`` and
   ``stop()``;
20. adaptive: adaptive query execution
   (``spark.rapids.sql.adaptive.enabled``), each query with it off and
   on (one warm-up, 1 timed run each), the on result equal to the off
   one (integers and strings exact, f64 within rtol 1e-9: moved batch
   boundaries reorder float sums) and the catalog's device bytes back
   after every run.  hash_join_1m: the 10,000-row dimension's measured
   bytes promote it to a broadcast build, and the fact side's shuffle is
   elided (one shuffle exchange left); K1 launches from group_by(grp).
   tpch_q3, q5, q8, q10 and q18 over phase 11's SF1 tables, each with
   its replan decisions printed (K1 from q8).  tpch_q13_sql: TPC-H
   Q13's official text, its ``LEFT OUTER JOIN ... ON c_custkey =
   o_custkey AND o_comment NOT LIKE '%special%requests%'`` evaluated on
   the join's candidate pairs on the card, off and on, each against the
   same text on a CPU session (K1 from the c_count aggregate).
   skew_join_6m: 6,001,215 fact rows (``k`` from 32 keys by the zipf law
   of tests/fuzzer.py's gen_skewed_keys, a = 1.2; ``v`` f64, ``w``
   int32; seed 27; six input batches) joined to a 32-row dimension with
   broadcast off, then grouped by ``k`` (count, sum; K1), under
   ``SKEW_CONF`` (tests/test_adaptive.py's skew conf scaled by 300):
   the hot partition must split, and the largest partition's and group's
   bytes print beside both times.  replan_fault: hash_join_1m under
   ``spark.rapids.faults.aqe.replan=always``: every pass falls back,
   ``aqeReplans`` stays 0, both exchanges stay and the result is
   right;
21. observe: query profiles and metrics on the card, with adaptive
   execution on, for hash_agg_sort_2m (K1), text_filter_agg_6m (K2),
   hash_join_1m and tpch_q3 over phase 11's tables.  Each query runs a
   warm-up, then one plain ``collect()`` and one
   ``explain(analyze=True)`` (both times printed): the profile's root
   must count the result's rows, every operator's ``numOutputRows``
   must equal the CPU session's profile of the same query, operator
   for operator, and both runs must read back the same ``hostSyncs``
   (counting adds no sync).  ``explain()`` without ``analyze`` must
   launch no kernel, and ``to_device_batches()`` must return CUDA
   tensors whose rows equal the collected result exactly.
   hash_join_1m then runs under ``spark.rapids.sql.trace.enabled`` with
   a temporary ``trace.dir``: one Chrome trace must be written, holding
   a K1 kernel (``dsr_*``) and a ``join.*`` range;
22. fleet: ``session.fleet()`` with ``spark.rapids.fleet.replicas=2``
   on the one card and bench_serve.py:278-293's other fleet settings,
   the compile store's keys included (its directory the one phase 28's
   processes filled, so every replica loads the kernel libraries from
   it and its warm pool launches each kernel once).  The
   replicas get ``lineitem`` (phase 11's, every column) and ``agg``
   (hash_agg_sort_2m's) by ``register_table_view``; 4 closed-loop
   clients x 12 queries over fleet_soak's query, TPC-H Q1 and Q6 as SQL
   and PREP_KAGG over its three bindings (K1 inside the replicas), each
   result bit for bit its serial result from this process's session.
   The passes: clean; replica 0 SIGKILLed while it holds its queries
   (``replica.slow`` shipped to it: each held for a second,
   ``fleet/replica.py``), every result right or typed, none
   untyped, the replays counted; ``replace_replica(0)`` (its time to
   hot; the replacement must build no kernel and load each from the
   store) and a pass;
   ``rolling_restart()`` under a pass, no rejection; an injected
   ``replica.fail`` replayed on the other replica; ``fleet.route=always``
   raising typed.  Each pass prints queries/s and p50/p99; the phase
   prints each replacement's time to hot, the bytes shipped per view,
   each replica process's K1 launches, the card's memory in use with
   two replicas up, and its seconds; it fails unless K1 launched in a
   replica.  The replicas' launches join the kernels line.

The dense-slot kernel's float sums take one fixed order: every
comparison of it with its plain version (phase 3, its edge specs and
kernel_path) also calls it 5 times and fails unless the float-add planes
come out bit for bit alike (``float_sum_results_of_5``).

23. files: SF1 lineitem (gen_tpch_numpy(6_001_215), every column)
   written as CSV by the port's writer (no pyarrow), read back decoded
   on the card with the schema inferred and with it given, every value
   checked against the in-memory table, csvSlowFloatFields 0, TPC-H Q1
   and Q6 over the scan equal to the in-memory ones, the device decode
   timed apart (decode GB/s of file bytes beside the 3.35 TB/s read-once
   bound) and the read traced (csv_lineitem_sf1); hash_agg_sort_2m's
   table and text_filter_agg_6m's through CSV (K1; K2 and K1 on the
   decoder's char matrix, against numpy); lineitem partitioned by
   returnflag and linestatus, a returnflag filter reading only its
   directories (csv_hive); a standing group_by(k) over a CSV root fed
   hash_agg_sort_2m's rows as appended files, a grown file and a
   rewritten one, each tick against a full recompute, the first poll
   failed by the stream.poll fault (stream_agg, freshness p50/p99); and
   write.parquet and read.orc raising PyarrowRequiredError without
   pyarrow.  Its files live under ``_smoke_files/`` in the checkout and
   are removed after it.  ``--files-only`` builds the kernels and runs
   this phase alone.
24. compressed: dictionary-encoded string columns, the port's default
   (``spark.rapids.sql.compressed.enabled``), each cell with it on and
   with it off in the same call, each through the result pull (codes on
   the wire when on): TPC-H q1, q3, q12 and q16 over
   gen_tpch_numpy(6_001_215), each on equal to off (floats within rtol
   1e-9, whether bit for bit printed) and checked against numpy (q1,
   q3) or a CPU session (q12, q16); compressed_shipmode_agg
   (group_by(l_shipmode) with count, sum and max over SF1 lineitem: no
   late decode, K1 over the codes, against numpy, K1 held against its
   plain version on its own update batch); compressed_contains_dict
   (a 17-byte contains over l_shipinstruct, then a count: one K2 launch
   a run, on the 4-value dictionary, where the dense path launches one
   a 2^20-row batch, K2 equal to its plain version
   there, the count equal to numpy's); hash_join_1m, text_filter_agg_6m
   and tpcxbb_q3 on and off; Q1 over Q1's columns of SF1 lineitem
   written as CSV and read back with the strings encoded on the card,
   bit for bit the in-memory Q1; tpch_q3 at a quarter of its catalog
   peak through the host and disk tiers (memory_tiers).  Each line
   prints encodedColumns, plainColumns, lateDecodes, fusedDecodes and
   the h2d raw and wire bytes of the first run, the scans' ms and the
   seconds of each timed run, on and off; a cell with an encoded column
   whose wire bytes are not below its raw bytes fails.
   ``--compressed-only`` builds the kernels and runs this phase alone.
   The off side (the master key false) takes no plane encoding either;
25. planes: RLE, delta-narrowed and bit-packed columns, each cell run
   with the planes on (the default) and with their three keys false,
   through the result pull, as phase 24 runs its cells:
   planes_clustered_agg (hash_agg_sort_2m's table sorted by k: k RLE in
   every batch at wire/raw 0.10 to 0.13, no late decode, one K1 launch
   a batch, K1 held against its plain version on its update batch, the
   result against numpy); planes_lineitem_clustered (SF1 lineitem
   stably sorted by l_orderkey, which takes the int8 delta at 0.20 to
   0.25: q18 against a CPU session, a group_by(l_orderkey) sum with no
   late decode against numpy); planes_flag_filter (l_late = l_receiptdate
   > l_commitdate bit-packed at 0.5625, a filter on it decoded by the
   stage, a group_by(l_shipmode) count against numpy); planes_tpch (q3
   against numpy, q5 against a CPU session, the dimension keys delta
   and o_shippriority RLE); the RLE table at a quarter of its catalog
   peak (memory_tiers) and one of its batches through the host and disk
   tiers, back as the same classes with no decode; decode_times (the
   three decodes at 2^20 rows, warm and cold, beside their read-once
   bounds).  Each line adds the plane counters, each operator's
   encodedColumns and the h2d bytes by encoding and by column.
   ``--planes-only`` builds the kernels and runs this phase alone.
26. transfer: the transfer path (pinned uploads on a copy stream,
   double-buffered through ``pipelined_scan``; the packed one-pull
   result egress; the staging limiters), each cell with its key on and
   off: SF1 TPC-H q1, q6 and q3 through the local scan with
   ``spark.rapids.sql.io.prefetch.enabled`` on and off (warm scan ms,
   query seconds, ``h2dOverlapMs``, one traced run each for the idle
   share), against numpy; hash_agg_sort_2m the same way, K1 launched
   and held against its plain version on the query's own update batch;
   project_filter_1m's result with ``spark.rapids.sql.transfer.pack.
   enabled`` on and off (bit for bit equal, 2 pulls on, wire / raw,
   ``to_numpy`` seconds); SF1 lineitem written as CSV and read typed
   with prefetch on and off (read seconds, the traced read's idle
   share); the pack at 2^20 rows beside its read-once bound; q1 with
   the three staging limiters at 64 MB (``pinnedPool.size``), equal to
   the uncapped run, its staging waits printed.  Every pair must be
   equal; a wrong result fails the run.  ``--transfer-only`` builds the
   kernels and runs this phase alone; with ``--package-root`` it runs
   the same cells over an earlier tree's package (the pack's own cell
   is skipped where it has no ``columnar/transfer.py``).
28. placement: the card's link constants as ``plan/cost.py:
   probe_link`` measures them; ``spark.rapids.sql.placement.mode``
   tpu, cpu and cost on project_filter_1m, hash_agg_sort_2m,
   hash_join_1m, SF1 q1 and q6 and a 1,000-row string scan, each result
   its tpu one's (floats within 1e-9), each cost decision beside the
   query's measured wall, a plan on the host launching no kernel and
   pulling nothing; one adaptive demotion over a 4,000-row in-memory
   table (the JAX placement test's pinned link); fusion on, off and at
   maxOps 2 on project_filter_1m and q6, bit for bit alike, with the
   stages' dispatches a scanned batch; the compile store across two
   plain processes: the first over an empty directory (its nvcc builds
   and their ms), the second over the same directory (no build, the
   load ms), each warming every kernel.  ``--placement-only`` builds
   the kernels and runs this phase alone.
29. shuffle: the host shuffle.  hash_agg_sort_2m's table,
   hash_join_1m's fact and dim and SF1 lineitem, each written as 8 CSV
   files by the port's writer; the group-by and the join (broadcast
   off) with ``spark.rapids.shuffle.workers.count`` 2 and 4 and SF1 q1
   with 4: the map side in spawned worker processes on the host (each
   on ``torch.device("cpu")`` with its share of the cores), the reduce
   here on the card.  Each result against the same query in process on
   the same session (integers exact, floats within 1e-9 relative); each
   run's map, fetch, upload and aggregate seconds, blocks, wire and raw
   bytes, codec and checksum; the transport must be the native one,
   K1 must launch on the reduce side of both aggregates, no worker may
   report a CUDA context (``torch.cuda.is_initialized()``, or
   ``/dev/nvidia-uvm`` among its mapped files), and no process this one
   started may map ``/dev/nvidia-uvm`` while a run lasts, as this
   process sees them in ``/proc``; first, a child that opens a context
   must show it both ways, the checks' negative control (``nvidia-smi
   --query-compute-apps`` cannot tell processes apart there: it gives
   every one pid 1).  A last run kills
   worker 1 (``spark.rapids.faults.worker.kill=count:1@w1``): the map
   stage reruns here and the result stays.  ``--shuffle-only`` builds
   the kernels and runs this phase alone.
30. mesh: the mesh exchange over 4 shards on the one card
   (``parallel/mesh.py: virtual_pool(4)``), each cell against
   the single-device run of the same query in the same call (integers
   bit for bit, floats within 1e-9 relative): hash_agg_sort_2m and
   hash_join_1m at ``spark.rapids.sql.mesh.devices=4`` (their mesh
   operators in the plan, the join draining the broadcast exchange, K1
   once a shard, and K1 held against its plain version on shard 0's
   update batch, its live rows as the update passes them and, timed
   beside them, padded to the shard's capacity), SF1 q1 and q3 there, then ``spark.rapids.shuffle.
   mode=ici`` over hash_join_1m (broadcast off) and hash_agg_sort_2m:
   clean (no pull in a hash exchange, the sort's bounds sample once),
   with the collective's first call faulted (one fragment degrades)
   and at ``maxStageBytes`` 1 MiB (every fragment over it degrades);
   then ``parallel/dryrun.py`` on the card.  Its K1 launches are
   printed split into the mesh runs', the single-device references' and
   the dry run's.  It runs before the CPU
   references' checks.  ``--mesh-only`` builds the kernels and runs
   this phase alone.

Each path of phases 5 to 30 runs with the launch counts set to 0 just
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
cube_shipmode, repartition_hash, window_frames and hash_join_1m with
adaptive execution on once more under torch.profiler and prints each
one's wall time, the card's busy time, its largest device entries, its
longest idle gaps and the port's named ranges (``join.*``, ``window.*``,
``exchange.*``, ``plan.aqe``); a join query's trace without a
``join.*`` range, window_1m's or window_frames' without a ``window.*``
one, repartition_hash's without an ``exchange.*`` one, or the adaptive
hash_join_1m's without ``plan.aqe``, fails the run.  Then one JSON
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
import shutil
import subprocess
import sys
import threading
import time

import numpy as np

SEED = 7
LINEITEM_ROWS = 6_001_215
# the port's named ranges (their device spans are not device work of
# their own): the joins', windows', exchanges' and planner's, and the
# transfer path's (io.h2d.overlap, io.prefetch.wait, io.d2h.*)
RANGES = ("join.", "window.", "exchange.", "plan.", "io.")
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
    # an operator's metric (utils/metrics.Metric) prints as its count
    print(json.dumps({"phase": phase, **fields}, default=int), flush=True)


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


def main_path_inputs(pag, session, query, half: bool = False,
                     codes: bool = False):
    """What a path gives the kernel: the aggregate's own plane
    construction on the first update batch of ``query`` that takes the
    dense-slot path, from the root-most aggregate down (its input, a
    join's output included); with ``half``, on the first half of that
    batch that an out-of-memory split would give it; with ``codes``,
    through the aggregate's code view, where a key over an encoded
    string column is its int32 codes -> (gid, planes, ops, K)."""
    from spark_rapids_tpu_torch.columnar.encoding import plane_view
    from spark_rapids_tpu_torch.exec.base import ExecContext
    from spark_rapids_tpu_torch.plan.planner import plan_query
    # the batch the aggregate exec's own routing would send
    # (TorchHashAggregateExec._try_pallas_update), its plane columns
    # decoded as the update decodes them
    for agg in _plan_nodes(plan_query(query.plan), "TorchHashAggregateExec"):
        if not codes and not pag.supports(agg.spec):
            continue
        for batch in agg.children[0].execute(
                ExecContext(session.conf, session.device)):
            if half:
                from spark_rapids_tpu_torch.utils.retry import \
                    split_batch_half
                batch = split_batch_half(batch)[0]
            spec = agg.spec
            if codes:
                spec, batch, _ = agg._agg_view("update", batch)
                if not pag.supports(spec):
                    break
            if batch.capacity > pag.max_capacity(spec):
                continue
            cols = plane_view(batch.columns)
            rng = pag.key_range(spec.groupings[0], cols, batch.num_rows,
                                batch.capacity)
            if rng is None:
                continue
            if not pag.fits(*rng):
                break
            lo, _ = rng
            K = pag.slot_count(*rng)
            gid, planes, ops, _ = pag.update_planes(
                spec, cols, batch.num_rows, batch.capacity, lo, K)
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
                      half: bool = False, codes: bool = False) -> float:
    """The dense-slot kernel against its plain version on the inputs
    another path gives it (``query``'s first update batch, or with
    ``half`` that batch's first half; ``codes``: through the code view),
    timed as phase 3 -> the largest f64 sum error."""
    return hold_k1(torch, pag, main_path_inputs(pag, session, query, half,
                                                codes), path, half=half,
                   codes=codes)


def hold_k1(torch, pag, inputs, path: str, **fields) -> float:
    """K1 against its plain version on ``inputs`` (gid, planes, ops, K),
    timed warm and cold beside the plain version, its float sums
    repeated 5 times -> the largest f64 sum error."""
    gid, planes, ops, K = inputs
    err = compare_kernel(torch, pag, gid, planes, ops, K)
    launch, _ = pag.prepare_launch(gid, planes, ops, K)
    fsum_planes, repeats = float_sum_repeats(torch, pag, gid, planes, ops, K)
    emit("kernel_path", name="dense_slot_reduce", path=path, **fields,
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
    # the lone contains filter (plan/fusion.py leaves a chain of one a
    # TorchFilterExec): one output batch an input batch
    filt = session._last_plan
    while type(filt).__name__ != "TorchFilterExec":
        filt = filt.children[0]
    batches = filt.metrics["numOutputBatches"]
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
    elif isinstance(cpu_tables, CpuReferences):
        tie_key, limit = TIE_KEYS.get(qname, ("", None))
        cols, masks, n = to_device((cols, masks, n), "cpu")
        cpu_tables.defer(("tpch", qname), lambda want: check_tpch(
            torch, cols, masks, n, want, limit, qname, tie_key))
    else:
        t0 = time.perf_counter()
        want = host_result(torch, TPCH_QUERIES[qname](cpu_tables).to_torch(),
                           f"{qname} on the CPU")
        cpu_s = time.perf_counter() - t0
        tie_key, limit = TIE_KEYS.get(qname, ("", None))
    if not isinstance(cpu_tables, CpuReferences):
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
    check(n > 0, "mortgage_etl: no rows")
    cpu_s = None
    if isinstance(cpu, CpuReferences):
        host = to_device((cols, masks, n), "cpu")
        cpu.defer(("mortgage", "etl"), lambda want: check_tpch(
            torch, *host, want, None, "mortgage_etl"))
    else:
        t0 = time.perf_counter()
        want = host_result(torch, mortgage_etl(cpu, tables).to_torch(),
                           "mortgage_etl on the CPU")
        cpu_s = time.perf_counter() - t0
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
    tie_key, limit = TPCXBB_TIE_KEYS.get(qname, ("", None))
    cpu_s = None
    if isinstance(cpu, CpuReferences):
        host = to_device((cols, masks, n), "cpu")
        cpu.defer(("tpcxbb", qname), lambda want: check_tpch(
            torch, *host, want, limit, f"tpcxbb_{qname}", tie_key))
    else:
        t0 = time.perf_counter()
        want = host_result(torch, cpu.sql(sql).to_torch(),
                           f"{qname} on the CPU")
        cpu_s = time.perf_counter() - t0
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


def breadth_sessions(st, tpch, line, devices=("cuda", "cpu")):
    """A session a device (card, CPU), each with BREADTH_CONF and the views
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
    for dev in devices:
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


# -- the CPU session's references, beside the card phases ----------------------

REFS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "_smoke_refs")


def reference_jobs() -> list:
    """What the references process computes, in the order the card
    phases ask for it: the TPC-H queries not checked against numpy, the
    TPCx-BB queries, mortgage_etl, the breadth queries, the operators'
    table queries."""
    from spark_rapids_tpu_torch.bench.tpch import BENCH_QUERIES, \
        TPCH_QUERIES
    from spark_rapids_tpu_torch.bench.tpcxbb import LEAD_QUERIES, \
        TPCXBB_QUERIES
    return ([("tpch", q) for q in TPCH_QUERIES if q not in BENCH_QUERIES]
            + [("tpcxbb", q) for q in list(LEAD_QUERIES)
               + [q for q in TPCXBB_QUERIES if q not in LEAD_QUERIES]]
            + [("mortgage", "etl")]
            + [("breadth", q) for q, _, _ in BREADTH_QUERIES]
            + [("operator", q) for q in list(OPERATOR_QUERIES)
               + list(OPERATOR_EXTRAS)])


class CpuReferences:
    """The CPU session's results that the TPC-H, TPCx-BB, mortgage,
    breadth and operator phases check the card against, computed by a
    process of its
    own (``--cpu-references``, on half the cores) while the card phases
    run; each phase defers its check (``defer``) and ``finish`` runs them
    all, every one as it was, once the process has ended.  The process
    makes the same tables from the same seeds.  It runs at nice 10, and
    ``overlapped`` names the phases that started while it was alive:
    their host seconds were taken beside it, under contention that runs
    without it did not have."""

    def __init__(self, package_root: str):
        shutil.rmtree(REFS_DIR, ignore_errors=True)
        os.makedirs(REFS_DIR)
        self.t0 = time.perf_counter()
        self._log = open(os.path.join(REFS_DIR, "process.log"), "w")
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--package-root",
             package_root, "--cpu-references", REFS_DIR],
            stdout=self._log, stderr=subprocess.STDOUT)
        self.pending = []
        self.overlapped = []

    def note_phase(self, path: str) -> None:
        """A phase starts: record it if the process is still running."""
        if self.proc.poll() is None:
            self.overlapped.append(path)

    def defer(self, job, check_fn) -> None:
        self.pending.append((job, check_fn))

    def finish(self, timeout: float = 600.0) -> None:
        import pickle
        waited = time.perf_counter()
        try:
            rc = self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            rc = None
        waited = time.perf_counter() - waited
        self.close()
        with open(os.path.join(REFS_DIR, "process.log")) as f:
            log_tail = f.read()[-2000:]
        check(rc == 0, f"the CPU references process ended with {rc}: "
              f"{log_tail}")
        seconds = {}
        for job, check_fn in self.pending:
            with open(self._path(job), "rb") as f:
                out = pickle.load(f)
            seconds[f"{job[0]}_{job[1]}"] = out["seconds"]
            check_fn(out["want"])
        with open(os.path.join(REFS_DIR, "summary.json")) as f:
            summary = json.load(f)
        emit("cpu_references", checks=len(self.pending),
             process_s=summary["seconds"], data_s=summary["data_s"],
             threads=summary["threads"], nice=summary["nice"],
             waited_s=waited, since_start_s=time.perf_counter() - self.t0,
             overlapped_phases=self.overlapped, seconds=seconds)
        shutil.rmtree(REFS_DIR, ignore_errors=True)

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=60)
        self._log.close()

    @staticmethod
    def _path(job) -> str:
        return os.path.join(REFS_DIR, f"{job[0]}_{job[1]}.pkl")


def cpu_references_main(out_dir: str) -> int:
    """``--cpu-references DIR``: compute every ``reference_jobs`` result
    on CPU sessions, each into DIR as it is done."""
    import pickle
    import torch
    import spark_rapids_tpu_torch as st
    from spark_rapids_tpu_torch.bench.mortgage import gen_mortgage_numpy, \
        mortgage_etl
    from spark_rapids_tpu_torch.bench.tpch import TPCH_QUERIES, \
        gen_tpch_numpy, load_tables
    from spark_rapids_tpu_torch.bench.tpcxbb import TPCXBB_QUERIES, \
        gen_tpcxbb_numpy, register_views
    t_start = time.perf_counter()
    # below the card phases' host work, which is what they time
    nice = os.nice(10)
    threads = max(1, (os.cpu_count() or 2) // 2)
    torch.set_num_threads(threads)
    tpch = gen_tpch_numpy(LINEITEM_ROWS)
    cpu = st.TorchSession({"spark.rapids.torch.device": "cpu"})
    cpu_dfs = load_tables(cpu, tpch)
    register_views(cpu, gen_tpcxbb_numpy(TPCXBB_SALES_ROWS))
    mortgage = gen_mortgage_numpy(MORTGAGE_PERF_ROWS)
    cpu_b, = breadth_sessions(st, tpch, gen_lineitem(LINEITEM_ROWS,
                                                     SEED + 2)[0], ("cpu",))
    ops_cpu = load_tables(cpu, operator_tables(tpch))
    data_s = time.perf_counter() - t_start
    from spark_rapids_tpu_torch import functions as F
    ops = {**{q: fn for q, (fn, _) in OPERATOR_QUERIES.items()},
           **OPERATOR_EXTRAS}
    sql = dict((q, text) for q, text, _ in BREADTH_QUERIES)
    for kind, name in reference_jobs():
        t0 = time.perf_counter()
        if kind == "tpch":
            want = host_result(torch, TPCH_QUERIES[name](cpu_dfs).to_torch(),
                               f"{name} on the CPU")
        elif kind == "tpcxbb":
            want = host_result(torch, cpu.sql(TPCXBB_QUERIES[name])
                               .to_torch(), f"{name} on the CPU")
        elif kind == "mortgage":
            want = host_result(torch, mortgage_etl(cpu, mortgage).to_torch(),
                               "mortgage_etl on the CPU")
        elif kind == "operator":
            want = ops[name](st, F, ops_cpu).to_torch()
        else:
            want = cpu_b.sql(sql[name]).to_torch()
        path = CpuReferences._path((kind, name))
        path = os.path.join(out_dir, os.path.basename(path))
        with open(path + ".tmp", "wb") as f:
            pickle.dump({"want": want, "seconds": time.perf_counter() - t0},
                        f)
        os.replace(path + ".tmp", path)
    with open(os.path.join(out_dir, "summary.json"), "w") as f:
        json.dump({"seconds": time.perf_counter() - t_start,
                   "data_s": data_s, "threads": threads, "nice": nice}, f)
    return 0


def phase_breadth(torch, st, gpu, cpu, runs: int = 2) -> None:
    """Each breadth query through ``session.sql`` on the card (one
    warm-up, ``runs`` timed) against the same SQL on the CPU session:
    integers, strings, booleans, dates and timestamps exact; rand and
    the queries marked so bit for bit; other f64 within rtol 1e-9 (the
    two devices' sums and transcendental functions may round apart)."""
    for qname, sql, bitwise in BREADTH_QUERIES:
        (cols, masks, n), secs = run_timed(torch, gpu.sql(sql), runs)
        plan = gpu._last_plan
        check(n > 0, f"breadth {qname}: no rows")
        rtol = 0.0 if bitwise else 1e-9
        floats_alike = cpu_s = None
        if isinstance(cpu, CpuReferences):
            host = to_device((cols, masks, n), "cpu")

            def later(want, qname=qname, host=host, rtol=rtol):
                emit("breadth_check", query=qname,
                     floats_bit_for_bit=same_result(
                         torch, want, host, f"breadth {qname}",
                         float_rtol=rtol))
            cpu.defer(("breadth", qname), later)
        else:
            t0 = time.perf_counter()
            device = next(iter(masks.values())).device
            want = to_device(cpu.sql(sql).to_torch(), device)
            cpu_s = time.perf_counter() - t0
            floats_alike = same_result(torch, want, (cols, masks, n),
                                       f"breadth {qname}", float_rtol=rtol)
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
                expect: str = "") -> float:
    """One run of ``query`` (a DataFrame, or a function that runs one)
    under torch.profiler: its wall seconds, the
    card's busy seconds (kernels and copies), the largest device entries,
    the longest idle gaps between them, and the host time and device span
    of each of the port's named ranges (the join's build and route, the
    window's sort and evaluation), so the device's idle share shows how
    far the host holds the card back and the ranges what a join or a
    window takes of it -> the idle share.  Fails when no host range
    starting with ``expect`` (``join.``, ``window.``) shows in the
    trace."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        query() if callable(query) else query.to_torch()
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
    return 1.0 - busy / wall


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
    # the sessions of later phases share the device's runtime: leave
    # one at the default budget behind, not the quarter one
    fresh_session(st)


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
                 runs: int = 1, cpu_query=None, peak: bool = False):
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
    if isinstance(cpu_query, tuple):
        refs, job = cpu_query
        host = to_device(out, "cpu")
        refs.defer(job, lambda want: same_rows(torch, host, want, name))
    elif cpu_query is not None:
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
# the second queries two of them check
OPERATOR_EXTRAS = {"explode_outer_nation": op_explode_outer_nation,
                   "repartition_roundrobin": op_repartition_rr}


def phase_operator(torch, st, F, session, t_gpu, t_cpu, name: str,
                   rows: int) -> None:
    """One of phase 18's table queries on the card against the CPU
    session (``t_cpu`` its tables, or a ``CpuReferences`` whose process
    runs them), with the checks of its own."""
    fn = OPERATOR_QUERIES[name][0]

    def cpu_query(query, fn):
        if isinstance(t_cpu, CpuReferences):
            return t_cpu, ("operator", query)
        return fn(st, F, t_cpu)
    out = run_operator(torch, session, lambda s: fn(st, F, t_gpu), name,
                       rows, cpu_query=cpu_query(name, fn),
                       peak=name == "window_frames")
    cols, masks, n = out
    if name == "window_frames":
        window_peaks(torch, st, F, t_gpu)
    elif name == "explode_horizons":
        check(n == 3, "explode_horizons: not three horizons")
        nat = run_operator(torch, session, lambda s: op_explode_outer_nation(
            st, F, t_gpu), "explode_outer_nation", 25,
            cpu_query=cpu_query("explode_outer_nation",
                                op_explode_outer_nation))
        check(nat[2] == 25 and not bool(nat[1]["h"][:25].any()),
              "explode_outer over nation: not 25 rows each with a null")
    elif name == "repartition_hash":
        rr = run_operator(torch, session, lambda s: op_repartition_rr(
            st, F, t_gpu), "repartition_roundrobin", rows,
            cpu_query=cpu_query("repartition_roundrobin",
                                op_repartition_rr))
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


# -- the serve phase -----------------------------------------------------------

# bench_serve.py's prepared templates and bindings (bench_serve.py:94-104)
PREP_Q6 = ("SELECT SUM(l_extendedprice * l_discount) AS revenue "
           "FROM lineitem WHERE l_discount >= ? AND l_discount <= ? "
           "AND l_quantity < ?")
PREP_TOPK = ("SELECT l_orderkey, SUM(l_quantity) AS q FROM lineitem "
             "WHERE l_quantity > ? GROUP BY l_orderkey")
Q6_BINDINGS = [(0.02, 0.06, 24.0), (0.03, 0.07, 30.0), (0.01, 0.05, 20.0)]
TOPK_BINDINGS = [(30.0,), (35.0,), (40.0,)]
# the group-by template that takes K1 inside the server (keys 0 to 999)
PREP_KAGG = ("SELECT k, COUNT(*) AS c, SUM(v) AS s, MAX(v) AS m FROM agg "
             "WHERE v > ? GROUP BY k")
KAGG_BINDINGS = [(-0.5,), (0.0,), (0.5,)]
SERVE_CLIENTS = 4           # bench_serve.py:34's default
SERVE_QUERIES = 12          # a client, bench_serve.py:35's default
SERVE_WEIGHTS = {"interactive": 2, "batch": 1}


def host_same_rows(got, want, what: str, rtol: float = 1e-9) -> None:
    """Two ``HostResult``s equal row for row: the same columns, rows and
    nulls; over the valid rows integers, dates and strings exact, floats
    within ``rtol``."""
    check(got.schema.names == want.schema.names,
          f"{what}: columns {got.schema.names} / {want.schema.names}")
    check(got.num_rows == want.num_rows,
          f"{what}: {got.num_rows} rows against {want.num_rows}")
    for f in want.schema:
        (a, va), (b, vb) = got.columns[f.name], want.columns[f.name]
        check(np.array_equal(va, vb), f"{what}: the nulls of {f.name} differ")
        if hasattr(a, "to_bytes"):
            oa, da = a[va].to_bytes()
            ob, db = b[vb].to_bytes()
            check(np.array_equal(oa, ob) and np.array_equal(da, db),
                  f"{what}: the strings of {f.name} differ")
        elif a.dtype.kind == "f":
            check(np.allclose(a[va], b[vb], rtol=rtol, atol=0.0,
                              equal_nan=True),
                  f"{what}: {f.name} beyond rtol {rtol}")
        else:
            check(np.array_equal(a[va], b[vb]), f"{what}: {f.name} differs")


def serve_classes(st, F, tpch_dfs, mortgage_df, line_df):
    """``bench_serve.py``'s mix (bench_serve.py:106-123) and the two
    classes that take the kernels: (class, tenant, what to submit), a
    DataFrame, SQL text, or (template, binding)."""
    from spark_rapids_tpu_torch.bench.tpch import TPCH_QUERIES
    from spark_rapids_tpu_torch.bench.tpcxbb import TPCXBB_QUERIES
    items = [("tpch_q1", "batch", TPCH_QUERIES["q1"](tpch_dfs)),
             ("tpch_q6", "interactive", TPCH_QUERIES["q6"](tpch_dfs)),
             ("tpcxbb_q7", "interactive", TPCXBB_QUERIES["q7"]),
             ("mortgage_etl", "batch", mortgage_df)]
    for i, b in enumerate(Q6_BINDINGS):
        items.append((f"prep_q6_{i}", "interactive", (PREP_Q6, b)))
    for i, b in enumerate(TOPK_BINDINGS):
        items.append((f"prep_topk_{i}", "interactive", (PREP_TOPK, b)))
    for i, b in enumerate(KAGG_BINDINGS):
        items.append((f"prep_kagg_{i}", "batch", (PREP_KAGG, b)))
    items.append(("text_filter_agg_6m", "batch",
                  text_agg_query(st, F, line_df)))
    return items


def serve_submit(server, spec, tenant, stmts, **kw):
    if isinstance(spec, tuple):
        return server.submit(stmts[spec[0]], tenant=tenant, params=spec[1],
                             **kw)
    return server.submit(spec, tenant=tenant, **kw)


def pct(xs, q: float) -> float:
    return float(np.percentile(np.asarray(xs, dtype=np.float64), q))


def serve_pass(torch, native, server, classes, serial, stmts, label: str,
               smi: str) -> dict:
    """SERVE_CLIENTS closed-loop clients, SERVE_QUERIES submissions each,
    round-robin over the classes; every result bit for bit its class's
    serial result -> the pass's numbers (printed)."""
    before = dict(native.LAUNCHES)
    done = []
    errors = []
    lock = threading.Lock()

    def client(c: int) -> None:
        try:
            for i in range(SERVE_QUERIES):
                name, tenant, spec = classes[(c + i) % len(classes)]
                tk = serve_submit(server, spec, tenant, stmts)
                res = tk.result(timeout=600)
                with lock:
                    done.append((name, tk, res))
        except BaseException as e:  # raised again below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(c,),
                                name=f"serve-client-{c}")
               for c in range(SERVE_CLIENTS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    wall = time.perf_counter() - t0
    check(not errors, f"serve {label}: a client failed: {errors!r}")
    check(len(done) == SERVE_CLIENTS * SERVE_QUERIES,
          f"serve {label}: {len(done)} results")
    for name, _, res in done:
        check(res.equals(serial[name]),
              f"serve {label}: {name} differs from its serial result")
    launches = {k: native.LAUNCHES[k] - before.get(k, 0)
                for k in native.LAUNCHES}
    by_class = {}
    for name, tk, _ in done:
        by_class.setdefault(name, []).append(tk.latency_ms)
    waits = [(tk.started_at - tk.submitted_at) * 1e3 for _, tk, _ in done]
    stats = server.stats()
    out = {"pass": label, "queries": len(done), "wall_s": wall,
           "queries_per_s": len(done) / wall,
           "latency_ms": {n: {"p50": pct(v, 50), "p99": pct(v, 99),
                              "n": len(v)} for n, v in by_class.items()},
           "latency_ms_all": {"p50": pct([tk.latency_ms for _, tk, _ in
                                          done], 50),
                              "p99": pct([tk.latency_ms for _, tk, _ in
                                          done], 99)},
           "admission_wait_ms": {"p50": pct(waits, 50),
                                 "p99": pct(waits, 99),
                                 "max": max(waits)},
           "cache_hits": sum(tk.cache_hit for _, tk, _ in done),
           "cache": stats.get("cache"), "queue": stats["queue"],
           "launches": launches, "bit_for_bit": True, "card": smi}
    emit("serve_pass", **out)
    return out


def phase_serve(torch, st, F, native, tpch, tpch_dfs, xbb, mortgage, agg_data,
                line_df, smi: str) -> None:
    """The session server on the card: bench_serve.py's mix and the two
    kernel classes run serially, then by four concurrent clients (cache
    off, then on), then the deliberate checks."""
    from spark_rapids_tpu_torch import faults, lifecycle
    from spark_rapids_tpu_torch.bench.mortgage import mortgage_etl
    from spark_rapids_tpu_torch.bench.tpch import TPCH_QUERIES, load_tables
    from spark_rapids_tpu_torch.bench.tpcxbb import register_views
    from spark_rapids_tpu_torch.io.prefetch import THREAD_PREFIX
    from spark_rapids_tpu_torch.obs import registry
    t_phase = time.perf_counter()

    def views(s, dfs=None):
        li = dfs["lineitem"] if dfs is not None else load_tables(
            s, {"lineitem": tpch["lineitem"]})["lineitem"]
        s.register_view("lineitem", li)
        register_views(s, xbb)
        s.create_dataframe(agg_data).create_or_replace_temp_view("agg")
        return s

    def serve_session(conf=None):
        return views(st.TorchSession(conf or {}), tpch_dfs)

    base = {f"spark.rapids.server.tenant.{t}.weight": w
            for t, w in SERVE_WEIGHTS.items()}
    serve = serve_session({**base,
                           "spark.rapids.server.resultCache.enabled": False})
    cpu = views(st.TorchSession({"spark.rapids.torch.device": "cpu"}))
    classes = serve_classes(st, F, tpch_dfs, mortgage_etl(serve, mortgage),
                            line_df)
    cat = serve.runtime.catalog
    registry.reset_histograms()

    # 1. serial, no server; the prepared classes against the CPU session
    serial, serial_s, cpu_s = {}, {}, 0.0
    for name, _, spec in classes:
        t0 = time.perf_counter()
        if isinstance(spec, tuple):
            res = serve.prepare(spec[0]).execute(*spec[1])
        elif isinstance(spec, str):
            res = serve.sql(spec)._host()
        else:
            res = spec._host()
        torch.cuda.synchronize()
        serial_s[name] = time.perf_counter() - t0
        serial[name] = res
        check(res.num_rows > 0, f"serve: {name} has no rows")
        if isinstance(spec, tuple):
            t0 = time.perf_counter()
            host_same_rows(res, cpu.prepare(spec[0]).execute(*spec[1]),
                           f"serve: {name} against the CPU session")
            cpu_s += time.perf_counter() - t0
    emit("serve_serial", seconds=serial_s, cpu_seconds=cpu_s, card=smi,
         rows={n: r.num_rows for n, r in serial.items()})

    # 2. concurrent: every submission runs (cache off), then the same
    # mix with the cache on, as bench_serve.py runs it
    server = serve.server(max_concurrency=2 * SERVE_CLIENTS)
    stmts = {sql: server.prepare(sql)
             for sql in (PREP_Q6, PREP_TOPK, PREP_KAGG)}
    device0 = cat.device_bytes
    uncached = serve_pass(torch, native, server, classes, serial, stmts,
                          "cache_off", smi)
    for k in ("dense_slot_reduce", "contains"):
        check(uncached["launches"][k] > 0,
              f"serve: {k} never launched from a server query")
    check(all(s.template_count == 1 for s in stmts.values()),
          "serve: a prepared statement parsed more than one template")
    server.close()
    cached_s = serve_session(base)
    cached = serve_pass(torch, native, cached_s.server(
        max_concurrency=2 * SERVE_CLIENTS), classes, serial,
        {sql: cached_s.prepare(sql) for sql in stmts}, "cache_on", smi)
    check(cached["cache"]["hits"] > 0, "serve: the cache never hit")
    cached_s.stop()
    check(cat.device_bytes == device0, "serve: device bytes left by the "
          f"concurrent passes: {cat.device_bytes} against {device0}")

    # one query traced alone, on the caller's thread and through a
    # server's one worker (torch.profiler is not thread-safe: nothing
    # runs beside it)
    q6 = classes[1][2]
    phase_trace(torch, lambda: q6._host(), "serve_tpch_q6_direct")
    one = serve_session({**base,
                         "spark.rapids.server.resultCache.enabled": False})
    worker = one.server(max_concurrency=1)
    phase_trace(torch, lambda: worker.submit(q6).result(timeout=300),
                "serve_tpch_q6_server")
    one.stop()

    # 4. the deliberate checks
    checks = {}
    s = serve_session(base)
    server = s.server(max_concurrency=4)
    # a re-submitted query hits; its view registered anew misses
    q = PREP_KAGG.replace("?", "0.25")
    first, again = server.submit(q), None
    first.result(timeout=300)
    again = server.submit(q)
    check(again.result(timeout=300).equals(first.result()) and
          again.cache_hit and not first.cache_hit,
          "serve: a re-submitted query did not hit the cache")
    s.create_dataframe(agg_data).create_or_replace_temp_view("agg")
    fresh = server.submit(q)
    check(fresh.result(timeout=300).equals(first.result())
          and not fresh.cache_hit,
          "serve: a view registered anew still hit the cache")
    checks["cache"] = [first.cache_hit, again.cache_hit, fresh.cache_hit]
    # re-binding parses once a type signature
    stmt = server.prepare(PREP_KAGG)
    execs0 = server.stats()["prepared_execs"]
    for b in KAGG_BINDINGS + [(0.75,)]:
        server.submit(stmt, params=b).result(timeout=300)
    check(server.stats()["prepared_execs"] == execs0 + 4
          and stmt.template_count == 1,
          "serve: re-binding parsed more than one template")
    checks["prepared"] = {"execs": server.stats()["prepared_execs"] - execs0,
                          "templates": stmt.template_count}
    # a 1 ms deadline on tpch_q1 is typed; the next query is served
    device0 = cat.device_bytes
    q1 = classes[0][2]
    t0 = time.perf_counter()
    try:
        server.submit(q1, timeout_ms=1).result(timeout=300)
        check(False, "serve: tpch_q1 with a 1 ms deadline finished")
    except st.QueryTimeoutError:
        pass
    cancel_ms = (time.perf_counter() - t0) * 1e3
    check(server.submit(q6).result(timeout=300).equals(serial["tpch_q6"]),
          "serve: the query after a timeout is wrong")
    check(cat.device_bytes == device0, "serve: the timeout left device bytes")
    checks["timeout"] = {"typed": True, "ms_to_error": cancel_ms}
    server.close()
    s.stop()
    # a one-byte budget fails a full ORDER BY typed; a neighbour finishes
    s = serve_session({**base, "spark.rapids.server.tenant.greedy."
                       "maxDeviceBytes": 1})
    server = s.server(max_concurrency=4)
    device0 = cat.device_bytes
    greedy = server.submit("SELECT l_orderkey, l_extendedprice FROM lineitem "
                           "ORDER BY l_extendedprice, l_orderkey",
                           tenant="greedy")
    polite = server.submit(q6, tenant="polite")
    try:
        greedy.result(timeout=300)
        check(False, "serve: the one-byte budget's ORDER BY finished")
    except st.QueryBudgetExceededError:
        pass
    check(polite.result(timeout=300).equals(serial["tpch_q6"]),
          "serve: the budget-less neighbour is wrong")
    check(cat.device_bytes == device0, "serve: the budget left device bytes")
    checks["budget"] = {"typed": True,
                        "budget_spills": cat.stats()["budget_spill_count"],
                        "exceeded": cat.stats()["budget_exceeded_count"]}
    server.close()
    s.stop()
    # server.admit=count:1 sheds the first submit typed; the queue serves
    s = serve_session({**base, "spark.rapids.faults.server.admit": "count:1"})
    server = s.server(max_concurrency=4)
    device0 = cat.device_bytes
    try:
        server.submit(q6)
        check(False, "serve: server.admit=count:1 did not fire")
    except faults.InjectedFault:
        pass
    check(server.submit(q6).result(timeout=300).equals(serial["tpch_q6"]),
          "serve: the query after an admission fault is wrong")
    check(cat.device_bytes == device0, "serve: the admit fault left bytes")
    checks["admit_fault"] = {"typed": True,
                             "waiting": server.stats()["queue"]["waiting"]}
    server.close()
    s.stop()
    faults.reset()
    # server.cache.lookup=always keeps every result right, counted
    s = serve_session({**base, "spark.rapids.faults.server.cache.lookup":
                       "always"})
    server = s.server(max_concurrency=4)
    for name in ("tpch_q6", "prep_kagg_1", "prep_kagg_1"):
        spec = dict((n, sp) for n, _, sp in classes)[name]
        got = serve_submit(server, spec, "batch",
                           {PREP_KAGG: server.prepare(PREP_KAGG)})
        check(got.result(timeout=300).equals(serial[name])
              and not got.cache_hit, f"serve: {name} under cache faults")
    cache = server.stats()["cache"]
    check(cache["faults"] == 3 and cache["hits"] == 0,
          f"serve: cache faults not counted: {cache}")
    checks["cache_fault"] = {"faults": cache["faults"], "hits": cache["hits"]}
    server.close()
    s.stop()
    faults.reset()
    serve.stop()
    left = [t.name for t in threading.enumerate()
            if t.name.startswith(THREAD_PREFIX)]
    check(not left, f"serve: threads left after close and stop: {left}")
    check(cat.audit_leaks() == 0, "serve: spill handles left")
    hist = registry.histogram_snapshots()
    emit("serve_checks", checks=checks, threads_left=left,
         lifecycle=lifecycle.global_stats(),
         admit_wait_us=hist.get("server.admit.wait.us"),
         sem_wait_us=hist.get("tpu.semaphore.wait.us"),
         seconds=time.perf_counter() - t_phase, card=smi)


# -- the adaptive phase -------------------------------------------------------

AQE_QUERIES = ("q3", "q5", "q8", "q10", "q18")
SKEW_ROWS = LINEITEM_ROWS
SKEW_KEYS = 32
SKEW_ZIPF_A = 1.2
# tests/test_adaptive.py's SKEW_CONF at 20,000 rows, scaled by 300 to
# 6,001,215 rows (its advisory 16,384 and threshold 8,192 bytes; factor 2)
SKEW_CONF = {
    "spark.sql.autoBroadcastJoinThreshold": -1,
    "spark.rapids.sql.adaptive.advisoryPartitionSizeInBytes": 16_384 * 300,
    "spark.rapids.sql.adaptive.skewJoin.skewedPartitionThresholdInBytes":
        8_192 * 300,
    "spark.rapids.sql.adaptive.skewJoin.skewedPartitionFactor": 2,
}
AQE_ON = {"spark.rapids.sql.adaptive.enabled": True}
Q13_OFFICIAL = """
    SELECT c_count, COUNT(*) AS custdist FROM (
      SELECT c_custkey, COUNT(o_orderkey) AS c_count
      FROM customer LEFT OUTER JOIN orders
        ON c_custkey = o_custkey
        AND o_comment NOT LIKE '%special%requests%'
      GROUP BY c_custkey) c_orders
    GROUP BY c_count ORDER BY custdist DESC, c_count DESC"""


def gen_skew(n: int = SKEW_ROWS, seed: int = SEED + 20):
    """skew_join_6m's fact and dimension: ``k`` drawn from 32 keys by
    the zipf law of tests/fuzzer.py's gen_skewed_keys (rank r with
    probability proportional to 1 / (r + 1) ** 1.2), ``v`` normal,
    ``w`` int32, from ``default_rng(seed)``; the dimension one row a
    key."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, SKEW_KEYS + 1, dtype=np.float64)
    pmf = ranks ** -SKEW_ZIPF_A
    pmf /= pmf.sum()
    k = rng.choice(SKEW_KEYS, size=n, p=pmf).astype(np.int64)
    fact = {"k": k, "v": rng.standard_normal(n),
            "w": rng.integers(-1000, 1000, n, dtype=np.int32)}
    dim = {"k": np.arange(SKEW_KEYS, dtype=np.int64),
           "g": (np.arange(SKEW_KEYS, dtype=np.int64) * 7) % 5}
    return fact, dim


def skew_query(st, F, fact, dim):
    """skew_join_6m: the fact joined to the dimension on ``k``, then
    ``GROUP BY k`` with a count and a sum (the dense-slot kernel)."""
    return (fact.join(dim, on="k", how="inner")
                .group_by(st.col("k"))
                .agg(F.count(st.col("w")).alias("c"),
                     F.sum(st.col("v")).alias("s")))


def sorted_by(torch, result, key: str):
    """A ``to_torch`` result with its rows ordered by the integer column
    ``key`` (for a query whose row order the plan does not fix)."""
    cols, masks, n = result
    order = torch.argsort(cols[key][:n], stable=True)
    return ({k: (v[0][:n][order], v[1][:n][order]) if isinstance(v, tuple)
             else v[:n][order] for k, v in cols.items()},
            {k: m[:n][order] for k, m in masks.items()}, n)


def adaptive_run(torch, native, session, query, runs: int = 1):
    """``query`` timed as ``run_timed`` times it, with the K1 launches
    and the catalog's device bytes of the runs -> (result, seconds,
    launches, the adaptive wrapper or None, the plan)."""
    from spark_rapids_tpu_torch.plan.adaptive import find_adaptive
    cat = session.runtime.catalog
    device0 = cat.device_bytes
    before = native.LAUNCHES["dense_slot_reduce"]
    out, secs = run_timed(torch, query, runs)
    launches = native.LAUNCHES["dense_slot_reduce"] - before
    check(cat.device_bytes == device0, "adaptive: the query left "
          f"{cat.device_bytes - device0} device bytes in the catalog")
    plan = session._last_plan
    return out, secs, launches, find_adaptive(plan), plan


def decisions(wrapper) -> list:
    return [{k: r.get(k) for k in ("decision", "coalesced", "skew_splits",
                                   "fallback") if r.get(k) is not None}
            for r in wrapper.reports]


def metric_sum(plan, name: str) -> int:
    return plan.metrics.get(name, 0) + sum(metric_sum(c, name)
                                           for c in plan.children)


def phase_adaptive(torch, st, F, native, main, dim, tpch, smi: str) -> None:
    """Adaptive execution on the card (``spark.rapids.sql.adaptive.
    enabled``): hash_join_1m, five TPC-H queries at SF1, TPC-H Q13's
    official text, skew_join_6m and the replan fault, each against its
    run with adaptive execution off."""
    from spark_rapids_tpu_torch import faults
    from spark_rapids_tpu_torch.bench.tpch import TPCH_QUERIES, load_tables
    t_phase = time.perf_counter()
    off = st.TorchSession({})
    on = st.TorchSession(dict(AQE_ON))

    # 1. hash_join_1m: the dimension promoted, the fact never shuffled
    times = {}
    res = {}
    for label, s in (("off", off), ("on", on)):
        q = hash_join_query(st, F, s.create_dataframe(main),
                            s.create_dataframe(dim))
        out, secs, k1, w, plan = adaptive_run(torch, native, s, q)
        res[label], times[label] = sorted_by(torch, out, "grp"), secs
        check(k1 > 0, f"hash_join_1m ({label}): K1 never launched")
    same_rows(torch, res["on"], res["off"], "adaptive hash_join_1m")
    check(w is not None and [r.get("decision") for r in w.reports]
          .count("broadcast_promoted") == 1,
          f"hash_join_1m: no single promotion: {w and w.reports}")
    body = w.children[0]
    exchanges = _plan_nodes(body, "TorchShuffleExchangeExec")
    check(len(exchanges) == 1, f"hash_join_1m: {len(exchanges)} shuffle "
          "exchanges left, not the build stage's one")
    check(len(_plan_nodes(body, "TorchBroadcastHashJoinExec")) == 1,
          "hash_join_1m: the promoted join is not a broadcast join")
    emit("adaptive", query="hash_join_1m", decisions=decisions(w),
         seconds_off=times["off"], seconds_on=times["on"], card=smi)

    # 2. the bench's TPC-H queries at SF1
    dfs = {"off": load_tables(off, tpch), "on": load_tables(on, tpch)}
    for qname in AQE_QUERIES:
        for label, s in (("off", off), ("on", on)):
            out, secs, k1, w, _ = adaptive_run(
                torch, native, s, TPCH_QUERIES[qname](dfs[label]))
            res[label], times[label] = out, secs
            if label == "on":
                check(w is not None, f"tpch_{qname}: no adaptive wrapper")
                if qname == "q8":
                    check(k1 > 0, "tpch_q8 (on): K1 never launched")
        same_rows(torch, res["on"], res["off"], f"adaptive tpch_{qname}")
        emit("adaptive", query=f"tpch_{qname}", decisions=decisions(w),
             metrics={m: metric_sum(s._last_plan, m) for m in (
                 "aqeReplans", "broadcastPromotions", "broadcastDemotions",
                 "coalescedPartitions", "skewSplits")},
             seconds_off=times["off"], seconds_on=times["on"], card=smi)

    # 3. TPC-H Q13's official text: the LEFT OUTER JOIN's condition on
    # the card, off and on, each against the same text on the CPU
    cpu = st.TorchSession({"spark.rapids.torch.device": "cpu"})
    for s in (off, on, cpu):
        for name, df in load_tables(s, {t: tpch[t] for t in (
                "customer", "orders")}).items():
            df.create_or_replace_temp_view(name)
    t0 = time.perf_counter()
    want = cpu.sql(Q13_OFFICIAL).to_torch()
    cpu_s = time.perf_counter() - t0
    for label, s in (("off", off), ("on", on)):
        out, secs, k1, w, plan = adaptive_run(torch, native, s,
                                              s.sql(Q13_OFFICIAL))
        check(k1 > 0, f"tpch_q13_sql ({label}): K1 never launched")
        (join,) = [j for j in _plan_nodes(plan, "TorchHashJoinExec")
                   + _plan_nodes(plan, "TorchBroadcastHashJoinExec")]
        check(join.condition is not None and join.route == "general",
              f"tpch_q13_sql ({label}): the condition is not on the join")
        same_rows(torch, out, to_device(want, out[1]["c_count"].device),
                  f"tpch_q13_sql ({label}) against the CPU session")
        times[label] = secs
        res[label] = out
    emit("adaptive", query="tpch_q13_sql", out_rows=res["on"][2],
         decisions=decisions(w), seconds_off=times["off"],
         seconds_on=times["on"], cpu_seconds=cpu_s, card=smi)

    # 4. skew_join_6m: the hot partition splits
    fact, sdim = gen_skew()
    groups = {}
    for label, conf in (("off", SKEW_CONF), ("on", {**AQE_ON,
                                                    **SKEW_CONF})):
        s = st.TorchSession(conf)
        q = skew_query(st, F, s.create_dataframe(fact),
                       s.create_dataframe(sdim))
        out, secs, k1, w, plan = adaptive_run(torch, native, s, q)
        check(k1 > 0, f"skew_join_6m ({label}): K1 never launched")
        res[label], times[label] = sorted_by(torch, out, "k"), secs
        if label == "on":
            stream = [r for r in w.reports
                      if r.get("decision") == "stream_side"]
            check(len(stream) == 1, f"skew_join_6m: {w.reports}")
            splits = metric_sum(plan, "skewSplits")
            check(splits >= 1, "skew_join_6m: the hot partition did not "
                  "split")
            groups = {"largest_partition_bytes": max(
                stream[0]["partition_bytes"]),
                "largest_group_bytes": max(stream[0]["group_bytes"]),
                "partition_bytes": stream[0]["partition_bytes"],
                "group_bytes": stream[0]["group_bytes"],
                "skew_splits": splits}
    same_rows(torch, res["on"], res["off"], "adaptive skew_join_6m")
    check(res["on"][2] == SKEW_KEYS, "skew_join_6m: not every key")
    check(int(res["on"][0]["c"].sum()) == SKEW_ROWS,
          "skew_join_6m: the counts do not add up to the rows")
    emit("adaptive", query="skew_join_6m", rows=SKEW_ROWS,
         conf=SKEW_CONF, seconds_off=times["off"], seconds_on=times["on"],
         card=smi, **groups)

    # 5. the replan fault: every pass falls back, the join stays shuffled
    fconf = {**AQE_ON, "spark.rapids.faults.aqe.replan": "always"}
    faults.configure_from_conf(fconf)
    try:
        s = st.TorchSession(fconf)
        q = hash_join_query(st, F, s.create_dataframe(main),
                            s.create_dataframe(dim))
        out, secs, k1, w, plan = adaptive_run(torch, native, s, q, runs=1)
        fired = faults.injector().stats()["aqe.replan"]["fired"]
    finally:
        faults.reset()
    check(fired > 0 and w.reports and all("fallback" in r
                                          for r in w.reports),
          f"replan_fault: {w.reports}")
    check(metric_sum(plan, "aqeReplans") == 0, "replan_fault: a replan "
          "counted")
    check(not _plan_nodes(plan, "TorchBroadcastHashJoinExec")
          and len(_plan_nodes(plan, "TorchShuffleExchangeExec")) == 2,
          "replan_fault: the join did not stay shuffled")
    want = hash_join_query(st, F, off.create_dataframe(main),
                           off.create_dataframe(dim)).to_torch()
    same_rows(torch, sorted_by(torch, out, "grp"),
              sorted_by(torch, want, "grp"), "replan_fault")
    emit("adaptive", query="replan_fault", fired=fired, seconds=secs,
         reports=len(w.reports), card=smi)
    emit("adaptive_phase", seconds=time.perf_counter() - t_phase, card=smi)


# -- phase 21: query profiles and metrics on the card ------------------------

OBSERVE_QUERIES = ("hash_agg_sort_2m", "text_filter_agg_6m",
                   "hash_join_1m", "tpch_q3")


def observe_builders(st, F, agg_data, line_cols, main, dim, tpch):
    """Each observe query as a function of a session -> its DataFrame."""
    from spark_rapids_tpu_torch.bench.tpch import TPCH_QUERIES, load_tables
    return {
        "hash_agg_sort_2m": lambda s: agg_query(
            st, F, s.create_dataframe(agg_data)),
        "text_filter_agg_6m": lambda s: text_agg_query(
            st, F, s.create_dataframe(line_cols)),
        "hash_join_1m": lambda s: hash_join_query(
            st, F, s.create_dataframe(main), s.create_dataframe(dim)),
        "tpch_q3": lambda s: TPCH_QUERIES["q3"](load_tables(
            s, {t: tpch[t] for t in ("customer", "orders", "lineitem")})),
    }


def profile_rows(profile) -> list:
    """[(operator, numOutputRows)] of a ``QueryProfile``, in tree
    order."""
    out = []

    def walk(node):
        out.append((node.name, node.rows))
        for c in node.children:
            walk(c)
    walk(profile.root)
    return out


def quiet(fn):
    """``fn()`` with what it writes to stdout kept -> (value, text)."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        value = fn()
    return value, buf.getvalue()


def phase_observe(torch, st, F, native, agg_data, line_cols, main, dim,
                  tpch, smi: str) -> None:
    """explain(analyze=True), the profile, hostSyncs, explain() and
    to_device_batches() on the card against a plain collect() and the
    CPU session's profile; then one query's trace under trace.dir."""
    import glob
    import tempfile
    from spark_rapids_tpu_torch.columnar.batch import device_batch_to_host
    t_phase = time.perf_counter()
    gpu = st.TorchSession(dict(AQE_ON))
    cpu = st.TorchSession({**AQE_ON, "spark.rapids.torch.device": "cpu"})
    builders = observe_builders(st, F, agg_data, line_cols, main, dim, tpch)
    for name in OBSERVE_QUERIES:
        build = builders[name]
        df = build(gpu)
        df._host()  # warm-up
        t0 = time.perf_counter()
        want = df._host()
        torch.cuda.synchronize()
        collect_s = time.perf_counter() - t0
        syncs_collect = host_syncs(gpu._last_plan)
        t0 = time.perf_counter()
        txt, _ = quiet(lambda: df.explain(analyze=True))
        torch.cuda.synchronize()
        explain_s = time.perf_counter() - t0
        prof = gpu.last_query_profile()
        syncs_explain = host_syncs(gpu._last_plan)
        check(prof.root.rows == want.num_rows,
              f"observe {name}: the profile's root counts "
              f"{prof.root.rows} rows, the result has {want.num_rows}")
        check(syncs_explain == syncs_collect,
              f"observe {name}: {syncs_explain} host syncs under explain, "
              f"{syncs_collect} in a plain collect")
        quiet(lambda: build(cpu).explain(analyze=True))
        got_rows, cpu_rows = profile_rows(prof), profile_rows(
            cpu.last_query_profile())
        check(got_rows == cpu_rows,
              f"observe {name}: operator rows {got_rows} on the card, "
              f"{cpu_rows} on the CPU")
        if name == "hash_agg_sort_2m":
            check("pallasAggBatches=" in txt,
                  "observe: K1's batches missing from the profile")
        # explain() without analyze runs nothing
        before = dict(native.LAUNCHES)
        plan_txt, _ = quiet(lambda: build(gpu).explain())
        check(dict(native.LAUNCHES) == before and
              "Physical plan:" in plan_txt,
              f"observe {name}: explain() launched a kernel")
        # the handoff: CUDA tensors, the collected rows
        batches = df.to_device_batches()
        check(all(c.data.device == gpu.device == c.validity.device
                  for b in batches for c in b.columns),
              f"observe {name}: a handed-off tensor is not on "
              f"{gpu.device}")
        schema = df.schema
        parts = [device_batch_to_host(b, schema) for b in batches]
        rows = sum(b.num_rows for b in batches)
        check(rows == want.num_rows,
              f"observe {name}: {rows} handed-off rows, {want.num_rows} "
              "collected")
        for f in schema:
            a = np.concatenate([p[f.name][1] for p in parts]) if parts \
                else np.zeros(0, bool)
            check(np.array_equal(a, want.columns[f.name][1]),
                  f"observe {name}: the nulls of {f.name} differ")
            vals = [p[f.name][0] for p in parts]
            w = want.columns[f.name][0]
            if hasattr(w, "to_bytes"):
                from spark_rapids_tpu_torch.columnar.batch import \
                    concat_host_values
                got = concat_host_values(vals).to_bytes() if vals else None
                check(got is None or all(np.array_equal(x, y) for x, y in
                                         zip(got, w.to_bytes())),
                      f"observe {name}: the strings of {f.name} differ")
            else:
                got = np.concatenate(vals) if vals else w[:0]
                check(np.array_equal(got[a], w[a]),
                      f"observe {name}: {f.name} differs")
        emit("observe", query=name, rows=want.num_rows, collect_s=collect_s,
             explain_analyze_s=explain_s, host_syncs=syncs_collect,
             operators=len(got_rows), handoff_batches=len(batches),
             handoff_device=str(gpu.device),
             explain=txt.splitlines(), card=smi)
    # one query's capture under trace.dir: a K1 kernel and a join range
    with tempfile.TemporaryDirectory(prefix="chip-smoke-trace-") as tdir:
        traced = st.TorchSession({"spark.rapids.sql.trace.enabled": True,
                                  "spark.rapids.sql.trace.dir": tdir})
        builders["hash_join_1m"](traced)._host()
        files = glob.glob(os.path.join(tdir, "*.json"))
        check(len(files) == 1, f"observe: {len(files)} traces written")
        with open(files[0], encoding="utf-8") as fh:
            names = {e.get("name") or "" for e in json.load(fh)[
                "traceEvents"]}
        kernels = sorted(n for n in names if "dsr_" in n
                         or "contains_shift_and" in n
                         or "contains_long" in n)
        joins = sorted(n for n in names if n.startswith("join."))
        check(bool(kernels) and bool(joins),
              f"observe: the trace lacks a kernel ({kernels}) or a join "
              f"range ({joins})")
        emit("observe_trace", query="hash_join_1m", events=len(names),
             kernels=kernels, join_ranges=joins,
             bytes=os.path.getsize(files[0]))
    emit("observe_phase", seconds=time.perf_counter() - t_phase, card=smi)


# -- phase 22: the serving fleet on one card ---------------------------------

# bench_serve.py:278-293, less the compile store's keys (no compile store
# is ported)
# the compile store's directory: phase 28's processes fill it, phase
# 22's replicas load from it
COMPILE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "_smoke_files", "compile_store")
FLEET_CONF = {
    "spark.rapids.sql.incompatibleOps.enabled": "true",
    "spark.rapids.fleet.replicas": "2",
    "spark.rapids.fleet.heartbeat.intervalMs": "100",
    "spark.rapids.fleet.heartbeat.timeoutMs": "3000",
    "spark.rapids.fleet.health.probationMs": "1000",
    "spark.rapids.fleet.retry.budgetPerMin": "100",
    "spark.rapids.sql.compile.store.enabled": "true",
    "spark.rapids.sql.compile.cacheDir": COMPILE_DIR,
    "spark.rapids.server.resultCache.enabled": "false",
    "spark.rapids.server.tenant.defaultTimeoutMs": "120000",
}
# fleet_soak's query (bench_serve.py:266-267)
SOAK_SQL = ("SELECT l_orderkey, SUM(l_quantity) AS q FROM lineitem "
            "WHERE l_quantity > 30.0 GROUP BY l_orderkey")
Q1_SQL = (
    "SELECT l_returnflag, l_linestatus, SUM(l_quantity) AS sum_qty, "
    "SUM(l_extendedprice) AS sum_base_price, "
    "SUM(l_extendedprice * (1.0 - l_discount)) AS sum_disc_price, "
    "SUM(l_extendedprice * (1.0 - l_discount) * (1.0 + l_tax)) "
    "AS sum_charge, AVG(l_quantity) AS avg_qty, "
    "AVG(l_extendedprice) AS avg_price, AVG(l_discount) AS avg_disc, "
    "COUNT(*) AS count_order FROM lineitem "
    "WHERE l_shipdate <= DATE '1998-09-02' "
    "GROUP BY l_returnflag, l_linestatus "
    "ORDER BY l_returnflag, l_linestatus")
Q6_SQL = ("SELECT SUM(l_extendedprice * l_discount) AS revenue "
          "FROM lineitem WHERE l_shipdate >= DATE '1994-01-01' "
          "AND l_shipdate < DATE '1995-01-01' AND l_discount >= 0.05 "
          "AND l_discount <= 0.07 AND l_quantity < 24.0")


def fleet_classes():
    """(class, SQL, bindings) of the fleet's mix."""
    items = [("soak", SOAK_SQL, ()), ("tpch_q1", Q1_SQL, ()),
             ("tpch_q6", Q6_SQL, ())]
    items += [(f"prep_kagg_{i}", PREP_KAGG, b)
              for i, b in enumerate(KAGG_BINDINGS)]
    return items


def fleet_pass(fleet, classes, serial, label: str, smi: str,
               mid=None, through_mid: bool = False) -> dict:
    """SERVE_CLIENTS closed-loop clients x SERVE_QUERIES submissions
    over the classes (with ``through_mid``, on until ``mid`` returns);
    ``mid()`` runs on this thread while they do.  Every result must
    equal its serial one bit for bit; an error must be typed (an
    ``EngineError``) -> the pass's numbers (printed)."""
    from spark_rapids_tpu_torch.errors import EngineError
    from spark_rapids_tpu_torch.fleet import stats as fleet_stats
    before = fleet_stats.global_stats()
    lats, wrong, typed, untyped = [], [], [], []
    submitted = [0]
    lock = threading.Lock()
    mid_done = threading.Event()

    def client(c: int) -> None:
        i = 0
        while i < SERVE_QUERIES or (through_mid and not mid_done.is_set()):
            name, sql, params = classes[(c + i) % len(classes)]
            i += 1
            with lock:
                submitted[0] += 1
            t0 = time.perf_counter()
            try:
                res = fleet.submit(sql, tenant=f"{label}-{c % 2}",
                                   params=params).result(timeout=600)
                ok = res.equals(serial[name])
                with lock:
                    lats.append((time.perf_counter() - t0) * 1e3)
                    if not ok:
                        wrong.append(name)
            except EngineError as e:
                with lock:
                    typed.append(f"{name}: {type(e).__name__}")
            except BaseException as e:
                with lock:
                    untyped.append(f"{name}: {type(e).__name__}: {e}")

    threads = [threading.Thread(target=client, args=(c,),
                                name=f"fleet-client-{c}")
               for c in range(SERVE_CLIENTS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    try:
        mid_out = mid() if mid is not None else None
    finally:
        mid_done.set()
    for t in threads:
        t.join(timeout=900)
    wall = time.perf_counter() - t0
    after = fleet_stats.global_stats()
    out = {"pass": label, "submitted": submitted[0],
           "results": len(lats), "typed": typed,
           "wall_s": wall, "queries_per_s": len(lats) / wall,
           "latency_ms": {"p50": pct(lats, 50), "p99": pct(lats, 99)}
           if lats else None,
           "replays": after["failovers"] - before["failovers"],
           "rejected": after["rejected"] - before["rejected"],
           "mid": mid_out, "card": smi}
    emit("fleet_pass", **out)
    check(not any(t.is_alive() for t in threads),
          f"fleet {label}: a client did not finish")
    check(not wrong, f"fleet {label}: wrong results {wrong}")
    check(not untyped, f"fleet {label}: untyped errors {untyped}")
    check(len(lats) + len(typed) == submitted[0],
          f"fleet {label}: {len(lats) + len(typed)} outcomes of "
          f"{submitted[0]} submissions")
    return out


def _replica_compile(fleet, kernels: int) -> dict:
    """Replica 0's ``compile`` section and launches once its warm pool
    has taken every kernel (it runs beside the replica's first
    queries)."""
    deadline = time.monotonic() + 600
    while True:
        snap = fleet.replica_stats(0, timeout=120)
        check(snap is not None, "compile store: no stats from the replica")
        comp = snap["compile"]
        if comp["warmPoolCompiles"] + comp["warmPoolErrors"] >= kernels \
                or time.monotonic() > deadline:
            return {"pid": snap["process"]["pid"], "compile": comp,
                    "launches": snap["kernels"]["launches"]}
        time.sleep(0.2)


def phase_fleet(torch, st, native, tpch, agg_data, smi: str,
                replica_launches: dict) -> None:
    """The fleet on one card; ``replica_launches`` gets the kernels'
    launches counted in the replica processes."""
    import signal
    from spark_rapids_tpu_torch import faults
    from spark_rapids_tpu_torch.errors import EngineError
    from spark_rapids_tpu_torch.fleet import stats as fleet_stats
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()  # leave the card to the replicas
    classes = fleet_classes()
    # the serial results, from this process's own session
    serial_s = st.TorchSession({})
    serial_s.create_dataframe(tpch["lineitem"]) \
        .create_or_replace_temp_view("lineitem")
    serial_s.create_dataframe(agg_data).create_or_replace_temp_view("agg")
    serial = {}
    for name, sql, params in classes:
        serial[name] = serial_s.prepare(sql).execute(*params) if params \
            else serial_s.sql(sql)._host()
        check(serial[name].num_rows > 0, f"fleet: {name} has no rows")
    shipped = {v: int(sum(a.nbytes for a in cols.values()))
               for v, cols in (("lineitem", tpch["lineitem"]),
                               ("agg", agg_data))}
    session = st.TorchSession(dict(FLEET_CONF))
    t0 = time.perf_counter()
    fleet = session.fleet()
    boot_s = time.perf_counter() - t0
    seen = {}  # replica pid -> its launch counts when last read

    def read_launches() -> None:
        for idx in (0, 1):
            snap = fleet.replica_stats(idx, timeout=120)
            if snap is not None:
                seen[snap["process"]["pid"]] = dict(
                    snap["kernels"]["launches"])

    try:
        t0 = time.perf_counter()
        fleet.register_table_view("lineitem", tpch["lineitem"])
        fleet.register_table_view("agg", agg_data)
        check(fleet.probe(0, timeout=600) and fleet.probe(1, timeout=600),
              "fleet: a replica failed its probe after the views")
        views_s = time.perf_counter() - t0
        free, total = torch.cuda.mem_get_info()
        emit("fleet_boot", boot_s=boot_s, views_s=views_s,
             shipped_bytes=shipped, card_memory_used_bytes=total - free,
             card_memory_total_bytes=total,
             pids=[fleet.replica_pid(i) for i in (0, 1)], card=smi)
        passes = [fleet_pass(fleet, classes, serial, "clean", smi)]
        read_launches()

        # replica 0 holds each query it gets, and dies holding them
        check(fleet.configure_faults({"replica.slow": "always@r0"}) == 2,
              "fleet: a replica did not take the slow spec")

        def kill0():
            deadline = time.monotonic() + 120
            while fleet._inflight_count(0) < 1 and \
                    time.monotonic() < deadline:
                time.sleep(0.01)
            held = fleet._inflight_count(0)
            os.kill(fleet.replica_pid(0), signal.SIGKILL)
            return {"killed": 0, "held": held}

        deaths0 = fleet_stats.global_stats()["replica_deaths"]
        killed = fleet_pass(fleet, classes, serial, "sigkill", smi,
                            mid=kill0)
        fleet.configure_faults({})
        check(killed["mid"]["held"] >= 1,
              "fleet: replica 0 held no query when it was killed")
        check(killed["replays"] >= 1, "fleet: no query was replayed")
        check(fleet_stats.global_stats()["replica_deaths"] > deaths0,
              "fleet: the killed replica was not declared dead")
        passes.append(killed)
        hot = {"replace_0": fleet.replace_replica(0)}
        replaced = _replica_compile(fleet, len(native.KERNELS))
        check(replaced["compile"]["nvccBuilds"] == 0
              and replaced["compile"]["compileStoreHits"]
              == len(native.KERNELS),
              f"fleet: the replacement did not load from the store: "
              f"{replaced}")
        passes.append(fleet_pass(fleet, classes, serial, "replaced", smi))
        read_launches()
        restarted = {}

        def restart():
            restarted.update(fleet.rolling_restart())
            return {"hot_s": dict(restarted)}

        rolled = fleet_pass(fleet, classes, serial, "rolling", smi,
                            mid=restart, through_mid=True)
        check(not rolled["typed"] and rolled["rejected"] == 0,
              f"fleet: rejections under the rolling restart: "
              f"{rolled['typed']}")
        passes.append(rolled)
        hot.update({f"rolling_{i}": v for i, v in restarted.items()})
        read_launches()

        # an injected replica.fail replays on the other replica
        f0 = fleet_stats.global_stats()["failovers"]
        faults.configure({"replica.fail": "always@r0"})
        try:
            res = fleet.submit(SOAK_SQL, tenant="fault").result(timeout=600)
        finally:
            faults.reset()
        check(res.equals(serial["soak"]),
              "fleet: the replayed query is wrong")
        check(fleet_stats.global_stats()["failovers"] == f0 + 1,
              "fleet: replica.fail did not replay once")
        # fleet.route raises typed, nothing dispatched
        faults.configure({"fleet.route": "always"})
        try:
            fleet.submit(SOAK_SQL)
            check(False, "fleet: fleet.route=always routed a query")
        except EngineError as e:
            route_error = type(e).__name__
        finally:
            faults.reset()
        read_launches()
    finally:
        session.stop()
        # this process keeps no store: the later phases load from _build/
        from spark_rapids_tpu_torch.compile import store as store_mod
        store_mod.reset()
        shutil.rmtree(COMPILE_DIR, ignore_errors=True)
    for counts in seen.values():
        for k, v in counts.items():
            replica_launches[k] = replica_launches.get(k, 0) + v
    check(replica_launches.get("dense_slot_reduce", 0) > 0,
          f"fleet: K1 never launched in a replica: {seen}")
    emit("fleet", passes=[{k: p[k] for k in ("pass", "queries_per_s",
                                             "latency_ms", "replays")}
                          for p in passes],
         time_to_hot_s=hot, replacement_compile=replaced["compile"],
         pr12_time_to_hot_s=12.1, route_fault=route_error,
         replica_launches=seen, shipped_bytes=shipped,
         stats=fleet_stats.global_stats(),
         seconds=time.perf_counter() - t_phase, card=smi)


# -- phase 23: file I/O and continuous queries --------------------------------

FILES_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "_smoke_files")
# the card's memory rate the decode is held against (bytes a second)
H100_SXM_RATE = 3.35e12
STREAM_PARTS = 8


def _timed(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _tree_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(path) for f in fs)


def _csv_files(path: str) -> list:
    return sorted(os.path.join(d, f) for d, _, fs in os.walk(path)
                  for f in fs if f.endswith(".csv"))


def csv_decode_seconds(torch, files, schema) -> float:
    """The device decode alone: every range of the files uploaded first,
    then split and converted, timed with the card synchronized."""
    from spark_rapids_tpu_torch.io import csv as C
    bufs = [torch.frombuffer(b, dtype=torch.uint8).cuda()
            for f in files for b in C.read_ranges(f)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    first = True
    for buf in bufs:
        s, ln, q = C.split_fields(buf, ",", len(schema))
        if first:
            s, ln, q = s[1:], ln[1:], q[1:]
            first = False
        for r0 in range(0, s.shape[0], 1 << 20):
            r1 = min(s.shape[0], r0 + (1 << 20))
            C.convert_fields(buf, s[r0:r1], ln[r0:r1], q[r0:r1], schema, 512)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _inferred_type(F64, I64, values: np.ndarray, dtype):
    """The type pyarrow infers for a column the port wrote: a double
    column of whole numbers prints them without a dot, so it reads back
    as int64."""
    if dtype == F64 and np.all(np.floor(values) == values):
        return I64
    return dtype


def _csv_lineitem(torch, st, tpch_dfs, smi: str):
    """Write SF1 lineitem as CSV, read it back inferred and typed, check
    every value, run Q1 and Q6 over the scan; -> (typed DataFrame,
    schema, path).  The reads run with the device scan cache off, so
    each one reads and decodes the file (phase 27 times the cache)."""
    from spark_rapids_tpu_torch.bench.tpch import TPCH_QUERIES
    from spark_rapids_tpu_torch.columnar.dtypes import FLOAT64, INT64
    session = st.TorchSession(SCAN_CACHE_OFF)
    mem = tpch_dfs["lineitem"]
    path = os.path.join(FILES_DIR, "lineitem")
    _, write_s = _timed(torch, lambda: mem.write.csv(path))
    files = _csv_files(path)
    nbytes = _tree_bytes(path)
    schema = mem.plan.output_schema()
    want = mem.to_torch()
    inferred = session.read.csv(path)
    check(inferred.plan.output_schema().names == schema.names,
          "csv_lineitem_sf1: inferred names")
    got, read_inferred_s = _timed(torch, inferred.to_torch)
    slow_inferred = metric_sum(session._last_plan, "csvSlowFloatFields")
    host_read_ns = metric_sum(session._last_plan, "csvReadTime")
    upload_ns = metric_sum(session._last_plan, "uploadTime")
    (gc, gm, gn), (wc, wm, wn) = got, want
    check(gn == wn, f"csv_lineitem_sf1: {gn} rows read, {wn} written")
    types = {}
    for f, g in zip(schema, inferred.plan.output_schema()):
        x, y = gc[f.name], wc[f.name]
        expect = _inferred_type(FLOAT64, INT64, y[:wn].cpu().numpy(),
                                f.dtype) if f.dtype == FLOAT64 \
            else f.dtype
        check(g.dtype == expect,
              f"csv_lineitem_sf1: {f.name} inferred {g.dtype}, "
              f"expected {expect}")
        types[f.name] = g.dtype.name
        check(torch.equal(gm[f.name][:gn], wm[f.name][:wn]),
              f"csv_lineitem_sf1: nulls of {f.name}")
        if isinstance(y, tuple):
            check(torch.equal(x[0][:gn], y[0][:wn])
                  and torch.equal(x[1][:gn], y[1][:wn]),
                  f"csv_lineitem_sf1: strings of {f.name}")
        else:
            check(torch.equal(x[:gn].to(y.dtype), y[:wn]),
                  f"csv_lineitem_sf1: values of {f.name}")
    typed = session.read.schema(schema).csv(path)
    got_typed, read_typed_s = _timed(torch, typed.to_torch)
    slow_typed = metric_sum(session._last_plan, "csvSlowFloatFields")
    same_result(torch, got_typed, want, "csv_lineitem_sf1 typed read")
    check(slow_inferred == 0 and slow_typed == 0,
          f"csvSlowFloatFields {slow_inferred}, {slow_typed} on TPC-H data")
    decode_s = csv_decode_seconds(torch, files, schema)
    tables = dict(tpch_dfs)
    tables["lineitem"] = typed
    bitwise = {}
    for q in ("q1", "q6"):
        a, secs = _timed(torch, TPCH_QUERIES[q](tables).to_torch)
        b = TPCH_QUERIES[q](tpch_dfs).to_torch()
        bitwise[q] = same_result(torch, a, b, f"tpch_{q} over csv",
                                 float_rtol=1e-9)
        bitwise[q + "_s"] = secs
    emit("csv_lineitem_sf1", rows=gn, files=len(files), file_bytes=nbytes,
         write_s=write_s, read_inferred_s=read_inferred_s,
         read_typed_s=read_typed_s, host_read_s=host_read_ns / 1e9,
         upload_s=upload_ns / 1e9, decode_s=decode_s,
         decode_gbps=nbytes / decode_s / 1e9,
         decode_bound_s=nbytes / H100_SXM_RATE,
         csvSlowFloatFields=[slow_inferred, slow_typed],
         inferred_types=types, queries=bitwise, nvidia_smi=smi)
    phase_trace(torch, typed, "csv_lineitem_sf1")
    return typed, schema, path


def _uncounted(native, fn):
    """``fn()`` with the launch counts left as they were: a comparison
    of a kernel with its plain version is not a main-path launch."""
    saved = dict(native.LAUNCHES)
    try:
        return fn()
    finally:
        native.LAUNCHES.update(saved)


def _csv_agg(torch, st, F, native, session, agg_data, smi: str) -> float:
    """hash_agg_sort_2m's table through CSV; -> K1's largest f64 sum
    error against its plain version on the scan's own update batch."""
    mem = session.create_dataframe(agg_data)
    path = os.path.join(FILES_DIR, "agg")
    _, write_s = _timed(torch, lambda: mem.write.csv(path))
    df = session.read.schema(mem.plan.output_schema()).csv(path)
    before = native.LAUNCHES["dense_slot_reduce"]
    (cols, masks, n), secs = _timed(torch, agg_query(st, F, df).to_torch)
    launches = native.LAUNCHES["dense_slot_reduce"] - before
    slow = metric_sum(session._last_plan, "csvSlowFloatFields")
    keys, counts, sums, maxes = group_stats(agg_data["k"], agg_data["v"],
                                            agg_data["w"])
    check(launches > 0, "csv_hash_agg_2m: the dense-slot kernel never ran")
    check(n == len(keys), f"csv_hash_agg_2m: {n} groups, numpy {len(keys)}")
    check(np.array_equal(cols["k"].cpu().numpy(), keys), "csv agg keys")
    check(np.array_equal(cols["cnt"].cpu().numpy(), counts),
          "csv agg counts")
    check(np.array_equal(cols["mx"].cpu().numpy(), maxes), "csv agg max")
    check(np.allclose(cols["s"].cpu().numpy(), sums, rtol=1e-9, atol=0),
          "csv agg sums beyond rtol 1e-9")
    emit("csv_hash_agg_2m", rows=len(agg_data["k"]), groups=n,
         file_bytes=_tree_bytes(path), write_s=write_s, query_s=secs,
         kernel_launches=launches, csvSlowFloatFields=slow, nvidia_smi=smi)
    from spark_rapids_tpu_torch.exec import pallas_agg as pag
    return _uncounted(native, lambda: phase_kernel_path(
        torch, pag, session, agg_query(st, F, df), "csv_hash_agg_2m"))


def _csv_text(torch, st, F, native, session, line, smi: str) -> None:
    """text_filter_agg_6m's table through CSV: the char matrix the
    contains kernel reads comes from the device's decoder."""
    mem = session.create_dataframe(line[0])
    path = os.path.join(FILES_DIR, "text")
    _, write_s = _timed(torch, lambda: mem.write.csv(path))
    df = session.read.schema(mem.plan.output_schema()).csv(path)
    before = dict(native.LAUNCHES)
    phase_text_agg(torch, st, F, native, session, df, line,
                   "csv_text_filter_agg_6m", 1)
    got = {k: native.LAUNCHES[k] - before[k] for k in before}
    check(got["contains"] > 0, "csv_text_filter_agg_6m: no contains launch")
    emit("csv_text_filter_agg_6m_io", file_bytes=_tree_bytes(path),
         write_s=write_s, launches=got, nvidia_smi=smi)

    def hold():
        # K2 against its plain version on the first batch the CSV scan
        # decoded: the char matrix the card's decoder built
        from spark_rapids_tpu_torch.exprs import pallas_strings as ps
        batch = df.to_device_batches()[0]
        c = batch.columns[batch.schema.field_index("l_comment")]
        hit = ps.run_contains(c.chars, c.data, NEEDLE.encode())
        torch.cuda.synchronize()
        want = ps.contains_reference(c.chars, c.data, NEEDLE.encode())
        check(torch.equal(hit, want), "contains kernel differs from its "
              "plain version on the CSV-decoded batch")
        emit("kernel_path", name="contains", path="csv_text_filter_agg_6m",
             rows=batch.num_rows, width=c.chars.shape[1],
             hits=int(want.sum()), max_abs_err=0.0)
    _uncounted(native, hold)


def _csv_hive(torch, st, F, session, typed, schema, smi: str) -> None:
    """lineitem partitioned by returnflag and linestatus; a filter on the
    returnflag reads its directories only."""
    col = st.col
    path = os.path.join(FILES_DIR, "hive")
    _, write_s = _timed(torch, lambda: typed.write.partition_by(
        "l_returnflag", "l_linestatus").csv(path))
    dirs = sorted({os.path.relpath(os.path.dirname(f), path)
                   for f in _csv_files(path)})
    names = session.read.csv(path).plan.output_schema().names
    check(names[-2:] == ["l_returnflag", "l_linestatus"],
          f"csv_hive: partition columns last, got {names}")
    from spark_rapids_tpu_torch.columnar.dtypes import Schema
    keys = ("l_returnflag", "l_linestatus")
    hive = session.read.schema(Schema(
        [f for f in schema if f.name not in keys]
        + [schema[schema.field_index(k)] for k in keys])).csv(path)

    def q1ish(df):
        return (df.filter(col("l_returnflag") == "R")
                  .group_by("l_linestatus")
                  .agg(F.count(col("l_quantity")).alias("n"),
                       F.sum(col("l_quantity")).alias("qty"),
                       F.sum(col("l_extendedprice")).alias("price"),
                       F.min(col("l_orderkey")).alias("lo"),
                       F.max(col("l_shipdate")).alias("hi"))
                  .order_by("l_linestatus"))

    got, secs = _timed(torch, q1ish(hive).to_torch)
    read = metric_sum(session._last_plan, "numFilesRead")
    total = metric_sum(session._last_plan, "numFilesTotal")
    want = q1ish(typed).to_torch()
    same_result(torch, got, want, "csv_hive against the unpartitioned read",
                float_rtol=1e-9)
    r_dirs = [d for d in dirs if d.startswith("l_returnflag=R")]
    check(read == len(r_dirs) and total == len(dirs) and read < total,
          f"csv_hive: read {read} of {total} files, R has {len(r_dirs)}")
    emit("csv_hive", dirs=dirs, files_read=read, files_total=total,
         write_s=write_s, query_s=secs, file_bytes=_tree_bytes(path),
         nvidia_smi=smi)


def _append_lines(torch, session, data, path: str) -> None:
    """The rows of ``data`` appended to the CSV file ``path`` (no
    header), as the writer prints them."""
    from spark_rapids_tpu_torch.io import csvformat
    b = session.create_dataframe(data).to_device_batches()
    with open(path, "ab") as f:
        for batch in b:
            f.write(csvformat.format_rows(batch.schema, batch.columns,
                                          batch.num_rows))


def _stream_agg(torch, st, F, native, agg_data, smi: str) -> None:
    """A standing group_by(k) over a CSV root fed hash_agg_sort_2m's rows
    as appended files, a grown file and a rewritten one; each refresh
    against a full recompute."""
    from spark_rapids_tpu_torch import faults
    from spark_rapids_tpu_torch.obs import registry as obs
    from spark_rapids_tpu_torch.stream import stats as stream_stats
    col = st.col
    root = os.path.join(FILES_DIR, "stream")
    n = len(agg_data["k"])
    tail = n // 64
    cuts = np.linspace(0, n - tail, STREAM_PARTS + 1).astype(np.int64)
    part = [{k: v[cuts[i]:cuts[i + 1]] for k, v in agg_data.items()}
            for i in range(STREAM_PARTS)]
    grown = {k: v[n - tail:] for k, v in agg_data.items()}
    s = st.TorchSession({"spark.rapids.stream.enabled": "true",
                         "spark.rapids.stream.pollIntervalMs": "3600000",
                         "spark.rapids.faults.stream.poll": "count:1"})
    schema = s.create_dataframe(part[0]).plan.output_schema()
    s.create_dataframe(part[0]).write.csv(root)
    stream_stats.reset()
    obs.histogram(obs.HIST_STREAM_FRESHNESS_US).reset()

    def agg(df):
        return df.group_by("k").agg(F.count(col("v")).alias("cnt"),
                                    F.sum(col("v")).alias("s"),
                                    F.max(col("w")).alias("mx"))

    def by_key(result):
        out = result.to_numpy()
        order = np.argsort(out["k"])
        return {k: np.asarray(v)[order] for k, v in out.items()}

    server = s.server(max_concurrency=2)
    try:
        reg = server.streaming
        reg.register_source(root, "csv")
        q = reg.register(agg(s.read.schema(schema).csv(root)), name="kagg")
        check(q.incremental, f"stream_agg: not incremental ({q.reason})")
        ticks = []

        def tick(what: str) -> None:
            t0 = time.perf_counter()
            consumed = reg.tick()
            secs = time.perf_counter() - t0
            got = by_key(q.result())
            want = by_key(agg(s.read.schema(schema).csv(root))._host())
            check(len(got["k"]) == len(want["k"])
                  and np.array_equal(got["k"], want["k"])
                  and np.array_equal(got["cnt"], want["cnt"])
                  and np.array_equal(got["mx"], want["mx"])
                  and np.allclose(got["s"], want["s"], rtol=1e-9, atol=0),
                  f"stream_agg: {what} differs from a full recompute")
            ticks.append({"tick": what, "consumed": consumed,
                          "seconds": secs,
                          "sums_bitwise": bool(np.array_equal(
                              got["s"].view(np.int64),
                              want["s"].view(np.int64)))})

        s.create_dataframe(part[1]).write.mode("append").csv(root)
        check(reg.tick() == 0, "stream_agg: the stream.poll fault did not "
              "skip the tick")
        check(stream_stats.global_stats()["tick_faults"] == 1,
              "stream_agg: tick fault not counted")
        tick("append 1 after the poll fault")
        for i in range(2, STREAM_PARTS):
            s.create_dataframe(part[i]).write.mode("append").csv(root)
            tick(f"append {i}")
        _append_lines(torch, s, grown, _csv_files(root)[-1])
        tick("grown")
        check(stream_stats.global_stats()["batch_grown"] == 1,
              "stream_agg: the grown file was not read as a tail")
        before = stream_stats.global_stats()["recompute_refreshes"]
        flipped = dict(part[0])
        flipped["v"] = -part[0]["v"]
        first = _csv_files(root)[0]
        os.remove(first)
        s.create_dataframe(flipped).write.mode("append").csv(root)
        tick("rewritten")
        gs = stream_stats.global_stats()
        check(gs["recompute_refreshes"] == before + 1,
              "stream_agg: the rewritten file was not a recompute")
        fresh = obs.histogram(obs.HIST_STREAM_FRESHNESS_US).snapshot()
        emit("stream_agg", rows=n, files=len(_csv_files(root)),
             ticks=ticks, stats=gs, freshness_p50_us=fresh["p50"],
             freshness_p99_us=fresh["p99"], refreshes=q.refreshes,
             nvidia_smi=smi)
    finally:
        # the server's close joins the poller; the session's runtime is
        # the main session's, which later phases go on using
        server.close()
        faults.reset()


def _typed_errors(st, session) -> None:
    """Parquet and ORC need pyarrow: without it they raise
    PyarrowRequiredError (simulated where pyarrow is installed)."""
    import importlib.util
    real = importlib.util.find_spec("pyarrow") is None
    saved = {m: sys.modules[m] for m in list(sys.modules)
             if m == "pyarrow" or m.startswith("pyarrow.")}
    if not real:
        for m in saved:
            del sys.modules[m]
        sys.modules["pyarrow"] = None
    try:
        df = session.create_dataframe({"a": np.arange(3)})
        for what, fn in (("write.parquet", lambda: df.write.parquet(
                             os.path.join(FILES_DIR, "pq"))),
                         ("read.orc", lambda: session.read.orc(
                             os.path.join(FILES_DIR, "none.orc")))):
            try:
                fn()
            except st.PyarrowRequiredError as e:
                check("pyarrow" in str(e), f"{what}: {e}")
            else:
                raise SystemExit(f"{what} did not raise "
                                 "PyarrowRequiredError")
    finally:
        if not real:
            del sys.modules["pyarrow"]
            sys.modules.update(saved)
    emit("files_typed_errors", pyarrow_installed=not real, ok=True)


def phase_files(torch, st, F, native, session, tpch_dfs, agg_data, line,
                smi: str, errs: dict) -> None:
    """Phase 23: CSV written and decoded on the card, hive partitions and
    a standing query over tailed CSV files, each checked; K1's error on
    the CSV scan's update batch goes into ``errs``.  The cells that time
    a read or hold a kernel on a decoded batch run with the device scan
    cache off, so each read decodes the file (phase 27 measures the
    cache); the standing query keeps the cache at its default (on)."""
    import shutil
    from spark_rapids_tpu_torch.runtime import TorchRuntime
    t0 = time.perf_counter()
    shutil.rmtree(FILES_DIR, ignore_errors=True)
    os.makedirs(FILES_DIR)
    off = st.TorchSession(SCAN_CACHE_OFF)
    try:
        typed, schema, _ = _csv_lineitem(torch, st, tpch_dfs, smi)
        errs["dense_slot_reduce"] = _csv_agg(torch, st, F, native,
                                             off, agg_data, smi)
        _csv_text(torch, st, F, native, off, line, smi)
        _csv_hive(torch, st, F, off, typed, schema, smi)
        _stream_agg(torch, st, F, native, agg_data, smi)
        _typed_errors(st, session)
    finally:
        shutil.rmtree(FILES_DIR, ignore_errors=True)
        # the scan cache's entries name the removed files
        session.runtime.scan_cache.clear()
        TorchRuntime.invalidate_paths(FILES_DIR)
    emit("files", seconds=time.perf_counter() - t0, nvidia_smi=smi)


# -- phase 24: the compressed domain ---------------------------------------

COMPRESSED_OFF = {"spark.rapids.sql.compressed.enabled": False}
COMPRESSED_TPCH = ("q1", "q3", "q12", "q16")
STATS_KEYS = (("encoded_columns", "encodedColumns"),
              ("plain_columns", "plainColumns"),
              ("late_decodes", "lateDecodes"),
              ("fused_decodes", "fusedDecodes"),
              ("h2d_raw_bytes", "h2d_raw_bytes"),
              ("h2d_wire_bytes", "h2d_wire_bytes"),
              ("encode_faults", "encode_faults"),
              ("rle_columns", "rle_columns"),
              ("delta_columns", "delta_columns"),
              ("packed_bool_columns", "packed_bool_columns"))
PLANE_COUNTERS = ("rle_columns", "delta_columns", "packed_bool_columns")


def stats_since(before: dict) -> dict:
    """The compressed domain's counters since ``before`` (a snapshot of
    ``encoding.compressed_stats()``), under the metric names, and the
    host encoder's ms."""
    from spark_rapids_tpu_torch.columnar import encoding
    after = encoding.compressed_stats()
    return {**{name: after[k] - before[k] for k, name in STATS_KEYS},
            "host_encode_ms": encode_ms_since(before)}


def encode_ms_since(before: dict) -> float:
    """Host ms the string encoder spent building since ``before``."""
    from spark_rapids_tpu_torch.columnar import encoding
    return (encoding.compressed_stats()["host_encode_ns"]
            - before["host_encode_ns"]) / 1e6


def scan_ms(plan) -> float:
    """Host wall of the plan's scans (each batch's encode and upload,
    ms): the scans' ``totalTime``."""
    return sum(n.metrics.get("totalTime", 0) / 1e6
               for n in _plan_nodes(plan, "TorchLocalScanExec")
               + _plan_nodes(plan, "TorchCsvScanExec"))


def host_bitwise(got, want) -> bool:
    """Whether two ``HostResult``s' float columns are bit for bit alike
    (``host_same_rows`` has checked everything else)."""
    for f in want.schema:
        (a, va), (b, vb) = got.columns[f.name], want.columns[f.name]
        if not hasattr(a, "to_bytes") and a.dtype.kind == "f" \
                and not np.array_equal(a[va].view(np.uint8),
                                       b[vb].view(np.uint8)):
            return False
    return True


def op_metric(plan, name: str) -> dict:
    """``name`` summed by operator class over a plan, zeros left out."""
    out = {}

    def walk(n):
        v = int(n.metrics.get(name, 0))
        if v:
            out[type(n).__name__] = out.get(type(n).__name__, 0) + v
        for c in n.children:
            walk(c)
    walk(plan)
    return out


def compressed_pair(torch, st, name: str, build, verify=None,
                    runs: int = 1, smi: str = "", off=None,
                    phase: str = "compressed", base=None, **extra):
    """``build(session)``'s query with compressed execution on (the
    default) and ``off`` (the master key false unless given), each one
    warm-up and ``runs`` timed runs through the result pull (codes on
    the wire when on); the two results equal (integers, strings, nulls
    exact; floats within rtol 1e-9, and whether they are bit for bit is
    printed), ``verify(HostResult)`` the reference's check of the on
    run.  Prints each mode's counters (of its warm-up), each operator's
    ``encodedColumns``, scan ms and seconds of the warm-up (``cold_*``:
    on, a first scan, which builds every dictionary and plane on the
    host, ``host_encode_ms``) and of the timed runs (on, served by the
    local scan's memo, but for a writable numpy column's plane, which
    is planned again each scan), with the memo's host bytes after
    them; the off side takes no plane encoding, and a run
    that took a plane or a dictionary crossed fewer bytes than it
    stands for; ``base`` is the conf both sides add; -> (on result, its
    counters)."""
    from spark_rapids_tpu_torch.columnar import encoding
    off = COMPRESSED_OFF if off is None else off
    res, line = {}, {}
    for mode, conf in (("on", {}), ("off", off)):
        s = st.TorchSession({**(base or {}), **conf})
        q = build(s)
        encoding.clear_memo()
        before = encoding.compressed_stats()
        t0 = time.perf_counter()
        res[mode] = q._host()
        torch.cuda.synchronize()
        cold = time.perf_counter() - t0
        stats = stats_since(before)
        cold_scan = scan_ms(s._last_plan)
        secs, scans = [], []
        before = encoding.compressed_stats()
        for _ in range(runs):
            t0 = time.perf_counter()
            res[mode] = q._host()
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            scans.append(scan_ms(s._last_plan))
        line[mode] = {**stats, "cold_scan_ms": cold_scan,
                      "cold_seconds": cold, "scan_ms": scans,
                      "seconds": secs,
                      "warm_host_encode_ms": encode_ms_since(before),
                      "memo_host_bytes":
                          encoding.compressed_stats()["memo_host_bytes"],
                      "encodedColumns_by_op": op_metric(s._last_plan,
                                                        "encodedColumns")}
    on, res_off = res["on"], res["off"]
    host_same_rows(on, res_off, f"{name}: on against off")
    if verify is not None:
        verify(on)
    st_on = line["on"]
    if off is COMPRESSED_OFF:
        check(line["off"]["encodedColumns"] == 0,
              f"{name}: compressed off encoded a column")
    check(not any(line["off"][c] for c in PLANE_COUNTERS),
          f"{name}: the off side took a plane encoding: {line['off']}")
    won = st_on["encodedColumns"] + sum(st_on[c] for c in PLANE_COUNTERS)
    if won and st_on["h2d_raw_bytes"]:
        check(st_on["h2d_wire_bytes"] < st_on["h2d_raw_bytes"],
              f"{name}: wire bytes {st_on['h2d_wire_bytes']} not below raw "
              f"{st_on['h2d_raw_bytes']}")
    emit(phase, cell=name, rows=on.num_rows,
         floats_bit_for_bit=host_bitwise(on, res_off), on=line["on"],
         off=line["off"], nvidia_smi=smi, **extra)
    return on, st_on


def _host_cols(result) -> dict:
    """A ``HostResult`` -> {name: numpy values (strings as str)}, with
    no null allowed."""
    out = {}
    for name, (values, valid) in result.columns.items():
        check(bool(valid.all()), f"unexpected nulls in {name}")
        out[name] = np.asarray(values.to_pylist()) \
            if hasattr(values, "to_pylist") else values
    return out


def _check_host(result, want, limit, qname: str, tie_key="revenue"):
    """``check_tpch`` over a ``HostResult``."""
    cols = _host_cols(result)
    n = result.num_rows
    rows = len(next(iter(want.values())))
    check(n == rows, f"{qname}: {n} rows, the reference has {rows}")
    tied = np.zeros(rows, bool)
    if limit is not None and tie_key in want:
        near = np.isclose(want[tie_key][1:], want[tie_key][:-1],
                          rtol=1e-9, atol=0)
        tied[1:] |= near
        tied[:-1] |= near
    for name, w in want.items():
        g, w = np.asarray(cols[name]), np.asarray(w)
        if w.dtype.kind == "f":
            check(np.allclose(g[~tied], w[~tied], rtol=1e-9, atol=0)
                  and np.allclose(np.sort(g[tied]), np.sort(w[tied]),
                                  rtol=1e-9, atol=0),
                  f"{qname}: {name} beyond rtol 1e-9")
        else:
            check(np.array_equal(g[~tied], w[~tied])
                  and sorted(g[tied].tolist()) == sorted(w[tied].tolist()),
                  f"{qname}: {name} differs from the reference's")


def _shipmode_agg(torch, st, F, native, pag, tpch, smi: str) -> float:
    """group_by(l_shipmode) over SF1 lineitem: no late decode, K1 over
    the codes, against numpy; -> K1's largest f64 sum error against its
    plain version on the query's own update batch."""
    from spark_rapids_tpu_torch.columnar import encoding
    col = st.col
    li = tpch["lineitem"]
    s = st.TorchSession({})
    q = s.create_dataframe(li).group_by(col("l_shipmode")).agg(
        F.count(col("l_quantity")).alias("c"),
        F.sum(col("l_quantity")).alias("s"),
        F.max(col("l_extendedprice")).alias("m"))
    encoding.clear_memo()
    b0 = encoding.compressed_stats()
    t0 = time.perf_counter()
    q._host()
    torch.cuda.synchronize()
    cold = {"seconds": time.perf_counter() - t0,
            "scan_ms": scan_ms(s._last_plan),
            "host_encode_ms": encode_ms_since(b0)}
    before = encoding.compressed_stats()
    k1 = native.LAUNCHES["dense_slot_reduce"]
    t0 = time.perf_counter()
    got = q._host()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    stats = stats_since(before)
    launches = native.LAUNCHES["dense_slot_reduce"] - k1
    (agg,) = _plan_nodes(s._last_plan, "TorchHashAggregateExec")
    dense = agg.metrics["pallasAggBatches"]
    check(stats["lateDecodes"] == 0,
          f"compressed_shipmode_agg: {stats['lateDecodes']} late decodes")
    check(stats["encodedColumns"] > 0 and dense > 0 and launches >= dense,
          f"compressed_shipmode_agg: K1 took {dense} batches over codes, "
          f"{launches} launches, {stats['encodedColumns']} encoded columns")
    modes, inv = np.unique(li["l_shipmode"], return_inverse=True)
    want = {"l_shipmode": modes,
            "c": np.bincount(inv, minlength=len(modes)),
            "s": np.bincount(inv, li["l_quantity"], minlength=len(modes)),
            "m": np.array([li["l_extendedprice"][inv == i].max()
                           for i in range(len(modes))])}
    _check_host(got, want, None, "compressed_shipmode_agg")
    emit("compressed", cell="compressed_shipmode_agg", rows=got.num_rows,
         dense_slot_batches=dense, kernel_launches=launches, seconds=secs,
         scan_ms=scan_ms(s._last_plan), cold=cold, on=stats, nvidia_smi=smi)
    return _uncounted(native, lambda: phase_kernel_path(
        torch, pag, s, q, "compressed_shipmode_agg", codes=True))


def _contains_dict(torch, st, F, native, ps, ops, smi: str) -> None:
    """A 17-byte contains over l_shipinstruct's 4-value dictionary, then
    a count: K2 launches once a run, on the dictionary, equal to its
    plain version there; the count equal to numpy's."""
    from spark_rapids_tpu_torch.columnar import encoding
    col = st.col
    li = ops["lineitem"]
    data = {"l_shipinstruct": li["l_shipinstruct"],
            "l_quantity": li["l_quantity"]}
    needle = SHIP_INSTRUCT[0]
    s = st.TorchSession({})
    df = s.create_dataframe(data)
    q = df.filter(F.contains(col("l_shipinstruct"), needle)).agg(
        F.count(col("l_quantity")).alias("n"))
    # each run evaluates the predicate once over the dictionary (one K2
    # launch on its 8 rows, where the dense path launches one a batch)
    # and gathers the table by code
    encoding.clear_memo()
    before = encoding.compressed_stats()
    k2 = native.LAUNCHES["contains"]
    t0 = time.perf_counter()
    q._host()
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    first = native.LAUNCHES["contains"] - k2
    stats = stats_since(before)
    t0 = time.perf_counter()
    got = q._host()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = native.LAUNCHES["contains"] - k2
    want = int((li["l_shipinstruct"] == needle).sum())
    check(int(got.columns["n"][0][0]) == want,
          f"compressed_contains_dict: {got.columns['n'][0][0]} rows, numpy "
          f"{want}")
    check(first == 1 and launches == 2,
          f"compressed_contains_dict: {first} and {launches - first} K2 "
          "launches in two runs, not one a run on the dictionary")
    (batch,) = df.to_device_batches()[:1]
    d = batch.columns[0].dict
    pat = needle.encode()
    got_k, plain = _uncounted(native, lambda: (
        ps.run_contains(d.chars, d.lengths, pat),
        ps.contains_reference(d.chars, d.lengths, pat)))
    check(torch.equal(got_k, plain),
          "compressed_contains_dict: K2 differs from its plain version "
          "on the dictionary")
    emit("compressed", cell="compressed_contains_dict", rows=len(
        li["l_shipinstruct"]), matched=want, dictionary=d.size,
         dictionary_rows=int(d.chars.shape[0]), needle_bytes=len(pat),
         contains_launches=[first, launches - first], seconds=secs,
         cold_seconds=cold, on=stats,
         nvidia_smi=smi)


def _csv_q1(torch, st, tpch, smi: str) -> None:
    """Q1's columns of SF1 lineitem through CSV, read back typed with
    compressed execution on (the strings encoded on the card) and off;
    Q1 over both bit for bit the in-memory Q1."""
    import shutil
    from spark_rapids_tpu_torch.bench.tpch import TPCH_QUERIES, load_tables
    li = tpch["lineitem"]
    cols = ["l_returnflag", "l_linestatus", "l_quantity", "l_extendedprice",
            "l_discount", "l_tax", "l_shipdate"]
    path = os.path.join(FILES_DIR, "q1")
    shutil.rmtree(path, ignore_errors=True)
    s = st.TorchSession(SCAN_CACHE_OFF)
    mem = s.create_dataframe({c: li[c] for c in cols})
    mem.write.csv(path)
    schema = mem.plan.output_schema()
    want = TPCH_QUERIES["q1"](load_tables(s, {**tpch, "lineitem": {
        c: li[c] for c in cols}}))._host()

    def build(session):
        tables = load_tables(session, tpch)
        tables["lineitem"] = session.read.schema(schema).csv(path)
        return TPCH_QUERIES["q1"](tables)

    def verify(result):
        host_same_rows(result, want, "csv_lineitem_sf1 q1", rtol=1e-9)
        check(host_bitwise(result, want),
              "csv_lineitem_sf1 q1: not bit for bit the in-memory q1")
    try:
        # every run reads the file: the device scan cache off
        compressed_pair(torch, st, "csv_lineitem_sf1_q1", build, verify,
                        smi=smi, base=SCAN_CACHE_OFF)
    finally:
        shutil.rmtree(FILES_DIR, ignore_errors=True)


def phase_compressed(torch, st, F, native, pag, ps, tpch, main, dim, line,
                     xbb, ops, errs: dict, smi: str) -> None:
    """Phase 24: dictionary-encoded string columns, each cell with
    compressed execution on (the default) and off in one call."""
    from spark_rapids_tpu_torch.bench.tpch import TPCH_QUERIES, load_tables
    from spark_rapids_tpu_torch.bench.tpcxbb import TPCXBB_QUERIES, \
        register_views
    t0 = time.perf_counter()
    cpu = st.TorchSession({"spark.rapids.torch.device": "cpu"})
    cpu_dfs = load_tables(cpu, tpch)
    for qname in COMPRESSED_TPCH:
        if qname in ("q1", "q3"):
            want, limit = tpch_reference(tpch, qname)
        else:
            want = _host_cols(TPCH_QUERIES[qname](cpu_dfs)._host())
            limit = None

        def verify(result, want=want, limit=limit, qname=qname):
            _check_host(result, want, limit, qname)
        _, stats = compressed_pair(
            torch, st, f"compressed_tpch_{qname}",
            lambda s, q=qname: TPCH_QUERIES[q](load_tables(s, tpch)),
            verify, smi=smi)
        check(stats["encodedColumns"] > 0,
              f"compressed_tpch_{qname}: no column was encoded")
    errs["dense_slot_reduce"] = _shipmode_agg(torch, st, F, native, pag,
                                              tpch, smi)
    _contains_dict(torch, st, F, native, ps, ops, smi)
    compressed_pair(torch, st, "hash_join_1m", lambda s: hash_join_query(
        st, F, s.create_dataframe(main), s.create_dataframe(dim)), smi=smi)
    compressed_pair(torch, st, "text_filter_agg_6m", lambda s: text_agg_query(
        st, F, s.create_dataframe(line[0])), smi=smi)

    def xbb_q3(s):
        register_views(s, xbb)
        return s.sql(TPCXBB_QUERIES["q3"])
    compressed_pair(torch, st, "tpcxbb_q3", xbb_q3, smi=smi)
    os.makedirs(FILES_DIR, exist_ok=True)
    _csv_q1(torch, st, tpch, smi)
    # the spill run: tpch_q3 with its encoded columns at a quarter of its
    # catalog peak, through the host and disk tiers
    from spark_rapids_tpu_torch.columnar import encoding
    want3, limit3 = tpch_reference(tpch, "q3")
    before = encoding.compressed_stats()
    tier_runs(torch, st, lambda s: TPCH_QUERIES["q3"](load_tables(s, tpch)),
              "compressed_tpch_q3", lambda out: check_tpch(
                  torch, *out, want3, limit3, "q3"))
    stats = stats_since(before)
    check(stats["encodedColumns"] > 0, "compressed_tpch_q3 spilled: no "
          "column was encoded")
    emit("compressed_phase", seconds=time.perf_counter() - t0,
         spill_run=stats, nvidia_smi=smi)


PLANES_OFF = {"spark.rapids.sql.compressed.rle.enabled": False,
              "spark.rapids.sql.compressed.delta.enabled": False,
              "spark.rapids.sql.compressed.packedBool.enabled": False}


def scan_encodings(df) -> tuple:
    """The encoding each column of ``df``'s scan took, batch by batch
    (``{column: {kind: batches}}``), the raw and wire bytes over the scan
    of each plane encoding and of each plane-encoded column (a plane
    column's wire is its compressed planes and validity, its raw the
    plain planes it stands for, as the encoder counts them), and a
    column of each plane kind from the first batch that has one."""
    from spark_rapids_tpu_torch.columnar import encoding
    kinds, nbytes, first = {}, {"by_encoding": {}, "by_column": {}}, {}
    for b in df.to_device_batches():
        for f, c in zip(b.schema, b.columns):
            k = c.mode if encoding.is_plane_compressed(c) else \
                "dict" if encoding.is_encoded(c) else "plain"
            kinds.setdefault(f.name, {})
            kinds[f.name][k] = kinds[f.name].get(k, 0) + 1
            if not encoding.is_plane_compressed(c):
                continue
            raw = c.capacity * (np.dtype(c.dtype.numpy_dtype).itemsize + 1)
            for group, key in (("by_encoding", k), ("by_column", f.name)):
                e = nbytes[group].setdefault(key, {"columns": 0, "raw": 0,
                                                   "wire": 0})
                e["columns"] += 1
                e["raw"] += raw
                e["wire"] += c.size_bytes()
            first.setdefault(k, (f.name, c))
    for group in nbytes.values():
        for e in group.values():
            e["wire_over_raw"] = e["wire"] / e["raw"]
    return kinds, nbytes, first


def check_encoding(kinds, nbytes, column: str, kind: str, lo: float,
                   hi: float, cell: str) -> None:
    """Every batch of ``column`` took ``kind``, and its wire/raw over the
    scan lies in [lo, hi]."""
    check(set(kinds[column]) == {kind},
          f"{cell}: {column} took {kinds[column]}, not {kind} in every batch")
    ratio = nbytes["by_column"][column]["wire_over_raw"]
    check(lo <= ratio <= hi, f"{cell}: {column}'s {kind} wire/raw {ratio}, "
          f"the prediction is in [{lo}, {hi}]")


def decode_times(torch, first: dict, rate: float, smi: str) -> None:
    """The three decodes (torch ops) on a 2^20-row column of each kind,
    warm and with L2 cold, beside the read-once bound: the compressed
    planes the decode reads (a delta also reads the validity) and the
    dense plane it writes, over the card's memory rate."""
    out = {}
    for kind, (col_name, c) in sorted(first.items()):
        reads = {"rle": (c.planes()[0], c.planes()[2]),
                 "delta": c.planes(),
                 "packed": (c.planes()[0],)}[kind]
        nbytes = sum(t.numel() * t.element_size() for t in reads
                     if t is not None)
        dense = c.dense_data()
        nbytes += dense.numel() * dense.element_size()
        check(torch.equal(dense, c.decoded().data),
              f"decode_times: {kind} differs from its late decode")
        out[kind] = {"column": col_name, "rows": c.capacity,
                     "bytes": nbytes, "ms": per_call_ms(torch, c.dense_data),
                     "cold_ms": cold_ms(torch, c.dense_data),
                     "bound_ms": nbytes / rate * 1e3}
    emit("planes", cell="decode_times", decodes=out, mem_rate=rate,
         nvidia_smi=smi)


def _planes_clustered_agg(torch, st, F, native, pag, agg_data, smi: str):
    """hash_agg_sort_2m's table sorted by k: k rides RLE, the update
    decodes it (no late decode), K1 launches once a batch, K1 held
    against its plain version on the update batch, the result against
    numpy; -> (K1's largest f64 sum error, the data, the verifier, the
    first RLE column)."""
    from spark_rapids_tpu_torch.columnar import encoding
    col = st.col
    order = np.argsort(agg_data["k"], kind="stable")
    data = {c: v[order] for c, v in agg_data.items()}
    keys, counts, sums, maxes = group_stats(data["k"], data["v"], data["w"])
    want = {"k": keys, "cnt": counts, "s": sums, "mx": maxes}
    kinds, nbytes, first = scan_encodings(
        st.TorchSession({}).create_dataframe(data))
    # about 524 runs a 2^20-row batch, rcap 1024:
    # (1024 * 12 + 2^20) / (9 * 2^20) = 0.11
    check_encoding(kinds, nbytes, "k", "rle", 0.1, 0.13,
                   "planes_clustered_agg")

    def build(s):
        return agg_query(st, F, s.create_dataframe(data))
    compressed_pair(torch, st, "planes_clustered_agg", build,
                    lambda r: _check_host(r, want, None,
                                          "planes_clustered_agg"),
                    smi=smi, off=PLANES_OFF, phase="planes",
                    encodings=kinds, h2d_by_encoding=nbytes)
    s = st.TorchSession({})
    q = build(s)
    before = encoding.compressed_stats()
    k1 = native.LAUNCHES["dense_slot_reduce"]
    q._host()
    torch.cuda.synchronize()
    launches = native.LAUNCHES["dense_slot_reduce"] - k1
    stats = stats_since(before)
    (agg,) = _plan_nodes(s._last_plan, "TorchHashAggregateExec")
    dense = agg.metrics["pallasAggBatches"]
    batches = -(-len(data["k"]) // (1 << 20))
    check(stats["lateDecodes"] == 0 and stats["fusedDecodes"] >= batches,
          f"planes_clustered_agg: {stats['lateDecodes']} late and "
          f"{stats['fusedDecodes']} fused decodes")
    check(dense == batches and launches == batches,
          f"planes_clustered_agg: K1 took {dense} of {batches} batches, "
          f"{launches} launches")
    emit("planes", cell="planes_clustered_agg_k1", dense_slot_batches=dense,
         kernel_launches=launches, on=stats, nvidia_smi=smi)
    err = _uncounted(native, lambda: phase_kernel_path(
        torch, pag, s, q, "planes_clustered_agg"))

    def verify_torch(out):
        check_tpch(torch, *out, want, None, "planes_clustered_agg")
    return err, build, verify_torch, data, first["rle"]


def _planes_spill(torch, st, build, verify, data, smi: str) -> None:
    """planes_clustered_agg at a quarter of its catalog peak (equal to
    its unpressured run), and a scan batch of its planes through the
    host and disk tiers, back as the same classes, decoded nowhere."""
    from spark_rapids_tpu_torch.columnar import encoding
    from spark_rapids_tpu_torch.memory.spill import SpillableBatch
    tier_runs(torch, st, build, "planes_clustered_agg", verify)
    s = fresh_session(st)
    batch = s.create_dataframe(data).to_device_batches()[0]
    cat = s.runtime.catalog
    sb = SpillableBatch(batch, cat)
    try:
        with cat._lock:
            sb._to_host()
            host = sb.host_nbytes()
            sb._to_disk()
        late = encoding.compressed_stats()["late_decodes"]
        back = sb.get()
        torch.cuda.synchronize()
        check(encoding.compressed_stats()["late_decodes"] == late,
              "planes spill: a promotion decoded a plane column")
        classes = [type(c).__name__ for c in back.columns]
        check(classes == [type(c).__name__ for c in batch.columns]
              and classes[0] == "RleColumn",
              f"planes spill: came back as {classes}")
        check(all(torch.equal(a, b) for x, y in zip(back.columns,
                                                    batch.columns)
                  for a, b in zip(*(encoding.stored_planes(z)[0]
                                    for z in (x, y)))
                  if a is not None),
              "planes spill: a plane differs after the round trip")
    finally:
        sb.close()
    emit("planes", cell="planes_spill_batch", device_bytes=batch.size_bytes(),
         host_bytes=host, classes=classes, nvidia_smi=smi)


def _planes_lineitem_clustered(torch, st, F, tpch, cpu, smi: str):
    """SF1 lineitem in dbgen's order (stably sorted by l_orderkey):
    l_orderkey takes the int8 delta; q18 over it equal to a CPU session;
    a group_by(l_orderkey) sum decoded in the update, against numpy;
    -> (the sorted lineitem, the first delta column)."""
    from spark_rapids_tpu_torch.bench.tpch import TPCH_QUERIES, load_tables
    col = st.col
    li = tpch["lineitem"]
    order = np.argsort(li["l_orderkey"], kind="stable")
    sli = {c: v[order] for c, v in li.items()}
    tables = {**tpch, "lineitem": sli}
    kinds, nbytes, first = scan_encodings(
        st.TorchSession({}).create_dataframe(sli))
    # (2^20 + 8 + 2^20) / (9 * 2^20) = 0.22
    check_encoding(kinds, nbytes, "l_orderkey", "delta", 0.2, 0.25,
                   "planes_lineitem_clustered")
    want18 = _host_cols(TPCH_QUERIES["q18"](load_tables(cpu, tables))._host())
    compressed_pair(torch, st, "planes_lineitem_clustered_q18",
                    lambda s: TPCH_QUERIES["q18"](load_tables(s, tables)),
                    lambda r: _check_host(r, want18, None, "q18"), runs=1,
                    smi=smi, off=PLANES_OFF, phase="planes",
                    encodings=kinds, h2d_by_encoding=nbytes)
    keys, inv = np.unique(sli["l_orderkey"], return_inverse=True)
    want = {"l_orderkey": keys,
            "q": np.bincount(inv, sli["l_quantity"], minlength=len(keys))}
    _, stats = compressed_pair(
        torch, st, "planes_lineitem_orderkey_agg",
        lambda s: s.create_dataframe(sli).group_by(col("l_orderkey")).agg(
            F.sum(col("l_quantity")).alias("q")).order_by(col("l_orderkey")),
        lambda r: _check_host(r, want, None, "planes_lineitem_orderkey_agg"),
        runs=1, smi=smi, off=PLANES_OFF, phase="planes")
    check(stats["lateDecodes"] == 0 and stats["fusedDecodes"] > 0,
          f"planes_lineitem_orderkey_agg: {stats['lateDecodes']} late and "
          f"{stats['fusedDecodes']} fused decodes")
    return first["delta"]


def _planes_flag_filter(torch, st, F, tpch, smi: str):
    """SF1 lineitem with l_late = l_receiptdate > l_commitdate (q4's and
    q21's predicate), bit-packed; a filter on it decoded in the stage's
    own pass (fused), then group_by(l_shipmode) count against numpy;
    -> the first packed column."""
    col = st.col
    li = tpch["lineitem"]
    late = li["l_receiptdate"] > li["l_commitdate"]
    flagged = {**li, "l_late": late}
    kinds, nbytes, first = scan_encodings(
        st.TorchSession({}).create_dataframe(flagged))
    # (2^20 / 8 + 2^20) / (2 * 2^20) = 0.5625
    check_encoding(kinds, nbytes, "l_late", "packed", 0.56, 0.57,
                   "planes_flag_filter")
    modes, counts = np.unique(li["l_shipmode"][late], return_counts=True)
    want = {"l_shipmode": modes, "n": counts}
    _, stats = compressed_pair(
        torch, st, "planes_flag_filter",
        lambda s: s.create_dataframe(flagged).filter(col("l_late"))
        .group_by(col("l_shipmode")).agg(F.count(col("l_quantity"))
                                         .alias("n"))
        .order_by(col("l_shipmode")),
        lambda r: _check_host(r, want, None, "planes_flag_filter"),
        runs=1, smi=smi, off=PLANES_OFF, phase="planes", encodings=kinds,
        h2d_by_encoding=nbytes)
    check(stats["packed_bool_columns"] > 0 and stats["fusedDecodes"] > 0,
          f"planes_flag_filter: {stats}")
    return first["packed"]


def _planes_tpch(torch, st, tpch, cpu, smi: str) -> None:
    """q3 and q5 over SF1: the dimension keys ride delta, o_shippriority
    RLE; on equal to off and to numpy (q3) or a CPU session (q5); the
    joins' late decodes printed, not gated on."""
    from spark_rapids_tpu_torch.bench.tpch import TPCH_QUERIES, load_tables
    s = st.TorchSession({})
    encs = {}
    for table, column, kind in (("orders", "o_orderkey", "delta"),
                                ("orders", "o_shippriority", "rle"),
                                ("customer", "c_custkey", "delta"),
                                ("part", "p_partkey", "delta"),
                                ("supplier", "s_suppkey", "delta")):
        kinds, nbytes, _ = scan_encodings(s.create_dataframe(tpch[table]))
        check(set(kinds[column]) == {kind},
              f"planes_tpch: {column} took {kinds[column]}, not {kind}")
        encs[table] = {"encodings": kinds, "h2d_by_encoding": nbytes}
    emit("planes", cell="planes_tpch_tables", tables=encs, nvidia_smi=smi)
    want3, limit3 = tpch_reference(tpch, "q3")
    want5 = _host_cols(TPCH_QUERIES["q5"](load_tables(cpu, tpch))._host())
    for qname, want, limit in (("q3", want3, limit3), ("q5", want5, None)):
        def verify(result, want=want, limit=limit, qname=qname):
            _check_host(result, want, limit, qname)
        _, stats = compressed_pair(
            torch, st, f"planes_tpch_{qname}",
            lambda s, q=qname: TPCH_QUERIES[q](load_tables(s, tpch)),
            verify, runs=1, smi=smi, off=PLANES_OFF, phase="planes")
        check(stats["delta_columns"] > 0,
              f"planes_tpch_{qname}: no column took the delta encoding")


def phase_planes(torch, st, F, native, pag, tpch, agg_data, errs: dict,
                 smi: str, rate: float) -> None:
    """Phase 25: the plane encodings (RLE, delta-narrowed, bit-packed),
    each cell with the planes on (the default) and with their three keys
    false, in one call; the SF1 cells one warm run each, the 2M-row one
    two."""
    t0 = time.perf_counter()
    cpu = st.TorchSession({"spark.rapids.torch.device": "cpu"})
    err, build, verify, data, rle = _planes_clustered_agg(
        torch, st, F, native, pag, agg_data, smi)
    errs["dense_slot_reduce"] = err
    delta = _planes_lineitem_clustered(torch, st, F, tpch, cpu, smi)
    packed = _planes_flag_filter(torch, st, F, tpch, smi)
    _planes_tpch(torch, st, tpch, cpu, smi)
    _planes_spill(torch, st, build, verify, data, smi)
    decode_times(torch, {"rle": rle, "delta": delta, "packed": packed},
                 rate, smi)
    emit("planes_phase", seconds=time.perf_counter() - t0, nvidia_smi=smi)


# -- phase 26: the transfer path ---------------------------------------------

PREFETCH_ON = {"spark.rapids.sql.io.prefetch.enabled": True}
PREFETCH_OFF = {"spark.rapids.sql.io.prefetch.enabled": False}
PACK_ON = {"spark.rapids.sql.transfer.pack.enabled": True}
PACK_OFF = {"spark.rapids.sql.transfer.pack.enabled": False}
PINNED_POOL_CONF = {**PREFETCH_ON,
                    "spark.rapids.memory.pinnedPool.size": 64 << 20,
                    "spark.rapids.memory.tpu.pooling.enabled": True}
TRANSFER_TPCH = ("q1", "q6", "q3")
TRANSFER_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "_smoke_files", "transfer")


def transfer_module():
    """The driven package's ``columnar/transfer.py``, or None in a
    package from before it (``--package-root`` of an earlier tree, which
    phase 26 times beside this one)."""
    import importlib.util
    if importlib.util.find_spec(
            "spark_rapids_tpu_torch.columnar.transfer") is None:
        return None
    from spark_rapids_tpu_torch.columnar import transfer
    return transfer


def d2h_since(before):
    """``transfer.d2h_stats()`` since ``before`` (None without it)."""
    tr = transfer_module()
    if tr is None:
        return None
    after = tr.d2h_stats()
    return {k: after[k] - (before or {}).get(k, 0) for k in after}


def _d2h_now():
    tr = transfer_module()
    return None if tr is None else tr.d2h_stats()


def prefetch_pair(torch, st, name: str, build, verify, runs: int = 1,
                  smi: str = "", trace: bool = True):
    """``build(session)``'s query with ``spark.rapids.sql.io.prefetch.
    enabled`` on and off, each one warm-up and ``runs`` timed runs
    through the result egress (``_host``), then (``trace``) one run under
    torch.profiler (its ``trace`` line has the idle share): warm scan ms,
    query seconds, the scans' ``h2dOverlapMs``, the pulls; the two
    results bit for bit alike and ``verify``'d -> the on result."""
    t_cell = time.perf_counter()
    res, line = {}, {}
    for mode, conf in (("on", PREFETCH_ON), ("off", PREFETCH_OFF)):
        s = st.TorchSession(conf)
        q = build(s)
        _, first = _timed(torch, q._host)
        secs, scans, overlap = [], [], []
        for _ in range(runs):
            t0 = time.perf_counter()
            res[mode] = q._host()
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            scans.append(scan_ms(s._last_plan))
            overlap.append(int(metric_sum(s._last_plan, "h2dOverlapMs")))
        line[mode] = {"first_seconds": first, "seconds": secs,
                      "scan_ms": scans, "h2dOverlapMs": overlap,
                      "d2hPulls": int(metric_sum(s._last_plan, "d2hPulls")),
                      "prefetchBatches": int(metric_sum(
                          s._last_plan, "prefetchBatches"))}
        if trace:
            phase_trace(torch, q._host, f"{name}_prefetch_{mode}")
    host_same_rows(res["on"], res["off"], f"{name}: prefetch on against off")
    check(res["on"].equals(res["off"]),
          f"{name}: prefetch on and off differ bit for bit")
    verify(res["on"])
    emit("transfer", cell=name, rows=res["on"].num_rows, on=line["on"],
         off=line["off"], cell_seconds=time.perf_counter() - t_cell,
         nvidia_smi=smi)
    return res["on"]


def _transfer_tpch(torch, st, tpch, smi: str) -> dict:
    """SF1 TPC-H q1, q6 and q3 through the local scan, prefetch on and
    off, against numpy -> {query: on result}."""
    from spark_rapids_tpu_torch.bench.tpch import TPCH_QUERIES, load_tables
    out = {}
    for qname in TRANSFER_TPCH:
        want, limit = tpch_reference(tpch, qname)
        out[qname] = prefetch_pair(
            torch, st, f"transfer_tpch_{qname}",
            lambda s, q=qname: TPCH_QUERIES[q](load_tables(s, tpch)),
            lambda r, w=want, lim=limit, q=qname: _check_host(r, w, lim, q),
            smi=smi)
    return out


def _transfer_agg(torch, st, F, native, pag, agg_data, smi: str) -> float:
    """hash_agg_sort_2m over the pipelined upload, prefetch on and off:
    K1 launches, the result against numpy, and K1 against its plain
    version on the query's own update batch (prefetch on) -> its error."""
    keys, counts, sums, maxes = group_stats(agg_data["k"], agg_data["v"],
                                            agg_data["w"])

    def verify(r):
        cols = r.columns
        check(r.num_rows == len(keys), "transfer_hash_agg_sort_2m: groups")
        check(np.array_equal(cols["k"][0], keys)
              and np.array_equal(cols["cnt"][0], counts)
              and np.array_equal(cols["mx"][0], maxes)
              and np.allclose(cols["s"][0], sums, rtol=1e-9, atol=0),
              "transfer_hash_agg_sort_2m differs from numpy")

    before = native.LAUNCHES["dense_slot_reduce"]
    prefetch_pair(torch, st, "transfer_hash_agg_sort_2m",
                  lambda s: agg_query(st, F, s.create_dataframe(agg_data)),
                  verify, smi=smi, trace=False)
    check(native.LAUNCHES["dense_slot_reduce"] > before,
          "transfer_hash_agg_sort_2m: K1 never launched")
    s = st.TorchSession(PREFETCH_ON)
    return phase_kernel_path(torch, pag, s, agg_query(
        st, F, s.create_dataframe(agg_data)), "transfer_hash_agg_sort_2m")


def _transfer_pack_pair(torch, st, main, smi: str) -> None:
    """project_filter_1m's result (about 450,000 rows of two doubles and
    a long) with the pack on and off: bit for bit equal, the pulls of a
    run, wire / raw, and the ``to_numpy`` seconds."""
    col = st.col
    res, line = {}, {}
    for mode, conf in (("on", PACK_ON), ("off", PACK_OFF)):
        s = st.TorchSession(conf)
        q = (s.create_dataframe(main)
             .filter((col("v") > 0.0) & (col("k") < 900))
             .select((col("v") * 2.0 + 1.0).alias("a"),
                     (col("v") + col("w")).alias("b"), col("k")))
        q._host()
        torch.cuda.synchronize()
        secs = []
        before = _d2h_now()
        for _ in range(2):
            t0 = time.perf_counter()
            q.to_numpy()
            secs.append(time.perf_counter() - t0)
        d = d2h_since(before)
        res[mode] = q._host()
        line[mode] = {"to_numpy_seconds": secs,
                      "d2hPulls": int(metric_sum(s._last_plan, "d2hPulls")),
                      "d2h_of_2_runs": d,
                      "wire_over_raw": None if not d or not d["raw_bytes"]
                      else d["wire_bytes"] / d["raw_bytes"]}
    check(res["on"].equals(res["off"]),
          "transfer_project_filter_1m: pack on and off differ")
    k, v, w = main["k"], main["v"], main["w"]
    keep = (v > 0.0) & (k < 900)
    a = res["on"].columns
    check(res["on"].num_rows == int(keep.sum())
          and np.array_equal(a["a"][0], v[keep] * 2.0 + 1.0)
          and np.array_equal(a["b"][0], v[keep] + w[keep].astype(np.float64))
          and np.array_equal(a["k"][0], k[keep]),
          "transfer_project_filter_1m differs from numpy")
    if transfer_module() is not None:
        check(line["on"]["d2hPulls"] == 2,
              f"transfer_project_filter_1m: {line['on']['d2hPulls']} pulls "
              "with the pack on, not 2 (stats, then data)")
    emit("transfer", cell="transfer_project_filter_1m",
         rows=res["on"].num_rows, pack_on=line["on"], pack_off=line["off"],
         nvidia_smi=smi)


def _transfer_csv(torch, st, tpch_dfs, smi: str) -> None:
    """SF1 lineitem written as CSV, read typed with prefetch on and off:
    the read seconds and each traced read's idle share (PR 13's traced
    read: idle 0.627 of 0.711 s), every value against the in-memory
    table."""
    import shutil
    mem = tpch_dfs["lineitem"]
    shutil.rmtree(TRANSFER_DIR, ignore_errors=True)
    path = os.path.join(TRANSFER_DIR, "lineitem")
    _, write_s = _timed(torch, lambda: mem.write.csv(path))
    schema = mem.plan.output_schema()
    want = mem.to_torch()
    line = {}
    try:
        for mode, conf in (("on", PREFETCH_ON), ("off", PREFETCH_OFF)):
            # every read reads the file: the device scan cache off
            s = st.TorchSession({**conf, **SCAN_CACHE_OFF})
            df = s.read.schema(schema).csv(path)
            got, _ = _timed(torch, df.to_torch)
            same_result(torch, got, want, f"transfer_csv_lineitem_sf1 {mode}")
            secs = [_timed(torch, df.to_torch)[1] for _ in range(2)]
            line[mode] = {"read_s": secs,
                          "host_read_s": metric_sum(s._last_plan,
                                                    "csvReadTime") / 1e9,
                          "upload_s": metric_sum(s._last_plan,
                                                 "uploadTime") / 1e9,
                          "h2dOverlapMs": int(metric_sum(s._last_plan,
                                                         "h2dOverlapMs"))}
            phase_trace(torch, df, f"transfer_csv_lineitem_sf1_prefetch_{mode}")
    finally:
        shutil.rmtree(TRANSFER_DIR, ignore_errors=True)
    emit("transfer", cell="transfer_csv_lineitem_sf1", write_s=write_s,
         on=line["on"], off=line["off"], nvidia_smi=smi)


def _transfer_pack_times(torch, st, rate: float, smi: str) -> None:
    """The pack (torch ops) at 2^20 rows of a long key, a double, a date,
    a boolean and a 16-byte string, with the stats plan, and the stats
    pass over the same batch, each warm and with L2 cold, beside its
    read-once bound (the planes read and, for the pack, the wire planes
    written, over the card's memory rate); the whole pull beside a
    ``.cpu()`` of the same planes."""
    tr = transfer_module()
    if tr is None:
        emit("transfer", cell="transfer_pack_2m20", skipped="no "
             "columnar/transfer.py in this package", nvidia_smi=smi)
        return
    from spark_rapids_tpu_torch.columnar.batch import host_batch_to_device, \
        host_columns_from_numpy
    from spark_rapids_tpu_torch.columnar.encoding import col_planes
    n = 1 << 20
    rng = np.random.default_rng(SEED + 26)
    schema, cols = host_columns_from_numpy({
        "k": rng.integers(0, 100_000, n),
        "v": rng.normal(size=n),
        "d": rng.integers(8000, 11000, n).astype("datetime64[D]"),
        "b": rng.random(n) < 0.5,
        "s": np.array([f"{x:016d}" for x in rng.integers(0, 10 ** 15, n)])})
    batch = host_batch_to_device(schema, cols, st.TorchSession({}).device)
    dtypes = [f.dtype for f in schema]
    pend = tr.pack_dispatch([batch], schema, 0)
    flats = [[col_planes(c, False) for c in batch.columns]]
    out_cap = tr.transfer_bucket(n)

    def pack():
        return tr._pack(flats, [n], out_cap, dtypes, pend.plans)

    def stats():
        return tr._stats(flats, [n], dtypes, {})

    planes = pack()
    read = sum(t[:n].numel() * t.element_size() for f in flats[0] for t in f
               if t is not None)
    wrote = sum(t.numel() * t.element_size() for p in planes for t in p
                if t is not None)
    # the stats read the int-like and string columns' data and validity
    stats_read = sum(t.numel() * t.element_size()
                     for f, (d, v, _) in zip(schema, flats[0])
                     if f.name in ("k", "d", "s") for t in (d, v))
    got = tr.pack_finish(pend)
    want = {f.name: v for f, v in zip(schema, (
        c.data[:n].cpu().numpy() for c in batch.columns))}
    for name in ("k", "v", "d", "b"):
        check(np.array_equal(got[name][0], want[name]),
              f"transfer_pack_2m20: {name} differs from .cpu()")
    _, pull_s = _timed(torch, lambda: tr.pack_and_pull([batch], schema, 0))
    _, cpu_s = _timed(torch, lambda: [(c.data.cpu(), c.validity.cpu(),
                                       None if c.chars is None
                                       else c.chars.cpu())
                                      for c in batch.columns])
    emit("transfer", cell="transfer_pack_2m20", rows=n,
         stores={f.name: p.store for f, p in zip(schema, pend.plans)},
         read_bytes=read, wire_bytes=wrote, ms=per_call_ms(torch, pack),
         cold_ms=cold_ms(torch, pack), bound_ms=(read + wrote) / rate * 1e3,
         stats_read_bytes=stats_read, stats_ms=per_call_ms(torch, stats),
         stats_cold_ms=cold_ms(torch, stats),
         stats_bound_ms=stats_read / rate * 1e3,
         pack_and_pull_s=pull_s, plain_cpu_pull_s=cpu_s, mem_rate=rate,
         nvidia_smi=smi)


def _transfer_pinned_pool(torch, st, tpch, want, smi: str) -> None:
    """TPC-H q1 with prefetch on and the three staging limiters capped at
    64 MB (pinnedPool.size, pooling on) on a runtime of its own: the
    result equal to the uncapped run's, the staging waits printed."""
    from spark_rapids_tpu_torch.bench.tpch import TPCH_QUERIES, load_tables
    from spark_rapids_tpu_torch.obs import registry
    from spark_rapids_tpu_torch.runtime import TorchRuntime
    s = fresh_session(st, PINNED_POOL_CONF)
    try:
        q = TPCH_QUERIES["q1"](load_tables(s, tpch))
        secs = []
        for _ in range(3):
            got, t = _timed(torch, q._host)
            secs.append(t)
            check(got.equals(want), "transfer_pinned_pool_64mb: q1 "
                  "differs from the uncapped run")
        cat = s.runtime.catalog
        limiters = {name: getattr(cat, name, None) for name in
                    ("staging", "prefetch_staging", "egress_staging")}
        hists = registry.histogram_snapshots()
        emit("transfer", cell="transfer_pinned_pool_64mb",
             seconds_first_and_warm=secs,
             caps={k: getattr(v, "cap", None) for k, v in limiters.items()},
             waits={k: getattr(v, "wait_count", None)
                    for k, v in limiters.items()},
             wait_us={k: hists.get(f"staging.{k}.wait.us") for k in
                      ("spill", "prefetch", "egress")},
             nvidia_smi=smi)
    finally:
        TorchRuntime.reset()


def phase_transfer(torch, st, F, native, pag, tpch, tpch_dfs, agg_data,
                   main, errs: dict, smi: str, rate: float) -> None:
    """Phase 26: the transfer path (pinned, double-buffered uploads, the
    packed egress, the staging limiters), each cell with its key on and
    off in one call."""
    t0 = time.perf_counter()
    q = _transfer_tpch(torch, st, tpch, smi)
    errs["dense_slot_reduce"] = _transfer_agg(torch, st, F, native, pag,
                                              agg_data, smi)
    _transfer_pack_pair(torch, st, main, smi)
    _transfer_csv(torch, st, tpch_dfs, smi)
    _transfer_pack_times(torch, st, rate, smi)
    _transfer_pinned_pool(torch, st, tpch, q["q1"], smi)
    emit("transfer_phase", seconds=time.perf_counter() - t0, nvidia_smi=smi)


# -- phase 27: the device scan cache ----------------------------------------

SCAN_CACHE_OFF = {"spark.rapids.sql.scan.deviceCacheEnabled": False}
SCAN_CACHE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "_smoke_files", "scan_cache")
SCAN_CACHE_CLIENTS = 4


def scan_cache_pair(torch, st, name: str, build, verify, runs: int = 1,
                    smi: str = "", conf=None, trace: bool = True):
    """``build(session)``'s query over files with the scan cache off and
    on (the default), each one warm-up and ``runs`` timed runs through
    the result egress (``_host``); the cache cleared before each side,
    so the on side's warm-up reads the files and its timed runs hit.  Prints
    each side's warm seconds and ``scanCacheHits``, the cache's entries,
    hits and bytes a tier after the on side, and one traced hit run's
    idle share; the results bit for bit alike and ``verify``'d -> (the
    on result, the on side's session)."""
    t_cell = time.perf_counter()
    res, line, sessions = {}, {}, {}
    # off first: the on side's entry stays for the caller
    for mode, key in (("off", SCAN_CACHE_OFF), ("on", {})):
        s = sessions[mode] = st.TorchSession({**(conf or {}), **key})
        s.runtime.scan_cache.clear()
        q = build(s)
        _, first = _timed(torch, q._host)
        secs, hits = [], []
        for _ in range(runs):
            t0 = time.perf_counter()
            res[mode] = q._host()
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            hits.append(int(metric_sum(s._last_plan, "scanCacheHits")))
        line[mode] = {"first_seconds": first, "seconds": secs,
                      "scanCacheHits": hits,
                      "cache": s.runtime.scan_cache.stats(),
                      "catalog": {k: v for k, v in
                                  s.runtime.catalog.stats().items()
                                  if k in ("spill_to_host_count",
                                           "spill_to_disk_count",
                                           "unspill_count")}}
        if trace and mode == "on":
            line[mode]["hit_idle_share"] = phase_trace(
                torch, q._host, f"{name}_hit")
    check(all(h >= 1 for h in line["on"]["scanCacheHits"]),
          f"{name}: a timed run with the cache on missed: {line['on']}")
    check(not any(line["off"]["scanCacheHits"])
          and line["off"]["cache"]["entries"] == 0,
          f"{name}: the cache served a run with the key off")
    check(res["on"].equals(res["off"]),
          f"{name}: the cache on and off differ bit for bit")
    verify(res["on"])
    emit("scan_cache", cell=name, rows=res["on"].num_rows, on=line["on"],
         off=line["off"], cell_seconds=time.perf_counter() - t_cell,
         nvidia_smi=smi)
    return res["on"], sessions["on"]


def _scan_cache_tpch(torch, st, tpch, path: str, schema, smi: str,
                     conf=None, tag: str = "") -> None:
    """SF1 TPC-H q1 and q6 over lineitem read from its CSV (a dashboard
    refreshing over one landing file), against numpy."""
    from spark_rapids_tpu_torch.bench.tpch import TPCH_QUERIES
    for qname in (("q6",) if tag else ("q1", "q6")):
        want, limit = tpch_reference(tpch, qname)
        scan_cache_pair(
            torch, st, f"scan_cache_tpch_{qname}{tag}",
            lambda s, q=qname: TPCH_QUERIES[q](
                {"lineitem": s.read.schema(schema).csv(path)}),
            lambda r, w=want, lim=limit, q=qname: _check_host(r, w, lim, q),
            smi=smi, conf=conf)


def _scan_cache_agg(torch, st, F, native, pag, agg_data, smi: str) -> float:
    """csv_hash_agg_2m with the cache on and off (K1 on the cached
    batches), against numpy; -> K1's largest f64 sum error against its
    plain version on a batch the cache served."""
    path = os.path.join(SCAN_CACHE_DIR, "agg")
    w = st.TorchSession(SCAN_CACHE_OFF)
    mem = w.create_dataframe(agg_data)
    _, write_s = _timed(torch, lambda: mem.write.csv(path))
    schema = mem.plan.output_schema()
    keys, counts, sums, maxes = group_stats(agg_data["k"], agg_data["v"],
                                            agg_data["w"])

    def verify(r):
        cols = _host_cols(r)
        check(r.num_rows == len(keys)
              and np.array_equal(cols["k"], keys)
              and np.array_equal(cols["cnt"], counts)
              and np.array_equal(cols["mx"], maxes)
              and np.allclose(cols["s"], sums, rtol=1e-9, atol=0),
              "scan_cache_csv_hash_agg_2m differs from numpy")
    before = native.LAUNCHES["dense_slot_reduce"]
    _, s = scan_cache_pair(
        torch, st, "scan_cache_csv_hash_agg_2m",
        lambda s: agg_query(st, F, s.read.schema(schema).csv(path)),
        verify, smi=smi)
    check(native.LAUNCHES["dense_slot_reduce"] > before,
          "scan_cache_csv_hash_agg_2m: the dense-slot kernel never ran")
    hits = s.runtime.scan_cache.stats()["hits"]
    err = _uncounted(native, lambda: phase_kernel_path(
        torch, pag, s, agg_query(st, F, s.read.schema(schema).csv(path)),
        "scan_cache_csv_hash_agg_2m"))
    check(s.runtime.scan_cache.stats()["hits"] == hits + 1,
          "scan_cache_csv_hash_agg_2m: K1 was not held on a cached batch")
    emit("scan_cache_io", cell="scan_cache_csv_hash_agg_2m",
         file_bytes=_tree_bytes(path), write_s=write_s, nvidia_smi=smi)
    return err


def _scan_cache_text(torch, st, F, native, line, smi: str) -> None:
    """csv_text_filter_agg_6m with the cache on and off (K2 on the
    cached ``l_comment`` char matrices), against the in-memory query."""
    path = os.path.join(SCAN_CACHE_DIR, "text")
    w = st.TorchSession(SCAN_CACHE_OFF)
    mem = w.create_dataframe(line[0])
    _, write_s = _timed(torch, lambda: mem.write.csv(path))
    schema = mem.plan.output_schema()
    want = text_agg_query(st, F, mem)._host()
    before = native.LAUNCHES["contains"]
    scan_cache_pair(
        torch, st, "scan_cache_csv_text_filter_agg_6m",
        lambda s: text_agg_query(st, F, s.read.schema(schema).csv(path)),
        lambda r: host_same_rows(r, want, "scan_cache_csv_text_filter_agg_"
                                 "6m against the in-memory query"),
        smi=smi)
    check(native.LAUNCHES["contains"] > before,
          "scan_cache_csv_text_filter_agg_6m: no contains launch")
    emit("scan_cache_io", cell="scan_cache_csv_text_filter_agg_6m",
         file_bytes=_tree_bytes(path), write_s=write_s, nvidia_smi=smi)


def _scan_cache_demoted(torch, st, tpch, path: str, schema,
                        smi: str) -> None:
    """q6 on a runtime of its own whose device budget is a quarter of the
    cached lineitem entry's bytes: the entry is demoted to the host as it
    is stored and promoted batch by batch on each hit."""
    from spark_rapids_tpu_torch.runtime import TorchRuntime
    s = fresh_session(st)
    s.read.schema(schema).csv(path).to_torch()
    entry = s.runtime.scan_cache.stats()["device_bytes"]
    conf = {"spark.rapids.memory.tpu.budgetBytes": max(1, entry // 4),
            "spark.rapids.memory.host.spillStorageSize": 4 * entry}
    try:
        fresh_session(st, conf)
        emit("scan_cache_budget", entry_device_bytes=entry,
             budget_bytes=conf["spark.rapids.memory.tpu.budgetBytes"],
             nvidia_smi=smi)
        _scan_cache_tpch(torch, st, tpch, path, schema, smi, conf=conf,
                         tag="_demoted")
    finally:
        TorchRuntime.reset()


def _scan_cache_server(torch, st, tpch, path: str, schema, smi: str,
                       passes: int = 2) -> None:
    """q6 over the lineitem CSV from SCAN_CACHE_CLIENTS session.server()
    clients at once (the result cache off), the scan cache on (cleared:
    the first pass's clients miss together) and off; every result equal
    to the serial one, bit for bit."""
    import concurrent.futures as cf
    from spark_rapids_tpu_torch.bench.tpch import TPCH_QUERIES
    want, limit = tpch_reference(tpch, "q6")
    serial = TPCH_QUERIES["q6"]({"lineitem": st.TorchSession(
        SCAN_CACHE_OFF).read.schema(schema).csv(path)})._host()
    _check_host(serial, want, limit, "q6")
    line = {}
    for mode, key in (("on", {}), ("off", SCAN_CACHE_OFF)):
        s = st.TorchSession(dict(key))
        s.runtime.scan_cache.clear()
        hits0 = s.runtime.scan_cache.stats()["hits"]
        q = TPCH_QUERIES["q6"]({"lineitem": s.read.schema(schema).csv(path)})
        server = s.server(max_concurrency=SCAN_CACHE_CLIENTS)
        secs = []
        try:
            with cf.ThreadPoolExecutor(SCAN_CACHE_CLIENTS) as pool:
                for _ in range(1 + passes):
                    t0 = time.perf_counter()
                    got = list(pool.map(
                        lambda _i: server.submit(q, tenant="dash",
                                                 use_cache=False)
                        .result(timeout=600),
                        range(SCAN_CACHE_CLIENTS)))
                    secs.append(time.perf_counter() - t0)
                    for r in got:
                        check(r.equals(serial), f"scan_cache_q6_server "
                              f"{mode}: a client's result is not the "
                              "serial one")
        finally:
            server.close()
        stats = s.runtime.scan_cache.stats()
        line[mode] = {"first_pass_seconds": secs[0], "seconds": secs[1:],
                      "hits": stats["hits"] - hits0,
                      "entries": stats["entries"],
                      "device_bytes": stats["device_bytes"],
                      "leaked": s.runtime.catalog.audit_leaks()}
        check(line[mode]["leaked"] == 0,
              f"scan_cache_q6_server {mode}: handles left registered")
    check(line["on"]["entries"] == 1
          and line["on"]["hits"] >= passes * SCAN_CACHE_CLIENTS,
          f"scan_cache_q6_server: {line['on']}")
    check(line["off"]["entries"] == 0 and line["off"]["hits"] == 0,
          f"scan_cache_q6_server: the key off was served: {line['off']}")
    emit("scan_cache", cell="scan_cache_q6_server",
         clients=SCAN_CACHE_CLIENTS, rows=serial.num_rows, on=line["on"],
         off=line["off"], nvidia_smi=smi)


def _scan_cache_rewrite(torch, st, F, tpch_dfs, tpch, path: str, schema,
                        smi: str) -> None:
    """q6 with the cache on, then the CSV overwritten by the port's writer
    with every other order's rows: the next run reads the new contents
    (a miss), the one after hits them; both against the in-memory q6 of
    the new rows, and against a run with the key off."""
    from spark_rapids_tpu_torch.bench.tpch import TPCH_QUERIES
    s = st.TorchSession({})
    off = st.TorchSession(SCAN_CACHE_OFF)
    q = TPCH_QUERIES["q6"]({"lineitem": s.read.schema(schema).csv(path)})
    before = q._host()
    q._host()
    check(int(metric_sum(s._last_plan, "scanCacheHits")) == 1,
          "scan_cache_rewrite: the second run before the rewrite missed")
    half = tpch_dfs["lineitem"].filter(st.col("l_orderkey") % 2 == 0)
    _, write_s = _timed(torch, lambda: half.write.mode("overwrite")
                        .csv(path))
    want = TPCH_QUERIES["q6"]({"lineitem": half})._host()
    after, secs = _timed(torch, q._host)
    miss = int(metric_sum(s._last_plan, "scanCacheHits"))
    again, hit_s = _timed(torch, q._host)
    hit = int(metric_sum(s._last_plan, "scanCacheHits"))
    keyoff = TPCH_QUERIES["q6"]({"lineitem": off.read.schema(schema)
                                 .csv(path)})._host()
    check(miss == 0 and hit == 1,
          f"scan_cache_rewrite: hits {miss}, {hit} after the rewrite")
    host_same_rows(after, want, "scan_cache_rewrite against the new rows")
    check(after.equals(again) and after.equals(keyoff),
          "scan_cache_rewrite: the runs after the rewrite differ")
    check(not after.equals(before),
          "scan_cache_rewrite: the result did not change")
    emit("scan_cache", cell="scan_cache_rewrite", write_s=write_s,
         miss_seconds=secs, hit_seconds=hit_s, nvidia_smi=smi)


def phase_scan_cache(torch, st, F, native, pag, tpch, tpch_dfs, agg_data,
                     line, errs: dict, smi: str) -> None:
    """Phase 27: the device scan cache, each cell with
    ``spark.rapids.sql.scan.deviceCacheEnabled`` on and off in one call:
    SF1 q1 and q6 over lineitem written as CSV, csv_hash_agg_2m (K1, held
    on a cached batch), csv_text_filter_agg_6m (K2), q6 under a budget
    that demotes the entry, q6 from 4 server clients, and a rewrite of
    the CSV read anew.  Its files go to _smoke_files/scan_cache and are
    removed, and the cache is cleared, at its end."""
    import shutil
    from spark_rapids_tpu_torch.runtime import TorchRuntime
    t0 = time.perf_counter()
    shutil.rmtree(SCAN_CACHE_DIR, ignore_errors=True)
    os.makedirs(SCAN_CACHE_DIR)
    try:
        mem = tpch_dfs["lineitem"]
        path = os.path.join(SCAN_CACHE_DIR, "lineitem")
        _, write_s = _timed(torch, lambda: mem.write.csv(path))
        schema = mem.plan.output_schema()
        emit("scan_cache_io", cell="lineitem_sf1", rows=LINEITEM_ROWS,
             file_bytes=_tree_bytes(path), write_s=write_s, nvidia_smi=smi)
        _scan_cache_tpch(torch, st, tpch, path, schema, smi)
        errs["dense_slot_reduce"] = _scan_cache_agg(
            torch, st, F, native, pag, agg_data, smi)
        _scan_cache_text(torch, st, F, native, line, smi)
        _scan_cache_demoted(torch, st, tpch, path, schema, smi)
        _scan_cache_server(torch, st, tpch, path, schema, smi)
        _scan_cache_rewrite(torch, st, F, tpch_dfs, tpch, path, schema, smi)
    finally:
        shutil.rmtree(SCAN_CACHE_DIR, ignore_errors=True)
        # the entries name the removed files: give their bytes back
        TorchRuntime.invalidate_paths(SCAN_CACHE_DIR)
    emit("scan_cache_phase", seconds=time.perf_counter() - t0,
         nvidia_smi=smi)


# -- phase 28: placement, fusion and the compile store ------------------------

PLACEMENT_MODES = ("tpu", "cpu", "cost")
# the JAX placement tests' remote link, with a fast upload, a card rate
# prior and a host rate prior that keep the static pass on the card,
# so only the measured bytes of the stage decide (the JAX test's
# _aqe_conf)
AQE_PLACEMENT_CONF = {
    "spark.rapids.sql.adaptive.enabled": "true",
    "spark.rapids.sql.placement.mode": "cost",
    "spark.rapids.sql.placement.pullLatencyMs": "94",
    "spark.rapids.sql.placement.h2dMBps": "100000",
    "spark.rapids.sql.placement.d2hMBps": "100000",
    "spark.rapids.sql.placement.cpuRowsPerSec": "1000",
}
FUSION_SETTINGS = {"on": {}, "off": {"spark.rapids.sql.fusion.enabled":
                                     "false"},
                   "max_ops_2": {"spark.rapids.sql.fusion.maxOps": "2"}}


class conf_of:
    """``session``'s conf with ``extra`` laid over, inside the block."""

    def __init__(self, session, extra):
        self.session, self.extra = session, extra

    def __enter__(self):
        self.old = self.session.conf
        self.session.conf = self.old.with_settings(self.extra)
        return self.session

    def __exit__(self, *exc):
        self.session.conf = self.old


def _placement_cell(torch, st, native, session, name: str, build,
                    smi: str) -> None:
    """``build(session)``'s query under each placement mode after one
    warm-up on the card, each result its tpu one's (floats within
    1e-9); a plan placed on the host launches no kernel and pulls
    nothing."""
    from spark_rapids_tpu_torch.columnar import transfer
    base, lines = None, {}
    build(session)._host()  # warm-up on the card (the default mode)
    for mode in PLACEMENT_MODES:
        with conf_of(session, {"spark.rapids.sql.placement.mode": mode}):
            before = dict(native.LAUNCHES)
            pulls = transfer.d2h_stats()["pulls"]
            t0 = time.perf_counter()
            out = build(session)._host()
            secs = time.perf_counter() - t0
            plan, qc = session._last_plan, session._last_query
        launches = {k: native.LAUNCHES[k] - before[k] for k in before}
        pulled = transfer.d2h_stats()["pulls"] - pulls
        if base is None:
            base = out
        else:
            host_same_rows(out, base, f"placement {name} {mode}")
        d = plan.placement[0] if plan.placement else None
        if plan.on_host:
            check(not any(launches.values()) and pulled == 0,
                  f"placement {name} {mode}: a plan on the host launched "
                  f"{launches} and pulled {pulled} times")
        lines[mode] = {
            "on_host": plan.on_host, "seconds": secs,
            "measured_ms": qc.wall_ms, "launches": launches,
            "d2h_pulls": pulled,
            "decision": None if d is None else {
                k: d.get(k) for k in ("engine", "tpu_ms", "cpu_ms",
                                      "deciding", "rows", "bytes_in",
                                      "bytes_out", "terms")}}
    check(lines["cpu"]["on_host"] and not lines["tpu"]["on_host"],
          f"placement {name}: mode cpu did not run on the host")
    emit("placement", cell=name, rows=base.num_rows, modes=lines,
         nvidia_smi=smi)


def _placement_aqe(torch, st, native, smi: str) -> None:
    """One adaptive demotion over an in-memory table: the static pass
    keeps the plan on the card, the stage's measured bytes (a selective
    filter) move the remainder to the host."""
    from spark_rapids_tpu_torch.plan.adaptive import find_adaptive
    rng = np.random.default_rng(SEED + 30)
    data = {"k": rng.integers(0, 100, 4000), "v": rng.normal(size=4000)}
    col = st.col

    def q(s):
        return (s.create_dataframe(data).filter(col("k") < 1)
                .repartition(4, "k").select((col("v") * 2.0).alias("a"),
                                            col("k")))
    want = q(st.TorchSession(dict(AQE_ON)))._host()
    s = st.TorchSession(dict(AQE_PLACEMENT_CONF))
    got = q(s)._host()
    host_same_rows(got, want, "placement_aqe")
    plan = s._last_plan
    reports = find_adaptive(plan).reports
    demoted = [r["placement"] for r in reports
               if r.get("decision") == "placement_demoted"]
    names = [type(n).__name__ for n in _plan_nodes(plan, "HostToDeviceExec")
             + _plan_nodes(plan, "DeviceToHostExec")]
    check(len(demoted) == 1 and len(names) == 2,
          f"placement_aqe: no adaptive demotion ({reports})")
    emit("placement_aqe", rows=got.num_rows, static=[
        d["engine"] for d in plan.placement], demotion={
        k: demoted[0].get(k) for k in ("engine", "tpu_ms", "cpu_ms",
                                       "deciding", "rows", "bytes_in")},
        transitions=names, d2h_pulls=sum(
            n.metrics["d2hPulls"] for n in _plan_nodes(
                plan, "DeviceToHostExec")), nvidia_smi=smi)


def _fusion_cells(torch, st, session, builds: dict, smi: str) -> None:
    """Each query with fusion on, off and at maxOps 2: every result bit
    for bit the same; the fused stages' dispatches a scanned batch."""
    for name, build in builds.items():
        base, lines = None, {}
        for label, extra in FUSION_SETTINGS.items():
            with conf_of(session, extra):
                out = build(session)._host()
                plan = session._last_plan
            if base is None:
                base = out
            check(out.equals(base), f"fusion {name} {label}: the result "
                  "differs from fusion on")
            scans = [n for n in _walk_plan(plan) if not n.children]
            batches = sum(n.metrics["numOutputBatches"] for n in scans)
            steps = [(type(n).__name__, len(getattr(n, "steps", ())))
                     for n in _walk_plan(plan) if hasattr(n, "steps")]
            dispatches = sum(n.metrics["stageDispatches"]
                             for n in _walk_plan(plan))
            lines[label] = {"operators": steps, "scan_batches": batches,
                            "stage_dispatches_per_batch":
                                dispatches / max(1, batches)}
        emit("fusion", cell=name, rows=base.num_rows, settings=lines,
             nvidia_smi=smi)


def _walk_plan(plan):
    out = [plan]
    for c in plan.children:
        out.extend(_walk_plan(c))
    return out


# one fresh process over the compile store: install it from the conf,
# let the warm pool build or load every kernel and launch it once, and
# print the compile section, the launches and the seconds that took
STORE_PROCESS = """
import json, sys, time
sys.path.insert(0, sys.argv[1])
import torch
from spark_rapids_tpu_torch import compile as srt_compile, native
from spark_rapids_tpu_torch.compile import service, warm
from spark_rapids_tpu_torch.conf import TorchConf
torch.cuda.init()
t0 = time.perf_counter()
srt_compile.configure_from_conf(TorchConf({
    "spark.rapids.sql.compile.store.enabled": "true",
    "spark.rapids.sql.compile.cacheDir": sys.argv[2]}),
    torch.device("cuda", 0))
idle = warm.wait_idle(600)
print(json.dumps({"warm_s": time.perf_counter() - t0, "idle": idle,
                  "compile": service.snapshot(),
                  "launches": dict(native.LAUNCHES)}))
"""


def _store_process(root: str) -> dict:
    """``STORE_PROCESS`` over ``COMPILE_DIR`` -> its line and its wall
    from spawn to exit."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", STORE_PROCESS, root,
                           COMPILE_DIR], capture_output=True, text=True,
                          timeout=600)
    wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"compile store: a process failed "
          f"({proc.returncode}): {proc.stderr[-2000:]}")
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    out["process_s"] = wall
    return out


def _compile_store(st, native, smi: str) -> None:
    """The store across two plain processes: the first over an empty
    directory builds each kernel with nvcc, the second over the same
    directory builds none and loads each; both warm every kernel.  The
    directory stays for phase 22's replicas."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(st.__file__)))
    kernels = len(native.KERNELS)
    shutil.rmtree(COMPILE_DIR, ignore_errors=True)
    os.makedirs(COMPILE_DIR)
    first = _store_process(root)
    second = _store_process(root)
    c1, c2 = first["compile"], second["compile"]
    check(c1["compileStoreMisses"] == kernels and c1["nvccBuilds"] == kernels,
          f"compile store: the first process did not build each kernel: "
          f"{first}")
    check(c2["nvccBuilds"] == 0 and c2["compileStoreHits"] == kernels,
          f"compile store: the second process built: {second}")
    check(all(p["idle"] and p["compile"]["warmPoolCompiles"] == kernels
              and all(v == 1 for v in p["launches"].values())
              for p in (first, second)),
          "compile store: the warm pool did not launch each kernel once")
    emit("compile_store", first=first, second=second, nvidia_smi=smi)


def phase_placement(torch, st, F, native, session, main, agg_data, dim,
                    tpch_dfs, smi: str) -> None:
    """Phase 28: the probed link constants; each placement mode on
    project_filter_1m, hash_agg_sort_2m, hash_join_1m, SF1 q1 and q6 and
    a tiny string scan; one adaptive demotion; fusion on, off and at
    maxOps 2; the compile store."""
    from spark_rapids_tpu_torch.bench.tpch import TPCH_QUERIES
    from spark_rapids_tpu_torch.plan import cost
    t0 = time.perf_counter()
    dev = torch.device("cuda", torch.cuda.current_device())
    emit("placement_link", probe=cost.probe_link(dev), nvidia_smi=smi)
    col = st.col
    main_df = session.create_dataframe(main)
    agg_df = session.create_dataframe(agg_data)
    dim_df = session.create_dataframe(dim)
    rng = np.random.default_rng(SEED + 31)
    tiny = session.create_dataframe({
        "k": rng.integers(0, 50, 1000),
        "s": np.array([f"name_{i % 13}" for i in range(1000)]),
        "v": rng.normal(size=1000)})

    def rebind(df, s):
        # the same logical plan, run under the session's current conf
        return type(df)(s, df.plan)

    def pf(s):
        return (rebind(main_df, s).filter((col("v") > 0.0)
                                          & (col("k") < 900))
                .select((col("v") * 2.0 + 1.0).alias("a"),
                        (col("v") + col("w")).alias("b"), col("k")))

    def q6(s):
        return rebind(TPCH_QUERIES["q6"](tpch_dfs), s)

    cells = {
        "project_filter_1m": pf,
        "hash_agg_sort_2m": lambda s: agg_query(st, F, rebind(agg_df, s)),
        "hash_join_1m": lambda s: hash_join_query(
            st, F, rebind(main_df, s), rebind(dim_df, s)),
        "tpch_q1": lambda s: rebind(TPCH_QUERIES["q1"](tpch_dfs), s),
        "tpch_q6": q6,
        "tiny_string_scan": lambda s: rebind(tiny, s).filter(
            col("k") < 25).select(col("s"), (col("v") + 1.0).alias("a")),
    }
    for name, build in cells.items():
        _placement_cell(torch, st, native, session, name, build, smi)
    _placement_aqe(torch, st, native, smi)
    _fusion_cells(torch, st, session, {"project_filter_1m": pf,
                                       "tpch_q6": q6}, smi)
    _compile_store(st, native, smi)
    emit("placement_phase", seconds=time.perf_counter() - t0,
         nvidia_smi=smi)


# -- phase 29: the host shuffle --------------------------------------------------

SHUFFLE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "_smoke_shuffle")
SHUFFLE_FILES = 8
# every wait of the exchange bounded well inside the script's limit
SHUFFLE_CONF = {"spark.rapids.shuffle.stage.timeout": 300}


def _write_parts(session, data: dict, path: str,
                 parts: int = SHUFFLE_FILES) -> list:
    """``data`` (numpy columns) as ``parts`` CSV files under ``path``,
    each a slice of the rows written by the port's writer."""
    n = len(next(iter(data.values())))
    for i in range(parts):
        lo, hi = i * n // parts, (i + 1) * n // parts
        session.create_dataframe({k: v[lo:hi] for k, v in data.items()}) \
            .write.mode("append").csv(path)
    files = _csv_files(path)
    check(len(files) == parts, f"{path}: {len(files)} files")
    return files


def _descendants() -> List[int]:
    """The pids of this process's children and their children, from
    ``/proc/<pid>/stat``."""
    kids = {}
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as f:
                stat = f.read()
            ppid = int(stat.rsplit(")", 1)[1].split()[1])
        except (OSError, ValueError, IndexError):
            continue
        kids.setdefault(ppid, []).append(int(d))
    out, todo = [], [os.getpid()]
    while todo:
        for k in kids.get(todo.pop(), []):
            out.append(k)
            todo.append(k)
    return out


def _card_files_of(pid: int) -> List[str]:
    """The card's device files process ``pid`` maps; a CUDA context maps
    ``/dev/nvidia-uvm`` (``card_apps_control`` shows it)."""
    try:
        with open(f"/proc/{pid}/maps") as f:
            return sorted({ln.split()[-1] for ln in f
                           if "/dev/nvidia" in ln})
    except OSError:
        return []


class _CardApps:
    """Watches this process's descendants while a run lasts: every 0.25
    s it reads each one's ``/proc/<pid>/maps``; ``contexts`` maps each
    descendant seen with ``/dev/nvidia-uvm`` mapped (a CUDA context) to
    its files, ``seen`` counts the descendants seen.  This is the
    parent's own view of the map workers, beside what they report.  It
    also reads the card's used memory less this process's allocator
    reservation (``torch.cuda.mem_get_info``): ``extra_mib``, the
    peak's rise over the first poll, and ``drop_mib``, the fall from the
    peak once the run has ended (``settle``).  Those are recorded, not
    checked: they cannot say which process holds the memory.
    ``nvidia-smi --query-compute-apps`` cannot either on the card's
    machine: it gives every process pid 1 and once listed one row while
    two processes held contexts."""

    def __init__(self, torch):
        self._torch = torch
        self.polls = 0
        self.seen = set()
        self.contexts = {}
        self.first_mib = None
        self.peak_mib = None
        self.after_mib = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._poll, daemon=True,
                                        name="smoke-card-apps")

    def _read_mib(self) -> float:
        # the larger reservation of the two reads: an allocation between
        # them must not look like another process
        r0 = self._torch.cuda.memory_reserved()
        free, total = self._torch.cuda.mem_get_info()
        r1 = self._torch.cuda.memory_reserved()
        return (total - free - max(r0, r1)) / 2 ** 20

    def others_mib(self) -> float:
        # the lower of two readings: a segment this process has just
        # allocated and not yet counted shows in one at most
        return min(self._read_mib(), self._read_mib())

    @property
    def extra_mib(self) -> float:
        return self.peak_mib - self.first_mib

    @property
    def drop_mib(self) -> float:
        return self.peak_mib - self.after_mib

    def _poll(self):
        while not self._stop.is_set():
            for pid in _descendants():
                self.seen.add(pid)
                files = _card_files_of(pid)
                if "/dev/nvidia-uvm" in files:
                    self.contexts[pid] = files
            others = self.others_mib()
            if self.first_mib is None:
                self.first_mib = self.peak_mib = others
            self.peak_mib = max(self.peak_mib, others)
            self.polls += 1
            self._stop.wait(0.25)

    def settle(self, seconds: float = 0.5) -> None:
        """The lowest memory reading over ``seconds`` once the run has
        ended."""
        end = time.perf_counter() + seconds
        low = self.others_mib()
        while time.perf_counter() < end:
            time.sleep(0.25)
            low = min(low, self.others_mib())
        self.after_mib = low

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=60)


def card_apps_control(torch, smi: str, work) -> None:
    """The negative control of the workers' card checks: a child process
    that opens a CUDA context must report ``/dev/nvidia-uvm`` among the
    card files it maps, as a map worker reports them
    (``shuffle/stage.py: card_files``), and ``_CardApps`` must see it
    from here.  ``work()`` runs meanwhile (the child takes seconds to
    reach the card)."""
    ready = os.path.join(SHUFFLE_DIR, "control_ready")
    torch.cuda.synchronize()
    child = subprocess.Popen(
        [sys.executable, "-c",
         "import sys, time, torch\n"
         "x = torch.ones(1 << 20, device='cuda')\n"
         "torch.cuda.synchronize()\n"
         "files = sorted({ln.split()[-1] for ln in open('/proc/self/maps')"
         " if '/dev/nvidia' in ln})\n"
         "open(sys.argv[1] + '.tmp', 'w').write('\\n'.join(files))\n"
         "import os; os.replace(sys.argv[1] + '.tmp', sys.argv[1])\n"
         "time.sleep(600)\n", ready])
    try:
        with _CardApps(torch) as apps:
            work()
            deadline = time.perf_counter() + 90
            while time.perf_counter() < deadline \
                    and not os.path.exists(ready) and child.poll() is None:
                time.sleep(0.25)
            seen = os.path.exists(ready)
            # a few polls with the child's context open
            polls = apps.polls
            while time.perf_counter() < deadline and apps.polls < polls + 4:
                time.sleep(0.25)
    finally:
        child.kill()
        child.wait(timeout=60)
    apps.settle()
    check(seen, "the card-apps control's child never opened its context")
    with open(ready) as f:
        child_files = f.read().split()
    check("/dev/nvidia-uvm" in child_files, "the card-apps control's child "
          f"holds a context but maps {child_files}: a map worker's report "
          "could not show one either")
    check(child.pid in apps.contexts, "the watcher did not see the "
          f"control's child's context ({apps.contexts}): it could not see "
          "a map worker's either")
    emit("card_apps_control", child_card_files=child_files,
         watched_contexts=len(apps.contexts), polls=apps.polls,
         drop_mib=apps.drop_mib, extra_mib=apps.extra_mib,
         first_mib=apps.first_mib, nvidia_smi=smi)


def _exchanges(plan) -> list:
    return _plan_nodes(plan, "TorchHostShuffleExchangeExec")


def _shuffle_run(torch, st, native, session, name: str, build, workers: int,
                 want, key, smi: str, faults_conf=None) -> dict:
    """``build(session)`` with ``workers`` map worker processes (under
    ``faults_conf`` when given): its result against ``want`` (the same
    query in process; integers exact, floats within 1e-9 relative, the
    order-of-sums class of ``exec/pallas_agg.py``), every exchange's
    map, fetch and upload seconds, blocks, bytes, transport, codec and
    checksum, the workers' CUDA state, mapped card files and threads,
    the card files the processes this one started mapped during the
    run, the card's memory outside this process, and K1's launches on
    the reduce side."""
    conf = {**SHUFFLE_CONF, "spark.rapids.shuffle.workers.count": workers,
            **(faults_conf or {})}
    k1 = native.LAUNCHES["dense_slot_reduce"]
    with conf_of(session, conf) as s, _CardApps(torch) as apps:
        got, secs = _timed(torch, build(s).to_torch)
    # the exchange has joined its workers by the time to_torch returns
    apps.settle()
    k1 = native.LAUNCHES["dense_slot_reduce"] - k1
    plan = session._last_plan
    if key is not None:
        got = sorted_by(torch, got, key)
    same_result(torch, got, want, f"shuffle {name} w={workers}",
                float_rtol=1e-9)
    exs = _exchanges(plan)
    check(exs, f"shuffle {name}: no host exchange in the plan")
    out = {"map_s": 0.0, "fetch_s": 0.0, "upload_s": 0.0, "blocks": 0,
           "wire_bytes": 0, "raw_bytes": 0, "rows_written": 0,
           "map_recomputes": 0, "partitions_recomputed": 0}
    worker_pids, cuda, card_files, threads, native_t, codec, checksum = \
        [], [], [], set(), set(), set(), set()
    for ex in exs:
        m = ex.metrics
        out["map_s"] += m["shuffleMapTime"].value / 1e9
        out["fetch_s"] += m["shuffleFetchTime"].value / 1e9
        out["upload_s"] += m["uploadTime"].value / 1e9
        out["blocks"] += int(m["shuffleBlocksFetched"])
        out["wire_bytes"] += int(m["shuffleWireBytes"])
        out["raw_bytes"] += int(m["shuffleRawBytes"])
        out["rows_written"] += int(m["shuffleRowsWritten"])
        out["map_recomputes"] += int(m["shuffleMapRecomputes"])
        out["partitions_recomputed"] += int(
            m["shufflePartitionsRecomputed"])
        run = ex.last_run
        native_t.add(run["native"])
        codec.add(run["codec"])
        checksum.add(run["checksum"])
        threads.add(run["worker_threads"])
        for info in run["workers"].values():
            worker_pids.append(info["pid"])
            cuda.append(info["cuda_initialized"])
            card_files.append(info["card_files"])
    aggs = _plan_nodes(plan, "TorchHashAggregateExec")
    agg_s = sum((a.metrics["totalTime"].value
                 - a.children[0].metrics["totalTime"].value) / 1e9
                for a in aggs)
    out.update(
        query=name, workers=workers, seconds=secs, aggregate_s=agg_s,
        wire_raw=out["wire_bytes"] / max(1, out["raw_bytes"]),
        codec=sorted(codec), checksum=sorted(map(str, checksum)),
        native_transport=native_t == {True},
        worker_threads=sorted(threads),
        worker_cuda_initialized=cuda, worker_pids=worker_pids,
        worker_card_files=card_files, watched_processes=len(apps.seen),
        watched_contexts=apps.contexts, watch_polls=apps.polls,
        card_drop_mib=apps.drop_mib, card_extra_mib=apps.extra_mib,
        parent_pid=os.getpid(), reduce_k1_launches=k1,
        faults=faults_conf or {}, nvidia_smi=smi)
    emit("shuffle", **out)
    check(native_t == {True}, f"shuffle {name}: the transport was not "
          f"the native one ({native_t})")
    check(not any(cuda) and not any("/dev/nvidia-uvm" in f
                                    for f in card_files),
          f"shuffle {name}: a worker made a CUDA context ({card_files})")
    check(len(apps.seen) >= len(worker_pids) and not apps.contexts,
          f"shuffle {name}: processes this one started held a CUDA "
          f"context during the run ({apps.contexts}; {len(apps.seen)} "
          f"watched); only this process may hold the card")
    return out


def phase_shuffle(torch, st, F, native, agg_data, main, dim, tpch,
                  smi: str) -> None:
    """Phase 29: the host shuffle.  hash_agg_sort_2m's table, hash_join_1m's
    fact and dim and SF1 lineitem, each written as 8 CSV files; the
    group-by and the join (broadcast off, so both sides shuffle) with 2
    and 4 map worker processes and SF1 q1 with 4, each against the same
    query in process on the same session; K1 must launch on the reduce
    side of the two aggregates.  Then the group-by with 2 workers and
    ``worker.kill`` firing in worker 1: the map stage reruns in process
    and the result stays."""
    from spark_rapids_tpu_torch.bench.tpch import TPCH_QUERIES
    from spark_rapids_tpu_torch.runtime import TorchRuntime
    from spark_rapids_tpu_torch.shuffle import manager as shuffle_manager
    from spark_rapids_tpu_torch.shuffle import stage as shuffle_stage
    t_phase = time.perf_counter()
    shutil.rmtree(SHUFFLE_DIR, ignore_errors=True)
    os.makedirs(SHUFFLE_DIR)
    session = st.TorchSession({**SCAN_CACHE_OFF,
                               "spark.sql.autoBroadcastJoinThreshold": -1})
    shuffle_manager.reset_global_stats()
    try:
        t0 = time.perf_counter()
        paths = {name: os.path.join(SHUFFLE_DIR, name)
                 for name in ("agg", "fact", "dim", "lineitem")}

        def write_tables():
            for name, data in (("agg", agg_data), ("fact", main),
                               ("dim", dim), ("lineitem", tpch["lineitem"])):
                _write_parts(session, data, paths[name])
        card_apps_control(torch, smi, write_tables)
        schemas = {name: session.create_dataframe(
            {k: v[:1] for k, v in data.items()}).plan.output_schema()
            for name, data in (("agg", agg_data), ("fact", main),
                               ("dim", dim),
                               ("lineitem", tpch["lineitem"]))}
        emit("shuffle_data", seconds=time.perf_counter() - t0,
             files=SHUFFLE_FILES,
             bytes={n: _tree_bytes(p) for n, p in paths.items()},
             worker_threads={w: shuffle_stage.worker_threads(w)
                             for w in (2, 4)},
             cores=os.cpu_count())

        def read(s, name):
            return s.read.schema(schemas[name]).csv(paths[name])

        cells = [
            ("hash_agg_sort_2m",
             lambda s: agg_query(st, F, read(s, "agg")), None, (2, 4)),
            ("hash_join_1m",
             lambda s: hash_join_query(st, F, read(s, "fact"),
                                       read(s, "dim")), "grp", (2, 4)),
            ("tpch_q1_sf1",
             lambda s: TPCH_QUERIES["q1"]({"lineitem": read(s, "lineitem")}),
             None, (4,)),
        ]
        for name, build, key, counts in cells:
            want, secs = _timed(torch, build(session).to_torch)
            if key is not None:
                want = sorted_by(torch, want, key)
            emit("shuffle_in_process", query=name, seconds=secs,
                 rows=want[2])
            for w in counts:
                out = _shuffle_run(torch, st, native, session, name, build,
                                   w, want, key, smi)
                if name != "tpch_q1_sf1":
                    check(out["reduce_k1_launches"] > 0,
                          f"shuffle {name} w={w}: K1 never launched on the "
                          "reduce side")
            if name == "hash_agg_sort_2m":
                out = _shuffle_run(
                    torch, st, native, session, name, build, 2, want, key,
                    smi, {"spark.rapids.faults.worker.kill": "count:1@w1"})
                check(out["map_recomputes"] == 1,
                      f"shuffle fault run: {out['map_recomputes']} map "
                      "recomputes")
    finally:
        shutil.rmtree(SHUFFLE_DIR, ignore_errors=True)
        TorchRuntime.invalidate_paths(SHUFFLE_DIR)
    emit("shuffle_phase", seconds=time.perf_counter() - t_phase,
         stats=shuffle_manager.global_stats(), nvidia_smi=smi)


# -- phase 30: the mesh exchange ---------------------------------------------

MESH_SHARDS = 4
MESH_STATIC = {"spark.rapids.sql.mesh.devices": MESH_SHARDS}
MESH_ICI = {"spark.rapids.shuffle.mode": "ici"}
NO_BROADCAST = {"spark.sql.autoBroadcastJoinThreshold": -1}


def mesh_shard_inputs(pag, session, query):
    """K1's inputs on the first shard of ``query``'s mesh aggregate: its
    drained input cut by ``shard_table`` as the aggregate cuts it, then
    the update's own plane construction (the live rows) -> ((gid,
    planes, ops, K), the shard's rows, its capacity)."""
    from spark_rapids_tpu_torch.columnar.encoding import plane_view
    from spark_rapids_tpu_torch.exec.aggregate import TorchHashAggregateExec
    from spark_rapids_tpu_torch.exec.base import ExecContext
    from spark_rapids_tpu_torch.exec.meshexec import _drain, _mesh
    from spark_rapids_tpu_torch.parallel.mesh import shard_table
    from spark_rapids_tpu_torch.plan.planner import plan_query
    (node,) = _plan_nodes(plan_query(query.plan, session.conf),
                          "TorchMeshAggregateExec")
    ctx = ExecContext(session.conf, session.device)
    shards, _, _ = shard_table(_drain(node.children[0], ctx),
                               node.n_devices, _mesh(node, ctx).devices)
    shard = shards[0]
    spec = TorchHashAggregateExec(node.groupings, node.aggregates, None).spec
    cols = plane_view(shard.columns)
    rng = pag.key_range(spec.groupings[0], cols, shard.num_rows,
                        shard.capacity)
    check(rng is not None and pag.fits(*rng),
          "the mesh shard's keys do not fit the dense-slot path")
    K = pag.slot_count(*rng)
    gid, planes, ops, _ = pag.update_planes(spec, cols, shard.num_rows,
                                            shard.capacity, rng[0], K)
    return (gid, planes, ops, K), shard.num_rows, shard.capacity


def padded_inputs(torch, pag, inputs, capacity: int):
    """``inputs`` padded to ``capacity`` rows as ``update_planes`` once
    padded them: gid 0 (the null slot), the occupancy and add planes 0,
    the min/max planes at their op's neutral."""
    gid, planes, ops, K = inputs
    extra = capacity - gid.numel()

    def pad(t, value):
        return torch.cat([t, torch.full((extra,), value, dtype=t.dtype,
                                        device=t.device)])
    return (pad(gid, 0), [pad(p, 0 if op == "add" else
                              pag.neutral(op, p.dtype))
                          for p, op in zip(planes, ops)], ops, K)


def _mesh_run(torch, native, session, build, key=None, warm=True):
    """A warm-up (with ``warm``) and one timed run of ``build(session)``
    -> (result, seconds, K1 launches of the timed run, plan, ici stats
    of the timed run)."""
    from spark_rapids_tpu_torch.exec import meshexec
    if warm:
        build(session).to_torch()
    meshexec.reset_ici_stats()
    before = native.LAUNCHES["dense_slot_reduce"]
    out, secs = _timed(torch, build(session).to_torch)
    launches = native.LAUNCHES["dense_slot_reduce"] - before
    if key is not None:
        out = sorted_by(torch, out, key)
    return out, secs, launches, session._last_plan, meshexec.ici_stats()


def _mesh_cell(torch, st, native, name: str, build, conf: dict, want,
               single_s: float, smi: str, key=None, expect=(), warm=True):
    """``build`` under ``conf`` against the single-device result ``want``
    (integers bit for bit, float sums within rtol 1e-9), its plan
    holding every operator of ``expect`` -> (plan, ici stats, K1
    launches)."""
    session = st.TorchSession(conf)
    out, secs, launches, plan, ici = _mesh_run(torch, native, session, build,
                                               key, warm)
    tree = plan.tree_string()
    for op in expect:
        check(op in tree, f"{name}: no {op} in the plan:\n{tree}")
    bitwise = same_result(torch, out, want, name, float_rtol=1e-9)
    emit(name, conf=conf, shards=MESH_SHARDS,
         rows=out[2], seconds=secs, single_device_seconds=single_s,
         k1_launches=launches, ici=ici, float_bitwise=bitwise,
         plan=tree.splitlines(), nvidia_smi=smi)
    return plan, ici, launches


def phase_mesh(torch, st, F, native, pag, agg_data, main, dim, tpch,
               smi: str, errs: dict) -> None:
    """Phase 30 inside a pool of 4 shards on the one card
    (``parallel/mesh.py: virtual_pool``), put back after it."""
    from spark_rapids_tpu_torch.parallel.mesh import virtual_pool
    with virtual_pool(MESH_SHARDS):
        _phase_mesh(torch, st, F, native, pag, agg_data, main, dim, tpch,
                    smi, errs)


def _phase_mesh(torch, st, F, native, pag, agg_data, main, dim, tpch,
                smi: str, errs: dict) -> None:
    """Phase 30: the mesh exchange over 4 shards on the one card, each
    cell against
    the single-device run of the same query in the same call:
    hash_agg_sort_2m and hash_join_1m at ``mesh.devices=4`` (the
    plans' mesh operators checked, K1 launched on every shard and held
    against its plain version on shard 0's update batch), SF1 TPC-H q1
    and q3 at ``mesh.devices=4``, the ``ici`` mode over hash_join_1m
    (broadcast off) and hash_agg_sort_2m clean, with the collective's
    first call faulted and with ``maxStageBytes`` at 1 MiB, and the dry
    run on the card."""
    from spark_rapids_tpu_torch import faults
    from spark_rapids_tpu_torch.bench.tpch import TPCH_QUERIES, load_tables
    from spark_rapids_tpu_torch.parallel.dryrun import dryrun_multichip
    t_phase = time.perf_counter()
    single = st.TorchSession({})

    def agg(s):
        return agg_query(st, F, s.create_dataframe(agg_data))

    def join(s):
        return hash_join_query(st, F, s.create_dataframe(main),
                               s.create_dataframe(dim))

    def tpch_q(q):
        return lambda s: TPCH_QUERIES[q](load_tables(s, tpch))

    def k1():
        return native.LAUNCHES["dense_slot_reduce"]

    k1_refs = k1()
    wants = {}
    for name, build, key, conf in (
            ("hash_agg_sort_2m", agg, None, {}),
            ("hash_join_1m", join, "grp", {}),
            ("hash_join_1m_no_broadcast", join, "grp", NO_BROADCAST),
            ("tpch_q1", tpch_q("q1"), None, {}),
            ("tpch_q3", tpch_q("q3"), None, {})):
        s = single if not conf else st.TorchSession(conf)
        out, secs, _, _, _ = _mesh_run(torch, native, s, build, key)
        wants[name] = (out, secs)
    k1_refs = k1() - k1_refs
    k1_mesh = k1()
    # K1 launches of the mesh cells' timed runs
    k1_timed = 0

    plan, _, launches = _mesh_cell(
        torch, st, native, "mesh_hash_agg_sort_2m", agg, MESH_STATIC,
        *wants["hash_agg_sort_2m"], smi,
        expect=("TorchMeshAggregate", "TorchMeshSort"))
    (magg,) = _plan_nodes(plan, "TorchMeshAggregateExec")
    check(launches == magg.metrics["pallasAggBatches"] == MESH_SHARDS,
          f"mesh_hash_agg_sort_2m: {launches} K1 launches, "
          f"{magg.metrics['pallasAggBatches']} dense shard batches")
    k1_timed += launches
    inputs, rows, capacity = mesh_shard_inputs(
        pag, st.TorchSession(MESH_STATIC), agg(st.TorchSession(MESH_STATIC)))
    # the live rows the update passes, then the same padded to the
    # shard's capacity with every padding row on slot 0
    errs["dense_slot_reduce"] = _uncounted(native, lambda: max(
        hold_k1(torch, pag, inputs, "mesh_hash_agg_sort_2m", shard=0,
                shard_rows=rows),
        hold_k1(torch, pag, padded_inputs(torch, pag, inputs, capacity),
                "mesh_hash_agg_sort_2m", shard=0, shard_rows=rows,
                padded_to=capacity)))

    plan, _, launches = _mesh_cell(
        torch, st, native, "mesh_hash_join_1m", join, MESH_STATIC,
        *wants["hash_join_1m"], smi, key="grp",
        expect=("TorchMeshAggregate", "TorchMeshHashJoin"))
    (mjoin,) = _plan_nodes(plan, "TorchMeshHashJoinExec")
    check(type(mjoin.children[1]).__name__ == "TorchBroadcastExchangeExec",
          "mesh_hash_join_1m: the mesh join does not drain the broadcast "
          "exchange as its right side")
    check(launches > 0, "mesh_hash_join_1m: K1 never launched on a shard")
    k1_timed += launches
    for q in ("q1", "q3"):
        k1_timed += _mesh_cell(torch, st, native, f"mesh_tpch_{q}",
                               tpch_q(q), MESH_STATIC, *wants[f"tpch_{q}"],
                               smi, expect=("TorchMesh",))[2]

    # the over-budget cell: every fragment whose input is over 1 MiB
    # degrades (the join and the aggregate over 1M rows; the aggregate
    # over 2M rows, but not the sort of its 1,000 groups)
    for name, build, key, extra, sorts, over in (
            ("hash_join_1m", join, "grp", NO_BROADCAST, 0, (2, 0)),
            ("hash_agg_sort_2m", agg, None, {}, 1, (1, 1))):
        want = wants["hash_join_1m_no_broadcast" if extra else name]
        conf = {**MESH_ICI, **extra}
        _, ici, launches = _mesh_cell(
            torch, st, native, f"mesh_ici_{name}", build, conf, *want, smi,
            key=key, expect=("TorchMesh",))
        k1_timed += launches
        # a hash exchange pulls nothing; a range exchange pulls its
        # bounds sample once
        check(ici["exchange_pulls"] == sorts and ici["fallbacks"] == 0,
              f"mesh_ici_{name}: {ici}")
        check(ici["exchanges"] >= (3 if key else 2),
              f"mesh_ici_{name}: {ici['exchanges']} exchanges")
        # the collective site's first call faulted: that fragment
        # degrades, the others run on the mesh (one run, warm already)
        faults.reset()
        try:
            _, ici, launches = _mesh_cell(
                torch, st, native, f"mesh_ici_{name}_fault", build,
                {**conf, "spark.rapids.faults.shuffle.ici.collective":
                 "first:1"}, *want, smi, key=key, warm=False)
        finally:
            faults.reset()
        k1_timed += launches
        check(ici["fallbacks"] == ici["fallbacks_injected"] == 1
              and ici["exchanges"] >= 1, f"mesh_ici_{name}_fault: {ici}")
        _, ici, launches = _mesh_cell(
            torch, st, native, f"mesh_ici_{name}_over_budget", build,
            {**conf, "spark.rapids.shuffle.ici.maxStageBytes": 1 << 20},
            *want, smi, key=key, warm=False)
        k1_timed += launches
        check(ici["fallbacks"] == ici["fallbacks_over_budget"] == over[0]
              and ici["exchanges"] == over[1],
              f"mesh_ici_{name}_over_budget: {ici}")

    k1_mesh = k1() - k1_mesh
    t0 = time.perf_counter()
    k1_dry = k1()
    got = dryrun_multichip(MESH_SHARDS, "cuda")
    torch.cuda.synchronize()
    k1_dry = k1() - k1_dry
    emit("mesh_dryrun", seconds=time.perf_counter() - t0, shards=MESH_SHARDS,
         results=got, k1_launches=k1_dry, nvidia_smi=smi)
    # the phase's K1 launches: the mesh cells (warm-ups included; their
    # timed runs apart), the single-device references, the dry run
    emit("mesh_phase", seconds=time.perf_counter() - t_phase,
         k1_launches={"mesh_cells": k1_mesh, "mesh_timed_runs": k1_timed,
                      "single_device_references": k1_refs,
                      "dryrun": k1_dry}, nvidia_smi=smi)


def mesh_only(torch, st, F, native, pag, main_data, agg_data, dim_data,
              name: str, smi: str) -> int:
    """``--mesh-only``: phase 30 and its data alone."""
    from spark_rapids_tpu_torch.bench.tpch import gen_tpch_numpy
    tpch = gen_tpch_numpy(LINEITEM_ROWS)
    native.reset_launches()
    errs = {}
    phase_mesh(torch, st, F, native, pag, agg_data, main_data, dim_data,
               tpch, smi, errs)
    emit("launches", path="mesh", counts=dict(native.LAUNCHES),
         dense_slot_reduce_max_abs_err=errs["dense_slot_reduce"])
    check(native.LAUNCHES["dense_slot_reduce"] > 0, "mesh: K1 never launched")
    print(json.dumps({"ok": True, "mesh_only": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def shuffle_only(torch, st, F, native, main_data, agg_data, dim_data,
                 name: str, smi: str) -> int:
    """``--shuffle-only``: phase 29 and its data alone."""
    from spark_rapids_tpu_torch.bench.tpch import gen_tpch_numpy
    native.reset_launches()
    phase_shuffle(torch, st, F, native, agg_data, main_data, dim_data,
                  gen_tpch_numpy(LINEITEM_ROWS), smi)
    emit("launches", path="shuffle", counts=dict(native.LAUNCHES))
    check(native.LAUNCHES["dense_slot_reduce"] > 0,
          "shuffle: K1 never launched")
    print(json.dumps({"ok": True, "shuffle_only": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def placement_only(torch, st, F, native, main_data, agg_data, dim_data,
                   name: str, smi: str) -> int:
    """``--placement-only``: phase 28 and its data alone."""
    from spark_rapids_tpu_torch.bench.tpch import gen_tpch_numpy, load_tables
    tpch = gen_tpch_numpy(LINEITEM_ROWS)
    session = st.TorchSession.builder().get_or_create()
    native.reset_launches()
    try:
        phase_placement(torch, st, F, native, session, main_data, agg_data,
                        dim_data, load_tables(session, tpch), smi)
    finally:
        shutil.rmtree(COMPILE_DIR, ignore_errors=True)
    emit("launches", path="placement", counts=dict(native.LAUNCHES))
    print(json.dumps({"ok": True, "placement_only": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def scan_cache_only(torch, st, F, native, pag, agg_data, line, name: str,
                    smi: str) -> int:
    """``--scan-cache-only``: phase 27 and its data alone."""
    from spark_rapids_tpu_torch.bench.tpch import gen_tpch_numpy, load_tables
    tpch = gen_tpch_numpy(LINEITEM_ROWS)
    session = st.TorchSession.builder().get_or_create()
    native.reset_launches()
    errs = {}
    phase_scan_cache(torch, st, F, native, pag, tpch,
                     load_tables(session, tpch), agg_data, line, errs, smi)
    emit("launches", path="scan_cache", counts=dict(native.LAUNCHES),
         dense_slot_reduce_max_abs_err=errs["dense_slot_reduce"])
    check(all(v > 0 for v in native.LAUNCHES.values()),
          f"scan_cache: a kernel never launched: {dict(native.LAUNCHES)}")
    print(json.dumps({"ok": True, "scan_cache_only": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def transfer_only(torch, st, F, native, pag, main_data, agg_data, name: str,
                  smi: str, rate: float) -> int:
    """``--transfer-only``: phase 26 and its data alone."""
    from spark_rapids_tpu_torch.bench.tpch import gen_tpch_numpy, load_tables
    tpch = gen_tpch_numpy(LINEITEM_ROWS)
    session = st.TorchSession.builder().get_or_create()
    native.reset_launches()
    phase_transfer(torch, st, F, native, pag, tpch,
                   load_tables(session, tpch), agg_data, main_data, {}, smi,
                   rate)
    emit("launches", path="transfer", counts=dict(native.LAUNCHES))
    print(json.dumps({"ok": True, "transfer_only": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def planes_only(torch, st, F, native, pag, agg_data, name: str, smi: str,
                rate: float) -> int:
    """``--planes-only``: phase 25 and its data alone."""
    from spark_rapids_tpu_torch.bench.tpch import gen_tpch_numpy
    tpch = gen_tpch_numpy(LINEITEM_ROWS)
    native.reset_launches()
    phase_planes(torch, st, F, native, pag, tpch, agg_data, {}, smi, rate)
    emit("launches", path="planes", counts=dict(native.LAUNCHES))
    print(json.dumps({"ok": True, "planes_only": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def compressed_only(torch, st, F, native, pag, ps, main_data, dim_data,
                    line, name: str, smi: str) -> int:
    """``--compressed-only``: phase 24 and its data alone."""
    from spark_rapids_tpu_torch.bench.tpch import gen_tpch_numpy
    from spark_rapids_tpu_torch.bench.tpcxbb import gen_tpcxbb_numpy
    tpch = gen_tpch_numpy(LINEITEM_ROWS)
    native.reset_launches()
    phase_compressed(torch, st, F, native, pag, ps, tpch, main_data,
                     dim_data, line, gen_tpcxbb_numpy(TPCXBB_SALES_ROWS),
                     operator_tables(tpch), {}, smi)
    emit("launches", path="compressed", counts=dict(native.LAUNCHES))
    print(json.dumps({"ok": True, "compressed_only": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


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
    ap.add_argument("--files-only", action="store_true",
                    help="build the kernels, run phase 23 (file I/O and "
                         "a standing query over CSV) with its launch "
                         "counts, and stop")
    ap.add_argument("--compressed-only", action="store_true",
                    help="build the kernels, run phase 24 (dictionary-"
                         "encoded columns, each cell on and off) with its "
                         "launch counts, and stop")
    ap.add_argument("--planes-only", action="store_true",
                    help="build the kernels, run phase 25 (RLE, delta and "
                         "bit-packed columns, each cell on and off) with "
                         "its launch counts, and stop")
    ap.add_argument("--transfer-only", action="store_true",
                    help="build the kernels, run phase 26 (pinned, "
                         "double-buffered uploads and the packed egress, "
                         "each cell with its key on and off) with its "
                         "launch counts, and stop")
    ap.add_argument("--scan-cache-only", action="store_true",
                    help="build the kernels, run phase 27 (the device "
                         "scan cache, each cell with its key on and off) "
                         "with its launch counts, and stop")
    ap.add_argument("--placement-only", action="store_true",
                    help="build the kernels, run phase 28 (placement "
                         "modes, an adaptive demotion, fusion settings "
                         "and the compile store) with its launch counts, "
                         "and stop")
    ap.add_argument("--shuffle-only", action="store_true",
                    help="build the kernels, run phase 29 (the host "
                         "shuffle: map worker processes on the host, the "
                         "reduce on the card) with its launch counts, and "
                         "stop")
    ap.add_argument("--mesh-only", action="store_true",
                    help="build the kernels, run phase 30 (the mesh "
                         "exchange over 4 shards on the one card, static "
                         "and ici, against the single-device runs) with "
                         "its launch counts, and stop")
    ap.add_argument("--cpu-references", metavar="DIR",
                    help=argparse.SUPPRESS)
    ap.add_argument("--string-paths", action="store_true",
                    help="time LIKE/RLIKE's two matchers and replace's "
                         "two paths on the breadth queries' columns and "
                         "the queries with each, and stop")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    start = time.perf_counter()
    args = parse_args(sys.argv[1:] if argv is None else argv)
    if args.cpu_references:
        sys.path.insert(0, os.path.abspath(args.package_root))
        return cpu_references_main(args.cpu_references)
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
    if args.planes_only:
        return planes_only(torch, st, F, native, pag, agg_data, name, smi,
                           rate)
    if args.transfer_only:
        return transfer_only(torch, st, F, native, pag, main_data, agg_data,
                             name, smi, rate)
    if args.placement_only:
        return placement_only(torch, st, F, native, main_data, agg_data,
                              dim_data, name, smi)
    if args.shuffle_only:
        return shuffle_only(torch, st, F, native, main_data, agg_data,
                            dim_data, name, smi)
    if args.mesh_only:
        return mesh_only(torch, st, F, native, pag, main_data, agg_data,
                         dim_data, name, smi)
    t0 = time.perf_counter()
    line = gen_lineitem(LINEITEM_ROWS, SEED + 2)
    session = st.TorchSession.builder().get_or_create()
    line_df = session.create_dataframe(line[0])
    emit("lineitem", rows=LINEITEM_ROWS, seconds=time.perf_counter() - t0)
    if args.files_only:
        from spark_rapids_tpu_torch.bench.tpch import gen_tpch_numpy, \
            load_tables
        native.reset_launches()
        phase_files(torch, st, F, native, session, load_tables(
            session, gen_tpch_numpy(LINEITEM_ROWS)), agg_data, line, smi,
            {})
        emit("launches", path="files", counts=dict(native.LAUNCHES))
        print(json.dumps({"ok": True, "files_only": True, "device": {
            "platform": "gpu", "kind": name,
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    if args.compressed_only:
        return compressed_only(torch, st, F, native, pag, ps, main_data,
                               dim_data, line, name, smi)
    if args.scan_cache_only:
        return scan_cache_only(torch, st, F, native, pag, agg_data, line,
                               name, smi)
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

    # the CPU session's references run in a process of their own from
    # here on; the phases that check against them defer their checks to
    # refs.finish()
    refs = CpuReferences(os.path.abspath(args.package_root))
    import atexit
    atexit.register(refs.close)
    # each path of the main path runs with the launch counts set to 0
    # just before it and read just after; the kernels line adds them up
    launches = {k: 0 for k in native.KERNELS}

    def drive(path: str, fn, *fn_args) -> None:
        refs.note_phase(path)
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
    # one timed run a query in the whole script (phase 30 took the room
    # of the second; the checks are unchanged)
    for qname in BENCH_QUERIES:
        drive(f"tpch_{qname}", phase_tpch, torch, st, native, session, tpch,
              tpch_dfs, qname, 1)
    drive("window_1m", phase_window, torch, st, F, session, main_data)
    for qname in TPCH_QUERIES:
        if qname not in BENCH_QUERIES:
            drive(f"tpch_{qname}", phase_tpch, torch, st, native, session,
                  tpch, tpch_dfs, qname, 1, refs)
    from spark_rapids_tpu_torch.bench.mortgage import gen_mortgage_numpy
    from spark_rapids_tpu_torch.bench.tpcxbb import LEAD_QUERIES, \
        TPCXBB_QUERIES, gen_tpcxbb_numpy, register_views
    t0 = time.perf_counter()
    mortgage = gen_mortgage_numpy(MORTGAGE_PERF_ROWS)
    xbb = gen_tpcxbb_numpy(TPCXBB_SALES_ROWS)
    register_views(session, xbb)
    emit("sql_data", mortgage_perf_rows=MORTGAGE_PERF_ROWS,
         tpcxbb_sales_rows=TPCXBB_SALES_ROWS,
         rows={t: len(next(iter(c.values()))) for t, c in xbb.items()},
         seconds=time.perf_counter() - t0)
    drive("mortgage_etl", phase_mortgage, torch, session, refs, mortgage, 1)
    # the bench's lead queries first, as bench.py:_tpcxbb_suites runs them
    for qname in list(LEAD_QUERIES) + [q for q in TPCXBB_QUERIES
                                       if q not in LEAD_QUERIES]:
        drive(f"tpcxbb_{qname}", phase_tpcxbb, torch, session, refs, qname,
              TPCXBB_SALES_ROWS, 1)
    gpu_b, = breadth_sessions(st, tpch, line[0], ("cuda",))
    emit("breadth_conf", conf=BREADTH_CONF)
    drive("breadth", phase_breadth, torch, st, gpu_b, refs, 1)
    drive("memory", phase_memory, torch, st, F, session, main_data,
          agg_data, dim_data, gen_big(), tpch)
    drive("range_aggs", phase_range_aggs, torch, st, F, session)
    t0 = time.perf_counter()
    ops = operator_tables(tpch)
    ops_gpu = load_tables(session, ops)
    emit("operator_data", seconds=time.perf_counter() - t0,
         lineitem_columns=sorted(ops["lineitem"]),
         orders_columns=sorted(ops["orders"]))
    for qname, (_, table) in OPERATOR_QUERIES.items():
        drive(qname, phase_operator, torch, st, F, session, ops_gpu,
              refs, qname, len(next(iter(ops[table].values()))))
    drive("serve", phase_serve, torch, st, F, native, tpch, tpch_dfs, xbb,
          mortgage, agg_data, line_df, smi)
    drive("adaptive", phase_adaptive, torch, st, F, native, main_data,
          dim_data, tpch, smi)
    drive("observe", phase_observe, torch, st, F, native, agg_data,
          line[0], main_data, dim_data, tpch, smi)
    file_errs = {}
    drive("files", phase_files, torch, st, F, native, session, tpch_dfs,
          agg_data, line, smi, file_errs)
    dsr["max_abs_err"] = max(dsr["max_abs_err"],
                             file_errs["dense_slot_reduce"])
    comp_errs = {}
    drive("compressed", phase_compressed, torch, st, F, native, pag, ps,
          tpch, main_data, dim_data, line, xbb, ops, comp_errs, smi)
    dsr["max_abs_err"] = max(dsr["max_abs_err"],
                             comp_errs["dense_slot_reduce"])
    plane_errs = {}
    drive("planes", phase_planes, torch, st, F, native, pag, tpch, agg_data,
          plane_errs, smi, rate)
    dsr["max_abs_err"] = max(dsr["max_abs_err"],
                             plane_errs["dense_slot_reduce"])
    transfer_errs = {}
    drive("transfer", phase_transfer, torch, st, F, native, pag, tpch,
          tpch_dfs, agg_data, main_data, transfer_errs, smi, rate)
    dsr["max_abs_err"] = max(dsr["max_abs_err"],
                             transfer_errs["dense_slot_reduce"])
    cache_errs = {}
    drive("scan_cache", phase_scan_cache, torch, st, F, native, pag, tpch,
          tpch_dfs, agg_data, line, cache_errs, smi)
    dsr["max_abs_err"] = max(dsr["max_abs_err"],
                             cache_errs["dense_slot_reduce"])
    drive("placement", phase_placement, torch, st, F, native, session,
          main_data, agg_data, dim_data, tpch_dfs, smi)
    mesh_errs = {}
    drive("mesh", phase_mesh, torch, st, F, native, pag, agg_data,
          main_data, dim_data, tpch, smi, mesh_errs)
    dsr["max_abs_err"] = max(dsr["max_abs_err"],
                             mesh_errs["dense_slot_reduce"])
    # every deferred check, before the shuffle's map workers want the
    # host's cores
    refs.finish()
    drive("shuffle", phase_shuffle, torch, st, F, native, agg_data,
          main_data, dim_data, tpch, smi)
    # the replicas count their own launches; they join the kernels line
    replica_launches = {}
    drive("fleet", phase_fleet, torch, st, native, tpch, agg_data, smi,
          replica_launches)
    emit("launches", path="fleet_replicas", counts=replica_launches)
    for k, v in replica_launches.items():
        launches[k] += v
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
    aqe_session = st.TorchSession(dict(AQE_ON))
    phase_trace(torch, hash_join_query(
        st, F, aqe_session.create_dataframe(main_data),
        aqe_session.create_dataframe(dim_data)), "hash_join_1m_aqe",
        expect="plan.aqe")
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
