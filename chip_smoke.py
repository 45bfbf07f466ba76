#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``blaze_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--scale 1.0] [--ds-scale 1.0]

Needs one CUDA card and ``nvcc`` (``/usr/local/cuda``).  From its
start, five worker processes (spawned, the card hidden from them) build
the same host tables from the same seeds and compute the host
references the checks below hold the card to: the numpy oracles of
TPC-H and TPC-DS at their scales and of the file phase, and the port's
CPU evaluations of the functions phase; two more write the map/zstd
phase's zstd files.  The main process waits for one
only where it is not done yet; the workers stop before the script
exits.  In order, it:

1. prints the card's name and power limit (``nvidia-smi``);
2. builds the hand-written kernels from ``blaze_tpu_torch/csrc`` and,
   beside them, the PR 3 ``pid_histogram`` design that the shipped one
   is timed against, and prints the build time and ptxas report;
3. runs each kernel at the main path's shapes on the card, holds it to
   its plain PyTorch version on the same inputs (exactly where the
   outputs are integers; ``fused_group_sums`` within rtol 2e-5, and to
   float64 sums), and times the kernel, the plain version and the
   library call that computes the same function with CUDA events, cold
   L2 (``pid_histogram`` also the PR 3 design); then holds every other
   code path of each kernel to its plain version, untimed (misaligned
   views, ragged ends, edge tables; for ``pid_histogram`` also each
   path's bin counts about its ends, 1,000 back-to-back calls and two
   streams at once);
4. checks the decimal -> double conversion on the card against numpy
   (decimal(12,2) 0.38 - double 1.5 = -1.12, and a seeded vector at
   four scales, exactly);
5. runs TPC-H q06, q01, q03, q04, q05, q10, q12, q14 and q19 at
   ``--scale`` and TPC-DS q03 and q07 at ``--ds-scale``, then the rest
   of TPC-H (q02, q07, q08, q09, q11, q13, q15-q18, q20-q22) at
   ``--scale`` on the same tables with dbgen's p_name, c_phone,
   o_custkey and l_suppkey (``datagen.with_spec_columns``), with 8
   partitions and 2^20-row batches, each scan pruned to the query's
   columns, each plan through the task optimizer
   (``ops.fusion.optimize_plan``, as ``run_task`` runs every decoded
   task) with the conf defaults (fusion on, the async shuffle write
   on, 4 map tasks at a time in an exchange), checks each against its numpy oracle (a nonempty result
   for the rest of TPC-H), and reads every kernel's launch count over
   each query (reset just before it, before its plan is built: q11,
   q15 and q22 run a scalar subquery then, whose seconds it prints
   and whose time is in the wall): the rest of TPC-H must launch all
   three engine kernels; q01
   must launch ``pid_histogram`` (and not ``murmur3_pids``: its keys
   are strings), q03, q04, q05, q10 and q12 ``murmur3_pids``,
   ``pid_histogram`` and ``sorted_lookup`` (q03 with the retired
   ``BLAZE_TPU_PALLAS_ENABLE=0`` set), q14 and q19 ``sorted_lookup``
   only (their one exchange has one partition), TPC-DS q03 and q07
   ``pid_histogram`` and ``sorted_lookup`` (string group keys take the
   plain murmur3); it prints each query's wall and launches beside the
   card's name and power limit; then times ``pid_histogram`` on the
   largest inputs q01 and q03 gave it, and ``murmur3_pids`` and
   ``sorted_lookup`` on q03's;
6. runs every query again, the same scans, through the plan
   contract: ``split_stages`` cuts each plan at its exchanges,
   ``run_stages`` serializes every task to TaskDefinition bytes and runs
   it through ``run_task``, hash exchanges go through ``.data``/``.index``
   files and broadcasts through checksummed blobs; each must equal its
   oracle and the in-process result, and launch each kernel as often as
   in process (launch counts reset just before each query); prints its
   stages and tasks, TaskDefinition bytes, ``.data`` bytes, blocks read,
   checksum-verified frames, the file path's host/device copies and its
   wall beside the in-process wall; one more untimed run of q06, q01, q03 and
   q05 through ``run_stages`` counts its syncs with the card (CUDA sync
   debug mode), q03's and q05's under cProfile; then runs the join
   code no TPC-H query runs (shuffled FULL, RIGHT_SEMI, RIGHT_ANTI and
   EXISTENCE joins, a broadcast RIGHT join over one probe partition, a
   FULL join with no build rows) on 2^18 probe rows, each equal to a
   Python oracle and launching the kernels its plan calls, and requires
   a FULL broadcast join over 8 probe partitions to raise;
   the A/B phase runs q01, q03, q05 and q21 on both paths unfused
   (``spark.blaze.fusion.enabled`` and ``spark.blaze.shuffle.asyncWrite``
   false, 1 map task at a time), under the defaults with 4 tasks at a
   time (``spark.blaze.stage.taskConcurrency`` 4 on ``run_stages``) and
   under the defaults one task at a time,
   once each in turns (A, B, C), each run equal to its oracle, and
   prints each one's walls, syncs with the card, ``.data`` bytes and
   launches (equal on both paths under one setting);
7. runs TPC-DS's window queries (q12, q20, q98, q53, q63, q89, q47,
   q57, q36, q86, q70, q67, q44, q49 and q51: ``WindowExec``,
   ``ExpandExec``, ``UnionExec`` and the fusion's partition buffer) at
   ``--ds-scale``, 8 partitions and 2^20-row batches, scans pruned to
   each query's columns, in process through the optimizer and through
   ``split_stages``/``run_stages``, each equal to its numpy oracle on a
   nonempty result on both paths and launching each kernel as often on
   both (``pid_histogram`` and ``sorted_lookup`` everywhere,
   ``murmur3_pids`` where an exchange's keys are all fixed-width), and
   prints per query and path the wall, the tasks, the ``.data`` bytes,
   the launches and the card's peak memory; then TPC-DS's rollup and
   union queries (q27, q18, q22, q5, q77, q80, q14a, q33, q56, q60,
   q71, q76, q66, q2, q75, q54, q23a and q23b: ``ExpandExec`` rollups
   with typed null literals, ``UnionExec`` over channels of sales and
   returns, LEFT_SEMI joins on aggregated build sides, decimal scalar
   subqueries, q22's 23.49M inventory rows) the same way, and q23a and
   q23b again at SF 0.002 (from SF 0.01 on they select nothing: ROADMAP
   queue C, reference defect 14); then q10, q35, q69, q38, q87, q17,
   q25, q29, q39a, q39b and q84 (two EXISTENCE joins renamed by
   ``RenameColumnsExec``, INTERSECT and EXCEPT as LEFT_SEMI/LEFT_ANTI on
   three columns, ``stddev_samp`` over ``inventory`` twice, ``concat``)
   the same way, q17's, q39a's and q39b's doubles within 1e-9 relative
   between the paths, and q87 again at SF 0.01 (from SF 0.1 on it
   selects nothing: the generator's customers carry 8 distinct names);
   of these three groups, the queries of ``SCHEDULED_CUT`` run in
   process only (q20, q98, q63, q89, q57, q86, q70, q56, q60, q77, q80,
   q25, q29, q35, q69 and q39b repeat the template of a query that keeps
   its ``run_stages`` path; q23a, q23b
   and q87 select nothing at SF1 and take both paths at their smaller
   scales): that cut and the reference workers keep the smoke within
   its time;
   then the single-fact reports (q42, q52, q55, q19, q43, q96, q26, q6,
   q41, q13, q48, q15, q45, q8, q91, q34, q73, q46, q68, q79, q9, q28,
   q88, q90, q61, q62, q99, q21, q32, q92 and q65: broadcast joins into
   one fact table, CASE pivots, and scalar subqueries (q45: an IN
   subquery) run in process while the plan is built, their seconds
   printed), in process only (their ``run_stages`` path, whose star
   joins the TPC-H queries through ``run_stages`` have, was cut to make
   room for the faults phase), with each oracle's host seconds; then the 26
   multi-fact, shuffled and self joins (q1, q30, q81, q94, q95, q16,
   q74, q11, q4, q37, q82, q40, q50, q93, q24a, q24b, q14b, q58, q31,
   q59, q83, q85, q78, q97, q64 and q72: shuffled joins on composite
   and string keys, a FULL shuffled join, LEFT_SEMI/LEFT_ANTI joins on
   aggregates, q72's shuffle of all of ``inventory``), each record with
   its oracle's row count; only q93, q78, q97 (the FULL shuffled join)
   and q72 (all of ``inventory`` through zlib files) also run through
   ``run_stages`` (the rest of that path was cut with the reports' for
   the faults phase; ``--uncut`` restores both, to time the cut);
8. the file phase: writes, with the port's own writers, into a
   temporary directory, one file a partition (8) and row groups of the
   2^20-row batches, so the scans yield the memory scans' batches:
   every TPC-H table at SF 0.1 as gzip parquet (the four tables
   ``with_spec_columns`` changes again), and runs all 22 queries from
   them on both paths (``ParquetScanExec`` over each whole table, the
   optimizer narrowing it at its source), each equal to its oracle on a
   nonempty result, the paths' rows alike; q01, q03 and q06 must equal
   their memory-scan runs at that scale, row for row and launch for
   launch on each path; q03's result goes through
   ``ParquetSinkExec`` (by ``o_shippriority``) and back through a scan;
   then q01, q03 and q06 from zlib ORC at SF 0.1, q01 and q06 from
   snappy parquet at SF 0.01, and q06 and q03 at SF1 from lineitem's
   numeric and date columns and the whole of orders and customer, with
   ``spark.blaze.pipeline.depth`` 2 and 0; each run prints its wall,
   the scans' decode seconds, bytes read, pruned row groups, peak
   device memory above what the run held, and launches;
9. the functions and object aggs phase, each run on both paths (in
   process through the optimizer, and through ``run_stages``), 8
   partitions and 2^20-row batches, launches equal on both: TPC-H q03
   at ``--scale`` with the runtime bloom filter Spark 3.5's
   InjectRuntimeFilter plants (``tpch.queries.q3_runtime_filter``: the
   creation side's ``bloom_filter_agg(xxhash64(o_orderkey))`` with
   1,000,000 expected items, 0.9 MB, run while the plan is built and
   put in as a BINARY literal; ``might_contain`` on the lineitem scan),
   equal to q03's oracle, with no false negative over the creation
   side's keys and the device probe equal to the host's on every
   lineitem row, its launches beside q03's without the filter;
   ``approx_count_distinct`` and ``approx_percentile`` (HLL and
   t-digest states on the host, OPAQUE columns through the exchange) by
   ``l_suppkey`` over lineitem and globally over part at SF 0.1 (cut
   from SF1: the states update row by row in python, as in the
   reference), equal to the same plans on the CPU, every HLL within 5%
   of the exact distinct count and the global median within 2% of
   numpy's; ``first``/``first_ignores_null`` by ``l_orderkey`` at SF 0.1
   against an exact oracle; and one projection per function family
   (date, math, device string, hash, decimal, casts over lineitem at SF
   0.1; host string functions over customer and part at SF 0.1, cut
   from SF1: python per row, as in the reference; JSON paths over
   ``concat`` of customer's columns at SF 0.1), every column equal to
   the port's CPU evaluation of the same plan (floats within 2 ulps),
   the JSON round trip returning ``c_name``, ``c_custkey`` and
   ``c_acctbal`` exactly; one JSON record a run;
10. the nested phase, each run on both paths with its walls, ``.data``
   bytes, peak device memory above what the run held and launches,
   equal on both paths: (1) order baskets at ``--scale``:
   ``collect_list(l_partkey)`` and ``collect_set(l_suppkey)`` by
   ``l_orderkey`` (PARTIAL, a hash exchange over 8 partitions, FINAL;
   ``spark.blaze.collect.maxElems`` 8, no order cut), a shuffled hash
   join with one year of orders, ``size`` and ``array_contains``,
   ``pos_explode`` of the list and an agg by ``o_orderpriority``, equal
   to numpy; ``murmur3_pids``, ``pid_histogram`` and ``sorted_lookup``
   held to their plain versions on the largest inputs the run gave
   them; (2) the same collect at SF 0.1 at the default budget, in
   2^14-row batches so that groups merge partial states, every list and
   set equal to numpy's; (3) word count over part's names at
   ``--scale`` (``split``, ``explode``, group, sort) equal to numpy's
   split; (4) one row per order at SF 0.1 (a LIST, a MAP and a STRUCT)
   written to ORC by the port's writer and read back through
   ``OrcScanExec``: the map exploded, a struct field and the list's
   first element aggregated per line number, equal to numpy and to the
   port's CPU evaluation; one JSON record a run; then the exchanges
   phase (q01 as Spark plans it, a global sort and ``repartition(8)`` of
   orders, a skipping partial agg, each on both paths); then the faults
   phase, every run through ``run_stages`` with
   ``spark.blaze.task.retryBackoff`` 0 but one: q03 at ``--scale``
   fault-free, then under each fault of ``FAULT_MATRIX`` (a crashed
   task, a failed commit, an injected fetch failure, a committed map
   output with a flipped byte, a corrupt broadcast blob), each equal to
   the fault-free rows and q03's oracle with its recovery counters as
   listed and launching at least as often; the retry budget used up
   (``TaskRetriesExhausted`` naming the stage, the task, 3 attempts and
   the site, nothing left behind); one retry with the default backoff;
   a 2 s straggler at a map commit raced by a speculative backup (4
   tasks at a time, the backup must win, the wall within 2 s of the
   fault-free one) and retried as a wedge (``spark.blaze.task.wedgeMs``
   500); q01 as Spark plans it with its boundary pass's first fetch
   failing; then ``murmur3_pids``, ``pid_histogram`` and
   ``sorted_lookup`` held to their plain versions on the largest inputs
   the phase gave them; one JSON record a run; then the map/zstd phase:
   q03 at ``--scale`` with its broadcast carrying the serialized join
   map (``BroadcastJoinBuildHashMapExec``, :func:`map_mode`) in process
   and through ``run_stages``, equal to the oracle and to raw mode's
   rows and launches on each path, with its payload bytes, the seconds
   building and rebuilding the map and the cache hits; the same through
   ``run_stages`` with ``broadcast.write@1@corrupt``, recovered by one
   broadcast re-run; ``sorted_lookup`` held to its plain version on the
   deserialized table; under ``spark.io.compression.codec=zstd`` at SF
   0.1, q03 through ``run_stages`` against the same run under zlib
   (rows, launches, ``.data`` bytes), q06 from zstd parquet and q01 from
   zstd ORC (written by the port's writer in two more worker processes
   from the start of the run), each equal to its oracle, with compress
   and decompress MB/s; and the committed ``zstandard`` fixture frames
   (``tests/data/zstd``) decoded to their SHA-256; one JSON record a run;
   then the pool phase: q03 at ``--scale`` from the file phase's SF1
   parquet files through ``run_stages`` unpooled and with a
   ``HostPool`` of two ``worker.py --serve`` processes on the card (the
   map stages that read no broadcast run in the workers, each with its
   own CUDA context), equal to the oracle and to each other, every
   eligible map output owned by a worker, the driver's launches plus the
   workers' equal to the unpooled run's and ``murmur3_pids`` and
   ``pid_histogram`` launched in the workers; each worker's pid,
   spawn-to-ready seconds, context memory, launches and jobs; q03 with
   ``worker.task@2@kill`` and ``maxFailures=1`` (each worker killed as
   its second job starts: 2 workers lost, 2 partial re-runs of one task,
   both slots blacklisted, the rest in process) equal to the oracle; a
   cancel 1 s after a job stalled in a worker, which kills it; after
   every pool's ``close()`` no worker pid in ``nvidia-smi
   --query-compute-apps``; one JSON record a run;
11. the null-key phase: ``store_sales`` at ``--ds-scale`` with its -1
   ``ss_customer_sk`` exposed as nulls (``with_null_fks``), through
   ``split_stages``/``run_stages``: an ``IS NULL`` count, a group by
   the key with one null group (its exchange through ``murmur3_pids``
   with nulls present), an INNER join to ``customer`` that drops them
   (its probe through ``sorted_lookup``) and a LEFT join that
   null-extends them, each equal to a numpy count; then
   ``murmur3_pids`` on that key column, held to its plain version, its
   null rows in the seed's partition, and ``sorted_lookup`` on the
   largest table and probe the joins gave it;
12. reads the CUPTI device time of every timed call in one
   ``torch.profiler`` session, and counts every device operation one
   ``pid_histogram`` call issues on each path (one on paths (a) and
   (b), or it fails); then runs q01 and q03 in process under each A/B
   setting and q10, TPC-DS q47, q67, q5, q22 and q72 under the defaults,
   and q03 from the SF1 parquet files, all in one more
   ``torch.profiler`` session, and prints the device's busy share of
   each run, its device operations, the kernels that take its time, and
   the hand-written kernels' device time at the shapes the query gives
   them;
13. prints where each phase ended on the host clock, the ``kernels``
   JSON line (launches summed over the 125 queries, the file,
   functions, nested and exchanges phases' runs in process, the faults
   and map/zstd phases' runs and the pool phase's pooled and killed runs,
   the driver's and the workers', and per query on each path; the
   null-key, file, functions, nested, exchanges, faults, map/zstd and
   pool phases' apart too), then ``{"ok": true, ...}`` last.

Any failure raises and exits nonzero before the last line; without a
CUDA card it exits 2.  Nothing here imports JAX or ``blaze_tpu``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict

REPO = Path(__file__).resolve().parent
T0 = time.perf_counter()

# NVIDIA H100 SXM data-sheet peaks
HBM_BYTES_PER_S = 3.35e12
# the data sheet gives no integer rate: 32-bit ALU work is counted against
# its float32 non-tensor rate, the nearest figure
ALU_OPS_PER_S = 67e12
L2_FLUSH_BYTES = 128 << 20
# about 10 ms of spinning at the H100's 1.98 GHz: longer than the host
# takes to enqueue any one timed call, plain versions included
SPIN_CYCLES = 20_000_000


def log(*a) -> None:
    print(*a, flush=True)


def bound(bytes_moved: float, ops: float):
    """(bound_ms, bound_by): the larger of the bytes and operations
    times at the card's peak rates."""
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S * 1e3, ops / ALU_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(torch, fn, iters: int, flush) -> float:
    """Median per-call device time of ``fn`` with L2 flushed before
    every call (CUDA events around each call, after a warm-up).  A spin
    kernel holds the card while the host enqueues the start event, the
    call and the end event, so the events time the call's device work
    and not the host's launch overhead."""
    for _ in range(3):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for s, e in zip(starts, ends):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    times = sorted(s.elapsed_time(e) for s, e in zip(starts, ends))
    return times[len(times) // 2]


def device_times(torch, cuda_ops, jobs, iters: int, flush, count_jobs=(), then=None):
    """(device time per call of each job, device operations per call of
    each count job, what ``then`` returned, the device events after the
    count jobs).  A job is ``(fn, kernel)`` or ``(fn, kernel,
    launches)``: the time of ``fn``'s launches of kernels named
    ``kernel``, from torch.profiler's CUPTI trace, L2 flushed before
    every call; the launches per call are ``launches`` or what
    ``fn`` adds to ``cuda_ops.LAUNCHES``.  It leaves out the gap from the
    start event to the launch that ``time_ms`` encloses.  A count job
    ``(fn, calls)`` runs ``fn`` that many times, unflushed, between two
    spin kernels; every device operation between them counts (kernels
    of any name, fills, memsets, copies).  ``then`` (the profiled
    queries, :func:`run_profiled`) runs after them in the same session:
    it is the process's only one, since a later session has lost spin
    kernels and more sessions have come back without kernel events
    (``profiler_drops.py``).  Everything is told apart by its order."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    launches = []
    for job in jobs:
        before = sum(cuda_ops.LAUNCHES.values())
        job[0]()
        launches.append(job[2] if len(job) > 2 else sum(cuda_ops.LAUNCHES.values()) - before)
    for fn, _ in count_jobs:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for job in jobs:
            for _ in range(iters):
                flush.zero_()
                job[0]()
        for fn, calls in count_jobs:
            torch.cuda._sleep(1000)
            for _ in range(calls):
                fn()
            torch.cuda._sleep(1000)
        later = then() if then is not None else None
        torch.cuda.synchronize()
    # the card's activity alone, read from the profiler's raw events:
    # building its function events (the host's among them) for the
    # profiled runs' half a million device operations took minutes
    device = sorted((e for e in prof.profiler.kineto_results.events() if e.device_type() == DeviceType.CUDA),
                    key=lambda e: e.start_ns())
    names = {job[1] for job in jobs}
    spins = [i for i, e in enumerate(device) if "spin_kernel" in e.name()]
    marks = 2 * len(count_jobs)
    first = spins[0] if spins else len(device)
    events = [e for e in device[:first] if any(k in e.name() for k in names)]
    if len(events) != iters * sum(launches) or len(spins) < marks:
        raise AssertionError(f"the profiler saw {len(events)} kernel launches, not {iters * sum(launches)}, "
                             f"and {len(spins)} spin kernels, fewer than {marks}")
    out, pos = [], 0
    for k in launches:
        out.append(sum(e.duration_ns() for e in events[pos:pos + iters * k]) / iters / 1e6)
        pos += iters * k
    ops = [(spins[2 * i + 1] - spins[2 * i] - 1) / calls for i, (_, calls) in enumerate(count_jobs)]
    return out, ops, later, device[spins[marks - 1] + 1 if marks else first:]


# ----------------------------------------------------------- kernel checks


def murmur3_inputs(torch, cuda_ops, n: int, kinds, seed: int, offset: int = 0):
    """(planes, widths, valids) of (n,) keys of the given kinds, 10%
    nulls; ``offset`` > 0 makes every plane and validity a view that
    starts that many elements into its buffer (a slice's alignment)."""
    from blaze_tpu_torch.batch import Column
    from blaze_tpu_torch.schema import DataType

    g = torch.Generator(device="cuda").manual_seed(seed)
    cols = []
    for kind in kinds:
        m = n + offset
        if kind == "int64":
            data = torch.randint(-(2**63), 2**63 - 1, (m,), generator=g, device="cuda", dtype=torch.int64)
            dtype = DataType.int64()
        elif kind == "date32":
            data = torch.randint(8000, 10500, (m,), generator=g, device="cuda", dtype=torch.int32)
            dtype = DataType.date32()
        else:
            data = torch.randint(-(2**31), 2**31 - 1, (m,), generator=g, device="cuda", dtype=torch.int32)
            dtype = DataType.int32()
        valid = torch.rand(m, generator=g, device="cuda") > 0.1
        cols.append(Column(dtype, data, valid))
    planes, widths = zip(*(cuda_ops.column_word_planes(c) for c in cols))
    valids = [c.validity[offset:] for c in cols]
    return [p[offset:] for p in planes], list(widths), valids


def check_murmur3(torch, cuda_ops, flush, planes, widths, valids, label: str, timed: bool = True,
                  n_parts: int = 8) -> dict:
    """murmur3_pids held exactly to its plain version; timed, also
    against its bound."""
    n = planes[0].shape[0]
    got = cuda_ops.murmur3_pids(planes, widths, valids, n_parts)
    want = cuda_ops.murmur3_pids_plain(planes, widths, valids, n_parts)
    torch.cuda.synchronize()
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    if err != 0 or not torch.equal(got, want):
        raise AssertionError(f"murmur3_pids {label}: kernel differs from plain version (max {err})")
    r = {"shape": f"N={n} keys={label} n_parts={n_parts}", "max_abs_err": err}
    if not timed:
        return r
    ms = time_ms(torch, lambda: cuda_ops.murmur3_pids(planes, widths, valids, n_parts), 50, flush)
    plain_ms = time_ms(torch, lambda: cuda_ops.murmur3_pids_plain(planes, widths, valids, n_parts), 10, flush)
    per_col_ops = {1: 21, 2: 32}  # mix_k1, mix_h1 per word, fmix, select
    ops = n * (sum(per_col_ops[w] for w in widths) + 4)
    bytes_moved = n * (sum(4 * w for w in widths) + len(widths) + 4)
    b_ms, b_by = bound(bytes_moved, ops)
    r.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
             device_job=(lambda: cuda_ops.murmur3_pids(planes, widths, valids, n_parts), "murmur3_pids_kernel"))
    return r


def lookup_inputs(torch, t: int, n: int, seed: int):
    """A t-key table with duplicates and null-key sentinels, keys on
    both sides of 2^63, sorted in unsigned order, and n probes: half
    table keys, the rest random, plus the sentinel and 0."""
    from blaze_tpu_torch.exprs.int128 import SIGN

    g = torch.Generator(device="cuda").manual_seed(seed)
    body = torch.randint(-(2**63), 2**63 - 1, (t - 64,), generator=g, device="cuda", dtype=torch.int64)
    keys = torch.cat([body, body[:32], torch.full((32,), -1, dtype=torch.int64, device="cuda")])
    table = (torch.sort(keys ^ SIGN).values ^ SIGN).contiguous()  # unsigned order
    pick = torch.randint(0, t, (n // 2,), generator=g, device="cuda")
    probe = torch.cat([
        table[pick],
        torch.randint(-(2**63), 2**63 - 1, (n - n // 2 - 2,), generator=g, device="cuda", dtype=torch.int64),
        torch.tensor([-1, 0], dtype=torch.int64, device="cuda"),
    ]).contiguous()
    return table, probe


def lookup_probes(torch, table, n: int, g):
    """n probes of ``table``: half its keys, the rest random, then 0,
    the sentinel, and (for a nonempty table) its first and last keys."""
    t = table.shape[0]
    edges = [0, -1] + ([int(table[0]), int(table[-1])] if t else [])
    half = n // 2 if t else 0
    pick = torch.randint(0, max(t, 1), (half,), generator=g, device="cuda")
    return torch.cat([
        table[pick] if t else torch.zeros(0, dtype=torch.int64, device="cuda"),
        torch.randint(-(2**63), 2**63 - 1, (n - half - len(edges),), generator=g, device="cuda",
                      dtype=torch.int64),
        torch.tensor(edges, dtype=torch.int64, device="cuda"),
    ]).contiguous()


def check_sorted_lookup(torch, cuda_ops, flush, table, probe, label: str, timed: bool = True) -> dict:
    """sorted_lookup held exactly to its plain version; timed, also
    against its bound and torch.searchsorted (left + right)."""
    from blaze_tpu_torch.exprs.int128 import SIGN

    t, n = table.shape[0], probe.shape[0]
    lo, hi = cuda_ops.sorted_lookup(table, probe)
    plo, phi = cuda_ops.sorted_lookup_plain(table, probe)
    torch.cuda.synchronize()
    err = max(int((lo - plo).abs().max()), int((hi - phi).abs().max()))
    if err != 0:
        raise AssertionError(f"sorted_lookup {label} T={t} N={n}: kernel differs from plain version (max {err})")
    r = {"shape": f"T={t} N={n} {label}".strip(), "max_abs_err": err}
    if not timed:
        return r
    tb, qb = table ^ SIGN, probe ^ SIGN
    ms = time_ms(torch, lambda: cuda_ops.sorted_lookup(table, probe), 50, flush)
    plain_ms = time_ms(torch, lambda: cuda_ops.sorted_lookup_plain(table, probe), 10, flush)
    library_ms = time_ms(torch, lambda: (torch.searchsorted(tb, qb, side="left"),
                                         torch.searchsorted(tb, qb, side="right")), 50, flush)
    # the work this run's data needs: each probe's lower-bound search
    # halves [0, t), its upper-bound search halves [lo, t); about 6
    # 32-bit operations per step (64-bit compare, index update)
    bits = lambda x: torch.floor(torch.log2(x.to(torch.float64) + 1)) + 1
    steps = float((bits(torch.full_like(lo, t)) + bits(t - lo.to(torch.int64))).sum())
    b_ms, b_by = bound(8 * n + 8 * t + 8 * n, 6 * steps)
    r.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=library_ms,
             device_job=(lambda: cuda_ops.sorted_lookup(table, probe), "sorted_lookup_kernel"))
    return r


def lookup_edge_tables(torch, cuda_ops, seed: int):
    """(label, table, probe) of the lookup's edge cases: tables about
    the sample stride's steps, a run of equal keys across a segment's
    end, one key, mostly sentinels, a table whose stride is past the
    segment (global narrowing steps), and an 8-byte-aligned view (the
    8-byte load path)."""
    from blaze_tpu_torch.exprs.int128 import SIGN

    g = torch.Generator(device="cuda").manual_seed(seed)
    usort = lambda x: (torch.sort(x ^ SIGN).values ^ SIGN).contiguous()
    rand = lambda k: torch.randint(-(2**63), 2**63 - 1, (k,), generator=g, device="cuda", dtype=torch.int64)
    keys_per_sample = cuda_ops.SAMPLE_BYTES // 8
    cases = []
    for t in (0, 1, 7, 9, keys_per_sample - 1, keys_per_sample, keys_per_sample + 1, 30001):
        body = rand(t)
        cases.append((f"random T={t}", usort(torch.cat([body[: t - t // 8], body[: t // 8]]))))
    stride = 1 << cuda_ops.sorted_lookup_geometry(30000)[0]
    table = usort(rand(30000))
    table[100 * stride - 5: 100 * stride + 2 * stride + 3] = table[100 * stride - 5]  # run over two segment ends
    cases.append(("run across segments", table))
    cases.append(("one key", torch.full((30000,), int(rand(1)), dtype=torch.int64, device="cuda")))
    cases.append(("one key, sentinel", torch.full((30000,), -1, dtype=torch.int64, device="cuda")))
    cases.append(("mostly sentinels", usort(torch.cat([rand(3000), torch.full((27000,), -1, dtype=torch.int64,
                                                                                 device="cuda")]))))
    cases.append(("T=2^20 (stride past the segment)", usort(rand(1 << 20))))
    buf = torch.cat([torch.zeros(1, dtype=torch.int64, device="cuda"), usort(rand(30000))])
    cases.append(("8-byte-aligned view", buf[1:]))
    return [(label, table, lookup_probes(torch, table, 1 << 16, g)) for label, table in cases]


def hist_pids(torch, n: int, n_parts: int, seed: int, offset: int = 0, layout: str = "random"):
    """(n,) int32 pids: "random" in [0, n_parts) with 5% -1 rows; "minus
    one" all -1; "one bin" all n_parts - 1; "past" in [n_parts,
    2 n_parts) and -1 (nothing counted).  ``offset`` > 0 makes them a
    view that starts that many elements into its buffer."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    m = n + offset
    if layout == "minus one":
        pids = torch.full((m,), -1, dtype=torch.int32, device="cuda")
    elif layout == "one bin":
        pids = torch.full((m,), n_parts - 1, dtype=torch.int32, device="cuda")
    else:
        lo = n_parts if layout == "past" else 0
        pids = torch.randint(lo, lo + n_parts, (m,), generator=g, device="cuda", dtype=torch.int32)
        pids[torch.rand(m, generator=g, device="cuda") < 0.05] = -1
    return pids[offset:]


def check_pid_histogram(torch, cuda_ops, flush, pids, n_parts: int, label: str = "", timed: bool = True,
                        pr3=None) -> dict:
    """pid_histogram held exactly to its plain version; timed, also the
    PR 3 design (``pr3``, its caller's zeroing included), the plain
    version and torch.bincount, against the bound."""
    n = pids.shape[0]
    got = cuda_ops.pid_histogram(pids, n_parts)
    want = cuda_ops.pid_histogram_plain(pids, n_parts)
    torch.cuda.synchronize()
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    counted = int(((pids >= 0) & (pids < n_parts)).sum())
    if err != 0 or not torch.equal(got, want) or int(got.to(torch.int64).sum()) != counted:
        raise AssertionError(f"pid_histogram N={n} n_parts={n_parts} {label}: kernel differs from plain (max {err})")
    r = {"shape": f"N={n} n_parts={n_parts} {label}".strip(), "max_abs_err": err}
    if not timed:
        return r
    ms = time_ms(torch, lambda: cuda_ops.pid_histogram(pids, n_parts), 50, flush)
    plain_ms = time_ms(torch, lambda: cuda_ops.pid_histogram_plain(pids, n_parts), 20, flush)
    # the same function in one library call: shift -1 into bin 0, drop it
    library_ms = time_ms(torch, lambda: torch.bincount(pids + 1, minlength=n_parts + 1)[1:], 50, flush)
    b_ms, b_by = bound(4 * n + 4 * n_parts, counted)
    r.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=library_ms,
             device_job=(lambda: cuda_ops.pid_histogram(pids, n_parts), "pid_histogram_kernel"))
    if pr3 is not None:
        if not torch.equal(pr3(pids, n_parts), want):
            raise AssertionError(f"pid_histogram PR 3 design N={n} n_parts={n_parts}: differs from plain")
        r["pr3_ms"] = time_ms(torch, lambda: pr3(pids, n_parts), 50, flush)
        r["pr3_job"] = (lambda: pr3(pids, n_parts), "pid_histogram_kernel", 1)
    return r


def check_pid_histogram_streams(torch, cuda_ops, seed: int) -> list:
    """1,000 back-to-back calls over inputs of every path and grid, summed
    per input; then calls on two streams at once, each with tickets of
    its own, summed per stream.  Each sum must be the call
    count times the plain version.  Returns check results."""
    inputs = [(hist_pids(torch, n, p, seed + i), p) for i, (n, p) in enumerate(
        ((1 << 20, 8), (100_003, 200), (5000, 8), ((1 << 20) + 3, 33), (3000, 200), (50_000, 57_344)))]
    wants = [cuda_ops.pid_histogram_plain(pids, p).to(torch.int64) for pids, p in inputs]
    sums = [torch.zeros_like(w) for w in wants]
    for k in range(1000):
        i = k % len(inputs)
        sums[i] += cuda_ops.pid_histogram(*inputs[i])
    torch.cuda.synchronize()
    calls = [len(range(i, 1000, len(inputs))) for i in range(len(inputs))]
    if not all(torch.equal(s, c * w) for s, c, w in zip(sums, calls, wants)):
        raise AssertionError("pid_histogram: 1,000 back-to-back calls do not sum to the plain counts")
    out = [{"shape": "1,000 back-to-back calls over 6 inputs, summed", "max_abs_err": 0}]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    pairs = [inputs[0], inputs[1]], [inputs[2], inputs[3]]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    results = [[], []]
    for _ in range(100):
        for j, s in enumerate(streams):
            with torch.cuda.stream(s):
                results[j].extend(cuda_ops.pid_histogram(pids, p) for pids, p in pairs[j])
    torch.cuda.synchronize()
    for j in range(2):
        for q, (pids, p) in enumerate(pairs[j]):
            total = sum(r.to(torch.int64) for r in results[j][q::2])
            if not torch.equal(total, 100 * cuda_ops.pid_histogram_plain(pids, p).to(torch.int64)):
                raise AssertionError(f"pid_histogram: stream {j} input {q} differs when two streams run at once")
    out.append({"shape": "two streams at once, 2 x 100 calls each, summed", "max_abs_err": 0})
    return out


def check_opt_in_threads(torch, cuda_ops, seed: int) -> list:
    """sorted_lookup and pid_histogram called from four host threads at
    once, 200 calls a thread, as parallel map tasks probe and count
    their own partitions: each thread's inputs need its own amount of
    shared memory above 48 KB, an opt-in that is the kernel's attribute
    and not the launch's.  Every result must equal the plain version.
    Returns check results."""
    from concurrent.futures import ThreadPoolExecutor

    lookups = [lookup_inputs(torch, t, 1 << 16, seed + i) for i, t in enumerate((6500, 7200, 8000, 14000))]
    hists = [(hist_pids(torch, 1 << 18, p, seed + 10 + i), p) for i, p in enumerate((13000, 20000, 30000, 50000))]
    for table, _ in lookups:
        if 8 * cuda_ops.sorted_lookup_geometry(table.shape[0])[1] <= 48 * 1024:
            raise AssertionError("sorted_lookup: a threaded input stays under 48 KB of shared memory")
    barrier = threading.Barrier(4)

    def run(i):
        barrier.wait()
        out = []
        for _ in range(200):
            out.append((cuda_ops.sorted_lookup(*lookups[i]), cuda_ops.pid_histogram(*hists[i])))
        return out

    with ThreadPoolExecutor(4) as pool:
        results = list(pool.map(run, range(4)))
    torch.cuda.synchronize()
    for i, calls in enumerate(results):
        plo, phi = cuda_ops.sorted_lookup_plain(*lookups[i])
        want = cuda_ops.pid_histogram_plain(*hists[i])
        for (lo, hi), counts in calls:
            if not (torch.equal(lo, plo) and torch.equal(hi, phi)):
                raise AssertionError(f"sorted_lookup: thread {i} differs from plain when four threads launch")
            if not torch.equal(counts, want):
                raise AssertionError(f"pid_histogram: thread {i} differs from plain when four threads launch")
    shape = "four host threads at once, 200 calls each, shared memory 52-200 KB"
    return [("sorted_lookup", {"shape": shape, "max_abs_err": 0}),
            ("pid_histogram", {"shape": shape, "max_abs_err": 0})]


def q01_group_inputs(torch, lineitem) -> tuple:
    """fused_group_sums at the q01 shape: gids from (l_returnflag,
    l_linestatus), G = 6, with the shipdate filter folded in as -1;
    K = 4 float32 values: quantity, extendedprice, discount and
    disc_price = extendedprice * (1 - discount)."""
    import numpy as np

    from blaze_tpu_torch.tpch.datagen import _days

    lut = np.full(256, -1, np.int64)
    for i, ch in enumerate(b"ANR"):
        lut[ch] = i
    rf = lut[lineitem["l_returnflag"][0][:, 0]]
    ls = (lineitem["l_linestatus"][0][:, 0] == ord("O")).astype(np.int64)
    gids = np.where(lineitem["l_shipdate"][0] <= _days(1998, 9, 2), rf * 2 + ls, -1).astype(np.int32)
    qty, ext, disc = (lineitem[c][0] / 100.0 for c in ("l_quantity", "l_extendedprice", "l_discount"))
    vals = [qty, ext, disc, ext * (1.0 - disc)]
    return (torch.from_numpy(gids).cuda(), [torch.from_numpy(v.astype(np.float32)).cuda() for v in vals], 6)


def check_group_sums(torch, cuda_ops, flush, gids, values, n_groups: int, timed: bool = True) -> dict:
    """fused_group_sums held to its plain version and to float64 sums
    of the same float32 inputs, both within rtol 2e-5 (float atomics
    order the sums differently from run to run); a ones column, the
    count, exactly."""
    n, k = gids.shape[0], len(values)
    got = cuda_ops.fused_group_sums(gids, values, n_groups)
    plain = cuda_ops.fused_group_sums_plain(gids, values, n_groups)
    v64 = torch.stack(values).to(torch.float64)
    want = torch.zeros(k, n_groups + 1, dtype=torch.float64, device="cuda").index_add_(
        1, (gids + 1).to(torch.int64), v64)[:, 1:]
    counted = (gids >= 0) & (gids < n_groups)
    ones = torch.ones(n, dtype=torch.float32, device="cuda")
    count = cuda_ops.fused_group_sums(gids, [ones], n_groups)[0].to(torch.int64)
    torch.cuda.synchronize()
    want_count = torch.bincount(gids[counted].to(torch.int64), minlength=n_groups)
    rel = lambda a, b: float(((a.to(torch.float64) - b).abs() / b.abs().clamp_min(1e-30)).max())
    rel_f64, rel_plain = rel(got, want), rel(got, plain.to(torch.float64))
    err = float((got - plain).abs().max())
    if rel_f64 > 2e-5 or rel_plain > 2e-5 or not torch.equal(count, want_count):
        raise AssertionError(f"fused_group_sums K={k} G={n_groups}: rel err {rel_f64:.3g} to float64, "
                             f"{rel_plain:.3g} to plain; counts equal {torch.equal(count, want_count)}")
    r = {"shape": f"N={n} K={k} G={n_groups}", "max_abs_err": err, "max_rel_err_f64": rel_f64}
    if not timed:
        return r
    vk = torch.stack(values)
    ms = time_ms(torch, lambda: cuda_ops.fused_group_sums(gids, values, n_groups), 50, flush)
    plain_ms = time_ms(torch, lambda: cuda_ops.fused_group_sums_plain(gids, values, n_groups), 10, flush)
    library_ms = time_ms(torch, lambda: torch.zeros(k, n_groups + 1, device="cuda").index_add_(
        1, gids + 1, vk)[:, 1:], 50, flush)
    # every row reads its gid and K values once; one add per counted value
    b_ms, b_by = bound(n * (4 + 4 * k) + 4 * k * n_groups, k * int(counted.sum()))
    r.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=library_ms,
             device_job=(lambda: cuda_ops.fused_group_sums(gids, values, n_groups), "group_sums"))
    return r


# -------------------------------------------------------------- queries

# the columns each query reads, per table (a columnar scan's pruning);
# "ds_" marks a TPC-DS query
QUERY_COLUMNS = {
    "q6": {"lineitem": ("l_quantity", "l_extendedprice", "l_discount", "l_shipdate")},
    "q1": {"lineitem": ("l_returnflag", "l_linestatus", "l_quantity", "l_extendedprice",
                        "l_discount", "l_tax", "l_shipdate")},
    "q3": {"lineitem": ("l_orderkey", "l_extendedprice", "l_discount", "l_shipdate"),
           "orders": ("o_orderkey", "o_custkey", "o_orderdate", "o_shippriority"),
           "customer": ("c_custkey", "c_mktsegment")},
    "q4": {"orders": ("o_orderkey", "o_orderdate", "o_orderpriority"),
           "lineitem": ("l_orderkey", "l_commitdate", "l_receiptdate")},
    "q5": {"region": ("r_regionkey", "r_name"), "nation": ("n_nationkey", "n_name", "n_regionkey"),
           "supplier": ("s_suppkey", "s_nationkey"), "orders": ("o_orderkey", "o_custkey", "o_orderdate"),
           "customer": ("c_custkey", "c_nationkey"),
           "lineitem": ("l_orderkey", "l_suppkey", "l_extendedprice", "l_discount")},
    "q10": {"orders": ("o_orderkey", "o_custkey", "o_orderdate"),
            "lineitem": ("l_orderkey", "l_returnflag", "l_extendedprice", "l_discount"),
            "customer": ("c_custkey", "c_name", "c_address", "c_nationkey", "c_phone", "c_acctbal", "c_comment"),
            "nation": ("n_nationkey", "n_name")},
    "q12": {"lineitem": ("l_orderkey", "l_shipmode", "l_commitdate", "l_receiptdate", "l_shipdate"),
            "orders": ("o_orderkey", "o_orderpriority")},
    "q14": {"lineitem": ("l_partkey", "l_extendedprice", "l_discount", "l_shipdate"),
            "part": ("p_partkey", "p_type")},
    "q19": {"lineitem": ("l_partkey", "l_quantity", "l_extendedprice", "l_discount", "l_shipmode",
                         "l_shipinstruct"),
            "part": ("p_partkey", "p_brand", "p_container", "p_size")},
    "q2": {"region": ("r_regionkey", "r_name"), "nation": ("n_nationkey", "n_name", "n_regionkey"),
           "supplier": ("s_suppkey", "s_name", "s_address", "s_nationkey", "s_phone", "s_acctbal", "s_comment"),
           "partsupp": ("ps_partkey", "ps_suppkey", "ps_supplycost"),
           "part": ("p_partkey", "p_mfgr", "p_type", "p_size")},
    "q7": {"nation": ("n_nationkey", "n_name"), "supplier": ("s_suppkey", "s_nationkey"),
           "customer": ("c_custkey", "c_nationkey"), "orders": ("o_orderkey", "o_custkey"),
           "lineitem": ("l_orderkey", "l_suppkey", "l_shipdate", "l_extendedprice", "l_discount")},
    "q8": {"region": ("r_regionkey", "r_name"), "nation": ("n_nationkey", "n_name", "n_regionkey"),
           "customer": ("c_custkey", "c_nationkey"), "orders": ("o_orderkey", "o_custkey", "o_orderdate"),
           "part": ("p_partkey", "p_type"), "supplier": ("s_suppkey", "s_nationkey"),
           "lineitem": ("l_orderkey", "l_partkey", "l_suppkey", "l_extendedprice", "l_discount")},
    "q9": {"part": ("p_partkey", "p_name"), "partsupp": ("ps_partkey", "ps_suppkey", "ps_supplycost"),
           "orders": ("o_orderkey", "o_orderdate"), "nation": ("n_nationkey", "n_name"),
           "supplier": ("s_suppkey", "s_nationkey"),
           "lineitem": ("l_orderkey", "l_partkey", "l_suppkey", "l_quantity", "l_extendedprice", "l_discount")},
    "q11": {"nation": ("n_nationkey", "n_name"), "supplier": ("s_suppkey", "s_nationkey"),
            "partsupp": ("ps_partkey", "ps_suppkey", "ps_availqty", "ps_supplycost")},
    "q13": {"orders": ("o_orderkey", "o_custkey", "o_comment"), "customer": ("c_custkey",)},
    "q15": {"lineitem": ("l_suppkey", "l_shipdate", "l_extendedprice", "l_discount"),
            "supplier": ("s_suppkey", "s_name", "s_address", "s_phone")},
    "q16": {"part": ("p_partkey", "p_brand", "p_type", "p_size"), "supplier": ("s_suppkey", "s_comment"),
            "partsupp": ("ps_partkey", "ps_suppkey")},
    "q17": {"part": ("p_partkey", "p_brand", "p_container"),
            "lineitem": ("l_partkey", "l_quantity", "l_extendedprice")},
    "q18": {"lineitem": ("l_orderkey", "l_quantity"),
            "orders": ("o_orderkey", "o_custkey", "o_orderdate", "o_totalprice"), "customer": ("c_custkey", "c_name")},
    "q20": {"part": ("p_partkey", "p_name"), "lineitem": ("l_partkey", "l_suppkey", "l_quantity", "l_shipdate"),
            "partsupp": ("ps_partkey", "ps_suppkey", "ps_availqty"),
            "supplier": ("s_suppkey", "s_name", "s_address", "s_nationkey"), "nation": ("n_nationkey", "n_name")},
    "q21": {"lineitem": ("l_orderkey", "l_suppkey", "l_commitdate", "l_receiptdate"),
            "nation": ("n_nationkey", "n_name"), "supplier": ("s_suppkey", "s_name", "s_nationkey"),
            "orders": ("o_orderkey", "o_orderstatus")},
    "q22": {"customer": ("c_custkey", "c_phone", "c_acctbal", "c_nationkey"), "orders": ("o_custkey",)},
    "ds_q3": {"date_dim": ("d_date_sk", "d_year", "d_moy"),
              "store_sales": ("ss_sold_date_sk", "ss_item_sk", "ss_ext_sales_price"),
              "item": ("i_item_sk", "i_brand_id", "i_brand", "i_manufact_id")},
    "ds_q7": {"customer_demographics": ("cd_demo_sk", "cd_gender", "cd_marital_status", "cd_education_status"),
              "date_dim": ("d_date_sk", "d_year"),
              "promotion": ("p_promo_sk", "p_channel_email", "p_channel_event"),
              "store_sales": ("ss_cdemo_sk", "ss_sold_date_sk", "ss_promo_sk", "ss_item_sk", "ss_quantity",
                              "ss_list_price", "ss_coupon_amt", "ss_sales_price"),
              "item": ("i_item_sk", "i_item_id")},
}
_WEB = ("ws_sold_date_sk", "ws_item_sk")
_CAT = ("cs_sold_date_sk", "cs_item_sk")
_STORE = ("ss_sold_date_sk", "ss_item_sk")
_SHARE_ITEM = ("i_item_sk", "i_item_id", "i_item_desc", "i_category", "i_class", "i_current_price")
_MANUFACT = {"item": ("i_item_sk", "i_manufact_id", "i_category", "i_class"), "store": ("s_store_sk",),
             "store_sales": _STORE + ("ss_store_sk", "ss_sales_price")}
_YOY_DATES = {"date_dim": ("d_date_sk", "d_year", "d_moy"), "item": ("i_item_sk", "i_category", "i_brand")}
_Q49 = {"date_dim": ("d_date_sk", "d_year", "d_moy"),
        "web_sales": _WEB + ("ws_order_number", "ws_quantity", "ws_net_paid", "ws_net_profit"),
        "web_returns": ("wr_item_sk", "wr_order_number", "wr_return_quantity", "wr_return_amt"),
        "catalog_sales": _CAT + ("cs_order_number", "cs_quantity", "cs_net_paid", "cs_net_profit"),
        "catalog_returns": ("cr_item_sk", "cr_order_number", "cr_return_quantity", "cr_return_amount"),
        "store_sales": _STORE + ("ss_ticket_number", "ss_quantity", "ss_net_paid", "ss_net_profit"),
        "store_returns": ("sr_item_sk", "sr_ticket_number", "sr_return_quantity", "sr_return_amt")}
# TPC-DS's window queries
QUERY_COLUMNS.update({
    "ds_q12": {"date_dim": ("d_date_sk", "d_date"), "item": _SHARE_ITEM, "web_sales": _WEB + ("ws_ext_sales_price",)},
    "ds_q20": {"date_dim": ("d_date_sk", "d_date"), "item": _SHARE_ITEM, "catalog_sales": _CAT + ("cs_ext_sales_price",)},
    "ds_q98": {"date_dim": ("d_date_sk", "d_date"), "item": _SHARE_ITEM, "store_sales": _STORE + ("ss_ext_sales_price",)},
    "ds_q53": {**_MANUFACT, "date_dim": ("d_date_sk", "d_year", "d_qoy")},
    "ds_q63": {**_MANUFACT, "date_dim": ("d_date_sk", "d_year", "d_moy")},
    "ds_q89": {"item": ("i_item_sk", "i_category", "i_class", "i_brand"), "date_dim": ("d_date_sk", "d_year", "d_moy"),
               "store": ("s_store_sk", "s_store_name", "s_company_name"),
               "store_sales": _STORE + ("ss_store_sk", "ss_sales_price")},
    "ds_q47": {**_YOY_DATES, "store": ("s_store_sk", "s_store_name", "s_company_name"),
               "store_sales": _STORE + ("ss_store_sk", "ss_sales_price")},
    "ds_q57": {**_YOY_DATES, "call_center": ("cc_call_center_sk", "cc_name"),
               "catalog_sales": _CAT + ("cs_call_center_sk", "cs_sales_price")},
    "ds_q36": {"date_dim": ("d_date_sk", "d_year"), "item": ("i_item_sk", "i_category", "i_class"),
               "store": ("s_store_sk", "s_state"),
               "store_sales": _STORE + ("ss_store_sk", "ss_net_profit", "ss_ext_sales_price")},
    "ds_q86": {"date_dim": ("d_date_sk", "d_year"), "item": ("i_item_sk", "i_category", "i_class"),
               "web_sales": _WEB + ("ws_net_paid",)},
    "ds_q70": {"date_dim": ("d_date_sk", "d_year"), "store": ("s_store_sk", "s_state", "s_county"),
               "store_sales": ("ss_sold_date_sk", "ss_store_sk", "ss_net_profit")},
    "ds_q67": {"date_dim": ("d_date_sk", "d_year", "d_qoy", "d_moy"), "store": ("s_store_sk", "s_store_name"),
               "item": ("i_item_sk", "i_category", "i_class", "i_brand", "i_item_id"),
               "store_sales": _STORE + ("ss_store_sk", "ss_quantity", "ss_sales_price")},
    "ds_q44": {"store_sales": ("ss_store_sk", "ss_item_sk", "ss_net_profit", "ss_addr_sk"),
               "item": ("i_item_sk", "i_item_id")},
    "ds_q49": _Q49,
    "ds_q51": {"date_dim": ("d_date_sk", "d_year", "d_date"), "web_sales": _WEB + ("ws_sales_price",),
               "store_sales": _STORE + ("ss_sales_price",)},
})
_DATES = ("d_date_sk", "d_date")
_YM = ("d_date_sk", "d_year", "d_moy")
_CD = ("cd_demo_sk", "cd_gender", "cd_education_status")


def _gmt(group_col: str, filter_col: str) -> dict:
    """q33, q56 and q60: three channels per item id, -5 GMT buyers."""
    return {"date_dim": _YM, "customer_address": ("ca_address_sk", "ca_gmt_offset"),
            "item": ("i_item_sk", group_col, filter_col),
            "store_sales": _STORE + ("ss_addr_sk", "ss_ext_sales_price"),
            "catalog_sales": _CAT + ("cs_bill_addr_sk", "cs_ext_sales_price"),
            "web_sales": _WEB + ("ws_bill_addr_sk", "ws_ext_sales_price")}


def _with_returns(sales: tuple, returns: tuple) -> dict:
    """q80 and q75: each channel's sales and its returns on (item, ticket
    or order), the columns after the keys per table."""
    return {"store_sales": _STORE + ("ss_ticket_number",) + sales[0],
            "store_returns": ("sr_item_sk", "sr_ticket_number") + returns[0],
            "catalog_sales": _CAT + ("cs_order_number",) + sales[1],
            "catalog_returns": ("cr_item_sk", "cr_order_number") + returns[1],
            "web_sales": _WEB + ("ws_order_number",) + sales[2],
            "web_returns": ("wr_item_sk", "wr_order_number") + returns[2]}


_Q23 = {"date_dim": _YM, "item": ("i_item_sk", "i_item_desc"),
        "store_sales": _STORE + ("ss_customer_sk", "ss_quantity", "ss_sales_price"),
        "catalog_sales": _CAT + ("cs_bill_customer_sk", "cs_quantity", "cs_list_price"),
        "web_sales": _WEB + ("ws_bill_customer_sk", "ws_quantity", "ws_list_price")}
# TPC-DS's rollup and union queries
QUERY_COLUMNS.update({
    "ds_q27": {"customer_demographics": _CD + ("cd_marital_status",), "date_dim": ("d_date_sk", "d_year"),
               "store": ("s_store_sk", "s_state"), "item": ("i_item_sk", "i_item_id"),
               "store_sales": _STORE + ("ss_cdemo_sk", "ss_store_sk", "ss_quantity", "ss_list_price", "ss_coupon_amt",
                                        "ss_sales_price")},
    "ds_q18": {"customer_demographics": _CD + ("cd_dep_count",), "date_dim": ("d_date_sk", "d_year"),
               "customer": ("c_customer_sk", "c_current_addr_sk", "c_birth_year"),
               "customer_address": ("ca_address_sk", "ca_county", "ca_state"), "item": ("i_item_sk", "i_item_id"),
               "catalog_sales": _CAT + ("cs_bill_customer_sk", "cs_bill_cdemo_sk", "cs_quantity", "cs_list_price",
                                        "cs_coupon_amt", "cs_sales_price", "cs_net_profit")},
    "ds_q22": {"date_dim": ("d_date_sk", "d_year"),
               "item": ("i_item_sk", "i_item_id", "i_brand", "i_class", "i_category"),
               "inventory": ("inv_date_sk", "inv_item_sk", "inv_quantity_on_hand")},
    "ds_q5": {"date_dim": _DATES, "store": ("s_store_sk", "s_store_name"),
              "store_sales": ("ss_sold_date_sk", "ss_store_sk", "ss_ext_sales_price", "ss_net_profit"),
              "store_returns": ("sr_returned_date_sk", "sr_store_sk", "sr_return_amt", "sr_net_loss"),
              "catalog_page": ("cp_catalog_page_sk", "cp_catalog_page_id"),
              "catalog_sales": ("cs_sold_date_sk", "cs_catalog_page_sk", "cs_ext_sales_price", "cs_net_profit"),
              "catalog_returns": ("cr_returned_date_sk", "cr_catalog_page_sk", "cr_return_amount", "cr_net_loss"),
              "web_site": ("web_site_sk", "web_name"),
              "web_sales": _WEB + ("ws_order_number", "ws_web_site_sk", "ws_ext_sales_price", "ws_net_profit"),
              "web_returns": ("wr_returned_date_sk", "wr_item_sk", "wr_order_number", "wr_return_amt",
                              "wr_net_loss")},
    "ds_q77": {"date_dim": _DATES, "store": ("s_store_sk",),
               "store_sales": ("ss_sold_date_sk", "ss_store_sk", "ss_ext_sales_price", "ss_net_profit"),
               "store_returns": ("sr_returned_date_sk", "sr_store_sk", "sr_return_amt", "sr_net_loss"),
               "catalog_sales": ("cs_sold_date_sk", "cs_call_center_sk", "cs_ext_sales_price", "cs_net_profit"),
               "catalog_returns": ("cr_returned_date_sk", "cr_return_amount", "cr_net_loss"),
               "web_sales": ("ws_sold_date_sk", "ws_web_page_sk", "ws_ext_sales_price", "ws_net_profit"),
               "web_returns": ("wr_returned_date_sk", "wr_web_page_sk", "wr_return_amt", "wr_net_loss")},
    "ds_q80": {"date_dim": _DATES, "item": ("i_item_sk", "i_item_id", "i_current_price"),
               "promotion": ("p_promo_sk", "p_channel_email"),
               **_with_returns((("ss_promo_sk", "ss_ext_sales_price", "ss_net_profit"),
                                ("cs_promo_sk", "cs_ext_sales_price", "cs_net_profit"),
                                ("ws_promo_sk", "ws_ext_sales_price", "ws_net_profit")),
                               (("sr_return_amt", "sr_net_loss"), ("cr_return_amount", "cr_net_loss"),
                                ("wr_return_amt", "wr_net_loss")))},
    "ds_q14a": {"date_dim": _YM, "item": ("i_item_sk", "i_brand_id", "i_class_id", "i_category_id"),
                "store_sales": _STORE + ("ss_quantity", "ss_list_price"),
                "catalog_sales": _CAT + ("cs_quantity", "cs_list_price"),
                "web_sales": _WEB + ("ws_quantity", "ws_list_price")},
    "ds_q33": _gmt("i_manufact_id", "i_category"),
    "ds_q56": _gmt("i_item_id", "i_color"),
    "ds_q60": _gmt("i_item_id", "i_category"),
    "ds_q71": {"item": ("i_item_sk", "i_brand_id", "i_brand", "i_manager_id"), "date_dim": _YM,
               "time_dim": ("t_time_sk", "t_hour", "t_minute", "t_meal_time"),
               "store_sales": _STORE + ("ss_sold_time_sk", "ss_ext_sales_price"),
               "catalog_sales": _CAT + ("cs_sold_time_sk", "cs_ext_sales_price"),
               "web_sales": _WEB + ("ws_sold_time_sk", "ws_ext_sales_price")},
    "ds_q76": {"date_dim": ("d_date_sk", "d_year", "d_qoy"), "item": ("i_item_sk", "i_category"),
               "store_sales": _STORE + ("ss_customer_sk", "ss_ext_sales_price"),
               "web_sales": _WEB + ("ws_promo_sk", "ws_ext_sales_price"),
               "catalog_sales": _CAT + ("cs_bill_customer_sk", "cs_ext_sales_price")},
    "ds_q66": {"date_dim": _YM, "time_dim": ("t_time_sk", "t_time"), "ship_mode": ("sm_ship_mode_sk", "sm_carrier"),
               "warehouse": ("w_warehouse_sk", "w_warehouse_name", "w_warehouse_sq_ft", "w_city", "w_county",
                             "w_state", "w_country"),
               "web_sales": ("ws_warehouse_sk", "ws_sold_date_sk", "ws_sold_time_sk", "ws_ship_mode_sk",
                             "ws_quantity", "ws_ext_sales_price", "ws_net_paid"),
               "catalog_sales": ("cs_warehouse_sk", "cs_sold_date_sk", "cs_sold_time_sk", "cs_ship_mode_sk",
                                 "cs_quantity", "cs_sales_price", "cs_net_paid_inc_tax")},
    "ds_q2": {"date_dim": ("d_date_sk", "d_week_seq", "d_dow", "d_year"),
              "web_sales": ("ws_sold_date_sk", "ws_ext_sales_price"),
              "catalog_sales": ("cs_sold_date_sk", "cs_ext_sales_price")},
    "ds_q75": {"date_dim": ("d_date_sk", "d_year"),
               "item": ("i_item_sk", "i_brand_id", "i_class_id", "i_category_id", "i_manufact_id", "i_category"),
               **_with_returns((("ss_quantity", "ss_ext_sales_price"), ("cs_quantity", "cs_ext_sales_price"),
                                ("ws_quantity", "ws_ext_sales_price")),
                               (("sr_return_quantity", "sr_return_amt"), ("cr_return_quantity", "cr_return_amount"),
                                ("wr_return_quantity", "wr_return_amt")))},
    "ds_q54": {"catalog_sales": _CAT + ("cs_bill_customer_sk",), "web_sales": _WEB + ("ws_bill_customer_sk",),
               "item": ("i_item_sk", "i_category"), "date_dim": _YM + ("d_month_seq",),
               "customer": ("c_customer_sk", "c_current_addr_sk"),
               "store_sales": ("ss_sold_date_sk", "ss_customer_sk", "ss_ext_sales_price"),
               "customer_address": ("ca_address_sk", "ca_county", "ca_state"), "store": ("s_county", "s_state")},
    "ds_q23a": _Q23,
    "ds_q23b": {**_Q23, "customer": ("c_customer_sk", "c_last_name", "c_first_name")},
})
_ACTIVE = {"date_dim": _YM, "customer": ("c_customer_sk", "c_current_addr_sk", "c_current_cdemo_sk"),
           "store_sales": ("ss_sold_date_sk", "ss_customer_sk"),
           "web_sales": ("ws_sold_date_sk", "ws_bill_customer_sk"),
           "catalog_sales": ("cs_sold_date_sk", "cs_ship_customer_sk")}
_CHAIN = {"date_dim": ("d_date_sk", "d_year"), "store": ("s_store_sk", "s_store_name"),
          "item": ("i_item_sk", "i_item_id", "i_item_desc"),
          "store_sales": ("ss_sold_date_sk", "ss_item_sk", "ss_ticket_number", "ss_customer_sk", "ss_store_sk",
                          "ss_net_profit", "ss_quantity"),
          "store_returns": ("sr_item_sk", "sr_ticket_number", "sr_customer_sk", "sr_returned_date_sk",
                            "sr_net_loss", "sr_return_quantity"),
          "catalog_sales": ("cs_sold_date_sk", "cs_bill_customer_sk", "cs_item_sk", "cs_net_profit", "cs_quantity")}
_SETS = {"date_dim": ("d_date_sk", "d_year", "d_date"), "customer": ("c_customer_sk", "c_last_name", "c_first_name"),
         "store_sales": ("ss_sold_date_sk", "ss_customer_sk"), "catalog_sales": ("cs_sold_date_sk", "cs_bill_customer_sk"),
         "web_sales": ("ws_sold_date_sk", "ws_bill_customer_sk")}
_Q39 = {"date_dim": _YM, "inventory": ("inv_date_sk", "inv_item_sk", "inv_warehouse_sk", "inv_quantity_on_hand"),
        "warehouse": ("w_warehouse_sk", "w_warehouse_name")}
_DEPS = ("cd_dep_count", "cd_dep_employed_count", "cd_dep_college_count")
_DEMO5 = ("cd_demo_sk", "cd_gender", "cd_marital_status", "cd_education_status", "cd_purchase_estimate",
          "cd_credit_rating")
# EXISTS, INTERSECT and EXCEPT; stddev and the chain it shares; concat
QUERY_COLUMNS.update({
    "ds_q10": {**_ACTIVE, "customer_address": ("ca_address_sk", "ca_county"), "customer_demographics": _DEMO5 + _DEPS},
    "ds_q35": {**_ACTIVE, "customer_address": ("ca_address_sk", "ca_state"),
               "customer_demographics": ("cd_demo_sk", "cd_gender", "cd_marital_status") + _DEPS},
    "ds_q69": {**_ACTIVE, "customer_address": ("ca_address_sk", "ca_state"), "customer_demographics": _DEMO5},
    "ds_q38": _SETS, "ds_q87": _SETS, "ds_q17": _CHAIN, "ds_q25": _CHAIN, "ds_q29": _CHAIN,
    "ds_q39a": _Q39, "ds_q39b": _Q39,
    "ds_q84": {"customer_address": ("ca_address_sk", "ca_city"),
               "customer": ("c_customer_id", "c_first_name", "c_last_name", "c_current_addr_sk", "c_current_cdemo_sk",
                            "c_current_hdemo_sk"),
               "income_band": ("ib_income_band_sk", "ib_lower_bound", "ib_upper_bound"),
               "household_demographics": ("hd_demo_sk", "hd_income_band_sk"),
               "customer_demographics": ("cd_demo_sk",), "store_returns": ("sr_cdemo_sk",)},
})
_NOV_ITEMS = {"date_dim": _YM, "store_sales": _STORE + ("ss_ext_sales_price",)}
_BANDS = {"date_dim": ("d_date_sk", "d_year"), "store": ("s_store_sk",),
          "customer_demographics": ("cd_demo_sk", "cd_marital_status", "cd_education_status"),
          "household_demographics": ("hd_demo_sk", "hd_dep_count"), "customer_address": ("ca_address_sk", "ca_state")}
_BAND_SALES = ("ss_sold_date_sk", "ss_store_sk", "ss_cdemo_sk", "ss_hdemo_sk", "ss_addr_sk", "ss_sales_price",
               "ss_net_profit", "ss_quantity")
_TICKETS = {"date_dim": ("d_date_sk", "d_dom", "d_year"),
            "household_demographics": ("hd_demo_sk", "hd_buy_potential", "hd_vehicle_count", "hd_dep_count"),
            "store": ("s_store_sk", "s_county"),
            "store_sales": ("ss_sold_date_sk", "ss_hdemo_sk", "ss_store_sk", "ss_ticket_number", "ss_customer_sk"),
            "customer": ("c_customer_sk", "c_salutation", "c_first_name", "c_last_name", "c_preferred_cust_flag")}
_CITY = {"date_dim": ("d_date_sk", "d_dow"), "store": ("s_store_sk", "s_city"),
         "household_demographics": ("hd_demo_sk", "hd_dep_count", "hd_vehicle_count"),
         "customer_address": ("ca_address_sk", "ca_city"),
         "customer": ("c_customer_sk", "c_last_name", "c_first_name", "c_current_addr_sk")}
_CITY_SALES = ("ss_sold_date_sk", "ss_store_sk", "ss_hdemo_sk", "ss_addr_sk", "ss_ticket_number", "ss_customer_sk")
_SHIP = {"date_dim": ("d_date_sk", "d_year", "d_date"), "warehouse": ("w_warehouse_sk", "w_warehouse_name"),
         "ship_mode": ("sm_ship_mode_sk", "sm_type")}
_CUST_ADDR = ("c_customer_sk", "c_current_addr_sk")
_REASON = {"reason": ("r_reason_sk",)}
# the single-fact reports
QUERY_COLUMNS.update({
    "ds_q42": {**_NOV_ITEMS, "item": ("i_item_sk", "i_manager_id", "i_category_id", "i_category")},
    "ds_q52": {**_NOV_ITEMS, "item": ("i_item_sk", "i_manager_id", "i_brand_id", "i_brand")},
    "ds_q55": {**_NOV_ITEMS, "item": ("i_item_sk", "i_manager_id", "i_brand_id", "i_brand")},
    "ds_q19": {"date_dim": _YM,
               "item": ("i_item_sk", "i_manager_id", "i_brand_id", "i_brand", "i_manufact_id", "i_manufact"),
               "customer": _CUST_ADDR, "customer_address": ("ca_address_sk", "ca_zip"),
               "store": ("s_store_sk", "s_zip"),
               "store_sales": _STORE + ("ss_customer_sk", "ss_store_sk", "ss_ext_sales_price")},
    "ds_q43": {"date_dim": ("d_date_sk", "d_year", "d_dow"), "store": ("s_store_sk", "s_store_name"),
               "store_sales": ("ss_sold_date_sk", "ss_store_sk", "ss_sales_price")},
    "ds_q96": {"time_dim": ("t_time_sk", "t_hour", "t_minute"),
               "household_demographics": ("hd_demo_sk", "hd_dep_count"), "store": ("s_store_sk", "s_store_name"),
               "store_sales": ("ss_sold_time_sk", "ss_hdemo_sk", "ss_store_sk")},
    "ds_q26": {**{k: v for k, v in QUERY_COLUMNS["ds_q7"].items() if k != "store_sales"},
               "catalog_sales": ("cs_bill_cdemo_sk", "cs_sold_date_sk", "cs_promo_sk", "cs_item_sk", "cs_quantity",
                                 "cs_list_price", "cs_coupon_amt", "cs_sales_price")},
    "ds_q6": {"item": ("i_item_sk", "i_category", "i_current_price"), "date_dim": _YM,
              "store_sales": _STORE + ("ss_customer_sk",), "customer": _CUST_ADDR,
              "customer_address": ("ca_address_sk", "ca_state")},
    "ds_q41": {"item": ("i_color", "i_units", "i_manufact", "i_manufact_id", "i_item_id")},
    "ds_q13": {**_BANDS, "store_sales": _BAND_SALES + ("ss_ext_sales_price", "ss_ext_discount_amt")},
    "ds_q48": {**_BANDS, "store_sales": _BAND_SALES},
    "ds_q15": {"date_dim": ("d_date_sk", "d_qoy", "d_year"), "customer": _CUST_ADDR,
               "customer_address": ("ca_address_sk", "ca_zip", "ca_state"),
               "catalog_sales": ("cs_sold_date_sk", "cs_bill_customer_sk", "cs_sales_price")},
    "ds_q45": {"date_dim": ("d_date_sk", "d_year", "d_qoy"), "item": ("i_item_sk", "i_item_id"),
               "web_sales": _WEB + ("ws_bill_customer_sk", "ws_sales_price"), "customer": _CUST_ADDR,
               "customer_address": ("ca_address_sk", "ca_city", "ca_zip")},
    "ds_q8": {"customer_address": ("ca_address_sk", "ca_zip"),
              "customer": ("c_preferred_cust_flag", "c_current_addr_sk"),
              "store": ("s_store_sk", "s_store_name", "s_zip"), "date_dim": ("d_date_sk", "d_year", "d_qoy"),
              "store_sales": ("ss_sold_date_sk", "ss_store_sk", "ss_net_profit")},
    "ds_q91": {"date_dim": ("d_date_sk", "d_year"),
               "catalog_returns": ("cr_returned_date_sk", "cr_returning_customer_sk", "cr_call_center_sk",
                                   "cr_net_loss"),
               "call_center": ("cc_call_center_sk", "cc_name"),
               "customer": ("c_customer_sk", "c_current_cdemo_sk", "c_current_addr_sk"),
               "customer_demographics": ("cd_demo_sk", "cd_marital_status", "cd_education_status")},
    "ds_q34": _TICKETS, "ds_q73": _TICKETS,
    "ds_q46": {**_CITY, "store_sales": _CITY_SALES + ("ss_coupon_amt", "ss_net_profit")},
    "ds_q68": {**_CITY, "store_sales": _CITY_SALES + ("ss_ext_sales_price", "ss_ext_list_price")},
    "ds_q79": {"date_dim": ("d_date_sk", "d_dow", "d_year"),
               "household_demographics": ("hd_demo_sk", "hd_dep_count", "hd_vehicle_count"),
               "store": ("s_store_sk", "s_city"), "customer": ("c_customer_sk", "c_last_name", "c_first_name"),
               "store_sales": ("ss_sold_date_sk", "ss_hdemo_sk", "ss_store_sk", "ss_ticket_number", "ss_customer_sk",
                               "ss_coupon_amt", "ss_net_profit")},
    "ds_q9": {**_REASON, "store_sales": ("ss_quantity", "ss_ext_discount_amt", "ss_net_profit")},
    "ds_q28": {"store": ("s_store_sk",),
               "store_sales": ("ss_quantity", "ss_list_price", "ss_coupon_amt", "ss_wholesale_cost")},
    "ds_q88": {**_REASON, "household_demographics": ("hd_demo_sk", "hd_dep_count", "hd_vehicle_count"),
               "store": ("s_store_sk", "s_store_name"), "time_dim": ("t_time_sk", "t_hour", "t_minute"),
               "store_sales": ("ss_sold_time_sk", "ss_hdemo_sk", "ss_store_sk")},
    "ds_q90": {"web_page": ("wp_web_page_sk", "wp_char_count"), "time_dim": ("t_time_sk", "t_hour"),
               "web_sales": ("ws_sold_time_sk", "ws_web_page_sk")},
    "ds_q61": {**_REASON, "date_dim": _YM, "store": ("s_store_sk",), "item": ("i_item_sk", "i_category"),
               "customer_address": ("ca_address_sk", "ca_gmt_offset"), "customer": _CUST_ADDR,
               "promotion": ("p_promo_sk", "p_channel_email", "p_channel_event"),
               "store_sales": _STORE + ("ss_store_sk", "ss_customer_sk", "ss_promo_sk", "ss_ext_sales_price")},
    "ds_q62": {**_SHIP, "web_site": ("web_site_sk", "web_name"),
               "web_sales": ("ws_sold_date_sk", "ws_ship_date_sk", "ws_warehouse_sk", "ws_ship_mode_sk",
                             "ws_web_site_sk")},
    "ds_q99": {**_SHIP, "call_center": ("cc_call_center_sk", "cc_name"),
               "catalog_sales": ("cs_sold_date_sk", "cs_ship_date_sk", "cs_warehouse_sk", "cs_ship_mode_sk",
                                 "cs_call_center_sk")},
    "ds_q21": {"date_dim": _DATES, "item": ("i_item_sk", "i_item_id", "i_current_price"),
               "warehouse": ("w_warehouse_sk", "w_warehouse_name"),
               "inventory": ("inv_date_sk", "inv_item_sk", "inv_warehouse_sk", "inv_quantity_on_hand")},
    "ds_q32": {"date_dim": _DATES, "item": ("i_item_sk", "i_manufact_id"),
               "catalog_sales": _CAT + ("cs_ext_discount_amt",)},
    "ds_q92": {"date_dim": _DATES, "item": ("i_item_sk", "i_manufact_id"),
               "web_sales": _WEB + ("ws_ext_discount_amt",)},
    "ds_q65": {"date_dim": ("d_date_sk", "d_year"), "store": ("s_store_sk", "s_store_name"),
               "item": ("i_item_sk", "i_item_desc", "i_current_price", "i_brand"),
               "store_sales": _STORE + ("ss_store_sk", "ss_sales_price")},
})
_Y = ("d_date_sk", "d_year")
_NAMES = ("c_customer_sk", "c_customer_id", "c_first_name", "c_last_name")
_YOY_CUST = _NAMES + ("c_preferred_cust_flag",)


def _yoy(store: tuple, catalog: tuple = (), web: tuple = ()) -> dict:
    """q74, q11 and q4: each channel's date and customer keys and its
    measure's columns."""
    out = {"date_dim": _Y, "customer": _YOY_CUST, "store_sales": ("ss_sold_date_sk", "ss_customer_sk") + store,
           "web_sales": ("ws_sold_date_sk", "ws_bill_customer_sk") + web}
    if catalog:
        out["catalog_sales"] = ("cs_sold_date_sk", "cs_bill_customer_sk") + catalog
    return out


_INV_PRICE = {"item": ("i_item_sk", "i_item_id", "i_item_desc", "i_current_price"), "date_dim": _DATES,
              "inventory": ("inv_date_sk", "inv_item_sk", "inv_quantity_on_hand")}
_Q24 = {"store_sales": ("ss_item_sk", "ss_ticket_number", "ss_store_sk", "ss_customer_sk", "ss_net_paid"),
        "store_returns": ("sr_item_sk", "sr_ticket_number"),
        "store": ("s_store_sk", "s_store_name", "s_county", "s_market_id"),
        "customer": ("c_customer_sk", "c_last_name", "c_first_name", "c_current_addr_sk"),
        "customer_address": ("ca_address_sk", "ca_county"), "item": ("i_item_sk", "i_color")}
_THREE = (("store_sales", "ss"), ("catalog_sales", "cs"), ("web_sales", "ws"))
_RETURNS3 = (("store_returns", "sr"), ("catalog_returns", "cr"), ("web_returns", "wr"))
_Q78 = {"date_dim": _Y, "store_returns": ("sr_item_sk", "sr_ticket_number"),
        "web_returns": ("wr_item_sk", "wr_order_number"), "catalog_returns": ("cr_item_sk", "cr_order_number"),
        "store_sales": ("ss_sold_date_sk", "ss_item_sk", "ss_customer_sk", "ss_ticket_number", "ss_quantity",
                        "ss_wholesale_cost", "ss_sales_price"),
        **{f: tuple(f"{p}_{c}" for c in ("sold_date_sk", "item_sk", "bill_customer_sk", "order_number", "quantity",
                                         "wholesale_cost", "sales_price"))
           for f, p in (("web_sales", "ws"), ("catalog_sales", "cs"))}}
# the multi-fact, shuffled and self joins
QUERY_COLUMNS.update({
    "ds_q1": {"date_dim": _Y, "store": ("s_store_sk", "s_state"), "customer": _NAMES[:2],
              "store_returns": ("sr_returned_date_sk", "sr_customer_sk", "sr_store_sk", "sr_return_amt")},
    "ds_q30": {"date_dim": _Y, "customer": _NAMES,
               "web_returns": ("wr_returned_date_sk", "wr_returning_customer_sk", "wr_web_page_sk", "wr_return_amt")},
    "ds_q81": {"date_dim": _Y, "customer": _NAMES,
               "catalog_returns": ("cr_returned_date_sk", "cr_returning_customer_sk", "cr_call_center_sk",
                                   "cr_return_amount")},
    **{q: {"date_dim": _DATES, "customer_address": ("ca_address_sk", "ca_state"),
           "web_site": ("web_site_sk", "web_company_name"), "web_returns": ("wr_order_number",),
           "web_sales": ("ws_ship_date_sk", "ws_ship_addr_sk", "ws_web_site_sk", "ws_order_number",
                         "ws_ext_ship_cost", "ws_net_profit", "ws_warehouse_sk")} for q in ("ds_q94", "ds_q95")},
    "ds_q16": {"date_dim": _DATES, "customer_address": ("ca_address_sk", "ca_state"),
               "call_center": ("cc_call_center_sk", "cc_county"), "catalog_returns": ("cr_order_number",),
               "catalog_sales": ("cs_ship_date_sk", "cs_ship_addr_sk", "cs_call_center_sk", "cs_order_number",
                                 "cs_ext_ship_cost", "cs_net_profit", "cs_warehouse_sk")},
    "ds_q74": _yoy(("ss_net_paid",), web=("ws_net_paid",)),
    "ds_q11": _yoy(("ss_ext_list_price", "ss_ext_discount_amt"), web=("ws_ext_list_price", "ws_ext_discount_amt")),
    "ds_q4": _yoy(("ss_ext_list_price", "ss_ext_wholesale_cost", "ss_ext_discount_amt", "ss_ext_sales_price"),
                  ("cs_ext_list_price", "cs_wholesale_cost", "cs_ext_discount_amt", "cs_ext_sales_price"),
                  ("ws_ext_list_price", "ws_wholesale_cost", "ws_ext_discount_amt", "ws_ext_sales_price")),
    "ds_q37": {**_INV_PRICE, "catalog_sales": ("cs_item_sk",)},
    "ds_q82": {**_INV_PRICE, "store_sales": ("ss_item_sk",)},
    "ds_q40": {"date_dim": _DATES, "item": ("i_item_sk", "i_item_id", "i_current_price"),
               "warehouse": ("w_warehouse_sk", "w_state"),
               "catalog_sales": ("cs_sold_date_sk", "cs_item_sk", "cs_order_number", "cs_warehouse_sk",
                                 "cs_sales_price"),
               "catalog_returns": ("cr_item_sk", "cr_order_number", "cr_refunded_cash")},
    "ds_q50": {"date_dim": ("d_date_sk", "d_date", "d_year", "d_moy"),
               "store": ("s_store_sk", "s_store_name", "s_county", "s_state", "s_zip"),
               "store_sales": ("ss_item_sk", "ss_ticket_number", "ss_customer_sk", "ss_store_sk", "ss_sold_date_sk"),
               "store_returns": ("sr_item_sk", "sr_ticket_number", "sr_customer_sk", "sr_returned_date_sk")},
    "ds_q93": {"reason": ("r_reason_sk", "r_reason_desc"),
               "store_sales": ("ss_item_sk", "ss_ticket_number", "ss_customer_sk", "ss_quantity", "ss_sales_price"),
               "store_returns": ("sr_item_sk", "sr_ticket_number", "sr_reason_sk", "sr_return_quantity")},
    "ds_q24a": _Q24, "ds_q24b": _Q24,
    "ds_q14b": QUERY_COLUMNS["ds_q14a"],
    "ds_q58": {"date_dim": ("d_date_sk", "d_date", "d_month_seq"), "item": ("i_item_sk", "i_item_id"),
               **{f: (f"{p}_sold_date_sk", f"{p}_item_sk", f"{p}_ext_sales_price") for f, p in _THREE}},
    "ds_q31": {"date_dim": ("d_date_sk", "d_year", "d_qoy"), "customer_address": ("ca_address_sk", "ca_county"),
               "store_sales": ("ss_sold_date_sk", "ss_addr_sk", "ss_ext_sales_price"),
               "web_sales": ("ws_sold_date_sk", "ws_bill_addr_sk", "ws_ext_sales_price")},
    "ds_q59": {"date_dim": ("d_date_sk", "d_week_seq", "d_dow", "d_year"), "store": ("s_store_sk", "s_store_name"),
               "store_sales": ("ss_sold_date_sk", "ss_store_sk", "ss_sales_price")},
    "ds_q83": {"date_dim": _Y, "item": ("i_item_sk", "i_item_id"),
               **{f: (f"{p}_returned_date_sk", f"{p}_item_sk", f"{p}_return_quantity") for f, p in _RETURNS3}},
    "ds_q85": {"date_dim": _Y, "web_page": ("wp_web_page_sk",), "reason": ("r_reason_sk", "r_reason_desc"),
               "customer_demographics": ("cd_demo_sk", "cd_marital_status"),
               "customer_address": ("ca_address_sk", "ca_country", "ca_state"),
               "web_sales": ("ws_item_sk", "ws_order_number", "ws_web_page_sk", "ws_sold_date_sk", "ws_quantity",
                             "ws_sales_price", "ws_net_profit"),
               "web_returns": ("wr_item_sk", "wr_order_number", "wr_refunded_cdemo_sk", "wr_returning_cdemo_sk",
                               "wr_refunded_addr_sk", "wr_reason_sk", "wr_refunded_cash", "wr_fee")},
    "ds_q78": _Q78,
    "ds_q97": {"date_dim": _Y, "store_sales": ("ss_sold_date_sk", "ss_customer_sk", "ss_item_sk"),
               "catalog_sales": ("cs_sold_date_sk", "cs_bill_customer_sk", "cs_item_sk")},
    "ds_q64": {"date_dim": _Y, "item": ("i_item_sk", "i_item_id", "i_color"),
               "store": ("s_store_sk", "s_store_name", "s_zip"), "store_returns": ("sr_item_sk", "sr_ticket_number"),
               "store_sales": ("ss_item_sk", "ss_ticket_number", "ss_store_sk", "ss_sold_date_sk",
                               "ss_wholesale_cost", "ss_list_price", "ss_coupon_amt")},
    "ds_q72": {"household_demographics": ("hd_demo_sk", "hd_buy_potential"),
               "customer_demographics": ("cd_demo_sk", "cd_marital_status"),
               "date_dim": ("d_date_sk", "d_date", "d_week_seq"), "item": ("i_item_sk", "i_item_desc"),
               "warehouse": ("w_warehouse_sk", "w_warehouse_name"),
               "catalog_sales": ("cs_sold_date_sk", "cs_ship_date_sk", "cs_item_sk", "cs_bill_cdemo_sk",
                                 "cs_bill_hdemo_sk", "cs_quantity"),
               "inventory": ("inv_date_sk", "inv_item_sk", "inv_warehouse_sk", "inv_quantity_on_hand")},
})
TPCH_QUERIES = ("q6", "q1", "q3", "q4", "q5", "q10", "q12", "q14", "q19")
DS_QUERIES = ("ds_q3", "ds_q7")
# the rest of TPC-H; they run on the tables with dbgen's p_name,
# c_phone, o_custkey and l_suppkey (datagen.with_spec_columns), without
# which q09, q20 and q22 select no row
NEW_QUERIES = ("q2", "q7", "q8", "q9", "q11", "q13", "q15", "q16", "q17", "q18", "q20", "q21", "q22")
# TPC-DS's window queries: WindowExec, ExpandExec (q36, q86, q70, q67),
# UnionExec (q49) and the fusion's partition buffer
WINDOW_QUERIES = tuple(f"ds_{q}" for q in ("q12", "q20", "q98", "q53", "q63", "q89", "q47", "q57", "q36", "q86",
                                           "q70", "q67", "q44", "q49", "q51"))
# TPC-DS's rollup and union queries: ExpandExec rollups with typed null
# literals and UnionExec over channels of sales and returns
ROLLUP_UNION_QUERIES = tuple(f"ds_{q}" for q in ("q27", "q18", "q22", "q5", "q77", "q80", "q14a", "q33", "q56", "q60",
                                                 "q71", "q76", "q66", "q2", "q75", "q54", "q23a", "q23b"))
# TPC-DS's EXISTS, INTERSECT/EXCEPT, stddev and concat queries
EXISTS_STDDEV_QUERIES = tuple(f"ds_{q}" for q in ("q10", "q35", "q69", "q38", "q87", "q17", "q25", "q29", "q39a",
                                                  "q39b", "q84"))
# TPC-DS's single-fact reports: broadcast joins into one fact table, scalar
# and IN subqueries run while the plan is built, CASE pivots
REPORT_QUERIES = tuple(f"ds_{q}" for q in ("q42", "q52", "q55", "q19", "q43", "q96", "q26", "q6", "q41", "q13", "q48",
                                           "q15", "q45", "q8", "q91", "q34", "q73", "q46", "q68", "q79", "q9", "q28",
                                           "q88", "q90", "q61", "q62", "q99", "q21", "q32", "q92", "q65"))
# of those, the ones that also run through run_stages: the whole fact
# tables q93, q78 and q72 shuffle through zlib files, and q97's FULL
# shuffled join; the others' shapes run through run_stages elsewhere
JOINED_SCHEDULED = ("ds_q93", "ds_q78", "ds_q97", "ds_q72")
# TPC-DS's multi-fact, shuffled and self joins, the heaviest (q72) last
JOINED_QUERIES = tuple(f"ds_{q}" for q in ("q1", "q30", "q81", "q94", "q95", "q16", "q74", "q11", "q4", "q37", "q82",
                                           "q40", "q50", "q93", "q24a", "q24b", "q14b", "q58", "q31", "q59", "q83",
                                           "q85", "q78", "q97", "q64", "q72"))
# the window, rollup/union and exists/stddev queries whose run_stages
# path is cut: each repeats the template of a query that keeps it with
# other columns or constants (q20 and q98 q12's, q63 and q89 q53's
# window average against the month, q57 q47's, q86 and q70 q36's
# rollup ranked within its parent level, q56 and q60 q33's, q77 and q80
# q5's channel report, q25 and q29 q17's store-sales, returns and
# catalog chain, q35 and q69 q10's, q39b q39a's), or selects nothing at
# SF1 (q23a, q23b and q87, whose two paths run at the smaller scales
# below)
SCHEDULED_CUT = ("ds_q20", "ds_q98", "ds_q63", "ds_q57", "ds_q56", "ds_q60", "ds_q23a", "ds_q23b", "ds_q87",
                 "ds_q29", "ds_q39b", "ds_q86", "ds_q77", "ds_q80", "ds_q35", "ds_q69", "ds_q89", "ds_q25", "ds_q70")
ALL_DS_QUERIES = (DS_QUERIES + WINDOW_QUERIES + ROLLUP_UNION_QUERIES + EXISTS_STDDEV_QUERIES + REPORT_QUERIES
                  + JOINED_QUERIES)
# q23a and q23b are empty from SF 0.01 on (the generator's -1 customer
# spends the most): they run again at this scale, where they are not
Q23_QUERIES, Q23_SCALE = ("ds_q23a", "ds_q23b"), 0.002
# q87 is empty from SF 0.1 on (the generator's customers carry 8
# distinct names, so every store (name, day) recurs in another channel):
# it runs again at this scale, where it is not
Q87_QUERIES, Q87_SCALE = ("ds_q87",), 0.01
# the queries that run a scalar (q45: an IN) subquery while their plan is built
SUBQUERY_QUERIES = ("q11", "q15", "q22", "ds_q44", "ds_q77", "ds_q14a", "ds_q54", "ds_q23a", "ds_q23b", "ds_q9",
                    "ds_q28", "ds_q88", "ds_q90", "ds_q61", "ds_q45", "ds_q24a", "ds_q24b", "ds_q14b", "ds_q58")
# the queries whose two paths sum doubles in another order (q18's
# averages of casts to double; q17's and q39's stddevs merge their
# states in another order): their rows agree within 1e-9 relative
FLOAT_SUM_QUERIES = ("ds_q18", "ds_q17", "ds_q39a", "ds_q39b")
# the kernels each query must launch, and those it must not
EXPECTED_LAUNCHES = {
    "q6": ((), ("murmur3_pids", "pid_histogram", "sorted_lookup")),
    "q1": (("pid_histogram",), ("murmur3_pids",)),
    **{q: (("murmur3_pids", "pid_histogram", "sorted_lookup"), ()) for q in ("q3", "q4", "q5", "q10", "q12")},
    **{q: (("sorted_lookup",), ("murmur3_pids", "pid_histogram")) for q in ("q14", "q19")},
    **{q: (("pid_histogram", "sorted_lookup"), ("murmur3_pids",)) for q in DS_QUERIES},
    # int or date keys on every hash exchange, and at least one join
    **{q: (("murmur3_pids", "pid_histogram", "sorted_lookup"), ()) for q in NEW_QUERIES},
    # a string key on every hash exchange: the plain murmur3
    **{q: (("pid_histogram", "sorted_lookup"), ("murmur3_pids",))
       for q in ("ds_q12", "ds_q20", "ds_q98", "ds_q89", "ds_q47", "ds_q57", "ds_q36", "ds_q86", "ds_q70", "ds_q67")},
    # an int or date key on at least one hash exchange
    **{q: (("murmur3_pids", "pid_histogram", "sorted_lookup"), ())
       for q in ("ds_q53", "ds_q63", "ds_q44", "ds_q49", "ds_q51")},
    **{q: (("pid_histogram", "sorted_lookup"), ("murmur3_pids",))
       for q in ("ds_q27", "ds_q18", "ds_q22", "ds_q56", "ds_q60", "ds_q71", "ds_q76", "ds_q66")},
    **{q: (("murmur3_pids", "pid_histogram", "sorted_lookup"), ())
       for q in ("ds_q5", "ds_q77", "ds_q80", "ds_q14a", "ds_q33", "ds_q2", "ds_q75", "ds_q54", "ds_q23a", "ds_q23b")},
    # int64 customer keys under the EXISTS sets, int keys on the chain's
    # shuffled joins and q84's
    **{q: (("murmur3_pids", "pid_histogram", "sorted_lookup"), ())
       for q in ("ds_q10", "ds_q35", "ds_q69", "ds_q17", "ds_q25", "ds_q29", "ds_q84")},
    # a string key on every hash exchange (names; the warehouse name)
    **{q: (("pid_histogram", "sorted_lookup"), ("murmur3_pids",)) for q in ("ds_q38", "ds_q87", "ds_q39a", "ds_q39b")},
    # the reports: a string key on every hash exchange
    **{q: (("pid_histogram", "sorted_lookup"), ("murmur3_pids",))
       for q in ("ds_q42", "ds_q52", "ds_q55", "ds_q19", "ds_q43", "ds_q26", "ds_q6", "ds_q41", "ds_q15", "ds_q45",
                 "ds_q8", "ds_q91", "ds_q46", "ds_q68", "ds_q79", "ds_q62", "ds_q99", "ds_q21")},
    # int keys: (ticket, customer), the item, (store, item)
    **{q: (("murmur3_pids", "pid_histogram", "sorted_lookup"), ()) for q in ("ds_q34", "ds_q73", "ds_q32", "ds_q92",
                                                                              "ds_q65")},
    # global aggregates over broadcast joins: no hash exchange
    **{q: (("sorted_lookup",), ("murmur3_pids", "pid_histogram")) for q in ("ds_q96", "ds_q13", "ds_q48", "ds_q88",
                                                                             "ds_q90", "ds_q61")},
    # q9: five bands' global aggregates over one table, no join, no
    # hash exchange (as TPC-H q06); q28: its distinct prices' exchange
    # on a decimal key, no join
    "ds_q9": ((), ("murmur3_pids", "pid_histogram", "sorted_lookup")),
    "ds_q28": (("murmur3_pids", "pid_histogram"), ("sorted_lookup",)),
    # the joined queries: an int key on at least one hash exchange (q64's
    # last join, on three strings, takes the plain murmur3)
    **{q: (("murmur3_pids", "pid_histogram", "sorted_lookup"), ())
       for q in JOINED_QUERIES if q not in ("ds_q31", "ds_q83")},
    # county and item-id strings on every hash exchange
    **{q: (("pid_histogram", "sorted_lookup"), ("murmur3_pids",)) for q in ("ds_q31", "ds_q83")},
}


def query_data(queries, scale: float, ds: bool) -> Dict[str, dict]:
    """Host tables at ``scale``, each with the columns ``queries`` read."""
    from blaze_tpu_torch import tpcds
    from blaze_tpu_torch.tpch import datagen

    cols_of: Dict[str, set] = {}
    for q in queries:
        for name, cols in QUERY_COLUMNS[q].items():
            cols_of.setdefault(name, set()).update(cols)
    if ds:
        return {name: tpcds.generate_table(name, scale, columns=cols) for name, cols in cols_of.items()}
    return {name: datagen.generate_table(name, scale, columns=cols) if name == "lineitem"
            else {c: v for c, v in datagen.generate_table(name, scale).items() if c in cols}
            for name, cols in cols_of.items()}


def spec_data(data, scale: float) -> Dict[str, dict]:
    """``data`` with dbgen's p_name, c_phone, o_custkey and l_suppkey
    (the other arrays shared, not copied): the new queries' tables."""
    from blaze_tpu_torch.tpch import datagen

    return datagen.with_spec_columns(data, scale)


def build_plan(query: str, scans, n_parts: int):
    """The plan of ``query`` (a TPC-DS query when prefixed "ds_")."""
    from blaze_tpu_torch import tpcds, tpch

    if query.startswith("ds_"):
        return tpcds.build_query(query[3:], scans, n_parts)
    return tpch.build_query(query, scans, n_parts)


def query_scans(data, query: str, n_parts: int, batch_rows: int):
    """Scans of ``query``'s tables staged on the card, pruned to the
    columns it reads."""
    from blaze_tpu_torch.batch import table_to_batches
    from blaze_tpu_torch.ops import MemoryScanExec
    from blaze_tpu_torch.schema import Schema
    from blaze_tpu_torch.tpcds import TPCDS_SCHEMAS
    from blaze_tpu_torch.tpch import TPCH_SCHEMAS

    schemas = TPCDS_SCHEMAS if query.startswith("ds_") else TPCH_SCHEMAS
    scans = {}
    for name, cols in QUERY_COLUMNS[query].items():
        schema = Schema([f for f in schemas[name].fields if f.name in cols])
        parts = table_to_batches({c: data[name][c] for c in cols}, schema, n_parts, batch_rows,
                                 device="cuda")
        scans[name] = MemoryScanExec(parts, schema, device="cuda")
    return scans


def run_plan(torch, plan):
    from blaze_tpu_torch.batch import batch_to_pydict
    from blaze_tpu_torch.runtime.context import TaskContext

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    batches = []
    n = plan.num_partitions()
    for p in range(n):
        batches.extend(plan.execute(p, TaskContext(p, n)))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out = {f.name: [] for f in plan.schema.fields}
    for b in batches:
        for k, v in batch_to_pydict(b).items():
            out[k].extend(v)
    return out, wall


HAND_WRITTEN = ("murmur3_pids_kernel", "pid_histogram_kernel", "group_sums", "sorted_lookup_kernel")
#: the launch counter of each hand-written kernel
HAND_WRITTEN_KEYS = dict(zip(HAND_WRITTEN, ("murmur3_pids", "pid_histogram", "fused_group_sums", "sorted_lookup")))


def run_profiled(torch, cuda_ops, runs) -> tuple:
    """Each ``(label, plan)`` of ``runs`` once inside the caller's
    profiler session (:func:`device_times`' ``then``), a spin kernel
    before and after each run to tell them apart.  Returns each run's
    wall and the launches its wrappers counted."""
    walls, counted = [], []
    torch.cuda._sleep(1000)
    for _, plan in runs:
        torch.cuda._sleep(1000)
        before = dict(cuda_ops.LAUNCHES)
        walls.append(run_plan(torch, plan)[1])
        counted.append({k: cuda_ops.LAUNCHES[k] - before[k] for k in before})
        torch.cuda._sleep(1000)
    torch.cuda._sleep(1000)
    return walls, counted


def read_profiles(runs, walls, counted, device) -> list:
    """The device events of :func:`run_profiled`'s runs, split: the
    device's busy share of each run's wall, its device operations, the
    kernels that take the most device time and the hand-written kernels'
    time at the shapes the query gives them.  Fails when the session
    lost a record it can count: a spin kernel, or a hand-written kernel
    launch that its wrapper counted.  Returns one dict a run."""
    spins = [i for i, e in enumerate(device) if "spin_kernel" in e.name()]
    # a run's work lies between two spins, and nothing lies between a
    # run's closing spin and the next one's opening spin (nor between
    # the first and last spins and their runs): the runs are the
    # nonempty stretches between spins
    stretches = [(a, b) for a, b in zip(spins, spins[1:]) if b > a + 1]
    if len(spins) != 2 * len(runs) + 2 or len(stretches) != len(runs):
        raise AssertionError(f"the profiler lost records: {len(spins)} spin kernels of {2 * len(runs) + 2}, "
                             f"{len(stretches)} runs' work between them of {len(runs)}, "
                             f"{len(device)} device operations in all")
    out = []
    for i, ((label, _), wall) in enumerate(zip(runs, walls)):
        events = device[stretches[i][0] + 1:stretches[i][1]]
        by_name: Dict[str, list] = {}
        for e in events:
            t = by_name.setdefault(e.name(), [0.0, 0])
            t[0] += e.duration_ns() / 1e3
            t[1] += 1
        busy = sum(t for t, _ in by_name.values()) / 1e6
        log(f"{label} profile: wall {wall:.4f} s, device busy {busy:.4f} s ({100 * busy / wall:.1f}%), "
            f"{len(events)} device operations")
        for name, (t, k) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]:
            log(f"  {t / 1e3:9.3f} ms  {k:6d}x  {name[:100]}")
        for name in HAND_WRITTEN:
            ours = [v for k, v in by_name.items() if name in k]
            total, count = sum(t for t, _ in ours), sum(k for _, k in ours)
            log(f"{label} profile: {name} {count} launches, {total / 1e3:.4f} ms in all, "
                f"{total / 1e3 / max(count, 1):.4f} ms each")
            if count != counted[i][HAND_WRITTEN_KEYS[name]]:
                raise AssertionError(f"{label}: the profiler saw {count} {name} launches, its wrapper counted "
                                     f"{counted[i][HAND_WRITTEN_KEYS[name]]}: records were lost")
        out.append({"run": label, "profiled_wall_s": wall, "busy_s": busy, "busy_share": busy / wall,
                    "device_ops": len(events)})
    return out


@contextlib.contextmanager
def timed_subqueries():
    """Adds to the one-element list it yields the host seconds of every
    subquery (scalar, or q45's IN list) that a plan built inside the
    block runs: each goes through ``tpch.queries.collect_columns`` and
    waits for the card before it returns."""
    from blaze_tpu_torch.tpch import queries

    spent = [0.0]
    real = queries.collect_columns

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return real(*args, **kwargs)
        finally:
            spent[0] += time.perf_counter() - t0

    queries.collect_columns = timed
    try:
        yield spent
    finally:
        queries.collect_columns = real


#: the tasks of the plan :func:`timed_build` built last (:func:`plan_tasks`
#: of it before the optimizer), so a caller need not build it again
LAST_BUILD = {"tasks": 0}


def timed_build(torch, query: str, scans, n_parts: int, map_tasks=None, rewrite=None):
    """(the plan of ``query``, seconds to build it, seconds of the
    scalar subqueries it ran while it was built); rewritten by
    ``rewrite`` when given (:func:`map_mode`); optimized (see
    :func:`optimized`) unless ``map_tasks`` is None."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with timed_subqueries() as sub:
        plan = build_plan(query, scans, n_parts)
        if rewrite is not None:
            plan = rewrite(plan)
        LAST_BUILD["tasks"] = plan_tasks(plan)
        if map_tasks is not None:
            plan = optimized(plan, map_tasks)
    return plan, time.perf_counter() - t0, sub[0]


def optimized(plan, map_tasks: int = 4):
    """``plan`` through the task optimizer, as ``run_task`` runs a
    decoded task, with every exchange running ``map_tasks`` map tasks
    at a time."""
    from blaze_tpu_torch.ops.fusion import optimize_plan
    from blaze_tpu_torch.parallel.exchange import NativeShuffleExchangeExec

    def walk(node):
        if isinstance(node, NativeShuffleExchangeExec):
            node.parallel_map_tasks = map_tasks
        for c in node.children:
            walk(c)

    walk(plan)
    return optimize_plan(plan)


#: each query's partial aggs on each path: {query: {"inproc": ...,
#: "run_stages": ...}} of ``ops.agg.PARTIAL_TOTALS`` (skips, rows, batches)
PARTIAL_BY_QUERY: Dict[str, dict] = {}


def partial_totals() -> dict:
    from blaze_tpu_torch.ops import agg as A

    return dict(A.PARTIAL_TOTALS)


def run_query(torch, cuda_ops, query: str, scans, n_parts: int, map_tasks: int = 4, rewrite=None):
    """One query through its plan builder, the optimizer and
    plan.execute, with every launch count and the partial aggs' totals
    (:func:`partial_totals`) reset just before it; the wall includes
    building and optimizing the plan, and so a scalar subquery the plan
    runs; returns (rows, wall, launches, the subqueries' seconds)."""
    from blaze_tpu_torch.ops import agg as A

    A.reset_partial_totals()
    cuda_ops.reset_launch_counts()
    plan, build_s, sub_s = timed_build(torch, query, scans, n_parts, map_tasks, rewrite)
    got, wall = run_plan(torch, plan)
    return got, build_s + wall, dict(cuda_ops.LAUNCHES), sub_s


def log_check(name: str, r: dict) -> None:
    if "ms" not in r:
        log(f"{name} [{r['shape']}]: equal to plain (max_abs_err {r['max_abs_err']})")
        return
    log(f"{name} [{r['shape']}]: equal to plain (max_abs_err {r['max_abs_err']}); "
        f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
        f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}; share of bound {r['bound_ms'] / r['ms']:.0%}), "
        f"library {r['library_ms']} ms")


@contextlib.contextmanager
def largest_inputs(cuda_ops):
    """Keeps the inputs of the calls of ``murmur3_pids``,
    ``sorted_lookup`` and ``pid_histogram`` made inside the block that
    have the most rows (murmur3_pids: per key count; sorted_lookup: the
    most probes and the longest table).  The calls run unchanged."""
    seen: Dict[str, tuple] = {}
    m3, sl, ph = cuda_ops.murmur3_pids, cuda_ops.sorted_lookup, cuda_ops.pid_histogram
    lock = threading.Lock()  # map tasks call from several threads

    def keep(key, size, args):
        with lock:
            if key not in seen or size > seen[key][0]:
                seen[key] = (size, args)

    def murmur3_pids(planes, widths, valids, n_parts):
        keep(f"murmur3_pids {len(planes)} keys", planes[0].shape[0], (planes, widths, valids, n_parts))
        return m3(planes, widths, valids, n_parts)

    def sorted_lookup(table, probe):
        keep("sorted_lookup most probes", probe.shape[0], (table, probe))
        keep("sorted_lookup longest table", table.shape[0], (table, probe))
        return sl(table, probe)

    def pid_histogram(pids, n_parts):
        keep("pid_histogram most rows", pids.shape[0], (pids, n_parts))
        return ph(pids, n_parts)

    cuda_ops.murmur3_pids, cuda_ops.sorted_lookup, cuda_ops.pid_histogram = murmur3_pids, sorted_lookup, pid_histogram
    try:
        yield seen
    finally:
        cuda_ops.murmur3_pids, cuda_ops.sorted_lookup, cuda_ops.pid_histogram = m3, sl, ph


_ORACLES: Dict[tuple, object] = {}
# host seconds of each oracle's one run, by (tables, query)
ORACLE_SECONDS: Dict[tuple, float] = {}


def oracle_fn(query: str):
    from blaze_tpu_torch.tpcds import oracle as DO
    from blaze_tpu_torch.tpch import oracle as O

    return getattr(DO, f"oracle_{query[3:]}") if query.startswith("ds_") else getattr(O, f"oracle_{query}")


def oracle(data, query: str):
    """The query's numpy oracle on ``data``, computed once a run (q01's
    takes seconds at SF1, and both paths are held to it): taken from a
    reference worker where ``data`` was registered with one
    (:func:`register_tables`), else computed here."""
    key = (id(data), query)
    if key not in _ORACLES:
        made = REFERENCES.take(("oracle", *TABLE_RECIPES[id(data)][1:], query)) if id(data) in TABLE_RECIPES else None
        if made is None:
            t0 = time.perf_counter()
            made = oracle_fn(query)(data), time.perf_counter() - t0
        _ORACLES[key], ORACLE_SECONDS[key] = made
    return _ORACLES[key]


# ------------------------------------------ host references in worker processes
#
# The numpy oracles and the port's CPU evaluations are host work that
# needs no card: at SF1 they took about a sixth of the smoke's seconds
# on the host thread that drives the card.  Worker processes (spawned,
# the card hidden from them, one torch thread each) build the same host
# tables from the same seeds and compute them from the start of the
# run, in the order the phases need them; the main process waits only
# where one is not done yet.  Every check still holds the card's rows
# to the same reference.

#: the main process's host tables that a worker builds too: id -> (the
#: tables, kept alive so that no other object takes their id; recipe;
#: variant)
TABLE_RECIPES: Dict[int, tuple] = {}


def register_tables(data: dict, recipe: tuple, variant: str) -> None:
    TABLE_RECIPES[id(data)] = (data, recipe, variant)


def recipe_tables(recipe: tuple) -> dict:
    """The host tables of ``recipe``, by variant, built as the main
    process builds them: ("tpch", scale), ("tpcds", scale), ("files",
    scale) or ("functions", scale, host scale)."""
    from blaze_tpu_torch.tpch import datagen

    kind, scale = recipe[:2]
    if kind == "tpch":
        plain = query_data(TPCH_QUERIES + NEW_QUERIES, scale, ds=False)
        return {"plain": plain, "spec": spec_data(plain, scale)}
    if kind == "tpcds":
        return {"plain": query_data(ALL_DS_QUERIES, scale, ds=True)}
    if kind == "files":
        plain = datagen.generate_all(scale)
        return {"plain": plain, "spec": datagen.with_spec_columns(plain, scale)}
    return {"lineitem": datagen.generate_table("lineitem", scale), "part": datagen.generate_table("part", scale),
            "host": {name: datagen.generate_table(name, recipe[2]) for name in ("customer", "part")}}


_WORKER_TABLES: Dict[tuple, dict] = {}


def reference_worker_init(repo: str) -> None:
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    sys.path.insert(0, repo)
    import torch

    torch.set_num_threads(1)


def reference_job(job: tuple) -> tuple:
    """One host reference, in a worker: (its result, its seconds).  Jobs:
    ("oracle", recipe, variant, query), ("family", recipe, family, table,
    n_parts, batch_rows), ("object agg", recipe, label, n_parts,
    batch_rows), ("zstd files", recipe, fmt, directory, n_parts,
    batch_rows)."""
    kind, recipe, *rest = job
    if recipe not in _WORKER_TABLES:
        _WORKER_TABLES[recipe] = recipe_tables(recipe)
    tables = _WORKER_TABLES[recipe]
    t0 = time.perf_counter()
    if kind == "oracle":
        variant, query = rest
        out = oracle_fn(query)(tables[variant])
    elif kind == "family":
        out = family_cpu_arrays({"lineitem": tables["lineitem"], **tables["host"]}, *rest)
    elif kind == "zstd files":
        out = write_zstd_files(tables["plain"], *rest)
    else:
        out = object_agg_cpu_rows({"lineitem": tables["lineitem"], "part": tables["part"]}, *rest)
    return out, time.perf_counter() - t0


class References:
    """Host references computed by worker processes: :meth:`start`
    submits jobs to a pool of its own, :meth:`take` waits for one's
    result (None for a job never submitted), :meth:`close` stops every
    worker."""

    def __init__(self):
        self.pools, self.futures = [], {}

    def start(self, workers: int, jobs) -> None:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor

        pool = ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn"),
                                   initializer=reference_worker_init, initargs=(str(REPO),))
        self.pools.append(pool)
        for job in jobs:
            self.futures[job] = pool.submit(reference_job, job)

    def take(self, job: tuple):
        future = self.futures.pop(job, None)
        return None if future is None else future.result()

    def close(self) -> None:
        for pool in self.pools:
            pool.shutdown(wait=True, cancel_futures=True)
        self.pools, self.futures = [], {}


REFERENCES = References()


def start_references(scale: float, ds_scale: float, n_parts: int, batch_rows: int, zstd_dir: str) -> None:
    """Starts the reference workers, each pool's jobs in the order the
    phases ask for them: three workers for the TPC-H oracles at
    ``scale`` (the first phases'), two for the TPC-DS oracles at
    ``ds_scale``, then the file phase's oracles and the functions
    phase's CPU evaluations; two more write the map/zstd phase's zstd
    parquet and ORC files under ``zstd_dir`` (host work: the port's
    zstd encoder is python)."""
    tpch = ("tpch", scale)
    REFERENCES.start(3, [("oracle", tpch, "plain", q) for q in TPCH_QUERIES]
                     + [("oracle", tpch, "spec", q) for q in NEW_QUERIES])
    files, fns = ("files", FILE_SCALE), ("functions", FN_SCALE, FN_HOST_SCALE)
    REFERENCES.start(2, [("oracle", ("tpcds", ds_scale), "plain", q) for q in ALL_DS_QUERIES]
                     + [("oracle", files, "plain", q) for q in TPCH_QUERIES]
                     + [("oracle", files, "spec", q) for q in NEW_QUERIES]
                     + [("object agg", fns, label, n_parts, batch_rows) for label, *_ in OBJECT_AGG_RUNS]
                     + [("family", fns, family, table, n_parts, batch_rows) for family, table, *_ in function_families()])
    REFERENCES.start(2, [zstd_files_job(fmt, zstd_dir, n_parts, batch_rows) for fmt in ("parquet", "orc")])


def check_oracle(data, query: str, got: dict) -> str:
    """Raises unless ``got`` equals the query's numpy oracle: exactly
    for integers and unscaled decimals (top-N rows as sets, in their
    sort order: ties may order differently); q14 also to the exact HALF_UP
    quotient of the oracle's sums (its oracle divides in float64, within
    one unit); TPC-DS q07's decimal averages within one unit at the
    HALF_UP boundary and its int average within 1e-9, as the
    reference's own tests allow.  Says what matched."""
    exp = oracle(data, query)

    def need(ok: bool, what) -> None:
        if not ok:
            raise AssertionError(f"{query}: {what}")

    if query in ("q6", "q19"):
        need(got["revenue"] == [exp] and exp > 0, f"{got['revenue']} != oracle {exp}")
        return f"revenue {exp} (unscaled, scale 4) = oracle"
    if query == "q1":
        keys = list(zip(got["l_returnflag"], got["l_linestatus"]))
        need(keys == sorted(exp), f"groups {keys} != oracle {sorted(exp)}")
        for i, key in enumerate(keys):
            row = {m: got[m][i] for m in exp[key]}
            need(row == exp[key], f"group {key}: {row} != oracle {exp[key]}")
        return f"{len(keys)} groups = oracle"
    if query in ("q3", "q10"):
        key, n = ("l_orderkey", 10) if query == "q3" else ("c_custkey", 20)
        rows = list(zip(got[key], got["revenue"]))
        want = {(r[0], r[1]) for r in exp} if query == "q3" else {(r[0], r[4]) for r in exp}
        need(len(rows) == len(exp) == n and set(rows) == want, f"{rows} != oracle {sorted(want)}")
        need([r[1] for r in rows] == sorted((r[1] for r in rows), reverse=True), "rows not in descending revenue")
        if query == "q10":
            by_key = {e[0]: e for e in exp}
            need(all((r[0], r[1], r[2], r[3], r[4]) == by_key[r[0]] for r in zip(
                got["c_custkey"], got["c_name"], got["c_acctbal"], got["n_name"], got["revenue"])),
                "customer columns != oracle")
        return f"top {len(rows)} = oracle"
    if query == "q4":
        need(dict(zip(got["o_orderpriority"], got["order_count"])) == exp and got["o_orderpriority"] == sorted(exp),
             f"{got} != oracle {exp}")
        return f"{len(exp)} priorities, {sum(exp.values())} orders = oracle"
    if query == "q5":
        need(dict(zip(got["n_name"], got["revenue"])) == exp and got["revenue"] == sorted(exp.values(), reverse=True),
             f"{got} != oracle {exp}")
        return f"{len(exp)} nations = oracle"
    if query == "q12":
        rows = {m: [h, lo] for m, h, lo in zip(got["l_shipmode"], got["high_line_count"], got["low_line_count"])}
        need(rows == exp and got["l_shipmode"] == sorted(exp), f"{rows} != oracle {exp}")
        return f"{len(exp)} ship modes = oracle"
    if query == "q14":
        pct, sp, sr = exp
        exact = (2 * 10**8 * sp + sr) // (2 * sr)
        need(got["promo_revenue"] == [exact] and abs(exact - pct) <= 1 and sp > 0,
             f"{got['promo_revenue']} != {exact} (oracle sums {sp} / {sr}; float oracle {pct})")
        return f"promo_revenue {exact} (unscaled, scale 6) = 10^8 sp / sr of the oracle's sums"
    if query in NEW_QUERIES:
        return check_new_query(query, got, exp, need)
    if query in WINDOW_QUERIES + ROLLUP_UNION_QUERIES + EXISTS_STDDEV_QUERIES + REPORT_QUERIES + JOINED_QUERIES:
        from blaze_tpu_torch.tpcds.oracle import check_query

        return check_query(query[3:], got, exp)
    if query == "ds_q3":
        rows = list(zip(got["d_year"], got["brand_id"], got["brand"], got["sum_agg"]))
        need(len(rows) == min(len(exp), 100) and all(exp.get(r[:3]) == r[3] for r in rows),
             f"{rows[:5]}... != oracle")
        need(rows == sorted(rows, key=lambda r: (r[0], -r[3], r[1])), "rows out of order")
        return f"{len(rows)} of {len(exp)} groups = oracle"
    ids = got["i_item_id"]
    need(ids == sorted(ids) and len(ids) == min(len(exp), 100), f"items {ids[:5]}... != oracle")
    for i, iid in enumerate(ids):
        e = exp[iid]
        need(abs(got["agg1"][i] - e[0]) < 1e-9, f"{iid} agg1 {got['agg1'][i]} != {e[0]}")
        for k, m in enumerate(("agg2", "agg3", "agg4"), start=1):
            need(abs(got[m][i] - e[k]) <= 1, f"{iid} {m} {got[m][i]} != {e[k]}")
    return f"{len(ids)} of {len(exp)} items = oracle"


def check_new_query(query: str, got: dict, exp, need) -> str:
    """The rest of TPC-H against its oracle, on a nonempty result:
    integers and unscaled decimals exactly, q08's shares within 1e-9
    absolute and q17's average within 1e-9 relative (the reference
    tests' tolerances); q02, q18 and q21 as ordered rows where their
    sort keys order them totally, and as sets within ties."""
    need(bool(exp) and bool(next(iter(got.values()))), f"empty result (oracle {exp!r:.200})")

    def ordered(rows, want, key):
        need([key(r) for r in rows] == [key(w) for w in want], f"sort keys {rows[:3]}... != oracle {want[:3]}...")
        need(sorted(rows, key=repr) == sorted(want, key=repr), f"rows {rows[:3]}... != oracle {want[:3]}...")

    if query == "q2":
        rows = list(zip(got["s_acctbal"], got["s_name"], got["n_name"], got["p_partkey"], got["p_mfgr"]))
        ordered(rows, exp, lambda r: (-r[0], r[2], r[1], r[3]))
        return f"{len(rows)} rows = oracle, in order"
    if query == "q7":
        keys = list(zip(got["supp_nation"], got["cust_nation"], got["l_year"]))
        need(dict(zip(keys, got["revenue"])) == exp and keys == sorted(exp), f"{got} != oracle {exp}")
        return f"{len(exp)} groups = oracle"
    if query == "q8":
        need(got["o_year"] == sorted(exp), f"years {got['o_year']} != oracle {sorted(exp)}")
        for y, share in zip(got["o_year"], got["mkt_share"]):
            need(abs(share - exp[y]) < 1e-9, f"{y}: mkt_share {share!r} != oracle {exp[y]!r}")
        return f"{len(exp)} years = oracle within 1e-9 ({got['mkt_share']})"
    if query == "q9":
        keys = list(zip(got["nation"], got["o_year"]))
        need(dict(zip(keys, got["sum_profit"])) == exp and keys == sorted(keys, key=lambda k: (k[0], -k[1])),
             "groups != oracle")
        return f"{len(exp)} groups = oracle"
    if query == "q11":
        need(dict(zip(got["ps_partkey"], got["value"])) == exp
             and got["value"] == sorted(got["value"], reverse=True), "parts != oracle")
        return f"{len(exp)} parts = oracle"
    if query == "q13":
        rows = list(zip(got["custdist"], got["c_count"]))
        need(dict(zip(got["c_count"], got["custdist"])) == exp and rows == sorted(rows, reverse=True),
             f"{rows} != oracle {exp}")
        return f"{len(exp)} order counts = oracle ({exp.get(0, 0)} customers with none)"
    if query == "q15":
        need(list(zip(got["s_suppkey"], got["s_name"], got["total_revenue"])) == exp, f"{got} != oracle {exp}")
        return f"supplier {exp[0][0]} = oracle"
    if query == "q16":
        need({(b, t, z): c for b, t, z, c in zip(got["p_brand"], got["p_type"], got["p_size"],
                                                  got["supplier_cnt"])} == exp
             and got["supplier_cnt"] == sorted(got["supplier_cnt"], reverse=True), "groups != oracle")
        return f"{len(exp)} groups = oracle"
    if query == "q17":
        v = got["avg_yearly"]
        need(len(v) == 1 and exp > 0 and abs(v[0] - exp) / exp < 1e-9, f"{v} != oracle {exp!r}")
        return f"avg_yearly {v[0]!r} = oracle within 1e-9"
    if query == "q18":
        rows = list(zip(got["c_name"], got["c_custkey"], got["o_orderkey"], got["o_orderdate"], got["o_totalprice"],
                        got["qsum"]))
        ordered(rows, exp, lambda r: (-r[4], r[3]))
        return f"{len(rows)} orders = oracle, in order"
    if query == "q20":
        need(list(zip(got["s_name"], got["s_address"])) == exp, f"{got} != oracle {exp}")
        return f"{len(exp)} suppliers = oracle"
    if query == "q21":
        rows = list(zip(got["s_name"], got["numwait"]))
        want = sorted(exp.items(), key=lambda kv: (-kv[1], kv[0]))[:100]
        ordered(rows, want, lambda r: (-r[1], r[0]))
        return f"top {len(rows)} of {len(exp)} suppliers = oracle"
    need(got["cntrycode"] == sorted(exp) and {c: [n, t] for c, n, t in zip(
        got["cntrycode"], got["numcust"], got["totacctbal"])} == exp, f"{got} != oracle {exp}")
    return f"{len(exp)} country codes = oracle"


def run_scheduled(torch, cuda_ops, query: str, scans, n_parts: int, rewrite=None):
    """One query through split_stages + run_stages, every task from its
    TaskDefinition bytes, with the launch, copy and verified-frame counts
    reset just before it; returns (rows, wall, launches, what moved)."""
    from blaze_tpu_torch import batch as B
    from blaze_tpu_torch.runtime import integrity
    from blaze_tpu_torch.runtime.context import RESOURCES
    from blaze_tpu_torch.runtime.scheduler import RunStats, split_stages

    from blaze_tpu_torch.ops import agg as A

    # a scalar subquery runs in process while the plan is built: its
    # launches count, its seconds join the wall
    A.reset_partial_totals()
    cuda_ops.reset_launch_counts()
    plan, build_s, sub_s = timed_build(torch, query, scans, n_parts, rewrite=rewrite)
    stages, manager = split_stages(plan)
    stats = RunStats()
    B.reset_copy_counts()
    integrity.COUNTS["frames_verified"] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    batches = run_clean(query, stages, manager, stats)
    torch.cuda.synchronize()
    wall = build_s + time.perf_counter() - t0
    launches = dict(cuda_ops.LAUNCHES)
    if len(RESOURCES) or os.path.exists(manager.root):
        raise AssertionError(f"{query}: run_stages left resources {RESOURCES.keys()} or {manager.root}")
    out = {f.name: [] for f in stages[-1].plan.schema.fields}
    for b in batches:
        for k, v in B.batch_to_pydict(b).items():
            out[k].extend(v)
    moved = {"stages": len(stages), "tasks": stats.tasks, "kinds": [s.kind for s in stages],
             "task_def_bytes": stats.task_def_bytes, "data_bytes": stats.data_bytes,
             "blocks_read": stats.blocks, "broadcast_bytes": stats.broadcast_bytes,
             "frames_verified": integrity.COUNTS["frames_verified"], **B.COPIES,
             "stage_seconds": stats.stage_seconds, "subquery_s": sub_s, "partial": partial_totals()}
    return out, wall, launches, moved


# the A/B phase: the pipeline unfused and serial against the defaults, as
# (label, spark.blaze.fusion.enabled, spark.blaze.shuffle.asyncWrite,
# map tasks at a time in an exchange, spark.blaze.stage.taskConcurrency);
# column pruning runs under every setting, as in the reference
# q01 in process and q21 through run_stages, where zlib takes most of
# the wall: the two findings the A/B phase is kept for
AB_QUERIES = ("q1", "q21")
AB_SETTINGS = (("unfused, 1 task", False, False, 1, 1), ("defaults, 4 tasks", True, True, 4, 4),
               # the defaults one task at a time: what the map tasks' threads do apart
               ("defaults, 1 task", True, True, 1, 1))


@contextlib.contextmanager
def pipeline_conf(fusion: bool, async_write: bool, task_concurrency: int):
    """The pipeline's conf entries set for the block, restored after."""
    from blaze_tpu_torch import conf

    entries = (conf.FUSION_ENABLE, conf.SHUFFLE_ASYNC_WRITE, conf.STAGE_TASK_CONCURRENCY)
    saved = [e.get() for e in entries]
    for e, v in zip(entries, (fusion, async_write, task_concurrency)):
        e.set(v)
    try:
        yield
    finally:
        for e, v in zip(entries, saved):
            e.set(v)


def ab_phase(torch, cuda_ops, card: str, scans, datas, n_parts: int) -> list:
    """Each of AB_QUERIES on both paths under every AB_SETTINGS, timed
    once each in turns (A, B, C), every run held to the oracle; then one
    untimed run a setting counts the syncs with the card.  The two
    paths must launch each kernel as often under one setting.  Returns
    one dict a (query, path, setting); the profiled runs are in the
    last phase."""
    out = []
    for query in AB_QUERIES:
        launches_of = {}
        for path in ("in process", "run_stages"):
            walls = {label: [] for label, *_ in AB_SETTINGS}
            last = {}
            for label, fusion, async_write, map_tasks, tasks in AB_SETTINGS:
                with pipeline_conf(fusion, async_write, tasks):
                    if path == "in process":
                        got, wall, launches, _ = run_query(torch, cuda_ops, query, scans[query], n_parts, map_tasks)
                        moved = {}
                    else:
                        got, wall, launches, moved = run_scheduled(torch, cuda_ops, query, scans[query], n_parts)
                check_oracle(datas[query], query, got)
                walls[label].append(wall)
                last[label] = (launches, moved)
            for label, fusion, async_write, map_tasks, tasks in AB_SETTINGS:
                with pipeline_conf(fusion, async_write, tasks):
                    if path == "in process":
                        run = lambda: run_query(torch, cuda_ops, query, scans[query], n_parts, map_tasks)  # noqa: E731
                    else:
                        run = lambda: run_scheduled(torch, cuda_ops, query, scans[query], n_parts)  # noqa: E731
                    syncs, _ = count_syncs(torch, run)
                launches, moved = last[label]
                launches_of[(path, label)] = launches
                r = {"query": query_label(query), "path": path, "setting": label, "walls_s": walls[label],
                     "syncs": syncs, "launches": launches, "card": card,
                     **{k: moved[k] for k in ("data_bytes", "device_to_host", "tasks", "stage_seconds")
                        if k in moved}}
                log(f"A/B {query_label(query)} {path}, {label}: = oracle in every run; walls "
                    f"{', '.join(f'{w:.4f}' for w in walls[label])} s, {syncs} syncs with the card"
                    + (f", .data bytes {moved['data_bytes']}, device-to-host copies {moved['device_to_host']}"
                       if moved else "") + f"; launches {launches}; on {card}")
                log("ab " + json.dumps(r))
                out.append(r)
        for label, *_ in AB_SETTINGS:
            if launches_of[("in process", label)] != launches_of[("run_stages", label)]:
                raise AssertionError(f"A/B {query}, {label}: in process launched {launches_of[('in process', label)]}, "
                                     f"run_stages {launches_of[('run_stages', label)]}")
    return out


# joins whose code the TPC-H queries leave off the card: (join type, how
# planned, key count, build rows); the build is the right side, the
# probe the left
JOIN_CASES = (("FULL", "shuffled", 2, 1 << 16), ("RIGHT_ANTI", "shuffled", 1, 1 << 16),
              ("RIGHT_SEMI", "shuffled", 2, 1 << 16), ("EXISTENCE", "shuffled", 1, 1 << 16),
              ("RIGHT", "broadcast", 2, 1 << 16), ("FULL", "shuffled", 1, 0))


def join_tables(n_left: int, n_right: int, seed: int):
    """Left keys in [0, 40000), right keys in [10000, 60000) with
    duplicates, nulls in both first keys and in the left value."""
    import numpy as np

    rng = np.random.default_rng(seed)
    left = {"lk": (rng.integers(0, 40000, n_left), None, rng.random(n_left) > 0.05),
            "lk2": (rng.integers(0, 3, n_left).astype(np.int32), None, None),
            "lv": (rng.integers(-(10**9), 10**9, n_left), None, rng.random(n_left) > 0.2)}
    right = {"rk": (rng.integers(10000, 60000, n_right), None, rng.random(n_right) > 0.05),
             "rk2": (rng.integers(0, 3, n_right).astype(np.int32), None, None),
             "rv": (rng.integers(0, 100, n_right).astype(np.int32), None, None)}
    return left, right


def join_oracle(kind: str, left: dict, right: dict, n_keys: int) -> list:
    """The join's rows from Python lists, the right side building: a
    null key never matches; RIGHT_SEMI/RIGHT_ANTI keep build rows,
    EXISTENCE every probe row with a flag."""
    def rows(t):
        cols = [[int(x) if ok else None for x, ok in zip(v.tolist(), (m if m is not None else [True] * len(v)))]
                for v, _, m in t.values()]
        return list(zip(*cols)) if cols[0] else []

    lrows, rrows = rows(left), rows(right)
    index: Dict[tuple, list] = {}
    for j, r in enumerate(rrows):
        if None not in r[:n_keys]:
            index.setdefault(r[:n_keys], []).append(j)
    out, build_hit = [], [False] * len(rrows)
    null_l, null_r = (None,) * len(left), (None,) * len(right)
    for r in lrows:
        js = index.get(r[:n_keys], ()) if None not in r[:n_keys] else ()
        for j in js:
            build_hit[j] = True
        if kind == "EXISTENCE":
            out.append(r + (bool(js),))
        elif kind in ("FULL", "RIGHT"):
            out += [r + rrows[j] for j in js]
            if kind == "FULL" and not js:
                out.append(r + null_r)
    if kind in ("FULL", "RIGHT"):
        out += [null_l + rr for rr, hit in zip(rrows, build_hit) if not hit]
    elif kind in ("RIGHT_SEMI", "RIGHT_ANTI"):
        out += [rr for rr, hit in zip(rrows, build_hit) if hit == (kind == "RIGHT_SEMI")]
    return out


def check_build_preserving_joins(cuda_ops, device: str, n_parts: int, n_left: int, seed: int) -> list:
    """The join types that output build rows (FULL, RIGHT, RIGHT_SEMI,
    RIGHT_ANTI) and EXISTENCE, on ``device``, each held to
    :func:`join_oracle`; a FULL join with no build rows takes the
    no-map path.  Each case's launch counts are reset before it, and it
    must launch the kernels its plan calls.  A broadcast join that
    outputs build rows must refuse more than one probe partition.
    Returns one line per case."""
    from blaze_tpu_torch.batch import batch_to_pydict, table_to_batches
    from blaze_tpu_torch.exprs import col
    from blaze_tpu_torch.ops import MemoryScanExec
    from blaze_tpu_torch.ops.joins import JoinType
    from blaze_tpu_torch.runtime.context import TaskContext
    from blaze_tpu_torch.schema import DataType, Field, Schema
    from blaze_tpu_torch.tpch import queries

    lschema = Schema([Field("lk", DataType.int64()), Field("lk2", DataType.int32()), Field("lv", DataType.int64())])
    rschema = Schema([Field("rk", DataType.int64()), Field("rk2", DataType.int32()), Field("rv", DataType.int32())])
    lines = []
    for i, (kind, planned, n_keys, n_right) in enumerate(JOIN_CASES):
        left, right = join_tables(n_left, n_right, seed + i)
        probe_parts = 1 if planned == "broadcast" else n_parts
        lscan = MemoryScanExec(table_to_batches(left, lschema, probe_parts, 1 << 16, device=device), lschema,
                               device=device)
        rscan = MemoryScanExec(table_to_batches(right, rschema, n_parts, 1 << 16, device=device), rschema,
                               device=device)
        lkeys, rkeys = [col("lk"), col("lk2")][:n_keys], [col("rk"), col("rk2")][:n_keys]
        cuda_ops.reset_launch_counts()
        if planned == "shuffled":
            plan = queries.shuffle_join(lscan, rscan, lkeys, rkeys, JoinType[kind], n_parts, build_left=False)
            need = ("murmur3_pids", "pid_histogram") + (("sorted_lookup",) if n_right else ())
        else:
            plan = queries.broadcast_join(rscan, lscan, rkeys, lkeys, JoinType[kind], build_is_left=False)
            need = ("sorted_lookup",)
        got = []
        for p in range(plan.num_partitions()):
            for b in plan.execute(p, TaskContext(p, plan.num_partitions())):
                got += list(zip(*batch_to_pydict(b).values()))
        launches = dict(cuda_ops.LAUNCHES)
        want = join_oracle(kind, left, right, n_keys)
        if not want or sorted(got, key=repr) != sorted(want, key=repr):
            raise AssertionError(f"{kind} join ({planned}, {n_keys} keys, {n_right} build rows): "
                                 f"{len(got)} rows, the oracle {len(want)}")
        require_launches(f"{kind} join ({planned})", launches, need)
        lines.append(f"{kind} join ({planned}, {n_keys} keys, {n_left} probe x {n_right} build rows): "
                     f"= oracle, {len(got)} rows; launches {launches}")
    wide = MemoryScanExec(table_to_batches(left, lschema, n_parts, 1 << 16, device=device), lschema,
                          device=device)
    try:
        queries.broadcast_join(rscan, wide, [col("rk")], [col("lk")], JoinType.FULL, build_is_left=False)
    except NotImplementedError:
        lines.append(f"a FULL broadcast join over {n_parts} probe partitions raises")
    else:
        raise AssertionError(f"a FULL broadcast join over {n_parts} probe partitions was built")
    return lines


def count_syncs(torch, fn, host_profile: bool = False):
    """Runs ``fn`` once, untimed, with CUDA's sync debug mode warning on
    every operation that waits for the card; returns the warnings and,
    with ``host_profile``, the host functions that took the most time
    under cProfile (else None)."""
    import cProfile
    import io
    import pstats
    import warnings

    prof = cProfile.Profile() if host_profile else None
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            if prof:
                prof.enable()
            fn()
            if prof:
                prof.disable()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    if not prof:
        return syncs, None
    text = io.StringIO()
    pstats.Stats(prof, stream=text).sort_stats("tottime").print_stats(10)
    return syncs, "\n".join(line for line in text.getvalue().splitlines() if line.strip())


def require_launches(query: str, launches: dict, launched, not_launched=()) -> None:
    for name in launched:
        if launches[name] <= 0:
            raise AssertionError(f"{query} never launched {name}: {launches}")
    for name in not_launched:
        if launches[name] != 0:
            raise AssertionError(f"{query} launched {name}: {launches}")


def plan_tasks(plan) -> int:
    """The tasks an in-process run of ``plan`` runs, counted as the stage
    scheduler counts them: every exchange's and broadcast's map tasks
    (its child's partitions) and the root's partitions."""
    from blaze_tpu_torch.parallel.broadcast import BroadcastExchangeExec
    from blaze_tpu_torch.parallel.exchange import NativeShuffleExchangeExec

    seen = set()

    def walk(node) -> int:
        if id(node) in seen:  # an exchange two parents share runs once
            return 0
        seen.add(id(node))
        n = sum(walk(c) for c in node.children)
        if isinstance(node, (NativeShuffleExchangeExec, BroadcastExchangeExec)):
            n += node.children[0].num_partitions()
        return n

    return walk(plan) + plan.num_partitions()


def same_rows(a: dict, b: dict, rel: float = 0.0) -> bool:
    """The same columns and the same rows as multisets (rows that tie on
    every sort key may come in another order); doubles within ``rel``
    relative (0: exactly)."""
    def close(x, y):
        if isinstance(x, float) and isinstance(y, float) and rel:
            return x == y or abs(x - y) <= rel * max(abs(x), abs(y))
        return x == y

    def key(row):
        return tuple(format(v, ".9g") if isinstance(v, float) and rel else repr(v) for v in row)

    if list(a) != list(b):
        return False
    ra, rb = sorted(zip(*a.values()), key=key), sorted(zip(*b.values()), key=key)
    return len(ra) == len(rb) and all(close(x, y) for r, t in zip(ra, rb) for x, y in zip(r, t))


def ds_phase(torch, cuda_ops, card: str, label: str, queries, data, scale: float, n_parts: int, batch_rows: int,
             runs: dict, sched_runs: dict, scheduled=None) -> list:
    """TPC-DS ``queries`` on both paths, one query at a time (its scans
    staged before it and dropped after): in process through the
    optimizer, then through split_stages/run_stages, each equal to its
    oracle on a nonempty result, the two paths' rows alike (as
    multisets: rows that tie on every sort key may come in another
    order; q18's doubles within 1e-9 relative) and their launches
    equal; ``runs`` and ``sched_runs`` get each query's launch counts.
    Only the queries in ``scheduled`` (None: all) take the second path;
    the others run in process alone (their records' ``run_stages_*``
    fields None).
    Prints each query's walls, tasks, ``.data`` bytes, launches and the
    card's peak memory on each path, and how far each peak rose above
    what the run held before the query's scans were staged.  Returns
    one record per query."""
    out = []
    for query in queries:
        held = torch.cuda.memory_allocated()
        scans = query_scans(data, query, n_parts, batch_rows)
        torch.cuda.reset_peak_memory_stats()
        got, wall, runs[query], sub_s = run_query(torch, cuda_ops, query, scans, n_parts)
        ipartial = partial_totals()
        peak = torch.cuda.max_memory_allocated()
        said = check_oracle(data, query, got)
        require_launches(query_label(query), runs[query], *EXPECTED_LAUNCHES[query])
        tasks = LAST_BUILD["tasks"]  # of run_query's build: no second build, no second subquery
        key = query_label(query) if query_label(query) not in PARTIAL_BY_QUERY else f"{query_label(query)} SF{scale}"
        launches = {k: runs[query][k] for k in ("murmur3_pids", "pid_histogram", "sorted_lookup")}
        sub = f" (its scalar subquery {sub_s:.4f} s of it)" if query in SUBQUERY_QUERIES else ""
        oracle_s = ORACLE_SECONDS[(id(data), query)]
        said = (f"{query_label(query)} SF{scale} (8 partitions, 2^20-row batches): {said} (oracle {oracle_s:.2f} s "
                f"on the host); in process wall {wall:.4f} s{sub}, {tasks} tasks, .data bytes 0 (exchanges kept on "
                f"the card), peak device memory {peak / 2**20:.1f} MiB ({(peak - held) / 2**20:.1f} above the "
                f"{held / 2**20:.1f} held before)")
        swall = speak = None
        moved = {"tasks": None, "data_bytes": None, "kinds": None, "partial": None}
        both = scheduled is None or query in scheduled
        if both:
            torch.cuda.reset_peak_memory_stats()
            sgot, swall, sched_runs[query], moved = run_scheduled(torch, cuda_ops, query, scans, n_parts)
            speak = torch.cuda.max_memory_allocated()
            check_oracle(data, query, sgot)
            if not same_rows(sgot, got, 1e-9 if query in FLOAT_SUM_QUERIES else 0.0):
                raise AssertionError(f"{query} through run_stages: {sgot} != in process {got}")
            if sched_runs[query] != runs[query]:
                raise AssertionError(f"{query} through run_stages launched {sched_runs[query]}, in process "
                                     f"{runs[query]}")
            said += (f"; through run_stages = oracle and = in process, wall {swall:.4f} s, {moved['tasks']} tasks, "
                     f".data bytes {moved['data_bytes']}, peak device memory {speak / 2**20:.1f} MiB "
                     f"({(speak - held) / 2**20:.1f} above)")
        PARTIAL_BY_QUERY[key] = {"inproc": ipartial, "run_stages": moved["partial"], "data_bytes": moved["data_bytes"]}
        log(f"{said}; on {card}; launches {launches}{' on each path' if both else ''}; partial aggs "
            f"{ipartial} in process" + (f", {moved['partial']} through run_stages" if both else ""))
        exp = oracle(data, query)
        rec = {"query": query_label(query), "scale": scale, "rows": len(next(iter(got.values()))),
               "oracle_rows": len(exp) if isinstance(exp, (dict, list, set)) else None,
               "inproc_wall_s": wall, "inproc_tasks": tasks, "held_bytes": held, "inproc_peak_bytes": peak,
               "run_stages_wall_s": swall, "run_stages_tasks": moved["tasks"], "run_stages_peak_bytes": speak,
               "data_bytes": moved["data_bytes"], "stages": moved["kinds"], "launches": launches,
               "subquery_s": sub_s, "oracle_s": oracle_s, "inproc_partial": ipartial,
               "run_stages_partial": moved["partial"], "card": card}
        log(f"{label} " + json.dumps(rec))
        out.append(rec)
        del scans
    return out


NULL_KEY_CHECKS = ("is null", "null group", "inner join", "left join")


def null_key_plan(check: str, sales, customer, n_parts: int):
    """One of the four checks of the null-key phase over the scans
    ``sales`` (``ss_customer_sk``, null keys) and ``customer``."""
    from blaze_tpu_torch.exprs import col
    from blaze_tpu_torch.ops import AggFunction, FilterExec, GroupingExpr
    from blaze_tpu_torch.ops.joins import JoinType
    from blaze_tpu_torch.tpch.queries import broadcast_join, two_stage_agg

    count = [AggFunction("count_star", None, "n")]
    if check == "is null":
        return two_stage_agg(FilterExec(sales, col("ss_customer_sk").is_null()), [], count, 1)
    if check == "null group":
        return two_stage_agg(sales, [GroupingExpr(col("ss_customer_sk"), "k")], count, n_parts)
    j = broadcast_join(customer, sales, [col("c_customer_sk")], [col("ss_customer_sk")],
                       JoinType.INNER if check == "inner join" else JoinType.LEFT, build_is_left=False)
    if check == "left join":
        j = FilterExec(j, col("c_customer_sk").is_null())
    return two_stage_agg(j, [], count, 1)


def null_key_phase(torch, cuda_ops, flush, card: str, data, scale: float, n_parts: int, batch_rows: int):
    """``store_sales`` with its -1 customer keys exposed as nulls
    (``with_null_fks``) through split_stages/run_stages: the four checks
    of the reference's end-to-end null-key test, each equal to a numpy
    count, with its launches (counts reset just before each).  Then
    ``murmur3_pids`` on the key column, held to its plain version, its
    null rows in the seed's partition (pmod(42, 8)), and
    ``sorted_lookup`` held to its plain version on the largest table and
    probe the joins gave it.  Returns (launches by check, kernel
    checks)."""
    import numpy as np

    from blaze_tpu_torch.batch import batch_to_pydict, table_to_batches
    from blaze_tpu_torch.ops import MemoryScanExec
    from blaze_tpu_torch.runtime.context import RESOURCES
    from blaze_tpu_torch.runtime.scheduler import split_stages
    from blaze_tpu_torch.schema import Schema
    from blaze_tpu_torch.tpcds import TPCDS_SCHEMAS
    from blaze_tpu_torch.tpcds.datagen import with_null_fks

    ss = with_null_fks({"ss_customer_sk": data["store_sales"]["ss_customer_sk"]}, ["ss_customer_sk"])
    fk, valid = ss["ss_customer_sk"][0], ss["ss_customer_sk"][2]
    customers = data["customer"]["c_customer_sk"][0]
    known = valid & np.isin(fk, customers)
    keys, counts = np.unique(fk[valid], return_counts=True)
    want = {"is null": {None: int((~valid).sum())},
            "null group": {**dict(zip(keys.tolist(), counts.tolist())), None: int((~valid).sum())},
            "inner join": {None: int(known.sum())}, "left join": {None: int((~known).sum())}}
    ss_schema = Schema([TPCDS_SCHEMAS["store_sales"].field("ss_customer_sk")])
    c_schema = Schema([TPCDS_SCHEMAS["customer"].field("c_customer_sk")])
    sales = MemoryScanExec(table_to_batches(ss, ss_schema, n_parts, batch_rows, device="cuda"), ss_schema,
                           device="cuda")
    customer = MemoryScanExec(table_to_batches({"c_customer_sk": data["customer"]["c_customer_sk"]}, c_schema, 1,
                                               batch_rows, device="cuda"), c_schema, device="cuda")
    runs = {}
    with largest_inputs(cuda_ops) as seen:
        for check in NULL_KEY_CHECKS:
            cuda_ops.reset_launch_counts()
            plan = null_key_plan(check, sales, customer, n_parts)
            stages, manager = split_stages(plan)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            batches = run_clean(f"null key {check}", stages, manager)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            runs[check] = dict(cuda_ops.LAUNCHES)
            got: Dict[str, list] = {"k": [], "n": []}
            for b in batches:
                for k, v in batch_to_pydict(b).items():
                    got[k].extend(v)
            rows = dict(zip(got["k"] if check == "null group" else [None] * len(got["n"]), got["n"]))
            if rows != want[check] or len(rows) != len(got["n"]) or len(RESOURCES):
                raise AssertionError(f"null keys, {check}: {len(rows)} rows != numpy's {len(want[check])} "
                                     f"(null row: {rows.get(None)} against {want[check].get(None)})")
            launched = {"null group": ("murmur3_pids", "pid_histogram"),
                        "inner join": ("sorted_lookup",), "left join": ("sorted_lookup",)}.get(check, ())
            require_launches(f"null keys, {check}", runs[check], launched)
            log(f"null keys, {check} (TPC-DS SF{scale} store_sales, {int((~valid).sum())} of {fk.shape[0]} "
                f"customer keys null) through run_stages: = numpy ({len(rows)} rows, null row "
                f"{rows.get(None)}); wall {wall:.4f} s on {card}; launches {runs[check]}")
    # the key column's hash pids on the card: kernel = plain, nulls at the seed
    col = sales._partitions[0][0].columns[0]
    planes, widths = zip(*[cuda_ops.column_word_planes(col)])
    r = check_murmur3(torch, cuda_ops, flush, list(planes), list(widths), [col.validity],
                      f"ss_customer_sk with {int((~col.validity[:sales._partitions[0][0].num_rows]).sum())} nulls",
                      timed=False, n_parts=n_parts)
    pids = cuda_ops.murmur3_pids(list(planes), list(widths), [col.validity], n_parts)
    at_seed = pids[~col.validity]
    if not bool((at_seed == 42 % n_parts).all()):
        raise AssertionError(f"null keys: murmur3_pids put null rows in partitions {at_seed.unique().tolist()}, "
                             f"not the seed's {42 % n_parts}")
    checks = [("murmur3_pids", r)]
    probed = set()
    for key, (_, (table, probe)) in sorted((k, v) for k, v in seen.items() if k.startswith("sorted_lookup")):
        if id(probe) in probed:
            continue
        probed.add(id(probe))
        nulls = int((probe == -1).sum())
        checks.append(("sorted_lookup", check_sorted_lookup(torch, cuda_ops, flush, table, probe,
                                                            f"(null keys, {key[14:]}, {nulls} null probes)",
                                                            timed=False)))
    for name, c in checks:
        log_check(name, c)
    del sales, customer
    return runs, checks


# the file phase: TPC-H read from files the port wrote (io/, the scans, the
# sink, the producer thread); see file_phase
FILE_SCALE = 0.1
ORC_QUERIES = ("q1", "q3", "q6")
SNAPPY_QUERIES, SNAPPY_SCALE = ("q1", "q6"), 0.01
SF1_FILE_QUERIES = ("q6", "q3")
LAUNCH_MATCH_QUERIES = ("q1", "q3", "q6")


@contextlib.contextmanager
def scans_seen():
    """Collects every parquet and ORC scan that runs inside the block, on
    either path (a decoded task's scans too)."""
    from blaze_tpu_torch.ops import OrcScanExec, ParquetScanExec

    seen: Dict[int, tuple] = {}  # id -> (scan, its metrics when first seen in the block)
    lock = threading.Lock()
    reals = {cls: cls.execute for cls in (ParquetScanExec, OrcScanExec)}

    def wrap(real):
        def execute(self, partition, ctx):
            with lock:
                seen.setdefault(id(self), (self, dict(self.metrics.values)))
            return real(self, partition, ctx)
        return execute

    for cls, real in reals.items():
        cls.execute = wrap(real)
    try:
        yield seen
    finally:
        for cls, real in reals.items():
            cls.execute = real


def scan_totals(seen) -> dict:
    """The scans' decode seconds, bytes read and pruned row groups (or
    stripes) in the block, summed (a scan two runs share counts once a
    run)."""
    total = lambda k: sum(s.metrics.values.get(k, 0) - was.get(k, 0) for s, was in seen.values())  # noqa: E731
    return {"decode_s": total("input_io_time") / 1e9, "bytes_read": total("bytes_read"),
            "pruned_row_groups": total("pruned_row_groups") + total("pruned_stripes"), "scans": len(seen)}


def write_tables(tables, names, directory: str, n_parts: int, batch_rows: int, fmt: str = "parquet",
                 codec=None, numeric_only=()) -> dict:
    """``tables[name]`` for each of ``names`` as ``n_parts`` files (one a
    partition, row groups of ``batch_rows``: the memory scans' batches),
    every column the table holds, only its numeric and date ones for a
    table in ``numeric_only``; returns name -> (file groups, schema)."""
    from blaze_tpu_torch.io.table_files import write_table_files
    from blaze_tpu_torch.schema import Schema
    from blaze_tpu_torch.tpch import TPCH_SCHEMAS

    out = {}
    for name in names:
        schema = Schema([f for f in TPCH_SCHEMAS[name].fields if f.name in tables[name]
                         and not (name in numeric_only and f.dtype.is_string)])
        groups = write_table_files(tables[name], schema, os.path.join(directory, fmt, name), n_parts, batch_rows,
                                   fmt, codec, workers=n_parts)
        out[name] = (groups, schema)
    return out


def file_scans(written: dict, fmt: str, batch_rows: int) -> dict:
    """A scan over each written table, staged on the card; the task
    optimizer narrows each to the columns its query reads."""
    from blaze_tpu_torch.ops import OrcScanExec, ParquetScanExec

    cls = ParquetScanExec if fmt == "parquet" else OrcScanExec
    return {name: cls(groups, schema, batch_rows=batch_rows, device="cuda") for name, (groups, schema) in written.items()}


def file_query(torch, cuda_ops, query: str, scans, n_parts: int, path: str) -> tuple:
    """One query over file scans on ``path`` ("in process" or
    "run_stages"), with the launch counts reset just before it: (rows,
    wall, launches, scan totals, peak device memory above what the run
    held before)."""
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with scans_seen() as seen:
        if path == "in process":
            got, wall, launches, _ = run_query(torch, cuda_ops, query, scans, n_parts)
        else:
            got, wall, launches, _ = run_scheduled(torch, cuda_ops, query, scans, n_parts)
    return got, wall, launches, scan_totals(seen), torch.cuda.max_memory_allocated() - held


def file_runs(torch, cuda_ops, card: str, label: str, queries, scans, tables, n_parts: int,
              launches_of: dict) -> dict:
    """``queries`` over ``scans`` on both paths: each equal to its oracle
    on a nonempty result, the paths' rows alike, each launching what
    EXPECTED_LAUNCHES asks; one record per query and path.  (The paths
    may launch apart where the memory scans' paths do: q18 at SF 0.1.)
    Returns the in-process rows by query."""
    rows = {}
    for query in queries:
        qdata = tables[1] if query in NEW_QUERIES else tables[0]
        got = {}
        for path in ("in process", "run_stages"):
            got[path], wall, launches, totals, above = file_query(torch, cuda_ops, query, scans, n_parts, path)
            said = check_oracle(qdata, query, got[path])
            name = f"{query_label(query)} {label}" + (" (run_stages)" if path == "run_stages" else "")
            require_launches(name, launches, *EXPECTED_LAUNCHES[query])
            launches_of[name] = launches
            rec = {"query": query_label(query), "files": label, "path": path, "wall_s": wall, **totals,
                   "peak_above_held_bytes": above, "launches": {k: launches[k] for k in LAUNCH_KEYS}, "card": card}
            log(f"files {query_label(query)} {label} {path}: {said}; wall {wall:.4f} s, decode "
                f"{totals['decode_s']:.4f} s, bytes read {totals['bytes_read']}, pruned row groups "
                f"{totals['pruned_row_groups']}, peak device memory {above / 2**20:.1f} MiB above what the run held; "
                f"on {card}; launches {rec['launches']}")
            log("files " + json.dumps(rec))
        if not same_rows(got["run_stages"], got["in process"]):
            raise AssertionError(f"{query} {label} through run_stages: {got['run_stages']} != in process")
        rows[query] = got["in process"]
    return rows


LAUNCH_KEYS = ("murmur3_pids", "pid_histogram", "sorted_lookup")


def sink_round_trip(torch, query_rows: dict, scans, n_parts: int, directory: str) -> str:
    """q03 over ``scans`` on the card, written through ParquetSinkExec by
    o_shippriority, read back through ParquetScanExec: the rows must be
    q03's (the partition column from the directory names)."""
    from blaze_tpu_torch.batch import batch_to_pydict
    from blaze_tpu_torch.ops import ParquetScanExec, ParquetSinkExec
    from blaze_tpu_torch.runtime.context import TaskContext
    from blaze_tpu_torch.schema import Schema

    plan = optimized(build_plan("q3", scans, n_parts))
    sink = ParquetSinkExec(plan, directory, ["o_shippriority"])
    n = sink.num_partitions()
    for p in range(n):
        for _ in sink.execute(p, TaskContext(p, n)):
            raise AssertionError("the sink yielded a batch")
    schema = Schema([f for f in plan.schema.fields if f.name != "o_shippriority"])
    back = []
    for path in sink.written_files:
        value = int(Path(path).parent.name.split("=", 1)[1])
        for b in ParquetScanExec([[path]], schema, device="cuda").execute(0, TaskContext(0, 1)):
            d = {**batch_to_pydict(b), "o_shippriority": [value] * b.num_rows}
            back += list(zip(*(d[f.name] for f in plan.schema.fields)))
    want = query_rows["q3"]
    want = list(zip(*(want[f.name] for f in plan.schema.fields)))
    if sorted(back, key=repr) != sorted(want, key=repr) or not back:
        raise AssertionError(f"sink round trip: {back} != q03's {want}")
    return f"{len(back)} rows in {len(sink.written_files)} file(s) = q03's"


def file_phase(torch, cuda_ops, card: str, data, scale: float, n_parts: int, batch_rows: int, workdir: str) -> tuple:
    """TPC-H from files the port writes under ``workdir``, on both paths
    (see the module docstring, step 8).  Returns (the launches of each
    run, the SF1 files for the profiled runs, the SF ``FILE_SCALE``
    tables)."""
    from blaze_tpu_torch import conf
    from blaze_tpu_torch.io import parquet as pq
    from blaze_tpu_torch.tpch import datagen

    launches_of = {}
    conf.BATCH_SIZE.set(batch_rows)  # a decoded scan's batches: the memory scans'
    try:
        # ---- every table at FILE_SCALE, gzip parquet; the 13 later queries on
        # dbgen's columns, whose four tables are written again
        t0 = time.perf_counter()
        plain = datagen.generate_all(FILE_SCALE)
        spec = datagen.with_spec_columns(plain, FILE_SCALE)
        register_tables(plain, ("files", FILE_SCALE), "plain")
        register_tables(spec, ("files", FILE_SCALE), "spec")
        gen_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        written = write_tables(plain, list(plain), os.path.join(workdir, "plain"), n_parts, batch_rows)
        spec_names = [k for k in spec if spec[k] is not plain[k]]
        spec_written = {**written, **write_tables(spec, spec_names, os.path.join(workdir, "spec"), n_parts,
                                                  batch_rows)}
        write_s = time.perf_counter() - t0
        size = sum(os.path.getsize(g[0]) for w in (written, spec_written) for gs, _ in w.values() for g in gs)
        log(f"files: TPC-H SF{FILE_SCALE} generated in {gen_s:.2f} s, written as gzip parquet ({n_parts} files a "
            f"table, {len(spec_names)} tables again with dbgen's columns) in {write_s:.2f} s, {size} bytes")
        rows = file_runs(torch, cuda_ops, card, f"parquet SF{FILE_SCALE}", TPCH_QUERIES,
                         file_scans(written, "parquet", batch_rows), (plain, spec), n_parts, launches_of)
        rows.update(file_runs(torch, cuda_ops, card, f"parquet SF{FILE_SCALE}", NEW_QUERIES,
                              file_scans(spec_written, "parquet", batch_rows), (plain, spec), n_parts, launches_of))
        # ---- q01, q03 and q06 launch as their memory-scan runs at the same
        # scale and batches, on each path
        for query in LAUNCH_MATCH_QUERIES:
            mem_scans = query_scans(plain, query, n_parts, batch_rows)
            got, wall, mem, _ = run_query(torch, cuda_ops, query, mem_scans, n_parts)
            sgot, swall, smem, _ = run_scheduled(torch, cuda_ops, query, mem_scans, n_parts)
            name = f"{query_label(query)} parquet SF{FILE_SCALE}"
            if mem != launches_of[name] or smem != launches_of[name + " (run_stages)"] or got != rows[query]:
                raise AssertionError(f"{name}: launched {launches_of[name]} in process and "
                                     f"{launches_of[name + ' (run_stages)']} through run_stages, its memory scans "
                                     f"{mem} and {smem}; rows equal: {got == rows[query]}")
            log(f"files {name}: = its memory-scan runs (walls {wall:.4f} s in process, {swall:.4f} s through "
                f"run_stages) row for row, and launched as they did ({ {k: mem[k] for k in LAUNCH_KEYS} } in "
                f"process, { {k: smem[k] for k in LAUNCH_KEYS} } through run_stages)")
        log("files sink: " + sink_round_trip(torch, rows, file_scans(written, "parquet", batch_rows), n_parts,
                                             os.path.join(workdir, "sink")))
        # ---- ORC (zlib, Spark's ORC default) at FILE_SCALE
        t0 = time.perf_counter()
        orc_written = write_tables(plain, ("lineitem", "orders", "customer"), workdir, n_parts, batch_rows, "orc")
        log(f"files: lineitem, orders and customer at SF{FILE_SCALE} written as zlib ORC in "
            f"{time.perf_counter() - t0:.2f} s")
        file_runs(torch, cuda_ops, card, f"orc SF{FILE_SCALE}", ORC_QUERIES, file_scans(orc_written, "orc", batch_rows),
                  (plain, spec), n_parts, launches_of)
        # ---- snappy (Spark's parquet default, pure-python here) at SNAPPY_SCALE
        small = {"lineitem": datagen.generate_table("lineitem", SNAPPY_SCALE)}
        t0 = time.perf_counter()
        snappy = write_tables(small, ("lineitem",), os.path.join(workdir, "snappy"), n_parts, batch_rows,
                              codec=pq.CODEC_SNAPPY)
        log(f"files: lineitem at SF{SNAPPY_SCALE} written as snappy parquet in {time.perf_counter() - t0:.2f} s")
        file_runs(torch, cuda_ops, card, f"snappy parquet SF{SNAPPY_SCALE}", SNAPPY_QUERIES,
                  file_scans(snappy, "parquet", batch_rows), (small, small), n_parts, launches_of)
        # ---- q06 and q03 at --scale (SF1): lineitem's numeric and date columns,
        # orders and customer whole; the producer thread on (depth 2) and off (0)
        t0 = time.perf_counter()
        sf1 = {"lineitem": data["lineitem"], "orders": datagen.generate_table("orders", scale),
               "customer": datagen.generate_table("customer", scale)}
        gen_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        sf1_written = write_tables(sf1, list(sf1), os.path.join(workdir, "sf1"), n_parts, batch_rows,
                                   numeric_only=("lineitem",))
        log(f"files: SF{scale} orders and customer generated in {gen_s:.2f} s; lineitem's "
            f"{len(sf1_written['lineitem'][1].fields)} numeric and date columns, orders and customer written as gzip "
            f"parquet in {time.perf_counter() - t0:.2f} s")
        del sf1
        sf1_scans = file_scans(sf1_written, "parquet", batch_rows)
        for depth in (2, 0):
            conf.PIPELINE_DEPTH.set(depth)
            try:
                file_runs(torch, cuda_ops, card, f"parquet SF{scale}, pipeline depth {depth}", SF1_FILE_QUERIES, sf1_scans,
                          (data, data), n_parts, launches_of)
            finally:
                conf.PIPELINE_DEPTH.set(2)
    finally:
        conf.BATCH_SIZE.set(8192)
    return launches_of, sf1_written, plain


# ------------------------------------------------ functions and object aggs

# the phase's scale for lineitem's object aggs, first and the device
# function families: the object aggs update their states row by row in
# python, as in the reference, so SF1's 6M rows would take minutes
FN_SCALE = 0.1
# float results held to the port's CPU evaluation: torch's CPU and CUDA
# libraries may round transcendental functions apart, each within an ulp
# of numpy (tests/test_torch_functions.py)
FN_ULPS = 2
# the host string and JSON families: python per row, so SF 0.1 runs the
# same code as SF1 in a tenth of the time
FN_HOST_SCALE = 0.1


def batches_arrays(schema, batches) -> dict:
    """The batches' rows as host arrays per column, in order:
    (data, validity, lengths or None), one device-to-host copy a batch."""
    import numpy as np

    from blaze_tpu_torch.io.batch_serde import host_columns

    parts = [host_columns(b)[0] for b in batches]
    out = {}
    for i, f in enumerate(schema.fields):
        cols = [p[i] for p in parts]
        data = [c[0] for c in cols]
        if cols and cols[0][2] is not None:
            w = max(d.shape[1] for d in data)
            data = [np.pad(d, ((0, 0), (0, w - d.shape[1]))) for d in data]
        out[f.name] = (np.concatenate(data) if data else np.zeros(0),
                       np.concatenate([c[1] for c in cols]) if cols else np.zeros(0, bool),
                       np.concatenate([c[2] for c in cols]) if cols and cols[0][2] is not None else None)
    return out


def _ordered_bits(x):
    """float64 values as int64 keys whose differences count ulps."""
    import numpy as np

    i = x.astype(np.float64).view(np.int64)
    return np.where(i < 0, -(i & 0x7FFFFFFFFFFFFFFF), i)


def same_arrays(got: dict, want: dict, label: str, ulps: int = 0) -> None:
    """Raises unless every column of ``got`` equals ``want``'s row for
    row: the same nulls; integers, strings (bytes up to each length) and
    booleans exactly; floats within ``ulps`` units in the last place, a
    NaN equal to a NaN."""
    import numpy as np

    if list(got) != list(want):
        raise AssertionError(f"{label}: columns {list(got)} != {list(want)}")
    for name in got:
        (a, va, la), (b, vb, lb) = got[name], want[name]
        if a.shape[0] != b.shape[0] or not np.array_equal(va, vb):
            raise AssertionError(f"{label} {name}: the rows or their nulls differ")
        a, b = a[va], b[va]
        if la is not None:
            la, lb = la[va], lb[va]
            w = max(a.shape[1], b.shape[1])
            pos = np.arange(w)[None, :]
            a = np.where(pos < la[:, None], np.pad(a, ((0, 0), (0, w - a.shape[1]))), 0)
            b = np.where(pos < lb[:, None], np.pad(b, ((0, 0), (0, w - b.shape[1]))), 0)
            bad = (la != lb) | (a != b).any(axis=1)
        elif a.dtype.kind == "f":
            both_nan = np.isnan(a) & np.isnan(b)
            with np.errstate(over="ignore"):
                dist = np.abs(_ordered_bits(a) - _ordered_bits(b))
            bad = ~both_nan & (dist > ulps)
        else:
            bad = a != b
        if bad.any():
            i = int(np.argmax(bad))
            raise AssertionError(f"{label} {name}: {int(bad.sum())} rows differ, first "
                                 f"{a[i]!r} against {b[i]!r}")


def table_scans(tables: dict, names, n_parts: int, batch_rows: int, device: str) -> dict:
    from blaze_tpu_torch.batch import table_to_batches
    from blaze_tpu_torch.ops import MemoryScanExec
    from blaze_tpu_torch.tpch import TPCH_SCHEMAS

    return {name: MemoryScanExec(table_to_batches(tables[name], TPCH_SCHEMAS[name], n_parts, batch_rows, device),
                                 TPCH_SCHEMAS[name], device=device) for name in names}


def plan_batches(plan) -> list:
    from blaze_tpu_torch.runtime.context import TaskContext

    n = plan.num_partitions()
    return [b for p in range(n) for b in plan.execute(p, TaskContext(p, n))]


def both_paths(torch, cuda_ops, label: str, build, launches_of: dict, arrays: bool = False) -> tuple:
    """``build()``'s plan in process (through the optimizer) and through
    split_stages/run_stages, launch counts reset before each build, the
    walls from the build to the last batch on the card; the launches
    equal, and the rows alike: as multisets of python values, or with
    ``arrays`` as host arrays in order (``same_arrays``, exactly).
    Returns (in-process rows or arrays, wall, run_stages wall)."""
    from blaze_tpu_torch.batch import batch_to_pydict
    from blaze_tpu_torch.runtime.scheduler import split_stages

    cuda_ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plan = optimized(build())
    batches = plan_batches(plan)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches_of[label] = dict(cuda_ops.LAUNCHES)
    cuda_ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stages, manager = split_stages(build())
    sbatches = run_clean(label, stages, manager)
    torch.cuda.synchronize()
    swall = time.perf_counter() - t0
    launches_of[f"{label} (run_stages)"] = dict(cuda_ops.LAUNCHES)
    if arrays:
        got = batches_arrays(plan.schema, batches)
        same_arrays(batches_arrays(plan.schema, sbatches), got, f"{label} through run_stages")
    else:
        got, sgot = ({f.name: [] for f in plan.schema.fields} for _ in range(2))
        for rows, bs in ((got, batches), (sgot, sbatches)):
            for b in bs:
                for k, v in batch_to_pydict(b).items():
                    rows[k].extend(v)
        if not same_rows(sgot, got):
            raise AssertionError(f"{label} through run_stages differs from in process")
    if launches_of[label] != launches_of[f"{label} (run_stages)"]:
        raise AssertionError(f"{label}: launches {launches_of[label]} in process, "
                             f"{launches_of[f'{label} (run_stages)']} through run_stages")
    return got, wall, swall


def cpu_rows(plan) -> dict:
    """A plan's rows, run in process on CPU scans (the port's CPU
    evaluation, the plain versions of the kernels)."""
    from blaze_tpu_torch.batch import batch_to_pydict

    out = {f.name: [] for f in plan.schema.fields}
    for b in plan_batches(plan):
        for k, v in batch_to_pydict(b).items():
            out[k].extend(v)
    return out


def runtime_filter_run(torch, cuda_ops, card: str, data, scale: float, n_parts: int, batch_rows: int,
                       runs: dict, launches_of: dict) -> dict:
    """TPC-H q03 with the runtime bloom filter (see the module
    docstring, step 9)."""
    import numpy as np

    from blaze_tpu_torch.batch import column_to_pylist
    from blaze_tpu_torch.exprs.bloom import SparkBloomFilter
    from blaze_tpu_torch.exprs.compile import lower
    from blaze_tpu_torch.exprs.ir import col, func
    from blaze_tpu_torch.ops import ProjectExec
    from blaze_tpu_torch.runtime.context import TaskContext
    from blaze_tpu_torch.tpch import queries as Q

    scans = query_scans(data, "q3", n_parts, batch_rows)
    got, wall, swall = both_paths(torch, cuda_ops, "q03 runtime filter",
                                  lambda: Q.q3_runtime_filter(scans, n_parts), launches_of)
    said = check_oracle(data, "q3", got)
    payload = Q.q3_bloom_payload(scans, n_parts)
    filt = SparkBloomFilter.deserialize(payload)
    # every lineitem row: the device probe against the host's, and no
    # false negative over the creation side's keys
    keys = set()
    co = ProjectExec(Q._q3_customer_orders(scans), [col("o_orderkey")], ["k"])
    for p in range(co.num_partitions()):
        for b in co.execute(p, TaskContext(p, co.num_partitions())):
            keys.update(column_to_pylist(b.columns[0], b.num_rows))
    line = scans["lineitem"]
    creation_keys = np.fromiter(keys, np.int64, len(keys))
    rows, passed, missed, differ = 0, 0, 0, 0
    for p in range(line.num_partitions()):
        for b in line.execute(p, TaskContext(p, line.num_partitions())):
            env = {f.name: c.head(b.num_rows) for f, c in zip(line.schema.fields, b.columns)}
            h = lower(func("xxhash64", col("l_orderkey")), line.schema, env, b.num_rows)
            dev = filt.might_contain_device(h).cpu().numpy()
            host = filt.might_contain_longs(h.data.cpu().numpy())
            differ += int((dev != host).sum())
            on_creation_side = np.isin(env["l_orderkey"].data.cpu().numpy(), creation_keys)
            missed += int((on_creation_side & ~dev).sum())
            rows += b.num_rows
            passed += int(dev.sum())
    if differ or missed:
        raise AssertionError(f"runtime filter: {differ} rows where the device probe differs from the host's, "
                             f"{missed} false negatives")
    rec = {"run": "q03 runtime filter", "scale": scale, "payload_bytes": len(payload),
           "expected_items": 1_000_000, "creation_side_keys": len(keys), "lineitem_rows": rows,
           "lineitem_rows_passing_filter": passed, "false_negatives": 0, "probe_differs_from_host": 0,
           "inproc_wall_s": wall, "run_stages_wall_s": swall, "launches": launches_of["q03 runtime filter"],
           "launches_q03_without_filter": {k: runs["q3"][k] for k in launches_of["q03 runtime filter"]},
           "card": card}
    log(f"q03 with the runtime bloom filter SF{scale}: {said} on both paths; filter {len(payload)} bytes over "
        f"{len(keys)} creation-side keys, lineitem {rows} -> {passed} rows, no false negative, the device "
        f"probe = the host's on every row; walls {wall:.4f} s in process, {swall:.4f} s through run_stages "
        f"on {card}; launches {rec['launches']} on each path (q03 without it {rec['launches_q03_without_filter']})")
    return rec


#: (label, table, group key, distinct column, percentile column) of the
#: object agg runs: grouped over lineitem, global over part
OBJECT_AGG_RUNS = (("object agg by l_suppkey", "lineitem", "l_suppkey", "l_orderkey", "l_extendedprice"),
                   ("object agg, global", "part", None, "p_size", "p_retailprice"))


def object_agg_plan(scans, n_parts: int, table: str, key, ndv_col: str, p50_col: str):
    from blaze_tpu_torch.exprs.ir import col
    from blaze_tpu_torch.ops import AggMode, GroupingExpr, ObjectAggExec
    from blaze_tpu_torch.ops import udafs as U
    from blaze_tpu_torch.parallel.exchange import NativeShuffleExchangeExec
    from blaze_tpu_torch.parallel.shuffle import HashPartitioning, SinglePartitioning

    udafs = [U.approx_count_distinct(col(ndv_col), "ndv"), U.approx_percentile(col(p50_col), 0.5, "p50")]
    g = [GroupingExpr(col(key), key)] if key else []
    partial = ObjectAggExec(scans[table], AggMode.PARTIAL, g, udafs)
    part_by = HashPartitioning([col(key)], n_parts) if key else SinglePartitioning()
    return ObjectAggExec(NativeShuffleExchangeExec(partial, part_by), AggMode.FINAL, g, udafs)


def object_agg_cpu_rows(tables: dict, label: str, n_parts: int, batch_rows: int) -> dict:
    """The object agg run ``label``'s rows on CPU scans of ``tables``."""
    args = next(run[1:] for run in OBJECT_AGG_RUNS if run[0] == label)
    return cpu_rows(object_agg_plan(table_scans(tables, list(tables), n_parts, batch_rows, "cpu"), n_parts, *args))


def object_agg_runs(torch, cuda_ops, card: str, lineitem, part, n_parts: int, batch_rows: int,
                    launches_of: dict) -> list:
    """approx_count_distinct and approx_percentile (see the module
    docstring, step 9): grouped over lineitem, global over part, each
    held to the same plan on CPU scans (a reference worker's)."""
    import numpy as np

    recipe = ("functions", FN_SCALE, FN_HOST_SCALE)
    tables = {"lineitem": lineitem, "part": part}
    card_scans = table_scans(tables, list(tables), n_parts, batch_rows, "cuda")
    out = []
    for label, table, key, ndv_col, p50_col in OBJECT_AGG_RUNS:
        args = (table, key, ndv_col, p50_col)
        got, wall, swall = both_paths(torch, cuda_ops, label,
                                      lambda args=args: object_agg_plan(card_scans, n_parts, *args), launches_of)
        made = REFERENCES.take(("object agg", recipe, label, n_parts, batch_rows))
        cpu = made[0] if made else object_agg_cpu_rows(tables, label, n_parts, batch_rows)
        keyed = lambda rows: {k: (n, p) for k, n, p in zip(rows.get(key, [None] * len(rows["ndv"])),
                                                           rows["ndv"], rows["p50"])}
        g, c = keyed(got), keyed(cpu)
        if g != c:
            raise AssertionError(f"{label}: the sketches on the card differ from the CPU run's")
        keys_col = tables[table][key][0] if key else None
        ndv_err, p50_err = [], []
        for k, (ndv, p50) in g.items():
            rows = keys_col == k if key else np.ones(len(tables[table][ndv_col][0]), bool)
            exact = len(np.unique(tables[table][ndv_col][0][rows]))
            median = float(np.percentile(tables[table][p50_col][0][rows], 50))
            ndv_err.append(abs(ndv - exact) / exact)
            p50_err.append(abs(p50 - median) / median)
        # every HLL within 5%; a median within 2% (the reference's
        # tolerance, over 12,000 values) where it summarizes a whole table:
        # a supplier's ~600 values meet 100 centroids too coarsely to hold
        # 2% each, and are held to the CPU run above
        if max(ndv_err) > 0.05 or (not key and max(p50_err) > 0.02):
            raise AssertionError(f"{label}: HLL {max(ndv_err):.4f} or median {max(p50_err):.4f} off the "
                                 f"exact values")
        scale = FN_SCALE
        rec = {"run": label, "table": table, "scale": scale, "groups": len(g), "worst_ndv_rel_err": max(ndv_err),
               "median_rel_err_p50_p90_max": [float(np.percentile(p50_err, 50)), float(np.percentile(p50_err, 90)),
                                              max(p50_err)],
               "inproc_wall_s": wall, "run_stages_wall_s": swall, "launches": launches_of[label], "card": card,
               "cut": f"SF{scale}, from SF1: the states update row by row in python, as in the reference"}
        log(f"{label} over {table} SF{scale}: {len(g)} groups = the CPU run's, HLL within {max(ndv_err):.4f} of "
            f"the exact distinct counts, medians {rec['median_rel_err_p50_p90_max']} (p50, p90, max relative) "
            f"off numpy's; walls {wall:.4f} s in process, {swall:.4f} s through run_stages on {card}; "
            f"launches {rec['launches']} on each path")
        out.append(rec)
    return out


def first_run(torch, cuda_ops, card: str, lineitem, n_parts: int, batch_rows: int, launches_of: dict) -> dict:
    """first and first_ignores_null over a hash exchange, against an
    exact oracle (see the module docstring, step 9)."""
    import numpy as np

    from blaze_tpu_torch.exprs.ir import Case, Cast, col, lit
    from blaze_tpu_torch.ops import AggFunction, GroupingExpr
    from blaze_tpu_torch.schema import DataType
    from blaze_tpu_torch.tpch.queries import two_stage_agg

    scans = table_scans({"lineitem": lineitem}, ["lineitem"], n_parts, batch_rows, "cuda")
    dep = col("l_orderkey") * lit(7)
    holes = Case([(col("l_linenumber") == lit(1), lit(None, DataType.int64()))], dep)
    aggs = [AggFunction("first", dep, "f"), AggFunction("first_ignores_null", holes, "fin"),
            AggFunction("first", Cast(col("l_orderkey"), DataType.string(24)), "fs")]
    build = lambda: two_stage_agg(scans["lineitem"], [GroupingExpr(col("l_orderkey"), "k")], aggs, n_parts)
    got, wall, swall = both_paths(torch, cuda_ops, "first by l_orderkey", build, launches_of)
    okey, line = lineitem["l_orderkey"][0], lineitem["l_linenumber"][0]
    multi = set(np.unique(okey[line != 1]).tolist())
    for k, f, fin, fs in zip(got["k"], got["f"], got["fin"], got["fs"]):
        if f != 7 * k or fs != str(k) or fin != (7 * k if k in multi else None):
            raise AssertionError(f"first: group {k} gave {(f, fin, fs)}")
    if len(got["k"]) != len(np.unique(okey)):
        raise AssertionError("first: a group is missing")
    rec = {"run": "first by l_orderkey", "scale": FN_SCALE, "groups": len(got["k"]),
           "groups_all_null_for_ignores_null": len(got["k"]) - len(multi), "inproc_wall_s": wall,
           "run_stages_wall_s": swall, "launches": launches_of["first by l_orderkey"], "card": card}
    log(f"first/first_ignores_null SF{FN_SCALE}: {len(got['k'])} groups = the oracle on both paths; walls "
        f"{wall:.4f} s in process, {swall:.4f} s through run_stages on {card}; launches {rec['launches']}")
    return rec


def function_families():
    """The card's function families: (family, table, [(name, expr)]
    [, a projection of the table the expressions read])."""
    from blaze_tpu_torch.exprs.ir import Cast, col, func, lit
    from blaze_tpu_torch.schema import DataType as T

    f, c = func, col
    ts = Cast(c("l_orderkey") * lit(1234567891), T.timestamp())
    price, disc = c("l_extendedprice"), c("l_discount")
    json_doc = f("concat", lit('{"key":'), Cast(c("c_custkey"), T.string(24)), lit(',"name":"'), c("c_name"),
                 lit('","bal":'), Cast(c("c_acctbal"), T.string(24)), lit("}"))
    return [
        ("date", "lineitem", [
            ("quarter", f("quarter", c("l_shipdate"))), ("dayofweek", f("dayofweek", c("l_shipdate"))),
            ("weekday", f("weekday", c("l_commitdate"))), ("dayofyear", f("dayofyear", c("l_receiptdate"))),
            ("weekofyear", f("weekofyear", c("l_shipdate"))), ("last_day", f("last_day", c("l_shipdate"))),
            ("add_months", f("add_months", c("l_shipdate"), c("l_linenumber"))),
            ("date_add", f("date_add", c("l_shipdate"), c("l_linenumber"))),
            ("date_sub", f("date_sub", c("l_commitdate"), lit(7))),
            ("datediff", f("datediff", c("l_receiptdate"), c("l_shipdate"))),
            ("unix_timestamp", f("unix_timestamp", c("l_shipdate"))), ("hour", f("hour", ts)),
            ("minute", f("minute", ts)), ("second", f("second", ts))]),
        ("math", "lineitem", [
            ("sqrt", f("sqrt", price)), ("cbrt", f("cbrt", price)), ("ln", f("ln", price)),
            ("log10", f("log10", price)), ("exp", f("exp", disc)), ("sin", f("sin", price)),
            ("atan", f("atan", disc)), ("tanh", f("tanh", disc)), ("ceil", f("ceil", price)),
            ("floor", f("floor", price)), ("trunc", f("trunc", price)), ("signum", f("signum", disc)),
            ("degrees", f("degrees", disc)), ("pow", f("pow", c("l_quantity"), c("l_tax"))),
            ("atan2", f("atan2", disc, c("l_tax"))), ("round", f("round", price, lit(1)))]),
        ("device string", "lineitem", [
            ("length", f("length", c("l_comment"))), ("upper", f("upper", c("l_comment"))),
            ("lower", f("lower", c("l_shipinstruct"))), ("trim", f("trim", c("l_comment"))),
            ("ltrim", f("ltrim", c("l_comment"), lit("abcdefghijklmnop"))), ("rtrim", f("rtrim", c("l_comment"))),
            ("starts_with", f("starts_with", c("l_shipinstruct"), lit("DELIVER"))),
            ("ends_with", f("ends_with", c("l_comment"), lit("s"))),
            ("repeat", f("repeat", c("l_shipmode"), lit(2))), ("space", f("space", c("l_linenumber"))),
            ("concat_ws", f("concat_ws", lit("|"), c("l_shipmode"), c("l_returnflag"))),
            ("octet_length", f("octet_length", c("l_comment"))),
            ("coalesce", f("coalesce", f("nullif", c("l_shipmode"), lit("AIR")), c("l_returnflag")))]),
        ("hash", "lineitem", [
            ("murmur3_hash", f("murmur3_hash", c("l_orderkey"))),
            ("murmur3_hash-string", f("murmur3_hash", c("l_comment"))),
            ("xxhash64", f("xxhash64", c("l_orderkey"), c("l_shipmode"))),
            ("xxhash64-decimal", f("xxhash64", price))]),
        ("decimal", "lineitem", [
            ("unscaled_value", f("unscaled_value", price)),
            ("make_decimal", f("make_decimal", c("l_orderkey"), lit(18), lit(2))),
            ("check_overflow", f("check_overflow", price, lit(7), lit(1))),
            ("round-decimal", f("round", price, lit(1))), ("negative", f("negative", disc)),
            ("null_if_zero", f("null_if_zero", disc))]),
        ("casts", "lineitem", [
            ("decimal-string", Cast(price, T.string(24))), ("long-string", Cast(c("l_orderkey"), T.string(24))),
            ("date-string", Cast(c("l_shipdate"), T.string(16))),
            ("bool-string", Cast(c("l_returnflag") == lit("R"), T.string(8))),
            ("string-long", Cast(Cast(c("l_orderkey"), T.string(24)), T.int64())),
            ("string-decimal", Cast(Cast(price, T.string(24)), T.decimal(12, 2))),
            ("string-date", Cast(Cast(c("l_shipdate"), T.string(16)), T.date32())),
            ("string-int", Cast(c("l_shipmode"), T.int32()))]),
        # the host families: ~5 us a row and function in python, as in the
        # reference, on each path and in the CPU evaluation
        ("host string", "customer", [
            ("md5", f("md5", c("c_name"))), ("sha2", f("sha2", c("c_phone"), lit(256))),
            ("regexp_extract", f("regexp_extract", c("c_name"), lit("#(\\d+)"), lit(1))),
            ("lpad", f("lpad", c("c_name"), lit(24), lit("*"))),
            ("split_part", f("split_part", c("c_phone"), lit("-"), lit(2))),
            ("to_hex", f("to_hex", c("c_custkey")))]),
        ("host string", "part", [
            ("translate", f("translate", c("p_name"), lit("aeiou"), lit("AEIOU"))),
            ("rlike", f("rlike", c("p_name"), lit("green|red"))), ("chr", f("chr", c("p_size"))),
            ("locate", f("locate", lit("e"), c("p_name"), lit(3))),
            ("date_format", f("date_format", Cast(c("p_size"), T.date32()), lit("yyyy-MM-dd")))]),
        # the document is built once, by a projection under the JSON paths
        ("JSON", "customer", [
            ("name", f("get_json_object", c("doc"), lit("$.name"))),
            ("key", f("get_json_object", c("doc"), lit("$.key"))),
            ("bal", f("get_json_object", c("doc"), lit("$.bal"))),
            ("parsed_key", f("get_parsed_json_object", f("parse_json", c("doc")), lit("$.key")))],
         [("doc", json_doc)]),
    ]


def family_plan(scans, table: str, cases, pre=()):
    """One function family's projection of ``scans[table]``."""
    from blaze_tpu_torch.ops import ProjectExec

    src = scans[table]
    if pre:
        src = ProjectExec(src, [e for _, e in pre[0]], [n for n, _ in pre[0]])
    return ProjectExec(src, [e for _, e in cases], [n for n, _ in cases])


def family_cpu_arrays(tables: dict, family: str, table: str, n_parts: int, batch_rows: int) -> dict:
    """The function family ``family``'s columns over ``table`` on CPU
    scans of ``tables``: the port's CPU evaluation."""
    cases, *pre = next(f[2:] for f in function_families() if f[:2] == (family, table))
    plan = family_plan(table_scans(tables, list(tables), n_parts, batch_rows, "cpu"), table, cases, pre)
    return batches_arrays(plan.schema, plan_batches(plan))


def family_runs(torch, cuda_ops, card: str, lineitem, host_tables, n_parts: int, batch_rows: int,
                launches_of: dict) -> list:
    """One plan per function family on both paths, each column equal to
    the port's CPU evaluation of the same plan (a reference worker's;
    see the module docstring, step 9)."""
    from decimal import Decimal

    from blaze_tpu_torch.ops import ProjectExec

    tables = {"lineitem": lineitem, **host_tables}
    card_scans = table_scans(tables, list(tables), n_parts, batch_rows, "cuda")
    recipe = ("functions", FN_SCALE, FN_HOST_SCALE)
    out = []
    for family, table, cases, *pre in function_families():
        label = f"functions: {family} over {table}"
        names = [n for n, _ in cases]
        got, wall, swall = both_paths(torch, cuda_ops, label,
                                      lambda table=table, cases=cases, pre=pre: family_plan(card_scans, table, cases,
                                                                                           pre),
                                      launches_of, arrays=True)
        made = REFERENCES.take(("family", recipe, family, table, n_parts, batch_rows))
        if made is None:
            t0 = time.perf_counter()
            made = family_cpu_arrays(tables, family, table, n_parts, batch_rows), time.perf_counter() - t0
        want, cpu_s = made
        same_arrays(got, want, f"{label} against the CPU", FN_ULPS)
        nulls = {n: int((~got[n][1]).sum()) for n in names}
        out.append({"run": label, "scale": FN_SCALE if table == "lineitem" else FN_HOST_SCALE,
                    "rows": int(got[names[0]][1].shape[0]), "functions": names, "nulls": nulls, "inproc_wall_s": wall,
                    "run_stages_wall_s": swall, "cpu_evaluation_s": cpu_s, "launches": launches_of[label],
                    "card": card})
        if family == "JSON":
            from blaze_tpu_torch.exprs.ir import col

            cpu_scan = table_scans(tables, [table], n_parts, batch_rows, "cpu")[table]
            src = cpu_rows(ProjectExec(cpu_scan, [col("c_custkey"), col("c_name"), col("c_acctbal")], ["k", "n", "b"]))
            text = {n: [bytes(d[:ln]).decode() for d, ln in zip(got[n][0], got[n][2])]
                    for n in ("name", "key", "bal")}
            bad = sum(1 for k, n, b, gk, gn, gb in zip(src["k"], src["n"], src["b"], text["key"], text["name"],
                                                        text["bal"])
                      if gn != n or int(gk) != k or Decimal(gb) != Decimal(b).scaleb(-2))
            if bad:
                raise AssertionError(f"JSON round trip: {bad} rows lost c_name, c_custkey or c_acctbal")
        log(f"{label} SF{out[-1]['scale']}: {len(names)} functions over {out[-1]['rows']} rows = the CPU "
            f"evaluation ({cpu_s:.2f} s on the host) on both paths; walls {wall:.4f} s in process, {swall:.4f} s "
            f"through run_stages on {card}; launches {launches_of[label]}")
    return out


def functions_phase(torch, cuda_ops, card: str, data, scale: float, n_parts: int, batch_rows: int,
                    runs: dict) -> tuple:
    """The functions and aggregates no TPC query uses, on both paths
    (see the module docstring, step 9).  Returns the launches of each
    run."""
    import gc

    from blaze_tpu_torch.tpch import datagen

    # the host functions and the sketches allocate python objects by the
    # million: keep the collector from rescanning the run's earlier tables
    # on each of its passes
    gc.freeze()
    launches_of: Dict[str, dict] = {}
    t0 = time.perf_counter()
    lineitem = datagen.generate_table("lineitem", FN_SCALE)
    part = datagen.generate_table("part", FN_SCALE)
    host_tables = {name: datagen.generate_table(name, FN_HOST_SCALE) for name in ("customer", "part")}
    log(f"functions: lineitem and part SF{FN_SCALE}, customer and part SF{FN_HOST_SCALE} generated in "
        f"{time.perf_counter() - t0:.2f} s")
    records = [runtime_filter_run(torch, cuda_ops, card, data, scale, n_parts, batch_rows, runs, launches_of)]
    records += object_agg_runs(torch, cuda_ops, card, lineitem, part, n_parts, batch_rows, launches_of)
    records.append(first_run(torch, cuda_ops, card, lineitem, n_parts, batch_rows, launches_of))
    records += family_runs(torch, cuda_ops, card, lineitem, host_tables, n_parts, batch_rows, launches_of)
    gc.unfreeze()
    for rec in records:
        log("functions " + json.dumps(rec))
    return launches_of


# --------------------------------------------------------- nested columns

# run 1's element budget: an order holds 1 to 7 lines, so no element is
# dropped, and its states take 8 slots where the default 64 would take
# eight times the bytes through every exchange and zlib
BASKET_MAX_ELEMS = 8
NESTED_SCALE = 0.1
# run 1's orders: one year of o_orderdate; its array_contains constant
BASKET_YEAR = 1995
BASKET_SUPPKEY = 1
# run 2's scan batches: small, so that orders span batches and their
# groups merge two partial states or more
MERGE_BATCH_ROWS = 1 << 14


def sub_scan(table: dict, schema, names, n_parts: int, batch_rows: int, device: str):
    """A memory scan of ``names`` of a host table."""
    from blaze_tpu_torch.batch import table_to_batches
    from blaze_tpu_torch.ops import MemoryScanExec
    from blaze_tpu_torch.schema import Schema

    s = Schema([schema.field(n) for n in names])
    return MemoryScanExec(table_to_batches({n: table[n] for n in names}, s, n_parts, batch_rows, device), s,
                          device=device)


def nested_paths(torch, cuda_ops, label: str, build, launches_of: dict, canon=None) -> dict:
    """``build()``'s plan in process (through the optimizer) and through
    split_stages/run_stages, launch counts reset before each: the walls
    from the build to the last batch on the card, the ``.data`` bytes,
    each path's peak device memory above what the run held before it;
    the rows (``canon`` applied to each path's) and the launches equal on
    both paths.  Returns the record, the in-process rows under ``rows``."""
    from blaze_tpu_torch.batch import batch_to_pydict
    from blaze_tpu_torch.runtime.scheduler import RunStats, split_stages

    rec = {"run": label}
    rows = {}
    for path in ("inproc", "run_stages"):
        cuda_ops.reset_launch_counts()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        if path == "inproc":
            plan = optimized(build())
            batches, schema = plan_batches(plan), plan.schema
        else:
            stats = RunStats()
            stages, manager = split_stages(build())
            batches, schema = run_clean(label, stages, manager, stats), stages[-1].plan.schema
            rec["data_bytes"], rec["tasks"] = stats.data_bytes, stats.tasks
        torch.cuda.synchronize()
        rec[f"{path}_wall_s"] = time.perf_counter() - t0
        rec[f"{path}_peak_mib"] = round((torch.cuda.max_memory_allocated() - base) / 2**20, 1)
        launches_of[label if path == "inproc" else f"{label} (run_stages)"] = dict(cuda_ops.LAUNCHES)
        out = {f.name: [] for f in schema.fields}
        for b in batches:
            for k, v in batch_to_pydict(b).items():
                out[k].extend(v)
        rows[path] = canon(out) if canon else out
        del batches
    if not same_rows(rows["inproc"], rows["run_stages"]):
        raise AssertionError(f"{label} through run_stages differs from in process")
    if launches_of[label] != launches_of[f"{label} (run_stages)"]:
        raise AssertionError(f"{label}: launches {launches_of[label]} in process, "
                             f"{launches_of[f'{label} (run_stages)']} through run_stages")
    rec["launches"] = launches_of[label]
    rec["rows"] = rows["inproc"]
    return rec


def basket_oracle(lineitem: dict, orders: dict):
    """Run 1 in numpy: per o_orderpriority over the year's orders, the
    exploded lines' count, sum of l_partkey and sum of positions, the
    orders, their distinct suppliers summed, the orders holding the
    constant supplier and the most lines of an order; and the most lines
    of any order."""
    import datetime

    import numpy as np

    okey, pkey, skey = (lineitem[c][0] for c in ("l_orderkey", "l_partkey", "l_suppkey"))
    day = lambda y: (datetime.date(y, 1, 1) - datetime.date(1970, 1, 1)).days
    odate = orders["o_orderdate"][0]
    sel = (odate >= day(BASKET_YEAR)) & (odate < day(BASKET_YEAR + 1))
    order_of = np.searchsorted(orders["o_orderkey"][0], okey)
    keep = sel[order_of]
    lines = np.bincount(order_of, minlength=odate.shape[0])
    pairs = np.unique(order_of[keep].astype(np.int64) << 32 | skey[keep].astype(np.int64))
    distinct = np.bincount(pairs >> 32, minlength=odate.shape[0])
    has = np.zeros(odate.shape[0], bool)
    has[order_of[keep & (skey == BASKET_SUPPKEY)]] = True
    pdata, plen = orders["o_orderpriority"][0], orders["o_orderpriority"][1]
    masked = np.ascontiguousarray(np.where(np.arange(pdata.shape[1])[None, :] < plen[:, None], pdata, 0))
    names, code = np.unique(masked.view(np.dtype((np.void, masked.shape[1]))).reshape(-1), return_inverse=True)
    code = code.reshape(-1)
    out = {}
    for c, row in enumerate(names):
        o_idx = np.flatnonzero(sel & (code == c))
        if not o_idx.size:
            continue
        n = lines[o_idx]
        out[bytes(row).rstrip(b"\0").decode()] = {
            "cnt": int(n.sum()), "s": int(pkey[keep & (code[order_of] == c)].sum()),
            "spos": int((n * (n - 1) // 2).sum()), "norders": int(o_idx.shape[0]),
            "nsup": int(distinct[o_idx].sum()), "nhas": int(has[o_idx].sum()), "maxn": int(n.max())}
    return out, int(lines.max())


def basket_plan(scans: dict, n_parts: int):
    """Run 1: order baskets.  Per l_orderkey a PARTIAL collect_list of
    l_partkey and collect_set of l_suppkey, a hash exchange, FINAL; a
    shuffled hash join with the year's orders (the agg's output is
    already partitioned by the key: only orders is exchanged); size and
    array_contains; pos_explode of the list; per o_orderpriority the
    exploded rows' count and sums."""
    import datetime

    from blaze_tpu_torch.exprs.ir import Case, col, func, lit
    from blaze_tpu_torch.ops import AggFunction, FilterExec, GenerateExec, GroupingExpr, NativeGenerator, ProjectExec
    from blaze_tpu_torch.ops.joins import HashJoinExec, JoinType
    from blaze_tpu_torch.parallel.exchange import NativeShuffleExchangeExec
    from blaze_tpu_torch.parallel.shuffle import HashPartitioning
    from blaze_tpu_torch.tpch.queries import two_stage_agg

    baskets = two_stage_agg(scans["lineitem"], [GroupingExpr(col("l_orderkey"), "k")],
                            [AggFunction("collect_list", col("l_partkey"), "parts"),
                             AggFunction("collect_set", col("l_suppkey"), "supps")], n_parts)
    year = FilterExec(scans["orders"], (col("o_orderdate") >= lit(datetime.date(BASKET_YEAR, 1, 1)))
                      & (col("o_orderdate") < lit(datetime.date(BASKET_YEAR + 1, 1, 1))))
    orders = NativeShuffleExchangeExec(year, HashPartitioning([col("o_orderkey")], n_parts))
    joined = HashJoinExec(orders, baskets, [col("o_orderkey")], [col("k")], JoinType.INNER, build_is_left=True)
    proj = ProjectExec(joined, [col("o_orderpriority"), func("size", col("parts")).alias("n_parts"),
                                func("size", col("supps")).alias("n_supps"),
                                func("array_contains", col("supps"), lit(BASKET_SUPPKEY)).alias("has"),
                                col("parts")])
    exploded = GenerateExec(proj, NativeGenerator("pos_explode", col("parts")), [])
    first = col("pos") == lit(0)
    zero = lit(0)
    aggs = [AggFunction("count_star", None, "cnt"), AggFunction("sum", col("col"), "s"),
            AggFunction("sum", col("pos"), "spos"), AggFunction("sum", Case([(first, lit(1))], zero), "norders"),
            AggFunction("sum", Case([(first, col("n_supps"))], zero), "nsup"),
            AggFunction("sum", Case([(first & col("has"), lit(1))], zero), "nhas"),
            AggFunction("max", col("n_parts"), "maxn")]
    return two_stage_agg(exploded, [GroupingExpr(col("o_orderpriority"), "prio")], aggs, n_parts)


def check_basket(got: dict, want: dict) -> None:
    rows = {p: {k: got[k][i] for k in got if k != "prio"} for i, p in enumerate(got["prio"])}
    if rows != want:
        raise AssertionError(f"order baskets: {rows} != the oracle's {want}")


def merge_oracle(lineitem: dict) -> dict:
    """Run 2 in numpy: per order its sorted l_partkey list and sorted
    distinct l_suppkey list."""
    import numpy as np

    okey, pkey, skey = (lineitem[c][0] for c in ("l_orderkey", "l_partkey", "l_suppkey"))
    order = np.lexsort((pkey, okey))
    keys, starts = np.unique(okey[order], return_index=True)
    parts = np.split(pkey[order], starts[1:])
    sorder = np.lexsort((skey, okey))
    supps = np.split(skey[sorder], starts[1:])
    return {int(k): (p.tolist(), sorted(set(s.tolist()))) for k, p, s in zip(keys, parts, supps)}


def sorted_lists(rows: dict) -> dict:
    """The collect columns' lists sorted: Spark gives no element order
    across partitions, so the two paths compare as multisets."""
    return {k: [sorted(v) if isinstance(v, list) else v for v in vals] for k, vals in rows.items()}


def words_oracle(part: dict):
    import numpy as np

    data, lengths = part["p_name"][0], part["p_name"][1]
    words = [w for i in range(data.shape[0]) for w in bytes(data[i, :lengths[i]]).decode().split(" ")]
    uniq, counts = np.unique(np.array(words, dtype=object).astype(str), return_counts=True)
    return [str(u) for u in uniq], [int(c) for c in counts]


def write_nested_orc(lineitem: dict, orders: dict, path: str):
    """Run 4's file: one row per order (o_orderkey; a LIST of l_partkey;
    a MAP from l_linenumber to l_partkey; a STRUCT of o_orderdate and
    o_totalprice), written by the port's own writer.  Returns its schema
    and the numpy oracle: per l_linenumber the lines, the sum of
    l_partkey and the sum of their orders' o_totalprice."""
    import numpy as np

    from blaze_tpu_torch.io import orc
    from blaze_tpu_torch.schema import DataType as T, Field, Schema

    okey, pkey, lnum = (lineitem[c][0] for c in ("l_orderkey", "l_partkey", "l_linenumber"))
    o_key, o_date, o_price = (orders[c][0] for c in ("o_orderkey", "o_orderdate", "o_totalprice"))
    row = np.searchsorted(o_key, okey)
    first = np.searchsorted(row, np.arange(o_key.shape[0]))
    pos = np.arange(okey.shape[0]) - first[row]
    m = BASKET_MAX_ELEMS
    lens = np.bincount(row, minlength=o_key.shape[0]).astype(np.int32)
    edata = np.zeros((o_key.shape[0], m), np.int64)
    evalid = np.zeros((o_key.shape[0], m), bool)
    edata[row, pos] = pkey
    evalid[row, pos] = True
    maps = [dict(zip(lnum[first[i]:first[i] + lens[i]].tolist(), pkey[first[i]:first[i] + lens[i]].tolist()))
            for i in range(o_key.shape[0])]
    structs = [{"o_orderdate": int(d), "o_totalprice": int(p)} for d, p in zip(o_date.tolist(), o_price.tolist())]
    schema = Schema([Field("o_orderkey", T.int64()), Field("parts", T.array(T.int64(), m)),
                     Field("lines", T.map(T.int32(), T.int64(), m)),
                     Field("head", T.struct([Field("o_orderdate", T.date32()), Field("o_totalprice", T.decimal(12, 2))]))])
    orc.write_orc(path, schema, {"o_orderkey": (o_key, None, None), "parts": (None, None, lens, (edata, evalid)),
                                 "lines": maps, "head": structs}, compression="zlib")
    want = {}
    for ln in np.unique(lnum):
        sel = lnum == ln
        want[int(ln)] = {"cnt": int(sel.sum()), "s": int(pkey[sel].sum()), "price": int(o_price[row[sel]].sum())}
    return schema, want


def orc_plan(scan, n_parts: int):
    """Run 4: the map exploded, a struct field and the list's first
    element beside it, per l_linenumber."""
    from blaze_tpu_torch.exprs.ir import Case, GetIndexedField, GetStructField, col, lit
    from blaze_tpu_torch.ops import AggFunction, GenerateExec, GroupingExpr, NativeGenerator, ProjectExec
    from blaze_tpu_torch.tpch.queries import two_stage_agg

    gen = GenerateExec(scan, NativeGenerator("explode", col("lines")), [])
    proj = ProjectExec(gen, [col("key"), col("value"), GetStructField(col("head"), "o_totalprice").alias("price"),
                             Case([(col("key") == lit(1), GetIndexedField(col("parts"), 0))]).alias("p0")])
    return two_stage_agg(proj, [GroupingExpr(col("key"), "ln")],
                         [AggFunction("count_star", None, "cnt"), AggFunction("sum", col("value"), "s"),
                          AggFunction("sum", col("price"), "price"), AggFunction("sum", col("p0"), "s0")], n_parts)


def nested_phase(torch, cuda_ops, flush, card: str, data, new_data, scale: float, n_parts: int, batch_rows: int,
                 workdir: str) -> tuple:
    """The nested columns (see the module docstring, step 10).  Returns
    the launches of each run and the kernel checks on run 1's inputs."""
    import numpy as np

    from blaze_tpu_torch import conf
    from blaze_tpu_torch.exprs.ir import col, func, lit
    from blaze_tpu_torch.ops import GenerateExec, MemoryScanExec, NativeGenerator, OrcScanExec, ProjectExec, SortField
    from blaze_tpu_torch.ops import AggFunction, GroupingExpr
    from blaze_tpu_torch.tpch import TPCH_SCHEMAS, datagen
    from blaze_tpu_torch.tpch.queries import single_sorted, two_stage_agg

    t_phase = time.perf_counter()
    launches_of: Dict[str, dict] = {}
    records, checks = [], []
    lineitem, orders = data["lineitem"], data["orders"]
    # ---- run 1: order baskets at --scale, budget 8
    li_cols, o_cols = ("l_orderkey", "l_partkey", "l_suppkey"), ("o_orderkey", "o_orderdate", "o_orderpriority")
    scans = {"lineitem": sub_scan(lineitem, TPCH_SCHEMAS["lineitem"], li_cols, n_parts, batch_rows, "cuda"),
             "orders": sub_scan(orders, TPCH_SCHEMAS["orders"], o_cols, n_parts, batch_rows, "cuda")}
    n_orders = orders["o_orderkey"][0].shape[0]
    state_mb = n_orders * 2 * BASKET_MAX_ELEMS * (8 + 1) / 1e6
    log(f"nested: run 1's collect states ~{n_orders} orders x 2 arrays x {BASKET_MAX_ELEMS} elements x 9 B = "
        f"{state_mb:.0f} MB (at the default 64: {state_mb * 8:.0f} MB)")
    t0 = time.perf_counter()
    want, most_lines = basket_oracle(lineitem, orders)
    oracle_s = time.perf_counter() - t0
    if most_lines > BASKET_MAX_ELEMS:
        raise AssertionError(f"order baskets: an order of {most_lines} lines would be cut at {BASKET_MAX_ELEMS}")
    conf.COLLECT_MAX_ELEMS.set(BASKET_MAX_ELEMS)
    try:
        with largest_inputs(cuda_ops) as seen:
            rec = nested_paths(torch, cuda_ops, "nested: order baskets", lambda: basket_plan(scans, n_parts),
                               launches_of)
    finally:
        conf.COLLECT_MAX_ELEMS.set(64)
    check_basket(rec.pop("rows"), want)
    require_launches("nested: order baskets", rec["launches"], ("murmur3_pids", "pid_histogram", "sorted_lookup"))
    rec.update(scale=scale, max_elems=BASKET_MAX_ELEMS, most_lines_of_an_order=most_lines, oracle_s=oracle_s,
               priorities=len(want), exploded_rows=sum(w["cnt"] for w in want.values()))
    records.append(rec)
    for key, (_, inputs) in sorted(seen.items()):
        if key.startswith("murmur3_pids"):
            planes, widths, valids, parts = inputs
            checks.append(("murmur3_pids", check_murmur3(torch, cuda_ops, flush, planes, widths, valids,
                                                         "(order baskets)", timed=False, n_parts=parts)))
        elif key.startswith("pid_histogram"):
            pids, parts = inputs
            checks.append(("pid_histogram", check_pid_histogram(torch, cuda_ops, flush, pids, parts,
                                                                "(order baskets)", timed=False)))
        elif key == "sorted_lookup most probes":
            checks.append(("sorted_lookup", check_sorted_lookup(torch, cuda_ops, flush, *inputs,
                                                                "(order baskets)", timed=False)))
    for name, r in checks:
        log_check(name, r)
    del scans, seen
    # ---- run 2: the default budget, states merged, at NESTED_SCALE
    small = datagen.generate_table("lineitem", NESTED_SCALE, columns=["l_orderkey", "l_partkey", "l_suppkey",
                                                                       "l_linenumber"])
    small_orders = datagen.generate_table("orders", NESTED_SCALE, columns=["o_orderkey", "o_orderdate",
                                                                            "o_totalprice"])
    okey = small["l_orderkey"][0]
    per_part = [np.array_split(part, -(-part.shape[0] // MERGE_BATCH_ROWS))
                for part in np.array_split(okey, n_parts)]
    spanning = sum(int(a[-1] == b[0]) for batches in per_part for a, b in zip(batches, batches[1:]))
    mscan = sub_scan(small, TPCH_SCHEMAS["lineitem"], li_cols, n_parts, MERGE_BATCH_ROWS, "cuda")
    merge_build = lambda: two_stage_agg(mscan, [GroupingExpr(col("l_orderkey"), "k")],
                                        [AggFunction("collect_list", col("l_partkey"), "parts"),
                                         AggFunction("collect_set", col("l_suppkey"), "supps")], n_parts)
    rec = nested_paths(torch, cuda_ops, "nested: collect at the default budget", merge_build, launches_of,
                       canon=sorted_lists)
    got = rec.pop("rows")
    want2 = merge_oracle(small)
    if len(got["k"]) != len(want2) or any(want2[k] != (p, s) for k, p, s in zip(got["k"], got["parts"],
                                                                                  got["supps"])):
        raise AssertionError("collect at the default budget: a group's list or set differs from numpy's")
    rec.update(scale=NESTED_SCALE, max_elems=64, groups=len(got["k"]), batch_rows=MERGE_BATCH_ROWS,
               orders_over_two_batches=spanning)
    if not spanning:
        raise AssertionError("collect at the default budget: no group merged two partial states")
    records.append(rec)
    # ---- run 3: word count over part's names at --scale
    part = new_data["part"]
    pscan = sub_scan(part, TPCH_SCHEMAS["part"], ("p_name",), n_parts, batch_rows, "cuda")

    def words_build():
        split = ProjectExec(pscan, [func("split", col("p_name"), lit(" ")).alias("words")])
        words = GenerateExec(split, NativeGenerator("explode", col("words")), [], keep_input=False)
        counted = two_stage_agg(words, [GroupingExpr(col("col"), "word")],
                                [AggFunction("count_star", None, "n")], n_parts)
        return single_sorted(counted, [SortField(col("word"), True, False)])

    rec = nested_paths(torch, cuda_ops, "nested: word count", words_build, launches_of)
    got = rec.pop("rows")
    words, counts = words_oracle(part)
    if got["word"] != words or got["n"] != counts:
        raise AssertionError("word count differs from numpy's split")
    rec.update(scale=scale, names=part["p_name"][0].shape[0], words=len(words), exploded_rows=sum(counts))
    records.append(rec)
    # ---- run 4: nested ORC at NESTED_SCALE, written by the port's writer
    path = os.path.join(workdir, "nested_orders.orc")
    t0 = time.perf_counter()
    schema, want4 = write_nested_orc(small, small_orders, path)
    write_s = time.perf_counter() - t0
    orc_build = lambda dev: orc_plan(OrcScanExec([[path]], schema, device=dev), n_parts)
    rec = nested_paths(torch, cuda_ops, "nested: ORC map explode", lambda: orc_build("cuda"), launches_of)
    got = rec.pop("rows")
    rows4 = {ln: {"cnt": c, "s": s, "price": p} for ln, c, s, p in zip(got["ln"], got["cnt"], got["s"], got["price"])}
    s0 = {ln: v for ln, v in zip(got["ln"], got["s0"])}
    if rows4 != want4 or s0 != {ln: (w["s"] if ln == 1 else None) for ln, w in want4.items()}:
        raise AssertionError(f"nested ORC: {rows4} != numpy's {want4}")
    t0 = time.perf_counter()
    if not same_rows(cpu_rows(orc_build("cpu")), {k: v for k, v in got.items()}):
        raise AssertionError("nested ORC: the card's rows differ from the CPU evaluation")
    cpu_s = time.perf_counter() - t0
    syncs, _ = count_syncs(torch, lambda: plan_batches(optimized(orc_build("cuda"))))
    # the explode alone over the scan's batches on the card: one read
    # of the emitted count a batch, none a column
    staged = plan_batches(OrcScanExec([[path]], schema, device="cuda"))
    explode = GenerateExec(MemoryScanExec([staged], schema, device="cuda"), NativeGenerator("explode", col("lines")), [])
    explode_syncs, _ = count_syncs(torch, lambda: plan_batches(explode))
    if explode_syncs > len(staged):
        raise AssertionError(f"explode: {explode_syncs} syncs over {len(staged)} batches")
    rec.update(scale=NESTED_SCALE, file_bytes=os.path.getsize(path), write_s=write_s, cpu_evaluation_s=cpu_s,
               inproc_syncs=syncs, explode_syncs=explode_syncs, explode_batches=len(staged))
    records.append(rec)
    os.unlink(path)
    for rec in records:
        rec["card"] = card
        log(f"{rec['run']}: = numpy on both paths; walls {rec['inproc_wall_s']:.4f} s in process, "
            f"{rec['run_stages_wall_s']:.4f} s through run_stages, .data {rec['data_bytes']} bytes, peaks "
            f"{rec['inproc_peak_mib']} / {rec['run_stages_peak_mib']} MiB on {card}; launches {rec['launches']}")
        log("nested " + json.dumps(rec))
    log(f"nested phase: {time.perf_counter() - t_phase:.1f} s")
    return launches_of, checks


# the exchanges phase: Spark's global ORDER BY and repartition, and a
# skipping partial agg, each on both paths
EXCHANGE_PARTS = 8
EXCHANGE_BUDGET_S = 45.0
ORDERS_COLUMNS = ("o_orderkey", "o_orderpriority", "o_totalprice")


def spark_q01_plan(scans, n_parts: int, n_out: int = EXCHANGE_PARTS):
    """TPC-H q01 as Spark 3.5.1 plans it (``tests/fixtures/
    spark351_q1_plan.json``): the FINAL agg, a range exchange on
    (l_returnflag, l_linestatus) and a sort of each partition, the
    partitions read in order."""
    from blaze_tpu_torch.exprs.ir import col
    from blaze_tpu_torch.ops import AggExec, SortExec, SortField
    from blaze_tpu_torch.ops.agg import AggMode
    from blaze_tpu_torch.parallel import RangePartitioning
    from blaze_tpu_torch.parallel.exchange import NativeShuffleExchangeExec

    agg = build_plan("q1", scans, n_parts)
    while not (isinstance(agg, AggExec) and agg.mode == AggMode.FINAL):
        agg = agg.children[0]
    fields = [SortField(col("l_returnflag")), SortField(col("l_linestatus"))]
    return SortExec(NativeShuffleExchangeExec(agg, RangePartitioning(fields, n_out)), fields)


def orders_sort_fields():
    """ORDER BY o_orderpriority, o_totalprice DESC, o_orderkey."""
    from blaze_tpu_torch.exprs.ir import col
    from blaze_tpu_torch.ops import SortField

    return [SortField(col("o_orderpriority")), SortField(col("o_totalprice"), ascending=False),
            SortField(col("o_orderkey"))]


def orders_sort_plan(scan, n_out: int = EXCHANGE_PARTS):
    """A global sort of orders: a range exchange, then a sort of each
    partition."""
    from blaze_tpu_torch.ops import SortExec
    from blaze_tpu_torch.parallel import RangePartitioning
    from blaze_tpu_torch.parallel.exchange import NativeShuffleExchangeExec

    fields = orders_sort_fields()
    return SortExec(NativeShuffleExchangeExec(scan, RangePartitioning(fields, n_out)), fields)


def by_priority(child, n_out: int):
    """count(*) and sum(o_totalprice) by o_orderpriority."""
    from blaze_tpu_torch.exprs.ir import col
    from blaze_tpu_torch.ops import AggFunction, GroupingExpr
    from blaze_tpu_torch.tpch.queries import two_stage_agg

    return two_stage_agg(child, [GroupingExpr(col("o_orderpriority"), "o_orderpriority")],
                         [AggFunction("count_star", None, "n"), AggFunction("sum", col("o_totalprice"), "total")],
                         n_out)


def repartition_plan(scan, n_out: int = EXCHANGE_PARTS):
    """``df.repartition(n_out)`` (a round-robin exchange), then the
    count and sum by o_orderpriority."""
    from blaze_tpu_torch.parallel import RoundRobinPartitioning
    from blaze_tpu_torch.parallel.exchange import NativeShuffleExchangeExec

    return by_priority(NativeShuffleExchangeExec(scan, RoundRobinPartitioning(n_out)), n_out)


def skipping_plan(scan, n_out: int = EXCHANGE_PARTS):
    """count(*) and sum(o_totalprice) by the unique o_orderkey over a
    hash exchange: every partial agg's groups are its rows."""
    from blaze_tpu_torch.exprs.ir import col
    from blaze_tpu_torch.ops import AggFunction, GroupingExpr
    from blaze_tpu_torch.tpch.queries import two_stage_agg

    return two_stage_agg(scan, [GroupingExpr(col("o_orderkey"), "o_orderkey")],
                         [AggFunction("count_star", None, "n"), AggFunction("sum", col("o_totalprice"), "total")],
                         n_out)


def round_robin_sizes(task_rows, n_out: int, staggered: bool) -> list:
    """Rows each round-robin partition gets by the reference's formula:
    row i of map task m to ``(i + start) % n_out``, ``start`` m in
    process and 0 in a writer."""
    import numpy as np

    sizes = np.zeros(n_out, np.int64)
    for m, rows in enumerate(task_rows):
        start = m % n_out if staggered else 0
        sizes += np.bincount((np.arange(rows) + start) % n_out, minlength=n_out)
    return sizes.tolist()


def task_rows_of(table: dict, n_parts: int) -> list:
    """Rows of each map task of a table split by ``table_to_batches``."""
    n = next(iter(table.values()))[0].shape[0]
    return [(p + 1) * n // n_parts - p * n // n_parts for p in range(n_parts)]


def priority_strings(orders: dict):
    """o_orderpriority as a numpy bytes array."""
    import numpy as np

    data = np.ascontiguousarray(orders["o_orderpriority"][0])
    return data.view(f"S{data.shape[1]}").ravel()


def orders_sort_oracle(orders: dict) -> dict:
    """The global sort's rows in order, by numpy's lexsort."""
    import numpy as np

    key, prio, price = orders["o_orderkey"][0], priority_strings(orders), orders["o_totalprice"][0]
    order = np.lexsort((key, -price, prio))
    return {"o_orderkey": key[order].tolist(), "o_orderpriority": [p.decode() for p in prio[order]],
            "o_totalprice": price[order].tolist()}


def priority_oracle(orders: dict) -> dict:
    """count(*) and sum(o_totalprice) by o_orderpriority."""
    import numpy as np

    names, inv = np.unique(priority_strings(orders), return_inverse=True)
    sums = np.zeros(len(names), np.int64)
    np.add.at(sums, inv, orders["o_totalprice"][0])
    return {n.decode(): (int(c), int(s)) for n, c, s in zip(names, np.bincount(inv), sums)}


def exchange_node(plan, kinds):
    """The plan's first exchange whose partitioning is one of ``kinds``."""
    from blaze_tpu_torch.parallel.exchange import NativeShuffleExchangeExec

    if isinstance(plan, NativeShuffleExchangeExec) and isinstance(plan.partitioning, kinds):
        return plan
    for c in plan.children:
        found = exchange_node(c, kinds)
        if found is not None:
            return found
    return None


def exchange_paths(torch, cuda_ops, label: str, build, kinds, launches_of: dict) -> dict:
    """``build()``'s plan in process (through the optimizer, each
    partition read in turn) and through split_stages/run_stages, the
    launch counts and ``PARTIAL_TOTALS`` reset before each: the walls,
    the ``.data`` bytes, the rows of each partition of the exchange of
    ``kinds``, the peaks above what the run held, the partial aggs'
    skips, rows and batches, the launches, and each path's rows in the
    order they came."""
    from blaze_tpu_torch.batch import batch_to_pydict
    from blaze_tpu_torch.ops import agg as A
    from blaze_tpu_torch.runtime.context import TaskContext
    from blaze_tpu_torch.runtime.scheduler import RunStats, split_stages

    rec = {"run": label}
    for path in ("inproc", "run_stages"):
        cuda_ops.reset_launch_counts()
        A.reset_partial_totals()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        plan = optimized(build()) if path == "inproc" else build()
        ex = exchange_node(plan, kinds)
        if path == "inproc":
            n = plan.num_partitions()
            batches = [b for p in range(n) for b in plan.execute(p, TaskContext(p, n))]
            schema = plan.schema
        else:
            stats = RunStats()
            stages, manager = split_stages(plan)
            batches, schema = run_clean(label, stages, manager, stats), stages[-1].plan.schema
        torch.cuda.synchronize()
        rec[f"{path}_wall_s"] = time.perf_counter() - t0
        rec[f"{path}_peak_mib"] = round((torch.cuda.max_memory_allocated() - base) / 2**20, 1)
        if path == "inproc":
            rec["inproc_partition_rows"] = [sum(b.num_rows for b in part) for part in ex._outputs]
        else:
            rec["data_bytes"], rec["tasks"] = stats.data_bytes, stats.tasks
            rec["run_stages_partition_rows"] = stats.read_rows[ex.shuffle_id]
            rec["stage_seconds"] = stats.stage_seconds
        rec[f"{path}_partial"] = dict(A.PARTIAL_TOTALS)
        launches_of[label if path == "inproc" else f"{label} (run_stages)"] = dict(cuda_ops.LAUNCHES)
        out = {f.name: [] for f in schema.fields}
        for b in batches:
            for k, v in batch_to_pydict(b).items():
                out[k].extend(v)
        rec[f"{path}_rows"] = out
        del batches
    rec["launches"] = launches_of[label]
    return rec


def exchange_phase(torch, cuda_ops, flush, card: str, data, scale: float, n_parts: int, batch_rows: int) -> tuple:
    """The exchanges (see the module docstring, step 11).  Returns the
    launches of each run and the kernel checks on their inputs."""
    import numpy as np

    from blaze_tpu_torch import conf
    from blaze_tpu_torch.parallel import RangePartitioning, RoundRobinPartitioning
    from blaze_tpu_torch.parallel.shuffle import HashPartitioning
    from blaze_tpu_torch.tpch import TPCH_SCHEMAS

    t_phase = time.perf_counter()
    launches_of: Dict[str, dict] = {}
    records, checks = [], []
    orders = data["orders"]
    n_out = EXCHANGE_PARTS
    oscan = sub_scan(orders, TPCH_SCHEMAS["orders"], ORDERS_COLUMNS, n_parts, batch_rows, "cuda")
    # the skipping agg in 2^14-row batches: a map task folds its first
    # batches before it skips, and streams the rest unmerged
    kscan = sub_scan(orders, TPCH_SCHEMAS["orders"], ("o_orderkey", "o_totalprice"), n_parts, MERGE_BATCH_ROWS,
                     "cuda")
    n_orders = orders["o_orderkey"][0].shape[0]
    with largest_inputs(cuda_ops) as seen:
        # ---- q01 as Spark plans it: equal to q01's oracle row for row
        q1_scans = query_scans(data, "q1", n_parts, batch_rows)
        rec = exchange_paths(torch, cuda_ops, "exchanges: q01 as Spark plans it",
                             lambda: spark_q01_plan(q1_scans, n_parts), RangePartitioning, launches_of)
        for path in ("inproc", "run_stages"):
            check_oracle(data, "q1", rec.pop(f"{path}_rows"))
        # four groups over 8 partitions: the exact order statistics put
        # them at 1, 3, 5 and 7
        if rec["inproc_partition_rows"] != [0, 1, 0, 1, 0, 1, 0, 1]:
            raise AssertionError(f"q01's range partitions in process: {rec['inproc_partition_rows']}")
        records.append(rec)
        del q1_scans
        # ---- a global sort of orders
        want = orders_sort_oracle(orders)
        rec = exchange_paths(torch, cuda_ops, "exchanges: global sort of orders",
                             lambda: orders_sort_plan(oscan), RangePartitioning, launches_of)
        for path in ("inproc", "run_stages"):
            got = rec.pop(f"{path}_rows")
            if got != want:
                raise AssertionError(f"global sort of orders, {path}: not numpy's lexsort order")
            if sum(rec[f"{path}_partition_rows"]) != n_orders:
                raise AssertionError(f"global sort of orders, {path}: partitions {rec[f'{path}_partition_rows']}")
        # the key is a total order: exact order statistics cut even partitions
        cuts = [0] + [min(n_orders - 1, n_orders * (i + 1) // n_out) for i in range(n_out - 1)] + [n_orders]
        if rec["inproc_partition_rows"] != np.diff(cuts).tolist():
            raise AssertionError(f"global sort in process: partitions {rec['inproc_partition_rows']}")
        records.append(rec)
        # ---- repartition(8), then a count and sum by priority
        want = priority_oracle(orders)
        task_rows = task_rows_of(orders, n_parts)
        rec = exchange_paths(torch, cuda_ops, "exchanges: repartition(8) then by priority",
                             lambda: repartition_plan(oscan), RoundRobinPartitioning, launches_of)
        for path, staggered in (("inproc", True), ("run_stages", False)):
            got = rec.pop(f"{path}_rows")
            rows = {p: (n, s) for p, n, s in zip(got["o_orderpriority"], got["n"], got["total"])}
            if rows != want:
                raise AssertionError(f"repartition then by priority, {path}: {rows} != numpy's {want}")
            if rec[f"{path}_partition_rows"] != round_robin_sizes(task_rows, n_out, staggered):
                raise AssertionError(f"repartition, {path}: partitions {rec[f'{path}_partition_rows']} != "
                                     f"{round_robin_sizes(task_rows, n_out, staggered)}")
        records.append(rec)
        # ---- a partial agg that skips, and the same with skipping off
        keys, prices = orders["o_orderkey"][0], orders["o_totalprice"][0]
        for enabled in (True, False):
            conf.ENABLE_PARTIAL_AGG_SKIPPING.set(enabled)
            try:
                rec = exchange_paths(torch, cuda_ops, f"exchanges: by o_orderkey, skipping {'on' if enabled else 'off'}",
                                     lambda: skipping_plan(kscan), HashPartitioning, launches_of)
            finally:
                conf.ENABLE_PARTIAL_AGG_SKIPPING.set(True)
            for path in ("inproc", "run_stages"):
                got = rec.pop(f"{path}_rows")
                order = np.argsort(got["o_orderkey"])
                if not (np.array_equal(np.asarray(got["o_orderkey"])[order], np.sort(keys))
                        and set(got["n"]) == {1}
                        and np.array_equal(np.asarray(got["total"])[order], prices[np.argsort(keys)])):
                    raise AssertionError(f"by o_orderkey, skipping {enabled}, {path}: not numpy's rows")
                skipped = rec[f"{path}_partial"]["partial_skipped"]
                if skipped != (n_parts if enabled else 0):
                    raise AssertionError(f"by o_orderkey, skipping {enabled}, {path}: {skipped} of {n_parts} "
                                         f"map tasks skipped")
            records.append(rec)
    for key, (_, inputs) in sorted(seen.items()):
        if key.startswith("murmur3_pids"):
            planes, widths, valids, parts = inputs
            checks.append(("murmur3_pids", check_murmur3(torch, cuda_ops, flush, planes, widths, valids,
                                                         "(exchanges)", timed=False, n_parts=parts)))
        elif key.startswith("pid_histogram"):
            pids, parts = inputs
            checks.append(("pid_histogram", check_pid_histogram(torch, cuda_ops, flush, pids, parts,
                                                                "(exchanges)", timed=False)))
    if {name for name, _ in checks} != {"murmur3_pids", "pid_histogram"}:
        raise AssertionError(f"exchanges: kernels held {[name for name, _ in checks]}")
    for name, r in checks:
        log_check(name, r)
    for rec in records:
        rec["card"] = card
        log(f"{rec['run']}: = numpy on both paths; walls {rec['inproc_wall_s']:.4f} s in process, "
            f"{rec['run_stages_wall_s']:.4f} s through run_stages, .data {rec['data_bytes']} bytes, partitions "
            f"{rec['inproc_partition_rows']} / {rec['run_stages_partition_rows']}, peaks {rec['inproc_peak_mib']} / "
            f"{rec['run_stages_peak_mib']} MiB, partial aggs {rec['inproc_partial']} / {rec['run_stages_partial']} "
            f"on {card}; launches {rec['launches']}")
        log("exchanges " + json.dumps(rec))
    seconds = time.perf_counter() - t_phase
    log(f"exchanges phase: {seconds:.1f} s (budget {EXCHANGE_BUDGET_S:.0f} s)")
    return launches_of, checks, seconds


# ---- the faults phase: recovery under injected faults, through run_stages
FAULTS_BUDGET_S = 40.0
# the recovery counters of RunStats; a run's expectation names those
# that move, and every other must stay 0
RECOVERY_COUNTERS = ("task_retries", "task_timeouts", "fetch_failures", "map_stage_reruns", "map_tasks_rerun",
                     "broadcast_stage_reruns", "speculative_attempts", "speculative_won", "speculative_lost",
                     "worker_lost")
# q03 at --scale in 8 partitions: its stages are a broadcast stage of 8
# tasks (run_task calls 1-8, broadcast.write hits 1-8), then four map
# stages of 8 tasks each (the first map stage's commits are
# shuffle.write hits 1-8), then the result
FAULT_MATRIX = (
    ("task.compute@2@a0", "a task body crashes (broadcast task 1)", {"task_retries": 1}),
    ("shuffle.write@1", "a map commit fails (the first map stage's task 0), no .inprogress file left",
     {"task_retries": 1}),
    # fetches 1-8 are the broadcast's 8 blobs (read by the consumer's task
    # 0; its other tasks hit the join-map cache): 9 is the first shuffle block
    ("shuffle.fetch@9@a0", "an injected fetch failure (no map ids) on the first shuffle block re-runs the whole "
     "map stage", {"fetch_failures": 1, "map_stage_reruns": 1, "map_tasks_rerun": 8}),
    ("shuffle.write@3@corrupt", "the third committed map output gets a flipped byte, the checksum catches it, "
     "only the map task that wrote it re-runs", {"fetch_failures": 1, "map_stage_reruns": 1, "map_tasks_rerun": 1}),
    ("broadcast.write@1@corrupt", "a corrupt broadcast blob regenerates the broadcast stage",
     {"fetch_failures": 1, "broadcast_stage_reruns": 1}),
)
EXHAUSTED_SPEC = "task.compute@1@a0,task.compute@2@a1,task.compute@3@a2"
# the first map stage's third commit: one of its tasks 1-4 (4 at a time,
# after task 0 alone), which of them the log says
STRAGGLER_SPEC = "shuffle.write@3@slow2000"


@contextlib.contextmanager
def slow_hits():
    """Records (site, attempt, detail, seconds) of every fault-site
    probe made inside the block that took over 50 ms: which task an
    ``@slow`` rule held, and for how long (until its cancellation woke
    it, or its whole sleep)."""
    from blaze_tpu_torch.runtime import faults

    seen, real = [], faults.hit

    def hit(site, attempt=0, detail="", cancel=None):
        t0 = time.perf_counter()
        try:
            real(site, attempt, detail, cancel)
        finally:
            if time.perf_counter() - t0 > 0.05:
                seen.append((site, attempt, os.path.basename(detail), round(time.perf_counter() - t0, 4)))

    faults.hit = hit
    try:
        yield seen
    finally:
        faults.hit = real


def fault_run(torch, cuda_ops, build, spec: str, max_task_attempts=None, backoff: float = 0.0, knobs=()) -> dict:
    """``build()``'s plan through split_stages/run_stages under the
    fault schedule ``spec``, ``spark.blaze.task.retryBackoff`` ``backoff``
    and the conf ``knobs`` ((entry, value) pairs), all restored after;
    the launch counts reset just before.  Returns the rows, the wall
    (from the split to the last batch, synchronized), the run's
    RunStats, the launches, the peak device memory above what the run
    held, and what the shuffle directory held at the last batch.
    RESOURCES must be empty and the directory gone after it."""
    from blaze_tpu_torch import conf
    from blaze_tpu_torch.batch import batch_to_pydict
    from blaze_tpu_torch.runtime import faults
    from blaze_tpu_torch.runtime.context import RESOURCES
    from blaze_tpu_torch.runtime.scheduler import RunStats, run_stages, split_stages

    entries = [(conf.FAULTS_SPEC, spec), (conf.TASK_RETRY_BACKOFF, backoff), *knobs]
    saved = [(e, e.get()) for e, _ in entries]
    for e, v in entries:
        e.set(v)
    faults.reset()
    stats, manager, batches, left = RunStats(), None, [], []
    try:
        cuda_ops.reset_launch_counts()
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        stages, manager = split_stages(build())
        for b in run_stages(stages, manager, stats, max_task_attempts):
            batches.append(b)
            left = os.listdir(manager.root)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - held
    finally:
        for e, v in saved:
            e.set(v)
        faults.reset()
        if len(RESOURCES) or (manager is not None and os.path.exists(manager.root)):
            raise AssertionError(f"{spec}: run_stages left resources {RESOURCES.keys()} or its directory")
    rows = {f.name: [] for f in stages[-1].plan.schema.fields}
    for b in batches:
        for k, v in batch_to_pydict(b).items():
            rows[k].extend(v)
    return {"spec": spec, "rows": rows, "wall_s": wall, "stats": stats, "launches": dict(cuda_ops.LAUNCHES),
            "peak_above_held_mib": round(peak / 2**20, 1), "left": left}


def counters_of(stats) -> dict:
    return {"task_attempts": stats.task_attempts, "tasks": stats.tasks,
            **{c: getattr(stats, c) for c in RECOVERY_COUNTERS}}


def require_counters(label: str, stats, want: dict) -> None:
    got = {c: getattr(stats, c) for c in RECOVERY_COUNTERS}
    if got != {c: want.get(c, 0) for c in RECOVERY_COUNTERS}:
        raise AssertionError(f"{label}: recovery counters {got}, not {want}")


def run_clean(label: str, stages, manager, stats=None, pool=None) -> list:
    """run_stages's batches where nothing may be recovered: every run
    outside the faults phase and the pool phase's injected runs.
    run_stages retries a failed task (a CUDA launch error among them)
    and re-runs a lost map output, so a fault that goes away on a second
    try would pass unseen; here any retry, timeout, fetch failure,
    re-run, speculative attempt or lost worker fails the smoke."""
    from blaze_tpu_torch.runtime.scheduler import RunStats, run_stages

    stats = RunStats() if stats is None else stats
    batches = list(run_stages(stages, manager, stats, pool=pool))
    require_counters(f"{label} (outside the faults phase)", stats, {})
    return batches


def faults_phase(torch, cuda_ops, flush, card: str, data, scale: float, n_parts: int, batch_rows: int) -> tuple:
    """TPC-H q03 at ``--scale`` through run_stages, fault-free, then
    under each fault of FAULT_MATRIX, each equal to the fault-free rows
    bit for bit and to q03's oracle, its recovery counters as expected;
    the retry budget used up (TaskRetriesExhausted); one retry with the
    default backoff; a straggler raced by a speculative backup, and the
    same straggler as a wedge retried; q01 as Spark plans it with its
    boundary pass's fetch failing.  Then ``murmur3_pids``,
    ``pid_histogram`` and ``sorted_lookup`` against their plain versions
    on the largest inputs the phase gave them.  Returns the launches of
    each run, the kernel checks and the phase's seconds."""
    from blaze_tpu_torch import conf
    from blaze_tpu_torch.runtime.context import RESOURCES
    from blaze_tpu_torch.runtime.retry import RetryPolicy, TaskRetriesExhausted

    t_phase = time.perf_counter()
    launches_of: Dict[str, dict] = {}
    records, checks = [], []
    scans = query_scans(data, "q3", n_parts, batch_rows)
    q3 = lambda: build_plan("q3", scans, n_parts)  # noqa: E731

    def record(label: str, r: dict, base: dict = None) -> dict:
        launches = {k: r["launches"][k] for k in LAUNCH_KEYS}
        rec = {"run": label, "spec": r["spec"], "equal_to": "the fault-free rows and the oracle" if base is not None
               else "the oracle", "wall_s": r["wall_s"], **counters_of(r["stats"]),
               "launches": launches, "peak_above_held_mib": r["peak_above_held_mib"], "card": card}
        if base is not None:
            rec["excess_launches"] = {k: launches[k] - base["launches"][k] for k in LAUNCH_KEYS}
            if any(v < 0 for v in rec["excess_launches"].values()):
                raise AssertionError(f"faults {label}: launched {launches}, fewer than fault-free {base['launches']}")
        launches_of[f"faults: {label}"] = r["launches"]
        records.append(rec)
        return rec

    with largest_inputs(cuda_ops) as seen:
        free = fault_run(torch, cuda_ops, q3, "")
        check_oracle(data, "q3", free["rows"])
        require_counters("faults q03 fault-free", free["stats"], {})
        base = record("q03 fault-free", free)
        # ---- the matrix, backoff 0
        for spec, shows, want in FAULT_MATRIX:
            r = fault_run(torch, cuda_ops, q3, spec)
            if r["rows"] != free["rows"]:
                raise AssertionError(f"faults q03 {spec}: rows {r['rows']} != fault-free {free['rows']}")
            check_oracle(data, "q3", r["rows"])
            require_counters(f"faults q03 {spec}", r["stats"], want)
            if any(".inprogress" in f for f in r["left"]):
                raise AssertionError(f"faults q03 {spec}: left {r['left']}")
            record(f"q03 {spec} ({shows})", r, base)
        # ---- the budget used up: the broadcast stage's task 0 fails 3 times of 3
        try:
            fault_run(torch, cuda_ops, q3, EXHAUSTED_SPEC, max_task_attempts=3)
        except TaskRetriesExhausted as e:
            said = str(e)
            if not all(w in said for w in ("stage 0", "task 0", "3 attempt", "task.compute")) or len(RESOURCES):
                raise AssertionError(f"faults q03 {EXHAUSTED_SPEC}: {said}; resources {RESOURCES.keys()}")
        else:
            raise AssertionError(f"faults q03 {EXHAUSTED_SPEC} with 3 attempts: no TaskRetriesExhausted")
        log(f"faults q03 {EXHAUSTED_SPEC} with max_task_attempts 3: TaskRetriesExhausted ({said}); "
            f"RESOURCES empty, the shuffle directory gone")
        # ---- one retry with the default backoff: its seconds
        r = fault_run(torch, cuda_ops, q3, FAULT_MATRIX[0][0], backoff=float(conf.TASK_RETRY_BACKOFF.default))
        if r["rows"] != free["rows"]:
            raise AssertionError("faults q03 with the default backoff: rows differ")
        rec = record(f"q03 {FAULT_MATRIX[0][0]}, backoff {conf.TASK_RETRY_BACKOFF.default} s", r, base)
        rec["backoff_s"] = RetryPolicy(backoff_base=float(conf.TASK_RETRY_BACKOFF.default)).backoff(0, 1, 0)
        # ---- a straggler: speculation wins it, or wedge detection retries it
        for label, knobs, want in (
                # a backup for a task past 3 x the median and 0.5 s alone:
                # a healthy task that a neighbour's GIL slowed gets none
                ("speculation on (multiplier 3, minRuntime 0.5 s), 4 tasks at a time",
                 ((conf.STAGE_TASK_CONCURRENCY, 4), (conf.SPECULATION_ENABLE, True),
                  (conf.SPECULATION_MULTIPLIER, 3.0), (conf.SPECULATION_MIN_RUNTIME, 0.5)),
                 {"speculative_attempts": 1, "speculative_won": 1}),
                ("speculation off, task.wedgeMs 500, 4 tasks at a time",
                 ((conf.STAGE_TASK_CONCURRENCY, 4), (conf.TASK_WEDGE_MS, 500)),
                 {"task_retries": 1, "task_timeouts": 1})):
            with slow_hits() as held_by:
                r = fault_run(torch, cuda_ops, q3, STRAGGLER_SPEC, knobs=knobs)
            if r["rows"] != free["rows"]:
                raise AssertionError(f"faults q03 {STRAGGLER_SPEC}, {label}: rows differ")
            require_counters(f"faults q03 {STRAGGLER_SPEC}, {label}", r["stats"], want)
            if want.get("speculative_won") and r["wall_s"] >= free["wall_s"] + 2.0:
                raise AssertionError(f"faults q03 {STRAGGLER_SPEC}, {label}: wall {r['wall_s']:.4f} s, the "
                                     f"fault-free {free['wall_s']:.4f} s + 2 s or more")
            rec = record(f"q03 {STRAGGLER_SPEC}, {label}", r, base)
            rec["held"] = held_by  # (site, attempt, the map output's file, seconds slept)
        # ---- q01 as Spark plans it: the boundary pass's fetch fails
        q1_scans = query_scans(data, "q1", n_parts, batch_rows)
        r = fault_run(torch, cuda_ops, lambda: spark_q01_plan(q1_scans, n_parts), "shuffle.fetch@1@a0")
        check_oracle(data, "q1", r["rows"])
        st = r["stats"]
        if st.fetch_failures < 1 or st.map_stage_reruns < 1:
            raise AssertionError(f"faults q01's boundary pass: {counters_of(st)}")
        record("q01 as Spark plans it, shuffle.fetch@1@a0 (the boundary pass's first fetch)", r)
        del q1_scans
    probed = set()
    for key, (_, inputs) in sorted(seen.items()):
        if key.startswith("murmur3_pids"):
            planes, widths, valids, parts = inputs
            checks.append(("murmur3_pids", check_murmur3(torch, cuda_ops, flush, planes, widths, valids,
                                                         "(faults)", timed=False, n_parts=parts)))
        elif key.startswith("pid_histogram"):
            pids, parts = inputs
            checks.append(("pid_histogram", check_pid_histogram(torch, cuda_ops, flush, pids, parts, "(faults)",
                                                                timed=False)))
        elif id(inputs[1]) not in probed:  # one call can have both the most probes and the longest table
            probed.add(id(inputs[1]))
            checks.append(("sorted_lookup", check_sorted_lookup(torch, cuda_ops, flush, *inputs,
                                                                f"(faults, {key[14:]})", timed=False)))
    if {name for name, _ in checks} != set(LAUNCH_KEYS):
        raise AssertionError(f"faults: kernels held {[name for name, _ in checks]}")
    for name, r in checks:
        log_check(name, r)
    for rec in records:
        log(f"faults {rec['run']}: = {rec['equal_to']}; wall {rec['wall_s']:.4f} s, attempts "
            f"{rec['task_attempts']}, retries {rec['task_retries']}, fetch failures {rec['fetch_failures']}, map "
            f"stage re-runs {rec['map_stage_reruns']} ({rec['map_tasks_rerun']} tasks), broadcast re-runs "
            f"{rec['broadcast_stage_reruns']}, speculative {rec['speculative_attempts']} / won "
            f"{rec['speculative_won']}, peak {rec['peak_above_held_mib']} MiB above what the run held, on {card}; "
            f"launches {rec['launches']}, excess {rec.get('excess_launches')}")
        log("faults " + json.dumps(rec))
    seconds = time.perf_counter() - t_phase
    log(f"faults phase: {seconds:.1f} s (budget {FAULTS_BUDGET_S:.0f} s)")
    return launches_of, checks, seconds


# ------------------------------------------------ map-mode joins and zstd

MAP_ZSTD_BUDGET_S = 60.0
# the zstd runs' scale: the file phase's, whose tables and oracles they share
ZSTD_SCALE = FILE_SCALE
# the columns of the zstd files: what q06 (parquet) and q01 (ORC) read
ZSTD_FILES = {"parquet": ("q6", ("l_quantity", "l_extendedprice", "l_discount", "l_shipdate")),
              "orc": ("q1", ("l_returnflag", "l_linestatus", "l_quantity", "l_extendedprice", "l_discount", "l_tax",
                             "l_shipdate"))}
ZSTD_FIXTURES = REPO / "tests" / "data" / "zstd"


def map_mode(plan, join=None, exchange=None, build_map=None):
    """``plan`` with each broadcast join's build side
    ``BroadcastExchangeExec(child)`` rewritten into
    ``BroadcastExchangeExec(BroadcastJoinBuildHashMapExec(child, build
    keys))``: the broadcast carries the serialized join map, as Spark
    plans a map-mode broadcast.  The classes are the port's unless
    given (``tests/test_torch_broadcast_map.py`` copies this helper and
    passes the reference's)."""
    if join is None:
        from blaze_tpu_torch.ops.joins import BroadcastJoinBuildHashMapExec as build_map, BroadcastJoinExec as join
        from blaze_tpu_torch.parallel.broadcast import BroadcastExchangeExec as exchange
    for i, c in enumerate(list(plan.children)):
        plan.children[i] = map_mode(c, join, exchange, build_map)
    if isinstance(plan, join) and isinstance(plan.children[0], exchange):
        child = plan.children[0].children[0]
        return join(exchange(build_map(child, plan.build_keys)), plan.children[1], plan.build_keys, plan.probe_keys,
                    plan.join_type, plan.build_is_left, build_data_schema=child.schema,
                    cached_build_id=plan.cached_build_id)
    return plan


def zstd_files_job(fmt: str, directory: str, n_parts: int, batch_rows: int) -> tuple:
    return ("zstd files", ("files", FILE_SCALE), fmt, directory, n_parts, batch_rows)


def write_zstd_files(tables: dict, fmt: str, directory: str, n_parts: int, batch_rows: int) -> dict:
    """lineitem's ``ZSTD_FILES[fmt]`` columns as zstd parquet or ORC,
    one file a partition, by the port's writer (in a reference worker);
    returns the written groups and schema, and the bytes of the columns."""
    from blaze_tpu_torch.io import parquet as pq

    _, cols = ZSTD_FILES[fmt]
    lineitem = {c: tables["lineitem"][c] for c in cols}
    written = write_tables({"lineitem": lineitem}, ("lineitem",), directory, n_parts, batch_rows, fmt,
                           pq.CODEC_ZSTD if fmt == "parquet" else "zstd")
    return {"written": written, "column_bytes": sum(v[0].nbytes for v in lineitem.values())}


@contextlib.contextmanager
def joins_seen():
    """Collects every broadcast join and join-map node that runs inside
    the block, on either path (a decoded task's too), for their
    metrics."""
    from blaze_tpu_torch.ops.joins import BroadcastJoinBuildHashMapExec, BroadcastJoinExec

    seen: Dict[int, object] = {}
    lock = threading.Lock()
    reals = {cls: cls.execute for cls in (BroadcastJoinExec, BroadcastJoinBuildHashMapExec)}

    def wrap(real):
        def execute(self, partition, ctx):
            with lock:
                seen.setdefault(id(self), self)
            return real(self, partition, ctx)
        return execute

    for cls, real in reals.items():
        cls.execute = wrap(real)
    try:
        yield seen
    finally:
        for cls, real in reals.items():
            cls.execute = real


def join_metrics(seen) -> dict:
    """Map-mode metrics of the nodes :func:`joins_seen` collected:
    payload bytes, seconds building the map (the map node) and rebuilding
    it from its bytes (the joins; the build side's drain is outside that
    timer), cache hits."""
    from blaze_tpu_torch.ops.joins import BroadcastJoinBuildHashMapExec

    out = {"payload_bytes": 0, "build_hash_map_s": 0.0, "deserialize_s": 0.0, "hashmap_cache_hit": 0,
           "map_mode_joins": 0}
    for node in seen.values():
        v = node.metrics.values
        if isinstance(node, BroadcastJoinBuildHashMapExec):
            out["payload_bytes"] += v.get("payload_bytes", 0)
            out["build_hash_map_s"] += v.get("build_hash_map_time", 0) / 1e9
        elif node.map_mode:
            out["map_mode_joins"] += 1
            out["deserialize_s"] += v.get("build_hash_map_time", 0) / 1e9
            out["hashmap_cache_hit"] += v.get("hashmap_cache_hit", 0)
    return out


@contextlib.contextmanager
def zstd_timing():
    """Bytes and seconds of every zstd compress and decompress made
    inside the block (frames, parquet pages, ORC chunks), on any
    thread."""
    from blaze_tpu_torch.io import ipc_compression as IC, orc, parquet

    acc = {"compressed_in": 0, "compress_s": 0.0, "decompressed_out": 0, "decompress_s": 0.0}
    lock = threading.Lock()
    mods = (IC, parquet, orc)
    reals = [(m, m.zstd_compress, m.zstd_decompress) for m in mods]
    real_c, real_d = IC.zstd_compress, IC.zstd_decompress

    def compress(data, *a, **k):
        t0 = time.perf_counter()
        out = real_c(data, *a, **k)
        with lock:
            acc["compressed_in"] += len(data)
            acc["compress_s"] += time.perf_counter() - t0
        return out

    def decompress(data):
        t0 = time.perf_counter()
        out = real_d(data)
        with lock:
            acc["decompressed_out"] += len(out)
            acc["decompress_s"] += time.perf_counter() - t0
        return out

    for m in mods:
        m.zstd_compress, m.zstd_decompress = compress, decompress
    try:
        yield acc
    finally:
        for m, c, d in reals:
            m.zstd_compress, m.zstd_decompress = c, d


def mb_per_s(nbytes: int, seconds: float):
    return round(nbytes / seconds / 1e6, 3) if seconds else None


def map_zstd_phase(torch, cuda_ops, flush, card: str, data, file_tables, zstd_dir: str, scale: float, n_parts: int,
                   batch_rows: int, runs: dict, sched_runs: dict, inproc: dict) -> tuple:
    """Map-mode broadcast joins and the zstd codec.  (1) TPC-H q03 at
    ``--scale`` with its broadcast carrying the serialized join map
    (:func:`map_mode`) in process and through ``run_stages``: rows equal
    to the oracle and to the raw-mode run of the queries phase, launches
    equal to raw mode's on each path (``runs``, ``sched_runs``); then
    ``broadcast.write@1@corrupt`` in map mode, recovered by one broadcast
    re-run; ``sorted_lookup`` held to its plain version on the largest
    deserialized table and probes.  (2) Under
    ``spark.io.compression.codec=zstd`` at SF ``ZSTD_SCALE``: q03
    through ``run_stages`` against the same run under zlib (rows,
    launches, ``.data`` bytes), q06 from zstd parquet and q01 from zstd
    ORC written by the port's writer under ``zstd_dir`` (in a reference worker), in
    process, each equal to its oracle; the committed ``zstandard``
    fixtures decoded to their SHA-256.  Prints one ``map_zstd`` record a
    run with walls, compress and decompress MB/s and the card's name and
    power limit.  Returns the launches of each run, the kernel checks
    and the phase's seconds."""
    import hashlib

    from blaze_tpu_torch import conf
    from blaze_tpu_torch.io import zstd as Z

    t_phase = time.perf_counter()
    launches_of: Dict[str, dict] = {}
    records, checks = [], []

    def record(label: str, launches: dict, **fields) -> dict:
        rec = {"run": label, **fields, "launches": {k: launches[k] for k in LAUNCH_KEYS}, "card": card}
        launches_of[f"map/zstd: {label}"] = launches
        records.append(rec)
        return rec

    # ---- (1) map mode at --scale, both paths
    scans = query_scans(data, "q3", n_parts, batch_rows)
    with largest_inputs(cuda_ops) as seen:
        for path in ("in process", "run_stages"):
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            with joins_seen() as nodes:
                if path == "in process":
                    got, wall, launches, _ = run_query(torch, cuda_ops, "q3", scans, n_parts, rewrite=map_mode)
                    raw = runs["q3"]
                else:
                    got, wall, launches, moved = run_scheduled(torch, cuda_ops, "q3", scans, n_parts,
                                                               rewrite=map_mode)
                    raw = sched_runs["q3"]
            peak = torch.cuda.max_memory_allocated() - held
            said = check_oracle(data, "q3", got)
            metrics = join_metrics(nodes)
            if got != inproc["q3"][0]:
                raise AssertionError(f"q03 in map mode ({path}): {got} != raw mode {inproc['q3'][0]}")
            if launches != raw or not launches["sorted_lookup"]:
                raise AssertionError(f"q03 in map mode ({path}) launched {launches}, raw mode {raw}")
            if not metrics["map_mode_joins"] or not metrics["payload_bytes"]:
                raise AssertionError(f"q03 in map mode ({path}): no map-mode join ran: {metrics}")
            rec = record(f"q03 SF{scale} in map mode, {path}", launches, equal_to="the oracle and raw mode",
                         said=said, wall_s=wall, raw_wall_s=inproc["q3"][1] if path == "in process" else None,
                         peak_above_held_mib=round(peak / 2**20, 1), **metrics)
            if path == "run_stages":
                rec.update(broadcast_bytes=moved["broadcast_bytes"], data_bytes=moved["data_bytes"],
                           tasks=moved["tasks"], kinds=moved["kinds"])
        r = fault_run(torch, cuda_ops, lambda: map_mode(build_plan("q3", scans, n_parts)),
                      "broadcast.write@1@corrupt")
        if r["rows"] != inproc["q3"][0]:
            raise AssertionError("q03 in map mode, broadcast.write@1@corrupt: rows differ")
        require_counters("q03 in map mode, broadcast.write@1@corrupt", r["stats"],
                         {"fetch_failures": 1, "broadcast_stage_reruns": 1})
        record("q03 in map mode, broadcast.write@1@corrupt (a corrupt map blob regenerates its stage)",
               r["launches"], equal_to="the oracle", wall_s=r["wall_s"], **counters_of(r["stats"]),
               peak_above_held_mib=r["peak_above_held_mib"])
    probed = set()
    for key, (_, inputs) in sorted(seen.items()):
        if key.startswith("sorted_lookup") and id(inputs[1]) not in probed:
            probed.add(id(inputs[1]))
            checks.append(("sorted_lookup", check_sorted_lookup(torch, cuda_ops, flush, *inputs,
                                                                f"(map mode, {key[14:]})", timed=False)))
    # ---- (2) zstd at ZSTD_SCALE
    zscans = query_scans(file_tables, "q3", n_parts, batch_rows)
    by_codec = {}
    for codec in ("zstd", "zlib"):
        conf.IO_COMPRESSION_CODEC.set(codec)
        try:
            with zstd_timing() as z:
                got, wall, launches, moved = run_scheduled(torch, cuda_ops, "q3", zscans, n_parts)
        finally:
            conf.IO_COMPRESSION_CODEC.set(conf.IO_COMPRESSION_CODEC.default)
        check_oracle(file_tables, "q3", got)
        by_codec[codec] = (got, launches, moved)
        record(f"q03 SF{ZSTD_SCALE} through run_stages, spark.io.compression.codec={codec}", launches,
               equal_to="the oracle", wall_s=wall, data_bytes=moved["data_bytes"],
               broadcast_bytes=moved["broadcast_bytes"], compress_mb_s=mb_per_s(z["compressed_in"], z["compress_s"]),
               decompress_mb_s=mb_per_s(z["decompressed_out"], z["decompress_s"]), **z)
        if codec == "zstd" and not (z["compressed_in"] and z["decompressed_out"]):
            raise AssertionError(f"q03 under spark.io.compression.codec=zstd wrote or read no zstd frame: {z}")
        if codec == "zlib" and (z["compressed_in"] or z["decompressed_out"]):
            raise AssertionError(f"q03 under spark.io.compression.codec=zlib went through zstd: {z}")
    if by_codec["zstd"][0] != by_codec["zlib"][0] or by_codec["zstd"][1] != by_codec["zlib"][1]:
        raise AssertionError(f"q03 under zstd: rows or launches differ from zlib's ({by_codec['zstd'][1]}, "
                             f"{by_codec['zlib'][1]})")
    if by_codec["zstd"][2]["data_bytes"] == by_codec["zlib"][2]["data_bytes"]:
        raise AssertionError("q03 under zstd: its .data bytes equal zlib's, so the codec did not change them")
    for fmt, (query, _) in ZSTD_FILES.items():
        made, write_s = REFERENCES.take(zstd_files_job(fmt, zstd_dir, n_parts, batch_rows))
        fscans = file_scans(made["written"], fmt, batch_rows)
        with zstd_timing() as z, scans_seen() as sseen:
            got, wall, launches, _ = run_query(torch, cuda_ops, query, fscans, n_parts)
        said = check_oracle(file_tables, query, got)
        require_launches(f"{query_label(query)} zstd {fmt}", launches, *EXPECTED_LAUNCHES[query])
        record(f"{query_label(query)} SF{ZSTD_SCALE} from zstd {fmt}, in process", launches, equal_to="the oracle",
               said=said, wall_s=wall, **scan_totals(sseen), decompress_mb_s=mb_per_s(z["decompressed_out"],
                                                                                   z["decompress_s"]),
               **z, written_by="the port's writer in a reference worker", write_s=write_s,
               write_mb_s=mb_per_s(made["column_bytes"], write_s))
    fixtures = json.loads((ZSTD_FIXTURES / "manifest.json").read_text())
    t0 = time.perf_counter()
    decoded = 0
    for name, want in sorted(fixtures.items()):
        if not isinstance(want, dict):
            continue
        out = Z.decompress((ZSTD_FIXTURES / f"{name}.zst").read_bytes())
        if hashlib.sha256(out).hexdigest() != want["sha256"]:
            raise AssertionError(f"zstd fixture {name}: decoded bytes differ from zstandard's")
        decoded += len(out)
    fix_s = time.perf_counter() - t0
    log(f"map/zstd: {sum(isinstance(v, dict) for v in fixtures.values())} zstandard fixture frames "
        f"({fixtures['zstandard_version']}) decoded to their SHA-256, {decoded} bytes in {fix_s:.4f} s "
        f"({mb_per_s(decoded, fix_s)} MB/s)")
    for name, r in checks:
        log_check(name, r)
    for rec in records:
        log("map_zstd " + json.dumps(rec))
    seconds = time.perf_counter() - t_phase
    log(f"map/zstd phase: {seconds:.1f} s (budget {MAP_ZSTD_BUDGET_S:.0f} s)")
    return launches_of, checks, seconds


# ------------------------------------------------ the worker pool

POOL_BUDGET_S = 60.0
POOL_WORKERS = 2
# each worker dies as its second job starts, owning one committed map output
POOL_KILL_SPEC = "worker.task@2@kill"
# a worker's first job stalls a minute: the cancel must kill it first
POOL_STALL_SPEC = "worker.task@1@slow60000"


def card_apps() -> list:
    """(pid, used memory) of every process with a context on the card,
    as ``nvidia-smi --query-compute-apps`` lists them."""
    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,used_memory", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    return [tuple(part.strip() for part in line.split(",")) for line in out.splitlines() if line.strip()]


class CancelAfterDispatch:
    """A pool whose first ``run_task`` starts a timer that cancels query
    ``query_id`` ``delay`` seconds later, while that job is in flight."""

    def __init__(self, pool, query_id: str, delay: float):
        self.pool, self.query_id, self.delay, self.timer = pool, query_id, delay, None

    def __getattr__(self, name):
        return getattr(self.pool, name)

    def run_task(self, spec, worker, timeout=300.0, scope=None):
        from blaze_tpu_torch.runtime.context import cancel_query

        if self.timer is None:
            self.timer = threading.Timer(self.delay, cancel_query, (self.query_id,))
            self.timer.start()
        return self.pool.run_task(spec, worker, timeout, scope)


def pool_phase(torch, cuda_ops, card: str, data, sf1_files: dict, scale: float, n_parts: int,
               batch_rows: int) -> tuple:
    """TPC-H q03 at ``--scale`` from the file phase's SF1 parquet files
    through ``run_stages``, unpooled and with a ``HostPool`` of two
    ``--serve`` workers on the card (see the module docstring, step 10).
    The unpooled run first; then three pools start at once (five worker
    processes: the healthy pool, the killed one, the stalled one) and the
    runs follow, each on its own pool.  (1) The pooled run: equal to the
    oracle and the unpooled run, the eligible map tasks owned by the
    workers, the driver's launches plus the workers' equal to the
    unpooled run's, ``murmur3_pids`` and ``pid_histogram`` launched in
    the workers; each worker's pid, spawn-to-ready seconds (its imports'
    share apart), context memory (the card's free bytes before the
    spawns against after ready, and each worker's own before and after
    loading the library), launches and jobs.  (2) ``worker.task@2@kill``
    with ``maxFailures=1``: equal to the oracle, recovered by partial
    re-runs, both slots blacklisted, degraded to in process.  (3) A
    cancel 1 s after a job stalled in a worker: ``QueryCancelledError``,
    the worker killed, no loss, no blacklist.  After the pools'
    ``close()`` the card holds the contexts it held before them, and no
    worker pid is alive or on the card.  Returns the launches of each
    run and the phase's seconds."""
    from blaze_tpu_torch import conf
    from blaze_tpu_torch.runtime.context import RESOURCES, QueryCancelledError, cancel_scope
    from blaze_tpu_torch.runtime.hostpool import HostPool
    from blaze_tpu_torch.runtime.scheduler import RunStats, ipc_readers, run_stages, split_stages

    t_phase = time.perf_counter()
    launches_of: Dict[str, dict] = {}
    records = []
    env = {"BLAZE_BATCHSIZE": str(batch_rows)}  # the workers decode the scans' batches as the driver does
    scans = file_scans(sf1_files, "parquet", batch_rows)
    label = f"q03 SF{scale} from parquet"

    def run(pool=None, clean: bool = True) -> tuple:
        """(rows, wall, the driver's launches, the workers', stats, the
        task counts of the stages the pool may host)."""
        from blaze_tpu_torch import batch as B

        before = pool.launches() if pool is not None else {}
        cuda_ops.reset_launch_counts()
        stages, manager = split_stages(build_plan("q3", scans, n_parts))
        eligible = [s.n_tasks for s in stages if s.kind == "map" and not ipc_readers(s.plan, "broadcast_")]
        stats = RunStats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if clean:
            batches = run_clean(label, stages, manager, stats, pool=pool)
        else:
            batches = list(run_stages(stages, manager, stats, pool=pool))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if len(RESOURCES) or os.path.exists(manager.root):
            raise AssertionError(f"{label}: run_stages left resources {RESOURCES.keys()} or {manager.root}")
        driver = dict(cuda_ops.LAUNCHES)
        after = pool.launches() if pool is not None else {}
        workers = {k: after.get(k, 0) - before.get(k, 0) for k in driver}
        rows = {f.name: [] for f in stages[-1].plan.schema.fields}
        for b in batches:
            for k, v in B.batch_to_pydict(b).items():
                rows[k].extend(v)
        return rows, wall, driver, workers, stats, eligible

    def total(a: dict, b: dict) -> dict:
        return {k: a.get(k, 0) + b.get(k, 0) for k in a}

    conf.BATCH_SIZE.set(batch_rows)
    pools = []
    try:
        base, base_wall, base_launches, _, base_stats, eligible = run()
        said = check_oracle(data, "q3", base)
        if not eligible:
            raise AssertionError(f"{label}: no map stage the pool may host")
        launches_of[f"pool: {label}, unpooled"] = base_launches
        # ---- the three pools start at once; each keeps the settings it started with
        apps_before = card_apps()
        torch.cuda.synchronize()
        free0 = torch.cuda.mem_get_info()[0]
        t0 = time.perf_counter()
        healthy = HostPool(POOL_WORKERS, env=env)
        pools.append(healthy)
        conf.HOST_BLACKLIST_MAX_FAILURES.set(1)
        try:
            killed = HostPool(POOL_WORKERS, env={**env, "BLAZE_FAULTS_SPEC": POOL_KILL_SPEC})
            pools.append(killed)
        finally:
            conf.HOST_BLACKLIST_MAX_FAILURES.set(conf.HOST_BLACKLIST_MAX_FAILURES.default)
        stalled = HostPool(1, env={**env, "BLAZE_FAULTS_SPEC": POOL_STALL_SPEC})
        pools.append(stalled)
        for pool in pools:
            if not pool.wait_ready(180.0):
                raise AssertionError(f"a worker never became ready: {pool.worker_telemetry()}")
        ready_s = time.perf_counter() - t0
        n_workers = sum(len(pool.pids()) for pool in pools)
        took = free0 - torch.cuda.mem_get_info()[0]
        pids = [pid for pool in pools for pid in pool.pids().values()]
        apps_alive = card_apps()
        if len(apps_alive) != len(apps_before) + n_workers:
            raise AssertionError(f"{n_workers} workers ready, but the card lists {apps_alive} against "
                                 f"{apps_before} before them")
        # ---- (1) q03 through the healthy pool
        got, wall, driver, workers, stats, _ = run(healthy)
        check_oracle(data, "q3", got)
        if got != base:
            raise AssertionError(f"{label} through the pool: {got} != unpooled {base}")
        summed = total(driver, workers)
        if summed != base_launches:
            raise AssertionError(f"{label} through the pool launched {driver} on the driver and {workers} in the "
                                 f"workers, unpooled {base_launches}")
        if not (workers["murmur3_pids"] and workers["pid_histogram"]):
            raise AssertionError(f"{label}: the workers launched {workers}: no murmur3_pids or pid_histogram")
        if healthy.owned_map_outputs() != sum(eligible) or healthy.blacklisted() or healthy.degraded():
            raise AssertionError(f"{label}: the pool owns {healthy.owned_map_outputs()} map outputs of "
                                 f"{sum(eligible)} eligible, blacklisted {healthy.blacklisted()}, degraded "
                                 f"{healthy.degraded()}")
        launches_of[f"pool: {label}, pooled"] = summed
        per_worker = [{"worker": r["worker"], "pid": r["pid"], "spawn_to_ready_s": r["ready_s"],
                       "imported_s": r["init"]["imported_s"], "init_s": r["init"]["init_s"],
                       "library_and_allocator_mib": (r["init"]["free_at_context"] - r["init"]["free_after_init"])
                       / 2**20, "jobs_ok": r["jobs_ok"], "jobs_failed": r["jobs_failed"],
                       "peak_allocated_mib": r["mem_peak"] / 2**20, "launches": r["launches"]}
                      for r in healthy.worker_telemetry()]
        spawns = [r["ready_s"] for pool in pools for r in pool.worker_telemetry()]
        records.append({"run": f"{label}, HostPool({POOL_WORKERS}) against unpooled", "said": said,
                        "wall_s": wall, "unpooled_wall_s": base_wall, "eligible_stage_tasks": eligible,
                        "owned_map_outputs": sum(eligible), "tasks": stats.tasks, "unpooled_tasks": base_stats.tasks,
                        "data_bytes": stats.data_bytes, "launches_driver": driver, "launches_workers": workers,
                        "launches_unpooled": base_launches, "workers_started_at_once": n_workers,
                        "all_ready_s": ready_s, "spawn_to_ready_s": [min(spawns), max(spawns)],
                        "card_mib_per_worker": took / n_workers / 2**20, "workers": per_worker,
                        "card_apps_before": apps_before, "card_apps_alive": apps_alive, "card": card})
        # ---- (2) a worker killed as its second job starts, in each slot
        got, wall, driver, workers, stats, _ = run(killed, clean=False)
        check_oracle(data, "q3", got)
        if got != base:
            raise AssertionError(f"{label} under {POOL_KILL_SPEC}: rows differ from the unpooled run's")
        state = (killed.blacklisted(), killed.degraded(), killed.stats())
        if (stats.worker_lost, stats.map_stage_reruns, stats.map_tasks_rerun) != (2, 2, 2) \
                or stats.map_tasks_rerun >= min(eligible) or state[0] != ["w0", "w1"] or not state[1]:
            raise AssertionError(f"{label} under {POOL_KILL_SPEC}: worker_lost {stats.worker_lost}, map stage "
                                 f"re-runs {stats.map_stage_reruns} of {stats.map_tasks_rerun} tasks, blacklisted "
                                 f"{state[0]}, degraded {state[1]}")
        launches_of[f"pool: {label}, {POOL_KILL_SPEC}"] = total(driver, workers)
        records.append({"run": f"{label}, {POOL_KILL_SPEC}, maxFailures=1 (partial re-runs, then in process)",
                        "equal_to": "the oracle and the unpooled run", "wall_s": wall,
                        "worker_lost": stats.worker_lost, "map_stage_reruns": stats.map_stage_reruns,
                        "map_tasks_rerun": stats.map_tasks_rerun, "map_stage_tasks": min(eligible),
                        "task_retries": stats.task_retries, "blacklisted": state[0], "degraded": state[1],
                        "pool_stats": state[2], "launches_driver": driver, "launches_workers": workers,
                        "card": card})
        # ---- (3) a cancel while a job stalls in a worker
        stuck = stalled.pids()["w0"]
        t0 = time.perf_counter()
        try:
            with cancel_scope("pool cancel"):
                run(CancelAfterDispatch(stalled, "pool cancel", 1.0), clean=False)
            raise AssertionError(f"{label}: the cancelled query ran to its end")
        except QueryCancelledError as e:
            cancelled = str(e)
        cancel_s = time.perf_counter() - t0
        state = (stalled.stats(), stalled.blacklisted(), stalled.lost_counts())
        if len(RESOURCES) or state[0]["worker_kills"] != 1 or state[1] or state[2]:
            raise AssertionError(f"{label}: the cancel left resources {RESOURCES.keys()}, pool {state}")
        try:
            os.kill(stuck, 0)
            raise AssertionError(f"{label}: the stalled worker {stuck} outlived the cancel")
        except ProcessLookupError:
            pass
        records.append({"run": f"{label}, cancelled 1 s after a job stalled in a worker ({POOL_STALL_SPEC})",
                        "raised": cancelled, "seconds_to_cancel": cancel_s, "pool_stats": state[0], "card": card})
    finally:
        conf.BATCH_SIZE.set(conf.BATCH_SIZE.default)
        for pool in pools:
            pool.close()
    apps = card_apps()
    for _ in range(20):  # a context goes with its process's exit: give the driver up to 10 s
        if len(apps) == len(apps_before):
            break
        time.sleep(0.5)
        apps = card_apps()
    alive = []
    for p in pids:
        try:
            os.kill(p, 0)
            alive.append(p)
        except ProcessLookupError:
            pass
    on_card = [p for p in pids if any(str(p) == a[0] for a in apps)]
    if alive or on_card or len(apps) != len(apps_before):
        raise AssertionError(f"after close(): worker pids {alive} alive, {on_card} on the card; the card lists "
                             f"{apps} against {apps_before} before the pools")
    records.append({"run": "after every pool's close()", "worker_pids": pids, "card_apps": apps, "card": card})
    for rec in records:
        log("pool " + json.dumps(rec))
    seconds = time.perf_counter() - t_phase
    log(f"pool phase: {seconds:.1f} s (budget {POOL_BUDGET_S:.0f} s)")
    return launches_of, seconds


def kept_scheduled(queries) -> tuple:
    """Those of ``queries`` that keep their run_stages path."""
    return tuple(q for q in queries if q not in SCHEDULED_CUT)


def end_phase(phases: list, name: str) -> None:
    """Notes, and prints, the seconds from the start of the script to the
    end of phase ``name``."""
    phases.append((name, time.perf_counter() - T0))
    log(f"phase {name} ended at {phases[-1][1]:.1f} s")


def query_label(query: str) -> str:
    """q6 -> "q06", ds_q7 -> "TPC-DS q07", ds_q14a -> "TPC-DS q14a"."""
    bench, name = ("TPC-DS ", query[3:]) if query.startswith("ds_") else ("", query)
    digits = name[1:].rstrip("ab")
    return f"{bench}q{int(digits):02d}{name[1 + len(digits):]}"


def check_decimal_to_double(torch) -> str:
    """decimal -> double on the card, held to numpy ``v / 10**s``
    exactly: decimal(12,2) 0.38 - double 1.5 through the lowering, then
    a seeded vector at four scales through the coercion.  Raises on any
    mismatch."""
    import numpy as np

    from blaze_tpu_torch.batch import column_from_numpy
    from blaze_tpu_torch.exprs import col
    from blaze_tpu_torch.exprs.compile import _coerce, lower
    from blaze_tpu_torch.schema import DataType, Field, Schema

    schema = Schema([Field("d", DataType.decimal(12, 2)), Field("x", DataType.float64())])
    env = {"d": column_from_numpy(DataType.decimal(12, 2), np.array([38]), capacity=1, device="cuda"),
           "x": column_from_numpy(DataType.float64(), np.array([1.5]), capacity=1, device="cuda")}
    got = lower(col("d") - col("x"), schema, env, 1).data.cpu().tolist()
    want = (np.array([38]) / 10**2 - 1.5).tolist()
    if got != want:
        raise AssertionError(f"decimal(12,2) 0.38 - double 1.5 on the card: {got!r} != numpy {want!r}")
    rng = np.random.default_rng(44)
    v = np.concatenate([[38, -38, 1, 10**12 - 1], rng.integers(-(10**12) + 1, 10**12, 1 << 20)])
    for scale in (0, 2, 4, 6):
        c = column_from_numpy(DataType.decimal(18, scale), v, capacity=len(v), device="cuda")
        out = _coerce(c, DataType.float64()).data.cpu().numpy()
        bad = int((out != v / 10**scale).sum())
        if bad:
            raise AssertionError(f"decimal(18,{scale}) -> double on the card: {bad} of {len(v)} values "
                                 f"differ from numpy")
    return f"0.38 - 1.5 = {got[0]!r} = numpy; {len(v)} values at scales 0, 2, 4, 6 = numpy"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=float, default=1.0, help="TPC-H scale factor (default 1.0)")
    ap.add_argument("--ds-scale", type=float, default=1.0, help="TPC-DS scale factor (default 1.0)")
    ap.add_argument("--uncut", action="store_true",
                    help="run every TPC-DS query through run_stages too: the depth before the cuts that keep the "
                         "smoke within its time, to time them")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port runs on the card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from blaze_tpu_torch.kernels import build, cuda_ops, sweep

    # 8 partitions and 2^20-row batches throughout; the host references
    # start now, beside the build
    n_parts, batch_rows = 8, 1 << 20
    zstd_dir = tempfile.mkdtemp(prefix="blaze-zstd-")
    start_references(args.scale, args.ds_scale, n_parts, batch_rows, zstd_dir)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log("torch", torch.__version__, "cuda", torch.version.cuda, "device", torch.cuda.get_device_name(0))

    # seconds on the host clock from the start of the script to the end of each phase
    phases = []

    # ---- build; beside it, the PR 3 pid_histogram design that the shipped one is timed against
    t0 = time.perf_counter()
    cuda_ops.reset_launch_counts()
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    pr3_so = Path(tempfile.mkdtemp(prefix="pr3-", dir=build.BUILD_DIR)) / "pid_histogram_pr3.so"
    pr3_build = sweep.compile_variant(sweep.PR3_HISTOGRAM_SOURCE, {}, pr3_so)
    build.library()
    pr3_log = pr3_build.communicate()[0]
    if pr3_build.returncode != 0:
        raise RuntimeError(f"nvcc failed on {sweep.PR3_HISTOGRAM_SOURCE}:\n{pr3_log}")
    pr3 = sweep.pr3_histogram(sweep.load_variant(pr3_so, *sweep.HISTOGRAM_SOURCES[sweep.PR3_HISTOGRAM_SOURCE]))
    shutil.rmtree(pr3_so.parent)  # loaded; the mapping outlives the file
    log(f"kernel build: {time.perf_counter() - t0:.2f} s "
        f"(nvcc {build.last_build.seconds:.2f} s, {build.last_build.path.name}; PR 3 pid_histogram beside it)")
    for line in (build.last_build.log + pr3_log).splitlines():
        if "ptxas info" in line:
            log("  " + line.strip())

    end_phase(phases, "build")
    # ---- host tables (set-up, not timed)
    t0 = time.perf_counter()
    data = query_data(TPCH_QUERIES + NEW_QUERIES, args.scale, ds=False)
    new_data = spec_data(data, args.scale)
    ds_data = query_data(ALL_DS_QUERIES, args.ds_scale, ds=True)
    register_tables(data, ("tpch", args.scale), "plain")
    register_tables(new_data, ("tpch", args.scale), "spec")
    register_tables(ds_data, ("tpcds", args.ds_scale), "plain")
    log(f"data at TPC-H SF{args.scale}, TPC-DS SF{args.ds_scale}: " + ", ".join(
        f"{k} {next(iter(v.values()))[0].shape[0]} rows" for k, v in (*data.items(), *ds_data.items()))
        + f" ({time.perf_counter() - t0:.1f} s)")

    end_phase(phases, "tables")
    # ---- kernels against their plain versions, main-path shapes
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    one = torch.zeros(1, device="cuda")
    log(f"timing floor: a one-element add_ reads {time_ms(torch, lambda: one.add_(1), 50, flush):.4f} ms "
        f"in time_ms")
    n = 1 << 20
    keys3 = ("int64", "date32", "int32")
    m1 = check_murmur3(torch, cuda_ops, flush, *murmur3_inputs(torch, cuda_ops, n, ("int64",), seed=1), "int64")
    m3 = check_murmur3(torch, cuda_ops, flush, *murmur3_inputs(torch, cuda_ops, n, keys3, seed=2),
                       "/".join(keys3))
    # ten keys: past one launch's eight, so two launches chained through the hash
    keys10 = keys3 * 3 + ("int64",)
    m10 = check_murmur3(torch, cuda_ops, flush, *murmur3_inputs(torch, cuda_ops, n, keys10, seed=4),
                        "/".join(keys10))
    sl = check_sorted_lookup(torch, cuda_ops, flush, *lookup_inputs(torch, 30000, n, seed=3), "")
    # 8 partitions: q01's and q03's exchanges (register bins); 200: Spark's
    # default shuffle partitions (shared-memory bins)
    h8 = check_pid_histogram(torch, cuda_ops, flush, hist_pids(torch, n, 8, seed=5), 8, pr3=pr3)
    h200 = check_pid_histogram(torch, cuda_ops, flush, hist_pids(torch, n, 200, seed=6), 200, pr3=pr3)
    gq = check_group_sums(torch, cuda_ops, flush, *q01_group_inputs(torch, data["lineitem"]))
    checks = [("murmur3_pids", m1), ("murmur3_pids", m3), ("murmur3_pids", m10), ("sorted_lookup", sl),
              ("pid_histogram", h8), ("pid_histogram", h200), ("fused_group_sums", gq)]
    # the kernels' other paths, checked but not timed.  murmur3_pids:
    # views at element offsets 1-3 (the one-row path), N below one group
    # of 4 rows and with a ragged tail, K = 8 int64 keys (its most
    # registers).  sorted_lookup: see lookup_edge_tables.
    # pid_histogram: see the list below.
    # fused_group_sums: K x G past the register path (shared atomics,
    # two chained launches for K = 9), K x G past shared memory.
    for offset in (1, 2, 3):
        planes, widths, valids = murmur3_inputs(torch, cuda_ops, n, keys3, seed=20 + offset, offset=offset)
        if all(p.data_ptr() % 16 == 0 for p in planes):
            raise AssertionError(f"murmur3_pids offset {offset}: views still 16-byte aligned")
        checks.append(("murmur3_pids", check_murmur3(torch, cuda_ops, flush, planes, widths, valids,
                                                     f"{'/'.join(keys3)} offset {offset}", timed=False)))
    for rows in (1, 3, n + 5):
        checks.append(("murmur3_pids", check_murmur3(
            torch, cuda_ops, flush, *murmur3_inputs(torch, cuda_ops, rows, keys3, seed=rows),
            "/".join(keys3), timed=False)))
    checks.append(("murmur3_pids", check_murmur3(
        torch, cuda_ops, flush, *murmur3_inputs(torch, cuda_ops, n, ("int64",) * 8, seed=30),
        "8 x int64", timed=False)))
    for label, table, probe in lookup_edge_tables(torch, cuda_ops, seed=31):
        if label.startswith("8-byte") and table.data_ptr() % 16 != 8:
            raise AssertionError("sorted_lookup: the 8-byte-aligned view is 16-byte aligned")
        checks.append(("sorted_lookup", check_sorted_lookup(torch, cuda_ops, flush, table, probe, label,
                                                            timed=False)))
    g = torch.Generator(device="cuda").manual_seed(7)
    rand_vals = lambda k: [torch.rand(n, generator=g, device="cuda") for _ in range(k)]
    rand_gids = lambda groups: torch.randint(-1, groups, (n,), generator=g, device="cuda", dtype=torch.int32)
    # pid_histogram: N about one int4, one tile and the small-N threshold;
    # views at element offsets 1-3; nothing or everything in one bin;
    # bins about each path's end (32, the shared cap); then back-to-back
    # calls and two streams at once
    small = cuda_ops.HIST_SMALL_N
    hist_cases = [(rows, 8, 0, "random") for rows in (1, 31, 33, n + 3, small - 1, small, small + 1)]
    hist_cases += [(n + 5, 8, offset, "random") for offset in (1, 2, 3)]
    hist_cases += [(n, 8, 0, "minus one"), (n, 8, 0, "one bin"), (n, 200, 0, "one bin"), (n, 8, 0, "past"),
                   (n, 200, 0, "past")]
    hist_cases += [(n, parts, 0, "random") for parts in (1, 32, 33, 200, 20000, cuda_ops.HIST_SHARED_BINS,
                                                         cuda_ops.HIST_SHARED_BINS + 1)]
    for rows, parts, offset, layout in hist_cases:
        pids = hist_pids(torch, rows, parts, seed=rows + parts + offset, offset=offset, layout=layout)
        if offset and pids.data_ptr() % 16 == 0:
            raise AssertionError(f"pid_histogram offset {offset}: the view is 16-byte aligned")
        path = cuda_ops.pid_histogram_geometry(rows, parts)[0]
        label = f"{layout}{f' offset {offset}' if offset else ''} ({path})"
        checks.append(("pid_histogram", check_pid_histogram(torch, cuda_ops, flush, pids, parts, label,
                                                            timed=False)))
    checks += [("pid_histogram", r) for r in check_pid_histogram_streams(torch, cuda_ops, seed=40)]
    checks += check_opt_in_threads(torch, cuda_ops, seed=50)
    checks += [
        ("fused_group_sums", check_group_sums(torch, cuda_ops, flush, rand_gids(40), rand_vals(9), 40,
                                              timed=False)),
        ("fused_group_sums", check_group_sums(torch, cuda_ops, flush, rand_gids(20000), rand_vals(2),
                                              20000, timed=False)),
    ]
    for name, r in checks:
        log_check(name, r)
    log(f"fused_group_sums [{gq['shape']}]: max relative error to float64 sums {gq['max_rel_err_f64']:.3g}")

    end_phase(phases, "kernel checks")
    log("decimal -> double on the card: " + check_decimal_to_double(torch))

    end_phase(phases, "decimal check")
    # ---- the main path: every query, each with the counts reset just before it
    runs, inproc, scans, q_inputs = {}, {}, {}, {}
    for query in TPCH_QUERIES + DS_QUERIES + NEW_QUERIES:
        qdata = ds_data if query.startswith("ds_") else new_data if query in NEW_QUERIES else data
        scans[query] = query_scans(qdata, query, n_parts, batch_rows)
        # the variable of the retired spark.blaze.tpu.pallas.enable knob
        # must change nothing: fixed-width exchange keys take murmur3_pids
        if query == "q3":
            os.environ["BLAZE_TPU_PALLAS_ENABLE"] = "0"
        with largest_inputs(cuda_ops) as q_inputs[query]:
            got, wall, runs[query], sub_s = run_query(torch, cuda_ops, query, scans[query], n_parts)
        os.environ.pop("BLAZE_TPU_PALLAS_ENABLE", None)
        PARTIAL_BY_QUERY[query_label(query)] = {"inproc": partial_totals()}
        inproc[query] = (got, wall)
        scale = args.ds_scale if query.startswith("ds_") else args.scale
        sub = f" (its scalar subquery {sub_s:.4f} s of it)" if query in SUBQUERY_QUERIES else ""
        log(f"{query_label(query)} SF{scale} (8 partitions, 2^20-row batches): {check_oracle(qdata, query, got)}; "
            f"wall {wall:.4f} s{sub} on {card}; launches {runs[query]}; partial aggs "
            f"{PARTIAL_BY_QUERY[query_label(query)]['inproc']}")
        require_launches(query_label(query), runs[query], *EXPECTED_LAUNCHES[query])
    q1_inputs, q3_inputs = q_inputs["q1"], q_inputs["q3"]

    end_phase(phases, "queries in process")
    # ---- the same queries through the plan contract: every task from
    # TaskDefinition bytes, hash exchanges through .data/.index files
    sched_runs = {}
    for query in TPCH_QUERIES + DS_QUERIES + NEW_QUERIES:
        qdata = ds_data if query.startswith("ds_") else new_data if query in NEW_QUERIES else data
        got, wall, sched_runs[query], moved = run_scheduled(torch, cuda_ops, query, scans[query], n_parts)
        PARTIAL_BY_QUERY[query_label(query)].update(run_stages=moved["partial"], data_bytes=moved["data_bytes"])
        check_oracle(qdata, query, got)
        # rows that tie on a sort key (q11's equal values) may come in
        # another order; the oracle check above holds each order
        same = got == inproc[query][0] or (query in NEW_QUERIES and list(got) == list(inproc[query][0]) and sorted(
            zip(*got.values()), key=repr) == sorted(zip(*inproc[query][0].values()), key=repr))
        if not same:
            raise AssertionError(f"{query} through run_stages: {got} != in process {inproc[query][0]}")
        if sched_runs[query] != runs[query]:
            raise AssertionError(f"{query} through run_stages launched {sched_runs[query]}, "
                                 f"in process {runs[query]}")
        log(f"{query_label(query)} through split_stages/run_stages: = oracle and = in process; "
            f"stages {moved['kinds']}, {moved['tasks']} tasks, TaskDefinition bytes {moved['task_def_bytes']}, "
            f".data bytes {moved['data_bytes']}, blocks read {moved['blocks_read']}, broadcast bytes "
            f"{moved['broadcast_bytes']}, checksum-verified frames {moved['frames_verified']}, copies "
            f"device-to-host {moved['device_to_host']} host-to-device {moved['host_to_device']}; "
            f"wall {wall:.4f} s (in process {inproc[query][1]:.4f} s)"
            + (f", its scalar subquery {moved['subquery_s']:.4f} s of it" if query in SUBQUERY_QUERIES else "")
            + f" on {card}; launches {sched_runs[query]}; partial aggs {moved['partial']}")
        syncs = None
        if query in ("q6", "q1", "q3", "q5"):
            # q03's and q05's shuffles are the ones with bytes: where their host time goes
            syncs, host = count_syncs(torch, lambda: run_scheduled(torch, cuda_ops, query, scans[query], n_parts),
                                      host_profile=query in ("q3", "q5"))
            log(f"{query} syncs with the card through run_stages: {syncs}; "
                f"stage seconds {[round(t, 4) for t in moved['stage_seconds']]}")
            if host:
                log(f"{query} through run_stages, the host's time by function (cProfile, the same untimed run):\n"
                    + host[-3000:])
        log("scheduler " + json.dumps({"query": query, "wall_s": wall, "inproc_wall_s": inproc[query][1],
                                       "launches": sched_runs[query], "syncs": syncs, **moved}))
    require_launches("q06 (run_stages)", sched_runs["q6"], (), tuple(runs["q6"]))

    end_phase(phases, "queries through run_stages")
    # ---- the A/B phase: the pipeline unfused and serial against the defaults
    t_ab = time.perf_counter()
    ab_phase(torch, cuda_ops, card, scans, {q: new_data if q in NEW_QUERIES else data for q in AB_QUERIES},
             n_parts)
    log(f"A/B phase ({', '.join(AB_QUERIES)}): {time.perf_counter() - t_ab:.1f} s")

    end_phase(phases, "A/B pipeline")
    # ---- the join code no TPC-H query runs, on the card
    for line in check_build_preserving_joins(cuda_ops, "cuda", n_parts, 1 << 18, seed=60):
        log(line)

    end_phase(phases, "build-preserving joins")
    # ---- TPC-DS's window queries on both paths
    ds_phase(torch, cuda_ops, card, "window", WINDOW_QUERIES, ds_data, args.ds_scale, n_parts, batch_rows, runs,
             sched_runs, scheduled=None if args.uncut else kept_scheduled(WINDOW_QUERIES))

    end_phase(phases, "window queries")
    # ---- TPC-DS's rollup and union queries on both paths
    ds_phase(torch, cuda_ops, card, "rollup/union", ROLLUP_UNION_QUERIES, ds_data, args.ds_scale, n_parts,
             batch_rows, runs, sched_runs, scheduled=None if args.uncut else kept_scheduled(ROLLUP_UNION_QUERIES))
    # q23a and q23b select nothing from SF 0.01 on (ROADMAP queue C,
    # reference defect 14): their plans also run where they select rows
    ds_phase(torch, cuda_ops, card, "rollup/union", Q23_QUERIES, query_data(Q23_QUERIES, Q23_SCALE, ds=True),
             Q23_SCALE, n_parts, batch_rows, {}, {})

    end_phase(phases, "rollup and union queries")
    # ---- TPC-DS's EXISTS, INTERSECT/EXCEPT, stddev and concat queries on both paths
    ds_phase(torch, cuda_ops, card, "exists/stddev", EXISTS_STDDEV_QUERIES, ds_data, args.ds_scale, n_parts,
             batch_rows, runs, sched_runs, scheduled=None if args.uncut else kept_scheduled(EXISTS_STDDEV_QUERIES))
    ds_phase(torch, cuda_ops, card, "exists/stddev", Q87_QUERIES, query_data(Q87_QUERIES, Q87_SCALE, ds=True),
             Q87_SCALE, n_parts, batch_rows, {}, {})

    end_phase(phases, "exists and stddev queries")
    # ---- TPC-DS's single-fact reports, in process only: their run_stages
    # path, with most of the joined queries', gives the faults phase its
    # time within the smoke's budget
    ds_phase(torch, cuda_ops, card, "report", REPORT_QUERIES, ds_data, args.ds_scale, n_parts, batch_rows, runs,
             sched_runs, scheduled=None if args.uncut else ())

    end_phase(phases, "report queries")
    # ---- TPC-DS's multi-fact, shuffled and self joins in process, and
    # those of JOINED_SCHEDULED through run_stages too
    ds_phase(torch, cuda_ops, card, "joined", JOINED_QUERIES, ds_data, args.ds_scale, n_parts, batch_rows, runs,
             sched_runs, scheduled=None if args.uncut else JOINED_SCHEDULED)

    end_phase(phases, "joined queries")
    skipping = {q: r for q, r in PARTIAL_BY_QUERY.items()
                if r["inproc"]["partial_skipped"] or (r["run_stages"] or {}).get("partial_skipped")}
    log(f"partial aggs that skipped, of {len(PARTIAL_BY_QUERY)} queries: " + json.dumps(skipping))
    # ---- TPC-H from Parquet and ORC files the port writes, on both paths
    workdir = tempfile.mkdtemp(prefix="blaze-files-")
    file_launches, sf1_files, file_tables = file_phase(torch, cuda_ops, card, data, args.scale, n_parts, batch_rows,
                                                       workdir)

    end_phase(phases, "file scans")
    # ---- the functions and aggregates no TPC query uses
    fn_launches = functions_phase(torch, cuda_ops, card, data, args.scale, n_parts, batch_rows, runs)

    end_phase(phases, "functions and object aggs")
    # ---- nested columns: collects, explodes, nested functions and ORC fields
    nested_launches, nested_checks = nested_phase(torch, cuda_ops, flush, card, data, new_data, args.scale,
                                                  n_parts, batch_rows, workdir)
    checks += nested_checks

    end_phase(phases, "nested columns")
    # ---- Spark's global ORDER BY and repartition, and a skipping partial agg
    exchange_launches, exchange_checks, exchange_s = exchange_phase(torch, cuda_ops, flush, card, data, args.scale,
                                                                    n_parts, batch_rows)
    checks += exchange_checks

    end_phase(phases, "exchanges")
    # ---- recovery from injected faults through run_stages
    fault_launches, fault_checks, faults_s = faults_phase(torch, cuda_ops, flush, card, data, args.scale, n_parts,
                                                          batch_rows)
    checks += fault_checks

    end_phase(phases, "faults")
    # ---- map-mode broadcast joins and the zstd codec
    map_zstd_launches, map_zstd_checks, _ = map_zstd_phase(torch, cuda_ops, flush, card, data, file_tables, zstd_dir,
                                                           args.scale, n_parts, batch_rows, runs, sched_runs, inproc)
    checks += map_zstd_checks
    shutil.rmtree(zstd_dir)

    end_phase(phases, "map mode and zstd")
    # ---- q03's map tasks in worker processes, a killed worker, a cancel
    pool_launches, _ = pool_phase(torch, cuda_ops, card, data, sf1_files, args.scale, n_parts, batch_rows)

    end_phase(phases, "worker pool")
    # ---- real null foreign keys through run_stages, and the kernels on them
    null_runs, null_checks = null_key_phase(torch, cuda_ops, flush, card, ds_data, args.ds_scale, n_parts,
                                            batch_rows)
    checks += null_checks

    end_phase(phases, "null keys")
    # ---- the redesigned kernels again, on the largest inputs q01 and q03 gave them
    at_query: Dict[str, list] = {"murmur3_pids": [], "sorted_lookup": [], "pid_histogram": []}
    for query, seen in (("q01", q1_inputs), ("q03", q3_inputs)):
        pids, parts = seen["pid_histogram most rows"][1]
        r = check_pid_histogram(torch, cuda_ops, flush, pids, parts, f"({query}'s most rows)", pr3=pr3)
        at_query["pid_histogram"].append(r)
        log_check("pid_histogram", r)
    probed = set()
    for key, (_, inputs) in sorted(q3_inputs.items()):
        if key.startswith("pid_histogram"):
            continue
        if key.startswith("murmur3_pids"):
            planes, widths, valids, parts = inputs
            label = "/".join(f"int{32 * w}" for w in widths) + " (q03)"
            r = check_murmur3(torch, cuda_ops, flush, planes, widths, valids, label, n_parts=parts)
            at_query["murmur3_pids"].append(r)
            log_check("murmur3_pids", r)
        elif id(inputs[1]) not in probed:  # one call can have both the most probes and the longest table
            probed.add(id(inputs[1]))
            r = check_sorted_lookup(torch, cuda_ops, flush, *inputs, f"(q03, {key[14:]})")
            at_query["sorted_lookup"].append(r)
            log_check("sorted_lookup", r)

    end_phase(phases, "kernels at query shapes")
    # ---- the timed kernels' own device time, the same calls again; and
    # every device operation one pid_histogram call issues, on each path
    timed_calls = [(name, r) for name, r in checks if "device_job" in r]
    timed_calls += [(name, r) for name, rs in at_query.items() for r in rs]
    jobs = [r.pop("device_job") for _, r in timed_calls]
    pr3_calls = [r for _, r in timed_calls if "pr3_job" in r]
    jobs += [r.pop("pr3_job") for r in pr3_calls]
    count_cases = [("registers, a grid", n, 8), ("registers, one block", 3000, 8), ("shared, a grid", n, 200),
                   ("shared, one block", 3000, 200), ("shared, the most bins", n, cuda_ops.HIST_SHARED_BINS),
                   ("global atomics", n, cuda_ops.HIST_SHARED_BINS + 1)]
    count_jobs = []
    for label, rows, parts in count_cases:
        pids = hist_pids(torch, rows, parts, seed=50 + parts)
        count_jobs.append((lambda pids=pids, parts=parts: cuda_ops.pid_histogram(pids, parts), 10))
    # and, in the same profiler session, the profiled queries: q01 and
    # q03 in process under each A/B setting, q10 under the defaults
    profiled = []
    for query in ("q1", "q3"):
        for label, fusion, async_write, map_tasks, tasks in AB_SETTINGS:
            with pipeline_conf(fusion, async_write, tasks):
                profiled.append((f"{query_label(query)} ({label})",
                                 optimized(build_plan(query, scans[query], n_parts), map_tasks)))
    profiled.append((query_label("q10"), optimized(build_plan("q10", scans["q10"], n_parts))))
    # two window queries: q47's stacked windows, q67's nine-way expand;
    # two rollup queries: q5's unions of sales and returns, q22's
    # inventory; q72's shuffled join of catalog lines to all of inventory
    for query in ("ds_q47", "ds_q67", "ds_q5", "ds_q22", "ds_q72"):
        profiled.append((query_label(query), optimized(build_plan(
            query, query_scans(ds_data, query, n_parts, batch_rows), n_parts))))
    # q03 from the SF1 parquet files: the card's busy share beside the host's decoding
    profiled.append((f"q03 from parquet SF{args.scale}",
                     optimized(build_plan("q3", file_scans(sf1_files, "parquet", batch_rows), n_parts))))
    times, ops, (walls, counted), rest = device_times(torch, cuda_ops, jobs, 20, flush, count_jobs,
                                                      then=lambda: run_profiled(torch, cuda_ops, profiled))
    for (name, r), ms in zip(timed_calls, times):
        r["device_ms"] = ms
        log(f"{name} [{r['shape']}]: device time {ms:.4f} ms (CUPTI), bound {r['bound_ms']:.4f} ms "
            f"(share of bound {r['bound_ms'] / ms:.0%})")
    for r, ms in zip(pr3_calls, times[len(timed_calls):]):
        r["pr3_device_ms"] = ms
        log(f"pid_histogram PR 3 design [{r['shape']}]: {r['pr3_ms']:.4f} ms by events, device time "
            f"{ms:.4f} ms (CUPTI); shipped {r['ms']:.4f} / {r['device_ms']:.4f} ms")
    hist_ops = {}
    for (label, rows, parts), k in zip(count_cases, ops):
        hist_ops[label] = k
        log(f"pid_histogram [{label}: N={rows} n_parts={parts}]: {k:g} device operations per call")
        if label != "global atomics" and k != 1:
            raise AssertionError(f"pid_histogram [{label}]: {k:g} device operations a call, not 1")

    profiles = read_profiles(profiled, walls, counted, rest)
    for r in profiles:
        log("profile " + json.dumps({**r, "card": card}))
    shutil.rmtree(workdir)
    end_phase(phases, "device times and profiled queries")
    log("phase ends, seconds from the start of the script: "
        + ", ".join(f"{name} {t:.1f}" for name, t in phases))

    timed = {"murmur3_pids": m3, "sorted_lookup": sl, "pid_histogram": h8, "fused_group_sums": gq}
    errs: Dict[str, float] = {}
    for name, r in checks:
        errs[name] = max(errs.get(name, 0), r["max_abs_err"])
    kernels = []
    for name, src, line in (("murmur3_pids", "murmur3_pids.cu", 136),
                            ("pid_histogram", "pid_histogram.cu", 219),
                            ("fused_group_sums", "fused_group_sums.cu", 276),
                            ("sorted_lookup", "sorted_lookup.cu", 347)):
        r = timed[name]
        kernels.append({
            "name": name, "route": "cuda", "source": f"blaze_tpu_torch/csrc/{src}",
            "replaces": f"blaze_tpu/kernels/pallas_ops.py:{line}",
            "launches": sum(run[name] for run in runs.values())
            + sum(run[name] for label, run in file_launches.items() if not label.endswith("(run_stages)"))
            + sum(run[name] for label, run in fn_launches.items() if not label.endswith("(run_stages)"))
            + sum(run[name] for label, run in nested_launches.items() if not label.endswith("(run_stages)"))
            + sum(run[name] for label, run in exchange_launches.items() if not label.endswith("(run_stages)"))
            + sum(run[name] for run in fault_launches.values())
            + sum(run[name] for run in map_zstd_launches.values())
            + sum(run[name] for label, run in pool_launches.items() if not label.endswith("unpooled")),
            "launches_null_keys": {check: run[name] for check, run in null_runs.items()},
            "launches_by_query": {query_label(q): run[name] for q, run in runs.items()},
            "launches_run_stages": {query_label(q): run[name] for q, run in sched_runs.items()},
            "launches_files": {label: run[name] for label, run in file_launches.items()},
            "launches_functions": {label: run[name] for label, run in fn_launches.items()},
            "launches_nested": {label: run[name] for label, run in nested_launches.items()},
            "launches_exchanges": {label: run[name] for label, run in exchange_launches.items()},
            "launches_faults": {label: run[name] for label, run in fault_launches.items()},
            "launches_map_zstd": {label: run[name] for label, run in map_zstd_launches.items()},
            "launches_pool": {label: run[name] for label, run in pool_launches.items()},
            "shape": r["shape"], "max_abs_err": errs[name], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "device_ms": r.get("device_ms"),
            "at_query_shapes": [{k: q.get(k) for k in ("shape", "ms", "device_ms", "bound_ms", "bound_by",
                                                       "library_ms", "pr3_ms", "pr3_device_ms") if k in q}
                                for q in at_query.get(name, [])],
        })
        if name == "pid_histogram":
            kernels[-1].update(pr3_ms=r["pr3_ms"], pr3_device_ms=r["pr3_device_ms"], device_ops_per_call=hist_ops,
                               n_parts_200={k: h200[k] for k in ("ms", "device_ms", "pr3_ms", "pr3_device_ms",
                                                                 "bound_ms", "library_ms")})
    log("launches_exchanges " + json.dumps(exchange_launches))
    log("launches_faults " + json.dumps(fault_launches))
    log("launches_map_zstd " + json.dumps(map_zstd_launches))
    log("launches_pool " + json.dumps(pool_launches))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        code = main()
    finally:
        REFERENCES.close()
    sys.exit(code)
