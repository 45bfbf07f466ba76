#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``blaze_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--scale 1.0]

Needs one CUDA card and ``nvcc`` (``/usr/local/cuda``).  In order, it:

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
4. runs TPC-H q06, q01 and q03 at ``--scale`` with 8 partitions and
   2^20-row batches, each scan pruned to the query's columns, checks
   each against its numpy oracle, and reads every kernel's launch count
   over each query (reset just before it): q01 must launch
   ``pid_histogram`` (and not ``murmur3_pids``: its keys are strings),
   q03 ``murmur3_pids``, ``pid_histogram`` and ``sorted_lookup``, with
   the retired ``BLAZE_TPU_PALLAS_ENABLE=0`` set; then times
   ``pid_histogram`` on the largest inputs q01 and q03 gave it, and
   ``murmur3_pids`` and ``sorted_lookup`` on q03's;
5. runs q06, q01 and q03 again, the same scans, through the plan
   contract: ``split_stages`` cuts each plan at its exchanges,
   ``run_stages`` serializes every task to TaskDefinition bytes and runs
   it through ``run_task``, hash exchanges go through ``.data``/``.index``
   files and broadcasts through checksummed blobs; each must equal its
   oracle and the in-process result, and launch each kernel as often as
   in process (launch counts reset just before each query); prints its
   stages and tasks, TaskDefinition bytes, ``.data`` bytes, blocks read,
   checksum-verified frames, the file path's host/device copies and its
   wall beside the in-process wall; then flips one byte of one committed
   q06 ``.data`` file and requires the reduce task to raise
   ``BlockCorruptionError``; one more untimed run of each query through
   ``run_stages`` counts its syncs with the card (CUDA sync debug mode),
   q03's under cProfile;
6. reads the CUPTI device time of every timed call in one
   ``torch.profiler`` session, and counts every device operation one
   ``pid_histogram`` call issues on each path (one on paths (a) and
   (b), or it fails); then runs q01 and q03 once more under
   ``torch.profiler`` and prints the device's busy share of each run,
   the kernels that take its time, and the hand-written kernels' device
   time at the shapes the query gives them;
7. prints where each phase ended on the host clock, the ``kernels``
   JSON line, then ``{"ok": true, ...}`` last.

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


def dev_us(e) -> float:
    return getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)


def device_times(torch, cuda_ops, jobs, iters: int, flush, count_jobs=()):
    """(device time per call of each job, device operations per call of
    each count job).  A job is ``(fn, kernel)`` or ``(fn, kernel,
    launches)``: the time of ``fn``'s launches of kernels named
    ``kernel``, from torch.profiler's CUPTI trace, L2 flushed before
    every call; the launches per call are ``launches`` or what
    ``fn`` adds to ``cuda_ops.LAUNCHES``.  It leaves out the gap from the
    start event to the launch that ``time_ms`` encloses.  A count job
    ``(fn, calls)`` runs ``fn`` that many times, unflushed, between two
    spin kernels; every device operation between them counts (kernels
    of any name, fills, memsets, copies).  All jobs share one profiler
    session (more sessions in one process have come back without kernel
    events), told apart by their order."""
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
        torch.cuda.synchronize()
    device = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA), key=lambda e: e.time_range.start)
    names = {job[1] for job in jobs}
    spins = [i for i, e in enumerate(device) if "spin_kernel" in e.name]
    events = [e for e in device[:spins[0] if spins else len(device)] if any(k in e.name for k in names)]
    if len(events) != iters * sum(launches) or len(spins) != 2 * len(count_jobs):
        raise AssertionError(f"the profiler saw {len(events)} kernel launches, not {iters * sum(launches)}, "
                             f"and {len(spins)} spin kernels, not {2 * len(count_jobs)}")
    out, pos = [], 0
    for k in launches:
        out.append(sum(e.time_range.elapsed_us() for e in events[pos:pos + iters * k]) / iters / 1e3)
        pos += iters * k
    ops = [(spins[2 * i + 1] - spins[2 * i] - 1) / calls for i, (_, calls) in enumerate(count_jobs)]
    return out, ops


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

# the columns each query reads, per table (a columnar scan's pruning)
QUERY_COLUMNS = {
    "q6": {"lineitem": ("l_quantity", "l_extendedprice", "l_discount", "l_shipdate")},
    "q1": {"lineitem": ("l_returnflag", "l_linestatus", "l_quantity", "l_extendedprice",
                        "l_discount", "l_tax", "l_shipdate")},
    "q3": {"lineitem": ("l_orderkey", "l_extendedprice", "l_discount", "l_shipdate"),
           "orders": ("o_orderkey", "o_custkey", "o_orderdate", "o_shippriority"),
           "customer": ("c_custkey", "c_mktsegment")},
}


def tpch_data(scale: float) -> Dict[str, dict]:
    """Host tables at ``scale``, each with the columns the queries read."""
    from blaze_tpu_torch.tpch.datagen import generate_table

    data: Dict[str, dict] = {}
    for tables in QUERY_COLUMNS.values():
        for name, cols in tables.items():
            data.setdefault(name, set()).update(cols)
    return {name: generate_table(name, scale, columns=cols) if name == "lineitem"
            else {c: v for c, v in generate_table(name, scale).items() if c in cols}
            for name, cols in data.items()}


def tpch_scans(data, query: str, n_parts: int, batch_rows: int):
    """Scans of ``query``'s tables staged on the card, pruned to the
    columns it reads."""
    from blaze_tpu_torch.batch import table_to_batches
    from blaze_tpu_torch.ops import MemoryScanExec
    from blaze_tpu_torch.schema import Schema
    from blaze_tpu_torch.tpch import TPCH_SCHEMAS

    scans = {}
    for name, cols in QUERY_COLUMNS[query].items():
        schema = Schema([f for f in TPCH_SCHEMAS[name].fields if f.name in cols])
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


def profile_query(torch, query: str, plan) -> None:
    """One query under torch.profiler: the device's busy share of the
    wall time and the kernels that take the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, wall = run_plan(torch, plan)
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(dev_us(e) for e in kernels) / 1e6
    log(f"{query} profile: wall {wall:.4f} s, device busy {busy:.4f} s ({100 * busy / wall:.1f}%), "
        f"{sum(e.count for e in kernels)} device operations")
    for e in sorted(kernels, key=dev_us, reverse=True)[:12]:
        log(f"  {dev_us(e) / 1e3:9.3f} ms  {e.count:6d}x  {e.key[:100]}")
    # the hand-written kernels at the shapes the query really gives them
    for name in HAND_WRITTEN:
        ours = [e for e in kernels if name in e.key]
        total, count = sum(dev_us(e) for e in ours), sum(e.count for e in ours)
        log(f"{query} profile: {name} {count} launches, {total / 1e3:.4f} ms in all, "
            f"{total / 1e3 / max(count, 1):.4f} ms each")


def run_query(torch, cuda_ops, query: str, scans, n_parts: int):
    """One query through build_query + plan.execute with every launch
    count reset just before it; returns (rows, wall, launches)."""
    from blaze_tpu_torch.tpch import build_query

    plan = build_query(query, scans, n_parts)
    cuda_ops.reset_launch_counts()
    got, wall = run_plan(torch, plan)
    return got, wall, dict(cuda_ops.LAUNCHES)


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

    def keep(key, size, args):
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


def oracle(O, data, query: str):
    """The query's numpy oracle on ``data``, computed once a run (q01's
    takes seconds at SF1, and both paths are held to it)."""
    key = (id(data), query)
    if key not in _ORACLES:
        _ORACLES[key] = {"q6": O.oracle_q6, "q1": O.oracle_q1, "q3": O.oracle_q3}[query](data)
    return _ORACLES[key]


def check_oracle(O, data, query: str, got: dict) -> str:
    """Raises unless ``got`` equals the query's numpy oracle exactly
    (q03: the top 10 (orderkey, revenue) pairs, in descending revenue:
    ties may order differently); says what matched."""
    if query == "q6":
        want = oracle(O, data, query)
        if got["revenue"] != [want]:
            raise AssertionError(f"q06: {got['revenue']} != oracle {want}")
        return f"revenue {want} (unscaled, scale 4) = oracle"
    if query == "q1":
        exp = oracle(O, data, query)
        keys = list(zip(got["l_returnflag"], got["l_linestatus"]))
        if keys != sorted(exp):
            raise AssertionError(f"q01 groups {keys} != oracle {sorted(exp)}")
        for i, key in enumerate(keys):
            row = {m: got[m][i] for m in exp[key]}
            if row != exp[key]:
                raise AssertionError(f"q01 group {key}: {row} != oracle {exp[key]}")
        return f"{len(keys)} groups = oracle"
    exp = oracle(O, data, query)
    rows = list(zip(got["l_orderkey"], got["revenue"]))
    if len(rows) != len(exp) or set(rows) != {(r[0], r[1]) for r in exp}:
        raise AssertionError(f"q03: {rows} != oracle {[(r[0], r[1]) for r in exp]}")
    if [r[1] for r in rows] != sorted((r[1] for r in rows), reverse=True):
        raise AssertionError("q03: rows not in descending revenue order")
    return f"top {len(rows)} = oracle"


def run_scheduled(torch, cuda_ops, query: str, scans, n_parts: int):
    """One query through split_stages + run_stages, every task from its
    TaskDefinition bytes, with the launch, copy and verified-frame counts
    reset just before it; returns (rows, wall, launches, what moved)."""
    from blaze_tpu_torch import batch as B
    from blaze_tpu_torch.runtime import integrity
    from blaze_tpu_torch.runtime.context import RESOURCES
    from blaze_tpu_torch.runtime.scheduler import RunStats, run_stages, split_stages
    from blaze_tpu_torch.tpch import build_query

    stages, manager = split_stages(build_query(query, scans, n_parts))
    stats = RunStats()
    cuda_ops.reset_launch_counts()
    B.reset_copy_counts()
    integrity.COUNTS["frames_verified"] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    batches = list(run_stages(stages, manager, stats))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
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
             "stage_seconds": stats.stage_seconds}
    return out, wall, launches, moved


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


def corrupt_block_check(scans, n_parts: int) -> str:
    """q06's map stage through the scheduler, one byte of one committed
    .data file flipped, then its reduce task: it must raise
    BlockCorruptionError (only that class is caught)."""
    from blaze_tpu_torch.runtime import integrity
    from blaze_tpu_torch.runtime.context import RESOURCES
    from blaze_tpu_torch.runtime.scheduler import StageRunner, split_stages
    from blaze_tpu_torch.tpch import build_query

    stages, manager = split_stages(build_query("q6", scans, n_parts))
    try:
        runner = StageRunner(manager)
        for stage in stages[:-1]:
            for _ in runner.run_stage(stage):
                pass
        path = manager.map_output_paths(stages[0].shuffle_id, 0)[0]
        offset = integrity.flip_byte_in_file(path)
        try:
            for _ in runner.run_stage(stages[-1]):
                pass
        except integrity.BlockCorruptionError as e:
            caught = f"byte {offset} of {os.path.basename(path)} flipped: {e}"
        else:
            raise AssertionError("q06's reduce task read a corrupted block without BlockCorruptionError")
    finally:
        manager.cleanup()
    if len(RESOURCES):
        raise AssertionError(f"the failed reduce task left resources {RESOURCES.keys()}")
    return caught


def require_launches(query: str, launches: dict, launched, not_launched=()) -> None:
    for name in launched:
        if launches[name] <= 0:
            raise AssertionError(f"{query} never launched {name}: {launches}")
    for name in not_launched:
        if launches[name] != 0:
            raise AssertionError(f"{query} launched {name}: {launches}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=float, default=1.0, help="TPC-H scale factor (default 1.0)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port runs on the card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from blaze_tpu_torch.kernels import build, cuda_ops, sweep
    from blaze_tpu_torch.tpch import build_query
    from blaze_tpu_torch.tpch import oracle as O

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

    phases.append(("build", time.perf_counter() - T0))
    # ---- host tables (set-up, not timed)
    t0 = time.perf_counter()
    data = tpch_data(args.scale)
    log(f"data at SF{args.scale}: " + ", ".join(
        f"{k} {next(iter(v.values()))[0].shape[0]} rows" for k, v in data.items())
        + f" ({time.perf_counter() - t0:.1f} s)")

    phases.append(("tables", time.perf_counter() - T0))
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
    checks += [
        ("fused_group_sums", check_group_sums(torch, cuda_ops, flush, rand_gids(40), rand_vals(9), 40,
                                              timed=False)),
        ("fused_group_sums", check_group_sums(torch, cuda_ops, flush, rand_gids(20000), rand_vals(2),
                                              20000, timed=False)),
    ]
    for name, r in checks:
        log_check(name, r)
    log(f"fused_group_sums [{gq['shape']}]: max relative error to float64 sums {gq['max_rel_err_f64']:.3g}")

    phases.append(("kernel checks", time.perf_counter() - T0))
    # ---- the main path: q06, q01, q03, each with the counts reset just before it
    n_parts, batch_rows = 8, 1 << 20
    runs = {}
    q6_scans = tpch_scans(data, "q6", n_parts, batch_rows)
    inproc = {}
    got, wall, runs["q6"] = run_query(torch, cuda_ops, "q6", q6_scans, n_parts)
    inproc["q6"] = (got, wall)
    log(f"q06 SF{args.scale}: {check_oracle(O, data, 'q6', got)}; wall {wall:.4f} s; launches {runs['q6']}")

    q1_scans = tpch_scans(data, "q1", n_parts, batch_rows)
    with largest_inputs(cuda_ops) as q1_inputs:
        got, wall, runs["q1"] = run_query(torch, cuda_ops, "q1", q1_scans, n_parts)
    inproc["q1"] = (got, wall)
    log(f"q01 SF{args.scale} (8 partitions, 2^20-row batches): {check_oracle(O, data, 'q1', got)}; "
        f"wall {wall:.4f} s; launches {runs['q1']}")
    require_launches("q01", runs["q1"], ("pid_histogram",), ("murmur3_pids",))

    q3_scans = tpch_scans(data, "q3", n_parts, batch_rows)
    # the variable of the retired spark.blaze.tpu.pallas.enable knob
    # must change nothing: fixed-width exchange keys take murmur3_pids
    os.environ["BLAZE_TPU_PALLAS_ENABLE"] = "0"
    with largest_inputs(cuda_ops) as q3_inputs:
        got, wall, runs["q3"] = run_query(torch, cuda_ops, "q3", q3_scans, n_parts)
    del os.environ["BLAZE_TPU_PALLAS_ENABLE"]
    inproc["q3"] = (got, wall)
    log(f"q03 SF{args.scale} (8 partitions, 2^20-row batches): {check_oracle(O, data, 'q3', got)}; "
        f"wall {wall:.4f} s; launches {runs['q3']}")
    require_launches("q03", runs["q3"], ("murmur3_pids", "pid_histogram", "sorted_lookup"))

    phases.append(("queries in process", time.perf_counter() - T0))
    # ---- the same three queries through the plan contract: every task
    # from TaskDefinition bytes, hash exchanges through .data/.index files
    sched_runs = {}
    for query, scans in (("q6", q6_scans), ("q1", q1_scans), ("q3", q3_scans)):
        got, wall, sched_runs[query], moved = run_scheduled(torch, cuda_ops, query, scans, n_parts)
        check_oracle(O, data, query, got)
        if got != inproc[query][0]:
            raise AssertionError(f"{query} through run_stages: {got} != in process {inproc[query][0]}")
        if sched_runs[query] != runs[query]:
            raise AssertionError(f"{query} through run_stages launched {sched_runs[query]}, "
                                 f"in process {runs[query]}")
        log(f"{query} SF{args.scale} through split_stages/run_stages: = oracle and = in process; "
            f"stages {moved['kinds']}, {moved['tasks']} tasks, TaskDefinition bytes {moved['task_def_bytes']}, "
            f".data bytes {moved['data_bytes']}, blocks read {moved['blocks_read']}, broadcast bytes "
            f"{moved['broadcast_bytes']}, checksum-verified frames {moved['frames_verified']}, copies "
            f"device-to-host {moved['device_to_host']} host-to-device {moved['host_to_device']}; "
            f"wall {wall:.4f} s (in process {inproc[query][1]:.4f} s); launches {sched_runs[query]}")
        # q03's shuffle is the one with bytes: where its host time goes
        syncs, host = count_syncs(torch, lambda: run_scheduled(torch, cuda_ops, query, scans, n_parts),
                                  host_profile=query == "q3")
        log(f"{query} syncs with the card through run_stages: {syncs}; "
            f"stage seconds {[round(t, 4) for t in moved['stage_seconds']]}")
        if host:
            log(f"{query} through run_stages, the host's time by function (cProfile, the same untimed run):\n"
                + host[-3000:])
        log("scheduler " + json.dumps({"query": query, "wall_s": wall, "inproc_wall_s": inproc[query][1],
                                       "launches": sched_runs[query], "syncs": syncs, **moved}))
    require_launches("q06 (run_stages)", sched_runs["q6"], (), tuple(runs["q6"]))
    log("corrupted block: " + corrupt_block_check(q6_scans, n_parts))

    phases.append(("queries through run_stages", time.perf_counter() - T0))
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

    phases.append(("kernels at query shapes", time.perf_counter() - T0))
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
    times, ops = device_times(torch, cuda_ops, jobs, 20, flush, count_jobs)
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

    phases.append(("device times", time.perf_counter() - T0))
    profile_query(torch, "q01", build_query("q1", q1_scans, n_parts))
    profile_query(torch, "q03", build_query("q3", q3_scans, n_parts))
    phases.append(("profiled queries", time.perf_counter() - T0))
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
            "launches": sum(run[name] for run in runs.values()),
            "launches_q01": runs["q1"][name], "launches_q03": runs["q3"][name],
            "launches_run_stages": {q: run[name] for q, run in sched_runs.items()},
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
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
