#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``blaze_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--scale 1.0]

Needs one CUDA card and ``nvcc`` (``/usr/local/cuda``).  In order, it:

1. prints the card's name and power limit (``nvidia-smi``);
2. builds the hand-written kernels from ``blaze_tpu_torch/csrc`` and
   prints the build time and ptxas report;
3. runs each kernel at the main path's shapes on the card, holds it to
   its plain PyTorch version on the same inputs (exactly where the
   outputs are integers; ``fused_group_sums`` within rtol 2e-5, and to
   float64 sums), and times the kernel, the plain version and the
   library call that computes the same function with CUDA events, cold
   L2;
4. runs TPC-H q06, q01 and q03 at ``--scale`` with 8 partitions and
   2^20-row batches, each scan pruned to the query's columns, checks
   each against its numpy oracle, and reads every kernel's launch count
   over each query (reset just before it): q01 must launch
   ``pid_histogram`` (and not ``murmur3_pids``: its keys are strings),
   q03 ``murmur3_pids``, ``pid_histogram`` and ``sorted_lookup``;
5. runs q01 and q03 once more under ``torch.profiler`` and prints the
   device's busy share of each run, the kernels that take its time, and
   the hand-written kernels' device time at the shapes the query gives
   them;
6. prints the ``kernels`` JSON line, then ``{"ok": true, ...}`` last.

Any failure raises and exits nonzero before the last line; without a
CUDA card it exits 2.  Nothing here imports JAX or ``blaze_tpu``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict

REPO = Path(__file__).resolve().parent

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


# ----------------------------------------------------------- kernel checks


def check_murmur3(torch, cuda_ops, flush, n: int, kinds, seed: int) -> dict:
    """murmur3_pids on (n,) keys of the given kinds, 10% nulls."""
    from blaze_tpu_torch.batch import Column
    from blaze_tpu_torch.schema import DataType

    g = torch.Generator(device="cuda").manual_seed(seed)
    cols = []
    for kind in kinds:
        if kind == "int64":
            data = torch.randint(-(2**63), 2**63 - 1, (n,), generator=g, device="cuda", dtype=torch.int64)
            dtype = DataType.int64()
        elif kind == "date32":
            data = torch.randint(8000, 10500, (n,), generator=g, device="cuda", dtype=torch.int32)
            dtype = DataType.date32()
        else:
            data = torch.randint(-(2**31), 2**31 - 1, (n,), generator=g, device="cuda", dtype=torch.int32)
            dtype = DataType.int32()
        valid = torch.rand(n, generator=g, device="cuda") > 0.1
        cols.append(Column(dtype, data, valid))
    planes, widths = zip(*(cuda_ops.column_word_planes(c) for c in cols))
    planes, widths = list(planes), list(widths)
    valids = [c.validity for c in cols]
    n_parts = 8
    got = cuda_ops.murmur3_pids(planes, widths, valids, n_parts)
    want = cuda_ops.murmur3_pids_plain(planes, widths, valids, n_parts)
    torch.cuda.synchronize()
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    if err != 0 or not torch.equal(got, want):
        raise AssertionError(f"murmur3_pids {kinds}: kernel differs from plain version (max {err})")
    ms = time_ms(torch, lambda: cuda_ops.murmur3_pids(planes, widths, valids, n_parts), 50, flush)
    plain_ms = time_ms(torch, lambda: cuda_ops.murmur3_pids_plain(planes, widths, valids, n_parts), 10, flush)
    per_col_ops = {1: 21, 2: 32}  # mix_k1, mix_h1 per word, fmix, select
    ops = n * (sum(per_col_ops[w] for w in widths) + 4)
    bytes_moved = n * (sum(4 * w for w in widths) + len(widths) + 4)
    b_ms, b_by = bound(bytes_moved, ops)
    return {"shape": f"N={n} keys={'/'.join(kinds)} n_parts={n_parts}", "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


def check_sorted_lookup(torch, cuda_ops, flush, t: int, n: int, seed: int) -> dict:
    """sorted_lookup of n probes in a t-key table with duplicates and
    null-key sentinels, keys on both sides of 2^63."""
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
    lo, hi = cuda_ops.sorted_lookup(table, probe)
    plo, phi = cuda_ops.sorted_lookup_plain(table, probe)
    torch.cuda.synchronize()
    err = max(int((lo - plo).abs().max()), int((hi - phi).abs().max()))
    if err != 0:
        raise AssertionError(f"sorted_lookup: kernel differs from plain version (max {err})")
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
    return {"shape": f"T={t} N={n}", "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms}


def check_pid_histogram(torch, cuda_ops, flush, n: int, n_parts: int, seed: int, timed: bool = True) -> dict:
    """pid_histogram on (n,) int32 pids in [0, n_parts) with 5% -1 rows."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    pids = torch.randint(0, n_parts, (n,), generator=g, device="cuda", dtype=torch.int32)
    pids[torch.rand(n, generator=g, device="cuda") < 0.05] = -1
    got = cuda_ops.pid_histogram(pids, n_parts)
    want = cuda_ops.pid_histogram_plain(pids, n_parts)
    torch.cuda.synchronize()
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    if err != 0 or int(got.sum()) != int((pids >= 0).sum()):
        raise AssertionError(f"pid_histogram n_parts={n_parts}: kernel differs from plain version (max {err})")
    r = {"shape": f"N={n} n_parts={n_parts}", "max_abs_err": err}
    if not timed:
        return r
    ms = time_ms(torch, lambda: cuda_ops.pid_histogram(pids, n_parts), 50, flush)
    plain_ms = time_ms(torch, lambda: cuda_ops.pid_histogram_plain(pids, n_parts), 20, flush)
    # the same function in one library call: shift -1 into bin 0, drop it
    library_ms = time_ms(torch, lambda: torch.bincount(pids + 1, minlength=n_parts + 1)[1:], 50, flush)
    b_ms, b_by = bound(4 * n + 4 * n_parts, int((pids >= 0).sum()))
    r.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=library_ms)
    return r


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
    r.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=library_ms)
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
    dev_us = lambda e: getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)
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
    from blaze_tpu_torch.kernels import build, cuda_ops
    from blaze_tpu_torch.tpch import build_query
    from blaze_tpu_torch.tpch import oracle as O

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log("torch", torch.__version__, "cuda", torch.version.cuda, "device", torch.cuda.get_device_name(0))

    # ---- build
    t0 = time.perf_counter()
    cuda_ops.reset_launch_counts()
    build.library()
    log(f"kernel build: {time.perf_counter() - t0:.2f} s "
        f"(nvcc {build.last_build.seconds:.2f} s, {build.last_build.path.name})")
    for line in build.last_build.log.splitlines():
        if "ptxas info" in line:
            log("  " + line.strip())

    # ---- host tables (set-up, not timed)
    t0 = time.perf_counter()
    data = tpch_data(args.scale)
    log(f"data at SF{args.scale}: " + ", ".join(
        f"{k} {next(iter(v.values()))[0].shape[0]} rows" for k, v in data.items())
        + f" ({time.perf_counter() - t0:.1f} s)")

    # ---- kernels against their plain versions, main-path shapes
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    n = 1 << 20
    m1 = check_murmur3(torch, cuda_ops, flush, n, ("int64",), seed=1)
    m3 = check_murmur3(torch, cuda_ops, flush, n, ("int64", "date32", "int32"), seed=2)
    # ten keys: past one launch's eight, so two launches chained through the hash
    m10 = check_murmur3(torch, cuda_ops, flush, n, ("int64", "date32", "int32") * 3 + ("int64",), seed=4)
    sl = check_sorted_lookup(torch, cuda_ops, flush, 30000, n, seed=3)
    # 8 partitions: q01's and q03's exchanges; 200: more bins than a warp has lanes
    h8 = check_pid_histogram(torch, cuda_ops, flush, n, 8, seed=5)
    h200 = check_pid_histogram(torch, cuda_ops, flush, n, 200, seed=6)
    gq = check_group_sums(torch, cuda_ops, flush, *q01_group_inputs(torch, data["lineitem"]))
    checks = [("murmur3_pids", m1), ("murmur3_pids", m3), ("murmur3_pids", m10), ("sorted_lookup", sl),
              ("pid_histogram", h8), ("pid_histogram", h200), ("fused_group_sums", gq)]
    # the kernels' other paths, checked but not timed: bins past shared
    # memory (global atomics), K x G past the register path (shared
    # atomics, two chained launches for K = 9), K x G past shared memory
    g = torch.Generator(device="cuda").manual_seed(7)
    rand_vals = lambda k: [torch.rand(n, generator=g, device="cuda") for _ in range(k)]
    rand_gids = lambda groups: torch.randint(-1, groups, (n,), generator=g, device="cuda", dtype=torch.int32)
    checks += [
        ("pid_histogram", check_pid_histogram(torch, cuda_ops, flush, n, 20000, seed=8, timed=False)),
        ("fused_group_sums", check_group_sums(torch, cuda_ops, flush, rand_gids(40), rand_vals(9), 40,
                                              timed=False)),
        ("fused_group_sums", check_group_sums(torch, cuda_ops, flush, rand_gids(20000), rand_vals(2),
                                              20000, timed=False)),
    ]
    for name, r in checks:
        if "ms" not in r:
            log(f"{name} [{r['shape']}]: equal to plain (max_abs_err {r['max_abs_err']})")
            continue
        log(f"{name} [{r['shape']}]: equal to plain (max_abs_err {r['max_abs_err']}); "
            f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), library {r['library_ms']} ms")
    log(f"fused_group_sums [{gq['shape']}]: max relative error to float64 sums {gq['max_rel_err_f64']:.3g}")

    # ---- the main path: q06, q01, q03, each with the counts reset just before it
    n_parts, batch_rows = 8, 1 << 20
    runs = {}
    got, wall, runs["q6"] = run_query(torch, cuda_ops, "q6", tpch_scans(data, "q6", n_parts, batch_rows),
                                      n_parts)
    want6 = O.oracle_q6(data)
    if got["revenue"] != [want6]:
        raise AssertionError(f"q06: {got['revenue']} != oracle {want6}")
    log(f"q06 SF{args.scale}: revenue {want6} (unscaled, scale 4) = oracle; wall {wall:.4f} s; "
        f"launches {runs['q6']}")

    q1_scans = tpch_scans(data, "q1", n_parts, batch_rows)
    got, wall, runs["q1"] = run_query(torch, cuda_ops, "q1", q1_scans, n_parts)
    exp = O.oracle_q1(data)
    keys = list(zip(got["l_returnflag"], got["l_linestatus"]))
    if keys != sorted(exp):
        raise AssertionError(f"q01 groups {keys} != oracle {sorted(exp)}")
    for i, key in enumerate(keys):
        row = {m: got[m][i] for m in exp[key]}
        if row != exp[key]:
            raise AssertionError(f"q01 group {key}: {row} != oracle {exp[key]}")
    log(f"q01 SF{args.scale} (8 partitions, 2^20-row batches): {len(keys)} groups = oracle; "
        f"wall {wall:.4f} s; launches {runs['q1']}")
    require_launches("q01", runs["q1"], ("pid_histogram",), ("murmur3_pids",))

    q3_scans = tpch_scans(data, "q3", n_parts, batch_rows)
    got, wall, runs["q3"] = run_query(torch, cuda_ops, "q3", q3_scans, n_parts)
    exp = O.oracle_q3(data)
    rows = list(zip(got["l_orderkey"], got["revenue"]))
    if len(rows) != len(exp) or set(rows) != {(r[0], r[1]) for r in exp}:
        raise AssertionError(f"q03: {rows} != oracle {[(r[0], r[1]) for r in exp]}")
    if [r[1] for r in rows] != sorted((r[1] for r in rows), reverse=True):
        raise AssertionError("q03: rows not in descending revenue order")
    log(f"q03 SF{args.scale} (8 partitions, 2^20-row batches): top {len(rows)} = oracle; "
        f"wall {wall:.4f} s; launches {runs['q3']}")
    require_launches("q03", runs["q3"], ("murmur3_pids", "pid_histogram", "sorted_lookup"))

    profile_query(torch, "q01", build_query("q1", q1_scans, n_parts))
    profile_query(torch, "q03", build_query("q3", q3_scans, n_parts))

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
            "shape": r["shape"], "max_abs_err": errs[name], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
