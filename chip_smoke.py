#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``blaze_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--scale 1.0]

Needs one CUDA card and ``nvcc`` (``/usr/local/cuda``).  In order, it:

1. prints the card's name and power limit (``nvidia-smi``);
2. builds the hand-written kernels from ``blaze_tpu_torch/csrc`` and
   prints the build time and ptxas report;
3. runs each kernel at the main path's shapes on the card, holds it to
   its plain PyTorch version on the same inputs (exactly: the outputs
   are integers), and times both with CUDA events, cold L2;
4. runs TPC-H q06 at ``--scale`` and checks it against the numpy oracle;
5. runs TPC-H q03 at ``--scale`` with 8 partitions, 2^20-row batches and
   the join-probe kernel on, checks it against the oracle, and reads
   each kernel's launch count over that run (every count must be > 0);
6. runs q03 once more under ``torch.profiler`` and prints the device's
   busy share of that run, the kernels that take its time, and the
   hand-written kernels' device time at the shapes q03 gives them;
7. prints the ``kernels`` JSON line, then ``{"ok": true, ...}`` last.

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


# -------------------------------------------------------------- queries

QUERY_COLUMNS = {
    "lineitem": ("l_orderkey", "l_quantity", "l_extendedprice", "l_discount", "l_shipdate"),
    "orders": ("o_orderkey", "o_custkey", "o_orderdate", "o_shippriority"),
    "customer": ("c_custkey", "c_mktsegment"),
}


def tpch_scans(scale: float, n_parts: int, batch_rows: int):
    """Host tables at ``scale`` and scans staged on the card, pruned to
    the columns q03 and q06 read (as a columnar scan would)."""
    from blaze_tpu_torch.batch import table_to_batches
    from blaze_tpu_torch.ops import MemoryScanExec
    from blaze_tpu_torch.schema import Schema
    from blaze_tpu_torch.tpch import TPCH_SCHEMAS
    from blaze_tpu_torch.tpch.datagen import generate_table

    data, scans = {}, {}
    for name, cols in QUERY_COLUMNS.items():
        full = generate_table(name, scale, columns=set(cols)) if name == "lineitem" \
            else generate_table(name, scale)
        data[name] = {c: full[c] for c in cols}
        schema = Schema([f for f in TPCH_SCHEMAS[name].fields if f.name in cols])
        parts = table_to_batches(data[name], schema, n_parts, batch_rows, device="cuda")
        scans[name] = MemoryScanExec(parts, schema, device="cuda")
    return data, scans


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


def profile_q03(torch, plan) -> None:
    """q03 under torch.profiler: the device's busy share of the wall
    time and the kernels that take the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, wall = run_plan(torch, plan)
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    dev_us = lambda e: getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)
    busy = sum(dev_us(e) for e in kernels) / 1e6
    log(f"q03 profile: wall {wall:.4f} s, device busy {busy:.4f} s ({100 * busy / wall:.1f}%), "
        f"{sum(e.count for e in kernels)} kernel launches")
    for e in sorted(kernels, key=dev_us, reverse=True)[:15]:
        log(f"  {dev_us(e) / 1e3:9.3f} ms  {e.count:6d}x  {e.key[:100]}")
    # the hand-written kernels at the shapes q03 really gives them
    for name in ("murmur3_pids_kernel", "sorted_lookup_kernel"):
        ours = [e for e in kernels if name in e.key]
        total, count = sum(dev_us(e) for e in ours), sum(e.count for e in ours)
        log(f"q03 profile: {name} {count} launches, {total / 1e3:.4f} ms in all, "
            f"{total / 1e3 / max(count, 1):.4f} ms each")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=float, default=1.0, help="TPC-H scale factor (default 1.0)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port runs on the card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from blaze_tpu_torch import conf
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

    # ---- kernels against their plain versions, main-path shapes
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    n = 1 << 20
    m1 = check_murmur3(torch, cuda_ops, flush, n, ("int64",), seed=1)
    m3 = check_murmur3(torch, cuda_ops, flush, n, ("int64", "date32", "int32"), seed=2)
    # ten keys: past one launch's eight, so two launches chained through the hash
    m10 = check_murmur3(torch, cuda_ops, flush, n, ("int64", "date32", "int32") * 3 + ("int64",), seed=4)
    sl = check_sorted_lookup(torch, cuda_ops, flush, 30000, n, seed=3)
    for name, r in (("murmur3_pids", m1), ("murmur3_pids", m3), ("murmur3_pids", m10),
                    ("sorted_lookup", sl)):
        log(f"{name} [{r['shape']}]: equal to plain (max_abs_err {r['max_abs_err']}); "
            f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), library {r['library_ms']} ms")

    # ---- the main path: q06, then q03 with the join-probe kernel on
    data, scans = tpch_scans(args.scale, 8, 1 << 20)
    log(f"data at SF{args.scale}: " + ", ".join(
        f"{k} {next(iter(v.values()))[0].shape[0]} rows" for k, v in data.items()))
    got, wall6 = run_plan(torch, build_query("q6", scans, 8))
    want6 = O.oracle_q6(data)
    if got["revenue"] != [want6]:
        raise AssertionError(f"q06: {got['revenue']} != oracle {want6}")
    log(f"q06 SF{args.scale}: revenue {want6} (unscaled, scale 4) = oracle; wall {wall6:.4f} s")

    conf.PALLAS_JOIN_PROBE.set(True)
    plan = build_query("q3", scans, 8)
    cuda_ops.reset_launch_counts()
    got, wall3 = run_plan(torch, plan)
    launches = dict(cuda_ops.LAUNCHES)
    exp = O.oracle_q3(data)
    rows = list(zip(got["l_orderkey"], got["revenue"]))
    if len(rows) != len(exp) or set(rows) != {(r[0], r[1]) for r in exp}:
        raise AssertionError(f"q03: {rows} != oracle {[(r[0], r[1]) for r in exp]}")
    if [r[1] for r in rows] != sorted((r[1] for r in rows), reverse=True):
        raise AssertionError("q03: rows not in descending revenue order")
    log(f"q03 SF{args.scale} (8 partitions, 2^20-row batches, join probe kernel on): "
        f"top {len(rows)} = oracle; wall {wall3:.4f} s; launches {launches}")
    for name, k in launches.items():
        if k <= 0:
            raise AssertionError(f"q03 never launched {name}")

    profile_q03(torch, build_query("q3", scans, 8))

    kernels = [
        {"name": "murmur3_pids", "route": "cuda", "source": "blaze_tpu_torch/csrc/murmur3_pids.cu",
         "replaces": "blaze_tpu/kernels/pallas_ops.py:136", "launches": launches["murmur3_pids"],
         "max_abs_err": max(m1["max_abs_err"], m3["max_abs_err"], m10["max_abs_err"]), "ms": m3["ms"],
         "plain_ms": m3["plain_ms"], "bound_ms": m3["bound_ms"], "bound_by": m3["bound_by"],
         "library_ms": None},
        {"name": "sorted_lookup", "route": "cuda", "source": "blaze_tpu_torch/csrc/sorted_lookup.cu",
         "replaces": "blaze_tpu/kernels/pallas_ops.py:347", "launches": launches["sorted_lookup"],
         "max_abs_err": sl["max_abs_err"], "ms": sl["ms"], "plain_ms": sl["plain_ms"],
         "bound_ms": sl["bound_ms"], "bound_by": sl["bound_by"], "library_ms": sl["library_ms"]},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
