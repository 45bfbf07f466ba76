#!/usr/bin/env python3
"""Wall times of TPC-H q06, q01 and q03 for two checkouts of the port,
measured in turns on one card.

    python3 ab_walls.py TREE_A TREE_B [--scale 1.0] [--repeat 3]

Each tree (a directory holding a ``blaze_tpu_torch/`` package) runs in
its own process, in the order A, B, B, A.  A process builds the tree's
kernels, generates the three queries' tables at ``--scale`` (their
columns only), stages them on the card (8 partitions, 2^20-row
batches) and runs each query ``--repeat`` times in process
(``plan.execute``) and through ``split_stages``/``run_stages``, the
card synchronized around every run; the first run of each is a
warm-up and is not kept.  It prints one JSON line per process: the
tree, the card's name and power limit (``nvidia-smi``), every wall,
and a digest of each query's rows (equal digests: equal rows).  The
last line is the per-query median of each tree's walls.  Needs one
CUDA card; nothing here imports JAX or ``blaze_tpu``.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import subprocess
import sys
import time

QUERY_COLUMNS = {
    "q6": {"lineitem": ("l_quantity", "l_extendedprice", "l_discount", "l_shipdate")},
    "q1": {"lineitem": ("l_returnflag", "l_linestatus", "l_quantity", "l_extendedprice",
                        "l_discount", "l_tax", "l_shipdate")},
    "q3": {"lineitem": ("l_orderkey", "l_extendedprice", "l_discount", "l_shipdate"),
           "orders": ("o_orderkey", "o_custkey", "o_orderdate", "o_shippriority"),
           "customer": ("c_custkey", "c_mktsegment")},
}


def worker(tree: str, scale: float, repeat: int) -> dict:
    root = os.path.abspath(tree)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("ab_walls: no CUDA device")
    import blaze_tpu_torch
    from blaze_tpu_torch.batch import batch_to_pydict, table_to_batches
    from blaze_tpu_torch.kernels import build
    from blaze_tpu_torch.ops import MemoryScanExec
    from blaze_tpu_torch.runtime.context import TaskContext
    from blaze_tpu_torch.runtime.scheduler import run_stages, split_stages
    from blaze_tpu_torch.schema import Schema
    from blaze_tpu_torch.tpch import TPCH_SCHEMAS, build_query
    from blaze_tpu_torch.tpch.datagen import generate_table

    if not os.path.abspath(blaze_tpu_torch.__file__).startswith(root + os.sep):
        raise SystemExit(f"ab_walls: imported {blaze_tpu_torch.__file__}, not the package under {tree}")
    build.library()
    cols_of = {}
    for tables in QUERY_COLUMNS.values():
        for name, cols in tables.items():
            cols_of.setdefault(name, set()).update(cols)
    data = {name: generate_table(name, scale, columns=cols) if name == "lineitem"
            else {c: v for c, v in generate_table(name, scale).items() if c in cols}
            for name, cols in cols_of.items()}

    def scans(query):
        out = {}
        for name, cols in QUERY_COLUMNS[query].items():
            schema = Schema([f for f in TPCH_SCHEMAS[name].fields if f.name in cols])
            parts = table_to_batches({c: data[name][c] for c in cols}, schema, 8, 1 << 20, device="cuda")
            out[name] = MemoryScanExec(parts, schema, device="cuda")
        return out

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batches = fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0, batches

    def in_process(plan):
        n = plan.num_partitions()
        return [b for p in range(n) for b in plan.execute(p, TaskContext(p, n))]

    def scheduled(plan):
        stages, manager = split_stages(plan)
        return list(run_stages(stages, manager))

    def digest(batches):
        rows = [batch_to_pydict(b) for b in batches]
        return hashlib.sha256(json.dumps(rows, sort_keys=True, default=str).encode()).hexdigest()[:16]

    walls, digests = {}, {}
    for query in QUERY_COLUMNS:
        s = scans(query)
        for path, run in (("in_process", in_process), ("run_stages", scheduled)):
            times = []
            for i in range(repeat + 1):
                t, batches = timed(lambda: run(build_query(query, s, 8)))
                if i:
                    times.append(t)
            walls[f"{query} {path}"] = times
            digests[f"{query} {path}"] = digest(batches)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    return {"tree": tree, "card": smi, "walls": walls, "digests": digests}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*")
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--repeat", type=int, default=3)
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(args.worker, args.scale, args.repeat)), flush=True)
        return 0
    if len(args.trees) != 2:
        ap.error("give two trees")
    a, b = args.trees
    results = []
    for tree in (a, b, b, a):
        out = subprocess.run([sys.executable, __file__, "--worker", tree, "--scale", str(args.scale),
                              "--repeat", str(args.repeat)], capture_output=True, text=True)
        if out.returncode:
            raise RuntimeError(f"the worker on {tree} failed:\n{out.stderr[-4000:]}")
        line = out.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        results.append(json.loads(line))
    if any(r["digests"] != results[0]["digests"] for r in results):
        raise AssertionError("the trees' rows differ")
    medians = {tree: {k: statistics.median([t for r in results if r["tree"] == tree for t in r["walls"][k]])
                      for k in results[0]["walls"]} for tree in (a, b)}
    print(json.dumps({"median_walls_s": medians}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
