"""Does a torch.profiler session on the card lose device records, and
does that depend on how many a session holds?

Each session is laid out as ``chip_smoke.profile_queries`` lays out its
runs: a spin kernel (``torch.cuda._sleep``) before the first run, one
before and one after each run, one after the last.  A run is bursts of
tiny device operations (kernels and host-to-device copies, a share of
them from a second thread on a stream of its own) with the host asleep
between bursts, as the smoke's queries leave the card idle most of
their wall.  Every operation's count is known beforehand, so the script
prints, per session, the spins seen, the runs that split apart and the
device operations seen against those launched.

Every configuration runs in a process of its own (two sessions each):
later sessions of one process have come back short of kernel events.

    python3 profiler_drops.py                  # the default matrix
    python3 profiler_drops.py --child 500000 13  # one process's sessions

Needs one card.  Prints one JSON line per session and a summary last.
The two smaller cases take about 8 minutes on an H100; give the whole
matrix 20.
"""

import argparse
import json
import os
import subprocess
import sys
import threading
import time

#: (device operations per session, processes): the smoke's profiled
#: session held about 485,000 and was split over two sessions after
#: it lost records
MATRIX = ((240_000, 3), (485_000, 4), (1_500_000, 2))
SESSIONS_PER_PROCESS = 2
BURSTS = 20
SIDE_SHARE = 4  # one operation in SIDE_SHARE comes from the side thread


def session(torch, total_ops: int, runs: int) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda")
    x = torch.zeros(256, device=dev)
    y = torch.zeros(256, device=dev)
    host = torch.ones(64).pin_memory()
    side_dst = torch.zeros(64, device=dev)
    side = torch.cuda.Stream()
    per_run = total_ops // runs
    per_burst = per_run // BURSTS
    side_n = per_burst // SIDE_SHARE
    main_n = per_burst - side_n
    launched = 0

    def side_work():
        with torch.cuda.stream(side):
            for _ in range(side_n):
                side_dst.copy_(host, non_blocking=True)

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1000)
        for _ in range(runs):
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            for _ in range(BURSTS):
                t = threading.Thread(target=side_work)
                t.start()
                for i in range(main_n):
                    (x if i % 2 else y).add_(1.0)
                t.join()
                launched += per_burst
                time.sleep(0.02)
            torch.cuda.synchronize()
            torch.cuda._sleep(1000)
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
    device = sorted((e for e in prof.profiler.kineto_results.events() if e.device_type() == DeviceType.CUDA),
                    key=lambda e: e.start_ns())
    spins = [i for i, e in enumerate(device) if "spin_kernel" in e.name()]
    stretches = [(a, b) for a, b in zip(spins, spins[1:]) if b > a + 1]
    return {"ops_launched": launched, "ops_seen": len(device) - len(spins), "spins": len(spins),
            "spins_launched": 2 * runs + 2, "runs": runs, "runs_split": len(stretches)}


def child(total_ops: int, runs: int) -> None:
    import torch

    for k in range(SESSIONS_PER_PROCESS):
        t0 = time.perf_counter()
        r = session(torch, total_ops, runs)
        r.update(session=k + 1, seconds=round(time.perf_counter() - t0, 3))
        print(json.dumps(r), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--child", nargs=2, type=int, metavar=("OPS", "RUNS"))
    args = ap.parse_args()
    if args.child:
        child(*args.child)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("no card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    summary = []
    for total, procs in MATRIX:
        for p in range(procs):
            # kineto's own warnings (a dropped-records count) reach stderr
            # at log level 2 unless torch silences them
            out = subprocess.run([sys.executable, __file__, "--child", str(total), "13"],
                                 capture_output=True, text=True, env={**os.environ, "KINETO_LOG_LEVEL": "2"})
            if out.returncode:
                print(out.stderr[-4000:], file=sys.stderr)
                return out.returncode
            warnings = [w[:300] for w in out.stderr.splitlines() if "drop" in w.lower() or "exceed" in w.lower()]
            for line in out.stdout.splitlines():
                r = json.loads(line)
                r.update(process=p + 1, kineto_warnings=warnings[:10])
                print(json.dumps(r), flush=True)
                summary.append((total, r["ops_launched"] - r["ops_seen"], r["spins_launched"] - r["spins"],
                                r["runs"] - r["runs_split"]))
    by = {}
    for total, lost_ops, lost_spins, merged in summary:
        s = by.setdefault(total, {"sessions": 0, "sessions_losing": 0, "ops_lost": 0, "spins_lost": 0,
                                  "runs_merged": 0})
        s["sessions"] += 1
        s["sessions_losing"] += int(bool(lost_ops or lost_spins))
        s["ops_lost"] += lost_ops
        s["spins_lost"] += lost_spins
        s["runs_merged"] += merged
    print(json.dumps({"summary": {str(k): v for k, v in by.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
