"""A task worker in a process of its own (≙ ``blaze_tpu/runtime/worker.py``).

One-shot mode, ``python -m blaze_tpu_torch.runtime.worker [--device cpu]
<spec.json>``, runs one task attempt; ``--serve`` makes the process a
long-lived member of a pool (``runtime/hostpool.py`` is the driver
half).  Either way the worker re-creates the shuffle manager over the
SHARED shuffle root, registers its partition's reduce blocks in its own
``RESOURCES``, decodes the TaskDefinition and drives the plan: a map
task commits ``.data``/``.index`` into the root, a result task writes
its batches as checksummed frames to ``output``.

Job spec (``scheduler.worker_task_spec``)::

    {"task_def": "<base64 TaskDefinition bytes>", "partition": N, "attempt": 0,
     "shuffle_root": "/dir/shared/by/the/workers",
     "readers": [{"resource_id": "shuffle_7", "shuffle_id": 7, "n_maps": 3}],
     "output": "/path/result.frames" | null}

The device is the spawner's choice, ``--device``: ``cuda`` unless it
asks for ``cpu``; asking for ``cuda`` where there is no card fails the
worker at its start.

Crash safety: a result file is written to ``<output>.inprogress.a<N>``
and renamed into place once the plan has drained, so a worker that dies
mid-task leaves nothing or a whole file; the driver verifies the frames
(:func:`verify_result_file`) before it trusts them.
:func:`run_worker_with_retry` is the driver half of the one-shot mode:
it spawns the worker in its own session, re-attempts a failed or
output-less attempt with a fresh attempt id under the task retry
policy, and raises at once on a failure the worker's typed exit record
(:func:`read_exit_record`) classes as fatal.

Serve mode reads job specs as checksummed JSON frames
(``io/ipc_compression.py``) on stdin and answers on stdout: ``ready``
once, ``hb`` every ``spark.blaze.pool.heartbeatMs`` from a daemon
thread, and one ``done`` a job, whose failure carries the error's typed
identity (:func:`_describe_error`); the process keeps serving after a
failed job.  fd 1 is re-pointed at stderr once the protocol has the
real stdout, so no stray print can corrupt a frame.  ``hb`` and
``done`` frames carry the telemetry since the last frame that carried
any (``v``, ``tm``): rows and result bytes, jobs ok and failed, the
card's peak allocation, and the deltas of ``kernels/cuda_ops.LAUNCHES``,
which the driver adds up; ``ready`` carries the worker's start-up
(the card's free bytes once its context exists and after the kernel
library is loaded).
"""

from __future__ import annotations

import base64
import json
import os
import struct
import sys
from typing import Dict, Optional

#: the telemetry payload version ``hb``/``done`` frames stamp as ``v``
TELEMETRY_VERSION = 1


def _process_age() -> Optional[float]:
    """Seconds since this process started (from ``/proc``), or None."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return None
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def _configure_worker_process(device: str) -> dict:
    """One-time set-up of both modes: the default device (raises when
    ``cuda`` is asked for and there is no card), ``@kill`` armed, and on
    the card the context created and the kernel library loaded.
    Returns the start-up record ``ready`` carries: the process's age
    once its imports were done, and the set-up's seconds."""
    import time

    import blaze_tpu_torch

    from . import faults

    imported_s = _process_age()
    t0 = time.perf_counter()
    blaze_tpu_torch.set_default_device(device)
    dev = blaze_tpu_torch.resolve_device()
    faults.mark_worker_process()
    init = {"device": str(dev), "imported_s": imported_s}
    if dev.type == "cuda":
        import torch

        from ..kernels import build

        free_ctx, total = torch.cuda.mem_get_info()  # creates this process's context
        build.library()
        torch.empty(1, device=dev)
        free_after, _ = torch.cuda.mem_get_info()
        init.update(free_at_context=free_ctx, free_after_init=free_after, total=total)
    init["init_s"] = time.perf_counter() - t0
    return init


def _execute_spec(spec: dict) -> dict:
    """Run one job spec to its end in this process: register the reduce
    blocks, decode the TaskDefinition, drive the plan and, for a result
    task, commit the frames by an atomic rename.  The ``worker.task``
    site is probed at the job's start and at each output batch.  Returns
    the rows and result bytes written, the blocks registered and the
    rows each shuffle reader read (``scheduler.plan_reads``)."""
    from ..io.batch_serde import serialize_batch
    from ..io.ipc_compression import block_trailer, compress_frame
    from ..parallel.shuffle import LocalShuffleManager
    from ..serde.from_proto import run_task
    from . import faults, integrity
    from .context import RESOURCES, current_cancel_scope
    from .scheduler import plan_reads

    partition = int(spec["partition"])
    attempt = int(spec.get("attempt", 0))
    faults.hit("worker.task", attempt=attempt, detail=f"p{partition}")
    staged_keys = []
    blocks = 0
    rows = out_bytes = 0
    plans: list = []
    try:
        if spec.get("readers"):
            mgr = LocalShuffleManager(spec["shuffle_root"])
            for r in spec["readers"]:
                key = f"{r['resource_id']}.{partition}"
                got = mgr.reduce_blocks(int(r["shuffle_id"]), int(r["n_maps"]), partition)
                RESOURCES.put(key, got)
                staged_keys.append(key)
                blocks += len(got)
        stream = run_task(base64.b64decode(spec["task_def"]), task_attempt_id=attempt, on_plan=plans.append)
        out_path = spec.get("output")
        if out_path:
            algo = integrity.FRAME_ALGO
            # attempt-qualified: a late predecessor never writes into this attempt's temp
            tmp = out_path + f".inprogress.a{attempt}"
            count = xor = 0
            try:
                with open(tmp, "wb") as f:
                    for batch in stream:
                        faults.hit("worker.task", attempt=attempt, detail=f"p{partition}#batch")
                        frame = compress_frame(serialize_batch(batch), codec="raw", checksum_algo=algo)
                        xor ^= struct.unpack("<BI", frame[-5:])[1]
                        f.write(frame)
                        count += 1
                        rows += int(batch.num_rows)
                        out_bytes += len(frame)
                    f.write(block_trailer(count, xor, algo))
                if faults.corrupt("worker.result", attempt=attempt):
                    # bit rot after the write: the driver's verification must catch it
                    integrity.flip_byte_in_file(tmp)
                # a cancel between the drain and the rename commits nothing
                scope = current_cancel_scope()
                if scope is not None:
                    scope.check()
                os.replace(tmp, out_path)
            except BaseException:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                raise
        else:
            for batch in stream:
                faults.hit("worker.task", attempt=attempt, detail=f"p{partition}#batch")
                rows += int(batch.num_rows)
    finally:
        # a registration the plan did not consume must not outlive the
        # job: a serving worker registers the same keys for the next one
        for key in staged_keys:
            RESOURCES.discard(key)
    reads = plan_reads(plans[0], partition) if plans else {}
    return {"rows": rows, "bytes": out_bytes, "blocks": blocks,
            "read_rows": {str(sid): v for sid, v in reads.items()}}


def _describe_error(exc: BaseException) -> dict:
    """A job failure's typed identity for the driver: class name,
    ``retry.classify`` disposition and message; a ``FetchFailedError``'s
    resource, partition and map ids (the partial re-run needs them); a
    ``QueryCancelledError``'s query id and reason."""
    from .context import QueryCancelledError
    from .retry import FetchFailedError, classify

    d = {"error_type": type(exc).__name__, "disposition": classify(exc), "message": str(exc)[:500]}
    if isinstance(exc, FetchFailedError):
        d["resource_id"] = exc.resource_id
        d["partition"] = exc.partition
        if exc.map_ids is not None:
            d["map_ids"] = list(exc.map_ids)
    if isinstance(exc, QueryCancelledError):
        d["query_id"] = exc.query_id
        d["reason"] = getattr(exc, "reason", "cancel")
    return d


def exit_record_path(spec_path: str) -> str:
    return spec_path + ".exit.json"


def _write_exit_record(spec_path: str, exc: BaseException) -> None:
    """The one-shot worker's typed failure beside its spec, written then
    renamed, so the driver routes the exit through ``retry.classify``
    instead of re-spawning blindly; a worker that cannot write it still
    exits nonzero."""
    tmp = exit_record_path(spec_path) + ".tmp"
    try:
        with open(tmp, "w") as f:
            json.dump(_describe_error(exc), f)
        os.replace(tmp, exit_record_path(spec_path))
    except OSError:
        try:
            os.unlink(tmp)
        except OSError:
            pass


def read_exit_record(spec_path: str) -> Optional[dict]:
    """The worker's typed exit record, or None when it died without one."""
    try:
        with open(exit_record_path(spec_path)) as f:
            rec = json.load(f)
    except (OSError, json.JSONDecodeError):
        return None
    return rec if isinstance(rec, dict) else None


def main(spec_path: str, device: str = "cuda") -> int:
    _configure_worker_process(device)
    with open(spec_path) as f:
        spec = json.load(f)
    try:
        _execute_spec(spec)
    except BaseException as e:
        _write_exit_record(spec_path, e)
        raise
    return 0


def serve(device: str = "cuda") -> int:
    """The pooled worker's loop: framed JSON jobs on stdin, one ``done``
    frame a job on stdout (a failed job's carries its typed error, and
    the loop goes on), ``hb`` frames from a daemon thread.  EOF on stdin
    or a ``shutdown`` frame ends it."""
    import threading

    from .. import conf
    from ..io.ipc_compression import compress_frame, iter_stream_frames
    from ..kernels import cuda_ops
    from .integrity import FRAME_ALGO

    init = _configure_worker_process(device)
    on_card = init["device"].startswith("cuda")

    # the real stdout is the protocol's; fd 1 becomes stderr
    proto = os.fdopen(os.dup(1), "wb", buffering=0)
    os.dup2(2, 1)
    sys.stdout = sys.stderr
    wlock = threading.Lock()

    def send(obj: dict) -> None:
        frame = compress_frame(json.dumps(obj).encode(), codec="raw", checksum_algo=FRAME_ALGO)
        with wlock:
            proto.write(frame)

    # cumulative tallies and the last snapshot sent: each frame carries
    # the delta, so the driver adds them up
    tlock = threading.Lock()
    tally = {"rows": 0, "bytes": 0, "jobs_ok": 0, "jobs_failed": 0}
    sent = dict(tally)
    sent_launches: Dict[str, int] = {}
    sent_mem = -1

    def telemetry() -> Optional[dict]:
        nonlocal sent, sent_launches, sent_mem
        cur = dict(cuda_ops.LAUNCHES)
        mem = 0
        if on_card:
            import torch

            mem = int(torch.cuda.max_memory_allocated())
        with tlock:
            tm: dict = {}
            dl = {k: v - sent_launches.get(k, 0) for k, v in cur.items() if v - sent_launches.get(k, 0)}
            if dl:
                tm["launches"] = dl
            for k in tally:
                if tally[k] - sent[k]:
                    tm[k] = tally[k] - sent[k]
            if mem != sent_mem:
                tm["mem_peak"] = mem
            if not tm:
                return None
            sent, sent_launches, sent_mem = dict(tally), cur, mem
            return tm

    def stamp(msg: dict) -> dict:
        tm = telemetry()
        if tm is not None:
            msg["v"] = TELEMETRY_VERSION
            msg["tm"] = tm
        return msg

    hb_s = max(0.005, int(conf.POOL_HEARTBEAT_MS.get()) / 1000.0)
    stop = threading.Event()

    def beat() -> None:
        while not stop.wait(hb_s):
            try:
                send(stamp({"t": "hb", "pid": os.getpid()}))
            except OSError:
                return  # the driver went away; the job loop sees EOF too

    threading.Thread(target=beat, daemon=True, name=f"blaze-pool-beat-{os.getpid()}").start()
    send({"t": "ready", "pid": os.getpid(), **init})
    try:
        for payload in iter_stream_frames(sys.stdin.buffer, site="pool.frame"):
            msg = json.loads(payload.decode())
            if msg.get("t") == "shutdown":
                break
            job_id = msg.get("job_id")
            try:
                out = _execute_spec(msg)
            except BaseException as e:
                with tlock:
                    tally["jobs_failed"] += 1
                reply = stamp({"t": "done", "job_id": job_id, "status": "error", "pid": os.getpid()})
                reply.update(_describe_error(e))
                send(reply)
                if isinstance(e, (KeyboardInterrupt, SystemExit, GeneratorExit)):
                    raise
            else:
                with tlock:
                    tally["jobs_ok"] += 1
                    tally["rows"] += out["rows"]
                    tally["bytes"] += out["bytes"]
                send(stamp({"t": "done", "job_id": job_id, "status": "ok", "pid": os.getpid(),
                            "blocks": out["blocks"], "read_rows": out["read_rows"]}))
    finally:
        stop.set()
    return 0


def read_result_frames(path: str, schema=None):
    """A committed result file's frame payloads, or its batches when
    ``schema`` is given, every frame and the block trailer verified
    (``BlockCorruptionError`` on a mismatch)."""
    from ..io.batch_serde import deserialize_batch
    from ..io.ipc_compression import iter_stream_frames

    with open(path, "rb") as f:
        for payload in iter_stream_frames(f, site="worker.result", path=path):
            yield deserialize_batch(payload, schema) if schema is not None else payload


def verify_result_file(path: str) -> int:
    """Walk every frame of a committed result file; returns the frame
    count, raises ``BlockCorruptionError`` on corruption."""
    return sum(1 for _ in read_result_frames(path))


def worker_env(env: Optional[dict] = None) -> dict:
    """The driver's environment for a worker: ``env`` over it, and the
    package importable from any working directory."""
    run_env = dict(os.environ)
    run_env.update(env or {})
    pkg_parent = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    prior = run_env.get("PYTHONPATH", "")
    run_env["PYTHONPATH"] = pkg_parent + (os.pathsep + prior if prior else "")
    return run_env


def run_worker_with_retry(spec: dict, spec_dir: str, tag: str, max_attempts: Optional[int] = None,
                          env: Optional[dict] = None, timeout: float = 300.0, device: str = "cuda") -> int:
    """Run ``spec`` in one-shot workers (each in its own session) under
    the task retry policy; returns the attempt that succeeded.  An
    attempt fails on a nonzero exit, on no committed output, on a result
    file that fails verification (deleted, never served) or on running
    past ``timeout`` (its process group killed); a fresh attempt id
    follows.  A typed exit record classed fatal raises at once, a
    ``QueryCancelledError`` as itself.  The poll loop is a cancel
    checkpoint: a cancelled query kills the worker's group, sweeps its
    temp and raises.  Raises ``TaskRetriesExhausted`` after the budget."""
    import glob
    import subprocess
    import time

    from .context import QueryCancelledError, current_cancel_scope
    from .integrity import BlockCorruptionError
    from .retry import FATAL, RetryPolicy, TaskRetriesExhausted

    policy = RetryPolicy.from_conf()
    if max_attempts is not None:
        policy = policy.with_max_attempts(max_attempts)
    run_env = worker_env(env)
    out_path = spec.get("output")
    partition = int(spec.get("partition", 0))

    def sweep_inprogress() -> None:
        # a killed worker cannot unlink its own temp
        if out_path:
            for stale in glob.glob(out_path + ".inprogress*"):
                try:
                    os.unlink(stale)
                except OSError:
                    pass

    last_failure: Optional[Exception] = None
    for attempt in range(policy.max_attempts):
        spec_path = os.path.join(spec_dir, f"spec_{tag}_a{attempt}.json")
        with open(spec_path, "w") as f:
            json.dump(dict(spec, attempt=attempt), f)
        stderr_tail, reason = "", None
        scope = current_cancel_scope()
        proc = subprocess.Popen([sys.executable, "-m", "blaze_tpu_torch.runtime.worker", "--device", device,
                                 spec_path], env=run_env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                start_new_session=True)
        deadline = time.monotonic() + timeout
        while True:
            try:
                # communicate drains the pipes: a chatty worker never blocks on a full one
                _, err = proc.communicate(timeout=0.05)
                stderr_tail = (err or b"").decode(errors="replace")[-500:]
                break
            except subprocess.TimeoutExpired:
                pass
            if scope is not None and scope.cancelled:
                terminate_process_group(proc)
                proc.communicate()
                sweep_inprogress()
                scope.raise_cancelled()
            if time.monotonic() > deadline:
                terminate_process_group(proc)
                _, err = proc.communicate()
                stderr_tail = (err or b"").decode(errors="replace")[-500:]
                reason = f"hung past {timeout}s and was killed"
                break
        if reason is None:
            if proc.returncode == 0 and (not out_path or os.path.exists(out_path)):
                if not out_path:
                    return attempt
                try:
                    verify_result_file(out_path)
                    return attempt
                except BlockCorruptionError as e:
                    try:
                        os.unlink(out_path)
                    except OSError:
                        pass
                    reason, stderr_tail = f"committed output failed checksum verification: {e}", ""
            else:
                reason = (f"exit status {proc.returncode}" if proc.returncode != 0
                          else "worker exited 0 but produced no committed output")
                rec = read_exit_record(spec_path) if proc.returncode != 0 else None
                if rec and rec.get("disposition") == FATAL:
                    sweep_inprogress()
                    if rec.get("error_type") == "QueryCancelledError":
                        raise QueryCancelledError(str(rec.get("query_id") or "worker"),
                                                  reason=str(rec.get("reason") or "cancel"))
                    from .hostpool import WorkerTaskFatalError

                    raise WorkerTaskFatalError(str(rec.get("error_type") or "Exception"),
                                               str(rec.get("message") or ""))
        last_failure = RuntimeError(f"worker attempt {attempt} failed ({reason}): " + stderr_tail)
        sweep_inprogress()
        if attempt + 1 < policy.max_attempts:
            policy.sleep_before_retry(0, partition, attempt)
    raise TaskRetriesExhausted(0, partition, policy.max_attempts, last_failure or RuntimeError("no attempts ran"))


def terminate_process_group(proc) -> None:
    """SIGTERM a worker's process group, SIGKILL it if it is still alive
    half a second later; safe on a process already gone."""
    import signal
    import subprocess

    if proc.returncode is not None:
        # reaped already: its pid may be another process's by now, and
        # that process's group no worker's
        return
    try:
        pgid = os.getpgid(proc.pid)
    except (OSError, ProcessLookupError):
        pgid = None
    for sig in (signal.SIGTERM, signal.SIGKILL):
        try:
            if pgid is not None:
                os.killpg(pgid, sig)
            else:
                proc.send_signal(sig)
        except (OSError, ProcessLookupError):
            return
        try:
            proc.wait(timeout=0.5)
            return
        except subprocess.TimeoutExpired:
            continue


if __name__ == "__main__":
    args = sys.argv[1:]
    dev = args[args.index("--device") + 1] if "--device" in args else "cuda"
    if "--serve" in args:
        sys.exit(serve(dev))
    sys.exit(main(args[-1], dev))
