"""The worker host pool: placement, liveness, lost-worker recovery and
blacklisting (≙ ``blaze_tpu/runtime/hostpool.py``).

Spark binds tasks to long-lived executors, notices one dying (heartbeat
loss, exit status), invalidates the map outputs that died with it and
resubmits only those partitions on the survivors; repeat offenders are
blacklisted.  :class:`HostPool` is that for ``worker.py --serve``
processes: the scheduler (``run_stages(..., pool=)``) binds eligible
map tasks to them, one at a time, on the driver's thread.

Protocol: checksummed JSON frames (``io/ipc_compression.py``, raw
codec).  The driver writes a job (``scheduler.worker_task_spec`` and a
``job_id``) to a worker's stdin; the worker answers on stdout with
``ready``, ``hb`` every ``spark.blaze.pool.heartbeatMs`` and one
``done`` a job.  A heartbeat is never taken for a reply, and a ``done``
of an abandoned earlier job is skipped by its ``job_id``.  A failed job
comes back typed (:meth:`HostPool._rebuild_error`): a real
``FetchFailedError`` with its map ids, the cancel error, or
:class:`WorkerTaskError` / :class:`WorkerTaskFatalError` by the
worker-side disposition.

Liveness: the reader thread stamps each frame's arrival.  A worker is
lost on a nonzero exit, on stdout's end (a SIGKILL), or, once it has
sent ``ready``, on heartbeat silence past
``spark.blaze.pool.livenessTimeoutMs``; :class:`WorkerLostError` then
carries the map outputs it committed (``lost_outputs``), which the
scheduler re-runs through its partial re-run before it retries the
interrupted task.  A slot lost ``spark.blaze.host.blacklist.maxFailures``
times within ``spark.blaze.host.blacklist.decaySec`` is blacklisted (no
respawn; re-admitted once its count decays); with every slot dead or
blacklisted :meth:`HostPool.placement` returns None, the pool is
degraded and the scheduler runs the task in process.  The wait for a
job is a cancel checkpoint: a cancelled query kills the bound worker,
which cannot see the driver's scope, without charging its slot.

Every worker is a fresh interpreter (``subprocess.Popen``, never a fork
of a driver that has touched CUDA) in a session of its own, so a loss,
a cancel or :meth:`HostPool.close` reaps its whole process group and no
CUDA context is left on the card.  On the card each worker holds a
context of its own; the driver builds the kernel library before the
first spawn so that the workers load it instead of each running nvcc.

The pool's state (slots, ownership, failures, blacklist, rotor) changes
under one ``threading.Lock``; spawns, kills and waits happen outside it.
The reference's monitor registry, resource ledger and trace events are
not ported (ROADMAP A.12): ``worker_kills`` and ``workers_blacklisted``
count in :meth:`HostPool.stats`, and each worker's telemetry (its
start-up, jobs, rows, bytes, peak allocation and kernel launches) in
:meth:`HostPool.worker_telemetry`.
"""

from __future__ import annotations

import json
import queue
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional, Set, Tuple

from .. import conf
from .worker import TELEMETRY_VERSION, terminate_process_group, worker_env


class WorkerLostError(Exception):
    """A pooled worker died while bound to a task.  ``lost_outputs``
    maps shuffle id -> sorted map ids of the committed outputs it owned,
    which re-run before the task retries.  Retried."""

    def __init__(self, worker: str, reason: str, lost_outputs: Optional[Dict[int, List[int]]] = None):
        self.worker = worker
        self.reason = reason
        self.lost_outputs: Dict[int, List[int]] = {
            int(sid): sorted(mids) for sid, mids in (lost_outputs or {}).items() if mids}
        super().__init__(f"pooled worker {worker!r} lost ({reason})"
                         + (f"; owned map outputs {self.lost_outputs}" if self.lost_outputs else ""))


class WorkerTaskError(RuntimeError):
    """A pooled job failed with an error its worker classed as retried
    (rebuilt from the reply's class name and message); the worker itself
    is healthy."""

    def __init__(self, error_type: str, message: str):
        self.error_type = error_type
        super().__init__(f"worker task failed [{error_type}]: {message}")


class WorkerTaskFatalError(RuntimeError):
    """A worker failure its worker classed as fatal: a re-run would fail
    the same way.  Not retried."""

    def __init__(self, error_type: str, message: str):
        self.error_type = error_type
        super().__init__(f"fatal worker failure [{error_type}]: {message}")


class _Worker:
    """One slot's live process, its reader thread, and the stamps that
    thread keeps (each a single store by the reader, read by the waiter)."""

    def __init__(self, name: str, proc: subprocess.Popen):
        self.name = name
        self.proc = proc
        self.replies: "queue.Queue[Optional[dict]]" = queue.Queue()
        self.spawned = time.monotonic()
        self.last_beat = time.monotonic_ns()
        self.ready = threading.Event()
        self.eof = False
        self.thread: Optional[threading.Thread] = None


class HostPool:
    """``n_workers`` persistent ``worker.py --serve`` processes on
    ``device`` (``cuda`` unless the caller asks for ``cpu``) with ``env``
    over the driver's environment."""

    def __init__(self, n_workers: Optional[int] = None, env: Optional[Dict[str, str]] = None,
                 device: str = "cuda"):
        self._n = int(n_workers if n_workers is not None else conf.POOL_WORKERS.get())
        self._env = dict(env or {})
        self._device = str(device)
        self._hb_ms = int(conf.POOL_HEARTBEAT_MS.get())
        self._liveness_ms = int(conf.POOL_LIVENESS_TIMEOUT_MS.get())
        self._max_failures = int(conf.HOST_BLACKLIST_MAX_FAILURES.get())
        self._decay_s = float(conf.HOST_BLACKLIST_DECAY_SEC.get())
        self._names: Tuple[str, ...] = tuple(f"w{i}" for i in range(max(0, self._n)))
        self._lock = threading.Lock()
        self._slots: Dict[str, _Worker] = {}
        self._map_outputs: Dict[str, Dict[int, Set[int]]] = {}
        self._failures: Dict[str, List[float]] = {}
        self._blacklisted: Set[str] = set()
        self._rr = 0
        self._job_seq = 0
        self._lost_total = 0
        self._kills = 0
        self._blacklistings = 0
        self._degraded = False
        self._closed = False
        self._tm_lock = threading.Lock()
        self._telemetry: Dict[int, dict] = {}  # pid -> what that process reported
        try:
            if self._names and self._device.startswith("cuda"):
                from ..kernels import build

                build.library()  # built once here, loaded by every worker
            for name in self._names:
                self._ensure_spawned(name)
        except BaseException:
            self.close()  # no worker outlives a pool that failed to start
            raise

    # ------------------------------------------------------- lifecycle

    def _spawn(self, name: str) -> _Worker:
        """Start one worker in its own session and its reader thread."""
        env = worker_env(self._env)
        env["BLAZE_POOL_HEARTBEATMS"] = str(self._hb_ms)
        proc = subprocess.Popen(
            [sys.executable, "-m", "blaze_tpu_torch.runtime.worker", "--serve", "--device", self._device],
            env=env, stdin=subprocess.PIPE, stdout=subprocess.PIPE, start_new_session=True)
        w = _Worker(name, proc)
        with self._tm_lock:
            self._telemetry[proc.pid] = {"worker": name, "pid": proc.pid, "ready_s": None, "init": None,
                                         "rows": 0, "bytes": 0, "jobs_ok": 0, "jobs_failed": 0, "mem_peak": 0,
                                         "launches": {}}
        w.thread = threading.Thread(target=self._read_loop, args=(w,), name=f"blaze-pool-read-{name}",
                                    daemon=True)
        w.thread.start()
        return w

    def _ensure_spawned(self, name: str) -> None:
        """Spawn a slot's worker if the slot is empty and not blacklisted."""
        with self._lock:
            if self._closed or name in self._slots or name in self._blacklisted:
                return
        w = self._spawn(name)
        stale = None
        with self._lock:
            if self._closed or name in self._slots:
                stale = w  # lost the race, or closing: reap it
            else:
                self._slots[name] = w
        if stale is not None:
            self._reap(stale)

    @staticmethod
    def _reap(w: _Worker) -> None:
        terminate_process_group(w.proc)
        if w.thread is not None:
            w.thread.join(timeout=2.0)
        for pipe in (w.proc.stdin, w.proc.stdout):
            try:
                pipe.close()
            except (OSError, ValueError):
                pass

    def _fold(self, pid: int, tm: dict) -> None:
        with self._tm_lock:
            rec = self._telemetry.get(pid)
            if rec is None:
                return
            for k in ("rows", "bytes", "jobs_ok", "jobs_failed"):
                rec[k] += int(tm.get(k, 0))
            if "mem_peak" in tm:
                rec["mem_peak"] = max(rec["mem_peak"], int(tm["mem_peak"]))
            for k, v in (tm.get("launches") or {}).items():
                rec["launches"][k] = rec["launches"].get(k, 0) + int(v)

    def _read_loop(self, w: _Worker) -> None:
        """Every frame stamps liveness and folds its telemetry; ``done``
        frames queue for the waiter.  The stream's end (an exit, a
        SIGKILL, a frame torn by a death) queues None so a waiter wakes
        at once."""
        from ..io.ipc_compression import iter_stream_frames
        from .integrity import BlockCorruptionError

        try:
            for payload in iter_stream_frames(w.proc.stdout, site="pool.frame"):
                try:
                    msg = json.loads(payload.decode())
                except (UnicodeDecodeError, json.JSONDecodeError):
                    continue
                w.last_beat = time.monotonic_ns()
                if msg.get("v") == TELEMETRY_VERSION and isinstance(msg.get("tm"), dict):
                    self._fold(w.proc.pid, msg["tm"])
                t = msg.get("t")
                if t == "ready":
                    with self._tm_lock:
                        rec = self._telemetry[w.proc.pid]
                        rec["ready_s"] = time.monotonic() - w.spawned
                        rec["init"] = {k: v for k, v in msg.items() if k not in ("t", "pid")}
                    w.ready.set()
                elif t == "done":
                    w.replies.put(msg)
        except (BlockCorruptionError, OSError, ValueError):
            # a killed worker tears its last frame or closes the pipe;
            # its death is reported by the sentinel and the waiter's checks
            pass
        w.eof = True
        w.replies.put(None)

    def close(self) -> None:
        """Shut down: ``shutdown`` frames, waits of 2 s, then process-group
        kills; joins the reader threads."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            slots = list(self._slots.values())
            self._slots.clear()
        from ..io.ipc_compression import compress_frame
        from .integrity import FRAME_ALGO

        bye = compress_frame(json.dumps({"t": "shutdown"}).encode(), codec="raw", checksum_algo=FRAME_ALGO)
        for w in slots:
            try:
                w.proc.stdin.write(bye)
                w.proc.stdin.flush()
                w.proc.stdin.close()
            except (BrokenPipeError, OSError, ValueError):
                pass
        for w in slots:
            try:
                w.proc.wait(timeout=2.0)
            except subprocess.TimeoutExpired:
                pass
            # the group too: nothing a worker started outlives it
            self._reap(w)

    def __enter__(self) -> "HostPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def wait_ready(self, timeout: float = 300.0) -> bool:
        """Wait until every live slot's worker has sent ``ready``; True
        when they all did within ``timeout`` seconds."""
        deadline = time.monotonic() + timeout
        with self._lock:
            workers = list(self._slots.values())
        for w in workers:
            while not w.ready.wait(0.05):
                if w.eof or time.monotonic() > deadline:
                    return False
        return True

    # ------------------------------------------------------- placement

    def placement(self, stage_id: int, t: int) -> Optional[str]:
        """Round-robin binding over the live, non-blacklisted slots;
        decayed blacklist entries are re-admitted (and respawned) here.
        None when every slot is blacklisted: the pool is degraded and
        the caller runs the task in process."""
        respawn: List[str] = []
        with self._lock:
            if self._closed or not self._names:
                return None
            now = time.monotonic()
            for name in sorted(self._blacklisted):
                fails = [ts for ts in self._failures.get(name, []) if now - ts <= self._decay_s]
                self._failures[name] = fails
                if len(fails) < self._max_failures:
                    self._blacklisted.discard(name)  # decayed: re-admitted
            live = [n for n in self._names if n not in self._blacklisted]
            if not live:
                self._degraded = True
                return None
            self._degraded = False
            chosen = live[self._rr % len(live)]
            self._rr += 1
            respawn = [n for n in live if n not in self._slots]
        for name in respawn:
            self._ensure_spawned(name)
        return chosen

    def degraded(self) -> bool:
        with self._lock:
            return self._degraded

    def stats(self) -> Dict[str, int]:
        """Size, live and blacklisted slots, losses, the degraded flag,
        and the kills for a cancel and the blacklistings so far."""
        with self._lock:
            live = sum(1 for w in self._slots.values() if not w.eof and w.proc.poll() is None)
            return {"workers": len(self._names), "live": live, "lost": self._lost_total,
                    "blacklisted": len(self._blacklisted), "degraded": bool(self._degraded),
                    "worker_kills": self._kills, "workers_blacklisted": self._blacklistings}

    def heartbeat_ages(self) -> Dict[str, float]:
        """Seconds since each live worker's last frame."""
        now = time.monotonic_ns()
        with self._lock:
            return {n: (now - w.last_beat) / 1e9 for n, w in self._slots.items()}

    def pids(self) -> Dict[str, int]:
        """The process id of each live slot's worker."""
        with self._lock:
            return {n: w.proc.pid for n, w in self._slots.items()}

    def worker_telemetry(self) -> List[dict]:
        """What every worker this pool started reported, by process:
        seconds from spawn to ``ready``, its start-up record, jobs ok and
        failed, rows and result bytes, peak allocation and launches."""
        with self._tm_lock:
            return [json.loads(json.dumps(rec)) for rec in self._telemetry.values()]

    def launches(self) -> Dict[str, int]:
        """The kernel launches of every worker's jobs, summed."""
        out: Dict[str, int] = {}
        for rec in self.worker_telemetry():
            for k, v in rec["launches"].items():
                out[k] = out.get(k, 0) + v
        return out

    # ------------------------------------------------------- bookkeeping

    def note_map_output(self, worker: str, shuffle_id: int, map_id: int) -> None:
        """``worker`` committed map output ``map_id`` of ``shuffle_id``."""
        with self._lock:
            self._map_outputs.setdefault(worker, {}).setdefault(int(shuffle_id), set()).add(int(map_id))

    def owned_map_outputs(self) -> int:
        """Committed map outputs owned by live pooled workers."""
        with self._lock:
            return sum(len(m) for per in self._map_outputs.values() for m in per.values())

    def lost_counts(self) -> Dict[str, int]:
        """Each slot's failures within the decay window."""
        now = time.monotonic()
        with self._lock:
            return {n: len([ts for ts in f if now - ts <= self._decay_s]) for n, f in self._failures.items()}

    def blacklisted(self) -> List[str]:
        with self._lock:
            return sorted(self._blacklisted)

    # ------------------------------------------------------- execution

    def run_task(self, spec: dict, worker: str, timeout: float = 300.0, scope=None) -> dict:
        """Run one job on ``worker`` and return its ``done`` reply,
        watching the worker the whole way: a nonzero exit, stdout's end
        or heartbeat silence past the liveness timeout raises
        :class:`WorkerLostError`; a failed job raises its typed error; a
        cancelled query (``scope``, by default the ambient one) kills the
        worker and raises the cancel error."""
        from ..io.ipc_compression import compress_frame
        from .context import current_cancel_scope
        from .integrity import FRAME_ALGO

        with self._lock:
            w = self._slots.get(worker)
            self._job_seq += 1
            job_id = self._job_seq
        if w is None or w.eof or w.proc.poll() is not None:
            self._worker_lost(worker, "worker dead before dispatch")
        frame = compress_frame(json.dumps(dict(spec, job_id=job_id)).encode(), codec="raw",
                               checksum_algo=FRAME_ALGO)
        try:
            w.proc.stdin.write(frame)
            w.proc.stdin.flush()
        except (BrokenPipeError, OSError, ValueError):
            self._worker_lost(worker, "stdin pipe broken (worker exited)")
        scope = scope if scope is not None else current_cancel_scope()
        deadline = time.monotonic() + timeout
        while True:
            try:
                reply = w.replies.get(timeout=0.05)
            except queue.Empty:
                if scope is not None and scope.cancelled:
                    self._kill_for_cancel(worker)
                    scope.raise_cancelled()
                rc = w.proc.poll()
                if rc is not None and w.eof:
                    self._worker_lost(worker, f"killed by signal {-rc}" if rc < 0 else f"exit status {rc}")
                age_ms = (time.monotonic_ns() - w.last_beat) / 1e6
                if w.ready.is_set() and age_ms > self._liveness_ms:
                    self._worker_lost(worker, f"heartbeat silent for {age_ms:.0f}ms")
                if time.monotonic() > deadline:
                    self._worker_lost(worker, f"job hung past {timeout}s")
                continue
            if reply is None:  # the reader's end-of-stream sentinel
                try:
                    rc = w.proc.wait(timeout=2.0)
                except subprocess.TimeoutExpired:
                    rc = None
                self._worker_lost(worker, f"killed by signal {-rc}" if rc is not None and rc < 0
                                  else f"stdout closed (exit {rc})")
            if reply.get("job_id") != job_id:
                continue  # a reply of an abandoned earlier job
            break
        if reply.get("status") == "ok":
            return reply
        raise self._rebuild_error(reply)

    @staticmethod
    def _rebuild_error(reply: dict) -> BaseException:
        """The driver-side typed error of a failed job's reply."""
        et = str(reply.get("error_type") or "Exception")
        msg = str(reply.get("message") or "")
        if reply.get("resource_id"):
            from .retry import FetchFailedError

            err = FetchFailedError(str(reply["resource_id"]), partition=int(reply.get("partition", -1)),
                                   detail=f"in a pooled worker: {msg}", map_ids=reply.get("map_ids"))
            err.__cause__ = WorkerTaskError(et, msg)
            return err
        if et in ("QueryCancelledError", "QueryDeadlineError"):
            from .context import QueryCancelledError

            return QueryCancelledError(str(reply.get("query_id") or "worker"),
                                       reason=str(reply.get("reason") or "cancel"))
        if reply.get("disposition") == "fatal":
            return WorkerTaskFatalError(et, msg)
        return WorkerTaskError(et, msg)

    # ------------------------------------------------------- loss path

    def _kill_for_cancel(self, name: str) -> None:
        """Reap a worker for a cancel, with no failure charged to its
        slot (the driver chose the kill); the slot respawns at the next
        placement."""
        with self._lock:
            w = self._slots.pop(name, None)
            self._map_outputs.pop(name, None)
            self._kills += 1
        if w is not None:
            self._reap(w)

    def _worker_lost(self, name: str, reason: str) -> None:
        """Declare a slot's worker dead: reap it, charge the slot one
        decayed failure, blacklist it at the threshold (else respawn),
        and raise :class:`WorkerLostError` with the outputs it owned."""
        with self._lock:
            w = self._slots.pop(name, None)
            lost = self._map_outputs.pop(name, {})
            now = time.monotonic()
            fails = [ts for ts in self._failures.get(name, []) if now - ts <= self._decay_s]
            fails.append(now)
            self._failures[name] = fails
            blacklist = len(fails) >= self._max_failures
            if blacklist:
                self._blacklisted.add(name)
                self._blacklistings += 1
            self._lost_total += 1
        if w is not None:
            self._reap(w)
        if not blacklist:
            self._ensure_spawned(name)
        raise WorkerLostError(name, reason, lost_outputs={sid: sorted(m) for sid, m in lost.items()})
