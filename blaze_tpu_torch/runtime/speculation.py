"""Speculative attempts and wedge detection for the stage scheduler (≙
``blaze_tpu/runtime/speculation.py``, without its trace events,
monitor registry and query cancel scope).

A retry recovers a task that fails; a task that only straggles (a slow
host, a wedged kernel) holds its stage back without ever raising.
:class:`StageTaskRunner` runs a map or broadcast stage's tasks on
threads, ``spark.blaze.stage.taskConcurrency`` at a time, and:

- **speculates** (``spark.blaze.speculation.*``): once a quantile of the
  stage's tasks are done, a task running longer than ``multiplier``
  times their median (and at least ``minRuntime``), or whose heartbeat
  is older than ``wedgeMs``, gets ONE backup attempt, its id from
  :data:`SPEC_ATTEMPT_BASE` up.  The first attempt to finish wins (its
  commit stands: the atomic-rename shuffle commit, the broadcast blob of
  the attempt's own resources map); the loser is cancelled, and a
  cancelled attempt commits nothing;
- **retries a wedged task** (``spark.blaze.task.wedgeMs``): with no
  backup to race, a task whose heartbeat is older than that is
  cancelled and failed with ``TaskWedgedError``, which the scheduler
  retries as a timeout.

The heartbeat is ``serde.from_proto.run_task``'s ``on_beat``, fired by
the operators' output batches on the task's thread.  The scheduler
runs a stage's first task alone before the runner starts (it builds
and loads the kernel library, and materializes what the stage reads
once), so that no backup races a build or a materialization and no
build looks wedged.
"""

from __future__ import annotations

import math
import statistics
import threading
import time
from dataclasses import dataclass
from typing import Callable, List, Optional

from .. import conf
from .retry import FATAL, TaskWedgedError, classify

#: speculative attempt ids start here, far above any retry's id, so a
#: backup's temporary files and its ``@a<n>``-gated faults are its own
SPEC_ATTEMPT_BASE = 100

#: seconds to wait for a cancelled attempt to stop before leaving its
#: thread to the stage's end
_LOSER_JOIN_S = 5.0


@dataclass(frozen=True)
class SpeculationPolicy:
    """The speculation, wedge and concurrency knobs of one stage run."""

    enabled: bool = False
    multiplier: float = 1.5
    quantile: float = 0.75
    min_runtime: float = 0.1
    wedge_ms: int = 0
    task_wedge_ms: int = 0
    concurrency: int = 1

    @classmethod
    def from_conf(cls) -> "SpeculationPolicy":
        return cls(enabled=bool(conf.SPECULATION_ENABLE.get()),
                   multiplier=max(1.0, float(conf.SPECULATION_MULTIPLIER.get())),
                   quantile=min(1.0, max(0.0, float(conf.SPECULATION_QUANTILE.get()))),
                   min_runtime=max(0.0, float(conf.SPECULATION_MIN_RUNTIME.get())),
                   wedge_ms=max(0, int(conf.SPECULATION_WEDGE_MS.get())),
                   task_wedge_ms=max(0, int(conf.TASK_WEDGE_MS.get())),
                   concurrency=max(1, int(conf.STAGE_TASK_CONCURRENCY.get())))

    def runner_needed(self) -> bool:
        """Whether a stage needs the runner at all: with none of these
        armed, its tasks run one after another on the driver's thread."""
        return self.enabled or self.task_wedge_ms > 0 or self.concurrency > 1

    def quantile_met(self, n_done: int, n_tasks: int) -> bool:
        return n_done >= max(1, math.ceil(self.quantile * n_tasks))

    def should_speculate(self, runtime_s: float, done_durations: List[float], n_tasks: int) -> bool:
        """The duration trigger: slow against the tasks done."""
        if not self.enabled or not done_durations or not self.quantile_met(len(done_durations), n_tasks):
            return False
        return runtime_s >= self.min_runtime and runtime_s > self.multiplier * statistics.median(done_durations)

    def is_spec_wedged(self, beat_age_s: float) -> bool:
        """The wedge trigger of speculation."""
        return self.enabled and self.wedge_ms > 0 and beat_age_s * 1000.0 > self.wedge_ms

    def is_retry_wedged(self, beat_age_s: float) -> bool:
        """The wedge trigger of a plain retry."""
        return self.task_wedge_ms > 0 and beat_age_s * 1000.0 > self.task_wedge_ms


class _Attempt:
    """One running attempt of one task, on a thread of its own.  Each
    field has one writer: ``last_beat``, ``ok`` and ``error`` the
    attempt's thread (``ok`` and ``error`` before ``done`` is set), the
    rest the driver."""

    __slots__ = ("cancel", "thread", "started", "last_beat", "done", "error", "ok")

    def __init__(self):
        self.cancel = threading.Event()
        self.thread: Optional[threading.Thread] = None
        self.started = time.monotonic()
        self.last_beat = self.started
        self.done = threading.Event()
        self.error: Optional[BaseException] = None
        self.ok = False

    def beat(self) -> None:
        self.last_beat = time.monotonic()

    def beat_age(self, now: float) -> float:
        return now - max(self.started, self.last_beat)

    def runtime(self, now: float) -> float:
        return now - self.started


class _TaskState:
    """The driver's state of one task."""

    __slots__ = ("task", "attempt_no", "regens", "primary", "backup", "pending_error", "finished", "speculated",
                 "relaunch_at")

    def __init__(self, task: int):
        self.task = task
        self.attempt_no = 0  # the primary's retry counter
        self.regens = 0
        self.primary: Optional[_Attempt] = None
        self.backup: Optional[_Attempt] = None
        self.pending_error: Optional[BaseException] = None
        self.finished = False
        self.speculated = False  # one backup a task, ever
        self.relaunch_at: Optional[float] = None  # a relaunch waiting out its backoff


class StageTaskRunner:
    """Runs a map or broadcast stage's tasks on threads, with
    speculation and wedge handling.  ``attempt_fn(t, attempt_id,
    cancel_event, on_beat)`` runs one attempt to its end (raising on
    failure); ``on_failure(t, exc,
    attempt, regens) -> (attempt, regens, delay_s)`` is the scheduler's
    recovery (``handle_failure``), raising when the failure is
    terminal; ``count(name, n)`` adds to the run's counters.
    ``durations`` are tasks already done (the warm-up)."""

    def __init__(self, stage_id: int, tasks: List[int], policy: SpeculationPolicy,
                 attempt_fn: Callable, on_failure: Callable, count: Callable[[str, int], None],
                 durations: Optional[List[float]] = None) -> None:
        self.stage_id = stage_id
        self.tasks = list(tasks)
        self.policy = policy
        self.attempt_fn = attempt_fn
        self.on_failure = on_failure
        self.count = count
        self.durations: List[float] = list(durations or [])
        self.n_tasks = len(self.tasks) + len(self.durations)
        self._abandoned: List[_Attempt] = []

    def _spawn(self, state: _TaskState, attempt_id: int) -> _Attempt:
        att = _Attempt()

        def body() -> None:
            try:
                self.attempt_fn(state.task, attempt_id, att.cancel, att.beat)
                att.ok = True
            except BaseException as exc:  # noqa: BLE001 - the driver classifies it
                att.error = exc
            finally:
                att.done.set()

        att.thread = threading.Thread(target=body, daemon=True,
                                      name=f"blaze-attempt-{self.stage_id}-{state.task}-a{attempt_id}")
        att.thread.start()
        return att

    def _reap(self, att: _Attempt) -> None:
        """Cancel an attempt and wait for it to stop; one that does not
        stop in time is joined at the stage's end."""
        att.cancel.set()
        att.thread.join(timeout=_LOSER_JOIN_S)
        if att.thread.is_alive():
            self._abandoned.append(att)

    def _resolve_speculation(self, state: _TaskState, winner: _Attempt) -> None:
        backup = state.backup
        if backup is None:
            return
        self.count("speculative_won" if winner is backup else "speculative_lost", 1)
        loser = state.primary if winner is backup else backup
        if loser is not None and not loser.done.is_set():
            self._reap(loser)
        state.backup = None

    def _launch_backup(self, state: _TaskState) -> None:
        state.speculated = True
        self.count("speculative_attempts", 1)
        state.backup = self._spawn(state, SPEC_ATTEMPT_BASE + state.attempt_no)

    def _finish_task(self, state: _TaskState, winner: _Attempt) -> None:
        self.durations.append(winner.runtime(time.monotonic()))
        self._resolve_speculation(state, winner)
        state.finished = True

    def _handle_primary_failure(self, state: _TaskState, exc: BaseException) -> None:
        """The primary failed with no backup left to win: the
        scheduler's recovery (may raise), then a relaunch, at once or
        when its backoff is due (the poll loop waits, so one task's
        backoff never holds the others)."""
        state.primary = None
        state.attempt_no, state.regens, delay = self.on_failure(state.task, exc, state.attempt_no, state.regens)
        if delay > 0:
            state.relaunch_at = time.monotonic() + delay
        else:
            state.primary = self._spawn(state, state.attempt_no)

    def _check_one(self, state: _TaskState, now: float) -> None:
        primary, backup = state.primary, state.backup
        if state.relaunch_at is not None and primary is None:
            if now >= state.relaunch_at:
                state.relaunch_at = None
                state.primary = self._spawn(state, state.attempt_no)
            return
        # completions, the backup first: when both finished in one poll
        # their outputs are the same, and the backup's win is the one
        # the tests know to expect.  A cancelled attempt never wins.
        for att in (backup, primary):
            if att is not None and att.done.is_set() and att.ok and not att.cancel.is_set():
                self._finish_task(state, att)
                return
        if backup is not None and backup.done.is_set() and not backup.ok:
            # a failed backup costs the task no attempt of its budget
            self.count("speculative_lost", 1)
            state.backup = None
        if primary is not None and primary.done.is_set() and not primary.ok:
            exc = primary.error
            if state.backup is not None:
                if classify(exc) == FATAL:
                    raise exc
                state.pending_error = exc  # the backup may still win
                state.primary = None
            else:
                self._handle_primary_failure(state, exc)
            return
        if state.primary is None and state.backup is None and state.pending_error is not None:
            exc, state.pending_error = state.pending_error, None
            self._handle_primary_failure(state, exc)
            return
        primary, backup = state.primary, state.backup
        if primary is None and backup is not None and not backup.done.is_set() \
                and self.policy.is_retry_wedged(backup.beat_age(now)):
            # a backup left alone wedges too: reaped as lost, and the
            # pending error relaunches the primary
            self.count("speculative_lost", 1)
            self._reap(backup)
            state.backup = None
            return
        if primary is not None and backup is not None and not primary.done.is_set() \
                and not backup.done.is_set() and self.policy.is_retry_wedged(primary.beat_age(now)) \
                and self.policy.is_retry_wedged(backup.beat_age(now)):
            # both wedged (a hung card, stuck IO): no race can end it
            self.count("speculative_lost", 1)
            self._reap(backup)
            state.backup = None
            self._reap(primary)
            self._handle_primary_failure(state, TaskWedgedError(
                f"task {state.task} of stage {self.stage_id}: primary and backup heartbeats both older than "
                f"{self.policy.task_wedge_ms} ms"))
            return
        if primary is None or primary.done.is_set() or backup is not None:
            return
        age = primary.beat_age(now)
        can_speculate = not state.speculated and self.policy.enabled
        if can_speculate and (self.policy.is_spec_wedged(age) or self.policy.should_speculate(
                primary.runtime(now), self.durations, self.n_tasks)):
            self._launch_backup(state)
        elif self.policy.is_retry_wedged(age):
            self._reap(primary)
            self._handle_primary_failure(state, TaskWedgedError(
                f"task {state.task} of stage {self.stage_id}: heartbeat older than {self.policy.task_wedge_ms} ms"))

    def run(self) -> None:
        pending = [_TaskState(t) for t in self.tasks]
        running: List[_TaskState] = []
        # at most 50 ms: the wait watches one attempt, so this bounds how
        # late any other attempt's end or a due relaunch is seen
        poll_s = min([max(5, m) / 4000.0 for m in (self.policy.wedge_ms, self.policy.task_wedge_ms) if m > 0]
                     + [0.05])
        try:
            while pending or running:
                while pending and len(running) < self.policy.concurrency:
                    st = pending.pop(0)
                    st.primary = self._spawn(st, st.attempt_no)
                    running.append(st)
                now = time.monotonic()
                for st in list(running):
                    self._check_one(st, now)
                    if st.finished:
                        running.remove(st)
                attempts = [a for st in running for a in (st.primary, st.backup) if a is not None]
                if attempts and not any(a.done.is_set() for a in attempts):
                    attempts[0].done.wait(poll_s)
                elif running and not attempts:
                    time.sleep(poll_s)  # every running task waits out a backoff
        except BaseException:
            # terminal: stop every attempt before the error leaves the stage
            live = [a for st in running for a in (st.primary, st.backup) if a is not None]
            for att in live:
                att.cancel.set()
            for att in live:
                att.thread.join(timeout=_LOSER_JOIN_S)
            raise
        finally:
            for att in self._abandoned:
                att.thread.join(timeout=_LOSER_JOIN_S)
