"""Retry policy and the classification of a failed task attempt (≙
``blaze_tpu/runtime/retry.py``).

The scheduler's attempt loop (``runtime/scheduler.py``) asks
:func:`classify` what a failure calls for: a fresh attempt of the task
(:data:`RETRY`), the regeneration of the stage that produced what the
task could not read, then a fresh attempt (:data:`FETCH_FAILED`), or
nothing (:data:`FATAL`: the error propagates).  The reference resolves
its classes through its error registry (``error_names.json``); the
port keeps its own table of the classes it has, with the reference's
dispositions, and the reference's rules for everything else.

Backoff is deterministic: its jitter is a hash of (stage, task,
attempt), so a retried run sleeps the same every time.
"""

from __future__ import annotations

import hashlib
import time
from dataclasses import dataclass, replace
from typing import List, Optional

from .. import conf


class FetchFailedError(RuntimeError):
    """A reduce task could not read what a producing stage wrote: a
    block not registered, a missing or torn file, a frame that fails
    its checksum or its decode, or an injected fault (≙ Spark's
    FetchFailedException).  The cure is to regenerate the producer,
    then re-run the reader.  ``resource_id`` names the producer
    (``shuffle_<id>`` or ``broadcast_<id>``); ``map_ids``, when known,
    the map tasks whose outputs are bad, so that only they re-run
    (None: the whole stage)."""

    def __init__(self, resource_id: str, partition: int = -1, detail: str = "", injected: bool = False,
                 map_ids: Optional[List[int]] = None):
        self.resource_id = resource_id
        self.partition = partition
        self.injected = injected
        self.map_ids = sorted(set(map_ids)) if map_ids else None
        msg = f"fetch failed: {resource_id}"
        if partition >= 0:
            msg += f" partition {partition}"
        if self.map_ids:
            msg += f" map_ids {self.map_ids}"
        if injected:
            msg += " [injected]"
        super().__init__(msg + (f": {detail}" if detail else ""))

    def _producer(self, prefix: str) -> Optional[int]:
        if not self.resource_id.startswith(prefix):
            return None
        head = self.resource_id[len(prefix):].split(".")[0]
        return int(head) if head.isdigit() else None

    @property
    def shuffle_id(self) -> Optional[int]:
        """The producing shuffle's id, for a shuffle read."""
        return self._producer("shuffle_")

    @property
    def broadcast_id(self) -> Optional[int]:
        """The producing broadcast's id, for a broadcast blob read: a
        corrupt blob regenerates its broadcast stage."""
        return self._producer("broadcast_")


class TaskTimeoutError(Exception):
    """A task ran past ``spark.blaze.task.timeout`` seconds (checked
    between its output batches).  Retried."""


class TaskWedgedError(TaskTimeoutError):
    """A task's heartbeat grew older than ``spark.blaze.task.wedgeMs``:
    it made no progress inside a batch, where no deadline can see it.
    Retried as the timeout it is."""


class TaskRetriesExhausted(RuntimeError):
    """A task failed on every attempt it was allowed (or its producer
    could not be regenerated often enough): names the stage, the task
    (-1: a range boundary pass), the attempts and the last error, which
    is also its ``__cause__``."""

    def __init__(self, stage_id: int, task: int, attempts: int, last_error: BaseException):
        self.stage_id = stage_id
        self.task = task
        self.attempts = attempts
        self.last_error = last_error
        super().__init__(f"task {task} of stage {stage_id} failed after {attempts} attempt(s); "
                         f"last error: {type(last_error).__name__}: {last_error}")


RETRY = "retry"  # a fresh attempt of the task
FETCH_FAILED = "fetch"  # regenerate the producing stage first
FATAL = "fatal"  # propagate, no retry


def _dispositions() -> dict:
    """The classes the port has, by disposition (the reference's
    registry entries for them)."""
    from .context import QueryCancelledError, TaskCancelled
    from .faults import InjectedDiskFull, InjectedFault, InjectedOom
    from .hostpool import WorkerLostError, WorkerTaskError, WorkerTaskFatalError
    from .integrity import BlockCorruptionError

    return {
        FetchFailedError: FETCH_FAILED,
        TaskTimeoutError: RETRY, TaskWedgedError: RETRY, BlockCorruptionError: RETRY, InjectedFault: RETRY,
        InjectedOom: RETRY, InjectedDiskFull: RETRY, WorkerLostError: RETRY, WorkerTaskError: RETRY,
        TaskRetriesExhausted: FATAL, TaskCancelled: FATAL, QueryCancelledError: FATAL, WorkerTaskFatalError: FATAL,
    }


_TABLE: Optional[dict] = None


def classify(exc: BaseException) -> str:
    """What a failed attempt calls for.  The most derived class of
    ``exc`` in the port's table decides; past the table, the
    reference's rules: interpreter control flow and ``MemoryError``,
    ``AssertionError`` and ``NotImplementedError`` (an engine bug, an
    unported path, a zstd frame that needs a dictionary, fails alike every
    time) are fatal, the rest retried."""
    global _TABLE
    if _TABLE is None:
        _TABLE = _dispositions()
    for cls in type(exc).__mro__:
        if cls in _TABLE:
            return _TABLE[cls]
    if isinstance(exc, (KeyboardInterrupt, SystemExit, GeneratorExit, MemoryError, AssertionError,
                        NotImplementedError)):
        return FATAL
    return RETRY


@dataclass(frozen=True)
class RetryPolicy:
    """The attempt budget, the backoff and the cooperative timeout.

    ``max_attempts``: attempts a task (1: no retry).  ``backoff_base``:
    the first retry's delay in seconds, doubling each attempt, at most
    ``backoff_max``.  ``task_timeout``: seconds a task may run (0: no
    limit), checked between output batches.  ``max_stage_regens``:
    regenerations of a producer one task may ask for."""

    max_attempts: int = 4
    backoff_base: float = 0.1
    backoff_max: float = 5.0
    task_timeout: float = 0.0
    max_stage_regens: int = 4

    @classmethod
    def from_conf(cls) -> "RetryPolicy":
        return cls(max_attempts=max(1, int(conf.TASK_MAX_ATTEMPTS.get())),
                   backoff_base=float(conf.TASK_RETRY_BACKOFF.get()),
                   task_timeout=float(conf.TASK_TIMEOUT.get()),
                   max_stage_regens=max(1, int(conf.STAGE_MAX_ATTEMPTS.get())))

    def with_max_attempts(self, n: int) -> "RetryPolicy":
        return replace(self, max_attempts=max(1, int(n)))

    def backoff(self, stage_id: int, task: int, attempt: int) -> float:
        """Seconds before the next attempt after ``attempt`` (0-based)
        failed: exponential, with a jitter in [0.8, 1.2) keyed on
        (stage, task, attempt), the reference's to the bit."""
        if self.backoff_base <= 0:
            return 0.0
        raw = min(self.backoff_max, self.backoff_base * (2.0 ** attempt))
        h = hashlib.blake2b(f"{stage_id}:{task}:{attempt}".encode(), digest_size=8).digest()
        return raw * (0.8 + 0.4 * (int.from_bytes(h, "little") / 2**64))

    def sleep_before_retry(self, stage_id: int, task: int, attempt: int) -> None:
        d = self.backoff(stage_id, task, attempt)
        if d > 0:
            time.sleep(d)

    def deadline(self) -> Optional[float]:
        """The monotonic deadline of a task starting now, or None."""
        return time.monotonic() + self.task_timeout if self.task_timeout > 0 else None
