"""Task context and the process-wide resources map (≙
``blaze_tpu/runtime/context.py`` ``ResourcesMap``/``RESOURCES``,
``TaskCancelled`` and ``TaskContext``, without the memory manager, the
service layer's ``CancelScope`` and ``ScopedResources``, which no port
caller needs: every attempt gets a map of its own), and
the task heartbeat the wedge detector reads (:func:`beating`,
:func:`tick`)."""

from __future__ import annotations

import contextvars
import threading
from typing import Any, Callable, Dict, Optional


class ResourcesMap:
    """Process-wide rendezvous for what a serialized plan names by id:
    the partitions a memory scan reads, the shuffle blocks a reduce
    task reads, the blobs a broadcast stage writes.  ``get`` pops, so a
    registration is consumed once."""

    def __init__(self):
        self._lock = threading.Lock()
        self._map: Dict[str, Any] = {}

    def put(self, key: str, value: Any) -> None:
        with self._lock:
            self._map[key] = value

    def get(self, key: str) -> Any:
        with self._lock:
            if key not in self._map:
                raise KeyError(f"resource {key!r} not found")
            return self._map.pop(key)

    def discard(self, key: str) -> None:
        """Drop a registration if it is still there."""
        with self._lock:
            self._map.pop(key, None)

    def __len__(self) -> int:
        with self._lock:
            return len(self._map)

    def keys(self):
        with self._lock:
            return list(self._map)


RESOURCES = ResourcesMap()


class TaskCancelled(Exception):
    """Raised where a cancelled task may not stop quietly, because what
    it leaves would be kept half done.  Never retried."""


class TaskContext:
    """One executing task = one partition of one stage."""

    def __init__(
        self,
        partition: int,
        num_partitions: int = 1,
        resources: Optional[ResourcesMap] = None,
        cancel_event: Optional[threading.Event] = None,
        stage_id: int = 0,
        task_attempt_id: int = 0,
    ):
        self.partition = partition
        self.num_partitions = num_partitions
        self.stage_id = stage_id
        self.task_attempt_id = task_attempt_id
        # the process-wide map unless a caller passes its own
        self.resources = RESOURCES if resources is None else resources
        self._cancelled = cancel_event or threading.Event()

    def child_context(self, partition: int, num_partitions: int = 1) -> "TaskContext":
        """A context for driving a child subtree inside this task: it
        shares this task's resources, cancellation, stage and attempt."""
        return TaskContext(partition, num_partitions, self.resources, self._cancelled,
                           self.stage_id, self.task_attempt_id)

    @property
    def cancel_event(self) -> threading.Event:
        return self._cancelled

    def is_task_running(self) -> bool:
        return not self._cancelled.is_set()

    def cancel(self) -> None:
        self._cancelled.set()


_BEAT: contextvars.ContextVar = contextvars.ContextVar("task_beat", default=None)


def tick() -> None:
    """Progress on this thread: beats the task being driven here.  Every
    operator's output batch ticks (``ExecNode._record_batch``)."""
    on_beat = _BEAT.get()
    if on_beat is not None:
        on_beat()


def beating(stream, on_beat: Callable[[], None]):
    """``stream`` with ``on_beat`` armed while each of its steps runs on
    the consumer's thread (never across a yield): the clock of the
    wedge detector, which a map task that yields nothing still moves.
    A beat is one timestamp store, so it fires at every tick, with no
    period of its own to throttle it."""
    it = iter(stream)
    try:
        while True:
            token = _BEAT.set(on_beat)
            try:
                tick()
                b = next(it)
            except StopIteration:
                return
            finally:
                _BEAT.reset(token)
            yield b
    finally:
        if hasattr(it, "close"):
            it.close()
