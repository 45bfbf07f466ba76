"""Task context and the process-wide resources map (≙
``blaze_tpu/runtime/context.py`` ``ResourcesMap``/``RESOURCES``,
``TaskCancelled`` and ``TaskContext``, without the memory manager and
``ScopedResources``, which no port caller needs: every attempt gets a
map of its own, and a pooled job reads its worker's), the query cancel
scope (``QueryCancelledError``, ``QueryDeadlineError``, ``CancelScope``,
``cancel_scope``, ``cancel_query``: the reference's, without the service
lease and the trace events), and the task heartbeat the wedge detector
reads (:func:`beating`, :func:`tick`)."""

from __future__ import annotations

import contextlib
import contextvars
import threading
import time
from typing import Any, Callable, Dict, Iterator, Optional, Set, Tuple


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


class QueryCancelledError(RuntimeError):
    """Terminal: the query was cancelled (:func:`cancel_query`).  Never
    retried: re-running a task the user killed would bring the query
    back one attempt at a time."""

    def __init__(self, query_id: str, reason: str = "cancel", stage_id: Optional[int] = None,
                 task: Optional[int] = None):
        self.query_id = query_id
        self.reason = reason
        self.stage_id = stage_id
        self.task = task
        at = ""
        if stage_id is not None:
            at = f" at stage {stage_id}" + (f" task {task}" if task is not None else "")
        super().__init__(f"query {query_id!r} cancelled ({reason}){at}")


class QueryDeadlineError(QueryCancelledError):
    """Terminal: the query ran past ``spark.blaze.query.timeoutMs``: a
    cancel the clock asked for, with the stage and task it had
    reached."""

    def __init__(self, query_id: str, timeout_ms: int, stage_id: Optional[int] = None,
                 task: Optional[int] = None):
        super().__init__(query_id, reason="deadline", stage_id=stage_id, task=task)
        self.timeout_ms = timeout_ms
        at = ""
        if stage_id is not None:
            at = f"; frontier: stage {stage_id}" + (f" task {task}" if task is not None else "")
        self.args = (f"query {query_id!r} exceeded its deadline ({timeout_ms}ms){at}",)


class CancelScope:
    """One query's cancellation and deadline.  :meth:`cancel` sets the
    scope's event (which serial attempts take as their cancel event)
    and every attached attempt's; every cooperative checkpoint calls
    :meth:`check`, which also enforces the deadline.  The first cancel
    wins: its reason is kept, and every later check raises the typed
    error for it."""

    def __init__(self, query_id: str, timeout_ms: int = 0):
        self.query_id = query_id
        self.timeout_ms = max(0, int(timeout_ms or 0))
        self.deadline: Optional[float] = time.monotonic() + self.timeout_ms / 1000.0 if self.timeout_ms else None
        self.event = threading.Event()
        self.reason: Optional[str] = None
        self.frontier: Tuple[Optional[int], Optional[int]] = (None, None)
        self._lock = threading.Lock()
        self._children: Set[threading.Event] = set()
        self._closed = False

    def cancel(self, reason: str = "cancel") -> bool:
        """Cancel the query: True on the first call of an open scope,
        False after (a closed scope, its query done, refuses)."""
        with self._lock:
            if self.reason is not None or self._closed:
                return False
            self.reason = reason
            kids = tuple(self._children)
        self.event.set()
        for ev in kids:
            ev.set()
        return True

    def close(self) -> bool:
        """Refuse any later cancel; True when one came before."""
        with self._lock:
            self._closed = True
            return self.reason is not None

    def attach(self, event: threading.Event) -> None:
        """Fan the scope's cancellation into ``event`` (a concurrent
        attempt's own); set at once when the scope is cancelled."""
        with self._lock:
            self._children.add(event)
            fired = self.reason is not None
        if fired:
            event.set()

    def detach(self, event: threading.Event) -> None:
        with self._lock:
            self._children.discard(event)

    @property
    def cancelled(self) -> bool:
        return self.event.is_set()

    def check(self, stage_id: Optional[int] = None, task: Optional[int] = None) -> None:
        """The checkpoint: cancel on an expired deadline, and raise the
        typed error once cancelled."""
        if self.reason is None and self.deadline is not None and time.monotonic() > self.deadline:
            self.cancel(reason="deadline")
        if self.event.is_set():
            self.raise_cancelled(stage_id, task)

    def raise_cancelled(self, stage_id: Optional[int] = None, task: Optional[int] = None) -> None:
        if self.frontier == (None, None) and stage_id is not None:
            self.frontier = (stage_id, task)
        fs, ft = self.frontier
        if (self.reason or "cancel") == "deadline":
            raise QueryDeadlineError(self.query_id, self.timeout_ms, stage_id=fs, task=ft)
        raise QueryCancelledError(self.query_id, reason=self.reason or "cancel", stage_id=fs, task=ft)


_scope_lock = threading.Lock()
_SCOPES: Dict[str, CancelScope] = {}
# the scope the checkpoints read: per context, so concurrent queries on
# other threads never see each other's
_CURRENT_SCOPE: contextvars.ContextVar = contextvars.ContextVar("blaze_torch_cancel_scope", default=None)


def current_cancel_scope() -> Optional[CancelScope]:
    return _CURRENT_SCOPE.get()


@contextlib.contextmanager
def cancel_scope(query_id: str, timeout_ms: Optional[int] = None) -> Iterator[CancelScope]:
    """Open one query's :class:`CancelScope`: registered under
    ``query_id`` for :func:`cancel_query` and installed as the scope the
    checkpoints read until the block ends.  ``timeout_ms`` defaults to
    ``spark.blaze.query.timeoutMs``."""
    from .. import conf

    if timeout_ms is None:
        timeout_ms = int(conf.QUERY_TIMEOUT_MS.get())
    scope = CancelScope(query_id, timeout_ms)
    with _scope_lock:
        _SCOPES[query_id] = scope
    token = _CURRENT_SCOPE.set(scope)
    try:
        yield scope
    finally:
        _CURRENT_SCOPE.reset(token)
        with _scope_lock:
            if _SCOPES.get(query_id) is scope:
                del _SCOPES[query_id]
        scope.close()


def cancel_query(query_id: str, reason: str = "cancel") -> bool:
    """Cancel a running query by id: True when a live scope took the
    request (again True for a repeat), False when no such query runs."""
    with _scope_lock:
        scope = _SCOPES.get(query_id)
    if scope is None:
        return False
    return scope.cancel(reason) or scope.cancelled


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
