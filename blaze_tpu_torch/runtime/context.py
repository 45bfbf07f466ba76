"""Task context and the process-wide resources map (≙
``blaze_tpu/runtime/context.py`` ``ResourcesMap``/``RESOURCES`` and
``TaskContext``, without the memory manager for now)."""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional


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

    def is_task_running(self) -> bool:
        return not self._cancelled.is_set()

    def cancel(self) -> None:
        self._cancelled.set()
