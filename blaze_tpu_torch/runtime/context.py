"""Task context (≙ ``blaze_tpu/runtime/context.py`` ``TaskContext``,
without the memory manager for now)."""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional


class TaskContext:
    """One executing task = one partition of one stage."""

    def __init__(
        self,
        partition: int,
        num_partitions: int = 1,
        resources: Optional[Dict[str, Any]] = None,
        cancel_event: Optional[threading.Event] = None,
    ):
        self.partition = partition
        self.num_partitions = num_partitions
        # named objects shared between operators of one run
        self.resources: Dict[str, Any] = {} if resources is None else resources
        self._cancelled = cancel_event or threading.Event()

    def child_context(self, partition: int, num_partitions: int = 1) -> "TaskContext":
        """A context for driving a child subtree inside this task: it
        shares this task's resources and cancellation."""
        return TaskContext(partition, num_partitions, self.resources, self._cancelled)

    def is_task_running(self) -> bool:
        return not self._cancelled.is_set()

    def cancel(self) -> None:
        self._cancelled.set()
