"""Broadcast exchange (≙ ``blaze_tpu/parallel/broadcast.py``
``BroadcastExchangeExec``).

Collects every child partition once into ONE device batch, which every
output partition replays.  The reference ships the collected rows as
checksummed IPC bytes; this port keeps the device batch in process (the
wire format is not ported yet).
"""

from __future__ import annotations

import threading
from typing import Optional

from ..batch import RecordBatch, concat_batches
from ..ops.base import BatchStream, ExecNode
from ..runtime.context import TaskContext
from ..schema import Schema


class BroadcastExchangeExec(ExecNode):
    def __init__(self, child: ExecNode):
        super().__init__([child])
        self._lock = threading.Lock()
        self._collected: Optional[RecordBatch] = None
        self._done = False

    @property
    def schema(self) -> Schema:
        return self.children[0].schema

    def num_partitions(self) -> int:
        return 1

    def collect(self, ctx: TaskContext) -> Optional[RecordBatch]:
        """All child rows as one batch (None when there are none)."""
        with self._lock:
            if not self._done:
                child = self.children[0]
                n = child.num_partitions()
                batches = [b for p in range(n) for b in child.execute(p, ctx.child_context(p, n))]
                if not ctx.is_task_running():
                    return None  # a partial collect is never kept
                self._collected = concat_batches(batches) if batches else None
                self._done = True
            return self._collected

    def execute(self, partition: int, ctx: TaskContext) -> BatchStream:
        def stream():
            b = self.collect(ctx)
            if b is not None:
                self._record_batch(b)
                yield b

        return stream()
