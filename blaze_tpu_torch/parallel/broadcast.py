"""Broadcast exchange (≙ ``blaze_tpu/parallel/broadcast.py``).

In process (``plan.execute()``), :class:`BroadcastExchangeExec`
collects every child partition once into ONE device batch, which every
output partition replays.  Across stages (the scheduler),
:class:`IpcWriterExec` drains one child partition into a checksummed
IPC blob registered under ``<resource_id>.<partition>``, and the
consumer reads the blobs back through ``IpcReaderExec``.
"""

from __future__ import annotations

import struct
import threading
from typing import Iterable, List, Optional

from ..batch import RecordBatch, concat_batches
from ..io.batch_serde import serialize_batch
from ..io.ipc_compression import block_trailer, compress_frame
from ..ops.base import BatchStream, ExecNode
from ..runtime import integrity
from ..runtime.context import TaskContext
from ..schema import Schema


def collect_blob(batches: Iterable[RecordBatch]) -> bytes:
    """A batch stream as ONE blob: a frame per batch, checksummed with
    ``integrity.FRAME_ALGO``, closed by a block trailer, so a consumer
    detects a flipped byte and a missing whole frame."""
    algo = integrity.FRAME_ALGO
    frames: List[bytes] = []
    xor = 0
    for b in batches:
        frame = compress_frame(serialize_batch(b), checksum_algo=algo)
        xor ^= struct.unpack("<BI", frame[-5:])[1]
        frames.append(frame)
    frames.append(block_trailer(len(frames), xor, algo))
    return b"".join(frames)


class IpcWriterExec(ExecNode):
    """A broadcast stage's task: drains the child's partition into a
    blob registered under ``<resource_id>.<partition>``; the output
    stream is empty."""

    def __init__(self, child: ExecNode, resource_id: str):
        super().__init__([child])
        self.resource_id = resource_id

    @property
    def schema(self) -> Schema:
        return self.children[0].schema

    def execute(self, partition: int, ctx: TaskContext) -> BatchStream:
        def stream():
            blob = collect_blob(self.children[0].execute(partition, ctx))
            if not ctx.is_task_running():
                return  # a cancelled drain is partial: never published
            ctx.resources.put(f"{self.resource_id}.{partition}", blob)
            return
            yield  # an empty stream

        return stream()


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
