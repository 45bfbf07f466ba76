"""CoalesceBatches: small batches merged up to ``target_rows`` (≙
``blaze_tpu/ops/coalesce.py``), so the operators above launch fewer,
larger device programs."""

from __future__ import annotations

from typing import List

from .. import conf
from ..batch import RecordBatch, concat_batches
from ..runtime.context import TaskContext
from ..schema import Schema
from .base import BatchStream, ExecNode


class CoalesceBatchesExec(ExecNode):
    """A batch of ``target_rows`` or more passes as it is; smaller ones
    are held until they reach ``target_rows`` together, then merged
    (``batch.concat_batches``) in order."""

    def __init__(self, child: ExecNode, target_rows: int = 0):
        super().__init__([child])
        self.target_rows = target_rows or int(conf.BATCH_SIZE.get())

    @property
    def schema(self) -> Schema:
        return self.children[0].schema

    def execute(self, partition: int, ctx: TaskContext) -> BatchStream:
        child_stream = self.children[0].execute(partition, ctx)

        def stream():
            buf: List[RecordBatch] = []
            buffered = 0
            for b in child_stream:
                if b.num_rows >= self.target_rows and not buf:
                    self._record_batch(b)
                    yield b
                    continue
                buf.append(b)
                buffered += b.num_rows
                if buffered >= self.target_rows:
                    out = concat_batches(buf)
                    buf, buffered = [], 0
                    self._record_batch(out)
                    yield out
            if buf:
                out = concat_batches(buf)
                self._record_batch(out)
                yield out

        return stream()
