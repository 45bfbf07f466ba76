"""Limit (≙ ``blaze_tpu/ops/limit.py``): the first ``limit`` rows of
the partition; rows cut from a batch become padding."""

from __future__ import annotations

from ..batch import RecordBatch
from ..runtime.context import TaskContext
from ..schema import Schema
from .base import BatchStream, ExecNode


def truncate(batch: RecordBatch, n: int) -> RecordBatch:
    """The first ``n <= num_rows`` rows; the rows cut off become
    padding (invalid, zeroed)."""
    if n >= batch.num_rows:
        return batch
    return RecordBatch(batch.schema, [c.head(n).pad(c.capacity) for c in batch.columns], n)


class LimitExec(ExecNode):
    def __init__(self, child: ExecNode, limit: int):
        super().__init__([child])
        self.limit = limit

    @property
    def schema(self) -> Schema:
        return self.children[0].schema

    def execute(self, partition: int, ctx: TaskContext) -> BatchStream:
        child_stream = self.children[0].execute(partition, ctx)

        def stream():
            remaining = self.limit
            for batch in child_stream:
                if remaining <= 0:
                    return
                out = truncate(batch, remaining)
                remaining -= out.num_rows
                self._record_batch(out)
                yield out

        return stream()
