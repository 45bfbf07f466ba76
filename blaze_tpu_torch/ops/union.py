"""Union (≙ ``blaze_tpu/ops/union.py`` ``UnionExec``): the children's
streams, one after another.

Output partition ``p`` is partition ``p`` of every child that has one,
in child order; the union has as many partitions as its widest child.
The children share one schema (the first child's names)."""

from __future__ import annotations

from typing import Sequence

from ..runtime.context import TaskContext
from ..schema import Schema
from .base import BatchStream, ExecNode


class UnionExec(ExecNode):
    def __init__(self, children: Sequence[ExecNode]):
        super().__init__(children)

    @property
    def schema(self) -> Schema:
        return self.children[0].schema

    def num_partitions(self) -> int:
        return max(c.num_partitions() for c in self.children)

    def execute(self, partition: int, ctx: TaskContext) -> BatchStream:
        def stream():
            for child in self.children:
                if partition < child.num_partitions():
                    for b in child.execute(partition, ctx):
                        self._record_batch(b)
                        yield b

        return stream()
