"""ExecNode: the operator interface (≙ ``blaze_tpu/ops/base.py``).

``execute(partition, ctx)`` returns a python iterator of RecordBatches;
operators issue torch ops on the device their input batches live on.
"""

from __future__ import annotations

from typing import Iterator, List, Sequence

import torch

from ..batch import RecordBatch
from ..runtime.context import TaskContext
from ..runtime.metrics import MetricsSet
from ..schema import Schema

BatchStream = Iterator[RecordBatch]


class ExecNode:
    """Base physical operator."""

    def __init__(self, children: Sequence["ExecNode"]):
        self.children: List[ExecNode] = list(children)
        self.metrics = MetricsSet()

    @property
    def schema(self) -> Schema:
        raise NotImplementedError

    def execute(self, partition: int, ctx: TaskContext) -> BatchStream:
        raise NotImplementedError

    @property
    def device(self) -> torch.device:
        """The device this node's output lives on (its scans')."""
        return self.children[0].device

    def num_partitions(self) -> int:
        """Output partitioning degree (the first child's by default)."""
        if self.children:
            return self.children[0].num_partitions()
        return 1

    def _record_batch(self, b: RecordBatch) -> None:
        self.metrics.add("output_rows", b.num_rows)
        self.metrics.add("output_batches")
