"""In-memory table source (≙ ``blaze_tpu/ops/memory_scan.py``)."""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import torch

from ..batch import RecordBatch
from ..runtime.context import TaskContext
from ..schema import Schema
from .base import BatchStream, ExecNode


class MemoryScanExec(ExecNode):
    """Yields the given per-partition batches, staged onto ``device``
    (the package default, the card, when None)."""

    def __init__(
        self,
        partitions: Sequence[Sequence[RecordBatch]],
        schema: Optional[Schema] = None,
        device: Union[None, str, torch.device] = None,
    ):
        from .. import resolve_device

        super().__init__([])
        self._partitions: List[List[RecordBatch]] = [list(p) for p in partitions]
        if schema is None:
            first = next((b for p in self._partitions for b in p), None)
            if first is None:
                raise ValueError("schema required for an empty MemoryScanExec")
            schema = first.schema
        self._schema = schema
        self._device = resolve_device(device)

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def schema(self) -> Schema:
        return self._schema

    def num_partitions(self) -> int:
        return max(1, len(self._partitions))

    def execute(self, partition: int, ctx: TaskContext) -> BatchStream:
        def stream():
            if partition < len(self._partitions):
                for b in self._partitions[partition]:
                    with self.metrics.timer("input_io_time"):
                        out = b.to(self._device)
                    self._record_batch(out)
                    yield out

        return stream()
