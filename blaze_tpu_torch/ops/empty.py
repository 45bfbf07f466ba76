"""EmptyPartitions (≙ ``blaze_tpu/ops/empty.py``): ``num_partitions``
partitions of no rows."""

from __future__ import annotations

from typing import Union

import torch

from ..runtime.context import TaskContext
from ..schema import Schema
from .base import BatchStream, ExecNode


class EmptyPartitionsExec(ExecNode):
    def __init__(self, schema: Schema, num_partitions: int, device: Union[None, str, torch.device] = None):
        from .. import resolve_device

        super().__init__([])
        self._schema = schema
        self._num_partitions = num_partitions
        self._device = resolve_device(device)

    @property
    def schema(self) -> Schema:
        return self._schema

    @property
    def device(self) -> torch.device:
        return self._device

    def num_partitions(self) -> int:
        return self._num_partitions

    def execute(self, partition: int, ctx: TaskContext) -> BatchStream:
        return iter(())
