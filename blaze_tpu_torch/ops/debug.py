"""Debug pass-through (≙ ``blaze_tpu/ops/debug.py``): logs each batch's
row count, and with ``verbose`` its rows, at a tagged point of a plan."""

from __future__ import annotations

import logging

from ..batch import batch_to_pydict
from ..runtime.context import TaskContext
from ..schema import Schema
from .base import BatchStream, ExecNode

log = logging.getLogger("blaze_tpu_torch.debug")


class DebugExec(ExecNode):
    def __init__(self, child: ExecNode, tag: str = "", verbose: bool = False):
        super().__init__([child])
        self.tag = tag
        self.verbose = verbose

    @property
    def schema(self) -> Schema:
        return self.children[0].schema

    def execute(self, partition: int, ctx: TaskContext) -> BatchStream:
        child_stream = self.children[0].execute(partition, ctx)

        def stream():
            for i, b in enumerate(child_stream):
                log.info("[%s] partition=%d batch=%d rows=%d", self.tag, partition, i, b.num_rows)
                if self.verbose:
                    log.info("%s", batch_to_pydict(b))
                yield b

        return stream()
