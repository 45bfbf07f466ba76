"""RenameColumns (≙ ``blaze_tpu/ops/rename.py`` ``RenameColumnsExec``): the
child's columns under new names, rows and their order untouched.  The
EXISTS plans of TPC-DS q10, q35 and q69 rename each EXISTENCE join's
``exists#0`` flag, so the next join's flag does not clash with it."""

from __future__ import annotations

from typing import Sequence

from ..batch import RecordBatch
from ..runtime.context import TaskContext
from ..schema import Field, Schema
from .base import BatchStream, ExecNode


class RenameColumnsExec(ExecNode):
    def __init__(self, child: ExecNode, names: Sequence[str]):
        super().__init__([child])
        if len(names) != len(child.schema.fields):
            raise ValueError(f"{len(names)} names for {len(child.schema.fields)} columns")
        self._schema = Schema([Field(n, f.dtype, f.nullable) for n, f in zip(names, child.schema.fields)])

    @property
    def schema(self) -> Schema:
        return self._schema

    @property
    def preserves_ordering(self) -> bool:
        return True

    def execute(self, partition: int, ctx: TaskContext) -> BatchStream:
        child_stream = self.children[0].execute(partition, ctx)

        def stream():
            for b in child_stream:
                out = RecordBatch(self._schema, b.columns, b.num_rows)
                self._record_batch(out)
                yield out

        return stream()
