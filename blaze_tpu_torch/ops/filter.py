"""Filter: predicate -> mask -> compact (≙ ``blaze_tpu/ops/filter.py``).

Survivors move to the front of a batch of the input's capacity; the
survivor count is the one scalar the host reads per batch."""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ..batch import Column, RecordBatch
from ..exprs.compile import lower
from ..exprs.ir import Expr
from ..runtime.context import TaskContext
from ..schema import Schema
from .base import BatchStream, ExecNode


def live_mask(cap: int, num_rows: int, device: torch.device) -> torch.Tensor:
    return torch.arange(cap, device=device) < num_rows


def compact_columns(cols: Sequence[Column], keep: torch.Tensor) -> Tuple[list, int]:
    """Rows where ``keep`` moved to the front, the rest padding."""
    idx = torch.nonzero(keep).squeeze(1)
    cap = keep.shape[0]
    return [c.take(idx, cap) for c in cols], int(idx.shape[0])


def eval_predicate(pred: Expr, batch: RecordBatch) -> torch.Tensor:
    """True where ``pred`` holds (null counts as false) on a live row."""
    env = {f.name: c for f, c in zip(batch.schema.fields, batch.columns)}
    p = lower(pred, batch.schema, env, batch.capacity)
    live = live_mask(batch.capacity, batch.num_rows, batch.device)
    return p.validity & p.data.to(torch.bool) & live


class FilterExec(ExecNode):
    def __init__(self, child: ExecNode, predicate: Expr):
        super().__init__([child])
        self.predicate = predicate

    @property
    def schema(self) -> Schema:
        return self.children[0].schema

    def execute(self, partition: int, ctx: TaskContext) -> BatchStream:
        child_stream = self.children[0].execute(partition, ctx)

        def stream():
            for batch in child_stream:
                with self.metrics.timer("elapsed_compute"):
                    cols, n = compact_columns(batch.columns, eval_predicate(self.predicate, batch))
                if n == 0:
                    continue
                out = RecordBatch(self.schema, cols, n)
                self._record_batch(out)
                yield out

        return stream()
