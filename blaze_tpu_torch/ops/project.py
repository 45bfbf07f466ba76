"""Projection (≙ ``blaze_tpu/ops/project.py``)."""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from ..batch import Column, RecordBatch
from ..exprs.compile import infer_dtype, lower
from ..exprs.ir import Alias, Col, Expr
from ..runtime.context import TaskContext
from ..schema import Field, Schema
from .base import BatchStream, ExecNode
from .filter import live_mask


def _expr_name(e: Expr, i: int) -> str:
    if isinstance(e, (Alias, Col)):
        return e.name
    return f"#{i}"


def mask_padding(c: Column, live: torch.Tensor) -> Column:
    """Enforce the padding invariant: invalid, zeroed rows past the
    live prefix (computed columns such as literals are valid there)."""
    zero = torch.zeros((), dtype=c.data.dtype, device=c.data.device)
    data = torch.where(live.view((-1,) + (1,) * (c.data.dim() - 1)), c.data, zero)
    lengths = None if c.lengths is None else torch.where(live, c.lengths, 0)
    return Column(c.dtype, data, c.validity & live, lengths)


class ProjectExec(ExecNode):
    def __init__(self, child: ExecNode, exprs: Sequence[Expr], names: Optional[Sequence[str]] = None):
        super().__init__([child])
        self.exprs = list(exprs)
        in_schema = child.schema
        self.names = list(names) if names else [_expr_name(e, i) for i, e in enumerate(self.exprs)]
        self._schema = Schema(
            [Field(n, infer_dtype(e, in_schema)) for n, e in zip(self.names, self.exprs)]
        )
        # pure column selection is a host-side pick of columns
        picked: Optional[List[int]] = []
        for e in self.exprs:
            inner = e.child if isinstance(e, Alias) else e
            if not isinstance(inner, Col):
                picked = None
                break
            picked.append(in_schema.index(inner.name))
        self._select_idx = picked

    @property
    def schema(self) -> Schema:
        return self._schema

    def project_batch(self, batch: RecordBatch) -> RecordBatch:
        if self._select_idx is not None:
            cols = [batch.columns[i] for i in self._select_idx]
            return RecordBatch(self._schema, cols, batch.num_rows)
        env = {f.name: c for f, c in zip(batch.schema.fields, batch.columns)}
        live = live_mask(batch.capacity, batch.num_rows, batch.device)
        cols = [
            mask_padding(lower(e, batch.schema, env, batch.capacity), live)
            for e in self.exprs
        ]
        return RecordBatch(self._schema, cols, batch.num_rows)

    def execute(self, partition: int, ctx: TaskContext) -> BatchStream:
        child_stream = self.children[0].execute(partition, ctx)

        def stream():
            for batch in child_stream:
                with self.metrics.timer("elapsed_compute"):
                    out = self.project_batch(batch)
                self._record_batch(out)
                yield out

        return stream()
