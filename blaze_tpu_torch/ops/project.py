"""Projection (≙ ``blaze_tpu/ops/project.py``).

A projection of bare columns is a host-side pick of the batch's
columns (``_select_names``): no device work, the free select that
column pruning plants."""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from ..batch import Column, RecordBatch
from ..exprs.compile import infer_dtype, lower, needs_host
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
    return c.mask_rows(live)


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
        picked: Optional[List[str]] = []
        for e in self.exprs:
            inner = e.child if isinstance(e, Alias) else e
            if not isinstance(inner, Col):
                picked = None
                break
            picked.append(inner.name)
        self._select_names = picked
        self._select_idx = None if picked is None else [in_schema.index(n) for n in picked]
        #: a host LIKE somewhere: the projection cannot join a fused chain
        self.host = any(needs_host(e) for e in self.exprs)

    @property
    def schema(self) -> Schema:
        return self._schema

    def _project_cols(self, cols: Sequence[Column], num_rows) -> List[Column]:
        if self._select_idx is not None:
            return [cols[i] for i in self._select_idx]
        in_schema = self.children[0].schema
        cap = cols[0].capacity
        env = {f.name: c for f, c in zip(in_schema.fields, cols)}
        live = live_mask(cap, num_rows, cols[0].device)
        return [mask_padding(lower(e, in_schema, env, cap), live) for e in self.exprs]

    def project_batch(self, batch: RecordBatch) -> RecordBatch:
        return RecordBatch(self._schema, self._project_cols(batch.columns, batch.num_rows),
                           batch.num_rows)

    # ---------------------------------------------- tracing contract

    def trace_fn(self):
        if self.host:
            return None
        return lambda cols, num_rows: (self._project_cols(cols, num_rows), num_rows)

    def trace_key(self):
        if self.host:
            return None
        if self._select_names is not None:
            return ("select", repr(self.children[0].schema), tuple(self._select_idx))
        return ("project", repr(self.children[0].schema), tuple(repr(e) for e in self.exprs))

    @property
    def has_kernel(self) -> bool:
        return self._select_names is None

    @property
    def preserves_ordering(self) -> bool:
        return True

    def execute(self, partition: int, ctx: TaskContext) -> BatchStream:
        child_stream = self.children[0].execute(partition, ctx)

        def stream():
            for batch in child_stream:
                with self.metrics.timer("elapsed_compute"):
                    out = self.project_batch(batch)
                self._record_batch(out)
                yield out

        return stream()
