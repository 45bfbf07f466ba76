"""Expand: each input row becomes one output row per projection list,
for ROLLUP, CUBE and GROUPING SETS (≙ ``blaze_tpu/ops/expand.py``).

``execute`` passes once over the child and emits, per input batch, one
batch per projection (a rollup above a join or an exchange must not
run its child again).  The traced form (:meth:`ExpandExec.trace_fn`)
projects a batch P ways and packs the P results' live rows into one
batch of P x n rows: the same multiset of rows, which an aggregation
above does not tell apart."""

from __future__ import annotations

from typing import List, Sequence

import torch

from ..batch import Column, bucket_capacity, concat_columns
from ..exprs.ir import Expr
from ..runtime.context import TaskContext
from ..schema import Schema
from .base import BatchStream, ExecNode
from .filter import live_mask
from .project import ProjectExec, mask_padding


def _stack_rows(parts: Sequence[Column], src_part: torch.Tensor, src_row: torch.Tensor,
                live: torch.Tensor) -> Column:
    """Row ``i`` of the result is row ``src_row[i]`` of part
    ``src_part[i]``; rows where ``live`` is false are padding."""
    cap = parts[0].capacity
    stacked = concat_columns(parts, cap * len(parts))
    return mask_padding(stacked.take(src_part * cap + src_row), live)


class ExpandExec(ExecNode):
    def __init__(self, child: ExecNode, projections: Sequence[Sequence[Expr]], names: Sequence[str]):
        super().__init__([child])
        self._projects: List[ProjectExec] = [ProjectExec(child, list(p), list(names)) for p in projections]
        self._schema = self._projects[0].schema
        for p in self._projects[1:]:
            if [f.dtype for f in p.schema.fields] != [f.dtype for f in self._schema.fields]:
                raise ValueError("expand projections must agree on types")

    @property
    def schema(self) -> Schema:
        return self._schema

    @property
    def projections(self) -> List[List[Expr]]:
        return [p.exprs for p in self._projects]

    # ---------------------------------------------- tracing contract

    def trace_fn(self):
        """All projections at once: the P projected batches' live rows
        packed in projection order, ``n`` rows in, ``P * n`` out, in a
        batch of capacity ``bucket_capacity(P * cap)``.  None when a
        projection needs the host."""
        fns = [p.trace_fn() for p in self._projects]
        if any(fn is None for fn in fns):
            return None
        n_proj = len(fns)

        def fn(cols, num_rows):
            outs = [f(cols, num_rows)[0] for f in fns]
            cap = cols[0].capacity
            out_cap = bucket_capacity(n_proj * cap)
            dev = cols[0].device
            t = torch.arange(out_cap, device=dev)
            # num_rows may be a 0-d tensor: no host read
            n = torch.as_tensor(num_rows, device=dev).clamp(min=1)
            src_part = torch.clamp(t // n, max=n_proj - 1)
            src_row = torch.clamp(t - src_part * n, max=cap - 1)
            total = num_rows * n_proj
            live = live_mask(out_cap, total, dev)
            out = [_stack_rows([o[j] for o in outs], src_part, src_row, live)
                   for j in range(len(self._schema.fields))]
            return out, total

        return fn

    def trace_key(self):
        keys = tuple(p.trace_key() for p in self._projects)
        return None if any(k is None for k in keys) else ("expand", keys)

    @property
    def trace_changes_count(self) -> bool:
        return True  # n rows -> P * n rows

    def execute(self, partition: int, ctx: TaskContext) -> BatchStream:
        def stream():
            for b in self.children[0].execute(partition, ctx):
                for proj in self._projects:
                    out = proj.project_batch(b)
                    self._record_batch(out)
                    yield out

        return stream()
