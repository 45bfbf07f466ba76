"""Filter: predicate -> mask -> compact (≙ ``blaze_tpu/ops/filter.py``).

Survivors move to the front of a batch of the input's capacity.  The
operator's own ``execute`` reads the survivor count back once per batch
(``torch.nonzero``); its traced form (:meth:`FilterExec.trace_fn`,
which fused chains compose) compacts with a prefix sum and keeps the
count on the device.  The optimizer may fuse a following projection
into the filter (``project``): the predicate and the projection are
evaluated over the raw batch and only the projected columns are
compacted."""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import torch

from ..batch import Column, RecordBatch
from ..exprs.compile import infer_dtype, lower, needs_host
from ..exprs.ir import Expr
from ..runtime.context import TaskContext
from ..schema import Field, Schema
from .base import BatchStream, ExecNode

RowCount = Union[int, torch.Tensor]


def live_mask(cap: int, num_rows: RowCount, device: torch.device) -> torch.Tensor:
    return torch.arange(cap, device=device) < num_rows


def compact_columns(cols: Sequence[Column], keep: torch.Tensor) -> Tuple[list, int]:
    """Rows where ``keep`` moved to the front, the rest padding."""
    idx = torch.nonzero(keep).squeeze(1)
    cap = keep.shape[0]
    return [c.take(idx, cap) for c in cols], int(idx.shape[0])


def compact_columns_traced(cols: Sequence[Column], keep: torch.Tensor) -> Tuple[list, torch.Tensor]:
    """:func:`compact_columns` without a host read: each kept row's
    place is the prefix sum of ``keep`` before it, the rows are
    scattered there in a batch of the input's capacity, and the count
    stays a 0-d int64 tensor (≙ the reference's ``nonzero(size=cap)``)."""
    from .project import mask_padding

    cap = keep.shape[0]
    dev = keep.device
    pos = torch.cumsum(keep, 0) - 1
    # a dropped row writes to the spare slot ``cap``, cut off below
    src = torch.zeros(cap + 1, dtype=torch.int64, device=dev)
    src.scatter_(0, torch.where(keep, pos, cap), torch.arange(cap, device=dev))
    idx = src[:cap]
    count = keep.sum()
    live = live_mask(cap, count, dev)
    return [mask_padding(c.take(idx), live) for c in cols], count


def predicate_mask(pred: Expr, schema: Schema, env, cap: int, num_rows: RowCount,
                   device: torch.device) -> torch.Tensor:
    """True where ``pred`` holds (null counts as false) on a live row:
    the live mask matters, since IS NULL is true on padding."""
    p = lower(pred, schema, env, cap)
    return p.validity & p.data.to(torch.bool) & live_mask(cap, num_rows, device)


class FilterExec(ExecNode):
    """Filter, optionally fused with the projection that followed it
    (``project=(exprs, names)``)."""

    def __init__(self, child: ExecNode, predicate: Expr,
                 project: Optional[Tuple[List[Expr], List[str]]] = None):
        super().__init__([child])
        self.predicate = predicate
        self.project = None if project is None else (list(project[0]), list(project[1]))
        in_schema = child.schema
        if self.project is None:
            self._schema = in_schema
        else:
            self._schema = Schema([Field(n, infer_dtype(e, in_schema)) for e, n in zip(*self.project)])
        exprs = [predicate] + ([] if self.project is None else self.project[0])
        #: a host LIKE somewhere: the filter cannot join a fused chain
        self.host = any(needs_host(e) for e in exprs)

    @property
    def schema(self) -> Schema:
        return self._schema

    def _keep_and_outputs(self, cols: Sequence[Column], num_rows: RowCount):
        """The keep mask and the columns to compact (the input's, or
        the projection's over the raw batch)."""
        in_schema = self.children[0].schema
        cap = cols[0].capacity
        env = {f.name: c for f, c in zip(in_schema.fields, cols)}
        keep = predicate_mask(self.predicate, in_schema, env, cap, num_rows, cols[0].device)
        if self.project is None:
            return keep, list(cols)
        return keep, [lower(e, in_schema, env, cap) for e in self.project[0]]

    # ---------------------------------------------- tracing contract

    def trace_fn(self):
        if self.host:
            return None

        def fn(cols, num_rows):
            keep, out = self._keep_and_outputs(cols, num_rows)
            return compact_columns_traced(out, keep)

        return fn

    def trace_key(self):
        if self.host:
            return None
        proj = None if self.project is None else (tuple(repr(e) for e in self.project[0]),
                                                  tuple(self.project[1]))
        return ("filter", repr(self.children[0].schema), repr(self.predicate), proj)

    @property
    def trace_changes_count(self) -> bool:
        return True

    @property
    def preserves_ordering(self) -> bool:
        return True  # compaction keeps the rows' relative order

    def execute(self, partition: int, ctx: TaskContext) -> BatchStream:
        child_stream = self.children[0].execute(partition, ctx)

        def stream():
            for batch in child_stream:
                with self.metrics.timer("elapsed_compute"):
                    keep, out = self._keep_and_outputs(batch.columns, batch.num_rows)
                    cols, n = compact_columns(out, keep)
                if n == 0:
                    continue
                out = RecordBatch(self.schema, cols, n)
                self._record_batch(out)
                yield out

        return stream()
