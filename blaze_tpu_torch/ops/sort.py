"""In-memory sort with an optional ``fetch`` (≙ ``blaze_tpu/ops/sort.py``,
without the external spill path).

Sort keys encode into order-preserving int64 words (:func:`order_words`)
compared as signed integers: a null-rank word honouring nulls
first/last, then the value words (ints as they are, floats through the
sign-magnitude bit trick, strings as big-endian byte words), inverted
for descending keys.  Rows sort stably by the words, last word first.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import torch

from ..batch import Column, RecordBatch, concat_batches
from ..exprs.compile import lower
from ..exprs.ir import Expr
from ..exprs.strings import packed_be
from ..runtime.context import TaskContext
from ..schema import Schema
from .agg import lexsort
from .base import BatchStream, ExecNode


@dataclass
class SortField:
    expr: Expr
    ascending: bool = True
    nulls_first: bool = True


def order_words(c: Column, ascending: bool, nulls_first: bool) -> List[torch.Tensor]:
    """Order-preserving int64 words (signed order) for one key column."""
    valid = c.validity.to(torch.int64)
    words = [valid if nulls_first else 1 - valid]
    if c.dtype.is_string:
        vals = list(packed_be(c.data).unbind(1))
    elif c.dtype.is_float:
        bits = (c.data.view(torch.int32) if c.data.dtype == torch.float32
                else c.data.view(torch.int64)).to(torch.int64)
        # negative floats: flip the magnitude bits so larger magnitudes
        # order lower
        vals = [bits ^ ((bits >> 63) & 0x7FFFFFFFFFFFFFFF)]
    else:
        vals = [c.data.to(torch.int64)]
    if not ascending:
        vals = [~v for v in vals]
    # null rows: neutral value words so they cluster deterministically
    words.extend(torch.where(c.validity, v, 0) for v in vals)
    return words


def sort_batch(batch: RecordBatch, fields: Sequence[SortField], fetch: Optional[int] = None) -> RecordBatch:
    """The batch's live rows stably sorted by ``fields``, cut to
    ``fetch`` rows when given."""
    n = batch.num_rows
    cols = [c.head(n) for c in batch.columns]
    env = {f.name: c for f, c in zip(batch.schema.fields, cols)}
    words: List[torch.Tensor] = []
    for f in fields:
        words.extend(order_words(lower(f.expr, batch.schema, env, n), f.ascending, f.nulls_first))
    order = lexsort(words)
    if fetch is not None:
        order = order[:fetch]
    return RecordBatch(batch.schema, cols, n).take(order)


class SortExec(ExecNode):
    def __init__(self, child: ExecNode, fields: Sequence[SortField], fetch: Optional[int] = None):
        super().__init__([child])
        self.fields = list(fields)
        self.fetch = fetch

    @property
    def schema(self) -> Schema:
        return self.children[0].schema

    def execute(self, partition: int, ctx: TaskContext) -> BatchStream:
        child_stream = self.children[0].execute(partition, ctx)

        def stream():
            buffered: List[RecordBatch] = []
            for batch in child_stream:
                if not ctx.is_task_running():
                    return
                if self.fetch is not None and batch.num_rows > self.fetch:
                    batch = sort_batch(batch, self.fields, self.fetch)
                buffered.append(batch)
            if not buffered:
                return
            with self.metrics.timer("sort_time"):
                out = sort_batch(concat_batches(buffered), self.fields, self.fetch)
            self._record_batch(out)
            yield out

        return stream()
