"""Shuffle exchange, in process (≙ the in-process path of
``blaze_tpu/parallel/exchange.py`` ``NativeShuffleExchangeExec``).

The first reduce partition to run materializes the exchange: every map
partition of the child runs (serially in this port), each batch's rows
are sorted by partition id on the device, all pid counts come to the
host in one copy, and each reduce partition's row ranges are sliced
out and concatenated into one device batch.  Output stays on the
device for the plan's lifetime, so a retried partition re-reads it.
The file shuffle of the reference is not ported yet.
"""

from __future__ import annotations

import threading
from typing import List, Optional

from .. import conf
from ..batch import RecordBatch, concat_batches
from ..ops.base import BatchStream, ExecNode
from ..runtime.context import TaskContext
from ..schema import Schema
from .shuffle import HashPartitioning, Partitioning, hash_pids, sort_by_pid, split_by_counts


class NativeShuffleExchangeExec(ExecNode):
    def __init__(self, child: ExecNode, partitioning: Partitioning):
        super().__init__([child])
        self.partitioning = partitioning
        self._lock = threading.Lock()
        self._outputs: Optional[List[List[RecordBatch]]] = None

    @property
    def schema(self) -> Schema:
        return self.children[0].schema

    def num_partitions(self) -> int:
        return self.partitioning.num_partitions

    def _materialize(self, caller: TaskContext) -> Optional[List[List[RecordBatch]]]:
        child = self.children[0]
        n_out = self.partitioning.num_partitions
        n_maps = child.num_partitions()
        is_hash = isinstance(self.partitioning, HashPartitioning) and n_out > 1
        pending = []
        for m in range(n_maps):
            for batch in child.execute(m, caller.child_context(m, n_maps)):
                if not caller.is_task_running():
                    return None  # a cancelled materialization is never kept
                if not is_hash:
                    pending.append(batch)
                    continue
                with self.metrics.timer("elapsed_compute"):
                    cols = [c.head(batch.num_rows) for c in batch.columns]
                    pids = hash_pids(self.schema, self.partitioning.exprs, cols,
                                     batch.num_rows, n_out)
                    pending.append(sort_by_pid(batch, pids, n_out))
        if not is_hash:
            # every row to partition 0, coalesced into one batch
            return [[concat_batches(pending)] if pending else []] + [[] for _ in range(n_out - 1)]
        with self.metrics.timer("elapsed_compute"):
            parts = split_by_counts(pending, n_out)
            return [[concat_batches(p)] if p else [] for p in parts]

    def execute(self, partition: int, ctx: TaskContext) -> BatchStream:
        if not bool(conf.EXCHANGE_IN_PROCESS.get()):
            raise NotImplementedError("the file shuffle is not ported; only the in-process exchange")

        def stream():
            with self._lock:
                if self._outputs is None:
                    self._outputs = self._materialize(ctx)
                outputs = self._outputs
            if outputs is None:
                return
            for b in outputs[partition]:
                self._record_batch(b)
                yield b

        return stream()
