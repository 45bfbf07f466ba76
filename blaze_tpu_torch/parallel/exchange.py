"""Shuffle exchange (≙ ``blaze_tpu/parallel/exchange.py``
``NativeShuffleExchangeExec``).

The first reduce partition to run materializes the exchange: every map
partition of the child runs, ``parallel_map_tasks`` (default 4) at a
time (:func:`warm_then_map`: map task 0 first, alone), the results kept
in map order.

- In process (``spark.blaze.exchange.inProcess``, the default): each
  batch's rows are sorted by partition id on the device, all pid counts
  come to the host in one copy, and each reduce partition's row ranges
  are sliced out and concatenated into one device batch.  Output stays
  on the device for the plan's lifetime, so a retried partition
  re-reads it.
- Through files (the conf set false): each map task runs a
  ``ShuffleWriterExec`` into this exchange's ``LocalShuffleManager``
  (a temporary directory removed with the exchange), and each reduce
  partition reads its blocks back through an ``IpcReaderExec``; the
  manager's ``map_writer`` and ``reduce_registration`` are the steps
  the stage scheduler takes too.

``shuffle_id`` is process-unique; ``runtime/scheduler.split_stages``
names the stage's shuffle files by it.
"""

from __future__ import annotations

import itertools
import threading
import weakref
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Optional, TypeVar

from .. import conf
from ..batch import RecordBatch, concat_batches
from ..ops.base import BatchStream, ExecNode
from ..runtime.context import TaskContext
from ..schema import Schema
from .shuffle import (
    HashPartitioning, IpcReaderExec, LocalShuffleManager, Partitioning, hash_pids, sort_by_pid,
    split_by_counts,
)

_shuffle_ids = itertools.count()

T = TypeVar("T")


def warm_then_map(fn: Callable[[int], T], n_tasks: int, max_workers: int) -> List[T]:
    """``[fn(0), ..., fn(n_tasks - 1)]``: task 0 runs alone on this
    thread first (it builds and loads the kernel library, and
    materializes any exchange or broadcast below, once), then the rest
    run ``max_workers`` at a time (≙ the reference's ``_warm_then_map``).
    The results keep task order; an error in any task raises here."""
    if max_workers <= 1 or n_tasks <= 1:
        return [fn(t) for t in range(n_tasks)]
    first = fn(0)
    with ThreadPoolExecutor(max_workers=max_workers, thread_name_prefix="map-task") as pool:
        return [first] + list(pool.map(fn, range(1, n_tasks)))


class NativeShuffleExchangeExec(ExecNode):
    def __init__(self, child: ExecNode, partitioning: Partitioning, parallel_map_tasks: int = 4):
        super().__init__([child])
        self.partitioning = partitioning
        self.parallel_map_tasks = parallel_map_tasks
        self.shuffle_id = next(_shuffle_ids)
        self._lock = threading.Lock()
        self._outputs: Optional[List[List[RecordBatch]]] = None
        self._manager: Optional[LocalShuffleManager] = None

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

        def run_map(m: int) -> Optional[list]:
            """Map task ``m``'s batches (hashed: pid-sorted, with their
            counts); None when cancelled."""
            local = []
            for batch in child.execute(m, caller.child_context(m, n_maps)):
                if not caller.is_task_running():
                    return None
                if not is_hash:
                    local.append(batch)
                    continue
                with self.metrics.timer("elapsed_compute"):
                    cols = [c.head(batch.num_rows) for c in batch.columns]
                    pids = hash_pids(self.schema, self.partitioning.exprs, cols,
                                     batch.num_rows, n_out)
                    local.append(sort_by_pid(batch, pids, n_out))
            return local

        per_map = warm_then_map(run_map, n_maps, self.parallel_map_tasks)
        if any(local is None for local in per_map) or not caller.is_task_running():
            return None  # a cancelled materialization is never kept
        pending = [item for local in per_map for item in local]
        if not is_hash:
            # every row to partition 0, coalesced into one batch
            return [[concat_batches(pending)] if pending else []] + [[] for _ in range(n_out - 1)]
        with self.metrics.timer("elapsed_compute"):
            parts = split_by_counts(pending, n_out)
            return [[concat_batches(p)] if p else [] for p in parts]

    def _write_map_outputs(self, caller: TaskContext) -> Optional[LocalShuffleManager]:
        """Every map task into a manager owned by this exchange; None
        when cancelled."""
        manager = LocalShuffleManager()
        weakref.finalize(self, manager.cleanup)
        child = self.children[0]
        n_maps = child.num_partitions()

        def run_map(m: int) -> None:
            writer = manager.map_writer(child, self.partitioning, self.shuffle_id, m)
            writer.metrics = self.metrics  # one metric set across the map tasks
            for _ in writer.execute(m, caller.child_context(m, n_maps)):
                pass

        warm_then_map(run_map, n_maps, self.parallel_map_tasks)
        return manager if caller.is_task_running() else None

    def _file_stream(self, partition: int, ctx: TaskContext) -> BatchStream:
        with self._lock:
            if self._manager is None:
                self._manager = self._write_map_outputs(ctx)
            manager = self._manager
        if manager is None:
            return
        reader = IpcReaderExec(self.schema, f"shuffle_{self.shuffle_id}", self.num_partitions(),
                               self.device)
        reader.metrics = self.metrics
        with manager.reduce_registration(ctx.resources, self.shuffle_id,
                                         self.children[0].num_partitions(), partition):
            yield from reader.execute(partition, ctx)

    def execute(self, partition: int, ctx: TaskContext) -> BatchStream:
        if not bool(conf.EXCHANGE_IN_PROCESS.get()):
            return self._file_stream(partition, ctx)

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
