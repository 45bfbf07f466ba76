"""Shuffle exchange (≙ ``blaze_tpu/parallel/exchange.py``
``NativeShuffleExchangeExec``).

The first reduce partition to run materializes the exchange: every map
partition of the child runs, ``parallel_map_tasks`` (default 4) at a
time (:func:`warm_then_map`: map task 0 first, alone), the results kept
in map order.

- In process (``spark.blaze.exchange.inProcess``, the default): each
  batch's rows are sorted by partition id on the device, all pid counts
  come to the host in one copy, and each reduce partition's row ranges
  are sliced out and concatenated into one device batch.  Round robin
  starts map task m at partition m; range partitioning first collects
  every map batch's key words and takes exact order statistics of all
  of them as its boundaries.  Output stays on the device for the plan's
  lifetime, so a retried partition re-reads it.
- Through files (the conf set false): each map task runs a
  ``ShuffleWriterExec`` into this exchange's ``LocalShuffleManager``
  (a temporary directory removed with the exchange), and each reduce
  partition reads its blocks back through an ``IpcReaderExec``; the
  manager's ``map_writer`` and ``reduce_registration`` are the steps
  the stage scheduler takes too.  A fetch failure before a reduce
  partition's first batch invalidates the map outputs and runs the map
  tasks again, once (≙ the reference's one local recovery tier); a
  later one raises to the task.

``shuffle_id`` is process-unique; ``runtime/scheduler.split_stages``
names the stage's shuffle files by it.
"""

from __future__ import annotations

import itertools
import threading
import weakref
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Optional, TypeVar

import torch

from .. import conf
from ..batch import RecordBatch, concat_batches
from ..ops.base import BatchStream, ExecNode
from ..ops.sort import range_key_words, words_order
from ..runtime.context import TaskContext
from ..runtime.retry import FetchFailedError
from ..schema import Schema
from .shuffle import (
    HashPartitioning, IpcReaderExec, LocalShuffleManager, Partitioning, RangePartitioning, RoundRobinPartitioning,
    hash_pids, range_pids, round_robin_pids, sort_by_pid, split_by_counts,
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
        # the file path: the manager, whether its map outputs stand, and
        # how often they were written (a recovery re-runs them once)
        self._manager: Optional[LocalShuffleManager] = None
        self._written = False
        self._generation = 0

    @property
    def schema(self) -> Schema:
        return self.children[0].schema

    def num_partitions(self) -> int:
        return self.partitioning.num_partitions

    def _materialize(self, caller: TaskContext) -> Optional[List[List[RecordBatch]]]:
        child = self.children[0]
        part = self.partitioning
        n_out = part.num_partitions
        n_maps = child.num_partitions()
        split = n_out > 1 and isinstance(part, (HashPartitioning, RoundRobinPartitioning))
        is_range = n_out > 1 and isinstance(part, RangePartitioning)

        def run_map(m: int) -> Optional[list]:
            """Map task ``m``'s batches (hashed or round robin: pid-sorted,
            with their counts; range: with their key words); None when
            cancelled."""
            local = []
            rr = m  # round robin: map task m starts at partition m, as in the reference
            for batch in child.execute(m, caller.child_context(m, n_maps)):
                if not caller.is_task_running():
                    return None
                if not (split or is_range):
                    local.append(batch)
                    continue
                with self.metrics.timer("elapsed_compute"):
                    cols = [c.head(batch.num_rows) for c in batch.columns]
                    if is_range:
                        local.append((batch, range_key_words(self.schema, part.fields, cols, batch.num_rows)))
                        continue
                    if isinstance(part, HashPartitioning):
                        pids = hash_pids(self.schema, part.exprs, cols, batch.num_rows, n_out)
                    else:
                        pids = round_robin_pids(batch.num_rows, rr, n_out, batch.device)
                        rr = (rr + batch.num_rows) % n_out
                    local.append(sort_by_pid(batch, pids, n_out))
            return local

        per_map = warm_then_map(run_map, n_maps, self.parallel_map_tasks)
        if any(local is None for local in per_map) or not caller.is_task_running():
            return None  # a cancelled materialization is never kept
        pending = [item for local in per_map for item in local]
        if not (split or is_range):
            # every row to partition 0, coalesced into one batch
            return [[concat_batches(pending)] if pending else []] + [[] for _ in range(n_out - 1)]
        with self.metrics.timer("elapsed_compute"):
            if is_range:
                pending = self._range_split(pending)
            parts = split_by_counts(pending, n_out)
            return [[concat_batches(p)] if p else [] for p in parts]

    def _range_split(self, keyed: list) -> list:
        """Range partitioning in process (≙ the reference's
        ``_materialize_range``): every map batch's key words sorted once,
        the boundaries the exact order statistics at ``(total * (i + 1))
        // n_out`` (a boundary row and every row equal to it go right),
        then each batch's pids by comparison with them, sorted by pid and
        counted as the hash path's."""
        n_out = self.partitioning.num_partitions
        total = sum(b.num_rows for b, _ in keyed)
        if not total:
            return []
        n_words = len(keyed[0][1])
        cat = [torch.cat([w[k] for _, w in keyed]) for k in range(n_words)]
        positions = torch.tensor([min(total - 1, (total * (i + 1)) // n_out) for i in range(n_out - 1)],
                                 device=cat[0].device)
        at = words_order(cat)[positions]
        bounds = [w[at] for w in cat]
        del cat
        return [sort_by_pid(b, range_pids(w, bounds), n_out) for b, w in keyed]

    def _write_map_outputs(self, caller: TaskContext) -> Optional[LocalShuffleManager]:
        """Every map task into the manager this exchange owns (made at the
        first call); None when cancelled."""
        if self._manager is None:
            self._manager = LocalShuffleManager()
            weakref.finalize(self, self._manager.cleanup)
        manager = self._manager
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
        for recovery in (False, True):
            with self._lock:
                if not self._written:
                    self._written = self._write_map_outputs(ctx) is not None
                written, generation = self._written, self._generation
            if not written:
                return
            reader = IpcReaderExec(self.schema, f"shuffle_{self.shuffle_id}", self.num_partitions(),
                                   self.device)
            reader.metrics = self.metrics
            yielded = False
            try:
                with self._manager.reduce_registration(ctx.resources, self.shuffle_id,
                                                       self.children[0].num_partitions(), partition):
                    for b in reader.execute(partition, ctx):
                        yielded = True
                        yield b
                return
            except FetchFailedError:
                if yielded or recovery:
                    raise
                with self._lock:
                    if self._generation == generation:  # no other partition re-ran them meanwhile
                        self._manager.invalidate(self.shuffle_id)
                        self._written = False
                        self._generation += 1

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
