"""Stage scheduler: split a plan at its exchanges and run it as stages
of tasks, every task from its TaskDefinition bytes (≙
``blaze_tpu/runtime/scheduler.py``).

:func:`split_stages` replaces every ``NativeShuffleExchangeExec`` with
an ``IpcReaderExec`` over its shuffle and emits a map stage for the
exchange's child, and every ``BroadcastExchangeExec`` with an
``IpcReaderExec`` over its blobs and a broadcast stage that drains the
child through an ``IpcWriterExec``.  :func:`run_stages` runs the stages
in order.  A map or broadcast stage runs its tasks
``spark.blaze.stage.taskConcurrency`` at a time (default 1, serial;
above 1 task 0 runs first, alone); the result stage runs them one by
one.  Before each task it registers the task's reduce blocks and
broadcast blobs in a resources map of the task's own (tasks of one
stage read one broadcast under one key), serializes the task to
TaskDefinition bytes (a map task's plan wrapped in a
``ShuffleWriterExec`` with this task's ``.data``/``.index`` paths,
its scans staged in ``RESOURCES``) and runs the bytes through
``serde.from_proto.run_task``; it yields the result stage's batches.
The shuffle directory is removed when the result stream ends or is
closed.

Before a range-partitioned map stage whose partitioning has no
boundaries, :meth:`StageRunner.run_stage` first runs the boundary
pass (:func:`compute_range_boundaries`, ≙ Spark's RangePartitioner
sample job): the stage's plan once more over a sample of each task's
rows; its seconds count in the stage's.

Not ported from the reference's scheduler: task retry and fetch-failure
re-runs of map stages (the boundary pass's retry with them),
speculation and wedge detection, worker host pools, the service lease,
tracing and monitoring.  A failed task fails the query.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from .. import conf
from ..batch import RecordBatch
from ..ops.base import ExecNode
from ..parallel.broadcast import BroadcastExchangeExec, IpcWriterExec
from ..parallel.exchange import NativeShuffleExchangeExec, warm_then_map
from ..parallel.shuffle import IpcReaderExec, LocalShuffleManager, Partitioning, RangePartitioning
from .context import RESOURCES, ResourcesMap

# process-unique: a broadcast's cached join map is named by its id
_broadcast_ids = itertools.count()


@dataclass
class Stage:
    """One stage: a plan template with no exchanges, and its task
    count.  Map stages write a shuffle, broadcast stages publish blobs
    every consumer task re-reads, the result stage yields batches; each
    stage reads only what the stages before it wrote."""

    stage_id: int
    kind: str  # "map" | "broadcast" | "result"
    plan: ExecNode
    n_tasks: int
    shuffle_id: Optional[int] = None  # map stages
    partitioning: Optional[Partitioning] = None  # map stages
    broadcast_id: Optional[int] = None  # broadcast stages


@dataclass
class RunStats:
    """What :func:`run_stages` moved: tasks run, their TaskDefinition
    bytes, committed ``.data`` bytes, blocks registered for reduce
    tasks, broadcast blob bytes, the rows read from each shuffle's
    partitions; and each stage's seconds on the host clock (the result
    stage's include its consumer's)."""

    tasks: int = 0
    task_def_bytes: int = 0
    data_bytes: int = 0
    blocks: int = 0
    broadcast_bytes: int = 0
    stage_seconds: List[float] = field(default_factory=list)
    # rows each reduce partition of each shuffle held, as its reader read them
    read_rows: Dict[int, List[int]] = field(default_factory=dict)


class _StageRoot(ExecNode):
    """Holds the root so a root exchange can be replaced too."""

    def __init__(self, child: ExecNode):
        super().__init__([child])

    @property
    def schema(self):
        return self.children[0].schema


def split_stages(root: ExecNode, manager: Optional[LocalShuffleManager] = None
                 ) -> Tuple[List[Stage], LocalShuffleManager]:
    """The plan's stages in dependency order (the result stage last),
    and the shuffle manager (a fresh temporary directory by default)
    their map outputs go to.  Rewrites the plan in place."""
    from ..ops.joins import BroadcastJoinExec

    manager = manager or LocalShuffleManager()
    stages: List[Stage] = []
    wrapper = _StageRoot(root)

    def walk(node: ExecNode) -> None:
        for i, c in enumerate(list(node.children)):
            if isinstance(c, BroadcastExchangeExec):
                src = c.children[0]
                walk(src)
                bid = next(_broadcast_ids)
                stages.append(Stage(len(stages), "broadcast", IpcWriterExec(src, f"broadcast_{bid}"),
                                    src.num_partitions(), broadcast_id=bid))
                node.children[i] = IpcReaderExec(c.schema, f"broadcast_{bid}", 1)
                if isinstance(node, BroadcastJoinExec) and node.cached_build_id is None:
                    # one join map per process for all the consumer's tasks
                    node.cached_build_id = f"sched_bcast_{id(manager)}_{bid}"
            elif isinstance(c, NativeShuffleExchangeExec):
                src = c.children[0]
                walk(src)
                stages.append(Stage(len(stages), "map", src, src.num_partitions(),
                                    shuffle_id=c.shuffle_id, partitioning=c.partitioning))
                node.children[i] = IpcReaderExec(c.schema, f"shuffle_{c.shuffle_id}",
                                                 c.partitioning.num_partitions)
            else:
                walk(c)

    walk(wrapper)
    top = wrapper.children[0]
    stages.append(Stage(len(stages), "result", top, top.num_partitions()))
    return stages, manager


def build_task(stage: Stage, manager: LocalShuffleManager, t: int) -> Tuple[ExecNode, bytes]:
    """Task ``t``'s plan and TaskDefinition bytes; a map task's plan is
    the stage's wrapped in a ShuffleWriterExec writing this task's
    output files.  Serializing stages the scans' partitions in
    ``RESOURCES``: run every task built."""
    from ..serde.to_proto import task_definition

    plan = stage.plan
    if stage.kind == "map":
        plan = manager.map_writer(plan, stage.partitioning, stage.shuffle_id, t)
    return plan, task_definition(plan, f"task_{stage.stage_id}_{t}", stage.stage_id, t)


def ipc_readers(plan: ExecNode, prefix: str) -> List[IpcReaderExec]:
    """The plan's IPC readers whose resource id starts with ``prefix``."""
    out: List[IpcReaderExec] = []

    def walk(node: ExecNode) -> None:
        for c in node.children:
            walk(c)
        if isinstance(node, IpcReaderExec) and node.resource_id.startswith(prefix) \
                and all(r is not node for r in out):
            out.append(node)

    walk(plan)
    return out


def compute_range_boundaries(stage: Stage, register, max_rows: int = 1 << 16) -> tuple:
    """The boundary words of a range-partitioned map stage (≙ the
    reference's ``_compute_range_boundaries``): the stage's plan runs
    for each task, with ``register(t, resources, scope)`` staging its
    inputs; every batch's key words are sampled at the current stride,
    the pool halves (stride doubles) whenever it passes twice
    ``max_rows``, and a task's stream is dropped once its quota of
    ``max(1024, max_rows // tasks)`` rows is met.  The split points are
    the sample's rows at ``(i * n) // n_out`` of its order.  Any
    consistent split keeps the total order; the sample decides only the
    balance.  Returns one int64 array a key word (the reference's
    uint64 words, bit for bit)."""
    from ..ops.sort import range_key_words, words_order
    from .context import TaskContext

    part = stage.partitioning
    schema = stage.plan.schema
    per_word: List[List[np.ndarray]] = []
    pool_rows, stride = 0, 1
    task_quota = max(1024, max_rows // max(1, stage.n_tasks))
    for t in range(stage.n_tasks):
        resources = ResourcesMap()
        with contextlib.ExitStack() as scope:
            register(t, resources, scope)
            task_rows = 0
            for b in stage.plan.execute(t, TaskContext(t, stage.n_tasks, resources)):
                words = range_key_words(schema, part.fields, [c.head(b.num_rows) for c in b.columns], b.num_rows)
                host = torch.stack([w[::stride] for w in words]).cpu().numpy() if words[0].shape[0] else \
                    np.zeros((len(words), 0), np.int64)
                for i, w in enumerate(host):
                    if len(per_word) <= i:
                        per_word.append([])
                    per_word[i].append(w)
                got = host.shape[1]
                pool_rows += got
                task_rows += got * stride
                if pool_rows > 2 * max_rows:
                    per_word = [[np.concatenate(chunks)[::2]] for chunks in per_word]
                    pool_rows = len(per_word[0][0])
                    stride *= 2
                if task_rows >= task_quota:
                    break
    n_out = part.num_partitions
    if not per_word:
        # no batch: no row will reach a pid, any boundaries do
        return (np.zeros(n_out - 1, np.int64),)
    cat = [np.concatenate(chunks) for chunks in per_word]
    n = cat[0].shape[0]
    if n == 0:
        return tuple(np.zeros(n_out - 1, np.int64) for _ in cat)
    if n > max_rows:
        s = (n + max_rows - 1) // max_rows
        cat = [c[::s] for c in cat]
        n = cat[0].shape[0]
    order = words_order([torch.from_numpy(c) for c in cat]).numpy()
    idx = order[[min(n - 1, (i * n) // n_out) for i in range(1, n_out)]]
    return tuple(c[idx] for c in cat)


def _discard(keys: List[str]) -> None:
    for key in keys:
        RESOURCES.discard(key)


class StageRunner:
    """Runs stages of one split, in order: keeps each shuffle's map
    count and each broadcast's blobs for the stages that read them."""

    def __init__(self, manager: LocalShuffleManager, stats: Optional[RunStats] = None):
        self.manager = manager
        self.stats = stats if stats is not None else RunStats()
        self.n_maps: Dict[int, int] = {}
        self.blobs: Dict[int, List[bytes]] = {}
        self._lock = threading.Lock()  # the stats, from concurrent tasks

    def _register(self, stage: Stage, t: int, resources: ResourcesMap,
                  scope: contextlib.ExitStack) -> None:
        """Stage task ``t``'s reduce blocks and broadcast blobs in its
        ``resources`` until ``scope`` closes."""
        blocks = 0
        for node in ipc_readers(stage.plan, "shuffle_"):
            if t >= node.num_partitions():
                continue  # a union's narrower child: no partition t to read
            sid = int(node.resource_id.split("_")[1])
            blocks += scope.enter_context(
                self.manager.reduce_registration(resources, sid, self.n_maps[sid], t))
        for node in ipc_readers(stage.plan, "broadcast_"):
            bid = int(node.resource_id.split("_")[1])
            resources.put(f"{node.resource_id}.0", list(self.blobs[bid]))
        with self._lock:
            self.stats.blocks += blocks

    def _run_task(self, stage: Stage, t: int, resources: ResourcesMap) -> Iterator[RecordBatch]:
        from ..serde.from_proto import run_task
        from ..serde.to_proto import STAGED_RIDS

        # a scan the task did not consume (a failed task stops early)
        # must not outlive it; what it did not read of ``resources``
        # goes with the map
        with contextlib.ExitStack() as scope:
            self._register(stage, t, resources, scope)
            staged: List[str] = []
            scope.callback(_discard, staged)
            token = STAGED_RIDS.set(staged)
            try:
                _, td = build_task(stage, self.manager, t)
            finally:
                STAGED_RIDS.reset(token)
            with self._lock:
                self.stats.tasks += 1
                self.stats.task_def_bytes += len(td)
            plans = []
            yield from run_task(td, resources=resources, on_plan=plans.append)
            self._note_reads(plans[0], t)

    def _note_reads(self, plan: ExecNode, t: int) -> None:
        """Adds the rows task ``t``'s shuffle readers read to the stats."""
        for node in ipc_readers(plan, "shuffle_"):
            if t >= node.num_partitions():
                continue  # a union's narrower child
            sid = int(node.resource_id.split("_")[1])
            with self._lock:
                rows = self.stats.read_rows.setdefault(sid, [0] * node.num_partitions())
                rows[t] += node.metrics.values.get("output_rows", 0)

    def _drain_task(self, stage: Stage, t: int) -> Optional[bytes]:
        """Run map or broadcast task ``t`` to its end; a broadcast task
        returns its blob."""
        resources = ResourcesMap()
        for _ in self._run_task(stage, t, resources):
            pass
        if stage.kind == "broadcast":
            return resources.get(f"broadcast_{stage.broadcast_id}.{t}")
        return None

    def run_stage(self, stage: Stage) -> Iterator[RecordBatch]:
        """Run every task of ``stage``; a result stage yields its
        batches, the others yield nothing.  A range map stage without
        boundaries runs the boundary pass first."""
        part = stage.partitioning
        if stage.kind == "map" and isinstance(part, RangePartitioning) and part.boundaries is None \
                and part.num_partitions > 1:
            part.boundaries = compute_range_boundaries(
                stage, lambda t, resources, scope: self._register(stage, t, resources, scope))
        if stage.kind == "result":
            for t in range(stage.n_tasks):
                yield from self._run_task(stage, t, ResourcesMap())
            return
        outs = warm_then_map(lambda t: self._drain_task(stage, t), stage.n_tasks,
                             int(conf.STAGE_TASK_CONCURRENCY.get()))
        if stage.kind == "map":
            self.n_maps[stage.shuffle_id] = stage.n_tasks
            self.stats.data_bytes += self.manager.data_bytes(stage.shuffle_id, stage.n_tasks)
        else:
            self.blobs[stage.broadcast_id] = outs
            self.stats.broadcast_bytes += sum(len(b) for b in outs)


def run_stages(stages: List[Stage], manager: LocalShuffleManager,
               stats: Optional[RunStats] = None) -> Iterator[RecordBatch]:
    """Run ``stages`` (from :func:`split_stages`) and yield the result
    stage's batches; ``stats``, when given, accumulates what moved.
    The manager's directory and the split's cached join maps are
    dropped when the stream ends or is closed."""
    from ..ops.joins.broadcast import clear_join_map_cache

    runner = StageRunner(manager, stats)
    try:
        for stage in stages:
            t0 = time.perf_counter()
            yield from runner.run_stage(stage)
            runner.stats.stage_seconds.append(time.perf_counter() - t0)
    finally:
        manager.cleanup()
        clear_join_map_cache(f"sched_bcast_{id(manager)}_")
