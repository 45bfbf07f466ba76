"""Stage scheduler: split a plan at its exchanges and run it as stages
of tasks, every task from its TaskDefinition bytes (≙
``blaze_tpu/runtime/scheduler.py``).

:func:`split_stages` replaces every ``NativeShuffleExchangeExec`` with
an ``IpcReaderExec`` over its shuffle and emits a map stage for the
exchange's child, and every ``BroadcastExchangeExec`` with an
``IpcReaderExec`` over its blobs and a broadcast stage that drains the
child through an ``IpcWriterExec``.  :func:`run_stages` runs the stages
in order and their tasks serially: before each task it registers the
task's reduce blocks and broadcast blobs in ``RESOURCES``, serializes
the task to TaskDefinition bytes (a map task's plan wrapped in a
``ShuffleWriterExec`` with this task's ``.data``/``.index`` paths) and
runs the bytes through ``serde.from_proto.run_task``; it yields the
result stage's batches.  The shuffle directory is removed when the
result stream ends or is closed.

Not ported from the reference's scheduler: task retry and fetch-failure
re-runs of map stages, speculation and wedge detection, worker host
pools, the service lease, range partitioning's boundary pass, tracing
and monitoring.  A failed task fails the query.
"""

from __future__ import annotations

import contextlib
import itertools
import time
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple

from ..batch import RecordBatch
from ..ops.base import ExecNode
from ..parallel.broadcast import BroadcastExchangeExec, IpcWriterExec
from ..parallel.exchange import NativeShuffleExchangeExec
from ..parallel.shuffle import IpcReaderExec, LocalShuffleManager, Partitioning
from .context import RESOURCES

# process-unique: broadcast blobs live in the process-wide RESOURCES
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
    tasks, broadcast blob bytes; and each stage's seconds on the host
    clock (the result stage's include its consumer's)."""

    tasks: int = 0
    task_def_bytes: int = 0
    data_bytes: int = 0
    blocks: int = 0
    broadcast_bytes: int = 0
    stage_seconds: List[float] = field(default_factory=list)


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

    def _register(self, stage: Stage, t: int, scope: contextlib.ExitStack) -> None:
        """Stage task ``t``'s reduce blocks and broadcast blobs in
        ``RESOURCES`` until ``scope`` closes."""
        for node in ipc_readers(stage.plan, "shuffle_"):
            sid = int(node.resource_id.split("_")[1])
            self.stats.blocks += scope.enter_context(
                self.manager.reduce_registration(RESOURCES, sid, self.n_maps[sid], t))
        for node in ipc_readers(stage.plan, "broadcast_"):
            bid = int(node.resource_id.split("_")[1])
            key = f"{node.resource_id}.0"
            RESOURCES.put(key, list(self.blobs[bid]))
            scope.callback(RESOURCES.discard, key)

    def _run_task(self, stage: Stage, t: int) -> Iterator[RecordBatch]:
        from ..serde.from_proto import run_task
        from ..serde.to_proto import STAGED_RIDS

        # a registration the task did not consume (a cached join map
        # skips its build side's blobs, a failed task stops early) must
        # not outlive it
        with contextlib.ExitStack() as scope:
            self._register(stage, t, scope)
            staged: List[str] = []
            scope.callback(_discard, staged)
            token = STAGED_RIDS.set(staged)
            try:
                _, td = build_task(stage, self.manager, t)
            finally:
                STAGED_RIDS.reset(token)
            self.stats.tasks += 1
            self.stats.task_def_bytes += len(td)
            yield from run_task(td)

    def run_stage(self, stage: Stage) -> Iterator[RecordBatch]:
        """Run every task of ``stage``; a result stage yields its
        batches, the others yield nothing."""
        for t in range(stage.n_tasks):
            for b in self._run_task(stage, t):
                if stage.kind == "result":
                    yield b
        if stage.kind == "map":
            self.n_maps[stage.shuffle_id] = stage.n_tasks
            self.stats.data_bytes += self.manager.data_bytes(stage.shuffle_id, stage.n_tasks)
        elif stage.kind == "broadcast":
            bid = stage.broadcast_id
            self.blobs[bid] = [RESOURCES.get(f"broadcast_{bid}.{p}") for p in range(stage.n_tasks)]
            self.stats.broadcast_bytes += sum(len(b) for b in self.blobs[bid])


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
        for stage in stages:  # the blobs of a broadcast stage that failed
            if stage.kind == "broadcast":
                for p in range(stage.n_tasks):
                    RESOURCES.discard(f"broadcast_{stage.broadcast_id}.{p}")
        manager.cleanup()
        clear_join_map_cache(f"sched_bcast_{id(manager)}_")
