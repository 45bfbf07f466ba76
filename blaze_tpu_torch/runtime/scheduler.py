"""Stage scheduler: split a plan at its exchanges and run it as stages
of tasks, every task from its TaskDefinition bytes (≙
``blaze_tpu/runtime/scheduler.py``).

:func:`split_stages` replaces every ``NativeShuffleExchangeExec`` with
an ``IpcReaderExec`` over its shuffle and emits a map stage for the
exchange's child, and every ``BroadcastExchangeExec`` with an
``IpcReaderExec`` over its blobs and a broadcast stage that drains the
child through an ``IpcWriterExec``.  :func:`run_stages` runs the stages
in order.  A map or broadcast stage runs its tasks one by one on the
driver's thread, or, with ``spark.blaze.stage.taskConcurrency`` above
1, speculation or wedge detection armed, its first task alone and the
rest under ``runtime/speculation.StageTaskRunner``; the result stage
runs them one by one.  Each attempt of a task registers the task's
reduce blocks and broadcast blobs in a resources map of the attempt's
own (tasks of one stage read one broadcast under one key), serializes
the task to TaskDefinition bytes (a map task's plan wrapped in a
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

Recovery (≙ the reference's, ``runtime/retry.py`` and
``runtime/speculation.py``): a failed attempt discards what it staged
and its temporary files, and :meth:`StageRunner.handle_failure` asks
``retry.classify`` what it calls for.  A retryable failure runs a fresh
attempt (``_a<attempt>`` in its task id) after a deterministic backoff,
``spark.blaze.task.maxAttempts`` in all.  A ``FetchFailedError``
regenerates its producer first, without costing an attempt: the map
tasks it names, the whole map stage when it names none, or the
broadcast stage, ``spark.blaze.stage.maxAttempts`` times a task at
most.  The boundary pass recovers the same way, as task -1.  A result
task is retried only before its first batch.  ``spark.blaze.task.timeout``
is checked between a task's batches.  A budget used up raises
``TaskRetriesExhausted``; a fatal error (a cancellation, an engine
bug, an unported path) propagates at once.

Worker pool (``pool``, a ``runtime/hostpool.HostPool``): a map stage
whose plan reads no broadcast blob (:meth:`StageRunner.pool_eligible`)
binds its tasks to the pool's worker processes round robin, one at a
time on the driver's thread, as the reference does; under the
concurrent runner nothing is pooled.  A task whose TaskDefinition
stages driver resources (a memory scan) cannot ship and runs in
process under the same attempt id, and so does every task once the
pool is degraded.  A lost worker's ``WorkerLostError`` first re-runs
the committed map outputs it owned (each re-run counting against
``spark.blaze.stage.maxAttempts``), then retries the task.

Query cancellation (``scope``, a ``runtime/context.CancelScope``, by
default the ambient one of ``context.cancel_scope``): checked before
each stage, task attempt and pulled batch; serial attempts take its
event as their cancel event, concurrent ones are attached to it; a
cancelled run sweeps its temporary files and raises
``QueryCancelledError``.

Not ported from the reference's scheduler: the service lease, tracing
and monitoring.
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

from ..batch import RecordBatch
from ..ops.base import ExecNode
from ..parallel.broadcast import BroadcastExchangeExec, IpcWriterExec
from ..parallel.exchange import NativeShuffleExchangeExec
from ..parallel.shuffle import IpcReaderExec, LocalShuffleManager, Partitioning, RangePartitioning
from .context import RESOURCES, QueryCancelledError, ResourcesMap, current_cancel_scope
from .retry import FETCH_FAILED, RETRY, RetryPolicy, TaskRetriesExhausted, TaskTimeoutError, classify
from .speculation import SpeculationPolicy, StageTaskRunner

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
    """What :func:`run_stages` moved: tasks run to their end (a
    regenerated task counts once, under ``map_tasks_rerun`` or
    ``broadcast_stage_reruns``), the TaskDefinition bytes of every
    attempt, committed ``.data`` bytes, blocks registered for reduce
    tasks, broadcast blob bytes, the rows the finished tasks read from
    each shuffle's partitions, a regeneration's reads not again; each stage's
    seconds on the host clock (the result stage's include its
    consumer's); and the recovery counters (the reference's):
    attempts, retries, timeouts (wedges among them), fetch failures,
    map stage re-runs and the map tasks they ran, broadcast stage
    re-runs, speculative attempts, won and lost, and pooled workers
    lost."""

    tasks: int = 0
    task_def_bytes: int = 0
    data_bytes: int = 0
    blocks: int = 0
    broadcast_bytes: int = 0
    stage_seconds: List[float] = field(default_factory=list)
    # rows each reduce partition of each shuffle held, as its reader read them
    read_rows: Dict[int, List[int]] = field(default_factory=dict)
    task_attempts: int = 0
    task_retries: int = 0
    task_timeouts: int = 0
    fetch_failures: int = 0
    map_stage_reruns: int = 0
    map_tasks_rerun: int = 0
    broadcast_stage_reruns: int = 0
    speculative_attempts: int = 0
    speculative_won: int = 0
    speculative_lost: int = 0
    worker_lost: int = 0


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


def build_task(stage: Stage, manager: LocalShuffleManager, t: int, attempt: int = 0) -> Tuple[ExecNode, bytes]:
    """Task ``t``'s plan and TaskDefinition bytes (its id
    ``task_<stage>_<t>``, ``_a<attempt>`` after a first attempt); a map
    task's plan is the stage's wrapped in a ShuffleWriterExec writing
    this task's output files.  Serializing stages the scans' partitions
    in ``RESOURCES``: run every task built."""
    from ..serde.to_proto import task_definition

    plan = stage.plan
    if stage.kind == "map":
        plan = manager.map_writer(plan, stage.partitioning, stage.shuffle_id, t)
    suffix = f"_a{attempt}" if attempt else ""
    return plan, task_definition(plan, f"task_{stage.stage_id}_{t}{suffix}", stage.stage_id, t)


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


def plan_reads(plan: ExecNode, t: int) -> Dict[int, Tuple[int, int]]:
    """Shuffle id -> (rows its reader read in task ``t``, its reduce
    partitions), from a run plan's reader metrics."""
    out: Dict[int, Tuple[int, int]] = {}
    for node in ipc_readers(plan, "shuffle_"):
        if t >= node.num_partitions():
            continue  # a union's narrower child: no partition t to read
        sid = int(node.resource_id.split("_")[1])
        rows = out.get(sid, (0, 0))[0] + node.metrics.values.get("output_rows", 0)
        out[sid] = (rows, node.num_partitions())
    return out


def worker_task_spec(stage: Stage, manager: LocalShuffleManager, t: int, attempt: int = 0,
                     n_maps: Optional[Dict[int, int]] = None, output: Optional[str] = None) -> Dict[str, object]:
    """The ``runtime/worker.py`` job spec of task ``t``: its
    TaskDefinition bytes, the shared shuffle root, a reader for each
    upstream shuffle of ``n_maps`` (shuffle id -> committed map outputs)
    and, for a result task, the path of its result frames."""
    import base64

    _, td = build_task(stage, manager, t, attempt)
    return {"task_def": base64.b64encode(td).decode(), "partition": t, "attempt": attempt,
            "shuffle_root": manager.root,
            "readers": [{"resource_id": f"shuffle_{sid}", "shuffle_id": sid, "n_maps": nm}
                        for sid, nm in sorted((n_maps or {}).items())],
            "output": output}


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


def _drop_frames(exc: BaseException) -> None:
    """Drop the tracebacks of a handled failure and of its causes: their
    frames hold the failed attempt's tensors, which a retry would
    otherwise keep on the card beside its own."""
    seen = set()
    while exc is not None and id(exc) not in seen:
        seen.add(id(exc))
        exc.__traceback__ = None
        exc = exc.__cause__ or exc.__context__


class StageRunner:
    """Runs the stages of one split, in order, and recovers their
    failures: keeps each shuffle's map count and each broadcast's blobs
    for the stages that read them, and the stage that produced each, to
    regenerate it.  ``pool`` hosts the eligible map tasks; ``scope``
    cancels the run."""

    def __init__(self, stages: List[Stage], manager: LocalShuffleManager, stats: Optional[RunStats] = None,
                 max_task_attempts: Optional[int] = None, pool=None, scope=None):
        self.manager = manager
        self.pool = pool
        self.scope = scope
        self.stats = stats if stats is not None else RunStats()
        self.policy = RetryPolicy.from_conf()
        if max_task_attempts is not None:
            self.policy = self.policy.with_max_attempts(max_task_attempts)
        self.map_stages = {s.shuffle_id: s for s in stages if s.kind == "map"}
        self.broadcast_stages = {s.broadcast_id: s for s in stages if s.kind == "broadcast"}
        self.n_maps: Dict[int, int] = {}
        self.blobs: Dict[int, List[bytes]] = {}
        self._lock = threading.Lock()  # the stats, from concurrent tasks

    def _count(self, name: str, n: int = 1) -> None:
        with self._lock:
            setattr(self.stats, name, getattr(self.stats, name) + n)

    def _checkpoint(self, stage: Stage, t: Optional[int] = None) -> None:
        """Raise ``QueryCancelledError`` once the run's scope is cancelled."""
        if self.scope is not None:
            self.scope.check(stage.stage_id, t)

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
        self._count("blocks", blocks)

    def _run_task(self, stage: Stage, t: int, attempt: int, resources: ResourcesMap, plans: list,
                  cancel_event=None, on_beat=None) -> Iterator[RecordBatch]:
        """One attempt of task ``t``: its batches, each pulled within
        ``spark.blaze.task.timeout``; its optimized plan goes to
        ``plans``."""
        from ..serde import from_proto
        from ..serde.to_proto import STAGED_RIDS

        self._count("task_attempts")
        # a scan the task did not consume (a failed task stops early)
        # must not outlive it; what it did not read of ``resources``
        # goes with the map
        with contextlib.ExitStack() as scope:
            self._register(stage, t, resources, scope)
            staged: List[str] = []
            scope.callback(_discard, staged)
            token = STAGED_RIDS.set(staged)
            try:
                _, td = build_task(stage, self.manager, t, attempt)
            finally:
                STAGED_RIDS.reset(token)
            self._count("task_def_bytes", len(td))
            deadline = self.policy.deadline()
            for b in from_proto.run_task(td, task_attempt_id=attempt, resources=resources, on_plan=plans.append,
                                         cancel_event=cancel_event, on_beat=on_beat):
                self._checkpoint(stage, t)
                if deadline is not None and time.monotonic() > deadline:
                    raise TaskTimeoutError(f"task {t} of stage {stage.stage_id} exceeded "
                                           f"{self.policy.task_timeout}s")
                yield b

    def _note_reads(self, reads: Dict[int, Tuple[int, int]], t: int) -> None:
        """Adds the rows task ``t``'s shuffle readers read (``plan_reads``)
        to the stats."""
        with self._lock:
            for sid, (rows, n_parts) in reads.items():
                self.stats.read_rows.setdefault(sid, [0] * n_parts)[t] += rows

    def _attempt(self, stage: Stage, t: int, attempt: int, outs: dict, cancel_event=None, on_beat=None) -> None:
        """One attempt of map or broadcast task ``t`` to its end.  The
        first attempt of the task to finish uncancelled puts (its blob,
        its reads) in ``outs[t]``; a failed or cancelled map attempt's
        temporary files go.  A serial attempt takes the scope's event as
        its cancel event, a concurrent one is attached to the scope."""
        resources, plans = ResourcesMap(), []
        attached = cancel_event is not None and self.scope is not None
        if attached:
            self.scope.attach(cancel_event)
        elif self.scope is not None:
            cancel_event = self.scope.event
        try:
            for _ in self._run_task(stage, t, attempt, resources, plans, cancel_event, on_beat):
                pass
            self._checkpoint(stage, t)  # a cancelled drain may have stopped early
        except BaseException:
            if stage.kind == "map":
                self.manager.sweep_inprogress(stage.shuffle_id, t, attempt)
            raise
        finally:
            if attached:
                self.scope.detach(cancel_event)
        if cancel_event is not None and cancel_event.is_set():
            # a loser: its drain may have stopped early, and nothing of it is kept
            if stage.kind == "map":
                self.manager.sweep_inprogress(stage.shuffle_id, t, attempt)
            return
        blob = resources.get(f"broadcast_{stage.broadcast_id}.{t}") if stage.kind == "broadcast" else None
        with self._lock:
            outs.setdefault(t, (blob, plan_reads(plans[0], t)))

    def pool_eligible(self, stage: Stage) -> bool:
        """A map stage the pool may host: its plan reads no broadcast
        blob, which lives in the driver's memory."""
        return self.pool is not None and stage.kind == "map" and not ipc_readers(stage.plan, "broadcast_")

    def _pooled_attempt(self, stage: Stage, t: int, attempt: int, worker: str, outs: dict) -> bool:
        """One attempt of map task ``t`` on the pooled ``worker``, which
        commits its output into the shared root; the pool then owns it.
        False, with nothing run, when the TaskDefinition cannot ship: it
        staged driver resources (a memory scan) no other process can
        read.  A failed attempt's temporary files go."""
        import base64

        from ..serde.to_proto import STAGED_RIDS

        n_maps = {}
        for node in ipc_readers(stage.plan, "shuffle_"):
            if t < node.num_partitions():
                sid = int(node.resource_id.split("_")[1])
                n_maps[sid] = self.n_maps[sid]
        staged: List[str] = []
        token = STAGED_RIDS.set(staged)
        try:
            spec = worker_task_spec(stage, self.manager, t, attempt, n_maps)
        finally:
            STAGED_RIDS.reset(token)
        if staged:
            _discard(staged)
            return False
        self._count("task_attempts")
        self._count("task_def_bytes", len(base64.b64decode(spec["task_def"])))
        try:
            reply = self.pool.run_task(spec, worker, scope=self.scope)
        except BaseException:
            self.manager.sweep_inprogress(stage.shuffle_id, t, attempt)
            raise
        self.pool.note_map_output(worker, stage.shuffle_id, t)
        self._count("blocks", int(reply.get("blocks", 0)))
        reads = {int(sid): (int(r), int(n)) for sid, (r, n) in (reply.get("read_rows") or {}).items()}
        with self._lock:
            outs.setdefault(t, (None, reads))
        return True

    def handle_failure(self, stage: Stage, t: int, exc: BaseException, attempt: int, regens: int,
                       sleep: bool = True) -> Tuple[int, int, float]:
        """Recover from a failed attempt of task ``t`` (-1: the boundary
        pass): regenerate the producer of a fetch failure, or count a
        retry; returns (the next attempt, the regenerations so far, the
        backoff still to wait: 0 when ``sleep`` slept it).  Raises
        ``TaskRetriesExhausted`` when a budget is used up, and a fatal
        error as it is.  A lost pooled worker's committed map outputs
        re-run first, each re-run a regeneration; the task then retries."""
        from .hostpool import WorkerLostError

        if isinstance(exc, WorkerLostError):
            # now, not at a later fetch: the pool no longer vouches for
            # what the dead worker committed
            self._count("worker_lost")
            for sid in sorted(exc.lost_outputs):
                mstage = self.map_stages.get(sid)
                if mstage is None:
                    continue
                regens += 1
                if regens > self.policy.max_stage_regens:
                    raise TaskRetriesExhausted(stage.stage_id, t, attempt + 1, exc) from exc
                self.regenerate_map_stage(mstage, exc.lost_outputs[sid])
        action = classify(exc)
        if action == FETCH_FAILED:
            self._count("fetch_failures")
            mstage = self.map_stages.get(exc.shuffle_id)
            bstage = self.broadcast_stages.get(exc.broadcast_id)
            if mstage is not None or bstage is not None:
                regens += 1
                if regens > self.policy.max_stage_regens:
                    raise TaskRetriesExhausted(stage.stage_id, t, attempt + 1, exc) from exc
                _drop_frames(exc)
                if mstage is not None:
                    self.regenerate_map_stage(mstage, exc.map_ids)
                else:
                    self.regenerate_broadcast_stage(bstage)
                return attempt, regens, 0.0
            action = RETRY  # no stage of this run produced it: a plain retry may still read it
        if action != RETRY:
            raise exc
        attempt += 1
        if attempt >= self.policy.max_attempts:
            raise TaskRetriesExhausted(stage.stage_id, t, attempt, exc) from exc
        _drop_frames(exc)
        self._count("task_retries")
        if isinstance(exc, TaskTimeoutError):
            self._count("task_timeouts")
        delay = self.policy.backoff(stage.stage_id, t, attempt - 1)
        if sleep and delay > 0:
            time.sleep(delay)
            delay = 0.0
        return attempt, regens, delay

    def regenerate_map_stage(self, stage: Stage, map_ids: Optional[List[int]] = None) -> None:
        """A fetch failure's recovery: drop the shuffle's bad map outputs
        and run their map tasks again, only those of ``map_ids`` when
        they are known (a partial re-run), all of them when not."""
        tasks = sorted(m for m in set(map_ids or ()) if 0 <= m < stage.n_tasks) or None
        if tasks is not None and len(tasks) >= stage.n_tasks:
            tasks = None
        self._count("map_stage_reruns")
        self._count("map_tasks_rerun", stage.n_tasks if tasks is None else len(tasks))
        self.manager.invalidate(stage.shuffle_id, map_ids=tasks)
        self._run_tasks(stage, tasks, regenerated=True)
        self.n_maps[stage.shuffle_id] = stage.n_tasks

    def regenerate_broadcast_stage(self, stage: Stage) -> None:
        """A corrupt blob's recovery: run the broadcast stage again and
        keep its new blobs (the kept ones are the corrupt bytes)."""
        self._count("broadcast_stage_reruns")
        outs = self._run_tasks(stage, regenerated=True)
        self.blobs[stage.broadcast_id] = [outs[t][0] for t in range(stage.n_tasks)]

    def run_task_attempts(self, stage: Stage, t: int, outs: dict, pooled: bool = False) -> None:
        """Map or broadcast task ``t`` under the retry policy, on this
        thread; ``pooled``: on a worker the pool places it on, in
        process once the pool is degraded or when the task cannot ship
        (the same attempt id: nothing ran)."""
        attempt = regens = 0
        while True:
            self._checkpoint(stage, t)
            try:
                if pooled:
                    worker = self.pool.placement(stage.stage_id, t)
                    if worker is not None:
                        if self._pooled_attempt(stage, t, attempt, worker, outs):
                            return
                        pooled = False
                        continue
                return self._attempt(stage, t, attempt, outs)
            except BaseException as exc:
                attempt, regens, _ = self.handle_failure(stage, t, exc, attempt, regens)

    def _run_tasks(self, stage: Stage, tasks: Optional[List[int]] = None, regenerated: bool = False) -> dict:
        """Run the tasks of a map or broadcast stage (all, or ``tasks``
        of a partial re-run); returns each task's (blob, plan).  The
        tasks and their reads count in the stats unless ``regenerated``
        (they counted when they first finished)."""
        tasks = list(range(stage.n_tasks)) if tasks is None else list(tasks)
        outs: dict = {}
        policy = SpeculationPolicy.from_conf()
        if not policy.runner_needed() or len(tasks) <= 1:
            # the pool hosts serial stages only, as in the reference
            pooled = self.pool_eligible(stage) and not policy.runner_needed()
            for t in tasks:
                self.run_task_attempts(stage, t, outs, pooled)
        else:
            # the first task alone: it builds the kernel library and
            # materializes what the stage reads, which no backup may
            # race and no wedge detector may take for a wedge
            t0 = time.monotonic()
            self.run_task_attempts(stage, tasks[0], outs)
            StageTaskRunner(stage.stage_id, tasks[1:], policy,
                            attempt_fn=lambda t, a, cancel, beat: self._attempt(stage, t, a, outs, cancel, beat),
                            on_failure=lambda t, exc, a, r: self.handle_failure(stage, t, exc, a, r, sleep=False),
                            count=self._count, durations=[time.monotonic() - t0]).run()
        if not regenerated:
            self._count("tasks", len(outs))
            for t, (_, reads) in outs.items():
                self._note_reads(reads, t)
        return outs

    def run_result_task(self, stage: Stage, t: int) -> Iterator[RecordBatch]:
        """Result task ``t``'s batches, streamed; a failure before the
        first batch is recovered, a later one is terminal (its batches
        are the caller's already)."""
        attempt = regens = 0
        while True:
            self._checkpoint(stage, t)
            plans: list = []
            yielded = False
            try:
                cancel = self.scope.event if self.scope is not None else None
                with contextlib.closing(self._run_task(stage, t, attempt, ResourcesMap(), plans, cancel)) as stream:
                    for b in stream:
                        yielded = True
                        yield b
                # a cancelled operator stops quietly: no truncated result passes as whole
                self._checkpoint(stage, t)
            except BaseException as exc:
                if yielded:
                    raise
                attempt, regens, _ = self.handle_failure(stage, t, exc, attempt, regens)
                continue
            self._count("tasks")
            self._note_reads(plan_reads(plans[0], t), t)
            return

    def run_stage(self, stage: Stage) -> Iterator[RecordBatch]:
        """Run every task of ``stage``; a result stage yields its
        batches, the others yield nothing.  A range map stage without
        boundaries runs the boundary pass first, recovered as task -1."""
        self._checkpoint(stage)
        part = stage.partitioning
        if stage.kind == "map" and isinstance(part, RangePartitioning) and part.boundaries is None \
                and part.num_partitions > 1:
            attempt = regens = 0
            while part.boundaries is None:
                try:
                    part.boundaries = compute_range_boundaries(
                        stage, lambda t, resources, scope: self._register(stage, t, resources, scope))
                except BaseException as exc:
                    attempt, regens, _ = self.handle_failure(stage, -1, exc, attempt, regens)
        if stage.kind == "result":
            for t in range(stage.n_tasks):
                yield from self.run_result_task(stage, t)
            return
        outs = self._run_tasks(stage)
        if stage.kind == "map":
            self.n_maps[stage.shuffle_id] = stage.n_tasks
            self.stats.data_bytes += self.manager.data_bytes(stage.shuffle_id, stage.n_tasks)
        else:
            self.blobs[stage.broadcast_id] = [outs[t][0] for t in range(stage.n_tasks)]
            self.stats.broadcast_bytes += sum(len(b) for b in self.blobs[stage.broadcast_id])


def run_stages(stages: List[Stage], manager: LocalShuffleManager, stats: Optional[RunStats] = None,
               max_task_attempts: Optional[int] = None, pool=None, scope=None) -> Iterator[RecordBatch]:
    """Run ``stages`` (from :func:`split_stages`) and yield the result
    stage's batches; ``stats``, when given, accumulates what moved and
    the recovery counters; ``max_task_attempts`` overrides
    ``spark.blaze.task.maxAttempts``; ``pool`` (a ``HostPool``) hosts
    the eligible map tasks; ``scope`` (default: the ambient
    ``CancelScope``) cancels the run.  The manager's directory and the
    split's cached join maps are dropped when the stream ends or is
    closed."""
    from ..ops.joins.broadcast import clear_join_map_cache

    runner = StageRunner(stages, manager, stats, max_task_attempts, pool=pool,
                         scope=scope if scope is not None else current_cancel_scope())
    try:
        for stage in stages:
            t0 = time.perf_counter()
            yield from runner.run_stage(stage)
            runner.stats.stage_seconds.append(time.perf_counter() - t0)
    except QueryCancelledError:
        # what no attempt's own rollback reached: abandoned temporary files
        manager.sweep_inprogress()
        raise
    finally:
        manager.cleanup()
        clear_join_map_cache(f"sched_bcast_{id(manager)}_")
