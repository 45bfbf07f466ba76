"""Speculative attempts, wedge detection and partial map re-runs (the
reference's ``tests/test_speculation.py``), on the port.

q06 at SF 0.002 in 3 partitions through ``run_stages``: its map stage's
task 0 runs alone (the warm-up), tasks 1 and 2 under
``runtime/speculation.StageTaskRunner``.  A ``@slow`` rule at the
map-side commit is the straggler; the backup wins and the loser, woken
by its cancellation, commits nothing.  The rows always equal the
fault-free run's.  The policy's decisions, the partial re-run's
counters and ``invalidate`` are held to the reference's.  A straggler
rule needs a hit after task 0's (hit 1 is the warm-up, which nothing
races or watches), where the reference's tests use hit 1.
"""

import os
import threading
import time

import pytest

from blaze_tpu import conf as jconf
from blaze_tpu.batch import batch_to_pydict as jax_to_pydict
from blaze_tpu.ops import MemoryScanExec as JScan
from blaze_tpu.parallel.shuffle import LocalShuffleManager as JManager
from blaze_tpu.parallel.shuffle import block_map_id as jax_block_map_id
from blaze_tpu.runtime import scheduler as JS
from blaze_tpu.runtime.metrics import MetricNode
from blaze_tpu.runtime.speculation import SpeculationPolicy as JPolicy
from blaze_tpu.serde import from_proto as jax_from_proto
from blaze_tpu.tpch import TPCH_SCHEMAS as JAX_SCHEMAS
from blaze_tpu.tpch import build_query as jax_build_query
from blaze_tpu.tpch.datagen import generate_all as jax_generate_all
from blaze_tpu.tpch.datagen import table_to_batches as jax_table_to_batches

import blaze_tpu_torch
import blaze_tpu_torch.batch as TB
from blaze_tpu_torch import conf
from blaze_tpu_torch.ops import MemoryScanExec
from blaze_tpu_torch.parallel.shuffle import LocalShuffleManager, ShuffleWriterExec, SinglePartitioning, block_map_id
from blaze_tpu_torch.runtime import context, faults
from blaze_tpu_torch.runtime import scheduler as S
from blaze_tpu_torch.runtime.context import RESOURCES, TaskContext
from blaze_tpu_torch.runtime.speculation import SPEC_ATTEMPT_BASE, SpeculationPolicy
from blaze_tpu_torch.schema import DataType, Field, Schema
from blaze_tpu_torch.serde import from_proto
from blaze_tpu_torch.tpch import TPCH_SCHEMAS, build_query
from blaze_tpu_torch.tpch.datagen import generate_all

SCALE = 0.002
N_PARTS = 3
_KNOBS = (conf.SPECULATION_ENABLE, conf.SPECULATION_MULTIPLIER, conf.SPECULATION_QUANTILE,
          conf.SPECULATION_MIN_RUNTIME, conf.SPECULATION_WEDGE_MS, conf.TASK_WEDGE_MS, conf.STAGE_TASK_CONCURRENCY,
          conf.TASK_RETRY_BACKOFF)


def _attempt_threads():
    return [t for t in threading.enumerate() if t.name.startswith("blaze-attempt-") and t.is_alive()]


@pytest.fixture(autouse=True, scope="module")
def _on_cpu():
    prev = blaze_tpu_torch._default_device
    blaze_tpu_torch.set_default_device("cpu")
    yield
    blaze_tpu_torch.set_default_device(prev)


@pytest.fixture(autouse=True)
def _clean_speculation(_on_cpu):
    """Every case starts disarmed and leaves nothing armed or running."""
    saved = [k.get() for k in _KNOBS]
    conf.TASK_RETRY_BACKOFF.set(0.0)
    _inject("")
    yield
    for k, v in zip(_KNOBS, saved):
        k.set(v)
    _inject("")
    deadline = time.monotonic() + 10
    while _attempt_threads() and time.monotonic() < deadline:
        time.sleep(0.02)
    assert _attempt_threads() == [], "the runner left attempt threads"
    assert len(RESOURCES) == 0


def _inject(spec: str) -> None:
    conf.FAULTS_SPEC.set(spec)
    faults.reset()


@pytest.fixture(scope="module")
def data():
    return generate_all(SCALE)


def _rows(batches, to_pydict):
    out = {}
    for b in batches:
        for k, v in to_pydict(b).items():
            out.setdefault(k, []).extend(v)
    return out


def run_port(data, q="q6", stages_hook=None):
    scans = {name: MemoryScanExec(TB.table_to_batches(data[name], TPCH_SCHEMAS[name], N_PARTS, 4096, "cpu"),
                                  TPCH_SCHEMAS[name], device="cpu") for name in TPCH_SCHEMAS}
    stages, manager = S.split_stages(build_query(q, scans, N_PARTS))
    if stages_hook is not None:
        stages_hook(stages, manager)
    stats = S.RunStats()
    rows = _rows(S.run_stages(stages, manager, stats), TB.batch_to_pydict)
    assert not os.path.exists(manager.root)
    return rows, stats


@pytest.fixture(scope="module")
def baseline(data):
    return {q: run_port(data, q)[0] for q in ("q6", "q3")}


def _arm_speculation(wedge_ms=0, multiplier=1.2, quantile=0.25, min_runtime=0.02, concurrency=3):
    conf.SPECULATION_ENABLE.set(True)
    conf.SPECULATION_MULTIPLIER.set(multiplier)
    conf.SPECULATION_QUANTILE.set(quantile)
    conf.SPECULATION_MIN_RUNTIME.set(min_runtime)
    conf.SPECULATION_WEDGE_MS.set(wedge_ms)
    conf.STAGE_TASK_CONCURRENCY.set(concurrency)


# ------------------------------------------------------------ the policy


def test_the_policy_decides_as_the_reference():
    kw = dict(enabled=True, multiplier=2.0, quantile=0.5, min_runtime=0.1, wedge_ms=200)
    p, jp = SpeculationPolicy(**kw), JPolicy(**kw)
    cases = [(10.0, [1.0], 4), (2.5, [1.0, 1.2], 4), (1.9, [1.0, 1.2], 4), (0.05, [0.01, 0.01], 4),
             (5.0, [], 4), (3.0, [1.0, 1.0, 1.0], 3)]
    assert [p.should_speculate(*c) for c in cases] == [jp.should_speculate(*c) for c in cases] \
        == [False, True, False, False, False, True]
    ages = [0.0, 0.15, 0.25, 10.0]
    assert [p.is_spec_wedged(a) for a in ages] == [jp.is_spec_wedged(a) for a in ages]
    off = SpeculationPolicy()
    assert not off.runner_needed() and not off.should_speculate(100.0, [0.1, 0.1], 2)
    for arm in ({"enabled": True}, {"task_wedge_ms": 100}, {"concurrency": 2}):
        assert SpeculationPolicy(**arm).runner_needed() and JPolicy(**arm).runner_needed()
    assert SpeculationPolicy(task_wedge_ms=100).is_retry_wedged(0.2)
    # from the conf, clamped as the reference clamps
    for c in (conf, jconf):
        c.SPECULATION_ENABLE.set(True)
        c.SPECULATION_MULTIPLIER.set(0.3)
        c.SPECULATION_QUANTILE.set(7.0)
        c.STAGE_TASK_CONCURRENCY.set(0)
    try:
        assert SpeculationPolicy.from_conf() == SpeculationPolicy(enabled=True, multiplier=1.0, quantile=1.0)
        assert vars(JPolicy.from_conf()) == vars(SpeculationPolicy.from_conf())
    finally:
        for c in (conf, jconf):
            c.SPECULATION_ENABLE.set(False)
            c.SPECULATION_MULTIPLIER.set(1.5)
            c.SPECULATION_QUANTILE.set(0.75)
            c.STAGE_TASK_CONCURRENCY.set(1)


def test_the_heartbeat_beats_at_each_operator_batch():
    """Every operator's output batch ticks the task being driven on its
    thread, and only while a step of its stream runs."""
    schema = Schema([Field("x", DataType.int64())])
    batches = [TB.batch_from_pydict({"x": [i]}, schema, device="cpu") for i in range(40)]
    scan = MemoryScanExec([batches], schema, device="cpu")
    beats = []
    for b in context.beating(scan.execute(0, TaskContext(0)), lambda: beats.append(1)):
        context.tick()  # the consumer's own work, between steps: not the task's
    # a beat at each step's start (41, the last one ending the stream) and at each of the scan's batches
    assert len(beats) == 81
    context.tick()  # no task driven here: nothing to beat
    assert len(beats) == 81


# ------------------------------------------------- the runner undisturbed


@pytest.mark.parametrize("q", ["q6", "q3"])
def test_the_runner_gives_the_serial_rows(data, baseline, q):
    """Three tasks at a time is a change of schedule alone: the same
    rows, one attempt a task.  q03's broadcast join reads its blobs from
    each attempt's own resources map."""
    conf.STAGE_TASK_CONCURRENCY.set(3)
    rows, stats = run_port(data, q)
    assert rows == baseline[q]
    assert stats.speculative_attempts == stats.task_retries == 0
    assert stats.task_attempts == stats.tasks


def test_the_runner_still_retries_faults(data, baseline):
    """A crash under the runner is retried through its deferred backoff
    (the poll loop relaunches the task when the backoff is due)."""
    conf.STAGE_TASK_CONCURRENCY.set(3)
    conf.TASK_RETRY_BACKOFF.set(0.05)
    _inject("task.compute@2@a0")
    rows, stats = run_port(data)
    assert rows == baseline["q6"]
    assert stats.task_retries == 1


# ------------------------------------------------------ speculative attempts


def test_a_backup_wins_on_the_duration_trigger(data, baseline):
    """The third commit sleeps 800 ms: one of tasks 1 and 2 finishes,
    the other straggles past 1.2 x the median and gets a backup, whose
    commit (the fourth hit) is fast.  The loser wakes cancelled and
    commits nothing."""
    _arm_speculation()
    _inject("shuffle.write@3@slow800")
    t0 = time.monotonic()
    rows, stats = run_port(data)
    assert rows == baseline["q6"]
    assert (stats.speculative_attempts, stats.speculative_won, stats.speculative_lost) == (1, 1, 0)
    assert stats.task_retries == 0 and time.monotonic() - t0 < 5


def test_a_backup_wins_on_the_wedge_trigger(data, baseline):
    """With the duration trigger out of reach, a heartbeat older than
    speculation.wedgeMs launches the backup."""
    _arm_speculation(wedge_ms=400, multiplier=1000.0, quantile=1.0)
    _inject("shuffle.write@2@slow1200")
    rows, stats = run_port(data)
    assert rows == baseline["q6"]
    assert (stats.speculative_attempts, stats.speculative_won) == (1, 1)


@pytest.mark.parametrize("speculation", [False, True])
def test_a_wedged_task_is_failed_and_retried(data, baseline, speculation):
    """task.wedgeMs fails a task whose heartbeat stopped (inside its
    commit, where no batch reaches the driver) and retries it as a
    timeout; speculation on but unable to act (its wedge trigger off,
    its duration trigger out of reach) must not switch that off."""
    if speculation:
        _arm_speculation(wedge_ms=0, multiplier=1000.0, quantile=1.0, concurrency=1)
    conf.TASK_WEDGE_MS.set(400)
    _inject("shuffle.write@2@slow1200")
    rows, stats = run_port(data)
    assert rows == baseline["q6"]
    assert stats.task_timeouts == stats.task_retries == 1
    assert stats.speculative_attempts == 0


# -------------------------------------------------------- partial re-runs


def _losing(package, call, lost_path):
    """run_task of ``package`` that deletes ``lost_path`` at its
    ``call``-th call: an executor lost between the stages."""
    real, state = package.run_task, {"calls": 0}

    def losing(td, **kw):
        state["calls"] += 1
        if state["calls"] == call:
            os.unlink(lost_path)
        return real(td, **kw)

    return losing, state


def _jax_q6(monkeypatch, call, which):
    """The reference's q06 run with map 1's ``which`` (0: ``.data``, 1:
    ``.index``) deleted at its ``call``-th run_task; (rows, metrics)."""
    jdata = jax_generate_all(SCALE)
    scans = {name: JScan(jax_table_to_batches(jdata[name], JAX_SCHEMAS[name], N_PARTS, batch_rows=4096),
                         JAX_SCHEMAS[name]) for name in JAX_SCHEMAS}
    jstages, jmanager = JS.split_stages(jax_build_query("q6", scans, N_PARTS))
    fn, _ = _losing(jax_from_proto, call, jmanager.map_output_paths(jstages[0].shuffle_id, 1)[which])
    monkeypatch.setattr(jax_from_proto, "run_task", fn)
    m = MetricNode()
    return _rows(JS.run_stages(jstages, jmanager, metrics=m), jax_to_pydict), m.metrics


def test_a_partial_rerun_runs_only_the_missing_map_ids(data, monkeypatch):
    """Map 1's committed ``.data`` vanishes: the reduce task's fetch
    failure names map 1, that task alone re-runs, and the counters equal
    the reference's: 3 maps, map 1 again, 2 reduce attempts."""
    want = run_port(data)[0]

    def lose_map_1(stages, manager):
        # just before the first reduce task, its blocks registered already
        fn, _ = _losing(from_proto, N_PARTS + 1, manager.map_output_paths(stages[0].shuffle_id, 1)[0])
        monkeypatch.setattr(from_proto, "run_task", fn)

    rows, stats = run_port(data, stages_hook=lose_map_1)
    monkeypatch.undo()
    jrows, jm = _jax_q6(monkeypatch, N_PARTS + 1, 0)
    assert rows == jrows == want
    names = ("fetch_failures", "map_stage_reruns", "map_tasks_rerun", "task_attempts")
    assert tuple(getattr(stats, c) for c in names) == tuple(jm.get(c) for c in names) == (1, 1, 1, 6)


def test_a_lost_index_reruns_its_map_task_where_the_reference_drops_its_rows(data, monkeypatch):
    """Reference defect 19: map 1's ``.index`` vanishes before the reduce
    task registers its blocks (during map task 2).  The port's
    ``reduce_blocks`` raises a fetch failure naming map 1, which re-runs,
    and q06 is right; the reference's skips map 1, and its q06 revenue
    lacks map 1's rows."""
    want = run_port(data)[0]

    def lose_index_1(stages, manager):
        fn, _ = _losing(from_proto, N_PARTS, manager.map_output_paths(stages[0].shuffle_id, 1)[1])
        monkeypatch.setattr(from_proto, "run_task", fn)

    rows, stats = run_port(data, stages_hook=lose_index_1)
    monkeypatch.undo()
    assert rows == want
    assert (stats.fetch_failures, stats.map_tasks_rerun, stats.task_attempts) == (1, 1, 6)
    jrows, jm = _jax_q6(monkeypatch, N_PARTS, 1)
    assert 0 < jrows["revenue"][0] < want["revenue"][0]  # the defect, pinned
    assert jm.get("fetch_failures") == 0


def test_a_cancelled_loser_never_commits_over_the_winner(tmp_path):
    """A cancelled attempt whose child yields nothing reaches no commit:
    the winner's files stay as they were, in both packages.  A task that
    is empty and not cancelled still commits (a reduce task needs its
    index)."""
    schema = Schema([Field("x", DataType.int64())])
    manager = LocalShuffleManager(str(tmp_path))
    data_p, index_p = manager.map_output_paths(0, 0)
    full = MemoryScanExec([[TB.batch_from_pydict({"x": list(range(64))}, schema, device="cpu")]], schema,
                          device="cpu")
    list(ShuffleWriterExec(full, SinglePartitioning(), data_p, index_p).execute(0, TaskContext(0, 1)))
    winner = (open(data_p, "rb").read(), open(index_p, "rb").read())
    cancelled = threading.Event()
    cancelled.set()
    empty = MemoryScanExec([[]], schema, device="cpu")
    list(ShuffleWriterExec(empty, SinglePartitioning(), data_p, index_p).execute(
        0, TaskContext(0, 1, cancel_event=cancelled, task_attempt_id=SPEC_ATTEMPT_BASE)))
    assert (open(data_p, "rb").read(), open(index_p, "rb").read()) == winner
    # cancelled while it sleeps in its commit: it wakes and writes nothing
    _inject("shuffle.write@1@slow5000")
    late = threading.Event()
    threading.Timer(0.05, late.set).start()
    t0 = time.monotonic()
    list(ShuffleWriterExec(full, SinglePartitioning(), data_p, index_p).execute(
        0, TaskContext(0, 1, cancel_event=late, task_attempt_id=1)))
    assert time.monotonic() - t0 < 2.0
    assert (open(data_p, "rb").read(), open(index_p, "rb").read()) == winner
    assert sorted(os.listdir(tmp_path)) == sorted(os.path.basename(p) for p in (data_p, index_p))
    d2, i2 = manager.map_output_paths(0, 1)
    list(ShuffleWriterExec(empty, SinglePartitioning(), d2, i2).execute(0, TaskContext(0, 1)))
    assert os.path.exists(i2)
    # the reference keeps the winner's files alike
    from blaze_tpu.batch import batch_from_pydict as jax_from_pydict
    from blaze_tpu.parallel.shuffle import ShuffleWriterExec as JWriter, SinglePartitioning as JSingle
    from blaze_tpu.runtime.context import TaskContext as JCtx
    from blaze_tpu.schema import DataType as JT, Field as JF, Schema as JSchema

    jschema = JSchema([JF("x", JT.int64())])
    jmanager = JManager(str(tmp_path / "ref"))
    jd, ji = jmanager.map_output_paths(0, 0)
    list(JWriter(JScan([[jax_from_pydict({"x": list(range(64))}, jschema)]], jschema), JSingle(), jd, ji)
         .execute(0, JCtx(0, 1)))
    jwinner = (open(jd, "rb").read(), open(ji, "rb").read())
    list(JWriter(JScan([[]], jschema), JSingle(), jd, ji).execute(0, JCtx(0, 1, cancel_event=cancelled)))
    assert (open(jd, "rb").read(), open(ji, "rb").read()) == jwinner


def test_invalidate_a_subset_and_sweep_an_attempt_as_the_reference(tmp_path):
    names = {}
    for label, mgr in (("port", LocalShuffleManager(str(tmp_path / "port"))),
                       ("ref", JManager(str(tmp_path / "ref")))):
        for m in range(3):
            for p in mgr.map_output_paths(5, m):
                open(p, "wb").write(b"x")
                open(p + f".inprogress.a{m}", "wb").write(b"x")
        open(mgr.map_output_paths(5, 2)[0] + ".corrupt", "wb").write(b"x")
        assert mgr.invalidate(5, map_ids=[1]) == 4
        assert mgr.sweep_inprogress(5, 2, 2) == 2
        assert mgr.sweep_inprogress(5, 0, 1) == 0
        names[label] = sorted(os.listdir(mgr.root))
        assert mgr.invalidate(5) == 6
        assert os.listdir(mgr.root) == ["shuffle_5_2.data.corrupt"]  # kept
    assert names["port"] == names["ref"]
    data, _ = LocalShuffleManager(str(tmp_path / "ids")).map_output_paths(7, 2)
    for block in ((data, 0, 10), b"inmemory", ("/odd/name.bin", 0, 1)):
        assert block_map_id(block) == jax_block_map_id(block)
    assert block_map_id((data, 0, 10)) == 2
