"""The port's worker processes against the JAX package's.

The pure parts first, held to the reference's functions: the ``@kill``
grammar (armed in a worker only), the dispositions of the pool's error
classes and of the query cancel, ``WorkerLostError.lost_outputs``,
``_describe_error`` and the exit record, and ``run_worker_with_retry``
over a fake ``Popen`` (the reference's ``tests/test_hostpool.py``
cases: no respawn after a fatal exit, one after a retried one).  Then
real CPU workers (``device="cpu"``): a result task in one-shot workers
whose first result file is corrupted (``worker.result@1@a0@corrupt``),
caught by the driver's verification and retried, the second's frames
verified; a cancel that reaches a job stalled in a pooled worker
(``worker.task@1@slow5000``) and kills it with no blacklist and no
loss; a worker stopped with SIGSTOP declared lost for heartbeat silence
under ``livenessTimeoutMs=500``.

No test waits on a clock a loaded machine can miss: the pool is ready
before a test uses it, and no timing is asserted.  After every test
``RESOURCES`` is empty, no ``.inprogress`` file is left and no worker
outlives its pool.
"""

import json
import os
import signal

import numpy as np
import pytest

from blaze_tpu.runtime import context as jcontext
from blaze_tpu.runtime import faults as jfaults
from blaze_tpu.runtime import hostpool as jhostpool
from blaze_tpu.runtime import retry as jretry
from blaze_tpu.runtime import worker as jworker

import blaze_tpu_torch
from blaze_tpu_torch import conf
from blaze_tpu_torch.batch import batch_to_pydict
from blaze_tpu_torch.exprs import col, lit
from blaze_tpu_torch.io import parquet
from blaze_tpu_torch.ops import AggExec, AggFunction, AggMode, FilterExec, ParquetScanExec, ProjectExec
from blaze_tpu_torch.parallel.exchange import NativeShuffleExchangeExec
from blaze_tpu_torch.parallel.shuffle import LocalShuffleManager, SinglePartitioning
from blaze_tpu_torch.runtime import context, faults, retry
from blaze_tpu_torch.runtime import worker as worker_mod
from blaze_tpu_torch.runtime.context import RESOURCES, QueryCancelledError, cancel_scope
from blaze_tpu_torch.runtime.hostpool import HostPool, WorkerLostError, WorkerTaskError, WorkerTaskFatalError
from blaze_tpu_torch.runtime.scheduler import StageRunner, split_stages, worker_task_spec
from blaze_tpu_torch.schema import DataType, Field, Schema

NAMES = ("l_quantity", "l_extendedprice", "l_discount")
SCHEMA = Schema([Field(n, DataType.int64()) for n in NAMES])


def live_children():
    """This process's children that have not exited."""
    me, out = os.getpid(), []
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as f:
                state, ppid = f.read().rsplit(")", 1)[1].split()[:2]
        except OSError:
            continue
        if int(ppid) == me and state != "Z":
            out.append(int(d))
    return out


def inprogress_files(root):
    return [os.path.join(d, f) for d, _, fs in os.walk(root) for f in fs if ".inprogress" in f]


@pytest.fixture(autouse=True, scope="module")
def _on_cpu():
    prev = blaze_tpu_torch._default_device
    blaze_tpu_torch.set_default_device("cpu")
    yield
    blaze_tpu_torch.set_default_device(prev)


@pytest.fixture(autouse=True)
def _clean(tmp_path, _on_cpu):
    conf.FAULTS_SPEC.set("")
    conf.TASK_RETRY_BACKOFF.set(0.0)
    faults.reset()
    before = set(live_children())
    yield
    conf.TASK_RETRY_BACKOFF.set(0.1)
    faults.reset()
    assert len(RESOURCES) == 0, RESOURCES.keys()
    assert inprogress_files(tmp_path) == []
    assert set(live_children()) <= before


# ------------------------------------------------------------ pure parts


def test_kill_round_trips_and_is_armed_in_a_worker_only():
    spec = "worker.task@3@kill,shuffle.fetch@1@a0@kill"
    rules = faults.parse_spec(spec)
    assert rules == jfaults.parse_spec(spec)
    assert faults.format_spec(rules) == jfaults.format_spec(rules) == spec
    assert {"worker.task", "worker.result"} <= set(faults.SITES)
    with pytest.raises(ValueError, match="worker process"):
        faults.FaultInjector(rules)
    faults.FaultInjector(rules, allow_kill=True)


def test_pool_and_cancel_errors_classify_as_the_reference():
    pairs = [(WorkerLostError("w0", "sigkill"), jhostpool.WorkerLostError("w0", "sigkill")),
             (WorkerTaskError("ValueError", "boom"), jhostpool.WorkerTaskError("ValueError", "boom")),
             (WorkerTaskFatalError("AssertionError", "bug"), jhostpool.WorkerTaskFatalError("AssertionError", "bug")),
             (QueryCancelledError("q7"), jcontext.QueryCancelledError("q7"))]
    got = [retry.classify(e) for e, _ in pairs]
    assert got == [jretry.classify(j) for _, j in pairs] == [retry.RETRY, retry.RETRY, retry.FATAL, retry.FATAL]
    assert retry.classify(context.QueryDeadlineError("q7", 5)) == retry.FATAL


@pytest.mark.parametrize("how", ["cancel", "deadline"])
def test_a_cancel_scope_raises_as_the_reference(how):
    """``cancel_query`` reaches the open scope of its id (the first
    reason wins; a closed scope refuses), and a deadline already past
    cancels at the next checkpoint; each check raises the reference's
    message with the frontier it first reached."""
    import time

    said = []
    for ctx in (context, jcontext):
        with ctx.cancel_scope("q5", timeout_ms=1 if how == "deadline" else 0) as scope:
            if how == "cancel":
                assert ctx.cancel_query("q5", reason="user") and ctx.cancel_query("q5", reason="later")
            else:
                time.sleep(0.01)  # past its 1 ms
            for stage, task in ((2, 7), (3, None)):
                with pytest.raises(ctx.QueryCancelledError) as ei:
                    scope.check(stage, task)
                said.append((type(ei.value).__name__, str(ei.value), scope.reason, scope.frontier))
        assert not ctx.cancel_query("q5")
    assert said[:2] == said[2:]
    assert said[0][0] == ("QueryDeadlineError" if how == "deadline" else "QueryCancelledError")
    assert said[1][3] == (2, 7)


def test_lost_outputs_are_sorted_and_drop_empties():
    e = WorkerLostError("w1", "exit status 1", lost_outputs={3: [2, 0], 1: []})
    j = jhostpool.WorkerLostError("w1", "exit status 1", lost_outputs={3: [2, 0], 1: []})
    assert e.lost_outputs == j.lost_outputs == {3: [0, 2]}
    assert str(e) == str(j)


def test_describe_error_equals_the_reference():
    port = retry.FetchFailedError("shuffle_3", partition=1, map_ids=[2, 0])
    ref = jretry.FetchFailedError("shuffle_3", partition=1, map_ids=[2, 0])
    d, jd = worker_mod._describe_error(port), jworker._describe_error(ref)
    # the two classes word their messages apart; each is its own str()
    assert d.pop("message") == str(port) and jd.pop("message") == str(ref)
    assert d == jd == {"error_type": "FetchFailedError", "disposition": "fetch", "resource_id": "shuffle_3",
                       "partition": 1, "map_ids": [0, 2]}
    for exc in (ValueError("bad input"), AssertionError("invariant broke")):
        assert worker_mod._describe_error(exc) == jworker._describe_error(exc)
    c = worker_mod._describe_error(QueryCancelledError("q9", reason="deadline"))
    assert c == jworker._describe_error(jcontext.QueryCancelledError("q9", reason="deadline"))


def test_exit_record_round_trip(tmp_path):
    spec_path = str(tmp_path / "spec.json")
    try:
        raise ValueError("bad input")
    except ValueError as e:
        worker_mod._write_exit_record(spec_path, e)
    rec = worker_mod.read_exit_record(spec_path)
    assert rec == jworker.read_exit_record(spec_path)
    assert rec["error_type"] == "ValueError" and rec["disposition"] == retry.RETRY and "bad input" in rec["message"]
    assert worker_mod.read_exit_record(str(tmp_path / "missing.json")) is None


class _FakeProc:
    """A worker that writes a typed exit record (or none) and exits."""

    def __init__(self, record, returncode, spec_path):
        self.returncode = returncode
        self.pid = os.getpid()
        if record is not None:
            with open(worker_mod.exit_record_path(spec_path), "w") as f:
                json.dump(record, f)

    def communicate(self, timeout=None):
        return b"", b"synthetic failure"


def _fake_popen(monkeypatch, script):
    """``script``: (exit record or None, exit code) a spawn; returns the
    spawns' spec paths."""
    calls = []

    def popen(cmd, **kwargs):
        record, rc = script[min(len(calls), len(script) - 1)]
        calls.append(cmd[-1])
        return _FakeProc(record, rc, cmd[-1])

    import subprocess

    monkeypatch.setattr(subprocess, "Popen", popen)
    return calls


@pytest.mark.parametrize("record,raises", [
    ({"error_type": "QueryCancelledError", "disposition": "fatal", "message": "query q7 cancelled",
      "query_id": "q7", "reason": "cancel"}, QueryCancelledError),
    ({"error_type": "AssertionError", "disposition": "fatal", "message": "invariant broke"}, WorkerTaskFatalError),
])
def test_a_fatal_exit_is_not_respawned(tmp_path, monkeypatch, record, raises):
    calls = _fake_popen(monkeypatch, [(record, 1)])
    with pytest.raises(raises) as ei:
        worker_mod.run_worker_with_retry({"partition": 0}, str(tmp_path), "t0", max_attempts=4, device="cpu")
    assert len(calls) == 1
    if raises is QueryCancelledError:
        assert ei.value.query_id == "q7"
    else:
        assert "AssertionError" in str(ei.value)


def test_a_retried_exit_is_respawned(tmp_path, monkeypatch):
    calls = _fake_popen(monkeypatch, [({"error_type": "InjectedFault", "disposition": "retry",
                                        "message": "seeded crash"}, 1), (None, 0)])
    assert worker_mod.run_worker_with_retry({"partition": 0}, str(tmp_path), "t2", max_attempts=4,
                                            device="cpu") == 1
    assert [os.path.basename(c) for c in calls] == ["spec_t2_a0.json", "spec_t2_a1.json"]


# ------------------------------------------------------------ real workers


def test_a_corrupt_one_shot_result_is_caught_and_retried(tmp_path):
    """A result task in one-shot CPU workers: the first attempt's
    committed file gets a flipped byte (``worker.result@1@a0@corrupt``),
    the driver's verification rejects and deletes it, and the second
    attempt's frames pass and hold the revenue."""
    rng = np.random.RandomState(3)
    d = {n: rng.randint(1, 50, 64).astype(np.int64) for n in NAMES}
    files = []
    for i in range(2):
        path = str(tmp_path / f"l{i}.parquet")
        parquet.write_parquet(path, SCHEMA, {n: (v[i * 32:(i + 1) * 32], None, None) for n, v in d.items()})
        files.append(path)
    scan = ParquetScanExec([[f] for f in files], SCHEMA)
    f = FilterExec(scan, col("l_discount") >= lit(5))
    pr = ProjectExec(f, [col("l_extendedprice") * col("l_discount")], ["rev"])
    ex = NativeShuffleExchangeExec(AggExec(pr, AggMode.PARTIAL, [], [AggFunction("sum", col("rev"), "s")]),
                                   SinglePartitioning())
    stages, manager = split_stages(AggExec(ex, AggMode.FINAL, [], [AggFunction("sum", col("rev"), "s")]),
                                   LocalShuffleManager(str(tmp_path / "root")))
    runner = StageRunner(stages, manager)
    list(runner.run_stage(stages[0]))  # the map stage, in process
    out = str(tmp_path / "result.frames")
    spec = worker_task_spec(stages[1], manager, 0, n_maps=dict(runner.n_maps), output=out)
    attempt = worker_mod.run_worker_with_retry(spec, str(tmp_path), "r0", max_attempts=2, device="cpu",
                                               env={"BLAZE_FAULTS_SPEC": "worker.result@1@a0@corrupt"})
    assert attempt == 1
    assert worker_mod.verify_result_file(out) == 1
    batches = list(worker_mod.read_result_frames(out, stages[1].plan.schema))
    keep = d["l_discount"] >= 5
    assert batch_to_pydict(batches[0]) == {"s": [int((d["l_extendedprice"] * d["l_discount"])[keep].sum())]}
    manager.cleanup()


@pytest.fixture(scope="module")
def stalled_pool(_on_cpu):
    """Two CPU workers whose first job stalls 5 s, a stopped worker
    declared lost after 500 ms of silence, a slot blacklisted at its
    first loss; ready before any test uses it."""
    conf.POOL_LIVENESS_TIMEOUT_MS.set(500)
    conf.HOST_BLACKLIST_MAX_FAILURES.set(1)
    pool = HostPool(2, device="cpu", env={"BLAZE_FAULTS_SPEC": "worker.task@1@slow5000"})
    try:
        assert pool.wait_ready()
        yield pool
    finally:
        pool.close()
        for entry in (conf.POOL_LIVENESS_TIMEOUT_MS, conf.HOST_BLACKLIST_MAX_FAILURES):
            entry.set(entry.default)
    assert live_children() == []


def test_a_cancel_kills_the_job_in_flight(stalled_pool):
    """The wait for a job is a cancel checkpoint: a cancelled query
    kills the stalled worker (it cannot see the driver's scope), counts
    one kill, and charges its slot no failure."""
    pid = stalled_pool.pids()["w0"]
    kills = stalled_pool.stats()["worker_kills"]
    with cancel_scope("q_pool_cancel") as scope:
        assert context.cancel_query("q_pool_cancel")
        with pytest.raises(QueryCancelledError, match="q_pool_cancel"):
            stalled_pool.run_task({"partition": 0, "attempt": 0}, "w0")
    assert scope.cancelled and not context.cancel_query("q_pool_cancel")
    assert stalled_pool.stats()["worker_kills"] == kills + 1
    assert "w0" not in stalled_pool.blacklisted() and "w0" not in stalled_pool.lost_counts()
    with pytest.raises(ProcessLookupError):
        os.kill(pid, 0)


def test_a_silent_worker_is_lost(stalled_pool):
    """A worker stopped after ``ready`` sends no heartbeat: past
    ``livenessTimeoutMs`` it is lost, reaped and (``maxFailures=1``)
    blacklisted."""
    pid = stalled_pool.pids()["w1"]
    os.kill(pid, signal.SIGSTOP)
    with pytest.raises(WorkerLostError, match="heartbeat silent") as ei:
        stalled_pool.run_task({"partition": 0, "attempt": 0}, "w1")
    assert ei.value.worker == "w1" and ei.value.lost_outputs == {}
    assert stalled_pool.blacklisted() == ["w1"] and stalled_pool.lost_counts() == {"w1": 1}
    with pytest.raises(ProcessLookupError):
        os.kill(pid, 0)


def test_a_result_commits_under_an_open_scope_where_the_reference_raises(tmp_path):
    """Reference defect 20: the reference's ``_execute_spec`` guards its
    rename with ``scope.raise_cancelled()``, which raises whenever a
    cancel scope is open, cancelled or not, and leaves its temp; the
    port checks the scope.  One result task of ``a + 1`` over a memory
    scan, run in process under an open scope."""
    from blaze_tpu.batch import batch_from_pydict as jax_from_pydict
    from blaze_tpu.exprs import col as jcol
    from blaze_tpu.ops import MemoryScanExec as JScan, ProjectExec as JProject
    from blaze_tpu.runtime import scheduler as JS
    from blaze_tpu.schema import DataType as JT, Field as JF, Schema as JSchema

    from blaze_tpu_torch.batch import batch_from_pydict
    from blaze_tpu_torch.ops import MemoryScanExec, ProjectExec

    a = {"a": [1, 2, 3]}
    jschema, schema = JSchema([JF("a", JT.int64())]), Schema([Field("a", DataType.int64())])
    from blaze_tpu.parallel.shuffle import LocalShuffleManager as JManager

    jstages, jmanager = JS.split_stages(JProject(JScan([[jax_from_pydict(a, jschema)]], jschema), [jcol("a") + 1],
                                                 ["b"]), JManager(str(tmp_path / "jroot")))
    out = str(tmp_path / "ref.frames")
    with jcontext.cancel_scope("q_open"), pytest.raises(jcontext.QueryCancelledError):
        jworker._execute_spec(JS.worker_task_spec(jstages[0], jmanager, 0, output=out))
    assert not os.path.exists(out) and inprogress_files(tmp_path) == [out + ".inprogress.a0"]
    os.unlink(out + ".inprogress.a0")

    scan = MemoryScanExec([[batch_from_pydict(a, schema, device="cpu")]], schema, device="cpu")
    stages, manager = split_stages(ProjectExec(scan, [col("a") + 1], ["b"]),
                                   LocalShuffleManager(str(tmp_path / "root")))
    out = str(tmp_path / "port.frames")
    with cancel_scope("q_open"):
        done = worker_mod._execute_spec(worker_task_spec(stages[0], manager, 0, output=out))
    assert done["rows"] == 3
    assert [batch_to_pydict(b) for b in worker_mod.read_result_frames(out, stages[0].plan.schema)] == [
        {"b": [2, 3, 4]}]
    manager.cleanup()
