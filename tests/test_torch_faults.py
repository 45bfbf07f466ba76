"""The port's fault injection and recovery against the JAX package's.

``runtime/faults.py``'s grammar, ``random_spec`` and hit counters,
``runtime/retry.py``'s ``classify`` and backoff are held to the
reference's.  Then each scheduler recovery of the reference's
``tests/test_faults.py`` runs the same spec through both packages'
``run_stages`` on the same seeded TPC-H data (q06, and q01 under the
reference's fault matrix, at SF 0.002 in 3 partitions; the reference's
``run_stages`` is right on both): the rows equal the fault-free run's
and the reference's, and ``task_attempts``, ``task_retries``,
``fetch_failures`` and ``map_stage_reruns`` equal the reference's
counters.  Every spec probes its site on the task's own thread, so the
hit numbers of both packages count the same events.
"""

import os
import threading
import time

import numpy as np
import pytest

from blaze_tpu import conf as jconf
from blaze_tpu.batch import batch_to_pydict as jax_to_pydict
from blaze_tpu.exprs import col as jcol
from blaze_tpu.ops import MemoryScanExec as JScan, ProjectExec as JProject, SortExec as JSort
from blaze_tpu.ops import SortField as JSortField
from blaze_tpu.parallel import RangePartitioning as JRange
from blaze_tpu.parallel.exchange import NativeShuffleExchangeExec as JExchange
from blaze_tpu.parallel.shuffle import HashPartitioning as JHash
from blaze_tpu.runtime import faults as jfaults
from blaze_tpu.runtime import retry as jretry
from blaze_tpu.runtime import scheduler as JS
from blaze_tpu.runtime.context import TaskCancelled as JTaskCancelled
from blaze_tpu.runtime.integrity import BlockCorruptionError as JBlockCorruption
from blaze_tpu.runtime.metrics import MetricNode
from blaze_tpu.schema import DataType as JT, Field as JF, Schema as JSchema
from blaze_tpu.serde import from_proto as jax_from_proto
from blaze_tpu.tpch import TPCH_SCHEMAS as JAX_SCHEMAS
from blaze_tpu.tpch import build_query as jax_build_query
from blaze_tpu.tpch.datagen import generate_all as jax_generate_all
from blaze_tpu.tpch.datagen import table_to_batches as jax_table_to_batches

import blaze_tpu_torch
import blaze_tpu_torch.batch as TB
from blaze_tpu_torch import conf
from blaze_tpu_torch.exprs import col
from blaze_tpu_torch.ops import MemoryScanExec, ProjectExec, SortExec, SortField
from blaze_tpu_torch.parallel import RangePartitioning
from blaze_tpu_torch.parallel.exchange import NativeShuffleExchangeExec
from blaze_tpu_torch.parallel.shuffle import (
    HashPartitioning, IpcReaderExec, LocalShuffleManager, ShuffleWriterExec, SinglePartitioning,
)
from blaze_tpu_torch.runtime import faults, integrity, retry
from blaze_tpu_torch.runtime import scheduler as S
from blaze_tpu_torch.runtime.context import RESOURCES, TaskCancelled, TaskContext
from blaze_tpu_torch.schema import DataType as TT, Field as TF, Schema as TSchema
from blaze_tpu_torch.serde import from_proto
from blaze_tpu_torch.tpch import TPCH_SCHEMAS, build_query
from blaze_tpu_torch.tpch.datagen import generate_all

SCALE = 0.002
N_PARTS = 3
COUNTERS = ("task_attempts", "task_retries", "fetch_failures", "map_stage_reruns")


@pytest.fixture(autouse=True, scope="module")
def _on_cpu():
    prev = blaze_tpu_torch._default_device
    blaze_tpu_torch.set_default_device("cpu")
    yield
    blaze_tpu_torch.set_default_device(prev)


@pytest.fixture(autouse=True)
def _clean_faults(_on_cpu):
    """Sleep-free retries, no spec before or after."""
    for c, f in ((conf, faults), (jconf, jfaults)):
        c.FAULTS_SPEC.set("")
        c.TASK_RETRY_BACKOFF.set(0.0)
        f.reset()
    yield
    for c, f in ((conf, faults), (jconf, jfaults)):
        c.FAULTS_SPEC.set("")
        c.TASK_RETRY_BACKOFF.set(0.1)
        c.TASK_TIMEOUT.set(0.0)
        f.reset()
    integrity.reset()
    assert len(RESOURCES) == 0


def _inject(spec: str) -> None:
    for c, f in ((conf, faults), (jconf, jfaults)):
        c.FAULTS_SPEC.set(spec)
        f.reset()


@pytest.fixture(scope="module")
def data():
    return generate_all(SCALE)


@pytest.fixture(scope="module")
def jax_data():
    return jax_generate_all(SCALE)


def _rows(batches, to_pydict):
    out = {}
    for b in batches:
        for k, v in to_pydict(b).items():
            out.setdefault(k, []).extend(v)
    return out


def run_port(data, q, **kw):
    """(rows, stats, what the shuffle root held as the result stream
    ended) of ``q`` through the port's run_stages."""
    scans = {name: MemoryScanExec(TB.table_to_batches(data[name], TPCH_SCHEMAS[name], N_PARTS, 4096, "cpu"),
                                  TPCH_SCHEMAS[name], device="cpu") for name in TPCH_SCHEMAS}
    stages, manager = S.split_stages(build_query(q, scans, N_PARTS))
    stats, out, left = S.RunStats(), [], []
    for b in S.run_stages(stages, manager, stats, **kw):
        out.append(b)
        left = os.listdir(manager.root)
    assert not os.path.exists(manager.root)
    return _rows(out, TB.batch_to_pydict), stats, left


def run_jax(jax_data, q, **kw):
    scans = {name: JScan(jax_table_to_batches(jax_data[name], JAX_SCHEMAS[name], N_PARTS, batch_rows=4096),
                         JAX_SCHEMAS[name]) for name in JAX_SCHEMAS}
    stages, manager = JS.split_stages(jax_build_query(q, scans, N_PARTS))
    m = MetricNode()
    rows = _rows(JS.run_stages(stages, manager, metrics=m, **kw), jax_to_pydict)
    return rows, m.metrics


def counters(stats, jax_metrics=None):
    if jax_metrics is not None:
        return tuple(jax_metrics.get(c) for c in COUNTERS)
    return tuple(getattr(stats, c) for c in COUNTERS)


@pytest.fixture(scope="module")
def fault_free(data, jax_data):
    """A query's fault-free rows, equal in both packages with equal
    counters; each query run once a module (ask before injecting)."""
    out = {}

    def rows_of(q):
        if q not in out:
            rows, stats, _ = run_port(data, q)
            jrows, jm = run_jax(jax_data, q)
            assert rows == jrows
            assert counters(stats) == counters(None, jm)
            out[q] = rows
        return out[q]

    return rows_of


# -------------------------------------------------- the registry alone


def test_spec_parse_format_roundtrip_equals_the_reference():
    spec = "shuffle.fetch@2,task.compute@1@a0,shuffle.write@1@a0@slow250,kernel.dispatch@3@oom," \
           "shuffle.write@2@corrupt,spill.write@1@enospc,worker.task@2@kill"
    rules = faults.parse_spec(spec)
    assert rules == jfaults.parse_spec(spec)
    assert rules[:3] == [("shuffle.fetch", 2, None, None, False), ("task.compute", 1, 0, None, False),
                         ("shuffle.write", 1, 0, 250, False)]
    assert faults.format_spec(rules) == jfaults.format_spec(rules) == spec
    assert faults.parse_spec("shuffle.write@1@slow250@a0") == [("shuffle.write", 1, 0, 250, False)]
    assert faults.SITES == jfaults.SITES
    for bad, match in (("bogus.site@1", "unknown fault site"), ("task.compute", "bad fault spec"),
                       ("task.compute@1@x3", "bad modifier"), ("task.compute@1@slow5@slow6", "duplicate slow"),
                       ("task.compute@1@oom@corrupt", "conflicting kind"), ("task.compute@1@oom@slow5", "exclusive")):
        for package in (faults, jfaults):
            with pytest.raises(ValueError, match=match):
                package.parse_spec(bad)
    # a kill is armed in a worker process only (test_torch_worker.py): a driver refuses it
    with pytest.raises(ValueError, match="worker process"):
        faults.FaultInjector(faults.parse_spec("worker.task@2@kill"))


@pytest.mark.parametrize("kw", [{}, {"n_stragglers": 2}, {"n_faults": 6, "n_ooms": 2, "horizon": 4},
                                {"first_attempt_only": False, "n_stragglers": 3, "straggler_ms": (300, 800)}])
def test_random_spec_equals_the_reference(kw):
    specs = [faults.random_spec(seed, **kw) for seed in range(12)]
    assert specs == [jfaults.random_spec(seed, **kw) for seed in range(12)]
    assert len(set(specs)) > 1
    for spec in specs:
        for site, _, attempt, slow_ms, kind in faults.parse_spec(spec):
            assert site in faults.SITES
            assert attempt == (0 if kw.get("first_attempt_only", True) and slow_ms is None and kind is False
                               else None)


def test_straggler_rule_sleeps_instead_of_raising_and_wakes_when_cancelled():
    inj = faults.FaultInjector(faults.parse_spec("task.compute@1@a0@slow80,task.compute@2@slow5000"))
    t0 = time.monotonic()
    inj.hit("task.compute", attempt=0)  # the matching hit sleeps, no raise
    assert time.monotonic() - t0 >= 0.07
    cancel = threading.Event()
    threading.Timer(0.05, cancel.set).start()
    t0 = time.monotonic()
    inj.hit("task.compute", attempt=0, cancel=cancel)  # hit 2 wakes with its task's cancel
    assert time.monotonic() - t0 < 2.0
    t0 = time.monotonic()
    inj.hit("task.compute", attempt=0)  # hit 3: no rule
    # attempt-gated: a backup attempt never pays it
    faults.FaultInjector(faults.parse_spec("task.compute@1@a0@slow80")).hit("task.compute", attempt=100)
    assert time.monotonic() - t0 < 0.05


def test_injector_nth_hit_and_attempt_gate():
    for package in (faults, jfaults):
        inj = package.FaultInjector(package.parse_spec("task.compute@3@a0"))
        inj.hit("task.compute", attempt=0)
        inj.hit("task.compute", attempt=0)
        with pytest.raises(package.InjectedFault, match="hit 3"):
            inj.hit("task.compute", attempt=0)
        inj.hit("task.compute", attempt=1)  # single-fire
        inj2 = package.FaultInjector(package.parse_spec("task.compute@1@a0"))
        inj2.hit("task.compute", attempt=1)  # hit 1, another attempt: no raise
        inj2.hit("task.compute", attempt=0)  # hit 2: the rule has passed
        inj3 = package.FaultInjector(package.parse_spec("shuffle.write@2@corrupt"))
        inj3.hit("shuffle.write")  # the raising probe counts apart
        assert [inj3.corrupt("shuffle.write") for _ in range(3)] == [False, True, False]
    inj = faults.FaultInjector(faults.parse_spec("shuffle.fetch@1,spill.write@1@enospc,kernel.dispatch@1@oom"))
    with pytest.raises(retry.FetchFailedError) as e:
        inj.hit("shuffle.fetch", detail="shuffle_4")
    assert e.value.injected and e.value.shuffle_id == 4 and e.value.map_ids is None
    with pytest.raises(OSError) as e:
        inj.hit("spill.write")
    assert e.value.errno == 28
    with pytest.raises(faults.InjectedOom, match="RESOURCE_EXHAUSTED"):
        inj.hit("kernel.dispatch")


def _shared_classes():
    """(the port's instance, the reference's) of every class both have."""
    return [
        (retry.FetchFailedError("shuffle_3", 0), jretry.FetchFailedError("shuffle_3", 0)),
        (retry.TaskTimeoutError("t"), jretry.TaskTimeoutError("t")),
        (retry.TaskWedgedError("w"), jretry.TaskWedgedError("w")),
        (retry.TaskRetriesExhausted(1, 2, 3, ValueError()), jretry.TaskRetriesExhausted(1, 2, 3, ValueError())),
        (TaskCancelled(), JTaskCancelled()),
        (integrity.BlockCorruptionError("s"), JBlockCorruption("s")),
        (faults.InjectedFault("task.compute", 1), jfaults.InjectedFault("task.compute", 1)),
        (faults.InjectedOom("kernel.dispatch", 1), jfaults.InjectedOom("kernel.dispatch", 1)),
        (faults.InjectedDiskFull("spill.write", 1), jfaults.InjectedDiskFull("spill.write", 1)),
        (RuntimeError("x"), RuntimeError("x")), (ValueError("x"), ValueError("x")), (OSError(5, "x"), OSError(5, "x")),
        (AssertionError(), AssertionError()), (NotImplementedError(), NotImplementedError()),
        (KeyboardInterrupt(), KeyboardInterrupt()), (MemoryError(), MemoryError()),
    ]


def test_classify_and_backoff_equal_the_reference():
    for port_exc, jax_exc in _shared_classes():
        assert retry.classify(port_exc) == jretry.classify(jax_exc), type(port_exc).__name__
    assert retry.classify(retry.FetchFailedError("shuffle_3", 0)) == retry.FETCH_FAILED
    assert retry.classify(integrity.BlockCorruptionError("s")) == retry.RETRY
    from blaze_tpu_torch.io.zstd import ZstdDictionaryError

    # a frame that needs a dictionary the port does not have fails alike every time
    assert retry.classify(ZstdDictionaryError("frame needs dictionary 7")) == retry.FATAL
    for base in (0.0, 0.05, 0.1, 1.0):
        p, jp = retry.RetryPolicy(backoff_base=base), jretry.RetryPolicy(backoff_base=base)
        grid = [(s, t, a) for s in range(4) for t in (-1, 0, 1, 7) for a in range(6)]
        assert [p.backoff(*g) for g in grid] == [jp.backoff(*g) for g in grid]
    p = retry.RetryPolicy()
    assert p.backoff(1, 2, 1) != p.backoff(1, 2, 0) and p.backoff(1, 2, 0) == p.backoff(1, 2, 0)
    assert retry.FetchFailedError("shuffle_7", 1).shuffle_id == 7
    assert retry.FetchFailedError("broadcast_7", 1).shuffle_id is None


# -------------------------------------------------- the reader's failures

SCHEMA = TSchema([TF("x", TT.int64())])


def test_ipc_reader_missing_block_raises_fetch_failed():
    RESOURCES.put("shuffle_9.0", [("/nonexistent/shuffle_9_2.data", 0, 128)])
    with pytest.raises(retry.FetchFailedError) as e:
        list(IpcReaderExec(SCHEMA, "shuffle_9", 1, "cpu").execute(0, TaskContext(0, 1)))
    assert e.value.shuffle_id == 9 and e.value.map_ids == [2]
    assert isinstance(e.value.__cause__, OSError)


def test_ipc_reader_corrupt_payload_raises_fetch_failed():
    """A frame whose bytes survive the frame read but not the decode is
    bad producer bytes too: a fetch failure, not a retry."""
    import struct

    garbage = b"\x99" * 32
    RESOURCES.put("shuffle_11.0", [struct.pack("<IB", len(garbage), 0) + garbage])
    reader = IpcReaderExec(SCHEMA, "shuffle_11", 1, "cpu")
    with pytest.raises(retry.FetchFailedError) as e:
        list(reader.execute(0, TaskContext(0, 1)))
    assert e.value.shuffle_id == 11 and e.value.map_ids is None
    assert retry.classify(e.value) == retry.FETCH_FAILED
    assert "corruption_detected" not in reader.metrics.values


# ------------------------------------------- the scheduler's recoveries


@pytest.mark.parametrize("spec,moved", [
    ("task.compute@2@a0", {"task_retries": 1}),
    ("shuffle.fetch@1@a0", {"fetch_failures": 1, "map_stage_reruns": 1}),
    ("shuffle.write@1", {"task_retries": 1}),
])
def test_recovers_like_the_reference(data, jax_data, fault_free, spec, moved):
    want = fault_free("q6")
    _inject(spec)
    rows, stats, left = run_port(data, "q6")
    _inject(spec)
    jrows, jm = run_jax(jax_data, "q6")
    assert rows == jrows == want
    assert counters(stats) == counters(None, jm)
    assert {c: getattr(stats, c) for c in moved} == moved
    assert not [f for f in left if "inprogress" in f]  # a failed commit left no temporary file
    if spec.startswith("shuffle.fetch"):
        assert stats.map_tasks_rerun == N_PARTS == jm.get("map_tasks_rerun")  # no map ids: the whole stage


def test_exhausted_retries_name_the_stage_task_attempts_and_site(data, jax_data):
    spec = "task.compute@1@a0,task.compute@2@a1,task.compute@3@a2"
    errs = []
    for run, data_of in ((run_port, data), (run_jax, jax_data)):
        _inject(spec)
        with pytest.raises(RuntimeError) as e:
            run(data_of, "q6", max_task_attempts=3)
        errs.append(e.value)
    assert isinstance(errs[0], retry.TaskRetriesExhausted)
    assert str(errs[0]) == str(errs[1])
    assert "stage 0" in str(errs[0]) and "task 0" in str(errs[0]) and "3 attempt" in str(errs[0])
    assert "task.compute" in str(errs[0]) and isinstance(errs[0].__cause__, faults.InjectedFault)


def _range_plans(n=900):
    """A hash exchange, then a range exchange on its output, then a sort
    of each partition, in both packages: the boundary pass reads the
    first shuffle."""
    x = np.random.default_rng(7).integers(-10**6, 10**6, n)
    table = {"x": (x, None, None)}
    jschema = JSchema([JF("x", JT.int64())])
    tscan = MemoryScanExec(TB.table_to_batches(table, SCHEMA, 3, 200, "cpu"), SCHEMA, device="cpu")
    jscan = JScan(jax_table_to_batches(table, jschema, 3, batch_rows=200), jschema)
    hashed = ProjectExec(NativeShuffleExchangeExec(tscan, HashPartitioning([col("x")], 3)), [col("x")], ["x"])
    jhashed = JProject(JExchange(jscan, JHash([jcol("x")], 3)), [jcol("x")], ["x"])
    port = SortExec(NativeShuffleExchangeExec(hashed, RangePartitioning([SortField(col("x"))], 3)),
                    [SortField(col("x"))])
    ref = JSort(JExchange(jhashed, JRange([JSortField(jcol("x"))], 3)), [JSortField(jcol("x"))])
    return port, ref, sorted(x.tolist())


def test_range_boundary_pass_recovers_from_fetch_failure():
    """The first fetch is the boundary pass's: it regenerates the hash
    exchange's map stage, as a task's would, and the query goes on."""
    got = {}
    for spec in ("", "shuffle.fetch@1@a0"):
        _inject(spec)
        port, ref, want = _range_plans()
        stats = S.RunStats()
        stages, manager = S.split_stages(port)
        rows = _rows(S.run_stages(stages, manager, stats), TB.batch_to_pydict)
        jstages, jmanager = JS.split_stages(ref)
        m = MetricNode()
        jrows = _rows(JS.run_stages(jstages, jmanager, metrics=m), jax_to_pydict)
        assert rows["x"] == jrows["x"] == want
        assert counters(stats) == counters(None, m.metrics)
        got[spec] = stats
    assert got["shuffle.fetch@1@a0"].fetch_failures == 1 and got["shuffle.fetch@1@a0"].map_stage_reruns == 1
    assert got[""].fetch_failures == 0


def test_a_partial_rerun_counts_its_tasks_and_reads_once():
    """The range stage's map 1 (the fifth commit, after the hash stage's
    three and map 0) gets a flipped byte: only map 1 re-runs, reading
    the hash shuffle's partition 1 again.  ``tasks`` and ``read_rows``
    stay the fault-free run's; the re-run counts in ``map_tasks_rerun``."""
    got = {}
    for spec in ("", "shuffle.write@5@corrupt"):
        _inject(spec)
        port, _, want = _range_plans()
        stats = S.RunStats()
        stages, manager = S.split_stages(port)
        assert _rows(S.run_stages(stages, manager, stats), TB.batch_to_pydict)["x"] == want
        got[spec] = stats
    clean, hit = got[""], got["shuffle.write@5@corrupt"]
    assert (hit.fetch_failures, hit.map_stage_reruns, hit.map_tasks_rerun) == (1, 1, 1)
    assert hit.tasks == clean.tasks == 9
    # each run numbers its shuffles anew
    assert list(hit.read_rows.values()) == list(clean.read_rows.values())
    assert sum(hit.read_rows[stages[0].shuffle_id]) == 900


def test_unresolvable_fetch_failure_falls_back_to_a_plain_retry(data, jax_data, fault_free, monkeypatch):
    """A fetch failure whose producer is no stage of the run (here a
    broadcast q06 does not have) costs a plain retry instead."""
    want = fault_free("q6")
    for package, run, data_of in ((from_proto, run_port, data), (jax_from_proto, run_jax, jax_data)):
        real, fails = package.run_task, [1]

        error = retry.FetchFailedError if package is from_proto else jretry.FetchFailedError

        def flaky(td, real=real, fails=fails, error=error, **kw):
            if fails[0]:
                fails[0] -= 1
                raise error("broadcast_987654", 0)
            return real(td, **kw)

        monkeypatch.setattr(package, "run_task", flaky)
        rows, stats = run(data_of, "q6")[:2]
        assert rows == want and fails == [0]
        got = tuple(stats.get(c) for c in COUNTERS) if package is jax_from_proto else counters(stats)
        assert got[1:] == (1, 1, 0)  # one retry, one fetch failure, no stage re-run


def test_task_timeout_is_retried(data, jax_data, fault_free, monkeypatch):
    """The deadline is checked between a task's batches: the result task
    (the fourth run_task after 3 map tasks), dragged past it, is retried
    before its first batch reaches the caller."""
    want = fault_free("q6")
    for package, run, data_of, c in ((from_proto, run_port, data, conf), (jax_from_proto, run_jax, jax_data, jconf)):
        c.TASK_TIMEOUT.set(0.2)
        real, state = package.run_task, {"calls": 0, "dragged": 0}

        def slow(td, real=real, state=state, **kw):
            gen = real(td, **kw)
            state["calls"] += 1
            if state["calls"] != N_PARTS + 1:
                return gen
            state["dragged"] += 1

            def dragging():
                for b in gen:
                    time.sleep(0.3)
                    yield b

            return dragging()

        monkeypatch.setattr(package, "run_task", slow)
        rows, stats = run(data_of, "q6")[:2]
        assert rows == want and state["dragged"] == 1
        timeouts = stats.get("task_timeouts") if package is jax_from_proto else stats.task_timeouts
        assert timeouts == 1


def test_shuffle_write_fault_commits_nothing(tmp_path):
    """A failed map attempt leaves neither ``.data`` nor ``.index``."""
    scan = MemoryScanExec([[TB.batch_from_pydict({"x": list(range(64))}, SCHEMA, device="cpu")]], SCHEMA, device="cpu")
    manager = LocalShuffleManager(str(tmp_path))
    data_p, index_p = manager.map_output_paths(0, 0)
    _inject("shuffle.write@1")
    with pytest.raises(faults.InjectedFault):
        list(ShuffleWriterExec(scan, SinglePartitioning(), data_p, index_p).execute(0, TaskContext(0, 1)))
    assert os.listdir(tmp_path) == []
    with pytest.raises(retry.FetchFailedError) as e:
        manager.reduce_blocks(0, 1, 0)  # stricter than the reference, which skips it
    assert e.value.map_ids == [0]
    _inject("")
    list(ShuffleWriterExec(scan, SinglePartitioning(), data_p, index_p).execute(0, TaskContext(0, 1)))
    assert os.path.exists(data_p) and os.path.exists(index_p)
    assert manager.invalidate(0) == 2 and os.listdir(tmp_path) == []


def test_tpch_q1_bit_identical_under_the_fault_matrix(data, jax_data, fault_free):
    """The reference's slow matrix (``test_tpch_q1_bit_identical_under_
    fault_matrix``), here at SF 0.002: q01's rows and the four counters
    equal the reference's under each spec."""
    want = fault_free("q1")
    for spec, moved in (("shuffle.fetch@1@a0", ("fetch_failures", "map_stage_reruns")),
                        ("task.compute@2@a0", ("task_retries",)), ("shuffle.write@1", ("task_retries",))):
        _inject(spec)
        rows, stats, _ = run_port(data, "q1")
        _inject(spec)
        jrows, jm = run_jax(jax_data, "q1")
        assert rows == jrows == want, spec
        assert counters(stats) == counters(None, jm), spec
        assert all(getattr(stats, c) >= 1 for c in moved), spec
