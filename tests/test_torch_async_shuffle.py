"""The port's shuffle-write pipeline: the async stager
(``parallel/shuffle.py`` ``_AsyncInserter``), parallel map tasks
(``parallel/exchange.py`` ``warm_then_map``, ``runtime/scheduler.py``
under ``spark.blaze.stage.taskConcurrency``) and the state they share.

(c) A shuffle's ``.data``/``.index`` bytes are the same with the stager
on and off, at 1 and 4 map tasks at a time, fused (tier 5) or not.
(d) A staging error surfaces at the next ``put`` or at ``close``; a
failing or cancelled map task commits no file.  (e) ``run_stages`` with
4 tasks at a time equals the numpy oracle on q01, q03, q05 and q21, its
tasks really overlapping, and leaves ``RESOURCES`` empty.  Then 8
threads at once hammer the launch counts, the copy counts, the
``pid_histogram`` ticket and SM-count caches and ``RESOURCES``.
"""

import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

import blaze_tpu_torch
from blaze_tpu_torch import batch as TB
from blaze_tpu_torch import conf
from blaze_tpu_torch.exprs.ir import col, lit
from blaze_tpu_torch.kernels import cuda_ops
from blaze_tpu_torch.ops import FilterExec, MemoryScanExec, ProjectExec
from blaze_tpu_torch.ops.fusion import optimize_plan
from blaze_tpu_torch.parallel import shuffle as SH
from blaze_tpu_torch.parallel.exchange import NativeShuffleExchangeExec, warm_then_map
from blaze_tpu_torch.parallel.shuffle import HashPartitioning, LocalShuffleManager
from blaze_tpu_torch.runtime import scheduler as S
from blaze_tpu_torch.runtime.context import RESOURCES, ResourcesMap, TaskContext
from blaze_tpu_torch.runtime.metrics import MetricsSet
from blaze_tpu_torch.schema import DataType, Field, Schema
from blaze_tpu_torch.tpch import TPCH_SCHEMAS, build_query
from blaze_tpu_torch.tpch.datagen import generate_all, with_spec_columns

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402  (its oracle checks, run here on CPU rows)

N_MAPS = 6
N_OUT = 4
SCHEMA = Schema([Field("k", DataType.int64()), Field("s", DataType.string(16)), Field("f", DataType.float64())])


@pytest.fixture(autouse=True)
def on_cpu():
    prev = blaze_tpu_torch._default_device
    blaze_tpu_torch.set_default_device("cpu")
    yield
    blaze_tpu_torch.set_default_device(prev)


@pytest.fixture
def settings():
    """Restores the pipeline's conf after a test."""
    keys = (conf.SHUFFLE_ASYNC_WRITE, conf.SHUFFLE_ASYNC_QUEUE_DEPTH, conf.STAGE_TASK_CONCURRENCY,
            conf.FUSION_ENABLE, conf.EXCHANGE_IN_PROCESS)
    saved = [k.get() for k in keys]
    yield
    for k, v in zip(keys, saved):
        k.set(v)


def _scan(seed=3):
    g = np.random.default_rng(seed)
    n = 5000
    words = [b"alpha", b"be", b"gamma-ray", b"", b"delta"]
    s = [words[j] for j in g.integers(0, len(words), n)]
    data = np.zeros((n, 16), np.uint8)
    for r, b in enumerate(s):
        data[r, :len(b)] = np.frombuffer(b, np.uint8)
    table = {"k": (g.integers(-(2**40), 2**40, n), None, g.random(n) > 0.05),
             "s": (data, np.array([len(b) for b in s], np.int32)),
             "f": (g.standard_normal(n), None, g.random(n) > 0.1)}
    return MemoryScanExec(TB.table_to_batches(table, SCHEMA, N_MAPS, 300, "cpu"), SCHEMA, device="cpu")


def _chain(scan):
    f = FilterExec(scan, col("f") > lit(-0.5))
    return ProjectExec(f, [col("k"), col("s"), (col("f") * lit(2.0)).alias("f2")], ["k", "s", "f2"])


def _files(tmp_path, name, fuse):
    """Every map output of the chain's shuffle through files, as bytes."""
    mgr = LocalShuffleManager(str(tmp_path / name))
    child = _chain(_scan())
    out = []
    for m in range(N_MAPS):
        writer = mgr.map_writer(child, HashPartitioning([col("k"), col("s")], N_OUT), 0, m)
        if fuse:
            optimize_plan(writer)
        list(writer.execute(m, TaskContext(m, N_MAPS)))
        for path in mgr.map_output_paths(0, m):
            with open(path, "rb") as f:
                out.append(f.read())
    mgr.cleanup()
    return out


@pytest.mark.parametrize("fuse", [False, True])
@pytest.mark.parametrize("depth", [1, 2, 5])
def test_stager_on_and_off_write_the_same_bytes(tmp_path, settings, fuse, depth):
    conf.SHUFFLE_ASYNC_WRITE.set(False)
    sync = _files(tmp_path, "sync", fuse)
    conf.SHUFFLE_ASYNC_WRITE.set(True)
    conf.SHUFFLE_ASYNC_QUEUE_DEPTH.set(depth)
    assert _files(tmp_path, "async", fuse) == sync
    # fused or not, the same bytes (tier 5 keeps them)
    assert sync == _files(tmp_path, "other", not fuse)


def _exchange_files(tmp_path, parallel):
    """The exchange's own map outputs through files, as bytes."""
    ex = NativeShuffleExchangeExec(_chain(_scan()), HashPartitioning([col("k")], N_OUT), parallel)
    mgr = ex._write_map_outputs(TaskContext(0, N_OUT))
    out = []
    for m in range(N_MAPS):
        for path in mgr.map_output_paths(ex.shuffle_id, m):
            with open(path, "rb") as f:
                out.append(f.read())
    mgr.cleanup()
    return out


def _exchange_rows(parallel):
    ex = NativeShuffleExchangeExec(_chain(_scan()), HashPartitioning([col("k")], N_OUT), parallel)
    return [TB.batch_to_pydict(b) for p in range(N_OUT) for b in ex.execute(p, TaskContext(p, N_OUT))]


@pytest.mark.parametrize("stager", [False, True])
def test_one_or_four_map_tasks_write_the_same_bytes(tmp_path, settings, stager):
    conf.SHUFFLE_ASYNC_WRITE.set(stager)
    one = _exchange_files(tmp_path, 1)
    assert _exchange_files(tmp_path, 4) == one and len(one) == 2 * N_MAPS


def test_one_or_four_map_tasks_give_the_same_rows_in_process():
    assert _exchange_rows(4) == _exchange_rows(1)


def test_warm_then_map_runs_task_0_first_and_keeps_order():
    seen = []

    def fn(t):
        seen.append((t, threading.current_thread().name))
        time.sleep(0.01 * (5 - t % 5))
        return t * t

    assert warm_then_map(fn, 9, 4) == [t * t for t in range(9)]
    assert seen[0] == (0, threading.current_thread().name)
    assert {name for t, name in seen[1:]} <= {f"map-task_{i}" for i in range(4)}


# --------------------------------------------------- (d) staging errors


class _Copy:
    def __init__(self, fail=False):
        self.fail = fail

    def result(self):
        if self.fail:
            raise ValueError("staging failed")
        return [np.zeros(2, np.int64), np.ones(2, np.bool_)]


def test_a_staging_error_surfaces_at_put_or_close():
    rep = SH.ShuffleRepartitioner(1)
    ins = SH._AsyncInserter(rep, 2, MetricsSet())
    ins.put((_Copy(fail=True), [False], 2, [2]))
    deadline = time.time() + 10
    with pytest.raises(ValueError, match="staging failed"):
        while time.time() < deadline:  # the stager takes it in its own time
            ins.put((_Copy(), [False], 2, [2]))
            time.sleep(0.01)
    with pytest.raises(ValueError, match="staging failed"):
        ins.close()
    assert not ins._thread.is_alive()
    rep2 = SH.ShuffleRepartitioner(1)
    ins2 = SH._AsyncInserter(rep2, 1, MetricsSet())
    ins2.put((_Copy(fail=True), [False], 2, [2]))
    with pytest.raises(ValueError, match="staging failed"):
        ins2.close()


def test_abort_drops_what_is_queued():
    rep = SH.ShuffleRepartitioner(1)
    gate, entered = threading.Event(), threading.Event()

    class Slow(_Copy):
        def result(self):
            entered.set()
            gate.wait(10)
            return super().result()

    ins = SH._AsyncInserter(rep, 4, MetricsSet())
    ins.put((Slow(), [False], 2, [2]))
    for _ in range(3):
        ins.put((_Copy(), [False], 2, [2]))
    # abort only once the stager holds the first batch: a batch it never
    # started is dropped, and the first one is then staged
    assert entered.wait(10)
    threading.Timer(0.1, gate.set).start()  # the stager is held in the first batch's copy
    ins.abort()
    assert not ins._thread.is_alive() and sum(len(b) for b in rep._buffers) == 1


def _no_files(tmp_path):
    return [p for p in os.listdir(tmp_path) if p.startswith("shuffle_")]


@pytest.mark.parametrize("fuse", [False, True])
def test_a_failed_staging_commits_no_file(tmp_path, settings, monkeypatch, fuse):
    conf.SHUFFLE_ASYNC_WRITE.set(True)
    mgr = LocalShuffleManager(str(tmp_path))
    writer = mgr.map_writer(_chain(_scan()), HashPartitioning([col("k")], N_OUT), 0, 0)
    if fuse:
        optimize_plan(writer)
    calls = []

    def failing(self):
        calls.append(1)
        if len(calls) == 3:
            raise OSError("host copy failed")
        return real(self)

    real = TB.HostCopy.result
    monkeypatch.setattr(TB.HostCopy, "result", failing)
    with pytest.raises(OSError, match="host copy failed"):
        list(writer.execute(0, TaskContext(0, N_MAPS)))
    assert _no_files(tmp_path) == []
    assert not [t for t in threading.enumerate() if t.name == "shuffle-async-insert"]


@pytest.mark.parametrize("stager", [False, True])
def test_a_failing_or_cancelled_map_task_commits_no_file(tmp_path, settings, stager):
    conf.SHUFFLE_ASYNC_WRITE.set(stager)
    mgr = LocalShuffleManager(str(tmp_path))

    class Boom(FilterExec):
        def execute(self, partition, ctx):
            for i, b in enumerate(super().execute(partition, ctx)):
                if i == 1:
                    raise RuntimeError("child failed")
                yield b

    writer = mgr.map_writer(Boom(_scan(), col("f") > lit(-9.0)), HashPartitioning([col("k")], N_OUT), 0, 0)
    with pytest.raises(RuntimeError, match="child failed"):
        list(writer.execute(0, TaskContext(0, N_MAPS)))
    ctx = TaskContext(0, N_MAPS)
    ctx.cancel()
    list(mgr.map_writer(_scan(), HashPartitioning([col("k")], N_OUT), 0, 1).execute(0, ctx))
    assert _no_files(tmp_path) == []
    assert not [t for t in threading.enumerate() if t.name == "shuffle-async-insert"]


# ------------------------------------------- (e) run_stages, 4 at a time

SCALE = 0.002


@pytest.fixture(scope="module")
def tpch():
    return with_spec_columns(generate_all(SCALE), SCALE)


@pytest.mark.parametrize("q", ["q1", "q3", "q5", "q21"])
def test_run_stages_four_tasks_at_a_time_equals_the_oracle(tpch, settings, monkeypatch, q):
    conf.STAGE_TASK_CONCURRENCY.set(4)
    from blaze_tpu_torch.serde import from_proto

    running, most = [0], [0]
    lock = threading.Lock()
    real = from_proto.run_task

    def run_task(td, *a, **kw):
        for b in real(td, *a, **kw):
            with lock:
                running[0] += 1
                most[0] = max(most[0], running[0])
            time.sleep(0.002)
            with lock:
                running[0] -= 1
            yield b
        with lock:
            running[0] += 1
            most[0] = max(most[0], running[0])
        time.sleep(0.02)  # a map task's end: hold it, so tasks overlap
        with lock:
            running[0] -= 1

    monkeypatch.setattr(from_proto, "run_task", run_task)
    scans = {k: MemoryScanExec(TB.table_to_batches(tpch[k], TPCH_SCHEMAS[k], 4, 4096, "cpu"), TPCH_SCHEMAS[k],
                               device="cpu") for k in TPCH_SCHEMAS}
    stages, manager = S.split_stages(build_query(q, scans, 4))
    batches = list(S.run_stages(stages, manager))
    got = {f.name: [] for f in stages[-1].plan.schema.fields}
    for b in batches:
        for k, v in TB.batch_to_pydict(b).items():
            got[k].extend(v)
    chip_smoke.check_oracle(tpch, q, got)
    assert most[0] > 1, "no two tasks ran at once"
    assert len(RESOURCES) == 0 and not os.path.exists(manager.root)


# ------------------------------------------------- 8 threads at once


def _hammer(fn, threads=8):
    """``fn(t)`` on ``threads`` threads at once, the interpreter switching
    threads every microsecond so that an unlocked read-modify-write
    loses updates; raises the first error."""
    start = threading.Barrier(threads)
    errs = []

    def run(t):
        try:
            start.wait()
            fn(t)
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errs.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=run, args=(t,)) for t in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in ts)
    if errs:
        raise errs[0]


def test_launch_counts_from_8_threads():
    cuda_ops.reset_launch_counts()
    _hammer(lambda t: [cuda_ops.count_launch(("murmur3_pids", "pid_histogram")[t % 2]) for _ in range(20000)])
    assert cuda_ops.LAUNCHES == {"murmur3_pids": 80000, "sorted_lookup": 0, "pid_histogram": 80000,
                                 "fused_group_sums": 0}
    cuda_ops.reset_launch_counts()


def test_copy_counts_from_8_threads():
    TB.reset_copy_counts()
    x = torch.arange(10)
    _hammer(lambda t: [TB.tensors_to_host([x]) if i % 100 == 0 else TB.count_copy("host_to_device")
                       for i in range(5000)])
    assert TB.COPIES == {"device_to_host": 8 * 50, "host_to_device": 8 * 4950}
    TB.reset_copy_counts()


def test_ticket_and_sm_count_caches_from_8_threads(monkeypatch):
    """Each (device, stream) gets ONE ticket set and each device ONE SM
    count, however many map tasks ask at once (the creation is slowed
    to widen the window in which two could race)."""
    made, props = [], []
    real_zeros = torch.zeros

    def zeros(n, dtype=None, device=None):
        made.append(n)
        time.sleep(0.002)
        return real_zeros(n, dtype=dtype)

    class Props:
        multi_processor_count = 132

    def get_props(i):
        props.append(i)
        time.sleep(0.002)
        return Props()

    monkeypatch.setattr(torch, "zeros", zeros)
    monkeypatch.setattr(torch.cuda, "get_device_properties", get_props)
    monkeypatch.setattr(cuda_ops, "_tickets", {})
    monkeypatch.setattr(cuda_ops, "_sm_counts", {})

    class Stream:
        def __init__(self, s):
            self.cuda_stream = s

    dev = torch.device("cuda", 0)
    got = [[] for _ in range(8)]

    def ask(t):
        for i in range(50):
            got[t].append(cuda_ops._zeroed_tickets(dev, Stream(i % 2), 8))
            assert cuda_ops._sm_count(dev) == 132

    _hammer(ask)
    assert len(made) == 2 and props == [0]
    for i in range(50):
        assert len({id(g[i]) for g in got}) == 1


def test_resources_from_8_threads():
    res = ResourcesMap()

    def churn(t):
        for i in range(2000):
            res.put(f"k{t}.{i}", i)
            assert res.get(f"k{t}.{i}") == i
            res.put(f"d{t}.{i}", i)
            res.discard(f"d{t}.{i}")

    _hammer(churn)
    assert len(res) == 0
