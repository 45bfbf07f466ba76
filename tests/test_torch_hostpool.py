"""The port's worker pool against the JAX package's, with real workers on
the CPU (``HostPool(..., device="cpu")``).

The reference's two-stage revenue plan (``tests/test_hostpool.py``: a
parquet scan, a filter, a projection and a partial sum, a
single-partition exchange, the final sum) runs over three small
parquet files, one map task each, through both packages'
``run_stages``.  Through a pool of two workers the map outputs are the
workers' (``owned_map_outputs() == 3``) and the rows equal the
reference's in-process ``run_stages`` and the port's; a memory-scan
plan cannot ship and runs in process; ``worker.task@2@kill`` with
``maxFailures=1`` gives the reference test's own numbers (2 workers
lost, 2 map stage re-runs of one task each, both slots blacklisted,
the pool degraded) and the same rows.  TPC-H q03 at SF 0.002 from
parquet through the pool equals the port's in-process run, its oracle
and the reference's.

No test waits on a clock a loaded machine can miss: each pool is
waited on until its workers are ready, liveness is set explicitly, and
no timing is asserted.  After every test ``RESOURCES`` is empty, no
``.inprogress`` file is left, and no worker outlives its pool.
"""

import os

import numpy as np
import pytest

from blaze_tpu.batch import batch_from_pydict as jax_from_pydict
from blaze_tpu.batch import batch_to_pydict as jax_to_pydict
from blaze_tpu.ops import MemoryScanExec as JScan
from blaze_tpu.ops import ParquetScanExec as JParquetScan
from blaze_tpu.parallel.shuffle import LocalShuffleManager as JManager
from blaze_tpu.runtime.scheduler import run_stages as jax_run_stages
from blaze_tpu.runtime.scheduler import split_stages as jax_split_stages
from blaze_tpu.schema import DataType as JT, Field as JF, Schema as JSchema
from blaze_tpu.spark import BlazeSparkSession
from blaze_tpu.tpch import oracle as jax_oracle
from blaze_tpu.tpch.datagen import generate_all as jax_generate_all

import spark_fixtures as F

import blaze_tpu_torch
from blaze_tpu_torch import conf
from blaze_tpu_torch.batch import batch_from_pydict, batch_to_pydict
from blaze_tpu_torch.exprs import col, lit
from blaze_tpu_torch.io import parquet
from blaze_tpu_torch.io.table_files import write_table_files
from blaze_tpu_torch.ops import AggExec, AggFunction, AggMode, FilterExec, MemoryScanExec, ParquetScanExec, ProjectExec
from blaze_tpu_torch.ops.fusion import optimize_plan
from blaze_tpu_torch.parallel.exchange import NativeShuffleExchangeExec
from blaze_tpu_torch.parallel.shuffle import LocalShuffleManager, SinglePartitioning
from blaze_tpu_torch.runtime import faults
from blaze_tpu_torch.runtime.context import RESOURCES, TaskContext
from blaze_tpu_torch.runtime.hostpool import HostPool
from blaze_tpu_torch.runtime.scheduler import RunStats, run_stages, split_stages
from blaze_tpu_torch.schema import DataType, Field, Schema
from blaze_tpu_torch.tpch import TPCH_SCHEMAS, build_query
from blaze_tpu_torch.tpch import oracle as O
from blaze_tpu_torch.tpch.datagen import generate_all

NAMES = ("l_quantity", "l_extendedprice", "l_discount")
SCHEMA = Schema([Field(n, DataType.int64()) for n in NAMES])
JAX_SCHEMA = JSchema([JF(n, JT.int64()) for n in NAMES])
Q3_SCALE, Q3_PARTS, Q3_BATCH_ROWS = 0.002, 2, 4096


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


@pytest.fixture(scope="module")
def pool(_on_cpu):
    """One pool of two CPU workers for the healthy-path tests, ready
    before any test uses it; no worker is alive after it."""
    conf.POOL_LIVENESS_TIMEOUT_MS.set(60000)
    p = HostPool(2, device="cpu", env={"BLAZE_BATCHSIZE": str(Q3_BATCH_ROWS)})
    try:
        assert p.wait_ready()
        yield p
    finally:
        p.close()
        conf.POOL_LIVENESS_TIMEOUT_MS.set(conf.POOL_LIVENESS_TIMEOUT_MS.default)
    assert live_children() == []


@pytest.fixture(autouse=True)
def _clean(tmp_path, _on_cpu):
    conf.FAULTS_SPEC.set("")
    conf.TASK_RETRY_BACKOFF.set(0.0)
    faults.reset()
    before = set(live_children())
    yield
    conf.TASK_RETRY_BACKOFF.set(0.1)
    conf.HOST_BLACKLIST_MAX_FAILURES.set(2)
    assert len(RESOURCES) == 0, RESOURCES.keys()
    assert inprogress_files(tmp_path) == []
    assert set(live_children()) <= before


@pytest.fixture(scope="module")
def revenue_files(tmp_path_factory):
    """The reference test's three files of 120 rows (its seed), by the
    port's writer; returns (paths, the rows)."""
    root = tmp_path_factory.mktemp("revenue")
    rng = np.random.RandomState(7)
    files, data = [], {n: [] for n in NAMES}
    for i in range(3):
        d = {"l_quantity": rng.randint(1, 50, 120), "l_extendedprice": rng.randint(100, 10000, 120),
             "l_discount": rng.randint(0, 10, 120)}
        path = str(root / f"lineitem_{i}.parquet")
        parquet.write_parquet(path, SCHEMA, {n: (d[n].astype(np.int64), None, None) for n in NAMES})
        files.append(path)
        for n in NAMES:
            data[n].extend(int(v) for v in d[n])
    return files, data


def revenue_plan(scan):
    """The reference's plan, of the port's operators."""
    f = FilterExec(scan, (col("l_quantity") < lit(24)) & (col("l_discount") >= lit(5)))
    pr = ProjectExec(f, [col("l_extendedprice") * col("l_discount")], ["rev"])
    partial = AggExec(pr, AggMode.PARTIAL, [], [AggFunction("sum", col("rev"), "s")])
    ex = NativeShuffleExchangeExec(partial, SinglePartitioning())
    final = AggExec(ex, AggMode.FINAL, [], [AggFunction("sum", col("rev"), "s")])
    return ProjectExec(final, [col("s")], ["revenue"])


def jax_revenue_plan(scan):
    """The reference test's ``_two_stage_plan`` over ``scan``."""
    sess = BlazeSparkSession()
    sess.register_table("lineitem", scan)
    s = F.scan("lineitem", [F.attr("l_quantity", 1), F.attr("l_extendedprice", 2), F.attr("l_discount", 3)])
    f = F.filter_(F.binop("And", F.binop("LessThan", F.attr("l_quantity", 1), F.lit(24, "long")),
                          F.binop("GreaterThanOrEqual", F.attr("l_discount", 3), F.lit(5, "long"))), s)
    pr = F.project([F.alias(F.binop("Multiply", F.attr("l_extendedprice", 2), F.attr("l_discount", 3)), "rev", 10)],
                   f)
    partial = F.hash_agg([], [F.agg_expr(F.sum_(F.attr("rev", 10)), "Partial", 20)], pr)
    ex = F.shuffle(F.single_partition(), partial)
    final = F.hash_agg([], [F.agg_expr(F.sum_(F.attr("rev", 10)), "Final", 20)], ex,
                       result=[F.alias(F.attr("s", 20), "revenue", 21)])
    return sess.plan(F.flatten(final))


def values(batches, to_pydict):
    out = []
    for b in batches:
        d = to_pydict(b)
        out.extend(zip(*[d[k] for k in sorted(d)]))
    return sorted(out)


def run_port(plan, root, pool=None, stats=None):
    stages, manager = split_stages(plan, LocalShuffleManager(str(root)))
    rows = values(run_stages(stages, manager, stats, pool=pool), batch_to_pydict)
    assert not os.path.exists(manager.root)
    return rows


def run_jax(plan, root):
    stages, manager = jax_split_stages(plan, JManager(str(root)))
    return values(jax_run_stages(stages, manager), jax_to_pydict)


@pytest.fixture(scope="module")
def expected(revenue_files, tmp_path_factory):
    """The reference's in-process run_stages of the files, which numpy
    agrees with."""
    files, data = revenue_files
    rows = run_jax(jax_revenue_plan(JParquetScan([[f] for f in files], JAX_SCHEMA)),
                   tmp_path_factory.mktemp("jax"))
    q, p, d = (np.array(data[n]) for n in NAMES)
    assert rows == [(int((p * d)[(q < 24) & (d >= 5)].sum()),)]
    return rows


def test_memory_scan_plans_run_in_process(pool, tmp_path):
    """A memory scan stages driver resources no worker can read: its map
    tasks run in process, one attempt each, and nothing is pool-owned."""
    d = {"l_quantity": [1, 30], "l_extendedprice": [10, 20], "l_discount": [7, 8]}
    scan = MemoryScanExec([[batch_from_pydict(d, SCHEMA, device="cpu")]], SCHEMA, device="cpu")
    owned = pool.owned_map_outputs()  # 0 when this test runs first, as in file order
    stats = RunStats()
    got = run_port(revenue_plan(scan), tmp_path / "pool", pool, stats)
    assert pool.owned_map_outputs() == owned
    assert stats.task_attempts == stats.tasks == 2
    assert got == run_port(revenue_plan(scan), tmp_path / "local") == [(70,)]
    assert got == run_jax(jax_revenue_plan(JScan([[jax_from_pydict(d, JAX_SCHEMA)]], JAX_SCHEMA)), tmp_path / "jax")


def test_two_workers_host_the_map_stage(pool, revenue_files, expected, tmp_path):
    """The map stage's three tasks run on the two workers, round robin,
    and commit into the shared root; the rows equal the reference's and
    the port's in-process runs."""
    files, _ = revenue_files
    owned = pool.owned_map_outputs()
    jobs = {r["worker"]: r["jobs_ok"] for r in pool.worker_telemetry()}
    stats = RunStats()
    got = run_port(revenue_plan(ParquetScanExec([[f] for f in files], SCHEMA)), tmp_path / "pool", pool, stats)
    assert pool.owned_map_outputs() - owned == 3
    assert pool.blacklisted() == [] and not pool.degraded()
    assert sorted(pool.heartbeat_ages()) == ["w0", "w1"] and min(pool.heartbeat_ages().values()) >= 0
    assert stats.worker_lost == stats.task_retries == 0 and stats.tasks == 4
    assert got == expected
    assert got == run_port(revenue_plan(ParquetScanExec([[f] for f in files], SCHEMA)), tmp_path / "local")
    ran = sorted(r["jobs_ok"] - jobs[r["worker"]] for r in pool.worker_telemetry())
    assert ran == [1, 2]  # round robin over the two


def test_q03_from_parquet_through_the_pool(pool, tmp_path):
    """TPC-H q03 at SF 0.002 from gzip parquet: its eligible map stages
    (those that read no broadcast) run on the workers; the rows equal
    the port's in-process run of the same files and its oracle, which
    equals the reference's oracle."""
    data = generate_all(Q3_SCALE)
    files = {name: write_table_files(data[name], schema, str(tmp_path / name), Q3_PARTS, Q3_BATCH_ROWS)
             for name, schema in TPCH_SCHEMAS.items() if name in ("lineitem", "orders", "customer")}

    def scans():
        return {name: ParquetScanExec(groups, TPCH_SCHEMAS[name]) for name, groups in files.items()}

    conf.BATCH_SIZE.set(Q3_BATCH_ROWS)
    try:
        owned = pool.owned_map_outputs()
        stats = RunStats()
        stages, manager = split_stages(build_query("q3", scans(), Q3_PARTS), LocalShuffleManager(str(tmp_path / "s")))
        eligible = sum(s.n_tasks for s in stages if s.kind == "map" and not any(
            r.resource_id.startswith("broadcast_") for r in _readers(s.plan)))
        got = {}
        for b in run_stages(stages, manager, stats, pool=pool):
            for k, v in batch_to_pydict(b).items():
                got.setdefault(k, []).extend(v)
        assert pool.owned_map_outputs() - owned == eligible > 0
        assert stats.worker_lost == stats.task_retries == 0
        plan = optimize_plan(build_query("q3", scans(), Q3_PARTS))
        local = {}
        for p in range(plan.num_partitions()):
            for b in plan.execute(p, TaskContext(p, plan.num_partitions())):
                for k, v in batch_to_pydict(b).items():
                    local.setdefault(k, []).extend(v)
    finally:
        conf.BATCH_SIZE.set(conf.BATCH_SIZE.default)
    assert got == local
    exp = O.oracle_q3(data)
    assert exp == jax_oracle.oracle_q3(jax_generate_all(Q3_SCALE)) and len(exp) == 10
    assert {(r[0], r[1]) for r in exp} == set(zip(got["l_orderkey"], got["revenue"]))


def _readers(plan):
    from blaze_tpu_torch.runtime.scheduler import ipc_readers

    return ipc_readers(plan, "")


def test_a_killed_worker_reruns_its_outputs_blacklists_and_degrades(revenue_files, expected, tmp_path):
    """``worker.task@2@kill``: each worker dies as its second job starts,
    owning one committed map output; that output alone re-runs (a
    partial re-run), the slot blacklists at ``maxFailures=1``, and with
    both slots gone the pool degrades to in-process runs.  The numbers
    are the reference test's on the same plan."""
    files, _ = revenue_files
    conf.HOST_BLACKLIST_MAX_FAILURES.set(1)
    conf.POOL_LIVENESS_TIMEOUT_MS.set(60000)
    stats = RunStats()
    try:
        with HostPool(2, device="cpu", env={"BLAZE_FAULTS_SPEC": "worker.task@2@kill"}) as pool:
            assert pool.wait_ready()
            pids = [r["pid"] for r in pool.worker_telemetry()]
            got = run_port(revenue_plan(ParquetScanExec([[f] for f in files], SCHEMA)), tmp_path / "kill", pool,
                           stats)
            assert pool.blacklisted() == ["w0", "w1"]
            assert pool.degraded()
            assert pool.stats()["workers_blacklisted"] == 2 and pool.stats()["live"] == 0
    finally:
        conf.POOL_LIVENESS_TIMEOUT_MS.set(conf.POOL_LIVENESS_TIMEOUT_MS.default)
    assert got == expected
    assert stats.worker_lost == 2
    assert stats.map_stage_reruns == 2 and stats.map_tasks_rerun == 2
    for pid in pids:
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)
