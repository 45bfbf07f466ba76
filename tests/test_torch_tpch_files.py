"""TPC-H q01, q03, q06 and q12 (its strings) read from files the port
wrote, on both paths.

The tables at SF 0.002 are written once per module as Parquet (gzip)
and ORC (zlib), one file per partition with row groups of the memory
scan's batch size, so the file scans yield the memory scan's batches.
Each query runs through ``plan.execute`` after the task optimizer
(which narrows the scans at their source) and through
``split_stages``/``run_stages``, whose tasks carry the scan nodes as
TaskDefinition bytes.  Each result equals the port's memory-scan run of
the same query, row for row, and the numpy oracle; the kernel wrappers
are called as often as on the memory scans; ``RESOURCES`` is empty after
each run.  No reference plan runs here: the memory-scan runs are held to
the reference in ``tests/test_torch_tpch*.py``.
"""

import os

import pytest

import blaze_tpu_torch
from blaze_tpu_torch import conf
from blaze_tpu_torch.batch import batch_to_pydict, table_to_batches
from blaze_tpu_torch.io.table_files import write_table_files
from blaze_tpu_torch.kernels import cuda_ops
from blaze_tpu_torch.ops import MemoryScanExec, OrcScanExec, ParquetScanExec
from blaze_tpu_torch.ops.fusion import optimize_plan
from blaze_tpu_torch.runtime.context import RESOURCES, TaskContext
from blaze_tpu_torch.runtime.scheduler import RunStats, run_stages, split_stages
from blaze_tpu_torch.serde import from_proto
from blaze_tpu_torch.tpch import TPCH_SCHEMAS, build_query
from blaze_tpu_torch.tpch import oracle as O
from blaze_tpu_torch.tpch.datagen import generate_all

SCALE = 0.002
N_PARTS = 2
BATCH_ROWS = 4096
QUERIES = ("q1", "q3", "q6", "q12")
WRAPPERS = ("murmur3_pids", "pid_histogram", "sorted_lookup")


@pytest.fixture(autouse=True)
def on_cpu():
    """Decoded scans stage on the default device; file scans emit
    batches of spark.blaze.batchSize rows."""
    prev = blaze_tpu_torch._default_device
    blaze_tpu_torch.set_default_device("cpu")
    conf.BATCH_SIZE.set(BATCH_ROWS)
    yield
    conf.BATCH_SIZE.set(8192)
    blaze_tpu_torch.set_default_device(prev)


@pytest.fixture(scope="module")
def data():
    return generate_all(SCALE)


@pytest.fixture(scope="module")
def files(tmp_path_factory, data):
    root = tmp_path_factory.mktemp("tpch")
    return {fmt: {name: write_table_files(data[name], schema, str(root / fmt / name), N_PARTS, BATCH_ROWS, fmt)
                  for name, schema in TPCH_SCHEMAS.items()}
            for fmt in ("parquet", "orc")}


def _memory_scans(data):
    return {name: MemoryScanExec(table_to_batches(data[name], schema, N_PARTS, BATCH_ROWS, "cpu"), schema, device="cpu")
            for name, schema in TPCH_SCHEMAS.items()}


def _file_scans(files, fmt):
    cls = ParquetScanExec if fmt == "parquet" else OrcScanExec
    return {name: cls(groups, TPCH_SCHEMAS[name]) for name, groups in files[fmt].items()}


def _rows(batches):
    out = {}
    for b in batches:
        for k, v in batch_to_pydict(b).items():
            out.setdefault(k, []).extend(v)
    return out


@pytest.fixture
def wrapper_calls(monkeypatch):
    calls = dict.fromkeys(WRAPPERS, 0)
    for name in WRAPPERS:
        real = getattr(cuda_ops, name)

        def counting(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(cuda_ops, name, counting)
    return calls


def _in_process(scans, q, calls):
    before = dict(calls)
    plan = optimize_plan(build_query(q, scans, N_PARTS))
    rows = _rows(b for p in range(plan.num_partitions()) for b in plan.execute(p, TaskContext(p, plan.num_partitions())))
    assert len(RESOURCES) == 0
    return rows, {k: calls[k] - before[k] for k in calls}


def _scheduled(scans, q, monkeypatch):
    kinds = []
    real = from_proto.plan_from_proto

    def recording(n):
        kinds.append(n.which_oneof("node"))
        return real(n)

    monkeypatch.setattr(from_proto, "plan_from_proto", recording)
    stats = RunStats()
    stages, manager = split_stages(build_query(q, scans, N_PARTS))
    rows = _rows(run_stages(stages, manager, stats))
    monkeypatch.setattr(from_proto, "plan_from_proto", real)
    assert len(RESOURCES) == 0 and not os.path.exists(manager.root)
    assert stats.task_def_bytes > 0
    return rows, kinds


def _check_oracle(data, q, got):
    exp = getattr(O, f"oracle_{q}")(data)
    if q == "q6":
        assert got["revenue"] == [exp] and exp > 0
    elif q == "q1":
        keys = list(zip(got["l_returnflag"], got["l_linestatus"]))
        assert keys == sorted(exp) and len(keys) > 1
        for i, key in enumerate(keys):
            assert {m: got[m][i] for m in exp[key]} == exp[key]
    elif q == "q3":
        assert {(r[0], r[1]) for r in exp} == set(zip(got["l_orderkey"], got["revenue"])) and len(exp) == 10
    else:
        rows = {m: [h, lo] for m, h, lo in zip(got["l_shipmode"], got["high_line_count"], got["low_line_count"])}
        assert rows == exp and got["l_shipmode"] == sorted(exp)


@pytest.fixture(scope="module")
def memory_results(data):
    return {}


@pytest.mark.parametrize("fmt", ["parquet", "orc"])
@pytest.mark.parametrize("q", QUERIES)
def test_query_from_files_equals_memory_scans_and_oracle(data, files, memory_results, wrapper_calls, monkeypatch,
                                                        fmt, q):
    if q not in memory_results:
        memory_results[q] = _in_process(_memory_scans(data), q, wrapper_calls)
    want, want_calls = memory_results[q]
    got, got_calls = _in_process(_file_scans(files, fmt), q, wrapper_calls)
    assert got == want
    assert got_calls == want_calls
    assert (want_calls["pid_histogram"] > 0) == (q != "q6")
    _check_oracle(data, q, got)
    sched, kinds = _scheduled(_file_scans(files, fmt), q, monkeypatch)
    assert sched == want
    assert f"{fmt}_scan" in kinds and "memory_scan" not in kinds
