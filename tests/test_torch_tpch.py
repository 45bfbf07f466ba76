"""The port's TPC-H slice against the JAX package and the numpy oracles.

Both packages generate SF 0.002 from one seed; the port's generator
must give the same arrays.  q01, q06 and q03 run end to end through
each package's plan builders and ``plan.execute(partition,
TaskContext)`` over every partition, with two partitions.  The port
probes its joins through ``sorted_lookup`` always (on the CPU its plain
version); q03 is held against the reference with its join-probe knob
off (XLA searchsorted) and on (the Pallas kernel in interpret mode).
q01, q06 and the q03 (orderkey, revenue) rows compare exactly; q03 row
order is checked as descending revenue, as ``tests/test_tpch.py`` does.
"""

import numpy as np
import pytest
import torch

import blaze_tpu_torch
from blaze_tpu import conf as jax_conf
from blaze_tpu.batch import batch_to_pydict as jax_to_pydict
from blaze_tpu.kernels import pallas_ops
from blaze_tpu.ops import MemoryScanExec as JaxScan
from blaze_tpu.runtime.context import TaskContext as JaxContext
from blaze_tpu.tpch import TPCH_SCHEMAS as JAX_SCHEMAS
from blaze_tpu.tpch import build_query as jax_build_query
from blaze_tpu.tpch import oracle as jax_oracle
from blaze_tpu.tpch.datagen import generate_all as jax_generate_all
from blaze_tpu.tpch.datagen import table_to_batches as jax_table_to_batches

from blaze_tpu_torch.batch import batch_to_pydict, table_to_batches
from blaze_tpu_torch.kernels import cuda_ops
from blaze_tpu_torch.ops import MemoryScanExec
from blaze_tpu_torch.runtime.context import TaskContext
from blaze_tpu_torch.tpch import TPCH_SCHEMAS, build_query
from blaze_tpu_torch.tpch import oracle as O
from blaze_tpu_torch.tpch.datagen import generate_all

SCALE = 0.002
N_PARTS = 2


@pytest.fixture(scope="module")
def data():
    return generate_all(SCALE)


@pytest.fixture(scope="module")
def jax_data():
    return jax_generate_all(SCALE)


def _scans(data):
    return {
        name: MemoryScanExec(
            table_to_batches(data[name], TPCH_SCHEMAS[name], N_PARTS, batch_rows=4096, device="cpu"),
            TPCH_SCHEMAS[name], device="cpu")
        for name in TPCH_SCHEMAS
    }


def _run(plan, to_pydict, context):
    out = {f.name: [] for f in plan.schema.fields}
    for p in range(plan.num_partitions()):
        for b in plan.execute(p, context(p, plan.num_partitions())):
            d = to_pydict(b)
            for k in out:
                out[k].extend(d[k])
    return out


def _jax_run(jax_data, q):
    scans = {
        name: JaxScan(jax_table_to_batches(jax_data[name], JAX_SCHEMAS[name], N_PARTS, batch_rows=4096),
                      JAX_SCHEMAS[name])
        for name in JAX_SCHEMAS
    }
    return _run(jax_build_query(q, scans, N_PARTS), jax_to_pydict, JaxContext)


@pytest.fixture(scope="module")
def jax_results(jax_data):
    return {q: _jax_run(jax_data, q) for q in ("q1", "q3", "q6")}


@pytest.fixture(scope="module")
def jax_q3_pallas_probe(jax_data):
    """The reference's q03 with its join-probe knob on: the Pallas
    sorted_lookup kernel, in interpret mode on the CPU."""
    pallas_ops.force_interpret(True)
    jax_conf.PALLAS_JOIN_PROBE.set(True)
    try:
        return _jax_run(jax_data, "q3")
    finally:
        jax_conf.PALLAS_JOIN_PROBE.set(False)
        pallas_ops.force_interpret(False)


def test_datagen_equals_reference(data, jax_data):
    assert data.keys() == jax_data.keys()
    for name in data:
        assert data[name].keys() == jax_data[name].keys(), name
        for c in data[name]:
            for a, b in zip(data[name][c], jax_data[name][c]):
                if a is None or b is None:
                    assert a is b, (name, c)
                else:
                    np.testing.assert_array_equal(a, b, err_msg=f"{name}.{c}")


def test_datagen_column_subset_is_a_projection():
    full = generate_all(SCALE)["lineitem"]
    from blaze_tpu_torch.tpch.datagen import generate_table

    sub = generate_table("lineitem", SCALE, columns={"l_orderkey", "l_shipmode"})
    assert set(sub) == {"l_orderkey", "l_shipmode"}
    for c in sub:
        np.testing.assert_array_equal(sub[c][0], full[c][0])


def test_q6_equals_reference_and_oracle(data, jax_results):
    got = _run(build_query("q6", _scans(data), N_PARTS), batch_to_pydict, TaskContext)
    assert got == jax_results["q6"]
    assert got["revenue"] == [O.oracle_q6(data)]


def test_q1_equals_reference_and_oracle(data, jax_data, jax_results):
    """String group keys through the grouped agg, the 2-way hash
    exchange and the final sort; wide decimal sums and HALF_UP avgs."""
    got = _run(build_query("q1", _scans(data), N_PARTS), batch_to_pydict, TaskContext)
    assert got == jax_results["q1"]
    exp = O.oracle_q1(data)
    assert exp == jax_oracle.oracle_q1(jax_data)
    keys = list(zip(got["l_returnflag"], got["l_linestatus"]))
    assert keys == sorted(exp) and len(keys) > 1
    for i, key in enumerate(keys):
        assert {m: got[m][i] for m in exp[key]} == exp[key], key


@pytest.mark.parametrize("probe_kernel", [False, True], ids=["probe-plain", "probe-kernel"])
def test_q3_equals_reference_and_oracle(data, jax_data, jax_results, jax_q3_pallas_probe, probe_kernel):
    """The port's one probe route against both of the reference's:
    XLA searchsorted (knob off) and the Pallas kernel (knob on)."""
    got = _run(build_query("q3", _scans(data), N_PARTS), batch_to_pydict, TaskContext)
    want = jax_q3_pallas_probe if probe_kernel else jax_results["q3"]
    rows = list(zip(got["l_orderkey"], got["revenue"], got["o_orderdate"], got["o_shippriority"]))
    exp = O.oracle_q3(data)
    assert exp == jax_oracle.oracle_q3(jax_data)
    assert len(rows) == len(exp) == len(want["l_orderkey"]) == 10
    # ties on equal revenue and date may break differently
    assert {(r[0], r[1]) for r in rows} == {(r[0], r[1]) for r in exp}
    assert {(r[0], r[1]) for r in rows} == set(zip(want["l_orderkey"], want["revenue"]))
    assert [r[1] for r in rows] == sorted([r[1] for r in rows], reverse=True)


def _count_wrapper_calls(monkeypatch, names):
    calls = dict.fromkeys(names, 0)
    for name in names:
        real = getattr(cuda_ops, name)

        def counting(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(cuda_ops, name, counting)
    return calls


def test_q3_reaches_both_kernel_wrappers(data, monkeypatch):
    """The q03 path calls murmur3_pids and pid_histogram (its hash
    exchanges) and, with no knob set, sorted_lookup (its two joins)."""
    calls = _count_wrapper_calls(monkeypatch, ("murmur3_pids", "pid_histogram", "sorted_lookup"))
    cuda_ops.reset_launch_counts()
    _run(build_query("q3", _scans(data), N_PARTS), batch_to_pydict, TaskContext)
    assert all(k > 0 for k in calls.values()), calls
    assert set(cuda_ops.LAUNCHES.values()) == {0}  # CPU: plain versions


def test_q1_reaches_pid_histogram_wrapper(data, monkeypatch):
    """q01's string-keyed exchange counts its rows through
    pid_histogram; its pids take the plain murmur3 path (string keys,
    as the reference routes them), so murmur3_pids is never called."""
    calls = _count_wrapper_calls(monkeypatch, ("murmur3_pids", "pid_histogram"))
    cuda_ops.reset_launch_counts()
    _run(build_query("q1", _scans(data), N_PARTS), batch_to_pydict, TaskContext)
    assert calls["pid_histogram"] > 0 and calls["murmur3_pids"] == 0, calls
    assert set(cuda_ops.LAUNCHES.values()) == {0}


def test_probe_counts_takes_the_plain_lookup_on_the_cpu(monkeypatch):
    """One probe route: sorted_lookup, whose CPU tensors run
    sorted_lookup_plain; the sentinel probe has no candidates."""
    from blaze_tpu_torch.ops.joins.core import SENTINEL, probe_counts

    calls = _count_wrapper_calls(monkeypatch, ("sorted_lookup_plain",))
    table = torch.tensor([3, 3, 9, -5, SENTINEL], dtype=torch.int64)  # unsigned order
    lo, counts = probe_counts(table, torch.tensor([3, 4, -5, SENTINEL], dtype=torch.int64))
    assert calls["sorted_lookup_plain"] == 1
    assert lo.tolist() == [0, 2, 3, 4] and counts.tolist() == [2, 0, 1, 0]


def test_default_device_is_the_card():
    """No CPU fallback: without a card, the default device raises."""
    if torch.cuda.is_available():
        assert blaze_tpu_torch.resolve_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        blaze_tpu_torch.resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        MemoryScanExec([], TPCH_SCHEMAS["region"])
    assert blaze_tpu_torch.resolve_device("cpu").type == "cpu"
