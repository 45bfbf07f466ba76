"""The port's TPC-H slice against the JAX package and the numpy oracles.

Both packages generate SF 0.002 from one seed; the port's generator
must give the same arrays.  q06 and q03 run end to end through each
package's plan builders and ``plan.execute(partition, TaskContext)``
over every partition, with two partitions; the port runs q03 with the
join-probe kernel off and on (on the CPU its plain version).  q06 and
the q03 (orderkey, revenue) rows compare exactly; q03 row order is
checked as descending revenue, as ``tests/test_tpch.py`` does.
"""

import numpy as np
import pytest

import blaze_tpu_torch
from blaze_tpu.batch import batch_to_pydict as jax_to_pydict
from blaze_tpu.ops import MemoryScanExec as JaxScan
from blaze_tpu.runtime.context import TaskContext as JaxContext
from blaze_tpu.tpch import TPCH_SCHEMAS as JAX_SCHEMAS
from blaze_tpu.tpch import build_query as jax_build_query
from blaze_tpu.tpch import oracle as jax_oracle
from blaze_tpu.tpch.datagen import generate_all as jax_generate_all
from blaze_tpu.tpch.datagen import table_to_batches as jax_table_to_batches

from blaze_tpu_torch import conf
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


@pytest.fixture(scope="module")
def jax_results(jax_data):
    scans = {
        name: JaxScan(jax_table_to_batches(jax_data[name], JAX_SCHEMAS[name], N_PARTS, batch_rows=4096),
                      JAX_SCHEMAS[name])
        for name in JAX_SCHEMAS
    }
    return {q: _run(jax_build_query(q, scans, N_PARTS), jax_to_pydict, JaxContext) for q in ("q3", "q6")}


@pytest.fixture
def join_probe():
    def set_(on: bool):
        conf.PALLAS_JOIN_PROBE.set(on)

    yield set_
    conf.PALLAS_JOIN_PROBE.set(False)


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


@pytest.mark.parametrize("probe_kernel", [False, True], ids=["probe-plain", "probe-kernel"])
def test_q3_equals_reference_and_oracle(data, jax_data, jax_results, join_probe, probe_kernel):
    join_probe(probe_kernel)
    got = _run(build_query("q3", _scans(data), N_PARTS), batch_to_pydict, TaskContext)
    want = jax_results["q3"]
    rows = list(zip(got["l_orderkey"], got["revenue"], got["o_orderdate"], got["o_shippriority"]))
    exp = O.oracle_q3(data)
    assert exp == jax_oracle.oracle_q3(jax_data)
    assert len(rows) == len(exp) == len(want["l_orderkey"]) == 10
    # ties on equal revenue and date may break differently
    assert {(r[0], r[1]) for r in rows} == {(r[0], r[1]) for r in exp}
    assert {(r[0], r[1]) for r in rows} == set(zip(want["l_orderkey"], want["revenue"]))
    assert [r[1] for r in rows] == sorted([r[1] for r in rows], reverse=True)


def test_q3_reaches_both_kernel_wrappers(data, join_probe, monkeypatch):
    """The q03 path calls murmur3_pids (its hash exchanges) and, with
    the join probe on, sorted_lookup (its two joins)."""
    calls = {"murmur3_pids": 0, "sorted_lookup": 0}
    for name in calls:
        real = getattr(cuda_ops, name)

        def counting(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(cuda_ops, name, counting)
    join_probe(True)
    _run(build_query("q3", _scans(data), N_PARTS), batch_to_pydict, TaskContext)
    assert calls["murmur3_pids"] > 0 and calls["sorted_lookup"] > 0
    assert cuda_ops.LAUNCHES == {"murmur3_pids": 0, "sorted_lookup": 0}  # CPU: plain versions


def test_default_device_is_the_card():
    """No CPU fallback: without a card, the default device raises."""
    import torch

    if torch.cuda.is_available():
        assert blaze_tpu_torch.resolve_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        blaze_tpu_torch.resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        MemoryScanExec([], TPCH_SCHEMAS["region"])
    assert blaze_tpu_torch.resolve_device("cpu").type == "cpu"
