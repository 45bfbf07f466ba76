"""TPC-H q02 and q18 through the port and the JAX package, against the
numpy oracles.  Both sort with ``fetch=100``.  q02 (``min`` of a decimal
joined back on the part) runs at SF 0.01, since at SF 0.002 it selects
no row; q18 (a decimal sum compared with ``lit(300, decimal(22,2))``)
at SF 0.05, since at SF 0.002 and 0.01 no order passes it.

The tables come from ``generate_all`` with ``with_spec_columns``
(dbgen's p_name, c_phone, o_custkey and l_suppkey), fed to both packages; two
partitions, in process.  Each query equals the reference's rows and
the oracle on a nonempty result, and the port's oracles equal the
reference's.
"""

import pytest

from blaze_tpu.batch import batch_to_pydict as jax_to_pydict
from blaze_tpu.ops import MemoryScanExec as JaxScan
from blaze_tpu.runtime.context import TaskContext as JaxContext
from blaze_tpu.tpch import TPCH_SCHEMAS as JAX_SCHEMAS
from blaze_tpu.tpch import build_query as jax_build_query
from blaze_tpu.tpch import oracle as jax_oracle
from blaze_tpu.tpch.datagen import table_to_batches as jax_table_to_batches

from blaze_tpu_torch.batch import batch_to_pydict, table_to_batches
from blaze_tpu_torch.kernels import cuda_ops
from blaze_tpu_torch.ops import MemoryScanExec
from blaze_tpu_torch.runtime.context import TaskContext
from blaze_tpu_torch.tpch import TPCH_SCHEMAS, build_query
from blaze_tpu_torch.tpch import oracle as O
from blaze_tpu_torch.tpch.datagen import generate_all, with_spec_columns

N_PARTS = 2


def _run(plan, to_pydict, context):
    out = {f.name: [] for f in plan.schema.fields}
    for p in range(plan.num_partitions()):
        for b in plan.execute(p, context(p, plan.num_partitions())):
            for k, v in to_pydict(b).items():
                out[k].extend(v)
    return out


def _port(data, q):
    scans = {name: MemoryScanExec(table_to_batches(data[name], TPCH_SCHEMAS[name], N_PARTS, 4096, device="cpu"),
                                  TPCH_SCHEMAS[name], device="cpu") for name in TPCH_SCHEMAS}
    return _run(build_query(q, scans, N_PARTS), batch_to_pydict, TaskContext)


def _reference(data, q):
    scans = {name: JaxScan(jax_table_to_batches(data[name], JAX_SCHEMAS[name], N_PARTS, batch_rows=4096),
                           JAX_SCHEMAS[name]) for name in JAX_SCHEMAS}
    return _run(jax_build_query(q, scans, N_PARTS), jax_to_pydict, JaxContext)


def _both(data, q):
    """(port rows, reference rows, the port's oracle), the port's oracle
    equal to the reference's."""
    got, want = _port(data, q), _reference(data, q)
    exp = getattr(O, f"oracle_{q}")(data)
    assert exp == getattr(jax_oracle, f"oracle_{q}")(data)
    return got, want, exp


KERNELS = ("murmur3_pids", "pid_histogram", "sorted_lookup")


def _wrapper_calls(data, q, monkeypatch):
    """How often each kernel wrapper ran in one in-process run (its
    plain version, on the CPU); no launch is counted."""
    calls = dict.fromkeys(KERNELS, 0)
    for name in KERNELS:
        real = getattr(cuda_ops, name)
        monkeypatch.setattr(cuda_ops, name, lambda *a, _r=real, _n=name, **kw: (
            calls.__setitem__(_n, calls[_n] + 1), _r(*a, **kw))[1])
    cuda_ops.reset_launch_counts()
    _port(data, q)
    assert set(cuda_ops.LAUNCHES.values()) == {0}
    return calls


@pytest.fixture(scope="module")
def sf001():
    return with_spec_columns(generate_all(0.01), 0.01)


@pytest.fixture(scope="module")
def sf005():
    return with_spec_columns(generate_all(0.05), 0.05)


def test_q18_equals_reference_and_oracle(sf005):
    got, want, exp = _both(sf005, "q18")
    assert got == want
    rows = list(zip(got["c_name"], got["c_custkey"], got["o_orderkey"], got["o_orderdate"],
                    got["o_totalprice"], got["qsum"]))
    # no two big orders tie on (o_totalprice, o_orderdate): the order is total
    assert len({(r[4], r[3]) for r in rows}) == len(rows)
    assert rows == exp and len(rows) >= 2


def test_q18_reaches_every_kernel_wrapper(sf005, monkeypatch):
    calls = _wrapper_calls(sf005, "q18", monkeypatch)
    assert all(calls.values()), calls


def test_q2_equals_reference_and_oracle(sf001):
    got, want, exp = _both(sf001, "q2")
    assert got == want
    rows = list(zip(got["s_acctbal"], got["s_name"], got["n_name"], got["p_partkey"], got["p_mfgr"]))
    # (s_acctbal desc, n_name, s_name, p_partkey) orders the rows totally
    assert rows == exp and len(rows) > 3
    assert set(got["n_name"]) <= {"FRANCE", "GERMANY", "ROMANIA", "RUSSIA", "UNITED KINGDOM"}


def test_q2_reaches_every_kernel_wrapper(sf001, monkeypatch):
    calls = _wrapper_calls(sf001, "q2", monkeypatch)
    assert all(calls.values()), calls
