"""TPC-H q16, q17, q21 and q22 through the port and the JAX package,
against the numpy oracles.

The tables come from ``generate_all`` with ``with_spec_columns``
(dbgen's p_name, c_phone, o_custkey and l_suppkey), fed to both packages; two
partitions, in process.  Each query equals the reference's rows and
the oracle on a nonempty result, and the port's oracles equal the
reference's.  q16 (a LEFT_ANTI join of a host LIKE-filtered supplier,
``distinct_rows``), q21 (distinct supplier counts joined three ways)
and q22 (``substring``, an avg as a decimal scalar subquery, a
LEFT_ANTI join) at SF 0.002; q17 (an avg joined back and compared as
doubles) at SF 0.01, since at SF 0.002 no part passes its filter.  The
reference's q22 is run with its plan cache off (reference defect 9,
pinned in ``test_torch_tpch_q8_q15.py``).
"""

import pytest

from blaze_tpu import conf as jax_conf
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
def sf0002():
    return with_spec_columns(generate_all(0.002), 0.002)


@pytest.fixture(scope="module")
def sf001():
    return with_spec_columns(generate_all(0.01), 0.01)


@pytest.fixture
def reference_without_plan_cache():
    prev = jax_conf.CACHE_PLAN_ENABLED.get()
    jax_conf.CACHE_PLAN_ENABLED.set(False)
    yield
    jax_conf.CACHE_PLAN_ENABLED.set(prev)


def test_q16_equals_reference_and_oracle(sf0002):
    got, want, exp = _both(sf0002, "q16")
    assert got == want
    assert {(b, t, s): c for b, t, s, c in zip(got["p_brand"], got["p_type"], got["p_size"],
                                                got["supplier_cnt"])} == exp and len(exp) > 20
    assert got["supplier_cnt"] == sorted(got["supplier_cnt"], reverse=True)


def test_q17_equals_reference_and_oracle(sf001):
    got, want, exp = _both(sf001, "q17")
    assert got == want
    assert exp > 0 and abs(got["avg_yearly"][0] - exp) / exp < 1e-9


def test_q21_equals_reference_and_oracle(sf0002):
    got, want, exp = _both(sf0002, "q21")
    assert got == want
    assert dict(zip(got["s_name"], got["numwait"])) == exp and sum(exp.values()) > 0


def test_q22_equals_reference_and_oracle(sf0002, reference_without_plan_cache):
    got, want, exp = _both(sf0002, "q22")
    assert got == want
    assert got["cntrycode"] == sorted(exp) and len(exp) >= 3
    for i, c in enumerate(got["cntrycode"]):
        assert [got["numcust"][i], got["totacctbal"][i]] == exp[c]


@pytest.mark.parametrize("q", ['q16', 'q21', 'q22'])
def test_query_reaches_every_kernel_wrapper(sf0002, monkeypatch, q):
    """Each query's hash exchanges hash int or date keys through
    murmur3_pids and count through pid_histogram, and its joins probe
    through sorted_lookup."""
    calls = _wrapper_calls(sf0002, q, monkeypatch)
    assert all(calls.values()), calls

def test_q17_reaches_every_kernel_wrapper(sf001, monkeypatch):
    calls = _wrapper_calls(sf001, "q17", monkeypatch)
    assert all(calls.values()), calls
