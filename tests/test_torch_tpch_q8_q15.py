"""TPC-H q08, q11, q13 and q15 through the port and the JAX package,
against the numpy oracles.

The tables come from ``generate_all`` with ``with_spec_columns``
(dbgen's p_name, c_phone, o_custkey and l_suppkey), fed to both packages; two
partitions, in process.  Each query equals the reference's rows and
the oracle on a nonempty result, and the port's oracles equal the
reference's.  q11 (a decimal cast and a double scalar subquery), q13
(a LEFT outer join and ``count`` of the nullable side, the host LIKE
'%special%requests%' negated) and q15 (``max`` as a decimal scalar
subquery) at SF 0.002; q08 (a CASE over a string, decimal sums cast to
double and divided, within 1e-9, the reference tests' tolerance) at SF
0.02, the first of SF 0.002, 0.01 and 0.02 where BRAZIL's share is
not 0.

The reference's plan cache turns literals into slots that scale a
scalar subquery's decimal again, so in process its q15 and q22 select
no row (ROADMAP queue C, reference defect 9): q15 is compared with the
reference run with ``spark.blaze.cache.plan.enabled`` off, and the
defect is pinned with it on.
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
def sf002():
    return with_spec_columns(generate_all(0.02), 0.02)


@pytest.fixture
def reference_without_plan_cache():
    prev = jax_conf.CACHE_PLAN_ENABLED.get()
    jax_conf.CACHE_PLAN_ENABLED.set(False)
    yield
    jax_conf.CACHE_PLAN_ENABLED.set(prev)


def test_q8_equals_reference_and_oracle(sf002):
    got, want, exp = _both(sf002, "q8")
    assert got == want
    assert got["o_year"] == sorted(exp) == [1995, 1996]
    for y, share in zip(got["o_year"], got["mkt_share"]):
        assert abs(share - exp[y]) < 1e-9
    assert max(got["mkt_share"]) > 0


def test_q11_equals_reference_and_oracle(sf0002):
    got, want, exp = _both(sf0002, "q11")
    assert got == want
    assert dict(zip(got["ps_partkey"], got["value"])) == exp and len(exp) > 20
    assert got["value"] == sorted(got["value"], reverse=True)


def test_q13_equals_reference_and_oracle(sf0002):
    got, want, exp = _both(sf0002, "q13")
    assert got == want
    assert dict(zip(got["c_count"], got["custdist"])) == exp
    # a third of the customers have no order: the outer join's null side counts 0
    assert exp[0] > 50
    rows = list(zip(got["custdist"], got["c_count"]))
    assert rows == sorted(rows, reverse=True)


def test_q15_equals_reference_and_oracle(sf0002, reference_without_plan_cache):
    got, want, exp = _both(sf0002, "q15")
    assert got == want
    assert list(zip(got["s_suppkey"], got["s_name"], got["total_revenue"])) == exp and len(exp) == 1


@pytest.mark.parametrize("q", ["q15", "q22"])
def test_reference_plan_cache_scales_a_decimal_subquery_twice(sf0002, q):
    """Reference defect 9: with the plan cache on (its default),
    ``slotify_literals`` multiplies the ``_RawUnscaled`` value of a
    decimal scalar subquery by 10^scale again, so q15's ``= max`` and
    q22's ``> avg`` select no row; the port (tests above) equals the
    oracle."""
    assert jax_conf.CACHE_PLAN_ENABLED.get()
    ref = _reference(sf0002, q)
    assert all(v == [] for v in ref.values())
    assert getattr(O, f"oracle_{q}")(sf0002)


@pytest.mark.parametrize("q", ['q11', 'q13', 'q15'])
def test_query_reaches_every_kernel_wrapper(sf0002, monkeypatch, q):
    """Each query's hash exchanges hash int or date keys through
    murmur3_pids and count through pid_histogram, and its joins probe
    through sorted_lookup."""
    calls = _wrapper_calls(sf0002, q, monkeypatch)
    assert all(calls.values()), calls

@pytest.mark.parametrize("q", ["q8"])
def test_q8_reaches_every_kernel_wrapper(sf002, monkeypatch, q):
    calls = _wrapper_calls(sf002, q, monkeypatch)
    assert all(calls.values()), calls
