"""The TPC-H queries that need CASE, IN, LIKE and decimal division,
through the port and the JAX package, against the numpy oracles.

q12 (IN, CASE over a shuffled join) and q14 (LIKE 'PROMO%' in a CASE,
then ``100.00 * sp / sr``, an int128 decimal quotient) run at SF 0.002;
q19 (three IN/AND branches ORed over a broadcast join) at SF 0.01,
since at SF 0.002 no row passes its filter.  Two partitions, in
process; each query equals the reference's rows and the oracle, whose
port copy equals the reference's.
"""

import pytest

from blaze_tpu.batch import batch_to_pydict as jax_to_pydict
from blaze_tpu.ops import MemoryScanExec as JaxScan
from blaze_tpu.runtime.context import TaskContext as JaxContext
from blaze_tpu.tpch import TPCH_SCHEMAS as JAX_SCHEMAS
from blaze_tpu.tpch import build_query as jax_build_query
from blaze_tpu.tpch import oracle as jax_oracle
from blaze_tpu.tpch.datagen import generate_all as jax_generate_all
from blaze_tpu.tpch.datagen import table_to_batches as jax_table_to_batches

from blaze_tpu_torch.batch import batch_to_pydict, table_to_batches
from blaze_tpu_torch.ops import MemoryScanExec
from blaze_tpu_torch.runtime.context import TaskContext
from blaze_tpu_torch.tpch import TPCH_SCHEMAS, build_query
from blaze_tpu_torch.tpch import oracle as O
from blaze_tpu_torch.tpch.datagen import generate_all

N_PARTS = 2


def _run(plan, to_pydict, context):
    out = {f.name: [] for f in plan.schema.fields}
    for p in range(plan.num_partitions()):
        for b in plan.execute(p, context(p, plan.num_partitions())):
            for k, v in to_pydict(b).items():
                out[k].extend(v)
    return out


@pytest.fixture(scope="module")
def sf0002():
    return generate_all(0.002), jax_generate_all(0.002)


@pytest.fixture(scope="module")
def sf001():
    return generate_all(0.01), jax_generate_all(0.01)


def _both(tables, q):
    data, jax_data = tables
    scans = {name: MemoryScanExec(table_to_batches(data[name], TPCH_SCHEMAS[name], N_PARTS, 4096, device="cpu"),
                                  TPCH_SCHEMAS[name], device="cpu") for name in TPCH_SCHEMAS}
    jscans = {name: JaxScan(jax_table_to_batches(jax_data[name], JAX_SCHEMAS[name], N_PARTS, batch_rows=4096),
                            JAX_SCHEMAS[name]) for name in JAX_SCHEMAS}
    got = _run(build_query(q, scans, N_PARTS), batch_to_pydict, TaskContext)
    want = _run(jax_build_query(q, jscans, N_PARTS), jax_to_pydict, JaxContext)
    exp = getattr(O, f"oracle_{q}")(data)
    assert exp == getattr(jax_oracle, f"oracle_{q}")(jax_data)
    return got, want, exp


def test_q12_equals_reference_and_oracle(sf0002):
    got, want, exp = _both(sf0002, "q12")
    assert got == want
    assert got["l_shipmode"] == sorted(exp) == ["MAIL", "SHIP"]
    for i, mode in enumerate(got["l_shipmode"]):
        assert [got["high_line_count"][i], got["low_line_count"][i]] == exp[mode]
    assert min(got["high_line_count"] + got["low_line_count"]) > 0


def test_q14_equals_reference_and_oracle(sf0002):
    """The oracle divides in float64 (its own test allows one unit at
    scale 6); the port's int128 HALF_UP quotient equals the reference's
    exactly and the exact quotient of the oracle's sums."""
    got, want, (pct, sp, sr) = _both(sf0002, "q14")
    assert got == want
    assert len(got["promo_revenue"]) == 1 and 0 < sp < sr
    assert abs(got["promo_revenue"][0] - pct) <= 1
    # 100.00 * sp is scale 6, sr scale 4: the quotient at scale 6 is 10^8 sp / sr, HALF_UP
    assert got["promo_revenue"] == [(2 * 10**8 * sp + sr) // (2 * sr)]


def test_q19_equals_reference_and_oracle(sf001):
    got, want, exp = _both(sf001, "q19")
    assert got == want == {"revenue": [exp]}
    assert exp > 0


@pytest.mark.parametrize("q,kernels", [
    ("q12", {"murmur3_pids", "pid_histogram", "sorted_lookup"}),
    ("q14", {"sorted_lookup"}),
    ("q19", {"sorted_lookup"}),
])
def test_query_reaches_its_kernel_wrappers(sf0002, monkeypatch, q, kernels):
    """q12's shuffled join runs all three wrappers; q14 and q19 probe a
    broadcast join through sorted_lookup, and their one exchange has one
    partition (no pids, no histogram).  On the CPU each wrapper runs its
    plain version and counts no launch."""
    from blaze_tpu_torch.kernels import cuda_ops

    calls = dict.fromkeys(("murmur3_pids", "pid_histogram", "sorted_lookup"), 0)
    for name in calls:
        real = getattr(cuda_ops, name)
        monkeypatch.setattr(cuda_ops, name, lambda *a, _r=real, _n=name, **kw: (
            calls.__setitem__(_n, calls[_n] + 1), _r(*a, **kw))[1])
    cuda_ops.reset_launch_counts()
    data = sf0002[0]
    scans = {name: MemoryScanExec(table_to_batches(data[name], TPCH_SCHEMAS[name], N_PARTS, 4096, device="cpu"),
                                  TPCH_SCHEMAS[name], device="cpu") for name in TPCH_SCHEMAS}
    _run(build_query(q, scans, N_PARTS), batch_to_pydict, TaskContext)
    assert {k for k, v in calls.items() if v} == kernels, calls
    assert set(cuda_ops.LAUNCHES.values()) == {0}
