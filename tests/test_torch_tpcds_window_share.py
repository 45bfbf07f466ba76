"""TPC-DS's window queries through the port, part 1: q12, q20 and q98
(an item's share of its class, a whole-partition ``sum``).

Both packages generate SF 0.002 from one seed, two partitions.  Each
query (a) equals the reference's rows in process (``plan.execute`` of
the unoptimized plans; integers, decimals and ranks exactly, float64
within 1e-9 relative: the reference's XLA rounds ``x * 100 / y`` an ulp
apart) and (b) equals the port's oracle, on a nonempty result, in
process through the task optimizer (as ``run_task`` runs a plan: the
window fused over a ``BufferPartitionExec``) and through
``split_stages``/``run_stages`` (every task from TaskDefinition bytes,
hash exchanges through ``.data``/``.index`` files), both paths giving
the same rows and leaving ``RESOURCES`` empty.  The other window
queries are in ``test_torch_tpcds_window_*.py``; the helpers here serve
them all, and the rollup and union family's files
(``test_torch_tpcds_rollup_*.py``, ``test_torch_tpcds_union_*.py``).
"""

import math

import pytest

from blaze_tpu import conf as jax_conf
from blaze_tpu.batch import batch_to_pydict as jax_to_pydict
from blaze_tpu.ops import MemoryScanExec as JaxScan
from blaze_tpu.runtime.context import TaskContext as JaxContext
from blaze_tpu.tpcds import TPCDS_SCHEMAS as JAX_SCHEMAS
from blaze_tpu.tpcds import build_query as jax_build_query
from blaze_tpu.tpch.datagen import table_to_batches as jax_table_to_batches

import blaze_tpu_torch
from blaze_tpu_torch.batch import batch_to_pydict, table_to_batches
from blaze_tpu_torch.ops import MemoryScanExec
from blaze_tpu_torch.ops.fusion import optimize_plan
from blaze_tpu_torch.runtime.context import RESOURCES, TaskContext
from blaze_tpu_torch.runtime.scheduler import run_stages, split_stages
from blaze_tpu_torch.tpcds import TPCDS_SCHEMAS, build_query, generate_all
from blaze_tpu_torch.tpcds import oracle as O

SCALE = 0.002
N_PARTS = 2


@pytest.fixture(autouse=True)
def on_cpu():
    prev = blaze_tpu_torch._default_device
    blaze_tpu_torch.set_default_device("cpu")
    yield
    blaze_tpu_torch.set_default_device(prev)


@pytest.fixture(scope="module")
def data():
    return generate_all(SCALE)


def port_scans(data):
    return {k: MemoryScanExec(table_to_batches(data[k], s, N_PARTS, 4096, device="cpu"), s, device="cpu")
            for k, s in TPCDS_SCHEMAS.items()}


def run(plan, to_pydict=batch_to_pydict, context=TaskContext):
    out = {f.name: [] for f in plan.schema.fields}
    n = plan.num_partitions()
    for p in range(n):
        for b in plan.execute(p, context(p, n)):
            for k, v in to_pydict(b).items():
                out[k].extend(v)
    return out


_REFERENCE_ROWS = {}


def reference_rows(data, q, plan_cache=True):
    """The reference's rows in process, run once per tables, query and
    setting (its JAX compiles take most of these files' time);
    ``plan_cache`` False turns off its literal slots
    (``spark.blaze.cache.plan.enabled``)."""
    key = (id(data), q, plan_cache)
    if key not in _REFERENCE_ROWS:
        jax_conf.CACHE_PLAN_ENABLED.set(plan_cache)
        try:
            scans = {k: JaxScan(jax_table_to_batches(data[k], s, N_PARTS, batch_rows=4096), s)
                     for k, s in JAX_SCHEMAS.items()}
            # the tables stay referenced, so their id names them
            _REFERENCE_ROWS[key] = (data, run(jax_build_query(q, scans, N_PARTS), jax_to_pydict, JaxContext))
        finally:
            jax_conf.CACHE_PLAN_ENABLED.set(True)
    return _REFERENCE_ROWS[key][1]


def _same(a, b) -> bool:
    if isinstance(a, float) and isinstance(b, float):
        return a == b or (math.isnan(a) and math.isnan(b)) or abs(a - b) <= 1e-9 * max(abs(a), abs(b))
    return a == b


def assert_rows_equal(got, want):
    """Equal columns: exact, floats within 1e-9 relative."""
    assert list(got) == list(want)
    for name in got:
        assert len(got[name]) == len(want[name]), name
        bad = [(r, a, b) for r, (a, b) in enumerate(zip(got[name], want[name])) if not _same(a, b)]
        assert not bad, (name, bad[:5])


def check_reference(data, q, plan_cache=True):
    """The port in process (unoptimized, as the reference's
    ``plan.execute`` runs) equals the reference's rows."""
    got = run(build_query(q, port_scans(data), N_PARTS))
    want = reference_rows(data, q, plan_cache)
    assert len(next(iter(got.values()))) > 0
    assert_rows_equal(got, want)


def check_both_paths(data, q):
    """The port's oracle on both paths: optimized in process, and
    through split_stages/run_stages; the two paths' rows alike."""
    exp = getattr(O, f"oracle_{q}")(data)
    inproc = run(optimize_plan(build_query(q, port_scans(data), N_PARTS)))
    O.check_query(q, inproc, exp)
    stages, manager = split_stages(build_query(q, port_scans(data), N_PARTS))
    staged = {f.name: [] for f in stages[-1].plan.schema.fields}
    for b in run_stages(stages, manager):
        for k, v in batch_to_pydict(b).items():
            staged[k].extend(v)
    O.check_query(q, staged, exp)
    assert_rows_equal(staged, inproc)
    assert not len(RESOURCES)
    return [s.kind for s in stages]


QUERIES = ["q12", "q20", "q98"]


@pytest.mark.parametrize("q", QUERIES)
def test_equals_the_reference_in_process(data, q):
    check_reference(data, q)


@pytest.mark.parametrize("q", QUERIES)
def test_equals_the_oracle_in_process_and_through_run_stages(data, q):
    kinds = check_both_paths(data, q)
    assert kinds.count("map") >= 2 and kinds[-1] == "result"
