"""TPC-DS q10 and q80 with every -1 key of every table exposed as null
(``tpcds.datagen.with_null_fks``): the port equals the reference in
process (unoptimized, the reference's plan cache off: ROADMAP queue C,
defect 9), and its optimized and ``run_stages`` rows equal its own,
leaving ``RESOURCES`` empty.  The reference's own null-key checks are in
``test_torch_null_fks.py``."""

import numpy as np
import pytest

from blaze_tpu_torch.batch import batch_to_pydict
from blaze_tpu_torch.ops.fusion import optimize_plan
from blaze_tpu_torch.runtime import scheduler as S
from blaze_tpu_torch.runtime.context import RESOURCES
from blaze_tpu_torch.tpcds import build_query
from blaze_tpu_torch.tpcds.datagen import with_null_fks

from test_torch_null_fks import _rows
from test_torch_tpcds_window_share import (  # noqa: F401
    N_PARTS, assert_rows_equal, data, on_cpu, port_scans, reference_rows, run,
)


@pytest.fixture(scope="module")
def nulled(data):
    """Every table with each ``_sk`` column that holds a -1 exposed as
    null."""
    return {name: with_null_fks(t, [c for c, v in t.items() if c.endswith("_sk") and v[1] is None
                                    and np.issubdtype(v[0].dtype, np.integer) and (v[0] == -1).any()])
            for name, t in data.items()}


@pytest.mark.parametrize("q", ["q10", "q80"])
def test_queries_over_null_keys_equal_the_reference(nulled, q):
    assert sum(len(t[c]) == 3 for t in nulled.values() for c in t) >= 15
    got = run(build_query(q, port_scans(nulled), N_PARTS))
    assert len(next(iter(got.values()))) > 0
    assert_rows_equal(got, reference_rows(nulled, q, plan_cache=False))
    assert_rows_equal(run(optimize_plan(build_query(q, port_scans(nulled), N_PARTS))), got)
    stages, manager = S.split_stages(build_query(q, port_scans(nulled), N_PARTS))
    assert_rows_equal(_rows(S.run_stages(stages, manager), stages[-1].plan, batch_to_pydict), got)
    assert not len(RESOURCES)
