"""TPC-DS's rollup and union queries through the port, part 3: the
channel reports q5, q77 and q80 (three channels of sales and returns
unioned, widened to decimal(8,2) by ``_d8``, outer-join null sides
filled by ``_coalesce0``, ROLLUP(channel, id)).  Against the reference
in process and the port's oracle on both paths, as
``test_torch_tpcds_window_share.py`` describes.

q77's catalog returns total is a decimal scalar subquery, which the
reference's plan cache scales twice (ROADMAP queue C, reference defect
9): the port is held to the reference run with the cache off, and the
defect is pinned with it on.

Then TPC-DS q10 and q80 with every -1 key of every table exposed as
null (``tpcds.datagen.with_null_fks``): the port equals the reference in
process (unoptimized, the reference's plan cache off: defect 9), and its
optimized and ``run_stages`` rows equal its own, leaving ``RESOURCES``
empty.  The reference's own null-key checks are in
``test_torch_null_fks.py``.  They share this module with q80's channel
report so that one worker compiles the reference's q80 once (its tables
have the same shapes, nulls or not)."""

import numpy as np
import pytest

from test_torch_null_fks import _rows
from test_torch_tpcds_window_share import (  # noqa: F401
    N_PARTS, assert_rows_equal, check_both_paths, check_reference, data, on_cpu, port_scans, reference_rows, run,
)

from blaze_tpu_torch.batch import batch_to_pydict
from blaze_tpu_torch.ops.fusion import optimize_plan
from blaze_tpu_torch.runtime import scheduler as S
from blaze_tpu_torch.runtime.context import RESOURCES
from blaze_tpu_torch.tpcds import build_query
from blaze_tpu_torch.tpcds import oracle as O
from blaze_tpu_torch.tpcds.datagen import with_null_fks

QUERIES = ["q5", "q77", "q80"]


@pytest.mark.parametrize("q", QUERIES)
def test_equals_the_reference_in_process(data, q):
    check_reference(data, q, plan_cache=q != "q77")


@pytest.mark.parametrize("q", QUERIES)
def test_equals_the_oracle_in_process_and_through_run_stages(data, q):
    kinds = check_both_paths(data, q)
    assert kinds.count("map") >= 4


def test_reference_plan_cache_scales_q77s_decimal_subquery_twice(data):
    """Reference defect 9 on q77: the catalog returns total (a
    decimal(17,2) scalar subquery) comes back 100 times too large in
    every catalog row with the cache on; with it off, and in the port,
    the oracle's."""
    exp = O.oracle_q77(data)
    want = reference_rows(data, "q77", plan_cache=False)
    bad = reference_rows(data, "q77")
    got = run(build_query("q77", port_scans(data), N_PARTS))
    assert got == want
    cat = [r for r, c in enumerate(want["channel"]) if c == "catalog channel"]
    assert cat and all(got["returns"][r] == exp[("catalog channel", got["id"][r])][1] for r in cat)
    assert all(bad["returns"][r] == 100 * want["returns"][r] != 0 for r in cat)


# ------------------------------------------------------ real null keys


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
