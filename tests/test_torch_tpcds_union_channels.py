"""TPC-DS's rollup and union queries through the port, part 3: the
channel reports q5, q77 and q80 (three channels of sales and returns
unioned, widened to decimal(8,2) by ``_d8``, outer-join null sides
filled by ``_coalesce0``, ROLLUP(channel, id)).  Against the reference
in process and the port's oracle on both paths, as
``test_torch_tpcds_window_share.py`` describes.

q77's catalog returns total is a decimal scalar subquery, which the
reference's plan cache scales twice (ROADMAP queue C, reference defect
9): the port is held to the reference run with the cache off, and the
defect is pinned with it on."""

import pytest

from test_torch_tpcds_window_share import (  # noqa: F401
    N_PARTS, check_both_paths, check_reference, data, on_cpu, port_scans, reference_rows, run,
)

from blaze_tpu_torch.tpcds import build_query
from blaze_tpu_torch.tpcds import oracle as O

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
