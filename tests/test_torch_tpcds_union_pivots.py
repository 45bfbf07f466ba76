"""TPC-DS's rollup and union queries through the port, part 6: q66 (a
12-month CASE pivot per warehouse over a web and catalog union) and q2
(a weekly day-of-week pivot over a web and catalog union, float
ratios).  Against the reference in process and the port's oracle on
both paths, as ``test_torch_tpcds_window_share.py`` describes."""

import pytest

from test_torch_tpcds_window_share import check_both_paths, check_reference, data, on_cpu  # noqa: F401

QUERIES = ["q66", "q2"]


@pytest.mark.parametrize("q", QUERIES)
def test_equals_the_reference_in_process(data, q):
    check_reference(data, q)


@pytest.mark.parametrize("q", QUERIES)
def test_equals_the_oracle_in_process_and_through_run_stages(data, q):
    check_both_paths(data, q)

