"""TPC-DS's window queries through the port, part 2: q53 and q63 (a
manufacturer's quarterly or monthly sales against its whole-partition
``avg``) and q89 (monthly brand sales against the year's store
average).  Against the reference in process and the port's oracle on
both paths, as ``test_torch_tpcds_window_share.py`` describes."""

import pytest

from test_torch_tpcds_window_share import check_both_paths, check_reference, data, on_cpu  # noqa: F401

QUERIES = ["q53", "q63", "q89"]


@pytest.mark.parametrize("q", QUERIES)
def test_equals_the_reference_in_process(data, q):
    check_reference(data, q)


@pytest.mark.parametrize("q", QUERIES)
def test_equals_the_oracle_in_process_and_through_run_stages(data, q):
    check_both_paths(data, q)
