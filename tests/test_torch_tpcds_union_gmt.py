"""TPC-DS's rollup and union queries through the port, part 5: q33, q56
and q60 (three channels per item id, each a LEFT_SEMI join of the items
against a DISTINCT id subquery, unioned and then summed) and q76 (three
channels filtered on the generator's -1 key and tagged with string
literals of two widths).  Against the reference in process and the
port's oracle on both paths, as ``test_torch_tpcds_window_share.py``
describes."""

import pytest

from test_torch_tpcds_window_share import check_both_paths, check_reference, data, on_cpu  # noqa: F401

QUERIES = ["q33", "q56", "q60", "q76"]


@pytest.mark.parametrize("q", QUERIES)
def test_equals_the_reference_in_process(data, q):
    check_reference(data, q)


@pytest.mark.parametrize("q", QUERIES)
def test_equals_the_oracle_in_process_and_through_run_stages(data, q):
    kinds = check_both_paths(data, q)
    assert kinds.count("map") >= 2

