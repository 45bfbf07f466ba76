"""TPC-DS q4 through the port: six per-customer yearly totals over all
three channels broadcast-joined on the customer, the widest plan of
the benchmark.  Against the reference in process and the port's oracle
on both paths, as ``test_torch_tpcds_joined_share.py`` describes."""

import pytest

from test_torch_tpcds_joined_share import check
from test_torch_tpcds_window_share import on_cpu  # noqa: F401

QUERIES = ["q4"]


@pytest.mark.parametrize("q", QUERIES)
def test_equals_the_reference_and_the_oracle_on_both_paths(q):
    kinds = check(q)
    assert kinds.count("broadcast") >= 12 and kinds[-1] == "result"
