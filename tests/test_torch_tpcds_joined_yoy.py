"""TPC-DS's year-over-year customers through the port: q74 and q11 (four
per-customer yearly totals broadcast-joined on the customer). Against
the reference in process and the port's oracle on both paths, as
``test_torch_tpcds_joined_share.py`` describes."""

import pytest

from test_torch_tpcds_joined_share import check
from test_torch_tpcds_window_share import on_cpu  # noqa: F401

QUERIES = ["q74", "q11"]


@pytest.mark.parametrize("q", QUERIES)
def test_equals_the_reference_and_the_oracle_on_both_paths(q):
    kinds = check(q)
    assert kinds.count("broadcast") >= 8 and kinds[-1] == "result"
