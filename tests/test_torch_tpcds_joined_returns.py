"""TPC-DS's returns above a location's average through the port: q1, q30
and q81 (each customer's returns per store, web page or call center
against the location's average, a grouped ``avg`` over the
per-customer sums joined back to them). Against the reference in
process and the port's oracle on both paths, as
``test_torch_tpcds_joined_share.py`` describes."""

import pytest

from test_torch_tpcds_joined_share import check
from test_torch_tpcds_window_share import on_cpu  # noqa: F401

QUERIES = ["q1", "q30", "q81"]


@pytest.mark.parametrize("q", QUERIES)
def test_equals_the_reference_and_the_oracle_on_both_paths(q):
    kinds = check(q)
    assert kinds.count("map") >= 2 and kinds[-1] == "result"
