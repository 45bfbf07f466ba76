"""TPC-DS's pair joins through the port: q85 (web sales joined to their
returns on (order, item), then two demographics, an address and a
reason) and q97 (a FULL join of two DISTINCT (customer, item) sets).
Against the reference in process and the port's oracle on both paths,
as ``test_torch_tpcds_joined_share.py`` describes."""

import pytest

from test_torch_tpcds_joined_share import check
from test_torch_tpcds_window_share import on_cpu  # noqa: F401

QUERIES = ["q85", "q97"]


@pytest.mark.parametrize("q", QUERIES)
def test_equals_the_reference_and_the_oracle_on_both_paths(q):
    kinds = check(q)
    assert kinds.count("map") >= 2 and kinds[-1] == "result"
