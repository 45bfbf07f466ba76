"""TPC-DS q58 through the port: three channels' item revenues in the
month of 2000-01-03 (its month_seq a scalar subquery, the nested
subquery of the spec), shuffle-joined on the item id.  Against the
reference in process and the port's oracle on both paths, as
``test_torch_tpcds_joined_share.py`` describes."""

import pytest

from test_torch_tpcds_joined_share import check
from test_torch_tpcds_window_share import on_cpu  # noqa: F401

QUERIES = ["q58"]


@pytest.mark.parametrize("q", QUERIES)
def test_equals_the_reference_and_the_oracle_on_both_paths(q):
    kinds = check(q)
    assert kinds.count("map") >= 2 and kinds[-1] == "result"
