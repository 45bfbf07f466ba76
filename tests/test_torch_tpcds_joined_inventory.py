"""TPC-DS's inventory items through the port: q37 and q82 (the items of a
price band shuffle-joined to a 60-day window of ``inventory``, then
LEFT_SEMI-joined to a channel's items). Against the reference in
process and the port's oracle on both paths, as
``test_torch_tpcds_joined_share.py`` describes."""

import pytest

from test_torch_tpcds_joined_share import check
from test_torch_tpcds_window_share import on_cpu  # noqa: F401

QUERIES = ["q37", "q82"]


@pytest.mark.parametrize("q", QUERIES)
def test_equals_the_reference_and_the_oracle_on_both_paths(q):
    kinds = check(q)
    assert kinds.count("map") >= 2 and kinds[-1] == "result"
