"""TPC-DS q72 through the port: catalog lines of one buyer profile
shuffle-joined to all of ``inventory`` on the item (the heaviest join
of the port), then filtered on the week and the quantity on hand.
Against the reference in process and the port's oracle on both paths,
as ``test_torch_tpcds_joined_share.py`` describes."""

import pytest

from test_torch_tpcds_joined_share import check
from test_torch_tpcds_window_share import on_cpu  # noqa: F401

QUERIES = ["q72"]


@pytest.mark.parametrize("q", QUERIES)
def test_equals_the_reference_and_the_oracle_on_both_paths(q):
    kinds = check(q)
    assert kinds.count("map") >= 2 and kinds[-1] == "result"
