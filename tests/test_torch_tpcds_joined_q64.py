"""TPC-DS q64 through the port: returned store lines of two years, each
grouped per (item id, store, zip), joined on those three string keys.
Against the reference in process and the port's oracle on both paths,
as ``test_torch_tpcds_joined_share.py`` describes."""

import pytest

from test_torch_tpcds_joined_share import check
from test_torch_tpcds_window_share import on_cpu  # noqa: F401

QUERIES = ["q64"]


@pytest.mark.parametrize("q", QUERIES)
def test_equals_the_reference_and_the_oracle_on_both_paths(q):
    kinds = check(q)
    assert kinds.count("map") >= 4 and kinds[-1] == "result"
