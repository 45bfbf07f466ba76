"""TPC-DS q14b through the port: this November's store cells of the
cross-channel items against last November's, shuffle-joined on the
three ids, both above the three channels' average (a decimal scalar
subquery); the reference held with its plan cache off (defect 9, which
empties its result, pinned by ``test_torch_tpcds_joined_q14b_defect9.py``).
Against the reference in process and the port's oracle on both paths,
as ``test_torch_tpcds_joined_share.py`` describes."""

import pytest

from test_torch_tpcds_joined_share import PLAN_CACHE_OFF, check
from test_torch_tpcds_window_share import on_cpu  # noqa: F401

QUERIES = ["q14b"]


@pytest.mark.parametrize("q", QUERIES)
def test_equals_the_reference_and_the_oracle_on_both_paths(q):
    kinds = check(q, plan_cache=q not in PLAN_CACHE_OFF)
    assert kinds.count("map") >= 2 and kinds[-1] == "result"
