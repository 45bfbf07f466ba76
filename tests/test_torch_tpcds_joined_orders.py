"""TPC-DS's multi-warehouse orders through the port: q94, q95 and q16 (a
LEFT_SEMI join whose build side is an aggregate of the orders that
ship from two warehouses, a LEFT_ANTI or LEFT_SEMI join to the
returns, and count(DISTINCT order) as a grouped agg under a global
``count_star``). Against the reference in process and the port's
oracle on both paths, as ``test_torch_tpcds_joined_share.py``
describes."""

import pytest

from test_torch_tpcds_joined_share import check
from test_torch_tpcds_window_share import on_cpu  # noqa: F401

QUERIES = ["q94", "q95", "q16"]


@pytest.mark.parametrize("q", QUERIES)
def test_equals_the_reference_and_the_oracle_on_both_paths(q):
    kinds = check(q)
    assert kinds.count("broadcast") >= 4 and kinds[-1] == "result"
