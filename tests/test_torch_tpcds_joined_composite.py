"""TPC-DS's sales shuffle-joined to their returns on a composite key
through the port: q40 (LEFT on (item, order), a CASE split by date),
q50 (INNER on (item, ticket, customer), days-to-return buckets) and
q93 (LEFT on (item, ticket) whose null side feeds a CASE, then a
reason). Against the reference in process and the port's oracle on
both paths, as ``test_torch_tpcds_joined_share.py`` describes."""

import pytest

from test_torch_tpcds_joined_share import check
from test_torch_tpcds_window_share import on_cpu  # noqa: F401

QUERIES = ["q40", "q50", "q93"]


@pytest.mark.parametrize("q", QUERIES)
def test_equals_the_reference_and_the_oracle_on_both_paths(q):
    kinds = check(q)
    assert kinds.count("map") >= 2 and kinds[-1] == "result"
