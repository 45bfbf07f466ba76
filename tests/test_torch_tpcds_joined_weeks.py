"""TPC-DS's weekly and per-item self joins through the port: q59 (q2's
weekly day-of-week pivot per store joined to the week 52 later), q83
(three channels' returns joined on the item id) and q58 (three
channels' item revenues in the month of 2000-01-03, its month_seq a
scalar subquery, the nested subquery of the spec, shuffle-joined on
the item id). Against the reference in process and the port's oracle
on both paths, as ``test_torch_tpcds_joined_share.py`` describes.  q58
and q83 share one module, so that one worker compiles the reference's
per-channel item joins once."""

import pytest

from test_torch_tpcds_joined_share import check
from test_torch_tpcds_window_share import on_cpu  # noqa: F401

QUERIES = ["q59", "q83", "q58"]


@pytest.mark.parametrize("q", QUERIES)
def test_equals_the_reference_and_the_oracle_on_both_paths(q):
    kinds = check(q)
    assert kinds.count("map") >= 2 and kinds[-1] == "result"
