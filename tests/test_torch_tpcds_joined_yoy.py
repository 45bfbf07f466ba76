"""TPC-DS's year-over-year customers through the port: q74 and q11 (four
per-customer yearly totals broadcast-joined on the customer) and q4
(six, over all three channels: the widest plan of the benchmark).
Against the reference in process and the port's oracle on both paths,
as ``test_torch_tpcds_joined_share.py`` describes.  The three share one
module, so that one worker compiles the reference's per-customer
yearly totals (``_year_total``) once."""

import pytest

from test_torch_tpcds_joined_share import check
from test_torch_tpcds_window_share import on_cpu  # noqa: F401

#: each query's broadcast stages, at least
QUERIES = {"q74": 8, "q11": 8, "q4": 12}


@pytest.mark.parametrize("q", list(QUERIES))
def test_equals_the_reference_and_the_oracle_on_both_paths(q):
    kinds = check(q)
    assert kinds.count("broadcast") >= QUERIES[q] and kinds[-1] == "result"
