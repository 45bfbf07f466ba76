"""TPC-DS's ship-lag and inventory CASE pivots through the port: q62 and
q99 (orders in five ship-lag buckets per warehouse, ship mode and site
or call center, a date joined twice) and q21 (``inventory`` around a
date, a ratio filter on two CASE sums).  Against the reference in
process and the port's oracle on both paths, as
``test_torch_tpcds_report_share.py`` describes."""

import pytest

from test_torch_tpcds_report_share import data_of
from test_torch_tpcds_window_share import check_both_paths, check_reference, on_cpu  # noqa: F401

QUERIES = ["q62", "q99", "q21"]


@pytest.mark.parametrize("q", QUERIES)
def test_equals_the_reference_in_process(q):
    check_reference(data_of(q), q)


@pytest.mark.parametrize("q", QUERIES)
def test_equals_the_oracle_in_process_and_through_run_stages(q):
    kinds = check_both_paths(data_of(q), q)
    assert kinds.count("broadcast") >= 3 and kinds[-1] == "result"
