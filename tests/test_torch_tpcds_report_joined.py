"""TPC-DS's averages joined back through the port: q32 and q92
(discounts over 1.3 times their item's average, a grouped ``avg``
broadcast back to its own input, then a LEFT_SEMI join) and q65 (per
(store, item) revenue against its store's average, an aggregation over
an aggregation joined back to it).  Against the reference in process
and the port's oracle on both paths, as
``test_torch_tpcds_report_share.py`` describes."""

import pytest

from test_torch_tpcds_report_share import data_of
from test_torch_tpcds_window_share import check_both_paths, check_reference, on_cpu  # noqa: F401

QUERIES = ["q32", "q92", "q65"]


@pytest.mark.parametrize("q", QUERIES)
def test_equals_the_reference_in_process(q):
    check_reference(data_of(q), q)


@pytest.mark.parametrize("q", QUERIES)
def test_equals_the_oracle_in_process_and_through_run_stages(q):
    kinds = check_both_paths(data_of(q), q)
    assert kinds.count("map") >= 2 and kinds[-1] == "result"
