"""TPC-DS's ticket reports through the port: q34 and q73 (lines per
(ticket, customer), a HAVING range, then the customer joined, every row
sorted; q73 at SF 0.01), q46 and q68 (tickets bought away from the
buyer's current city) and q79 (Monday tickets per store city).  Against
the reference in process and the port's oracle on both paths, as
``test_torch_tpcds_report_share.py`` describes."""

import pytest

from test_torch_tpcds_report_share import data_of
from test_torch_tpcds_window_share import check_both_paths, check_reference, on_cpu  # noqa: F401

QUERIES = ["q34", "q73", "q46", "q68", "q79"]


@pytest.mark.parametrize("q", QUERIES)
def test_equals_the_reference_in_process(q):
    check_reference(data_of(q), q)


@pytest.mark.parametrize("q", QUERIES)
def test_equals_the_oracle_in_process_and_through_run_stages(q):
    kinds = check_both_paths(data_of(q), q)
    assert kinds.count("map") >= 2 and kinds.count("broadcast") >= 3
