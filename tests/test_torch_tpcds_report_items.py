"""TPC-DS's item reports through the port: q96 (one count; at SF 0.01),
q26 (q7 over ``catalog_sales``), q6 (a grouped average joined back,
then a LEFT_SEMI join) and q41 (a LEFT_SEMI join on the string
i_manufact).  Against the reference in process and the port's oracle on
both paths, as ``test_torch_tpcds_report_share.py`` describes."""

import pytest

from test_torch_tpcds_report_share import data_of
from test_torch_tpcds_window_share import check_both_paths, check_reference, on_cpu  # noqa: F401

QUERIES = ["q96", "q26", "q6", "q41"]


@pytest.mark.parametrize("q", QUERIES)
def test_equals_the_reference_in_process(q):
    check_reference(data_of(q), q)


@pytest.mark.parametrize("q", QUERIES)
def test_equals_the_oracle_in_process_and_through_run_stages(q):
    kinds = check_both_paths(data_of(q), q)
    assert kinds.count("broadcast") >= 1 and kinds[-1] == "result"
