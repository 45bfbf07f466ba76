"""TPC-DS's demographic and zip band reports through the port: q13 and
q48 (an OR of demographic bands AND an OR of address bands over five
broadcast joins; at SF 0.01), q15 (a zip prefix, a state or a price),
q45 (a zip prefix or an IN subquery's items, run while the plan is
built), q8 (INTERSECT of zip sets into a LEFT_SEMI join on a
``substring`` key) and q91 (catalog returns by call center and
demographics).  Against the reference in process and the port's oracle
on both paths, as ``test_torch_tpcds_report_share.py`` describes."""

import pytest

from test_torch_tpcds_report_share import data_of
from test_torch_tpcds_window_share import check_both_paths, check_reference, on_cpu  # noqa: F401

QUERIES = ["q13", "q48", "q15", "q45", "q8", "q91"]


@pytest.mark.parametrize("q", QUERIES)
def test_equals_the_reference_in_process(q):
    check_reference(data_of(q), q)


@pytest.mark.parametrize("q", QUERIES)
def test_equals_the_oracle_in_process_and_through_run_stages(q):
    kinds = check_both_paths(data_of(q), q)
    assert kinds.count("broadcast") >= 1 and kinds[-1] == "result"
