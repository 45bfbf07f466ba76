"""TPC-DS's brand reports through the port: q42, q52 and q55 (one
month's sales of one manager's items per category or brand), q19 (five
broadcast joins and a filter on two ``substring`` zips) and q43 (a CASE
pivot by weekday; a weekday with no sale sums to null).  The item
reports are in ``test_torch_tpcds_report_items.py``.  Against the
reference in process and the port's oracle on both paths, as
``test_torch_tpcds_report_share.py`` describes."""

import pytest

from test_torch_tpcds_report_share import data_of
from test_torch_tpcds_window_share import check_both_paths, check_reference, on_cpu, port_scans, run  # noqa: F401

from blaze_tpu_torch.tpcds import build_query

QUERIES = ["q42", "q52", "q55", "q19", "q43"]


@pytest.mark.parametrize("q", QUERIES)
def test_equals_the_reference_in_process(q):
    check_reference(data_of(q), q)


@pytest.mark.parametrize("q", QUERIES)
def test_equals_the_oracle_in_process_and_through_run_stages(q):
    kinds = check_both_paths(data_of(q), q)
    assert kinds.count("broadcast") >= 1 and kinds[-1] == "result"


def test_q43_sums_a_weekday_without_sales_to_null():
    """At SF 0.002 some stores sold nothing on some weekday: the pivot's
    sum of no value is null (the reference's oracle writes 0 there)."""
    got = run(build_query("q43", port_scans(data_of("q43")), 2))
    sums = [v for d in ("sun", "mon", "tue", "wed", "thu", "fri", "sat") for v in got[f"{d}_sales"]]
    assert None in sums and any(v is not None for v in sums)
