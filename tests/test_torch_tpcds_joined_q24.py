"""TPC-DS q24a and q24b through the port: returned store lines
shuffle-joined on (item, ticket), each color's net paid against 5% of
the average over every color, a decimal scalar subquery; the reference
held with its plan cache off, and reference defect 9 pinned.  Against
the reference in process and the port's oracle on both paths, as
``test_torch_tpcds_joined_share.py`` describes."""

import pytest

from test_torch_tpcds_joined_share import PLAN_CACHE_OFF, check, data
from test_torch_tpcds_window_share import N_PARTS, on_cpu, port_scans, reference_rows, run  # noqa: F401

QUERIES = ["q24a", "q24b"]


@pytest.mark.parametrize("q", QUERIES)
def test_equals_the_reference_and_the_oracle_on_both_paths(q):
    kinds = check(q, plan_cache=q not in PLAN_CACHE_OFF)
    assert kinds.count("map") >= 2 and kinds[-1] == "result"


def test_reference_plan_cache_scales_the_average_twice():
    """Reference defect 9 on q24a and q24b (as on q9, q28 and q61,
    ``test_torch_tpcds_report_subqueries.py``): with its plan cache on,
    the decimal average's literal is scaled again (by 10^6), so no
    person passes 5% of it and the reference returns no row; with the
    cache off, and in the port, the oracle's rows."""
    from blaze_tpu_torch.tpcds import build_query

    for q in QUERIES:
        port = run(build_query(q, port_scans(data()), N_PARTS))
        on, off = reference_rows(data(), q), reference_rows(data(), q, plan_cache=False)
        assert port["paid"] and off["paid"] == port["paid"] and on["paid"] == [], q
