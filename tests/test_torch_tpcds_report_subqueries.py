"""TPC-DS's reports of scalar subqueries through the port, run while
the plan is built: q88 (eight counts), q90 (two counts and their
ratio), q9 (15 subqueries over five quantity bands), q28 (12 subqueries
of 18 values, a count of distinct prices through a grouped agg) and q61
(two decimal sums and their ratio).  Against the reference in process
(q9, q28 and q61 with its plan cache off) and the port's oracle on both
paths, as ``test_torch_tpcds_report_share.py`` describes; reference
defect 9 pinned on q9, q28 and q61."""

import pytest

from test_torch_tpcds_report_share import PLAN_CACHE_OFF, data_of
from test_torch_tpcds_window_share import (  # noqa: F401
    N_PARTS, check_both_paths, check_reference, on_cpu, port_scans, reference_rows, run,
)

from blaze_tpu_torch.tpcds import build_query

QUERIES = ["q88", "q90", "q9", "q28", "q61"]


@pytest.mark.parametrize("q", QUERIES)
def test_equals_the_reference_in_process(q):
    check_reference(data_of(q), q, plan_cache=q not in PLAN_CACHE_OFF)


@pytest.mark.parametrize("q", QUERIES)
def test_equals_the_oracle_in_process_and_through_run_stages(q):
    kinds = check_both_paths(data_of(q), q)
    assert kinds[-1] == "result"


def test_reference_plan_cache_scales_decimal_subqueries_twice():
    """Reference defect 9 on q9, q28 and q61: with its plan cache on, a
    decimal scalar subquery's literal is scaled again (by 10^6 for q9's
    and q28's scale-6 averages, 100 for q61's sums; q61's ratio keeps
    its value, both terms scaled); with the cache off, and in the port,
    the oracle's."""
    scaled = {"q9": ([f"bucket{b}" for b in range(1, 6)], 10**6), "q28": (["B1_lp"], 10**6),
              "q61": (["promotions", "total"], 100)}
    for q, (cols, factor) in scaled.items():
        data = data_of(q)
        port = run(build_query(q, port_scans(data), N_PARTS))
        on, off = reference_rows(data, q), reference_rows(data, q, plan_cache=False)
        for c in cols:
            assert off[c] == port[c] and port[c][0] is not None, (q, c)
            assert on[c] == [port[c][0] * factor], (q, c)
