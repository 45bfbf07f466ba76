"""TPC-DS q14a and q14b through the port, which share the cross-channel
items (``_q14_base``): one module, so that one worker compiles the
reference's plans of them once.

q14a (INTERSECT as LEFT_SEMI joins between aggregated DISTINCT triple
sets, one ``cross_items`` plan under three channels, a global ``avg``
over a union as a decimal scalar subquery, ROLLUP over the channels'
union), against the reference in process and the port's oracle on both
paths, as ``test_torch_tpcds_window_share.py`` describes.

q14b (this November's store cells of the cross-channel items against
last November's, shuffle-joined on the three ids, both above the three
channels' average), against the reference in process and the port's
oracle on both paths, as ``test_torch_tpcds_joined_share.py`` describes.

The reference's plan cache scales the decimal average of both twice
(ROADMAP queue C, reference defect 9): with it on, no cell passes the
average and the reference returns no row.  The port is held to the
reference run with the cache off, and the defect is pinned with it on."""

import pytest

from test_torch_tpcds_joined_share import PLAN_CACHE_OFF, check
from test_torch_tpcds_joined_share import data as joined_data
from test_torch_tpcds_window_share import (  # noqa: F401
    N_PARTS, check_both_paths, check_reference, data, on_cpu, port_scans, reference_rows, run,
)

from blaze_tpu_torch.tpcds import build_query
from blaze_tpu_torch.tpcds import oracle as O

QUERIES = ["q14b"]


def test_equals_the_reference_in_process(data):
    check_reference(data, "q14a", plan_cache=False)


def test_equals_the_oracle_in_process_and_through_run_stages(data):
    kinds = check_both_paths(data, "q14a")
    assert kinds.count("broadcast") >= 12


def test_reference_plan_cache_scales_q14as_average_twice(data):
    """Defect 9 on q14a: with the cache on, the average (decimal(34,6))
    is scaled by 10^6 again and no cell passes it, so the reference
    gives no row; with it off, and in the port, the oracle's first 100
    of its rollup rows."""
    exp = O.oracle_q14a(data)
    assert len(exp) > 100
    assert reference_rows(data, "q14a")["channel"] == []
    assert len(reference_rows(data, "q14a", plan_cache=False)["channel"]) == 100
    assert len(run(build_query("q14a", port_scans(data), N_PARTS))["channel"]) == 100


@pytest.mark.parametrize("q", QUERIES)
def test_equals_the_reference_and_the_oracle_on_both_paths(q):
    kinds = check(q, plan_cache=q not in PLAN_CACHE_OFF)
    assert kinds.count("map") >= 2 and kinds[-1] == "result"


def test_reference_plan_cache_scales_q14bs_average_twice():
    """Defect 9 on q14b: the port's rows are the oracle's; the
    reference's, with its plan cache on, are none."""
    port = run(build_query("q14b", port_scans(joined_data()), N_PARTS))
    O.check_query("q14b", port, O.oracle_q14b(joined_data()))
    assert reference_rows(joined_data(), "q14b")["sales"] == []
