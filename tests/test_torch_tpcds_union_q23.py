"""TPC-DS's rollup and union queries through the port, part 8: q23a and
q23b (frequent items through ``substring``, best customers through a
decimal ``max`` scalar subquery, a catalog and web union).  Against the
reference in process and the port's oracle on both paths, as
``test_torch_tpcds_window_share.py`` describes.

The reference's plan cache scales the decimal maximum twice (ROADMAP
queue C, reference defect 9): the port is held to the reference run with
the cache off, and the defect is pinned with it on.  The reference's
best customers count the generator's -1 (a null customer) as a
customer (ROADMAP queue C, reference defect 14): from SF 0.01 its spend
is the largest, and q23a and q23b select nothing; pinned below."""

import pytest

from test_torch_tpcds_window_share import (  # noqa: F401
    N_PARTS, check_both_paths, check_reference, data, on_cpu, port_scans, reference_rows, run,
)

from blaze_tpu.tpcds import oracle as jax_oracle

from blaze_tpu_torch.tpcds import build_query, generate_all
from blaze_tpu_torch.tpcds import oracle as O

QUERIES = ["q23a", "q23b"]


@pytest.mark.parametrize("q", QUERIES)
def test_equals_the_reference_in_process(data, q):
    check_reference(data, q, plan_cache=False)


@pytest.mark.parametrize("q", QUERIES)
def test_equals_the_oracle_in_process_and_through_run_stages(data, q):
    check_both_paths(data, q)


def test_reference_plan_cache_scales_q23s_decimal_maximum_twice(data):
    """Reference defect 9 on q23a: the largest spend (decimal(38,2))
    scaled by 100 again leaves no best customer, so the reference's total
    is null; with the cache off, and in the port, the oracle's."""
    exp = O.oracle_q23a(data)
    assert exp is not None
    assert reference_rows(data, "q23a")["sum_sales"] == [None]
    assert reference_rows(data, "q23a", plan_cache=False)["sum_sales"] == [exp]
    assert run(build_query("q23a", port_scans(data), N_PARTS))["sum_sales"] == [exp]


def test_the_null_customer_is_the_best_customer_from_sf_001():
    """Reference defect 14: the generator's -1 customer (the spec's null)
    spends the most from SF 0.01 on, so it is the only best customer:
    q23a sums nothing (it bought no catalog or web line of a frequent
    item in May 2000) and q23b, which joins the customer's name, is empty
    in the reference's oracle, the port's and the port's plan."""
    t = generate_all(0.01)
    ss = t["store_sales"]
    spend = {}
    for c, q, p in zip(ss["ss_customer_sk"][0].tolist(), ss["ss_quantity"][0].tolist(),
                       ss["ss_sales_price"][0].tolist()):
        spend[c] = spend.get(c, 0) + q * p
    assert max(spend, key=spend.get) == -1
    assert [c for c, v in spend.items() if v > 0.5 * spend[-1]] == [-1]
    assert O.oracle_q23b(t) == jax_oracle.oracle_q23b(t) == {}
    assert O.oracle_q23a(t) is None
    scans = port_scans(t)
    assert run(build_query("q23b", scans, N_PARTS))["sales"] == []
    assert run(build_query("q23a", scans, N_PARTS))["sum_sales"] == [None]
