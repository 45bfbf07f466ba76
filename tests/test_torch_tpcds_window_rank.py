"""TPC-DS's window queries through the port, part 4: q44 (two ``rank``
windows over one exchange, joined on the rank; a decimal scalar
subquery sets the baseline) and q51 (running ``sum`` per channel, a FULL
outer join, running ``max`` carrying each side across the join's gaps).

The reference's plan cache scales q44's decimal scalar subquery twice
(ROADMAP queue C, reference defect 9): with
``spark.blaze.cache.plan.enabled`` on, its default, it gives no row at
SF 0.002, where the oracle and the port give 10; the port is held to the
reference run with the cache off, and the defect is pinned with it on.
"""

import pytest

from test_torch_tpcds_window_share import (  # noqa: F401
    check_both_paths, check_reference, data, on_cpu, reference_rows, run, N_PARTS, port_scans,
)

from blaze_tpu.tpcds import oracle as jax_oracle

from blaze_tpu_torch.tpcds import build_query
from blaze_tpu_torch.tpcds import oracle as O


@pytest.mark.parametrize("q", ["q44", "q51"])
def test_equals_the_reference_in_process(data, q):
    check_reference(data, q, plan_cache=q != "q44")


@pytest.mark.parametrize("q", ["q44", "q51"])
def test_equals_the_oracle_in_process_and_through_run_stages(data, q):
    check_both_paths(data, q)


def test_reference_plan_cache_scales_q44s_decimal_subquery_twice(data):
    """Reference defect 9 on q44: the threshold 0.9 * avg(net profit)
    of the null-address rows is a decimal(11,6) scalar subquery; the
    plan cache's literal slots scale the injected unscaled value by
    10^6 again, so no item passes.  With the cache off, and in the port,
    the oracle's 10 rank pairs."""
    exp = O.oracle_q44(data)
    assert exp == jax_oracle.oracle_q44(data) and len(exp) == 10
    assert reference_rows(data, "q44")["rnk"] == []
    assert len(reference_rows(data, "q44", plan_cache=False)["rnk"]) == 10
    assert len(run(build_query("q44", port_scans(data), N_PARTS))["rnk"]) == 10
