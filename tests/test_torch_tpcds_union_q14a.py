"""TPC-DS's rollup and union queries through the port, part 4: q14a
(INTERSECT as LEFT_SEMI joins between aggregated DISTINCT triple sets,
one ``cross_items`` plan under three channels, a global ``avg`` over a
union as a decimal scalar subquery, ROLLUP over the channels' union).
Against the reference in process and the port's oracle on both paths,
as ``test_torch_tpcds_window_share.py`` describes.

The reference's plan cache scales the decimal average twice (ROADMAP
queue C, reference defect 9), so the port is held to the reference run
with the cache off, and the defect is pinned with it on."""

from test_torch_tpcds_window_share import (  # noqa: F401
    N_PARTS, check_both_paths, check_reference, data, on_cpu, port_scans, reference_rows, run,
)

from blaze_tpu_torch.tpcds import build_query
from blaze_tpu_torch.tpcds import oracle as O


def test_equals_the_reference_in_process(data):
    check_reference(data, "q14a", plan_cache=False)


def test_equals_the_oracle_in_process_and_through_run_stages(data):
    kinds = check_both_paths(data, "q14a")
    assert kinds.count("broadcast") >= 12


def test_reference_plan_cache_scales_q14as_average_twice(data):
    """Reference defect 9 on q14a: with the cache on, the average
    (decimal(34,6)) is scaled by 10^6 again and no cell passes it, so the
    reference gives no row; with it off, and in the port, the oracle's
    first 100 of its rollup rows."""
    exp = O.oracle_q14a(data)
    assert len(exp) > 100
    assert reference_rows(data, "q14a")["channel"] == []
    assert len(reference_rows(data, "q14a", plan_cache=False)["channel"]) == 100
    assert len(run(build_query("q14a", port_scans(data), N_PARTS))["channel"]) == 100
