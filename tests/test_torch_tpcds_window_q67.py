"""TPC-DS q67 through the port: an eight-dimension ROLLUP (nine
projections of ``ExpandExec``, fused with the projection under it into
one batch of 9 x n rows in process) and ``rank`` per category, the top
100 ranks.  Against the reference in process and the port's oracle on
both paths, as ``test_torch_tpcds_window_share.py`` describes."""

from test_torch_tpcds_window_share import check_both_paths, check_reference, data, on_cpu  # noqa: F401


def test_q67_equals_the_reference_in_process(data):
    check_reference(data, "q67")


def test_q67_equals_the_oracle_in_process_and_through_run_stages(data):
    check_both_paths(data, "q67")
