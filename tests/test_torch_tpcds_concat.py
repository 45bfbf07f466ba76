"""TPC-DS q84 through the port: one city's customers in an income
range, one row per store return of their demographics (a shuffled join
on ``cd_demo_sk``), named ``concat(c_last_name, ", ", c_first_name)``.
Against the reference in process and the port's oracle on both paths,
as ``test_torch_tpcds_window_share.py`` describes; the TaskDefinition
bytes are in ``test_torch_rename.py``."""

from test_torch_tpcds_window_share import check_both_paths, check_reference, data, on_cpu  # noqa: F401


def test_equals_the_reference_in_process(data):
    check_reference(data, "q84")


def test_equals_the_oracle_in_process_and_through_run_stages(data):
    kinds = check_both_paths(data, "q84")
    assert kinds.count("map") >= 2
