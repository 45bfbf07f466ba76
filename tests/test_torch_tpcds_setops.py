"""TPC-DS's INTERSECT and EXCEPT queries through the port: q38 and q87
(three channels' DISTINCT (last name, first name, day) sets, LEFT_SEMI
or LEFT_ANTI joined on all three columns, strings and a date, then
counted).  Against the reference in process and the port's oracle on
both paths, as ``test_torch_tpcds_window_share.py`` describes."""

import pytest

from test_torch_tpcds_window_share import check_both_paths, check_reference, data, on_cpu  # noqa: F401

from blaze_tpu_torch.tpcds import oracle as O

QUERIES = ["q38", "q87"]


@pytest.mark.parametrize("q", QUERIES)
def test_equals_the_reference_in_process(data, q):
    check_reference(data, q)


@pytest.mark.parametrize("q", QUERIES)
def test_equals_the_oracle_in_process_and_through_run_stages(data, q):
    kinds = check_both_paths(data, q)
    assert kinds.count("map") >= 4
    # nonempty here; q87 is empty from SF 0.1 on (8 distinct names)
    assert getattr(O, f"oracle_{q}")(data) > 0
