"""TPC-DS's rollup and union queries through the port, part 7: q71 (a
union of three channels keyed by time of day), q75 (year over year with
LEFT joins to the returns, ``_coalesce0`` and a union of three
channels) and q54 (a catalog and web customer union and an int scalar
subquery).  SF 0.002 selects too little for them, so, as the
reference's own tests, they run at SF 0.01.  Against the reference in
process and the port's oracle on both paths, as
``test_torch_tpcds_window_share.py`` describes."""

import pytest

from test_torch_tpcds_window_share import check_both_paths, check_reference, on_cpu  # noqa: F401

from blaze_tpu_torch.tpcds import generate_all

QUERIES = ["q71", "q75", "q54"]


@pytest.fixture(scope="module")
def data():
    return generate_all(0.01)


@pytest.mark.parametrize("q", QUERIES)
def test_equals_the_reference_in_process(data, q):
    check_reference(data, q)


@pytest.mark.parametrize("q", QUERIES)
def test_equals_the_oracle_in_process_and_through_run_stages(data, q):
    check_both_paths(data, q)
