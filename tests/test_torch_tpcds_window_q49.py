"""TPC-DS q49 through the port, at SF 0.01 (SF 0.002 leaves one row):
per channel, the items' return ratios double-ranked (two ``rank``
windows over two sorts), rank <= 10 on either, the three channels
through ``UnionExec``.  Against the reference in process and the port's
oracle on both paths, as ``test_torch_tpcds_window_share.py``
describes."""

import pytest

from test_torch_tpcds_window_share import check_both_paths, check_reference, on_cpu  # noqa: F401

from blaze_tpu_torch.tpcds import generate_all


@pytest.fixture(scope="module")
def data():
    return generate_all(0.01)


def test_q49_equals_the_reference_in_process(data):
    check_reference(data, "q49")


def test_q49_equals_the_oracle_in_process_and_through_run_stages(data):
    check_both_paths(data, "q49")
