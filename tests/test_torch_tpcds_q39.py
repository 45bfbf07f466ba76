"""TPC-DS q39a and q39b through the port: per (warehouse, item) the
mean and the ``stddev_samp`` of the quantity on hand in January and in
February 2001 (two ``inventory`` scans), a coefficient of variation
over a threshold, and the months shuffle-joined on a string and an
int64 key.  Against the reference in process (doubles within 1e-9
relative) and the port's oracle on both paths, as
``test_torch_tpcds_window_share.py`` describes; no row's cov lies within
1e-9 of a threshold at this scale."""

import pytest

from test_torch_tpcds_window_share import check_both_paths, check_reference, data, on_cpu  # noqa: F401

from blaze_tpu_torch.tpcds import oracle as O

QUERIES = ["q39a", "q39b"]


@pytest.mark.parametrize("q", QUERIES)
def test_equals_the_reference_in_process(data, q):
    check_reference(data, q)


@pytest.mark.parametrize("q", QUERIES)
def test_equals_the_oracle_in_process_and_through_run_stages(data, q):
    kinds = check_both_paths(data, q)
    assert kinds.count("map") >= 4
    assert getattr(O, f"oracle_{q}")(data)[1] == []
