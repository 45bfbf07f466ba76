"""TPC-DS's EXISTS queries through the port: q10, q35 and q69 (a
LEFT_SEMI join to the store buyers, then a web and a catalog EXISTENCE
join, each flag renamed from ``exists#0`` by ``RenameColumnsExec``, OR'd
or both negated).  Against the reference in process and the port's
oracle on both paths, as ``test_torch_tpcds_window_share.py`` describes."""

import pytest

from test_torch_tpcds_window_share import check_both_paths, check_reference, data, on_cpu  # noqa: F401

QUERIES = ["q10", "q35", "q69"]


@pytest.mark.parametrize("q", QUERIES)
def test_equals_the_reference_in_process(data, q):
    check_reference(data, q)


@pytest.mark.parametrize("q", QUERIES)
def test_equals_the_oracle_in_process_and_through_run_stages(data, q):
    kinds = check_both_paths(data, q)
    assert kinds.count("map") >= 2 and kinds.count("broadcast") >= 3
