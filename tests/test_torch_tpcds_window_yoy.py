"""TPC-DS's window queries through the port, part 3: q47 and q57 (the
whole-partition ``avg`` window stacked under a ``lag``/``lead`` window
over the same sort; the optimizer fuses the upper window over a
``BufferPartitionExec`` fed by the lower one) and q70 (ROLLUP over
store geography, ranked within the parent level; here for the files'
time balance, beside q36 and q86 in ``test_torch_tpcds_window_rollup.py``).
Against the reference in process and the port's oracle on both paths,
as ``test_torch_tpcds_window_share.py`` describes."""

import pytest

from test_torch_tpcds_window_share import check_both_paths, check_reference, data, on_cpu  # noqa: F401

QUERIES = ["q47", "q57", "q70"]


@pytest.mark.parametrize("q", QUERIES)
def test_equals_the_reference_in_process(data, q):
    check_reference(data, q)


@pytest.mark.parametrize("q", QUERIES)
def test_equals_the_oracle_in_process_and_through_run_stages(data, q):
    check_both_paths(data, q)
