"""TPC-DS's window queries through the port, part 4: q36 and q86
(ROLLUP through ``ExpandExec`` with typed null literals, then ``rank``
within the parent level, whose partition key is a null string above
level 0; q70, the same tail over store geography, is in
``test_torch_tpcds_window_yoy.py``).  Against the reference in process
and the port's oracle on both paths, as
``test_torch_tpcds_window_share.py`` describes; and every level of the
three rollups ranked within its parent."""

import pytest

from test_torch_tpcds_window_share import check_both_paths, check_reference, data, on_cpu, run  # noqa: F401

from blaze_tpu_torch.tpcds import build_query
from blaze_tpu_torch.tpcds import oracle as O
from test_torch_tpcds_window_share import N_PARTS, port_scans

QUERIES = ["q36", "q86"]


@pytest.mark.parametrize("q", QUERIES)
def test_equals_the_reference_in_process(data, q):
    check_reference(data, q)


@pytest.mark.parametrize("q", QUERIES)
def test_equals_the_oracle_in_process_and_through_run_stages(data, q):
    check_both_paths(data, q)


@pytest.mark.parametrize("q", ["q36", "q86", "q70"])
def test_every_rollup_level_ranks_within_its_parent(data, q):
    """All three levels come out, the null parent of levels 1 and 2 one
    partition each: their ranks run 1, 2, ... over all their rows."""
    got = run(build_query(q, port_scans(data), N_PARTS))
    exp = getattr(O, f"oracle_{q}")(data)
    assert set(got["lochierarchy"]) == {0, 1, 2} and len(exp) <= 100
    for loch in (1, 2):
        ranks = sorted(r for r, lv in zip(got["rank_within_parent"], got["lochierarchy"]) if lv == loch)
        assert ranks[0] == 1 and len(ranks) == sum(1 for k in exp if k[2] == loch)
