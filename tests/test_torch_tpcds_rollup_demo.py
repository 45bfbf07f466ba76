"""TPC-DS's rollup and union queries through the port, part 1: q27
(ROLLUP(i_item_id, s_state) as an ``ExpandExec`` with typed null
strings and a grouping id, four decimal ``avg``s) and q18 (a four-level
rollup over item and customer geography, ``avg`` of casts to double
over five broadcast joins).  Against the reference in process and the
port's oracle on both paths, as ``test_torch_tpcds_window_share.py``
describes; and every rollup level present with its grouping id."""

import pytest

from test_torch_tpcds_window_share import (  # noqa: F401
    N_PARTS, check_both_paths, check_reference, data, on_cpu, port_scans, run,
)

from blaze_tpu_torch.tpcds import build_query

QUERIES = ["q27", "q18"]


@pytest.mark.parametrize("q", QUERIES)
def test_equals_the_reference_in_process(data, q):
    check_reference(data, q)


@pytest.mark.parametrize("q", QUERIES)
def test_equals_the_oracle_in_process_and_through_run_stages(data, q):
    kinds = check_both_paths(data, q)
    assert kinds.count("broadcast") >= 4 and kinds[-1] == "result"


@pytest.mark.parametrize("q, dims, gids", [
    ("q27", ("i_item_id", "s_state"), {0, 1, 3}),
    ("q18", ("i_item_id", "ca_county", "ca_state"), {0, 1, 2, 3}),
])
def test_every_level_nulls_the_dimensions_it_rolls_up(data, q, dims, gids):
    """A row of grouping id g has a null in each dimension the level
    drops (q27's ids are Spark's bit masks 0, 1, 3; q18's count the
    dropped dimensions) and the grand total is one row."""
    got = run(build_query(q, port_scans(data), N_PARTS))
    assert set(got["g_id"]) == gids
    for r, g in enumerate(got["g_id"]):
        dropped = bin(g).count("1") if q == "q27" else g
        nulls = [got[d][r] is None for d in dims]
        assert nulls == [k >= len(dims) - dropped for k in range(len(dims))], (g, nulls)
    assert sum(1 for g in got["g_id"] if g == max(gids)) == 1
