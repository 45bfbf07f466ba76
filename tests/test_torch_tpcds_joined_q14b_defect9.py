"""Reference defect 9 on TPC-DS q14b (as on q14a,
``test_torch_tpcds_union_q14a.py``): with its plan cache on, the
reference scales the decimal average of the three channels' sales
again (by 10^6), so no cell passes it and q14b returns no row; the
port's rows are the oracle's.  ``test_torch_tpcds_joined_q14b.py``
holds the port to the reference with the cache off (a file of its own
keeps each under 60 s)."""

from test_torch_tpcds_joined_share import data
from test_torch_tpcds_window_share import N_PARTS, on_cpu, port_scans, reference_rows, run  # noqa: F401

from blaze_tpu_torch.tpcds import build_query
from blaze_tpu_torch.tpcds import oracle as O


def test_reference_plan_cache_scales_q14bs_average_twice():
    port = run(build_query("q14b", port_scans(data()), N_PARTS))
    O.check_query("q14b", port, O.oracle_q14b(data()))
    assert reference_rows(data(), "q14b")["sales"] == []
