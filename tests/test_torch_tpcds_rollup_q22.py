"""TPC-DS's rollup and union queries through the port, part 2: q22
(``inventory``, the largest table the port scans: a five-level ROLLUP
over the product hierarchy of ``avg(inv_quantity_on_hand)``, the 100
smallest averages).  Against the reference in process and the port's
oracle on both paths, as ``test_torch_tpcds_window_share.py``
describes."""

from test_torch_tpcds_window_share import (  # noqa: F401
    N_PARTS, check_both_paths, check_reference, data, on_cpu, port_scans, run,
)

from blaze_tpu_torch.tpcds import build_query
from blaze_tpu_torch.tpcds import oracle as O


def test_equals_the_reference_in_process(data):
    check_reference(data, "q22")


def test_equals_the_oracle_in_process_and_through_run_stages(data):
    check_both_paths(data, "q22")


def test_every_level_is_in_the_oracle(data):
    """The oracle has all five levels, the grand total once; the top
    100 are its smallest averages."""
    exp = O.oracle_q22(data)
    assert {k[4] for k in exp} == {0, 1, 2, 3, 4} and sum(1 for k in exp if k[4] == 4) == 1
    got = run(build_query("q22", port_scans(data), N_PARTS))
    assert got["qoh"] == sorted(exp.values())[:100]
