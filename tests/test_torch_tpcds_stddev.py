"""TPC-DS's sold-returned-rebought chain through the port: q17 (count,
average, ``stddev_samp`` and a CASE coefficient of variation of each
leg's quantity; at SF 0.002 three of its legs have two values or more,
so a stddev is defined, the others null), q25 (the legs' profit and
loss sums) and q29 (their quantity sums); two shuffled joins on
(item, ticket) and (customer, item).  Against the reference in process
(doubles within 1e-9 relative) and the port's oracle on both paths, as
``test_torch_tpcds_window_share.py`` describes."""

import pytest

from test_torch_tpcds_window_share import check_both_paths, check_reference, data, on_cpu, run  # noqa: F401

from blaze_tpu_torch.ops.fusion import optimize_plan
from blaze_tpu_torch.tpcds import build_query

from test_torch_tpcds_window_share import N_PARTS, port_scans

QUERIES = ["q17", "q25", "q29"]


@pytest.mark.parametrize("q", QUERIES)
def test_equals_the_reference_in_process(data, q):
    check_reference(data, q)


@pytest.mark.parametrize("q", QUERIES)
def test_equals_the_oracle_in_process_and_through_run_stages(data, q):
    kinds = check_both_paths(data, q)
    assert kinds.count("map") >= 4


def test_q17_has_defined_and_null_stddevs(data):
    got = run(optimize_plan(build_query("q17", port_scans(data), N_PARTS)))
    sds = [v for leg in ("store", "returns", "catalog") for v in got[f"{leg}_qty_stdev"]]
    assert any(v is not None for v in sds) and any(v is None for v in sds)
