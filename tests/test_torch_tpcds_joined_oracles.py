"""The port's numpy oracles of ``JOINED_QUERIES`` against the reference's
Python ones (``blaze_tpu/tpcds/oracle.py``) at SF 0.002 and 0.01: the
same rows, integers exactly, doubles within 1e-9 relative.  Where the
reference returns a set (q1, q30, q81, q74, q11, q4), the port returns
the rows as a sorted list, one a (customer, location) for q1, q30 and
q81 (a customer may pass at two locations); they are compared as sets.

Then q31 through the port: six (channel, quarter) county sums
shuffle-joined on the county, two CASE-guarded growth comparisons,
against the reference in process and the port's oracle on both paths,
as ``test_torch_tpcds_joined_share.py`` describes.  Its reference
compile is the family's longest (about 53 s serially): it shares this
module, whose many quick tests pytest-xdist hands out among the first
(``--dist loadfile`` sends the files with the most tests first), so that
no worker starts it last."""

import pytest

import blaze_tpu.tpcds.oracle as RO
from test_torch_tpcds_joined_share import check
from test_torch_tpcds_report_oracles import _close
from test_torch_tpcds_report_share import tables
from test_torch_tpcds_window_share import on_cpu  # noqa: F401

from blaze_tpu_torch.tpcds import oracle as O
from blaze_tpu_torch.tpcds.queries import JOINED_QUERIES


@pytest.mark.parametrize("scale", [0.002, 0.01])
@pytest.mark.parametrize("q", JOINED_QUERIES)
def test_oracle_equals_the_reference(q, scale):
    data = tables(scale)
    mine, ref = getattr(O, f"oracle_{q}")(data), getattr(RO, f"oracle_{q}")(data)
    if isinstance(mine, list):
        assert len(mine) > 0 and set(mine) == ref
    else:
        assert mine and _close(mine, ref)


@pytest.mark.parametrize("q", ["q31"])
def test_equals_the_reference_and_the_oracle_on_both_paths(q):
    kinds = check(q)
    assert kinds.count("map") >= 6 and kinds[-1] == "result"
