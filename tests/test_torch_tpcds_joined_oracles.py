"""The port's numpy oracles of ``JOINED_QUERIES`` against the reference's
Python ones (``blaze_tpu/tpcds/oracle.py``) at SF 0.002 and 0.01: the
same rows, integers exactly, doubles within 1e-9 relative.  Where the
reference returns a set (q1, q30, q81, q74, q11, q4), the port returns
the rows as a sorted list, one a (customer, location) for q1, q30 and
q81 (a customer may pass at two locations); they are compared as sets."""

import pytest

import blaze_tpu.tpcds.oracle as RO
from test_torch_tpcds_report_oracles import _close
from test_torch_tpcds_report_share import tables

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
