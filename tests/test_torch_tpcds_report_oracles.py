"""The port's numpy oracles of ``REPORT_QUERIES`` against the
reference's Python ones (``blaze_tpu/tpcds/oracle.py``) at SF 0.002 and
0.01: the same rows, integers exactly, doubles within 1e-9 relative.
The reference's q9 and q8 take their constants as arguments; the
port's read its own copies (held equal to the reference's by
``test_constants_equal_the_reference``).  The reference's q43 and q61 write 0
for a sum of no sale (a weekday on which a store sold nothing; q61's
promotional revenue), where SQL's is null: the port's oracles, and both
engines, give null (at SF 0.002)."""

import pytest

import blaze_tpu.tpcds.oracle as RO
import blaze_tpu.tpcds.queries as RQ

from test_torch_tpcds_report_share import tables

from blaze_tpu_torch.tpcds import oracle as O
from blaze_tpu_torch.tpcds.queries import REPORT_QUERIES


def _close(a, b) -> bool:
    if isinstance(a, float) and isinstance(b, float):
        return abs(a - b) <= 1e-9 * max(abs(a), abs(b))
    if isinstance(a, (tuple, list)) and isinstance(b, (tuple, list)):
        return len(a) == len(b) and all(_close(x, y) for x, y in zip(a, b))
    if isinstance(a, dict) and isinstance(b, dict):
        return set(a) == set(b) and all(_close(a[k], b[k]) for k in a)
    return a == b


def _reference(q, data):
    fn = getattr(RO, f"oracle_{q}")
    if q == "q9":
        return fn(data, RQ.Q9_THRESHOLDS)
    if q == "q8":
        return fn(data, RQ.Q8_ZIPS, RQ.Q8_MIN_PREFERRED)
    return fn(data)


@pytest.mark.parametrize("scale", [0.002, 0.01])
@pytest.mark.parametrize("q", REPORT_QUERIES)
def test_oracle_equals_the_reference(q, scale):
    data = tables(scale)
    mine, ref = getattr(O, f"oracle_{q}")(data), _reference(q, data)
    if q == "q43":
        mine = {k: [0 if v is None else v for v in sums] for k, sums in mine.items()}
    if q == "q61":
        mine = tuple(0 if v is None else v for v in mine)
    assert _close(mine, ref)


def test_constants_equal_the_reference():
    from blaze_tpu_torch.tpcds import queries as Q

    for name in ("Q9_THRESHOLDS", "Q8_ZIPS", "Q8_MIN_PREFERRED", "Q13_BANDS", "Q13_STATE_BANDS", "Q15_ZIPS",
                 "Q32_MFG_MAX"):
        assert getattr(Q, name) == getattr(RQ, name), name
