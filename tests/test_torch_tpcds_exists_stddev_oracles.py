"""The port's numpy oracles of ``EXISTS_STDDEV_QUERIES`` against the
reference's Python ones (``blaze_tpu/tpcds/oracle.py``) at SF 0.002 and
0.01: the same rows, integers exactly, doubles (averages, stddevs,
covs) within 1e-9 relative.  The port's compute a variance exactly in
integers and round once; the reference's from a float sum of squares."""

import pytest

import blaze_tpu.tpcds.oracle as RO

from blaze_tpu_torch.tpcds import generate_all
from blaze_tpu_torch.tpcds import oracle as O
from blaze_tpu_torch.tpcds.queries import EXISTS_STDDEV_QUERIES

_DATA = {}


def _data(scale):
    if scale not in _DATA:
        _DATA[scale] = generate_all(scale)
    return _DATA[scale]


def _close(a, b) -> bool:
    if isinstance(a, float) and isinstance(b, float):
        return abs(a - b) <= 1e-9 * max(abs(a), abs(b))
    if isinstance(a, tuple) and isinstance(b, tuple):
        return len(a) == len(b) and all(_close(x, y) for x, y in zip(a, b))
    return a == b


@pytest.mark.parametrize("scale", [0.002, 0.01])
@pytest.mark.parametrize("q", EXISTS_STDDEV_QUERIES)
def test_oracle_equals_the_reference(q, scale):
    data = _data(scale)
    mine, ref = getattr(O, f"oracle_{q}")(data), getattr(RO, f"oracle_{q}")(data)
    if q in ("q39a", "q39b"):
        mine, near = mine
        assert near == []
    if isinstance(ref, dict):
        assert set(mine) == set(ref) and ref
        assert all(_close(mine[k], ref[k]) for k in ref)
    else:
        assert mine == ref and ref
