"""The port's oracles of TPC-DS's rollup and union family
(``blaze_tpu_torch/tpcds/oracle.py``, numpy joins and groups) equal the
reference's (``blaze_tpu/tpcds/oracle.py``, Python loops over every fact
row) at SF 0.002 and SF 0.01: the same dicts, every integer, decimal and
string exact, q18's double averages within 1e-9 relative (the
reference sums the doubles one by one, the port's oracle exact cents);
each on a nonempty result, but q23a and q23b at SF 0.01, which are
empty in both (ROADMAP queue C, reference defect 14).  The port rewrote
them so that they finish at SF1 (q22's loop runs over 23.49M inventory
rows there), where ``chip_smoke.py`` holds the card to them; and the
generators agree on every table the family reads."""

import math

import pytest

from blaze_tpu.tpcds import generate_all as jax_generate_all
from blaze_tpu.tpcds import oracle as JO

from blaze_tpu_torch.tpcds import generate_all
from blaze_tpu_torch.tpcds import oracle as O
from blaze_tpu_torch.tpcds.queries import ROLLUP_UNION_QUERIES


@pytest.fixture(scope="module")
def tables():
    return {s: generate_all(s) for s in (0.002, 0.01)}


def _same(a, b) -> bool:
    if isinstance(a, float) and isinstance(b, float):
        return a == b or (math.isnan(a) and math.isnan(b)) or abs(a - b) <= 1e-9 * max(abs(a), abs(b))
    if isinstance(a, tuple) and isinstance(b, tuple):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


@pytest.mark.parametrize("scale", [0.002, 0.01])
@pytest.mark.parametrize("q", ROLLUP_UNION_QUERIES)
def test_numpy_oracle_equals_the_reference(tables, q, scale):
    data = tables[scale]
    got = getattr(O, f"oracle_{q}")(data)
    want = getattr(JO, f"oracle_{q}")(data)
    if q == "q18":
        assert got.keys() == want.keys() and all(_same(got[k], want[k]) for k in got)
    else:
        assert got == want
    empty = got is None or (isinstance(got, dict) and not got)
    assert empty == (q in ("q23a", "q23b") and scale == 0.01)


def test_generators_agree(tables):
    """The oracles read the port's tables; the reference's generator
    gives the same arrays at SF 0.01 (every table of the family that
    ``test_torch_tpcds_window_oracles.py`` does not hold)."""
    ref = jax_generate_all(0.01)
    for name in ("inventory", "warehouse", "catalog_page", "web_site", "web_page", "promotion", "ship_mode",
                 "time_dim", "customer", "customer_address", "customer_demographics", "household_demographics",
                 "store", "item", "date_dim"):
        assert tables[0.01][name].keys() == ref[name].keys(), name
        for c, v in tables[0.01][name].items():
            assert all((a is None and b is None) or (a == b).all() for a, b in zip(v, ref[name][c])), (name, c)
