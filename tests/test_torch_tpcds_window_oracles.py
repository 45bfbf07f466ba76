"""The port's TPC-DS window-family oracles (``blaze_tpu_torch/tpcds/
oracle.py``, numpy joins and groups) equal the reference's
(``blaze_tpu/tpcds/oracle.py``, Python loops over every fact row) at
SF 0.002 and SF 0.01: the same dicts and sets, every value exact.  The
port rewrote them so that they finish at SF1 (the reference's q67 loops
nine times over ``store_sales`` and ranks quadratically; q51 merges
per item quadratically), where ``chip_smoke.py`` holds the card to them;
``check_window_query`` is held to both paths there and in the
``test_torch_tpcds_window_*.py`` files."""

import pytest

from blaze_tpu.tpcds import generate_all as jax_generate_all
from blaze_tpu.tpcds import oracle as JO

from blaze_tpu_torch.tpcds import generate_all
from blaze_tpu_torch.tpcds import oracle as O
from blaze_tpu_torch.tpcds.queries import WINDOW_QUERIES


@pytest.fixture(scope="module")
def tables():
    return {s: generate_all(s) for s in (0.002, 0.01)}


@pytest.mark.parametrize("scale", [0.002, 0.01])
@pytest.mark.parametrize("q", WINDOW_QUERIES)
def test_numpy_oracle_equals_the_reference(tables, q, scale):
    data = tables[scale]
    got = getattr(O, f"oracle_{q}")(data)
    assert got == getattr(JO, f"oracle_{q}")(data)
    assert len(got) > 0


def test_generators_agree(tables):
    """The oracles read the port's tables; the reference's generator
    gives the same arrays at SF 0.01 (every table of the family)."""
    ref = jax_generate_all(0.01)
    for name in ("store_sales", "catalog_sales", "web_sales", "store_returns", "catalog_returns", "web_returns",
                 "call_center"):
        for c, v in tables[0.01][name].items():
            assert all((a is None and b is None) or (a == b).all() for a, b in zip(v, ref[name][c])), (name, c)
