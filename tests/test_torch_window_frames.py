"""The rest of ``tests/test_torch_window.py``'s window specs, in a file
of their own so that each file stays under a minute: a decimal order
key over the whole table, a descending date order key (RANGE frames on
a date) and two order keys (no RANGE frame), every kind the spec allows
against the reference's ``WindowExec``."""

import pytest

from test_torch_window import _table, check_spec


@pytest.fixture(scope="module")
def table():
    return _table()


@pytest.mark.parametrize("spec", ["order_d", "part_g_order_dt_desc", "part_k_order_o_f"])
def test_every_kind_equals_the_reference(table, spec):
    check_spec(table, spec)
