"""Independent numpy oracles for the port's TPC-H queries: the
port's own copy of ``oracle_q3`` and ``oracle_q6`` from
``blaze_tpu/tpch/oracle.py``.  Decimal math is unscaled int64 with
Spark semantics, coded independently of the engine."""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from ..batch import HostTable
from .datagen import _days


def _s_eq(table: HostTable, name: str, value: str) -> np.ndarray:
    data, lengths = table[name]
    b = value.encode()
    if len(b) > data.shape[1]:
        return np.zeros(data.shape[0], bool)
    m = lengths == len(b)
    for i, ch in enumerate(b):
        m = m & (data[:, i] == ch)
    return m


def oracle_q3(tables: Dict[str, HostTable]):
    """Top 10 (l_orderkey, revenue, o_orderdate, o_shippriority) rows,
    revenue unscaled at scale 4."""
    cu, orders, li = tables["customer"], tables["orders"], tables["lineitem"]
    bld = _s_eq(cu, "c_mktsegment", "BUILDING")
    cust_keys = set(cu["c_custkey"][0][bld].tolist())
    om = (orders["o_orderdate"][0] < _days(1995, 3, 15)) & np.isin(
        orders["o_custkey"][0], list(cust_keys) or [0]
    )
    o_by_key = {}
    for i in np.nonzero(om)[0]:
        o_by_key[int(orders["o_orderkey"][0][i])] = (
            int(orders["o_orderdate"][0][i]),
            int(orders["o_shippriority"][0][i]),
        )
    lm = li["l_shipdate"][0] > _days(1995, 3, 15)
    rev = li["l_extendedprice"][0] * (100 - li["l_discount"][0])
    agg: Dict[Tuple, int] = {}
    for i in np.nonzero(lm)[0]:
        ok = int(li["l_orderkey"][0][i])
        if ok in o_by_key:
            d, sp = o_by_key[ok]
            k = (ok, d, sp)
            agg[k] = agg.get(k, 0) + int(rev[i])
    rows = [(ok, r, d, sp) for (ok, d, sp), r in agg.items()]
    rows.sort(key=lambda t: (-t[1], t[2], t[0]))
    return rows[:10]


def oracle_q6(tables: Dict[str, HostTable]) -> int:
    """sum(l_extendedprice * l_discount), unscaled at scale 4."""
    li = tables["lineitem"]
    m = (
        (li["l_shipdate"][0] >= _days(1994, 1, 1))
        & (li["l_shipdate"][0] < _days(1995, 1, 1))
        & (li["l_discount"][0] >= 5)
        & (li["l_discount"][0] <= 7)
        & (li["l_quantity"][0] < 2400)
    )
    return int((li["l_extendedprice"][0][m] * li["l_discount"][0][m]).sum())
