"""Independent numpy oracles for the port's TPC-H queries: the
port's own copy of ``oracle_q1``, ``oracle_q3`` and ``oracle_q6`` from
``blaze_tpu/tpch/oracle.py``.  Decimal math is unscaled int64 with
Spark semantics, coded independently of the engine."""

from __future__ import annotations

from typing import Dict, List, Tuple

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


def _sv(table: HostTable, name: str) -> List[str]:
    data, lengths = table[name]
    return [bytes(data[i, : lengths[i]]).decode() for i in range(data.shape[0])]


def oracle_q1(tables: Dict[str, HostTable]):
    """{(l_returnflag, l_linestatus): measures}: sums unscaled at their
    scales (2, 2, 4, 6), avgs unscaled at scale 6 with exact bignum
    HALF_UP, count_order."""
    li = tables["lineitem"]
    mask = li["l_shipdate"][0] <= _days(1998, 9, 2)
    rf = np.array(_sv(li, "l_returnflag"))
    ls = np.array(_sv(li, "l_linestatus"))
    qty = li["l_quantity"][0]
    ext = li["l_extendedprice"][0]
    disc = li["l_discount"][0]
    tax = li["l_tax"][0]
    disc_price = (ext * (100 - disc)).astype(object)          # scale 4
    charge = disc_price * (100 + tax).astype(object)          # scale 6
    out = {}
    for key in sorted(set(zip(rf[mask], ls[mask]))):
        m = mask & (rf == key[0]) & (ls == key[1])
        n = int(m.sum())

        def avg(vals):
            # q1 measures are non-negative: HALF_UP is floor(x + n/2)
            s = int(vals[m].astype(object).sum())
            return (s * 10**4 + n // 2) // n

        out[key] = dict(
            sum_qty=int(qty[m].sum()),
            sum_base_price=int(ext[m].sum()),
            sum_disc_price=int(disc_price[m].sum()),
            sum_charge=int(charge[m].sum()),
            avg_qty=avg(qty),
            avg_price=avg(ext),
            avg_disc=avg(disc),
            count_order=n,
        )
    return out


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
