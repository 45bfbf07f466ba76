"""Independent numpy oracles for the port's TPC-H queries: the
port's own copy of ``oracle_q1``, ``q3``, ``q4``, ``q5``, ``q6``,
``q10``, ``q12``, ``q14`` and ``q19`` from ``blaze_tpu/tpch/oracle.py``.
Decimal math is unscaled int64 with Spark semantics, coded
independently of the engine."""

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


def _s_isin(table: HostTable, name: str, values) -> np.ndarray:
    m = np.zeros(next(iter(table.values()))[0].shape[0], bool)
    for v in values:
        m = m | _s_eq(table, name, v)
    return m


def _round_half_up(x: np.ndarray) -> np.ndarray:
    return np.where(x >= 0, np.floor(x + 0.5), np.ceil(x - 0.5)).astype(np.int64)


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


def oracle_q4(tables: Dict[str, HostTable]):
    orders, li = tables["orders"], tables["lineitem"]
    om = (orders["o_orderdate"][0] >= _days(1993, 7, 1)) & (
        orders["o_orderdate"][0] < _days(1993, 10, 1)
    )
    lm = li["l_commitdate"][0] < li["l_receiptdate"][0]
    has_line = set(li["l_orderkey"][0][lm].tolist())
    pr = np.array(_sv(orders, "o_orderpriority"))
    out: Dict[str, int] = {}
    for i in np.nonzero(om)[0]:
        if int(orders["o_orderkey"][0][i]) in has_line:
            out[pr[i]] = out.get(pr[i], 0) + 1
    return dict(sorted(out.items()))


def oracle_q5(tables: Dict[str, HostTable]):
    na, re_, su, cu, orders, li = (
        tables["nation"], tables["region"], tables["supplier"],
        tables["customer"], tables["orders"], tables["lineitem"],
    )
    asia = int(re_["r_regionkey"][0][_s_eq(re_, "r_name", "ASIA")][0])
    nk = na["n_nationkey"][0][na["n_regionkey"][0] == asia]
    nname = {int(k): v for k, v in zip(na["n_nationkey"][0], _sv(na, "n_name")) if int(na["n_regionkey"][0][int(k)]) == asia}
    s_nation = {int(s): int(n) for s, n in zip(su["s_suppkey"][0], su["s_nationkey"][0]) if int(n) in nname}
    c_nation = {int(c): int(n) for c, n in zip(cu["c_custkey"][0], cu["c_nationkey"][0])}
    om = (orders["o_orderdate"][0] >= _days(1994, 1, 1)) & (
        orders["o_orderdate"][0] < _days(1995, 1, 1)
    )
    o_cust = {int(k): int(c) for k, c in zip(orders["o_orderkey"][0][om], orders["o_custkey"][0][om])}
    rev = li["l_extendedprice"][0] * (100 - li["l_discount"][0])
    out: Dict[str, int] = {}
    for i in range(li["l_orderkey"][0].shape[0]):
        ok = int(li["l_orderkey"][0][i])
        if ok not in o_cust:
            continue
        sk = int(li["l_suppkey"][0][i])
        if sk not in s_nation:
            continue
        ck = o_cust[ok]
        if c_nation.get(ck) != s_nation[sk]:
            continue
        name = nname[s_nation[sk]]
        out[name] = out.get(name, 0) + int(rev[i])
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def oracle_q10(tables: Dict[str, HostTable]):
    cu, orders, li, na = tables["customer"], tables["orders"], tables["lineitem"], tables["nation"]
    om = (orders["o_orderdate"][0] >= _days(1993, 10, 1)) & (
        orders["o_orderdate"][0] < _days(1994, 1, 1)
    )
    o_cust = {int(k): int(c) for k, c in zip(orders["o_orderkey"][0][om], orders["o_custkey"][0][om])}
    lm = _s_eq(li, "l_returnflag", "R")
    rev = li["l_extendedprice"][0] * (100 - li["l_discount"][0])
    by_cust: Dict[int, int] = {}
    for i in np.nonzero(lm)[0]:
        ok = int(li["l_orderkey"][0][i])
        if ok in o_cust:
            c = o_cust[ok]
            by_cust[c] = by_cust.get(c, 0) + int(rev[i])
    nname = dict(zip(na["n_nationkey"][0].tolist(), _sv(na, "n_name")))
    ckeys = cu["c_custkey"][0]
    cname = _sv(cu, "c_name")
    rows = []
    for i in range(ckeys.shape[0]):
        ck = int(ckeys[i])
        if ck in by_cust:
            rows.append((ck, cname[i], int(cu["c_acctbal"][0][i]), nname[int(cu["c_nationkey"][0][i])], by_cust[ck]))
    rows.sort(key=lambda t: (-t[4], t[0]))
    return rows[:20]


def oracle_q12(tables: Dict[str, HostTable]):
    li, orders = tables["lineitem"], tables["orders"]
    m = (
        _s_isin(li, "l_shipmode", ["MAIL", "SHIP"])
        & (li["l_commitdate"][0] < li["l_receiptdate"][0])
        & (li["l_shipdate"][0] < li["l_commitdate"][0])
        & (li["l_receiptdate"][0] >= _days(1994, 1, 1))
        & (li["l_receiptdate"][0] < _days(1995, 1, 1))
    )
    urgent = {
        int(k)
        for k, p in zip(orders["o_orderkey"][0], _sv(orders, "o_orderpriority"))
        if p in ("1-URGENT", "2-HIGH")
    }
    all_keys = set(orders["o_orderkey"][0].tolist())
    sm = np.array(_sv(li, "l_shipmode"))
    out: Dict[str, List[int]] = {}
    for i in np.nonzero(m)[0]:
        ok = int(li["l_orderkey"][0][i])
        if ok not in all_keys:
            continue
        mode = sm[i]
        hl = out.setdefault(mode, [0, 0])
        if ok in urgent:
            hl[0] += 1
        else:
            hl[1] += 1
    return dict(sorted(out.items()))


def oracle_q14(tables: Dict[str, HostTable]):
    li, part = tables["lineitem"], tables["part"]
    m = (li["l_shipdate"][0] >= _days(1995, 9, 1)) & (li["l_shipdate"][0] < _days(1995, 10, 1))
    promo_part = {
        int(k) for k, t in zip(part["p_partkey"][0], _sv(part, "p_type")) if t.startswith("PROMO")
    }
    all_parts = set(part["p_partkey"][0].tolist())
    rev = li["l_extendedprice"][0] * (100 - li["l_discount"][0])
    sp = sr = 0
    for i in np.nonzero(m)[0]:
        pk = int(li["l_partkey"][0][i])
        if pk not in all_parts:
            continue
        r = int(rev[i])
        sr += r
        if pk in promo_part:
            sp += r
    # engine: (100.00 dec(5,2) * sp dec(36,4) -> dec(38,6) exact) / sr
    # dec(36,4) -> dec(38,6) via float64
    num = 10000 * sp  # scale 6
    fa = float(num) / 10**6
    fb = float(sr) / 10**4 if sr else 1.0
    q = fa / fb * 10**6
    return int(_round_half_up(np.array([q]))[0]), sp, sr


def oracle_q19(tables: Dict[str, HostTable]):
    li, part = tables["lineitem"], tables["part"]
    lm = _s_isin(li, "l_shipmode", ["AIR", "REG AIR"]) & _s_eq(li, "l_shipinstruct", "DELIVER IN PERSON")
    brand = dict(zip(part["p_partkey"][0].tolist(), _sv(part, "p_brand")))
    container = dict(zip(part["p_partkey"][0].tolist(), _sv(part, "p_container")))
    size = dict(zip(part["p_partkey"][0].tolist(), part["p_size"][0].tolist()))
    rev = li["l_extendedprice"][0] * (100 - li["l_discount"][0])
    total = 0
    for i in np.nonzero(lm)[0]:
        pk = int(li["l_partkey"][0][i])
        if pk not in brand:
            continue
        q = int(li["l_quantity"][0][i])
        b, c, s = brand[pk], container[pk], size[pk]
        ok = (
            (b == "Brand#12" and c in ("SM CASE", "SM BOX", "SM PACK", "SM PKG") and 100 <= q <= 1100 and 1 <= s <= 5)
            or (b == "Brand#23" and c in ("MED BAG", "MED BOX", "MED PKG", "MED PACK") and 1000 <= q <= 2000 and 1 <= s <= 10)
            or (b == "Brand#34" and c in ("LG CASE", "LG BOX", "LG PACK", "LG PKG") and 2000 <= q <= 3000 and 1 <= s <= 15)
        )
        if ok:
            total += int(rev[i])
    return total
