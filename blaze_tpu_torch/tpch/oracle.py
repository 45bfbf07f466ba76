"""Independent numpy oracles for the 22 TPC-H queries: the port's own
copy of ``blaze_tpu/tpch/oracle.py``.  Decimal math is unscaled int64
with Spark semantics, coded independently of the engine."""

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


def oracle_q2(tables: Dict[str, HostTable]):
    re_, na, su, ps, part = (
        tables["region"], tables["nation"], tables["supplier"],
        tables["partsupp"], tables["part"],
    )
    europe = int(re_["r_regionkey"][0][_s_eq(re_, "r_name", "EUROPE")][0])
    nname = {
        int(k): v
        for k, v, r in zip(na["n_nationkey"][0], _sv(na, "n_name"), na["n_regionkey"][0])
        if int(r) == europe
    }
    s_info = {}
    snames = _sv(su, "s_name")
    saddr = _sv(su, "s_address")
    sphone = _sv(su, "s_phone")
    scom = _sv(su, "s_comment")
    for i in range(su["s_suppkey"][0].shape[0]):
        nk = int(su["s_nationkey"][0][i])
        if nk in nname:
            s_info[int(su["s_suppkey"][0][i])] = (
                int(su["s_acctbal"][0][i]), snames[i], nname[nk], saddr[i], sphone[i], scom[i]
            )
    ptype = _sv(part, "p_type")
    pmfgr = _sv(part, "p_mfgr")
    eligible_parts = {
        int(k): pmfgr[i]
        for i, k in enumerate(part["p_partkey"][0])
        if int(part["p_size"][0][i]) == 15 and ptype[i].endswith("BRASS")
    }
    # min cost per eligible part over european suppliers
    rows = []
    mincost: Dict[int, int] = {}
    for i in range(ps["ps_partkey"][0].shape[0]):
        pk = int(ps["ps_partkey"][0][i])
        sk = int(ps["ps_suppkey"][0][i])
        if pk in eligible_parts and sk in s_info:
            c = int(ps["ps_supplycost"][0][i])
            if pk not in mincost or c < mincost[pk]:
                mincost[pk] = c
    for i in range(ps["ps_partkey"][0].shape[0]):
        pk = int(ps["ps_partkey"][0][i])
        sk = int(ps["ps_suppkey"][0][i])
        if pk in eligible_parts and sk in s_info and int(ps["ps_supplycost"][0][i]) == mincost[pk]:
            bal, sn, nn, addr, ph, com = s_info[sk]
            rows.append((bal, sn, nn, pk, eligible_parts[pk]))
    rows.sort(key=lambda t: (-t[0], t[2], t[1], t[3]))
    return rows[:100]


def oracle_q7(tables: Dict[str, HostTable]):
    na, su, cu, orders, li = (
        tables["nation"], tables["supplier"], tables["customer"],
        tables["orders"], tables["lineitem"],
    )
    nname = dict(zip(na["n_nationkey"][0].tolist(), _sv(na, "n_name")))
    fr_ge = {k: v for k, v in nname.items() if v in ("FRANCE", "GERMANY")}
    s_nat = {int(s): fr_ge[int(n)] for s, n in zip(su["s_suppkey"][0], su["s_nationkey"][0]) if int(n) in fr_ge}
    c_nat = {int(c): fr_ge[int(n)] for c, n in zip(cu["c_custkey"][0], cu["c_nationkey"][0]) if int(n) in fr_ge}
    o_cust = dict(zip(orders["o_orderkey"][0].tolist(), orders["o_custkey"][0].tolist()))
    lm = (li["l_shipdate"][0] >= _days(1995, 1, 1)) & (li["l_shipdate"][0] <= _days(1996, 12, 31))
    rev = li["l_extendedprice"][0] * (100 - li["l_discount"][0])
    import datetime as _dt

    out: Dict[Tuple, int] = {}
    for i in np.nonzero(lm)[0]:
        sk = int(li["l_suppkey"][0][i])
        if sk not in s_nat:
            continue
        ok = int(li["l_orderkey"][0][i])
        ck = o_cust.get(ok)
        cn = c_nat.get(int(ck)) if ck is not None else None
        if cn is None:
            continue
        sn = s_nat[sk]
        if not ((sn == "FRANCE" and cn == "GERMANY") or (sn == "GERMANY" and cn == "FRANCE")):
            continue
        year = (_dt.date(1970, 1, 1) + _dt.timedelta(days=int(li["l_shipdate"][0][i]))).year
        k = (sn, cn, year)
        out[k] = out.get(k, 0) + int(rev[i])
    return dict(sorted(out.items()))


def oracle_q9(tables: Dict[str, HostTable]):
    part, su, li, ps, orders, na = (
        tables["part"], tables["supplier"], tables["lineitem"],
        tables["partsupp"], tables["orders"], tables["nation"],
    )
    green = {int(k) for k, nm in zip(part["p_partkey"][0], _sv(part, "p_name")) if "green" in nm}
    nname = dict(zip(na["n_nationkey"][0].tolist(), _sv(na, "n_name")))
    s_nat = {int(s): nname[int(n)] for s, n in zip(su["s_suppkey"][0], su["s_nationkey"][0])}
    cost = {}
    for i in range(ps["ps_partkey"][0].shape[0]):
        cost[(int(ps["ps_partkey"][0][i]), int(ps["ps_suppkey"][0][i]))] = int(ps["ps_supplycost"][0][i])
    o_date = dict(zip(orders["o_orderkey"][0].tolist(), orders["o_orderdate"][0].tolist()))
    import datetime as _dt

    rev = li["l_extendedprice"][0] * (100 - li["l_discount"][0])
    out: Dict[Tuple, int] = {}
    for i in range(li["l_orderkey"][0].shape[0]):
        pk = int(li["l_partkey"][0][i])
        if pk not in green:
            continue
        sk = int(li["l_suppkey"][0][i])
        key = (pk, sk)
        if key not in cost:
            continue
        ok = int(li["l_orderkey"][0][i])
        if ok not in o_date:
            continue
        nation = s_nat.get(sk)
        if nation is None:
            continue
        year = (_dt.date(1970, 1, 1) + _dt.timedelta(days=int(o_date[ok]))).year
        # amount = rev(scale4) - supplycost(scale2)*quantity(scale2) -> scale 4
        amount = int(rev[i]) - cost[key] * int(li["l_quantity"][0][i])
        k = (nation, year)
        out[k] = out.get(k, 0) + amount
    return out


def oracle_q11(tables: Dict[str, HostTable]):
    na, su, ps = tables["nation"], tables["supplier"], tables["partsupp"]
    germany = {int(k) for k, v in zip(na["n_nationkey"][0], _sv(na, "n_name")) if v == "GERMANY"}
    sk_ok = {int(s) for s, n in zip(su["s_suppkey"][0], su["s_nationkey"][0]) if int(n) in germany}
    by_part: Dict[int, int] = {}
    total = 0
    for i in range(ps["ps_partkey"][0].shape[0]):
        if int(ps["ps_suppkey"][0][i]) not in sk_ok:
            continue
        v = int(ps["ps_supplycost"][0][i]) * int(ps["ps_availqty"][0][i])  # scale 2
        pk = int(ps["ps_partkey"][0][i])
        by_part[pk] = by_part.get(pk, 0) + v
        total += v
    thr = (total / 10**2) * 0.0001
    out = {pk: v for pk, v in by_part.items() if v / 10**2 > thr}
    return out


def oracle_q13(tables: Dict[str, HostTable]):
    import re as _re

    cu, orders = tables["customer"], tables["orders"]
    rx = _re.compile("special.*requests")
    keep = [not rx.search(c) for c in _sv(orders, "o_comment")]
    per_cust: Dict[int, int] = {int(c): 0 for c in cu["c_custkey"][0]}
    for i in np.nonzero(np.array(keep))[0]:
        ck = int(orders["o_custkey"][0][i])
        if ck in per_cust:
            per_cust[ck] += 1
    hist: Dict[int, int] = {}
    for n in per_cust.values():
        hist[n] = hist.get(n, 0) + 1
    return hist


def oracle_q8(tables: Dict[str, HostTable]):
    re_, na, cu, orders, li, part, su = (
        tables["region"], tables["nation"], tables["customer"], tables["orders"],
        tables["lineitem"], tables["part"], tables["supplier"],
    )
    import datetime as _dt

    america = int(re_["r_regionkey"][0][_s_eq(re_, "r_name", "AMERICA")][0])
    am_nk = {int(k) for k, r in zip(na["n_nationkey"][0], na["n_regionkey"][0]) if int(r) == america}
    am_cust = {int(c) for c, n in zip(cu["c_custkey"][0], cu["c_nationkey"][0]) if int(n) in am_nk}
    om = (orders["o_orderdate"][0] >= _days(1995, 1, 1)) & (orders["o_orderdate"][0] <= _days(1996, 12, 31))
    o_info = {
        int(k): int(d)
        for k, c, d in zip(orders["o_orderkey"][0][om], orders["o_custkey"][0][om], orders["o_orderdate"][0][om])
        if int(c) in am_cust
    }
    steel = {int(k) for k, t in zip(part["p_partkey"][0], _sv(part, "p_type")) if t == "ECONOMY ANODIZED STEEL"}
    nname = dict(zip(na["n_nationkey"][0].tolist(), _sv(na, "n_name")))
    s_nat = {int(s): nname[int(n)] for s, n in zip(su["s_suppkey"][0], su["s_nationkey"][0])}
    rev = li["l_extendedprice"][0] * (100 - li["l_discount"][0])
    by_year: Dict[int, List[int]] = {}
    for i in range(li["l_orderkey"][0].shape[0]):
        if int(li["l_partkey"][0][i]) not in steel:
            continue
        ok = int(li["l_orderkey"][0][i])
        if ok not in o_info:
            continue
        year = (_dt.date(1970, 1, 1) + _dt.timedelta(days=o_info[ok])).year
        nat = s_nat[int(li["l_suppkey"][0][i])]
        e = by_year.setdefault(year, [0, 0])
        e[1] += int(rev[i])
        if nat == "BRAZIL":
            e[0] += int(rev[i])
    return {y: (b / t if t else 0.0) for y, (b, t) in sorted(by_year.items())}


def oracle_q15(tables: Dict[str, HostTable]):
    li, su = tables["lineitem"], tables["supplier"]
    m = (li["l_shipdate"][0] >= _days(1996, 1, 1)) & (li["l_shipdate"][0] < _days(1996, 4, 1))
    rev = li["l_extendedprice"][0] * (100 - li["l_discount"][0])
    by_supp: Dict[int, int] = {}
    for i in np.nonzero(m)[0]:
        sk = int(li["l_suppkey"][0][i])
        by_supp[sk] = by_supp.get(sk, 0) + int(rev[i])
    if not by_supp:
        return []
    mx = max(by_supp.values())
    snames = dict(zip(su["s_suppkey"][0].tolist(), _sv(su, "s_name")))
    rows = [(sk, snames.get(sk), v) for sk, v in by_supp.items() if v == mx and sk in snames]
    rows.sort()
    return rows


def oracle_q16(tables: Dict[str, HostTable]):
    import re as _re

    part, su, ps = tables["part"], tables["supplier"], tables["partsupp"]
    sizes = {49, 14, 23, 45, 19, 3, 36, 9}
    ptype = _sv(part, "p_type")
    pbrand = _sv(part, "p_brand")
    keep_part = {}
    for i, k in enumerate(part["p_partkey"][0]):
        if pbrand[i] != "Brand#45" and not ptype[i].startswith("MEDIUM POLISHED") and int(part["p_size"][0][i]) in sizes:
            keep_part[int(k)] = (pbrand[i], ptype[i], int(part["p_size"][0][i]))
    rx = _re.compile("special.*requests")
    bad = {int(s) for s, c in zip(su["s_suppkey"][0], _sv(su, "s_comment")) if rx.search(c)}
    groups: Dict[Tuple, set] = {}
    for i in range(ps["ps_partkey"][0].shape[0]):
        pk = int(ps["ps_partkey"][0][i])
        sk = int(ps["ps_suppkey"][0][i])
        if pk in keep_part and sk not in bad:
            groups.setdefault(keep_part[pk], set()).add(sk)
    return {k: len(v) for k, v in groups.items()}


def oracle_q17(tables: Dict[str, HostTable]):
    part, li = tables["part"], tables["lineitem"]
    pb = _sv(part, "p_brand")
    pc = _sv(part, "p_container")
    keys = {
        int(k)
        for i, k in enumerate(part["p_partkey"][0])
        if pb[i] == "Brand#23" and pc[i] == "MED BOX"
    }
    qty_by_part: Dict[int, List[int]] = {}
    rows = []
    for i in range(li["l_partkey"][0].shape[0]):
        pk = int(li["l_partkey"][0][i])
        if pk in keys:
            qty_by_part.setdefault(pk, []).append(i)
    total = 0
    for pk, idxs in qty_by_part.items():
        qs = [int(li["l_quantity"][0][i]) for i in idxs]
        # engine avg: exact int path or float; avg dec(16,6): shift 4
        s = sum(qs)
        n = len(qs)
        # replicate HALF_UP: use same float path as engine (dec(22,2)+4>18)
        f = float(s) * 1e4 / n
        avg_unscaled = int(np.where(f >= 0, np.floor(f + 0.5), np.ceil(f - 0.5)))
        threshold = 0.2 * (avg_unscaled / 10**6)
        for i in idxs:
            if int(li["l_quantity"][0][i]) / 10**2 < threshold:
                total += int(li["l_extendedprice"][0][i])
    return total / 10**2 / 7.0


def oracle_q18(tables: Dict[str, HostTable]):
    li, orders, cu = tables["lineitem"], tables["orders"], tables["customer"]
    qsum: Dict[int, int] = {}
    for i in range(li["l_orderkey"][0].shape[0]):
        ok = int(li["l_orderkey"][0][i])
        qsum[ok] = qsum.get(ok, 0) + int(li["l_quantity"][0][i])
    big = {ok: q for ok, q in qsum.items() if q > 300 * 100}
    cname = dict(zip(cu["c_custkey"][0].tolist(), _sv(cu, "c_name")))
    rows = []
    for i in range(orders["o_orderkey"][0].shape[0]):
        ok = int(orders["o_orderkey"][0][i])
        if ok in big:
            ck = int(orders["o_custkey"][0][i])
            rows.append((
                cname.get(ck), ck, ok, int(orders["o_orderdate"][0][i]),
                int(orders["o_totalprice"][0][i]), big[ok],
            ))
    rows.sort(key=lambda t: (-t[4], t[3], t[2]))
    return rows[:100]


def oracle_q20(tables: Dict[str, HostTable]):
    part, li, ps, su, na = (
        tables["part"], tables["lineitem"], tables["partsupp"],
        tables["supplier"], tables["nation"],
    )
    forest = {int(k) for k, nm in zip(part["p_partkey"][0], _sv(part, "p_name")) if nm.startswith("forest")}
    m = (li["l_shipdate"][0] >= _days(1994, 1, 1)) & (li["l_shipdate"][0] < _days(1995, 1, 1))
    used: Dict[Tuple[int, int], int] = {}
    for i in np.nonzero(m)[0]:
        k = (int(li["l_partkey"][0][i]), int(li["l_suppkey"][0][i]))
        used[k] = used.get(k, 0) + int(li["l_quantity"][0][i])
    qualified = set()
    for i in range(ps["ps_partkey"][0].shape[0]):
        pk, sk = int(ps["ps_partkey"][0][i]), int(ps["ps_suppkey"][0][i])
        if pk not in forest:
            continue
        u = used.get((pk, sk))
        if u is None:
            continue
        if int(ps["ps_availqty"][0][i]) > 0.5 * (u / 100):
            qualified.add(sk)
    canada = {int(k) for k, v in zip(na["n_nationkey"][0], _sv(na, "n_name")) if v == "CANADA"}
    rows = []
    snames = _sv(su, "s_name")
    saddr = _sv(su, "s_address")
    for i in range(su["s_suppkey"][0].shape[0]):
        sk = int(su["s_suppkey"][0][i])
        if sk in qualified and int(su["s_nationkey"][0][i]) in canada:
            rows.append((snames[i], saddr[i]))
    rows.sort()
    return rows


def oracle_q21(tables: Dict[str, HostTable]):
    li, orders, su, na = (
        tables["lineitem"], tables["orders"], tables["supplier"], tables["nation"],
    )
    saudi = {int(k) for k, v in zip(na["n_nationkey"][0], _sv(na, "n_name")) if v == "SAUDI ARABIA"}
    s_saudi = {int(s) for s, n in zip(su["s_suppkey"][0], su["s_nationkey"][0]) if int(n) in saudi}
    snames = dict(zip(su["s_suppkey"][0].tolist(), _sv(su, "s_name")))
    status_f = {int(k) for k, st in zip(orders["o_orderkey"][0], _sv(orders, "o_orderstatus")) if st == "F"}
    all_supp: Dict[int, set] = {}
    late_supp: Dict[int, set] = {}
    late_rows = []
    lat = li["l_receiptdate"][0] > li["l_commitdate"][0]
    for i in range(li["l_orderkey"][0].shape[0]):
        ok = int(li["l_orderkey"][0][i])
        sk = int(li["l_suppkey"][0][i])
        all_supp.setdefault(ok, set()).add(sk)
        if lat[i]:
            late_supp.setdefault(ok, set()).add(sk)
            late_rows.append((ok, sk))
    out: Dict[str, int] = {}
    for ok, sk in late_rows:
        if sk not in s_saudi or ok not in status_f:
            continue
        if len(all_supp[ok]) > 1 and len(late_supp[ok]) == 1:
            nm = snames[sk]
            out[nm] = out.get(nm, 0) + 1
    return out


def oracle_q22(tables: Dict[str, HostTable]):
    cu, orders = tables["customer"], tables["orders"]
    codes = {"13", "31", "23", "29", "30", "18", "17"}
    phones = _sv(cu, "c_phone")
    sel = [i for i in range(len(phones)) if phones[i][:2] in codes]
    pos = [i for i in sel if int(cu["c_acctbal"][0][i]) > 0]
    if not pos:
        return {}
    s = sum(int(cu["c_acctbal"][0][i]) for i in pos)
    f = float(s) * 1e4 / len(pos)
    avg_unscaled = int(np.where(f >= 0, np.floor(f + 0.5), np.ceil(f - 0.5)))  # scale 6
    thr = avg_unscaled / 10**6
    has_orders = set(orders["o_custkey"][0].tolist())
    out: Dict[str, List[int]] = {}
    for i in sel:
        bal = int(cu["c_acctbal"][0][i])
        if bal / 10**2 <= thr:
            continue
        if int(cu["c_custkey"][0][i]) in has_orders:
            continue
        e = out.setdefault(phones[i][:2], [0, 0])
        e[0] += 1
        e[1] += bal
    return out
