"""Independent numpy/python oracles for the port's TPC-DS queries, each
re-implemented from the spec over the generated host tables, no engine
code reused: its own copy of ``blaze_tpu/tpcds/oracle.py``'s
``oracle_q3`` and ``oracle_q7``, and of the window family's oracles
(q12, q20, q98, q53, q63, q89, q47, q57, q36, q86, q70, q67, q44, q49,
q51), which return what the reference's return.  The reference's loop
in Python over every fact row (q67's nine times, and its ranks and
q51's per-item merges are quadratic), which does not finish at SF1;
these join and group the fact rows with numpy (sorted-key joins,
sums by ``np.add.reduceat`` over a lexsort, exact in int64) and keep
Python for the groups."""

from __future__ import annotations

import datetime
from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..tpch.oracle import _round_half_up, _s_eq, _sv


def _brand_rollup(tables, *, year, moy, item_filter_col, item_filter_val, group_cols):
    """Shared star-join: date slice × item slice × store_sales, grouped
    sums of ss_ext_sales_price."""
    dd = tables["date_dim"]
    it = tables["item"]
    ss = tables["store_sales"]

    d_mask = dd["d_moy"][0] == moy
    if year is not None:
        d_mask &= dd["d_year"][0] == year
    d_sk = dd["d_date_sk"][0][d_mask]
    d_year_by_sk = dict(zip(d_sk.tolist(), dd["d_year"][0][d_mask].tolist()))

    i_mask = it[item_filter_col][0] == item_filter_val
    i_sk = it["i_item_sk"][0][i_mask]
    group_by_sk = {}
    gvals = []
    for gc in group_cols:
        if it[gc][1] is not None:  # string col
            gvals.append(np.array(_sv(it, gc)))
        else:
            gvals.append(it[gc][0])
    for idx in np.flatnonzero(i_mask):
        group_by_sk[int(it["i_item_sk"][0][idx])] = tuple(
            (gv[idx] if isinstance(gv[idx], str) else int(gv[idx])) for gv in gvals
        )

    sums: Dict[tuple, int] = {}
    date_sk = ss["ss_sold_date_sk"][0]
    item_sk = ss["ss_item_sk"][0]
    price = ss["ss_ext_sales_price"][0]
    for i in range(date_sk.shape[0]):
        dsk = int(date_sk[i])
        isk = int(item_sk[i])
        if dsk not in d_year_by_sk or isk not in group_by_sk:
            continue
        key = (d_year_by_sk[dsk],) + group_by_sk[isk]
        sums[key] = sums.get(key, 0) + int(price[i])
    return sums


def oracle_q3(tables):
    return _brand_rollup(
        tables, year=None, moy=11,
        item_filter_col="i_manufact_id", item_filter_val=128,
        group_cols=["i_brand_id", "i_brand"],
    )


def oracle_q7(tables):
    cd = tables["customer_demographics"]
    cd_ok = (
        _s_eq(cd, "cd_gender", "M")
        & _s_eq(cd, "cd_marital_status", "S")
        & _s_eq(cd, "cd_education_status", "College")
    )
    cd_set = set(cd["cd_demo_sk"][0][cd_ok].tolist())

    dd = tables["date_dim"]
    d_set = set(dd["d_date_sk"][0][dd["d_year"][0] == 2000].tolist())

    pr = tables["promotion"]
    p_ok = _s_eq(pr, "p_channel_email", "N") | _s_eq(pr, "p_channel_event", "N")
    p_set = set(pr["p_promo_sk"][0][p_ok].tolist())

    it = tables["item"]
    item_id_by_sk = dict(zip(it["i_item_sk"][0].tolist(), _sv(it, "i_item_id")))

    ss = tables["store_sales"]
    acc: Dict[str, list] = {}
    cols = [ss[c][0] for c in (
        "ss_cdemo_sk", "ss_sold_date_sk", "ss_promo_sk", "ss_item_sk",
        "ss_quantity", "ss_list_price", "ss_coupon_amt", "ss_sales_price",
    )]
    for i in range(cols[0].shape[0]):
        if int(cols[0][i]) not in cd_set:
            continue
        if int(cols[1][i]) not in d_set:
            continue
        if int(cols[2][i]) not in p_set:
            continue
        iid = item_id_by_sk.get(int(cols[3][i]))
        if iid is None:
            continue
        acc.setdefault(iid, []).append(tuple(int(c[i]) for c in cols[4:]))

    out = {}
    for iid, rows in acc.items():
        n = len(rows)

        def avg_dec(idx):
            # decimal avg: result scale +4, float64 HALF_UP (engine path)
            s = sum(r[idx] for r in rows)
            f = float(s) * float(10**4) / n
            return int(_round_half_up(np.array([f]))[0])

        avg_qty = float(sum(r[0] for r in rows)) / n  # int avg -> float64
        out[iid] = (avg_qty, avg_dec(1), avg_dec(2), avg_dec(3), n)
    return out


# ------------------------------------------------------------ numpy joins


def _rows_of(keys: np.ndarray, probe: np.ndarray) -> np.ndarray:
    """Per probe value, the row of ``keys`` (unique) that holds it; -1
    where none does."""
    if keys.shape[0] == 0:
        return np.full(probe.shape[0], -1, np.int64)
    order = np.argsort(keys, kind="stable")
    sk = keys[order]
    pos = np.clip(np.searchsorted(sk, probe), 0, sk.shape[0] - 1)
    return np.where(sk[pos] == probe, order[pos], -1)


def _codes(labels: Sequence) -> Tuple[np.ndarray, List]:
    """One int code per label, equal labels one code; and the labels
    by code."""
    ids: Dict = {}
    codes = np.fromiter((ids.setdefault(lb, len(ids)) for lb in labels), np.int64, len(labels))
    return codes, list(ids)


def _dim(table, sk_col: str, labels: Sequence, mask=None):
    """(the dimension's keys, a code per row, -1 where ``mask`` drops
    it; the labels by code)."""
    codes, uniq = _codes(labels)
    if mask is not None:
        codes = np.where(mask, codes, -1)
    return table[sk_col][0], codes, uniq


def _fact_code(dim, fk: np.ndarray) -> np.ndarray:
    """Per fact row, the code of the dimension row its key joins (-1:
    none, or a row the dimension's mask dropped)."""
    keys, codes, _ = dim
    rows = _rows_of(keys, fk)
    return np.where(rows >= 0, codes[np.maximum(rows, 0)], -1)


def _group_sums(keys: Sequence[np.ndarray], values: Sequence[np.ndarray]):
    """(the distinct key tuples as arrays, in lexicographic order; each
    value's int64 sum per group)."""
    n = keys[0].shape[0]
    if n == 0:
        return [k[:0] for k in keys], [v[:0].astype(np.int64) for v in values]
    order = np.lexsort(list(keys)[::-1])
    sk = [k[order] for k in keys]
    change = np.zeros(n, bool)
    change[0] = True
    for k in sk:
        change[1:] |= k[1:] != k[:-1]
    starts = np.flatnonzero(change)
    return [k[starts] for k in sk], [np.add.reduceat(v.astype(np.int64)[order], starts) for v in values]


def _keep(*codes: np.ndarray) -> np.ndarray:
    m = np.ones(codes[0].shape[0], bool)
    for c in codes:
        m &= c >= 0
    return m


def _avg_u(total: int, n: int) -> int:
    """An exact HALF_UP decimal average at scale + 4, unscaled."""
    num = total * 10_000
    q, r = divmod(abs(num), n)
    q += 1 if 2 * r >= n else 0
    return q if num >= 0 else -q


# ------------------------------------------------------ the window family


def oracle_q89(tables):
    """{(cat, cls, brand, store, company, moy): (sum, avg)} for rows
    passing |sum - avg| / avg > 0.1; sums unscaled, the avg unscaled at
    scale + 4."""
    it = tables["item"]
    cats, clss, brands = _sv(it, "i_category"), _sv(it, "i_class"), _sv(it, "i_brand")
    keep = ({(c, k) for c in ("Books", "Electronics", "Sports") for k in ("accessories", "reference", "football")}
            | {(c, k) for c in ("Men", "Jewelry", "Women") for k in ("shirts", "birdal", "dresses")})
    items = _dim(it, "i_item_sk", list(zip(cats, clss, brands)),
                 np.array([(c, k) in keep for c, k in zip(cats, clss)], bool))
    dd = tables["date_dim"]
    dates = (dd["d_date_sk"][0], np.where(dd["d_year"][0] == 1999, dd["d_moy"][0], -1).astype(np.int64), None)
    st = tables["store"]
    stores = _dim(st, "s_store_sk", list(zip(_sv(st, "s_store_name"), _sv(st, "s_company_name"))))
    ss = tables["store_sales"]
    ic, mc, sc = (_fact_code(items, ss["ss_item_sk"][0]), _fact_code(dates, ss["ss_sold_date_sk"][0]),
                  _fact_code(stores, ss["ss_store_sk"][0]))
    m = _keep(ic, mc, sc)
    (gi, gs, gm), (tot,) = _group_sums([ic[m], sc[m], mc[m]], [ss["ss_sales_price"][0][m]])
    sums = {items[2][i] + stores[2][s] + (mo,): v for i, s, mo, v in zip(gi.tolist(), gs.tolist(), gm.tolist(),
                                                                        tot.tolist())}
    parts: Dict[tuple, list] = {}
    for key, v in sums.items():
        cat, _, brand, stn, co, _ = key
        parts.setdefault((cat, brand, stn, co), []).append(v)
    out = {}
    for key, v in sums.items():
        cat, _, brand, stn, co, _ = key
        vals = parts[(cat, brand, stn, co)]
        avg_unscaled = int(_round_half_up(np.array([float(sum(vals)) * float(10**4) / len(vals)]))[0])
        sum_f, avg_f = float(v) / 100.0, avg_unscaled / 1e6
        if avg_f != 0 and abs(sum_f - avg_f) / avg_f > 0.1:
            out[key] = (v, avg_unscaled)
    return out


def _class_share_oracle(tables, *, sales, date_col, item_col, price_col):
    """q98, q20 and q12: {(id, desc, cat, cls, price): (revenue, ratio)}."""
    dd, it, sl = tables["date_dim"], tables["item"], tables[sales]
    epoch = datetime.date(1970, 1, 1)
    lo, hi = (datetime.date(1999, 2, 22) - epoch).days, (datetime.date(1999, 3, 24) - epoch).days
    dates = (dd["d_date_sk"][0], np.where((dd["d_date"][0] >= lo) & (dd["d_date"][0] <= hi), 0, -1), None)
    cats = _sv(it, "i_category")
    meta = list(zip(_sv(it, "i_item_id"), _sv(it, "i_item_desc"), cats, _sv(it, "i_class"),
                    it["i_current_price"][0].tolist()))
    items = _dim(it, "i_item_sk", meta, np.array([c in ("Sports", "Books", "Home") for c in cats], bool))
    ic, dc = _fact_code(items, sl[item_col][0]), _fact_code(dates, sl[date_col][0])
    m = _keep(ic, dc)
    (gi,), (tot,) = _group_sums([ic[m]], [sl[price_col][0][m]])
    rev = {items[2][i]: v for i, v in zip(gi.tolist(), tot.tolist())}
    by_class: Dict[str, int] = {}
    for mt, r in rev.items():
        by_class[mt[3]] = by_class.get(mt[3], 0) + r
    return {mt: (r, float(r) * 100.0 / float(by_class[mt[3]])) for mt, r in rev.items()}


def oracle_q98(tables):
    return _class_share_oracle(tables, sales="store_sales", date_col="ss_sold_date_sk", item_col="ss_item_sk",
                               price_col="ss_ext_sales_price")


def oracle_q20(tables):
    return _class_share_oracle(tables, sales="catalog_sales", date_col="cs_sold_date_sk", item_col="cs_item_sk",
                               price_col="cs_ext_sales_price")


def oracle_q12(tables):
    return _class_share_oracle(tables, sales="web_sales", date_col="ws_sold_date_sk", item_col="ws_item_sk",
                               price_col="ws_ext_sales_price")


def _oracle_manufact_window(tables, group_col):
    """q53 and q63: {(manufact_id, qoy or moy): (sum, avg)} for rows
    passing |sum - avg| / avg > 0.1 (the avg at scale + 4, HALF_UP)."""
    it = tables["item"]
    cats, clss = _sv(it, "i_category"), _sv(it, "i_class")
    keep = ({(c, k) for c in ("Books", "Children", "Electronics") for k in ("personal", "self-help", "reference")}
            | {(c, k) for c in ("Women", "Music", "Men") for k in ("accessories", "classical", "fragrances")})
    items = (it["i_item_sk"][0],
             np.where(np.array([(c, k) in keep for c, k in zip(cats, clss)], bool), it["i_manufact_id"][0], -1)
             .astype(np.int64), None)
    dd = tables["date_dim"]
    dates = (dd["d_date_sk"][0], np.where(np.isin(dd["d_year"][0], (1999, 2000)), dd[group_col][0], -1)
             .astype(np.int64), None)
    ss = tables["store_sales"]
    ic, gc = _fact_code(items, ss["ss_item_sk"][0]), _fact_code(dates, ss["ss_sold_date_sk"][0])
    m = _keep(ic, gc) & np.isin(ss["ss_store_sk"][0], tables["store"]["s_store_sk"][0])
    (gm, gg), (tot,) = _group_sums([ic[m], gc[m]], [ss["ss_sales_price"][0][m]])
    sums = {(mi, g): v for mi, g, v in zip(gm.tolist(), gg.tolist(), tot.tolist())}
    parts: Dict[int, list] = {}
    for (mi, _), v in sums.items():
        parts.setdefault(mi, []).append(v)
    out = {}
    for (mi, g), v in sums.items():
        vals = parts[mi]
        avg_unscaled = int(_round_half_up(np.array([float(sum(vals)) * float(10**4) / len(vals)]))[0])
        sum_f, avg_f = float(v) / 100.0, avg_unscaled / 1e6
        if avg_f > 0 and abs(sum_f - avg_f) / avg_f > 0.1:
            out[(mi, g)] = (v, avg_unscaled)
    return out


def oracle_q53(tables):
    return _oracle_manufact_window(tables, "d_qoy")


def oracle_q63(tables):
    return _oracle_manufact_window(tables, "d_moy")


def _rank_within_parent(rows, *, parent_of, measure_of, descending):
    """Competition rank within (lochierarchy, parent) partitions (q36,
    q86, q70): {(d0, d1, lochierarchy): (measure, rank)}."""
    parts = defaultdict(list)
    for r in rows:
        parts[(r[2], parent_of(r))].append(r)
    out = {}
    for plist in parts.values():
        plist.sort(key=lambda r: -measure_of(r) if descending else measure_of(r))
        rank, prev = 0, None
        for i, r in enumerate(plist, 1):
            if prev is None or measure_of(r) != prev:
                rank = i
            prev = measure_of(r)
            out[(r[0], r[1], r[2])] = (measure_of(r), rank)
    return out


def _rollup(sums_by_leaf: Dict[tuple, list], levels) -> Dict[tuple, list]:
    """Sums of the leaves' value lists at each rollup level:
    ``levels`` (how many leading dimensions a level keeps, its id)."""
    out: Dict[tuple, list] = {}
    for (d0, d1), vals in sums_by_leaf.items():
        for keep, gid in levels:
            key = (d0 if keep > 0 else None, d1 if keep > 1 else None, gid)
            acc = out.setdefault(key, [0] * len(vals))
            for k, v in enumerate(vals):
                acc[k] += v
    return out


def _rollup_margin_oracle(tables, *, sales, date_col, item_col, num_col, den_col, year, store_filter=False,
                          ratio_desc=False):
    """q36 and q86: ROLLUP(i_category, i_class) sums, lochierarchy and
    the rank within the parent."""
    dd, it, sl = tables["date_dim"], tables["item"], tables[sales]
    dates = (dd["d_date_sk"][0], np.where(dd["d_year"][0] == year, 0, -1), None)
    items = _dim(it, "i_item_sk", list(zip(_sv(it, "i_category"), _sv(it, "i_class"))))
    ic, dc = _fact_code(items, sl[item_col][0]), _fact_code(dates, sl[date_col][0])
    m = _keep(ic, dc)
    if store_filter:
        st = tables["store"]
        ok = st["s_store_sk"][0][np.array([s in ("TN", "SD", "AL", "GA", "OH") for s in _sv(st, "s_state")], bool)]
        m &= np.isin(sl["ss_store_sk"][0], ok)
    vals = [sl[num_col][0][m]] + ([sl[den_col][0][m]] if den_col else [])
    (gi,), sums = _group_sums([ic[m]], vals)
    leaves = {items[2][i]: [int(s[k]) for s in sums] for k, i in enumerate(gi.tolist())}
    rows = []
    for (cat, cls, gid), acc in _rollup(leaves, ((2, 0), (1, 1), (0, 3))).items():
        loch = {0: 0, 1: 1, 3: 2}[gid]
        # decimal(17,2) sums cast to double are dollars; a ratio cancels
        measure = (acc[0] / acc[1]) if den_col else (acc[0] / 100.0)
        rows.append([cat, cls, loch, measure])
    return _rank_within_parent(rows, parent_of=lambda r: r[0] if r[2] == 0 else None, measure_of=lambda r: r[3],
                               descending=ratio_desc)


def oracle_q36(tables):
    return _rollup_margin_oracle(tables, sales="store_sales", date_col="ss_sold_date_sk", item_col="ss_item_sk",
                                 num_col="ss_net_profit", den_col="ss_ext_sales_price", year=2001,
                                 store_filter=True)


def oracle_q86(tables):
    return _rollup_margin_oracle(tables, sales="web_sales", date_col="ws_sold_date_sk", item_col="ws_item_sk",
                                 num_col="ws_net_paid", den_col=None, year=2000, ratio_desc=True)


def oracle_q70(tables):
    """{(state | None, county | None, lochierarchy): (total, rank)}: the
    rollup over store geography, ranked by total, descending."""
    dd, st, ss = tables["date_dim"], tables["store"], tables["store_sales"]
    dates = (dd["d_date_sk"][0], np.where(dd["d_year"][0] == 2000, 0, -1), None)
    stores = _dim(st, "s_store_sk", list(zip(_sv(st, "s_state"), _sv(st, "s_county"))))
    sc, dc = _fact_code(stores, ss["ss_store_sk"][0]), _fact_code(dates, ss["ss_sold_date_sk"][0])
    m = _keep(sc, dc)
    (gs,), (tot,) = _group_sums([sc[m]], [ss["ss_net_profit"][0][m]])
    leaves = {stores[2][s]: [v] for s, v in zip(gs.tolist(), tot.tolist())}
    rows = [(state, county, loch, acc[0])
            for (state, county, loch), acc in _rollup(leaves, ((2, 0), (1, 1), (0, 2))).items()]
    return _rank_within_parent(rows, parent_of=lambda r: r[0] if r[2] == 0 else None, measure_of=lambda r: r[3],
                               descending=True)


def _yoy_oracle(tables, *, sales, date_col, item_col, price_col, entity, year):
    """q47 and q57: monthly sums, the year's average per partition,
    lag and lead over the months, kept in the target year where
    |sum - avg| / avg > 0.1.  ``entity``: (table, its key in the sales
    table, its own key column, its label columns)."""
    dd, it, sl = tables["date_dim"], tables["item"], tables[sales]
    etab, fk_col, esk_col, ecols = entity
    et = tables[etab]
    y, mo = dd["d_year"][0], dd["d_moy"][0]
    ok = (y == year) | ((y == year - 1) & (mo == 12)) | ((y == year + 1) & (mo == 1))
    dates = (dd["d_date_sk"][0], np.where(ok, y * 100 + mo, -1).astype(np.int64), None)
    items = _dim(it, "i_item_sk", list(zip(_sv(it, "i_category"), _sv(it, "i_brand"))))
    ents = _dim(et, esk_col, list(zip(*[_sv(et, c) for c in ecols])))
    dc, ic, ec = (_fact_code(dates, sl[date_col][0]), _fact_code(items, sl[item_col][0]),
                  _fact_code(ents, sl[fk_col][0]))
    m = _keep(dc, ic, ec)
    (gi, ge, gd), (tot,) = _group_sums([ic[m], ec[m], dc[m]], [sl[price_col][0][m]])
    sums = {items[2][i] + ents[2][e] + (d // 100, d % 100): v
            for i, e, d, v in zip(gi.tolist(), ge.tolist(), gd.tolist(), tot.tolist())}
    by_year_part = defaultdict(list)
    by_part = defaultdict(list)
    for key, v in sums.items():
        part, yy, mm = key[:-2], key[-2], key[-1]
        by_year_part[part + (yy,)].append(v)
        by_part[part].append((yy, mm, v))
    out = {}
    for part, rows in by_part.items():
        rows.sort()
        for i, (yy, mm, v) in enumerate(rows):
            if yy != year:
                continue
            vals = by_year_part[part + (yy,)]
            avg = sum(vals) / len(vals)
            if avg <= 0 or abs(v - avg) / avg <= 0.1:
                continue
            # avg(decimal(17,2)) carries scale 6: unscaled * 10^4
            avg = int(_round_half_up(np.array([avg * 10**4]))[0])
            psum = rows[i - 1][2] if i > 0 else None
            nsum = rows[i + 1][2] if i + 1 < len(rows) else None
            out[part + (yy, mm)] = (v, avg, psum, nsum)
    return out


def oracle_q47(tables):
    return _yoy_oracle(tables, sales="store_sales", date_col="ss_sold_date_sk", item_col="ss_item_sk",
                       price_col="ss_sales_price",
                       entity=("store", "ss_store_sk", "s_store_sk", ["s_store_name", "s_company_name"]), year=1999)


def oracle_q57(tables):
    return _yoy_oracle(tables, sales="catalog_sales", date_col="cs_sold_date_sk", item_col="cs_item_sk",
                       price_col="cs_sales_price",
                       entity=("call_center", "cs_call_center_sk", "cc_call_center_sk", ["cc_name"]), year=1999)


def _segment_starts(*keys: np.ndarray) -> np.ndarray:
    """True where any key changes from the row before (row 0 too)."""
    n = keys[0].shape[0]
    b = np.zeros(n, bool)
    if n:
        b[0] = True
    for k in keys:
        b[1:] |= k[1:] != k[:-1]
    return b


def _segment_running_max(seg_start: np.ndarray, values: np.ndarray, present: np.ndarray):
    """Per row, the maximum of the present values so far in its segment
    (and whether there was one)."""
    n = values.shape[0]
    seg = np.cumsum(seg_start) - 1
    if not n:
        return values.astype(np.int64), present
    lo = int(values[present].min()) if present.any() else 0
    span = (int(values[present].max()) if present.any() else 0) - lo + 2
    shifted = np.where(present, values.astype(np.int64) - lo + 1, 0) + seg.astype(np.int64) * span
    run = np.maximum.accumulate(shifted) - seg * span + lo - 1
    seen = np.cumsum(present) - np.maximum.accumulate(np.where(seg_start, np.cumsum(present) - present, 0))
    return run, seen > 0


def oracle_q51(tables):
    """{(item, d_date): (web max cumulative, store max cumulative)} where
    the web's passes the store's."""
    dd = tables["date_dim"]
    dates = (dd["d_date_sk"][0], np.where(dd["d_year"][0] == 2000, dd["d_date"][0], -1).astype(np.int64), None)

    def cume(fact, d_c, i_c, p_c):
        f = tables[fact]
        dv = _fact_code(dates, f[d_c][0])
        m = dv >= 0
        (items, days), (daily,) = _group_sums([f[i_c][0][m].astype(np.int64), dv[m]], [f[p_c][0][m]])
        c = np.cumsum(daily)
        starts = _segment_starts(items)
        base = np.maximum.accumulate(np.where(starts, c - daily, np.iinfo(np.int64).min)) if c.size else c
        return items, days, c - base

    wi, wd, wc = cume("web_sales", "ws_sold_date_sk", "ws_item_sk", "ws_sales_price")
    si, sd, sc = cume("store_sales", "ss_sold_date_sk", "ss_item_sk", "ss_sales_price")
    items = np.concatenate([wi, si])
    days = np.concatenate([wd, sd])
    web = np.concatenate([np.ones(wi.shape[0], bool), np.zeros(si.shape[0], bool)])
    vals = np.concatenate([wc, sc])
    order = np.lexsort((~web, days, items))  # (item, day), web first
    items, days, web, vals = items[order], days[order], web[order], vals[order]
    starts = _segment_starts(items)
    wmax, wseen = _segment_running_max(starts, vals, web)
    smax, sseen = _segment_running_max(starts, vals, ~web)
    # one row per (item, day): the last of its (at most two) rows
    last = np.ones(items.shape[0], bool)
    last[:-1] = (items[1:] != items[:-1]) | (days[1:] != days[:-1])
    keep = last & wseen & sseen & (wmax > smax)
    return {(i, d): (w, s) for i, d, w, s in zip(items[keep].tolist(), days[keep].tolist(), wmax[keep].tolist(),
                                                 smax[keep].tolist())}


def oracle_q67(tables):
    """{(the 8 rollup dimensions, None above the level, g_id): (sum,
    rank)}: the store sales of 2000 (quantity x price) rolled up over
    nine levels, ranked per category by sum, descending; ranks <= 100."""
    dd = tables["date_dim"]
    dlabels = list(zip(dd["d_year"][0].tolist(), dd["d_qoy"][0].tolist(), dd["d_moy"][0].tolist()))
    dates = _dim(dd, "d_date_sk", dlabels, dd["d_year"][0] == 2000)
    st = tables["store"]
    stores = _dim(st, "s_store_sk", _sv(st, "s_store_name"))
    it = tables["item"]
    items = _dim(it, "i_item_sk", list(zip(_sv(it, "i_category"), _sv(it, "i_class"), _sv(it, "i_brand"),
                                           _sv(it, "i_item_id"))))
    ss = tables["store_sales"]
    dc, sc, ic = (_fact_code(dates, ss["ss_sold_date_sk"][0]), _fact_code(stores, ss["ss_store_sk"][0]),
                  _fact_code(items, ss["ss_item_sk"][0]))
    m = _keep(dc, sc, ic)
    dc, sc, ic = dc[m], sc[m], ic[m]
    val = ss["ss_quantity"][0][m].astype(np.int64) * ss["ss_sales_price"][0][m].astype(np.int64)
    # codes of each label's prefixes: item (cat, cls, brand, id) and date (year, qoy, moy)
    ipre = [_codes([lb[:k] for lb in items[2]]) for k in range(5)]
    dpre = [_codes([lb[:k] for lb in dates[2]]) for k in range(4)]
    cat_row = ipre[1][0][ic]  # each row's category (the rank's partition)
    cells_cat, cells_val, cells_key = [], [], []
    for level in range(8, -1, -1):
        ik, dk, sk = min(level, 4), max(0, min(level - 4, 3)), level == 8
        cols = [cat_row if level else np.full(ic.shape[0], -1, np.int64), ipre[ik][0][ic], dpre[dk][0][dc]]
        groups, (tot,) = _group_sums(cols + ([sc] if sk else []), [val])
        cells_cat.append(groups[0])
        cells_val.append(tot)
        cells_key.append((level, ik, dk, sk, groups[1:]))
    cat = np.concatenate(cells_cat)
    v = np.concatenate(cells_val)
    origin = np.concatenate([np.full(c.shape[0], k, np.int64) for k, c in enumerate(cells_cat)])
    within = np.concatenate([np.arange(c.shape[0]) for c in cells_cat])
    order = np.lexsort((-v, cat))
    cat, v, origin, within = cat[order], v[order], origin[order], within[order]
    idx = np.arange(v.shape[0])
    cat_start = np.maximum.accumulate(np.where(_segment_starts(cat), idx, 0))
    tie_start = np.maximum.accumulate(np.where(_segment_starts(cat, v), idx, 0))
    rank = tie_start - cat_start + 1
    out = {}
    for k in np.flatnonzero(rank <= 100).tolist():
        level, ik, dk, sk, groups = cells_key[origin[k]]
        g = [a[within[k]] for a in groups]
        ilab = ipre[ik][1][g[0]]
        dlab = dpre[dk][1][g[1]]
        dims = ilab + (None,) * (4 - len(ilab)) + dlab + (None,) * (3 - len(dlab)) + (
            (stores[2][g[2]],) if sk else (None,))
        out[dims + (8 - level,)] = (int(v[k]), int(rank[k]))
    return out


def oracle_q44(tables):
    """{(rank, best item id, worst item id)}: items of store 4 whose
    average net profit passes 90% of the store's null-address average,
    paired by ascending and descending rank <= 10."""
    ss = tables["store_sales"]
    at = ss["ss_store_sk"][0] == 4
    base = ss["ss_net_profit"][0][at & (ss["ss_addr_sk"][0] == -1)]
    if not base.shape[0]:
        return set()
    (items,), (tot, cnt) = _group_sums([ss["ss_item_sk"][0][at]], [ss["ss_net_profit"][0][at],
                                                                    np.ones(int(at.sum()), np.int64)])
    thr = _avg_u(int(base.sum()), int(base.shape[0]))
    avgs = [_avg_u(t, n) for t, n in zip(tot.tolist(), cnt.tolist())]
    kept = [(i, a) for i, a in zip(items.tolist(), avgs) if a / 1e6 > 0.9 * (thr / 1e6)]
    vals = np.array(sorted(a for _, a in kept), np.int64)
    it = tables["item"]
    iid = dict(zip(it["i_item_sk"][0].tolist(), _sv(it, "i_item_id")))
    asc, desc = defaultdict(list), defaultdict(list)
    for i, a in kept:
        r_asc = int(np.searchsorted(vals, a, "left")) + 1
        r_desc = int(vals.shape[0] - np.searchsorted(vals, a, "right")) + 1
        if r_asc <= 10:
            asc[r_asc].append(i)
        if r_desc <= 10:
            desc[r_desc].append(i)
    return {(r, iid[b], iid[w]) for r, bests in asc.items() for b in bests for w in desc.get(r, ())
            if b in iid and w in iid}


def _min_rank(vals: np.ndarray) -> np.ndarray:
    """rank(): ties share the lowest 1-based position."""
    return np.searchsorted(np.sort(vals), vals, side="left") + 1


def oracle_q49(tables):
    """{(channel, item, return ratio, return rank, currency rank)}: per
    channel, the items' quantity and currency return ratios of December
    2001, each ranked, rank <= 10 on either (return amounts > 250, as
    the query)."""
    dd = tables["date_dim"]
    dsk = dd["d_date_sk"][0][(dd["d_year"][0] == 2001) & (dd["d_moy"][0] == 12)]

    def channel(name, fact, ret, s_item, s_ord, s_qty, s_paid, s_profit, r_item, r_ord, r_qty, r_amt, date_c):
        f, r = tables[fact], tables[ret]
        ramt = r[r_amt][0].astype(np.int64)
        rk = ramt / 100.0 > 250.0
        r_o, r_i = r[r_ord][0][rk].astype(np.int64), r[r_item][0][rk].astype(np.int64)
        r_q, r_a = r[r_qty][0][rk].astype(np.int64), ramt[rk]
        fm = (np.isin(f[date_c][0], dsk) & (f[s_profit][0].astype(np.int64) / 100.0 > 1.0)
              & (f[s_paid][0].astype(np.int64) / 100.0 > 0.0) & (f[s_qty][0] > 0))
        f_o, f_i = f[s_ord][0][fm].astype(np.int64), f[s_item][0][fm].astype(np.int64)
        f_q, f_p = f[s_qty][0][fm].astype(np.int64), f[s_paid][0][fm].astype(np.int64)
        # every (fact row, return row) pair on (order, item), by one
        # int64 key order * M + item
        mult = int(max(r_i.max(initial=0), f_i.max(initial=0))) + 1
        rkey, fkey = r_o * mult + r_i, f_o * mult + f_i
        order = np.argsort(rkey, kind="stable")
        start = np.searchsorted(rkey[order], fkey, "left")
        count = np.searchsorted(rkey[order], fkey, "right") - start
        pf = np.repeat(np.arange(fkey.shape[0]), count)
        first = np.repeat(start, count)
        pr = order[first + np.arange(pf.shape[0]) - np.repeat(np.cumsum(count) - count, count)]
        if not pf.shape[0]:
            return set()
        (items,), (a0, a1, a2, a3) = _group_sums([f_i[pf]], [r_q[pr], f_q[pf], r_a[pr], f_p[pf]])
        rr = a0 / a1
        cr = (a2 / 100.0) / (a3 / 100.0)
        rrank, crank = _min_rank(rr), _min_rank(cr)
        return {(name, i, x, a, b) for i, x, a, b in zip(items.tolist(), rr.tolist(), rrank.tolist(), crank.tolist())
                if a <= 10 or b <= 10}

    out = set()
    out |= channel("web", "web_sales", "web_returns", "ws_item_sk", "ws_order_number", "ws_quantity",
                   "ws_net_paid", "ws_net_profit", "wr_item_sk", "wr_order_number", "wr_return_quantity",
                   "wr_return_amt", "ws_sold_date_sk")
    out |= channel("catalog", "catalog_sales", "catalog_returns", "cs_item_sk", "cs_order_number", "cs_quantity",
                   "cs_net_paid", "cs_net_profit", "cr_item_sk", "cr_order_number", "cr_return_quantity",
                   "cr_return_amount", "cs_sold_date_sk")
    out |= channel("store", "store_sales", "store_returns", "ss_item_sk", "ss_ticket_number", "ss_quantity",
                   "ss_net_paid", "ss_net_profit", "sr_item_sk", "sr_ticket_number", "sr_return_quantity",
                   "sr_return_amt", "ss_sold_date_sk")
    return out


# ------------------------------------------------- holding a result to them


def _null_first(v):
    return (0, "") if v is None else (1, v)


def check_window_query(query: str, got: Dict[str, list], exp) -> str:
    """Raises ``AssertionError`` unless the window query's rows ``got``
    (column -> values) equal its oracle ``exp`` on a nonempty result:
    integers, decimals and ranks exactly, doubles within 1e-9 (the
    reference tests' tolerances; q47/q57's averages within one unit,
    the oracle rounding a float); a top 100 as the first 100 of the
    oracle's rows in the query's order, ties compared as sort keys.
    Returns what matched."""
    def need(ok, what):
        if not ok:
            raise AssertionError(f"{query}: {what}")

    n = len(next(iter(got.values())))
    need(n > 0 and len(exp) > 0, f"empty result ({n} rows, oracle {len(exp)})")
    if query in ("q12", "q20", "q98"):
        need(n == len(exp), f"{n} rows != oracle {len(exp)}")
        for row in zip(got["i_item_id"], got["i_item_desc"], got["i_category"], got["i_class"],
                       got["i_current_price"], got["itemrevenue"], got["revenueratio"]):
            e = exp.get(row[:5])
            need(e is not None and row[5] == e[0] and abs(row[6] - e[1]) < 1e-9, f"{row} != oracle {e}")
        keys = list(zip(got["i_category"], got["i_class"], got["i_item_id"], got["i_item_desc"]))
        need(keys == sorted(keys), "rows out of order")
        return f"{n} items = oracle"
    if query in ("q53", "q63"):
        g, avg = ("d_qoy", "avg_quarterly_sales") if query == "q53" else ("d_moy", "avg_monthly_sales")
        rows = list(zip(got["i_manufact_id"], got[g], got["sum_sales"], got[avg]))
        need(all(exp.get(r[:2]) == r[2:] for r in rows), "rows != oracle")
        order = (lambda m, v: (v[1], v[0], m[0])) if query == "q53" else (lambda m, v: (m[0], v[1], v[0]))
        need([order(r[:2], r[2:]) for r in rows] == sorted(order(k, v) for k, v in exp.items())[:100],
             "not the oracle's first 100 in order")
        return f"{n} of {len(exp)} groups = oracle"
    if query == "q89":
        cols = ("i_category", "i_class", "i_brand", "s_store_name", "s_company_name", "d_moy")
        rows = list(zip(*(got[c] for c in cols), got["sum_sales"], got["avg_monthly_sales"], got["delta"]))
        need(all(exp.get(r[:6]) == r[6:8] for r in rows), "rows != oracle")
        delta = sorted((v[0] / 100.0 - v[1] / 1e6, k[3]) for k, v in exp.items())[:100]
        need(len(rows) == len(delta) and all(abs(r[8] - d[0]) < 1e-6 and r[3] == d[1] for r, d in zip(rows, delta)),
             "not the oracle's first 100 by (delta, store)")
        return f"{n} of {len(exp)} rows = oracle"
    if query in ("q47", "q57"):
        ents = ("s_store_name", "s_company_name") if query == "q47" else ("cc_name",)
        cols = ("i_category", "i_brand") + ents + ("d_year", "d_moy")
        for r in zip(*(got[c] for c in cols), got["sum_sales"], got["avg_monthly_sales"], got["psum"], got["nsum"]):
            e = exp.get(r[:len(cols)])
            v = r[len(cols):]
            need(e is not None and v[0] == e[0] and abs(v[1] - e[1]) <= 1 and v[2:] == e[2:], f"{r} != oracle {e}")
        deltas = sorted(v[0] / 100.0 - v[1] / 1e6 for v in exp.values())
        need(n == min(len(exp), 100) and all(abs(a - b) < 1e-5 for a, b in zip(got["delta"], deltas)),
             "not the oracle's first 100 by delta")
        return f"{n} of {len(exp)} months = oracle"
    if query in ("q36", "q86", "q70"):
        d0, d1, m = ("s_state", "s_county", "total_sum") if query == "q70" else ("i_category", "i_class", "measure")
        for r in zip(got[d0], got[d1], got["lochierarchy"], got[m], got["rank_within_parent"]):
            e = exp.get(r[:3])
            need(e is not None and abs(r[3] - e[0]) < 1e-9 and r[4] == e[1], f"{r} != oracle {e}")

        def order(k, rank):
            return (-k[2], _null_first(k[0] if k[2] == 0 else None), rank)

        need([order(k, r) for k, r in zip(zip(got[d0], got[d1], got["lochierarchy"]), got["rank_within_parent"])]
             == sorted(order(k, v[1]) for k, v in exp.items())[:100], "not the oracle's first 100 in order")
        return f"{n} of {len(exp)} rollup rows = oracle, levels {sorted(set(got['lochierarchy']))}"
    if query == "q67":
        dims = ("i_category", "i_class", "i_brand", "i_item_id", "d_year", "d_qoy", "d_moy", "s_store_name", "g_id")
        keys = list(zip(*(got[d] for d in dims)))
        need(all(exp.get(k) == (s, r) for k, s, r in zip(keys, got["sumsales"], got["rk"])), "rows != oracle")
        need([(_null_first(k[0]), r, -s) for k, s, r in zip(keys, got["sumsales"], got["rk"])]
             == sorted((_null_first(k[0]), v[1], -v[0]) for k, v in exp.items())[:100],
             "not the oracle's first 100 in order")
        return f"{n} of {len(exp)} ranked cells = oracle"
    if query == "q44":
        rows = list(zip(got["rnk"], got["best_name"], got["worst_name"]))
        need(rows == sorted(exp)[:100], f"{rows[:3]}... != oracle {sorted(exp)[:3]}...")
        return f"{n} rank pairs = oracle"
    if query == "q49":
        rows = list(zip(got["channel"], got["item"], got["return_ratio"], got["return_rank"], got["currency_rank"]))
        need(len(exp) <= 100 and set(rows) == exp and len(rows) == len(exp), "rows != oracle")
        keys = [(r[0], r[3], r[4]) for r in rows]
        need(keys == sorted(keys), "rows out of order")
        return f"{n} ranked items over {len(set(got['channel']))} channels = oracle"
    if query == "q51":
        keys = list(zip(got["item_sk"], got["d_date"]))
        need(all(exp.get(k) == v for k, v in zip(keys, zip(got["web_cumulative"], got["store_cumulative"]))),
             "rows != oracle")
        need(keys == sorted(exp)[:100], "not the oracle's first 100 (item, day)")
        return f"{n} of {len(exp)} days = oracle"
    raise KeyError(query)
