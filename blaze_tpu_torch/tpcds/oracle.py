"""Independent numpy/python oracles for the port's TPC-DS queries, each
re-implemented from the spec over the generated host tables, no engine
code reused: its own copy of ``blaze_tpu/tpcds/oracle.py``'s
``oracle_q3`` and ``oracle_q7``, and of the window family's oracles
(q12, q20, q98, q53, q63, q89, q47, q57, q36, q86, q70, q67, q44, q49,
q51) and of the rollup and union family's (q27, q18, q22, q5, q77, q80,
q14a, q33, q56, q60, q71, q76, q66, q2, q75, q54, q23a, q23b) and of
``EXISTS_STDDEV_QUERIES``' (q10, q35, q69, q38, q87, q17, q25, q29,
q39a, q39b, q84), ``REPORT_QUERIES``' (but q43's and q61's sums of
no sale, null here as in SQL, 0 in the reference's) and
``JOINED_QUERIES``' (where the reference's return a set of customers,
these a sorted list: a customer may pass at two locations), which
return what the reference's return (q18's
double averages and q17's and q39's stddevs within 1e-9 relative: these
compute a variance exactly in integers and round once, the reference's
from a float sum of squares; q39's also list the rows near a cov
threshold).  The reference's loop in Python over every fact row (q67's
nine times, q22's over 23.49M inventory rows at SF1, and its ranks and
q51's per-item merges are quadratic; q72's pairs 59.1M at SF1), which
does not finish at SF1;
these join and group the fact rows with numpy (sorted-key joins,
sums by ``np.add.reduceat`` over a lexsort, exact in int64) and keep
Python for the groups."""

from __future__ import annotations

import datetime
import math
from collections import Counter, defaultdict
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..tpch.oracle import _round_half_up, _s_eq, _s_isin, _sv
from .queries import _Q64_COLORS, EXISTS_STDDEV_QUERIES, JOINED_QUERIES, REPORT_QUERIES, ROLLUP_UNION_QUERIES


def _brand_rollup(tables, *, year, moy, item_filter_col, item_filter_val, group_cols):
    """{(d_year, the item's ``group_cols``): sum of ss_ext_sales_price}
    over one month (of one year, unless ``year`` is None) and the items
    whose ``item_filter_col`` is ``item_filter_val`` (q3, q42, q52,
    q55)."""
    dd, it, ss = tables["date_dim"], tables["item"], tables["store_sales"]
    d_mask = dd["d_moy"][0] == moy
    if year is not None:
        d_mask &= dd["d_year"][0] == year
    dates = _dim(dd, "d_date_sk", dd["d_year"][0].tolist(), d_mask)
    labels = list(zip(*(_sv(it, c) if it[c][1] is not None else it[c][0].tolist() for c in group_cols)))
    items = _dim(it, "i_item_sk", labels, it[item_filter_col][0] == item_filter_val)
    dc, ic = _fact_code(dates, ss["ss_sold_date_sk"][0]), _fact_code(items, ss["ss_item_sk"][0])
    m = _keep(dc, ic)
    (gd, gi), (s,) = _group_sums([dc[m], ic[m]], [ss["ss_ext_sales_price"][0][m]])
    return {(dates[2][d],) + items[2][i]: v for d, i, v in zip(gd.tolist(), gi.tolist(), s.tolist())}


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


def _rollup_levels(cells: Dict[tuple, list], n_dims: int, gids=None) -> Dict[tuple, list]:
    """ROLLUP of ``cells`` (full key tuple -> list of int sums): every
    level from the finest, a key's trailing dimensions None and its
    grouping id appended (``gids``: the id of each level, finest
    first; default n_dims - level)."""
    out: Dict[tuple, list] = {}
    for key, vals in cells.items():
        for k, level in enumerate(range(n_dims, -1, -1)):
            gid = gids[k] if gids else n_dims - level
            acc = out.setdefault(tuple(key[i] if i < level else None for i in range(n_dims)) + (gid,),
                                 [0] * len(vals))
            for i, v in enumerate(vals):
                acc[i] += v
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
    for (cat, cls, gid), acc in _rollup_levels(leaves, 2, gids=(0, 1, 3)).items():
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
            for (state, county, loch), acc in _rollup_levels(leaves, 2).items()]
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


def _matches(keys: Sequence[np.ndarray], probe: Sequence[np.ndarray]):
    """Every (probe row, key row) pair equal on all key columns: (probe
    rows, key rows), one entry a pair, probe rows ascending."""
    n = keys[0].shape[0]
    if not n or not probe[0].shape[0]:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    both = [np.concatenate([k.astype(np.int64), p.astype(np.int64)]) for k, p in zip(keys, probe)]
    # one int64 code per distinct key tuple, over both sides
    codes = np.zeros(both[0].shape[0], np.int64)
    for c in both:
        _, inv = np.unique(c, return_inverse=True)
        codes = codes * (int(inv.max()) + 1) + inv
        _, codes = np.unique(codes, return_inverse=True)
    kc, pc = codes[:n], codes[n:]
    order = np.argsort(kc, kind="stable")
    start = np.searchsorted(kc[order], pc, "left")
    count = np.searchsorted(kc[order], pc, "right") - start
    pr = np.repeat(np.arange(pc.shape[0]), count)
    offs = np.arange(pr.shape[0]) - np.repeat(np.cumsum(count) - count, count)
    return pr, order[np.repeat(start, count) + offs]


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
        # every (fact row, return row) pair on (order, item)
        pf, pr = _matches([r_o, r_i], [f_o, f_i])
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


# -------------------------------------------- the rollup and union family


def _epoch_day(y: int, m: int, d: int) -> int:
    return (datetime.date(y, m, d) - datetime.date(1970, 1, 1)).days


def _window(tables, lo, hi) -> np.ndarray:
    """The date_sk of the days from ``lo`` to ``hi`` ((y, m, d))."""
    dd = tables["date_dim"]
    m = (dd["d_date"][0] >= _epoch_day(*lo)) & (dd["d_date"][0] <= _epoch_day(*hi))
    return dd["d_date_sk"][0][m]


def _label_sums(codes: np.ndarray, labels, values: Sequence[np.ndarray]) -> Dict:
    """{label: [int sum of each value]} over the rows with a code >= 0."""
    m = codes >= 0
    (g,), sums = _group_sums([codes[m]], [v[m] for v in values])
    return {labels[c]: [int(s[k]) for s in sums] for k, c in enumerate(g.tolist())}


def oracle_q27(tables):
    """{(item id | None, state | None, g_id): (avg quantity, avg list
    price, avg coupon, avg sales price)}: the store sales of 2002 to
    single male college buyers in five states, ROLLUP(i_item_id,
    s_state); decimal averages unscaled at scale 6, exact HALF_UP."""
    cd = tables["customer_demographics"]
    cd_ok = _s_eq(cd, "cd_gender", "M") & _s_eq(cd, "cd_marital_status", "S") & _s_eq(cd, "cd_education_status",
                                                                                       "College")
    dd, st, it, ss = tables["date_dim"], tables["store"], tables["item"], tables["store_sales"]
    states = _sv(st, "s_state")
    stores = _dim(st, "s_store_sk", states, np.array([s in ("TN", "SD", "AL", "GA", "OH") for s in states], bool))
    items = _dim(it, "i_item_sk", _sv(it, "i_item_id"))
    m = (np.isin(ss["ss_cdemo_sk"][0], cd["cd_demo_sk"][0][cd_ok])
         & np.isin(ss["ss_sold_date_sk"][0], dd["d_date_sk"][0][dd["d_year"][0] == 2002]))
    sc, ic = _fact_code(stores, ss["ss_store_sk"][0]), _fact_code(items, ss["ss_item_sk"][0])
    m &= _keep(sc, ic)
    vals = [ss[c][0][m] for c in ("ss_quantity", "ss_list_price", "ss_coupon_amt", "ss_sales_price")]
    (gi, gs), sums = _group_sums([ic[m], sc[m]], vals + [np.ones(int(m.sum()), np.int64)])
    cells = {(items[2][i], stores[2][k]): [int(s[j]) for s in sums] for j, (i, k) in enumerate(zip(gi.tolist(),
                                                                                                   gs.tolist()))}
    out = {}
    for key, acc in _rollup_levels(cells, 2, gids=(0, 1, 3)).items():
        n = acc[4]
        out[key] = (float(acc[0]) / n, _avg_u(acc[1], n), _avg_u(acc[2], n), _avg_u(acc[3], n))
    return out


def oracle_q18(tables):
    """{(item id, county, state, g_id) with None above the level: the
    seven averages}: the catalog sales of 2001 to female college buyers
    born 1966-1980, ROLLUP(i_item_id, ca_county, ca_state).  The
    averages are of doubles: here exact sums over the count (the
    reference sums the doubles one by one; the two agree within 1e-9
    relative)."""
    dd, cdt, cu, ca, it, cs = (tables[k] for k in ("date_dim", "customer_demographics", "customer",
                                                   "customer_address", "item", "catalog_sales"))
    cd_ok = _s_eq(cdt, "cd_gender", "F") & _s_eq(cdt, "cd_education_status", "College")
    by = cu["c_birth_year"][0]
    cu_ok = (by >= 1966) & (by <= 1980)
    m = np.isin(cs["cs_sold_date_sk"][0], dd["d_date_sk"][0][dd["d_year"][0] == 2001])
    cd_row = _rows_of(cdt["cd_demo_sk"][0], cs["cs_bill_cdemo_sk"][0])
    m &= (cd_row >= 0) & cd_ok[np.maximum(cd_row, 0)]
    cu_row = _rows_of(cu["c_customer_sk"][0], cs["cs_bill_customer_sk"][0])
    m &= (cu_row >= 0) & cu_ok[np.maximum(cu_row, 0)]
    addrs = _dim(ca, "ca_address_sk", list(zip(_sv(ca, "ca_county"), _sv(ca, "ca_state"))))
    ac = _fact_code(addrs, cu["c_current_addr_sk"][0][np.maximum(cu_row, 0)])
    items = _dim(it, "i_item_sk", _sv(it, "i_item_id"))
    ic = _fact_code(items, cs["cs_item_sk"][0])
    m &= _keep(ac, ic)
    vals = [cs[c][0][m] for c in ("cs_quantity", "cs_list_price", "cs_coupon_amt", "cs_sales_price", "cs_net_profit")]
    vals += [by[cu_row[m]], cdt["cd_dep_count"][0][cd_row[m]], np.ones(int(m.sum()), np.int64)]
    (gi, ga), sums = _group_sums([ic[m], ac[m]], vals)
    cells = {(items[2][i],) + addrs[2][a]: [int(s[j]) for s in sums]
             for j, (i, a) in enumerate(zip(gi.tolist(), ga.tolist()))}
    out = {}
    for key, acc in _rollup_levels(cells, 3).items():
        n = acc[7]
        out[key] = tuple((acc[k] / 100.0 if k in (1, 2, 3, 4) else float(acc[k])) / n for k in range(7))
    return out


def oracle_q22(tables):
    """{(item id, brand, class, category, g_id) with None above the
    level: average quantity on hand}: the inventory of 2000, ROLLUP
    over the product hierarchy (int sums over the count, as the engine
    divides)."""
    dd, it, inv = tables["date_dim"], tables["item"], tables["inventory"]
    items = _dim(it, "i_item_sk", list(zip(_sv(it, "i_item_id"), _sv(it, "i_brand"), _sv(it, "i_class"),
                                           _sv(it, "i_category"))))
    ic = _fact_code(items, inv["inv_item_sk"][0])
    ic = np.where(np.isin(inv["inv_date_sk"][0], dd["d_date_sk"][0][dd["d_year"][0] == 2000]), ic, -1)
    m = ic >= 0
    (g,), (qsum, cnt) = _group_sums([ic[m]], [inv["inv_quantity_on_hand"][0][m], np.ones(int(m.sum()), np.int64)])
    cells = {items[2][c]: [q, n] for c, q, n in zip(g.tolist(), qsum.tolist(), cnt.tolist())}
    return {k: v[0] / v[1] for k, v in _rollup_levels(cells, 4).items()}


def _channel_rollup(detail: Dict[tuple, list]) -> Dict[tuple, tuple]:
    """ROLLUP(channel, id) of {(channel, id): [sales, returns, profit]}
    for q5, q77 and q80: {(channel | None, id | None): (sums)}."""
    return {k[:2]: tuple(v) for k, v in _rollup_levels(detail, 2).items()}


def _add_detail(detail, channel, sums: Dict):
    for ident, vals in sums.items():
        acc = detail.setdefault((channel, ident), [0, 0, 0])
        for k, v in enumerate(vals):
            acc[k] += v


def oracle_q5(tables):
    """{(channel | None, location id | None): (sales, returns, profit)},
    unscaled, over 2000-08-23 .. 2000-09-05: store sales and returns by
    store name, catalog by page id, web by site name (web returns find
    their site through every web_sales line of their (item, order))."""
    win = _window(tables, (2000, 8, 23), (2000, 9, 5))
    detail: Dict[tuple, list] = {}

    def channel(name, loc, loc_sk, loc_id, fact, date_c, fk, price, profit, rtab, rdate, rfk, amt, loss):
        locs = _dim(tables[loc], loc_sk, _sv(tables[loc], loc_id))
        f = tables[fact]
        lc = np.where(np.isin(f[date_c][0], win), _fact_code(locs, f[fk][0]), -1)
        z = np.zeros(f[price][0].shape[0], np.int64)
        _add_detail(detail, name, _label_sums(lc, locs[2], [f[price][0], z, f[profit][0]]))
        if rtab is None:
            return locs
        r = tables[rtab]
        rc = np.where(np.isin(r[rdate][0], win), _fact_code(locs, r[rfk][0]), -1)
        z = np.zeros(r[amt][0].shape[0], np.int64)
        _add_detail(detail, name, _label_sums(rc, locs[2], [z, r[amt][0], -r[loss][0].astype(np.int64)]))
        return locs

    channel("store channel", "store", "s_store_sk", "s_store_name", "store_sales", "ss_sold_date_sk", "ss_store_sk",
            "ss_ext_sales_price", "ss_net_profit", "store_returns", "sr_returned_date_sk", "sr_store_sk",
            "sr_return_amt", "sr_net_loss")
    channel("catalog channel", "catalog_page", "cp_catalog_page_sk", "cp_catalog_page_id", "catalog_sales",
            "cs_sold_date_sk", "cs_catalog_page_sk", "cs_ext_sales_price", "cs_net_profit", "catalog_returns",
            "cr_returned_date_sk", "cr_catalog_page_sk", "cr_return_amount", "cr_net_loss")
    sites = channel("web channel", "web_site", "web_site_sk", "web_name", "web_sales", "ws_sold_date_sk",
                    "ws_web_site_sk", "ws_ext_sales_price", "ws_net_profit", None, None, None, None, None)
    ws, wr = tables["web_sales"], tables["web_returns"]
    rm = np.isin(wr["wr_returned_date_sk"][0], win)
    pr, kr = _matches([ws["ws_item_sk"][0], ws["ws_order_number"][0]],
                      [wr["wr_item_sk"][0][rm], wr["wr_order_number"][0][rm]])
    sc = _fact_code(sites, ws["ws_web_site_sk"][0][kr])
    amt, loss = wr["wr_return_amt"][0][rm][pr], wr["wr_net_loss"][0][rm][pr].astype(np.int64)
    _add_detail(detail, "web channel", _label_sums(sc, sites[2], [np.zeros(pr.shape[0], np.int64), amt, -loss]))
    return _channel_rollup(detail)


def _sums_by(keys: np.ndarray, mask: np.ndarray, values) -> Dict[int, list]:
    (g,), sums = _group_sums([keys[mask].astype(np.int64)], [v[mask] for v in values])
    return {k: [int(s[j]) for s in sums] for j, k in enumerate(g.tolist())}


def oracle_q77(tables):
    """{(channel | None, id | None): (sales, returns, profit)} over
    2000-08-03 .. 2000-09-01: per store, call center and web page, each
    location's sales less its returns (catalog: the window's whole
    returns)."""
    win = _window(tables, (2000, 8, 3), (2000, 9, 1))
    detail: Dict[tuple, list] = {}
    ss, sr = tables["store_sales"], tables["store_returns"]
    st_sks = tables["store"]["s_store_sk"][0]
    sales = _sums_by(ss["ss_store_sk"][0], np.isin(ss["ss_sold_date_sk"][0], win) & np.isin(ss["ss_store_sk"][0], st_sks),
                     [ss["ss_ext_sales_price"][0], ss["ss_net_profit"][0]])
    rets = _sums_by(sr["sr_store_sk"][0], np.isin(sr["sr_returned_date_sk"][0], win)
                    & np.isin(sr["sr_store_sk"][0], st_sks), [sr["sr_return_amt"][0], sr["sr_net_loss"][0]])
    for sk, (s, p) in sales.items():
        r, l_ = rets.get(sk, (0, 0))
        detail[("store channel", sk)] = [s, r, p - l_]
    cs, cr = tables["catalog_sales"], tables["catalog_returns"]
    csales = _sums_by(cs["cs_call_center_sk"][0], np.isin(cs["cs_sold_date_sk"][0], win),
                      [cs["cs_ext_sales_price"][0], cs["cs_net_profit"][0]])
    cm = np.isin(cr["cr_returned_date_sk"][0], win)
    rtot, ltot = int(cr["cr_return_amount"][0][cm].astype(np.int64).sum()), int(cr["cr_net_loss"][0][cm].astype(
        np.int64).sum())
    for cc, (s, p) in csales.items():
        detail[("catalog channel", cc)] = [s, rtot, p - ltot]
    ws, wr = tables["web_sales"], tables["web_returns"]
    wsales = _sums_by(ws["ws_web_page_sk"][0], np.isin(ws["ws_sold_date_sk"][0], win),
                      [ws["ws_ext_sales_price"][0], ws["ws_net_profit"][0]])
    wrets = _sums_by(wr["wr_web_page_sk"][0], np.isin(wr["wr_returned_date_sk"][0], win),
                     [wr["wr_return_amt"][0], wr["wr_net_loss"][0]])
    for pg, (s, p) in wsales.items():
        r, l_ = wrets.get(pg, (0, 0))
        detail[("web channel", pg)] = [s, r, p - l_]
    return _channel_rollup(detail)


def _left_join_sums(fact_keys, ret_keys, ret_values):
    """Per fact row, its matches among the returns on all keys (a LEFT
    join's multiplicity, at least 1) and each return value summed over
    its matches."""
    n = fact_keys[0].shape[0]
    fr, rr = _matches(ret_keys, fact_keys)
    k = np.bincount(fr, minlength=n)
    sums = []
    for v in ret_values:
        acc = np.zeros(n, np.int64)
        np.add.at(acc, fr, v[rr].astype(np.int64))
        sums.append(acc)
    return np.maximum(k, 1), sums


def oracle_q80(tables):
    """{(channel | None, item id | None): (sales, returns, profit)} over
    2000-08-03 .. 2000-09-01, items over $50 on promotions without
    email: every sales line LEFT joined to its returns on (item, ticket
    or order), each match a row."""
    win = _window(tables, (2000, 8, 3), (2000, 9, 1))
    it, pm = tables["item"], tables["promotion"]
    items = _dim(it, "i_item_sk", _sv(it, "i_item_id"), it["i_current_price"][0] > 5000)
    promo_ok = pm["p_promo_sk"][0][_s_eq(pm, "p_channel_email", "N")]
    detail: Dict[tuple, list] = {}

    def channel(name, fact, d_c, i_c, promo_c, key2_c, price_c, profit_c, rtab, ri_c, rkey2_c, ramt_c, rloss_c):
        f, r = tables[fact], tables[rtab]
        ic = _fact_code(items, f[i_c][0])
        m = np.isin(f[d_c][0], win) & (ic >= 0) & np.isin(f[promo_c][0], promo_ok)
        mult, (amt, loss) = _left_join_sums([f[i_c][0][m], f[key2_c][0][m]], [r[ri_c][0], r[rkey2_c][0]],
                                            [r[ramt_c][0], r[rloss_c][0]])
        price, profit = f[price_c][0][m].astype(np.int64), f[profit_c][0][m].astype(np.int64)
        _add_detail(detail, name, _label_sums(ic[m], items[2], [price * mult, amt, profit * mult - loss]))

    channel("store channel", "store_sales", "ss_sold_date_sk", "ss_item_sk", "ss_promo_sk", "ss_ticket_number",
            "ss_ext_sales_price", "ss_net_profit", "store_returns", "sr_item_sk", "sr_ticket_number",
            "sr_return_amt", "sr_net_loss")
    channel("catalog channel", "catalog_sales", "cs_sold_date_sk", "cs_item_sk", "cs_promo_sk", "cs_order_number",
            "cs_ext_sales_price", "cs_net_profit", "catalog_returns", "cr_item_sk", "cr_order_number",
            "cr_return_amount", "cr_net_loss")
    channel("web channel", "web_sales", "ws_sold_date_sk", "ws_item_sk", "ws_promo_sk", "ws_order_number",
            "ws_ext_sales_price", "ws_net_profit", "web_returns", "wr_item_sk", "wr_order_number", "wr_return_amt",
            "wr_net_loss")
    return _channel_rollup(detail)


_SALES_QP = (("store_sales", "ss_sold_date_sk", "ss_item_sk", "ss_quantity", "ss_list_price"),
             ("catalog_sales", "cs_sold_date_sk", "cs_item_sk", "cs_quantity", "cs_list_price"),
             ("web_sales", "ws_sold_date_sk", "ws_item_sk", "ws_quantity", "ws_list_price"))


def _q14_base(tables):
    """(item sk -> id-triple code, the triples by code, the codes of the
    triples sold in all three channels in 1998-2000, the threshold: the
    channels' 1998-2000 average of quantity x list price, exact HALF_UP
    at scale 6, as a double)."""
    dd, it = tables["date_dim"], tables["item"]
    y = dd["d_year"][0]
    years = dd["d_date_sk"][0][(y >= 1998) & (y <= 2000)]
    triples = list(zip(*(it[c][0].tolist() for c in ("i_brand_id", "i_class_id", "i_category_id"))))
    tcodes, tlabels = _codes(triples)
    item_triple = (it["i_item_sk"][0], tcodes, tlabels)
    seen, total, cnt = [], 0, 0
    for fact, d_c, i_c, q_c, p_c in _SALES_QP:
        f = tables[fact]
        m = np.isin(f[d_c][0], years)
        tc = _fact_code(item_triple, f[i_c][0][m])
        seen.append(set(tc[tc >= 0].tolist()))
        total += int((f[q_c][0][m].astype(np.int64) * f[p_c][0][m].astype(np.int64)).sum())
        cnt += int(m.sum())
    inter = np.array(sorted(seen[0] & seen[1] & seen[2]), np.int64)
    q_, r_ = divmod(total * 10_000, cnt)
    return item_triple, tlabels, inter, (q_ + (1 if 2 * r_ >= cnt else 0)) / 1_000_000.0


def _q14_cells(tables, base, channel, year) -> Dict[tuple, list]:
    """{id triple: [sales, number of sales]} of one channel's November
    ``year`` sales of the cross-channel items, kept above the
    threshold."""
    item_triple, tlabels, inter, thr = base
    fact, d_c, i_c, q_c, p_c = channel
    f = tables[fact]
    tc = _fact_code(item_triple, f[i_c][0])
    m = np.isin(f[d_c][0], _days_where(tables, d_year=year, d_moy=11)) & np.isin(tc, inter)
    v = f[q_c][0][m].astype(np.int64) * f[p_c][0][m].astype(np.int64)
    return {k: sn for k, sn in _label_sums(tc[m], tlabels, [v, np.ones(v.shape[0], np.int64)]).items()
            if sn[0] / 100.0 > thr}


def oracle_q14a(tables):
    """{(channel, brand, class, category ids) with None above the level:
    (sales, number of sales)}: November 2002 cells of the items whose id
    triple sells in all three channels in 1998-2000, kept above the
    three channels' 1998-2000 average of quantity x list price (exact
    HALF_UP at scale 6), ROLLUP over the channels' union."""
    base = _q14_base(tables)
    cells = {(name,) + triple: sn for channel, name in zip(_SALES_QP, ("store", "catalog", "web"))
             for triple, sn in _q14_cells(tables, base, channel, 2002).items()}
    return {k[:4]: tuple(v) for k, v in _rollup_levels(cells, 4).items()}


_GMT_CHANNELS = (("store_sales", "ss_sold_date_sk", "ss_item_sk", "ss_addr_sk", "ss_ext_sales_price"),
                 ("catalog_sales", "cs_sold_date_sk", "cs_item_sk", "cs_bill_addr_sk", "cs_ext_sales_price"),
                 ("web_sales", "ws_sold_date_sk", "ws_item_sk", "ws_bill_addr_sk", "ws_ext_sales_price"))


def _channel_union_oracle(tables, *, group_col, item_mask, year, moy):
    """q33, q56 and q60: {id: total} over the three channels' sales in
    one month of the items whose id is in the filtered set, to -5 GMT
    addresses."""
    dd, it, ca = tables["date_dim"], tables["item"], tables["customer_address"]
    d_sks = dd["d_date_sk"][0][(dd["d_year"][0] == year) & (dd["d_moy"][0] == moy)]
    ca_ok = ca["ca_address_sk"][0][ca["ca_gmt_offset"][0] == -500]
    gv = _sv(it, group_col) if it[group_col][1] is not None else it[group_col][0].tolist()
    id_set = {gv[i] for i in np.flatnonzero(item_mask(it))}
    items = _dim(it, "i_item_sk", gv, np.array([g in id_set for g in gv], bool))
    out: Dict = {}
    for fact, d_c, i_c, a_c, p_c in _GMT_CHANNELS:
        f = tables[fact]
        ic = _fact_code(items, f[i_c][0])
        ic = np.where(np.isin(f[d_c][0], d_sks) & np.isin(f[a_c][0], ca_ok), ic, -1)
        for g, (v,) in _label_sums(ic, items[2], [f[p_c][0]]).items():
            out[g] = out.get(g, 0) + v
    return out


def oracle_q33(tables):
    return _channel_union_oracle(tables, group_col="i_manufact_id",
                                 item_mask=lambda it: _s_eq(it, "i_category", "Electronics"), year=1998, moy=5)


def oracle_q56(tables):
    return _channel_union_oracle(
        tables, group_col="i_item_id",
        item_mask=lambda it: _s_eq(it, "i_color", "slate") | _s_eq(it, "i_color", "blanched")
        | _s_eq(it, "i_color", "burnished"), year=2000, moy=2)


def oracle_q60(tables):
    return _channel_union_oracle(tables, group_col="i_item_id", item_mask=lambda it: _s_eq(it, "i_category", "Music"),
                                 year=1999, moy=9)


def oracle_q71(tables):
    """{(brand id, brand, hour, minute): sales}: November 1999 sales of
    the three channels of manager 1's items at breakfast and dinner."""
    dd, it, tm = tables["date_dim"], tables["item"], tables["time_dim"]
    dsel = dd["d_date_sk"][0][(dd["d_year"][0] == 1999) & (dd["d_moy"][0] == 11)]
    items = _dim(it, "i_item_sk", list(zip(it["i_brand_id"][0].tolist(), _sv(it, "i_brand"))),
                 it["i_manager_id"][0] == 1)
    times = _dim(tm, "t_time_sk", list(zip(tm["t_hour"][0].tolist(), tm["t_minute"][0].tolist())),
                 _s_eq(tm, "t_meal_time", "breakfast") | _s_eq(tm, "t_meal_time", "dinner"))
    out: Dict[tuple, int] = {}
    for fact, p_c, d_c, i_c, t_c in (("web_sales", "ws_ext_sales_price", "ws_sold_date_sk", "ws_item_sk",
                                      "ws_sold_time_sk"),
                                     ("catalog_sales", "cs_ext_sales_price", "cs_sold_date_sk", "cs_item_sk",
                                      "cs_sold_time_sk"),
                                     ("store_sales", "ss_ext_sales_price", "ss_sold_date_sk", "ss_item_sk",
                                      "ss_sold_time_sk")):
        f = tables[fact]
        ic, tc = _fact_code(items, f[i_c][0]), _fact_code(times, f[t_c][0])
        m = _keep(ic, tc) & np.isin(f[d_c][0], dsel)
        (gi, gt), (tot,) = _group_sums([ic[m], tc[m]], [f[p_c][0][m]])
        for i, t_, v in zip(gi.tolist(), gt.tolist(), tot.tolist()):
            key = items[2][i] + times[2][t_]
            out[key] = out.get(key, 0) + v
    return out


def oracle_q76(tables):
    """{(channel, key column, year, quarter, category): (count, sales)}
    over the sales rows whose key column is the generator's -1."""
    dd, it = tables["date_dim"], tables["item"]
    dates = _dim(dd, "d_date_sk", list(zip(dd["d_year"][0].tolist(), dd["d_qoy"][0].tolist())))
    items = _dim(it, "i_item_sk", _sv(it, "i_category"))
    out = {}
    for fact, d_c, i_c, null_c, p_c, name in (
            ("store_sales", "ss_sold_date_sk", "ss_item_sk", "ss_customer_sk", "ss_ext_sales_price", "store"),
            ("web_sales", "ws_sold_date_sk", "ws_item_sk", "ws_promo_sk", "ws_ext_sales_price", "web"),
            ("catalog_sales", "cs_sold_date_sk", "cs_item_sk", "cs_bill_customer_sk", "cs_ext_sales_price", "catalog")):
        f = tables[fact]
        dc, ic = _fact_code(dates, f[d_c][0]), _fact_code(items, f[i_c][0])
        m = _keep(dc, ic) & (f[null_c][0] == -1)
        (gd, gi), (n, tot) = _group_sums([dc[m], ic[m]], [np.ones(int(m.sum()), np.int64), f[p_c][0][m]])
        for d, i, c, v in zip(gd.tolist(), gi.tolist(), n.tolist(), tot.tolist()):
            out[(name, null_c) + dates[2][d] + (items[2][i],)] = (c, v)
    return out


def oracle_q66(tables):
    """{warehouse name: (sq ft, city, county, state, country, 12 monthly
    sales, 12 sales per sq ft, 12 monthly nets)}: web and catalog sales
    of 2001 in the time window on DHL or BARIAN; an empty month None;
    the per-sq-ft ratio a sum over the channels of each channel's."""
    dd, tm, smt, wh = tables["date_dim"], tables["time_dim"], tables["ship_mode"], tables["warehouse"]
    dates = (dd["d_date_sk"][0], np.where(dd["d_year"][0] == 2001, dd["d_moy"][0] - 1, -1).astype(np.int64), None)
    t_ok = tm["t_time_sk"][0][(tm["t_time"][0] >= 30838) & (tm["t_time"][0] <= 30838 + 28800)]
    modes = smt["sm_ship_mode_sk"][0][_s_eq(smt, "sm_carrier", "DHL") | _s_eq(smt, "sm_carrier", "BARIAN")]
    wnames = _sv(wh, "w_warehouse_name")
    winfo = list(zip(wnames, wh["w_warehouse_sq_ft"][0].tolist(), _sv(wh, "w_city"), _sv(wh, "w_county"),
                     _sv(wh, "w_state"), _sv(wh, "w_country")))
    whs = _dim(wh, "w_warehouse_sk", winfo)

    def channel(fact, wh_c, date_c, time_c, mode_c, qty_c, sales_c, net_c):
        f = tables[fact]
        mc, wc = _fact_code(dates, f[date_c][0]), _fact_code(whs, f[wh_c][0])
        m = _keep(mc, wc) & np.isin(f[time_c][0], t_ok) & np.isin(f[mode_c][0], modes)
        q = f[qty_c][0][m].astype(np.int64)
        (gw, gm), (s, n_, c) = _group_sums([wc[m], mc[m]], [f[sales_c][0][m].astype(np.int64) * q,
                                                            f[net_c][0][m].astype(np.int64) * q,
                                                            np.ones(int(m.sum()), np.int64)])
        return {(w, mo): (sv, nv) for w, mo, sv, nv in zip(gw.tolist(), gm.tolist(), s.tolist(), n_.tolist())}

    web = channel("web_sales", "ws_warehouse_sk", "ws_sold_date_sk", "ws_sold_time_sk", "ws_ship_mode_sk",
                  "ws_quantity", "ws_ext_sales_price", "ws_net_paid")
    cat = channel("catalog_sales", "cs_warehouse_sk", "cs_sold_date_sk", "cs_sold_time_sk", "cs_ship_mode_sk",
                  "cs_quantity", "cs_sales_price", "cs_net_paid_inc_tax")
    out = {}
    for w in sorted({k[0] for k in web} | {k[0] for k in cat}):
        name, sq_ft, city, cty, state, country = whs[2][w]
        sales, ratios, nets = [], [], []
        for mo in range(12):
            here = [ch[(w, mo)] for ch in (web, cat) if (w, mo) in ch]
            sales.append(sum(v[0] for v in here) if here else None)
            nets.append(sum(v[1] for v in here) if here else None)
            ratios.append(sum((v[0] / 100.0) / float(sq_ft) for v in here) if here else None)
        out[name] = (sq_ft, city, cty, state, country, tuple(sales), tuple(ratios), tuple(nets))
    return out


def _dow_ratios(sums1, sums2, c1, c2) -> tuple:
    """Seven day-of-week ratios of q2 and q59: an empty day None, a zero
    or empty denominator 1.0."""
    return tuple(None if n1 == 0 else (a / 100.0) / ((b / 100.0) if (n2 > 0 and b > 0) else 1.0)
                 for a, b, n1, n2 in zip(sums1, sums2, c1, c2))


def oracle_q2(tables):
    """{week of 2001: 7 day-of-week ratios}: web and catalog sales per
    (week, day), each 2001 week over the week 52 later in 2002; an empty
    day None, a zero or missing denominator 1.0."""
    dd = tables["date_dim"]
    y1 = set(dd["d_week_seq"][0][dd["d_year"][0] == 2001].tolist())
    y2 = set(dd["d_week_seq"][0][dd["d_year"][0] == 2002].tolist())
    dates = (dd["d_date_sk"][0], (dd["d_week_seq"][0].astype(np.int64) * 7 + dd["d_dow"][0]), None)
    sums: Dict[int, list] = {}
    counts: Dict[int, list] = {}
    for fact, d_c, p_c in (("web_sales", "ws_sold_date_sk", "ws_ext_sales_price"),
                           ("catalog_sales", "cs_sold_date_sk", "cs_ext_sales_price")):
        f = tables[fact]
        wd = _fact_code(dates, f[d_c][0])
        m = wd >= 0
        (g,), (tot, n) = _group_sums([wd[m]], [f[p_c][0][m], np.ones(int(m.sum()), np.int64)])
        for k, v, c in zip(g.tolist(), tot.tolist(), n.tolist()):
            sums.setdefault(k // 7, [0] * 7)[k % 7] += v
            counts.setdefault(k // 7, [0] * 7)[k % 7] += c
    out = {}
    for w1, sums1 in sums.items():
        k2 = w1 + 52
        if w1 not in y1 or k2 not in y2 or k2 not in sums:
            continue
        out[w1] = _dow_ratios(sums1, sums[k2], counts[w1], counts[k2])
    return out


def oracle_q75(tables):
    """{(brand, class, category, manufacturer ids): (quantity change,
    amount change)} of the Books items whose 2002 quantity, net of
    returns over the three channels, fell below 90% of 2001's."""
    dd, it = tables["date_dim"], tables["item"]
    ids = list(zip(*(it[c][0].tolist() for c in ("i_brand_id", "i_class_id", "i_category_id", "i_manufact_id"))))
    items = _dim(it, "i_item_sk", ids, _s_eq(it, "i_category", "Books"))
    dates = (dd["d_date_sk"][0], dd["d_year"][0].astype(np.int64), None)
    agg: Dict[tuple, list] = {}
    for fact, d_c, i_c, k2_c, q_c, a_c, rtab, ri_c, rk2_c, rq_c, ra_c in (
            ("store_sales", "ss_sold_date_sk", "ss_item_sk", "ss_ticket_number", "ss_quantity", "ss_ext_sales_price",
             "store_returns", "sr_item_sk", "sr_ticket_number", "sr_return_quantity", "sr_return_amt"),
            ("catalog_sales", "cs_sold_date_sk", "cs_item_sk", "cs_order_number", "cs_quantity",
             "cs_ext_sales_price", "catalog_returns", "cr_item_sk", "cr_order_number", "cr_return_quantity",
             "cr_return_amount"),
            ("web_sales", "ws_sold_date_sk", "ws_item_sk", "ws_order_number", "ws_quantity", "ws_ext_sales_price",
             "web_returns", "wr_item_sk", "wr_order_number", "wr_return_quantity", "wr_return_amt")):
        f, r = tables[fact], tables[rtab]
        yc, ic = _fact_code(dates, f[d_c][0]), _fact_code(items, f[i_c][0])
        m = _keep(yc, ic)
        mult, (rq, ra) = _left_join_sums([f[i_c][0][m], f[k2_c][0][m]], [r[ri_c][0], r[rk2_c][0]],
                                         [r[rq_c][0], r[ra_c][0]])
        q, a = f[q_c][0][m].astype(np.int64), f[a_c][0][m].astype(np.int64)
        (gy, gi), (cnt, amt) = _group_sums([yc[m], ic[m]], [q * mult - rq, a * mult - ra])
        for yy, i, c, v in zip(gy.tolist(), gi.tolist(), cnt.tolist(), amt.tolist()):
            acc = agg.setdefault((yy,) + items[2][i], [0, 0])
            acc[0] += c
            acc[1] += v
    out = {}
    for key, (cnt, amt) in agg.items():
        prev = agg.get((2001,) + key[1:])
        if key[0] == 2002 and prev is not None and prev[0] > 0 and cnt / prev[0] < 0.9:
            out[key[1:]] = (cnt - prev[0], amt - prev[1])
    return out


def oracle_q54(tables):
    """{segment: customers}: the store revenue, in the three months after
    December 1998, of the customers who bought Women items from catalog
    or web in 1998, at the stores of their own county and state (each
    such store a match), in $50 segments (the engine's double division
    truncated to int)."""
    dd, it, cust, ca, st, ss = (tables[k] for k in ("date_dim", "item", "customer", "customer_address", "store",
                                                    "store_sales"))
    women = it["i_item_sk"][0][_s_eq(it, "i_category", "Women")]
    y98 = dd["d_date_sk"][0][dd["d_year"][0] == 1998]
    buyers = []
    for fact, d_c, c_c, i_c in (("catalog_sales", "cs_sold_date_sk", "cs_bill_customer_sk", "cs_item_sk"),
                                ("web_sales", "ws_sold_date_sk", "ws_bill_customer_sk", "ws_item_sk")):
        f = tables[fact]
        m = np.isin(f[d_c][0], y98) & np.isin(f[i_c][0], women) & np.isin(f[c_c][0], cust["c_customer_sk"][0])
        buyers.append(f[c_c][0][m])
    buyers = np.unique(np.concatenate(buyers))
    dec98 = (dd["d_year"][0] == 1998) & (dd["d_moy"][0] == 12)
    ms = int(dd["d_month_seq"][0][dec98][0])
    wsk = dd["d_date_sk"][0][(dd["d_month_seq"][0] >= ms + 1) & (dd["d_month_seq"][0] <= ms + 3)]
    store_locs: Dict[tuple, int] = {}
    for loc in zip(_sv(st, "s_county"), _sv(st, "s_state")):
        store_locs[loc] = store_locs.get(loc, 0) + 1
    locs = _dim(ca, "ca_address_sk", list(zip(_sv(ca, "ca_county"), _sv(ca, "ca_state"))))
    mult_of_loc = np.array([store_locs.get(lb, 0) for lb in locs[2]], np.int64)
    m = np.isin(ss["ss_sold_date_sk"][0], wsk) & np.isin(ss["ss_customer_sk"][0], buyers)
    c = ss["ss_customer_sk"][0][m]
    lc = _fact_code(locs, cust["c_current_addr_sk"][0][_rows_of(cust["c_customer_sk"][0], c)])
    mult = np.where(lc >= 0, mult_of_loc[np.maximum(lc, 0)], 0)
    keep = mult > 0
    (g,), (rev,) = _group_sums([c[keep]], [ss["ss_ext_sales_price"][0][m][keep].astype(np.int64) * mult[keep]])
    segs: Dict[int, int] = {}
    for cents in rev.tolist():
        seg = int((cents / 100.0) / 50.0)
        segs[seg] = segs.get(seg, 0) + 1
    return segs


def _q23_rows(tables):
    """(customer, quantity x list price) of the catalog and web sales of
    May 2000 of the frequent items (sold more than 4 times in one
    (item, month) cell of the store) to the best customers (lifetime
    store spend over half the largest)."""
    dd, ss = tables["date_dim"], tables["store_sales"]
    ym = (dd["d_date_sk"][0], dd["d_year"][0].astype(np.int64) * 12 + dd["d_moy"][0], None)
    cell = _fact_code(ym, ss["ss_sold_date_sk"][0])
    m = cell >= 0
    (gi, _), (cnt,) = _group_sums([ss["ss_item_sk"][0][m].astype(np.int64), cell[m]], [np.ones(int(m.sum()), np.int64)])
    hot = np.unique(gi[cnt > 4])
    (cust,), (spend,) = _group_sums([ss["ss_customer_sk"][0].astype(np.int64)],
                                    [ss["ss_quantity"][0].astype(np.int64) * ss["ss_sales_price"][0].astype(np.int64)])
    cmax = int(spend.max())
    best = np.array([c for c, v in zip(cust.tolist(), spend.tolist()) if v / 100.0 > 0.5 * (cmax / 100.0)], np.int64)
    may = dd["d_date_sk"][0][(dd["d_year"][0] == 2000) & (dd["d_moy"][0] == 5)]
    custs, vals = [], []
    for fact, d_c, i_c, c_c, q_c, p_c in (("catalog_sales", "cs_sold_date_sk", "cs_item_sk", "cs_bill_customer_sk",
                                           "cs_quantity", "cs_list_price"),
                                          ("web_sales", "ws_sold_date_sk", "ws_item_sk", "ws_bill_customer_sk",
                                           "ws_quantity", "ws_list_price")):
        f = tables[fact]
        m = np.isin(f[d_c][0], may) & np.isin(f[i_c][0], hot) & np.isin(f[c_c][0], best)
        custs.append(f[c_c][0][m].astype(np.int64))
        vals.append(f[q_c][0][m].astype(np.int64) * f[p_c][0][m].astype(np.int64))
    return np.concatenate(custs), np.concatenate(vals)


def oracle_q23a(tables):
    """The total of :func:`_q23_rows` (None when it has no row)."""
    _, vals = _q23_rows(tables)
    return int(vals.sum()) if vals.shape[0] else None


def oracle_q23b(tables):
    """{(last name, first name): total} of :func:`_q23_rows`."""
    custs, vals = _q23_rows(tables)
    cu = tables["customer"]
    names = _dim(cu, "c_customer_sk", list(zip(_sv(cu, "c_last_name"), _sv(cu, "c_first_name"))))
    return {k: v[0] for k, v in _label_sums(_fact_code(names, custs), names[2], [vals]).items()}


# ------------------------------- EXISTS, INTERSECT, EXCEPT; stddev; concat


def _active_set(tables, sales, date_col, cust_col, *, year, moys) -> np.ndarray:
    """The distinct customer keys of one channel in a (year, months)
    window."""
    dd, sl = tables["date_dim"], tables[sales]
    m = (dd["d_year"][0] == year) & (dd["d_moy"][0] >= moys[0]) & (dd["d_moy"][0] <= moys[1])
    return np.unique(sl[cust_col][0][np.isin(sl[date_col][0], dd["d_date_sk"][0][m])])


def _channel_sets(tables, *, year, moys):
    """The (store, web, catalog) customer sets of q10, q35 and q69."""
    return tuple(_active_set(tables, s, d, c, year=year, moys=moys)
                 for s, d, c in (("store_sales", "ss_sold_date_sk", "ss_customer_sk"),
                                 ("web_sales", "ws_sold_date_sk", "ws_bill_customer_sk"),
                                 ("catalog_sales", "cs_sold_date_sk", "cs_ship_customer_sk")))


def _customers_by_demographics(tables, active: np.ndarray, addr_ok: np.ndarray, cd_cols) -> Dict[tuple, list]:
    """{the demographics row's ``cd_cols`` values: [row of each customer
    whose key is in ``active`` and whose address key is in ``addr_ok``]}."""
    cu, cd = tables["customer"], tables["customer_demographics"]
    m = np.isin(cu["c_customer_sk"][0], active) & np.isin(cu["c_current_addr_sk"][0], addr_ok)
    rows = _rows_of(cd["cd_demo_sk"][0], cu["c_current_cdemo_sk"][0][m])
    cols = [_sv(cd, c) if cd[c][1] is not None else cd[c][0].tolist() for c in cd_cols]
    out: Dict[tuple, list] = defaultdict(list)
    for cust, r in zip(np.flatnonzero(m).tolist(), rows.tolist()):
        if r >= 0:
            out[tuple(c[r] for c in cols)].append(cust)
    return out


_Q10_CD = ("cd_gender", "cd_marital_status", "cd_education_status", "cd_purchase_estimate", "cd_credit_rating",
           "cd_dep_count", "cd_dep_employed_count", "cd_dep_college_count")


def oracle_q10(tables):
    """{demographics (8 columns): customers} of three counties' customers
    with a store purchase and a web or catalog one in January-April
    2002."""
    ca = tables["customer_address"]
    addr = ca["ca_address_sk"][0][_s_isin(ca, "ca_county", ("Williamson County", "Franklin Parish", "Bronx County"))]
    ss, ws, cs = _channel_sets(tables, year=2002, moys=(1, 4))
    active = np.intersect1d(ss, np.union1d(ws, cs))
    return {k: len(v) for k, v in _customers_by_demographics(tables, active, addr, _Q10_CD).items()}


def oracle_q35(tables):
    """{(state, gender, marital status, 3 dependant counts): (count, then
    avg, max and sum of each dependant count)} of q10's customers in
    every state."""
    cu, ca = tables["customer"], tables["customer_address"]
    ss, ws, cs = _channel_sets(tables, year=2002, moys=(1, 4))
    active = np.intersect1d(ss, np.union1d(ws, cs))
    deps = ("cd_dep_count", "cd_dep_employed_count", "cd_dep_college_count")
    state = _rows_of(ca["ca_address_sk"][0], cu["c_current_addr_sk"][0])
    states = _sv(ca, "ca_state")
    out = {}
    for (g, ms, *dep), custs in _customers_by_demographics(tables, active, ca["ca_address_sk"][0],
                                                           ("cd_gender", "cd_marital_status") + deps).items():
        by_state: Dict[str, int] = defaultdict(int)
        for c in custs:
            by_state[states[state[c]]] += 1
        for st, n in by_state.items():
            # every customer of the group has the same dependant counts
            out[(st, g, ms, *dep)] = (n,) + tuple(x for d in dep for x in (float(d), d, d * n))
    return out


def oracle_q69(tables):
    """{demographics (5 columns): customers} of three states' customers
    with a store purchase and neither a web nor a catalog one in
    January-March 2002."""
    ca = tables["customer_address"]
    addr = ca["ca_address_sk"][0][_s_isin(ca, "ca_state", ("TN", "SD", "AL"))]
    ss, ws, cs = _channel_sets(tables, year=2002, moys=(1, 3))
    active = np.setdiff1d(ss, np.union1d(ws, cs))
    return {k: len(v) for k, v in _customers_by_demographics(tables, active, addr, _Q10_CD[:5]).items()}


def _channel_customer_set(tables, sales, date_col, cust_col, year) -> np.ndarray:
    """The distinct (last name, first name, d_date) of one channel's
    buyers in ``year``, each as one int64: a name code times 2^32 plus
    the day."""
    dd, cu, sl = tables["date_dim"], tables["customer"], tables[sales]
    days = _dim(dd, "d_date_sk", dd["d_date"][0].tolist(), dd["d_year"][0] == year)
    names = _dim(cu, "c_customer_sk", list(zip(_sv(cu, "c_last_name"), _sv(cu, "c_first_name"))))
    day_code = _fact_code(days, sl[date_col][0])
    name_code = _fact_code(names, sl[cust_col][0])
    m = (day_code >= 0) & (name_code >= 0)
    day = np.asarray(days[2], np.int64)[day_code[m]]
    return np.unique(name_code[m] * (1 << 32) + day)


def _three_channel_sets(tables):
    return [_channel_customer_set(tables, s, d, c, 2000)
            for s, d, c in (("store_sales", "ss_sold_date_sk", "ss_customer_sk"),
                            ("catalog_sales", "cs_sold_date_sk", "cs_bill_customer_sk"),
                            ("web_sales", "ws_sold_date_sk", "ws_bill_customer_sk"))]


def oracle_q38(tables):
    """How many (name, day) bought in all three channels in 2000."""
    ss, cs, ws = _three_channel_sets(tables)
    return int(np.intersect1d(np.intersect1d(ss, cs), ws).shape[0])


def oracle_q87(tables):
    """How many (name, day) bought in a store in 2000 but neither from
    the catalog nor on the web."""
    ss, cs, ws = _three_channel_sets(tables)
    return int(np.setdiff1d(np.setdiff1d(ss, cs), ws).shape[0])


def _pairs(left: np.ndarray, right: np.ndarray):
    """(left rows, right rows) of every pair with equal int64 keys."""
    order = np.argsort(right, kind="stable")
    rk = right[order]
    lo, hi = np.searchsorted(rk, left, "left"), np.searchsorted(rk, left, "right")
    n = hi - lo
    li = np.repeat(np.arange(left.shape[0]), n)
    at = np.arange(int(n.sum())) - np.repeat(np.cumsum(n) - n, n)
    return li, order[np.repeat(lo, n) + at]


def _key2(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Two int keys as one int64 (``b`` as its low 32 bits: the
    generator's -1 null stand-in stays apart from every key)."""
    return a.astype(np.int64) * (1 << 32) + (b.astype(np.int64) & 0xFFFFFFFF)


def _srcandc(tables, columns):
    """The q17/q25/q29 chain: (a group code per chain row, the labels
    (item id, item desc, store name) by code, each of ``columns`` —
    (table, column) — per chain row).  A store line of 2000, its returns
    of 2000-2002 on (item, ticket), the returning customer's catalog
    lines of 2000-2002 of the same item, with a store and an item."""
    dd = tables["date_dim"]
    y = dd["d_year"][0]
    y2000 = dd["d_date_sk"][0][y == 2000]
    y00_02 = dd["d_date_sk"][0][(y >= 2000) & (y <= 2002)]
    ss, sr, cs = tables["store_sales"], tables["store_returns"], tables["catalog_sales"]
    st, it = tables["store"], tables["item"]
    s_rows = np.flatnonzero(np.isin(ss["ss_sold_date_sk"][0], y2000))
    r_rows = np.flatnonzero(np.isin(sr["sr_returned_date_sk"][0], y00_02))
    c_rows = np.flatnonzero(np.isin(cs["cs_sold_date_sk"][0], y00_02))
    a, b = _pairs(_key2(ss["ss_item_sk"][0][s_rows], ss["ss_ticket_number"][0][s_rows]),
                  _key2(sr["sr_item_sk"][0][r_rows], sr["sr_ticket_number"][0][r_rows]))
    s_rows, r_rows = s_rows[a], r_rows[b]
    a, b = _pairs(_key2(sr["sr_customer_sk"][0][r_rows], sr["sr_item_sk"][0][r_rows]),
                  _key2(cs["cs_bill_customer_sk"][0][c_rows], cs["cs_item_sk"][0][c_rows]))
    s_rows, r_rows, c_rows = s_rows[a], r_rows[a], c_rows[b]
    store = _dim(st, "s_store_sk", _sv(st, "s_store_name"))
    item = _dim(it, "i_item_sk", list(zip(_sv(it, "i_item_id"), _sv(it, "i_item_desc"))))
    sc = _fact_code(store, ss["ss_store_sk"][0][s_rows])
    ic = _fact_code(item, ss["ss_item_sk"][0][s_rows])
    m = (sc >= 0) & (ic >= 0)
    labels = [i + (s,) for i in item[2] for s in store[2]]
    rows = {"store_sales": s_rows[m], "store_returns": r_rows[m], "catalog_sales": c_rows[m]}
    return (ic[m] * len(store[2]) + sc[m], labels,
            [tables[t][c][0][rows[t]].astype(np.int64) for t, c in columns])


def _srcandc_sums(tables, columns):
    codes, labels, values = _srcandc(tables, columns)
    return {k: tuple(v) for k, v in _label_sums(codes, labels, values).items()}


def oracle_q25(tables):
    """{(item id, item desc, store name): (store profit, return loss,
    catalog profit)}, unscaled decimals."""
    return _srcandc_sums(tables, (("store_sales", "ss_net_profit"), ("store_returns", "sr_net_loss"),
                                  ("catalog_sales", "cs_net_profit")))


def oracle_q29(tables):
    """{(item id, item desc, store name): (the three legs' quantities)}."""
    return _srcandc_sums(tables, (("store_sales", "ss_quantity"), ("store_returns", "sr_return_quantity"),
                                  ("catalog_sales", "cs_quantity")))


def _moments(codes: np.ndarray, values: np.ndarray):
    """(group codes, count, mean, sample stddev or None) per group of
    integer ``values``: the variance (n sum x^2 - (sum x)^2) / (n (n-1))
    exact in integers, then one correctly rounded division."""
    (g,), (n, s, q) = _group_sums([codes], [np.ones_like(values), values, values * values])
    out = []
    for c, cnt, tot, sq in zip(g.tolist(), n.tolist(), s.tolist(), q.tolist()):
        sd = math.sqrt((cnt * sq - tot * tot) / (cnt * (cnt - 1))) if cnt > 1 else None
        out.append((c, cnt, tot / cnt, sd))
    return out


def _cov(sd, mean):
    return sd / mean if sd is not None and mean > 0 else None


def oracle_q17(tables):
    """{(item id, item desc, store name): ((count, avg, stddev, cov) of
    each leg's quantity)}."""
    codes, labels, values = _srcandc(tables, (("store_sales", "ss_quantity"), ("store_returns", "sr_return_quantity"),
                                              ("catalog_sales", "cs_quantity")))
    out: Dict[tuple, list] = defaultdict(list)
    for v in values:
        for c, n, mean, sd in _moments(codes, v):
            out[labels[c]].append((n, mean, sd, _cov(sd, mean)))
    return {k: tuple(v) for k, v in out.items()}


def _q39_month(tables, moy: int) -> Dict[tuple, tuple]:
    """{(warehouse name, item): (mean, cov)} of the quantity on hand in
    one month of 2001, where the cov is defined."""
    dd, wh, inv = tables["date_dim"], tables["warehouse"], tables["inventory"]
    days = dd["d_date_sk"][0][(dd["d_year"][0] == 2001) & (dd["d_moy"][0] == moy)]
    m = np.isin(inv["inv_date_sk"][0], days)
    names = _dim(wh, "w_warehouse_sk", _sv(wh, "w_warehouse_name"))
    w = _fact_code(names, inv["inv_warehouse_sk"][0][m])
    items = inv["inv_item_sk"][0][m].astype(np.int64)
    keep = w >= 0
    out = {}
    for c, _, mean, sd in _moments(_key2(w[keep], items[keep]), inv["inv_quantity_on_hand"][0][m][keep]
                                   .astype(np.int64)):
        cov = _cov(sd, mean)
        if cov is not None:
            out[(names[2][c >> 32], c & 0xFFFFFFFF)] = (mean, cov)
    return out


def _q39(tables, thr1: float, thr2: float):
    """{(warehouse name, item): (mean, cov, mean2, cov2)} with January's
    cov over ``thr1`` and February's over ``thr2``; and the rows whose
    cov lies within 1e-9 relative of its threshold (the engine's cov may
    fall on the other side there)."""
    m1, m2 = _q39_month(tables, 1), _q39_month(tables, 2)
    near = sorted(k for m, thr in ((m1, thr1), (m2, thr2)) for k, (_, cov) in m.items()
                  if abs(cov - thr) <= 1e-9 * thr)
    rows = {k: m1[k] + m2[k] for k in m1 if k in m2 and m1[k][1] > thr1 and m2[k][1] > thr2}
    return rows, near


def oracle_q39a(tables):
    return _q39(tables, 0.7, 0.7)


def oracle_q39b(tables):
    return _q39(tables, 0.85, 0.7)


def oracle_q84(tables):
    """The sorted rows (customer id, "last, first") of one city's
    customers in an income range, one per store return of their
    demographics; the first 100."""
    ca, ib, hd = tables["customer_address"], tables["income_band"], tables["household_demographics"]
    cu, cd, sr = tables["customer"], tables["customer_demographics"], tables["store_returns"]
    midway = ca["ca_address_sk"][0][_s_eq(ca, "ca_city", "Midway")]
    bands = ib["ib_income_band_sk"][0][(ib["ib_lower_bound"][0] >= 38128) & (ib["ib_upper_bound"][0] <= 88128)]
    hsel = hd["hd_demo_sk"][0][np.isin(hd["hd_income_band_sk"][0], bands)]
    m = (np.isin(cu["c_current_addr_sk"][0], midway) & np.isin(cu["c_current_hdemo_sk"][0], hsel)
         & np.isin(cu["c_current_cdemo_sk"][0], cd["cd_demo_sk"][0]))
    cdemo, n = np.unique(sr["sr_cdemo_sk"][0], return_counts=True)
    ids, lasts, firsts = _sv(cu, "c_customer_id"), _sv(cu, "c_last_name"), _sv(cu, "c_first_name")
    rows = []
    for i in np.flatnonzero(m).tolist():
        k = np.searchsorted(cdemo, cu["c_current_cdemo_sk"][0][i])
        if k < cdemo.shape[0] and cdemo[k] == cu["c_current_cdemo_sk"][0][i]:
            rows += [(ids[i], f"{lasts[i]}, {firsts[i]}")] * int(n[k])
    return sorted(rows)[:100]


# ------------------------------------------------- single-fact reports


def _strs(table, name: str, rows) -> List[str]:
    """The string column ``name`` at ``rows`` only."""
    data, lengths = table[name]
    return [bytes(data[r, :lengths[r]]).decode() for r in rows]


def _days_where(tables, **equal) -> np.ndarray:
    """The date_sk of the days whose date_dim columns equal ``equal``'s
    values."""
    dd = tables["date_dim"]
    m = np.ones(dd["d_date_sk"][0].shape[0], bool)
    for c, v in equal.items():
        m &= dd[c][0] == v
    return dd["d_date_sk"][0][m]


def oracle_q52(tables):
    return _brand_rollup(tables, year=2000, moy=11, item_filter_col="i_manager_id", item_filter_val=1,
                         group_cols=["i_brand_id", "i_brand"])


def oracle_q55(tables):
    return _brand_rollup(tables, year=1999, moy=11, item_filter_col="i_manager_id", item_filter_val=28,
                         group_cols=["i_brand_id", "i_brand"])


def oracle_q42(tables):
    return _brand_rollup(tables, year=2000, moy=11, item_filter_col="i_manager_id", item_filter_val=1,
                         group_cols=["i_category_id", "i_category"])


def oracle_q19(tables):
    """{(brand id, brand, manufact id, manufact): sum}: November 1998
    store sales of manager 8's items to buyers whose 5-digit zip is not
    the store's."""
    it, cu, ca, st, ss = (tables[k] for k in ("item", "customer", "customer_address", "store", "store_sales"))
    labels = list(zip(it["i_brand_id"][0].tolist(), _sv(it, "i_brand"), it["i_manufact_id"][0].tolist(),
                      _sv(it, "i_manufact")))
    items = _dim(it, "i_item_sk", labels, it["i_manager_id"][0] == 8)
    # one code space for both zips
    zc, _ = _codes([z[:5] for z in _sv(ca, "ca_zip")] + [z[:5] for z in _sv(st, "s_zip")])
    n_ca = ca["ca_address_sk"][0].shape[0]
    m = np.isin(ss["ss_sold_date_sk"][0], _days_where(tables, d_moy=11, d_year=1998))
    ic = _fact_code(items, ss["ss_item_sk"][0])
    cu_row = _rows_of(cu["c_customer_sk"][0], ss["ss_customer_sk"][0])
    cz = _fact_code((ca["ca_address_sk"][0], zc[:n_ca], None), cu["c_current_addr_sk"][0][np.maximum(cu_row, 0)])
    sz = _fact_code((st["s_store_sk"][0], zc[n_ca:], None), ss["ss_store_sk"][0])
    m &= _keep(ic, cu_row, cz, sz) & (cz != sz)
    return {k: v[0] for k, v in _label_sums(np.where(m, ic, -1), items[2], [ss["ss_ext_sales_price"][0]]).items()}


def oracle_q43(tables):
    """{store name: [Sunday..Saturday sums]}: the store sales of 2000; a
    weekday with no sale sums to None, as the engine's sum of no value."""
    dd, st, ss = tables["date_dim"], tables["store"], tables["store_sales"]
    d_row = _rows_of(dd["d_date_sk"][0], ss["ss_sold_date_sk"][0])
    stores = _dim(st, "s_store_sk", _sv(st, "s_store_name"))
    sc = _fact_code(stores, ss["ss_store_sk"][0])
    m = _keep(d_row, sc)
    d_row = np.maximum(d_row, 0)
    m &= dd["d_year"][0][d_row] == 2000
    (g, dow), (s,) = _group_sums([sc[m], dd["d_dow"][0][d_row][m]], [ss["ss_sales_price"][0][m]])
    out: Dict[str, list] = {}
    for c, k, v in zip(g.tolist(), dow.tolist(), s.tolist()):
        out.setdefault(stores[2][c], [None] * 7)[k] = v
    return out


def oracle_q96(tables) -> int:
    """The count of store sales at 20:30-20:59 to 7-dependant households
    at the stores named "ese"."""
    td, hd, st, ss = (tables[k] for k in ("time_dim", "household_demographics", "store", "store_sales"))
    m = np.isin(ss["ss_sold_time_sk"][0], td["t_time_sk"][0][(td["t_hour"][0] == 20) & (td["t_minute"][0] >= 30)])
    m &= np.isin(ss["ss_hdemo_sk"][0], hd["hd_demo_sk"][0][hd["hd_dep_count"][0] == 7])
    m &= np.isin(ss["ss_store_sk"][0], st["s_store_sk"][0][_s_eq(st, "s_store_name", "ese")])
    return int(m.sum())


def oracle_q26(tables):
    """{item id: (avg quantity, avg list price, avg coupon, avg sales
    price)}: q7's over ``catalog_sales``; decimal averages unscaled at
    scale 6, exact HALF_UP."""
    cd, pr, it, cs = (tables[k] for k in ("customer_demographics", "promotion", "item", "catalog_sales"))
    cd_ok = (_s_eq(cd, "cd_gender", "M") & _s_eq(cd, "cd_marital_status", "S")
             & _s_eq(cd, "cd_education_status", "College"))
    p_ok = _s_eq(pr, "p_channel_email", "N") | _s_eq(pr, "p_channel_event", "N")
    items = _dim(it, "i_item_sk", _sv(it, "i_item_id"))
    m = (np.isin(cs["cs_bill_cdemo_sk"][0], cd["cd_demo_sk"][0][cd_ok])
         & np.isin(cs["cs_sold_date_sk"][0], _days_where(tables, d_year=2000))
         & np.isin(cs["cs_promo_sk"][0], pr["p_promo_sk"][0][p_ok]))
    ic = _fact_code(items, cs["cs_item_sk"][0])
    vals = [cs[c][0] for c in ("cs_quantity", "cs_list_price", "cs_coupon_amt", "cs_sales_price")]
    sums = _label_sums(np.where(m, ic, -1), items[2], vals + [np.ones(ic.shape[0], np.int64)])
    return {k: (v[0] / v[4], _avg_u(v[1], v[4]), _avg_u(v[2], v[4]), _avg_u(v[3], v[4])) for k, v in sums.items()}


def oracle_q6(tables):
    """{state: buyers} of the states with at least 10 store sales in May
    2000 of items priced over 1.2 times their category's average (the
    average unscaled at scale 6, exact HALF_UP, compared as doubles)."""
    it, cu, ca, ss = tables["item"], tables["customer"], tables["customer_address"], tables["store_sales"]
    cats, _ = _codes(_sv(it, "i_category"))
    price = it["i_current_price"][0].astype(np.int64)
    (g,), (tot, n) = _group_sums([cats], [price, np.ones(cats.shape[0], np.int64)])
    avg = np.zeros(int(g.max()) + 1, np.int64)
    avg[g] = [_avg_u(s, k) for s, k in zip(tot.tolist(), n.tolist())]
    hot = it["i_item_sk"][0][price / 100.0 > 1.2 * (avg[cats] / 1_000_000.0)]
    m = np.isin(ss["ss_sold_date_sk"][0], _days_where(tables, d_year=2000, d_moy=5))
    m &= np.isin(ss["ss_item_sk"][0], hot)
    cu_row = _rows_of(cu["c_customer_sk"][0], ss["ss_customer_sk"][0])
    states = _dim(ca, "ca_address_sk", _sv(ca, "ca_state"))
    sc = _fact_code(states, cu["c_current_addr_sk"][0][np.maximum(cu_row, 0)])
    m &= _keep(cu_row, sc)
    counts = _label_sums(np.where(m, sc, -1), states[2], [np.ones(sc.shape[0], np.int64)])
    return {k: v[0] for k, v in counts.items() if v[0] >= 10}


def oracle_q41(tables):
    """The sorted distinct item ids of manufacturer ids 50-120 whose
    manufacturer makes a (powder or navy, Each or Dozen) or (peach or
    saddle, Case or Pallet) item."""
    it = tables["item"]
    colors, units, manufs, ids = _sv(it, "i_color"), _sv(it, "i_units"), _sv(it, "i_manufact"), _sv(it, "i_item_id")
    ok = {m for c, u, m in zip(colors, units, manufs)
          if (c in ("powder", "navy") and u in ("Each", "Dozen"))
          or (c in ("peach", "saddle") and u in ("Case", "Pallet"))}
    mids = it["i_manufact_id"][0].tolist()
    return sorted({ids[k] for k in range(len(ids)) if 50 <= mids[k] <= 120 and manufs[k] in ok})


def _q13_mask(tables) -> np.ndarray:
    """The store sales rows of q13's and q48's bands (2001, a store, the
    demographic band AND the address band)."""
    from .queries import Q13_BANDS, Q13_STATE_BANDS

    ss, st, cd, hd, ca = (tables[k] for k in ("store_sales", "store", "customer_demographics",
                                             "household_demographics", "customer_address"))
    cd_row = _rows_of(cd["cd_demo_sk"][0], ss["ss_cdemo_sk"][0])
    hd_row = _rows_of(hd["hd_demo_sk"][0], ss["ss_hdemo_sk"][0])
    ca_row = _rows_of(ca["ca_address_sk"][0], ss["ss_addr_sk"][0])
    m = (np.isin(ss["ss_sold_date_sk"][0], _days_where(tables, d_year=2001))
         & np.isin(ss["ss_store_sk"][0], st["s_store_sk"][0]) & _keep(cd_row, hd_row, ca_row))
    cd_row, hd_row, ca_row = np.maximum(cd_row, 0), np.maximum(hd_row, 0), np.maximum(ca_row, 0)
    sp, npf, dep = ss["ss_sales_price"][0], ss["ss_net_profit"][0], hd["hd_dep_count"][0][hd_row]
    demo = np.zeros(m.shape[0], bool)
    for ms, ed, lo, hi, n_dep in Q13_BANDS:
        band = _s_eq(cd, "cd_marital_status", ms) & _s_eq(cd, "cd_education_status", ed)
        demo |= band[cd_row] & (sp >= lo * 100) & (sp <= hi * 100) & (dep == n_dep)
    geo = np.zeros(m.shape[0], bool)
    for states, lo, hi in Q13_STATE_BANDS:
        geo |= _s_isin(ca, "ca_state", states)[ca_row] & (npf >= lo * 100) & (npf <= hi * 100)
    return m & demo & geo


def oracle_q13(tables):
    """{avg_qty, avg_ext_sales, avg_ext_disc, cnt} of the banded rows
    (decimal averages unscaled at scale 6, exact HALF_UP); None if none."""
    ss = tables["store_sales"]
    m = _q13_mask(tables)
    n = int(m.sum())
    if n == 0:
        return None
    total = lambda c: int(ss[c][0][m].astype(np.int64).sum())
    return dict(avg_qty=total("ss_quantity") / n, avg_ext_sales=_avg_u(total("ss_ext_sales_price"), n),
                avg_ext_disc=_avg_u(total("ss_ext_discount_amt"), n), cnt=n)


def oracle_q48(tables) -> int:
    """The banded rows' total quantity."""
    return int(tables["store_sales"]["ss_quantity"][0][_q13_mask(tables)].astype(np.int64).sum())


def oracle_q15(tables):
    """{zip: sum}: catalog sales of 2001 Q2 whose buyer's zip prefix is
    listed, state is TN, GA or OH, or price is over 250."""
    from .queries import Q15_ZIPS

    cu, ca, cs = tables["customer"], tables["customer_address"], tables["catalog_sales"]
    zips = _sv(ca, "ca_zip")
    ok = np.array([z[:5] in Q15_ZIPS for z in zips], bool) | _s_isin(ca, "ca_state", ("TN", "GA", "OH"))
    m = np.isin(cs["cs_sold_date_sk"][0], _days_where(tables, d_qoy=2, d_year=2001))
    cu_row = _rows_of(cu["c_customer_sk"][0], cs["cs_bill_customer_sk"][0])
    a_row = _rows_of(ca["ca_address_sk"][0], cu["c_current_addr_sk"][0][np.maximum(cu_row, 0)])
    m &= _keep(cu_row, a_row)
    price = cs["cs_sales_price"][0]
    m &= ok[np.maximum(a_row, 0)] | (price > 250 * 100)
    codes, labels = _codes(zips)
    return {k: v[0] for k, v in _label_sums(np.where(m, codes[np.maximum(a_row, 0)], -1), labels, [price]).items()}


def oracle_q45(tables):
    """{(zip, city): sum}: web sales of 2000 Q2 whose buyer's zip prefix
    is listed or whose item's id is one of the items of keys 2-29
    prime."""
    it, cu, ca, ws = tables["item"], tables["customer"], tables["customer_address"], tables["web_sales"]
    ids = _sv(it, "i_item_id")
    primes = np.isin(it["i_item_sk"][0], (2, 3, 5, 7, 11, 13, 17, 19, 23, 29))
    hot = {ids[j] for j in np.flatnonzero(primes).tolist()}
    item_hot = np.array([i in hot for i in ids], bool)
    zips = _sv(ca, "ca_zip")
    zip_ok = np.array([z[:5] in ("35000", "35137", "60031", "60062", "60093") for z in zips], bool)
    m = np.isin(ws["ws_sold_date_sk"][0], _days_where(tables, d_year=2000, d_qoy=2))
    i_row = _rows_of(it["i_item_sk"][0], ws["ws_item_sk"][0])
    cu_row = _rows_of(cu["c_customer_sk"][0], ws["ws_bill_customer_sk"][0])
    a_row = _rows_of(ca["ca_address_sk"][0], cu["c_current_addr_sk"][0][np.maximum(cu_row, 0)])
    m &= _keep(i_row, cu_row, a_row)
    a_row = np.maximum(a_row, 0)
    m &= zip_ok[a_row] | item_hot[np.maximum(i_row, 0)]
    codes, labels = _codes(list(zip(zips, _sv(ca, "ca_city"))))
    return {k: v[0] for k, v in _label_sums(np.where(m, codes[a_row], -1), labels, [ws["ws_sales_price"][0]]).items()}


def oracle_q8(tables):
    """{store name: net profit} of 1998 Q2 at the stores whose 2-digit
    zip prefix is that of a zip of ``Q8_ZIPS`` with ``Q8_MIN_PREFERRED``
    preferred customers or more."""
    from .queries import Q8_MIN_PREFERRED, Q8_ZIPS

    ca, cu, st, ss = tables["customer_address"], tables["customer"], tables["store"], tables["store_sales"]
    zip5s = [z[:5] for z in _sv(ca, "ca_zip")]
    a1 = set(zip5s) & set(Q8_ZIPS)
    a_row = _rows_of(ca["ca_address_sk"][0], cu["c_current_addr_sk"][0][_s_eq(cu, "c_preferred_cust_flag", "Y")])
    counts: Dict[str, int] = defaultdict(int)
    for r in a_row[a_row >= 0].tolist():
        counts[zip5s[r]] += 1
    prefixes = {z[:2] for z in a1 if counts[z] >= Q8_MIN_PREFERRED}
    names = _sv(st, "s_store_name")
    stores = _dim(st, "s_store_sk", names, np.array([z[:2] in prefixes for z in _sv(st, "s_zip")], bool))
    m = np.isin(ss["ss_sold_date_sk"][0], _days_where(tables, d_year=1998, d_qoy=2))
    sc = np.where(m, _fact_code(stores, ss["ss_store_sk"][0]), -1)
    return {k: v[0] for k, v in _label_sums(sc, stores[2], [ss["ss_net_profit"][0]]).items()}


def oracle_q91(tables):
    """{(call center, marital status, education): loss}: catalog returns
    of 2000 by customers of the (M, Unknown) or (W, Advanced Degree)
    demographics."""
    cc, cu, cd, cr = (tables[k] for k in ("call_center", "customer", "customer_demographics", "catalog_returns"))
    bands = (("M", "Unknown"), ("W", "Advanced Degree"))
    band = np.full(cd["cd_demo_sk"][0].shape[0], -1, np.int64)
    for k, (ms, es) in enumerate(bands):
        band[_s_eq(cd, "cd_marital_status", ms) & _s_eq(cd, "cd_education_status", es)] = k
    centers = _dim(cc, "cc_call_center_sk", _sv(cc, "cc_name"))
    m = np.isin(cr["cr_returned_date_sk"][0], _days_where(tables, d_year=2000))
    ccc = _fact_code(centers, cr["cr_call_center_sk"][0])
    cu_row = _rows_of(cu["c_customer_sk"][0], cr["cr_returning_customer_sk"][0])
    bc = _fact_code((cd["cd_demo_sk"][0], band, None), cu["c_current_cdemo_sk"][0][np.maximum(cu_row, 0)])
    m &= _keep(ccc, cu_row, bc)
    (gc, gb), (s,) = _group_sums([ccc[m], bc[m]], [cr["cr_net_loss"][0][m]])
    return {(centers[2][c],) + bands[b]: v for c, b, v in zip(gc.tolist(), gb.tolist(), s.tolist())}


def _oracle_ticket_report(tables, *, dom_ranges, buy_potentials, cnt_lo, cnt_hi, dep_vehicle_ratio):
    """{(ticket, customer): (salutation, first, last, preferred flag,
    lines)} of q34's and q73's tickets."""
    dd, hd, st, cu, ss = (tables[k] for k in ("date_dim", "household_demographics", "store", "customer",
                                             "store_sales"))
    d_ok = np.zeros(dd["d_dom"][0].shape[0], bool)
    for lo, hi in dom_ranges:
        d_ok |= (dd["d_dom"][0] >= lo) & (dd["d_dom"][0] <= hi)
    d_ok &= np.isin(dd["d_year"][0], (1999, 2000, 2001))
    veh = hd["hd_vehicle_count"][0]
    h_ok = _s_isin(hd, "hd_buy_potential", buy_potentials) & (veh > 0)
    h_ok &= hd["hd_dep_count"][0] / np.maximum(veh, 1) > dep_vehicle_ratio
    s_ok = _s_isin(st, "s_county", ("Williamson County", "Franklin Parish", "Bronx County", "Orange County"))
    m = (np.isin(ss["ss_sold_date_sk"][0], dd["d_date_sk"][0][d_ok])
         & np.isin(ss["ss_hdemo_sk"][0], hd["hd_demo_sk"][0][h_ok])
         & np.isin(ss["ss_store_sk"][0], st["s_store_sk"][0][s_ok]))
    (tick, cust), (n,) = _group_sums([ss["ss_ticket_number"][0][m], ss["ss_customer_sk"][0][m]],
                                     [np.ones(int(m.sum()), np.int64)])
    keep = (n >= cnt_lo) & (n <= cnt_hi)
    tick, cust, n = tick[keep], cust[keep], n[keep]
    c_row = _rows_of(cu["c_customer_sk"][0], cust)
    found = c_row >= 0
    rows = c_row[found].tolist()
    info = zip(*(_strs(cu, c, rows) for c in ("c_salutation", "c_first_name", "c_last_name", "c_preferred_cust_flag")))
    return {(t, c): i + (k,) for t, c, i, k in zip(tick[found].tolist(), cust[found].tolist(), info,
                                                  n[found].tolist())}


def oracle_q34(tables):
    return _oracle_ticket_report(tables, dom_ranges=[(1, 3), (25, 28)], buy_potentials=(">10000", "Unknown"),
                                 cnt_lo=15, cnt_hi=20, dep_vehicle_ratio=1.2)


def oracle_q73(tables):
    return _oracle_ticket_report(tables, dom_ranges=[(1, 2)], buy_potentials=(">10000", "Unknown"), cnt_lo=1,
                                 cnt_hi=5, dep_vehicle_ratio=1.0)


def _oracle_city_tickets(tables, *, dow, cities, hd_ok_fn, amt_c, extra):
    """{(last, first, current city, bought city, ticket): (amount sum,
    each extra sum)} of q46's and q68's tickets."""
    dd, st, hd, ca, cu, ss = (tables[k] for k in ("date_dim", "store", "household_demographics",
                                                 "customer_address", "customer", "store_sales"))
    city = _dim(ca, "ca_address_sk", _sv(ca, "ca_city"))
    m = (np.isin(ss["ss_sold_date_sk"][0], dd["d_date_sk"][0][np.isin(dd["d_dow"][0], dow)])
         & np.isin(ss["ss_store_sk"][0], st["s_store_sk"][0][_s_isin(st, "s_city", cities)])
         & np.isin(ss["ss_hdemo_sk"][0], hd["hd_demo_sk"][0][hd_ok_fn(hd["hd_dep_count"][0],
                                                                        hd["hd_vehicle_count"][0])]))
    bought = _fact_code(city, ss["ss_addr_sk"][0])
    m &= bought >= 0
    (tick, cust, bc), sums = _group_sums([ss["ss_ticket_number"][0][m], ss["ss_customer_sk"][0][m], bought[m]],
                                         [ss[c][0][m] for c in [amt_c] + list(extra)])
    c_row = _rows_of(cu["c_customer_sk"][0], cust)
    cur = _fact_code(city, cu["c_current_addr_sk"][0][np.maximum(c_row, 0)])
    keep = np.flatnonzero(_keep(c_row, cur) & (cur != bc))
    rows = c_row[keep].tolist()
    out = {}
    for j, last, first in zip(keep.tolist(), _strs(cu, "c_last_name", rows), _strs(cu, "c_first_name", rows)):
        out[(last, first, city[2][cur[j]], city[2][bc[j]], int(tick[j]))] = tuple(int(s[j]) for s in sums)
    return out


def oracle_q46(tables):
    return _oracle_city_tickets(tables, dow=(6, 0), cities=("Midway", "Fairview"),
                                hd_ok_fn=lambda d, v: (d == 4) | (v == 3), amt_c="ss_coupon_amt",
                                extra=["ss_net_profit"])


def oracle_q68(tables):
    return _oracle_city_tickets(tables, dow=(6, 0), cities=("Midway", "Fairview"),
                                hd_ok_fn=lambda d, v: (d == 5) | (v == 3), amt_c="ss_ext_sales_price",
                                extra=["ss_ext_list_price"])


def oracle_q79(tables):
    """{(last, first, store city, ticket): (coupon sum, profit sum)} of
    Monday tickets of 1998-2000 from 6-dependant or 3+-vehicle
    households."""
    dd, hd, st, cu, ss = (tables[k] for k in ("date_dim", "household_demographics", "store", "customer",
                                             "store_sales"))
    days = dd["d_date_sk"][0][(dd["d_dow"][0] == 1) & (dd["d_year"][0] >= 1998) & (dd["d_year"][0] <= 2000)]
    h_ok = (hd["hd_dep_count"][0] == 6) | (hd["hd_vehicle_count"][0] > 2)
    cities = _dim(st, "s_store_sk", _sv(st, "s_city"))
    sc = _fact_code(cities, ss["ss_store_sk"][0])
    m = (np.isin(ss["ss_sold_date_sk"][0], days) & np.isin(ss["ss_hdemo_sk"][0], hd["hd_demo_sk"][0][h_ok])
         & (sc >= 0))
    (tick, cust, gc), (amt, prof) = _group_sums([ss["ss_ticket_number"][0][m], ss["ss_customer_sk"][0][m], sc[m]],
                                                [ss["ss_coupon_amt"][0][m], ss["ss_net_profit"][0][m]])
    c_row = _rows_of(cu["c_customer_sk"][0], cust)
    keep = np.flatnonzero(c_row >= 0)
    rows = c_row[keep].tolist()
    return {(last, first, cities[2][gc[j]], int(tick[j])): (int(amt[j]), int(prof[j]))
            for j, last, first in zip(keep.tolist(), _strs(cu, "c_last_name", rows), _strs(cu, "c_first_name", rows))}


def oracle_q9(tables):
    """The five buckets: per quantity band, the average discount if its
    count passes the threshold, else the average net profit (unscaled
    at scale 6, exact HALF_UP); None for an empty band."""
    from .queries import Q9_THRESHOLDS

    ss = tables["store_sales"]
    q = ss["ss_quantity"][0]
    out = []
    for b, thresh in enumerate(Q9_THRESHOLDS):
        m = (q >= 20 * b + 1) & (q <= 20 * (b + 1))
        n = int(m.sum())
        vals = ss["ss_ext_discount_amt" if n > thresh else "ss_net_profit"][0][m]
        out.append(_avg_u(int(vals.astype(np.int64).sum()), n) if n else None)
    return out


def oracle_q88(tables) -> List[int]:
    """The eight half-hour counts from 8:30 of store sales to the three
    household bands at the stores named "ese"."""
    ss, hd, td, st = (tables[k] for k in ("store_sales", "household_demographics", "time_dim", "store"))
    dep, veh = hd["hd_dep_count"][0], hd["hd_vehicle_count"][0]
    h_ok = ((dep == 4) & (veh <= 6)) | ((dep == 2) & (veh <= 4)) | ((dep == 0) & (veh <= 2))
    m = (np.isin(ss["ss_hdemo_sk"][0], hd["hd_demo_sk"][0][h_ok])
         & np.isin(ss["ss_store_sk"][0], st["s_store_sk"][0][_s_eq(st, "s_store_name", "ese")]))
    t_row = _rows_of(td["t_time_sk"][0], ss["ss_sold_time_sk"][0])
    m &= t_row >= 0
    t_row = np.maximum(t_row, 0)
    hour, minute = td["t_hour"][0][t_row], td["t_minute"][0][t_row]
    out = []
    for k in range(8):
        h, half = divmod(k + 17, 2)
        out.append(int((m & (hour == h) & ((minute >= 30) if half else (minute < 30))).sum()))
    return out


def oracle_q28(tables):
    """{band: (avg list price unscaled at scale 6 or None, count,
    distinct list prices)} of q28's six bands."""
    ss = tables["store_sales"]
    q, lp, cp, wc = (ss[c][0] for c in ("ss_quantity", "ss_list_price", "ss_coupon_amt", "ss_wholesale_cost"))
    bands = [("B1", 0, 5, 0, 10, 0, 50), ("B2", 6, 10, 10, 20, 50, 100), ("B3", 11, 15, 20, 30, 100, 150),
             ("B4", 16, 20, 30, 40, 150, 200), ("B5", 21, 25, 40, 50, 200, 250), ("B6", 26, 30, 50, 60, 250, 300)]
    out = {}
    for name, q_lo, q_hi, c_lo, c_hi, w_lo, _ in bands:
        m = (q >= q_lo) & (q <= q_hi) & (((lp >= c_lo * 100) & (lp <= (c_lo + 10) * 100))
                                         | ((cp >= w_lo * 100) & (cp <= (w_lo + 1000) * 100))
                                         | ((wc >= c_hi * 100) & (wc <= (c_hi + 20) * 100)))
        vals = lp[m]
        n = int(m.sum())
        out[name] = (_avg_u(int(vals.astype(np.int64).sum()), n) if n else None, n, int(np.unique(vals).shape[0]))
    return out


def oracle_q90(tables):
    """(morning count, evening count, their ratio) of web sales at 8-9
    and 19-20 o'clock on pages of 2000-6000 characters."""
    wp, td, ws = tables["web_page"], tables["time_dim"], tables["web_sales"]
    pages = np.isin(ws["ws_web_page_sk"][0], wp["wp_web_page_sk"][0][(wp["wp_char_count"][0] >= 2000)
                                                 & (wp["wp_char_count"][0] <= 6000)])

    def count(lo, hi):
        hours = td["t_time_sk"][0][(td["t_hour"][0] >= lo) & (td["t_hour"][0] <= hi)]
        return int((pages & np.isin(ws["ws_sold_time_sk"][0], hours)).sum())

    am, pm = count(8, 9), count(19, 20)
    return am, pm, am / (pm if pm > 0 else 1.0)


def oracle_q61(tables):
    """(promotional revenue, total revenue), unscaled: store sales of
    November 1998 of jewelry to -5 GMT customers, with an email or event
    promotion and in all; a sum of no sale is None, as SQL's."""
    st, it, ca, cu, pr, ss = (tables[k] for k in ("store", "item", "customer_address", "customer", "promotion",
                                                 "store_sales"))
    gmt5 = ca["ca_address_sk"][0][ca["ca_gmt_offset"][0] == -500]
    custs = cu["c_customer_sk"][0][np.isin(cu["c_current_addr_sk"][0], gmt5)]
    m = (np.isin(ss["ss_sold_date_sk"][0], _days_where(tables, d_year=1998, d_moy=11))
         & np.isin(ss["ss_store_sk"][0], st["s_store_sk"][0])
         & np.isin(ss["ss_item_sk"][0], it["i_item_sk"][0][_s_eq(it, "i_category", "Jewelry")])
         & np.isin(ss["ss_customer_sk"][0], custs))
    promo = m & np.isin(ss["ss_promo_sk"][0], pr["p_promo_sk"][0][_s_eq(pr, "p_channel_email", "Y")
                                                  | _s_eq(pr, "p_channel_event", "Y")])
    price = ss["ss_ext_sales_price"][0].astype(np.int64)
    return tuple(int(price[k].sum()) if k.any() else None for k in (promo, m))


def _oracle_ship_lag(tables, fact, sold_c, ship_c, wh_c, sm_c, dim_tab, dim_sk_c, dim_name_c, dim_fk, year):
    """{(warehouse, ship mode type, site or call center): (orders shipped
    in 30 days, 31-60, 61-90, 91-120, later)} of a year's orders."""
    dd, f = tables["date_dim"], tables[fact]
    sold, ship = _rows_of(dd["d_date_sk"][0], f[sold_c][0]), _rows_of(dd["d_date_sk"][0], f[ship_c][0])
    wh = _dim(tables["warehouse"], "w_warehouse_sk", _sv(tables["warehouse"], "w_warehouse_name"))
    sm = _dim(tables["ship_mode"], "sm_ship_mode_sk", _sv(tables["ship_mode"], "sm_type"))
    dim = _dim(tables[dim_tab], dim_sk_c, _sv(tables[dim_tab], dim_name_c))
    wc, mc, dc = _fact_code(wh, f[wh_c][0]), _fact_code(sm, f[sm_c][0]), _fact_code(dim, f[dim_fk][0])
    m = _keep(sold, ship, wc, mc, dc)
    sold, ship = np.maximum(sold, 0), np.maximum(ship, 0)
    m &= dd["d_year"][0][sold] == year
    lag = dd["d_date"][0][ship].astype(np.int64) - dd["d_date"][0][sold].astype(np.int64)
    bucket = np.select([lag <= 30, lag <= 60, lag <= 90, lag <= 120], [0, 1, 2, 3], 4)
    (gw, gm, gd), counts = _group_sums([wc[m], mc[m], dc[m]], [(bucket[m] == k) for k in range(5)])
    return {(wh[2][a], sm[2][b], dim[2][c]): tuple(int(s[j]) for s in counts)
            for j, (a, b, c) in enumerate(zip(gw.tolist(), gm.tolist(), gd.tolist()))}


def oracle_q62(tables):
    return _oracle_ship_lag(tables, "web_sales", "ws_sold_date_sk", "ws_ship_date_sk", "ws_warehouse_sk",
                            "ws_ship_mode_sk", "web_site", "web_site_sk", "web_name", "ws_web_site_sk", 2001)


def oracle_q99(tables):
    return _oracle_ship_lag(tables, "catalog_sales", "cs_sold_date_sk", "cs_ship_date_sk", "cs_warehouse_sk",
                            "cs_ship_mode_sk", "call_center", "cc_call_center_sk", "cc_name", "cs_call_center_sk",
                            2001)


def oracle_q21(tables):
    """{(warehouse, item id): (on hand before, after)} of items priced
    20-50, summed over the 30 days before and after 2000-03-11, kept
    where after / before lies in [2/3, 3/2]."""
    dd, it, wh, inv = tables["date_dim"], tables["item"], tables["warehouse"], tables["inventory"]
    pivot = _epoch_day(2000, 3, 11)
    m = np.isin(inv["inv_date_sk"][0], _window(tables, (2000, 2, 10), (2000, 4, 10)))
    d_sk, i_sk, w_sk, qoh = (inv[c][0][m] for c in ("inv_date_sk", "inv_item_sk", "inv_warehouse_sk",
                                                    "inv_quantity_on_hand"))
    price = it["i_current_price"][0]
    items = _dim(it, "i_item_sk", _sv(it, "i_item_id"), (price >= 2000) & (price <= 5000))
    whs = _dim(wh, "w_warehouse_sk", _sv(wh, "w_warehouse_name"))
    ic, wc = _fact_code(items, i_sk), _fact_code(whs, w_sk)
    k = _keep(ic, wc)
    before = dd["d_date"][0][_rows_of(dd["d_date_sk"][0], d_sk)] < pivot
    q = qoh.astype(np.int64)
    (gw, gi), (b, a) = _group_sums([wc[k], ic[k]], [np.where(before, q, 0)[k], np.where(before, 0, q)[k]])
    return {(whs[2][w], items[2][i]): (x, y) for w, i, x, y in zip(gw.tolist(), gi.tolist(), b.tolist(), a.tolist())
            if x > 0 and 2.0 / 3.0 <= y / x <= 1.5}


def _excess_discount_oracle(tables, *, sales, date_col, item_col, amt_col):
    """q32's and q92's total of the discounts of 2000-01-27..04-26 over
    1.3 times their item's average then (unscaled at scale 6, exact
    HALF_UP, compared as doubles), of manufacturer ids up to
    ``Q32_MFG_MAX``; None if none passes."""
    from .queries import Q32_MFG_MAX

    it, sl = tables["item"], tables[sales]
    m = np.isin(sl[date_col][0], _window(tables, (2000, 1, 27), (2000, 4, 26)))
    ik, amt = sl[item_col][0][m], sl[amt_col][0][m].astype(np.int64)
    (g,), (tot, n) = _group_sums([ik], [amt, np.ones(ik.shape[0], np.int64)])
    avg = np.array([_avg_u(s, k) for s, k in zip(tot.tolist(), n.tolist())], np.int64)
    row_avg = avg[np.searchsorted(g, ik)] if g.shape[0] else avg
    keep = np.isin(ik, it["i_item_sk"][0][it["i_manufact_id"][0] <= Q32_MFG_MAX])
    keep &= amt / 100.0 > (row_avg / 10**6) * 1.3
    return int(amt[keep].sum()) if keep.any() else None


def oracle_q32(tables):
    return _excess_discount_oracle(tables, sales="catalog_sales", date_col="cs_sold_date_sk", item_col="cs_item_sk",
                                   amt_col="cs_ext_discount_amt")


def oracle_q92(tables):
    return _excess_discount_oracle(tables, sales="web_sales", date_col="ws_sold_date_sk", item_col="ws_item_sk",
                                   amt_col="ws_ext_discount_amt")


def oracle_q65(tables):
    """{(store sk, item sk): (store name, item desc, revenue, price,
    brand)} of the items whose 2000 revenue at a store is at most a
    tenth of the store's average item revenue (unscaled at scale 6,
    exact HALF_UP, compared as doubles)."""
    st, it, ss = tables["store"], tables["item"], tables["store_sales"]
    m = np.isin(ss["ss_sold_date_sk"][0], _days_where(tables, d_year=2000))
    (gs, gi), (rev,) = _group_sums([ss["ss_store_sk"][0][m], ss["ss_item_sk"][0][m]], [ss["ss_sales_price"][0][m]])
    (stores,), (tot, n) = _group_sums([gs], [rev, np.ones(gs.shape[0], np.int64)])
    ave = np.array([_avg_u(s, k) for s, k in zip(tot.tolist(), n.tolist())], np.int64)
    low = rev / 100.0 <= (ave[np.searchsorted(stores, gs)] / 10**6) * 0.1
    s_row, i_row = _rows_of(st["s_store_sk"][0], gs), _rows_of(it["i_item_sk"][0], gi)
    keep = np.flatnonzero(low & _keep(s_row, i_row))
    srows, irows = s_row[keep].tolist(), i_row[keep].tolist()
    price = it["i_current_price"][0]
    return {(int(gs[j]), int(gi[j])): (name, desc, int(rev[j]), int(price[r]), brand)
            for j, r, name, desc, brand in zip(keep.tolist(), irows, _strs(st, "s_store_name", srows),
                                               _strs(it, "i_item_desc", irows), _strs(it, "i_brand", irows))}


# -------------------------------- multi-fact, shuffled and self joins


def _returns_above_avg(tables, rtab, r_date, r_cust, r_loc, r_amt, loc_ok, names):
    """q1, q30 and q81: the customers' 2000 returns per location above
    1.2 times the location's average (exact HALF_UP at scale 6,
    compared as doubles): their ids sorted (q1), or (id, first, last,
    total) rows, one a (customer, location)."""
    rt, cu = tables[rtab], tables["customer"]
    m = np.isin(rt[r_date][0], _days_where(tables, d_year=2000))
    if loc_ok is not None:
        m &= np.isin(rt[r_loc][0], loc_ok)
    (gc, gl), (tot,) = _group_sums([rt[r_cust][0][m], rt[r_loc][0][m]], [rt[r_amt][0][m]])
    (locs,), (lsum, ln) = _group_sums([gl], [tot, np.ones(gl.shape[0], np.int64)])
    avg = np.array([_avg_u(s, n) for s, n in zip(lsum.tolist(), ln.tolist())], np.int64)
    rows = _rows_of(cu["c_customer_sk"][0], gc)
    keep = np.flatnonzero((tot / 100.0 > 1.2 * (avg[np.searchsorted(locs, gl)] / 1_000_000.0)) & (rows >= 0))
    r = rows[keep].tolist()
    ids = _strs(cu, "c_customer_id", r)
    if not names:
        return sorted(ids)
    return sorted(zip(ids, _strs(cu, "c_first_name", r), _strs(cu, "c_last_name", r), tot[keep].tolist()))


def oracle_q1(tables):
    st = tables["store"]
    return _returns_above_avg(tables, "store_returns", "sr_returned_date_sk", "sr_customer_sk", "sr_store_sk",
                              "sr_return_amt", st["s_store_sk"][0][_s_eq(st, "s_state", "TN")], False)


def oracle_q30(tables):
    return _returns_above_avg(tables, "web_returns", "wr_returned_date_sk", "wr_returning_customer_sk",
                              "wr_web_page_sk", "wr_return_amt", None, True)


def oracle_q81(tables):
    return _returns_above_avg(tables, "catalog_returns", "cr_returned_date_sk", "cr_returning_customer_sk",
                              "cr_call_center_sk", "cr_return_amount", None, True)


def _ship_report(tables, *, fact, order_c, wh_c, ship_date_c, addr_c, dim_c, dim_ok, ship_c, profit_c, ret_tab,
                 r_order_c, lo, hi, state, returned):
    """q16, q94 and q95: (distinct orders, ship cost, net profit) of the
    window's lines to ``state`` of multi-warehouse orders (over the
    whole fact table) with (``returned``) or without a return; sums of
    no line None."""
    f, ca = tables[fact], tables["customer_address"]
    orders = f[order_c][0].astype(np.int64)
    pairs = np.unique(_key2(orders, f[wh_c][0]))
    by_order, n_wh = np.unique(pairs >> 32, return_counts=True)
    m = (np.isin(f[ship_date_c][0], _window(tables, lo, hi))
         & np.isin(f[addr_c][0], ca["ca_address_sk"][0][_s_eq(ca, "ca_state", state)])
         & np.isin(f[dim_c][0], dim_ok) & np.isin(orders, by_order[n_wh >= 2])
         & (np.isin(orders, tables[ret_tab][r_order_c][0]) == returned))
    n = int(np.unique(orders[m]).shape[0])
    sums = [int(f[c][0][m].astype(np.int64).sum()) if n else None for c in (ship_c, profit_c)]
    return (n, *sums)


def _web_ship_report(tables, returned):
    ws = tables["web_site"]
    return _ship_report(tables, fact="web_sales", order_c="ws_order_number", wh_c="ws_warehouse_sk",
                        ship_date_c="ws_ship_date_sk", addr_c="ws_ship_addr_sk", dim_c="ws_web_site_sk",
                        dim_ok=ws["web_site_sk"][0][_s_eq(ws, "web_company_name", "pri")], ship_c="ws_ext_ship_cost",
                        profit_c="ws_net_profit", ret_tab="web_returns", r_order_c="wr_order_number",
                        lo=(1999, 2, 1), hi=(1999, 12, 31), state="TN", returned=returned)


def oracle_q94(tables):
    return _web_ship_report(tables, False)


def oracle_q95(tables):
    return _web_ship_report(tables, True)


def oracle_q16(tables):
    cc = tables["call_center"]
    return _ship_report(tables, fact="catalog_sales", order_c="cs_order_number", wh_c="cs_warehouse_sk",
                        ship_date_c="cs_ship_date_sk", addr_c="cs_ship_addr_sk", dim_c="cs_call_center_sk",
                        dim_ok=cc["cc_call_center_sk"][0][_s_eq(cc, "cc_county", "Williamson County")],
                        ship_c="cs_ext_ship_cost", profit_c="cs_net_profit", ret_tab="catalog_returns",
                        r_order_c="cr_order_number", lo=(2002, 2, 1), hi=(2002, 12, 31), state="GA", returned=False)


def _year_totals(tables, fact, date_c, cust_c, measure, year) -> Tuple[np.ndarray, np.ndarray]:
    """(customer keys ascending, their total of ``measure``) of one
    channel's lines of ``year``."""
    f = tables[fact]
    m = np.isin(f[date_c][0], _days_where(tables, d_year=year))
    (g,), (s,) = _group_sums([f[cust_c][0][m]], [measure[m]])
    return g, s


def _customers_in_all(tables, totals) -> np.ndarray:
    """The customer keys in every ``totals`` and the customer table."""
    keys = tables["customer"]["c_customer_sk"][0]
    for g, _ in totals:
        keys = np.intersect1d(keys, g)
    return keys


def _at(totals, keys: np.ndarray) -> np.ndarray:
    g, s = totals
    return s[np.searchsorted(g, keys)]


def _yoy_customer(tables, *, store_m, web_m, y1, y2, out_cols):
    """q74 and q11: the ``out_cols`` rows of the customers whose web
    total grew faster than their store total from ``y1`` to ``y2`` (the
    decimals compared as doubles)."""
    ss, ws = tables["store_sales"], tables["web_sales"]
    tot = [_year_totals(tables, "store_sales", "ss_sold_date_sk", "ss_customer_sk", store_m(ss), y)
           for y in (y1, y2)]
    tot += [_year_totals(tables, "web_sales", "ws_sold_date_sk", "ws_bill_customer_sk", web_m(ws), y)
            for y in (y1, y2)]
    keys = _customers_in_all(tables, tot)
    s1, s2, w1, w2 = (_at(t, keys) for t in tot)
    ok = (s1 > 0) & (w1 > 0) & ((w2 / 100.0) / (w1 / 100.0) > (s2 / 100.0) / (s1 / 100.0))
    cu = tables["customer"]
    rows = _rows_of(cu["c_customer_sk"][0], keys[ok]).tolist()
    return sorted(zip(*(_strs(cu, c, rows) for c in out_cols)))


def oracle_q74(tables):
    return _yoy_customer(tables, store_m=lambda f: f["ss_net_paid"][0].astype(np.int64),
                         web_m=lambda f: f["ws_net_paid"][0].astype(np.int64), y1=1999, y2=2000,
                         out_cols=["c_customer_id", "c_first_name", "c_last_name"])


def oracle_q11(tables):
    return _yoy_customer(
        tables, store_m=lambda f: f["ss_ext_list_price"][0].astype(np.int64) - f["ss_ext_discount_amt"][0],
        web_m=lambda f: f["ws_ext_list_price"][0].astype(np.int64) - f["ws_ext_discount_amt"][0], y1=2000, y2=2001,
        out_cols=["c_customer_id", "c_preferred_cust_flag", "c_first_name", "c_last_name"])


def oracle_q4(tables):
    """The (id, first, last) of the customers whose catalog and web
    growth of (list - wholesale - discount + sales) / 2 (exact at scale
    10, compared as doubles) both beat their store growth, 2000 to
    2001."""
    tot = []
    for fact, d_c, c_c, cols in (
            ("store_sales", "ss_sold_date_sk", "ss_customer_sk",
             ("ss_ext_list_price", "ss_ext_wholesale_cost", "ss_ext_discount_amt", "ss_ext_sales_price")),
            ("catalog_sales", "cs_sold_date_sk", "cs_bill_customer_sk",
             ("cs_ext_list_price", "cs_wholesale_cost", "cs_ext_discount_amt", "cs_ext_sales_price")),
            ("web_sales", "ws_sold_date_sk", "ws_bill_customer_sk",
             ("ws_ext_list_price", "ws_wholesale_cost", "ws_ext_discount_amt", "ws_ext_sales_price"))):
        f = tables[fact]
        lp, wc, dc, sp = (f[c][0].astype(np.int64) for c in cols)
        for year in (2000, 2001):
            g, s = _year_totals(tables, fact, d_c, c_c, lp - wc - dc + sp, year)
            # x / 2 at scale 10 is x * 5 * 10^7 unscaled; sums of it alike
            tot.append((g, s * 50_000_000))
    keys = _customers_in_all(tables, tot)
    s1, s2, c1, c2, w1, w2 = (_at(t, keys) / 1e10 for t in tot)
    ok = (s1 > 0) & (c1 > 0) & (w1 > 0) & (c2 / c1 > s2 / s1) & (w2 / w1 > s2 / s1)
    cu = tables["customer"]
    rows = _rows_of(cu["c_customer_sk"][0], keys[ok]).tolist()
    return sorted(zip(*(_strs(cu, c, rows) for c in ("c_customer_id", "c_first_name", "c_last_name"))))


def _inv_price_items(tables, fact, item_c):
    """q37 and q82: the (id, desc, price) of the items priced 30-60 with
    100-500 on hand in 2000-02-01..04-01, sold in the channel."""
    it, inv = tables["item"], tables["inventory"]
    qoh = inv["inv_quantity_on_hand"][0]
    m = np.isin(inv["inv_date_sk"][0], _window(tables, (2000, 2, 1), (2000, 4, 1))) & (qoh >= 100) & (qoh <= 500)
    sk, price = it["i_item_sk"][0], it["i_current_price"][0]
    ok = ((price >= 3000) & (price <= 6000) & np.isin(sk, inv["inv_item_sk"][0][m])
          & np.isin(sk, tables[fact][item_c][0]))
    rows = np.flatnonzero(ok).tolist()
    return set(zip(_strs(it, "i_item_id", rows), _strs(it, "i_item_desc", rows), price[rows].tolist()))


def oracle_q37(tables):
    return _inv_price_items(tables, "catalog_sales", "cs_item_sk")


def oracle_q82(tables):
    return _inv_price_items(tables, "store_sales", "ss_item_sk")


def oracle_q40(tables):
    """{(warehouse state, item id): (sales before, after 2000-03-11)} of
    items priced 20-50 in the 30 days either side, each line net of its
    refunds (once per matching return, else once whole); a side with no
    line None."""
    dd, it, wh = tables["date_dim"], tables["item"], tables["warehouse"]
    cs, cr = tables["catalog_sales"], tables["catalog_returns"]
    rows = np.flatnonzero(np.isin(cs["cs_sold_date_sk"][0], _window(tables, (2000, 2, 10), (2000, 4, 10))))
    price = it["i_current_price"][0]
    items = _dim(it, "i_item_sk", _sv(it, "i_item_id"), (price >= 2000) & (price <= 5000))
    states = _dim(wh, "w_warehouse_sk", _sv(wh, "w_state"))
    ic, wc = _fact_code(items, cs["cs_item_sk"][0][rows]), _fact_code(states, cs["cs_warehouse_sk"][0][rows])
    k = _keep(ic, wc)
    rows, ic, wc = rows[k], ic[k], wc[k]
    before = dd["d_date"][0][_rows_of(dd["d_date_sk"][0], cs["cs_sold_date_sk"][0][rows])] < _epoch_day(2000, 3, 11)
    sales = cs["cs_sales_price"][0][rows].astype(np.int64)
    line, ret = _matches([cr["cr_item_sk"][0], cr["cr_order_number"][0]],
                         [cs["cs_item_sk"][0][rows], cs["cs_order_number"][0][rows]])
    alone = np.flatnonzero(np.bincount(line, minlength=rows.shape[0]) == 0)
    at = np.concatenate([line, alone])
    net = np.concatenate([sales[line] - cr["cr_refunded_cash"][0][ret].astype(np.int64), sales[alone]])
    b = before[at]
    (gw, gi), (sb, sa, nb, na) = _group_sums([wc[at], ic[at]], [np.where(b, net, 0), np.where(b, 0, net),
                                                                  b.astype(np.int64), (~b).astype(np.int64)])
    return {(states[2][w], items[2][i]): (x if p else None, y if q else None)
            for w, i, x, y, p, q in zip(gw.tolist(), gi.tolist(), sb.tolist(), sa.tolist(), nb.tolist(), na.tolist())}


def oracle_q50(tables):
    """{(store name, county, state, zip): lines returned in August 2001
    within 30, 60, 90, 120 days of the sale and later}: each return
    joined to its sale on (item, ticket, customer)."""
    dd, st, ss, sr = tables["date_dim"], tables["store"], tables["store_sales"], tables["store_returns"]
    r_rows = np.flatnonzero(np.isin(sr["sr_returned_date_sk"][0], _days_where(tables, d_year=2001, d_moy=8)))
    s_rows = np.flatnonzero(np.isin(ss["ss_ticket_number"][0], sr["sr_ticket_number"][0][r_rows]))
    s, r = _matches([sr[c][0][r_rows] for c in ("sr_item_sk", "sr_ticket_number", "sr_customer_sk")],
                    [ss[c][0][s_rows] for c in ("ss_item_sk", "ss_ticket_number", "ss_customer_sk")])
    s, r = s_rows[s], r_rows[r]
    stores = _dim(st, "s_store_sk", list(zip(*(_sv(st, c) for c in ("s_store_name", "s_county", "s_state", "s_zip")))))
    sc = _fact_code(stores, ss["ss_store_sk"][0][s])
    sold = _rows_of(dd["d_date_sk"][0], ss["ss_sold_date_sk"][0][s])
    k = (sc >= 0) & (sold >= 0)
    lag = (dd["d_date"][0][_rows_of(dd["d_date_sk"][0], sr["sr_returned_date_sk"][0][r[k]])].astype(np.int64)
           - dd["d_date"][0][sold[k]])
    bounds = (-(1 << 62), 30, 60, 90, 120, 1 << 62)
    buckets = [(lag > lo) & (lag <= hi) for lo, hi in zip(bounds, bounds[1:])]
    return {k_: tuple(v) for k_, v in _label_sums(sc[k], stores[2], [b.astype(np.int64) for b in buckets]).items()}


def oracle_q93(tables):
    """{customer sk: sales net of returns} of the store lines returned
    for 'Stopped working' ((quantity - returned) x price per matching
    return)."""
    ss, sr, rs = tables["store_sales"], tables["store_returns"], tables["reason"]
    ok = rs["r_reason_sk"][0][_s_eq(rs, "r_reason_desc", "Stopped working")]
    r_rows = np.flatnonzero(np.isin(sr["sr_reason_sk"][0], ok))
    s_rows = np.flatnonzero(np.isin(ss["ss_ticket_number"][0], sr["sr_ticket_number"][0][r_rows]))
    s, r = _matches([sr["sr_item_sk"][0][r_rows], sr["sr_ticket_number"][0][r_rows]],
                    [ss["ss_item_sk"][0][s_rows], ss["ss_ticket_number"][0][s_rows]])
    s = s_rows[s]
    act = ((ss["ss_quantity"][0][s].astype(np.int64) - sr["sr_return_quantity"][0][r_rows[r]])
           * ss["ss_sales_price"][0][s].astype(np.int64))
    (g,), (v,) = _group_sums([ss["ss_customer_sk"][0][s]], [act])
    return dict(zip(g.tolist(), v.tolist()))


def _q24_cells(tables):
    """{(last, first, store name, color): net paid} of q24's ssales:
    the store lines once per matching return on (item, ticket), of
    market-8 stores, to customers living in the store's county."""
    ss, sr, st = tables["store_sales"], tables["store_returns"], tables["store"]
    cu, ca, it = tables["customer"], tables["customer_address"], tables["item"]
    s_rows = np.flatnonzero(np.isin(ss["ss_ticket_number"][0], sr["sr_ticket_number"][0]))
    s, _ = _matches([sr["sr_item_sk"][0], sr["sr_ticket_number"][0]],
                    [ss["ss_item_sk"][0][s_rows], ss["ss_ticket_number"][0][s_rows]])
    s = s_rows[s]
    counties, cty_labels = _codes(_sv(st, "s_county") + _sv(ca, "ca_county"))
    n_st = st["s_store_sk"][0].shape[0]
    st_row = _rows_of(st["s_store_sk"][0], ss["ss_store_sk"][0][s])
    cu_row = _rows_of(cu["c_customer_sk"][0], ss["ss_customer_sk"][0][s])
    ca_row = _rows_of(ca["ca_address_sk"][0], cu["c_current_addr_sk"][0][np.maximum(cu_row, 0)])
    it_row = _rows_of(it["i_item_sk"][0], ss["ss_item_sk"][0][s])
    k = (st_row >= 0) & (cu_row >= 0) & (ca_row >= 0) & (it_row >= 0)
    k[k] &= st["s_market_id"][0][st_row[k]] == 8
    k[k] &= counties[st_row[k]] == counties[n_st + ca_row[k]]
    names, name_labels = _codes(list(zip(_sv(cu, "c_last_name"), _sv(cu, "c_first_name"))))
    store_names, color = _sv(st, "s_store_name"), _sv(it, "i_color")
    (gn, gs, gi), (v,) = _group_sums([names[cu_row[k]], st_row[k], it_row[k]], [ss["ss_net_paid"][0][s[k]]])
    cells: Dict[tuple, int] = defaultdict(int)
    for n, r, i, x in zip(gn.tolist(), gs.tolist(), gi.tolist(), v.tolist()):
        cells[name_labels[n] + (store_names[r], color[i])] += x
    return dict(cells)


def _q24(tables, color):
    """{(last, first, store name): net paid} of ``color`` above 5% of
    the average over every cell (exact HALF_UP at scale 6, compared as
    doubles)."""
    cells = _q24_cells(tables)
    if not cells:
        return {}
    thr = 0.05 * (_avg_u(sum(cells.values()), len(cells)) / 1_000_000.0)
    return {k[:3]: v for k, v in cells.items() if k[3] == color and v / 100.0 > thr}


def oracle_q24a(tables):
    return _q24(tables, "peach")


def oracle_q24b(tables):
    return _q24(tables, "saddle")


def oracle_q14b(tables):
    """{(brand, class, category ids): (sales, number, last year's sales,
    number)} of November 2002's store cells of the cross-channel items
    above the average that beat November 2001's."""
    base = _q14_base(tables)
    ty, ly = (_q14_cells(tables, base, _SALES_QP[0], year) for year in (2002, 2001))
    return {k: (s, n, ly[k][0], ly[k][1]) for k, (s, n) in ty.items() if k in ly and s / 100.0 > ly[k][0] / 100.0}


def _item_sums(tables, items, fact, date_c, item_c, value_c, dates) -> Dict[str, int]:
    """{item id: the sum of ``value_c``} of one fact table's rows dated
    in ``dates``."""
    f = tables[fact]
    m = np.isin(f[date_c][0], dates)
    return {k: v[0] for k, v in _label_sums(_fact_code(items, f[item_c][0][m]), items[2],
                                            [f[value_c][0][m]]).items()}


def oracle_q58(tables):
    """{item id: (store revenue, share, catalog revenue, share, web
    revenue, share, average)} in the month of 2000-01-03 of the items
    whose three revenues lie within 25%-400% of each other."""
    dd, it = tables["date_dim"], tables["item"]
    month = dd["d_month_seq"][0][dd["d_date"][0] == _epoch_day(2000, 1, 3)][0]
    dates = dd["d_date_sk"][0][dd["d_month_seq"][0] == month]
    items = _dim(it, "i_item_sk", _sv(it, "i_item_id"))
    ssr, csr, wsr = (_item_sums(tables, items, fact, f"{p}_sold_date_sk", f"{p}_item_sk", f"{p}_ext_sales_price",
                                dates)
                     for fact, p in (("store_sales", "ss"), ("catalog_sales", "cs"), ("web_sales", "ws")))
    out = {}
    for k in ssr.keys() & csr.keys() & wsr.keys():
        s, c, w = ssr[k] / 100.0, csr[k] / 100.0, wsr[k] / 100.0
        if all(0.25 * b <= a <= 4.0 * b for a, b in ((s, c), (s, w), (c, s), (c, w), (w, s), (w, c))):
            total = s + c + w
            out[k] = (ssr[k], s / total / 3.0 * 100.0, csr[k], c / total / 3.0 * 100.0, wsr[k],
                      w / total / 3.0 * 100.0, total / 3.0)
    return out


def oracle_q31(tables):
    """{county: (web q1->q2, store q1->q2, web q2->q3, store q2->q3
    growth)} of the counties whose web growth beats the store's in
    either step of 2000 (a step with a zero denominator does not count;
    the reported ratios unguarded, inf or nan as the doubles give
    them)."""
    ca = tables["customer_address"]
    counties = _dim(ca, "ca_address_sk", _sv(ca, "ca_county"))

    def branch(fact, date_c, addr_c, price_c, qoy):
        f = tables[fact]
        m = np.isin(f[date_c][0], _days_where(tables, d_year=2000, d_qoy=qoy))
        return {k: v[0] for k, v in _label_sums(_fact_code(counties, f[addr_c][0][m]), counties[2],
                                                [f[price_c][0][m]]).items()}

    ss = {q: branch("store_sales", "ss_sold_date_sk", "ss_addr_sk", "ss_ext_sales_price", q) for q in (1, 2, 3)}
    ws = {q: branch("web_sales", "ws_sold_date_sk", "ws_bill_addr_sk", "ws_ext_sales_price", q) for q in (1, 2, 3)}
    out = {}
    for c in ss[1]:
        if any(c not in b[q] for b in (ss, ws) for q in (1, 2, 3)):
            continue
        with np.errstate(divide="ignore", invalid="ignore"):
            w12, s12, w23, s23 = (float(np.float64(b[qb][c] / 100.0) / np.float64(b[qa][c] / 100.0))
                                  for b, qa, qb in ((ws, 1, 2), (ss, 1, 2), (ws, 2, 3), (ss, 2, 3)))
        if (ws[1][c] > 0 and ss[1][c] > 0 and w12 > s12) or (ws[2][c] > 0 and ss[2][c] > 0 and w23 > s23):
            out[c] = (w12, s12, w23, s23)
    return out


def oracle_q59(tables):
    """{(store name, week of 2001): 7 day-of-week ratios}: store sales
    per (store, week, day), each 2001 week over the week 52 later in
    2002."""
    dd, st, ss = tables["date_dim"], tables["store"], tables["store_sales"]
    y1 = set(dd["d_week_seq"][0][dd["d_year"][0] == 2001].tolist())
    y2 = set(dd["d_week_seq"][0][dd["d_year"][0] == 2002].tolist())
    dates = (dd["d_date_sk"][0], (dd["d_week_seq"][0].astype(np.int64) * 7 + dd["d_dow"][0]), None)
    wd = _fact_code(dates, ss["ss_sold_date_sk"][0])
    sc = _rows_of(st["s_store_sk"][0], ss["ss_store_sk"][0])
    names = _sv(st, "s_store_name")
    m = (wd >= 0) & (sc >= 0)
    (gs, gw), (tot, n) = _group_sums([sc[m], wd[m]], [ss["ss_sales_price"][0][m], np.ones(int(m.sum()), np.int64)])
    sums: Dict[tuple, list] = {}
    counts: Dict[tuple, list] = {}
    for s, k, v, c in zip(gs.tolist(), gw.tolist(), tot.tolist(), n.tolist()):
        sums.setdefault((s, k // 7), [0] * 7)[k % 7] += v
        counts.setdefault((s, k // 7), [0] * 7)[k % 7] += c
    return {(names[s], w): _dow_ratios(sums[(s, w)], sums[(s, w + 52)], counts[(s, w)], counts[(s, w + 52)])
            for s, w in sums if w in y1 and w + 52 in y2 and (s, w + 52) in sums}


def oracle_q83(tables):
    """{item id: (store, catalog, web returned quantity, each one's
    share in percent, their average)} of 2000, items returned in all
    three channels."""
    it = tables["item"]
    items = _dim(it, "i_item_sk", _sv(it, "i_item_id"))
    dates = _days_where(tables, d_year=2000)
    sr, cr, wr = (_item_sums(tables, items, f"{name}_returns", f"{p}_returned_date_sk", f"{p}_item_sk",
                             f"{p}_return_quantity", dates)
                  for name, p in (("store", "sr"), ("catalog", "cr"), ("web", "wr")))
    out = {}
    for k in sr.keys() & cr.keys() & wr.keys():
        a, b, c = sr[k], cr[k], wr[k]
        tot = float(a + b + c)
        out[k] = (a, b, c, a / tot * 100.0, b / tot * 100.0, c / tot * 100.0, tot / 3.0)
    return out


def oracle_q85(tables):
    """{reason[:20]: (average quantity, average refund, average fee)}
    (the decimals exact HALF_UP at scale 6) of the 2000 web lines joined
    to their returns on (order, item), a page, both demographics, the
    refund address and the reason, kept by the query's OR'd bands."""
    ws, wr, cd = tables["web_sales"], tables["web_returns"], tables["customer_demographics"]
    ca, rs = tables["customer_address"], tables["reason"]
    w, r = _matches([wr["wr_order_number"][0], wr["wr_item_sk"][0]], [ws["ws_order_number"][0], ws["ws_item_sk"][0]])
    w_sk = ws["ws_web_page_sk"][0][w]
    cd1, cd2 = (_rows_of(cd["cd_demo_sk"][0], wr[c][0][r]) for c in ("wr_refunded_cdemo_sk", "wr_returning_cdemo_sk"))
    ar = _rows_of(ca["ca_address_sk"][0], wr["wr_refunded_addr_sk"][0][r])
    rr = _rows_of(rs["r_reason_sk"][0], wr["wr_reason_sk"][0][r])
    k = (np.isin(ws["ws_sold_date_sk"][0][w], _days_where(tables, d_year=2000))
         & np.isin(w_sk, tables["web_page"]["wp_web_page_sk"][0]) & _keep(cd1, cd2, ar, rr))
    w, r, cd1, cd2, ar, rr = w[k], r[k], cd1[k], cd2[k], ar[k], rr[k]
    ms, ms_labels = _codes(_sv(cd, "cd_marital_status"))
    ms_of = {v: i for i, v in enumerate(ms_labels)}
    m1, m2 = ms[cd1], ms[cd2]
    price = ws["ws_sales_price"][0][w] / 100.0
    profit = ws["ws_net_profit"][0][w] / 100.0
    demo = np.zeros(w.shape[0], bool)
    for status, lo, hi in (("M", 0.0, 150.0), ("S", 50.0, 250.0), ("W", 100.0, 300.0)):
        demo |= (m1 == ms_of.get(status, -1)) & (m1 == m2) & (price >= lo) & (price <= hi)
    us = _s_eq(ca, "ca_country", "United States")[ar]
    geo = np.zeros(w.shape[0], bool)
    for states, lo, hi in ((("OH", "TN", "SD"), -1000.0, 500.0), (("AL", "GA", "SD"), 0.0, 1500.0),
                           (("TN", "GA", "AL"), -500.0, 1000.0)):
        geo |= us & _s_isin(ca, "ca_state", states)[ar] & (profit >= lo) & (profit <= hi)
    k = demo & geo
    descs = _sv(rs, "r_reason_desc")
    sums = _label_sums(rr[k], descs, [ws["ws_quantity"][0][w[k]], wr["wr_refunded_cash"][0][r[k]],
                                      wr["wr_fee"][0][r[k]], np.ones(int(k.sum()), np.int64)])
    return {d[:20]: (q / n, _avg_u(c, n), _avg_u(f, n)) for d, (q, c, f, n) in sums.items()}


def _q78_channel(tables, fact, d_c, i_c, c_c, k2_c, q_c, w_c, s_c, rtab, ri_c, rk2_c):
    """(keys (item, customer) ascending, quantity, wholesale cost and
    price sums) of one channel's 2000 lines never returned."""
    f, rt = tables[fact], tables[rtab]
    rows = np.flatnonzero(np.isin(f[d_c][0], _days_where(tables, d_year=2000)))
    rows = rows[~np.isin(_key2(f[i_c][0][rows], f[k2_c][0][rows]), _key2(rt[ri_c][0], rt[rk2_c][0]))]
    (gi, gc), sums = _group_sums([f[i_c][0][rows], f[c_c][0][rows]], [f[c][0][rows] for c in (q_c, w_c, s_c)])
    return _key2(gi, gc), gi, gc, sums


def oracle_q78(tables):
    """{(item, customer): (store quantity, wholesale cost, price, ratio,
    other channels' quantity)} of 2000's never-returned store lines
    whose pair the web or the catalog sold too."""
    ss_k, ss_i, ss_c, (q, w, sp) = _q78_channel(tables, "store_sales", "ss_sold_date_sk", "ss_item_sk",
                                                 "ss_customer_sk", "ss_ticket_number", "ss_quantity",
                                                 "ss_wholesale_cost", "ss_sales_price", "store_returns", "sr_item_sk",
                                                 "sr_ticket_number")
    other = []
    for fact, p, rtab, r in (("web_sales", "ws", "web_returns", "wr"),
                             ("catalog_sales", "cs", "catalog_returns", "cr")):
        keys, _, _, (oq, _, _) = _q78_channel(tables, fact, f"{p}_sold_date_sk", f"{p}_item_sk",
                                              f"{p}_bill_customer_sk", f"{p}_order_number", f"{p}_quantity",
                                              f"{p}_wholesale_cost", f"{p}_sales_price", rtab, f"{r}_item_sk",
                                              f"{r}_order_number")
        at = _rows_of(keys, ss_k)
        other.append(np.where(at >= 0, oq[np.maximum(at, 0)], 0))
    wq, cq = other
    out = {}
    for j in np.flatnonzero((wq > 0) | (cq > 0)).tolist():
        o = int(wq[j] + cq[j])
        out[(int(ss_i[j]), int(ss_c[j]))] = (int(q[j]), int(w[j]), int(sp[j]), int(q[j]) / (float(o) if o > 0 else 1.0),
                                             o)
    return out


def oracle_q97(tables):
    """(store only, catalog only, both): the 2000 (customer, item) pairs
    of store and catalog sales."""
    dates = _days_where(tables, d_year=2000)

    def pairs(fact, d_c, c_c, i_c):
        f = tables[fact]
        m = np.isin(f[d_c][0], dates)
        return np.unique(_key2(f[c_c][0][m], f[i_c][0][m]))

    ss = pairs("store_sales", "ss_sold_date_sk", "ss_customer_sk", "ss_item_sk")
    cs = pairs("catalog_sales", "cs_sold_date_sk", "cs_bill_customer_sk", "cs_item_sk")
    both = int(np.intersect1d(ss, cs).shape[0])
    return (int(ss.shape[0]) - both, int(cs.shape[0]) - both, both)


def _q64_cells(tables, year):
    """{(item id, store name, zip): (lines, wholesale cost, list price,
    coupon sums)} of ``year``'s store lines of the ten colors, once per
    matching return on (item, ticket)."""
    ss, sr, it, st = tables["store_sales"], tables["store_returns"], tables["item"], tables["store"]
    rows = np.flatnonzero(np.isin(ss["ss_sold_date_sk"][0], _days_where(tables, d_year=year)))
    s, _ = _matches([sr["sr_item_sk"][0], sr["sr_ticket_number"][0]],
                    [ss["ss_item_sk"][0][rows], ss["ss_ticket_number"][0][rows]])
    s = rows[s]
    items = _dim(it, "i_item_sk", _sv(it, "i_item_id"), _s_isin(it, "i_color", _Q64_COLORS))
    stores = _dim(st, "s_store_sk", list(zip(_sv(st, "s_store_name"), _sv(st, "s_zip"))))
    ic, sc = _fact_code(items, ss["ss_item_sk"][0][s]), _fact_code(stores, ss["ss_store_sk"][0][s])
    k = _keep(ic, sc)
    (gi, gs), sums = _group_sums([ic[k], sc[k]], [np.ones(int(k.sum()), np.int64)]
                                 + [ss[c][0][s[k]] for c in ("ss_wholesale_cost", "ss_list_price", "ss_coupon_amt")])
    return {(items[2][i],) + stores[2][j]: tuple(int(v[n]) for v in sums)
            for n, (i, j) in enumerate(zip(gi.tolist(), gs.tolist()))}


def oracle_q64(tables):
    """{(item id, store name, zip): 2001's four values, then 2002's}
    where 2002 repeats at most as often."""
    c1, c2 = _q64_cells(tables, 2001), _q64_cells(tables, 2002)
    return {k: v + c2[k] for k, v in c1.items() if k in c2 and c2[k][0] <= v[0]}


def oracle_q72(tables):
    """{(item desc, warehouse name, week): lines}: the catalog lines of
    '>10000'-potential, divorced buyers shipped over 5 days after the
    sale, counted once per inventory row of their item, in their sale's
    week, holding fewer than the quantity ordered.  Per warehouse, the
    inventory is sorted by (item, week, on hand), so each line's count
    is one ``searchsorted`` difference (no pair is built)."""
    dd, it, wh = tables["date_dim"], tables["item"], tables["warehouse"]
    hd, cd = tables["household_demographics"], tables["customer_demographics"]
    cs, inv = tables["catalog_sales"], tables["inventory"]
    d_sk, d_date, d_week = dd["d_date_sk"][0], dd["d_date"][0].astype(np.int64), dd["d_week_seq"][0].astype(np.int64)
    m = (np.isin(cs["cs_bill_hdemo_sk"][0], hd["hd_demo_sk"][0][_s_eq(hd, "hd_buy_potential", ">10000")])
         & np.isin(cs["cs_bill_cdemo_sk"][0], cd["cd_demo_sk"][0][_s_eq(cd, "cd_marital_status", "D")]))
    rows = np.flatnonzero(m)
    sold, ship = (_rows_of(d_sk, cs[c][0][rows]) for c in ("cs_sold_date_sk", "cs_ship_date_sk"))
    ir = _rows_of(it["i_item_sk"][0], cs["cs_item_sk"][0][rows])
    k = (sold >= 0) & (ship >= 0) & (ir >= 0)
    k[k] &= d_date[ship[k]] > d_date[sold[k]] + 5
    rows, week, ir = rows[k], d_week[sold[k]], ir[k]
    item, qty = cs["cs_item_sk"][0][rows].astype(np.int64), cs["cs_quantity"][0][rows].astype(np.int64)
    descs, desc_labels = _codes(_sv(it, "i_item_desc"))
    inv_d = _rows_of(d_sk, inv["inv_date_sk"][0])
    inv_w = _rows_of(wh["w_warehouse_sk"][0], inv["inv_warehouse_sk"][0])
    qoh = inv["inv_quantity_on_hand"][0].astype(np.int64)
    lo, span = int(qoh.min(initial=0)), int(qoh.max(initial=0)) - int(qoh.min(initial=0)) + 2
    n_weeks = int(d_week.max()) + 1
    names = _sv(wh, "w_warehouse_name")
    out: Dict[tuple, int] = defaultdict(int)
    for w in range(wh["w_warehouse_sk"][0].shape[0]):
        at = np.flatnonzero((inv_w == w) & (inv_d >= 0))
        cell = inv["inv_item_sk"][0][at].astype(np.int64) * n_weeks + d_week[inv_d[at]]
        keys = np.sort(cell * span + (qoh[at] - lo))
        line = item * n_weeks + week
        n = (np.searchsorted(keys, line * span + np.clip(qty - lo, 0, span - 1), "left")
             - np.searchsorted(keys, line * span, "left"))
        got = n > 0
        (gd, gk), (cnt,) = _group_sums([descs[ir[got]], week[got]], [n[got]])
        for d, wk, c in zip(gd.tolist(), gk.tolist(), cnt.tolist()):
            out[(desc_labels[d], names[w], wk)] += c
    return dict(out)


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


def _close(a, b) -> bool:
    """Doubles within 1e-9 relative (nan equal to nan); anything else
    equal."""
    if isinstance(a, float) and isinstance(b, float):
        return a == b or (a != a and b != b) or abs(a - b) <= 1e-9 * max(abs(a), abs(b))
    return a == b


def _all_close(a: Sequence, b: Sequence) -> bool:
    return len(a) == len(b) and all(_close(x, y) for x, y in zip(a, b))


def _nf_key(k: tuple) -> tuple:
    return tuple(_null_first(v) for v in k)


def check_rollup_union_query(query: str, got: Dict[str, list], exp) -> str:
    """Raises ``AssertionError`` unless the rollup or union query's rows
    ``got`` (column -> values) equal its oracle ``exp`` on a nonempty
    result (but q23a's and q23b's, empty from SF 0.01 on: ROADMAP queue
    C, reference defect 14):
    integers and decimals exactly, doubles within 1e-9 relative; a top
    100 as the first 100 of the oracle's rows in the query's order
    (nulls first), compared as rows where the sort keys order them
    totally and as sort keys and a subset where rows may tie.  Returns
    what matched."""
    def need(ok, what):
        if not ok:
            raise AssertionError(f"{query}: {what}")

    n = len(next(iter(got.values())))
    size = len(exp) if isinstance(exp, dict) else int(exp is not None)
    if query not in ("q23a", "q23b") or size:
        need(n > 0 and size > 0, f"empty result ({n} rows, oracle {size})")

    def rollup(dims, values, order=None):
        """Rows keyed by ``dims`` (unique), in the oracle's first 100 by
        ``order`` (default: the keys, nulls first)."""
        keys = list(zip(*(got[d] for d in dims)))
        rows = list(zip(*(got[v] for v in values)))
        for k, r in zip(keys, rows):
            e = exp.get(k)
            need(e is not None and _all_close(r, e if isinstance(e, tuple) else (e,)), f"{k}: {r} != oracle {e}")
        key = order or (lambda k, v: _nf_key(k))
        need([key(k, exp[k]) for k in keys] == sorted(key(k, v) for k, v in exp.items())[:100],
             f"not the oracle's first {min(size, 100)} in order")
        return f"{n} of {size} rows = oracle"

    if query == "q27":
        return rollup(("i_item_id", "s_state", "g_id"), ("agg1", "agg2", "agg3", "agg4"),
                      lambda k, v: _nf_key(k[:2]))
    if query == "q18":
        return rollup(("i_item_id", "ca_county", "ca_state", "g_id"), tuple(f"agg{k}" for k in range(1, 8)),
                      lambda k, v: _nf_key((k[1], k[2], k[0], k[3])))
    if query == "q22":
        return rollup(("i_item_id", "i_brand", "i_class", "i_category", "g_id"), ("qoh",),
                      lambda k, v: (v,) + _nf_key(k[:4]))
    if query in ("q5", "q77", "q80"):
        keys = list(zip(got["channel"], got["id"]))
        rows = list(zip(got["sales"], got["returns"], got["profit"]))
        need(all(exp.get(k) == r for k, r in zip(keys, rows)), "rows != oracle")
        need([_nf_key(k) for k in keys] == sorted(_nf_key(k) for k in exp)[:100],
             "not the oracle's first 100 by (channel, id)")
        return f"{n} of {size} rollup rows = oracle, levels {sorted({(c is None) + (i is None) for c, i in keys})}"
    if query == "q14a":
        return rollup(("channel", "i_brand_id", "i_class_id", "i_category_id"), ("sum_sales", "sum_number_sales"))
    if query in ("q33", "q56", "q60"):
        g = "i_manufact_id" if query == "q33" else "i_item_id"
        rows = list(zip(got[g], got["total_sales"]))
        need(rows == sorted(((k, v) for k, v in exp.items()), key=lambda r: (r[1], r[0]))[:100],
             "not the oracle's first 100 by (total, id)")
        return f"{n} of {size} ids = oracle"
    if query == "q71":
        keys = list(zip(got["brand_id"], got["brand"], got["t_hour"], got["t_minute"]))
        need(dict(zip(keys, got["ext_price"])) == exp and n == size, "rows != oracle")
        order = [(-p, b) for p, b in zip(got["ext_price"], got["brand_id"])]
        need(order == sorted(order), "rows out of order")
        return f"{n} (brand, minute) cells = oracle"
    if query == "q76":
        return rollup(("channel", "col_name", "d_year", "d_qoy", "i_category"), ("sales_cnt", "sales_amt"))
    if query == "q66":
        names = got["w_warehouse_name"]
        need(names == sorted(exp)[:100], "warehouses != oracle")
        for i, name in enumerate(names):
            sq_ft, city, cty, state, country, sales, ratios, nets = exp[name]
            need((got["w_warehouse_sq_ft"][i], got["w_city"][i], got["w_county"][i], got["w_state"][i],
                  got["w_country"][i], got["ship_carriers"][i], got["year"][i])
                 == (sq_ft, city, cty, state, country, "DHL,BARIAN", 2001), f"{name}: keys != oracle")
            for m, nm in enumerate(("jan", "feb", "mar", "apr", "may", "jun", "jul", "aug", "sep", "oct", "nov",
                                    "dec")):
                need(got[f"{nm}_sales"][i] == sales[m] and got[f"{nm}_net"][i] == nets[m]
                     and _close(got[f"{nm}_sales_per_sq_foot"][i], ratios[m]), f"{name} {nm} != oracle")
        return f"{n} warehouses x 12 months = oracle"
    if query == "q2":
        weeks = got["d_week_seq"]
        need(weeks == sorted(exp)[:100], "weeks != oracle")
        for i, w in enumerate(weeks):
            for k, d in enumerate(("sun", "mon", "tue", "wed", "thu", "fri", "sat")):
                g, e = got[f"{d}_ratio"][i], exp[w][k]
                need((g is None) == (e is None) and (e is None or _close(g, e)), f"week {w} {d}: {g} != oracle {e}")
        return f"{n} of {size} weeks x 7 ratios = oracle"
    if query == "q75":
        keys = list(zip(got["i_brand_id"], got["i_class_id"], got["i_category_id"], got["i_manufact_id"]))
        rows = list(zip(got["sales_cnt_diff"], got["sales_amt_diff"]))
        need(all(exp.get(k) == r for k, r in zip(keys, rows)) and len(set(keys)) == n, "rows != oracle")
        need(rows == sorted(exp.values())[:100], "not the oracle's first 100 by (quantity, amount) change")
        need(set(got["year"]) == {2002} and set(got["prev_year"]) == {2001}, "years")
        return f"{n} of {size} items = oracle"
    if query == "q54":
        need(list(zip(got["segment"], got["num_customers"])) == sorted(exp.items())[:100],
             "not the oracle's first 100 segments")
        need(got["segment_base"] == [s * 50 for s in got["segment"]], "segment_base != 50 x segment")
        return f"{n} segments, {sum(exp.values())} customers = oracle"
    if query == "q23a":
        need(got["sum_sales"] == [exp], f"{got['sum_sales']} != oracle {exp}")
        return f"total {exp} = oracle"
    if query == "q23b":
        keys = list(zip(got["c_last_name"], got["c_first_name"]))
        need(all(exp.get(k) == v for k, v in zip(keys, got["sales"])) and len(set(keys)) == n, "rows != oracle")
        need([(-v, k) for k, v in zip(keys, got["sales"])] == sorted((-v, k) for k, v in exp.items())[:100],
             "not the oracle's first 100 by sales")
        return f"{n} of {size} customers = oracle"
    raise KeyError(query)



def check_exists_stddev_query(query: str, got: Dict[str, list], exp) -> str:
    """Raises ``AssertionError`` unless the rows ``got`` (column -> values)
    of a query of ``EXISTS_STDDEV_QUERIES`` equal its oracle ``exp`` on a
    nonempty result (but q87's, empty from SF 0.1 on: the generator's
    customers carry 8 distinct names, so every store (name, day) recurs
    in another channel): integers and decimals exactly, doubles
    (averages, stddevs, covs) within 1e-9 relative; a top 100 as the
    oracle's first 100 by the query's sort keys, which order its rows
    totally.  q39's
    rows pass a cov threshold: where they differ from the oracle's, the
    message names the oracle's rows whose cov lies within 1e-9 of a
    threshold.  Returns what matched."""
    def need(ok, what):
        if not ok:
            raise AssertionError(f"{query}: {what}")

    n = len(next(iter(got.values())))
    if query in ("q38", "q87"):
        need(got["cnt"] == [exp] and (exp > 0 or query == "q87"), f"{got['cnt']} != oracle {exp}")
        return f"{exp} (name, day) = oracle"
    if query == "q84":
        rows = list(zip(got["customer_id"], got["customername"]))
        need(n > 0 and sorted(rows) == exp and got["customer_id"] == sorted(got["customer_id"]),
             f"{rows[:5]}... != oracle {exp[:5]}...")
        return f"{n} (customer, name) rows = oracle"
    near = ()
    if query in ("q39a", "q39b"):
        exp, near = exp
    need(n > 0 and len(exp) > 0, f"empty result ({n} rows, oracle {len(exp)})")
    keys_of = {"q10": _Q10_CD, "q69": _Q10_CD[:5],
               "q35": ("ca_state", "cd_gender", "cd_marital_status", "cd_dep_count", "cd_dep_employed_count",
                       "cd_dep_college_count"),
               "q39a": ("w_warehouse_name", "inv_item_sk"), "q39b": ("w_warehouse_name", "inv_item_sk")}
    values_of = {"q10": ("cnt",), "q69": ("cnt",),
                 "q35": ("cnt1",) + tuple(f"{m}{i}" for i in (1, 2, 3) for m in ("avg", "max", "sum")),
                 "q25": ("store_sales_profit", "store_returns_loss", "catalog_sales_profit"),
                 "q29": ("store_sales_quantity", "store_returns_quantity", "catalog_sales_quantity"),
                 "q17": tuple(f"{leg}_qty_{m}" for leg in ("store", "returns", "catalog")
                              for m in ("count", "avg", "stdev", "cov")),
                 "q39a": ("mean", "cov", "mean2", "cov2"), "q39b": ("mean", "cov", "mean2", "cov2")}
    keys = list(zip(*(got[c] for c in keys_of.get(query, ("i_item_id", "i_item_desc", "s_store_name")))))
    rows = list(zip(*(got[c] for c in values_of[query])))
    flat = {k: tuple(x for leg in e for x in leg) if query == "q17" else e if isinstance(e, tuple) else (e,)
            for k, e in exp.items()}
    bad = [k for k, r in zip(keys, rows) if k not in flat or not _all_close(r, flat[k])]
    order_ok = keys == sorted(flat)[:100]
    if bad or not order_ok:
        missing = sorted(set(flat) - set(keys))[:5] if len(keys) < 100 else []
        raise AssertionError(f"{query}: rows {bad[:5]} != oracle, first 100 in order: {order_ok}, oracle rows "
                             f"missing {missing}; oracle rows within 1e-9 of a cov threshold: {list(near)}")
    return f"{n} of {len(flat)} rows = oracle" + (f" ({len(near)} within 1e-9 of a threshold)" if near else "")


def _sort_rows(rows, sort):
    """``rows`` in the order of ``sort`` ([(column index, descending)]),
    nulls first either way, as ``SortField`` orders them."""
    out = list(rows)
    for i, desc in reversed(sort):
        out = [r for r in out if r[i] is None] + sorted((r for r in out if r[i] is not None), key=lambda r: r[i],
                                                        reverse=desc)
    return out


def _check_sorted_rows(need, got, cols, exp_rows, sort, key_len=None, limit=100) -> str:
    """``got``'s rows (columns ``cols``) against the oracle's rows: each
    an oracle row, matched on its first ``key_len`` columns (doubles
    within 1e-9 relative; no key twice) or, without ``key_len``, as a
    multiset; and their sort keys those of the oracle's first ``limit``
    rows (all without a limit) in ``sort``'s order."""
    rows = list(zip(*(got[c] for c in cols)))
    n = len(rows)
    need(n > 0 and len(exp_rows) > 0, f"empty result ({n} rows, oracle {len(exp_rows)})")
    if key_len:
        by_key = {r[:key_len]: r for r in exp_rows}
        bad = [r for r in rows if r[:key_len] not in by_key or not _all_close(r, by_key[r[:key_len]])]
        need(not bad and len({r[:key_len] for r in rows}) == n, f"rows {bad[:3]} != oracle")
    else:
        left = Counter(exp_rows)
        left.subtract(rows)
        need(min(left.values()) >= 0, "rows != oracle")
    want = _sort_rows(exp_rows, sort)
    key = lambda r: tuple(r[i] for i, _ in sort)
    need([key(r) for r in rows] == [key(r) for r in (want[:limit] if limit else want)],
         f"not the oracle's first {limit or len(want)} in order")
    return f"{n} of {len(exp_rows)} rows = oracle"


#: per query of ``REPORT_QUERIES`` with rows: (its columns, the oracle's
#: rows from its return, the sort ([(column index, descending)]), the
#: columns that key a row (None: rows as a multiset), the fetch)
_REPORT_ROWS = {
    "q42": (("d_year", "category_id", "category", "sum_agg"), lambda e: [k + (v,) for k, v in e.items()],
            [(3, True), (0, False), (1, False), (2, False)], 3, 100),
    "q52": (("d_year", "brand_id", "brand", "ext_price"), lambda e: [k + (v,) for k, v in e.items()],
            [(0, False), (3, True), (1, False)], 3, 100),
    "q55": (("d_year", "brand_id", "brand", "ext_price"), lambda e: [k + (v,) for k, v in e.items()],
            [(3, True), (1, False)], 3, 100),
    "q19": (("brand_id", "brand", "manufact_id", "manufact", "ext_price"), lambda e: [k + (v,) for k, v in e.items()],
            [(4, True), (1, False), (0, False), (2, False), (3, False)], 4, 100),
    "q43": (("s_store_name",) + tuple(f"{d}_sales" for d in ("sun", "mon", "tue", "wed", "thu", "fri", "sat")),
            lambda e: [(k,) + tuple(v) for k, v in e.items()], [(0, False)], 1, 100),
    "q26": (("i_item_id", "agg1", "agg2", "agg3", "agg4"), lambda e: [(k,) + v for k, v in e.items()], [(0, False)],
            1, 100),
    "q6": (("state", "cnt"), lambda e: list(e.items()), [(1, False), (0, False)], 1, 100),
    "q15": (("ca_zip", "sum_price"), lambda e: list(e.items()), [(0, False)], 1, 100),
    "q45": (("ca_zip", "ca_city", "sum_sales"), lambda e: [k + (v,) for k, v in e.items()], [(0, False), (1, False)],
            2, 100),
    "q8": (("s_store_name", "net_profit"), lambda e: list(e.items()), [(0, False)], 1, 100),
    "q91": (("cc_name", "cd_marital_status", "cd_education_status", "returns_loss"),
            lambda e: [k + (v,) for k, v in e.items()], [(3, True), (0, False)], 3, 100),
    # (ticket, customer, salutation, first, last, preferred flag, lines); no fetch
    "q34": (("ss_ticket_number", "ss_customer_sk", "c_salutation", "c_first_name", "c_last_name",
             "c_preferred_cust_flag", "cnt"), lambda e: [k + v for k, v in e.items()],
            [(4, False), (3, False), (2, False), (5, True), (0, False)], 2, None),
    "q73": (("ss_ticket_number", "ss_customer_sk", "c_salutation", "c_first_name", "c_last_name",
             "c_preferred_cust_flag", "cnt"), lambda e: [k + v for k, v in e.items()], [(6, True), (4, False)], 2,
            None),
    "q46": (("c_last_name", "c_first_name", "current_city", "bought_city", "ss_ticket_number", "amt",
             "sum_ss_net_profit"), lambda e: [k + v for k, v in e.items()], [(i, False) for i in range(5)], 5, 100),
    "q68": (("c_last_name", "c_first_name", "current_city", "bought_city", "ss_ticket_number", "amt",
             "sum_ss_ext_list_price"), lambda e: [k + v for k, v in e.items()], [(i, False) for i in range(5)], 5,
            100),
    "q79": (("c_last_name", "c_first_name", "s_city", "ss_ticket_number", "amt", "profit"),
            lambda e: [k + v for k, v in e.items()], [(0, False), (1, False), (2, False), (5, False), (3, False)], 4,
            100),
    "q62": (("w_warehouse_name", "sm_type", "web_name", "d30", "d60", "d90", "d120", "dmore"),
            lambda e: [k + v for k, v in e.items()], [(0, False), (1, False), (2, False)], 3, 100),
    "q99": (("w_warehouse_name", "sm_type", "cc_name", "d30", "d60", "d90", "d120", "dmore"),
            lambda e: [k + v for k, v in e.items()], [(0, False), (1, False), (2, False)], 3, 100),
    "q21": (("w_warehouse_name", "i_item_id", "inv_before", "inv_after"), lambda e: [k + v for k, v in e.items()],
            [(0, False), (1, False)], 2, 100),
    "q65": (("s_store_name", "i_item_desc", "revenue", "i_current_price", "i_brand"), lambda e: list(e.values()),
            [(0, False), (1, False)], None, 100),
}


def check_report_query(query: str, got: Dict[str, list], exp) -> str:
    """Raises ``AssertionError`` unless the rows ``got`` (column -> values)
    of a query of ``REPORT_QUERIES`` equal its oracle ``exp`` on a
    nonempty result: integers and unscaled decimals exactly, doubles
    (q26's and q13's int averages, q90's and q61's ratios) within 1e-9
    relative; a report as the oracle's first 100 rows (q34 and q73: all
    of them) by the query's sort keys, rows that tie on every sort key
    compared as a set.  Returns what matched."""
    def need(ok, what):
        if not ok:
            raise AssertionError(f"{query}: {what}")

    if query in _REPORT_ROWS:
        cols, rows_of, sort, key_len, limit = _REPORT_ROWS[query]
        return _check_sorted_rows(need, got, cols, rows_of(exp), sort, key_len, limit)
    if query in ("q96", "q48", "q32", "q92"):
        name = {"q96": "cnt", "q48": "qty_sum"}.get(query, "excess_discount")
        need(got[name] == [exp] and bool(exp), f"{got[name]} != oracle {exp}")
        return f"{name} {exp} = oracle"
    if query == "q41":
        need(len(exp) > 0 and got["i_item_id"] == exp[:100], f"{got['i_item_id'][:5]}... != oracle {exp[:5]}...")
        return f"{len(got['i_item_id'])} of {len(exp)} items = oracle"
    if query == "q13":
        need(exp is not None and _all_close([got[k][0] for k in exp], list(exp.values())), f"{got} != oracle {exp}")
        return f"{exp['cnt']} banded rows = oracle"
    if query == "q9":
        got_b = [got[f"bucket{b}"][0] for b in range(1, 6)]
        need(got_b == exp and any(v is not None for v in exp), f"{got_b} != oracle {exp}")
        return f"5 buckets = oracle ({exp})"
    if query == "q28":
        for band, e in exp.items():
            g = tuple(got[f"{band}_{m}"][0] for m in ("lp", "cnt", "cntd"))
            need(g == e, f"{band} {g} != oracle {e}")
        need(any(e[1] for e in exp.values()), "every band empty")
        return f"6 bands = oracle ({sum(e[1] for e in exp.values())} rows)"
    if query == "q88":
        names = [f"h{h}_{30 if half else 0}" for h, half in (divmod(k + 17, 2) for k in range(8))]
        need([got[c][0] for c in names] == exp and any(exp), f"{[got[c][0] for c in names]} != oracle {exp}")
        return f"8 counts = oracle ({sum(exp)} sales)"
    if query == "q90":
        am, pm, ratio = exp
        need(got["am_count"] == [float(am)] and got["pm_count"] == [float(pm)] and _close(got["am_pm_ratio"][0], ratio)
             and am + pm > 0, f"{got} != oracle {exp}")
        return f"{am} / {pm} = oracle"
    if query == "q61":
        promo, total = exp
        need(promo is not None and total is not None, f"empty result (oracle {exp})")
        pct = (promo / 100.0) * 100.0 / (total / 100.0)
        need(got["promotions"] == [promo] and got["total"] == [total] and _close(got["promo_pct"][0], pct),
             f"{got} != oracle {exp}")
        return f"{promo} of {total} = oracle"
    raise KeyError(query)



_TRIPLE_IDS = ("i_brand_id", "i_class_id", "i_category_id")
_DOW_RATIOS = tuple(f"{d}_ratio" for d in ("sun", "mon", "tue", "wed", "thu", "fri", "sat"))
_Q64_COLS = ("i_item_id", "s_store_name", "s_zip", "cnt", "s1", "s2", "s3", "cnt2", "s1_2", "s2_2", "s3_2")

#: per query of ``JOINED_QUERIES`` with rows, as ``_REPORT_ROWS``: (its
#: columns, the oracle's rows from its return, the sort, the columns that
#: key a row (None: rows as a multiset), the fetch)
_JOINED_ROWS = {
    "q1": (("c_customer_id",), lambda e: [(k,) for k in e], [(0, False)], None, 100),
    **{q: (("c_customer_id", "c_first_name", "c_last_name", "ctr_total_return"), list, [(0, False), (3, False)],
           None, 100) for q in ("q30", "q81")},
    "q74": (("c_customer_id", "c_first_name", "c_last_name"), list, [(0, False)], None, 100),
    "q11": (("c_customer_id", "c_preferred_cust_flag", "c_first_name", "c_last_name"), list, [(0, False)], None,
            100),
    "q4": (("c_customer_id", "c_first_name", "c_last_name"), list, [(0, False)], None, 100),
    **{q: (("i_item_id", "i_item_desc", "i_current_price"), list, [(0, False)], None, 100) for q in ("q37", "q82")},
    "q40": (("w_state", "i_item_id", "sales_before", "sales_after"), lambda e: [k + v for k, v in e.items()],
            [(0, False), (1, False)], 2, 100),
    "q50": (("s_store_name", "s_county", "s_state", "s_zip", "d30", "d60", "d90", "d120", "dmore"),
            lambda e: [k + v for k, v in e.items()], [(i, False) for i in range(4)], 4, 100),
    "q93": (("ss_customer_sk", "sumsales"), lambda e: list(e.items()), [(1, False), (0, False)], 1, 100),
    **{q: (("c_last_name", "c_first_name", "s_store_name", "paid"), lambda e: [k + (v,) for k, v in e.items()],
           [(0, False), (1, False), (2, False)], 3, None) for q in ("q24a", "q24b")},
    "q14b": (_TRIPLE_IDS + ("sales", "number_sales", "last_sales", "last_number_sales"),
             lambda e: [k + v for k, v in e.items()], [(0, False), (1, False), (2, False)], 3, 100),
    "q58": (("item_id", "ss_item_rev", "ss_dev", "cs_item_rev", "cs_dev", "ws_item_rev", "ws_dev", "average"),
            lambda e: [(k,) + v for k, v in e.items()], [(0, False), (1, False)], 1, 100),
    "q31": (("ca_county", "web_q1_q2_increase", "store_q1_q2_increase", "web_q2_q3_increase",
             "store_q2_q3_increase"), lambda e: [(k,) + v for k, v in e.items()], [(0, False)], 1, None),
    "q59": (("s_store_name", "d_week_seq") + _DOW_RATIOS, lambda e: [k + v for k, v in e.items()],
            [(0, False), (1, False)], 2, 100),
    "q83": (("item_id", "sr_qty", "cr_qty", "wr_qty", "sr_dev", "cr_dev", "wr_dev", "average"),
            lambda e: [(k,) + v for k, v in e.items()], [(0, False), (1, False)], 1, 100),
    "q85": (("reason", "avg_q", "avg_cash", "avg_fee"), lambda e: [(k,) + v for k, v in e.items()],
            [(i, False) for i in range(4)], 1, 100),
    "q78": (("ss_item_sk", "ss_customer_sk", "ss_qty", "ss_wc", "ss_sp", "ratio", "other_chan_qty"),
            lambda e: [k + v for k, v in e.items()], [(2, True), (0, False), (1, False)], 2, 100),
    "q64": (_Q64_COLS, lambda e: [k + v for k, v in e.items()], [(4, True), (0, False), (1, False), (2, False)], 3,
            100),
    "q72": (("i_item_desc", "w_warehouse_name", "d_week_seq", "no_promo"), lambda e: [k + (v,) for k, v in e.items()],
            [(3, True), (0, False), (1, False), (2, False)], 3, 100),
}


def check_joined_query(query: str, got: Dict[str, list], exp) -> str:
    """Raises ``AssertionError`` unless the rows ``got`` (column -> values)
    of a query of ``JOINED_QUERIES`` equal its oracle ``exp`` on a
    nonempty result: integers and unscaled decimals exactly, doubles
    (ratios, shares, q85's average quantity) within 1e-9 relative (q31's
    unguarded ratios: inf as inf, nan as nan); a report as the oracle's
    first 100 rows (q24a, q24b and q31: all of them) by the query's sort
    keys, rows that tie on every sort key compared as a set.  Returns
    what matched."""
    def need(ok, what):
        if not ok:
            raise AssertionError(f"{query}: {what}")

    if query in ("q94", "q95", "q16", "q97"):
        cols = (("store_only", "catalog_only", "store_and_catalog") if query == "q97"
                else ("order_count", "total_shipping_cost", "total_net_profit"))
        row = tuple(got[c][0] for c in cols)
        need(len(got[cols[0]]) == 1 and row == exp and exp[0] > 0 and exp[-1] is not None, f"{row} != oracle {exp}")
        return f"{dict(zip(cols, exp))} = oracle"
    if query == "q31":
        need(set(got["d_year"]) == {2000}, f"d_year {set(got['d_year'])}")
    cols, rows_of, sort, key_len, limit = _JOINED_ROWS[query]
    return _check_sorted_rows(need, got, cols, rows_of(exp), sort, key_len, limit)


def check_query(query: str, got: Dict[str, list], exp) -> str:
    """:func:`check_rollup_union_query`,
    :func:`check_exists_stddev_query`, :func:`check_report_query` or
    :func:`check_joined_query` for those families, else
    :func:`check_window_query`."""
    if query in JOINED_QUERIES:
        return check_joined_query(query, got, exp)
    if query in REPORT_QUERIES:
        return check_report_query(query, got, exp)
    if query in ROLLUP_UNION_QUERIES:
        return check_rollup_union_query(query, got, exp)
    if query in EXISTS_STDDEV_QUERIES:
        return check_exists_stddev_query(query, got, exp)
    return check_window_query(query, got, exp)
