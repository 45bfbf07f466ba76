"""Independent numpy/python oracles for the port's TPC-DS queries, each
re-implemented from the spec over the generated host tables, no engine
code reused: its own copy of ``blaze_tpu/tpcds/oracle.py``'s
``oracle_q3`` and ``oracle_q7``, and of the window family's oracles
(q12, q20, q98, q53, q63, q89, q47, q57, q36, q86, q70, q67, q44, q49,
q51) and of the rollup and union family's (q27, q18, q22, q5, q77, q80,
q14a, q33, q56, q60, q71, q76, q66, q2, q75, q54, q23a, q23b) and of
``EXISTS_STDDEV_QUERIES``' (q10, q35, q69, q38, q87, q17, q25, q29,
q39a, q39b, q84), which return what the reference's return (q18's
double averages and q17's and q39's stddevs within 1e-9 relative: these
compute a variance exactly in integers and round once, the reference's
from a float sum of squares; q39's also list the rows near a cov
threshold).  The reference's loop in Python over every fact row (q67's
nine times, q22's over 23.49M inventory rows at SF1, and its ranks and
q51's per-item merges are quadratic), which does not finish at SF1;
these join and group the fact rows with numpy (sorted-key joins,
sums by ``np.add.reduceat`` over a lexsort, exact in int64) and keep
Python for the groups."""

from __future__ import annotations

import datetime
import math
from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..tpch.oracle import _round_half_up, _s_eq, _s_isin, _sv
from .queries import EXISTS_STDDEV_QUERIES, ROLLUP_UNION_QUERIES


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


def oracle_q14a(tables):
    """{(channel, brand, class, category ids) with None above the level:
    (sales, number of sales)}: November 2002 cells of the items whose id
    triple sells in all three channels in 1998-2000, kept above the
    three channels' 1998-2000 average of quantity x list price (exact
    HALF_UP at scale 6), ROLLUP over the channels' union."""
    dd, it = tables["date_dim"], tables["item"]
    y, mo = dd["d_year"][0], dd["d_moy"][0]
    years = dd["d_date_sk"][0][(y >= 1998) & (y <= 2000)]
    nov = dd["d_date_sk"][0][(y == 2002) & (mo == 11)]
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
    inter = seen[0] & seen[1] & seen[2]
    q_, r_ = divmod(total * 10_000, cnt)
    thr = (q_ + (1 if 2 * r_ >= cnt else 0)) / 1_000_000.0
    cells: Dict[tuple, list] = {}
    for (fact, d_c, i_c, q_c, p_c), name in zip(_SALES_QP, ("store", "catalog", "web")):
        f = tables[fact]
        tc = _fact_code(item_triple, f[i_c][0])
        m = np.isin(f[d_c][0], nov) & np.isin(tc, np.array(sorted(inter), np.int64))
        v = f[q_c][0][m].astype(np.int64) * f[p_c][0][m].astype(np.int64)
        for triple, (s, n) in _label_sums(tc[m], tlabels, [v, np.ones(v.shape[0], np.int64)]).items():
            if s / 100.0 > thr:
                cells[(name,) + triple] = [s, n]
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
        sums2, c1, c2 = sums[k2], counts[w1], counts[k2]
        out[w1] = tuple(None if n1 == 0 else (a / 100.0) / ((b / 100.0) if (n2 > 0 and b > 0) else 1.0)
                        for a, b, n1, n2 in zip(sums1, sums2, c1, c2))
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
    """Two int64 keys as one (``b`` in [0, 2^32))."""
    return a.astype(np.int64) * (1 << 32) + b.astype(np.int64)


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
    """Doubles within 1e-9 relative; anything else equal."""
    if isinstance(a, float) and isinstance(b, float):
        return a == b or abs(a - b) <= 1e-9 * max(abs(a), abs(b))
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


def check_query(query: str, got: Dict[str, list], exp) -> str:
    """:func:`check_rollup_union_query` or
    :func:`check_exists_stddev_query` for those families, else
    :func:`check_window_query`."""
    if query in ROLLUP_UNION_QUERIES:
        return check_rollup_union_query(query, got, exp)
    if query in EXISTS_STDDEV_QUERIES:
        return check_exists_stddev_query(query, got, exp)
    return check_window_query(query, got, exp)
