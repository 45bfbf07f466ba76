"""Independent numpy/python oracles for the port's TPC-DS queries:
its own copy of ``oracle_q3`` and ``oracle_q7`` from
``blaze_tpu/tpcds/oracle.py``, each re-implemented from the spec over
the generated host tables, no engine code reused."""

from __future__ import annotations

from typing import Dict

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
