"""TPC-DS data generation (star-schema subset, deterministic): the
port's own copy of ``blaze_tpu/tpcds/datagen.py``, which must give the
same arrays from the same seed.

Shares the host-table format and helpers with the TPC-H generator
(tpch/datagen.py).  Foreign keys that TPC-DS leaves NULL are generated
as -1 here (no dimension row matches): identical behavior for the
inner-join query set, without per-column validity plumbing;
:func:`with_null_fks` exposes them as real nulls.

≙ the reference's dsdgen-produced datasets (tpcds/datagen wrapper,
tpcds-reusable.yml checks out a pregenerated 1 GB set).
"""

from __future__ import annotations

import zlib
from typing import Dict

import numpy as np

from ..tpch.datagen import HostTable, _days, _encode_options

CATEGORIES = [
    "Books", "Children", "Electronics", "Home", "Jewelry",
    "Men", "Music", "Shoes", "Sports", "Women",
]
EDUCATIONS = [
    "Primary", "Secondary", "College", "2 yr Degree",
    "4 yr Degree", "Advanced Degree", "Unknown",
]
MARITALS = ["M", "S", "D", "W", "U"]
GENDERS = ["M", "F"]
STORE_NAMES = ["ese", "ought", "able", "pri", "bar", "anti"]
STATES = ["TN", "SD", "AL", "GA", "OH"]
# incl. values OUTSIDE the q34/q73 filter set so the IN predicate
# actually filters rows
COUNTIES = ["Williamson County", "Franklin Parish", "Bronx County",
            "Orange County", "Salem County", "Kern County"]
BUY_POTENTIALS = ["1001-5000", "0-500", ">10000", "Unknown", "501-1000", "5001-10000"]
SALUTATIONS = ["Mr.", "Mrs.", "Ms.", "Dr.", "Sir"]
FIRST_NAMES = ["James", "Mary", "John", "Linda", "Robert", "Susan", "David", "Karen"]
LAST_NAMES = ["Smith", "Jones", "Brown", "Davis", "Miller", "Wilson", "Moore", "Taylor"]
CLASSES = [
    "accessories", "classical", "fiction", "shirts", "birdal",
    "dresses", "football", "fragrances", "pants", "pop",
    "reference", "romance", "self-help", "wallpaper", "personal", "maternity",
]

REASON_DESCS = ["Package was damaged", "Stopped working", "Did not get it on time",
                "Not the product that was ordred", "Parts missing"]

CITIES = ["Midway", "Fairview", "Oak Grove", "Five Points", "Centerville", "Riverside"]
UNITS = ["Each", "Dozen", "Case", "Pallet", "Gross", "Box"]
SIZES = ["small", "medium", "large", "extra large", "petite", "N/A"]
SHIP_MODE_TYPES = ["EXPRESS", "OVERNIGHT", "REGULAR", "TWO DAY", "LIBRARY"]
SHIP_CARRIERS = ["UPS", "FEDEX", "AIRBORNE", "USPS", "DHL"]
WAREHOUSE_NAMES = ["Conventional childr", "Important issues liv",
                   "Doors canno", "Bad cards must make", "Rooms cook"]
WEB_SITE_NAMES = ["site_0", "site_1", "site_2", "site_3"]

DATE_SK_BASE = 2450815  # arbitrary julian-like base, spec-style


def _n_customers(scale: float) -> int:
    return max(50, int(100000 * scale))


def _n_items(scale: float) -> int:
    """item row count — inventory/fact generators MUST use this same
    formula or their item_sk draws desync from the item table."""
    return max(60, int(18000 * scale))


def _n_cdemo() -> int:
    """customer_demographics row count — MUST match that generator's
    cross-product x reps."""
    return len(EDUCATIONS) * len(MARITALS) * len(GENDERS) * 4


def _n_promos(scale: float) -> int:
    return max(5, int(300 * scale))


def _n_addresses(scale: float) -> int:
    return max(25, _n_customers(scale) // 2)
D_FIRST = (1998, 1, 1)
D_LAST = (2002, 12, 31)


def _money(rng, n, lo, hi):
    """decimal(7,2) unscaled int64."""
    return rng.randint(int(lo * 100), int(hi * 100) + 1, n).astype(np.int64)


def _date_dim() -> HostTable:
    first = _days(*D_FIRST)
    last = _days(*D_LAST)
    days = np.arange(first, last + 1, dtype=np.int32)
    # civil calendar split (vectorized Hinnant)
    z = days.astype(np.int64) + 719468
    era = np.where(z >= 0, z, z - 146096) // 146097
    doe = z - era * 146097
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
    y = yoe + era * 400
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)
    mp = (5 * doy + 2) // 153
    d = doy - (153 * mp + 2) // 5 + 1
    m = np.where(mp < 10, mp + 3, mp - 9)
    y = np.where(m <= 2, y + 1, y)
    return {
        "d_date_sk": ((days - first + DATE_SK_BASE).astype(np.int64), None),
        "d_date": (days, None),
        "d_year": (y.astype(np.int32), None),
        "d_moy": (m.astype(np.int32), None),
        "d_dom": (d.astype(np.int32), None),
        "d_qoy": (((m - 1) // 3 + 1).astype(np.int32), None),
        # 0 = Sunday (dsdgen convention); 1970-01-01 was a Thursday
        "d_dow": (((days.astype(np.int64) + 4) % 7).astype(np.int32), None),
        # monotone sequences for the year-over-year window families
        # (q2/q59 join week_seq±53; q67/q14 slice month_seq ranges);
        # anchored at the dataset's first day, spec-shaped not
        # spec-identical — oracles compute from the same columns
        "d_week_seq": (((days - first) // 7 + 1).astype(np.int32), None),
        "d_month_seq": (
            (((y - 1998) * 12 + m - 1) + 1176).astype(np.int32), None),
    }


def _time_dim() -> HostTable:
    mins = np.arange(1440, dtype=np.int64)
    hours = mins // 60
    # round-5 columns (deterministic, no rng): t_time in seconds since
    # midnight (q66 slices a BETWEEN range on it); dsdgen's meal-time
    # buckets (q71 filters breakfast/dinner)
    meal = np.where(
        (hours >= 6) & (hours < 9), "breakfast",
        np.where((hours >= 17) & (hours < 20), "dinner", ""),
    )
    return {
        "t_time_sk": (mins, None),
        "t_hour": (hours.astype(np.int32), None),
        "t_minute": ((mins % 60).astype(np.int32), None),
        "t_time": ((mins * 60).astype(np.int64), None),
        "t_meal_time": (*_encode_options([str(m) for m in meal], 16),),
    }


def generate_table(name: str, scale: float, seed: int = 20011129,
                   _base: Dict[str, "HostTable"] = None, columns=None) -> HostTable:
    """Table ``name`` at ``scale``; ``columns`` keeps a subset (every
    column is drawn all the same, so a subset is a projection of the
    full table)."""
    table = _generate_table(name, scale, seed, _base)
    return table if columns is None else {c: v for c, v in table.items() if c in columns}


def _generate_table(name: str, scale: float, seed: int, _base: Dict[str, "HostTable"]) -> HostTable:
    rng = np.random.RandomState((seed + zlib.crc32(name.encode())) % (2**31))
    base = _base or {}
    if name == "date_dim":
        return _date_dim()
    if name == "time_dim":
        return _time_dim()
    if name == "store":
        n = len(STORE_NAMES)
        data, lengths = _encode_options(STORE_NAMES, 16)
        st_data, st_len = _encode_options([STATES[i % len(STATES)] for i in range(n)], 8)
        co_data, co_len = _encode_options(["Unknown"] * n, 16)
        cty_data, cty_len = _encode_options([COUNTIES[i % len(COUNTIES)] for i in range(n)], 24)
        zip_data, zip_len = _encode_options([f"{35000 + 137 * i:05d}" for i in range(n)], 16)
        return {
            "s_store_sk": (np.arange(1, n + 1, dtype=np.int64), None),
            "s_store_name": (data, lengths),
            "s_state": (st_data, st_len),
            "s_company_name": (co_data, co_len),
            "s_county": (cty_data, cty_len),
            "s_zip": (zip_data, zip_len),
            # market 8 ≈ a third of stores so the q24 filter keeps rows
            "s_market_id": ((np.arange(n) % 3 * 2 + 6).astype(np.int32), None),
            "s_city": (*_encode_options([CITIES[i % len(CITIES)] for i in range(n)], 16),),
        }
    if name == "promotion":
        n = _n_promos(scale)
        yn = lambda: _encode_options([("Y" if v else "N") for v in rng.randint(0, 2, n)], 8)
        e_data, e_len = yn()
        v_data, v_len = yn()
        return {
            "p_promo_sk": (np.arange(1, n + 1, dtype=np.int64), None),
            "p_channel_email": (e_data, e_len),
            "p_channel_event": (v_data, v_len),
        }
    if name == "customer_demographics":
        # full cross product, spec-style smallest-cycle dimension
        combos = [
            (g, m, e)
            for e in EDUCATIONS
            for m in MARITALS
            for g in GENDERS
        ]
        reps = 4
        combos = combos * reps
        nc = len(combos)
        assert nc == _n_cdemo()
        g_data, g_len = _encode_options([c[0] for c in combos], 8)
        m_data, m_len = _encode_options([c[1] for c in combos], 8)
        e_data, e_len = _encode_options([c[2] for c in combos], 24)
        ratings = ["Low Risk", "Good", "High Risk", "Unknown"]
        cr_data, cr_len = _encode_options([ratings[i % 4] for i in range(nc)], 16)
        return {
            "cd_demo_sk": (np.arange(1, nc + 1, dtype=np.int64), None),
            "cd_gender": (g_data, g_len),
            "cd_marital_status": (m_data, m_len),
            "cd_education_status": (e_data, e_len),
            "cd_purchase_estimate": (((np.arange(nc) % 10 + 1) * 500).astype(np.int32), None),
            "cd_credit_rating": (cr_data, cr_len),
            "cd_dep_count": ((np.arange(nc) % 7).astype(np.int32), None),
            "cd_dep_employed_count": ((np.arange(nc) % 5).astype(np.int32), None),
            "cd_dep_college_count": ((np.arange(nc) % 4).astype(np.int32), None),
        }
    if name == "household_demographics":
        n = 720
        bp_data, bp_len = _encode_options(
            [BUY_POTENTIALS[i % len(BUY_POTENTIALS)] for i in range(n)], 16
        )
        return {
            "hd_demo_sk": (np.arange(1, n + 1, dtype=np.int64), None),
            "hd_dep_count": ((np.arange(n) % 10).astype(np.int32), None),
            "hd_buy_potential": (bp_data, bp_len),
            "hd_vehicle_count": (((np.arange(n) % 5) - 1).astype(np.int32), None),
            # round-5 column (deterministic): q84's income-band edge
            "hd_income_band_sk": ((np.arange(n) % 20 + 1).astype(np.int64), None),
        }
    if name == "customer":
        n = _n_customers(scale)
        sal, sal_len = _encode_options([SALUTATIONS[i % len(SALUTATIONS)] for i in range(n)], 8)
        fn_, fn_len = _encode_options([FIRST_NAMES[i % len(FIRST_NAMES)] for i in range(n)], 16)
        ln_, ln_len = _encode_options([LAST_NAMES[(i * 3) % len(LAST_NAMES)] for i in range(n)], 16)
        pf, pf_len = _encode_options([("Y" if i % 2 else "N") for i in range(n)], 8)
        n_addr = _n_addresses(scale)
        n_cd = _n_cdemo()
        return {
            "c_customer_sk": (np.arange(1, n + 1, dtype=np.int64), None),
            "c_current_addr_sk": (rng.randint(1, n_addr + 1, n).astype(np.int64), None),
            "c_current_cdemo_sk": (rng.randint(1, n_cd + 1, n).astype(np.int64), None),
            "c_salutation": (sal, sal_len),
            "c_first_name": (fn_, fn_len),
            "c_last_name": (ln_, ln_len),
            "c_preferred_cust_flag": (pf, pf_len),
            "c_customer_id": (*_encode_options([f"CUST{k:012d}" for k in range(1, n + 1)], 16),),
            "c_birth_year": ((1930 + np.arange(n) % 63).astype(np.int32), None),
            # round-5 column (new draw strictly after the existing
            # ones): q84's household-demographics edge
            "c_current_hdemo_sk": (rng.randint(1, 721, n).astype(np.int64), None),
        }
    if name == "customer_address":
        n = _n_addresses(scale)
        # ~10% of addresses share a store's 5-digit zip prefix so the
        # q19 "customer zip != store zip" predicate filters real rows
        zips = [
            (f"{35000 + 137 * (i % 6):05d}" if i % 10 == 0 else f"{60000 + 31 * i:05d}")
            for i in range(n)
        ]
        z_data, z_len = _encode_options([z[:5] + "-" + z[:4] for z in zips], 16)
        co_data, co_len = _encode_options(
            [COUNTIES[i % len(COUNTIES)] for i in range(n)], 24
        )
        st_data, st_len = _encode_options(
            [STATES[(i * 7) % len(STATES)] for i in range(n)], 8
        )
        # gmt offsets from the dsdgen domain; ~40% at -5 so the
        # q33/q56/q60 filter keeps a real subset (decimal(5,2) unscaled)
        gmt = np.array([(-500 if i % 5 < 2 else -600 - 100 * (i % 3)) for i in range(n)],
                       np.int64)
        return {
            "ca_address_sk": (np.arange(1, n + 1, dtype=np.int64), None),
            "ca_zip": (z_data, z_len),
            "ca_county": (co_data, co_len),
            "ca_state": (st_data, st_len),
            "ca_gmt_offset": (gmt, None),
            # ~1/6 of addresses share each store city so the q46/q68
            # "bought in another city" predicate splits rows both ways
            "ca_city": (*_encode_options([CITIES[(i * 5) % len(CITIES)] for i in range(n)], 16),),
            # round-5 column (deterministic): ~10% non-US so the q85
            # ca_country predicate filters real rows
            "ca_country": (*_encode_options(
                [("Canada" if i % 10 == 9 else "United States") for i in range(n)], 16),),
        }
    if name == "call_center":
        names = ["NY Metro", "Mid Atlantic", "North Midwest", "Pacific Northwest"]
        d, ln = _encode_options(names, 24)
        return {
            "cc_call_center_sk": (np.arange(1, len(names) + 1, dtype=np.int64), None),
            "cc_name": (d, ln),
            "cc_county": (*_encode_options(
                [COUNTIES[i % len(COUNTIES)] for i in range(len(names))], 24),),
        }
    if name == "reason":
        d, ln = _encode_options(REASON_DESCS, 40)
        return {
            "r_reason_sk": (np.arange(1, len(REASON_DESCS) + 1, dtype=np.int64), None),
            "r_reason_desc": (d, ln),
        }
    if name == "store_returns":
        # ~8% of store_sales lines come back; keys reference the SAME
        # deterministic store_sales draw (callers may pass it via
        # _base to avoid regenerating the largest fact table)
        ss = base.get("store_sales") or generate_table("store_sales", scale, seed)
        n_ss = ss["ss_item_sk"][0].shape[0]
        take = rng.rand(n_ss) < 0.08
        idx = np.flatnonzero(take)
        n = idx.shape[0]
        qty = ss["ss_quantity"][0][idx]
        ret_q = np.minimum(rng.randint(1, 101, n), qty).astype(np.int32)
        out = {
            "sr_item_sk": (ss["ss_item_sk"][0][idx], None),
            "sr_ticket_number": (ss["ss_ticket_number"][0][idx], None),
            "sr_reason_sk": (rng.randint(1, len(REASON_DESCS) + 1, n).astype(np.int64), None),
            "sr_return_quantity": (ret_q, None),
            "sr_return_amt": (_money(rng, n, 0, 300), None),
        }
        # round-4 columns: all NEW rng draws stay strictly AFTER the
        # original ones so the pre-existing columns are byte-identical
        # across rounds (oracle seeds/filters were tuned against them).
        # Return-side keys mirror the originating ticket line so
        # (item, ticket) joins recover the full provenance.
        sold = ss["ss_sold_date_sk"][0][idx]
        last_sk = _days(*D_LAST) - _days(*D_FIRST) + DATE_SK_BASE
        ret_date = np.where(
            sold < 0, np.int64(-1),
            np.minimum(sold + rng.randint(1, 91, n), last_sk),
        ).astype(np.int64)
        out.update({
            "sr_returned_date_sk": (ret_date, None),
            "sr_customer_sk": (ss["ss_customer_sk"][0][idx], None),
            "sr_store_sk": (ss["ss_store_sk"][0][idx], None),
            "sr_cdemo_sk": (ss["ss_cdemo_sk"][0][idx], None),
            "sr_net_loss": (_money(rng, n, 0, 500), None),
        })
        return out
    if name == "catalog_sales":
        n = max(150, int(1_440_000 * scale))
        n_date = _days(*D_LAST) - _days(*D_FIRST) + 1
        n_item = _n_items(scale)
        n_cust = _n_customers(scale)
        n_addr = _n_addresses(scale)
        date_sk = np.where(
            rng.rand(n) < 0.02, np.int64(-1),
            rng.randint(0, n_date, n) + DATE_SK_BASE,
        ).astype(np.int64)
        n_cd = _n_cdemo()
        n_promo = _n_promos(scale)
        out = {
            "cs_sold_date_sk": (date_sk, None),
            "cs_item_sk": (rng.randint(1, n_item + 1, n).astype(np.int64), None),
            "cs_bill_customer_sk": (rng.randint(1, n_cust + 1, n).astype(np.int64), None),
            "cs_ship_customer_sk": (rng.randint(1, n_cust + 1, n).astype(np.int64), None),
            "cs_bill_addr_sk": (rng.randint(1, n_addr + 1, n).astype(np.int64), None),
            "cs_bill_cdemo_sk": (rng.randint(1, n_cd + 1, n).astype(np.int64), None),
            "cs_promo_sk": (rng.randint(1, n_promo + 1, n).astype(np.int64), None),
            "cs_call_center_sk": (rng.randint(1, 5, n).astype(np.int64), None),
            "cs_quantity": (rng.randint(1, 101, n).astype(np.int32), None),
            "cs_list_price": (_money(rng, n, 1, 200), None),
            "cs_coupon_amt": (_money(rng, n, 0, 100), None),
            "cs_sales_price": (_money(rng, n, 0, 300), None),
            "cs_ext_sales_price": (_money(rng, n, 0, 2000), None),
            "cs_ext_discount_amt": (_money(rng, n, 0, 1000), None),
        }
        # round-4 columns (new draws strictly after the original ones;
        # see store_returns note).  Orders group 1-6 consecutive lines
        # (dsdgen's order model) — per-line warehouses/dates still vary
        # within an order, which the q16/q94 EXISTS shapes require.
        order = np.repeat(np.arange(1, n + 1), rng.randint(1, 7, n))[:n].astype(np.int64)
        ship_lag = rng.randint(2, 121, n)
        last_sk = _days(*D_LAST) - _days(*D_FIRST) + DATE_SK_BASE
        ship_date = np.where(
            date_sk < 0, np.int64(-1), np.minimum(date_sk + ship_lag, last_sk)
        ).astype(np.int64)
        out.update({
            "cs_order_number": (order, None),
            "cs_ship_date_sk": (ship_date, None),
            "cs_warehouse_sk": (rng.randint(1, len(WAREHOUSE_NAMES) + 1, n).astype(np.int64), None),
            "cs_ship_mode_sk": (rng.randint(1, len(SHIP_MODE_TYPES) + 1, n).astype(np.int64), None),
            "cs_ship_addr_sk": (rng.randint(1, n_addr + 1, n).astype(np.int64), None),
            "cs_bill_hdemo_sk": (rng.randint(1, 721, n).astype(np.int64), None),
            "cs_catalog_page_sk": (rng.randint(1, 21, n).astype(np.int64), None),
            "cs_net_profit": (_money(rng, n, -1000, 1500), None),
            "cs_ext_ship_cost": (_money(rng, n, 0, 500), None),
            "cs_wholesale_cost": (_money(rng, n, 1, 100), None),
            "cs_ext_list_price": (_money(rng, n, 1, 3000), None),
            "cs_net_paid": (_money(rng, n, 0, 2000), None),
        })
        # round-5 columns (new draws strictly after the round-4 ones;
        # q66 pivots on sold time + net incl. tax, q71 on sold time)
        out.update({
            "cs_sold_time_sk": (rng.randint(0, 1440, n).astype(np.int64), None),
            "cs_net_paid_inc_tax": (_money(rng, n, 0, 2200), None),
        })
        return out
    if name == "web_sales":
        n = max(100, int(720_000 * scale))
        n_date = _days(*D_LAST) - _days(*D_FIRST) + 1
        n_item = _n_items(scale)
        n_cust = _n_customers(scale)
        n_addr = _n_addresses(scale)
        date_sk = np.where(
            rng.rand(n) < 0.02, np.int64(-1),
            rng.randint(0, n_date, n) + DATE_SK_BASE,
        ).astype(np.int64)
        out = {
            "ws_sold_date_sk": (date_sk, None),
            "ws_item_sk": (rng.randint(1, n_item + 1, n).astype(np.int64), None),
            "ws_bill_customer_sk": (rng.randint(1, n_cust + 1, n).astype(np.int64), None),
            "ws_bill_addr_sk": (rng.randint(1, n_addr + 1, n).astype(np.int64), None),
            "ws_ext_sales_price": (_money(rng, n, 0, 2000), None),
            "ws_net_paid": (_money(rng, n, 0, 2000), None),
            "ws_ext_discount_amt": (_money(rng, n, 0, 1000), None),
        }
        # round-4 columns (new draws strictly after the original ones)
        order = np.repeat(np.arange(1, n + 1), rng.randint(1, 7, n))[:n].astype(np.int64)
        ship_lag = rng.randint(2, 121, n)
        last_sk = _days(*D_LAST) - _days(*D_FIRST) + DATE_SK_BASE
        ship_date = np.where(
            date_sk < 0, np.int64(-1), np.minimum(date_sk + ship_lag, last_sk)
        ).astype(np.int64)
        out.update({
            "ws_order_number": (order, None),
            "ws_ship_date_sk": (ship_date, None),
            "ws_warehouse_sk": (rng.randint(1, len(WAREHOUSE_NAMES) + 1, n).astype(np.int64), None),
            "ws_ship_mode_sk": (rng.randint(1, len(SHIP_MODE_TYPES) + 1, n).astype(np.int64), None),
            "ws_ship_addr_sk": (rng.randint(1, n_addr + 1, n).astype(np.int64), None),
            "ws_web_site_sk": (rng.randint(1, len(WEB_SITE_NAMES) + 1, n).astype(np.int64), None),
            "ws_web_page_sk": (rng.randint(1, 11, n).astype(np.int64), None),
            "ws_sold_time_sk": (rng.randint(0, 1440, n).astype(np.int64), None),
            "ws_quantity": (rng.randint(1, 101, n).astype(np.int32), None),
            "ws_list_price": (_money(rng, n, 1, 200), None),
            "ws_sales_price": (_money(rng, n, 0, 300), None),
            "ws_net_profit": (_money(rng, n, -1000, 1500), None),
            "ws_ext_ship_cost": (_money(rng, n, 0, 500), None),
            "ws_wholesale_cost": (_money(rng, n, 1, 100), None),
            "ws_ext_list_price": (_money(rng, n, 1, 3000), None),
            "ws_promo_sk": (rng.randint(1, _n_promos(scale) + 1, n).astype(np.int64), None),
        })
        return out
    if name == "item":
        n = _n_items(scale)
        sk = np.arange(1, n + 1, dtype=np.int64)
        ids = [f"ITEM{k:012d}" for k in range(1, n + 1)]
        id_data, id_len = _encode_options(ids, 16)
        brand_id = (rng.randint(1, 10, n) * 1000000 + rng.randint(1, 200, n)).astype(np.int32)
        brands = [f"brand#{b}" for b in brand_id]
        b_data, b_len = _encode_options(brands, 32)
        cat_id = rng.randint(1, len(CATEGORIES) + 1, n).astype(np.int32)
        c_data, c_len = _encode_options([CATEGORIES[c - 1] for c in cat_id], 16)
        class_id = rng.randint(1, len(CLASSES) + 1, n).astype(np.int32)
        cl_data, cl_len = _encode_options([CLASSES[c - 1] for c in class_id], 16)
        desc_data, desc_len = _encode_options([f"desc of item {k % 97}" for k in range(n)], 32)
        mfi = rng.randint(1, 200, n).astype(np.int32)
        mf_data, mf_len = _encode_options([f"manufact#{m}" for m in mfi], 24)
        colors = ["slate", "blanched", "burnished", "peach", "saddle",
                  "powder", "navy", "chiffon", "ivory", "plum"]
        col_data, col_len = _encode_options([colors[int(v)] for v in rng.randint(0, len(colors), n)], 16)
        return {
            "i_item_sk": (sk, None),
            "i_color": (col_data, col_len),
            "i_item_id": (id_data, id_len),
            "i_item_desc": (desc_data, desc_len),
            "i_brand_id": (brand_id, None),
            "i_brand": (b_data, b_len),
            "i_class_id": (class_id, None),
            "i_class": (cl_data, cl_len),
            "i_category_id": (cat_id, None),
            "i_category": (c_data, c_len),
            "i_manufact_id": (mfi, None),
            "i_manufact": (mf_data, mf_len),
            "i_manager_id": (rng.randint(1, 40, n).astype(np.int32), None),
            "i_current_price": (_money(rng, n, 1, 99), None),
            "i_units": (*_encode_options([UNITS[int(v)] for v in rng.randint(0, len(UNITS), n)], 8),),
            "i_size": (*_encode_options([SIZES[int(v)] for v in rng.randint(0, len(SIZES), n)], 16),),
            "i_wholesale_cost": (_money(rng, n, 1, 80), None),
        }
    if name == "store_sales":
        # dsdgen's basket model: a TICKET (1..25 lines, ~13 avg) shares
        # one date/time/store/customer/demographics draw; per-LINE
        # attributes (item, quantity, prices) vary within the basket.
        # Ticket-level HAVING queries (q34/q73) depend on this shape.
        n_target = max(200, int(2_880_000 * scale))
        n_tickets = max(2, n_target // 13)
        n_date = _days(*D_LAST) - _days(*D_FIRST) + 1
        n_item = _n_items(scale)
        n_cd = _n_cdemo()
        n_promo = _n_promos(scale)
        n_cust = _n_customers(scale)

        lines_per = rng.randint(1, 26, n_tickets)
        n = int(lines_per.sum())
        tidx = np.repeat(np.arange(n_tickets), lines_per)

        def ticket_fk(upper, null_frac=0.04):
            v = rng.randint(1, upper + 1, n_tickets).astype(np.int64)
            nulls = rng.rand(n_tickets) < null_frac
            return np.where(nulls, np.int64(-1), v)[tidx]

        t_date = np.where(
            rng.rand(n_tickets) < 0.02, np.int64(-1),
            rng.randint(0, n_date, n_tickets) + DATE_SK_BASE,
        ).astype(np.int64)[tidx]
        t_time = np.where(
            rng.rand(n_tickets) < 0.02, np.int64(-1),
            rng.randint(0, 1440, n_tickets),
        ).astype(np.int64)[tidx]
        return {
            "ss_sold_date_sk": (t_date, None),
            "ss_sold_time_sk": (t_time, None),
            "ss_item_sk": (rng.randint(1, n_item + 1, n).astype(np.int64), None),
            "ss_customer_sk": (ticket_fk(n_cust), None),
            "ss_cdemo_sk": (ticket_fk(n_cd), None),
            "ss_hdemo_sk": (ticket_fk(720), None),
            "ss_store_sk": (ticket_fk(len(STORE_NAMES)), None),
            "ss_promo_sk": (
                np.where(rng.rand(n) < 0.04, np.int64(-1),
                         rng.randint(1, n_promo + 1, n)).astype(np.int64), None),
            "ss_addr_sk": (ticket_fk(_n_addresses(scale)), None),
            "ss_ticket_number": ((tidx + 1).astype(np.int64), None),
            "ss_quantity": (rng.randint(1, 101, n).astype(np.int32), None),
            "ss_list_price": (_money(rng, n, 1, 200), None),
            "ss_sales_price": (_money(rng, n, 0, 200), None),
            "ss_ext_discount_amt": (_money(rng, n, 0, 1000), None),
            "ss_ext_sales_price": (_money(rng, n, 0, 2000), None),
            "ss_coupon_amt": (_money(rng, n, 0, 100), None),
            "ss_net_profit": (_money(rng, n, -1000, 1000), None),
            "ss_net_paid": (_money(rng, n, 0, 2000), None),
            "ss_wholesale_cost": (_money(rng, n, 1, 100), None),
            "ss_ext_list_price": (_money(rng, n, 1, 3000), None),
            "ss_ext_wholesale_cost": (_money(rng, n, 1, 5000), None),
        }
    if name == "warehouse":
        n = len(WAREHOUSE_NAMES)
        return {
            "w_warehouse_sk": (np.arange(1, n + 1, dtype=np.int64), None),
            "w_warehouse_name": (*_encode_options(WAREHOUSE_NAMES, 24),),
            "w_state": (*_encode_options([STATES[i % len(STATES)] for i in range(n)], 8),),
            "w_county": (*_encode_options([COUNTIES[i % len(COUNTIES)] for i in range(n)], 24),),
            # round-5 columns (deterministic, q66's pivot attributes)
            "w_warehouse_sq_ft": (((np.arange(n) + 1) * 73065).astype(np.int32), None),
            "w_city": (*_encode_options([CITIES[i % len(CITIES)] for i in range(n)], 16),),
            "w_country": (*_encode_options(["United States"] * n, 16),),
        }
    if name == "web_site":
        n = len(WEB_SITE_NAMES)
        return {
            "web_site_sk": (np.arange(1, n + 1, dtype=np.int64), None),
            "web_name": (*_encode_options(WEB_SITE_NAMES, 16),),
            "web_company_name": (*_encode_options(["pri", "ought", "able", "ese"], 16),),
        }
    if name == "ship_mode":
        n = len(SHIP_MODE_TYPES)
        return {
            "sm_ship_mode_sk": (np.arange(1, n + 1, dtype=np.int64), None),
            "sm_type": (*_encode_options(SHIP_MODE_TYPES, 16),),
            "sm_carrier": (*_encode_options(SHIP_CARRIERS, 16),),
        }
    if name == "catalog_page":
        n = 20
        return {
            "cp_catalog_page_sk": (np.arange(1, n + 1, dtype=np.int64), None),
            "cp_catalog_page_id": (*_encode_options([f"CPAG{k:08d}" for k in range(1, n + 1)], 16),),
        }
    if name == "income_band":
        # dsdgen's 20 fixed bands: [0..10000], [10001..20000], ...
        sk = np.arange(1, 21, dtype=np.int64)
        return {
            "ib_income_band_sk": (sk, None),
            "ib_lower_bound": (np.where(sk == 1, 0, (sk - 1) * 10000 + 1).astype(np.int32), None),
            "ib_upper_bound": ((sk * 10000).astype(np.int32), None),
        }
    if name == "web_page":
        n = 10
        return {
            "wp_web_page_sk": (np.arange(1, n + 1, dtype=np.int64), None),
            "wp_char_count": ((np.arange(n) * 800 + 400).astype(np.int32), None),
        }
    if name == "inventory":
        # weekly snapshots x item x warehouse, dsdgen-style full cross
        # (row count scales with the item dimension only)
        n_item = _n_items(scale)
        n_wh = len(WAREHOUSE_NAMES)
        first = _days(*D_FIRST)
        last = _days(*D_LAST)
        week_days = np.arange(first, last + 1, 7, dtype=np.int64) - first + DATE_SK_BASE
        dd, ii, ww = np.meshgrid(
            week_days, np.arange(1, n_item + 1, dtype=np.int64),
            np.arange(1, n_wh + 1, dtype=np.int64), indexing="ij",
        )
        n = dd.size
        return {
            "inv_date_sk": (dd.ravel(), None),
            "inv_item_sk": (ii.ravel(), None),
            "inv_warehouse_sk": (ww.ravel(), None),
            "inv_quantity_on_hand": (rng.randint(0, 1001, n).astype(np.int32), None),
        }
    if name == "catalog_returns":
        cs = base.get("catalog_sales") or generate_table("catalog_sales", scale, seed)
        n_cs = cs["cs_item_sk"][0].shape[0]
        take = rng.rand(n_cs) < 0.08
        idx = np.flatnonzero(take)
        n = idx.shape[0]
        ship = cs["cs_ship_date_sk"][0][idx]
        last_sk = _days(*D_LAST) - _days(*D_FIRST) + DATE_SK_BASE
        ret_date = np.where(
            ship < 0, np.int64(-1), np.minimum(ship + rng.randint(1, 61, n), last_sk)
        ).astype(np.int64)
        ret_q = np.minimum(rng.randint(1, 101, n), cs["cs_quantity"][0][idx]).astype(np.int32)
        return {
            "cr_item_sk": (cs["cs_item_sk"][0][idx], None),
            "cr_order_number": (cs["cs_order_number"][0][idx], None),
            "cr_returned_date_sk": (ret_date, None),
            "cr_return_quantity": (ret_q, None),
            "cr_return_amount": (_money(rng, n, 0, 300), None),
            "cr_net_loss": (_money(rng, n, 0, 500), None),
            "cr_catalog_page_sk": (cs["cs_catalog_page_sk"][0][idx], None),
            "cr_returning_customer_sk": (cs["cs_bill_customer_sk"][0][idx], None),
            "cr_call_center_sk": (cs["cs_call_center_sk"][0][idx], None),
            "cr_refunded_cash": (_money(rng, n, 0, 250), None),
        }
    if name == "web_returns":
        ws = base.get("web_sales") or generate_table("web_sales", scale, seed)
        n_ws = ws["ws_item_sk"][0].shape[0]
        take = rng.rand(n_ws) < 0.08
        idx = np.flatnonzero(take)
        n = idx.shape[0]
        ship = ws["ws_ship_date_sk"][0][idx]
        last_sk = _days(*D_LAST) - _days(*D_FIRST) + DATE_SK_BASE
        ret_date = np.where(
            ship < 0, np.int64(-1), np.minimum(ship + rng.randint(1, 61, n), last_sk)
        ).astype(np.int64)
        ret_q = np.minimum(rng.randint(1, 101, n), ws["ws_quantity"][0][idx]).astype(np.int32)
        return {
            "wr_item_sk": (ws["ws_item_sk"][0][idx], None),
            "wr_order_number": (ws["ws_order_number"][0][idx], None),
            "wr_returned_date_sk": (ret_date, None),
            "wr_return_quantity": (ret_q, None),
            "wr_return_amt": (_money(rng, n, 0, 300), None),
            "wr_net_loss": (_money(rng, n, 0, 500), None),
            "wr_web_page_sk": (ws["ws_web_page_sk"][0][idx], None),
            "wr_returning_customer_sk": (ws["ws_bill_customer_sk"][0][idx], None),
            "wr_refunded_cash": (_money(rng, n, 0, 250), None),
            # round-5 columns (new draws strictly after the round-4
            # ones): the q85 demographics/address/reason edges
            "wr_fee": (_money(rng, n, 0, 100), None),
            "wr_refunded_cdemo_sk": (rng.randint(1, _n_cdemo() + 1, n).astype(np.int64), None),
            "wr_returning_cdemo_sk": (rng.randint(1, _n_cdemo() + 1, n).astype(np.int64), None),
            "wr_refunded_addr_sk": (rng.randint(1, _n_addresses(scale) + 1, n).astype(np.int64), None),
            "wr_reason_sk": (rng.randint(1, len(REASON_DESCS) + 1, n).astype(np.int64), None),
        }
    raise KeyError(f"unknown tpcds table {name!r}")


def with_null_fks(table: HostTable, columns) -> HostTable:
    """``table`` with the -1 stand-ins for null in ``columns`` exposed as
    real nulls: each named column becomes (data, lengths, data != -1),
    the same draws with a validity (≙ the reference's
    ``with_null_fks``), which ``batch.table_to_batches`` stages."""
    out = dict(table)
    for c in columns:
        data, lengths = table[c][0], table[c][1]
        out[c] = (data, lengths, data != np.int64(-1))
    return out


def generate_all(scale: float, seed: int = 20011129) -> Dict[str, HostTable]:
    from .schema import TPCDS_SCHEMAS

    out: Dict[str, HostTable] = {}
    for name in TPCDS_SCHEMAS:
        out[name] = generate_table(name, scale, seed, _base=out)
    return out
