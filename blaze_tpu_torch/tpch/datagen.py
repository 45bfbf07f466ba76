"""Deterministic TPC-H data generator (vectorized numpy): the port's
own copy of ``blaze_tpu/tpch/datagen.py``, bit-identical to it for the
same seed (a test holds the two to equal arrays).

Values come out in physical form: decimals as unscaled int64, dates as
int32 days, strings as (N, W) uint8 + lengths.
"""

from __future__ import annotations

import datetime
from typing import Dict, List, Tuple

import numpy as np

from ..batch import HostTable  # (data, lengths|None); TPC-H has no nulls
from .schema import TPCH_SCHEMAS

EPOCH = datetime.date(1970, 1, 1)


def _days(y, m, d) -> int:
    return (datetime.date(y, m, d) - EPOCH).days

START_DATE = _days(1992, 1, 1)
END_DATE = _days(1998, 8, 2)

# spec value lists
RETURNFLAGS = ["R", "A", "N"]
LINESTATUS = ["O", "F"]
SHIPMODES = ["REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB"]
SHIPINSTRUCT = ["DELIVER IN PERSON", "COLLECT COD", "NONE", "TAKE BACK RETURN"]
PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECI", "5-LOW"]
SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY", "HOUSEHOLD"]
NATIONS = [
    ("ALGERIA", 0), ("ARGENTINA", 1), ("BRAZIL", 1), ("CANADA", 1), ("EGYPT", 4),
    ("ETHIOPIA", 0), ("FRANCE", 3), ("GERMANY", 3), ("INDIA", 2), ("INDONESIA", 2),
    ("IRAN", 4), ("IRAQ", 4), ("JAPAN", 2), ("JORDAN", 4), ("KENYA", 0),
    ("MOROCCO", 0), ("MOZAMBIQUE", 0), ("PERU", 1), ("CHINA", 2), ("ROMANIA", 3),
    ("SAUDI ARABIA", 4), ("VIETNAM", 2), ("RUSSIA", 3), ("UNITED KINGDOM", 3),
    ("UNITED STATES", 1),
]
REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
TYPE_S1 = ["STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY", "PROMO"]
TYPE_S2 = ["ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED"]
TYPE_S3 = ["TIN", "NICKEL", "BRASS", "STEEL", "COPPER"]
CONTAINER_S1 = ["SM", "LG", "MED", "JUMBO", "WRAP"]
CONTAINER_S2 = ["CASE", "BOX", "BAG", "JAR", "PKG", "PACK", "CAN", "DRUM"]
BRANDS = [f"Brand#{i}{j}" for i in range(1, 6) for j in range(1, 6)]
WORDS = [
    "special", "pending", "unusual", "express", "furious", "sly", "careful",
    "blithe", "quick", "bold", "ironic", "final", "regular", "even",
    "requests", "deposits", "packages", "accounts", "foxes", "ideas",
    "theodolites", "dependencies", "instructions", "accounts",
]


def _encode_options(options: List[str], width: int) -> Tuple[np.ndarray, np.ndarray]:
    data = np.zeros((len(options), width), np.uint8)
    lengths = np.zeros(len(options), np.int32)
    for i, s in enumerate(options):
        b = s.encode()
        data[i, : len(b)] = np.frombuffer(b, np.uint8)
        lengths[i] = len(b)
    return data, lengths


def str_choice(rng, options: List[str], n: int, width: int):
    data, lengths = _encode_options(options, width)
    idx = rng.randint(0, len(options), n)
    return data[idx], lengths[idx]


def word_sentence(rng, n: int, width: int, n_words: int = 4):
    """Pseudo comments: k words sampled from the spec-ish word list."""
    opts_data, opts_len = _encode_options([w + " " for w in WORDS], 16)
    data = np.zeros((n, width), np.uint8)
    lengths = np.zeros(n, np.int32)
    for w in range(n_words):
        idx = rng.randint(0, len(WORDS), n)
        wl = opts_len[idx]
        for j in range(16):
            col_pos = lengths + j
            ok = (j < wl) & (col_pos < width)
            data[np.arange(n)[ok], col_pos[ok]] = opts_data[idx[ok], j]
        lengths = np.minimum(lengths + wl, width)
    # trim trailing space
    last = np.maximum(lengths - 1, 0)
    trailing = data[np.arange(n), last] == ord(" ")
    lengths = lengths - trailing.astype(np.int32)
    data[np.arange(n)[trailing], last[trailing]] = 0
    return data, lengths


def _money(rng, n, lo, hi):
    """decimal(12,2) unscaled int64 uniform in [lo, hi] dollars."""
    return rng.randint(int(lo * 100), int(hi * 100) + 1, n).astype(np.int64)




def generate_table(name: str, scale: float, seed: int = 19940204, columns=None) -> HostTable:
    import zlib as _z

    rng = np.random.RandomState((seed + _z.crc32(name.encode())) % (2**31))
    if name == "region":
        data, lengths = _encode_options(REGIONS, 16)
        cdata, clen = word_sentence(rng, 5, 128)
        return {
            "r_regionkey": (np.arange(5, dtype=np.int32), None),
            "r_name": (data, lengths),
            "r_comment": (cdata, clen),
        }
    if name == "nation":
        names = [n for n, _ in NATIONS]
        data, lengths = _encode_options(names, 32)
        cdata, clen = word_sentence(rng, 25, 128)
        return {
            "n_nationkey": (np.arange(25, dtype=np.int32), None),
            "n_name": (data, lengths),
            "n_regionkey": (np.array([r for _, r in NATIONS], np.int32), None),
            "n_comment": (cdata, clen),
        }
    if name == "supplier":
        n = max(1, int(10000 * scale))
        keys = np.arange(1, n + 1, dtype=np.int64)
        sdata, slen = _encode_options([f"Supplier#{k:09d}" for k in range(1, n + 1)], 32)
        addr, alen = word_sentence(rng, n, 64, 3)
        phone, plen = _encode_options(
            [f"{10+k%25}-{rng.randint(100,999)}-{rng.randint(100,999)}-{rng.randint(1000,9999)}" for k in range(n)], 16
        )
        cdata, clen = word_sentence(rng, n, 128)
        return {
            "s_suppkey": (keys, None),
            "s_name": (sdata, slen),
            "s_address": (addr, alen),
            "s_nationkey": (rng.randint(0, 25, n).astype(np.int32), None),
            "s_phone": (phone, plen),
            "s_acctbal": (_money(rng, n, -999, 9999), None),
            "s_comment": (cdata, clen),
        }
    if name == "customer":
        n = max(1, int(150000 * scale))
        keys = np.arange(1, n + 1, dtype=np.int64)
        ndata, nlen = _encode_options([f"Customer#{k:09d}" for k in range(1, min(n, 1) + 1)], 32)
        # vectorized names: prefix + zero-padded key
        name_data = np.zeros((n, 32), np.uint8)
        prefix = np.frombuffer(b"Customer#", np.uint8)
        name_data[:, :9] = prefix
        digits = np.array([keys // 10**d % 10 for d in range(8, -1, -1)]).T + ord("0")
        name_data[:, 9:18] = digits.astype(np.uint8)
        name_len = np.full(n, 18, np.int32)
        addr, alen = word_sentence(rng, n, 64, 3)
        ph_data, ph_len = str_choice(rng, ["11-111-111-1111"], n, 16)
        seg_data, seg_len = str_choice(rng, SEGMENTS, n, 16)
        cdata, clen = word_sentence(rng, n, 128)
        return {
            "c_custkey": (keys, None),
            "c_name": (name_data, name_len),
            "c_address": (addr, alen),
            "c_nationkey": (rng.randint(0, 25, n).astype(np.int32), None),
            "c_phone": (ph_data, ph_len),
            "c_acctbal": (_money(rng, n, -999, 9999), None),
            "c_mktsegment": (seg_data, seg_len),
            "c_comment": (cdata, clen),
        }
    if name == "part":
        n = max(1, int(200000 * scale))
        keys = np.arange(1, n + 1, dtype=np.int64)
        pname, pnlen = word_sentence(rng, n, 64, 3)
        mfgr_ids = rng.randint(1, 6, n)
        mdata, mlen = _encode_options([f"Manufacturer#{i}" for i in range(1, 6)], 32)
        bdata, blen = _encode_options(BRANDS, 16)
        brand_idx = rng.randint(0, len(BRANDS), n)
        types = [f"{a} {b} {c}" for a in TYPE_S1 for b in TYPE_S2 for c in TYPE_S3]
        tdata, tlen = _encode_options(types, 32)
        t_idx = rng.randint(0, len(types), n)
        containers = [f"{a} {b}" for a in CONTAINER_S1 for b in CONTAINER_S2]
        cdata_, clen_ = _encode_options(containers, 16)
        c_idx = rng.randint(0, len(containers), n)
        com, comlen = word_sentence(rng, n, 32, 2)
        return {
            "p_partkey": (keys, None),
            "p_name": (pname, pnlen),
            "p_mfgr": (mdata[mfgr_ids - 1], mlen[mfgr_ids - 1]),
            "p_brand": (bdata[brand_idx], blen[brand_idx]),
            "p_type": (tdata[t_idx], tlen[t_idx]),
            "p_size": (rng.randint(1, 51, n).astype(np.int32), None),
            "p_container": (cdata_[c_idx], clen_[c_idx]),
            "p_retailprice": ((90000 + (keys % 20001) * 10 + (keys % 1000) * 100).astype(np.int64), None),
            "p_comment": (com, comlen),
        }
    if name == "partsupp":
        n_part = max(1, int(200000 * scale))
        n = n_part * 4
        pk = np.repeat(np.arange(1, n_part + 1, dtype=np.int64), 4)
        n_supp = max(1, int(10000 * scale))
        sk = (
            (pk + (np.tile(np.arange(4), n_part)) * (n_supp // 4 + 1)) % n_supp + 1
        ).astype(np.int64)
        com, comlen = word_sentence(rng, n, 128)
        return {
            "ps_partkey": (pk, None),
            "ps_suppkey": (sk, None),
            "ps_availqty": (rng.randint(1, 10000, n).astype(np.int32), None),
            "ps_supplycost": (_money(rng, n, 1, 1000), None),
            "ps_comment": (com, comlen),
        }
    if name == "orders":
        return _gen_orders(rng, scale)[0]
    if name == "lineitem":
        return _gen_lineitem(rng, scale, columns)
    raise KeyError(name)


def _gen_orders(rng, scale: float):
    n = max(1, int(1500000 * scale))
    n_cust = max(1, int(150000 * scale))
    keys = np.arange(1, n + 1, dtype=np.int64) * 4 - 3  # sparse keys like spec
    custkey = rng.randint(1, n_cust + 1, n).astype(np.int64)
    orderdate = rng.randint(START_DATE, END_DATE - 151, n).astype(np.int32)
    status, stlen = str_choice(rng, ["F", "O", "P"], n, 8)
    pr_data, pr_len = str_choice(rng, PRIORITIES, n, 16)
    clerk, cllen = str_choice(rng, [f"Clerk#{i:09d}" for i in range(1, 1001)], n, 16)
    com, comlen = word_sentence(rng, n, 128, 5)
    table = {
        "o_orderkey": (keys, None),
        "o_custkey": (custkey, None),
        "o_orderstatus": (status, stlen),
        "o_totalprice": (_money(rng, n, 1000, 400000), None),
        "o_orderdate": (orderdate, None),
        "o_orderpriority": (pr_data, pr_len),
        "o_clerk": (clerk, cllen),
        "o_shippriority": (np.zeros(n, np.int32), None),
        "o_comment": (com, comlen),
    }
    return table, (keys, orderdate)


def _gen_lineitem(rng, scale: float, columns=None) -> HostTable:
    """``columns``: optional subset to materialize — benchmarks at big
    scale factors skip the string columns their query never reads
    (string synthesis dominates datagen wall time)."""
    orders, (okeys, odates) = _gen_orders(np.random.RandomState(rng.randint(2**31)), scale)
    n_orders = okeys.shape[0]
    lines_per = rng.randint(1, 8, n_orders)
    n = int(lines_per.sum())
    order_idx = np.repeat(np.arange(n_orders), lines_per)
    okey = okeys[order_idx]
    odate = odates[order_idx]
    linenumber = (np.arange(n) - np.repeat(np.concatenate([[0], np.cumsum(lines_per)[:-1]]), lines_per) + 1).astype(np.int32)

    n_part = max(1, int(200000 * scale))
    n_supp = max(1, int(10000 * scale))
    partkey = rng.randint(1, n_part + 1, n).astype(np.int64)
    suppkey = rng.randint(1, n_supp + 1, n).astype(np.int64)
    quantity = rng.randint(100, 5100, n).astype(np.int64) // 100 * 100  # 1..50 at scale 2
    extendedprice = (quantity // 100) * _money(rng, n, 900, 2100) // 100 * 10
    discount = rng.randint(0, 11, n).astype(np.int64)  # 0.00..0.10 at scale 2
    tax = rng.randint(0, 9, n).astype(np.int64)
    shipdate = (odate + rng.randint(1, 122, n)).astype(np.int32)
    commitdate = (odate + rng.randint(30, 91, n)).astype(np.int32)
    receiptdate = (shipdate + rng.randint(1, 31, n)).astype(np.int32)
    want = lambda c: columns is None or c in columns
    # optional columns draw from INDEPENDENT child streams so the same
    # seed yields identical values regardless of which other columns
    # are requested (the subset must be a projection of the full table)
    child_seeds = rng.randint(2**31, size=4)
    out: HostTable = {
        "l_orderkey": (okey, None),
        "l_partkey": (partkey, None),
        "l_suppkey": (suppkey, None),
        "l_linenumber": (linenumber, None),
        "l_quantity": (quantity, None),
        "l_extendedprice": (extendedprice, None),
        "l_discount": (discount, None),
        "l_tax": (tax, None),
        "l_shipdate": (shipdate, None),
        "l_commitdate": (commitdate, None),
        "l_receiptdate": (receiptdate, None),
    }
    if want("l_returnflag"):
        # returnflag: R/A for receipts before current date else N (spec-ish)
        crng = np.random.RandomState(child_seeds[0])
        rf_idx = np.where(receiptdate < _days(1995, 6, 17), crng.randint(0, 2, n), 2)
        rf_opts, rf_len = _encode_options(RETURNFLAGS, 8)
        out["l_returnflag"] = (rf_opts[rf_idx], rf_len[rf_idx])
    if want("l_linestatus"):
        ls_idx = (shipdate > _days(1995, 6, 17)).astype(np.int64)
        ls_opts, ls_len = _encode_options(LINESTATUS, 8)
        out["l_linestatus"] = (ls_opts[ls_idx], ls_len[ls_idx])
    if want("l_shipinstruct"):
        si_data, si_len = str_choice(np.random.RandomState(child_seeds[1]), SHIPINSTRUCT, n, 32)
        out["l_shipinstruct"] = (si_data, si_len)
    if want("l_shipmode"):
        sm_data, sm_len = str_choice(np.random.RandomState(child_seeds[2]), SHIPMODES, n, 8)
        out["l_shipmode"] = (sm_data, sm_len)
    if want("l_comment"):
        com, comlen = word_sentence(np.random.RandomState(child_seeds[3]), n, 64, 3)
        out["l_comment"] = (com, comlen)
    if columns is not None:
        out = {k: v for k, v in out.items() if k in columns}
    return out


def generate_all(scale: float, seed: int = 19940204) -> Dict[str, HostTable]:
    return {name: generate_table(name, scale, seed) for name in TPCH_SCHEMAS}
