"""TPC-DS plans over the port's operators (≙ the same builders in
``blaze_tpu/tpcds/queries.py``, node for node).

q03 and q07: star schemas of broadcast joins into ``store_sales``,
two-stage aggregations and a sorted top 100.  The window family: q12,
q20 and q98 (an item's share of its class, a whole-partition ``sum``),
q53, q63 and q89 (sales against a whole-partition ``avg``), q47 and q57
(the ``avg`` window stacked under a ``lag``/``lead`` window), q36, q86
and q70 (ROLLUP through ``ExpandExec`` and ``rank`` within the parent
level), q67 (a nine-level ROLLUP ranked per category), q44 (two
``rank`` windows over one exchange, joined on the rank), q49 (three
channels double-ranked and unioned) and q51 (running ``sum`` and
``max`` around a FULL outer join).
"""

from __future__ import annotations

import datetime
from typing import Callable, Dict

from ..exprs.ir import Case, Lit, col, func, lit
from ..ops import (
    AggFunction, ExecNode, ExpandExec, FilterExec, GroupingExpr, LimitExec, ProjectExec, SortExec, SortField,
    UnionExec, WindowExec, WindowFunction,
)
from ..ops.joins import JoinType
from ..parallel.exchange import NativeShuffleExchangeExec
from ..parallel.shuffle import HashPartitioning, SinglePartitioning
from ..schema import DataType
from ..tpch.queries import broadcast_join, scalar_subquery, shuffle_join, single_sorted, two_stage_agg

f64 = DataType.float64()
i64 = DataType.int64()


def q3(t: Dict[str, ExecNode], n_parts: int) -> ExecNode:
    dt = FilterExec(t["date_dim"], col("d_moy") == lit(11))
    dt_p = ProjectExec(dt, [col("d_date_sk"), col("d_year")])
    sales = ProjectExec(t["store_sales"], [col("ss_sold_date_sk"), col("ss_item_sk"), col("ss_ext_sales_price")])
    j1 = broadcast_join(dt_p, sales, [col("d_date_sk")], [col("ss_sold_date_sk")], JoinType.INNER,
                        build_is_left=True)
    it = FilterExec(t["item"], col("i_manufact_id") == lit(128))
    it_p = ProjectExec(it, [col("i_item_sk"), col("i_brand_id"), col("i_brand")])
    j2 = broadcast_join(it_p, j1, [col("i_item_sk")], [col("ss_item_sk")], JoinType.INNER, build_is_left=True)
    agg = two_stage_agg(
        j2,
        [GroupingExpr(col("d_year"), "d_year"),
         GroupingExpr(col("i_brand_id"), "brand_id"),
         GroupingExpr(col("i_brand"), "brand")],
        [AggFunction("sum", col("ss_ext_sales_price"), "sum_agg")],
        n_parts,
    )
    return single_sorted(
        agg,
        [SortField(col("d_year")), SortField(col("sum_agg"), ascending=False), SortField(col("brand_id"))],
        fetch=100,
    )


def q7(t: Dict[str, ExecNode], n_parts: int) -> ExecNode:
    cd = FilterExec(
        t["customer_demographics"],
        (col("cd_gender") == lit("M"))
        & (col("cd_marital_status") == lit("S"))
        & (col("cd_education_status") == lit("College")),
    )
    cd_p = ProjectExec(cd, [col("cd_demo_sk")])
    dt_p = ProjectExec(FilterExec(t["date_dim"], col("d_year") == lit(2000)), [col("d_date_sk")])
    pr = FilterExec(t["promotion"], (col("p_channel_email") == lit("N")) | (col("p_channel_event") == lit("N")))
    pr_p = ProjectExec(pr, [col("p_promo_sk")])
    j = broadcast_join(cd_p, t["store_sales"], [col("cd_demo_sk")], [col("ss_cdemo_sk")], JoinType.INNER,
                       build_is_left=True)
    j = broadcast_join(dt_p, j, [col("d_date_sk")], [col("ss_sold_date_sk")], JoinType.INNER, build_is_left=True)
    j = broadcast_join(pr_p, j, [col("p_promo_sk")], [col("ss_promo_sk")], JoinType.INNER, build_is_left=True)
    it = ProjectExec(t["item"], [col("i_item_sk"), col("i_item_id")])
    j = broadcast_join(it, j, [col("i_item_sk")], [col("ss_item_sk")], JoinType.INNER, build_is_left=True)
    agg = two_stage_agg(
        j,
        [GroupingExpr(col("i_item_id"), "i_item_id")],
        [AggFunction("avg", col("ss_quantity"), "agg1"),
         AggFunction("avg", col("ss_list_price"), "agg2"),
         AggFunction("avg", col("ss_coupon_amt"), "agg3"),
         AggFunction("avg", col("ss_sales_price"), "agg4")],
        n_parts,
    )
    return single_sorted(agg, [SortField(col("i_item_id"))], fetch=100)


# ------------------------------------------------------ the window family


def q89(t: Dict[str, ExecNode], n_parts: int) -> ExecNode:
    """Monthly brand sales against the year's store average: a
    whole-partition ``avg`` and a CASE-guarded ratio filter."""
    cat_a = col("i_category").isin(lit("Books"), lit("Electronics"), lit("Sports"))
    cls_a = col("i_class").isin(lit("accessories"), lit("reference"), lit("football"))
    cat_b = col("i_category").isin(lit("Men"), lit("Jewelry"), lit("Women"))
    cls_b = col("i_class").isin(lit("shirts"), lit("birdal"), lit("dresses"))
    it = FilterExec(t["item"], (cat_a & cls_a) | (cat_b & cls_b))
    it_p = ProjectExec(it, [col("i_item_sk"), col("i_category"), col("i_class"), col("i_brand")])
    dt_p = ProjectExec(FilterExec(t["date_dim"], col("d_year") == lit(1999)), [col("d_date_sk"), col("d_moy")])
    st_p = ProjectExec(t["store"], [col("s_store_sk"), col("s_store_name"), col("s_company_name")])
    j = broadcast_join(it_p, t["store_sales"], [col("i_item_sk")], [col("ss_item_sk")], JoinType.INNER, True)
    j = broadcast_join(dt_p, j, [col("d_date_sk")], [col("ss_sold_date_sk")], JoinType.INNER, True)
    j = broadcast_join(st_p, j, [col("s_store_sk")], [col("ss_store_sk")], JoinType.INNER, True)
    agg = two_stage_agg(
        j,
        [GroupingExpr(col(c), c) for c in ("i_category", "i_class", "i_brand", "s_store_name", "s_company_name",
                                            "d_moy")],
        [AggFunction("sum", col("ss_sales_price"), "sum_sales")],
        n_parts,
    )
    part = [col("i_category"), col("i_brand"), col("s_store_name"), col("s_company_name")]
    pre = SortExec(NativeShuffleExchangeExec(agg, SinglePartitioning()), [SortField(e) for e in part])
    w = WindowExec(pre, [WindowFunction("avg", "avg_monthly_sales", col("sum_sales"), whole_partition=True)],
                   part, [])
    sum_f = col("sum_sales").cast(f64)
    avg_f = col("avg_monthly_sales").cast(f64)
    filt = FilterExec(w, Case([(avg_f != lit(0.0), func("abs", sum_f - avg_f) / avg_f)], None) > lit(0.1))
    proj = ProjectExec(
        filt,
        [col("i_category"), col("i_class"), col("i_brand"), col("s_store_name"), col("s_company_name"),
         col("d_moy"), col("sum_sales"), col("avg_monthly_sales"), sum_f - avg_f],
        ["i_category", "i_class", "i_brand", "s_store_name", "s_company_name", "d_moy", "sum_sales",
         "avg_monthly_sales", "delta"],
    )
    return single_sorted(proj, [SortField(col("delta")), SortField(col("s_store_name"))], fetch=100)


def _class_share_report(t, n_parts, *, sales, date_col, item_col, price_col):
    """q98, q20 and q12: an item's revenue share of its class, a
    whole-partition ``sum`` over i_class, per channel."""
    D = datetime.date
    dt = FilterExec(t["date_dim"], (col("d_date") >= lit(D(1999, 2, 22))) & (col("d_date") <= lit(D(1999, 3, 24))))
    dt_p = ProjectExec(dt, [col("d_date_sk")])
    it = FilterExec(t["item"], col("i_category").isin(lit("Sports"), lit("Books"), lit("Home")))
    it_p = ProjectExec(it, [col("i_item_sk"), col("i_item_id"), col("i_item_desc"), col("i_category"),
                            col("i_class"), col("i_current_price")])
    sl = ProjectExec(t[sales], [col(date_col), col(item_col), col(price_col)],
                     [date_col, item_col, "ss_ext_sales_price"])
    j = broadcast_join(dt_p, sl, [col("d_date_sk")], [col(date_col)], JoinType.INNER, True)
    j = broadcast_join(it_p, j, [col("i_item_sk")], [col(item_col)], JoinType.INNER, True)
    agg = two_stage_agg(
        j,
        [GroupingExpr(col(c), c) for c in ("i_item_id", "i_item_desc", "i_category", "i_class",
                                            "i_current_price")],
        [AggFunction("sum", col("ss_ext_sales_price"), "itemrevenue")],
        n_parts,
    )
    pre = SortExec(NativeShuffleExchangeExec(agg, SinglePartitioning()), [SortField(col("i_class"))])
    w = WindowExec(pre, [WindowFunction("sum", "class_revenue", col("itemrevenue"), whole_partition=True)],
                   [col("i_class")], [])
    ratio = (col("itemrevenue").cast(f64) * lit(100.0)) / col("class_revenue").cast(f64)
    proj = ProjectExec(
        w,
        [col("i_item_id"), col("i_item_desc"), col("i_category"), col("i_class"), col("i_current_price"),
         col("itemrevenue"), ratio],
        ["i_item_id", "i_item_desc", "i_category", "i_class", "i_current_price", "itemrevenue", "revenueratio"],
    )
    return single_sorted(proj, [SortField(col(c)) for c in ("i_category", "i_class", "i_item_id", "i_item_desc",
                                                             "revenueratio")])


def q98(t: Dict[str, ExecNode], n_parts: int) -> ExecNode:
    return _class_share_report(t, n_parts, sales="store_sales", date_col="ss_sold_date_sk",
                               item_col="ss_item_sk", price_col="ss_ext_sales_price")


def q20(t: Dict[str, ExecNode], n_parts: int) -> ExecNode:
    return _class_share_report(t, n_parts, sales="catalog_sales", date_col="cs_sold_date_sk",
                               item_col="cs_item_sk", price_col="cs_ext_sales_price")


def q12(t: Dict[str, ExecNode], n_parts: int) -> ExecNode:
    return _class_share_report(t, n_parts, sales="web_sales", date_col="ws_sold_date_sk",
                               item_col="ws_item_sk", price_col="ws_ext_sales_price")


def _manufact_window_report(t, n_parts, *, group_col, avg_name, order_first):
    """q53 and q63: a manufacturer's quarterly or monthly sales against
    its whole-partition ``avg``, a CASE-guarded ratio filter."""
    cat_a = col("i_category").isin(lit("Books"), lit("Children"), lit("Electronics"))
    cls_a = col("i_class").isin(lit("personal"), lit("self-help"), lit("reference"))
    cat_b = col("i_category").isin(lit("Women"), lit("Music"), lit("Men"))
    cls_b = col("i_class").isin(lit("accessories"), lit("classical"), lit("fragrances"))
    it_p = ProjectExec(FilterExec(t["item"], (cat_a & cls_a) | (cat_b & cls_b)),
                       [col("i_item_sk"), col("i_manufact_id")])
    dt_p = ProjectExec(FilterExec(t["date_dim"], col("d_year").isin(lit(1999), lit(2000))),
                       [col("d_date_sk"), col(group_col)])
    st_p = ProjectExec(t["store"], [col("s_store_sk")])
    j = broadcast_join(it_p, t["store_sales"], [col("i_item_sk")], [col("ss_item_sk")], JoinType.INNER, True)
    j = broadcast_join(dt_p, j, [col("d_date_sk")], [col("ss_sold_date_sk")], JoinType.INNER, True)
    j = broadcast_join(st_p, j, [col("s_store_sk")], [col("ss_store_sk")], JoinType.INNER, True)
    agg = two_stage_agg(
        j, [GroupingExpr(col("i_manufact_id"), "i_manufact_id"), GroupingExpr(col(group_col), group_col)],
        [AggFunction("sum", col("ss_sales_price"), "sum_sales")], n_parts)
    pre = SortExec(NativeShuffleExchangeExec(agg, SinglePartitioning()), [SortField(col("i_manufact_id"))])
    w = WindowExec(pre, [WindowFunction("avg", avg_name, col("sum_sales"), whole_partition=True)],
                   [col("i_manufact_id")], [])
    sum_f = col("sum_sales").cast(f64)
    avg_f = col(avg_name).cast(f64)
    filt = FilterExec(w, Case([(avg_f > lit(0.0), func("abs", sum_f - avg_f) / avg_f)], None) > lit(0.1))
    # the spec's orders: q53 avg, sum, manufacturer; q63 manufacturer, avg, sum
    order = ([avg_name, "sum_sales", "i_manufact_id"] if order_first == "avg"
             else ["i_manufact_id", avg_name, "sum_sales"])
    proj = ProjectExec(filt, [col("i_manufact_id"), col(group_col), col("sum_sales"), col(avg_name)],
                       ["i_manufact_id", group_col, "sum_sales", avg_name])
    return single_sorted(proj, [SortField(col(c)) for c in order], fetch=100)


def q53(t: Dict[str, ExecNode], n_parts: int) -> ExecNode:
    return _manufact_window_report(t, n_parts, group_col="d_qoy", avg_name="avg_quarterly_sales",
                                   order_first="avg")


def q63(t: Dict[str, ExecNode], n_parts: int) -> ExecNode:
    return _manufact_window_report(t, n_parts, group_col="d_moy", avg_name="avg_monthly_sales",
                                   order_first="manufact")


def _rollup_rank_tail(j, n_parts, *, dims, num_col, den_col, measure_name, measure_desc, measure_as_float=True):
    """q36, q86 and q70: ROLLUP over two dimensions (``ExpandExec``
    with typed null literals), lochierarchy, ``rank`` within the parent
    level and the spec's final sort.  ``dims``: [(column, its type)];
    ``den_col`` None: a plain sum, else the ratio num / den."""
    (d0, t0), (d1, t1) = dims
    null0, null1 = Lit(None, t0), Lit(None, t1)
    vals = [col(num_col)] + ([col(den_col)] if den_col else [])
    val_names = [num_col] + ([den_col] if den_col else [])
    expand = ExpandExec(
        j,
        [vals + [col(d0), col(d1), lit(0)], vals + [col(d0), null1, lit(1)], vals + [null0, null1, lit(3)]],
        val_names + [d0, d1, "g_id"],
    )
    aggs = [AggFunction("sum", col(num_col), "num_sum")] + (
        [AggFunction("sum", col(den_col), "den_sum")] if den_col else [])
    agg = two_stage_agg(expand, [GroupingExpr(col(d0), d0), GroupingExpr(col(d1), d1),
                                 GroupingExpr(col("g_id"), "g_id")], aggs, n_parts)
    # lochierarchy = grouping(d0) + grouping(d1): 0, 1, 2
    loch = Case([(col("g_id") == lit(0), lit(0)), (col("g_id") == lit(1), lit(1))], lit(2))
    if den_col:
        measure = col("num_sum").cast(f64) / col("den_sum").cast(f64)
    elif measure_as_float:
        measure = col("num_sum").cast(f64)
    else:
        measure = col("num_sum")
    proj = ProjectExec(agg, [col(d0), col(d1), loch, measure], [d0, d1, "lochierarchy", measure_name])
    single = NativeShuffleExchangeExec(proj, SinglePartitioning())
    # the parent: (lochierarchy, the level-0 dimension where it is 0)
    parent = Case([(col("lochierarchy") == lit(0), col(d0))], None)
    pre = SortExec(single, [SortField(col("lochierarchy")), SortField(parent),
                            SortField(col(measure_name), ascending=not measure_desc)])
    w = WindowExec(pre, [WindowFunction("rank", "rank_within_parent")], [col("lochierarchy"), parent],
                   [SortField(col(measure_name), ascending=not measure_desc)])
    out = SortExec(w, [SortField(col("lochierarchy"), ascending=False),
                       SortField(Case([(col("lochierarchy") == lit(0), col(d0))], None)),
                       SortField(col("rank_within_parent"))], fetch=100)
    return LimitExec(out, 100)


def _rollup_margin_report(t, n_parts, *, sales, date_col, item_col, num_col, den_col, year, extra_build=None,
                          ratio_desc=False):
    """q36 and q86: ROLLUP(i_category, i_class) over one channel."""
    dt_p = ProjectExec(FilterExec(t["date_dim"], col("d_year") == lit(year)), [col("d_date_sk")])
    it = ProjectExec(t["item"], [col("i_item_sk"), col("i_category"), col("i_class")])
    cols = [col(date_col), col(item_col), col(num_col)] + ([col(den_col)] if den_col else [])
    sl = ProjectExec(t[sales], cols + ([col("ss_store_sk")] if extra_build else []))
    j = broadcast_join(dt_p, sl, [col("d_date_sk")], [col(date_col)], JoinType.INNER, True)
    if extra_build is not None:
        build, bkey, pkey = extra_build
        j = broadcast_join(build, j, [bkey], [pkey], JoinType.INNER, True)
    j = broadcast_join(it, j, [col("i_item_sk")], [col(item_col)], JoinType.INNER, True)
    return _rollup_rank_tail(j, n_parts, dims=[("i_category", DataType.string(16)), ("i_class", DataType.string(16))],
                             num_col=num_col, den_col=den_col, measure_name="measure", measure_desc=ratio_desc)


def q36(t: Dict[str, ExecNode], n_parts: int) -> ExecNode:
    """Gross margin ROLLUP over store_sales in five states."""
    st = FilterExec(t["store"], col("s_state").isin(lit("TN"), lit("SD"), lit("AL"), lit("GA"), lit("OH")))
    st_p = ProjectExec(st, [col("s_store_sk")])
    return _rollup_margin_report(t, n_parts, sales="store_sales", date_col="ss_sold_date_sk", item_col="ss_item_sk",
                                 num_col="ss_net_profit", den_col="ss_ext_sales_price", year=2001,
                                 extra_build=(st_p, col("s_store_sk"), col("ss_store_sk")))


def q86(t: Dict[str, ExecNode], n_parts: int) -> ExecNode:
    """Net paid ROLLUP over web_sales, ranked by total, descending."""
    return _rollup_margin_report(t, n_parts, sales="web_sales", date_col="ws_sold_date_sk", item_col="ws_item_sk",
                                 num_col="ws_net_paid", den_col=None, year=2000, ratio_desc=True)


def q70(t: Dict[str, ExecNode], n_parts: int) -> ExecNode:
    """Net profit ROLLUP over store geography (state, county)."""
    dt_p = ProjectExec(FilterExec(t["date_dim"], col("d_year") == lit(2000)), [col("d_date_sk")])
    st_p = ProjectExec(t["store"], [col("s_store_sk"), col("s_state"), col("s_county")])
    sl = ProjectExec(t["store_sales"], [col("ss_sold_date_sk"), col("ss_store_sk"), col("ss_net_profit")])
    j = broadcast_join(dt_p, sl, [col("d_date_sk")], [col("ss_sold_date_sk")], JoinType.INNER, True)
    j = broadcast_join(st_p, j, [col("s_store_sk")], [col("ss_store_sk")], JoinType.INNER, True)
    return _rollup_rank_tail(j, n_parts, dims=[("s_state", DataType.string(8)), ("s_county", DataType.string(24))],
                             num_col="ss_net_profit", den_col=None, measure_name="total_sum", measure_desc=True,
                             measure_as_float=False)


def _yoy_window_report(t, n_parts, *, sales, date_col, item_col, price_col, entity_build, entity_cols, year):
    """q47 and q57: monthly sums per (brand, entity), a whole-partition
    ``avg`` within the year, then ``lag``/``lead`` over (year, month)
    in a second window over the same sort."""
    dt = FilterExec(
        t["date_dim"],
        (col("d_year") == lit(year))
        | ((col("d_year") == lit(year - 1)) & (col("d_moy") == lit(12)))
        | ((col("d_year") == lit(year + 1)) & (col("d_moy") == lit(1))),
    )
    dt_p = ProjectExec(dt, [col("d_date_sk"), col("d_year"), col("d_moy")])
    it = ProjectExec(t["item"], [col("i_item_sk"), col("i_category"), col("i_brand")])
    build, bkey, pkey = entity_build
    j = broadcast_join(dt_p, t[sales], [col("d_date_sk")], [col(date_col)], JoinType.INNER, True)
    j = broadcast_join(build, j, [bkey], [pkey], JoinType.INNER, True)
    j = broadcast_join(it, j, [col("i_item_sk")], [col(item_col)], JoinType.INNER, True)
    groupings = ([GroupingExpr(col("i_category"), "i_category"), GroupingExpr(col("i_brand"), "i_brand")]
                 + [GroupingExpr(col(c), c) for c in entity_cols]
                 + [GroupingExpr(col("d_year"), "d_year"), GroupingExpr(col("d_moy"), "d_moy")])
    agg = two_stage_agg(j, groupings, [AggFunction("sum", col(price_col), "sum_sales")], n_parts)
    part = [col("i_category"), col("i_brand")] + [col(c) for c in entity_cols]
    pre = SortExec(NativeShuffleExchangeExec(agg, SinglePartitioning()),
                   [SortField(e) for e in part] + [SortField(col("d_year")), SortField(col("d_moy"))])
    w_avg = WindowExec(pre, [WindowFunction("avg", "avg_monthly_sales", col("sum_sales"), whole_partition=True)],
                       part + [col("d_year")], [])
    # lag and lead across the months (the year is not in the partition)
    w = WindowExec(w_avg, [WindowFunction("lag", "psum", col("sum_sales"), offset=1),
                           WindowFunction("lead", "nsum", col("sum_sales"), offset=1)],
                   part, [SortField(col("d_year")), SortField(col("d_moy"))])
    sum_f = col("sum_sales").cast(f64)
    avg_f = col("avg_monthly_sales").cast(f64)
    filt = FilterExec(w, (col("d_year") == lit(year)) & (col("avg_monthly_sales") > lit(0))
                      & ((func("abs", sum_f - avg_f) / avg_f) > lit(0.1)))
    proj = ProjectExec(
        filt,
        [col("i_category"), col("i_brand")] + [col(c) for c in entity_cols]
        + [col("d_year"), col("d_moy"), col("sum_sales"), col("avg_monthly_sales"), col("psum"), col("nsum"),
           sum_f - avg_f],
        ["i_category", "i_brand"] + list(entity_cols)
        + ["d_year", "d_moy", "sum_sales", "avg_monthly_sales", "psum", "nsum", "delta"],
    )
    return single_sorted(proj, [SortField(col("delta")), SortField(col("d_moy"))], fetch=100)


def q47(t: Dict[str, ExecNode], n_parts: int) -> ExecNode:
    st_p = ProjectExec(t["store"], [col("s_store_sk"), col("s_store_name"), col("s_company_name")])
    return _yoy_window_report(t, n_parts, sales="store_sales", date_col="ss_sold_date_sk", item_col="ss_item_sk",
                              price_col="ss_sales_price", entity_build=(st_p, col("s_store_sk"), col("ss_store_sk")),
                              entity_cols=("s_store_name", "s_company_name"), year=1999)


def q57(t: Dict[str, ExecNode], n_parts: int) -> ExecNode:
    cc_p = ProjectExec(t["call_center"], [col("cc_call_center_sk"), col("cc_name")])
    return _yoy_window_report(t, n_parts, sales="catalog_sales", date_col="cs_sold_date_sk", item_col="cs_item_sk",
                              price_col="cs_sales_price",
                              entity_build=(cc_p, col("cc_call_center_sk"), col("cs_call_center_sk")),
                              entity_cols=("cc_name",), year=1999)


def _q51_cume(t, n_parts, fact, date_c, item_c, price_c, prefix):
    """One channel's per-item daily cumulative sales in 2000: a running
    ``sum`` per item, by day."""
    dt_p = ProjectExec(FilterExec(t["date_dim"], col("d_year") == lit(2000)), [col("d_date_sk"), col("d_date")])
    sl = ProjectExec(t[fact], [col(date_c), col(item_c), col(price_c)])
    j = broadcast_join(dt_p, sl, [col("d_date_sk")], [col(date_c)], JoinType.INNER, True)
    daily = two_stage_agg(j, [GroupingExpr(col(item_c), f"{prefix}_item_sk"),
                              GroupingExpr(col("d_date"), f"{prefix}_date")],
                          [AggFunction("sum", col(price_c), "sales")], n_parts)
    ex = NativeShuffleExchangeExec(daily, HashPartitioning([col(f"{prefix}_item_sk")], n_parts))
    srt = SortExec(ex, [SortField(col(f"{prefix}_item_sk")), SortField(col(f"{prefix}_date"))])
    w = WindowExec(srt, [WindowFunction("sum", f"{prefix}_cume", col("sales"))], [col(f"{prefix}_item_sk")],
                   [SortField(col(f"{prefix}_date"))])
    return ProjectExec(w, [col(f"{prefix}_item_sk"), col(f"{prefix}_date"), col(f"{prefix}_cume")])


def q51(t: Dict[str, ExecNode], n_parts: int) -> ExecNode:
    """Items whose web cumulative sales pass the store's: two running
    sums FULL outer joined by (item, day), then running maxima that
    carry each side across the join's gaps."""
    web = _q51_cume(t, n_parts, "web_sales", "ws_sold_date_sk", "ws_item_sk", "ws_sales_price", "w")
    store = _q51_cume(t, n_parts, "store_sales", "ss_sold_date_sk", "ss_item_sk", "ss_sales_price", "s")
    j = shuffle_join(web, store, [col("w_item_sk"), col("w_date")], [col("s_item_sk"), col("s_date")],
                     JoinType.FULL, n_parts, build_left=False)
    proj = ProjectExec(j, [
        Case([(col("w_item_sk").is_not_null(), col("w_item_sk"))], col("s_item_sk")).alias("item_sk"),
        Case([(col("w_date").is_not_null(), col("w_date"))], col("s_date")).alias("d_date"),
        col("w_cume"), col("s_cume")])
    ex = NativeShuffleExchangeExec(proj, HashPartitioning([col("item_sk")], n_parts))
    srt = SortExec(ex, [SortField(col("item_sk")), SortField(col("d_date"))])
    w = WindowExec(srt, [WindowFunction("max", "web_cumulative", col("w_cume")),
                         WindowFunction("max", "store_cumulative", col("s_cume"))],
                   [col("item_sk")], [SortField(col("d_date"))])
    f = FilterExec(w, col("web_cumulative") > col("store_cumulative"))
    out = ProjectExec(f, [col("item_sk"), col("d_date"), col("web_cumulative"), col("store_cumulative")])
    return single_sorted(out, [SortField(col("item_sk")), SortField(col("d_date"))], fetch=100)


def q67(t: Dict[str, ExecNode], n_parts: int) -> ExecNode:
    """An eight-dimension ROLLUP (nine levels through ``ExpandExec``)
    ranked per category, the top 100 ranks.  As in the reference,
    i_item_id and s_store_name stand in for the spec's i_product_name
    and s_store_id, which the generator does not draw."""
    dt_p = ProjectExec(FilterExec(t["date_dim"], col("d_year") == lit(2000)),
                       [col("d_date_sk"), col("d_year"), col("d_qoy"), col("d_moy")])
    st_p = ProjectExec(t["store"], [col("s_store_sk"), col("s_store_name")])
    it_p = ProjectExec(t["item"], [col("i_item_sk"), col("i_category"), col("i_class"), col("i_brand"),
                                   col("i_item_id")])
    sl = ProjectExec(t["store_sales"], [col("ss_sold_date_sk"), col("ss_store_sk"), col("ss_item_sk"),
                                        col("ss_quantity"), col("ss_sales_price")])
    j = broadcast_join(dt_p, sl, [col("d_date_sk")], [col("ss_sold_date_sk")], JoinType.INNER, True)
    j = broadcast_join(st_p, j, [col("s_store_sk")], [col("ss_store_sk")], JoinType.INNER, True)
    j = broadcast_join(it_p, j, [col("i_item_sk")], [col("ss_item_sk")], JoinType.INNER, True)
    sales = (col("ss_quantity").cast(i64) * col("ss_sales_price")).alias("val")
    base = ProjectExec(j, [col("i_category"), col("i_class"), col("i_brand"), col("i_item_id"), col("d_year"),
                           col("d_qoy"), col("d_moy"), col("s_store_name"), sales])
    s16, s32, i32 = DataType.string(16), DataType.string(32), DataType.int32()
    dims = [("i_category", s16), ("i_class", s16), ("i_brand", s32), ("i_item_id", s16), ("d_year", i32),
            ("d_qoy", i32), ("d_moy", i32), ("s_store_name", s16)]
    projections = [[col("val")] + [col(name) if k < level else Lit(None, dt_) for k, (name, dt_) in enumerate(dims)]
                   + [lit(8 - level)] for level in range(8, -1, -1)]
    expand = ExpandExec(base, projections, ["val"] + [d[0] for d in dims] + ["g_id"])
    agg = two_stage_agg(expand, [GroupingExpr(col(d[0]), d[0]) for d in dims] + [GroupingExpr(col("g_id"), "g_id")],
                        [AggFunction("sum", col("val"), "sumsales")], n_parts)
    ex = NativeShuffleExchangeExec(agg, HashPartitioning([col("i_category")], n_parts))
    srt = SortExec(ex, [SortField(col("i_category")), SortField(col("sumsales"), ascending=False)])
    w = WindowExec(srt, [WindowFunction("rank", "rk")], [col("i_category")],
                   [SortField(col("sumsales"), ascending=False)])
    f = FilterExec(w, col("rk") <= lit(100, i64))
    out = ProjectExec(f, [col(d[0]) for d in dims] + [col("g_id"), col("sumsales"), col("rk")])
    return single_sorted(out, [SortField(col("i_category")), SortField(col("rk")),
                               SortField(col("sumsales"), ascending=False)], fetch=100)


def q44(t: Dict[str, ExecNode], n_parts: int) -> ExecNode:
    """The best and worst items by average net profit at one store,
    paired by rank: two ``rank`` windows (ascending, descending) over
    one exchange of per-item averages above 90% of the store's
    null-address baseline (a decimal scalar subquery), joined on the
    rank.  As in the reference, i_item_id stands in for i_product_name
    and the generator's -1 for a null ss_addr_sk."""
    store = lit(4, i64)
    base = FilterExec(t["store_sales"], col("ss_store_sk") == store)
    per_item = two_stage_agg(ProjectExec(base, [col("ss_item_sk"), col("ss_net_profit")]),
                             [GroupingExpr(col("ss_item_sk"), "item_sk")],
                             [AggFunction("avg", col("ss_net_profit"), "rank_col")], n_parts)
    null_addr = FilterExec(t["store_sales"], (col("ss_store_sk") == store) & (col("ss_addr_sk") == lit(-1, i64)))
    thr_plan = two_stage_agg(ProjectExec(null_addr, [col("ss_net_profit")]), [],
                             [AggFunction("avg", col("ss_net_profit"), "thr")], n_parts)
    thr = scalar_subquery(thr_plan, "thr")
    keep = FilterExec(per_item, col("rank_col").cast(f64) > lit(0.9) * thr.cast(f64))
    # one single-partition exchange under both ranked branches
    single = NativeShuffleExchangeExec(keep, SinglePartitioning())

    def ranked(asc, alias_i, alias_r):
        srt = SortExec(single, [SortField(col("rank_col"), ascending=asc)])
        w = WindowExec(srt, [WindowFunction("rank", "rnk")], [], [SortField(col("rank_col"), ascending=asc)])
        f = FilterExec(w, col("rnk") <= lit(10, i64))
        return ProjectExec(f, [col("item_sk").alias(alias_i), col("rnk").alias(alias_r)])

    asc = ranked(True, "best_sk", "rnk")
    desc = ranked(False, "worst_sk", "rnk_d")
    j = shuffle_join(asc, desc, [col("rnk")], [col("rnk_d")], JoinType.INNER, n_parts, build_left=False)
    i1 = ProjectExec(t["item"], [col("i_item_sk"), col("i_item_id").alias("best_name")])
    j = broadcast_join(i1, j, [col("i_item_sk")], [col("best_sk")], JoinType.INNER, True)
    i2 = ProjectExec(t["item"], [col("i_item_sk").alias("i2_sk"), col("i_item_id").alias("worst_name")])
    j = broadcast_join(i2, j, [col("i2_sk")], [col("worst_sk")], JoinType.INNER, True)
    proj = ProjectExec(j, [col("rnk"), col("best_name"), col("worst_name")])
    return single_sorted(proj, [SortField(col("rnk")), SortField(col("best_name")), SortField(col("worst_name"))],
                         fetch=100)


def _q49_channel(t, n_parts, channel, fact, ret, s_item, s_ord, s_qty, s_paid, s_profit, r_item, r_ord, r_qty,
                 r_amt, date_c):
    """One channel of q49: per-item return ratios, each ranked.  As in
    the reference, the spec's return amount > 10000 is > 250 (the
    generator draws return amounts in [0, 300])."""
    dt = ProjectExec(FilterExec(t["date_dim"], (col("d_year") == lit(2001)) & (col("d_moy") == lit(12))),
                     [col("d_date_sk")])
    sl = FilterExec(t[fact], (col(s_profit).cast(f64) > lit(1.0)) & (col(s_paid).cast(f64) > lit(0.0))
                    & (col(s_qty) > lit(0)))
    sl = ProjectExec(sl, [col(date_c), col(s_item), col(s_ord), col(s_qty), col(s_paid)])
    j = broadcast_join(dt, sl, [col("d_date_sk")], [col(date_c)], JoinType.INNER, True)
    rt = ProjectExec(FilterExec(t[ret], col(r_amt).cast(f64) > lit(250.0)),
                     [col(r_item), col(r_ord), col(r_qty), col(r_amt)])
    j = shuffle_join(j, rt, [col(s_ord), col(s_item)], [col(r_ord), col(r_item)], JoinType.INNER, n_parts,
                     build_left=False)
    agg = two_stage_agg(j, [GroupingExpr(col(s_item), "item")],
                        [AggFunction("sum", col(r_qty), "ret_q"), AggFunction("sum", col(s_qty), "qty"),
                         AggFunction("sum", col(r_amt), "ret_amt"), AggFunction("sum", col(s_paid), "paid")],
                        n_parts)
    ratios = ProjectExec(agg, [
        col("item"),
        (col("ret_q").cast(f64) / col("qty").cast(f64)).alias("return_ratio"),
        (col("ret_amt").cast(f64) / col("paid").cast(f64)).alias("currency_ratio"),
    ])
    single = NativeShuffleExchangeExec(ratios, SinglePartitioning())
    s1 = SortExec(single, [SortField(col("return_ratio"))])
    w1 = WindowExec(s1, [WindowFunction("rank", "return_rank")], [], [SortField(col("return_ratio"))])
    s2 = SortExec(w1, [SortField(col("currency_ratio"))])
    w2 = WindowExec(s2, [WindowFunction("rank", "currency_rank")], [], [SortField(col("currency_ratio"))])
    f = FilterExec(w2, (col("return_rank") <= lit(10, i64)) | (col("currency_rank") <= lit(10, i64)))
    return ProjectExec(f, [lit(channel).alias("channel"), col("item"), col("return_ratio"), col("return_rank"),
                           col("currency_rank")])


def q49(t: Dict[str, ExecNode], n_parts: int) -> ExecNode:
    """The worst return ratios by channel: each channel's items ranked
    by quantity and by currency return ratio, rank <= 10 on either,
    the three channels unioned (their rows are distinct by channel, so
    UNION is UNION ALL)."""
    web = _q49_channel(t, n_parts, "web", "web_sales", "web_returns", "ws_item_sk", "ws_order_number",
                       "ws_quantity", "ws_net_paid", "ws_net_profit", "wr_item_sk", "wr_order_number",
                       "wr_return_quantity", "wr_return_amt", "ws_sold_date_sk")
    cat = _q49_channel(t, n_parts, "catalog", "catalog_sales", "catalog_returns", "cs_item_sk", "cs_order_number",
                       "cs_quantity", "cs_net_paid", "cs_net_profit", "cr_item_sk", "cr_order_number",
                       "cr_return_quantity", "cr_return_amount", "cs_sold_date_sk")
    store = _q49_channel(t, n_parts, "store", "store_sales", "store_returns", "ss_item_sk", "ss_ticket_number",
                         "ss_quantity", "ss_net_paid", "ss_net_profit", "sr_item_sk", "sr_ticket_number",
                         "sr_return_quantity", "sr_return_amt", "ss_sold_date_sk")
    return single_sorted(UnionExec([web, cat, store]),
                         [SortField(col("channel")), SortField(col("return_rank")), SortField(col("currency_rank"))],
                         fetch=100)


#: the window family, in the order the tests and the smoke run it
WINDOW_QUERIES = ("q12", "q20", "q98", "q53", "q63", "q89", "q47", "q57", "q36", "q86", "q70", "q67", "q44", "q49",
                  "q51")

QUERIES: Dict[str, Callable[[Dict[str, ExecNode], int], ExecNode]] = {
    "q3": q3, "q7": q7,
    "q12": q12, "q20": q20, "q98": q98, "q53": q53, "q63": q63, "q89": q89, "q47": q47, "q57": q57,
    "q36": q36, "q86": q86, "q70": q70, "q67": q67, "q44": q44, "q49": q49, "q51": q51,
}


def build_query(name: str, tables: Dict[str, ExecNode], n_parts: int = 2) -> ExecNode:
    return QUERIES[name](tables, n_parts)
