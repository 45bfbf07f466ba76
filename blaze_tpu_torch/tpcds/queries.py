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
``max`` around a FULL outer join).  The rollup and union family
(``ROLLUP_UNION_QUERIES``).  ``EXISTS_STDDEV_QUERIES``: q10, q35 and q69
(a LEFT_SEMI and two EXISTENCE joins, each flag renamed by
``RenameColumnsExec``), q38 and q87 (INTERSECT and EXCEPT as LEFT_SEMI
and LEFT_ANTI joins on three columns), q25 and q29 (sums along a
sold-returned-rebought chain), q17, q39a and q39b (``stddev_samp``) and
q84 (``concat``).  ``REPORT_QUERIES``: 31 single-fact reports, broadcast
joins into one fact table with CASE pivots (q43, q62, q99, q21), a
grouped average joined back (q6, q32, q92, q65), LEFT_SEMI joins (q6,
q41, q8) and subqueries run while the plan is built (q9, q28, q88, q90,
q61; q45's IN subquery).  ``JOINED_QUERIES``: the 26 that join two
or more fact tables, shuffle a join or join a table to itself (sales
shuffle-joined to their returns on composite keys, per-customer yearly
totals joined on the customer, channels joined on the item or the
county, q97's FULL join, q72's shuffle of all of ``inventory``).
With them the port runs all 103 of the reference's TPC-DS queries.
"""

from __future__ import annotations

import datetime
from typing import Callable, Dict

from ..exprs.ir import Case, Lit, col, func, lit
from ..ops import (
    AggFunction, ExecNode, ExpandExec, FilterExec, GroupingExpr, LimitExec, ProjectExec, RenameColumnsExec,
    SortExec, SortField, UnionExec, WindowExec, WindowFunction,
)
from ..ops.joins import JoinType
from ..parallel.exchange import NativeShuffleExchangeExec
from ..parallel.shuffle import HashPartitioning, SinglePartitioning
from ..schema import DataType
from ..tpch import queries as tpch_queries
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


def _promo_demographic_averages(t, n_parts, *, sales, cdemo_c, date_c, promo_c, item_c, measures):
    """q7 and q26: one channel's sales of 2000 to single male college
    buyers under an email or event promotion, four averages per item."""
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
    j = broadcast_join(cd_p, t[sales], [col("cd_demo_sk")], [col(cdemo_c)], JoinType.INNER, build_is_left=True)
    j = broadcast_join(dt_p, j, [col("d_date_sk")], [col(date_c)], JoinType.INNER, build_is_left=True)
    j = broadcast_join(pr_p, j, [col("p_promo_sk")], [col(promo_c)], JoinType.INNER, build_is_left=True)
    it = ProjectExec(t["item"], [col("i_item_sk"), col("i_item_id")])
    j = broadcast_join(it, j, [col("i_item_sk")], [col(item_c)], JoinType.INNER, build_is_left=True)
    agg = two_stage_agg(j, [GroupingExpr(col("i_item_id"), "i_item_id")],
                        [AggFunction("avg", col(m), f"agg{k}") for k, m in enumerate(measures, 1)], n_parts)
    return single_sorted(agg, [SortField(col("i_item_id"))], fetch=100)


def q7(t: Dict[str, ExecNode], n_parts: int) -> ExecNode:
    return _promo_demographic_averages(t, n_parts, sales="store_sales", cdemo_c="ss_cdemo_sk",
                                       date_c="ss_sold_date_sk", promo_c="ss_promo_sk", item_c="ss_item_sk",
                                       measures=("ss_quantity", "ss_list_price", "ss_coupon_amt", "ss_sales_price"))


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
    expand = ExpandExec(base, _rollup_projections([col("val")], dims), ["val"] + [d[0] for d in dims] + ["g_id"])
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


# ------------------------------------------- the rollup and union family

dec72 = DataType.decimal(7, 2)
s16 = DataType.string(16)


def _dz() -> Lit:
    """The decimal(7,2) zero."""
    return lit("0", dec72)


def _d8(e):
    """A decimal(7,2) expression widened to the unions' decimal(8,2)."""
    return e + _dz()


def _coalesce0(e):
    """COALESCE(e, 0) at decimal(8,2), for an outer join's null side."""
    return Case([(e.is_not_null(), _d8(e))], _d8(_dz()))


def _date_window(t, lo, hi, *, extra=()):
    """The d_date_sk of the days from ``lo`` to ``hi``, and the columns
    ``extra`` (q5, q77, q80, q21)."""
    dt = FilterExec(t["date_dim"], (col("d_date") >= lit(lo)) & (col("d_date") <= lit(hi)))
    return ProjectExec(dt, [col("d_date_sk")] + [col(c) for c in extra])


def _rollup_projections(measures, dims, g_type=None):
    """ROLLUP over ``dims`` ([(column, its type)]) as ``ExpandExec``
    projections, the finest level first: each keeps its leading
    dimensions, typed nulls for the rest and its grouping id."""
    n = len(dims)
    return [measures + [col(name) if k < level else Lit(None, t_) for k, (name, t_) in enumerate(dims)]
            + [lit(n - level, g_type)] for level in range(n, -1, -1)]


def q27(t: Dict[str, ExecNode], n_parts: int) -> ExecNode:
    """Store demographics averages, ROLLUP(i_item_id, s_state) through
    ``ExpandExec`` with typed null strings and a grouping id."""
    cd = FilterExec(t["customer_demographics"], (col("cd_gender") == lit("M")) & (col("cd_marital_status") == lit("S"))
                    & (col("cd_education_status") == lit("College")))
    cd_p = ProjectExec(cd, [col("cd_demo_sk")])
    dt_p = ProjectExec(FilterExec(t["date_dim"], col("d_year") == lit(2002)), [col("d_date_sk")])
    st = FilterExec(t["store"], col("s_state").isin(lit("TN"), lit("SD"), lit("AL"), lit("GA"), lit("OH")))
    st_p = ProjectExec(st, [col("s_store_sk"), col("s_state")])
    j = broadcast_join(cd_p, t["store_sales"], [col("cd_demo_sk")], [col("ss_cdemo_sk")], JoinType.INNER, True)
    j = broadcast_join(dt_p, j, [col("d_date_sk")], [col("ss_sold_date_sk")], JoinType.INNER, True)
    j = broadcast_join(st_p, j, [col("s_store_sk")], [col("ss_store_sk")], JoinType.INNER, True)
    it = ProjectExec(t["item"], [col("i_item_sk"), col("i_item_id")])
    j = broadcast_join(it, j, [col("i_item_sk")], [col("ss_item_sk")], JoinType.INNER, True)
    vals = ["ss_quantity", "ss_list_price", "ss_coupon_amt", "ss_sales_price"]
    null_s8 = Lit(None, DataType.string(8))
    passthrough = [col(v) for v in vals]
    expand = ExpandExec(j, [passthrough + [col("i_item_id"), col("s_state"), lit(0)],
                            passthrough + [col("i_item_id"), null_s8, lit(1)],
                            passthrough + [Lit(None, s16), null_s8, lit(3)]],
                        vals + ["i_item_id", "s_state", "g_id"])
    agg = two_stage_agg(expand, [GroupingExpr(col(c), c) for c in ("i_item_id", "s_state", "g_id")],
                        [AggFunction("avg", col(v), f"agg{k}") for k, v in enumerate(vals, 1)], n_parts)
    return single_sorted(agg, [SortField(col("i_item_id")), SortField(col("s_state"))], fetch=100)


def q18(t: Dict[str, ExecNode], n_parts: int) -> ExecNode:
    """Catalog demographics averages (of casts to double) for young
    buyers, ROLLUP(i_item_id, ca_county, ca_state) over five broadcast
    joins."""
    cd = FilterExec(t["customer_demographics"], (col("cd_gender") == lit("F"))
                    & (col("cd_education_status") == lit("College")))
    cd = ProjectExec(cd, [col("cd_demo_sk"), col("cd_dep_count")])
    dt = ProjectExec(FilterExec(t["date_dim"], col("d_year") == lit(2001)), [col("d_date_sk")])
    cu = FilterExec(t["customer"], (col("c_birth_year") >= lit(1966)) & (col("c_birth_year") <= lit(1980)))
    cu = ProjectExec(cu, [col("c_customer_sk"), col("c_current_addr_sk"), col("c_birth_year")])
    ca = ProjectExec(t["customer_address"], [col("ca_address_sk"), col("ca_county"), col("ca_state")])
    it = ProjectExec(t["item"], [col("i_item_sk"), col("i_item_id")])
    cs = ProjectExec(t["catalog_sales"], [col(c) for c in (
        "cs_sold_date_sk", "cs_item_sk", "cs_bill_customer_sk", "cs_bill_cdemo_sk", "cs_quantity", "cs_list_price",
        "cs_coupon_amt", "cs_sales_price", "cs_net_profit")])
    j = broadcast_join(dt, cs, [col("d_date_sk")], [col("cs_sold_date_sk")], JoinType.INNER, True)
    j = broadcast_join(cd, j, [col("cd_demo_sk")], [col("cs_bill_cdemo_sk")], JoinType.INNER, True)
    j = broadcast_join(cu, j, [col("c_customer_sk")], [col("cs_bill_customer_sk")], JoinType.INNER, True)
    j = broadcast_join(ca, j, [col("ca_address_sk")], [col("c_current_addr_sk")], JoinType.INNER, True)
    j = broadcast_join(it, j, [col("i_item_sk")], [col("cs_item_sk")], JoinType.INNER, True)
    measures = [("cs_quantity", "agg1"), ("cs_list_price", "agg2"), ("cs_coupon_amt", "agg3"),
                ("cs_sales_price", "agg4"), ("cs_net_profit", "agg5"), ("c_birth_year", "agg6"),
                ("cd_dep_count", "agg7")]
    base = ProjectExec(j, [col(src).cast(f64).alias(nm) for src, nm in measures]
                       + [col("i_item_id"), col("ca_county"), col("ca_state")])
    dims = [("i_item_id", s16), ("ca_county", DataType.string(24)), ("ca_state", DataType.string(8))]
    expand = ExpandExec(base, _rollup_projections([col(nm) for _, nm in measures], dims, i64),
                        [nm for _, nm in measures] + [d[0] for d in dims] + ["g_id"])
    agg = two_stage_agg(expand, [GroupingExpr(col(d[0]), d[0]) for d in dims] + [GroupingExpr(col("g_id"), "g_id")],
                        [AggFunction("avg", col(nm), nm) for _, nm in measures], n_parts)
    return single_sorted(agg, [SortField(col("ca_county")), SortField(col("ca_state")), SortField(col("i_item_id")),
                               SortField(col("g_id"))], fetch=100)


def q22(t: Dict[str, ExecNode], n_parts: int) -> ExecNode:
    """Average inventory on hand in 2000, ROLLUP over the product
    hierarchy (five levels).  As in the reference, i_item_id stands in
    for i_product_name."""
    dt_p = ProjectExec(FilterExec(t["date_dim"], col("d_year") == lit(2000)), [col("d_date_sk")])
    it = ProjectExec(t["item"], [col("i_item_sk"), col("i_item_id"), col("i_brand"), col("i_class"),
                                 col("i_category")])
    inv = ProjectExec(t["inventory"], [col("inv_date_sk"), col("inv_item_sk"), col("inv_quantity_on_hand")])
    j = broadcast_join(dt_p, inv, [col("d_date_sk")], [col("inv_date_sk")], JoinType.INNER, True)
    j = broadcast_join(it, j, [col("i_item_sk")], [col("inv_item_sk")], JoinType.INNER, True)
    dims = [("i_item_id", s16), ("i_brand", DataType.string(32)), ("i_class", s16), ("i_category", s16)]
    base = ProjectExec(j, [col("inv_quantity_on_hand")] + [col(d[0]) for d in dims])
    expand = ExpandExec(base, _rollup_projections([col("inv_quantity_on_hand")], dims),
                        ["inv_quantity_on_hand"] + [d[0] for d in dims] + ["g_id"])
    agg = two_stage_agg(expand, [GroupingExpr(col(d[0]), d[0]) for d in dims] + [GroupingExpr(col("g_id"), "g_id")],
                        [AggFunction("avg", col("inv_quantity_on_hand"), "qoh")], n_parts)
    return single_sorted(agg, [SortField(col(c)) for c in ("qoh", "i_item_id", "i_brand", "i_class", "i_category")],
                         fetch=100)


def _channel_report_tail(union_plan, n_parts, id_t):
    """q5, q77 and q80: ROLLUP(channel, id) over (sales, returns,
    profit), ordered by channel and id, the first 100."""
    vals = [col("sales"), col("returns"), col("profit")]
    expand = ExpandExec(union_plan, [vals + [col("channel"), col("id"), lit(0)],
                                     vals + [col("channel"), Lit(None, id_t), lit(1)],
                                     vals + [Lit(None, s16), Lit(None, id_t), lit(3)]],
                        ["sales", "returns", "profit", "channel", "id", "g_id"])
    agg = two_stage_agg(expand, [GroupingExpr(col(c), c) for c in ("channel", "id", "g_id")],
                        [AggFunction("sum", col(c), c) for c in ("sales", "returns", "profit")], n_parts)
    proj = ProjectExec(agg, [col("channel"), col("id"), col("sales"), col("returns"), col("profit")])
    return single_sorted(proj, [SortField(col("channel")), SortField(col("id"))], fetch=100)


_REPORT_COLS = ["id", "sales", "returns", "profit"]


def _tag(plan, channel):
    return ProjectExec(plan, [lit(channel, s16), col("id"), col("sales"), col("returns"), col("profit")],
                       ["channel"] + _REPORT_COLS)


def q5(t: Dict[str, ExecNode], n_parts: int) -> ExecNode:
    """Sales, returns and profit per channel and location over 14 days,
    ROLLUP(channel, id): each channel a union of its sales rows and its
    returns rows widened to decimal(8,2); web returns find their site
    through a shuffled (item, order) join back to web_sales."""
    dt = _date_window(t, datetime.date(2000, 8, 23), datetime.date(2000, 9, 5))

    def sales_rows(loc, loc_sk, loc_id, fact, date_c, fk, price, profit):
        sl = ProjectExec(t[fact], [col(date_c), col(fk), col(price), col(profit)])
        j = broadcast_join(dt, sl, [col("d_date_sk")], [col(date_c)], JoinType.INNER, True)
        j = broadcast_join(loc, j, [col(loc_sk)], [col(fk)], JoinType.INNER, True)
        return ProjectExec(j, [col(loc_id), _d8(col(price)), _d8(_dz()), _d8(col(profit))], _REPORT_COLS)

    def return_rows(j, loc_id, amt, loss):
        return ProjectExec(j, [col(loc_id), _d8(_dz()), _d8(col(amt)), _dz() - col(loss)], _REPORT_COLS)

    def returns_at(loc, loc_sk, rtab, date_c, fk, amt, loss):
        rt = ProjectExec(t[rtab], [col(date_c), col(fk), col(amt), col(loss)])
        jr = broadcast_join(dt, rt, [col("d_date_sk")], [col(date_c)], JoinType.INNER, True)
        return broadcast_join(loc, jr, [col(loc_sk)], [col(fk)], JoinType.INNER, True)

    st = ProjectExec(t["store"], [col("s_store_sk"), col("s_store_name")])
    store_rows = _tag(UnionExec([
        sales_rows(st, "s_store_sk", "s_store_name", "store_sales", "ss_sold_date_sk", "ss_store_sk",
                   "ss_ext_sales_price", "ss_net_profit"),
        return_rows(returns_at(st, "s_store_sk", "store_returns", "sr_returned_date_sk", "sr_store_sk",
                               "sr_return_amt", "sr_net_loss"), "s_store_name", "sr_return_amt", "sr_net_loss"),
    ]), "store channel")
    cp = ProjectExec(t["catalog_page"], [col("cp_catalog_page_sk"), col("cp_catalog_page_id")])
    cat_rows = _tag(UnionExec([
        sales_rows(cp, "cp_catalog_page_sk", "cp_catalog_page_id", "catalog_sales", "cs_sold_date_sk",
                   "cs_catalog_page_sk", "cs_ext_sales_price", "cs_net_profit"),
        return_rows(returns_at(cp, "cp_catalog_page_sk", "catalog_returns", "cr_returned_date_sk",
                               "cr_catalog_page_sk", "cr_return_amount", "cr_net_loss"),
                    "cp_catalog_page_id", "cr_return_amount", "cr_net_loss"),
    ]), "catalog channel")
    # web returns: the spec's LEFT JOIN to web_sales, whose null-site
    # rows the inner join to web_site then drops
    wsit = ProjectExec(t["web_site"], [col("web_site_sk"), col("web_name")])
    wr = ProjectExec(t["web_returns"], [col("wr_returned_date_sk"), col("wr_item_sk"), col("wr_order_number"),
                                        col("wr_return_amt"), col("wr_net_loss")])
    jr = broadcast_join(dt, wr, [col("d_date_sk")], [col("wr_returned_date_sk")], JoinType.INNER, True)
    ws_keys = ProjectExec(t["web_sales"], [col("ws_item_sk"), col("ws_order_number"), col("ws_web_site_sk")])
    jr = shuffle_join(jr, ws_keys, [col("wr_item_sk"), col("wr_order_number")],
                      [col("ws_item_sk"), col("ws_order_number")], JoinType.INNER, n_parts, build_left=False)
    jr = broadcast_join(wsit, jr, [col("web_site_sk")], [col("ws_web_site_sk")], JoinType.INNER, True)
    web_rows = _tag(UnionExec([
        sales_rows(wsit, "web_site_sk", "web_name", "web_sales", "ws_sold_date_sk", "ws_web_site_sk",
                   "ws_ext_sales_price", "ws_net_profit"),
        return_rows(jr, "web_name", "wr_return_amt", "wr_net_loss"),
    ]), "web channel")
    return _channel_report_tail(UnionExec([store_rows, cat_rows, web_rows]), n_parts, s16)


def q77(t: Dict[str, ExecNode], n_parts: int) -> ExecNode:
    """Per-location channel totals over 30 days, ROLLUP(channel, id):
    each channel aggregates sales and returns apart, then LEFT joins
    them (catalog's ungrouped returns total is a decimal scalar
    subquery)."""
    dt = _date_window(t, datetime.date(2000, 8, 3), datetime.date(2000, 9, 1))

    def agg_by(plan, key, sums, names):
        return two_stage_agg(plan, [GroupingExpr(col(key), key)],
                             [AggFunction("sum", col(e), n) for e, n in zip(sums, names)], n_parts)

    def tag(plan, channel, idc, sales, returns, profit):
        return ProjectExec(plan, [lit(channel, s16), col(idc), sales, returns, profit], ["channel"] + _REPORT_COLS)

    def dated(fact, date_c, cols):
        sl = ProjectExec(t[fact], [col(date_c)] + [col(c) for c in cols])
        return broadcast_join(dt, sl, [col("d_date_sk")], [col(date_c)], JoinType.INNER, True)

    st = ProjectExec(t["store"], [col("s_store_sk")])
    j = broadcast_join(st, dated("store_sales", "ss_sold_date_sk", ["ss_store_sk", "ss_ext_sales_price",
                                                                     "ss_net_profit"]),
                       [col("s_store_sk")], [col("ss_store_sk")], JoinType.INNER, True)
    ss_agg = agg_by(j, "s_store_sk", ["ss_ext_sales_price", "ss_net_profit"], ["sales", "profit"])
    jr = broadcast_join(st, dated("store_returns", "sr_returned_date_sk", ["sr_store_sk", "sr_return_amt",
                                                                           "sr_net_loss"]),
                        [col("s_store_sk")], [col("sr_store_sk")], JoinType.INNER, True)
    jr = ProjectExec(jr, [col("s_store_sk").alias("r_store_sk"), col("sr_return_amt"), col("sr_net_loss")])
    sr_agg = agg_by(jr, "r_store_sk", ["sr_return_amt", "sr_net_loss"], ["returns", "profit_loss"])
    sj = broadcast_join(sr_agg, ss_agg, [col("r_store_sk")], [col("s_store_sk")], JoinType.LEFT, False)
    store_rows = tag(sj, "store channel", "s_store_sk", _d8(col("sales")), _coalesce0(col("returns")),
                     _d8(col("profit")) - _coalesce0(col("profit_loss")))

    cs_agg = agg_by(dated("catalog_sales", "cs_sold_date_sk", ["cs_call_center_sk", "cs_ext_sales_price",
                                                                "cs_net_profit"]),
                    "cs_call_center_sk", ["cs_ext_sales_price", "cs_net_profit"], ["sales", "profit"])
    cr_tot = two_stage_agg(dated("catalog_returns", "cr_returned_date_sk", ["cr_return_amount", "cr_net_loss"]), [],
                           [AggFunction("sum", col("cr_return_amount"), "returns"),
                            AggFunction("sum", col("cr_net_loss"), "profit_loss")], n_parts)
    ret_lit, loss_lit = tpch_queries.scalar_subquery_row(cr_tot, ["returns", "profit_loss"])
    cat_rows = tag(cs_agg, "catalog channel", "cs_call_center_sk", _d8(col("sales")), _coalesce0(ret_lit),
                   _d8(col("profit")) - _coalesce0(loss_lit))

    ws_agg = agg_by(dated("web_sales", "ws_sold_date_sk", ["ws_web_page_sk", "ws_ext_sales_price", "ws_net_profit"]),
                    "ws_web_page_sk", ["ws_ext_sales_price", "ws_net_profit"], ["sales", "profit"])
    wr_agg = agg_by(dated("web_returns", "wr_returned_date_sk", ["wr_web_page_sk", "wr_return_amt", "wr_net_loss"]),
                    "wr_web_page_sk", ["wr_return_amt", "wr_net_loss"], ["returns", "profit_loss"])
    wj = broadcast_join(wr_agg, ws_agg, [col("wr_web_page_sk")], [col("ws_web_page_sk")], JoinType.LEFT, False)
    web_rows = tag(wj, "web channel", "ws_web_page_sk", _d8(col("sales")), _coalesce0(col("returns")),
                   _d8(col("profit")) - _coalesce0(col("profit_loss")))
    return _channel_report_tail(UnionExec([store_rows, cat_rows, web_rows]), n_parts, i64)


def q80(t: Dict[str, ExecNode], n_parts: int) -> ExecNode:
    """Per-item channel totals net of returns over 30 days: each sales
    line LEFT joined to its returns on (item, ticket or order), items
    over $50 on promotions without email, ROLLUP(channel, id).  As in
    the reference, the promotion filter is p_channel_email = 'N' (the
    generator draws no p_channel_tv)."""
    dt = _date_window(t, datetime.date(2000, 8, 3), datetime.date(2000, 9, 1))
    it_p = ProjectExec(FilterExec(t["item"], col("i_current_price") > lit("50", dec72)),
                       [col("i_item_sk"), col("i_item_id")])
    pr_p = ProjectExec(FilterExec(t["promotion"], col("p_channel_email") == lit("N")), [col("p_promo_sk")])

    def channel(fact, rtab, skeys, rkeys, date_c, promo_c, price_c, profit_c, ramt_c, rloss_c, name):
        sales = ProjectExec(t[fact], [col(c) for c in (date_c, skeys[0], promo_c, skeys[1], price_c, profit_c)])
        ret = ProjectExec(t[rtab], [col(c) for c in (*rkeys, ramt_c, rloss_c)])
        j = broadcast_join(dt, sales, [col("d_date_sk")], [col(date_c)], JoinType.INNER, True)
        j = broadcast_join(it_p, j, [col("i_item_sk")], [col(skeys[0])], JoinType.INNER, True)
        j = broadcast_join(pr_p, j, [col("p_promo_sk")], [col(promo_c)], JoinType.INNER, True)
        j = shuffle_join(j, ret, [col(k) for k in skeys], [col(k) for k in rkeys], JoinType.LEFT, n_parts,
                         build_left=False)
        return ProjectExec(j, [lit(name, s16), col("i_item_id"), _d8(col(price_c)), _coalesce0(col(ramt_c)),
                               _d8(col(profit_c)) - _coalesce0(col(rloss_c))], ["channel"] + _REPORT_COLS)

    return _channel_report_tail(UnionExec([
        channel("store_sales", "store_returns", ["ss_item_sk", "ss_ticket_number"],
                ["sr_item_sk", "sr_ticket_number"], "ss_sold_date_sk", "ss_promo_sk", "ss_ext_sales_price",
                "ss_net_profit", "sr_return_amt", "sr_net_loss", "store channel"),
        channel("catalog_sales", "catalog_returns", ["cs_item_sk", "cs_order_number"],
                ["cr_item_sk", "cr_order_number"], "cs_sold_date_sk", "cs_promo_sk", "cs_ext_sales_price",
                "cs_net_profit", "cr_return_amount", "cr_net_loss", "catalog channel"),
        channel("web_sales", "web_returns", ["ws_item_sk", "ws_order_number"], ["wr_item_sk", "wr_order_number"],
                "ws_sold_date_sk", "ws_promo_sk", "ws_ext_sales_price", "ws_net_profit", "wr_return_amt",
                "wr_net_loss", "web channel"),
    ]), n_parts, s16)


_Q14_CHANNELS = (
    ("store_sales", "ss_sold_date_sk", "ss_item_sk", "ss_quantity", "ss_list_price"),
    ("catalog_sales", "cs_sold_date_sk", "cs_item_sk", "cs_quantity", "cs_list_price"),
    ("web_sales", "ws_sold_date_sk", "ws_item_sk", "ws_quantity", "ws_list_price"),
)
_TRIPLE = ("i_brand_id", "i_class_id", "i_category_id")


def _q14_years(t):
    dt = FilterExec(t["date_dim"], (col("d_year") >= lit(1998)) & (col("d_year") <= lit(2000)))
    return ProjectExec(dt, [col("d_date_sk")])


def _q14_cross_items(t, n_parts):
    """Items whose (brand, class, category) ids sell in all three
    channels in 1998-2000: the INTERSECT planned as Spark plans it,
    LEFT_SEMI joins between the channels' DISTINCT triple sets."""
    def triples(fact, date_c, item_c):
        it = ProjectExec(t["item"], [col("i_item_sk")] + [col(c) for c in _TRIPLE])
        sl = ProjectExec(t[fact], [col(date_c), col(item_c)])
        j = broadcast_join(_q14_years(t), sl, [col("d_date_sk")], [col(date_c)], JoinType.INNER, True)
        j = broadcast_join(it, j, [col("i_item_sk")], [col(item_c)], JoinType.INNER, True)
        return two_stage_agg(j, [GroupingExpr(col(c), c) for c in _TRIPLE], [], n_parts)

    ss, cs, ws = (triples(f, d, i) for f, d, i, _, _ in _Q14_CHANNELS)
    keys = [col(c) for c in _TRIPLE]
    inter = broadcast_join(cs, ss, keys, keys, JoinType.LEFT_SEMI, False)
    inter = broadcast_join(ws, inter, keys, keys, JoinType.LEFT_SEMI, False)
    items = ProjectExec(t["item"], [col("i_item_sk")] + [col(c) for c in _TRIPLE])
    hot = broadcast_join(inter, items, keys, keys, JoinType.LEFT_SEMI, False)
    return ProjectExec(hot, [col("i_item_sk")])


def _q14_avg_sales(t, n_parts):
    """avg(quantity * list price) over the three channels' 1998-2000
    sales: a global ``avg`` over a union."""
    branches = []
    for fact, date_c, _, q_c, p_c in _Q14_CHANNELS:
        sl = ProjectExec(t[fact], [col(date_c), col(q_c), col(p_c)])
        j = broadcast_join(_q14_years(t), sl, [col("d_date_sk")], [col(date_c)], JoinType.INNER, True)
        branches.append(ProjectExec(j, [(col(q_c).cast(i64) * col(p_c)).alias("v")]))
    return two_stage_agg(UnionExec(branches), [], [AggFunction("avg", col("v"), "average_sales")], n_parts)


def _q14_channel_cells(t, n_parts, fact, date_c, item_c, q_c, p_c, cross, avg_lit, year, moy=11):
    """One channel's November cells of the cross-channel items, kept
    above the average."""
    dt = ProjectExec(FilterExec(t["date_dim"], (col("d_year") == lit(year)) & (col("d_moy") == lit(moy))),
                     [col("d_date_sk")])
    it = ProjectExec(t["item"], [col("i_item_sk")] + [col(c) for c in _TRIPLE])
    sl = ProjectExec(t[fact], [col(date_c), col(item_c), col(q_c), col(p_c)])
    j = broadcast_join(dt, sl, [col("d_date_sk")], [col(date_c)], JoinType.INNER, True)
    j = broadcast_join(cross, j, [col("i_item_sk")], [col(item_c)], JoinType.LEFT_SEMI, False)
    j = broadcast_join(it, j, [col("i_item_sk")], [col(item_c)], JoinType.INNER, True)
    proj = ProjectExec(j, [col(c) for c in _TRIPLE] + [(col(q_c).cast(i64) * col(p_c)).alias("v")])
    agg = two_stage_agg(proj, [GroupingExpr(col(c), c) for c in _TRIPLE],
                        [AggFunction("sum", col("v"), "sales"), AggFunction("count_star", None, "number_sales")],
                        n_parts)
    return FilterExec(agg, col("sales").cast(f64) > avg_lit.cast(f64))


def q14a(t: Dict[str, ExecNode], n_parts: int) -> ExecNode:
    """November-2002 sales of the cross-channel items above the
    three-channel average (a decimal scalar subquery), ROLLUP(channel,
    brand, class, category) over the three channels' union; one
    ``cross_items`` plan under all three.  As in the reference, the
    spec's week arithmetic is pinned to November 2002."""
    cross = _q14_cross_items(t, n_parts)
    avg_lit = scalar_subquery(_q14_avg_sales(t, n_parts), "average_sales")
    branches = []
    for (fact, date_c, item_c, q_c, p_c), name in zip(_Q14_CHANNELS, ("store", "catalog", "web")):
        cells = _q14_channel_cells(t, n_parts, fact, date_c, item_c, q_c, p_c, cross, avg_lit, 2002)
        branches.append(ProjectExec(cells, [lit(name, s16)] + [col(c) for c in _TRIPLE]
                                    + [col("sales"), col("number_sales")],
                                    ["channel", *_TRIPLE, "sales", "number_sales"]))
    i32 = DataType.int32()
    dims = [("channel", s16)] + [(c, i32) for c in _TRIPLE]
    expand = ExpandExec(UnionExec(branches), _rollup_projections([col("sales"), col("number_sales")], dims),
                        ["sales", "number_sales"] + [d[0] for d in dims] + ["g_id"])
    agg = two_stage_agg(expand, [GroupingExpr(col(d[0]), d[0]) for d in dims] + [GroupingExpr(col("g_id"), "g_id")],
                        [AggFunction("sum", col("sales"), "sum_sales"),
                         AggFunction("sum", col("number_sales"), "sum_number_sales")], n_parts)
    return single_sorted(agg, [SortField(col(c)) for c in ("channel", *_TRIPLE, "g_id")], fetch=100)


_GMT_CHANNELS = (
    ("store_sales", "ss_sold_date_sk", "ss_item_sk", "ss_addr_sk", "ss_ext_sales_price"),
    ("catalog_sales", "cs_sold_date_sk", "cs_item_sk", "cs_bill_addr_sk", "cs_ext_sales_price"),
    ("web_sales", "ws_sold_date_sk", "ws_item_sk", "ws_bill_addr_sk", "ws_ext_sales_price"),
)


def _channel_by_item(t, n_parts, sales, date_col, item_col, addr_col, price_col, *, group_col, item_filter, year,
                     moy):
    """One arm of q33, q56 and q60: a channel's sales in one month of
    the items in a filtered id set (a DISTINCT subquery, LEFT_SEMI
    joined), bought from -5 GMT addresses."""
    dt_p = ProjectExec(FilterExec(t["date_dim"], (col("d_year") == lit(year)) & (col("d_moy") == lit(moy))),
                       [col("d_date_sk")])
    ca_p = ProjectExec(FilterExec(t["customer_address"], col("ca_gmt_offset") == lit("-5", DataType.decimal(5, 2))),
                       [col("ca_address_sk")])
    ids = two_stage_agg(ProjectExec(FilterExec(t["item"], item_filter), [col(group_col)]),
                        [GroupingExpr(col(group_col), group_col)], [], n_parts)
    it = ProjectExec(t["item"], [col("i_item_sk"), col(group_col)])
    it_f = broadcast_join(ids, it, [col(group_col)], [col(group_col)], JoinType.LEFT_SEMI, False)
    sl = ProjectExec(t[sales], [col(date_col), col(item_col), col(addr_col), col(price_col)])
    j = broadcast_join(dt_p, sl, [col("d_date_sk")], [col(date_col)], JoinType.INNER, True)
    j = broadcast_join(ca_p, j, [col("ca_address_sk")], [col(addr_col)], JoinType.INNER, True)
    j = broadcast_join(it_f, j, [col("i_item_sk")], [col(item_col)], JoinType.INNER, True)
    return ProjectExec(j, [col(group_col), col(price_col)], [group_col, "sales_price"])


def _three_channel_union(t, n_parts, *, group_col, item_filter, year, moy):
    """q33, q56 and q60: the three channels unioned, then summed per
    id, the 100 smallest totals."""
    u = UnionExec([_channel_by_item(t, n_parts, *c, group_col=group_col, item_filter=item_filter, year=year, moy=moy)
                   for c in _GMT_CHANNELS])
    agg = two_stage_agg(u, [GroupingExpr(col(group_col), group_col)],
                        [AggFunction("sum", col("sales_price"), "total_sales")], n_parts)
    return single_sorted(agg, [SortField(col("total_sales")), SortField(col(group_col))], fetch=100)


def q33(t: Dict[str, ExecNode], n_parts: int) -> ExecNode:
    """Electronics manufacturers across the three channels."""
    return _three_channel_union(t, n_parts, group_col="i_manufact_id",
                                item_filter=col("i_category") == lit("Electronics"), year=1998, moy=5)


def q56(t: Dict[str, ExecNode], n_parts: int) -> ExecNode:
    """Items of three colours across the three channels."""
    return _three_channel_union(t, n_parts, group_col="i_item_id",
                                item_filter=col("i_color").isin(lit("slate"), lit("blanched"), lit("burnished")),
                                year=2000, moy=2)


def q60(t: Dict[str, ExecNode], n_parts: int) -> ExecNode:
    """Music items across the three channels."""
    return _three_channel_union(t, n_parts, group_col="i_item_id", item_filter=col("i_category") == lit("Music"),
                                year=1999, moy=9)


def q71(t: Dict[str, ExecNode], n_parts: int) -> ExecNode:
    """Brand sales by meal-time minute: November 1999 sales of the three
    channels unioned, manager 1's items, breakfast and dinner times."""
    it = ProjectExec(FilterExec(t["item"], col("i_manager_id") == lit(1)),
                     [col("i_item_sk"), col("i_brand_id"), col("i_brand")])
    parts = []
    for fact, price_c, date_c, item_c, time_c in (
            ("web_sales", "ws_ext_sales_price", "ws_sold_date_sk", "ws_item_sk", "ws_sold_time_sk"),
            ("catalog_sales", "cs_ext_sales_price", "cs_sold_date_sk", "cs_item_sk", "cs_sold_time_sk"),
            ("store_sales", "ss_ext_sales_price", "ss_sold_date_sk", "ss_item_sk", "ss_sold_time_sk")):
        dt = ProjectExec(FilterExec(t["date_dim"], (col("d_moy") == lit(11)) & (col("d_year") == lit(1999))),
                         [col("d_date_sk")])
        sl = ProjectExec(t[fact], [col(price_c).alias("ext_price"), col(date_c).alias("sold_date_sk"),
                                   col(item_c).alias("sold_item_sk"), col(time_c).alias("time_sk")])
        parts.append(broadcast_join(dt, sl, [col("d_date_sk")], [col("sold_date_sk")], JoinType.INNER, True))
    j = broadcast_join(it, UnionExec(parts), [col("i_item_sk")], [col("sold_item_sk")], JoinType.INNER, True)
    tm = FilterExec(t["time_dim"], (col("t_meal_time") == lit("breakfast")) | (col("t_meal_time") == lit("dinner")))
    tm = ProjectExec(tm, [col("t_time_sk"), col("t_hour"), col("t_minute")])
    j = broadcast_join(tm, j, [col("t_time_sk")], [col("time_sk")], JoinType.INNER, True)
    agg = two_stage_agg(j, [GroupingExpr(col("i_brand_id"), "brand_id"), GroupingExpr(col("i_brand"), "brand"),
                            GroupingExpr(col("t_hour"), "t_hour"), GroupingExpr(col("t_minute"), "t_minute")],
                        [AggFunction("sum", col("ext_price"), "ext_price")], n_parts)
    return single_sorted(agg, [SortField(col("ext_price"), ascending=False), SortField(col("brand_id"))])


def q76(t: Dict[str, ExecNode], n_parts: int) -> ExecNode:
    """Sales with a missing dimension key, per channel, year, quarter
    and category: three channels, each filtered on the generator's -1
    (the spec's NULL key) and tagged with string literals of two
    widths, unioned."""
    dt = ProjectExec(t["date_dim"], [col("d_date_sk"), col("d_year"), col("d_qoy")])
    it = ProjectExec(t["item"], [col("i_item_sk"), col("i_category")])

    def channel(fact, date_c, item_c, null_c, price_c, name):
        sl = ProjectExec(FilterExec(t[fact], col(null_c) == lit(-1, i64)), [col(date_c), col(item_c), col(price_c)])
        j = broadcast_join(dt, sl, [col("d_date_sk")], [col(date_c)], JoinType.INNER, True)
        j = broadcast_join(it, j, [col("i_item_sk")], [col(item_c)], JoinType.INNER, True)
        return ProjectExec(j, [lit(name, s16), lit(null_c, DataType.string(24)), col("d_year"), col("d_qoy"),
                               col("i_category"), col(price_c).alias("ext_sales_price")],
                           ["channel", "col_name", "d_year", "d_qoy", "i_category", "ext_sales_price"])

    u = UnionExec([
        channel("store_sales", "ss_sold_date_sk", "ss_item_sk", "ss_customer_sk", "ss_ext_sales_price", "store"),
        channel("web_sales", "ws_sold_date_sk", "ws_item_sk", "ws_promo_sk", "ws_ext_sales_price", "web"),
        channel("catalog_sales", "cs_sold_date_sk", "cs_item_sk", "cs_bill_customer_sk", "cs_ext_sales_price",
                "catalog"),
    ])
    keys = ("channel", "col_name", "d_year", "d_qoy", "i_category")
    agg = two_stage_agg(u, [GroupingExpr(col(c), c) for c in keys],
                        [AggFunction("count_star", None, "sales_cnt"),
                         AggFunction("sum", col("ext_sales_price"), "sales_amt")], n_parts)
    return single_sorted(agg, [SortField(col(c)) for c in keys], fetch=100)


_MONTHS = ("jan", "feb", "mar", "apr", "may", "jun", "jul", "aug", "sep", "oct", "nov", "dec")
_Q66_KEYS = ("w_warehouse_name", "w_warehouse_sq_ft", "w_city", "w_county", "w_state", "w_country")


def _q66_channel(t, n_parts, fact, wh_c, date_c, time_c, mode_c, qty_c, sales_c, net_c):
    """One channel of q66: a warehouse x month CASE pivot of sales and
    net in 2001, in an 8-hour sold-time window, on DHL or BARIAN.  An
    empty month is a null sum (the spec writes ELSE 0), as in the
    reference."""
    dt = ProjectExec(FilterExec(t["date_dim"], col("d_year") == lit(2001)), [col("d_date_sk"), col("d_moy")])
    tm = ProjectExec(FilterExec(t["time_dim"], (col("t_time") >= lit(30838)) & (col("t_time") <= lit(30838 + 28800))),
                     [col("t_time_sk")])
    sm = ProjectExec(FilterExec(t["ship_mode"], col("sm_carrier").isin(lit("DHL"), lit("BARIAN"))),
                     [col("sm_ship_mode_sk")])
    sl = ProjectExec(t[fact], [col(c) for c in (wh_c, date_c, time_c, mode_c, qty_c, sales_c, net_c)])
    j = broadcast_join(dt, sl, [col("d_date_sk")], [col(date_c)], JoinType.INNER, True)
    j = broadcast_join(tm, j, [col("t_time_sk")], [col(time_c)], JoinType.INNER, True)
    j = broadcast_join(sm, j, [col("sm_ship_mode_sk")], [col(mode_c)], JoinType.INNER, True)
    wh = ProjectExec(t["warehouse"], [col("w_warehouse_sk")] + [col(k) for k in _Q66_KEYS])
    j = broadcast_join(wh, j, [col("w_warehouse_sk")], [col(wh_c)], JoinType.INNER, True)
    sales, net = col(sales_c) * col(qty_c), col(net_c) * col(qty_c)
    pivots = ([Case([(col("d_moy") == lit(m), sales)], None).alias(f"{nm}_sales_v")
               for m, nm in enumerate(_MONTHS, start=1)]
              + [Case([(col("d_moy") == lit(m), net)], None).alias(f"{nm}_net_v")
                 for m, nm in enumerate(_MONTHS, start=1)])
    agg = two_stage_agg(ProjectExec(j, [col(k) for k in _Q66_KEYS] + pivots),
                        [GroupingExpr(col(k), k) for k in _Q66_KEYS],
                        [AggFunction("sum", col(f"{nm}_sales_v"), f"{nm}_sales") for nm in _MONTHS]
                        + [AggFunction("sum", col(f"{nm}_net_v"), f"{nm}_net") for nm in _MONTHS], n_parts)
    per = [(col(f"{nm}_sales").cast(f64) / col("w_warehouse_sq_ft").cast(f64)).alias(f"{nm}_sales_per_sq_foot")
           for nm in _MONTHS]
    return ProjectExec(agg, [col(k) for k in _Q66_KEYS]
                       + [lit("DHL,BARIAN").alias("ship_carriers"), lit(2001).alias("year")]
                       + [col(f"{nm}_sales") for nm in _MONTHS] + per + [col(f"{nm}_net") for nm in _MONTHS])


def q66(t: Dict[str, ExecNode], n_parts: int) -> ExecNode:
    """Warehouse monthly pivot: web and catalog unioned, summed again
    per warehouse with the per-square-foot ratios."""
    web = _q66_channel(t, n_parts, "web_sales", "ws_warehouse_sk", "ws_sold_date_sk", "ws_sold_time_sk",
                       "ws_ship_mode_sk", "ws_quantity", "ws_ext_sales_price", "ws_net_paid")
    cat = _q66_channel(t, n_parts, "catalog_sales", "cs_warehouse_sk", "cs_sold_date_sk", "cs_sold_time_sk",
                       "cs_ship_mode_sk", "cs_quantity", "cs_sales_price", "cs_net_paid_inc_tax")
    keys = list(_Q66_KEYS) + ["ship_carriers", "year"]
    measures = ([f"{nm}_sales" for nm in _MONTHS] + [f"{nm}_sales_per_sq_foot" for nm in _MONTHS]
                + [f"{nm}_net" for nm in _MONTHS])
    agg = two_stage_agg(UnionExec([web, cat]), [GroupingExpr(col(k), k) for k in keys],
                        [AggFunction("sum", col(m), m) for m in measures], n_parts)
    return single_sorted(agg, [SortField(col("w_warehouse_name"))], fetch=100)


_DOW7 = ("sun", "mon", "tue", "wed", "thu", "fri", "sat")


def _dow_ratio_projection():
    """The seven day-of-week ratios, year 1 over year 2, a null or zero
    denominator read as 1.0."""
    ratios = []
    for nm in _DOW7:
        den = col(f"{nm}2").cast(f64)
        den = Case([(den > lit(0.0), den)], lit(1.0))
        ratios.append((col(f"{nm}1").cast(f64) / den).alias(f"{nm}_ratio"))
    return ratios


def _weekly_dow_pivot(rows_plan, n_parts, group_cols, price_c):
    """Price sums per ``group_cols`` pivoted into seven day-of-week
    buckets (an empty bucket is a null sum)."""
    pivots = [Case([(col("d_dow") == lit(k), col(price_c))], None).alias(f"{nm}_v") for k, nm in enumerate(_DOW7)]
    return two_stage_agg(ProjectExec(rows_plan, [col(c) for c in group_cols] + pivots),
                         [GroupingExpr(col(c), c) for c in group_cols],
                         [AggFunction("sum", col(f"{nm}_v"), f"{nm}_sales") for nm in _DOW7], n_parts)


def _weeks_of(t, n_parts, year, name):
    """The distinct d_week_seq of ``year``, named ``name`` (q2, q59)."""
    return two_stage_agg(ProjectExec(FilterExec(t["date_dim"], col("d_year") == lit(year)),
                                     [col("d_week_seq").alias(name)]),
                         [GroupingExpr(col(name), name)], [], n_parts)


def q2(t: Dict[str, ExecNode], n_parts: int) -> ExecNode:
    """Web and catalog weekly day-of-week sales, unioned, each 2001 week
    against the same week a year on.  As in the reference, the year is
    52 weeks (the generator's week_seq starts with the data)."""
    dt = ProjectExec(t["date_dim"], [col("d_date_sk"), col("d_week_seq"), col("d_dow"), col("d_year")])
    u = UnionExec([ProjectExec(t[fact], [col(date_c).alias("sold_date_sk"), col(price_c).alias("sales_price")])
                   for fact, date_c, price_c in (("web_sales", "ws_sold_date_sk", "ws_ext_sales_price"),
                                                 ("catalog_sales", "cs_sold_date_sk", "cs_ext_sales_price"))])
    j = broadcast_join(dt, u, [col("d_date_sk")], [col("sold_date_sk")], JoinType.INNER, True)
    wk = _weekly_dow_pivot(j, n_parts, ["d_week_seq"], "sales_price")
    wk1 = broadcast_join(_weeks_of(t, n_parts, 2001, "wk1"), wk, [col("wk1")], [col("d_week_seq")],
                         JoinType.LEFT_SEMI, False)
    wk1 = ProjectExec(wk1, [col("d_week_seq")] + [col(f"{nm}_sales").alias(f"{nm}1") for nm in _DOW7])
    wk2 = broadcast_join(_weeks_of(t, n_parts, 2002, "wk2"), wk, [col("wk2")], [col("d_week_seq")],
                         JoinType.LEFT_SEMI, False)
    wk2 = ProjectExec(wk2, [(col("d_week_seq") - lit(52)).alias("wk_m52")]
                      + [col(f"{nm}_sales").alias(f"{nm}2") for nm in _DOW7])
    j2 = shuffle_join(wk1, wk2, [col("d_week_seq")], [col("wk_m52")], JoinType.INNER, n_parts, build_left=False)
    proj = ProjectExec(j2, [col("d_week_seq")] + _dow_ratio_projection())
    return single_sorted(proj, [SortField(col("d_week_seq"))], fetch=100)


def _q75_channel(t, n_parts, fact, date_c, item_c, qty_c, amt_c, rtab, r_item_c, r_key2_c, key2_c, r_qty_c, r_amt_c,
                 category):
    """One q75 channel: each sales line LEFT joined to its returns, the
    category's items, (year, ids, net quantity, net amount)."""
    dt = ProjectExec(t["date_dim"], [col("d_date_sk"), col("d_year")])
    it_p = ProjectExec(FilterExec(t["item"], col("i_category") == lit(category)),
                       [col("i_item_sk"), col("i_brand_id"), col("i_class_id"), col("i_category_id"),
                        col("i_manufact_id")])
    sl = ProjectExec(t[fact], [col(date_c), col(item_c), col(key2_c), col(qty_c), col(amt_c)])
    j = broadcast_join(dt, sl, [col("d_date_sk")], [col(date_c)], JoinType.INNER, True)
    j = broadcast_join(it_p, j, [col("i_item_sk")], [col(item_c)], JoinType.INNER, True)
    ret = ProjectExec(t[rtab], [col(r_item_c), col(r_key2_c), col(r_qty_c), col(r_amt_c)])
    j = shuffle_join(j, ret, [col(item_c), col(key2_c)], [col(r_item_c), col(r_key2_c)], JoinType.LEFT, n_parts,
                     build_left=False)
    qty_net = col(qty_c).cast(i64) - Case([(col(r_qty_c).is_not_null(), col(r_qty_c).cast(i64))], lit(0, i64))
    amt_net = _d8(col(amt_c)) - _coalesce0(col(r_amt_c))
    return ProjectExec(j, [col("d_year"), col("i_brand_id"), col("i_class_id"), col("i_category_id"),
                           col("i_manufact_id"), qty_net.alias("qty"), amt_net.alias("amt")])


def q75(t: Dict[str, ExecNode], n_parts: int) -> ExecNode:
    """Book items whose 2002 unit sales, net of returns over the three
    channels' union, fell below 90% of 2001's."""
    rows = UnionExec([
        _q75_channel(t, n_parts, "store_sales", "ss_sold_date_sk", "ss_item_sk", "ss_quantity", "ss_ext_sales_price",
                     "store_returns", "sr_item_sk", "sr_ticket_number", "ss_ticket_number", "sr_return_quantity",
                     "sr_return_amt", "Books"),
        _q75_channel(t, n_parts, "catalog_sales", "cs_sold_date_sk", "cs_item_sk", "cs_quantity",
                     "cs_ext_sales_price", "catalog_returns", "cr_item_sk", "cr_order_number", "cs_order_number",
                     "cr_return_quantity", "cr_return_amount", "Books"),
        _q75_channel(t, n_parts, "web_sales", "ws_sold_date_sk", "ws_item_sk", "ws_quantity", "ws_ext_sales_price",
                     "web_returns", "wr_item_sk", "wr_order_number", "ws_order_number", "wr_return_quantity",
                     "wr_return_amt", "Books"),
    ])
    ids = ["i_brand_id", "i_class_id", "i_category_id", "i_manufact_id"]
    agg = two_stage_agg(rows, [GroupingExpr(col(c), c) for c in ["d_year"] + ids],
                        [AggFunction("sum", col("qty"), "sales_cnt"), AggFunction("sum", col("amt"), "sales_amt")],
                        n_parts)
    curr = ProjectExec(FilterExec(agg, col("d_year") == lit(2002)),
                       [col(c) for c in ids] + [col("sales_cnt").alias("curr_cnt"), col("sales_amt").alias("curr_amt")])
    prev = ProjectExec(FilterExec(agg, col("d_year") == lit(2001)),
                       [col(c).alias(f"p_{c}") for c in ids]
                       + [col("sales_cnt").alias("prev_cnt"), col("sales_amt").alias("prev_amt")])
    j = shuffle_join(curr, prev, [col(c) for c in ids], [col(f"p_{c}") for c in ids], JoinType.INNER, n_parts,
                     build_left=False)
    f = FilterExec(j, (col("prev_cnt").cast(f64) > lit(0.0))
                   & ((col("curr_cnt").cast(f64) / col("prev_cnt").cast(f64)) < lit(0.9)))
    proj = ProjectExec(f, [lit(2001).alias("prev_year"), lit(2002).alias("year")] + [col(c) for c in ids]
                       + [(col("curr_cnt") - col("prev_cnt")).alias("sales_cnt_diff"),
                          (col("curr_amt") - col("prev_amt")).alias("sales_amt_diff")])
    return single_sorted(proj, [SortField(col("sales_cnt_diff")), SortField(col("sales_amt_diff"))], fetch=100)


def q54(t: Dict[str, ExecNode], n_parts: int) -> ExecNode:
    """Revenue segments of Women-category buyers: customers who bought
    from catalog or web in 1998 (a union), their store revenue in the
    three months after December 1998 (an int scalar subquery) at stores
    in their own county and state, in $50 segments.  As in the
    reference, the buyer window is all of 1998 and the item filter the
    category alone (the generator draws category and class apart)."""
    i32 = DataType.int32()
    u = UnionExec([ProjectExec(t[fact], [col(d).alias("sold_date_sk"), col(c).alias("customer_sk"),
                                         col(i).alias("item_sk")])
                   for fact, d, c, i in (("catalog_sales", "cs_sold_date_sk", "cs_bill_customer_sk", "cs_item_sk"),
                                         ("web_sales", "ws_sold_date_sk", "ws_bill_customer_sk", "ws_item_sk"))])
    it = ProjectExec(FilterExec(t["item"], col("i_category") == lit("Women")), [col("i_item_sk")])
    j = broadcast_join(it, u, [col("i_item_sk")], [col("item_sk")], JoinType.INNER, True)
    dt = ProjectExec(FilterExec(t["date_dim"], col("d_year") == lit(1998)), [col("d_date_sk")])
    j = broadcast_join(dt, j, [col("d_date_sk")], [col("sold_date_sk")], JoinType.INNER, True)
    cust = ProjectExec(t["customer"], [col("c_customer_sk"), col("c_current_addr_sk")])
    j = shuffle_join(cust, j, [col("c_customer_sk")], [col("customer_sk")], JoinType.INNER, n_parts, build_left=True)
    my_customers = two_stage_agg(ProjectExec(j, [col("c_customer_sk"), col("c_current_addr_sk")]),
                                 [GroupingExpr(col("c_customer_sk"), "c_customer_sk"),
                                  GroupingExpr(col("c_current_addr_sk"), "c_current_addr_sk")], [], n_parts)
    mseq = FilterExec(t["date_dim"], (col("d_year") == lit(1998)) & (col("d_moy") == lit(12)))
    mseq = two_stage_agg(ProjectExec(mseq, [col("d_month_seq").alias("ms")]), [GroupingExpr(col("ms"), "ms")], [],
                         n_parts)
    ms = scalar_subquery(mseq, "ms")
    dt2 = FilterExec(t["date_dim"], (col("d_month_seq") >= ms + lit(1)) & (col("d_month_seq") <= ms + lit(3)))
    dt2 = ProjectExec(dt2, [col("d_date_sk").alias("d2_sk")])
    sl = ProjectExec(t["store_sales"], [col("ss_sold_date_sk"), col("ss_customer_sk"), col("ss_ext_sales_price")])
    rev = broadcast_join(my_customers, sl, [col("c_customer_sk")], [col("ss_customer_sk")], JoinType.INNER, True)
    rev = broadcast_join(dt2, rev, [col("d2_sk")], [col("ss_sold_date_sk")], JoinType.INNER, True)
    ca = ProjectExec(t["customer_address"], [col("ca_address_sk"), col("ca_county"), col("ca_state")])
    rev = broadcast_join(ca, rev, [col("ca_address_sk")], [col("c_current_addr_sk")], JoinType.INNER, True)
    st = ProjectExec(t["store"], [col("s_county"), col("s_state")])
    rev = broadcast_join(st, rev, [col("s_county"), col("s_state")], [col("ca_county"), col("ca_state")],
                         JoinType.INNER, True)
    my_revenue = two_stage_agg(rev, [GroupingExpr(col("c_customer_sk"), "c_customer_sk")],
                               [AggFunction("sum", col("ss_ext_sales_price"), "revenue")], n_parts)
    seg = ProjectExec(my_revenue, [(col("revenue").cast(f64) / lit(50.0)).cast(i32).alias("segment")])
    agg = two_stage_agg(seg, [GroupingExpr(col("segment"), "segment")],
                        [AggFunction("count", lit(1), "num_customers")], n_parts)
    proj = ProjectExec(agg, [col("segment"), col("num_customers"), (col("segment") * lit(50)).alias("segment_base")])
    return single_sorted(proj, [SortField(col("segment")), SortField(col("num_customers"))], fetch=100)


def _q23_frequent_items(t, n_parts):
    """Items sold more than 4 times in one (item, month) cell in
    1998-2002: join, group, HAVING, DISTINCT.  As in the reference, the
    spec's cell is a day; the generator never repeats an item 4 times a
    day at test scales, so the cell is a month."""
    dt = ProjectExec(t["date_dim"], [col("d_date_sk"), col("d_year"), col("d_moy")])
    it = ProjectExec(t["item"], [col("i_item_sk"), col("i_item_desc")])
    sl = ProjectExec(t["store_sales"], [col("ss_sold_date_sk"), col("ss_item_sk")])
    j = broadcast_join(dt, sl, [col("d_date_sk")], [col("ss_sold_date_sk")], JoinType.INNER, True)
    j = broadcast_join(it, j, [col("i_item_sk")], [col("ss_item_sk")], JoinType.INNER, True)
    proj = ProjectExec(j, [col("i_item_sk"), func("substring", col("i_item_desc"), lit(1), lit(30)).alias("itemdesc"),
                           (col("d_year") * lit(12) + col("d_moy")).alias("cell")])
    cells = two_stage_agg(proj, [GroupingExpr(col(c), c) for c in ("i_item_sk", "itemdesc", "cell")],
                          [AggFunction("count_star", None, "cnt")], n_parts)
    hot = FilterExec(cells, col("cnt") > lit(4, i64))
    return two_stage_agg(ProjectExec(hot, [col("i_item_sk")]), [GroupingExpr(col("i_item_sk"), "i_item_sk")], [],
                         n_parts)


def _q23_best_customers(t, n_parts):
    """Customers whose lifetime store spend passes half the largest
    (a decimal ``max`` scalar subquery).  As in the reference, 50% for
    the spec's 95%, which keeps one customer on the generator's
    uniform totals."""
    def per_cust():
        sl = ProjectExec(t["store_sales"], [col("ss_customer_sk"),
                                            (col("ss_quantity").cast(i64) * col("ss_sales_price")).alias("spend")])
        return two_stage_agg(sl, [GroupingExpr(col("ss_customer_sk"), "ss_customer_sk")],
                             [AggFunction("sum", col("spend"), "csales")], n_parts)

    # the scalar subquery runs on a subtree of its own, as Spark plans it
    # apart from the main plan (the reference shares per_cust): the main
    # plan reuses no exchange output of the subquery's run
    cmax = two_stage_agg(per_cust(), [], [AggFunction("max", col("csales"), "tpcds_cmax")], n_parts)
    max_lit = scalar_subquery(cmax, "tpcds_cmax")
    best = FilterExec(per_cust(), col("csales").cast(f64) > lit(0.5) * max_lit.cast(f64))
    return ProjectExec(best, [col("ss_customer_sk")])


def _q23_month_sales(t, fact, date_c, item_c, cust_c, qty_c, price_c, hot_items, best_cust, names):
    """One channel's May-2000 sales of the frequent items to the best
    customers (two LEFT_SEMI joins on shared build sides)."""
    dt_p = ProjectExec(FilterExec(t["date_dim"], (col("d_year") == lit(2000)) & (col("d_moy") == lit(5))),
                       [col("d_date_sk")])
    fc = ProjectExec(t[fact], [col(date_c), col(item_c), col(cust_c), col(qty_c), col(price_c)])
    j = broadcast_join(dt_p, fc, [col("d_date_sk")], [col(date_c)], JoinType.INNER, True)
    j = broadcast_join(hot_items, j, [col("i_item_sk")], [col(item_c)], JoinType.LEFT_SEMI, False)
    j = broadcast_join(best_cust, j, [col("ss_customer_sk")], [col(cust_c)], JoinType.LEFT_SEMI, False)
    cols = [(col(qty_c).cast(i64) * col(price_c)).alias("sales")]
    if names:
        cu = ProjectExec(t["customer"], [col("c_customer_sk"), col("c_last_name"), col("c_first_name")])
        j = broadcast_join(cu, j, [col("c_customer_sk")], [col(cust_c)], JoinType.INNER, True)
        cols = [col("c_last_name"), col("c_first_name")] + cols
    return ProjectExec(j, cols)


def _q23_rows(t, n_parts, names):
    """The catalog and web branches' union; the two subplans built once
    and shared by both branches (the best customers' scalar subquery
    runs once)."""
    hot = _q23_frequent_items(t, n_parts)
    best = _q23_best_customers(t, n_parts)
    return UnionExec([
        _q23_month_sales(t, "catalog_sales", "cs_sold_date_sk", "cs_item_sk", "cs_bill_customer_sk", "cs_quantity",
                         "cs_list_price", hot, best, names),
        _q23_month_sales(t, "web_sales", "ws_sold_date_sk", "ws_item_sk", "ws_bill_customer_sk", "ws_quantity",
                         "ws_list_price", hot, best, names),
    ])


def q23a(t: Dict[str, ExecNode], n_parts: int) -> ExecNode:
    """May-2000 catalog and web spend of the best customers on the
    frequent items: one global total."""
    return two_stage_agg(_q23_rows(t, n_parts, names=False), [], [AggFunction("sum", col("sales"), "sum_sales")],
                         n_parts)


def q23b(t: Dict[str, ExecNode], n_parts: int) -> ExecNode:
    """q23a per customer name, the 100 largest."""
    agg = two_stage_agg(_q23_rows(t, n_parts, names=True),
                        [GroupingExpr(col("c_last_name"), "c_last_name"),
                         GroupingExpr(col("c_first_name"), "c_first_name")],
                        [AggFunction("sum", col("sales"), "sales")], n_parts)
    return single_sorted(agg, [SortField(col("sales"), ascending=False), SortField(col("c_last_name")),
                               SortField(col("c_first_name"))], fetch=100)


# ------------------------------------- EXISTS, INTERSECT and EXCEPT


def _active_customer_set(t, n_parts, sales, date_col, cust_col, *, year, moys):
    """DISTINCT customer keys of one channel in a (year, months) window:
    the correlated EXISTS subquery of q10, q35 and q69."""
    dt = FilterExec(t["date_dim"], (col("d_year") == lit(year)) & (col("d_moy") >= lit(moys[0]))
                    & (col("d_moy") <= lit(moys[1])))
    dt_p = ProjectExec(dt, [col("d_date_sk")])
    sl = ProjectExec(t[sales], [col(date_col), col(cust_col)])
    j = broadcast_join(dt_p, sl, [col("d_date_sk")], [col(date_col)], JoinType.INNER, build_is_left=True)
    return two_stage_agg(ProjectExec(j, [col(cust_col)], ["cust_sk"]), [GroupingExpr(col("cust_sk"), "cust_sk")],
                         [], n_parts)


def _exists_or_channels(t, n_parts, cust, *, year, moys, combine=None):
    """``cust`` with a store purchase (LEFT_SEMI), then a web and a
    catalog EXISTENCE flag, each renamed from ``exists#0``, combined by
    ``combine(ws, cs)`` (default OR: q10 and q35; q69 negates both): the
    plan Spark makes of a correlated (NOT) EXISTS."""
    ss_set = _active_customer_set(t, n_parts, "store_sales", "ss_sold_date_sk", "ss_customer_sk", year=year,
                                  moys=moys)
    ws_set = _active_customer_set(t, n_parts, "web_sales", "ws_sold_date_sk", "ws_bill_customer_sk", year=year,
                                  moys=moys)
    cs_set = _active_customer_set(t, n_parts, "catalog_sales", "cs_sold_date_sk", "cs_ship_customer_sk",
                                  year=year, moys=moys)
    ck = [col("c_customer_sk")]
    j = broadcast_join(ss_set, cust, [col("cust_sk")], ck, JoinType.LEFT_SEMI, build_is_left=False)
    for build, flag in ((ws_set, "exists_ws"), (cs_set, "exists_cs")):
        j = broadcast_join(build, j, [col("cust_sk")], ck, JoinType.EXISTENCE, build_is_left=False)
        j = RenameColumnsExec(j, [flag if n == "exists#0" else n for n in j.schema.names])
    if combine is None:
        combine = lambda ws, cs: ws | cs
    return FilterExec(j, combine(col("exists_ws"), col("exists_cs")))


def _county_customers(t, address_filter):
    """Customers (key, address, demographics) whose current address
    passes ``address_filter`` (LEFT_SEMI)."""
    ca_p = ProjectExec(FilterExec(t["customer_address"], address_filter), [col("ca_address_sk")])
    cust = ProjectExec(t["customer"], [col("c_customer_sk"), col("c_current_addr_sk"), col("c_current_cdemo_sk")])
    return broadcast_join(ca_p, cust, [col("ca_address_sk")], [col("c_current_addr_sk")], JoinType.LEFT_SEMI,
                          build_is_left=False)


def _demographic_counts(j, n_parts, group_cols):
    agg = two_stage_agg(j, [GroupingExpr(col(c), c) for c in group_cols],
                        [AggFunction("count_star", None, "cnt")], n_parts)
    return single_sorted(agg, [SortField(col(c)) for c in group_cols], fetch=100)


def q10(t: Dict[str, ExecNode], n_parts: int) -> ExecNode:
    """Demographic counts of three counties' customers who bought in a
    store and on the web or from the catalog in January-April 2002."""
    cust = _county_customers(t, col("ca_county").isin(lit("Williamson County"), lit("Franklin Parish"),
                                                      lit("Bronx County")))
    act = _exists_or_channels(t, n_parts, cust, year=2002, moys=(1, 4))
    j = broadcast_join(t["customer_demographics"], act, [col("cd_demo_sk")], [col("c_current_cdemo_sk")],
                       JoinType.INNER, build_is_left=True)
    return _demographic_counts(j, n_parts, ["cd_gender", "cd_marital_status", "cd_education_status",
                                            "cd_purchase_estimate", "cd_credit_rating", "cd_dep_count",
                                            "cd_dep_employed_count", "cd_dep_college_count"])


def q35(t: Dict[str, ExecNode], n_parts: int) -> ExecNode:
    """q10's customers in every state, with avg/max/sum of their
    dependant counts."""
    ca_p = ProjectExec(t["customer_address"], [col("ca_address_sk"), col("ca_state")])
    cust = ProjectExec(t["customer"], [col("c_customer_sk"), col("c_current_addr_sk"), col("c_current_cdemo_sk")])
    cust = broadcast_join(ca_p, cust, [col("ca_address_sk")], [col("c_current_addr_sk")], JoinType.INNER,
                          build_is_left=True)
    act = _exists_or_channels(t, n_parts, cust, year=2002, moys=(1, 4))
    deps = ("cd_dep_count", "cd_dep_employed_count", "cd_dep_college_count")
    cd = ProjectExec(t["customer_demographics"],
                     [col("cd_demo_sk"), col("cd_gender"), col("cd_marital_status")] + [col(c) for c in deps])
    j = broadcast_join(cd, act, [col("cd_demo_sk")], [col("c_current_cdemo_sk")], JoinType.INNER,
                       build_is_left=True)
    group_cols = ["ca_state", "cd_gender", "cd_marital_status", *deps]
    aggs = [AggFunction("count_star", None, "cnt1")]
    for i, c in enumerate(deps, 1):
        aggs += [AggFunction("avg", col(c), f"avg{i}"), AggFunction("max", col(c), f"max{i}"),
                 AggFunction("sum", col(c), f"sum{i}")]
    agg = two_stage_agg(j, [GroupingExpr(col(c), c) for c in group_cols], aggs, n_parts)
    return single_sorted(agg, [SortField(col(c)) for c in group_cols], fetch=100)


def q69(t: Dict[str, ExecNode], n_parts: int) -> ExecNode:
    """Three states' customers who bought in a store but neither on the
    web nor from the catalog in January-March 2002 (NOT EXISTS)."""
    cust = _county_customers(t, col("ca_state").isin(lit("TN"), lit("SD"), lit("AL")))
    act = _exists_or_channels(t, n_parts, cust, year=2002, moys=(1, 3), combine=lambda ws, cs: ~ws & ~cs)
    group_cols = ["cd_gender", "cd_marital_status", "cd_education_status", "cd_purchase_estimate",
                  "cd_credit_rating"]
    cd = ProjectExec(t["customer_demographics"], [col("cd_demo_sk")] + [col(c) for c in group_cols])
    j = broadcast_join(cd, act, [col("cd_demo_sk")], [col("c_current_cdemo_sk")], JoinType.INNER,
                       build_is_left=True)
    return _demographic_counts(j, n_parts, group_cols)


def _channel_customers(t, n_parts, sales, date_col, cust_col, year):
    """DISTINCT (c_last_name, c_first_name, d_date) of one channel's
    buyers in a year: q38's and q87's sets."""
    dt_p = ProjectExec(FilterExec(t["date_dim"], col("d_year") == lit(year)), [col("d_date_sk"), col("d_date")])
    cust = ProjectExec(t["customer"], [col("c_customer_sk"), col("c_last_name"), col("c_first_name")])
    sl = ProjectExec(t[sales], [col(date_col), col(cust_col)])
    j = broadcast_join(dt_p, sl, [col("d_date_sk")], [col(date_col)], JoinType.INNER, build_is_left=True)
    j = broadcast_join(cust, j, [col("c_customer_sk")], [col(cust_col)], JoinType.INNER, build_is_left=True)
    return two_stage_agg(j, [GroupingExpr(col(c), c) for c in ("c_last_name", "c_first_name", "d_date")], [],
                         n_parts)


_CHANNELS = (("store_sales", "ss_sold_date_sk", "ss_customer_sk"),
             ("catalog_sales", "cs_sold_date_sk", "cs_bill_customer_sk"),
             ("web_sales", "ws_sold_date_sk", "ws_bill_customer_sk"))


def _channel_set_count(t, n_parts, join_type):
    """count(*) of the store set LEFT_SEMI (INTERSECT) or LEFT_ANTI
    (EXCEPT) joined to the catalog set, then to the web set, on all
    three columns."""
    ss, cs, ws = (_channel_customers(t, n_parts, s, d, c, year=2000) for s, d, c in _CHANNELS)
    keys = [col("c_last_name"), col("c_first_name"), col("d_date")]
    rows = broadcast_join(cs, ss, keys, keys, join_type, build_is_left=False)
    rows = broadcast_join(ws, rows, keys, keys, join_type, build_is_left=False)
    return two_stage_agg(rows, [], [AggFunction("count_star", None, "cnt")], n_parts)


def q38(t: Dict[str, ExecNode], n_parts: int) -> ExecNode:
    """Customers (name, day) who bought in all three channels in 2000."""
    return _channel_set_count(t, n_parts, JoinType.LEFT_SEMI)


def q87(t: Dict[str, ExecNode], n_parts: int) -> ExecNode:
    """Customers (name, day) who bought in a store in 2000 but neither
    from the catalog nor on the web that day."""
    return _channel_set_count(t, n_parts, JoinType.LEFT_ANTI)


# ------------------------------------- stddev, and the chain q17 shares


def _srcandc_join(t, n_parts):
    """A store line sold in 2000, returned in 2000-2002 and bought again
    from the catalog in 2000-2002 by the returning customer, joined to
    its store and item (q17, q25 and q29)."""
    d1 = ProjectExec(FilterExec(t["date_dim"], col("d_year") == lit(2000)), [col("d_date_sk")])
    years = (col("d_year") >= lit(2000)) & (col("d_year") <= lit(2002))
    d2 = ProjectExec(FilterExec(t["date_dim"], years), [col("d_date_sk").alias("d2_sk")])
    d3 = ProjectExec(FilterExec(t["date_dim"], years), [col("d_date_sk").alias("d3_sk")])
    sl = ProjectExec(t["store_sales"], [col(c) for c in ("ss_sold_date_sk", "ss_item_sk", "ss_ticket_number",
                                                          "ss_customer_sk", "ss_store_sk", "ss_net_profit",
                                                          "ss_quantity")])
    j = broadcast_join(d1, sl, [col("d_date_sk")], [col("ss_sold_date_sk")], JoinType.INNER, build_is_left=True)
    sr = ProjectExec(t["store_returns"], [col(c) for c in ("sr_item_sk", "sr_ticket_number", "sr_customer_sk",
                                                            "sr_returned_date_sk", "sr_net_loss",
                                                            "sr_return_quantity")])
    j = shuffle_join(j, sr, [col("ss_item_sk"), col("ss_ticket_number")],
                     [col("sr_item_sk"), col("sr_ticket_number")], JoinType.INNER, n_parts, build_left=False)
    j = broadcast_join(d2, j, [col("d2_sk")], [col("sr_returned_date_sk")], JoinType.INNER, build_is_left=True)
    cs = ProjectExec(t["catalog_sales"], [col(c) for c in ("cs_sold_date_sk", "cs_bill_customer_sk", "cs_item_sk",
                                                            "cs_net_profit", "cs_quantity")])
    j = shuffle_join(j, cs, [col("sr_customer_sk"), col("sr_item_sk")],
                     [col("cs_bill_customer_sk"), col("cs_item_sk")], JoinType.INNER, n_parts, build_left=True)
    j = broadcast_join(d3, j, [col("d3_sk")], [col("cs_sold_date_sk")], JoinType.INNER, build_is_left=True)
    st = ProjectExec(t["store"], [col("s_store_sk"), col("s_store_name")])
    j = broadcast_join(st, j, [col("s_store_sk")], [col("ss_store_sk")], JoinType.INNER, build_is_left=True)
    it = ProjectExec(t["item"], [col("i_item_sk"), col("i_item_id"), col("i_item_desc")])
    return broadcast_join(it, j, [col("i_item_sk")], [col("ss_item_sk")], JoinType.INNER, build_is_left=True)


_ITEM_STORE = ("i_item_id", "i_item_desc", "s_store_name")


def _item_store_report(j, n_parts, aggs, project=None):
    """``aggs`` per (item, store), optionally projected, the first 100
    by the keys."""
    agg = two_stage_agg(j, [GroupingExpr(col(c), c) for c in _ITEM_STORE], aggs, n_parts)
    if project is not None:
        agg = ProjectExec(agg, project)
    return single_sorted(agg, [SortField(col(c)) for c in _ITEM_STORE], fetch=100)


def _sales_returns_catalog(t, n_parts, *, sums, sum_names):
    return _item_store_report(_srcandc_join(t, n_parts),
                              n_parts, [AggFunction("sum", e, n) for e, n in zip(sums, sum_names)])


def q25(t: Dict[str, ExecNode], n_parts: int) -> ExecNode:
    """The chain's store profit, return loss and catalog profit."""
    return _sales_returns_catalog(t, n_parts, sums=[col("ss_net_profit"), col("sr_net_loss"), col("cs_net_profit")],
                                  sum_names=["store_sales_profit", "store_returns_loss", "catalog_sales_profit"])


def q29(t: Dict[str, ExecNode], n_parts: int) -> ExecNode:
    """q25's quantity twin."""
    return _sales_returns_catalog(
        t, n_parts,
        sums=[col("ss_quantity").cast(i64), col("sr_return_quantity").cast(i64), col("cs_quantity").cast(i64)],
        sum_names=["store_sales_quantity", "store_returns_quantity", "catalog_sales_quantity"])


def _cov(sd, mean):
    """sd / mean where the mean is positive, else null."""
    return Case([(mean > lit(0.0), sd / mean)], None)


def q17(t: Dict[str, ExecNode], n_parts: int) -> ExecNode:
    """Count, average, sample stddev and coefficient of variation of each
    leg's quantity along the chain, per (item, store)."""
    legs = (("ss_quantity", "store"), ("sr_return_quantity", "returns"), ("cs_quantity", "catalog"))
    aggs, outs = [], [col(c) for c in _ITEM_STORE]
    for src, nm in legs:
        e = col(src).cast(i64)
        aggs += [AggFunction("count", e, f"{nm}_qty_count"), AggFunction("avg", e, f"{nm}_qty_avg"),
                 AggFunction("stddev_samp", e, f"{nm}_qty_stdev")]
        avg, sd = col(f"{nm}_qty_avg"), col(f"{nm}_qty_stdev")
        outs += [col(f"{nm}_qty_count"), avg, sd, _cov(sd, avg).alias(f"{nm}_qty_cov")]
    return _item_store_report(_srcandc_join(t, n_parts), n_parts, aggs, outs)


def _q39_monthly_cov(t, n_parts, moy):
    """Per (warehouse, item), the mean and coefficient of variation of the
    quantity on hand in one month of 2001."""
    dt = ProjectExec(FilterExec(t["date_dim"], (col("d_year") == lit(2001)) & (col("d_moy") == lit(moy))),
                     [col("d_date_sk")])
    inv = ProjectExec(t["inventory"], [col(c) for c in ("inv_date_sk", "inv_item_sk", "inv_warehouse_sk",
                                                         "inv_quantity_on_hand")])
    j = broadcast_join(dt, inv, [col("d_date_sk")], [col("inv_date_sk")], JoinType.INNER, build_is_left=True)
    wh = ProjectExec(t["warehouse"], [col("w_warehouse_sk"), col("w_warehouse_name")])
    j = broadcast_join(wh, j, [col("w_warehouse_sk")], [col("inv_warehouse_sk")], JoinType.INNER,
                       build_is_left=True)
    agg = two_stage_agg(j, [GroupingExpr(col("w_warehouse_name"), "w_warehouse_name"),
                            GroupingExpr(col("inv_item_sk"), "inv_item_sk")],
                        [AggFunction("avg", col("inv_quantity_on_hand"), "mean"),
                         AggFunction("stddev_samp", col("inv_quantity_on_hand"), "stdev")], n_parts)
    return ProjectExec(agg, [col("w_warehouse_name"), col("inv_item_sk"), col("mean"),
                             _cov(col("stdev"), col("mean")).alias("cov")])


def _q39(t, n_parts, thr1, thr2):
    """(warehouse, item) with a January cov over ``thr1`` and a February
    cov over ``thr2``, both months side by side."""
    m1 = FilterExec(_q39_monthly_cov(t, n_parts, 1), col("cov") > lit(thr1))
    m2 = FilterExec(_q39_monthly_cov(t, n_parts, 2), col("cov") > lit(thr2))
    m2 = ProjectExec(m2, [col("w_warehouse_name").alias("w2"), col("inv_item_sk").alias("i2"),
                          col("mean").alias("mean2"), col("cov").alias("cov2")])
    j = shuffle_join(m1, m2, [col("w_warehouse_name"), col("inv_item_sk")], [col("w2"), col("i2")],
                     JoinType.INNER, n_parts, build_left=False)
    proj = ProjectExec(j, [col(c) for c in ("w_warehouse_name", "inv_item_sk", "mean", "cov", "mean2", "cov2")])
    return single_sorted(proj, [SortField(col("w_warehouse_name")), SortField(col("inv_item_sk"))], fetch=100)


def q39a(t: Dict[str, ExecNode], n_parts: int) -> ExecNode:
    """cov > 0.7 in both January and February (the generator's stand-in
    for the spec's 1)."""
    return _q39(t, n_parts, 0.7, 0.7)


def q39b(t: Dict[str, ExecNode], n_parts: int) -> ExecNode:
    """q39a with January's cut at 0.85 (the spec's 1.5, scaled)."""
    return _q39(t, n_parts, 0.85, 0.7)


# ---------------------------------------------------------------- concat


def q84(t: Dict[str, ExecNode], n_parts: int) -> ExecNode:
    """Customers of one city in an income range, one row per store
    return of their demographics, named ``concat(last, ", ", first)``."""
    ca = ProjectExec(FilterExec(t["customer_address"], col("ca_city") == lit("Midway")), [col("ca_address_sk")])
    cust = ProjectExec(t["customer"], [col(c) for c in ("c_customer_id", "c_first_name", "c_last_name",
                                                         "c_current_addr_sk", "c_current_cdemo_sk",
                                                         "c_current_hdemo_sk")])
    j = broadcast_join(ca, cust, [col("ca_address_sk")], [col("c_current_addr_sk")], JoinType.INNER,
                       build_is_left=True)
    ib = FilterExec(t["income_band"], (col("ib_lower_bound") >= lit(38128))
                    & (col("ib_upper_bound") <= lit(38128 + 50000)))
    ib = ProjectExec(ib, [col("ib_income_band_sk")])
    hd = ProjectExec(t["household_demographics"], [col("hd_demo_sk"), col("hd_income_band_sk")])
    hd = broadcast_join(ib, hd, [col("ib_income_band_sk")], [col("hd_income_band_sk")], JoinType.INNER,
                        build_is_left=True)
    hd = ProjectExec(hd, [col("hd_demo_sk")])
    j = broadcast_join(hd, j, [col("hd_demo_sk")], [col("c_current_hdemo_sk")], JoinType.INNER, build_is_left=True)
    cd = ProjectExec(t["customer_demographics"], [col("cd_demo_sk")])
    j = broadcast_join(cd, j, [col("cd_demo_sk")], [col("c_current_cdemo_sk")], JoinType.INNER, build_is_left=True)
    sr = ProjectExec(t["store_returns"], [col("sr_cdemo_sk")])
    j = shuffle_join(j, sr, [col("cd_demo_sk")], [col("sr_cdemo_sk")], JoinType.INNER, n_parts, build_left=True)
    proj = ProjectExec(j, [col("c_customer_id").alias("customer_id"),
                           func("concat", col("c_last_name"), lit(", "), col("c_first_name")).alias("customername")])
    return single_sorted(proj, [SortField(col("customer_id"))], fetch=100)


# ------------------------------------------------ single-fact reports


def _november_item_sums(t, n_parts, *, year, manager, groups, measure):
    """One manager's items' store sales in November of ``year``, summed
    per (d_year, ``groups``) ([(item column, name)]): q42, q52, q55."""
    dt = FilterExec(t["date_dim"], (col("d_moy") == lit(11)) & (col("d_year") == lit(year)))
    dt_p = ProjectExec(dt, [col("d_date_sk"), col("d_year")])
    sales = ProjectExec(t["store_sales"], [col("ss_sold_date_sk"), col("ss_item_sk"), col("ss_ext_sales_price")])
    j = broadcast_join(dt_p, sales, [col("d_date_sk")], [col("ss_sold_date_sk")], JoinType.INNER, True)
    it = FilterExec(t["item"], col("i_manager_id") == lit(manager))
    it_p = ProjectExec(it, [col("i_item_sk")] + [col(c) for c, _ in groups])
    j = broadcast_join(it_p, j, [col("i_item_sk")], [col("ss_item_sk")], JoinType.INNER, True)
    return two_stage_agg(j, [GroupingExpr(col("d_year"), "d_year")] + [GroupingExpr(col(c), n) for c, n in groups],
                         [AggFunction("sum", col("ss_ext_sales_price"), measure)], n_parts)


def q42(t: Dict[str, ExecNode], n_parts: int) -> ExecNode:
    """Category sales of manager 1's items in November 2000."""
    agg = _november_item_sums(t, n_parts, year=2000, manager=1,
                              groups=[("i_category_id", "category_id"), ("i_category", "category")], measure="sum_agg")
    return single_sorted(agg, [SortField(col("sum_agg"), ascending=False), SortField(col("d_year")),
                               SortField(col("category_id")), SortField(col("category"))], fetch=100)


def _brand_report(t, n_parts, *, year, manager, order_year_first):
    agg = _november_item_sums(t, n_parts, year=year, manager=manager,
                              groups=[("i_brand_id", "brand_id"), ("i_brand", "brand")], measure="ext_price")
    sort = [SortField(col("ext_price"), ascending=False), SortField(col("brand_id"))]
    return single_sorted(agg, ([SortField(col("d_year"))] if order_year_first else []) + sort, fetch=100)


def q52(t: Dict[str, ExecNode], n_parts: int) -> ExecNode:
    """Brand sales of manager 1's items in November 2000."""
    return _brand_report(t, n_parts, year=2000, manager=1, order_year_first=True)


def q55(t: Dict[str, ExecNode], n_parts: int) -> ExecNode:
    """Brand sales of manager 28's items in November 1999."""
    return _brand_report(t, n_parts, year=1999, manager=28, order_year_first=False)


def q19(t: Dict[str, ExecNode], n_parts: int) -> ExecNode:
    """Brand revenue from buyers whose zip differs from the store's: five
    broadcast joins, then a filter on two ``substring`` results."""
    dt_p = ProjectExec(FilterExec(t["date_dim"], (col("d_moy") == lit(11)) & (col("d_year") == lit(1998))),
                       [col("d_date_sk")])
    it = FilterExec(t["item"], col("i_manager_id") == lit(8))
    it_p = ProjectExec(it, [col(c) for c in ("i_item_sk", "i_brand_id", "i_brand", "i_manufact_id", "i_manufact")])
    cust = ProjectExec(t["customer"], [col("c_customer_sk"), col("c_current_addr_sk")])
    addr = ProjectExec(t["customer_address"], [col("ca_address_sk"), col("ca_zip")])
    st = ProjectExec(t["store"], [col("s_store_sk"), col("s_zip")])
    j = broadcast_join(dt_p, t["store_sales"], [col("d_date_sk")], [col("ss_sold_date_sk")], JoinType.INNER, True)
    j = broadcast_join(it_p, j, [col("i_item_sk")], [col("ss_item_sk")], JoinType.INNER, True)
    j = broadcast_join(cust, j, [col("c_customer_sk")], [col("ss_customer_sk")], JoinType.INNER, True)
    j = broadcast_join(addr, j, [col("ca_address_sk")], [col("c_current_addr_sk")], JoinType.INNER, True)
    j = broadcast_join(st, j, [col("s_store_sk")], [col("ss_store_sk")], JoinType.INNER, True)
    zip5 = lambda c: func("substring", col(c), lit(1), lit(5))
    j = FilterExec(j, zip5("ca_zip") != zip5("s_zip"))
    agg = two_stage_agg(j, [GroupingExpr(col("i_brand_id"), "brand_id"), GroupingExpr(col("i_brand"), "brand"),
                            GroupingExpr(col("i_manufact_id"), "manufact_id"),
                            GroupingExpr(col("i_manufact"), "manufact")],
                        [AggFunction("sum", col("ss_ext_sales_price"), "ext_price")], n_parts)
    return single_sorted(agg, [SortField(col("ext_price"), ascending=False)]
                         + [SortField(col(c)) for c in ("brand", "brand_id", "manufact_id", "manufact")], fetch=100)


_DOW_NAMES = ("sun", "mon", "tue", "wed", "thu", "fri", "sat")


def q43(t: Dict[str, ExecNode], n_parts: int) -> ExecNode:
    """Each store's sales of 2000 by weekday: seven sums of a CASE that
    keeps one weekday's price, in one aggregation."""
    dt_p = ProjectExec(FilterExec(t["date_dim"], col("d_year") == lit(2000)), [col("d_date_sk"), col("d_dow")])
    st_p = ProjectExec(t["store"], [col("s_store_sk"), col("s_store_name")])
    sl = ProjectExec(t["store_sales"], [col("ss_sold_date_sk"), col("ss_store_sk"), col("ss_sales_price")])
    j = broadcast_join(dt_p, sl, [col("d_date_sk")], [col("ss_sold_date_sk")], JoinType.INNER, True)
    j = broadcast_join(st_p, j, [col("s_store_sk")], [col("ss_store_sk")], JoinType.INNER, True)
    pivots = [Case([(col("d_dow") == lit(k), col("ss_sales_price"))], None).alias(f"{name}_v")
              for k, name in enumerate(_DOW_NAMES)]
    agg = two_stage_agg(ProjectExec(j, [col("s_store_name")] + pivots),
                        [GroupingExpr(col("s_store_name"), "s_store_name")],
                        [AggFunction("sum", col(f"{name}_v"), f"{name}_sales") for name in _DOW_NAMES], n_parts)
    return single_sorted(agg, [SortField(col("s_store_name"))], fetch=100)


def q96(t: Dict[str, ExecNode], n_parts: int) -> ExecNode:
    """Store sales at 20:30-20:59 to households with 7 dependants at
    the stores named "ese": one count."""
    td_p = ProjectExec(FilterExec(t["time_dim"], (col("t_hour") == lit(20)) & (col("t_minute") >= lit(30))),
                       [col("t_time_sk")])
    hd_p = ProjectExec(FilterExec(t["household_demographics"], col("hd_dep_count") == lit(7)), [col("hd_demo_sk")])
    st_p = ProjectExec(FilterExec(t["store"], col("s_store_name") == lit("ese")), [col("s_store_sk")])
    sales = ProjectExec(t["store_sales"], [col("ss_sold_time_sk"), col("ss_hdemo_sk"), col("ss_store_sk")])
    j = broadcast_join(td_p, sales, [col("t_time_sk")], [col("ss_sold_time_sk")], JoinType.INNER, True)
    j = broadcast_join(hd_p, j, [col("hd_demo_sk")], [col("ss_hdemo_sk")], JoinType.INNER, True)
    j = broadcast_join(st_p, j, [col("s_store_sk")], [col("ss_store_sk")], JoinType.INNER, True)
    return two_stage_agg(j, [], [AggFunction("count_star", None, "cnt")], n_parts)


def q26(t: Dict[str, ExecNode], n_parts: int) -> ExecNode:
    """q7 over ``catalog_sales``."""
    return _promo_demographic_averages(t, n_parts, sales="catalog_sales", cdemo_c="cs_bill_cdemo_sk",
                                       date_c="cs_sold_date_sk", promo_c="cs_promo_sk", item_c="cs_item_sk",
                                       measures=("cs_quantity", "cs_list_price", "cs_coupon_amt", "cs_sales_price"))


def q6(t: Dict[str, ExecNode], n_parts: int) -> ExecNode:
    """States with at least 10 buyers, in May 2000, of items priced over
    1.2 times their category's average (the correlated subquery as a
    grouped ``avg`` joined back, then a LEFT_SEMI join)."""
    cat_avg = two_stage_agg(ProjectExec(t["item"], [col("i_category").alias("avg_cat"), col("i_current_price")]),
                            [GroupingExpr(col("avg_cat"), "avg_cat")],
                            [AggFunction("avg", col("i_current_price"), "cat_avg_price")], n_parts)
    it = ProjectExec(t["item"], [col("i_item_sk"), col("i_category"), col("i_current_price")])
    it = broadcast_join(cat_avg, it, [col("avg_cat")], [col("i_category")], JoinType.INNER, True)
    it = FilterExec(it, col("i_current_price").cast(f64) > lit(1.2) * col("cat_avg_price").cast(f64))
    it = ProjectExec(it, [col("i_item_sk")])
    dt = ProjectExec(FilterExec(t["date_dim"], (col("d_year") == lit(2000)) & (col("d_moy") == lit(5))),
                     [col("d_date_sk")])
    sl = ProjectExec(t["store_sales"], [col("ss_sold_date_sk"), col("ss_item_sk"), col("ss_customer_sk")])
    j = broadcast_join(dt, sl, [col("d_date_sk")], [col("ss_sold_date_sk")], JoinType.INNER, True)
    j = broadcast_join(it, j, [col("i_item_sk")], [col("ss_item_sk")], JoinType.LEFT_SEMI, False)
    cu = ProjectExec(t["customer"], [col("c_customer_sk"), col("c_current_addr_sk")])
    j = broadcast_join(cu, j, [col("c_customer_sk")], [col("ss_customer_sk")], JoinType.INNER, True)
    ca = ProjectExec(t["customer_address"], [col("ca_address_sk"), col("ca_state")])
    j = broadcast_join(ca, j, [col("ca_address_sk")], [col("c_current_addr_sk")], JoinType.INNER, True)
    agg = two_stage_agg(j, [GroupingExpr(col("ca_state"), "state")], [AggFunction("count_star", None, "cnt")],
                        n_parts)
    f = FilterExec(agg, col("cnt") >= lit(10, i64))
    return single_sorted(f, [SortField(col("cnt")), SortField(col("state"))], fetch=100)


def q41(t: Dict[str, ExecNode], n_parts: int) -> ExecNode:
    """Distinct items of the manufacturers that make a qualifying (color,
    units) item: the correlated EXISTS as a LEFT_SEMI join on the string
    i_manufact.  As in the reference, i_item_id stands in for the
    spec's i_product_name."""
    combo = ((col("i_color").isin(lit("powder"), lit("navy")) & col("i_units").isin(lit("Each"), lit("Dozen")))
             | (col("i_color").isin(lit("peach"), lit("saddle")) & col("i_units").isin(lit("Case"), lit("Pallet"))))
    manufacts = two_stage_agg(ProjectExec(FilterExec(t["item"], combo), [col("i_manufact")]),
                              [GroupingExpr(col("i_manufact"), "i_manufact")], [], n_parts)
    i1 = FilterExec(t["item"], (col("i_manufact_id") >= lit(50)) & (col("i_manufact_id") <= lit(120)))
    i1 = ProjectExec(i1, [col("i_manufact"), col("i_item_id")])
    j = broadcast_join(manufacts, i1, [col("i_manufact")], [col("i_manufact")], JoinType.LEFT_SEMI, False)
    distinct = two_stage_agg(ProjectExec(j, [col("i_item_id")]), [GroupingExpr(col("i_item_id"), "i_item_id")], [],
                             n_parts)
    return single_sorted(distinct, [SortField(col("i_item_id"))], fetch=100)


#: q13's and q48's bands, sized to the generator's prices as in the
#: reference: (marital status, education, sales price lo, hi, dependants)
Q13_BANDS = [("M", "Advanced Degree", 0, 150, 3), ("S", "College", 0, 100, 1), ("W", "2 yr Degree", 50, 200, 1)]
#: (states, net profit lo, hi)
Q13_STATE_BANDS = [(("TN", "SD", "AL"), 0, 1000), (("GA", "OH", "TN"), -500, 500), (("SD", "AL", "GA"), -1000, 250)]


def _band_preds(*, price_col):
    """q13's and q48's OR of demographic bands AND OR of address bands."""
    demo = None
    for ms, ed, lo, hi, dep in Q13_BANDS:
        p = ((col("cd_marital_status") == lit(ms)) & (col("cd_education_status") == lit(ed))
             & (col(price_col) >= lit(str(lo), dec72)) & (col(price_col) <= lit(str(hi), dec72))
             & (col("hd_dep_count") == lit(dep)))
        demo = p if demo is None else (demo | p)
    geo = None
    for states, lo, hi in Q13_STATE_BANDS:
        p = (col("ca_state").isin(*[lit(s) for s in states]) & (col("ss_net_profit") >= lit(str(lo), dec72))
             & (col("ss_net_profit") <= lit(str(hi), dec72)))
        geo = p if geo is None else (geo | p)
    return demo & geo


def _q13_source(t) -> ExecNode:
    """The store sales of 2001 joined to store, demographics, household
    and address, filtered by the bands (q13, q48)."""
    dt_p = ProjectExec(FilterExec(t["date_dim"], col("d_year") == lit(2001)), [col("d_date_sk")])
    st_p = ProjectExec(t["store"], [col("s_store_sk")])
    cd_p = ProjectExec(t["customer_demographics"],
                       [col("cd_demo_sk"), col("cd_marital_status"), col("cd_education_status")])
    hd_p = ProjectExec(t["household_demographics"], [col("hd_demo_sk"), col("hd_dep_count")])
    ca_p = ProjectExec(t["customer_address"], [col("ca_address_sk"), col("ca_state")])
    j = broadcast_join(dt_p, t["store_sales"], [col("d_date_sk")], [col("ss_sold_date_sk")], JoinType.INNER, True)
    j = broadcast_join(st_p, j, [col("s_store_sk")], [col("ss_store_sk")], JoinType.INNER, True)
    j = broadcast_join(cd_p, j, [col("cd_demo_sk")], [col("ss_cdemo_sk")], JoinType.INNER, True)
    j = broadcast_join(hd_p, j, [col("hd_demo_sk")], [col("ss_hdemo_sk")], JoinType.INNER, True)
    j = broadcast_join(ca_p, j, [col("ca_address_sk")], [col("ss_addr_sk")], JoinType.INNER, True)
    return FilterExec(j, _band_preds(price_col="ss_sales_price"))


def q13(t: Dict[str, ExecNode], n_parts: int) -> ExecNode:
    """Averages of the banded store sales, and their count."""
    return two_stage_agg(_q13_source(t), [],
                         [AggFunction("avg", col("ss_quantity"), "avg_qty"),
                          AggFunction("avg", col("ss_ext_sales_price"), "avg_ext_sales"),
                          AggFunction("avg", col("ss_ext_discount_amt"), "avg_ext_disc"),
                          AggFunction("count_star", None, "cnt")], n_parts)


def q48(t: Dict[str, ExecNode], n_parts: int) -> ExecNode:
    """The banded store sales' total quantity."""
    return two_stage_agg(_q13_source(t), [], [AggFunction("sum", col("ss_quantity"), "qty_sum")], n_parts)


#: q15's zip prefixes, sized to the generator's zips as in the reference
Q15_ZIPS = ("85669", "86197", "88274", "83405", "86475", "35000", "35137", "60031", "60062", "60093")


def q15(t: Dict[str, ExecNode], n_parts: int) -> ExecNode:
    """Catalog sales of a quarter per buyer zip, kept where the zip's
    prefix is listed, the state is one of three or the price is over
    250."""
    dt_p = ProjectExec(FilterExec(t["date_dim"], (col("d_qoy") == lit(2)) & (col("d_year") == lit(2001))),
                       [col("d_date_sk")])
    cust = ProjectExec(t["customer"], [col("c_customer_sk"), col("c_current_addr_sk")])
    ca_p = ProjectExec(t["customer_address"], [col("ca_address_sk"), col("ca_zip"), col("ca_state")])
    sl = ProjectExec(t["catalog_sales"], [col("cs_sold_date_sk"), col("cs_bill_customer_sk"), col("cs_sales_price")])
    j = broadcast_join(dt_p, sl, [col("d_date_sk")], [col("cs_sold_date_sk")], JoinType.INNER, True)
    j = broadcast_join(cust, j, [col("c_customer_sk")], [col("cs_bill_customer_sk")], JoinType.INNER, True)
    j = broadcast_join(ca_p, j, [col("ca_address_sk")], [col("c_current_addr_sk")], JoinType.INNER, True)
    zip5 = func("substring", col("ca_zip"), lit(1), lit(5))
    keep = (zip5.isin(*[lit(z) for z in Q15_ZIPS]) | col("ca_state").isin(lit("TN"), lit("GA"), lit("OH"))
            | (col("cs_sales_price") > lit("250", dec72)))
    agg = two_stage_agg(FilterExec(j, keep), [GroupingExpr(col("ca_zip"), "ca_zip")],
                        [AggFunction("sum", col("cs_sales_price"), "sum_price")], n_parts)
    return single_sorted(agg, [SortField(col("ca_zip"))], fetch=100)


def q45(t: Dict[str, ExecNode], n_parts: int) -> ExecNode:
    """Web sales of a quarter per buyer (zip, city), kept where the zip's
    prefix is listed or the item is one of an IN subquery's (run while
    the plan is built, its ids entering as literals)."""
    dt = ProjectExec(FilterExec(t["date_dim"], (col("d_year") == lit(2000)) & (col("d_qoy") == lit(2))),
                     [col("d_date_sk")])
    hot = FilterExec(t["item"], col("i_item_sk").isin(*[lit(v, i64) for v in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29)]))
    hot_ids = tpch_queries.collect_columns(ProjectExec(hot, [col("i_item_id")]), ["i_item_id"])["i_item_id"]
    ws = ProjectExec(t["web_sales"], [col("ws_sold_date_sk"), col("ws_item_sk"), col("ws_bill_customer_sk"),
                                      col("ws_sales_price")])
    j = broadcast_join(dt, ws, [col("d_date_sk")], [col("ws_sold_date_sk")], JoinType.INNER, True)
    cu = ProjectExec(t["customer"], [col("c_customer_sk"), col("c_current_addr_sk")])
    j = broadcast_join(cu, j, [col("c_customer_sk")], [col("ws_bill_customer_sk")], JoinType.INNER, True)
    ca = ProjectExec(t["customer_address"], [col("ca_address_sk"), col("ca_city"), col("ca_zip")])
    j = broadcast_join(ca, j, [col("ca_address_sk")], [col("c_current_addr_sk")], JoinType.INNER, True)
    it = ProjectExec(t["item"], [col("i_item_sk"), col("i_item_id")])
    j = broadcast_join(it, j, [col("i_item_sk")], [col("ws_item_sk")], JoinType.INNER, True)
    pred = func("substring", col("ca_zip"), lit(1), lit(5)).isin(
        *[lit(z) for z in ("35000", "35137", "60031", "60062", "60093")])
    if hot_ids:
        pred = pred | col("i_item_id").isin(*[lit(v) for v in hot_ids])
    agg = two_stage_agg(FilterExec(j, pred), [GroupingExpr(col("ca_zip"), "ca_zip"),
                                              GroupingExpr(col("ca_city"), "ca_city")],
                        [AggFunction("sum", col("ws_sales_price"), "sum_sales")], n_parts)
    return single_sorted(agg, [SortField(col("ca_zip")), SortField(col("ca_city"))], fetch=100)


#: q8's zips and its HAVING count of preferred customers, sized to the
#: generator as in the reference (the spec lists 400 zips, count > 10)
Q8_ZIPS = ("35000", "35137", "35274", "35411", "35548", "35685", "60031", "60062", "60093", "60124")
Q8_MIN_PREFERRED = 2


def q8(t: Dict[str, ExecNode], n_parts: int) -> ExecNode:
    """Store net profit of a quarter at the stores whose 2-digit zip
    prefix is one of (listed zips INTERSECT zips with enough preferred
    customers): a LEFT_SEMI join on a ``substring`` key."""
    zip5 = func("substring", col("ca_zip"), lit(1), lit(5))
    a1 = two_stage_agg(ProjectExec(FilterExec(t["customer_address"], zip5.isin(*[lit(z) for z in Q8_ZIPS])),
                                   [zip5], ["zip5"]),
                       [GroupingExpr(col("zip5"), "zip5")], [], n_parts)
    cust_p = ProjectExec(FilterExec(t["customer"], col("c_preferred_cust_flag") == lit("Y")),
                         [col("c_current_addr_sk")])
    ca_p = ProjectExec(t["customer_address"], [col("ca_address_sk"), col("ca_zip")])
    cj = broadcast_join(ca_p, cust_p, [col("ca_address_sk")], [col("c_current_addr_sk")], JoinType.INNER, True)
    a2 = FilterExec(two_stage_agg(ProjectExec(cj, [zip5], ["zip5"]), [GroupingExpr(col("zip5"), "zip5")],
                                  [AggFunction("count_star", None, "cnt")], n_parts),
                    col("cnt") >= lit(Q8_MIN_PREFERRED))
    inter = broadcast_join(ProjectExec(a2, [col("zip5")]), a1, [col("zip5")], [col("zip5")], JoinType.LEFT_SEMI,
                           False)
    prefixes = two_stage_agg(ProjectExec(inter, [func("substring", col("zip5"), lit(1), lit(2))], ["zip2"]),
                             [GroupingExpr(col("zip2"), "zip2")], [], n_parts)
    st = broadcast_join(prefixes, ProjectExec(t["store"], [col("s_store_sk"), col("s_store_name"), col("s_zip")]),
                        [col("zip2")], [func("substring", col("s_zip"), lit(1), lit(2))], JoinType.LEFT_SEMI, False)
    dt_p = ProjectExec(FilterExec(t["date_dim"], (col("d_year") == lit(1998)) & (col("d_qoy") == lit(2))),
                       [col("d_date_sk")])
    sl = ProjectExec(t["store_sales"], [col("ss_sold_date_sk"), col("ss_store_sk"), col("ss_net_profit")])
    j = broadcast_join(dt_p, sl, [col("d_date_sk")], [col("ss_sold_date_sk")], JoinType.INNER, True)
    j = broadcast_join(ProjectExec(st, [col("s_store_sk"), col("s_store_name")]), j, [col("s_store_sk")],
                       [col("ss_store_sk")], JoinType.INNER, True)
    agg = two_stage_agg(j, [GroupingExpr(col("s_store_name"), "s_store_name")],
                        [AggFunction("sum", col("ss_net_profit"), "net_profit")], n_parts)
    return single_sorted(agg, [SortField(col("s_store_name"))], fetch=100)


def q91(t: Dict[str, ExecNode], n_parts: int) -> ExecNode:
    """Catalog return losses of 2000 per (call center, marital status,
    education) of two demographic bands.  As in the reference, a year
    and no gmt filter (the spec's month is empty at test scales)."""
    dt = ProjectExec(FilterExec(t["date_dim"], col("d_year") == lit(2000)), [col("d_date_sk")])
    cr = ProjectExec(t["catalog_returns"], [col("cr_returned_date_sk"), col("cr_returning_customer_sk"),
                                            col("cr_call_center_sk"), col("cr_net_loss")])
    j = broadcast_join(dt, cr, [col("d_date_sk")], [col("cr_returned_date_sk")], JoinType.INNER, True)
    cc = ProjectExec(t["call_center"], [col("cc_call_center_sk"), col("cc_name")])
    j = broadcast_join(cc, j, [col("cc_call_center_sk")], [col("cr_call_center_sk")], JoinType.INNER, True)
    cu = ProjectExec(t["customer"], [col("c_customer_sk"), col("c_current_cdemo_sk"), col("c_current_addr_sk")])
    j = broadcast_join(cu, j, [col("c_customer_sk")], [col("cr_returning_customer_sk")], JoinType.INNER, True)
    cd = FilterExec(t["customer_demographics"],
                    ((col("cd_marital_status") == lit("M")) & (col("cd_education_status") == lit("Unknown")))
                    | ((col("cd_marital_status") == lit("W"))
                       & (col("cd_education_status") == lit("Advanced Degree"))))
    cd = ProjectExec(cd, [col("cd_demo_sk"), col("cd_marital_status"), col("cd_education_status")])
    j = broadcast_join(cd, j, [col("cd_demo_sk")], [col("c_current_cdemo_sk")], JoinType.INNER, True)
    agg = two_stage_agg(j, [GroupingExpr(col(c), c) for c in ("cc_name", "cd_marital_status", "cd_education_status")],
                        [AggFunction("sum", col("cr_net_loss"), "returns_loss")], n_parts)
    return single_sorted(agg, [SortField(col("returns_loss"), ascending=False), SortField(col("cc_name"))], fetch=100)


def _ticket_report(t, n_parts, *, dom_ranges, buy_potentials, cnt_lo, cnt_hi, dep_vehicle_ratio, order_by):
    """q34 and q73: lines per (ticket, customer) on some days of
    1999-2001 in four counties' stores, a HAVING range, then the
    customer joined: an aggregation below a join."""
    dt_pred = None
    for lo, hi in dom_ranges:
        rng_p = (col("d_dom") >= lit(lo)) & (col("d_dom") <= lit(hi))
        dt_pred = rng_p if dt_pred is None else (dt_pred | rng_p)
    dt = FilterExec(t["date_dim"], dt_pred & col("d_year").isin(lit(1999), lit(2000), lit(2001)))
    dt_p = ProjectExec(dt, [col("d_date_sk")])
    hd_pred = None
    for bp in buy_potentials:
        p = col("hd_buy_potential") == lit(bp)
        hd_pred = p if hd_pred is None else (hd_pred | p)
    # the spec's CASE WHEN vehicle_count > 0 THEN dep / vehicle END > ratio
    # (the > 0 guard makes the CASE's one arm unconditional)
    hd_pred = hd_pred & (col("hd_vehicle_count") > lit(0))
    hd_pred = hd_pred & (col("hd_dep_count").cast(f64) / col("hd_vehicle_count").cast(f64) > lit(dep_vehicle_ratio))
    hd_p = ProjectExec(FilterExec(t["household_demographics"], hd_pred), [col("hd_demo_sk")])
    st = FilterExec(t["store"], col("s_county").isin(lit("Williamson County"), lit("Franklin Parish"),
                                                     lit("Bronx County"), lit("Orange County")))
    st_p = ProjectExec(st, [col("s_store_sk")])
    j = broadcast_join(dt_p, t["store_sales"], [col("d_date_sk")], [col("ss_sold_date_sk")], JoinType.INNER, True)
    j = broadcast_join(hd_p, j, [col("hd_demo_sk")], [col("ss_hdemo_sk")], JoinType.INNER, True)
    j = broadcast_join(st_p, j, [col("s_store_sk")], [col("ss_store_sk")], JoinType.INNER, True)
    agg = two_stage_agg(j, [GroupingExpr(col("ss_ticket_number"), "ss_ticket_number"),
                            GroupingExpr(col("ss_customer_sk"), "ss_customer_sk")],
                        [AggFunction("count_star", None, "cnt")], n_parts)
    having = FilterExec(agg, (col("cnt") >= lit(cnt_lo)) & (col("cnt") <= lit(cnt_hi)))
    cust = ProjectExec(t["customer"], [col(c) for c in ("c_customer_sk", "c_salutation", "c_first_name",
                                                         "c_last_name", "c_preferred_cust_flag")])
    j2 = broadcast_join(cust, having, [col("c_customer_sk")], [col("ss_customer_sk")], JoinType.INNER, True)
    return single_sorted(j2, order_by)


def q34(t: Dict[str, ExecNode], n_parts: int) -> ExecNode:
    """Tickets of 15-20 lines on days 1-3 and 25-28."""
    return _ticket_report(t, n_parts, dom_ranges=[(1, 3), (25, 28)], buy_potentials=[">10000", "Unknown"],
                          cnt_lo=15, cnt_hi=20, dep_vehicle_ratio=1.2,
                          order_by=[SortField(col("c_last_name")), SortField(col("c_first_name")),
                                    SortField(col("c_salutation")),
                                    SortField(col("c_preferred_cust_flag"), ascending=False),
                                    SortField(col("ss_ticket_number"))])


def q73(t: Dict[str, ExecNode], n_parts: int) -> ExecNode:
    """Tickets of 1-5 lines on days 1-2."""
    return _ticket_report(t, n_parts, dom_ranges=[(1, 2)], buy_potentials=[">10000", "Unknown"], cnt_lo=1, cnt_hi=5,
                          dep_vehicle_ratio=1.0,
                          order_by=[SortField(col("cnt"), ascending=False), SortField(col("c_last_name"))])


def _city_ticket_report(t, n_parts, *, dow, cities, hd_pred, amt_c, extra_sums):
    """q46 and q68: weekend tickets at two cities' stores whose buyer
    now lives in another city than the one bought from, with sums per
    ticket."""
    dt_p = ProjectExec(FilterExec(t["date_dim"], col("d_dow").isin(*[lit(d) for d in dow])), [col("d_date_sk")])
    st_p = ProjectExec(FilterExec(t["store"], col("s_city").isin(*[lit(c) for c in cities])), [col("s_store_sk")])
    hd_p = ProjectExec(FilterExec(t["household_demographics"], hd_pred), [col("hd_demo_sk")])
    ca = ProjectExec(t["customer_address"], [col("ca_address_sk"), col("ca_city")])
    sum_cols = list(dict.fromkeys([amt_c] + extra_sums))
    sl = ProjectExec(t["store_sales"], [col(c) for c in ("ss_sold_date_sk", "ss_store_sk", "ss_hdemo_sk",
                                                          "ss_addr_sk", "ss_ticket_number", "ss_customer_sk")]
                     + [col(c) for c in sum_cols])
    j = broadcast_join(dt_p, sl, [col("d_date_sk")], [col("ss_sold_date_sk")], JoinType.INNER, True)
    j = broadcast_join(st_p, j, [col("s_store_sk")], [col("ss_store_sk")], JoinType.INNER, True)
    j = broadcast_join(hd_p, j, [col("hd_demo_sk")], [col("ss_hdemo_sk")], JoinType.INNER, True)
    j = broadcast_join(ca, j, [col("ca_address_sk")], [col("ss_addr_sk")], JoinType.INNER, True)
    proj = ProjectExec(j, [col("ss_ticket_number"), col("ss_customer_sk"), col("ca_city").alias("bought_city")]
                       + [col(c) for c in sum_cols])
    sums = [AggFunction("sum", col(amt_c), "amt")] + [AggFunction("sum", col(c), f"sum_{c}") for c in extra_sums]
    agg = two_stage_agg(proj, [GroupingExpr(col(c), c) for c in ("ss_ticket_number", "ss_customer_sk",
                                                                 "bought_city")], sums, n_parts)
    cu = ProjectExec(t["customer"], [col("c_customer_sk"), col("c_last_name"), col("c_first_name"),
                                     col("c_current_addr_sk")])
    j2 = broadcast_join(cu, agg, [col("c_customer_sk")], [col("ss_customer_sk")], JoinType.INNER, True)
    ca2 = ProjectExec(t["customer_address"], [col("ca_address_sk").alias("cur_addr_sk"),
                                              col("ca_city").alias("current_city")])
    j2 = broadcast_join(ca2, j2, [col("cur_addr_sk")], [col("c_current_addr_sk")], JoinType.INNER, True)
    f = FilterExec(j2, ~(col("current_city") == col("bought_city")))
    proj2 = ProjectExec(f, [col(c) for c in ("c_last_name", "c_first_name", "current_city", "bought_city",
                                              "ss_ticket_number", "amt")] + [col(f"sum_{c}") for c in extra_sums])
    return single_sorted(proj2, [SortField(col(c)) for c in ("c_last_name", "c_first_name", "current_city",
                                                             "bought_city", "ss_ticket_number")], fetch=100)


def q46(t: Dict[str, ExecNode], n_parts: int) -> ExecNode:
    """Coupon and net profit sums per ticket."""
    return _city_ticket_report(t, n_parts, dow=(6, 0), cities=("Midway", "Fairview"),
                               hd_pred=(col("hd_dep_count") == lit(4)) | (col("hd_vehicle_count") == lit(3)),
                               amt_c="ss_coupon_amt", extra_sums=["ss_net_profit"])


def q68(t: Dict[str, ExecNode], n_parts: int) -> ExecNode:
    """Sales and list price sums per ticket."""
    return _city_ticket_report(t, n_parts, dow=(6, 0), cities=("Midway", "Fairview"),
                               hd_pred=(col("hd_dep_count") == lit(5)) | (col("hd_vehicle_count") == lit(3)),
                               amt_c="ss_ext_sales_price", extra_sums=["ss_ext_list_price"])


def q79(t: Dict[str, ExecNode], n_parts: int) -> ExecNode:
    """Monday tickets of 1998-2000 per store city, coupon and profit
    sums.  As in the reference, every store qualifies (the generator
    draws no s_number_employees)."""
    dt = FilterExec(t["date_dim"], (col("d_dow") == lit(1)) & (col("d_year") >= lit(1998))
                    & (col("d_year") <= lit(2000)))
    dt_p = ProjectExec(dt, [col("d_date_sk")])
    hd = FilterExec(t["household_demographics"], (col("hd_dep_count") == lit(6)) | (col("hd_vehicle_count") > lit(2)))
    hd_p = ProjectExec(hd, [col("hd_demo_sk")])
    st_p = ProjectExec(t["store"], [col("s_store_sk"), col("s_city")])
    sl = ProjectExec(t["store_sales"], [col(c) for c in ("ss_sold_date_sk", "ss_hdemo_sk", "ss_store_sk",
                                                          "ss_ticket_number", "ss_customer_sk", "ss_coupon_amt",
                                                          "ss_net_profit")])
    j = broadcast_join(dt_p, sl, [col("d_date_sk")], [col("ss_sold_date_sk")], JoinType.INNER, True)
    j = broadcast_join(hd_p, j, [col("hd_demo_sk")], [col("ss_hdemo_sk")], JoinType.INNER, True)
    j = broadcast_join(st_p, j, [col("s_store_sk")], [col("ss_store_sk")], JoinType.INNER, True)
    agg = two_stage_agg(j, [GroupingExpr(col(c), c) for c in ("ss_ticket_number", "ss_customer_sk", "s_city")],
                        [AggFunction("sum", col("ss_coupon_amt"), "amt"),
                         AggFunction("sum", col("ss_net_profit"), "profit")], n_parts)
    cu = ProjectExec(t["customer"], [col("c_customer_sk"), col("c_last_name"), col("c_first_name")])
    j2 = broadcast_join(cu, agg, [col("c_customer_sk")], [col("ss_customer_sk")], JoinType.INNER, True)
    proj = ProjectExec(j2, [col(c) for c in ("c_last_name", "c_first_name", "s_city", "ss_ticket_number", "amt",
                                              "profit")])
    return single_sorted(proj, [SortField(col(c)) for c in ("c_last_name", "c_first_name", "s_city", "profit",
                                                            "ss_ticket_number")], fetch=100)


#: q9's count thresholds, sized to the generator as in the reference
Q9_THRESHOLDS = (400, 300, 200, 100, 50)


def q9(t: Dict[str, ExecNode], n_parts: int) -> ExecNode:
    """Five quantity bands of store sales, each the average discount or
    the average net profit by whether its count passes a threshold: 15
    scalar subqueries run while the plan is built, projected over one
    row of ``reason``."""
    exprs, names = [], []
    for b, thresh in enumerate(Q9_THRESHOLDS):
        lo, hi = 20 * b + 1, 20 * (b + 1)
        band = FilterExec(t["store_sales"], (col("ss_quantity") >= lit(lo)) & (col("ss_quantity") <= lit(hi)))
        cnt = scalar_subquery(two_stage_agg(band, [], [AggFunction("count_star", None, "c")], n_parts), "c")
        avg_disc = scalar_subquery(
            two_stage_agg(band, [], [AggFunction("avg", col("ss_ext_discount_amt"), "a")], n_parts), "a")
        avg_profit = scalar_subquery(
            two_stage_agg(band, [], [AggFunction("avg", col("ss_net_profit"), "a")], n_parts), "a")
        exprs.append(Case([(cnt > lit(thresh), avg_disc)], avg_profit))
        names.append(f"bucket{b + 1}")
    return ProjectExec(FilterExec(t["reason"], col("r_reason_sk") == lit(1)), exprs, names)


def q88(t: Dict[str, ExecNode], n_parts: int) -> ExecNode:
    """Store traffic in eight half hours from 8:30: eight scalar count
    subqueries, one row."""
    hd = FilterExec(t["household_demographics"],
                    ((col("hd_dep_count") == lit(4)) & (col("hd_vehicle_count") <= lit(6)))
                    | ((col("hd_dep_count") == lit(2)) & (col("hd_vehicle_count") <= lit(4)))
                    | ((col("hd_dep_count") == lit(0)) & (col("hd_vehicle_count") <= lit(2))))
    hd_p = ProjectExec(hd, [col("hd_demo_sk")])
    st_p = ProjectExec(FilterExec(t["store"], col("s_store_name") == lit("ese")), [col("s_store_sk")])
    exprs, names = [], []
    for k in range(8):
        h, half = divmod(k + 17, 2)  # 8:30, 9:00, ..., 12:00
        td = FilterExec(t["time_dim"], (col("t_hour") == lit(h))
                        & ((col("t_minute") >= lit(30)) if half else (col("t_minute") < lit(30))))
        td_p = ProjectExec(td, [col("t_time_sk")])
        sl = ProjectExec(t["store_sales"], [col("ss_sold_time_sk"), col("ss_hdemo_sk"), col("ss_store_sk")])
        j = broadcast_join(td_p, sl, [col("t_time_sk")], [col("ss_sold_time_sk")], JoinType.INNER, True)
        j = broadcast_join(hd_p, j, [col("hd_demo_sk")], [col("ss_hdemo_sk")], JoinType.INNER, True)
        j = broadcast_join(st_p, j, [col("s_store_sk")], [col("ss_store_sk")], JoinType.INNER, True)
        exprs.append(scalar_subquery(two_stage_agg(j, [], [AggFunction("count_star", None, "c")], n_parts), "c"))
        names.append(f"h{h}_{30 if half else 0}")
    return ProjectExec(FilterExec(t["reason"], col("r_reason_sk") == lit(1)), exprs, names)


def q90(t: Dict[str, ExecNode], n_parts: int) -> ExecNode:
    """Morning against evening web sales on mid-sized pages: two scalar
    count subqueries and their ratio.  As in the reference, no
    household filter (the generator draws no ws_ship_hdemo_sk)."""
    wp = FilterExec(t["web_page"], (col("wp_char_count") >= lit(2000)) & (col("wp_char_count") <= lit(6000)))
    wp_p = ProjectExec(wp, [col("wp_web_page_sk")])

    def half(lo, hi, name):
        td_p = ProjectExec(FilterExec(t["time_dim"], (col("t_hour") >= lit(lo)) & (col("t_hour") <= lit(hi))),
                           [col("t_time_sk")])
        ws = ProjectExec(t["web_sales"], [col("ws_sold_time_sk"), col("ws_web_page_sk")])
        j = broadcast_join(td_p, ws, [col("t_time_sk")], [col("ws_sold_time_sk")], JoinType.INNER, True)
        j = broadcast_join(wp_p, j, [col("wp_web_page_sk")], [col("ws_web_page_sk")], JoinType.INNER, True)
        return two_stage_agg(j, [], [AggFunction("count_star", None, name)], n_parts)

    am = scalar_subquery(half(8, 9, "amc"), "amc")
    pm = scalar_subquery(half(19, 20, "pmc"), "pmc")
    one_row = two_stage_agg(ProjectExec(t["web_page"], [col("wp_web_page_sk")]), [],
                            [AggFunction("count_star", None, "ignore")], n_parts)
    pmf = pm.cast(f64)
    den = Case([(pmf > lit(0.0), pmf)], lit(1.0))
    return ProjectExec(one_row, [am.cast(f64), pmf, am.cast(f64) / den], ["am_count", "pm_count", "am_pm_ratio"])


def q61(t: Dict[str, ExecNode], n_parts: int) -> ExecNode:
    """Promotional against all store revenue of November 1998 from -5
    GMT buyers of jewelry: two decimal scalar subqueries and their
    ratio, over one row of ``reason``.  As in the reference, the
    promotion's channels are its email and event flags."""
    def revenue(with_promo: bool):
        dt_p = ProjectExec(FilterExec(t["date_dim"], (col("d_year") == lit(1998)) & (col("d_moy") == lit(11))),
                           [col("d_date_sk")])
        st_p = ProjectExec(t["store"], [col("s_store_sk")])
        it_p = ProjectExec(FilterExec(t["item"], col("i_category") == lit("Jewelry")), [col("i_item_sk")])
        ca = FilterExec(t["customer_address"], col("ca_gmt_offset") == lit("-5", DataType.decimal(5, 2)))
        ca_p = ProjectExec(ca, [col("ca_address_sk")])
        cust = ProjectExec(t["customer"], [col("c_customer_sk"), col("c_current_addr_sk")])
        cust = broadcast_join(ca_p, cust, [col("ca_address_sk")], [col("c_current_addr_sk")], JoinType.LEFT_SEMI,
                              False)
        sl = ProjectExec(t["store_sales"], [col(c) for c in ("ss_sold_date_sk", "ss_store_sk", "ss_item_sk",
                                                              "ss_customer_sk", "ss_promo_sk", "ss_ext_sales_price")])
        j = broadcast_join(dt_p, sl, [col("d_date_sk")], [col("ss_sold_date_sk")], JoinType.INNER, True)
        j = broadcast_join(st_p, j, [col("s_store_sk")], [col("ss_store_sk")], JoinType.INNER, True)
        j = broadcast_join(it_p, j, [col("i_item_sk")], [col("ss_item_sk")], JoinType.INNER, True)
        j = broadcast_join(cust, j, [col("c_customer_sk")], [col("ss_customer_sk")], JoinType.INNER, True)
        if with_promo:
            pr = FilterExec(t["promotion"], (col("p_channel_email") == lit("Y")) | (col("p_channel_event") == lit("Y")))
            pr_p = ProjectExec(pr, [col("p_promo_sk")])
            j = broadcast_join(pr_p, j, [col("p_promo_sk")], [col("ss_promo_sk")], JoinType.INNER, True)
        return two_stage_agg(j, [], [AggFunction("sum", col("ss_ext_sales_price"), "rev")], n_parts)

    promo = scalar_subquery(revenue(True), "rev")
    total = scalar_subquery(revenue(False), "rev")
    ratio = promo.cast(f64) * lit(100.0) / total.cast(f64)
    return ProjectExec(FilterExec(t["reason"], col("r_reason_sk") == lit(1)), [promo, total, ratio],
                       ["promotions", "total", "promo_pct"])


def q28(t: Dict[str, ExecNode], n_parts: int) -> ExecNode:
    """Six price bands of store sales, each (avg list price, count,
    count of distinct list prices, the last through a grouped agg): 12
    scalar subqueries of 18 values, one row."""
    bands = [("B1", 0, 5, 0, 10, 0, 50), ("B2", 6, 10, 10, 20, 50, 100), ("B3", 11, 15, 20, 30, 100, 150),
             ("B4", 16, 20, 30, 40, 150, 200), ("B5", 21, 25, 40, 50, 200, 250), ("B6", 26, 30, 50, 60, 250, 300)]
    lits = []
    for name, q_lo, q_hi, c_lo, c_hi, w_lo, w_hi in bands:
        f = FilterExec(t["store_sales"],
                       (col("ss_quantity") >= lit(q_lo)) & (col("ss_quantity") <= lit(q_hi))
                       & ((col("ss_list_price") >= lit(str(c_lo), dec72))
                          & (col("ss_list_price") <= lit(str(c_lo + 10), dec72))
                          | (col("ss_coupon_amt") >= lit(str(w_lo), dec72))
                          & (col("ss_coupon_amt") <= lit(str(w_lo + 1000), dec72))
                          | (col("ss_wholesale_cost") >= lit(str(c_hi), dec72))
                          & (col("ss_wholesale_cost") <= lit(str(c_hi + 20), dec72))))
        lp = ProjectExec(f, [col("ss_list_price")])
        distinct = two_stage_agg(lp, [GroupingExpr(col("ss_list_price"), "ss_list_price")], [], n_parts)
        per_band = two_stage_agg(lp, [], [AggFunction("avg", col("ss_list_price"), f"{name}_lp"),
                                          AggFunction("count", col("ss_list_price"), f"{name}_cnt")], n_parts)
        dcnt = two_stage_agg(distinct, [], [AggFunction("count_star", None, f"{name}_cntd")], n_parts)
        lits.extend(tpch_queries.scalar_subquery_row(per_band, [f"{name}_lp", f"{name}_cnt"]))
        lits.extend(tpch_queries.scalar_subquery_row(dcnt, [f"{name}_cntd"]))
    one_row = two_stage_agg(ProjectExec(t["store"], [col("s_store_sk")]), [],
                            [AggFunction("count_star", None, "ignore")], n_parts)
    return ProjectExec(one_row, lits, [f"{name}_{m}" for name, *_ in bands for m in ("lp", "cnt", "cntd")])


def _ship_lag_pivot(t, n_parts, *, fact, sold_c, ship_c, wh_c, sm_c, dim_tab, dim_sk, dim_name, dim_fk, year):
    """q62 and q99: a year's orders in five 30-day ship-lag buckets per
    (warehouse, ship mode, site or call center), CASE pivots summed."""
    dt_p = ProjectExec(FilterExec(t["date_dim"], col("d_year") == lit(year)), [col("d_date_sk"), col("d_date")])
    d2 = ProjectExec(t["date_dim"], [col("d_date_sk").alias("d2_sk"), col("d_date").alias("ship_date")])
    wh = ProjectExec(t["warehouse"], [col("w_warehouse_sk"), col("w_warehouse_name")])
    sm = ProjectExec(t["ship_mode"], [col("sm_ship_mode_sk"), col("sm_type")])
    dim = ProjectExec(t[dim_tab], [col(dim_sk), col(dim_name)])
    sl = ProjectExec(t[fact], [col(sold_c), col(ship_c), col(wh_c), col(sm_c), col(dim_fk)])
    j = broadcast_join(dt_p, sl, [col("d_date_sk")], [col(sold_c)], JoinType.INNER, True)
    j = broadcast_join(d2, j, [col("d2_sk")], [col(ship_c)], JoinType.INNER, True)
    j = broadcast_join(wh, j, [col("w_warehouse_sk")], [col(wh_c)], JoinType.INNER, True)
    j = broadcast_join(sm, j, [col("sm_ship_mode_sk")], [col(sm_c)], JoinType.INNER, True)
    j = broadcast_join(dim, j, [col(dim_sk)], [col(dim_fk)], JoinType.INNER, True)
    lag = (col("ship_date").cast(i64) - col("d_date").cast(i64)).alias("lag")
    base = ProjectExec(j, [col("w_warehouse_name"), col("sm_type"), col(dim_name), lag])
    one, zero = lit(1, i64), lit(0, i64)
    lag_c = col("lag")
    buckets = [("d30", Case([(lag_c <= lit(30, i64), one)], zero))]
    for lo, name in ((30, "d60"), (60, "d90"), (90, "d120")):
        buckets.append((name, Case([((lag_c > lit(lo, i64)) & (lag_c <= lit(lo + 30, i64)), one)], zero)))
    buckets.append(("dmore", Case([(lag_c > lit(120, i64), one)], zero)))
    proj = ProjectExec(base, [col("w_warehouse_name"), col("sm_type"), col(dim_name)]
                       + [e.alias(nm) for nm, e in buckets])
    groups = ("w_warehouse_name", "sm_type", dim_name)
    agg = two_stage_agg(proj, [GroupingExpr(col(c), c) for c in groups],
                        [AggFunction("sum", col(nm), nm) for nm, _ in buckets], n_parts)
    return single_sorted(agg, [SortField(col(c)) for c in groups], fetch=100)


def q62(t: Dict[str, ExecNode], n_parts: int) -> ExecNode:
    """Web orders per (warehouse, ship mode, site)."""
    return _ship_lag_pivot(t, n_parts, fact="web_sales", sold_c="ws_sold_date_sk", ship_c="ws_ship_date_sk",
                           wh_c="ws_warehouse_sk", sm_c="ws_ship_mode_sk", dim_tab="web_site", dim_sk="web_site_sk",
                           dim_name="web_name", dim_fk="ws_web_site_sk", year=2001)


def q99(t: Dict[str, ExecNode], n_parts: int) -> ExecNode:
    """Catalog orders per (warehouse, ship mode, call center)."""
    return _ship_lag_pivot(t, n_parts, fact="catalog_sales", sold_c="cs_sold_date_sk", ship_c="cs_ship_date_sk",
                           wh_c="cs_warehouse_sk", sm_c="cs_ship_mode_sk", dim_tab="call_center",
                           dim_sk="cc_call_center_sk", dim_name="cc_name", dim_fk="cs_call_center_sk", year=2001)


def q21(t: Dict[str, ExecNode], n_parts: int) -> ExecNode:
    """Inventory on hand per (warehouse, item) in the 30 days before and
    after 2000-03-11, two CASE sums, kept where after / before lies in
    [2/3, 3/2]."""
    pivot = datetime.date(2000, 3, 11)
    dt = _date_window(t, pivot - datetime.timedelta(days=30), pivot + datetime.timedelta(days=30), extra=("d_date",))
    price = col("i_current_price")
    it = FilterExec(t["item"], (price >= lit("20", dec72)) & (price <= lit("50", dec72)))
    it_p = ProjectExec(it, [col("i_item_sk"), col("i_item_id")])
    wh = ProjectExec(t["warehouse"], [col("w_warehouse_sk"), col("w_warehouse_name")])
    inv = ProjectExec(t["inventory"], [col(c) for c in ("inv_date_sk", "inv_item_sk", "inv_warehouse_sk",
                                                         "inv_quantity_on_hand")])
    j = broadcast_join(dt, inv, [col("d_date_sk")], [col("inv_date_sk")], JoinType.INNER, True)
    j = broadcast_join(it_p, j, [col("i_item_sk")], [col("inv_item_sk")], JoinType.INNER, True)
    j = broadcast_join(wh, j, [col("w_warehouse_sk")], [col("inv_warehouse_sk")], JoinType.INNER, True)
    pivot_days = lit((pivot - datetime.date(1970, 1, 1)).days, i64)
    qoh = col("inv_quantity_on_hand").cast(i64)
    before = Case([(col("d_date").cast(i64) < pivot_days, qoh)], lit(0, i64))
    after = Case([(col("d_date").cast(i64) >= pivot_days, qoh)], lit(0, i64))
    proj = ProjectExec(j, [col("w_warehouse_name"), col("i_item_id"), before.alias("b"), after.alias("a")])
    agg = two_stage_agg(proj, [GroupingExpr(col("w_warehouse_name"), "w_warehouse_name"),
                               GroupingExpr(col("i_item_id"), "i_item_id")],
                        [AggFunction("sum", col("b"), "inv_before"), AggFunction("sum", col("a"), "inv_after")],
                        n_parts)
    bf, af = col("inv_before").cast(f64), col("inv_after").cast(f64)
    f = FilterExec(agg, (bf > lit(0.0)) & ((af / bf) >= lit(2.0 / 3.0)) & ((af / bf) <= lit(1.5)))
    return single_sorted(f, [SortField(col("w_warehouse_name")), SortField(col("i_item_id"))], fetch=100)


#: q32's and q92's manufacturers: ids up to this one, as in the reference
#: (the spec's one id may be absent at small scales)
Q32_MFG_MAX = 40


def _excess_discount(t, n_parts, *, sales, date_col, item_col, amt_col):
    """q32 and q92: the discounts of 90 days over 1.3 times their item's
    average in those days (the correlated subquery as a grouped ``avg``
    joined back), of low manufacturer ids, summed."""
    dt = FilterExec(t["date_dim"], (col("d_date") >= lit(datetime.date(2000, 1, 27)))
                    & (col("d_date") <= lit(datetime.date(2000, 4, 26))))
    dt_p = ProjectExec(dt, [col("d_date_sk")])
    sl = ProjectExec(t[sales], [col(date_col), col(item_col), col(amt_col)])
    j = broadcast_join(dt_p, sl, [col("d_date_sk")], [col(date_col)], JoinType.INNER, True)
    per_item = two_stage_agg(j, [GroupingExpr(col(item_col), "avg_item_sk")],
                             [AggFunction("avg", col(amt_col), "avg_amt")], n_parts)
    jj = broadcast_join(per_item, j, [col("avg_item_sk")], [col(item_col)], JoinType.INNER, True)
    # avg_amt is decimal(11,6): compared as doubles
    keep = col(amt_col).cast(f64) > col("avg_amt").cast(f64) * lit(1.3)
    it_p = ProjectExec(FilterExec(t["item"], col("i_manufact_id") <= lit(Q32_MFG_MAX)), [col("i_item_sk")])
    f = broadcast_join(it_p, FilterExec(jj, keep), [col("i_item_sk")], [col(item_col)], JoinType.LEFT_SEMI, False)
    return two_stage_agg(f, [], [AggFunction("sum", col(amt_col), "excess_discount")], n_parts)


def q32(t: Dict[str, ExecNode], n_parts: int) -> ExecNode:
    return _excess_discount(t, n_parts, sales="catalog_sales", date_col="cs_sold_date_sk", item_col="cs_item_sk",
                            amt_col="cs_ext_discount_amt")


def q92(t: Dict[str, ExecNode], n_parts: int) -> ExecNode:
    return _excess_discount(t, n_parts, sales="web_sales", date_col="ws_sold_date_sk", item_col="ws_item_sk",
                            amt_col="ws_ext_discount_amt")


def q65(t: Dict[str, ExecNode], n_parts: int) -> ExecNode:
    """Items whose 2000 revenue at a store is at most a tenth of the
    store's average item revenue: an aggregation over an aggregation,
    joined back to it."""
    dt_p = ProjectExec(FilterExec(t["date_dim"], col("d_year") == lit(2000)), [col("d_date_sk")])
    sl = ProjectExec(t["store_sales"], [col("ss_sold_date_sk"), col("ss_store_sk"), col("ss_item_sk"),
                                        col("ss_sales_price")])
    j = broadcast_join(dt_p, sl, [col("d_date_sk")], [col("ss_sold_date_sk")], JoinType.INNER, True)
    per_item = two_stage_agg(j, [GroupingExpr(col("ss_store_sk"), "ss_store_sk"),
                                 GroupingExpr(col("ss_item_sk"), "ss_item_sk")],
                             [AggFunction("sum", col("ss_sales_price"), "revenue")], n_parts)
    per_store = two_stage_agg(per_item, [GroupingExpr(col("ss_store_sk"), "sb_store_sk")],
                              [AggFunction("avg", col("revenue"), "ave")], n_parts)
    jj = broadcast_join(per_store, per_item, [col("sb_store_sk")], [col("ss_store_sk")], JoinType.INNER, True)
    low = FilterExec(jj, col("revenue").cast(f64) <= col("ave").cast(f64) * lit(0.1))
    st_p = ProjectExec(t["store"], [col("s_store_sk"), col("s_store_name")])
    it_p = ProjectExec(t["item"], [col("i_item_sk"), col("i_item_desc"), col("i_current_price"), col("i_brand")])
    out = broadcast_join(st_p, low, [col("s_store_sk")], [col("ss_store_sk")], JoinType.INNER, True)
    out = broadcast_join(it_p, out, [col("i_item_sk")], [col("ss_item_sk")], JoinType.INNER, True)
    proj = ProjectExec(out, [col(c) for c in ("s_store_name", "i_item_desc", "revenue", "i_current_price",
                                              "i_brand")])
    return single_sorted(proj, [SortField(col("s_store_name")), SortField(col("i_item_desc"))], fetch=100)


# ---------------------------------- multi-fact, shuffled and self joins


def _returns_above_avg(t, n_parts, *, rtab, r_cust, r_amt, r_date, r_loc, loc_tab=None, loc_sk=None,
                       loc_filter_col=None, loc_filter_val=None, names=False):
    """q1, q30 and q81: each customer's 2000 returns per location, kept
    above 1.2 times the location's average (the correlated average as a
    grouped ``avg`` joined on the location; one exchange of the
    per-customer sums under both consumers), with the customer's id."""
    dt_p = ProjectExec(FilterExec(t["date_dim"], col("d_year") == lit(2000)), [col("d_date_sk")])
    rt = ProjectExec(t[rtab], [col(r_date), col(r_cust), col(r_loc), col(r_amt)])
    j = broadcast_join(dt_p, rt, [col("d_date_sk")], [col(r_date)], JoinType.INNER, True)
    if loc_tab is not None:
        loc_p = ProjectExec(FilterExec(t[loc_tab], col(loc_filter_col) == lit(loc_filter_val)), [col(loc_sk)])
        j = broadcast_join(loc_p, j, [col(loc_sk)], [col(r_loc)], JoinType.INNER, True)
    per_cust = two_stage_agg(ProjectExec(j, [col(r_cust), col(r_loc), col(r_amt)]),
                             [GroupingExpr(col(r_cust), "ctr_customer_sk"), GroupingExpr(col(r_loc), "ctr_loc_sk")],
                             [AggFunction("sum", col(r_amt), "ctr_total_return")], n_parts)
    loc_avg = two_stage_agg(ProjectExec(per_cust, [col("ctr_loc_sk").alias("avg_loc_sk"), col("ctr_total_return")]),
                            [GroupingExpr(col("avg_loc_sk"), "avg_loc_sk")],
                            [AggFunction("avg", col("ctr_total_return"), "avg_return")], n_parts)
    j2 = broadcast_join(loc_avg, per_cust, [col("avg_loc_sk")], [col("ctr_loc_sk")], JoinType.INNER, True)
    f = FilterExec(j2, col("ctr_total_return").cast(f64) > lit(1.2) * col("avg_return").cast(f64))
    cu = ProjectExec(t["customer"], [col("c_customer_sk"), col("c_customer_id")]
                     + ([col("c_first_name"), col("c_last_name")] if names else []))
    j3 = broadcast_join(cu, f, [col("c_customer_sk")], [col("ctr_customer_sk")], JoinType.INNER, True)
    if names:
        proj = ProjectExec(j3, [col("c_customer_id"), col("c_first_name"), col("c_last_name"),
                                col("ctr_total_return")])
        return single_sorted(proj, [SortField(col("c_customer_id")), SortField(col("ctr_total_return"))], fetch=100)
    return single_sorted(ProjectExec(j3, [col("c_customer_id")]), [SortField(col("c_customer_id"))], fetch=100)


def q1(t: Dict[str, ExecNode], n_parts: int) -> ExecNode:
    """Store returns of TN stores."""
    return _returns_above_avg(t, n_parts, rtab="store_returns", r_cust="sr_customer_sk", r_amt="sr_return_amt",
                              r_date="sr_returned_date_sk", r_loc="sr_store_sk", loc_tab="store", loc_sk="s_store_sk",
                              loc_filter_col="s_state", loc_filter_val="TN")


def q30(t: Dict[str, ExecNode], n_parts: int) -> ExecNode:
    """Web returns per web page, with the customer's names.  As in the
    reference, no state filter (the generator's web_page has no state)."""
    return _returns_above_avg(t, n_parts, rtab="web_returns", r_cust="wr_returning_customer_sk",
                              r_amt="wr_return_amt", r_date="wr_returned_date_sk", r_loc="wr_web_page_sk", names=True)


def q81(t: Dict[str, ExecNode], n_parts: int) -> ExecNode:
    """Catalog returns per call center, with the customer's names."""
    return _returns_above_avg(t, n_parts, rtab="catalog_returns", r_cust="cr_returning_customer_sk",
                              r_amt="cr_return_amount", r_date="cr_returned_date_sk", r_loc="cr_call_center_sk",
                              names=True)


def _multi_wh_orders(t, n_parts, fact, order_c, wh_c):
    """Orders whose lines ship from two warehouses or more (the spec's
    EXISTS self-join on the order, another warehouse): distinct (order,
    warehouse) pairs counted per order."""
    pairs = two_stage_agg(ProjectExec(t[fact], [col(order_c), col(wh_c)]),
                          [GroupingExpr(col(order_c), order_c), GroupingExpr(col(wh_c), wh_c)], [], n_parts)
    per_order = two_stage_agg(pairs, [GroupingExpr(col(order_c), order_c)],
                              [AggFunction("count_star", None, "wh_cnt")], n_parts)
    return ProjectExec(FilterExec(per_order, col("wh_cnt") > lit(1, i64)), [col(order_c)])


def _ship_report_tail(rows, n_parts, order_c, ship_c, profit_c):
    """count(DISTINCT order) and two sums: sums per order, then a global
    ``count_star`` (the number of groups is the distinct count) and the
    sums of the sums."""
    per_order = two_stage_agg(rows, [GroupingExpr(col(order_c), order_c)],
                              [AggFunction("sum", col(ship_c), "s1"), AggFunction("sum", col(profit_c), "p1")],
                              n_parts)
    return two_stage_agg(per_order, [],
                         [AggFunction("count_star", None, "order_count"),
                          AggFunction("sum", col("s1"), "total_shipping_cost"),
                          AggFunction("sum", col("p1"), "total_net_profit")], n_parts)


def _q94_shape(t, n_parts, returns_join):
    """q94 and q95: web lines of an 11-month ship window to TN from the
    'pri' site, of multi-warehouse orders (a LEFT_SEMI join whose build
    side is an aggregate), with (LEFT_SEMI) or without (LEFT_ANTI) a
    return."""
    dt = _date_window(t, datetime.date(1999, 2, 1), datetime.date(1999, 12, 31))
    ca_p = ProjectExec(FilterExec(t["customer_address"], col("ca_state") == lit("TN")), [col("ca_address_sk")])
    site_p = ProjectExec(FilterExec(t["web_site"], col("web_company_name") == lit("pri")), [col("web_site_sk")])
    ws1 = ProjectExec(t["web_sales"], [col(c) for c in ("ws_ship_date_sk", "ws_ship_addr_sk", "ws_web_site_sk",
                                                        "ws_order_number", "ws_ext_ship_cost", "ws_net_profit")])
    j = broadcast_join(dt, ws1, [col("d_date_sk")], [col("ws_ship_date_sk")], JoinType.INNER, True)
    j = broadcast_join(ca_p, j, [col("ca_address_sk")], [col("ws_ship_addr_sk")], JoinType.INNER, True)
    j = broadcast_join(site_p, j, [col("web_site_sk")], [col("ws_web_site_sk")], JoinType.INNER, True)
    hot = _multi_wh_orders(t, n_parts, "web_sales", "ws_order_number", "ws_warehouse_sk")
    j = broadcast_join(hot, j, [col("ws_order_number")], [col("ws_order_number")], JoinType.LEFT_SEMI, False)
    wr = ProjectExec(t["web_returns"], [col("wr_order_number")])
    j = broadcast_join(wr, j, [col("wr_order_number")], [col("ws_order_number")], returns_join, False)
    return _ship_report_tail(j, n_parts, "ws_order_number", "ws_ext_ship_cost", "ws_net_profit")


def q94(t: Dict[str, ExecNode], n_parts: int) -> ExecNode:
    """Multi-warehouse web orders never returned."""
    return _q94_shape(t, n_parts, JoinType.LEFT_ANTI)


def q95(t: Dict[str, ExecNode], n_parts: int) -> ExecNode:
    """Multi-warehouse web orders with a return."""
    return _q94_shape(t, n_parts, JoinType.LEFT_SEMI)


def q16(t: Dict[str, ExecNode], n_parts: int) -> ExecNode:
    """q94's catalog twin: GA ship addresses, Williamson County call
    centers, 2002."""
    dt = _date_window(t, datetime.date(2002, 2, 1), datetime.date(2002, 12, 31))
    ca_p = ProjectExec(FilterExec(t["customer_address"], col("ca_state") == lit("GA")), [col("ca_address_sk")])
    cc_p = ProjectExec(FilterExec(t["call_center"], col("cc_county") == lit("Williamson County")),
                       [col("cc_call_center_sk")])
    cs1 = ProjectExec(t["catalog_sales"], [col(c) for c in ("cs_ship_date_sk", "cs_ship_addr_sk", "cs_call_center_sk",
                                                            "cs_order_number", "cs_ext_ship_cost", "cs_net_profit")])
    j = broadcast_join(dt, cs1, [col("d_date_sk")], [col("cs_ship_date_sk")], JoinType.INNER, True)
    j = broadcast_join(ca_p, j, [col("ca_address_sk")], [col("cs_ship_addr_sk")], JoinType.INNER, True)
    j = broadcast_join(cc_p, j, [col("cc_call_center_sk")], [col("cs_call_center_sk")], JoinType.INNER, True)
    hot = _multi_wh_orders(t, n_parts, "catalog_sales", "cs_order_number", "cs_warehouse_sk")
    j = broadcast_join(hot, j, [col("cs_order_number")], [col("cs_order_number")], JoinType.LEFT_SEMI, False)
    cr = ProjectExec(t["catalog_returns"], [col("cr_order_number")])
    j = broadcast_join(cr, j, [col("cr_order_number")], [col("cs_order_number")], JoinType.LEFT_ANTI, False)
    return _ship_report_tail(j, n_parts, "cs_order_number", "cs_ext_ship_cost", "cs_net_profit")


_CUST_NAMES = ("c_customer_id", "c_first_name", "c_last_name", "c_preferred_cust_flag")


def _year_total(t, n_parts, *, fact, date_c, cust_c, fact_cols, measure, year, names=False):
    """One channel's per-customer total of ``measure`` in ``year`` (the
    year_total CTE of q4, q11 and q74, one (channel, year) slice)."""
    dt_p = ProjectExec(FilterExec(t["date_dim"], col("d_year") == lit(year)), [col("d_date_sk")])
    fc = ProjectExec(t[fact], [col(date_c), col(cust_c)] + [col(c) for c in fact_cols])
    cu = ProjectExec(t["customer"], [col("c_customer_sk")] + ([col(c) for c in _CUST_NAMES] if names else []))
    j = broadcast_join(dt_p, fc, [col("d_date_sk")], [col(date_c)], JoinType.INNER, True)
    j = broadcast_join(cu, j, [col("c_customer_sk")], [col(cust_c)], JoinType.INNER, True)
    groups = [GroupingExpr(col("c_customer_sk"), "c_customer_sk")] + (
        [GroupingExpr(col(c), c) for c in _CUST_NAMES] if names else [])
    return two_stage_agg(j, groups, [AggFunction("sum", measure, "year_total")], n_parts)


def _year_slice(t, n_parts, fact, date_c, cust_c, cols, measure, year, alias, names=()):
    """A year total keyed ``sk_<alias>``, its total named ``alias``, and
    the customer columns ``names``."""
    yt = _year_total(t, n_parts, fact=fact, date_c=date_c, cust_c=cust_c, fact_cols=cols, measure=measure, year=year,
                     names=bool(names))
    return ProjectExec(yt, [col("c_customer_sk").alias(f"sk_{alias}"), col("year_total").alias(alias)]
                       + [col(c) for c in names])


def _yoy_customer(t, n_parts, *, store_measure, store_cols, web_measure, web_cols, y1, y2, out_cols):
    """q74 and q11: four (channel, year) totals broadcast-joined on the
    customer, kept where the web's growth beats the store's."""
    store = ("store_sales", "ss_sold_date_sk", "ss_customer_sk", store_cols, store_measure)
    web = ("web_sales", "ws_sold_date_sk", "ws_bill_customer_sk", web_cols, web_measure)
    s1 = _year_slice(t, n_parts, *store, y1, "s1")
    s2 = _year_slice(t, n_parts, *store, y2, "s2", _CUST_NAMES)
    w1, w2 = _year_slice(t, n_parts, *web, y1, "w1"), _year_slice(t, n_parts, *web, y2, "w2")
    j = broadcast_join(s1, s2, [col("sk_s1")], [col("sk_s2")], JoinType.INNER, True)
    j = broadcast_join(w1, j, [col("sk_w1")], [col("sk_s2")], JoinType.INNER, True)
    j = broadcast_join(w2, j, [col("sk_w2")], [col("sk_s2")], JoinType.INNER, True)
    s1f, s2f, w1f, w2f = (col(c).cast(f64) for c in ("s1", "s2", "w1", "w2"))
    f = FilterExec(j, (s1f > lit(0.0)) & (w1f > lit(0.0)) & ((w2f / w1f) > (s2f / s1f)))
    return single_sorted(ProjectExec(f, [col(c) for c in out_cols]), [SortField(col(out_cols[0]))], fetch=100)


def q74(t: Dict[str, ExecNode], n_parts: int) -> ExecNode:
    """Customers whose web net paid grew faster than their store net
    paid, 1999 to 2000."""
    return _yoy_customer(t, n_parts, store_measure=col("ss_net_paid"), store_cols=["ss_net_paid"],
                         web_measure=col("ws_net_paid"), web_cols=["ws_net_paid"], y1=1999, y2=2000,
                         out_cols=["c_customer_id", "c_first_name", "c_last_name"])


def q11(t: Dict[str, ExecNode], n_parts: int) -> ExecNode:
    """q74 on list price less discount, 2000 to 2001, with the preferred
    flag."""
    return _yoy_customer(t, n_parts, store_measure=col("ss_ext_list_price") - col("ss_ext_discount_amt"),
                         store_cols=["ss_ext_list_price", "ss_ext_discount_amt"],
                         web_measure=col("ws_ext_list_price") - col("ws_ext_discount_amt"),
                         web_cols=["ws_ext_list_price", "ws_ext_discount_amt"], y1=2000, y2=2001,
                         out_cols=["c_customer_id", "c_preferred_cust_flag", "c_first_name", "c_last_name"])


def q4(t: Dict[str, ExecNode], n_parts: int) -> ExecNode:
    """q11 over all three channels, on (list - wholesale - discount +
    sales) / 2: customers whose catalog and web growth both beat the
    store's, six year totals joined on the customer.  As in the
    reference, catalog and web take their per-unit wholesale cost (the
    generator has no ext_wholesale_cost for them)."""
    two = lit("2", dec72)

    def measure(lp, wc, dc, sp):
        return (col(lp) - col(wc) - col(dc) + col(sp)) / two

    ss_cols = ["ss_ext_list_price", "ss_ext_wholesale_cost", "ss_ext_discount_amt", "ss_ext_sales_price"]
    cs_cols = ["cs_ext_list_price", "cs_wholesale_cost", "cs_ext_discount_amt", "cs_ext_sales_price"]
    ws_cols = ["ws_ext_list_price", "ws_wholesale_cost", "ws_ext_discount_amt", "ws_ext_sales_price"]
    store = ("store_sales", "ss_sold_date_sk", "ss_customer_sk", ss_cols, measure(*ss_cols))
    cat = ("catalog_sales", "cs_sold_date_sk", "cs_bill_customer_sk", cs_cols, measure(*cs_cols))
    web = ("web_sales", "ws_sold_date_sk", "ws_bill_customer_sk", ws_cols, measure(*ws_cols))
    s1 = _year_slice(t, n_parts, *store, 2000, "s1")
    s2 = _year_slice(t, n_parts, *store, 2001, "s2", _CUST_NAMES[:3])
    c1, c2 = _year_slice(t, n_parts, *cat, 2000, "c1"), _year_slice(t, n_parts, *cat, 2001, "c2")
    w1, w2 = _year_slice(t, n_parts, *web, 2000, "w1"), _year_slice(t, n_parts, *web, 2001, "w2")
    j = broadcast_join(s1, s2, [col("sk_s1")], [col("sk_s2")], JoinType.INNER, True)
    for b, key in ((c1, "sk_c1"), (c2, "sk_c2"), (w1, "sk_w1"), (w2, "sk_w2")):
        j = broadcast_join(b, j, [col(key)], [col("sk_s2")], JoinType.INNER, True)
    s1f, s2f, c1f, c2f, w1f, w2f = (col(c).cast(f64) for c in ("s1", "s2", "c1", "c2", "w1", "w2"))
    f = FilterExec(j, (s1f > lit(0.0)) & (c1f > lit(0.0)) & (w1f > lit(0.0))
                   & ((c2f / c1f) > (s2f / s1f)) & ((w2f / w1f) > (s2f / s1f)))
    proj = ProjectExec(f, [col("c_customer_id"), col("c_first_name"), col("c_last_name")])
    return single_sorted(proj, [SortField(col("c_customer_id"))], fetch=100)


def _inv_price_items(t, n_parts, fact, item_c):
    """q37 and q82: items priced 30-60 with 100-500 on hand in a 60-day
    window (a shuffled join of the items to the inventory), sold in the
    channel (a LEFT_SEMI join).  As in the reference, no manufacturer
    list (the generator's ids are uniform)."""
    price = col("i_current_price")
    it = FilterExec(t["item"], (price >= lit("30", dec72)) & (price <= lit("60", dec72)))
    it_p = ProjectExec(it, [col("i_item_sk"), col("i_item_id"), col("i_item_desc"), col("i_current_price")])
    dt = _date_window(t, datetime.date(2000, 2, 1), datetime.date(2000, 4, 1))
    qoh = col("inv_quantity_on_hand")
    inv_p = ProjectExec(FilterExec(t["inventory"], (qoh >= lit(100)) & (qoh <= lit(500))),
                        [col("inv_date_sk"), col("inv_item_sk")])
    j = broadcast_join(dt, inv_p, [col("d_date_sk")], [col("inv_date_sk")], JoinType.INNER, True)
    j = shuffle_join(it_p, j, [col("i_item_sk")], [col("inv_item_sk")], JoinType.INNER, n_parts, build_left=True)
    sold = ProjectExec(t[fact], [col(item_c)])
    j = broadcast_join(sold, j, [col(item_c)], [col("i_item_sk")], JoinType.LEFT_SEMI, False)
    agg = two_stage_agg(j, [GroupingExpr(col(c), c) for c in ("i_item_id", "i_item_desc", "i_current_price")], [],
                        n_parts)
    return single_sorted(agg, [SortField(col("i_item_id"))], fetch=100)


def q37(t: Dict[str, ExecNode], n_parts: int) -> ExecNode:
    return _inv_price_items(t, n_parts, "catalog_sales", "cs_item_sk")


def q82(t: Dict[str, ExecNode], n_parts: int) -> ExecNode:
    return _inv_price_items(t, n_parts, "store_sales", "ss_item_sk")


def q40(t: Dict[str, ExecNode], n_parts: int) -> ExecNode:
    """Catalog sales net of refunds per (warehouse state, item), before
    and after 2000-03-11: a LEFT shuffled join on (item, order) to the
    returns, then q21's CASE split (a side with no line sums to null)."""
    pivot = datetime.date(2000, 3, 11)
    pivot_days = lit((pivot - datetime.date(1970, 1, 1)).days, i64)
    dt = _date_window(t, pivot - datetime.timedelta(days=30), pivot + datetime.timedelta(days=30), extra=("d_date",))
    price = col("i_current_price")
    it = ProjectExec(FilterExec(t["item"], (price >= lit("20", dec72)) & (price <= lit("50", dec72))),
                     [col("i_item_sk"), col("i_item_id")])
    wh = ProjectExec(t["warehouse"], [col("w_warehouse_sk"), col("w_state")])
    cs = ProjectExec(t["catalog_sales"], [col(c) for c in ("cs_sold_date_sk", "cs_item_sk", "cs_order_number",
                                                           "cs_warehouse_sk", "cs_sales_price")])
    j = broadcast_join(dt, cs, [col("d_date_sk")], [col("cs_sold_date_sk")], JoinType.INNER, True)
    j = broadcast_join(it, j, [col("i_item_sk")], [col("cs_item_sk")], JoinType.INNER, True)
    j = broadcast_join(wh, j, [col("w_warehouse_sk")], [col("cs_warehouse_sk")], JoinType.INNER, True)
    cr = ProjectExec(t["catalog_returns"], [col("cr_item_sk"), col("cr_order_number"), col("cr_refunded_cash")])
    j = shuffle_join(j, cr, [col("cs_item_sk"), col("cs_order_number")], [col("cr_item_sk"), col("cr_order_number")],
                     JoinType.LEFT, n_parts, build_left=False)
    net = _d8(col("cs_sales_price")) - _coalesce0(col("cr_refunded_cash"))
    before = Case([(col("d_date").cast(i64) < pivot_days, net)], None)
    after = Case([(col("d_date").cast(i64) >= pivot_days, net)], None)
    proj = ProjectExec(j, [col("w_state"), col("i_item_id"), before.alias("b"), after.alias("a")])
    agg = two_stage_agg(proj, [GroupingExpr(col("w_state"), "w_state"), GroupingExpr(col("i_item_id"), "i_item_id")],
                        [AggFunction("sum", col("b"), "sales_before"), AggFunction("sum", col("a"), "sales_after")],
                        n_parts)
    return single_sorted(agg, [SortField(col("w_state")), SortField(col("i_item_id"))], fetch=100)


#: q50's days-to-return buckets: (name, above, at most)
_LAG_BUCKETS = (("d30", None, 30), ("d60", 30, 60), ("d90", 60, 90), ("d120", 90, 120), ("dmore", 120, None))


def q50(t: Dict[str, ExecNode], n_parts: int) -> ExecNode:
    """Store returns of August 2001 joined to their sale (a shuffled
    join on item, ticket and customer), counted per store in five
    days-to-return buckets."""
    sl = ProjectExec(t["store_sales"], [col(c) for c in ("ss_item_sk", "ss_ticket_number", "ss_customer_sk",
                                                         "ss_store_sk", "ss_sold_date_sk")])
    sr = ProjectExec(t["store_returns"], [col(c) for c in ("sr_item_sk", "sr_ticket_number", "sr_customer_sk",
                                                           "sr_returned_date_sk")])
    j = shuffle_join(sl, sr, [col("ss_item_sk"), col("ss_ticket_number"), col("ss_customer_sk")],
                     [col("sr_item_sk"), col("sr_ticket_number"), col("sr_customer_sk")], JoinType.INNER, n_parts,
                     build_left=False)
    d1 = ProjectExec(t["date_dim"], [col("d_date_sk"), col("d_date")])
    d2 = ProjectExec(FilterExec(t["date_dim"], (col("d_year") == lit(2001)) & (col("d_moy") == lit(8))),
                     [col("d_date_sk").alias("d2_sk"), col("d_date").alias("ret_date")])
    j = broadcast_join(d1, j, [col("d_date_sk")], [col("ss_sold_date_sk")], JoinType.INNER, True)
    j = broadcast_join(d2, j, [col("d2_sk")], [col("sr_returned_date_sk")], JoinType.INNER, True)
    stores = ("s_store_name", "s_county", "s_state", "s_zip")
    st = ProjectExec(t["store"], [col("s_store_sk")] + [col(c) for c in stores])
    j = broadcast_join(st, j, [col("s_store_sk")], [col("ss_store_sk")], JoinType.INNER, True)
    lag_days = col("ret_date").cast(i64) - col("d_date").cast(i64)
    base = ProjectExec(j, [col(c) for c in stores] + [lag_days.alias("lag")])
    lag = col("lag")

    def bucket(lo, hi):
        if lo is None:
            return lag <= lit(hi, i64)
        if hi is None:
            return lag > lit(lo, i64)
        return (lag > lit(lo, i64)) & (lag <= lit(hi, i64))

    proj = ProjectExec(base, [col(c) for c in stores]
                       + [Case([(bucket(lo, hi), lit(1, i64))], lit(0, i64)).alias(nm) for nm, lo, hi in _LAG_BUCKETS])
    agg = two_stage_agg(proj, [GroupingExpr(col(c), c) for c in stores],
                        [AggFunction("sum", col(nm), nm) for nm, _, _ in _LAG_BUCKETS], n_parts)
    return single_sorted(agg, [SortField(col(c)) for c in stores], fetch=100)


def q93(t: Dict[str, ExecNode], n_parts: int) -> ExecNode:
    """Sales net of returns per customer for one return reason: a LEFT
    shuffled join on (item, ticket) whose null side feeds a CASE, then
    the reason's INNER join (which keeps returned lines alone, as the
    spec's comma join)."""
    sl = ProjectExec(t["store_sales"], [col(c) for c in ("ss_item_sk", "ss_ticket_number", "ss_customer_sk",
                                                         "ss_quantity", "ss_sales_price")])
    sr = ProjectExec(t["store_returns"], [col(c) for c in ("sr_item_sk", "sr_ticket_number", "sr_reason_sk",
                                                           "sr_return_quantity")])
    j = shuffle_join(sl, sr, [col("ss_item_sk"), col("ss_ticket_number")], [col("sr_item_sk"), col("sr_ticket_number")],
                     JoinType.LEFT, n_parts, build_left=False)
    reason_p = ProjectExec(FilterExec(t["reason"], col("r_reason_desc") == lit("Stopped working")),
                           [col("r_reason_sk")])
    j = broadcast_join(reason_p, j, [col("r_reason_sk")], [col("sr_reason_sk")], JoinType.INNER, True)
    qty = col("ss_quantity")
    act = Case([(col("sr_return_quantity").is_not_null(),
                 (qty - col("sr_return_quantity")).cast(i64) * col("ss_sales_price"))],
               qty.cast(i64) * col("ss_sales_price"))
    agg = two_stage_agg(ProjectExec(j, [col("ss_customer_sk"), act.alias("act_sales")]),
                        [GroupingExpr(col("ss_customer_sk"), "ss_customer_sk")],
                        [AggFunction("sum", col("act_sales"), "sumsales")], n_parts)
    return single_sorted(agg, [SortField(col("sumsales")), SortField(col("ss_customer_sk"))], fetch=100)


def _q24_ssales(t, n_parts):
    """q24's ssales: returned store lines (a shuffled join on (item,
    ticket)) of market-8 stores to customers living in the store's
    county, net paid per (last, first, store, color).  As in the
    reference, the county stands in for the zip (the generator's ca_zip
    carries a -nnnn suffix)."""
    sl = ProjectExec(t["store_sales"], [col(c) for c in ("ss_item_sk", "ss_ticket_number", "ss_store_sk",
                                                         "ss_customer_sk", "ss_net_paid")])
    sr = ProjectExec(t["store_returns"], [col("sr_item_sk"), col("sr_ticket_number")])
    j = shuffle_join(sl, sr, [col("ss_item_sk"), col("ss_ticket_number")], [col("sr_item_sk"), col("sr_ticket_number")],
                     JoinType.INNER, n_parts, build_left=False)
    st_p = ProjectExec(FilterExec(t["store"], col("s_market_id") == lit(8)),
                       [col("s_store_sk"), col("s_store_name"), col("s_county")])
    j = broadcast_join(st_p, j, [col("s_store_sk")], [col("ss_store_sk")], JoinType.INNER, True)
    cu = ProjectExec(t["customer"], [col("c_customer_sk"), col("c_last_name"), col("c_first_name"),
                                     col("c_current_addr_sk")])
    j = broadcast_join(cu, j, [col("c_customer_sk")], [col("ss_customer_sk")], JoinType.INNER, True)
    ca = ProjectExec(t["customer_address"], [col("ca_address_sk"), col("ca_county")])
    j = broadcast_join(ca, j, [col("ca_address_sk")], [col("c_current_addr_sk")], JoinType.INNER, True)
    j = FilterExec(j, col("ca_county") == col("s_county"))
    it = ProjectExec(t["item"], [col("i_item_sk"), col("i_color")])
    j = broadcast_join(it, j, [col("i_item_sk")], [col("ss_item_sk")], JoinType.INNER, True)
    return two_stage_agg(j, [GroupingExpr(col(c), c) for c in ("c_last_name", "c_first_name", "s_store_name",
                                                                "i_color")],
                         [AggFunction("sum", col("ss_net_paid"), "netpaid")], n_parts)


def _q24(t, n_parts, color):
    """One color's net paid per (last, first, store), kept above 5% of
    the average over every color (a decimal scalar subquery over a
    subtree of its own)."""
    avg_all = two_stage_agg(_q24_ssales(t, n_parts), [], [AggFunction("avg", col("netpaid"), "avg_netpaid")], n_parts)
    avg_lit = scalar_subquery(avg_all, "avg_netpaid")
    cells = FilterExec(_q24_ssales(t, n_parts), col("i_color") == lit(color))
    agg = two_stage_agg(cells, [GroupingExpr(col(c), c) for c in ("c_last_name", "c_first_name", "s_store_name")],
                        [AggFunction("sum", col("netpaid"), "paid")], n_parts)
    f = FilterExec(agg, col("paid").cast(f64) > lit(0.05) * avg_lit.cast(f64))
    return single_sorted(f, [SortField(col(c)) for c in ("c_last_name", "c_first_name", "s_store_name")])


def q24a(t: Dict[str, ExecNode], n_parts: int) -> ExecNode:
    return _q24(t, n_parts, "peach")


def q24b(t: Dict[str, ExecNode], n_parts: int) -> ExecNode:
    return _q24(t, n_parts, "saddle")


def q14b(t: Dict[str, ExecNode], n_parts: int) -> ExecNode:
    """This November's store cells of the cross-channel items against
    last November's (a shuffled join on the three ids), kept where sales
    grew; both years above the average (a decimal scalar subquery)."""
    cross = _q14_cross_items(t, n_parts)
    avg_lit = scalar_subquery(_q14_avg_sales(t, n_parts), "average_sales")
    store = _Q14_CHANNELS[0]
    ty = _q14_channel_cells(t, n_parts, *store, cross, avg_lit, 2002)
    ly = _q14_channel_cells(t, n_parts, *store, cross, avg_lit, 2001)
    ly = ProjectExec(ly, [col("i_brand_id").alias("l_brand_id"), col("i_class_id").alias("l_class_id"),
                          col("i_category_id").alias("l_category_id"), col("sales").alias("last_sales"),
                          col("number_sales").alias("last_number_sales")])
    j = shuffle_join(ty, ly, [col(c) for c in _TRIPLE], [col("l_brand_id"), col("l_class_id"), col("l_category_id")],
                     JoinType.INNER, n_parts, build_left=False)
    f = FilterExec(j, col("sales").cast(f64) > col("last_sales").cast(f64))
    proj = ProjectExec(f, [col(c) for c in _TRIPLE + ("sales", "number_sales", "last_sales", "last_number_sales")])
    return single_sorted(proj, [SortField(col(c)) for c in _TRIPLE], fetch=100)


def q58(t: Dict[str, ExecNode], n_parts: int) -> ExecNode:
    """Items whose revenue in the month of 2000-01-03 (a scalar
    subquery for its month_seq) is even across the three channels, each
    channel's revenue within 25%-400% of the others'.  As in the
    reference, the month for the spec's week and the wider band (the
    spec's select nothing from the generator's sparse cells)."""
    wk = FilterExec(t["date_dim"], col("d_date") == lit(datetime.date(2000, 1, 3)))
    wk = two_stage_agg(ProjectExec(wk, [col("d_month_seq").alias("wk_sel")]), [GroupingExpr(col("wk_sel"), "wk_sel")],
                       [], n_parts)
    wk_seq = scalar_subquery(wk, "wk_sel")

    def channel(fact, item_c, date_c, price_c, rev_name, id_name):
        dd = ProjectExec(FilterExec(t["date_dim"], col("d_month_seq") == wk_seq), [col("d_date_sk")])
        sl = ProjectExec(t[fact], [col(date_c), col(item_c), col(price_c)])
        j = broadcast_join(dd, sl, [col("d_date_sk")], [col(date_c)], JoinType.INNER, True)
        it = ProjectExec(t["item"], [col("i_item_sk"), col("i_item_id")])
        j = broadcast_join(it, j, [col("i_item_sk")], [col(item_c)], JoinType.INNER, True)
        return two_stage_agg(j, [GroupingExpr(col("i_item_id"), id_name)], [AggFunction("sum", col(price_c), rev_name)],
                             n_parts)

    ss_items = channel("store_sales", "ss_item_sk", "ss_sold_date_sk", "ss_ext_sales_price", "ss_item_rev", "item_id")
    cs_items = channel("catalog_sales", "cs_item_sk", "cs_sold_date_sk", "cs_ext_sales_price", "cs_item_rev",
                       "cs_item_id")
    ws_items = channel("web_sales", "ws_item_sk", "ws_sold_date_sk", "ws_ext_sales_price", "ws_item_rev", "ws_item_id")
    j = shuffle_join(ss_items, cs_items, [col("item_id")], [col("cs_item_id")], JoinType.INNER, n_parts,
                     build_left=False)
    j = shuffle_join(j, ws_items, [col("item_id")], [col("ws_item_id")], JoinType.INNER, n_parts, build_left=False)
    ssr, csr, wsr = (col(c).cast(f64) for c in ("ss_item_rev", "cs_item_rev", "ws_item_rev"))

    def near(a, b):
        return (a >= lit(0.25) * b) & (a <= lit(4.0) * b)

    f = FilterExec(j, near(ssr, csr) & near(ssr, wsr) & near(csr, ssr) & near(csr, wsr) & near(wsr, ssr)
                   & near(wsr, csr))
    total = ssr + csr + wsr
    proj = ProjectExec(f, [col("item_id"), col("ss_item_rev"), (ssr / total / lit(3.0) * lit(100.0)).alias("ss_dev"),
                           col("cs_item_rev"), (csr / total / lit(3.0) * lit(100.0)).alias("cs_dev"),
                           col("ws_item_rev"), (wsr / total / lit(3.0) * lit(100.0)).alias("ws_dev"),
                           (total / lit(3.0)).alias("average")])
    return single_sorted(proj, [SortField(col("item_id")), SortField(col("ss_item_rev"))], fetch=100)


def _q31_channel(t, n_parts, fact, date_c, addr_c, price_c, qoy, pre):
    """One channel's 2000 sales per county in quarter ``qoy``."""
    dt = ProjectExec(FilterExec(t["date_dim"], (col("d_year") == lit(2000)) & (col("d_qoy") == lit(qoy))),
                     [col("d_date_sk")])
    sl = ProjectExec(t[fact], [col(date_c), col(addr_c), col(price_c)])
    j = broadcast_join(dt, sl, [col("d_date_sk")], [col(date_c)], JoinType.INNER, True)
    ca = ProjectExec(t["customer_address"], [col("ca_address_sk"), col("ca_county")])
    j = broadcast_join(ca, j, [col("ca_address_sk")], [col(addr_c)], JoinType.INNER, True)
    return two_stage_agg(j, [GroupingExpr(col("ca_county"), f"{pre}_county")],
                         [AggFunction("sum", col(price_c), f"{pre}_sales")], n_parts)


def q31(t: Dict[str, ExecNode], n_parts: int) -> ExecNode:
    """Counties whose web growth beats their store growth from one
    quarter of 2000 to the next: six (channel, quarter) sums
    shuffle-joined on the county.  As in the reference, the two
    quarter-on-quarter comparisons are OR'd (no county passes both at
    the generator's scales); each CASE-guards its denominators."""
    channels = {"ss": ("store_sales", "ss_sold_date_sk", "ss_addr_sk", "ss_ext_sales_price"),
                "ws": ("web_sales", "ws_sold_date_sk", "ws_bill_addr_sk", "ws_ext_sales_price")}
    branches = {f"{c}{q}": _q31_channel(t, n_parts, *channels[c], q, f"{c}{q}")
                for c in ("ss", "ws") for q in (1, 2, 3)}
    j = branches["ss1"]
    for pre in ("ss2", "ss3", "ws1", "ws2", "ws3"):
        j = shuffle_join(j, branches[pre], [col("ss1_county")], [col(f"{pre}_county")], JoinType.INNER, n_parts,
                         build_left=False)

    def ratio(num, den):
        return col(num).cast(f64) / col(den).cast(f64)

    def guarded(num, den):
        return Case([(col(den).cast(f64) > lit(0.0), ratio(num, den))], None)

    f = FilterExec(j, (guarded("ws2_sales", "ws1_sales") > guarded("ss2_sales", "ss1_sales"))
                   | (guarded("ws3_sales", "ws2_sales") > guarded("ss3_sales", "ss2_sales")))
    proj = ProjectExec(f, [col("ss1_county").alias("ca_county"), lit(2000).alias("d_year"),
                           ratio("ws2_sales", "ws1_sales").alias("web_q1_q2_increase"),
                           ratio("ss2_sales", "ss1_sales").alias("store_q1_q2_increase"),
                           ratio("ws3_sales", "ws2_sales").alias("web_q2_q3_increase"),
                           ratio("ss3_sales", "ss2_sales").alias("store_q2_q3_increase")])
    return single_sorted(proj, [SortField(col("ca_county"))])


def q59(t: Dict[str, ExecNode], n_parts: int) -> ExecNode:
    """q2 per store over store sales: each 2001 week's day-of-week sales
    against the week 52 later (a shuffled join on (store, week))."""
    dt = ProjectExec(t["date_dim"], [col("d_date_sk"), col("d_week_seq"), col("d_dow")])
    sl = ProjectExec(t["store_sales"], [col("ss_sold_date_sk"), col("ss_store_sk"), col("ss_sales_price")])
    j = broadcast_join(dt, sl, [col("d_date_sk")], [col("ss_sold_date_sk")], JoinType.INNER, True)
    wk = _weekly_dow_pivot(j, n_parts, ["ss_store_sk", "d_week_seq"], "ss_sales_price")
    st = ProjectExec(t["store"], [col("s_store_sk"), col("s_store_name")])
    wk = broadcast_join(st, wk, [col("s_store_sk")], [col("ss_store_sk")], JoinType.INNER, True)
    wk1 = broadcast_join(_weeks_of(t, n_parts, 2001, "wk1"), wk, [col("wk1")], [col("d_week_seq")],
                         JoinType.LEFT_SEMI, False)
    wk1 = ProjectExec(wk1, [col("s_store_name"), col("ss_store_sk"), col("d_week_seq")]
                      + [col(f"{nm}_sales").alias(f"{nm}1") for nm in _DOW7])
    wk2 = broadcast_join(_weeks_of(t, n_parts, 2002, "wk2"), wk, [col("wk2")], [col("d_week_seq")],
                         JoinType.LEFT_SEMI, False)
    wk2 = ProjectExec(wk2, [col("ss_store_sk").alias("store2"), (col("d_week_seq") - lit(52)).alias("wk_m52")]
                      + [col(f"{nm}_sales").alias(f"{nm}2") for nm in _DOW7])
    j2 = shuffle_join(wk1, wk2, [col("ss_store_sk"), col("d_week_seq")], [col("store2"), col("wk_m52")],
                      JoinType.INNER, n_parts, build_left=False)
    proj = ProjectExec(j2, [col("s_store_name"), col("d_week_seq")] + _dow_ratio_projection())
    return single_sorted(proj, [SortField(col("s_store_name")), SortField(col("d_week_seq"))], fetch=100)


def q83(t: Dict[str, ExecNode], n_parts: int) -> ExecNode:
    """Each item's 2000 returned quantity in the three channels (two
    shuffled joins on the item id), each channel's share and the
    average."""
    dt = ProjectExec(FilterExec(t["date_dim"], col("d_year") == lit(2000)), [col("d_date_sk")])
    it = ProjectExec(t["item"], [col("i_item_sk"), col("i_item_id")])

    def channel(rtab, r_date, r_item, r_qty, nm):
        rt = ProjectExec(t[rtab], [col(r_date), col(r_item), col(r_qty)])
        j = broadcast_join(dt, rt, [col("d_date_sk")], [col(r_date)], JoinType.INNER, True)
        j = broadcast_join(it, j, [col("i_item_sk")], [col(r_item)], JoinType.INNER, True)
        return two_stage_agg(ProjectExec(j, [col("i_item_id").alias(f"{nm}_item_id"),
                                             col(r_qty).cast(i64).alias("q")]),
                             [GroupingExpr(col(f"{nm}_item_id"), f"{nm}_item_id")],
                             [AggFunction("sum", col("q"), f"{nm}_qty")], n_parts)

    sr = channel("store_returns", "sr_returned_date_sk", "sr_item_sk", "sr_return_quantity", "sr")
    cr = channel("catalog_returns", "cr_returned_date_sk", "cr_item_sk", "cr_return_quantity", "cr")
    wr = channel("web_returns", "wr_returned_date_sk", "wr_item_sk", "wr_return_quantity", "wr")
    j = shuffle_join(sr, cr, [col("sr_item_id")], [col("cr_item_id")], JoinType.INNER, n_parts, build_left=False)
    j = shuffle_join(j, wr, [col("sr_item_id")], [col("wr_item_id")], JoinType.INNER, n_parts, build_left=False)
    total = (col("sr_qty") + col("cr_qty") + col("wr_qty")).cast(f64)
    outs = [col("sr_item_id").alias("item_id"), col("sr_qty"), col("cr_qty"), col("wr_qty")]
    outs += [(col(f"{nm}_qty").cast(f64) / total * lit(100.0)).alias(f"{nm}_dev") for nm in ("sr", "cr", "wr")]
    proj = ProjectExec(j, outs + [(total / lit(3.0)).alias("average")])
    return single_sorted(proj, [SortField(col("item_id")), SortField(col("sr_qty"))], fetch=100)


def q85(t: Dict[str, ExecNode], n_parts: int) -> ExecNode:
    """Web sales joined to their returns (a shuffled join on (order,
    item)), the page, both demographics of the return, the refund
    address and the reason, kept by OR'd bands, three averages per
    reason.  As in the reference, the bands are widened and the
    education conjuncts dropped (the spec's select nothing from the
    generator)."""
    ws = ProjectExec(t["web_sales"], [col(c) for c in ("ws_item_sk", "ws_order_number", "ws_web_page_sk",
                                                       "ws_sold_date_sk", "ws_quantity", "ws_sales_price",
                                                       "ws_net_profit")])
    wr = ProjectExec(t["web_returns"], [col(c) for c in ("wr_item_sk", "wr_order_number", "wr_refunded_cdemo_sk",
                                                         "wr_returning_cdemo_sk", "wr_refunded_addr_sk",
                                                         "wr_reason_sk", "wr_refunded_cash", "wr_fee")])
    j = shuffle_join(ws, wr, [col("ws_order_number"), col("ws_item_sk")], [col("wr_order_number"), col("wr_item_sk")],
                     JoinType.INNER, n_parts, build_left=False)
    wp = ProjectExec(t["web_page"], [col("wp_web_page_sk")])
    j = broadcast_join(wp, j, [col("wp_web_page_sk")], [col("ws_web_page_sk")], JoinType.INNER, True)
    dt = ProjectExec(FilterExec(t["date_dim"], col("d_year") == lit(2000)), [col("d_date_sk")])
    j = broadcast_join(dt, j, [col("d_date_sk")], [col("ws_sold_date_sk")], JoinType.INNER, True)
    for nm, fk in (("cd1", "wr_refunded_cdemo_sk"), ("cd2", "wr_returning_cdemo_sk")):
        cd = ProjectExec(t["customer_demographics"], [col("cd_demo_sk").alias(f"{nm}_sk"),
                                                      col("cd_marital_status").alias(f"{nm}_ms")])
        j = broadcast_join(cd, j, [col(f"{nm}_sk")], [col(fk)], JoinType.INNER, True)
    ca = ProjectExec(t["customer_address"], [col("ca_address_sk"), col("ca_country"), col("ca_state")])
    j = broadcast_join(ca, j, [col("ca_address_sk")], [col("wr_refunded_addr_sk")], JoinType.INNER, True)
    rs = ProjectExec(t["reason"], [col("r_reason_sk"), col("r_reason_desc")])
    j = broadcast_join(rs, j, [col("r_reason_sk")], [col("wr_reason_sk")], JoinType.INNER, True)
    price, profit = col("ws_sales_price").cast(f64), col("ws_net_profit").cast(f64)

    def demo(ms, lo, hi):
        return ((col("cd1_ms") == lit(ms)) & (col("cd1_ms") == col("cd2_ms")) & (price >= lit(lo))
                & (price <= lit(hi)))

    def geo(states, lo, hi):
        return ((col("ca_country") == lit("United States")) & col("ca_state").isin(*[lit(s) for s in states])
                & (profit >= lit(lo)) & (profit <= lit(hi)))

    f = FilterExec(j, (demo("M", 0.0, 150.0) | demo("S", 50.0, 250.0) | demo("W", 100.0, 300.0))
                   & (geo(("OH", "TN", "SD"), -1000.0, 500.0) | geo(("AL", "GA", "SD"), 0.0, 1500.0)
                      | geo(("TN", "GA", "AL"), -500.0, 1000.0)))
    agg = two_stage_agg(f, [GroupingExpr(col("r_reason_desc"), "r")],
                        [AggFunction("avg", col("ws_quantity"), "avg_q"),
                         AggFunction("avg", col("wr_refunded_cash"), "avg_cash"),
                         AggFunction("avg", col("wr_fee"), "avg_fee")], n_parts)
    proj = ProjectExec(agg, [func("substring", col("r"), lit(1), lit(20)).alias("reason"), col("avg_q"),
                             col("avg_cash"), col("avg_fee")])
    return single_sorted(proj, [SortField(col(c)) for c in ("reason", "avg_q", "avg_cash", "avg_fee")], fetch=100)


def _q78_channel(t, n_parts, fact, date_c, item_c, cust_c, qty_c, wc_c, sp_c, rtab, r_item_c, r_key2_c, key2_c,
                 prefix):
    """One channel's never-returned lines of 2000 (a LEFT_ANTI shuffled
    join on (item, order or ticket)), summed per (item, customer)."""
    dt_p = ProjectExec(FilterExec(t["date_dim"], col("d_year") == lit(2000)), [col("d_date_sk")])
    sl = ProjectExec(t[fact], [col(c) for c in (date_c, item_c, cust_c, key2_c, qty_c, wc_c, sp_c)])
    j = broadcast_join(dt_p, sl, [col("d_date_sk")], [col(date_c)], JoinType.INNER, True)
    ret = ProjectExec(t[rtab], [col(r_item_c), col(r_key2_c)])
    j = shuffle_join(j, ret, [col(item_c), col(key2_c)], [col(r_item_c), col(r_key2_c)], JoinType.LEFT_ANTI, n_parts,
                     build_left=False)
    proj = ProjectExec(j, [col(item_c).alias(f"{prefix}_item_sk"), col(cust_c).alias(f"{prefix}_customer_sk"),
                           col(qty_c).cast(i64).alias("q"), col(wc_c), col(sp_c)])
    return two_stage_agg(proj, [GroupingExpr(col(f"{prefix}_item_sk"), f"{prefix}_item_sk"),
                                GroupingExpr(col(f"{prefix}_customer_sk"), f"{prefix}_customer_sk")],
                         [AggFunction("sum", col("q"), f"{prefix}_qty"), AggFunction("sum", col(wc_c), f"{prefix}_wc"),
                          AggFunction("sum", col(sp_c), f"{prefix}_sp")], n_parts)


def q78(t: Dict[str, ExecNode], n_parts: int) -> ExecNode:
    """Store sums per (item, customer) LEFT shuffle-joined with the web's
    and the catalog's, kept where another channel sold any."""
    ss = _q78_channel(t, n_parts, "store_sales", "ss_sold_date_sk", "ss_item_sk", "ss_customer_sk", "ss_quantity",
                      "ss_wholesale_cost", "ss_sales_price", "store_returns", "sr_item_sk", "sr_ticket_number",
                      "ss_ticket_number", "ss")
    ws = _q78_channel(t, n_parts, "web_sales", "ws_sold_date_sk", "ws_item_sk", "ws_bill_customer_sk", "ws_quantity",
                      "ws_wholesale_cost", "ws_sales_price", "web_returns", "wr_item_sk", "wr_order_number",
                      "ws_order_number", "ws")
    cs = _q78_channel(t, n_parts, "catalog_sales", "cs_sold_date_sk", "cs_item_sk", "cs_bill_customer_sk",
                      "cs_quantity", "cs_wholesale_cost", "cs_sales_price", "catalog_returns", "cr_item_sk",
                      "cr_order_number", "cs_order_number", "cs")
    keys = [col("ss_item_sk"), col("ss_customer_sk")]
    j = shuffle_join(ss, ws, keys, [col("ws_item_sk"), col("ws_customer_sk")], JoinType.LEFT, n_parts,
                     build_left=False)
    j = shuffle_join(j, cs, keys, [col("cs_item_sk"), col("cs_customer_sk")], JoinType.LEFT, n_parts,
                     build_left=False)

    def czero(c):
        return Case([(col(c).is_not_null(), col(c))], lit(0, i64))

    f = FilterExec(j, (czero("ws_qty") > lit(0, i64)) | (czero("cs_qty") > lit(0, i64)))
    other = (czero("ws_qty") + czero("cs_qty")).cast(f64)
    den = Case([(other > lit(0.0), other)], lit(1.0))
    proj = ProjectExec(f, [col("ss_item_sk"), col("ss_customer_sk"), col("ss_qty"), col("ss_wc"), col("ss_sp"),
                           (col("ss_qty").cast(f64) / den).alias("ratio"),
                           (czero("ws_qty") + czero("cs_qty")).alias("other_chan_qty")])
    return single_sorted(proj, [SortField(col("ss_qty"), ascending=False), SortField(col("ss_item_sk")),
                                SortField(col("ss_customer_sk"))], fetch=100)


def q97(t: Dict[str, ExecNode], n_parts: int) -> ExecNode:
    """The 2000 (customer, item) pairs of store and catalog sales, each
    set DISTINCT, FULL shuffle-joined and counted store only, catalog
    only and both."""
    dt_p = ProjectExec(FilterExec(t["date_dim"], col("d_year") == lit(2000)), [col("d_date_sk")])

    def pairs(fact, date_c, cust_c, item_c, pc, pi):
        sl = ProjectExec(t[fact], [col(date_c), col(cust_c), col(item_c)])
        j = broadcast_join(dt_p, sl, [col("d_date_sk")], [col(date_c)], JoinType.INNER, True)
        proj = ProjectExec(j, [col(cust_c).alias(pc), col(item_c).alias(pi)])
        return two_stage_agg(proj, [GroupingExpr(col(pc), pc), GroupingExpr(col(pi), pi)], [], n_parts)

    ss = pairs("store_sales", "ss_sold_date_sk", "ss_customer_sk", "ss_item_sk", "sc", "si")
    cs = pairs("catalog_sales", "cs_sold_date_sk", "cs_bill_customer_sk", "cs_item_sk", "cc", "ci")
    j = shuffle_join(ss, cs, [col("sc"), col("si")], [col("cc"), col("ci")], JoinType.FULL, n_parts, build_left=False)
    one, zero = lit(1, i64), lit(0, i64)
    store, cat = col("sc").is_not_null(), col("cc").is_not_null()
    flags = ProjectExec(j, [Case([(store & col("cc").is_null(), one)], zero).alias("store_only"),
                            Case([(col("sc").is_null() & cat, one)], zero).alias("catalog_only"),
                            Case([(store & cat, one)], zero).alias("store_and_catalog")])
    return two_stage_agg(flags, [], [AggFunction("sum", col(c), c) for c in ("store_only", "catalog_only",
                                                                             "store_and_catalog")], n_parts)


_Q64_COLORS = ("purple", "burlywood", "indian", "spring", "floral", "medium", "peach", "saddle", "navy", "slate")


def _q64_cross_sales(t, n_parts, year):
    """q64's cross_sales, cut as in the reference (the generator has no
    income bands, first-sale dates or address pairs): returned store
    lines of ``year`` (the year's slice before the shuffled (item,
    ticket) join) of ten colors, counts and cost sums per (item id,
    store, zip)."""
    sl = ProjectExec(t["store_sales"], [col(c) for c in ("ss_item_sk", "ss_ticket_number", "ss_store_sk",
                                                         "ss_sold_date_sk", "ss_wholesale_cost", "ss_list_price",
                                                         "ss_coupon_amt")])
    dt_p = ProjectExec(FilterExec(t["date_dim"], col("d_year") == lit(year)), [col("d_date_sk")])
    sl = broadcast_join(dt_p, sl, [col("d_date_sk")], [col("ss_sold_date_sk")], JoinType.INNER, True)
    sr = ProjectExec(t["store_returns"], [col("sr_item_sk"), col("sr_ticket_number")])
    j = shuffle_join(sl, sr, [col("ss_item_sk"), col("ss_ticket_number")], [col("sr_item_sk"), col("sr_ticket_number")],
                     JoinType.INNER, n_parts, build_left=False)
    it_p = ProjectExec(FilterExec(t["item"], col("i_color").isin(*[lit(c) for c in _Q64_COLORS])),
                       [col("i_item_sk"), col("i_item_id")])
    j = broadcast_join(it_p, j, [col("i_item_sk")], [col("ss_item_sk")], JoinType.INNER, True)
    st_p = ProjectExec(t["store"], [col("s_store_sk"), col("s_store_name"), col("s_zip")])
    j = broadcast_join(st_p, j, [col("s_store_sk")], [col("ss_store_sk")], JoinType.INNER, True)
    return two_stage_agg(j, [GroupingExpr(col(c), c) for c in ("i_item_id", "s_store_name", "s_zip")],
                         [AggFunction("count_star", None, "cnt"), AggFunction("sum", col("ss_wholesale_cost"), "s1"),
                          AggFunction("sum", col("ss_list_price"), "s2"),
                          AggFunction("sum", col("ss_coupon_amt"), "s3")], n_parts)


def q64(t: Dict[str, ExecNode], n_parts: int) -> ExecNode:
    """q64's cross_sales of 2001 and 2002 joined on (item id, store,
    zip), three string keys (a shuffled join through the plain murmur3),
    kept where 2002 repeats at most as often."""
    cs1 = _q64_cross_sales(t, n_parts, 2001)
    cs2 = ProjectExec(_q64_cross_sales(t, n_parts, 2002),
                      [col("i_item_id").alias("r_item_id"), col("s_store_name").alias("r_store_name"),
                       col("s_zip").alias("r_zip"), col("cnt").alias("cnt2"), col("s1").alias("s1_2"),
                       col("s2").alias("s2_2"), col("s3").alias("s3_2")])
    j = shuffle_join(cs1, cs2, [col("i_item_id"), col("s_store_name"), col("s_zip")],
                     [col("r_item_id"), col("r_store_name"), col("r_zip")], JoinType.INNER, n_parts, build_left=False)
    f = FilterExec(j, col("cnt2") <= col("cnt"))
    proj = ProjectExec(f, [col(c) for c in ("i_item_id", "s_store_name", "s_zip", "cnt", "s1", "s2", "s3", "cnt2",
                                            "s1_2", "s2_2", "s3_2")])
    return single_sorted(proj, [SortField(col("s1"), ascending=False), SortField(col("i_item_id")),
                                SortField(col("s_store_name")), SortField(col("s_zip"))], fetch=100)


def q72(t: Dict[str, ExecNode], n_parts: int) -> ExecNode:
    """Catalog lines of divorced '>10000'-potential buyers shipped over 5
    days after the sale, promised from a warehouse whose inventory in
    the sale's week held fewer than the quantity ordered: the lines
    shuffle-joined to all of ``inventory`` on the item, counted per
    (item, warehouse, week)."""
    hd_p = ProjectExec(FilterExec(t["household_demographics"], col("hd_buy_potential") == lit(">10000")),
                       [col("hd_demo_sk")])
    cd_p = ProjectExec(FilterExec(t["customer_demographics"], col("cd_marital_status") == lit("D")),
                       [col("cd_demo_sk")])
    d1 = ProjectExec(t["date_dim"], [col("d_date_sk"), col("d_date"), col("d_week_seq")])
    d3 = ProjectExec(t["date_dim"], [col("d_date_sk").alias("d3_date_sk"), col("d_date").alias("d3_date")])
    it = ProjectExec(t["item"], [col("i_item_sk"), col("i_item_desc")])
    wh = ProjectExec(t["warehouse"], [col("w_warehouse_sk"), col("w_warehouse_name")])
    d2 = ProjectExec(t["date_dim"], [col("d_date_sk").alias("d2_date_sk"), col("d_week_seq").alias("d2_week_seq")])
    cs = ProjectExec(t["catalog_sales"], [col(c) for c in ("cs_sold_date_sk", "cs_ship_date_sk", "cs_item_sk",
                                                           "cs_bill_cdemo_sk", "cs_bill_hdemo_sk", "cs_quantity")])
    j = broadcast_join(hd_p, cs, [col("hd_demo_sk")], [col("cs_bill_hdemo_sk")], JoinType.INNER, True)
    j = broadcast_join(cd_p, j, [col("cd_demo_sk")], [col("cs_bill_cdemo_sk")], JoinType.INNER, True)
    j = broadcast_join(d1, j, [col("d_date_sk")], [col("cs_sold_date_sk")], JoinType.INNER, True)
    j = broadcast_join(d3, j, [col("d3_date_sk")], [col("cs_ship_date_sk")], JoinType.INNER, True)
    j = FilterExec(j, col("d3_date").cast(i64) > (col("d_date").cast(i64) + lit(5, i64)))
    inv = ProjectExec(t["inventory"], [col(c) for c in ("inv_date_sk", "inv_item_sk", "inv_warehouse_sk",
                                                        "inv_quantity_on_hand")])
    j = shuffle_join(j, inv, [col("cs_item_sk")], [col("inv_item_sk")], JoinType.INNER, n_parts, build_left=True)
    j = broadcast_join(d2, j, [col("d2_date_sk")], [col("inv_date_sk")], JoinType.INNER, True)
    j = FilterExec(j, (col("d2_week_seq") == col("d_week_seq")) & (col("inv_quantity_on_hand") < col("cs_quantity")))
    j = broadcast_join(it, j, [col("i_item_sk")], [col("cs_item_sk")], JoinType.INNER, True)
    j = broadcast_join(wh, j, [col("w_warehouse_sk")], [col("inv_warehouse_sk")], JoinType.INNER, True)
    agg = two_stage_agg(j, [GroupingExpr(col(c), c) for c in ("i_item_desc", "w_warehouse_name", "d_week_seq")],
                        [AggFunction("count_star", None, "no_promo")], n_parts)
    return single_sorted(agg, [SortField(col("no_promo"), ascending=False), SortField(col("i_item_desc")),
                               SortField(col("w_warehouse_name")), SortField(col("d_week_seq"))], fetch=100)


#: the window family, in the order the tests and the smoke run it
WINDOW_QUERIES = ("q12", "q20", "q98", "q53", "q63", "q89", "q47", "q57", "q36", "q86", "q70", "q67", "q44", "q49",
                  "q51")
#: the rollup and union family, in the order the tests and the smoke run it
ROLLUP_UNION_QUERIES = ("q27", "q18", "q22", "q5", "q77", "q80", "q14a", "q33", "q56", "q60", "q71", "q76", "q66",
                        "q2", "q75", "q54", "q23a", "q23b")
#: the EXISTS/INTERSECT/EXCEPT family (q10, q35, q69, q38, q87), the
#: stddev family and the chain it shares (q17, q25, q29, q39a, q39b) and
#: q84's concat, in the order the tests and the smoke run them
EXISTS_STDDEV_QUERIES = ("q10", "q35", "q69", "q38", "q87", "q17", "q25", "q29", "q39a", "q39b", "q84")
#: the single-fact reports (broadcast joins into one fact table,
#: subqueries run while the plan is built, CASE pivots), in the order the
#: tests and the smoke run them
REPORT_QUERIES = ("q42", "q52", "q55", "q19", "q43", "q96", "q26", "q6", "q41", "q13", "q48", "q15", "q45", "q8",
                  "q91", "q34", "q73", "q46", "q68", "q79", "q9", "q28", "q88", "q90", "q61", "q62", "q99", "q21",
                  "q32", "q92", "q65")
#: the multi-fact, shuffled and self joins, in the order the tests and the
#: smoke run them (by shared helpers, the heaviest last)
JOINED_QUERIES = ("q1", "q30", "q81", "q94", "q95", "q16", "q74", "q11", "q4", "q37", "q82", "q40", "q50", "q93",
                  "q24a", "q24b", "q14b", "q58", "q31", "q59", "q83", "q85", "q78", "q97", "q64", "q72")

QUERIES: Dict[str, Callable[[Dict[str, ExecNode], int], ExecNode]] = {
    "q3": q3, "q7": q7,
    "q12": q12, "q20": q20, "q98": q98, "q53": q53, "q63": q63, "q89": q89, "q47": q47, "q57": q57,
    "q36": q36, "q86": q86, "q70": q70, "q67": q67, "q44": q44, "q49": q49, "q51": q51,
    "q27": q27, "q18": q18, "q22": q22, "q5": q5, "q77": q77, "q80": q80, "q14a": q14a, "q33": q33, "q56": q56,
    "q60": q60, "q71": q71, "q76": q76, "q66": q66, "q2": q2, "q75": q75, "q54": q54, "q23a": q23a, "q23b": q23b,
    "q10": q10, "q35": q35, "q69": q69, "q38": q38, "q87": q87, "q17": q17, "q25": q25, "q29": q29, "q39a": q39a,
    "q39b": q39b, "q84": q84,
    "q42": q42, "q52": q52, "q55": q55, "q19": q19, "q43": q43, "q96": q96, "q26": q26, "q6": q6, "q41": q41,
    "q13": q13, "q48": q48, "q15": q15, "q45": q45, "q8": q8, "q91": q91, "q34": q34, "q73": q73, "q46": q46,
    "q68": q68, "q79": q79, "q9": q9, "q28": q28, "q88": q88, "q90": q90, "q61": q61, "q62": q62, "q99": q99,
    "q21": q21, "q32": q32, "q92": q92, "q65": q65,
    "q1": q1, "q30": q30, "q81": q81, "q94": q94, "q95": q95, "q16": q16, "q74": q74, "q11": q11, "q4": q4,
    "q37": q37, "q82": q82, "q40": q40, "q50": q50, "q93": q93, "q24a": q24a, "q24b": q24b, "q14b": q14b,
    "q58": q58, "q31": q31, "q59": q59, "q83": q83, "q85": q85, "q78": q78, "q97": q97, "q64": q64, "q72": q72,
}


def build_query(name: str, tables: Dict[str, ExecNode], n_parts: int = 2) -> ExecNode:
    return QUERIES[name](tables, n_parts)
