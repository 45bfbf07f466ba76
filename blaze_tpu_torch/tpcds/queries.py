"""TPC-DS q03 and q07 plans over the port's operators (≙ the same
builders in ``blaze_tpu/tpcds/queries.py``, node for node): star
schemas of broadcast joins into ``store_sales``, two-stage
aggregations and a sorted top 100."""

from __future__ import annotations

from typing import Callable, Dict

from ..exprs.ir import col, lit
from ..ops import AggFunction, ExecNode, FilterExec, GroupingExpr, ProjectExec, SortField
from ..ops.joins import JoinType
from ..tpch.queries import broadcast_join, single_sorted, two_stage_agg


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


QUERIES: Dict[str, Callable[[Dict[str, ExecNode], int], ExecNode]] = {"q3": q3, "q7": q7}


def build_query(name: str, tables: Dict[str, ExecNode], n_parts: int = 2) -> ExecNode:
    return QUERIES[name](tables, n_parts)
