"""TPC-H q01, q03, q04, q05, q06, q10, q12, q14 and q19 plans over the
port's operators (≙ the same builders in ``blaze_tpu/tpch/queries.py``,
node for node: the same exchanges, build sides and fetches).

Each builder takes a table -> ExecNode map (scans) and an output
parallelism and returns the root ExecNode; a caller runs
``plan.execute(p, TaskContext(p, n))`` over every partition.
"""

from __future__ import annotations

import datetime
from typing import Callable, Dict, List, Optional

from ..exprs.ir import Case, Expr, Like, col, lit
from ..ops import (
    AggExec,
    AggFunction,
    AggMode,
    ExecNode,
    FilterExec,
    GroupingExpr,
    LimitExec,
    ProjectExec,
    SortExec,
    SortField,
)
from ..ops.joins import BroadcastJoinExec, HashJoinExec, JoinType
from ..parallel.broadcast import BroadcastExchangeExec
from ..parallel.exchange import NativeShuffleExchangeExec
from ..parallel.shuffle import HashPartitioning, SinglePartitioning
from ..schema import DataType

D = datetime.date
dec12 = lambda v: lit(v, DataType.decimal(12, 2))


def two_stage_agg(child: ExecNode, groupings: List[GroupingExpr],
                  aggs: List[AggFunction], n_out: int) -> ExecNode:
    """partial -> exchange on the group keys -> final."""
    partial = AggExec(child, AggMode.PARTIAL, groupings, aggs, supports_partial_skipping=True)
    if groupings:
        part = HashPartitioning([col(g.name) for g in groupings], n_out)
    else:
        part = SinglePartitioning()
    ex = NativeShuffleExchangeExec(partial, part)
    return AggExec(ex, AggMode.FINAL, [GroupingExpr(col(g.name), g.name) for g in groupings], aggs)


def shuffle_join(left: ExecNode, right: ExecNode, left_keys: List[Expr], right_keys: List[Expr],
                 join_type: JoinType, n_parts: int, build_left: bool = True) -> ExecNode:
    """Both sides hash-exchanged on their keys; the left side builds
    unless ``build_left`` is False."""
    lex = NativeShuffleExchangeExec(left, HashPartitioning(left_keys, n_parts))
    rex = NativeShuffleExchangeExec(right, HashPartitioning(right_keys, n_parts))
    if build_left:
        return HashJoinExec(lex, rex, left_keys, right_keys, join_type, build_is_left=True)
    return HashJoinExec(rex, lex, right_keys, left_keys, join_type, build_is_left=False)


def broadcast_join(build: ExecNode, probe: ExecNode, build_keys: List[Expr],
                   probe_keys: List[Expr], join_type: JoinType, build_is_left: bool) -> ExecNode:
    return BroadcastJoinExec(BroadcastExchangeExec(build), probe, build_keys, probe_keys,
                             join_type, build_is_left)


def single_sorted(child: ExecNode, fields: List[SortField], fetch: Optional[int] = None) -> ExecNode:
    s = SortExec(NativeShuffleExchangeExec(child, SinglePartitioning()), fields, fetch=fetch)
    return LimitExec(s, fetch) if fetch is not None else s


def revenue_expr() -> Expr:
    """decimal(12,2) * decimal(13,2) -> decimal(26,4): a wide product."""
    return col("l_extendedprice") * (dec12(1) - col("l_discount"))


def q1(t: Dict[str, ExecNode], n_parts: int) -> ExecNode:
    f = FilterExec(t["lineitem"], col("l_shipdate") <= lit(D(1998, 9, 2)))
    disc_price = revenue_expr()
    # decimal(26,4) * decimal(13,2) -> decimal(38,6): a wide product
    charge = disc_price * (dec12(1) + col("l_tax"))
    proj = ProjectExec(
        f,
        [
            col("l_returnflag"), col("l_linestatus"), col("l_quantity"),
            col("l_extendedprice"), col("l_discount"),
            disc_price.alias("disc_price"), charge.alias("charge"),
        ],
    )
    agg = two_stage_agg(
        proj,
        [GroupingExpr(col("l_returnflag"), "l_returnflag"),
         GroupingExpr(col("l_linestatus"), "l_linestatus")],
        [
            AggFunction("sum", col("l_quantity"), "sum_qty"),
            AggFunction("sum", col("l_extendedprice"), "sum_base_price"),
            AggFunction("sum", col("disc_price"), "sum_disc_price"),
            AggFunction("sum", col("charge"), "sum_charge"),
            AggFunction("avg", col("l_quantity"), "avg_qty"),
            AggFunction("avg", col("l_extendedprice"), "avg_price"),
            AggFunction("avg", col("l_discount"), "avg_disc"),
            AggFunction("count_star", None, "count_order"),
        ],
        n_parts,
    )
    return single_sorted(agg, [SortField(col("l_returnflag")), SortField(col("l_linestatus"))])


def q3(t: Dict[str, ExecNode], n_parts: int) -> ExecNode:
    cust = FilterExec(t["customer"], col("c_mktsegment") == lit("BUILDING"))
    cust_p = ProjectExec(cust, [col("c_custkey")])
    orders = FilterExec(t["orders"], col("o_orderdate") < lit(D(1995, 3, 15)))
    orders_p = ProjectExec(orders, [col("o_orderkey"), col("o_custkey"), col("o_orderdate"),
                                    col("o_shippriority")])
    co = broadcast_join(cust_p, orders_p, [col("c_custkey")], [col("o_custkey")],
                        JoinType.INNER, build_is_left=True)
    line = FilterExec(t["lineitem"], col("l_shipdate") > lit(D(1995, 3, 15)))
    line_p = ProjectExec(line, [col("l_orderkey"), revenue_expr().alias("rev")])
    j = shuffle_join(co, line_p, [col("o_orderkey")], [col("l_orderkey")], JoinType.INNER, n_parts)
    agg = two_stage_agg(
        j,
        [GroupingExpr(col("o_orderkey"), "l_orderkey"),
         GroupingExpr(col("o_orderdate"), "o_orderdate"),
         GroupingExpr(col("o_shippriority"), "o_shippriority")],
        [AggFunction("sum", col("rev"), "revenue")],
        n_parts,
    )
    proj = ProjectExec(agg, [col("l_orderkey"), col("revenue"), col("o_orderdate"),
                             col("o_shippriority")])
    return single_sorted(
        proj,
        [SortField(col("revenue"), ascending=False), SortField(col("o_orderdate"))],
        fetch=10,
    )


def q6(t: Dict[str, ExecNode], n_parts: int) -> ExecNode:
    f = FilterExec(
        t["lineitem"],
        (col("l_shipdate") >= lit(D(1994, 1, 1)))
        & (col("l_shipdate") < lit(D(1995, 1, 1)))
        & (col("l_discount") >= dec12("0.05"))
        & (col("l_discount") <= dec12("0.07"))
        & (col("l_quantity") < dec12(24)),
    )
    proj = ProjectExec(f, [(col("l_extendedprice") * col("l_discount")).alias("rev")])
    return two_stage_agg(proj, [], [AggFunction("sum", col("rev"), "revenue")], n_parts)


def q4(t: Dict[str, ExecNode], n_parts: int) -> ExecNode:
    orders = FilterExec(
        t["orders"],
        (col("o_orderdate") >= lit(D(1993, 7, 1))) & (col("o_orderdate") < lit(D(1993, 10, 1))),
    )
    orders_p = ProjectExec(orders, [col("o_orderkey"), col("o_orderpriority")])
    line = FilterExec(t["lineitem"], col("l_commitdate") < col("l_receiptdate"))
    line_p = ProjectExec(line, [col("l_orderkey")])
    # left semi join: the orders survive, lineitem builds
    j = shuffle_join(orders_p, line_p, [col("o_orderkey")], [col("l_orderkey")], JoinType.LEFT_SEMI,
                     n_parts, build_left=False)
    agg = two_stage_agg(
        j,
        [GroupingExpr(col("o_orderpriority"), "o_orderpriority")],
        [AggFunction("count_star", None, "order_count")],
        n_parts,
    )
    return single_sorted(agg, [SortField(col("o_orderpriority"))])


def q5(t: Dict[str, ExecNode], n_parts: int) -> ExecNode:
    region = FilterExec(t["region"], col("r_name") == lit("ASIA"))
    nation = broadcast_join(ProjectExec(region, [col("r_regionkey")]), t["nation"],
                            [col("r_regionkey")], [col("n_regionkey")], JoinType.INNER, build_is_left=True)
    nation_p = ProjectExec(nation, [col("n_nationkey"), col("n_name")])
    supp = broadcast_join(nation_p, t["supplier"], [col("n_nationkey")], [col("s_nationkey")],
                          JoinType.INNER, build_is_left=True)
    supp_p = ProjectExec(supp, [col("s_suppkey"), col("s_nationkey"), col("n_name")])
    orders = FilterExec(
        t["orders"],
        (col("o_orderdate") >= lit(D(1994, 1, 1))) & (col("o_orderdate") < lit(D(1995, 1, 1))),
    )
    orders_p = ProjectExec(orders, [col("o_orderkey"), col("o_custkey")])
    cust_p = ProjectExec(t["customer"], [col("c_custkey"), col("c_nationkey")])
    co = shuffle_join(cust_p, orders_p, [col("c_custkey")], [col("o_custkey")], JoinType.INNER, n_parts)
    co_p = ProjectExec(co, [col("o_orderkey"), col("c_nationkey")])
    line_p = ProjectExec(t["lineitem"], [col("l_orderkey"), col("l_suppkey"), revenue_expr().alias("rev")])
    col_j = shuffle_join(co_p, line_p, [col("o_orderkey")], [col("l_orderkey")], JoinType.INNER, n_parts)
    # a two-key broadcast join: l_suppkey = s_suppkey and c_nationkey = s_nationkey
    full = broadcast_join(supp_p, col_j, [col("s_suppkey"), col("s_nationkey")],
                          [col("l_suppkey"), col("c_nationkey")], JoinType.INNER, build_is_left=True)
    agg = two_stage_agg(full, [GroupingExpr(col("n_name"), "n_name")],
                        [AggFunction("sum", col("rev"), "revenue")], n_parts)
    return single_sorted(agg, [SortField(col("revenue"), ascending=False)])


def q10(t: Dict[str, ExecNode], n_parts: int) -> ExecNode:
    orders = FilterExec(
        t["orders"],
        (col("o_orderdate") >= lit(D(1993, 10, 1))) & (col("o_orderdate") < lit(D(1994, 1, 1))),
    )
    orders_p = ProjectExec(orders, [col("o_orderkey"), col("o_custkey")])
    line = FilterExec(t["lineitem"], col("l_returnflag") == lit("R"))
    line_p = ProjectExec(line, [col("l_orderkey"), revenue_expr().alias("rev")])
    ol = shuffle_join(orders_p, line_p, [col("o_orderkey")], [col("l_orderkey")], JoinType.INNER, n_parts)
    ol_p = ProjectExec(ol, [col("o_custkey"), col("rev")])
    col_j = shuffle_join(t["customer"], ol_p, [col("c_custkey")], [col("o_custkey")], JoinType.INNER, n_parts)
    nat = broadcast_join(ProjectExec(t["nation"], [col("n_nationkey"), col("n_name")]), col_j,
                         [col("n_nationkey")], [col("c_nationkey")], JoinType.INNER, build_is_left=True)
    agg = two_stage_agg(
        nat,
        [GroupingExpr(col(c), c) for c in ("c_custkey", "c_name", "c_acctbal", "c_phone", "n_name",
                                            "c_address", "c_comment")],
        [AggFunction("sum", col("rev"), "revenue")],
        n_parts,
    )
    return single_sorted(agg, [SortField(col("revenue"), ascending=False)], fetch=20)


def q12(t: Dict[str, ExecNode], n_parts: int) -> ExecNode:
    line = FilterExec(
        t["lineitem"],
        col("l_shipmode").isin("MAIL", "SHIP")
        & (col("l_commitdate") < col("l_receiptdate"))
        & (col("l_shipdate") < col("l_commitdate"))
        & (col("l_receiptdate") >= lit(D(1994, 1, 1)))
        & (col("l_receiptdate") < lit(D(1995, 1, 1))),
    )
    line_p = ProjectExec(line, [col("l_orderkey"), col("l_shipmode")])
    orders_p = ProjectExec(t["orders"], [col("o_orderkey"), col("o_orderpriority")])
    j = shuffle_join(line_p, orders_p, [col("l_orderkey")], [col("o_orderkey")], JoinType.INNER, n_parts)
    urgent = col("o_orderpriority").isin("1-URGENT", "2-HIGH")
    high = Case([(urgent, lit(1))], lit(0))
    low = Case([(urgent, lit(0))], lit(1))
    proj = ProjectExec(j, [col("l_shipmode"), high.alias("h"), low.alias("l")])
    agg = two_stage_agg(
        proj,
        [GroupingExpr(col("l_shipmode"), "l_shipmode")],
        [AggFunction("sum", col("h"), "high_line_count"), AggFunction("sum", col("l"), "low_line_count")],
        n_parts,
    )
    return single_sorted(agg, [SortField(col("l_shipmode"))])


def q14(t: Dict[str, ExecNode], n_parts: int) -> ExecNode:
    line = FilterExec(
        t["lineitem"],
        (col("l_shipdate") >= lit(D(1995, 9, 1))) & (col("l_shipdate") < lit(D(1995, 10, 1))),
    )
    line_p = ProjectExec(line, [col("l_partkey"), revenue_expr().alias("rev")])
    part_p = ProjectExec(t["part"], [col("p_partkey"), col("p_type")])
    j = broadcast_join(part_p, line_p, [col("p_partkey")], [col("l_partkey")], JoinType.INNER,
                       build_is_left=True)
    promo = Case([(Like(col("p_type"), "PROMO%"), col("rev"))], lit(0))
    proj = ProjectExec(j, [promo.alias("promo_rev"), col("rev")])
    agg = two_stage_agg(proj, [], [AggFunction("sum", col("promo_rev"), "sp"),
                                   AggFunction("sum", col("rev"), "sr")], n_parts)
    # decimal(38,6) / decimal(36,4): the int128 quotient, HALF_UP
    pct = (lit("100.00", DataType.decimal(5, 2)) * col("sp")) / col("sr")
    return ProjectExec(agg, [pct.alias("promo_revenue")])


def q19(t: Dict[str, ExecNode], n_parts: int) -> ExecNode:
    line = FilterExec(
        t["lineitem"],
        col("l_shipmode").isin("AIR", "REG AIR") & (col("l_shipinstruct") == lit("DELIVER IN PERSON")),
    )
    line_p = ProjectExec(line, [col("l_partkey"), col("l_quantity"), revenue_expr().alias("rev")])
    part_p = ProjectExec(t["part"], [col("p_partkey"), col("p_brand"), col("p_container"), col("p_size")])
    j = broadcast_join(part_p, line_p, [col("p_partkey")], [col("l_partkey")], JoinType.INNER,
                       build_is_left=True)
    qty = col("l_quantity")

    def branch(brand: str, containers, q_lo: int, q_hi: int, size_hi: int) -> Expr:
        return ((col("p_brand") == lit(brand)) & col("p_container").isin(*containers)
                & (qty >= dec12(q_lo)) & (qty <= dec12(q_hi))
                & (col("p_size") >= lit(1)) & (col("p_size") <= lit(size_hi)))

    f = FilterExec(j, branch("Brand#12", ("SM CASE", "SM BOX", "SM PACK", "SM PKG"), 1, 11, 5)
                   | branch("Brand#23", ("MED BAG", "MED BOX", "MED PKG", "MED PACK"), 10, 20, 10)
                   | branch("Brand#34", ("LG CASE", "LG BOX", "LG PACK", "LG PKG"), 20, 30, 15))
    proj = ProjectExec(f, [col("rev")])
    return two_stage_agg(proj, [], [AggFunction("sum", col("rev"), "revenue")], n_parts)


QUERIES: Dict[str, Callable[[Dict[str, ExecNode], int], ExecNode]] = {
    "q1": q1, "q3": q3, "q4": q4, "q5": q5, "q6": q6, "q10": q10, "q12": q12, "q14": q14, "q19": q19,
}


def build_query(name: str, tables: Dict[str, ExecNode], n_parts: int = 2) -> ExecNode:
    return QUERIES[name](tables, n_parts)
