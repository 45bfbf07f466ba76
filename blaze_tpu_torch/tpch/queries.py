"""TPC-H q01, q03 and q06 plans over the port's operators (≙ the same
builders in ``blaze_tpu/tpch/queries.py``, node for node).

Each builder takes a table -> ExecNode map (scans) and an output
parallelism and returns the root ExecNode; a caller runs
``plan.execute(p, TaskContext(p, n))`` over every partition.
"""

from __future__ import annotations

import datetime
from typing import Callable, Dict, List, Optional

from ..exprs.ir import Expr, col, lit
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
                 join_type: JoinType, n_parts: int) -> ExecNode:
    """Both sides hash-exchanged on their keys; the left side builds."""
    lex = NativeShuffleExchangeExec(left, HashPartitioning(left_keys, n_parts))
    rex = NativeShuffleExchangeExec(right, HashPartitioning(right_keys, n_parts))
    return HashJoinExec(lex, rex, left_keys, right_keys, join_type, build_is_left=True)


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


QUERIES: Dict[str, Callable[[Dict[str, ExecNode], int], ExecNode]] = {"q1": q1, "q3": q3, "q6": q6}


def build_query(name: str, tables: Dict[str, ExecNode], n_parts: int = 2) -> ExecNode:
    return QUERIES[name](tables, n_parts)
