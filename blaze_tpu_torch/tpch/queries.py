"""The 22 TPC-H query plans over the port's operators (≙ the same
plan functions in ``blaze_tpu/tpch/queries.py``, node for node: the same
exchanges, build sides and fetches).

Each builder takes a table -> ExecNode map (scans) and an output
parallelism and returns the root ExecNode; a caller runs
``plan.execute(p, TaskContext(p, n))`` over every partition.  q11, q15
and q22 run a scalar subquery while their plan is built
(:func:`scalar_subquery`): its value enters the plan as a literal.
"""

from __future__ import annotations

import datetime
from typing import Callable, Dict, List, Optional

from ..exprs.ir import Case, Expr, Like, Lit, col, func, lit
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


def collect_columns(plan: ExecNode, columns: List[str], limit: Optional[int] = None) -> Dict[str, list]:
    """Runs a subplan now, in process, partition by partition, and
    returns each requested column's values: every row, or the first
    ``limit`` rows (the run stops once it has them).  Every subquery
    that a plan runs while it is built goes through here."""
    from ..batch import batch_to_pydict
    from ..runtime.context import TaskContext

    out: Dict[str, list] = {c: [] for c in columns}
    n = plan.num_partitions()
    for p in range(n):
        for b in plan.execute(p, TaskContext(p, n)):
            d = batch_to_pydict(b)
            for c in columns:
                out[c].extend(d[c])
            if limit is not None and len(out[columns[0]]) >= limit:
                return {c: v[:limit] for c, v in out.items()}
    return out


def scalar_subquery_row(plan: ExecNode, columns: List[str]) -> List[Expr]:
    """Runs a subplan of at most one row now, in process, and returns
    each requested column of its first row as a typed literal (null
    when it has no row); a decimal is carried unscaled
    (``Lit(..., unscaled=True)``), as the plan contract carries it."""
    rows = collect_columns(plan, columns, limit=1)
    out: List[Expr] = []
    for c in columns:
        t = plan.schema.field(c).dtype
        v = rows[c][0] if rows[c] else None
        out.append(Lit(v, t, unscaled=t.is_decimal and v is not None))
    return out


def scalar_subquery(plan: ExecNode, column: str) -> Expr:
    return scalar_subquery_row(plan, [column])[0]


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


def _q3_customer_orders(t: Dict[str, ExecNode]) -> ExecNode:
    cust = FilterExec(t["customer"], col("c_mktsegment") == lit("BUILDING"))
    cust_p = ProjectExec(cust, [col("c_custkey")])
    orders = FilterExec(t["orders"], col("o_orderdate") < lit(D(1995, 3, 15)))
    orders_p = ProjectExec(orders, [col("o_orderkey"), col("o_custkey"), col("o_orderdate"),
                                    col("o_shippriority")])
    return broadcast_join(cust_p, orders_p, [col("c_custkey")], [col("o_custkey")],
                          JoinType.INNER, build_is_left=True)


def _q3_tail(co: ExecNode, line: ExecNode, n_parts: int) -> ExecNode:
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


def q3(t: Dict[str, ExecNode], n_parts: int) -> ExecNode:
    line = FilterExec(t["lineitem"], col("l_shipdate") > lit(D(1995, 3, 15)))
    return _q3_tail(_q3_customer_orders(t), line, n_parts)


def q3_bloom_payload(t: Dict[str, ExecNode], n_parts: int, expected_items: int = 1_000_000) -> bytes:
    """The creation side of q03's runtime filter, run now, in process:
    ``bloom_filter_agg(xxhash64(o_orderkey))`` over q03's filtered
    orders joined to its customers (PARTIAL per partition, one exchange,
    FINAL), on a subtree of its own.  Returns the serialized filter."""
    from ..ops import BloomFilterAggExec

    key = func("xxhash64", col("o_orderkey"))
    partial = BloomFilterAggExec(_q3_customer_orders(t), key, "bloom", AggMode.PARTIAL, expected_items)
    final = BloomFilterAggExec(NativeShuffleExchangeExec(partial, SinglePartitioning()), None, "bloom",
                               AggMode.FINAL, expected_items)
    return collect_columns(final, ["bloom"])["bloom"][0]


def q3_runtime_filter(t: Dict[str, ExecNode], n_parts: int, expected_items: int = 1_000_000) -> ExecNode:
    """q03 with the runtime filter Spark 3.5's InjectRuntimeFilter plants
    on its shuffled join: the creation side's bloom filter
    (:func:`q3_bloom_payload`) enters as a BINARY literal, and
    ``might_contain(filter, xxhash64(l_orderkey))`` filters the
    ``lineitem`` scan, under q03's own filter and below its hash
    exchange.  The rows are q03's."""
    from ..schema import string_width_for

    payload = q3_bloom_payload(t, n_parts, expected_items)
    bloom = Lit(payload, DataType.binary(string_width_for(len(payload))))
    line = FilterExec(t["lineitem"], func("might_contain", bloom, func("xxhash64", col("l_orderkey"))))
    line = FilterExec(line, col("l_shipdate") > lit(D(1995, 3, 15)))
    return _q3_tail(_q3_customer_orders(t), line, n_parts)


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


def q2(t: Dict[str, ExecNode], n_parts: int) -> ExecNode:
    region = FilterExec(t["region"], col("r_name") == lit("EUROPE"))
    nation = broadcast_join(
        ProjectExec(region, [col("r_regionkey")]), t["nation"],
        [col("r_regionkey")], [col("n_regionkey")], JoinType.INNER, build_is_left=True,
    )
    nation_p = ProjectExec(nation, [col("n_nationkey"), col("n_name")])
    supp = broadcast_join(
        nation_p, t["supplier"], [col("n_nationkey")], [col("s_nationkey")],
        JoinType.INNER, build_is_left=True,
    )
    supp_p = ProjectExec(
        supp,
        [col("s_suppkey"), col("s_name"), col("s_address"), col("s_phone"),
         col("s_acctbal"), col("s_comment"), col("n_name")],
    )
    ps = broadcast_join(
        supp_p, t["partsupp"], [col("s_suppkey")], [col("ps_suppkey")],
        JoinType.INNER, build_is_left=True,
    )
    part_f = FilterExec(
        t["part"], (col("p_size") == lit(15)) & Like(col("p_type"), "%BRASS")
    )
    part_p = ProjectExec(part_f, [col("p_partkey"), col("p_mfgr")])
    joined = broadcast_join(
        part_p, ps, [col("p_partkey")], [col("ps_partkey")], JoinType.INNER,
        build_is_left=True,
    )
    mincost = two_stage_agg(
        joined,
        [GroupingExpr(col("p_partkey"), "mk")],
        [AggFunction("min", col("ps_supplycost"), "mc")],
        n_parts,
    )
    withmin = shuffle_join(
        joined, mincost, [col("p_partkey")], [col("mk")], JoinType.INNER, n_parts
    )
    best = FilterExec(withmin, col("ps_supplycost") == col("mc"))
    proj = ProjectExec(
        best,
        [col("s_acctbal"), col("s_name"), col("n_name"), col("p_partkey"),
         col("p_mfgr"), col("s_address"), col("s_phone"), col("s_comment")],
    )
    return single_sorted(
        proj,
        [SortField(col("s_acctbal"), ascending=False), SortField(col("n_name")),
         SortField(col("s_name")), SortField(col("p_partkey"))],
        fetch=100,
    )


def q7(t: Dict[str, ExecNode], n_parts: int) -> ExecNode:
    nations = FilterExec(t["nation"], col("n_name").isin("FRANCE", "GERMANY"))
    nations_p = ProjectExec(nations, [col("n_nationkey"), col("n_name")])
    supp = broadcast_join(
        nations_p, t["supplier"], [col("n_nationkey")], [col("s_nationkey")],
        JoinType.INNER, build_is_left=True,
    )
    supp_p = ProjectExec(supp, [col("s_suppkey"), col("n_name").alias("supp_nation")])
    cust = broadcast_join(
        ProjectExec(nations, [col("n_nationkey"), col("n_name").alias("cust_nation")]),
        t["customer"], [col("n_nationkey")], [col("c_nationkey")],
        JoinType.INNER, build_is_left=True,
    )
    cust_p = ProjectExec(cust, [col("c_custkey"), col("cust_nation")])
    orders_p = ProjectExec(t["orders"], [col("o_orderkey"), col("o_custkey")])
    co = shuffle_join(cust_p, orders_p, [col("c_custkey")], [col("o_custkey")], JoinType.INNER, n_parts)
    co_p = ProjectExec(co, [col("o_orderkey"), col("cust_nation")])
    line = FilterExec(
        t["lineitem"],
        (col("l_shipdate") >= lit(D(1995, 1, 1))) & (col("l_shipdate") <= lit(D(1996, 12, 31))),
    )
    line_p = ProjectExec(
        line,
        [col("l_orderkey"), col("l_suppkey"), col("l_shipdate"), revenue_expr().alias("volume")],
    )
    lco = shuffle_join(co_p, line_p, [col("o_orderkey")], [col("l_orderkey")], JoinType.INNER, n_parts)
    full = broadcast_join(
        supp_p, lco, [col("s_suppkey")], [col("l_suppkey")], JoinType.INNER, build_is_left=True
    )
    pair = FilterExec(
        full,
        ((col("supp_nation") == lit("FRANCE")) & (col("cust_nation") == lit("GERMANY")))
        | ((col("supp_nation") == lit("GERMANY")) & (col("cust_nation") == lit("FRANCE"))),
    )
    proj = ProjectExec(
        pair,
        [col("supp_nation"), col("cust_nation"),
         func("year", col("l_shipdate")).alias("l_year"), col("volume")],
    )
    agg = two_stage_agg(
        proj,
        [GroupingExpr(col("supp_nation"), "supp_nation"),
         GroupingExpr(col("cust_nation"), "cust_nation"),
         GroupingExpr(col("l_year"), "l_year")],
        [AggFunction("sum", col("volume"), "revenue")],
        n_parts,
    )
    return single_sorted(
        agg,
        [SortField(col("supp_nation")), SortField(col("cust_nation")), SortField(col("l_year"))],
    )


def q9(t: Dict[str, ExecNode], n_parts: int) -> ExecNode:
    part_f = FilterExec(t["part"], Like(col("p_name"), "%green%"))
    part_p = ProjectExec(part_f, [col("p_partkey")])
    line_p = ProjectExec(
        t["lineitem"],
        [col("l_orderkey"), col("l_partkey"), col("l_suppkey"), col("l_quantity"),
         revenue_expr().alias("gross")],
    )
    lp = broadcast_join(
        part_p, line_p, [col("p_partkey")], [col("l_partkey")], JoinType.INNER,
        build_is_left=True,
    )
    ps_p = ProjectExec(
        t["partsupp"], [col("ps_partkey"), col("ps_suppkey"), col("ps_supplycost")]
    )
    lps = shuffle_join(
        lp, ps_p,
        [col("l_partkey"), col("l_suppkey")], [col("ps_partkey"), col("ps_suppkey")],
        JoinType.INNER, n_parts,
    )
    orders_p = ProjectExec(t["orders"], [col("o_orderkey"), col("o_orderdate")])
    lo = shuffle_join(lps, orders_p, [col("l_orderkey")], [col("o_orderkey")], JoinType.INNER, n_parts)
    supp_n = broadcast_join(
        ProjectExec(t["nation"], [col("n_nationkey"), col("n_name")]), t["supplier"],
        [col("n_nationkey")], [col("s_nationkey")], JoinType.INNER, build_is_left=True,
    )
    supp_p = ProjectExec(supp_n, [col("s_suppkey"), col("n_name")])
    full = broadcast_join(
        supp_p, lo, [col("s_suppkey")], [col("l_suppkey")], JoinType.INNER, build_is_left=True
    )
    amount = col("gross") - col("ps_supplycost") * col("l_quantity")
    proj = ProjectExec(
        full,
        [col("n_name").alias("nation"), func("year", col("o_orderdate")).alias("o_year"),
         amount.alias("amount")],
    )
    agg = two_stage_agg(
        proj,
        [GroupingExpr(col("nation"), "nation"), GroupingExpr(col("o_year"), "o_year")],
        [AggFunction("sum", col("amount"), "sum_profit")],
        n_parts,
    )
    return single_sorted(
        agg, [SortField(col("nation")), SortField(col("o_year"), ascending=False)]
    )


def _q11_partsupp(t: Dict[str, ExecNode]) -> ExecNode:
    """GERMANY's suppliers' partsupp rows."""
    nation = FilterExec(t["nation"], col("n_name") == lit("GERMANY"))
    supp = broadcast_join(
        ProjectExec(nation, [col("n_nationkey")]), t["supplier"],
        [col("n_nationkey")], [col("s_nationkey")], JoinType.INNER, build_is_left=True,
    )
    supp_p = ProjectExec(supp, [col("s_suppkey")])
    return broadcast_join(
        supp_p, t["partsupp"], [col("s_suppkey")], [col("ps_suppkey")],
        JoinType.INNER, build_is_left=True,
    )


def q11(t: Dict[str, ExecNode], n_parts: int) -> ExecNode:
    value = col("ps_supplycost") * col("ps_availqty").cast(DataType.decimal(10, 0))
    # the scalar subquery runs on a subtree of its own, as Spark plans
    # it apart from the main plan: the main plan shares no exchange or
    # broadcast whose output the subquery's run would leave behind
    total = two_stage_agg(
        ProjectExec(_q11_partsupp(t), [value.alias("v")]), [],
        [AggFunction("sum", col("v"), "tv")], n_parts,
    )
    threshold_plan = ProjectExec(
        total, [(col("tv").cast(DataType.float64()) * lit(0.0001)).alias("thr")]
    )
    thr = scalar_subquery(threshold_plan, "thr")
    proj = ProjectExec(_q11_partsupp(t), [col("ps_partkey"), value.alias("v")])
    agg = two_stage_agg(
        proj,
        [GroupingExpr(col("ps_partkey"), "ps_partkey")],
        [AggFunction("sum", col("v"), "value")],
        n_parts,
    )
    having = FilterExec(agg, col("value").cast(DataType.float64()) > thr)
    return single_sorted(having, [SortField(col("value"), ascending=False)])


def q13(t: Dict[str, ExecNode], n_parts: int) -> ExecNode:
    orders = FilterExec(
        t["orders"], Like(col("o_comment"), "%special%requests%", negated=True)
    )
    orders_p = ProjectExec(orders, [col("o_orderkey"), col("o_custkey")])
    cust_p = ProjectExec(t["customer"], [col("c_custkey")])
    cex = NativeShuffleExchangeExec(cust_p, HashPartitioning([col("c_custkey")], n_parts))
    oex = NativeShuffleExchangeExec(orders_p, HashPartitioning([col("o_custkey")], n_parts))
    # LEFT outer preserving customer (probe side)
    j = HashJoinExec(oex, cex, [col("o_custkey")], [col("c_custkey")], JoinType.LEFT, build_is_left=False)
    counts = two_stage_agg(
        j,
        [GroupingExpr(col("c_custkey"), "c_custkey")],
        [AggFunction("count", col("o_orderkey"), "c_count")],
        n_parts,
    )
    hist = two_stage_agg(
        counts,
        [GroupingExpr(col("c_count"), "c_count")],
        [AggFunction("count_star", None, "custdist")],
        n_parts,
    )
    return single_sorted(
        hist,
        [SortField(col("custdist"), ascending=False), SortField(col("c_count"), ascending=False)],
    )


def distinct_rows(child: ExecNode, names: List[str], n_parts: int) -> ExecNode:
    """DISTINCT via group-by-all-columns (the Spark rewrite)."""
    return two_stage_agg(
        child, [GroupingExpr(col(nm), nm) for nm in names], [], n_parts
    )


def q8(t: Dict[str, ExecNode], n_parts: int) -> ExecNode:
    region = FilterExec(t["region"], col("r_name") == lit("AMERICA"))
    am_nations = broadcast_join(
        ProjectExec(region, [col("r_regionkey")]), t["nation"],
        [col("r_regionkey")], [col("n_regionkey")], JoinType.INNER, build_is_left=True,
    )
    am_cust = broadcast_join(
        ProjectExec(am_nations, [col("n_nationkey")]), t["customer"],
        [col("n_nationkey")], [col("c_nationkey")], JoinType.INNER, build_is_left=True,
    )
    cust_p = ProjectExec(am_cust, [col("c_custkey")])
    orders = FilterExec(
        t["orders"],
        (col("o_orderdate") >= lit(D(1995, 1, 1))) & (col("o_orderdate") <= lit(D(1996, 12, 31))),
    )
    orders_p = ProjectExec(orders, [col("o_orderkey"), col("o_custkey"), col("o_orderdate")])
    co = broadcast_join(
        cust_p, orders_p, [col("c_custkey")], [col("o_custkey")], JoinType.INNER,
        build_is_left=True,
    )
    co_p = ProjectExec(co, [col("o_orderkey"), col("o_orderdate")])
    part_f = FilterExec(t["part"], col("p_type") == lit("ECONOMY ANODIZED STEEL"))
    line_p = ProjectExec(
        t["lineitem"],
        [col("l_orderkey"), col("l_partkey"), col("l_suppkey"), revenue_expr().alias("volume")],
    )
    lp = broadcast_join(
        ProjectExec(part_f, [col("p_partkey")]), line_p,
        [col("p_partkey")], [col("l_partkey")], JoinType.INNER, build_is_left=True,
    )
    lo = shuffle_join(co_p, lp, [col("o_orderkey")], [col("l_orderkey")], JoinType.INNER, n_parts)
    supp_n = broadcast_join(
        ProjectExec(t["nation"], [col("n_nationkey"), col("n_name")]), t["supplier"],
        [col("n_nationkey")], [col("s_nationkey")], JoinType.INNER, build_is_left=True,
    )
    supp_p = ProjectExec(supp_n, [col("s_suppkey"), col("n_name")])
    full = broadcast_join(
        supp_p, lo, [col("s_suppkey")], [col("l_suppkey")], JoinType.INNER, build_is_left=True
    )
    brazil_vol = Case([(col("n_name") == lit("BRAZIL"), col("volume"))], lit(0))
    proj = ProjectExec(
        full,
        [func("year", col("o_orderdate")).alias("o_year"),
         col("volume"), brazil_vol.alias("brazil_volume")],
    )
    agg = two_stage_agg(
        proj,
        [GroupingExpr(col("o_year"), "o_year")],
        [AggFunction("sum", col("brazil_volume"), "sb"),
         AggFunction("sum", col("volume"), "sv")],
        n_parts,
    )
    share = col("sb").cast(DataType.float64()) / col("sv").cast(DataType.float64())
    proj2 = ProjectExec(agg, [col("o_year"), share.alias("mkt_share")])
    return single_sorted(proj2, [SortField(col("o_year"))])


def _q15_revenue(t: Dict[str, ExecNode], n_parts: int) -> ExecNode:
    """The revenue view: total_revenue per supplier_no in 1996 Q1."""
    line = FilterExec(
        t["lineitem"],
        (col("l_shipdate") >= lit(D(1996, 1, 1))) & (col("l_shipdate") < lit(D(1996, 4, 1))),
    )
    line_p = ProjectExec(line, [col("l_suppkey"), revenue_expr().alias("rev")])
    return two_stage_agg(
        line_p,
        [GroupingExpr(col("l_suppkey"), "supplier_no")],
        [AggFunction("sum", col("rev"), "total_revenue")],
        n_parts,
    )


def q15(t: Dict[str, ExecNode], n_parts: int) -> ExecNode:
    # the subquery reads a revenue view of its own (see q11)
    max_plan = two_stage_agg(
        _q15_revenue(t, n_parts), [], [AggFunction("max", col("total_revenue"), "m")], n_parts
    )
    m = scalar_subquery(max_plan, "m")
    best = FilterExec(_q15_revenue(t, n_parts), col("total_revenue") == m)
    supp_p = ProjectExec(
        t["supplier"], [col("s_suppkey"), col("s_name"), col("s_address"), col("s_phone")]
    )
    j = broadcast_join(
        best, supp_p, [col("supplier_no")], [col("s_suppkey")], JoinType.INNER,
        build_is_left=False,
    )
    proj = ProjectExec(
        j, [col("s_suppkey"), col("s_name"), col("s_address"), col("s_phone"), col("total_revenue")]
    )
    return single_sorted(proj, [SortField(col("s_suppkey"))])


def q16(t: Dict[str, ExecNode], n_parts: int) -> ExecNode:
    part_f = FilterExec(
        t["part"],
        (col("p_brand") != lit("Brand#45"))
        & Like(col("p_type"), "MEDIUM POLISHED%", negated=True)
        & col("p_size").isin(49, 14, 23, 45, 19, 3, 36, 9),
    )
    part_p = ProjectExec(part_f, [col("p_partkey"), col("p_brand"), col("p_type"), col("p_size")])
    bad_supp = FilterExec(t["supplier"], Like(col("s_comment"), "%special%requests%"))
    bad_supp_p = ProjectExec(bad_supp, [col("s_suppkey")])
    ps_p = ProjectExec(t["partsupp"], [col("ps_partkey"), col("ps_suppkey")])
    # NOT IN (bad suppliers) -> anti join
    psx = NativeShuffleExchangeExec(ps_p, HashPartitioning([col("ps_suppkey")], n_parts))
    bsx = NativeShuffleExchangeExec(bad_supp_p, HashPartitioning([col("s_suppkey")], n_parts))
    good_ps = HashJoinExec(
        bsx, psx, [col("s_suppkey")], [col("ps_suppkey")], JoinType.LEFT_ANTI, build_is_left=False
    )
    j = broadcast_join(
        part_p, good_ps, [col("p_partkey")], [col("ps_partkey")], JoinType.INNER,
        build_is_left=True,
    )
    # count(distinct ps_suppkey) = distinct (group keys + suppkey) then count
    dedup = distinct_rows(
        ProjectExec(j, [col("p_brand"), col("p_type"), col("p_size"), col("ps_suppkey")]),
        ["p_brand", "p_type", "p_size", "ps_suppkey"],
        n_parts,
    )
    agg = two_stage_agg(
        dedup,
        [GroupingExpr(col("p_brand"), "p_brand"), GroupingExpr(col("p_type"), "p_type"),
         GroupingExpr(col("p_size"), "p_size")],
        [AggFunction("count_star", None, "supplier_cnt")],
        n_parts,
    )
    return single_sorted(
        agg,
        [SortField(col("supplier_cnt"), ascending=False), SortField(col("p_brand")),
         SortField(col("p_type")), SortField(col("p_size"))],
    )


def q17(t: Dict[str, ExecNode], n_parts: int) -> ExecNode:
    part_f = FilterExec(
        t["part"],
        (col("p_brand") == lit("Brand#23")) & (col("p_container") == lit("MED BOX")),
    )
    part_p = ProjectExec(part_f, [col("p_partkey")])
    line_p = ProjectExec(
        t["lineitem"], [col("l_partkey"), col("l_quantity"), col("l_extendedprice")]
    )
    lp = broadcast_join(
        part_p, line_p, [col("p_partkey")], [col("l_partkey")], JoinType.INNER,
        build_is_left=True,
    )
    avgq = two_stage_agg(
        lp,
        [GroupingExpr(col("p_partkey"), "ak")],
        [AggFunction("avg", col("l_quantity"), "aq")],
        n_parts,
    )
    j = shuffle_join(lp, avgq, [col("p_partkey")], [col("ak")], JoinType.INNER, n_parts)
    # l_quantity < 0.2 * avg(l_quantity): avg is decimal(16,6); compare at
    # common scale via floats (documented float-division semantics)
    keep = FilterExec(
        j,
        col("l_quantity").cast(DataType.float64())
        < lit(0.2) * col("aq").cast(DataType.float64()),
    )
    agg = two_stage_agg(
        ProjectExec(keep, [col("l_extendedprice")]), [],
        [AggFunction("sum", col("l_extendedprice"), "s")],
        n_parts,
    )
    yearly = (col("s").cast(DataType.float64()) / lit(7.0)).alias("avg_yearly")
    return ProjectExec(agg, [yearly])


def q18(t: Dict[str, ExecNode], n_parts: int) -> ExecNode:
    per_order = two_stage_agg(
        ProjectExec(t["lineitem"], [col("l_orderkey"), col("l_quantity")]),
        [GroupingExpr(col("l_orderkey"), "qk")],
        [AggFunction("sum", col("l_quantity"), "qsum")],
        n_parts,
    )
    big = FilterExec(per_order, col("qsum") > lit(300, DataType.decimal(22, 2)))
    big_keys = ProjectExec(big, [col("qk"), col("qsum")])
    orders_p = ProjectExec(
        t["orders"], [col("o_orderkey"), col("o_custkey"), col("o_orderdate"), col("o_totalprice")]
    )
    j = shuffle_join(
        big_keys, orders_p, [col("qk")], [col("o_orderkey")], JoinType.INNER, n_parts
    )
    cust_p = ProjectExec(t["customer"], [col("c_custkey"), col("c_name")])
    full = shuffle_join(cust_p, j, [col("c_custkey")], [col("o_custkey")], JoinType.INNER, n_parts)
    proj = ProjectExec(
        full,
        [col("c_name"), col("c_custkey"), col("o_orderkey"), col("o_orderdate"),
         col("o_totalprice"), col("qsum")],
    )
    return single_sorted(
        proj,
        [SortField(col("o_totalprice"), ascending=False), SortField(col("o_orderdate"))],
        fetch=100,
    )


def q20(t: Dict[str, ExecNode], n_parts: int) -> ExecNode:
    part_f = FilterExec(t["part"], Like(col("p_name"), "forest%"))
    part_p = ProjectExec(part_f, [col("p_partkey")])
    line = FilterExec(
        t["lineitem"],
        (col("l_shipdate") >= lit(D(1994, 1, 1))) & (col("l_shipdate") < lit(D(1995, 1, 1))),
    )
    line_p = ProjectExec(line, [col("l_partkey"), col("l_suppkey"), col("l_quantity")])
    usage = two_stage_agg(
        line_p,
        [GroupingExpr(col("l_partkey"), "uk_part"), GroupingExpr(col("l_suppkey"), "uk_supp")],
        [AggFunction("sum", col("l_quantity"), "used")],
        n_parts,
    )
    ps_p = ProjectExec(t["partsupp"], [col("ps_partkey"), col("ps_suppkey"), col("ps_availqty")])
    ps_forest = broadcast_join(
        part_p, ps_p, [col("p_partkey")], [col("ps_partkey")], JoinType.INNER, build_is_left=True
    )
    jo = shuffle_join(
        ProjectExec(ps_forest, [col("ps_partkey"), col("ps_suppkey"), col("ps_availqty")]),
        usage,
        [col("ps_partkey"), col("ps_suppkey")], [col("uk_part"), col("uk_supp")],
        JoinType.INNER, n_parts,
    )
    qualified = FilterExec(
        jo,
        col("ps_availqty").cast(DataType.float64())
        > lit(0.5) * col("used").cast(DataType.float64()),
    )
    supp_keys = distinct_rows(ProjectExec(qualified, [col("ps_suppkey")]), ["ps_suppkey"], n_parts)
    supp_p = ProjectExec(t["supplier"], [col("s_suppkey"), col("s_name"), col("s_address"), col("s_nationkey")])
    js = broadcast_join(
        supp_keys, supp_p, [col("ps_suppkey")], [col("s_suppkey")], JoinType.INNER,
        build_is_left=True,
    )
    nat = FilterExec(t["nation"], col("n_name") == lit("CANADA"))
    full = broadcast_join(
        ProjectExec(nat, [col("n_nationkey")]), js,
        [col("n_nationkey")], [col("s_nationkey")], JoinType.INNER, build_is_left=True,
    )
    proj = ProjectExec(full, [col("s_name"), col("s_address")])
    return single_sorted(proj, [SortField(col("s_name"))])


def q21(t: Dict[str, ExecNode], n_parts: int) -> ExecNode:
    """EXISTS/NOT-EXISTS with <> rewritten through per-order distinct
    supplier counts (equivalent because l1 itself is a late line)."""
    line_all = ProjectExec(t["lineitem"], [col("l_orderkey"), col("l_suppkey")])
    n_supp = two_stage_agg(
        distinct_rows(line_all, ["l_orderkey", "l_suppkey"], n_parts),
        [GroupingExpr(col("l_orderkey"), "ok_all")],
        [AggFunction("count_star", None, "n_supp")],
        n_parts,
    )
    late = FilterExec(t["lineitem"], col("l_receiptdate") > col("l_commitdate"))
    late_p = ProjectExec(late, [col("l_orderkey"), col("l_suppkey")])
    n_late = two_stage_agg(
        distinct_rows(late_p, ["l_orderkey", "l_suppkey"], n_parts),
        [GroupingExpr(col("l_orderkey"), "ok_late")],
        [AggFunction("count_star", None, "n_late")],
        n_parts,
    )
    saudi_supp = broadcast_join(
        ProjectExec(FilterExec(t["nation"], col("n_name") == lit("SAUDI ARABIA")), [col("n_nationkey")]),
        t["supplier"],
        [col("n_nationkey")], [col("s_nationkey")], JoinType.INNER, build_is_left=True,
    )
    saudi_p = ProjectExec(saudi_supp, [col("s_suppkey"), col("s_name")])
    l1 = broadcast_join(
        saudi_p,
        ProjectExec(late, [col("l_orderkey"), col("l_suppkey")]),
        [col("s_suppkey")], [col("l_suppkey")], JoinType.INNER, build_is_left=True,
    )
    orders_f = FilterExec(t["orders"], col("o_orderstatus") == lit("F"))
    lo = shuffle_join(
        ProjectExec(l1, [col("l_orderkey"), col("s_name")]),
        ProjectExec(orders_f, [col("o_orderkey")]),
        [col("l_orderkey")], [col("o_orderkey")], JoinType.INNER, n_parts,
    )
    with_nsupp = shuffle_join(
        lo, n_supp, [col("l_orderkey")], [col("ok_all")], JoinType.INNER, n_parts
    )
    with_nlate = shuffle_join(
        with_nsupp, n_late, [col("l_orderkey")], [col("ok_late")], JoinType.INNER, n_parts
    )
    keep = FilterExec(with_nlate, (col("n_supp") > lit(1)) & (col("n_late") == lit(1)))
    agg = two_stage_agg(
        ProjectExec(keep, [col("s_name")]),
        [GroupingExpr(col("s_name"), "s_name")],
        [AggFunction("count_star", None, "numwait")],
        n_parts,
    )
    return single_sorted(
        agg,
        [SortField(col("numwait"), ascending=False), SortField(col("s_name"))],
        fetch=100,
    )


def q22(t: Dict[str, ExecNode], n_parts: int) -> ExecNode:
    cc = func("substring", col("c_phone"), lit(1), lit(2))
    in_codes = cc.isin("13", "31", "23", "29", "30", "18", "17")
    cust = FilterExec(t["customer"], in_codes)
    cust_p = ProjectExec(
        cust, [col("c_custkey"), col("c_acctbal"), cc.alias("cntrycode")]
    )
    pos = FilterExec(cust_p, col("c_acctbal") > lit(0, DataType.decimal(12, 2)))
    avg_plan = two_stage_agg(
        ProjectExec(pos, [col("c_acctbal")]), [],
        [AggFunction("avg", col("c_acctbal"), "ab")],
        n_parts,
    )
    avg_bal = scalar_subquery(avg_plan, "ab")
    rich = FilterExec(
        cust_p,
        col("c_acctbal").cast(DataType.float64()) > avg_bal.cast(DataType.float64()),
    )
    orders_keys = ProjectExec(t["orders"], [col("o_custkey")])
    rex = NativeShuffleExchangeExec(rich, HashPartitioning([col("c_custkey")], n_parts))
    oex = NativeShuffleExchangeExec(orders_keys, HashPartitioning([col("o_custkey")], n_parts))
    no_orders = HashJoinExec(
        oex, rex, [col("o_custkey")], [col("c_custkey")], JoinType.LEFT_ANTI, build_is_left=False
    )
    agg = two_stage_agg(
        no_orders,
        [GroupingExpr(col("cntrycode"), "cntrycode")],
        [AggFunction("count_star", None, "numcust"),
         AggFunction("sum", col("c_acctbal"), "totacctbal")],
        n_parts,
    )
    return single_sorted(agg, [SortField(col("cntrycode"))])


QUERIES: Dict[str, Callable[[Dict[str, ExecNode], int], ExecNode]] = {
    "q1": q1, "q2": q2, "q3": q3, "q4": q4, "q5": q5, "q6": q6, "q7": q7,
    "q8": q8, "q9": q9, "q10": q10, "q11": q11, "q12": q12, "q13": q13,
    "q14": q14, "q15": q15, "q16": q16, "q17": q17, "q18": q18, "q19": q19,
    "q20": q20, "q21": q21, "q22": q22,
}


def build_query(name: str, tables: Dict[str, ExecNode], n_parts: int = 2) -> ExecNode:
    return QUERIES[name](tables, n_parts)
