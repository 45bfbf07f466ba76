"""TPC-H table schemas (TPC-H spec v3; decimal(12,2) money columns as
Spark reads them)."""

from ..schema import DataType as T, Field, Schema

_d = lambda: T.decimal(12, 2)

TPCH_SCHEMAS = {
    "lineitem": Schema([
        Field("l_orderkey", T.int64()),
        Field("l_partkey", T.int64()),
        Field("l_suppkey", T.int64()),
        Field("l_linenumber", T.int32()),
        Field("l_quantity", _d()),
        Field("l_extendedprice", _d()),
        Field("l_discount", _d()),
        Field("l_tax", _d()),
        Field("l_returnflag", T.string(8)),
        Field("l_linestatus", T.string(8)),
        Field("l_shipdate", T.date32()),
        Field("l_commitdate", T.date32()),
        Field("l_receiptdate", T.date32()),
        Field("l_shipinstruct", T.string(32)),
        Field("l_shipmode", T.string(8)),
        Field("l_comment", T.string(64)),
    ]),
    "orders": Schema([
        Field("o_orderkey", T.int64()),
        Field("o_custkey", T.int64()),
        Field("o_orderstatus", T.string(8)),
        Field("o_totalprice", _d()),
        Field("o_orderdate", T.date32()),
        Field("o_orderpriority", T.string(16)),
        Field("o_clerk", T.string(16)),
        Field("o_shippriority", T.int32()),
        Field("o_comment", T.string(128)),
    ]),
    "customer": Schema([
        Field("c_custkey", T.int64()),
        Field("c_name", T.string(32)),
        Field("c_address", T.string(64)),
        Field("c_nationkey", T.int32()),
        Field("c_phone", T.string(16)),
        Field("c_acctbal", _d()),
        Field("c_mktsegment", T.string(16)),
        Field("c_comment", T.string(128)),
    ]),
    "part": Schema([
        Field("p_partkey", T.int64()),
        Field("p_name", T.string(64)),
        Field("p_mfgr", T.string(32)),
        Field("p_brand", T.string(16)),
        Field("p_type", T.string(32)),
        Field("p_size", T.int32()),
        Field("p_container", T.string(16)),
        Field("p_retailprice", _d()),
        Field("p_comment", T.string(32)),
    ]),
    "supplier": Schema([
        Field("s_suppkey", T.int64()),
        Field("s_name", T.string(32)),
        Field("s_address", T.string(64)),
        Field("s_nationkey", T.int32()),
        Field("s_phone", T.string(16)),
        Field("s_acctbal", _d()),
        Field("s_comment", T.string(128)),
    ]),
    "partsupp": Schema([
        Field("ps_partkey", T.int64()),
        Field("ps_suppkey", T.int64()),
        Field("ps_availqty", T.int32()),
        Field("ps_supplycost", _d()),
        Field("ps_comment", T.string(128)),
    ]),
    "nation": Schema([
        Field("n_nationkey", T.int32()),
        Field("n_name", T.string(32)),
        Field("n_regionkey", T.int32()),
        Field("n_comment", T.string(128)),
    ]),
    "region": Schema([
        Field("r_regionkey", T.int32()),
        Field("r_name", T.string(16)),
        Field("r_comment", T.string(128)),
    ]),
}
