"""One small plan per run of ``chip_smoke.py``'s nested phase, the port
on the CPU against numpy and against the JAX package.

- Order baskets: ``collect_list(l_partkey)`` and ``collect_set(l_suppkey)``
  by ``l_orderkey`` (PARTIAL, a hash exchange, FINAL; an element budget
  of 8), a shuffled hash join with a year of orders, ``size``,
  ``array_contains``, ``pos_explode`` of the list and an agg by
  ``o_orderpriority``: in process and through
  ``split_stages``/``run_stages``, equal to numpy and to the reference.
- The default budget: the same collect in small batches, so that groups
  merge partial states; every list and set equal to numpy's on both
  paths.
- Word count: ``split``, ``explode``, group and sort, equal to numpy's
  split on both paths.
- Nested ORC: one row per order written by the port's writer (a LIST,
  a MAP and a STRUCT), read back, the map exploded and aggregated per
  line number, equal to numpy on both paths.

The last two hold only to numpy: ``split`` against the reference's is
a case of ``test_torch_host_functions.py``, the explode of a map one of
``test_torch_nested.py`` and the nested ORC scan ``test_torch_orc_nested.py``;
all four plans' node sequences after ``optimize_plan`` are the
reference's.

TPC-H at SF 0.002, 4 partitions; the reference's plans run once a
module.
"""

import datetime

import numpy as np
import pytest

import blaze_tpu.batch as JB
import blaze_tpu.exprs.ir as JI
import blaze_tpu.ops as JOPS
from blaze_tpu import conf as jconf
from blaze_tpu.ops.generate import GenerateExec as JGenerate, NativeGenerator as JNative
from blaze_tpu.ops.joins import HashJoinExec as JHashJoin, JoinType as JJoinType
from blaze_tpu.ops.orc_scan import OrcScanExec as JOrcScan
from blaze_tpu.parallel import NativeShuffleExchangeExec as JExchange
from blaze_tpu.parallel.shuffle import HashPartitioning as JHash
from blaze_tpu.runtime.context import TaskContext as JCtx
from blaze_tpu.schema import DataType as JT, Field as JF, Schema as JS
from blaze_tpu.tpch import TPCH_SCHEMAS as J_TPCH
from blaze_tpu.tpch import queries as JQ
from blaze_tpu.tpch.datagen import table_to_batches as jax_table_to_batches

import blaze_tpu_torch
import blaze_tpu_torch.exprs.ir as TI
import blaze_tpu_torch.ops as TOPS
from blaze_tpu_torch import batch as TB
from blaze_tpu_torch import conf
from blaze_tpu_torch.io import orc as porc
from blaze_tpu_torch.ops.fusion import optimize_plan
from blaze_tpu_torch.ops.generate import GenerateExec, NativeGenerator
from blaze_tpu_torch.ops.joins import HashJoinExec, JoinType
from blaze_tpu_torch.parallel.exchange import NativeShuffleExchangeExec
from blaze_tpu_torch.parallel.shuffle import HashPartitioning
from blaze_tpu_torch.runtime.context import RESOURCES, TaskContext
from blaze_tpu_torch.runtime.scheduler import run_stages, split_stages
from blaze_tpu_torch.schema import DataType as TT, Field as TF, Schema as TS
from blaze_tpu_torch.tpch import TPCH_SCHEMAS, datagen
from blaze_tpu_torch.tpch import queries as TQ

SCALE = 0.002
N_PARTS = 4
YEAR = 1995
SUPP = 1

PORT = dict(I=TI, O=TOPS, Q=TQ, Gen=GenerateExec, Native=NativeGenerator, Join=HashJoinExec, JT=JoinType,
            Ex=NativeShuffleExchangeExec, Hash=HashPartitioning, T=TT, F=TF, S=TS, schemas=TPCH_SCHEMAS)
REF = dict(I=JI, O=JOPS, Q=JQ, Gen=JGenerate, Native=JNative, Join=JHashJoin, JT=JJoinType, Ex=JExchange, Hash=JHash,
           T=JT, F=JF, S=JS, schemas=J_TPCH)


@pytest.fixture(autouse=True, scope="module")
def on_cpu():
    prev = blaze_tpu_torch._default_device
    blaze_tpu_torch.set_default_device("cpu")
    yield
    blaze_tpu_torch.set_default_device(prev)


@pytest.fixture(scope="module")
def tables():
    li = datagen.generate_table("lineitem", SCALE, columns=["l_orderkey", "l_partkey", "l_suppkey", "l_linenumber"])
    orders = datagen.generate_table("orders", SCALE, columns=["o_orderkey", "o_orderdate", "o_orderpriority",
                                                              "o_totalprice"])
    part = datagen.with_spec_columns({"part": datagen.generate_table("part", SCALE, columns=["p_name"])}, SCALE)["part"]
    return {"lineitem": li, "orders": orders, "part": part}


def _scan(P, tables, name, cols, batch_rows=1 << 16):
    s = P["S"]([P["schemas"][name].field(c) for c in cols])
    t = {c: tables[name][c] for c in cols}
    if P is PORT:
        return TOPS.MemoryScanExec(TB.table_to_batches(t, s, N_PARTS, batch_rows, "cpu"), s, device="cpu")
    return JOPS.MemoryScanExec(jax_table_to_batches(t, s, N_PARTS, batch_rows), s)


def _rows(P, plan) -> dict:
    ctx, to_dict = (TaskContext, TB.batch_to_pydict) if P is PORT else (JCtx, JB.batch_to_pydict)
    out = {f.name: [] for f in plan.schema.fields}
    for p in range(plan.num_partitions()):
        for b in plan.execute(p, ctx(p, plan.num_partitions())):
            for k, v in to_dict(b).items():
                out[k].extend(v)
    return out


def _scheduled(plan) -> dict:
    stages, manager = split_stages(plan)
    out = {f.name: [] for f in stages[-1].plan.schema.fields}
    for b in run_stages(stages, manager):
        for k, v in TB.batch_to_pydict(b).items():
            out[k].extend(v)
    assert not len(RESOURCES)
    return out


def _by(rows: dict, key: str) -> dict:
    return {k: {c: rows[c][i] for c in rows if c != key} for i, k in enumerate(rows[key])}


# ------------------------------------------------------ order baskets


def basket_plan(P, tables):
    I, O, Q = P["I"], P["O"], P["Q"]
    li = _scan(P, tables, "lineitem", ["l_orderkey", "l_partkey", "l_suppkey"])
    orders = _scan(P, tables, "orders", ["o_orderkey", "o_orderdate", "o_orderpriority"])
    baskets = Q.two_stage_agg(li, [O.GroupingExpr(I.col("l_orderkey"), "k")],
                              [O.AggFunction("collect_list", I.col("l_partkey"), "parts"),
                               O.AggFunction("collect_set", I.col("l_suppkey"), "supps")], N_PARTS)
    year = O.FilterExec(orders, (I.col("o_orderdate") >= I.lit(datetime.date(YEAR, 1, 1)))
                        & (I.col("o_orderdate") < I.lit(datetime.date(YEAR + 1, 1, 1))))
    ex = P["Ex"](year, P["Hash"]([I.col("o_orderkey")], N_PARTS))
    joined = P["Join"](ex, baskets, [I.col("o_orderkey")], [I.col("k")], P["JT"].INNER, build_is_left=True)
    proj = O.ProjectExec(joined, [I.col("o_orderpriority"), I.func("size", I.col("parts")).alias("n_parts"),
                                  I.func("size", I.col("supps")).alias("n_supps"),
                                  I.func("array_contains", I.col("supps"), I.lit(SUPP)).alias("has"), I.col("parts")])
    exploded = P["Gen"](proj, P["Native"]("pos_explode", I.col("parts")), [])
    first = I.col("pos") == I.lit(0)
    aggs = [O.AggFunction("count_star", None, "cnt"), O.AggFunction("sum", I.col("col"), "s"),
            O.AggFunction("sum", I.col("pos"), "spos"),
            O.AggFunction("sum", I.Case([(first, I.lit(1))], I.lit(0)), "norders"),
            O.AggFunction("sum", I.Case([(first, I.col("n_supps"))], I.lit(0)), "nsup"),
            O.AggFunction("sum", I.Case([(first & I.col("has"), I.lit(1))], I.lit(0)), "nhas"),
            O.AggFunction("max", I.col("n_parts"), "maxn")]
    return Q.two_stage_agg(exploded, [O.GroupingExpr(I.col("o_orderpriority"), "prio")], aggs, N_PARTS)


def basket_oracle(t) -> dict:
    okey, pkey, skey = (t["lineitem"][c][0] for c in ("l_orderkey", "l_partkey", "l_suppkey"))
    o = t["orders"]
    day = lambda y: (datetime.date(y, 1, 1) - datetime.date(1970, 1, 1)).days
    sel = (o["o_orderdate"][0] >= day(YEAR)) & (o["o_orderdate"][0] < day(YEAR + 1))
    row = np.searchsorted(o["o_orderkey"][0], okey)
    prio = [bytes(d[:n]).decode() for d, n in zip(o["o_orderpriority"][0], o["o_orderpriority"][1])]
    out = {}
    for i in np.flatnonzero(sel):
        lines = np.flatnonzero(row == i)
        n = lines.shape[0]
        r = out.setdefault(prio[i], {"cnt": 0, "s": 0, "spos": 0, "norders": 0, "nsup": 0, "nhas": 0, "maxn": 0})
        r["cnt"] += n
        r["s"] += int(pkey[lines].sum())
        r["spos"] += n * (n - 1) // 2
        r["norders"] += 1
        r["nsup"] += len(set(skey[lines].tolist()))
        r["nhas"] += int(SUPP in set(skey[lines].tolist()))
        r["maxn"] = max(r["maxn"], n)
    return out


@pytest.fixture(scope="module")
def baskets(tables):
    conf.COLLECT_MAX_ELEMS.set(8)
    jconf.COLLECT_MAX_ELEMS.set(8)
    try:
        port = _rows(PORT, optimize_plan(basket_plan(PORT, tables)))
        sched = _scheduled(basket_plan(PORT, tables))
        ref = _rows(REF, basket_plan(REF, tables))
    finally:
        conf.COLLECT_MAX_ELEMS.set(64)
        jconf.COLLECT_MAX_ELEMS.set(64)
    return port, sched, ref


@pytest.mark.parametrize("path", ["in process", "run_stages", "reference"])
def test_order_baskets_equal_numpy(tables, baskets, path):
    got = baskets[["in process", "run_stages", "reference"].index(path)]
    want = basket_oracle(tables)
    assert want and _by(got, "prio") == want
    assert max(r["maxn"] for r in want.values()) <= 8  # no order cut at the budget of 8


# ------------------------------------------------ the default budget


def test_collect_at_the_default_budget_merges_states(tables):
    li = _scan(PORT, tables, "lineitem", ["l_orderkey", "l_partkey", "l_suppkey"], batch_rows=1000)
    plan = lambda: TQ.two_stage_agg(li, [TOPS.GroupingExpr(TI.col("l_orderkey"), "k")],
                                    [TOPS.AggFunction("collect_list", TI.col("l_partkey"), "parts"),
                                     TOPS.AggFunction("collect_set", TI.col("l_suppkey"), "supps")], N_PARTS)
    okey, pkey, skey = (tables["lineitem"][c][0] for c in ("l_orderkey", "l_partkey", "l_suppkey"))
    want = {}
    for k, p, s in zip(okey.tolist(), pkey.tolist(), skey.tolist()):
        w = want.setdefault(k, ([], set()))
        w[0].append(p)
        w[1].add(s)
    # orders whose lines span two scan batches: their groups merge states
    bounds = [b[-1] == c[0] for part in TB.table_to_batches({"l_orderkey": tables["lineitem"]["l_orderkey"]},
                                                            TS([TPCH_SCHEMAS["lineitem"].field("l_orderkey")]),
                                                            N_PARTS, 1000, "cpu")
              for b, c in zip([TB.batch_to_pydict(x)["l_orderkey"] for x in part],
                              [TB.batch_to_pydict(x)["l_orderkey"] for x in part][1:])]
    assert any(bounds)
    for rows in (_rows(PORT, optimize_plan(plan())), _scheduled(plan())):
        assert len(rows["k"]) == len(want)
        for k, parts, supps in zip(rows["k"], rows["parts"], rows["supps"]):
            assert sorted(parts) == sorted(want[k][0]) and sorted(supps) == sorted(want[k][1]) == supps


# ---------------------------------------------------------- word count


def words_plan(P, tables):
    I, O, Q = P["I"], P["O"], P["Q"]
    split = O.ProjectExec(_scan(P, tables, "part", ["p_name"]),
                          [I.func("split", I.col("p_name"), I.lit(" ")).alias("words")])
    words = P["Gen"](split, P["Native"]("explode", I.col("words")), [], keep_input=False)
    counted = Q.two_stage_agg(words, [O.GroupingExpr(I.col("col"), "word")], [O.AggFunction("count_star", None, "n")],
                              N_PARTS)
    return Q.single_sorted(counted, [O.SortField(I.col("word"), True, False)])


def test_word_count_equals_numpy_split(tables):
    d, n = tables["part"]["p_name"][0], tables["part"]["p_name"][1]
    words, counts = np.unique([w for i in range(d.shape[0]) for w in bytes(d[i, :n[i]]).decode().split(" ")],
                              return_counts=True)
    want = {"word": words.tolist(), "n": counts.tolist()}
    assert _rows(PORT, optimize_plan(words_plan(PORT, tables))) == want
    assert _scheduled(words_plan(PORT, tables)) == want


# ---------------------------------------------------------- nested ORC


def orc_schema(P):
    T, F, S = P["T"], P["F"], P["S"]
    return S([F("o_orderkey", T.int64()), F("parts", T.array(T.int64(), 8)), F("lines", T.map(T.int32(), T.int64(), 8)),
              F("head", T.struct([F("o_orderdate", T.date32()), F("o_totalprice", T.decimal(12, 2))]))])


def orc_plan(P, path):
    I, O, Q = P["I"], P["O"], P["Q"]
    scan = (TOPS.OrcScanExec([[path]], orc_schema(P), device="cpu") if P is PORT
            else JOrcScan([[path]], orc_schema(P)))
    gen = P["Gen"](scan, P["Native"]("explode", I.col("lines")), [])
    proj = O.ProjectExec(gen, [I.col("key"), I.col("value"), I.GetStructField(I.col("head"), "o_totalprice").alias("price"),
                               I.Case([(I.col("key") == I.lit(1), I.GetIndexedField(I.col("parts"), 0))]).alias("p0")])
    return Q.two_stage_agg(proj, [O.GroupingExpr(I.col("key"), "ln")],
                           [O.AggFunction("count_star", None, "cnt"), O.AggFunction("sum", I.col("value"), "s"),
                            O.AggFunction("sum", I.col("price"), "price"), O.AggFunction("sum", I.col("p0"), "s0")],
                           N_PARTS)


def test_nested_orc_map_explode_equals_numpy(tables, tmp_path):
    li, o = tables["lineitem"], tables["orders"]
    okey, pkey, lnum = (li[c][0] for c in ("l_orderkey", "l_partkey", "l_linenumber"))
    o_key, o_date, o_price = (o[c][0] for c in ("o_orderkey", "o_orderdate", "o_totalprice"))
    row = np.searchsorted(o_key, okey)
    first = np.searchsorted(row, np.arange(o_key.shape[0]))
    lens = np.bincount(row, minlength=o_key.shape[0]).astype(np.int32)
    edata, evalid = np.zeros((o_key.shape[0], 8), np.int64), np.zeros((o_key.shape[0], 8), bool)
    edata[row, np.arange(okey.shape[0]) - first[row]] = pkey
    evalid[row, np.arange(okey.shape[0]) - first[row]] = True
    maps = [dict(zip(lnum[first[i]:first[i] + lens[i]].tolist(), pkey[first[i]:first[i] + lens[i]].tolist()))
            for i in range(o_key.shape[0])]
    heads = [{"o_orderdate": int(d), "o_totalprice": int(p)} for d, p in zip(o_date, o_price)]
    path = str(tmp_path / "nested_orders.orc")
    porc.write_orc(path, orc_schema(PORT), {"o_orderkey": (o_key, None, None), "parts": (None, None, lens, (edata, evalid)),
                                            "lines": maps, "head": heads}, stripe_rows=1000, compression="zlib")
    want = {}
    for ln in np.unique(lnum).tolist():
        sel = lnum == ln
        want[ln] = {"cnt": int(sel.sum()), "s": int(pkey[sel].sum()), "price": int(o_price[row[sel]].sum()),
                    "s0": int(pkey[sel].sum()) if ln == 1 else None}
    assert _by(_rows(PORT, optimize_plan(orc_plan(PORT, path))), "ln") == want
    assert _by(_scheduled(orc_plan(PORT, path)), "ln") == want


# ------------------------------------------------------ node sequences


def node_classes(node, depth=0):
    """The plan's nodes, depth first: (depth, class, fused operators)."""
    ops = tuple(type(o).__name__ for o in getattr(node, "ops", ()))
    out = [(depth, type(node).__name__, ops)]
    for c in node.children:
        out += node_classes(c, depth + 1)
    return out


@pytest.mark.parametrize("run", ["baskets", "words", "orc"])
def test_optimized_plan_has_the_reference_node_sequence(tables, tmp_path, run):
    """A GenerateExec joins a fused chain as an expanding operator, as
    in the reference (``ops/fusion.py`` there and here)."""
    from blaze_tpu.ops.fusion import optimize_plan as jax_optimize_plan

    if run == "orc":
        path = str(tmp_path / "empty.orc")
        porc.write_orc(path, orc_schema(PORT), {"o_orderkey": (np.zeros(0, np.int64), None, None),
                                                "parts": (None, None, np.zeros(0, np.int32),
                                                          (np.zeros((0, 8), np.int64), np.zeros((0, 8), bool))),
                                                "lines": [], "head": []})
        port, ref = orc_plan(PORT, path), orc_plan(REF, path)
    else:
        build = basket_plan if run == "baskets" else words_plan
        port, ref = build(PORT, tables), build(REF, tables)
    assert node_classes(port) == node_classes(ref)
    opt = optimize_plan(port)
    assert node_classes(opt) == node_classes(jax_optimize_plan(ref))
    assert any(cls == "GenerateExec" or "GenerateExec" in ops for _, cls, ops in node_classes(opt))
