"""The plans of ``chip_smoke.py``'s exchanges phase, small, on the CPU:
each on both of the port's paths (in process through the optimizer, and
through ``split_stages``/``run_stages``), held to the smoke's own numpy
oracles and to the JAX package's run of the same plan.

- TPC-H q01 as Spark plans it (the FINAL agg, a range exchange on
  (l_returnflag, l_linestatus) into 8 partitions, a sort of each): q01's
  oracle row for row on both paths, four groups in partitions 1, 3, 5
  and 7 in process, as in the reference.
- A global sort of orders (o_orderpriority, o_totalprice DESC,
  o_orderkey) over 8 range partitions: numpy's lexsort exactly, each
  partition's rows the reference's on its path.
- ``repartition(8)`` of orders, then count and sum by priority: each
  partition's rows the reference's formula, the result numpy's.
- count and sum by the unique o_orderkey over a hash exchange: every
  map task skips, on both paths and in the reference, and skipping off
  gives the same rows.
- Each of the four plans, built in both packages over empty scans, has
  the reference's node-class sequence before and after the task
  optimizer (``tests/test_torch_fusion.py``'s method).
"""

import os
import sys

import numpy as np
import pytest

import blaze_tpu.batch as JB
from blaze_tpu import conf as jconf
from blaze_tpu.exprs import col as jcol
from blaze_tpu.ops import AggExec as JAgg, MemoryScanExec as JScan, SortExec as JSort, SortField as JSortField
from blaze_tpu.ops.agg import AggFunction as JFn, AggMode as JMode, GroupingExpr as JGroup
from blaze_tpu.ops.fusion import optimize_plan as jax_optimize_plan
from blaze_tpu.parallel import HashPartitioning as JHash, RangePartitioning as JRange
from blaze_tpu.parallel import RoundRobinPartitioning as JRR
from blaze_tpu.parallel.exchange import NativeShuffleExchangeExec as JExchange
from blaze_tpu.runtime import scheduler as JS
from blaze_tpu.runtime.context import TaskContext as JCtx
from blaze_tpu.schema import Schema as JSchema
from blaze_tpu.tpch import TPCH_SCHEMAS as JAX_SCHEMAS
from blaze_tpu.tpch import build_query as jax_build_query
from blaze_tpu.tpch.datagen import table_to_batches as jax_batches

import blaze_tpu_torch
from blaze_tpu_torch import conf
from blaze_tpu_torch.batch import batch_to_pydict, table_to_batches
from blaze_tpu_torch.ops import MemoryScanExec
from blaze_tpu_torch.ops import agg as A
from blaze_tpu_torch.ops.fusion import optimize_plan
from blaze_tpu_torch.parallel import RangePartitioning, RoundRobinPartitioning
from blaze_tpu_torch.parallel.shuffle import HashPartitioning
from blaze_tpu_torch.runtime import scheduler as S
from blaze_tpu_torch.runtime.context import RESOURCES, TaskContext
from blaze_tpu_torch.schema import Schema
from blaze_tpu_torch.tpch import TPCH_SCHEMAS
from blaze_tpu_torch.tpch.datagen import generate_all

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as C  # noqa: E402  (the phase's plans and oracles, run here on CPU scans)
from test_torch_fusion import node_classes  # noqa: E402

SCALE = 0.002
N_PARTS = 4
N_OUT = C.EXCHANGE_PARTS
BATCH = 1 << 20
SMALL_BATCH = 256


@pytest.fixture(autouse=True)
def on_cpu():
    prev = blaze_tpu_torch._default_device
    blaze_tpu_torch.set_default_device("cpu")
    yield
    blaze_tpu_torch.set_default_device(prev)


@pytest.fixture(scope="module")
def data():
    return generate_all(SCALE)


def _scan(table, name, cols, batch_rows=BATCH):
    schema = Schema([TPCH_SCHEMAS[name].field(c) for c in cols])
    return MemoryScanExec(table_to_batches({c: table[c] for c in cols}, schema, N_PARTS, batch_rows, "cpu"), schema,
                          device="cpu")


def _jscan(table, name, cols, batch_rows=BATCH):
    schema = JSchema([JAX_SCHEMAS[name].field(c) for c in cols])
    return JScan(jax_batches({c: table[c] for c in cols}, schema, N_PARTS, batch_rows), schema)


def _dict(batches, to_pydict):
    out = {}
    for b in batches:
        for k, v in to_pydict(b).items():
            out.setdefault(k, []).extend(v)
    return out


def _port_paths(build, kinds):
    """{path: (rows in order, rows of each partition of the exchange of
    ``kinds``, the partial aggs' totals)} on both paths."""
    out = {}
    A.reset_partial_totals()
    plan = C.optimized(build())
    ex = C.exchange_node(plan, kinds)
    n = plan.num_partitions()
    rows = _dict([b for p in range(n) for b in plan.execute(p, TaskContext(p, n))], batch_to_pydict)
    out["inproc"] = (rows, [sum(b.num_rows for b in part) for part in ex._outputs], dict(A.PARTIAL_TOTALS))
    A.reset_partial_totals()
    plan = build()
    ex = C.exchange_node(plan, kinds)
    stats = S.RunStats()
    stages, manager = S.split_stages(plan)
    rows = _dict(S.run_stages(stages, manager, stats), batch_to_pydict)
    out["run_stages"] = (rows, stats.read_rows[ex.shuffle_id], dict(A.PARTIAL_TOTALS))
    assert not len(RESOURCES)
    return out


def _jax_in_process(plan):
    n = plan.num_partitions()
    return [_dict(list(plan.execute(p, JCtx(p, n))), JB.batch_to_pydict) for p in range(n)]


def _jax_run_stages(plan):
    stages, manager = JS.split_stages(plan)
    return _dict(list(JS.run_stages(stages, manager)), JB.batch_to_pydict)


def test_q01_as_spark_plans_it(data):
    cols = C.QUERY_COLUMNS["q1"]["lineitem"]
    paths = _port_paths(lambda: C.spark_q01_plan({"lineitem": _scan(data["lineitem"], "lineitem", cols)}, N_PARTS),
                        RangePartitioning)
    for rows, parts, _ in paths.values():
        C.check_oracle(data, "q1", rows)
    assert paths["inproc"][1] == [0, 1, 0, 1, 0, 1, 0, 1]
    # the reference's range exchange and sort over the same four rows:
    # the same rows in each partition
    rows = paths["inproc"][0]
    table = {c: (np.frombuffer("".join(rows[c]).encode(), np.uint8).reshape(-1, 1), np.ones(4, np.int32))
             for c in ("l_returnflag", "l_linestatus")}
    jscan = JScan(jax_batches(table, JSchema([JAX_SCHEMAS["lineitem"].field(c) for c in table]), 1, 4),
                  JSchema([JAX_SCHEMAS["lineitem"].field(c) for c in table]))
    fields = [JSortField(jcol("l_returnflag")), JSortField(jcol("l_linestatus"))]
    jparts = _jax_in_process(JSort(JExchange(jscan, JRange(fields, N_OUT)), fields))
    assert [len(p.get("l_returnflag", [])) for p in jparts] == paths["inproc"][1]
    assert sum((p.get("l_linestatus", []) for p in jparts), []) == rows["l_linestatus"]


def _orders_fields():
    return [JSortField(jcol("o_orderpriority")), JSortField(jcol("o_totalprice"), ascending=False),
            JSortField(jcol("o_orderkey"))]


def test_a_global_sort_of_orders(data):
    orders = data["orders"]
    paths = _port_paths(lambda: C.orders_sort_plan(_scan(orders, "orders", C.ORDERS_COLUMNS)), RangePartitioning)
    want = C.orders_sort_oracle(orders)
    n = orders["o_orderkey"][0].shape[0]
    for rows, parts, _ in paths.values():
        assert rows == want
        assert sum(parts) == n
    cuts = [0] + [min(n - 1, n * (i + 1) // N_OUT) for i in range(N_OUT - 1)] + [n]
    assert paths["inproc"][1] == np.diff(cuts).tolist()
    fields = _orders_fields()
    jparts = _jax_in_process(JSort(JExchange(_jscan(orders, "orders", C.ORDERS_COLUMNS), JRange(fields, N_OUT)),
                                   fields))
    assert [len(p.get("o_orderkey", [])) for p in jparts] == paths["inproc"][1]
    jrows = _jax_run_stages(JSort(JExchange(_jscan(orders, "orders", C.ORDERS_COLUMNS), JRange(fields, N_OUT)),
                                  fields))
    assert jrows == want


def test_repartition_then_by_priority(data):
    orders = data["orders"]
    paths = _port_paths(lambda: C.repartition_plan(_scan(orders, "orders", C.ORDERS_COLUMNS)),
                        RoundRobinPartitioning)
    want = C.priority_oracle(orders)
    task_rows = C.task_rows_of(orders, N_PARTS)
    for path, staggered in (("inproc", True), ("run_stages", False)):
        rows, parts, _ = paths[path]
        assert {p: (n, s) for p, n, s in zip(rows["o_orderpriority"], rows["n"], rows["total"])} == want
        assert parts == C.round_robin_sizes(task_rows, N_OUT, staggered)
    # the reference's round-robin exchange on each path: the same rows
    # in each partition
    jex = JExchange(_jscan(orders, "orders", C.ORDERS_COLUMNS), JRR(N_OUT))
    assert [len(p.get("o_orderkey", [])) for p in _jax_in_process(jex)] == paths["inproc"][1]
    stages, manager = JS.split_stages(JExchange(_jscan(orders, "orders", C.ORDERS_COLUMNS), JRR(N_OUT)))
    # its reader yields a batch a map output: N_PARTS a partition, in order
    jsizes = [b.num_rows for b in JS.run_stages(stages, manager)]
    assert len(jsizes) == N_OUT * N_PARTS
    assert [sum(jsizes[p * N_PARTS:(p + 1) * N_PARTS]) for p in range(N_OUT)] == paths["run_stages"][1]


@pytest.fixture
def min_rows():
    """minRows 300 in both packages, so a 750-row map task crosses it."""
    entries = (conf.PARTIAL_AGG_SKIPPING_MIN_ROWS, jconf.PARTIAL_AGG_SKIPPING_MIN_ROWS)
    saved = [e.get() for e in entries]
    for e in entries:
        e.set(300)
    yield
    for e, v in zip(entries, saved):
        e.set(v)
    conf.ENABLE_PARTIAL_AGG_SKIPPING.set(True)


def test_a_skipping_agg(data, min_rows):
    orders = data["orders"]
    cols = ("o_orderkey", "o_totalprice")
    runs = {}
    for enabled in (True, False):
        conf.ENABLE_PARTIAL_AGG_SKIPPING.set(enabled)
        runs[enabled] = _port_paths(lambda: C.skipping_plan(_scan(orders, "orders", cols, SMALL_BATCH)),
                                    HashPartitioning)
    conf.ENABLE_PARTIAL_AGG_SKIPPING.set(True)
    keys, prices = orders["o_orderkey"][0], orders["o_totalprice"][0]
    for enabled, paths in runs.items():
        for rows, _, partial in paths.values():
            order = np.argsort(rows["o_orderkey"])
            assert np.array_equal(np.asarray(rows["o_orderkey"])[order], np.sort(keys))
            assert set(rows["n"]) == {1}
            assert np.array_equal(np.asarray(rows["total"])[order], prices[np.argsort(keys)])
            assert partial["partial_skipped"] == (N_PARTS if enabled else 0)
    # the reference's map tasks skip alike, and stream as many states
    g = [JGroup(jcol("o_orderkey"), "o_orderkey")]
    fns = [JFn("count_star", None, "n"), JFn("sum", jcol("o_totalprice"), "total")]
    partial = JAgg(_jscan(orders, "orders", cols, SMALL_BATCH), JMode.PARTIAL, g, fns,
                   supports_partial_skipping=True)
    batches = [len(list(partial.execute(m, JCtx(m, N_PARTS)))) for m in range(N_PARTS)]
    assert partial.metrics.get("partial_skipped") == N_PARTS
    assert sum(batches) == runs[True]["inproc"][2]["partial_batches"] == runs[True]["run_stages"][2]["partial_batches"]


def _jax_two_stage(child, key, fns):
    partial = JAgg(child, JMode.PARTIAL, [JGroup(jcol(key), key)], fns, supports_partial_skipping=True)
    return JAgg(JExchange(partial, JHash([jcol(key)], N_OUT)), JMode.FINAL, [JGroup(jcol(key), key)], fns)


def _both_plans(name):
    """The phase's plan ``name`` in the port and the reference, over
    empty scans."""
    scan = MemoryScanExec([[]] * N_PARTS, Schema([TPCH_SCHEMAS["orders"].field(c) for c in C.ORDERS_COLUMNS]),
                          device="cpu")
    jscan = JScan([[]] * N_PARTS, JSchema([JAX_SCHEMAS["orders"].field(c) for c in C.ORDERS_COLUMNS]))
    fns = [JFn("count_star", None, "n"), JFn("sum", jcol("o_totalprice"), "total")]
    if name == "q01":
        port = C.spark_q01_plan({"lineitem": MemoryScanExec([[]] * N_PARTS, TPCH_SCHEMAS["lineitem"], device="cpu")},
                                N_PARTS)
        agg = jax_build_query("q1", {"lineitem": JScan([[]] * N_PARTS, JAX_SCHEMAS["lineitem"])}, N_PARTS)
        while not (isinstance(agg, JAgg) and agg.mode == JMode.FINAL):
            agg = agg.children[0]
        fields = [JSortField(jcol("l_returnflag")), JSortField(jcol("l_linestatus"))]
        return port, JSort(JExchange(agg, JRange(fields, N_OUT)), fields)
    if name == "sort":
        return C.orders_sort_plan(scan), JSort(JExchange(jscan, JRange(_orders_fields(), N_OUT)), _orders_fields())
    if name == "repartition":
        return C.repartition_plan(scan), _jax_two_stage(JExchange(jscan, JRR(N_OUT)), "o_orderpriority", fns)
    return C.skipping_plan(scan), _jax_two_stage(jscan, "o_orderkey", fns)


@pytest.mark.parametrize("name", ["q01", "sort", "repartition", "skipping"])
def test_the_plans_have_the_reference_node_sequence(name):
    port, ref = _both_plans(name)
    assert node_classes(port) == node_classes(ref)
    assert node_classes(optimize_plan(port)) == node_classes(jax_optimize_plan(ref))
