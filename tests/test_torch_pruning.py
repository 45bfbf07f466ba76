"""The port's column pruning (``blaze_tpu_torch/ops/pruning.py``)
against the reference's (``blaze_tpu/ops/pruning.py``).

``expr_columns`` names the same columns as the reference's for every
expression node the port has.  ``prune_columns`` alone gives every
TPC-H query the reference's pruned plan, node for node, and the same
rows as the unpruned plan at SF 0.002; it narrows what q03's exchanges
move; a memory scan gets the free select, as in the reference; an
operator the pass does not know keeps all of its children's columns,
a count(*) keeps one column, and a join with a name on both sides is
left as it is.
"""

import datetime

import pytest

import blaze_tpu.exprs.ir as JIR
from blaze_tpu.ops.pruning import expr_columns as jax_expr_columns
from blaze_tpu.ops.pruning import prune_columns as jax_prune_columns

import blaze_tpu_torch.exprs.ir as TIR
from blaze_tpu_torch.batch import batch_to_pydict, table_to_batches
from blaze_tpu_torch.ops import AggExec, AggFunction, AggMode, MemoryScanExec, ProjectExec
from blaze_tpu_torch.ops.joins import HashJoinExec, JoinType
from blaze_tpu_torch.ops.pruning import _narrow, expr_columns, prune_columns
from blaze_tpu_torch.parallel.broadcast import BroadcastExchangeExec
from blaze_tpu_torch.parallel.exchange import NativeShuffleExchangeExec
from blaze_tpu_torch.runtime.context import TaskContext
from blaze_tpu_torch.schema import DataType, Field, Schema

from test_torch_fusion import _tpch_plans, _walk, node_classes, tpch_data  # noqa: F401


def _exprs(ir):
    """One expression of each node kind, in package ``ir``."""
    c, lit = ir.col, ir.lit
    return [
        c("a") + c("b") * lit(2),
        (c("a") > lit(1)) & ~c("b").is_null() | c("c").is_not_null(),
        ir.Cast(c("a"), DataType.float64()) if ir is TIR else ir.Cast(c("a"), _jax_float64()),
        ir.Case([(c("a") > lit(0), c("b")), (c("c") > lit(0), lit(1))], c("d")),
        ir.Case([(c("a") > lit(0), c("b"))]),
        ir.InList(c("a"), [lit(1), c("e")]),
        ir.Like(c("s"), "%x%"),
        ir.ScalarFunc("year", [c("dt")]),
        ir.ScalarFunc("substring", [c("s"), lit(1), lit(2)]),
        c("a").alias("z"),
        lit(datetime.date(1995, 1, 1)),
    ]


def _jax_float64():
    from blaze_tpu.schema import DataType as JDT

    return JDT.float64()


@pytest.mark.parametrize("i", range(len(_exprs(TIR))))
def test_expr_columns_equal_the_reference(i):
    port, ref = _exprs(TIR)[i], _exprs(JIR)[i]
    assert expr_columns(port) == jax_expr_columns(ref)


def _rows(plan):
    out = []
    n = plan.num_partitions()
    for p in range(n):
        for b in plan.execute(p, TaskContext(p, n)):
            d = batch_to_pydict(b)
            out += list(zip(*d.values()))
    return sorted(out, key=repr)


@pytest.mark.parametrize("q", [f"q{i}" for i in range(1, 23)])
def test_pruning_alone_keeps_rows_and_equals_the_reference_plan(tpch_data, q):  # noqa: F811
    port, ref = _tpch_plans(tpch_data, q)
    pruned = prune_columns(port)
    assert node_classes(pruned) == node_classes(jax_prune_columns(ref))
    assert _rows(pruned) == _rows(_tpch_plans(tpch_data, q)[0])


def _exchange_widths(plan):
    return sorted(len(n.children[0].schema.fields) for n in _walk(plan)
                  if isinstance(n, NativeShuffleExchangeExec))


def test_pruning_narrows_what_q03_exchanges(tpch_data):  # noqa: F811
    before = _exchange_widths(_tpch_plans(tpch_data, "q3")[0])
    after = _exchange_widths(prune_columns(_tpch_plans(tpch_data, "q3")[0]))
    assert len(after) == len(before) and sum(after) < sum(before)


def _scan(names=("a", "b", "c")):
    schema = Schema([Field(n, DataType.int64()) for n in names])
    import numpy as np

    table = {n: (np.arange(10, dtype=np.int64) * (i + 1), None) for i, n in enumerate(names)}
    return MemoryScanExec(table_to_batches(table, schema, 1, 4, "cpu"), schema, device="cpu")


def test_a_memory_scan_gets_the_free_select():
    plan = prune_columns(ProjectExec(_scan(), [TIR.col("b")], ["b"]))
    child = plan.children[0]
    assert isinstance(child, ProjectExec) and child._select_names == ["b"] and not child.has_kernel
    assert isinstance(child.children[0], MemoryScanExec)


def test_an_unknown_operator_keeps_all_of_its_childrens_columns():
    bx = BroadcastExchangeExec(ProjectExec(_scan(), [TIR.col("a"), TIR.col("b")], ["a", "b"]))
    plan = prune_columns(ProjectExec(bx, [TIR.col("a")], ["a"]))
    # its parent narrows what it takes from it (a free select), but
    # nothing below it is narrowed
    assert plan.children[0].children[0] is bx and bx.children[0].schema.names == ["a", "b"]


def test_count_star_keeps_one_column_and_a_missing_name_leaves_the_child():
    agg = prune_columns(AggExec(_scan(), AggMode.PARTIAL, [], [AggFunction("count_star", None, "n")]))
    assert agg.children[0].schema.names == ["a"]
    scan = _scan()
    assert _narrow(scan, {"a", "zz"}) is scan
    assert _narrow(scan, {"a", "b", "c"}) is scan


def test_a_join_with_a_name_on_both_sides_is_left_as_it_is():
    left, right = _scan(("a", "b")), _scan(("a", "c"))
    join = HashJoinExec(left, right, [TIR.col("a")], [TIR.col("a")], JoinType.INNER, build_is_left=True)
    assert prune_columns(join, {"b"}) is join
