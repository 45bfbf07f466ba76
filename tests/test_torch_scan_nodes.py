"""The scan-side plan nodes against the JAX package's.

- ``CoalesceBatchesExec``, ``EmptyPartitionsExec`` and ``DebugExec`` give
  the reference's batches;
- the plan-contract bytes of ``parquet_scan``, ``orc_scan``,
  ``empty_partitions``, ``debug`` and ``coalesce_batches`` equal
  ``plan_pb2``'s for the same plan, and decode to the same nodes (a
  scan's predicate entries ANDed back);
- column pruning narrows a file scan at its source (a rebuilt scan, no
  projection above it), through ``CoalesceBatchesExec`` too, and the
  optimized TPC-H plans over file scans have the reference's node-class
  sequence (built and optimized, never run: no file is read);
- the scans' producer thread re-raises its error in the consumer;
- a scan given no device stages on the card, and raises where there is
  none.
"""

import logging
import threading

import numpy as np
import pytest
import torch

import blaze_tpu.ops as JOPS
from blaze_tpu import schema as RS
from blaze_tpu.batch import batch_to_pydict as jax_to_pydict
from blaze_tpu.exprs import ir as jax_ir
from blaze_tpu.ops.fusion import optimize_plan as jax_optimize_plan
from blaze_tpu.ops.orc_scan import OrcScanExec as JaxOrcScan
from blaze_tpu.ops.pruning import prune_columns as jax_prune_columns
from blaze_tpu.runtime.context import TaskContext as JaxContext
from blaze_tpu.serde import plan_pb2 as pb
from blaze_tpu.serde import to_proto as jax_to_proto
from blaze_tpu.tpch import TPCH_SCHEMAS as JAX_SCHEMAS
from blaze_tpu.tpch import build_query as jax_build_query
from blaze_tpu.tpch.datagen import table_to_batches as jax_table_to_batches

import blaze_tpu_torch
import blaze_tpu_torch.ops as TOPS
from blaze_tpu_torch import schema as PS
from blaze_tpu_torch.batch import batch_to_pydict, table_to_batches
from blaze_tpu_torch.exprs import ir
from blaze_tpu_torch.ops import fusion
from blaze_tpu_torch.ops.pruning import prune_columns
from blaze_tpu_torch.runtime.context import TaskContext
from blaze_tpu_torch.runtime.pipeline import maybe_pipelined, pipelined
from blaze_tpu_torch.serde import from_proto, to_proto, wire
from blaze_tpu_torch.tpch import TPCH_SCHEMAS, build_query


def node_classes(node, depth=0):
    """The plan's nodes, depth first: (depth, class, fused operators)."""
    ops = tuple(type(o).__name__ for o in getattr(node, "ops", ()))
    out = [(depth, type(node).__name__, ops)]
    for c in node.children:
        out += node_classes(c, depth + 1)
    return out


def _schema(S):
    return S.Schema([S.Field("a", S.DataType.int64()), S.Field("s", S.DataType.string(16)),
                     S.Field("d", S.DataType.date32()), S.Field("x", S.DataType.decimal(12, 2))])


@pytest.fixture(scope="module")
def table():
    rng = np.random.default_rng(2)
    n = 1000
    s = np.zeros((n, 16), np.uint8)
    ln = rng.integers(0, 17, n).astype(np.int32)
    for i in range(n):
        s[i, :ln[i]] = 0x61 + rng.integers(0, 26, ln[i])
    return {"a": (rng.integers(-10**12, 10**12, n), None, rng.random(n) > 0.1), "s": (s, ln),
            "d": (rng.integers(8000, 11000, n).astype(np.int32), None),
            "x": (rng.integers(-10**9, 10**9, n), None, rng.random(n) > 0.3)}


def _scans(table, batch_rows):
    return (TOPS.MemoryScanExec(table_to_batches(table, _schema(PS), 2, batch_rows, "cpu"), _schema(PS), device="cpu"),
            JOPS.MemoryScanExec(jax_table_to_batches(table, _schema(RS), 2, batch_rows), _schema(RS)))


def _batches(plan, jax: bool = False):
    ctx, to_dict = (JaxContext, jax_to_pydict) if jax else (TaskContext, batch_to_pydict)
    return [to_dict(b) for p in range(plan.num_partitions()) for b in plan.execute(p, ctx(p, plan.num_partitions()))]


@pytest.mark.parametrize("batch_rows,target", [(90, 200), (90, 90), (300, 1000), (300, 0)])
def test_coalesce_batches_equal_the_reference(table, batch_rows, target):
    """Small batches merge up to the target, in order; a batch at or
    past it passes as it is; the default target is spark.blaze.batchSize."""
    port, ref = _scans(table, batch_rows)
    got = _batches(TOPS.CoalesceBatchesExec(port, target))
    assert got == _batches(JOPS.CoalesceBatchesExec(ref, target), jax=True)
    assert len(got) < len(_batches(port)) or target == batch_rows


def test_empty_partitions_and_debug_equal_the_reference(table, caplog):
    empty = TOPS.EmptyPartitionsExec(_schema(PS), 3, device="cpu")
    assert empty.num_partitions() == 3 and _batches(empty) == [] and empty.device == torch.device("cpu")
    assert _batches(JOPS.EmptyPartitionsExec(_schema(RS), 3), jax=True) == []
    port, ref = _scans(table, 400)
    with caplog.at_level(logging.INFO, logger="blaze_tpu_torch.debug"):
        got = _batches(TOPS.DebugExec(port, "here", verbose=True))
    assert got == _batches(JOPS.DebugExec(ref, "here", verbose=True), jax=True)
    lines = [r.getMessage() for r in caplog.records if r.name == "blaze_tpu_torch.debug"]
    assert "[here] partition=1 batch=1 rows=100" in lines and len(lines) == 2 * len(got)


# ------------------------------------------------------------------ serde


def _pred(m, S):
    return (m.col("a") > m.lit(5)) & (m.col("d") <= m.lit("1995-03-15", S.DataType.date32())) \
        & (m.col("s") == m.lit("abc"))


def _plans(M, S, O, OrcCls):
    """The same five-node plans, built by the package of ``M``/``S``/``O``."""
    groups = [["/data/t/part-0.parquet", "/data/t/part-1.parquet"], [], ["/data/t/part-2.parquet"]]
    pq = O.ParquetScanExec(groups, _schema(S), _pred(M, S), **({"device": "cpu"} if O is TOPS else {}))
    orc = OrcCls(groups, _schema(S), None, **({"device": "cpu"} if O is TOPS else {}))
    empty = O.EmptyPartitionsExec(_schema(S), 4, **({"device": "cpu"} if O is TOPS else {}))
    return {"parquet_scan": pq, "orc_scan": orc, "empty_partitions": empty,
            "debug": O.DebugExec(pq, "tag", True), "coalesce_batches": O.CoalesceBatchesExec(orc, 4096)}


@pytest.mark.parametrize("kind", ["parquet_scan", "orc_scan", "empty_partitions", "debug", "coalesce_batches"])
def test_serde_bytes_equal_plan_pb2(kind):
    port = _plans(ir, PS, TOPS, TOPS.OrcScanExec)[kind]
    ref = _plans(jax_ir, RS, JOPS, JaxOrcScan)[kind]
    raw = jax_to_proto.plan_to_proto(ref).SerializeToString()
    assert to_proto.plan_to_proto(port).encode() == raw
    msg = pb.PhysicalPlanNode.FromString(raw)
    assert msg.WhichOneof("node") == kind
    blaze_tpu_torch.set_default_device("cpu")
    try:
        decoded = from_proto.plan_from_proto(wire.PhysicalPlanNode.decode(raw))
    finally:
        blaze_tpu_torch.set_default_device("cuda")
    assert type(decoded) is type(port) and to_proto.plan_to_proto(decoded).encode() == raw
    if kind == "parquet_scan":
        assert decoded.file_groups == port.file_groups and decoded.schema.names == port.schema.names


def test_predicate_entries_are_anded_back():
    """A producer may push each conjunct as an entry of its own: they
    decode to one AND, which re-encodes as one entry."""
    msg = pb.PhysicalPlanNode()
    msg.parquet_scan.schema.CopyFrom(jax_to_proto.schema_to_proto(_schema(RS)))
    msg.parquet_scan.file_groups.append("/x/a.parquet;/x/b.parquet")
    for e in (jax_ir.col("a") > jax_ir.lit(5), jax_ir.col("a") < jax_ir.lit(9)):
        msg.parquet_scan.predicate.add().CopyFrom(jax_to_proto.expr_to_proto(e))
    blaze_tpu_torch.set_default_device("cpu")
    try:
        scan = from_proto.plan_from_proto(wire.PhysicalPlanNode.decode(msg.SerializeToString()))
    finally:
        blaze_tpu_torch.set_default_device("cuda")
    assert scan.file_groups == [["/x/a.parquet", "/x/b.parquet"]]
    assert scan.predicate.op == "and" and scan._conjuncts == [("a", ">", 5), ("a", "<", 9)]
    ref = jax_to_proto.plan_to_proto(JOPS.ParquetScanExec(
        [["/x/a.parquet", "/x/b.parquet"]], _schema(RS), (jax_ir.col("a") > jax_ir.lit(5)) & (jax_ir.col("a") < jax_ir.lit(9))))
    assert to_proto.plan_to_proto(scan).encode() == ref.SerializeToString()


# ---------------------------------------------------------------- pruning


@pytest.mark.parametrize("cls", [TOPS.ParquetScanExec, TOPS.OrcScanExec])
def test_narrow_rebuilds_a_file_scan(cls):
    scan = cls([["/x/p.parquet"]], _schema(PS), ir.col("a") > ir.lit(1), batch_rows=77, device="cpu")
    plan = TOPS.ProjectExec(TOPS.CoalesceBatchesExec(scan, 500), [ir.col("d")], ["d"])
    out = prune_columns(plan)
    inner = out.children[0].children[0]
    assert type(out.children[0]) is TOPS.CoalesceBatchesExec and type(inner) is cls
    assert inner.schema.names == ["d"] and inner.batch_rows == 77 and inner.predicate is scan.predicate
    assert inner.file_groups == scan.file_groups and inner.device == torch.device("cpu")
    ref_cls = JOPS.ParquetScanExec if cls is TOPS.ParquetScanExec else JaxOrcScan
    ref = jax_prune_columns(JOPS.ProjectExec(JOPS.CoalesceBatchesExec(
        ref_cls([["/x/p.parquet"]], _schema(RS), jax_ir.col("a") > jax_ir.lit(1), 77), 500), [jax_ir.col("d")], ["d"]))
    assert node_classes(out) == node_classes(ref)


@pytest.mark.parametrize("q", ["q1", "q3", "q5", "q6", "q10", "q12", "q14", "q19"])
def test_optimized_file_plans_have_the_reference_node_sequence(q):
    port = {k: TOPS.ParquetScanExec([[f"/tpch/{k}/part-{p}.parquet"] for p in range(2)], s, device="cpu")
            for k, s in TPCH_SCHEMAS.items()}
    ref = {k: JOPS.ParquetScanExec([[f"/tpch/{k}/part-{p}.parquet"] for p in range(2)], s)
           for k, s in JAX_SCHEMAS.items()}
    plan, jplan = build_query(q, port, 2), jax_build_query(q, ref, 2)
    assert node_classes(plan) == node_classes(jplan)
    opt = fusion.optimize_plan(plan)
    assert node_classes(opt) == node_classes(jax_optimize_plan(jplan))
    # every scan reads fewer columns than its table has: narrowed at its source
    scans = [n for n in _walk(opt) if isinstance(n, TOPS.ParquetScanExec)]
    assert scans and all(len(s.schema.names) < len(TPCH_SCHEMAS[_table_of(s)].names) for s in scans)



def _walk(node):
    yield node
    for c in node.children:
        yield from _walk(c)


def _table_of(scan):
    return scan.file_groups[0][0].split("/")[2]


# --------------------------------------------------------------- pipeline


class _Boom(Exception):
    pass


def test_pipeline_reraises_the_producers_error():
    seen = []

    def gen():
        yield 1
        yield 2
        seen.append(threading.current_thread().name)
        raise _Boom("decode failed")

    out = []
    with pytest.raises(_Boom, match="decode failed"):
        for x in pipelined(gen(), TaskContext(0), depth=1):
            out.append(x)
    assert out == [1, 2] and seen and seen[0] != threading.current_thread().name


def test_pipeline_depth_zero_runs_in_place_and_closing_stops_the_producer():
    from blaze_tpu_torch import conf

    conf.PIPELINE_DEPTH.set(0)
    try:
        names = list(maybe_pipelined((threading.current_thread().name for _ in range(2)), TaskContext(0)))
    finally:
        conf.PIPELINE_DEPTH.set(2)
    assert names == [threading.current_thread().name] * 2
    produced = []

    def endless():
        i = 0
        while True:
            produced.append(i)
            yield i
            i += 1

    stream = maybe_pipelined(endless(), TaskContext(0))
    assert next(stream) == 0
    stream.close()
    threading.Event().wait(0.3)
    n = len(produced)
    threading.Event().wait(0.2)
    assert len(produced) == n <= 5


def test_a_scan_with_no_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: TOPS.ParquetScanExec([["/x.parquet"]], _schema(PS)),
                 lambda: TOPS.OrcScanExec([["/x.orc"]], _schema(PS)),
                 lambda: TOPS.EmptyPartitionsExec(_schema(PS), 1)):
        with pytest.raises(RuntimeError, match="CUDA card"):
            make()
    assert TOPS.ParquetScanExec([["/x.parquet"]], _schema(PS), device="cpu").device == torch.device("cpu")
