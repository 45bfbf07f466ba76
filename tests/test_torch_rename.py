"""``RenameColumnsExec`` of the port against the JAX package's, and the
plan contract of the queries that use it or the other new pieces.

- One seeded table through both packages' rename: the same schema
  (names, types, nullability) and the same rows.
- TPC-DS q10, q35 and q69 (two renamed EXISTENCE flags), q17
  (``stddev_samp``) and q84 (``concat`` with a string literal): the
  port's TaskDefinitions equal the reference's once the ids each
  process mints are normalized (``test_torch_serde.normalized``); the
  reference's bytes decode and re-encode byte for byte in the port's
  wire codec, and the plan the port decodes from them encodes to them
  again up to the memory-scan ids it mints.
- The renamed flags keep their names through the task optimizer and
  through the wire.
"""

import shutil

import numpy as np
import pytest

from blaze_tpu.batch import batch_to_pydict as jax_to_pydict
from blaze_tpu.ops import MemoryScanExec as JaxScan
from blaze_tpu.ops import RenameColumnsExec as JaxRename
from blaze_tpu.runtime import scheduler as JS
from blaze_tpu.runtime.context import RESOURCES as JAX_RESOURCES
from blaze_tpu.runtime.context import TaskContext as JaxContext
from blaze_tpu.schema import DataType as JT, Field as JF, Schema as JSchema
from blaze_tpu.serde import to_proto as jax_to_proto
from blaze_tpu.tpcds import TPCDS_SCHEMAS as JAX_DS_SCHEMAS
from blaze_tpu.tpcds import build_query as jax_build_ds
from blaze_tpu.tpch.datagen import table_to_batches as jax_table_to_batches

import blaze_tpu_torch
from blaze_tpu_torch.batch import batch_to_pydict, table_to_batches
from blaze_tpu_torch.ops import MemoryScanExec, RenameColumnsExec
from blaze_tpu_torch.ops.fusion import optimize_plan
from blaze_tpu_torch.runtime import scheduler as S
from blaze_tpu_torch.runtime.context import RESOURCES, TaskContext
from blaze_tpu_torch.schema import DataType as TT, Field as TF, Schema as TSchema
from blaze_tpu_torch.serde import from_proto, to_proto, wire
from blaze_tpu_torch.tpcds import TPCDS_SCHEMAS, build_query

from test_torch_serde import _scan_ids_normalized, memory_scans, normalized

CPU = "cpu"
N_PARTS = 2


@pytest.fixture(autouse=True)
def on_cpu():
    prev = blaze_tpu_torch._default_device
    blaze_tpu_torch.set_default_device(CPU)
    yield
    blaze_tpu_torch.set_default_device(prev)


def _run(plan, to_pydict, context):
    out = {f.name: [] for f in plan.schema.fields}
    for p in range(plan.num_partitions()):
        for b in plan.execute(p, context(p, plan.num_partitions())):
            for k, v in to_pydict(b).items():
                out[k].extend(v)
    return out


def test_rename_equals_the_reference():
    rng = np.random.default_rng(8)
    n = 700
    table = {"k": (rng.integers(0, 50, n), None, rng.random(n) > 0.1),
             "x": (rng.standard_normal(n), None, rng.random(n) > 0.1),
             "exists#0": (rng.random(n) > 0.5, None, None)}
    fields = [("k", TT.int64(), JT.int64()), ("x", TT.float64(), JT.float64()),
              ("exists#0", TT.bool_(), JT.bool_())]
    ts = TSchema([TF(nm, t, nullable=nm != "exists#0") for nm, t, _ in fields])
    js = JSchema([JF(nm, j, nullable=nm != "exists#0") for nm, _, j in fields])
    names = ["key", "x", "exists_ws"]
    port = RenameColumnsExec(MemoryScanExec(table_to_batches(table, ts, N_PARTS, 256, device=CPU), ts, device=CPU),
                             names)
    ref = JaxRename(JaxScan(jax_table_to_batches(table, js, N_PARTS, batch_rows=256), js), names)
    assert [(f.name, repr(f.dtype), f.nullable) for f in port.schema.fields] == \
        [(f.name, repr(f.dtype), f.nullable) for f in ref.schema.fields]
    got, want = _run(port, batch_to_pydict, TaskContext), _run(ref, jax_to_pydict, JaxContext)
    assert list(got) == names and got == want
    assert port.preserves_ordering and port.num_partitions() == N_PARTS
    with pytest.raises(ValueError, match="2 names for 3 columns"):
        RenameColumnsExec(port, ["a", "b"])


def _plans(q):
    """Both packages' plans of ``q`` over empty scans (serializing them
    reads no row)."""
    scans = {k: MemoryScanExec([[]] * N_PARTS, s, device=CPU) for k, s in TPCDS_SCHEMAS.items()}
    jscans = {k: JaxScan([[]] * N_PARTS, s) for k, s in JAX_DS_SCHEMAS.items()}
    return build_query(q, scans, N_PARTS), jax_build_ds(q, jscans, N_PARTS)


def _task_defs(scheduler, proto, resources, plan):
    """Every task's TaskDefinition bytes; what serializing staged is
    discarded."""
    stages, manager = scheduler.split_stages(plan)
    staged = []
    token = proto.STAGED_RIDS.set(staged)
    try:
        tds = [scheduler.build_task(s, manager, t)[1] for s in stages for t in range(s.n_tasks)]
    finally:
        proto.STAGED_RIDS.reset(token)
        for rid in staged:
            resources.discard(rid)
        shutil.rmtree(manager.root, ignore_errors=True)
    return [(s.kind, s.n_tasks) for s in stages], tds


QUERIES = ["q10", "q35", "q69", "q17", "q84"]


@pytest.mark.parametrize("q", QUERIES)
def test_task_definitions_equal_the_reference(q):
    port, ref = _plans(q)
    kinds, tds = _task_defs(S, to_proto, RESOURCES, port)
    jkinds, jtds = _task_defs(JS, jax_to_proto, JAX_RESOURCES, ref)
    assert kinds == jkinds
    assert normalized(tds) == normalized(jtds)
    assert not len(RESOURCES)
    if q in ("q10", "q35", "q69"):
        assert sum(t.count("rename_columns") for t in normalized(tds)) > 0


@pytest.mark.parametrize("q", QUERIES)
def test_reference_bytes_decode_and_encode_identically(q):
    _, jtds = _task_defs(JS, jax_to_proto, JAX_RESOURCES, _plans(q)[1])
    assert len(jtds) > 2
    for raw in jtds:
        td = wire.TaskDefinition.decode(raw)
        assert td.encode() == raw
        for scan in memory_scans(td.plan):
            RESOURCES.put(scan.resource_id, [[] for _ in range(scan.num_partitions)])
        plan = from_proto.plan_from_proto(td.plan)
        staged = []
        token = to_proto.STAGED_RIDS.set(staged)
        try:
            again = to_proto.task_definition(plan, td.task_id, td.stage_id, td.partition)
        finally:
            to_proto.STAGED_RIDS.reset(token)
            for rid in staged:
                RESOURCES.discard(rid)
        assert _scan_ids_normalized(again) == _scan_ids_normalized(raw)
    assert not len(RESOURCES)


def _renames(node):
    out = [node] if isinstance(node, RenameColumnsExec) else []
    for c in node.children:
        out += _renames(c)
    return out


def test_the_flags_keep_their_names_through_the_optimizer_and_the_wire():
    renames = _renames(optimize_plan(_plans("q10")[0]))
    assert [r.schema.names[-1] for r in renames] == ["exists_cs", "exists_ws"]
    assert all("exists#0" not in r.schema.names for r in renames)
    decoded = []
    for raw in _task_defs(S, to_proto, RESOURCES, _plans("q10")[0])[1]:
        td = wire.TaskDefinition.decode(raw)
        for scan in memory_scans(td.plan):
            RESOURCES.put(scan.resource_id, [[] for _ in range(scan.num_partitions)])
        decoded += _renames(from_proto.plan_from_proto(td.plan))
    # each task of the stage that holds them decodes both renames
    assert len(decoded) % len(renames) == 0
    assert {tuple(r.schema.names) for r in decoded} == {tuple(r.schema.names) for r in renames}
    assert not len(RESOURCES)
