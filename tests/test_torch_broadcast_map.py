"""Map-mode broadcast joins in the port against the JAX package's.

The broadcast carries the built join map, serialized
(``BroadcastJoinBuildHashMapExec``), instead of the build rows.  The
port's payload must be the reference's bytes for the same build batch,
each package must decode the other's, the join must give the rows of
raw mode and of the reference's map mode, and the map-mode plan must
cross the plan contract (TaskDefinition bytes equal to the
reference's) and ``run_stages`` (TPC-H q03 at SF 0.002, against its
oracle; a corrupt broadcast blob recovered).  The cases of the
reference's ``tests/test_broadcast_map.py`` run here on both packages.
"""

import os

import numpy as np
import pytest

from blaze_tpu.batch import batch_from_pydict as jax_from_pydict
from blaze_tpu.batch import batch_to_pydict as jax_to_pydict
from blaze_tpu.exprs import col as jcol
from blaze_tpu.ops import MemoryScanExec as JaxScan
from blaze_tpu.ops import joins as JJ
from blaze_tpu.ops.joins.core import build_join_map as jax_build_join_map
from blaze_tpu.ops.joins.core import make_build_kernel
from blaze_tpu.parallel.broadcast import BroadcastExchangeExec as JaxBroadcast
from blaze_tpu.runtime.context import RESOURCES as JAX_RESOURCES
from blaze_tpu.runtime.context import TaskContext as JaxContext
from blaze_tpu.schema import DataType as JT, Field as JF, Schema as JSchema
from blaze_tpu.serde import to_proto as jax_to_proto
from blaze_tpu.tpch import TPCH_SCHEMAS as JAX_SCHEMAS
from blaze_tpu.tpch import build_query as jax_build_query
from blaze_tpu.tpch.datagen import generate_all as jax_generate_all
from blaze_tpu.tpch.datagen import table_to_batches as jax_table_to_batches

import blaze_tpu_torch
import blaze_tpu_torch.batch as TB
from blaze_tpu_torch import conf
from blaze_tpu_torch.batch import batch_from_pydict, batch_to_pydict
from blaze_tpu_torch.exprs import col
from blaze_tpu_torch.kernels import cuda_ops
from blaze_tpu_torch.ops import MemoryScanExec
from blaze_tpu_torch.ops import joins as J
from blaze_tpu_torch.ops.fusion import optimize_plan
from blaze_tpu_torch.ops.joins.core import JoinMap, build_join_map
from blaze_tpu_torch.parallel.broadcast import BroadcastExchangeExec
from blaze_tpu_torch.runtime import faults
from blaze_tpu_torch.runtime import scheduler as S
from blaze_tpu_torch.runtime.context import RESOURCES, TaskContext
from blaze_tpu_torch.schema import DataType as TT, Field as TF, Schema as TSchema
from blaze_tpu_torch.serde import from_proto, to_proto
from blaze_tpu_torch.tpch import TPCH_SCHEMAS, build_query
from blaze_tpu_torch.tpch import oracle as O
from blaze_tpu_torch.tpch.datagen import generate_all

from test_torch_serde import _scan_ids_normalized

BUILD = {"k": [1, 2, 2, None, 5], "b": ["x", "y", "yy", "n", "z"]}
PROBE = {"k": [2, 1, 7, None, 5, 2], "p": [10, 20, 30, 40, 50, 60]}
SCALE = 0.002
N_PARTS = 2


def _schemas(T, F, Schema):
    return (Schema([F("k", T.int64()), F("b", T.string(8))]), Schema([F("k", T.int64()), F("p", T.int32())]))


TBUILD, TPROBE = _schemas(TT, TF, TSchema)
JBUILD, JPROBE = _schemas(JT, JF, JSchema)


@pytest.fixture(autouse=True)
def on_cpu():
    prev = blaze_tpu_torch._default_device
    blaze_tpu_torch.set_default_device("cpu")
    J.clear_join_map_cache()
    JJ.clear_join_map_cache()
    yield
    blaze_tpu_torch.set_default_device(prev)


def map_mode(plan, join=J.BroadcastJoinExec, exchange=BroadcastExchangeExec, build_map=J.BroadcastJoinBuildHashMapExec):
    """``plan`` with each broadcast join's build side
    ``BroadcastExchangeExec(child)`` rewritten into
    ``BroadcastExchangeExec(BroadcastJoinBuildHashMapExec(child, build
    keys))`` (a copy of ``chip_smoke.map_mode``; the classes are the
    port's unless given)."""
    for i, c in enumerate(list(plan.children)):
        plan.children[i] = map_mode(c, join, exchange, build_map)
    if isinstance(plan, join) and isinstance(plan.children[0], exchange):
        child = plan.children[0].children[0]
        return join(exchange(build_map(child, plan.build_keys)), plan.children[1], plan.build_keys, plan.probe_keys,
                    plan.join_type, plan.build_is_left, build_data_schema=child.schema,
                    cached_build_id=plan.cached_build_id)
    return plan


def _port(jt, mapped, build=BUILD, cache_id=None):
    bscan = MemoryScanExec([[batch_from_pydict(build, TBUILD)]], TBUILD)
    pscan = MemoryScanExec([[batch_from_pydict(PROBE, TPROBE)]], TPROBE)
    b = BroadcastExchangeExec(J.BroadcastJoinBuildHashMapExec(bscan, [col("k")]) if mapped else bscan)
    return J.BroadcastJoinExec(b, pscan, [col("k")], [col("k")], getattr(J.JoinType, jt), build_is_left=False,
                               cached_build_id=cache_id)


def _reference(jt, build=BUILD):
    bscan = JaxScan([[jax_from_pydict(build, JBUILD)]], JBUILD)
    pscan = JaxScan([[jax_from_pydict(PROBE, JPROBE)]], JPROBE)
    return JJ.BroadcastJoinExec(JaxBroadcast(JJ.BroadcastJoinBuildHashMapExec(bscan, [jcol("k")])), pscan,
                                [jcol("k")], [jcol("k")], getattr(JJ.JoinType, jt), build_is_left=False,
                                cached_build_id=f"ref_{jt}_{len(build['k'])}")


def _rows(plan, Context, to_pydict):
    rows = []
    n = plan.num_partitions()
    for p in range(n):
        for b in plan.execute(p, Context(p, n)):
            d = to_pydict(b)
            rows += list(zip(*[d[f.name] for f in plan.schema.fields]))
    return sorted(rows, key=repr)


@pytest.mark.parametrize("jt", ["INNER", "LEFT", "LEFT_SEMI", "LEFT_ANTI", "EXISTENCE",
                                "FULL", "RIGHT", "RIGHT_SEMI", "RIGHT_ANTI"])
def test_map_mode_equals_raw_mode_and_the_reference(jt):
    # one probe partition: the build-preserving types run too; the
    # reference's own map-mode cases are the first five
    got = _rows(_port(jt, mapped=True), TaskContext, batch_to_pydict)
    assert got == _rows(_port(jt, mapped=False), TaskContext, batch_to_pydict)
    if jt in ("INNER", "LEFT", "LEFT_SEMI", "LEFT_ANTI", "EXISTENCE"):
        assert got == _rows(_reference(jt), JaxContext, jax_to_pydict)


@pytest.mark.parametrize("jt", ["INNER", "LEFT_ANTI", "EXISTENCE"])
def test_a_build_side_with_no_rows(jt):
    empty = {"k": [], "b": []}
    plan = _port(jt, mapped=True, build=empty)
    got = _rows(plan, TaskContext, batch_to_pydict)
    assert got == _rows(_port(jt, mapped=False, build=empty), TaskContext, batch_to_pydict)
    assert got == _rows(_reference(jt, build=empty), JaxContext, jax_to_pydict)
    assert (len(got) == 0) == (jt == "INNER")
    # the 0-row payload is the reference's and decodes to no build rows
    bmap = plan.children[0].children[0]
    jbmap = JJ.BroadcastJoinBuildHashMapExec(JaxScan([[jax_from_pydict(empty, JBUILD)]], JBUILD), [jcol("k")])
    payload = bmap.payload(TaskContext(0, 1))
    assert payload == jbmap._build_payload(JaxContext(0, 1))
    assert JoinMap.deserialize(payload, TBUILD, [col("k")]) is None


def _build_table(n: int, seed: int):
    """Keys with duplicates and nulls, strings of every length."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(-40, 40, n).tolist()
    for i in rng.integers(0, n, n // 10):
        keys[i] = None
    words = ["", "a", "bb", "ccc", "dddd", "eeeee", "ffffff", "ggggggg"]
    return {"k": keys, "b": [None if i % 17 == 0 else words[i % 8] for i in range(n)]}


@pytest.mark.parametrize("n", [1, 1500])
def test_payload_bytes_equal_the_reference_and_decode_both_ways(n):
    data = _build_table(n, seed=n)
    tb, jb = batch_from_pydict(data, TBUILD), jax_from_pydict(data, JBUILD)
    tmap = build_join_map(tb, [col("k")])
    jmap = jax_build_join_map(jb, make_build_kernel(JBUILD, [jcol("k")]))
    payload = tmap.serialize()
    assert payload == jmap.serialize()
    # the port decodes the reference's bytes to its own map
    back = JoinMap.deserialize(jmap.serialize(), TBUILD, [col("k")])
    assert back.sorted_keys.tolist() == tmap.sorted_keys.tolist()
    assert back.sorted_rows.tolist() == tmap.sorted_rows.tolist()
    assert batch_to_pydict(back.batch) == batch_to_pydict(tb)
    assert [c.data.tolist() for c in back.key_cols] == [c.data.tolist() for c in tmap.key_cols]
    # the reference decodes the port's
    jback = JJ.JoinMap.deserialize(payload, JBUILD)
    assert jback.num_rows == n
    np.testing.assert_array_equal(np.asarray(jback.sorted_keys), np.asarray(jmap.sorted_keys))
    np.testing.assert_array_equal(np.asarray(jback.sorted_rows), np.asarray(jmap.sorted_rows))
    assert jax_to_pydict(jback.batch) == data
    # the emitted batch: the payload cut into minBatchCapacity rows
    bmap = J.BroadcastJoinBuildHashMapExec(MemoryScanExec([[tb]], TBUILD), [col("k")])
    (out,) = list(bmap.execute(0, TaskContext(0, 1)))
    rows = int(conf.MIN_CAPACITY.get())
    assert out.num_rows == rows and out.columns[0].dtype.string_width == max(8, -(-len(payload) // rows))
    assert J.broadcast.map_payload([out]) == payload
    assert bmap.metrics.values["payload_bytes"] == len(payload)


def test_cache_hit_on_a_reinstantiated_plan():
    first = _port("INNER", mapped=True, cache_id="bc_cache")
    want = _rows(first, TaskContext, batch_to_pydict)
    second = _port("INNER", mapped=True, cache_id="bc_cache")
    assert _rows(second, TaskContext, batch_to_pydict) == want
    assert second.metrics.values.get("hashmap_cache_hit") == 1
    assert "hashmap_cache_hit" not in first.metrics.values
    assert "build_hash_map_time" in first.metrics.values
    # the cache is keyed by the data schema, not the map's binary column
    assert any(k.startswith("bc_cache|") and "join_map#bytes" not in k for k in J.broadcast._MAP_CACHE)


def test_a_build_preserving_map_join_over_two_probe_partitions_raises():
    # reference defect 8's rule holds in map mode
    bscan = MemoryScanExec([[batch_from_pydict(BUILD, TBUILD)]], TBUILD)
    probe = MemoryScanExec([[batch_from_pydict(PROBE, TPROBE)], [batch_from_pydict(PROBE, TPROBE)]], TPROBE)
    build = BroadcastExchangeExec(J.BroadcastJoinBuildHashMapExec(bscan, [col("k")]))
    with pytest.raises(NotImplementedError, match="FULL broadcast join"):
        J.BroadcastJoinExec(build, probe, [col("k")], [col("k")], J.JoinType.FULL, build_is_left=False)


def test_the_data_schema_comes_from_the_map_node():
    plan = _port("INNER", mapped=True)
    assert plan.map_mode and plan.build_data_schema == TBUILD
    with pytest.raises(ValueError, match="build_data_schema"):
        J.BroadcastJoinExec(MemoryScanExec([[batch_from_pydict(BUILD, TBUILD)]], TBUILD), plan.children[1],
                            [col("k")], [col("k")], J.JoinType.INNER, False, build_data_schema=TPROBE)


def _task_defs(tplan, jplan):
    before = set(JAX_RESOURCES._map)
    jraw = jax_to_proto.task_definition(jplan, "t", 0, 0)
    for key in set(JAX_RESOURCES._map) - before:
        JAX_RESOURCES.discard(key)
    return to_proto.task_definition(tplan, "t", 0, 0), jraw


def test_task_definition_bytes_equal_the_reference():
    from blaze_tpu.parallel.broadcast import IpcWriterExec as JaxWriter
    from blaze_tpu_torch.parallel.broadcast import IpcWriterExec

    # the join over the map node, as Spark sends it
    tplan, jplan = _port("LEFT", mapped=True, cache_id="bc_td"), _reference("LEFT")
    tplan.children[0] = tplan.children[0].children[0]
    jplan = JJ.BroadcastJoinExec(jplan.children[0].children[0], jplan.children[1], [jcol("k")], [jcol("k")],
                                 JJ.JoinType.LEFT, build_is_left=False, cached_build_id="bc_td")
    traw, jraw = _task_defs(tplan, jplan)
    assert _scan_ids_normalized(traw) == _scan_ids_normalized(jraw)
    # the port decodes its bytes to the same map-mode plan
    back = from_proto.plan_from_proto(from_proto.pb.TaskDefinition.decode(traw).plan)
    assert back.map_mode and back.build_data_schema == TBUILD
    assert isinstance(back.children[0], J.BroadcastJoinBuildHashMapExec)
    assert _rows(back, TaskContext, batch_to_pydict) == _rows(_port("LEFT", mapped=False), TaskContext,
                                                              batch_to_pydict)
    # the broadcast stage's task: the map's drain into a blob
    traw, jraw = _task_defs(IpcWriterExec(tplan.children[0], "broadcast_7"),
                            JaxWriter(jplan.children[0], "broadcast_7"))
    assert _scan_ids_normalized(traw) == _scan_ids_normalized(jraw)
    for key in list(RESOURCES._map):
        RESOURCES.discard(key)


def test_the_pruner_leaves_the_map_side_whole():
    plan = map_mode(_port("INNER", mapped=False))
    want = _rows(_port("INNER", mapped=False), TaskContext, batch_to_pydict)
    from blaze_tpu_torch.ops import ProjectExec

    top = optimize_plan(ProjectExec(plan, [col("p")], ["p"]))
    (join,) = [n for n in _nodes(top) if isinstance(n, J.BroadcastJoinExec)]
    assert join.map_mode and join.build_data_schema == TBUILD
    bmap = join.children[0].children[0]
    assert isinstance(bmap, J.BroadcastJoinBuildHashMapExec) and bmap.data_schema == TBUILD
    assert sorted(r[0] for r in _rows(top, TaskContext, batch_to_pydict)) == sorted(r[1] for r in want)


def test_collect_ipc_blobs_equal_the_reference():
    data = _build_table(700, seed=3)
    parts = [[batch_from_pydict(data, TBUILD)], [batch_from_pydict(BUILD, TBUILD)]]
    jparts = [[jax_from_pydict(data, JBUILD)], [jax_from_pydict(BUILD, JBUILD)]]
    blobs = BroadcastExchangeExec(MemoryScanExec(parts, TBUILD)).collect_ipc()
    assert len(blobs) == 2
    assert blobs == JaxBroadcast(JaxScan(jparts, JBUILD)).collect_ipc()
    # the map's blob too (one partition)
    tx = BroadcastExchangeExec(J.BroadcastJoinBuildHashMapExec(MemoryScanExec(parts, TBUILD), [col("k")]))
    jx = JaxBroadcast(JJ.BroadcastJoinBuildHashMapExec(JaxScan(jparts, JBUILD), [jcol("k")]))
    assert tx.collect_ipc() == jx.collect_ipc()


# ------------------------------------------------------------ q03, both paths


@pytest.fixture(scope="module")
def tables():
    return generate_all(SCALE)


def _scans(data):
    return {name: MemoryScanExec(TB.table_to_batches(data[name], TPCH_SCHEMAS[name], N_PARTS, 4096, "cpu"),
                                 TPCH_SCHEMAS[name], device="cpu") for name in TPCH_SCHEMAS}


def _columns(batches, to_pydict):
    out = {}
    for b in batches:
        for k, v in to_pydict(b).items():
            out.setdefault(k, []).extend(v)
    return out


def _check_q3(rows, data):
    exp = O.oracle_q3(data)
    assert len(rows["l_orderkey"]) == len(exp) == 10
    assert set(zip(rows["l_orderkey"], rows["revenue"])) == {(r[0], r[1]) for r in exp}


def _lookups(monkeypatch):
    calls = []
    real = cuda_ops.sorted_lookup
    monkeypatch.setattr(cuda_ops, "sorted_lookup", lambda t, p: (calls.append(1), real(t, p))[1])
    return calls


def test_q3_in_map_mode_on_both_paths(tables, monkeypatch):
    calls = _lookups(monkeypatch)
    raw_plan = build_query("q3", _scans(tables), N_PARTS)
    raw = _columns([b for p in range(raw_plan.num_partitions())
                    for b in raw_plan.execute(p, TaskContext(p, raw_plan.num_partitions()))], batch_to_pydict)
    raw_lookups = len(calls)
    plan = map_mode(build_query("q3", _scans(tables), N_PARTS))
    assert any(isinstance(n, J.BroadcastJoinBuildHashMapExec) for n in _nodes(plan))
    del calls[:]
    got = _columns([b for p in range(plan.num_partitions())
                    for b in plan.execute(p, TaskContext(p, plan.num_partitions()))], batch_to_pydict)
    assert got == raw and len(calls) == raw_lookups > 0
    _check_q3(got, tables)
    # the reference's map-mode q03, in process, gives the same rows
    jax_data = jax_generate_all(SCALE)
    jscans = {name: JaxScan(jax_table_to_batches(jax_data[name], JAX_SCHEMAS[name], N_PARTS, batch_rows=4096),
                            JAX_SCHEMAS[name]) for name in JAX_SCHEMAS}
    jplan = map_mode(jax_build_query("q3", jscans, N_PARTS), JJ.BroadcastJoinExec, JaxBroadcast,
                     JJ.BroadcastJoinBuildHashMapExec)
    n = jplan.num_partitions()
    ref = _columns([b for p in range(n) for b in jplan.execute(p, JaxContext(p, n))], jax_to_pydict)
    assert ref == got
    # through split_stages/run_stages: the map's stage runs one task
    del calls[:]
    stats = S.RunStats()
    stages, manager = S.split_stages(map_mode(build_query("q3", _scans(tables), N_PARTS)))
    bstage = stages[0]
    assert bstage.kind == "broadcast" and bstage.n_tasks == 1
    assert isinstance(bstage.plan.children[0], J.BroadcastJoinBuildHashMapExec)
    reader = S.ipc_readers(stages[1].plan, "broadcast_")[0]
    assert reader.schema.fields[0].name == J.broadcast.MAP_COL
    scheduled = _columns(S.run_stages(stages, manager, stats), batch_to_pydict)
    assert scheduled == raw and len(calls) == raw_lookups
    assert len(RESOURCES) == 0 and not os.path.exists(manager.root)
    assert stats.broadcast_bytes > 0


def test_q3_map_mode_recovers_a_corrupt_broadcast_blob(tables):
    conf.TASK_RETRY_BACKOFF.set(0.0)
    conf.FAULTS_SPEC.set("broadcast.write@1@corrupt")
    faults.reset()
    try:
        stats = S.RunStats()
        stages, manager = S.split_stages(map_mode(build_query("q3", _scans(tables), N_PARTS)))
        rows = _columns(S.run_stages(stages, manager, stats), batch_to_pydict)
    finally:
        conf.FAULTS_SPEC.set("")
        conf.TASK_RETRY_BACKOFF.set(conf.TASK_RETRY_BACKOFF.default)
        faults.reset()
    _check_q3(rows, tables)
    assert stats.fetch_failures == 1 and stats.broadcast_stage_reruns == 1
    assert len(RESOURCES) == 0


def _nodes(plan):
    yield plan
    for c in plan.children:
        yield from _nodes(c)
