"""The port's stage scheduler against the JAX package's, on one proto.

q01, q03 and q06 at SF 0.002 with two partitions run through the
port's ``split_stages``/``run_stages``: every task is serialized to
TaskDefinition bytes and run by ``from_proto.run_task``, hash exchanges
go through ``.data``/``.index`` files and broadcasts through
checksummed blobs.  Each query equals the port's numpy oracle and
in-process result, and the reference's ``run_stages`` where that is
right (see the q03 test); ``RESOURCES`` is empty and the shuffle
directory gone after each.  The port's ``run_task`` also runs the
reference's own TaskDefinition bytes, the memory-scan partitions
registered in the port's ``RESOURCES`` under the reference's ids.
"""

import os
import shutil

import pytest

from blaze_tpu.batch import batch_to_pydict as jax_to_pydict
from blaze_tpu.ops import MemoryScanExec as JaxScan
from blaze_tpu.runtime import scheduler as JS
from blaze_tpu.runtime.context import RESOURCES as JAX_RESOURCES
from blaze_tpu.serde import to_proto as jax_to_proto
from blaze_tpu.tpch import TPCH_SCHEMAS as JAX_SCHEMAS
from blaze_tpu.tpch import build_query as jax_build_query
from blaze_tpu.tpch import oracle as jax_oracle
from blaze_tpu.tpch.datagen import generate_all as jax_generate_all
from blaze_tpu.tpch.datagen import table_to_batches as jax_table_to_batches

import blaze_tpu_torch
import blaze_tpu_torch.batch as TB
from blaze_tpu_torch.ops import MemoryScanExec
from blaze_tpu_torch.ops.joins import broadcast as bj
from blaze_tpu_torch.parallel.shuffle import LocalShuffleManager
from blaze_tpu_torch.runtime import integrity
from blaze_tpu_torch.runtime import scheduler as S
from blaze_tpu_torch.runtime.context import RESOURCES, TaskContext
from blaze_tpu_torch.serde import from_proto, wire
from blaze_tpu_torch.tpch import TPCH_SCHEMAS, build_query
from blaze_tpu_torch.tpch import oracle as O
from blaze_tpu_torch.tpch.datagen import generate_all

SCALE = 0.002
N_PARTS = 2


@pytest.fixture(autouse=True)
def on_cpu():
    prev = blaze_tpu_torch._default_device
    blaze_tpu_torch.set_default_device("cpu")
    yield
    blaze_tpu_torch.set_default_device(prev)


@pytest.fixture(scope="module")
def data():
    return generate_all(SCALE)


@pytest.fixture(scope="module")
def jax_data():
    return jax_generate_all(SCALE)


def _scans(data):
    return {name: MemoryScanExec(TB.table_to_batches(data[name], TPCH_SCHEMAS[name], N_PARTS, 4096, "cpu"),
                                 TPCH_SCHEMAS[name], device="cpu") for name in TPCH_SCHEMAS}


def _jax_scans(jax_data):
    return {name: JaxScan(jax_table_to_batches(jax_data[name], JAX_SCHEMAS[name], N_PARTS, batch_rows=4096),
                          JAX_SCHEMAS[name]) for name in JAX_SCHEMAS}


def _rows(batches, to_pydict):
    out = {}
    for b in batches:
        for k, v in to_pydict(b).items():
            out.setdefault(k, []).extend(v)
    return out


@pytest.fixture(scope="module")
def jax_scheduled(jax_data):
    """The reference's run_stages results, and the registrations each
    query left in the reference's RESOURCES (discarded here, so no
    later test in this process sees them)."""
    out, left = {}, {}
    for q in ("q1", "q3", "q6"):
        before = set(JAX_RESOURCES._map)
        stages, manager = JS.split_stages(jax_build_query(q, _jax_scans(jax_data), N_PARTS))
        out[q] = _rows(JS.run_stages(stages, manager), jax_to_pydict)
        left[q] = sorted(set(JAX_RESOURCES._map) - before)
        for key in left[q]:
            JAX_RESOURCES.discard(key)
        shutil.rmtree(manager.root)
    out["left"] = left
    return out


def run_port(data, q, stats=None):
    stages, manager = S.split_stages(build_query(q, _scans(data), N_PARTS))
    rows = _rows(S.run_stages(stages, manager, stats), TB.batch_to_pydict)
    assert len(RESOURCES) == 0 and not os.path.exists(manager.root)
    return stages, rows


def run_in_process(data, q):
    plan = build_query(q, _scans(data), N_PARTS)
    n = plan.num_partitions()
    return _rows([b for p in range(n) for b in plan.execute(p, TaskContext(p, n))], TB.batch_to_pydict)


def check_q1(rows, data):
    exp = O.oracle_q1(data)
    keys = list(zip(rows["l_returnflag"], rows["l_linestatus"]))
    assert keys == sorted(exp) and len(keys) > 1
    for i, key in enumerate(keys):
        assert {m: rows[m][i] for m in exp[key]} == exp[key], key


def q3_pairs(rows):
    return {(k, r) for k, r in zip(rows["l_orderkey"], rows["revenue"])}


def check_q3(rows, data):
    exp = O.oracle_q3(data)
    assert len(rows["l_orderkey"]) == len(exp) == 10
    assert q3_pairs(rows) == {(r[0], r[1]) for r in exp}
    assert rows["revenue"] == sorted(rows["revenue"], reverse=True)


def test_q6_equals_the_reference_scheduler_and_oracle(data, jax_scheduled):
    stats = S.RunStats()
    stages, rows = run_port(data, "q6", stats)
    assert [s.kind for s in stages] == ["map", "result"]
    assert rows == jax_scheduled["q6"] == run_in_process(data, "q6")
    assert rows["revenue"] == [O.oracle_q6(data)]
    assert stats.tasks == 3 and stats.blocks == 2 and stats.data_bytes > 0 and stats.task_def_bytes > 0


def test_q1_equals_the_reference_scheduler_and_oracle(data, jax_scheduled):
    stages, rows = run_port(data, "q1")
    assert [s.kind for s in stages] == ["map", "map", "result"]
    assert rows == jax_scheduled["q1"] == run_in_process(data, "q1")
    check_q1(rows, data)


def test_q3_equals_the_oracle_where_the_reference_scheduler_double_scales(data, jax_data, jax_scheduled):
    """q03 through the port's run_stages equals the oracle and the
    port's in-process rows.  The reference's run_stages does not: its
    literal slotification (``blaze_tpu/exprs/compile.py``
    ``_slot_physical``) scales the decoded ``_RawUnscaled`` decimal
    ``1`` of ``1 - l_discount`` a second time (100.00), so its revenue
    is about 100x (ROADMAP queue C)."""
    stages, rows = run_port(data, "q3")
    assert [s.kind for s in stages] == ["broadcast", "map", "map", "map", "map", "result"]
    assert rows == run_in_process(data, "q3")
    check_q3(rows, data)
    assert O.oracle_q3(data) == jax_oracle.oracle_q3(jax_data)
    ref = jax_scheduled["q3"]
    assert ref["revenue"][0] > 50 * rows["revenue"][0]  # the reference defect, pinned
    assert not q3_pairs(ref) & q3_pairs(rows)


def test_reference_scheduler_leaves_a_broadcast_blob(data, jax_scheduled):
    """The reference's q03 leaves its broadcast blob registered: the
    join-map cache hit of its second task never reads it (ROADMAP queue
    C).  The port discards every registration a task did not consume."""
    assert [k.rsplit(".", 1)[1] for k in jax_scheduled["left"]["q3"]] == ["0"]
    assert all(k.startswith("broadcast_") for k in jax_scheduled["left"]["q3"])
    assert jax_scheduled["left"]["q1"] == jax_scheduled["left"]["q6"] == []
    run_port(data, "q3")
    assert len(RESOURCES) == 0


def test_broadcast_join_map_is_built_once_per_split(data, monkeypatch):
    """Each task of the broadcast join's stage decodes its own plan;
    the cached_build_id makes them build the join map once."""
    puts = []
    real = bj._cache_put
    monkeypatch.setattr(bj, "_cache_put", lambda key, m: (puts.append(key), real(key, m)))
    stages, _ = run_port(data, "q3")
    consumer = next(s for s in stages if s.kind == "map" and S.ipc_readers(s.plan, "broadcast_"))
    assert consumer.n_tasks == N_PARTS and len(puts) == 1
    assert puts[0].startswith("sched_bcast_")
    assert not [k for k in bj._MAP_CACHE if k.startswith(puts[0].split("|")[0])]


def test_closing_the_result_stream_early_cleans_up(data):
    stages, manager = S.split_stages(build_query("q3", _scans(data), N_PARTS))
    it = S.run_stages(stages, manager)
    next(it)
    it.close()
    assert len(RESOURCES) == 0 and not os.path.exists(manager.root)


@pytest.mark.parametrize("stage_attempts", [4, 1])
def test_a_corrupted_block_fails_its_reduce_task_and_leaves_nothing(data, stage_attempts):
    """A flipped byte in map 1's committed output fails q06's reduce
    task, whose reader names map 1: that map task alone re-runs, and the
    retried reduce task gives the fault-free rows.  With
    ``spark.blaze.stage.maxAttempts`` 1 the re-run map output is
    corrupt again, and the second regeneration the task asks for is one
    too many: ``TaskRetriesExhausted``, the ``BlockCorruptionError`` in
    its cause chain.  Nothing is left registered either way."""
    from blaze_tpu_torch import conf
    from blaze_tpu_torch.runtime import faults
    from blaze_tpu_torch.runtime.retry import FetchFailedError, TaskRetriesExhausted

    _, want = run_port(data, "q6")
    conf.TASK_RETRY_BACKOFF.set(0.0)
    conf.STAGE_MAX_ATTEMPTS.set(stage_attempts)
    # q06's map stage commits maps 0 and 1: hits 1 and 2; the re-run of map 1 hit 3
    conf.FAULTS_SPEC.set("shuffle.write@2@corrupt" + (",shuffle.write@3@corrupt" if stage_attempts == 1 else ""))
    faults.reset()
    stats = S.RunStats()
    try:
        if stage_attempts == 1:
            stages, manager = S.split_stages(build_query("q6", _scans(data), N_PARTS))
            with pytest.raises(TaskRetriesExhausted) as e:
                list(S.run_stages(stages, manager, stats))
            chain = [e.value.__cause__, e.value.__cause__.__cause__]
            assert isinstance(chain[0], FetchFailedError) and chain[0].map_ids == [1]
            assert isinstance(chain[1], integrity.BlockCorruptionError)
            assert stats.map_tasks_rerun == 1 and stats.fetch_failures == 2
        else:
            assert run_port(data, "q6", stats)[1] == want
            assert (stats.fetch_failures, stats.map_stage_reruns, stats.map_tasks_rerun) == (1, 1, 1)
            assert stats.task_retries == 0 and stats.task_attempts == 5  # 2 maps, map 1 again, 2 reduce attempts
    finally:
        conf.FAULTS_SPEC.set("")
        conf.STAGE_MAX_ATTEMPTS.set(4)
        conf.TASK_RETRY_BACKOFF.set(0.1)
        faults.reset()
        integrity.reset()
    assert len(RESOURCES) == 0


# ------------------------------------------ the reference's own TaskDefinitions


def _find(msg, cls):
    """Every message of type ``cls`` under a decoded message."""
    if isinstance(msg, cls):
        return [msg]
    out = []
    for f in msg._spec.fields:
        if f.type != "message":
            continue
        subs = getattr(msg, f.name) if f.repeated else [getattr(msg, f.name)] if msg.has_field(f.name) else []
        for m in subs:
            out += _find(m, cls)
    return out


def run_reference_bytes(data, jax_data, q):
    """Every task of the reference's split of ``q``, from the
    reference's TaskDefinition bytes, through the port's run_task; the
    port registers what each task reads, as run_stages does."""
    jstages, jmanager = JS.split_stages(jax_build_query(q, _jax_scans(jax_data), N_PARTS))
    parts = {name: TB.table_to_batches(data[name], TPCH_SCHEMAS[name], N_PARTS, 4096, "cpu")
             for name in TPCH_SCHEMAS}
    table_of = {tuple(s.names): name for name, s in TPCH_SCHEMAS.items()}
    manager = LocalShuffleManager(jmanager.root)
    n_maps, blobs, out = {}, {}, []
    try:
        for st in jstages:
            for t in range(st.n_tasks):
                staged = []
                token = jax_to_proto.STAGED_RIDS.set(staged)
                try:
                    td = JS.build_task(st, jmanager, t)[1]
                finally:
                    jax_to_proto.STAGED_RIDS.reset(token)
                    for rid in staged:
                        JAX_RESOURCES.discard(rid)
                plan = wire.TaskDefinition.decode(td).plan
                for scan in _find(plan, wire.MemoryScanNode):
                    names = tuple(f.name for f in scan.schema.fields)
                    RESOURCES.put(scan.resource_id, parts[table_of[names]])
                keys = []
                for r in _find(plan, wire.IpcReaderNode):
                    kind, rid = r.ipc_provider_resource_id.split("_")
                    if kind == "shuffle":
                        keys.append(f"shuffle_{rid}.{t}")
                        RESOURCES.put(keys[-1], manager.reduce_blocks(int(rid), n_maps[int(rid)], t))
                    else:
                        keys.append(f"broadcast_{rid}.0")
                        RESOURCES.put(keys[-1], blobs[int(rid)])
                batches = list(from_proto.run_task(td))
                for key in keys:
                    RESOURCES.discard(key)
                if st.kind == "result":
                    out += batches
            if st.kind == "map":
                n_maps[st.shuffle_id] = st.n_tasks
            elif st.kind == "broadcast":
                bid = st.broadcast_id
                blobs[bid] = [RESOURCES.get(f"broadcast_{bid}.{p}") for p in range(st.n_tasks)]
    finally:
        manager.cleanup()
        bj.clear_join_map_cache(f"sched_bcast_{id(jmanager)}_")
    assert len(RESOURCES) == 0
    return _rows(out, TB.batch_to_pydict)


@pytest.mark.parametrize("q", ["q1", "q3", "q6"])
def test_run_task_runs_the_reference_task_definitions(data, jax_data, jax_scheduled, q):
    rows = run_reference_bytes(data, jax_data, q)
    if q == "q3":
        check_q3(rows, data)
        assert rows == run_in_process(data, "q3")
    else:
        assert rows == jax_scheduled[q]
        if q == "q1":
            check_q1(rows, data)
        else:
            assert rows["revenue"] == [O.oracle_q6(data)]
