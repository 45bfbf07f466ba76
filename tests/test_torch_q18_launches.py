"""Why TPC-H q18's two paths hash a different number of batches, pinned
against the reference's split (ROADMAP queue C, out of "open").

Through ``run_stages`` the map stage that writes q18's big-order keys
(the ``qsum > 300`` filter over the FINAL per-order sums, exchanged on
``qk``) folds the filter into its shuffle write (fusion tier 5): the
write hashes every batch over its whole capacity and reads no count
back, so a batch the filter empties still goes through ``murmur3_pids``
and ``pid_histogram``.  In process the exchange pulls the fused filter,
which reads each batch's count and drops an empty batch before it is
hashed.  The reference splits q18 into the same stages and folds the
same filter into the same write, so this is the reference's design,
not a port deviation: the paths differ by exactly the batches the
filter empties, and every other exchange hashes alike.  The data are
SF 0.01 with three orders' quantities raised past the filter, so that
it keeps rows in some partitions and empties the others (at SF 0.01
it keeps none).
"""

import collections
import shutil

import numpy as np
import pytest

from blaze_tpu.ops import MemoryScanExec as JaxScan
from blaze_tpu.ops.fusion import optimize_plan as jax_optimize
from blaze_tpu.runtime import scheduler as JS
from blaze_tpu.tpch import TPCH_SCHEMAS as JAX_SCHEMAS
from blaze_tpu.tpch import build_query as jax_build_query

import blaze_tpu_torch
from blaze_tpu_torch.batch import batch_to_pydict, table_to_batches
from blaze_tpu_torch.ops import MemoryScanExec
from blaze_tpu_torch.ops.fusion import optimize_plan
from blaze_tpu_torch.parallel import exchange as EX, shuffle as SH
from blaze_tpu_torch.runtime import scheduler as S
from blaze_tpu_torch.runtime.context import TaskContext
from blaze_tpu_torch.tpch import TPCH_SCHEMAS, build_query
from blaze_tpu_torch.tpch.datagen import generate_all, with_spec_columns

N_PARTS = 8


@pytest.fixture(autouse=True)
def on_cpu():
    prev = blaze_tpu_torch._default_device
    blaze_tpu_torch.set_default_device("cpu")
    yield
    blaze_tpu_torch.set_default_device(prev)


@pytest.fixture(scope="module")
def data():
    d = with_spec_columns(generate_all(0.01), 0.01)
    keys, qty = d["lineitem"]["l_orderkey"][0], d["lineitem"]["l_quantity"][0]
    big = np.isin(keys, np.unique(keys)[[5, 700, 9000]])
    qty = qty.copy()
    qty[big] = 10000  # 100.00 a line: past qsum > 300
    d["lineitem"]["l_quantity"] = (qty,) + d["lineitem"]["l_quantity"][1:]
    return d


def _scans(data):
    return {n: MemoryScanExec(table_to_batches(data[n], TPCH_SCHEMAS[n], N_PARTS, 1 << 20, "cpu"),
                              TPCH_SCHEMAS[n], device="cpu") for n in TPCH_SCHEMAS}


def _count_hashes(monkeypatch):
    calls = collections.Counter()
    live = collections.Counter()
    orig = SH.hash_pids

    def counted(schema, exprs, cols, n, n_out):
        key = tuple(e.name for e in exprs)
        calls[key] += 1
        return orig(schema, exprs, cols, n, n_out)

    monkeypatch.setattr(SH, "hash_pids", counted)
    monkeypatch.setattr(EX, "hash_pids", counted)
    return calls, live


def _rows(batches):
    out = {}
    for b in batches:
        for k, v in batch_to_pydict(b).items():
            out.setdefault(k, []).extend(v)
    return out


def test_the_paths_differ_by_the_batches_the_folded_filter_empties(data, monkeypatch):
    calls, _ = _count_hashes(monkeypatch)
    plan = optimize_plan(build_query("q18", _scans(data), N_PARTS))
    n = plan.num_partitions()
    rows = _rows(b for p in range(n) for b in plan.execute(p, TaskContext(p, n)))
    in_process = dict(calls)
    calls.clear()
    stages, manager = S.split_stages(build_query("q18", _scans(data), N_PARTS))
    assert _rows(S.run_stages(stages, manager)) == rows and rows["o_orderkey"]
    staged = dict(calls)
    # the per-order partial sums (8 map tasks) and the big keys (8 more
    # through run_stages, only the partitions that keep a key in process)
    kept = in_process[("qk",)] - N_PARTS
    assert 0 < kept < N_PARTS and staged[("qk",)] == 2 * N_PARTS
    assert {k: v for k, v in staged.items() if k != ("qk",)} == \
        {k: v for k, v in in_process.items() if k != ("qk",)}


def _writer(node):
    while type(node).__name__ != "ShuffleWriterExec":
        node = node.children[0]
    return node


def _chain(node):
    out = []
    while node.children:
        out.append(type(node).__name__)
        node = node.children[0]
    return out + [type(node).__name__]


def _big_keys_writer(scheduler, proto, resources, stages, manager, optimize):
    """The map task that writes the big-order keys, optimized: its
    writer and the node classes under it (what serializing the task
    staged is discarded)."""
    for s in stages:
        part = getattr(s, "partitioning", None) or getattr(s, "_partitioning", None)
        if s.kind == "map" and [e.name for e in part.exprs] == ["qk"] and "FilterExec" in _chain(s.plan):
            staged = []
            token = proto.STAGED_RIDS.set(staged)
            try:
                plan = scheduler.build_task(s, manager, 0)[0]
            finally:
                proto.STAGED_RIDS.reset(token)
                for rid in staged:
                    resources.discard(rid)
            writer = _writer(optimize(plan))
            return writer, _chain(writer.children[0])
    raise AssertionError("no big-keys map stage")


def test_the_reference_splits_q18_alike_and_folds_the_same_filter(data):
    from blaze_tpu.runtime.context import RESOURCES as JAX_RESOURCES
    from blaze_tpu.serde import to_proto as jax_to_proto
    from blaze_tpu_torch.runtime.context import RESOURCES
    from blaze_tpu_torch.serde import to_proto

    scans = {n: MemoryScanExec([[]] * N_PARTS, s, device="cpu") for n, s in TPCH_SCHEMAS.items()}
    jscans = {n: JaxScan([[]] * N_PARTS, s) for n, s in JAX_SCHEMAS.items()}
    stages, manager = S.split_stages(build_query("q18", scans, N_PARTS))
    jstages, jmanager = JS.split_stages(jax_build_query("q18", jscans, N_PARTS))
    try:
        assert [(s.kind, s.n_tasks) for s in stages] == [(s.kind, s.n_tasks) for s in jstages]
        writer, below = _big_keys_writer(S, to_proto, RESOURCES, stages, manager, optimize_plan)
        jwriter, jbelow = _big_keys_writer(JS, jax_to_proto, JAX_RESOURCES, jstages, jmanager, jax_optimize)
    finally:
        manager.cleanup()
        shutil.rmtree(jmanager.root, ignore_errors=True)
    assert below == jbelow and below[0] == "AggExec" and "FilterExec" not in below
    assert writer.fused and writer._fused_chain is not None
    assert jwriter._fused_write is not None
    assert not len(RESOURCES)
