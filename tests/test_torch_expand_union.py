"""The port's ``ExpandExec`` and ``UnionExec`` against the reference's, a
union of two hash exchanges through ``run_stages``, and the plan
contract's window, expand and union nodes.

- Expand: a rollup's three projections with typed null literals over a
  seeded table with nulls; ``execute`` (one batch per projection) equals
  the reference's rows in order; the traced form, fused with the
  projection under it, gives the same multiset in one batch of
  ``3 x n`` rows with no padding row live, and a two-stage aggregation
  above it the reference's groups.
- Union: children of two and three partitions; partition ``p`` is every
  child's partition ``p`` in child order, as in the reference; pruning
  narrows every child alike.
- Through ``split_stages``/``run_stages``: the union's two readers keep
  their own shuffle ids, the result stage has the union's three tasks,
  and the rows equal the in-process run's.
- Serde: every field of every ``WindowFunction`` (frames with unbounded
  sides, lead with offset 0, ignore_nulls), expand's projections and
  union's inputs encode as the reference's ``to_proto`` does (parsed
  with its ``plan_pb2``) and decode to the same node.
"""

import numpy as np
import pytest

import blaze_tpu.exprs.ir as JIR
import blaze_tpu.ops as JOPS
from blaze_tpu import schema as JSCH
from blaze_tpu.batch import batch_to_pydict as jax_to_pydict
from blaze_tpu.ops.window import WindowFunction as JWF
from blaze_tpu.parallel.shuffle import IpcReaderExec as JaxReader
from blaze_tpu.runtime.context import TaskContext as JaxContext
from blaze_tpu.serde import plan_pb2
from blaze_tpu.serde import to_proto as jax_to_proto
from blaze_tpu.tpch.datagen import table_to_batches as jax_table_to_batches

import blaze_tpu_torch
import blaze_tpu_torch.exprs.ir as TIR
import blaze_tpu_torch.ops as TOPS
from blaze_tpu_torch import schema as TSCH
from blaze_tpu_torch.batch import batch_to_pydict, table_to_batches
from blaze_tpu_torch.ops import fusion
from blaze_tpu_torch.ops.pruning import prune_columns
from blaze_tpu_torch.parallel.exchange import NativeShuffleExchangeExec
from blaze_tpu_torch.parallel.shuffle import HashPartitioning, IpcReaderExec
from blaze_tpu_torch.runtime.context import RESOURCES, TaskContext
from blaze_tpu_torch.runtime.scheduler import run_stages, split_stages
from blaze_tpu_torch.serde import from_proto, to_proto, wire
from blaze_tpu_torch.tpch.queries import two_stage_agg

N = 300


def _schema(S):
    T = S.DataType
    return S.Schema([S.Field("a", T.string(16)), S.Field("b", T.int32()), S.Field("v", T.decimal(7, 2)),
                     S.Field("x", T.float64())])


def _table(n=N, seed=8):
    g = np.random.default_rng(seed)
    words = np.array(["red", "green", "blue", "cyan"])
    av = g.random(n) > 0.1
    data = np.zeros((n, 16), np.uint8)
    lengths = np.zeros(n, np.int32)
    for r, w in enumerate(words[g.integers(0, 4, n)]):
        if av[r]:
            data[r, :len(w)] = np.frombuffer(w.encode(), np.uint8)
            lengths[r] = len(w)
    return {"a": (data, lengths, av), "b": (g.integers(0, 5, n).astype(np.int32), None, g.random(n) > 0.1),
            "v": (g.integers(-9_999, 9_999, n).astype(np.int64), None, g.random(n) > 0.1),
            "x": (g.choice([0.5, -2.0, 3.25, np.nan], n), None, g.random(n) > 0.1)}


def _run(plan, to_pydict=batch_to_pydict, context=TaskContext):
    out = {f.name: [] for f in plan.schema.fields}
    n = plan.num_partitions()
    for p in range(n):
        for b in plan.execute(p, context(p, n)):
            for k, v in to_pydict(b).items():
                out[k].extend(v)
    return out


def _rows(cols):
    """The rows as a sorted list of their reprs (NaN equal to NaN)."""
    return sorted(map(repr, zip(*cols.values())))


def _torch_scan(parts, schema=None):
    return TOPS.MemoryScanExec(parts, schema or _schema(TSCH), device="cpu")


def _expand(M, child, S):
    c, L, T = M.col, M.Lit, S.DataType
    return M.ExpandExec(child, [[c("v"), c("a"), c("b"), M.lit(0)], [c("v"), c("a"), L(None, T.int32()), M.lit(1)],
                                [c("v"), L(None, T.string(16)), L(None, T.int32()), M.lit(3)]],
                        ["v", "a", "b", "g_id"])


class _J:
    col, lit, Lit, ExpandExec, ProjectExec = JIR.col, JIR.lit, JIR.Lit, JOPS.ExpandExec, JOPS.ProjectExec


class _T:
    col, lit, Lit, ExpandExec, ProjectExec = TIR.col, TIR.lit, TIR.Lit, TOPS.ExpandExec, TOPS.ProjectExec


def _project(M, child):
    c = M.col
    return M.ProjectExec(child, [c("a"), c("b"), (c("v") + c("v")).alias("v")])


@pytest.fixture(scope="module")
def table():
    return _table()


def test_expand_execute_equals_the_reference(table):
    got = _run(_expand(_T, _torch_scan(table_to_batches(table, _schema(TSCH), 2, 64, "cpu")), TSCH))
    want = _run(_expand(_J, JOPS.MemoryScanExec(jax_table_to_batches(table, _schema(JSCH), 2, batch_rows=64),
                                                _schema(JSCH)), JSCH), jax_to_pydict, JaxContext)
    assert got == want and len(got["v"]) == 3 * N
    assert got["g_id"].count(3) == N and all(a is None for a, g in zip(got["a"], got["g_id"]) if g == 3)


def test_fused_expand_is_one_batch_of_p_times_n_rows(table):
    plan = _expand(_T, _project(_T, _torch_scan(table_to_batches(table, _schema(TSCH), 2, 64, "cpu"))), TSCH)
    fused = fusion.fuse_traceable_chains(plan)
    assert type(fused).__name__ == "FusedStageExec"
    assert [type(o).__name__ for o in fused.ops] == ["ProjectExec", "ExpandExec"]
    batches = list(fused.execute(0, TaskContext(0, 2)))
    assert [b.num_rows for b in batches] == [3 * 64, 3 * 64, 3 * (150 - 128)]
    for b in batches:
        assert b.capacity >= b.num_rows and b.capacity & (b.capacity - 1) == 0
        assert not any(c.validity[b.num_rows:].any() for c in b.columns)
    assert _rows(_run(fused)) == _rows(_run(_expand(_T, _project(
        _T, _torch_scan(table_to_batches(table, _schema(TSCH), 2, 64, "cpu"))), TSCH)))


@pytest.mark.parametrize("fused", [False, True])
def test_rollup_aggregate_over_expand_equals_the_reference(table, fused):
    """Sums per (a, b, g_id) over the three levels: the PARTIAL agg sees
    no padding row of the fused 3 x n batch."""
    from blaze_tpu.tpch.queries import two_stage_agg as jax_two_stage_agg

    def agg(M, ops, child, S, stage):
        c = M.col
        return stage(_expand(M, _project(M, child), S),
                     [ops.GroupingExpr(c(k), k) for k in ("a", "b", "g_id")],
                     [ops.AggFunction("sum", c("v"), "s"), ops.AggFunction("count_star", None, "n")], 2)

    plan = agg(_T, TOPS, _torch_scan(table_to_batches(table, _schema(TSCH), 2, 64, "cpu")), TSCH, two_stage_agg)
    if fused:
        plan = fusion.optimize_plan(plan)
        assert "FusedStageExec" in repr([type(n).__name__ for n in _walk(plan)])
    got = _run(plan)
    want = _run(agg(_J, JOPS, JOPS.MemoryScanExec(jax_table_to_batches(table, _schema(JSCH), 2, batch_rows=64),
                                                  _schema(JSCH)), JSCH, jax_two_stage_agg),
                jax_to_pydict, JaxContext)
    assert _rows(got) == _rows(want) and sum(got["n"]) == 3 * N


def _walk(node):
    yield node
    for c in node.children:
        yield from _walk(c)


def _union_parts(table, to_batches, schema, **kw):
    half = {k: tuple(None if a is None else a[:N // 2] for a in v) for k, v in table.items()}
    rest = {k: tuple(None if a is None else a[N // 2:] for a in v) for k, v in table.items()}
    return to_batches(half, schema, 2, **kw), to_batches(rest, schema, 3, **kw)


def test_union_partitions_equal_the_reference(table):
    t2, t3 = _union_parts(table, table_to_batches, _schema(TSCH), device="cpu")
    j2, j3 = _union_parts(table, jax_table_to_batches, _schema(JSCH))
    u = TOPS.UnionExec([_torch_scan(t2), _torch_scan(t3)])
    ju = JOPS.UnionExec([JOPS.MemoryScanExec(j2, _schema(JSCH)), JOPS.MemoryScanExec(j3, _schema(JSCH))])
    assert u.num_partitions() == ju.num_partitions() == 3
    for p in range(3):
        got = {k: [] for k in u.schema.names}
        for b in u.execute(p, TaskContext(p, 3)):
            for k, v in batch_to_pydict(b).items():
                got[k].extend(v)
        want = {k: [] for k in u.schema.names}
        for b in ju.execute(p, JaxContext(p, 3)):
            for k, v in jax_to_pydict(b).items():
                want[k].extend(v)
        assert repr(got) == repr(want)


def test_pruning_narrows_every_union_child(table):
    t2, t3 = _union_parts(table, table_to_batches, _schema(TSCH), device="cpu")
    c = TIR.col
    plan = TOPS.ProjectExec(TOPS.UnionExec([_torch_scan(t2), _torch_scan(t3)]), [c("a"), c("v")])
    pruned = prune_columns(plan)
    u = pruned.children[0]
    assert type(u).__name__ == "UnionExec"
    assert all(ch.schema.names == ["a", "v"] for ch in u.children)
    assert _rows(_run(pruned)) == _rows(_run(plan))
    whole = TOPS.UnionExec([_torch_scan(t2), _torch_scan(t3)])
    assert prune_columns(whole) is whole  # every column needed: untouched, as in the reference


@pytest.fixture
def on_cpu():
    prev = blaze_tpu_torch._default_device
    blaze_tpu_torch.set_default_device("cpu")
    yield
    blaze_tpu_torch.set_default_device(prev)


def test_union_of_two_exchanges_through_run_stages(table, on_cpu):
    """Two hash exchanges (3 and 2 partitions) under one union: each
    reader keeps its own shuffle id, the result stage runs the union's
    3 tasks (the narrower side reads nothing in task 2), and the rows
    equal the in-process run's."""
    def plan():
        t2, t3 = _union_parts(table, table_to_batches, _schema(TSCH), device="cpu")
        c = TIR.col
        a = NativeShuffleExchangeExec(_torch_scan(t2), HashPartitioning([c("b")], 3))
        b = NativeShuffleExchangeExec(_torch_scan(t3), HashPartitioning([c("a")], 2))
        return TOPS.UnionExec([a, b]), (a.shuffle_id, b.shuffle_id)

    inproc = _run(plan()[0])
    root, sids = plan()
    stages, manager = split_stages(root)
    assert [s.kind for s in stages] == ["map", "map", "result"]
    assert [s.shuffle_id for s in stages[:2]] == list(sids) and stages[2].n_tasks == 3
    readers = stages[2].plan.children
    assert [(type(r), r.resource_id, r.num_partitions()) for r in readers] == [
        (IpcReaderExec, f"shuffle_{sids[0]}", 3), (IpcReaderExec, f"shuffle_{sids[1]}", 2)]
    staged = {k: [] for k in root.schema.names}
    for b in run_stages(stages, manager):
        for k, v in batch_to_pydict(b).items():
            staged[k].extend(v)
    assert _rows(staged) == _rows(inproc) and len(staged["a"]) == N
    assert not len(RESOURCES)


# ----------------------------------------------------------------- serde


def _window_functions(M, WF):
    c = M.col
    return [WF("row_number", "rn"), WF("rank", "rk"), WF("ntile", "nt", offset=4),
            WF("nth_value", "nv", c("x"), whole_partition=True, offset=3),
            WF("lead", "ld0", c("v"), offset=0), WF("lag", "lg", c("a"), offset=2, ignore_nulls=True),
            WF("sum", "s", c("v"), rows_frame=(None, 2)), WF("avg", "av", c("v"), rows_frame=(3, None)),
            WF("min", "mn", c("b"), rows_frame=(1, 1)), WF("count", "cn", c("v"), range_frame=(None, 5)),
            WF("max", "mx", c("v"), range_frame=(2, None)), WF("sum", "sw", c("x"), whole_partition=True)]


def _nodes(M, ops, WF, reader, S):
    c = M.col
    leaf = reader(_schema(S), "shuffle_7", 2)
    window = ops.WindowExec(leaf, _window_functions(M, WF), [c("a")], [ops.SortField(c("b"), False, False)])
    expand = _expand(M, leaf, S)
    union = ops.UnionExec([leaf, reader(_schema(S), "shuffle_8", 3)])
    return {"window": window, "expand": expand, "union": union}


class _JM:
    col, lit, Lit, ExpandExec, ProjectExec = JIR.col, JIR.lit, JIR.Lit, JOPS.ExpandExec, JOPS.ProjectExec


@pytest.mark.parametrize("kind", ["window", "expand", "union"])
def test_nodes_encode_as_the_reference_and_decode_to_the_same_node(kind, on_cpu):
    port = _nodes(_T, TOPS, TOPS.WindowFunction, IpcReaderExec, TSCH)[kind]
    ref = _nodes(_JM, JOPS, JWF, JaxReader, JSCH)[kind]
    data = to_proto.plan_to_proto(port).encode()
    want = jax_to_proto.plan_to_proto(ref).SerializeToString()
    parsed = plan_pb2.PhysicalPlanNode()
    parsed.ParseFromString(data)
    assert parsed == plan_pb2.PhysicalPlanNode.FromString(want)
    back = from_proto.plan_from_proto(wire.PhysicalPlanNode.decode(data))
    assert type(back) is type(port) and back.schema.names == port.schema.names
    assert to_proto.plan_to_proto(back).encode() == data
    if kind == "window":
        for f, g in zip(back.functions, port.functions):
            assert (f.kind, f.name, f.whole_partition, f.rows_frame, f.offset, f.ignore_nulls, f.range_frame) == (
                g.kind, g.name, g.whole_partition, g.rows_frame, g.offset, g.ignore_nulls, g.range_frame)
    if kind == "union":
        assert back.num_partitions() == 3
