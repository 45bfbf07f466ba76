"""The port's range and round-robin exchanges against the JAX package's.

One seeded table (an int64 key with nulls and ties, a string key with
nulls, a decimal, a unique row id), 3 map partitions of 4 batches each,
goes through both packages:

- Range, in process and through ``split_stages``/``run_stages``:
  ascending and descending keys, nulls first and last, a string key, a
  decimal key, two keys, ties across a boundary, an empty input.  Each
  partition's rows (in process) and the boundary words and each
  partition's sorted rows (through ``run_stages``) equal the
  reference's; the partitions read in order equal numpy's lexsort.  A
  boundary pass with a smaller sample cap than the stage's rows still
  gives the total order and the reference's boundaries.  String keys
  narrower than their dtype in one batch and wider in another order
  alike (``tests/test_shuffle.py``'s mixed widths, descending too).
- The RANGE and ROUND_ROBIN protos: a map task's TaskDefinition bytes
  equal the reference's; the boundary words cross the wire bit for bit.
- Round robin: every row's partition equals the reference's, in process
  (each map task starting one partition on) and through the writer
  (each starting at 0), over several batches and map tasks.
- The writers of both kinds, fused (tier 5) and not, commit the same
  ``.data``/``.index`` bytes, behind a filter and a projection, and the
  reduce partitions hold the reference's rows.
"""

import functools
import os
import shutil

import numpy as np
import pytest

import blaze_tpu.batch as JB
from blaze_tpu.exprs import col as jcol, lit as jlit
from blaze_tpu.ops import FilterExec as JFilter, MemoryScanExec as JScan, ProjectExec as JProject
from blaze_tpu.ops import SortExec as JSort, SortField as JSortField
from blaze_tpu.parallel import RangePartitioning as JRange, RoundRobinPartitioning as JRR
from blaze_tpu.parallel.exchange import NativeShuffleExchangeExec as JExchange
from blaze_tpu.parallel.shuffle import IpcReaderExec as JReader, LocalShuffleManager as JManager
from blaze_tpu.parallel.shuffle import ShuffleWriterExec as JWriter
from blaze_tpu.runtime import scheduler as JS
from blaze_tpu.runtime.context import RESOURCES as JAX_RESOURCES
from blaze_tpu.runtime.context import TaskContext as JCtx
from blaze_tpu.schema import DataType as JT, Field as JF, Schema as JSchema
from blaze_tpu.serde import to_proto as jax_to_proto
from blaze_tpu.tpch.datagen import table_to_batches as jax_batches

import blaze_tpu_torch
import blaze_tpu_torch.batch as TB
from blaze_tpu_torch import conf
from blaze_tpu_torch.exprs import col, lit
from blaze_tpu_torch.ops import FilterExec, MemoryScanExec, ProjectExec, SortExec
from blaze_tpu_torch.ops.fusion import optimize_plan
from blaze_tpu_torch.ops.sort import SortField, range_key_words, words_order
from blaze_tpu_torch.parallel import RangePartitioning, RoundRobinPartitioning
from blaze_tpu_torch.parallel.exchange import NativeShuffleExchangeExec
from blaze_tpu_torch.parallel.shuffle import IpcReaderExec, LocalShuffleManager
from blaze_tpu_torch.runtime import scheduler as S
from blaze_tpu_torch.runtime.context import RESOURCES, TaskContext
from blaze_tpu_torch.schema import DataType as TT, Field as TF, Schema as TSchema
from blaze_tpu_torch.serde import from_proto, to_proto, wire

from test_torch_serde import normalized

N = 1200
N_MAPS = 3
BATCH = 100
N_OUT = 4

TYPES = [("k", TT.int64(), JT.int64()), ("s", TT.string(16), JT.string(16)),
         ("m", TT.decimal(12, 2), JT.decimal(12, 2)), ("d", TT.int64(), JT.int64())]
TSCHEMA = TSchema([TF(n, t) for n, t, _ in TYPES])
JSCHEMA = JSchema([JF(n, j) for n, _, j in TYPES])

# (label, [(column, ascending, nulls first)]); the int key's 41 values
# over 1200 rows put ties across every boundary
KEYS = [
    ("k asc nulls first, s desc nulls last", [("k", True, True), ("s", False, False)]),
    ("k desc nulls last", [("k", False, False)]),
    ("m desc nulls first", [("m", False, True)]),
]


@pytest.fixture(autouse=True)
def on_cpu():
    prev = blaze_tpu_torch._default_device
    blaze_tpu_torch.set_default_device("cpu")
    yield
    blaze_tpu_torch.set_default_device(prev)


def _table(n=N, seed=5):
    rng = np.random.default_rng(seed)
    words = [b"alpha", b"be", b"gamma-ray", b"", b"delta", b"zeta-function"]
    s = [words[j] for j in rng.integers(0, len(words), n)]
    data = np.zeros((n, 16), np.uint8)
    for r, b in enumerate(s):
        data[r, :len(b)] = np.frombuffer(b, np.uint8)
    return {"k": (rng.integers(-20, 21, n), None, rng.random(n) > 0.1),
            "s": (data, np.array([len(b) for b in s], np.int32), rng.random(n) > 0.1),
            "m": (rng.integers(-10**6, 10**6, n), None, rng.random(n) > 0.05),
            "d": (np.arange(n, dtype=np.int64), None, None)}


TABLE = _table()


def _scans(table=TABLE):
    return (MemoryScanExec(TB.table_to_batches(table, TSCHEMA, N_MAPS, BATCH, "cpu"), TSCHEMA, device="cpu"),
            JScan(jax_batches(table, JSCHEMA, N_MAPS, BATCH), JSCHEMA))


def _fields(spec):
    return ([SortField(col(c), a, nf) for c, a, nf in spec], [JSortField(jcol(c), a, nf) for c, a, nf in spec])


def _rows(batches, to_pydict):
    out = {}
    for b in batches:
        for k, v in to_pydict(b).items():
            out.setdefault(k, []).extend(v)
    return out


def _lexsort_ids(table, spec):
    """The row ids in the order of ``spec``, ties by row id (as a
    stable sort of the ids keeps them)."""
    keys = [table["d"][0]]
    for c, asc, nulls_first in reversed(spec):
        data = table[c][0]
        valid = table[c][-1] if table[c][-1] is not None else np.ones(len(data), bool)
        if c == "s":
            data = np.ascontiguousarray(data).view("S16").ravel()
            ranks = np.unique(data, return_inverse=True)[1]
        else:
            ranks = data
        ranks = np.where(valid, ranks if asc else -ranks, 0)
        keys += [ranks, valid if nulls_first else ~valid]
    return np.lexsort(keys).tolist()


def _total_order(ordered_ids, table, spec):
    """The partitions read in order are sorted by ``spec``: within the
    same keys, rows may come in any order."""
    want = _lexsort_ids(table, spec)
    rank = {d: i for i, d in enumerate(want)}
    key = {}
    for d in want:
        key[d] = tuple((table[c][-1] is None or bool(table[c][-1][d]),
                        table[c][0][d].tobytes() if c == "s" else int(table[c][0][d])) for c, _, _ in spec)
    got_keys = [key[d] for d in ordered_ids]
    assert sorted(ordered_ids) == sorted(want)
    assert got_keys == [key[d] for d in want], [rank[d] for d in ordered_ids][:20]


@pytest.mark.parametrize("label,spec", KEYS, ids=[k for k, _ in KEYS])
def test_range_in_process_equals_the_reference(label, spec):
    tscan, jscan = _scans()
    tf, jf = _fields(spec)
    tex = NativeShuffleExchangeExec(tscan, RangePartitioning(tf, N_OUT))
    jex = JExchange(jscan, JRange(jf, N_OUT))
    tparts = [_rows(tex.execute(p, TaskContext(p, N_OUT)), TB.batch_to_pydict) for p in range(N_OUT)]
    jparts = [_rows(jex.execute(p, JCtx(p, N_OUT)), JB.batch_to_pydict) for p in range(N_OUT)]
    assert tparts == jparts
    sort = SortExec(tex, tf)
    ordered = [d for p in range(N_OUT) for b in sort.execute(p, TaskContext(p, N_OUT))
               for d in TB.batch_to_pydict(b)["d"]]
    _total_order(ordered, TABLE, spec)


def _run_stages(package_scheduler, plan):
    stages, manager = package_scheduler.split_stages(plan)
    out = list(package_scheduler.run_stages(stages, manager))
    return out, stages


@pytest.mark.parametrize("label,spec", KEYS, ids=[k for k, _ in KEYS])
def test_range_through_run_stages_equals_the_reference(label, spec):
    tscan, jscan = _scans()
    tf, jf = _fields(spec)
    tpart, jpart = RangePartitioning(tf, N_OUT), JRange(jf, N_OUT)
    tbatches, _ = _run_stages(S, SortExec(NativeShuffleExchangeExec(tscan, tpart), tf))
    jbatches, _ = _run_stages(JS, JSort(JExchange(jscan, jpart), jf))
    assert len(tpart.boundaries) == len(jpart.boundaries)
    for t, j in zip(tpart.boundaries, jpart.boundaries):
        assert t.dtype == np.int64 and np.array_equal(t, np.asarray(j, np.uint64).view(np.int64))
    assert [TB.batch_to_pydict(b) for b in tbatches] == [JB.batch_to_pydict(b) for b in jbatches]
    _total_order([d for b in tbatches for d in TB.batch_to_pydict(b)["d"]], TABLE, spec)
    assert not len(RESOURCES)


def test_an_empty_input_on_both_paths():
    empty = {k: (v[0][:0],) + tuple(None if x is None else x[:0] for x in v[1:]) for k, v in TABLE.items()}
    tscan, jscan = _scans(empty)
    tf, jf = _fields(KEYS[0][1])
    tex = NativeShuffleExchangeExec(tscan, RangePartitioning(tf, N_OUT))
    assert [list(tex.execute(p, TaskContext(p, N_OUT))) for p in range(N_OUT)] == [[]] * N_OUT
    tpart, jpart = RangePartitioning(tf, N_OUT), JRange(jf, N_OUT)
    tbatches, _ = _run_stages(S, SortExec(NativeShuffleExchangeExec(tscan, tpart), tf))
    jbatches, _ = _run_stages(JS, JSort(JExchange(jscan, jpart), jf))
    assert tbatches == [] and jbatches == []
    assert [b.tolist() for b in tpart.boundaries] == [np.asarray(b, np.uint64).view(np.int64).tolist()
                                                      for b in jpart.boundaries]


def test_a_sample_smaller_than_the_stage_keeps_the_order(monkeypatch):
    """The boundary pass over more rows than its cap (128): a task's
    stream dropped at its quota, the pool re-strided; the boundaries
    equal the reference's under the same cap."""
    monkeypatch.setattr(S, "compute_range_boundaries", functools.partial(S.compute_range_boundaries, max_rows=128))
    monkeypatch.setattr(JS, "_compute_range_boundaries",
                        functools.partial(JS._compute_range_boundaries, max_rows=128))
    spec = KEYS[0][1]
    tscan, jscan = _scans()
    tf, jf = _fields(spec)
    tpart, jpart = RangePartitioning(tf, N_OUT), JRange(jf, N_OUT)
    tbatches, _ = _run_stages(S, SortExec(NativeShuffleExchangeExec(tscan, tpart), tf))
    jbatches, _ = _run_stages(JS, JSort(JExchange(jscan, jpart), jf))
    for t, j in zip(tpart.boundaries, jpart.boundaries):
        assert np.array_equal(t, np.asarray(j, np.uint64).view(np.int64))
    assert [TB.batch_to_pydict(b) for b in tbatches] == [JB.batch_to_pydict(b) for b in jbatches]
    _total_order([d for b in tbatches for d in TB.batch_to_pydict(b)["d"]], TABLE, spec)


def _width_batch(package, strings, width):
    """One string(16) column whose physical width is ``width``."""
    n = len(strings)
    data = np.zeros((n, width), np.uint8)
    for i, t in enumerate(strings):
        data[i, :len(t)] = np.frombuffer(t.encode(), np.uint8)
    lengths = np.array([len(t) for t in strings], np.int32)
    if package is TB:
        import torch

        c = TB.Column(TT.string(16), torch.from_numpy(data), torch.ones(n, dtype=torch.bool),
                      torch.from_numpy(lengths))
        return TB.RecordBatch(TSchema([TF("s", TT.string(16))]), [c], n)
    c = JB.Column(JT.string(16), data, np.ones(n, bool), lengths)
    return JB.RecordBatch(JSchema([JF("s", JT.string(16))]), [c], n)


@pytest.mark.parametrize("ascending", [True, False])
def test_string_keys_of_mixed_physical_widths(ascending):
    cases = [(["apple", "zebra", "mango"], ["banana", "cherry", "apricots"]),
             (["applepie", "zebra", "aaa"], ["applepieX", "applepie", "mango"])]
    for short, wide in cases:
        tb = [[_width_batch(TB, short, 8)], [_width_batch(TB, wide, 16)]]
        jb = [[_width_batch(JB, short, 8)], [_width_batch(JB, wide, 16)]]
        tf, jf = [SortField(col("s"), ascending)], [JSortField(jcol("s"), ascending)]
        tex = NativeShuffleExchangeExec(MemoryScanExec(tb, tb[0][0].schema, device="cpu"), RangePartitioning(tf, 2))
        jex = JExchange(JScan(jb, jb[0][0].schema), JRange(jf, 2))
        tparts = [[s for b in tex.execute(p, TaskContext(p, 2)) for s in TB.batch_to_pydict(b)["s"]]
                  for p in range(2)]
        jparts = [[s for b in jex.execute(p, JCtx(p, 2)) for s in JB.batch_to_pydict(b)["s"]] for p in range(2)]
        assert tparts == jparts
        got = [s for p in range(2) for b in SortExec(tex, tf).execute(p, TaskContext(p, 2))
               for s in TB.batch_to_pydict(b)["s"]]
        assert got == sorted(short + wide, reverse=not ascending)


def _task_defs(scheduler, proto, resources, plan, boundaries=None):
    """Every task's TaskDefinition bytes, the range partitioning given
    ``boundaries``; what serializing staged is discarded."""
    stages, manager = scheduler.split_stages(plan)
    if boundaries is not None:
        part = stages[0].partitioning if scheduler is S else stages[0]._partitioning
        part.boundaries = boundaries
    staged = []
    token = proto.STAGED_RIDS.set(staged)
    try:
        tds = [scheduler.build_task(s, manager, t)[1] for s in stages for t in range(s.n_tasks)]
    finally:
        proto.STAGED_RIDS.reset(token)
        for rid in staged:
            resources.discard(rid)
        shutil.rmtree(manager.root, ignore_errors=True)
    return tds


@pytest.mark.parametrize("kind", ["range", "round robin"])
def test_task_definitions_equal_the_reference(kind):
    tscan, jscan = _scans()
    if kind == "range":
        tf, jf = _fields(KEYS[0][1])
        words = (np.array([1, 1, 0], np.uint64), np.array([2**63 + 3, 5, 2**64 - 1], np.uint64),
                 np.array([0, 2**64 - 7, 9], np.uint64), np.array([1, 0, 1], np.uint64),
                 np.array([7, 2**62, 2**63], np.uint64), np.array([0, 0, 2**64 - 1], np.uint64))
        tplan = SortExec(NativeShuffleExchangeExec(tscan, RangePartitioning(tf, N_OUT)), tf)
        jplan = JSort(JExchange(jscan, JRange(jf, N_OUT)), jf)
        tds = _task_defs(S, to_proto, RESOURCES, tplan, tuple(w.view(np.int64) for w in words))
        jtds = _task_defs(JS, jax_to_proto, JAX_RESOURCES, jplan, words)
    else:
        tds = _task_defs(S, to_proto, RESOURCES, NativeShuffleExchangeExec(tscan, RoundRobinPartitioning(N_OUT)))
        jtds = _task_defs(JS, jax_to_proto, JAX_RESOURCES, JExchange(jscan, JRR(N_OUT)))
    assert normalized(tds) == normalized(jtds)
    assert not len(RESOURCES)
    # the map task's partitioning decodes to the same words and encodes again
    td = wire.TaskDefinition.decode(jtds[0])
    assert td.encode() == jtds[0]
    part = from_proto._partitioning_from_proto(td.plan.shuffle_writer.partitioning)
    again = to_proto._partitioning_to_proto(part)
    assert again.encode() == td.plan.shuffle_writer.partitioning.encode()
    if kind == "range":
        assert [b.tolist() for b in part.boundaries] == [w.view(np.int64).tolist() for w in words]
    else:
        assert isinstance(part, RoundRobinPartitioning) and part.num_partitions == N_OUT


def test_a_range_writer_without_boundaries_raises(tmp_path):
    tscan, _ = _scans()
    mgr = LocalShuffleManager(str(tmp_path))
    writer = mgr.map_writer(tscan, RangePartitioning(_fields(KEYS[1][1])[0], N_OUT), 0, 0)
    with pytest.raises(NotImplementedError, match="boundaries"):
        writer.execute(0, TaskContext(0, N_MAPS))
    with pytest.raises(NotImplementedError, match="boundaries"):
        to_proto._partitioning_to_proto(writer.partitioning)


def test_round_robin_in_process_equals_the_reference():
    tscan, jscan = _scans()
    tex = NativeShuffleExchangeExec(tscan, RoundRobinPartitioning(N_OUT))
    jex = JExchange(jscan, JRR(N_OUT))
    tparts = [_rows(tex.execute(p, TaskContext(p, N_OUT)), TB.batch_to_pydict) for p in range(N_OUT)]
    jparts = [_rows(jex.execute(p, JCtx(p, N_OUT)), JB.batch_to_pydict) for p in range(N_OUT)]
    assert tparts == jparts
    # map task m's row i goes to (i + m) % N_OUT
    for p, part in enumerate(tparts):
        for d in part["d"]:
            m = d * N_MAPS // N
            assert (d - m * N // N_MAPS + m) % N_OUT == p


def _chain(scan, filter_col, project_col, package):
    c, l = (col, lit) if package == "port" else (jcol, jlit)
    F, P = (FilterExec, ProjectExec) if package == "port" else (JFilter, JProject)
    f = F(scan, c("k") > l(-15))
    return P(f, [c("k"), c("s"), c("m"), c("d"), (c("d") * l(2)).alias("d2")], ["k", "s", "m", "d", "d2"])


def _write(root, package, partitioning, fuse):
    """Every map output of the chained writer as bytes, and each reduce
    partition's rows read back by the package's reader."""
    tscan, jscan = _scans()
    scan = tscan if package == "port" else jscan
    child = _chain(scan, "k", "d", package)
    mgr = LocalShuffleManager(root) if package == "port" else JManager(root)
    writer_cls = None if package == "port" else JWriter
    blobs = []
    for m in range(N_MAPS):
        if package == "port":
            writer = mgr.map_writer(child, partitioning, 0, m)
        else:
            writer = writer_cls(child, partitioning, *mgr.map_output_paths(0, m))
        if fuse:
            if package == "port":
                optimize_plan(writer)
                assert writer.fused
        for _ in writer.execute(m, (TaskContext if package == "port" else JCtx)(m, N_MAPS)):
            pass
        for path in mgr.map_output_paths(0, m):
            with open(path, "rb") as f:
                blobs.append(f.read())
    parts = []
    for p in range(N_OUT):
        if package == "port":
            RESOURCES.put(f"shuffle_0.{p}", mgr.reduce_blocks(0, N_MAPS, p))
            reader = IpcReaderExec(writer.schema, "shuffle_0", N_OUT, "cpu")
            parts.append(_rows(reader.execute(p, TaskContext(p, N_OUT)), TB.batch_to_pydict))
        else:
            JAX_RESOURCES.put(f"shuffle_0.{p}", mgr.reduce_blocks(0, N_MAPS, p))
            reader = JReader(writer.schema, "shuffle_0", N_OUT)
            parts.append(_rows(reader.execute(p, JCtx(p, N_OUT)), JB.batch_to_pydict))
    shutil.rmtree(root, ignore_errors=True)
    return blobs, parts


def _range_words():
    """Boundaries for KEYS[0] at the exact order statistics of the
    chain's rows, in both packages' forms."""
    tscan, _ = _scans()
    child = _chain(tscan, "k", "d", "port")
    tf, _ = _fields(KEYS[0][1])
    batches = [b for m in range(N_MAPS) for b in child.execute(m, TaskContext(m, N_MAPS))]
    words = [range_key_words(child.schema, tf, [c.head(b.num_rows) for c in b.columns], b.num_rows)
             for b in batches]
    import torch

    cat = [torch.cat([w[i] for w in words]) for i in range(len(words[0]))]
    total = cat[0].shape[0]
    at = words_order(cat)[[total * (i + 1) // N_OUT for i in range(N_OUT - 1)]]
    return tuple(w[at].numpy() for w in cat)


@pytest.mark.parametrize("kind", ["range", "round robin"])
def test_fused_and_unfused_writes_commit_the_same_bytes(tmp_path, kind):
    saved = conf.SHUFFLE_ASYNC_WRITE.get()
    try:
        if kind == "range":
            bounds = _range_words()
            tf, jf = _fields(KEYS[0][1])
            tpart = RangePartitioning(tf, N_OUT, boundaries=bounds)
            jpart = JRange(jf, N_OUT, boundaries=tuple(b.view(np.uint64) for b in bounds))
        else:
            tpart, jpart = RoundRobinPartitioning(N_OUT), JRR(N_OUT)
        blobs_u, parts_u = _write(str(tmp_path / "u"), "port", tpart, fuse=False)
        blobs_f, parts_f = _write(str(tmp_path / "f"), "port", tpart, fuse=True)
        conf.SHUFFLE_ASYNC_WRITE.set(not saved)
        blobs_a, _ = _write(str(tmp_path / "a"), "port", tpart, fuse=True)
        _, jparts = _write(str(tmp_path / "j"), "jax", jpart, fuse=False)
    finally:
        conf.SHUFFLE_ASYNC_WRITE.set(saved)
    assert blobs_f == blobs_u == blobs_a
    assert parts_f == parts_u == jparts
    assert not len(RESOURCES)


def test_a_range_key_no_parent_reads_survives_pruning():
    """The optimizer keeps a range exchange's key columns though no
    operator above reads them; the reference's pruner drops them and
    the exchange cannot compute its pids (ROADMAP queue C, defect 18)."""
    from blaze_tpu.ops import ProjectExec as JProj
    from blaze_tpu.ops.pruning import prune_columns as jax_prune

    tscan, jscan = _scans()
    tf, jf = _fields(KEYS[1][1])
    plain = ProjectExec(NativeShuffleExchangeExec(tscan, RangePartitioning(tf, N_OUT)), [col("d")])
    want = [_rows(plain.execute(p, TaskContext(p, N_OUT)), TB.batch_to_pydict) for p in range(N_OUT)]
    plan = optimize_plan(ProjectExec(NativeShuffleExchangeExec(tscan, RangePartitioning(tf, N_OUT)), [col("d")]))
    assert [_rows(plan.execute(p, TaskContext(p, N_OUT)), TB.batch_to_pydict) for p in range(N_OUT)] == want
    # partition p holds the rows of the p-th range of k, descending
    ks = [{TABLE["k"][0][d] if TABLE["k"][2][d] else None for d in part["d"]} for part in want]
    assert all(min(v for v in a if v is not None) >= max(v for v in b if v is not None)
               for a, b in zip(ks, ks[1:]) if a - {None} and b - {None})
    ref = jax_prune(JProj(JExchange(jscan, JRange(jf, N_OUT)), [jcol("d")]))
    with pytest.raises(KeyError, match="k"):
        list(ref.execute(0, JCtx(0, N_OUT)))
