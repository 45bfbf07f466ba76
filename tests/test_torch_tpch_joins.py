"""The port's semi and anti joins, and the TPC-H queries they carry,
against the JAX package and the numpy oracles (the other join types:
``test_torch_outer_joins.py``); then the slice's queries through the
port's stage scheduler.

- LEFT_SEMI and LEFT_ANTI, broadcast and shuffled, on one seeded table
  pair with duplicate, null and absent keys (a null key never matches:
  SEMI drops it, ANTI keeps it), and with an empty build side.
- q04 (a shuffled LEFT_SEMI join, lineitem building), q05 (a two-key
  broadcast join) and q10 (a 7-key group with strings, ``fetch=20``)
  at SF 0.002 with two partitions, in process, equal to the reference's
  rows and to the port's oracle copies (which equal the reference's).
- TPC-H at SF 0.002 (q19 at SF 0.01, where rows pass its filter) and
  TPC-DS q03 at SF 0.01, two partitions, through ``split_stages`` /
  ``run_stages``: every task from TaskDefinition bytes, hash exchanges
  through ``.data``/``.index`` files.  Every task's bytes (CASE, IN,
  LIKE and the semi join among them) decode and re-encode byte for byte
  in the port's codec and in the reference's generated ``plan_pb2``;
  each query equals its oracle and its in-process rows, and
  ``RESOURCES`` is empty after it.  The reference's own ``run_stages``
  scales decoded decimal literals twice (ROADMAP queue C, reference
  defect 2): pinned here for q05 and q10, whose revenue reads 100x;
  TPC-DS q03 has no decimal literal and is right there.  These share a
  module with q04, q05 and q10 in process so that one worker compiles
  the reference's plans of q05 and q10 once.
"""

import os
import shutil

import numpy as np
import pytest

from blaze_tpu.batch import batch_to_pydict as jax_to_pydict
from blaze_tpu.exprs import col as jcol
from blaze_tpu.ops import MemoryScanExec as JaxScan
from blaze_tpu.ops.joins import JoinType as JJoinType
from blaze_tpu.runtime import scheduler as JS
from blaze_tpu.runtime.context import RESOURCES as JAX_RESOURCES
from blaze_tpu.runtime.context import TaskContext as JaxContext
from blaze_tpu.schema import DataType as JT, Field as JF, Schema as JSchema
from blaze_tpu.serde import plan_pb2
from blaze_tpu.tpcds import TPCDS_SCHEMAS as JAX_DS_SCHEMAS
from blaze_tpu.tpcds import build_query as jax_ds_query
from blaze_tpu.tpcds import generate_all as jax_ds_generate_all
from blaze_tpu.tpch import TPCH_SCHEMAS as JAX_SCHEMAS
from blaze_tpu.tpch import build_query as jax_build_query
from blaze_tpu.tpch import oracle as jax_oracle
from blaze_tpu.tpch import queries as JQ
from blaze_tpu.tpch.datagen import generate_all as jax_generate_all
from blaze_tpu.tpch.datagen import table_to_batches as jax_table_to_batches

import blaze_tpu_torch
import blaze_tpu_torch.batch as TB
from blaze_tpu_torch import tpcds
from blaze_tpu_torch.batch import batch_to_pydict, table_to_batches
from blaze_tpu_torch.exprs import col
from blaze_tpu_torch.kernels import cuda_ops
from blaze_tpu_torch.ops import MemoryScanExec
from blaze_tpu_torch.ops.joins import JoinType
from blaze_tpu_torch.runtime import scheduler as S
from blaze_tpu_torch.runtime.context import RESOURCES, TaskContext
from blaze_tpu_torch.schema import DataType as TT, Field as TF, Schema as TSchema
from blaze_tpu_torch.serde import from_proto, wire
from blaze_tpu_torch.tpcds import oracle as DO
from blaze_tpu_torch.tpch import TPCH_SCHEMAS, build_query
from blaze_tpu_torch.tpch import oracle as O
from blaze_tpu_torch.tpch import queries as Q
from blaze_tpu_torch.tpch.datagen import generate_all

SCALE = 0.002
N_PARTS = 2


def _run(plan, to_pydict, context):
    out = {f.name: [] for f in plan.schema.fields}
    for p in range(plan.num_partitions()):
        for b in plan.execute(p, context(p, plan.num_partitions())):
            for k, v in to_pydict(b).items():
                out[k].extend(v)
    return out


def _sorted_rows(out):
    return sorted(zip(*out.values()), key=repr)


# ------------------------------------------------------ semi and anti joins


def _join_tables(rng, n_probe=900, n_build=300):
    """Probe keys in [0, 40), build keys in [10, 60) with duplicates;
    nulls on both sides."""
    probe = {"pk": (rng.integers(0, 40, n_probe), None, rng.random(n_probe) > 0.1),
             "pk2": (rng.integers(0, 3, n_probe).astype(np.int32), None, None),
             "pv": (rng.integers(-(10**9), 10**9, n_probe), None, rng.random(n_probe) > 0.2)}
    build = {"bk": (rng.integers(10, 60, n_build), None, rng.random(n_build) > 0.1),
             "bk2": (rng.integers(0, 3, n_build).astype(np.int32), None, None),
             "bv": (rng.integers(0, 100, n_build).astype(np.int32), None, None)}
    return probe, build


_PROBE = [("pk", TT.int64(), JT.int64()), ("pk2", TT.int32(), JT.int32()), ("pv", TT.int64(), JT.int64())]
_BUILD = [("bk", TT.int64(), JT.int64()), ("bk2", TT.int32(), JT.int32()), ("bv", TT.int32(), JT.int32())]


def _scan_pair(table, fields, parts=N_PARTS, batch_rows=128):
    ts = TSchema([TF(n, t) for n, t, _ in fields])
    js = JSchema([JF(n, j) for n, _, j in fields])
    return (MemoryScanExec(table_to_batches(table, ts, parts, batch_rows, device="cpu"), ts, device="cpu"),
            JaxScan(jax_table_to_batches(table, js, parts, batch_rows=batch_rows), js))


def _semi_plan(mod, probe, build, keys, jt, shuffled):
    c = col if mod is Q else jcol
    pkeys, bkeys = [c(k) for k in keys[0]], [c(k) for k in keys[1]]
    if shuffled:
        return mod.shuffle_join(probe, build, pkeys, bkeys, jt, N_PARTS, build_left=False)
    return mod.broadcast_join(build, probe, bkeys, pkeys, jt, build_is_left=False)


@pytest.mark.parametrize("shuffled", [False, True], ids=["broadcast", "shuffled"])
@pytest.mark.parametrize("kind", ["LEFT_SEMI", "LEFT_ANTI"])
@pytest.mark.parametrize("keys", [(["pk"], ["bk"]), (["pk", "pk2"], ["bk", "bk2"])], ids=["one-key", "two-keys"])
def test_semi_and_anti_joins_match_reference_and_python(kind, shuffled, keys):
    probe, build = _join_tables(np.random.default_rng(70))
    tp, jp = _scan_pair(probe, _PROBE)
    tb, jb = _scan_pair(build, _BUILD)
    got = _run(_semi_plan(Q, tp, tb, keys, JoinType[kind], shuffled), batch_to_pydict, TaskContext)
    want = _run(_semi_plan(JQ, jp, jb, keys, JJoinType[kind], shuffled), jax_to_pydict, JaxContext)
    assert list(got) == ["pk", "pk2", "pv"]
    assert _sorted_rows(got) == _sorted_rows(want)

    def key_of(t, names, i):
        vals = [t[n] for n in names]
        return None if not all(v[2] is None or v[2][i] for v in vals) else tuple(int(v[0][i]) for v in vals)

    build_keys = {key_of(build, keys[1], i) for i in range(len(build["bk"][0]))} - {None}
    expect = []
    for i in range(len(probe["pk"][0])):
        k = key_of(probe, keys[0], i)
        if (k is not None and k in build_keys) == (kind == "LEFT_SEMI"):
            expect.append((int(probe["pk"][0][i]) if probe["pk"][2][i] else None, int(probe["pk2"][0][i]),
                           int(probe["pv"][0][i]) if probe["pv"][2][i] else None))
    assert _sorted_rows(got) == sorted(expect, key=repr)
    # nulls never match: SEMI drops every null key, ANTI keeps them all
    n_null = int((~probe["pk"][2]).sum())
    assert got["pk"].count(None) == (0 if kind == "LEFT_SEMI" else n_null) and n_null
    assert 0 < len(got["pk"]) < len(probe["pk"][0])


@pytest.mark.parametrize("shuffled", [False, True], ids=["broadcast", "shuffled"])
@pytest.mark.parametrize("kind", ["LEFT_SEMI", "LEFT_ANTI"])
def test_semi_and_anti_joins_with_an_empty_build_side(kind, shuffled):
    """No build rows: SEMI outputs nothing, ANTI every probe row."""
    probe, build = _join_tables(np.random.default_rng(71))
    build = {k: (v[0][:0], None, None) for k, v in build.items()}
    tp, jp = _scan_pair(probe, _PROBE)
    tb, jb = _scan_pair(build, _BUILD)
    keys = (["pk"], ["bk"])
    got = _run(_semi_plan(Q, tp, tb, keys, JoinType[kind], shuffled), batch_to_pydict, TaskContext)
    want = _run(_semi_plan(JQ, jp, jb, keys, JJoinType[kind], shuffled), jax_to_pydict, JaxContext)
    assert _sorted_rows(got) == _sorted_rows(want)
    assert len(got["pk"]) == (0 if kind == "LEFT_SEMI" else len(probe["pk"][0]))


def test_other_join_types_raise():
    """Every join type runs since the outer joins were ported; what
    still raises is a broadcast join that outputs build rows (here the
    build is on the left) over more than one probe partition."""
    tp, _ = _scan_pair(*_join_tables(np.random.default_rng(72))[:1], _PROBE)
    for jt in (JoinType.LEFT, JoinType.FULL, JoinType.RIGHT_SEMI, JoinType.RIGHT_ANTI):
        with pytest.raises(NotImplementedError, match=jt.name):
            Q.broadcast_join(tp, tp, [col("pk")], [col("pk")], jt, build_is_left=True)
    for jt in (JoinType.INNER, JoinType.RIGHT, JoinType.LEFT_SEMI, JoinType.LEFT_ANTI, JoinType.EXISTENCE):
        Q.broadcast_join(tp, tp, [col("pk")], [col("pk")], jt, build_is_left=True)


# ----------------------------------------------------------- q04, q05, q10


@pytest.fixture(scope="module")
def data():
    return generate_all(SCALE)


@pytest.fixture(scope="module")
def jax_data():
    return jax_generate_all(SCALE)


def _scans(data):
    return {name: MemoryScanExec(table_to_batches(data[name], TPCH_SCHEMAS[name], N_PARTS, 4096, device="cpu"),
                                 TPCH_SCHEMAS[name], device="cpu") for name in TPCH_SCHEMAS}


def _jax_run(jax_data, q):
    scans = {name: JaxScan(jax_table_to_batches(jax_data[name], JAX_SCHEMAS[name], N_PARTS, batch_rows=4096),
                           JAX_SCHEMAS[name]) for name in JAX_SCHEMAS}
    return _run(jax_build_query(q, scans, N_PARTS), jax_to_pydict, JaxContext)


def _port_run(data, q):
    return _run(build_query(q, _scans(data), N_PARTS), batch_to_pydict, TaskContext)


def test_q4_equals_reference_and_oracle(data, jax_data):
    got = _port_run(data, "q4")
    assert got == _jax_run(jax_data, "q4")
    exp = O.oracle_q4(data)
    assert exp == jax_oracle.oracle_q4(jax_data)
    assert dict(zip(got["o_orderpriority"], got["order_count"])) == exp
    assert got["o_orderpriority"] == sorted(exp) and len(exp) == 5 and sum(exp.values()) > 50


def test_q5_equals_reference_and_oracle(data, jax_data):
    got = _port_run(data, "q5")
    assert got == _jax_run(jax_data, "q5")
    exp = O.oracle_q5(data)
    assert exp == jax_oracle.oracle_q5(jax_data)
    assert dict(zip(got["n_name"], got["revenue"])) == exp and len(exp) >= 2
    assert got["revenue"] == sorted(got["revenue"], reverse=True)


def test_q10_equals_reference_and_oracle(data, jax_data):
    got = _port_run(data, "q10")
    want = _jax_run(jax_data, "q10")
    exp = O.oracle_q10(data)
    assert exp == jax_oracle.oracle_q10(jax_data)
    rows = list(zip(got["c_custkey"], got["c_name"], got["c_acctbal"], got["n_name"], got["revenue"]))
    assert len(rows) == len(exp) == 20
    # ties on equal revenue may order differently
    assert _sorted_rows(got) == _sorted_rows(want)
    assert {(r[0], r[4]) for r in rows} == {(e[0], e[4]) for e in exp}
    assert [r[4] for r in rows] == sorted((r[4] for r in rows), reverse=True)
    by_key = {e[0]: e for e in exp}
    assert all(r == by_key[r[0]] for r in rows)


@pytest.mark.parametrize("q", ["q4", "q5", "q10"])
def test_query_reaches_the_kernel_wrappers(data, monkeypatch, q):
    """Every join probes through sorted_lookup, and every hash exchange
    counts through pid_histogram and (fixed-width keys) hashes through
    murmur3_pids; on the CPU they run their plain versions."""
    calls = dict.fromkeys(("murmur3_pids", "pid_histogram", "sorted_lookup"), 0)
    for name in calls:
        real = getattr(cuda_ops, name)
        monkeypatch.setattr(cuda_ops, name, lambda *a, _r=real, _n=name, **kw: (
            calls.__setitem__(_n, calls[_n] + 1), _r(*a, **kw))[1])
    cuda_ops.reset_launch_counts()
    _port_run(data, q)
    assert all(k > 0 for k in calls.values()), calls
    assert set(cuda_ops.LAUNCHES.values()) == {0}


# ------------------------------------------------- through the stage scheduler


DS_TABLES = ("date_dim", "store_sales", "item")


@pytest.fixture(autouse=True)
def on_cpu():
    prev = blaze_tpu_torch._default_device
    blaze_tpu_torch.set_default_device("cpu")
    yield
    blaze_tpu_torch.set_default_device(prev)


@pytest.fixture(scope="module")
def tpch():
    return {0.002: generate_all(0.002), 0.01: generate_all(0.01)}


@pytest.fixture(scope="module")
def ds():
    return tpcds.generate_all(0.01)


def _named_scans(data, schemas, names):
    return {n: MemoryScanExec(TB.table_to_batches(data[n], schemas[n], N_PARTS, 4096, "cpu"), schemas[n],
                              device="cpu") for n in names}


def _jax_scans(data, schemas, names):
    return {n: JaxScan(jax_table_to_batches(data[n], schemas[n], N_PARTS, batch_rows=4096), schemas[n])
            for n in names}


def _rows(batches, to_pydict):
    out = {}
    for b in batches:
        for k, v in to_pydict(b).items():
            out.setdefault(k, []).extend(v)
    return out


def run_port(plan_fn, monkeypatch):
    """(rows through run_stages, rows in process, the TaskDefinitions
    run); every TaskDefinition is checked byte for byte on the way."""
    seen = []
    real = from_proto.run_task

    def run_task(td, *a, **kw):
        seen.append(td)
        assert wire.TaskDefinition.decode(td).encode() == td
        assert plan_pb2.TaskDefinition.FromString(td).SerializeToString() == td
        return real(td, *a, **kw)

    monkeypatch.setattr(from_proto, "run_task", run_task)
    stages, manager = S.split_stages(plan_fn())
    rows = _rows(S.run_stages(stages, manager), TB.batch_to_pydict)
    assert len(RESOURCES) == 0 and not os.path.exists(manager.root)
    plan = plan_fn()
    n = plan.num_partitions()
    inproc = _rows([b for p in range(n) for b in plan.execute(p, TaskContext(p, n))], TB.batch_to_pydict)
    return rows, inproc, seen


def run_reference(plan):
    stages, manager = JS.split_stages(plan)
    before = set(JAX_RESOURCES._map)
    try:
        return _rows(JS.run_stages(stages, manager), jax_to_pydict)
    finally:
        for key in set(JAX_RESOURCES._map) - before:
            JAX_RESOURCES.discard(key)
        shutil.rmtree(manager.root, ignore_errors=True)


def _tpch(data, q):
    return lambda: build_query(q, _named_scans(data, TPCH_SCHEMAS, TPCH_SCHEMAS), N_PARTS)


def _kinds(tds, kind):
    return sum(f'{kind}' in str(wire.TaskDefinition.decode(td).plan) for td in tds)


def check(q, rows, data):
    """``rows`` against the oracle of TPC-H ``q``; not trivial."""
    exp = getattr(O, f"oracle_{q}")(data)
    if q == "q4":
        assert dict(zip(rows["o_orderpriority"], rows["order_count"])) == exp and len(exp) == 5
    elif q == "q5":
        assert dict(zip(rows["n_name"], rows["revenue"])) == exp and len(exp) >= 2
    elif q == "q10":
        assert {(r[0], r[4]) for r in exp} == set(zip(rows["c_custkey"], rows["revenue"])) and len(exp) == 20
    elif q == "q12":
        assert {m: [h, lo] for m, h, lo in zip(rows["l_shipmode"], rows["high_line_count"],
                                               rows["low_line_count"])} == exp and len(exp) == 2
    elif q == "q14":
        pct, sp, sr = exp
        assert rows["promo_revenue"] == [(2 * 10**8 * sp + sr) // (2 * sr)] and sp > 0
    else:
        assert rows["revenue"] == [exp] and exp > 0


@pytest.mark.parametrize("q,scale", [("q4", 0.002), ("q5", 0.002), ("q10", 0.002), ("q12", 0.002),
                                     ("q14", 0.002), ("q19", 0.01)])
def test_tpch_query_through_run_stages_equals_the_oracle(tpch, monkeypatch, q, scale):
    rows, inproc, tds = run_port(_tpch(tpch[scale], q), monkeypatch)
    assert rows == inproc
    check(q, rows, tpch[scale])
    expr_nodes = {"q4": (), "q5": (), "q10": (), "q12": ("InListExpr", "CaseExpr"),
                  "q14": ("LikeExpr", "CaseExpr"), "q19": ("InListExpr",)}[q]
    assert all(_kinds(tds, node) for node in expr_nodes)


@pytest.mark.parametrize("q", ["q5", "q10"])
def test_reference_scheduler_double_scales_q5_and_q10(tpch, q):
    """The reference's run_stages scales the decoded decimal ``1`` of
    ``1 - l_discount`` a second time, so q05's and q10's revenue reads
    100x the oracle (ROADMAP queue C, reference defect 2); the port's
    run_stages equals the oracle (the test above)."""
    data = tpch[0.002]
    ref = run_reference(jax_build_query(q, _jax_scans(jax_generate_all(0.002), JAX_SCHEMAS, JAX_SCHEMAS), N_PARTS))
    exp = O.oracle_q5(data) if q == "q5" else {r[0]: r[4] for r in O.oracle_q10(data)}
    keys = ref["n_name"] if q == "q5" else ref["c_custkey"]
    for k, rev in zip(keys, ref["revenue"]):
        if k in exp:
            assert rev > 50 * exp[k], (k, rev, exp[k])


def test_tpcds_q3_through_run_stages_equals_the_oracle_and_the_reference(ds, monkeypatch):
    plan_fn = lambda: tpcds.build_query("q3", _named_scans(ds, tpcds.TPCDS_SCHEMAS, DS_TABLES), N_PARTS)
    rows, inproc, tds = run_port(plan_fn, monkeypatch)
    assert rows == inproc
    exp = DO.oracle_q3(ds)
    got = list(zip(rows["d_year"], rows["brand_id"], rows["brand"], rows["sum_agg"]))
    assert len(got) == min(len(exp), 100) > 5 and all(exp[r[:3]] == r[3] for r in got)
    assert _kinds(tds, "BroadcastJoinNode")
    ref = run_reference(jax_ds_query("q3", _jax_scans(jax_ds_generate_all(0.01), JAX_DS_SCHEMAS, DS_TABLES), N_PARTS))
    assert ref == rows
