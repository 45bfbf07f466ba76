"""The port's semi and anti joins, and the TPC-H queries they carry,
against the JAX package and the numpy oracles (the other join types:
``test_torch_outer_joins.py``).

- LEFT_SEMI and LEFT_ANTI, broadcast and shuffled, on one seeded table
  pair with duplicate, null and absent keys (a null key never matches:
  SEMI drops it, ANTI keeps it), and with an empty build side.
- q04 (a shuffled LEFT_SEMI join, lineitem building), q05 (a two-key
  broadcast join) and q10 (a 7-key group with strings, ``fetch=20``)
  at SF 0.002 with two partitions, in process, equal to the reference's
  rows and to the port's oracle copies (which equal the reference's).
"""

import numpy as np
import pytest

from blaze_tpu.batch import batch_to_pydict as jax_to_pydict
from blaze_tpu.exprs import col as jcol
from blaze_tpu.ops import MemoryScanExec as JaxScan
from blaze_tpu.ops.joins import JoinType as JJoinType
from blaze_tpu.runtime.context import TaskContext as JaxContext
from blaze_tpu.schema import DataType as JT, Field as JF, Schema as JSchema
from blaze_tpu.tpch import TPCH_SCHEMAS as JAX_SCHEMAS
from blaze_tpu.tpch import build_query as jax_build_query
from blaze_tpu.tpch import oracle as jax_oracle
from blaze_tpu.tpch import queries as JQ
from blaze_tpu.tpch.datagen import generate_all as jax_generate_all
from blaze_tpu.tpch.datagen import table_to_batches as jax_table_to_batches

from blaze_tpu_torch.batch import batch_to_pydict, table_to_batches
from blaze_tpu_torch.exprs import col
from blaze_tpu_torch.kernels import cuda_ops
from blaze_tpu_torch.ops import MemoryScanExec
from blaze_tpu_torch.ops.joins import JoinType
from blaze_tpu_torch.runtime.context import TaskContext
from blaze_tpu_torch.schema import DataType as TT, Field as TF, Schema as TSchema
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
