"""Every join type of the port's ``Joiner`` against the JAX package and
a Python oracle.

INNER, LEFT, RIGHT, FULL, LEFT_SEMI, LEFT_ANTI, RIGHT_SEMI, RIGHT_ANTI
and EXISTENCE, broadcast and shuffled, on one and on two keys, over one
seeded table pair with duplicate, null and absent keys (a null key
never matches); the outer joins also with the build side on the left
(an empty build side: ``test_torch_cast_functions.py``).
A broadcast join that outputs build rows (``build_preserved``) runs
over one probe partition, where it equals the reference; over two the
port raises, and the reference's wrong rows there are pinned (ROADMAP
queue C, reference defect 8).  Rows compare as multisets, exactly.
"""

import numpy as np
import pytest

from blaze_tpu.batch import batch_to_pydict as jax_to_pydict
from blaze_tpu.exprs import col as jcol
from blaze_tpu.ops import MemoryScanExec as JaxScan
from blaze_tpu.ops.joins import JoinType as JJoinType
from blaze_tpu.runtime.context import TaskContext as JaxContext
from blaze_tpu.schema import DataType as JT, Field as JF, Schema as JSchema
from blaze_tpu.tpch import queries as JQ
from blaze_tpu.tpch.datagen import table_to_batches as jax_table_to_batches

from blaze_tpu_torch.batch import batch_to_pydict, table_to_batches
from blaze_tpu_torch.exprs import col
from blaze_tpu_torch.ops import MemoryScanExec
from blaze_tpu_torch.ops.joins import JoinType
from blaze_tpu_torch.runtime.context import TaskContext
from blaze_tpu_torch.schema import DataType as TT, Field as TF, Schema as TSchema
from blaze_tpu_torch.tpch import queries as Q

N_PARTS = 2
ALL_TYPES = [t.name for t in JoinType]
BUILD_SEMI = ("RIGHT_SEMI", "RIGHT_ANTI")

_LEFT = [("lk", TT.int64(), JT.int64()), ("lk2", TT.int32(), JT.int32()), ("lv", TT.int64(), JT.int64())]
_RIGHT = [("rk", TT.int64(), JT.int64()), ("rk2", TT.int32(), JT.int32()), ("rv", TT.int32(), JT.int32())]
KEYS = {"one-key": (["lk"], ["rk"]), "two-keys": (["lk", "lk2"], ["rk", "rk2"])}


def tables(seed, n_left=240, n_right=90):
    """Left keys in [0, 40), right keys in [10, 60) with duplicates;
    nulls in both key columns and in the left value."""
    rng = np.random.default_rng(seed)
    left = {"lk": (rng.integers(0, 40, n_left), None, rng.random(n_left) > 0.1),
            "lk2": (rng.integers(0, 3, n_left).astype(np.int32), None, None),
            "lv": (rng.integers(-(10**9), 10**9, n_left), None, rng.random(n_left) > 0.2)}
    right = {"rk": (rng.integers(10, 60, n_right), None, rng.random(n_right) > 0.1),
             "rk2": (rng.integers(0, 3, n_right).astype(np.int32), None, None),
             "rv": (rng.integers(0, 100, n_right).astype(np.int32), None, None)}
    return left, right


def scans(table, fields, parts):
    ts = TSchema([TF(n, t) for n, t, _ in fields])
    js = JSchema([JF(n, j) for n, _, j in fields])
    return (MemoryScanExec(table_to_batches(table, ts, parts, 64, device="cpu"), ts, device="cpu"),
            JaxScan(jax_table_to_batches(table, js, parts, batch_rows=64), js))


def build_preserved(kind: str, build_left: bool) -> bool:
    outer = "FULL" if kind == "FULL" else ("LEFT" if build_left else "RIGHT")
    return kind == outer or kind in BUILD_SEMI


def plan(mod, left, right, keys, kind, shuffled, build_left):
    c = col if mod is Q else jcol
    jt = (JoinType if mod is Q else JJoinType)[kind]
    lkeys, rkeys = [c(k) for k in keys[0]], [c(k) for k in keys[1]]
    if shuffled:
        return mod.shuffle_join(left, right, lkeys, rkeys, jt, N_PARTS, build_left=build_left)
    if build_left:
        return mod.broadcast_join(left, right, lkeys, rkeys, jt, build_is_left=True)
    return mod.broadcast_join(right, left, rkeys, lkeys, jt, build_is_left=False)


def run(p, to_pydict, context):
    out = {f.name: [] for f in p.schema.fields}
    for i in range(p.num_partitions()):
        for b in p.execute(i, context(i, p.num_partitions())):
            for k, v in to_pydict(b).items():
                out[k].extend(v)
    return out


def rows_of(out):
    return sorted(zip(*out.values()), key=repr)


def python_join(left, right, keys, kind, build_left):
    """The join's rows from Python lists: a null key never matches;
    SEMI/ANTI/EXISTENCE keep the probe's rows and RIGHT_SEMI/RIGHT_ANTI
    the build's, as the reference defines them."""
    def rows(t, names):
        n = len(t[names[0]][0])
        return [tuple(None if t[c][2] is not None and not t[c][2][i] else int(t[c][0][i]) for c in names)
                for i in range(n)]

    lrows, rrows = rows(left, [f[0] for f in _LEFT]), rows(right, [f[0] for f in _RIGHT])
    lkey = lambda r: tuple(r[[f[0] for f in _LEFT].index(k)] for k in keys[0])
    rkey = lambda r: tuple(r[[f[0] for f in _RIGHT].index(k)] for k in keys[1])
    pairs = [(i, j) for i, lr in enumerate(lrows) for j, rr in enumerate(rrows)
             if None not in lkey(lr) and lkey(lr) == rkey(rr)]
    lm, rm = {i for i, _ in pairs}, {j for _, j in pairs}
    probe, pm, build, bm = (rrows, rm, lrows, lm) if build_left else (lrows, lm, rrows, rm)
    nl, nr = (None,) * len(_LEFT), (None,) * len(_RIGHT)
    if kind == "LEFT_SEMI":
        return [r for i, r in enumerate(probe) if i in pm]
    if kind == "LEFT_ANTI":
        return [r for i, r in enumerate(probe) if i not in pm]
    if kind == "RIGHT_SEMI":
        return [r for i, r in enumerate(build) if i in bm]
    if kind == "RIGHT_ANTI":
        return [r for i, r in enumerate(build) if i not in bm]
    if kind == "EXISTENCE":
        return [r + (i in pm,) for i, r in enumerate(probe)]
    out = [lrows[i] + rrows[j] for i, j in pairs]
    if kind in ("LEFT", "FULL"):
        out += [r + nr for i, r in enumerate(lrows) if i not in lm]
    if kind in ("RIGHT", "FULL"):
        out += [nl + r for j, r in enumerate(rrows) if j not in rm]
    return out


def check(kind, shuffled, keys, build_left, seed):
    left, right = tables(seed)
    # a broadcast join that outputs build rows needs its probe in one partition
    probe_parts = 1 if not shuffled and build_preserved(kind, build_left) else N_PARTS
    lparts = probe_parts if not build_left else N_PARTS
    rparts = probe_parts if build_left else N_PARTS
    tl, jl = scans(left, _LEFT, lparts)
    tr, jr = scans(right, _RIGHT, rparts)
    got = run(plan(Q, tl, tr, keys, kind, shuffled, build_left), batch_to_pydict, TaskContext)
    want = run(plan(JQ, jl, jr, keys, kind, shuffled, build_left), jax_to_pydict, JaxContext)
    assert list(got) == list(want)
    assert rows_of(got) == rows_of(want)
    expect = sorted(python_join(left, right, keys, kind, build_left), key=repr)
    assert rows_of(got) == expect
    return got


@pytest.mark.parametrize("keys", list(KEYS), ids=list(KEYS))
@pytest.mark.parametrize("shuffled", [False, True], ids=["broadcast", "shuffled"])
@pytest.mark.parametrize("kind", ALL_TYPES)
def test_join_type_matches_reference_and_python(kind, shuffled, keys):
    got = check(kind, shuffled, KEYS[keys], build_left=False, seed=80)
    n = len(next(iter(got.values())))
    assert n > 0
    # an outer join's unmatched rows come back with the other side null
    if kind in ("LEFT", "FULL"):
        assert None in got["rk"]
    if kind in ("RIGHT", "FULL"):
        assert None in got["lk"]


@pytest.mark.parametrize("shuffled", [False, True], ids=["broadcast", "shuffled"])
@pytest.mark.parametrize("kind", ["LEFT", "RIGHT", "FULL"])
def test_outer_join_with_the_build_on_the_left(kind, shuffled):
    got = check(kind, shuffled, KEYS["one-key"], build_left=True, seed=81)
    assert None in (got["rk"] if kind == "LEFT" else got["lk"] if kind == "RIGHT" else got["lk"] + got["rk"])


@pytest.mark.parametrize("build_left", [False, True], ids=["build-right", "build-left"])
@pytest.mark.parametrize("kind", ALL_TYPES)
def test_build_preserved_broadcast_over_two_probe_partitions_raises(kind, build_left):
    """A broadcast join that outputs build rows over more than one
    probe partition raises at construction, naming the join type; the
    others build."""
    left, right = tables(82)
    tl, _ = scans(left, _LEFT, N_PARTS)
    tr, _ = scans(right, _RIGHT, N_PARTS)
    if build_preserved(kind, build_left):
        with pytest.raises(NotImplementedError, match=kind):
            plan(Q, tl, tr, KEYS["one-key"], kind, False, build_left)
    else:
        plan(Q, tl, tr, KEYS["one-key"], kind, False, build_left)


def test_reference_broadcast_keeps_the_last_probe_partitions_view():
    """Reference defect 8: the reference's BroadcastJoinExec emits the
    build side at the last probe partition's finish from that
    partition's matches alone.  Probe keys [1, 2] over two partitions,
    build keys [1, 3], build on the right: FULL gives (None, 1) beside
    (1, 1), RIGHT_SEMI nothing and RIGHT_ANTI [1, 3]; Spark (and the
    port's shuffled join) give no (None, 1), [1] and [3]."""
    probe = {"lk": (np.array([1, 2]), None, None), "lk2": (np.zeros(2, np.int32), None, None),
             "lv": (np.array([10, 20]), None, None)}
    build = {"rk": (np.array([1, 3]), None, None), "rk2": (np.zeros(2, np.int32), None, None),
             "rv": (np.array([7, 8], np.int32), None, None)}
    key = lambda out, names: sorted(zip(*(out[n] for n in names)), key=repr)
    for kind, ref_rows, right_rows in (
            ("FULL", [(1, 1), (2, None), (None, 1), (None, 3)], [(1, 1), (2, None), (None, 3)]),
            ("RIGHT_SEMI", [], [(1,)]),
            ("RIGHT_ANTI", [(1,), (3,)], [(3,)])):
        names = ["lk", "rk"] if kind == "FULL" else ["rk"]
        _, jl = scans(probe, _LEFT, 2)
        _, jr = scans(build, _RIGHT, 1)
        ref = run(plan(JQ, jl, jr, KEYS["one-key"], kind, False, False), jax_to_pydict, JaxContext)
        assert key(ref, names) == sorted(ref_rows, key=repr)
        tl, _ = scans(probe, _LEFT, 2)
        tr, _ = scans(build, _RIGHT, 1)
        got = run(plan(Q, tl, tr, KEYS["one-key"], kind, True, False), batch_to_pydict, TaskContext)
        assert key(got, names) == sorted(right_rows, key=repr)
        with pytest.raises(NotImplementedError, match=kind):
            plan(Q, tl, tr, KEYS["one-key"], kind, False, False)
