"""The port's ``avg`` aggregate against the JAX package's.

One seeded batch goes through each package's ``AggExec`` PARTIAL, then
FINAL over the partial states, grouped and global.  The inputs cover
every finalize branch of avg: a narrow decimal whose rescaled sum fits
int64, a narrow one that needs int128, the wide two-limb sum q01 keeps
for decimal(12,2), a wide sum whose quotient overflows int64 (null),
and integer and float inputs (float64 division).  Values are negative
and positive, so HALF_UP rounds away from zero both ways; a group whose
values are all null, and a zero count, give null.  Decimal results
compare exactly.
"""

import numpy as np
import pytest

from blaze_tpu import batch as JB
from blaze_tpu.exprs import col as jcol
from blaze_tpu.ops import AggExec as JAgg
from blaze_tpu.ops import AggFunction as JFn
from blaze_tpu.ops import AggMode as JMode
from blaze_tpu.ops import GroupingExpr as JGroup
from blaze_tpu.ops import MemoryScanExec as JScan
from blaze_tpu.runtime.context import TaskContext as JContext
from blaze_tpu.schema import DataType as JT, Field as JF, Schema as JSchema

from blaze_tpu_torch import batch as TB
from blaze_tpu_torch.exprs import col as tcol
from blaze_tpu_torch.ops import AggExec, AggFunction, AggMode, GroupingExpr, MemoryScanExec
from blaze_tpu_torch.runtime.context import TaskContext
from blaze_tpu_torch.schema import DataType as TT, Field as TF, Schema as TSchema

N = 700
# (name, port type, reference type, value range)
COLUMNS = [
    ("narrow", TT.decimal(4, 2), JT.decimal(4, 2), 10**4),        # sum(14,2) -> avg(8,6): int64
    ("narrow128", TT.decimal(5, 2), JT.decimal(5, 2), 10**5),     # sum(15,2) -> avg(9,6): int128
    ("wide", TT.decimal(12, 2), JT.decimal(12, 2), 10**12),       # q01: sum(22,2) -> avg(16,6)
    ("huge", TT.decimal(20, 0), JT.decimal(20, 0), 2**62),        # avg(24,4) past int64: null
    ("i64", TT.int64(), JT.int64(), 2**40),
    ("f64", TT.float64(), JT.float64(), None),
]


def _inputs():
    rng = np.random.default_rng(12)
    g = rng.integers(0, 6, N).astype(np.int32)
    arrays, valids = {"g": g}, {"g": None}
    for name, _, _, hi in COLUMNS:
        arrays[name] = rng.standard_normal(N) * 1e6 if hi is None else rng.integers(-hi + 1, hi, N)
        # group 5 holds only nulls; elsewhere 15% nulls
        valids[name] = (rng.random(N) > 0.15) & (g != 5)
    return arrays, valids


def _run(exec_cls_fn, scan, context, agg, fn, grouped, to_pydict):
    groups = [grouped("g", "g")] if grouped else []
    aggs = [fn("avg", col, f"avg_{name}") for name, col in agg]
    partial = exec_cls_fn(scan, "PARTIAL", groups, aggs)
    final = exec_cls_fn(partial, "FINAL", [grouped("g", "g")] if grouped else [], aggs)
    out = {f.name: [] for f in final.schema.fields}
    for b in final.execute(0, context(0, 1)):
        for k, v in to_pydict(b).items():
            out[k].extend(v)
    return final.schema, out


@pytest.mark.parametrize("grouped", [True, False], ids=["grouped", "global"])
def test_avg_partial_final_matches_reference(grouped):
    arrays, valids = _inputs()
    names = ["g"] + [c[0] for c in COLUMNS]
    ttypes = {"g": TT.int32(), **{c[0]: c[1] for c in COLUMNS}}
    jtypes = {"g": JT.int32(), **{c[0]: c[2] for c in COLUMNS}}
    tschema = TSchema([TF(n, ttypes[n]) for n in names])
    jschema = JSchema([JF(n, jtypes[n]) for n in names])
    tcols = [TB.column_from_numpy(ttypes[n], arrays[n], valids[n], capacity=1024, device="cpu")
             for n in names]
    jcols = [JB.column_from_numpy(jtypes[n], arrays[n], valids[n], capacity=1024).to_device()
             for n in names]
    tscan = MemoryScanExec([[TB.RecordBatch(tschema, tcols, N)]], tschema, device="cpu")
    jscan = JScan([[JB.RecordBatch(jschema, jcols, N)]], jschema)

    t_schema, got = _run(
        lambda c, m, g, a: AggExec(c, getattr(AggMode, m), g, a), tscan, TaskContext,
        [(c[0], tcol(c[0])) for c in COLUMNS], AggFunction, grouped and (lambda e, n: GroupingExpr(tcol(e), n)),
        TB.batch_to_pydict)
    j_schema, want = _run(
        lambda c, m, g, a: JAgg(c, getattr(JMode, m), g, a), jscan, JContext,
        [(c[0], jcol(c[0])) for c in COLUMNS], JFn, grouped and (lambda e, n: JGroup(jcol(e), n)),
        JB.batch_to_pydict)
    assert [repr(f.dtype) for f in t_schema.fields] == [repr(f.dtype) for f in j_schema.fields]
    assert repr(t_schema.field("avg_wide").dtype) == "decimal(16,6)"
    if grouped:
        order_t, order_j = np.argsort(got["g"]), np.argsort(want["g"])
        got = {k: [v[i] for i in order_t] for k, v in got.items()}
        want = {k: [v[i] for i in order_j] for k, v in want.items()}
        assert got["g"] == list(range(6))
        # the all-null group averages to null everywhere
        assert all(got[f"avg_{c[0]}"][5] is None for c in COLUMNS)
    for name, *_ in COLUMNS:
        k = f"avg_{name}"
        if name == "f64":
            np.testing.assert_allclose(np.array(got[k][:5 if grouped else 1], float),
                                       np.array(want[k][:5 if grouped else 1], float), rtol=1e-12)
        else:
            assert got[k] == want[k], name
    # overflow past int64 is null in both, and the others are not
    assert all(v is None for v in got["avg_huge"])
    assert got["avg_wide"][0] is not None


def test_avg_rounds_half_up_away_from_zero():
    """A sum of +-0.01 over 32 rows is 312.5 units of the result scale
    (10^-6): HALF_UP gives +-313 (HALF_EVEN would give 312), on the
    narrow int64 branch, the int128 branch and the wide-limb branch."""
    n = 64
    g = np.repeat(np.array([0, 1], np.int32), 32)
    v = np.zeros(n, np.int64)
    v[0], v[32] = 1, -1
    types = {"narrow": TT.decimal(4, 2), "narrow128": TT.decimal(5, 2), "wide": TT.decimal(12, 2)}
    tschema = TSchema([TF("g", TT.int32())] + [TF(k, t) for k, t in types.items()])
    cols = [TB.column_from_numpy(TT.int32(), g, None, capacity=n, device="cpu")] + [
        TB.column_from_numpy(t, v, None, capacity=n, device="cpu") for t in types.values()]
    scan = MemoryScanExec([[TB.RecordBatch(tschema, cols, n)]], tschema, device="cpu")
    aggs = [AggFunction("avg", tcol(k), k) for k in types]
    partial = AggExec(scan, AggMode.PARTIAL, [GroupingExpr(tcol("g"), "g")], aggs)
    final = AggExec(partial, AggMode.FINAL, [GroupingExpr(tcol("g"), "g")], aggs)
    out = TB.batch_to_pydict(next(iter(final.execute(0, TaskContext(0, 1)))))
    for k in types:
        assert dict(zip(out["g"], out[k])) == {0: 313, 1: -313}, k
