"""``stddev_samp`` and ``var_samp`` of the port's ``AggExec`` against the
JAX package and an exact oracle.

One seeded table, two partitions of 512-row batches, goes through both
packages' PARTIAL -> hash (or single) exchange -> FINAL plan, so each
partition merges its batches' states and the FINAL merges the
partitions' (Chan's formula both times).  The cases: int32, int64,
float64 and decimal(7,2) inputs with nulls; groups of one and of two
values and a group of nulls only; values near 1e9 with small deviations
(where a sum of squares would cancel); grouped and global; a global
aggregate over no rows and over one and two rows.  Every value agrees
with the reference's and with the oracle's (the variance exact in
rationals, rounded once) within 1e-12 relative, and is null exactly
where theirs is; the values near 1e9 within 1e-9: each merge's term
``n_i (mean_i - mean)^2`` carries the rounding of means near 1e9 (an
ulp is 1.2e-7) against deviations of about 300, about 1e-11 relative in
both packages (their sums round in other orders).  This file has the
int32, int64 and float64 inputs; ``test_torch_agg_stddev_wide.py`` the
decimal and near-1e9 inputs and the state's three columns across the
``.data`` files of ``split_stages``/``run_stages``.
"""

import math
from fractions import Fraction

import numpy as np
import pytest

from blaze_tpu.batch import batch_to_pydict as jax_to_pydict
from blaze_tpu.exprs import col as jcol
from blaze_tpu.ops import AggFunction as JAgg, GroupingExpr as JGroup, MemoryScanExec as JaxScan
from blaze_tpu.runtime.context import TaskContext as JaxContext
from blaze_tpu.schema import DataType as JT, Field as JF, Schema as JSchema
from blaze_tpu.tpch import queries as JQ
from blaze_tpu.tpch.datagen import table_to_batches as jax_table_to_batches

from blaze_tpu_torch.batch import batch_to_pydict, table_to_batches
from blaze_tpu_torch.exprs import col as tcol
from blaze_tpu_torch.ops import AggExec, AggFunction, AggMode, GroupingExpr, MemoryScanExec
from blaze_tpu_torch.runtime.context import TaskContext
from blaze_tpu_torch.schema import DataType as TT, Field as TF, Schema as TSchema
from blaze_tpu_torch.tpch import queries as Q

CPU = "cpu"
N = 3000
PARTS = 2
BATCH_ROWS = 512
REL = 1e-12
REL_NEAR_1E9 = 1e-9

FIELDS = [("g", TT.int64(), JT.int64()), ("i32", TT.int32(), JT.int32()), ("i64", TT.int64(), JT.int64()),
          ("f64", TT.float64(), JT.float64()), ("dec", TT.decimal(7, 2), JT.decimal(7, 2)),
          ("big", TT.int64(), JT.int64()), ("fbig", TT.float64(), JT.float64())]


def _table(n: int):
    """Groups 0-39 at random; group 100 one row, 101 two rows, 102 only
    nulls; every value column with nulls.  ``big``/``fbig``: 1e9 plus
    deviations under 1000."""
    rng = np.random.default_rng(17)
    g = rng.integers(0, 40, n).astype(np.int64)
    if n >= 10:
        g[3] = 100
        g[[5, 9]] = 101
        g[[1, 7, 8]] = 102
    valid = lambda: rng.random(n) > 0.15
    big = 10**9 + rng.integers(0, 1000, n)
    t = {
        "g": (g, None, None),
        "i32": (rng.integers(-(2**31), 2**31 - 1, n).astype(np.int32), None, valid()),
        "i64": (rng.integers(-(10**12), 10**12, n), None, valid()),
        "f64": (rng.standard_normal(n) * 1e3, None, valid()),
        "dec": (rng.integers(-(10**7) + 1, 10**7, n), None, valid()),
        "big": (big, None, valid()),
        "fbig": (big.astype(np.float64) + 0.25, None, valid()),
    }
    for k, (_, _, v) in t.items():
        if v is not None and n >= 10:
            v[[3, 5, 9]] = True
            v[[1, 7, 8]] = False
    return t


def _scan_pair(table):
    ts = TSchema([TF(n, t) for n, t, _ in FIELDS])
    js = JSchema([JF(n, j) for n, _, j in FIELDS])
    return (MemoryScanExec(table_to_batches(table, ts, PARTS, BATCH_ROWS, device=CPU), ts, device=CPU),
            JaxScan(jax_table_to_batches(table, js, PARTS, batch_rows=BATCH_ROWS), js))


def _plans(table, column, grouped):
    port, ref = _scan_pair(table)
    aggs = [("stddev_samp", "sd"), ("var_samp", "var")]
    p = Q.two_stage_agg(port, [GroupingExpr(tcol("g"), "g")] if grouped else [],
                        [AggFunction(fn, tcol(column), nm) for fn, nm in aggs], PARTS)
    j = JQ.two_stage_agg(ref, [JGroup(jcol("g"), "g")] if grouped else [],
                         [JAgg(fn, jcol(column), nm) for fn, nm in aggs], PARTS)
    return p, j


def _run(plan, to_pydict, context):
    out = {f.name: [] for f in plan.schema.fields}
    for i in range(plan.num_partitions()):
        for b in plan.execute(i, context(i, plan.num_partitions())):
            for k, v in to_pydict(b).items():
                out[k].extend(v)
    return out


def _rows(out, grouped):
    keys = out["g"] if grouped else [None] * len(out["sd"])
    return {k: (sd, var) for k, sd, var in zip(keys, out["sd"], out["var"])}


def _oracle(table, column, grouped):
    """{group: (stddev, variance)} from exact rationals."""
    data, _, valid = table[column]
    scale = 100 if column == "dec" else 1
    groups = {}
    for k, v, ok in zip(table["g"][0].tolist(), data.tolist(), valid.tolist()):
        vals = groups.setdefault(k if grouped else None, [])
        if ok:
            vals.append(Fraction(v) / scale)
    if not grouped and not groups:
        groups[None] = []
    out = {}
    for k, vals in groups.items():
        n = len(vals)
        if n < 2:
            out[k] = (None, None)
            continue
        mean = sum(vals) / n
        var = float(sum((v - mean) ** 2 for v in vals) / (n - 1))
        out[k] = (math.sqrt(var), var)
    return out


def _close(a, b, rel=REL):
    if a is None or b is None:
        return a is None and b is None
    return a == b or abs(a - b) <= rel * max(abs(a), abs(b))


def case_ids(cases):
    return [f"{c}-{'grouped' if g else 'global'}-{n}rows" for c, g, n in cases]


# the decimal and near-1e9 inputs are in test_torch_agg_stddev_wide.py
CASES = [(c, g, N) for c in ("i32", "i64", "f64") for g in (True, False)]
CASES += [("i64", False, 0), ("i64", True, 0), ("f64", False, 2)]


@pytest.mark.parametrize("column,grouped,n", CASES, ids=case_ids(CASES))
def test_stddev_and_variance_equal_the_reference_and_the_exact_oracle(column, grouped, n):
    check_case(column, grouped, n)


def check_case(column, grouped, n):
    table = _table(n)
    port, ref = _plans(table, column, grouped)
    got = _rows(_run(port, batch_to_pydict, TaskContext), grouped)
    want = _rows(_run(ref, jax_to_pydict, JaxContext), grouped)
    exact = _oracle(table, column, grouped)
    assert set(got) == set(want) == set(exact)
    rel = REL_NEAR_1E9 if column in ("big", "fbig") else REL
    bad = [(k, got[k], want[k], exact[k]) for k in got
           if not all(_close(a, b, rel) and _close(a, c, rel) for a, b, c in zip(got[k], want[k], exact[k]))]
    assert not bad, bad[:5]
    if grouped and n == N:
        # one value, no value: null; two values: defined
        assert got[100] == (None, None) and got[102] == (None, None) and got[101][0] is not None
    assert port.schema.field("sd").dtype == TT.float64()


def test_an_unknown_state_raises_naming_the_function():
    schema = TSchema([TF("x#sum", TT.int64())])
    scan = MemoryScanExec([[]], schema, device=CPU)
    # ``first`` and ``collect_list`` are ported since; a collect merge
    # finds its input type in its ``#list`` state, which this schema lacks
    with pytest.raises(NotImplementedError, match="no_such_agg"):
        AggExec(scan, AggMode.FINAL, [], [AggFunction("no_such_agg", tcol("x"), "x")])
    with pytest.raises(KeyError, match="x#list"):
        AggExec(scan, AggMode.FINAL, [], [AggFunction("collect_list", tcol("x"), "x")])
