"""``min`` and ``max`` of the port's ``AggExec`` against the JAX
package and Python: int64, date, decimal, float64 (NaN, -0.0, inf) and
string columns, grouped and global, in one batch and across a
partial/final split through an exchange, a group of nulls only, and no
rows at all.  As in the reference, NaN is larger than every number and
a NaN in a group makes its min NaN too.  Every comparison is exact
(floats by ``repr``, so -0.0 is not 0.0).
"""

import math

import numpy as np
import pytest

from blaze_tpu.batch import batch_to_pydict as jax_to_pydict
from blaze_tpu.exprs import col as jcol
from blaze_tpu.ops import AggExec as JAggExec, AggFunction as JAgg, AggMode as JAggMode
from blaze_tpu.ops import GroupingExpr as JGroup, MemoryScanExec as JaxScan
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

_MM_FLOATS = [np.nan, -0.0, 0.0, np.inf, -np.inf, 1.5, -7.25, 3.0, np.nan, 0.0]


def _encode_strings(vals, width):
    data = np.zeros((len(vals), width), np.uint8)
    lengths = np.zeros(len(vals), np.int32)
    for i, s in enumerate(vals):
        b = s.encode()
        data[i, :len(b)] = np.frombuffer(b, np.uint8)
        lengths[i] = len(b)
    return data, lengths


def _minmax_table(seed, n):
    rng = np.random.default_rng(seed)
    words = ["", "a", "ab", "abc", "b", "PROMO", "PROM", "zeta", "a\x7f", "Zulu"]
    strs = [words[i] for i in rng.integers(0, len(words), n)]
    table = {
        "g": (rng.integers(0, 9, n).astype(np.int32), None, None),
        "i": (rng.integers(-(2**40), 2**40, n), None, rng.random(n) > 0.2),
        "d": (rng.integers(-5000, 20000, n).astype(np.int32), None, rng.random(n) > 0.2),
        "m": (rng.integers(-(10**11), 10**11, n), None, rng.random(n) > 0.2),
        "f": (np.array([_MM_FLOATS[i] for i in rng.integers(0, len(_MM_FLOATS), n)]), None, rng.random(n) > 0.2),
        "s": (*_encode_strings(strs, 16), rng.random(n) > 0.2),
    }
    # group 8 holds nulls only
    for k in ("i", "d", "m", "f", "s"):
        table[k][2][table["g"][0] == 8] = False
    return table, strs


_MM_FIELDS = [("g", TT.int32(), JT.int32()), ("i", TT.int64(), JT.int64()), ("d", TT.date32(), JT.date32()),
              ("m", TT.decimal(12, 2), JT.decimal(12, 2)), ("f", TT.float64(), JT.float64()),
              ("s", TT.string(16), JT.string(16))]


def _scan_pair(table, fields, parts, batch_rows):
    ts = TSchema([TF(n, t) for n, t, _ in fields])
    js = JSchema([JF(n, j) for n, _, j in fields])
    return (MemoryScanExec(table_to_batches(table, ts, parts, batch_rows, device=CPU), ts, device=CPU),
            JaxScan(jax_table_to_batches(table, js, parts, batch_rows=batch_rows), js))


def _run(p, to_pydict, context):
    out = {f.name: [] for f in p.schema.fields}
    for i in range(p.num_partitions()):
        for b in p.execute(i, context(i, p.num_partitions())):
            for k, v in to_pydict(b).items():
                out[k].extend(v)
    return out


def _rows(out):
    return sorted((tuple(repr(v) for v in r) for r in zip(*out.values())))


def _python_minmax(values, is_min):
    vals = [v for v in values if v is not None]
    if not vals:
        return None
    if any(isinstance(v, float) and math.isnan(v) for v in vals):
        return float("nan")
    if isinstance(vals[0], float):
        # -0.0 orders below 0.0
        key = lambda v: (v, math.copysign(1.0, v))
        return (min if is_min else max)(vals, key=key)
    return (min if is_min else max)(vals)


@pytest.mark.parametrize("grouped", [True, False], ids=["grouped", "global"])
@pytest.mark.parametrize("split", ["one-batch", "partial-final"])
def test_min_max_match_reference_and_python(grouped, split):
    table, strs = _minmax_table(62, 600)
    parts, rows = (1, 1024) if split == "one-batch" else (2, 96)
    tscan, jscan = _scan_pair(table, _MM_FIELDS, parts, rows)
    names = ["i", "d", "m", "f", "s"]

    def plan(mod, scan, Exec, Mode, Agg, Group, c):
        aggs = [Agg(fn, c(k), f"{fn}_{k}") for k in names for fn in ("min", "max")]
        groups = [Group(c("g"), "g")] if grouped else []
        if split == "one-batch":
            partial = Exec(scan, Mode.PARTIAL, groups, aggs)
            return Exec(partial, Mode.FINAL, [Group(c(g.name), g.name) for g in groups], aggs)
        # partial states of several batches, merged through an exchange
        return mod.two_stage_agg(scan, groups, aggs, 2)

    got = _run(plan(Q, tscan, AggExec, AggMode, AggFunction, GroupingExpr, tcol), batch_to_pydict, TaskContext)
    want = _run(plan(JQ, jscan, JAggExec, JAggMode, JAgg, JGroup, jcol), jax_to_pydict, JaxContext)
    assert _rows(got) == _rows(want)
    # the same extremes from Python over the table's valid values
    g = table["g"][0].tolist() if grouped else [0] * 600
    for k in names:
        data, valid = table[k][0], table[k][2]
        vals = [(strs[i] if k == "s" else data[i].item()) if valid[i] else None for i in range(600)]
        for fn in ("min", "max"):
            by_group = {}
            for gi, v in zip(g, vals):
                by_group.setdefault(gi, []).append(v)
            want_col = {gi: _python_minmax(vs, fn == "min") for gi, vs in by_group.items()}
            keys = got["g"] if grouped else [0]
            assert [repr(v) for v in got[f"{fn}_{k}"]] == [repr(want_col[gi]) for gi in keys], (fn, k)
    if grouped:
        assert got["min_i"][got["g"].index(8)] is None and got["max_s"][got["g"].index(8)] is None


def test_min_max_over_no_rows_is_null():
    table, _ = _minmax_table(63, 10)
    tscan, jscan = _scan_pair({k: tuple(x[:0] if x is not None else None for x in v) for k, v in table.items()},
                              _MM_FIELDS, 1, 16)
    aggs = lambda Agg, c: [Agg("min", c("f"), "lo"), Agg("max", c("s"), "hi"), Agg("count_star", None, "n")]
    got = _run(Q.two_stage_agg(tscan, [], aggs(AggFunction, tcol), 2), batch_to_pydict, TaskContext)
    want = _run(JQ.two_stage_agg(jscan, [], aggs(JAgg, jcol), 2), jax_to_pydict, JaxContext)
    assert got == want == {"lo": [None], "hi": [None], "n": [0]}
