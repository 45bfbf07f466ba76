"""``first`` and ``first_ignores_null`` in the port's AggExec against
the JAX package: grouped and global, over several batches and two
partitions, PARTIAL -> hash exchange -> FINAL, for int64 (decimals share
its path), float and string inputs with nulls; with a filter folded into the
PARTIAL aggregate by the optimizer; and in one partition, where the
result is the first row in input order (every sort on the path is
stable).  A merge of states skips null states, ``first`` too: the
reference's rule (``ignore = ... or mode != PARTIAL``, ROADMAP queue C),
which Spark's ``First`` does not have.  Every comparison is exact.
"""

import numpy as np
import pytest

from blaze_tpu.batch import batch_to_pydict as jax_to_pydict
from blaze_tpu.exprs import col as jcol, lit as jlit
from blaze_tpu.ops import AggExec as JAgg, AggFunction as JFn, AggMode as JMode, FilterExec as JFilter
from blaze_tpu.ops import GroupingExpr as JGroup, MemoryScanExec as JaxScan
from blaze_tpu.ops.fusion import optimize_plan as jax_optimize
from blaze_tpu.parallel import HashPartitioning as JHash, NativeShuffleExchangeExec as JExchange
from blaze_tpu.parallel import SinglePartitioning as JSingle
from blaze_tpu.runtime.context import TaskContext as JaxContext
from blaze_tpu.schema import DataType as JT, Field as JF, Schema as JSchema
from blaze_tpu.tpch.datagen import table_to_batches as jax_table_to_batches

from blaze_tpu_torch.batch import batch_to_pydict, table_to_batches
from blaze_tpu_torch.exprs import col, lit
from blaze_tpu_torch.ops import AggExec, AggFunction, AggMode, FilterExec, GroupingExpr, MemoryScanExec
from blaze_tpu_torch.ops.fusion import optimize_plan
from blaze_tpu_torch.parallel.exchange import NativeShuffleExchangeExec
from blaze_tpu_torch.parallel.shuffle import HashPartitioning, SinglePartitioning
from blaze_tpu_torch.runtime.context import TaskContext
from blaze_tpu_torch.schema import DataType as TT, Field as TF, Schema as TSchema

from test_torch_fn_tables import host_table
from test_torch_fusion import node_classes

N = 1500
FIELDS = [("k", TT.int32(), JT.int32()), ("v", TT.int64(), JT.int64()), ("d", TT.decimal(12, 2), JT.decimal(12, 2)),
          ("x", TT.float64(), JT.float64()), ("s", TT.string(16), JT.string(16))]
TSCH = TSchema([TF(n, t) for n, t, _ in FIELDS])
JSCH = JSchema([JF(n, j) for n, _, j in FIELDS])


@pytest.fixture(scope="module")
def table():
    rng = np.random.RandomState(41)
    words = ["alpha", "beta", "", "gamma delta", "z", "épsilon"]
    # nulls clustered at the start of batches, so a group's first row is
    # often null and first_ignores_null must look past it
    nulls = lambda: (rng.rand(N) > 0.35) & (np.arange(N) % 250 > 3)
    return host_table({
        "k": (np.int32, rng.randint(0, 9, N), rng.rand(N) > 0.05),
        "v": (np.int64, rng.randint(-10**9, 10**9, N), nulls()),
        "d": (np.int64, rng.randint(-10**7, 10**7, N), nulls()),
        "x": (np.float64, rng.normal(0, 10, N), nulls()),
        "s": (("string", 16), [words[i] for i in rng.randint(0, len(words), N)], nulls()),
    })


def _aggs(F, c):
    return [F(fn, c(n), f"{fn}_{n}") for n in ("v", "x", "s") for fn in ("first", "first_ignores_null")]


def _port(table, grouped, n_parts=2, rows=250, filtered=False, optimize=False):
    scan = MemoryScanExec(table_to_batches(table, TSCH, n_parts, rows, "cpu"), TSCH, device="cpu")
    child = FilterExec(scan, col("v") > lit(-(10**8))) if filtered else scan
    g = [GroupingExpr(col("k"), "k")] if grouped else []
    partial = AggExec(child, AggMode.PARTIAL, g, _aggs(AggFunction, col))
    part = HashPartitioning([col("k")], 3) if grouped else SinglePartitioning()
    plan = AggExec(NativeShuffleExchangeExec(partial, part), AggMode.FINAL,
                   [GroupingExpr(col("k"), "k")] if grouped else [], _aggs(AggFunction, col))
    return optimize_plan(plan) if optimize else plan


def _ref(table, grouped, n_parts=2, rows=250, filtered=False, optimize=False):
    scan = JaxScan(jax_table_to_batches(table, JSCH, n_parts, batch_rows=rows), JSCH)
    child = JFilter(scan, jcol("v") > jlit(-(10**8))) if filtered else scan
    g = [JGroup(jcol("k"), "k")] if grouped else []
    partial = JAgg(child, JMode.PARTIAL, g, _aggs(JFn, jcol))
    part = JHash([jcol("k")], 3) if grouped else JSingle()
    plan = JAgg(JExchange(partial, part), JMode.FINAL, [JGroup(jcol("k"), "k")] if grouped else [],
                _aggs(JFn, jcol))
    return jax_optimize(plan) if optimize else plan


def _rows(plan, ctx, to_pydict):
    out = {}
    n = plan.num_partitions()
    for p in range(n):
        for b in plan.execute(p, ctx(p, n)):
            for k, v in to_pydict(b).items():
                out.setdefault(k, []).extend(v)
    return out


def _by_key(rows):
    keys = rows.get("k", [None] * len(next(iter(rows.values()))))
    return {k: {c: rows[c][i] for c in rows if c != "k"} for i, k in enumerate(keys)}


@pytest.mark.parametrize("grouped,filtered", [(True, False), (False, False), (True, True)],
                         ids=["grouped", "global", "grouped-filter-folded"])
def test_first_equals_the_reference(table, grouped, filtered):
    got = _rows(_port(table, grouped, filtered=filtered, optimize=filtered), TaskContext, batch_to_pydict)
    want = _rows(_ref(table, grouped, filtered=filtered, optimize=filtered), JaxContext, jax_to_pydict)
    assert _by_key(got) == _by_key(want)
    assert len(got["first_v"]) == (10 if grouped else 1)
    if filtered:
        assert node_classes(_port(table, True, filtered=True, optimize=True)) == \
            node_classes(_ref(table, True, filtered=True, optimize=True))


def test_first_in_one_batch_is_the_first_row_in_input_order(table):
    rows = _rows(_port(table, True, n_parts=1, rows=N), TaskContext, batch_to_pydict)
    k, v, valid_v = table["k"][0], table["v"][0], table["v"][2]
    kvalid = table["k"][2]
    for i, key in enumerate(rows["k"]):
        idx = [j for j in range(N) if (kvalid[j] and k[j] == key) or (key is None and not kvalid[j])]
        first = idx[0]
        assert rows["first_v"][i] == (int(v[first]) if valid_v[first] else None)
        nn = [j for j in idx if valid_v[j]]
        assert rows["first_ignores_null_v"][i] == (int(v[nn[0]]) if nn else None)
