"""Partial aggregate skipping (``spark.blaze.partialAggSkipping.*``) of
the port against the JAX package's.

Each case feeds the same seeded (key, value) batches to both packages'
PARTIAL agg (``sum`` and ``count_star`` by the key; a global agg for
one case) with ``supports_partial_skipping`` set, in 1024-row batches,
under the reference's ratio 0.8 and its fused update, with ``minRows``
set alike in both (small, so that a case crosses it in a few batches),
and compares ``partial_skipped``, the number of the PARTIAL output's
batches and the multiset of its rows, and the FINAL agg's rows over
that output.  The cases: unique keys over 4 batches crossing minRows,
decided on a fold (the accumulator rebuilt past its bucket), with a
lower minRows still there (the fold's count one fold behind), and with
a higher minRows on the eager path the accumulator then takes; keys
whose groups stay well under the ratio, and near it on either side;
the conf's ``enable`` false; a ``pre_filter`` that drops most rows
(``in_rows`` counts them all); a global agg, which never skips; and
batches of varied capacities, where folds and eager batches
interleave.
"""

import numpy as np
import pytest

import blaze_tpu.batch as JB
from blaze_tpu import conf as jconf
from blaze_tpu.exprs import col as jcol, lit as jlit
from blaze_tpu.ops import MemoryScanExec as JScan
from blaze_tpu.ops.agg import AggExec as JAgg, AggFunction as JFn, AggMode as JMode, GroupingExpr as JGroup
from blaze_tpu.runtime.context import TaskContext as JCtx
from blaze_tpu.schema import DataType as JT, Field as JF, Schema as JSchema

import blaze_tpu_torch
import blaze_tpu_torch.batch as TB
from blaze_tpu_torch import conf
from blaze_tpu_torch.exprs import col, lit
from blaze_tpu_torch.ops import MemoryScanExec
from blaze_tpu_torch.ops.agg import AggExec, AggFunction, AggMode, GroupingExpr
from blaze_tpu_torch.runtime.context import TaskContext
from blaze_tpu_torch.schema import DataType as TT, Field as TF, Schema as TSchema

TSCHEMA = TSchema([TF("k", TT.int64()), TF("v", TT.int64())])
JSCHEMA = JSchema([JF("k", JT.int64()), JF("v", JT.int64())])

BATCH = 1024

# (label, rows, distinct keys (None: unique), minRows, pre_filter bound
# on v (None: no filter), enable, grouped, the skips expected)
CASES = [
    ("unique keys, decided on a fold", 4096, None, 2500, None, True, True, 1),
    ("unique keys, decided on the eager path", 4096, None, 3500, None, True, True, 1),
    # checked from batch 2, where the fold's count is its capacity's
    # 1024 (one fold behind), not the 2048 groups: decided at batch 3
    ("unique keys, the fold's count one behind", 4096, None, 1500, None, True, True, 1),
    ("groups well under the ratio", 4096, 400, 2500, None, True, True, 0),
    # 0.796 and 0.733 of the rows distinct at batches 3 and 4, but the
    # eager count at batch 4 (its groups beside the accumulator's) is 0.82
    ("groups near the ratio, over it by the eager count", 4096, 6000, 2500, None, True, True, 1),
    ("groups near the ratio, under it", 4096, 5000, 2500, None, True, True, 0),
    ("enable false", 4096, None, 2500, None, False, True, 0),
    ("a pre_filter dropping most rows", 4096, None, 2500, 10, True, True, 0),
    ("a global agg", 4096, None, 2500, None, True, False, 0),
]


@pytest.fixture(autouse=True)
def on_cpu():
    prev = blaze_tpu_torch._default_device
    blaze_tpu_torch.set_default_device("cpu")
    yield
    blaze_tpu_torch.set_default_device(prev)


@pytest.fixture
def skipping():
    """Sets ``enable`` and ``minRows`` in both packages for the test;
    restores them after."""
    entries = (conf.ENABLE_PARTIAL_AGG_SKIPPING, jconf.ENABLE_PARTIAL_AGG_SKIPPING,
               conf.PARTIAL_AGG_SKIPPING_MIN_ROWS, jconf.PARTIAL_AGG_SKIPPING_MIN_ROWS)
    saved = [e.get() for e in entries]

    def set_conf(enable: bool, min_rows: int) -> None:
        for e, v in zip(entries, (enable, enable, min_rows, min_rows)):
            e.set(v)

    yield set_conf
    for e, v in zip(entries, saved):
        e.set(v)


def _table(rows, distinct, seed):
    rng = np.random.default_rng(seed)
    keys = rng.permutation(rows) if distinct is None else rng.integers(0, distinct, rows)
    return {"k": (keys.astype(np.int64), None, None), "v": (rng.integers(0, 100, rows), None, None)}


def _port_batches(table, batch_rows):
    """One partition of ``batch_rows``-row batches; ``batch_rows`` a
    list: batches of those sizes, in turn."""
    if isinstance(batch_rows, int):
        return TB.table_to_batches(table, TSCHEMA, 1, batch_rows, "cpu")
    cuts = np.cumsum([0] + batch_rows)
    return [[TB.batch_from_numpy(TSCHEMA, table, "cpu", int(a), int(b)) for a, b in zip(cuts, cuts[1:])]]


def _slice(table, lo, hi):
    return {k: (v[0][lo:hi],) + tuple(None if x is None else x[lo:hi] for x in v[1:]) for k, v in table.items()}


def _jax_batches(table, batch_rows):
    from blaze_tpu.tpch.datagen import table_to_batches

    if isinstance(batch_rows, int):
        return table_to_batches(table, JSCHEMA, 1, batch_rows)
    cuts = np.cumsum([0] + batch_rows)
    return [[table_to_batches(_slice(table, int(a), int(b)), JSCHEMA, 1, int(b - a))[0][0]
             for a, b in zip(cuts, cuts[1:])]]


def _aggs(package, grouped, bound):
    c, l = (col, lit) if package == "port" else (jcol, jlit)
    G, F, M = (GroupingExpr, AggFunction, AggMode) if package == "port" else (JGroup, JFn, JMode)
    groupings = [G(c("k"), "k")] if grouped else []
    fns = [F("sum", c("v"), "s"), F("count_star", None, "n")]
    return groupings, fns, (None if bound is None else c("v") < l(bound)), M


def _run(package, table, batch_rows, bound, grouped):
    """(partial_skipped, the PARTIAL output's batches as sorted rows,
    the FINAL rows sorted)."""
    groupings, fns, pre, M = _aggs(package, grouped, bound)
    if package == "port":
        scan = MemoryScanExec(_port_batches(table, batch_rows), TSCHEMA, device="cpu")
        partial = AggExec(scan, M.PARTIAL, groupings, fns, supports_partial_skipping=True, pre_filter=pre)
        final = AggExec(partial, M.FINAL, [GroupingExpr(col("k"), "k")] if grouped else [], fns)
        ctx, to_dict, skipped = TaskContext(0, 1), TB.batch_to_pydict, lambda: partial.metrics.values.get(
            "partial_skipped", 0)
    else:
        scan = JScan(_jax_batches(table, batch_rows), JSCHEMA)
        partial = JAgg(scan, M.PARTIAL, groupings, fns, supports_partial_skipping=True, pre_filter=pre)
        final = JAgg(partial, M.FINAL, [JGroup(jcol("k"), "k")] if grouped else [], fns)
        ctx, to_dict, skipped = JCtx(0, 1), JB.batch_to_pydict, lambda: partial.metrics.get("partial_skipped")
    parts = [sorted(zip(*to_dict(b).values())) for b in partial.execute(0, ctx)]
    n_skipped = skipped()
    rows = sorted(r for b in final.execute(0, ctx) for r in zip(*to_dict(b).values()))
    return n_skipped, parts, rows


@pytest.mark.parametrize("label,rows,distinct,min_rows,bound,enable,grouped,skips", CASES,
                         ids=[c[0] for c in CASES])
def test_the_skip_equals_the_reference(skipping, label, rows, distinct, min_rows, bound, enable, grouped, skips):
    skipping(enable, min_rows)
    table = _table(rows, distinct, seed=rows + (distinct or 0))
    t_skipped, t_parts, t_rows = _run("port", table, BATCH, bound, grouped)
    j_skipped, j_parts, j_rows = _run("jax", table, BATCH, bound, grouped)
    assert t_skipped == j_skipped == skips
    assert len(t_parts) == len(j_parts)
    assert sorted(r for p in t_parts for r in p) == sorted(r for p in j_parts for r in p)
    assert [len(p) for p in t_parts] == [len(p) for p in j_parts]
    assert t_rows == j_rows


def test_folds_and_eager_batches_interleave(skipping):
    """Batches whose capacities go up and down: some fold into the
    accumulator, some take the eager path, a fold outgrows its bucket."""
    skipping(True, 2500)
    sizes = [300, 1024, 200, 700, 1024, 500, 1024, 150, 1024]
    table = _table(sum(sizes), 4000, seed=11)
    t_skipped, t_parts, t_rows = _run("port", table, sizes, None, True)
    j_skipped, j_parts, j_rows = _run("jax", table, sizes, None, True)
    assert t_skipped == j_skipped
    assert [len(p) for p in t_parts] == [len(p) for p in j_parts]
    assert sorted(r for p in t_parts for r in p) == sorted(r for p in j_parts for r in p)
    assert t_rows == j_rows
