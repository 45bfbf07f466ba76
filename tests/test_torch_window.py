"""The port's window operator (``blaze_tpu_torch/ops/window.py``) against
the reference's ``WindowExec`` (``blaze_tpu/ops/window.py``).

One seeded numpy table feeds both packages: a string key and an int key
with nulls, a decimal(7,2), a float64 with NaN, -0.0, 0.0 and ties, an
int order key with ties and nulls, a date and an int32, split over
three scan partitions (one empty) of several batches each.  Each window
spec (partition keys x order keys) sorts its partitions and runs every
window kind the spec allows in one ``WindowExec``: ranks, ntile,
nth_value, lead/lag (with and without ignore_nulls), first/last value,
and sum/count/avg/min/max over the running, whole-partition, ROWS and
RANGE frames.  Integers, decimals and ranks must be exact; float64
within 1e-9 relative (NaN equal to NaN, the sign of a zero kept).

Also: a one-row partition; two reference defects pinned (ROADMAP
queue C): a decimal average whose int64 product wraps in the reference
while the port divides on int128 (defect 12), and a float running sum
that carries one partition's NaN into the later partitions in the
reference (defect 13: the sums take a NaN-free float column
elsewhere); min and max against a Python oracle with -0.0 and NaN; the
fused form (a chain over a ``BufferPartitionExec``) equal to the
unfused operator; kinds and frames the transform does not compute
raise, naming themselves.  The specs' other half is in
``test_torch_window_frames.py``.
"""

import math

import numpy as np
import pytest

import blaze_tpu.exprs.ir as JIR
import blaze_tpu.ops as JOPS
from blaze_tpu import schema as JSCH
from blaze_tpu.batch import batch_to_pydict as jax_to_pydict
from blaze_tpu.runtime.context import TaskContext as JaxContext
from blaze_tpu.tpch.datagen import table_to_batches as jax_table_to_batches

import blaze_tpu_torch.exprs.ir as TIR
import blaze_tpu_torch.ops as TOPS
from blaze_tpu_torch import schema as TSCH
from blaze_tpu_torch.batch import batch_to_pydict, table_to_batches
from blaze_tpu_torch.ops import fusion
from blaze_tpu_torch.runtime.context import TaskContext

N_ROWS = 400
BATCH_ROWS = 48


def _schema(S):
    T = S.DataType
    return S.Schema([
        S.Field("k", T.string(8)), S.Field("g", T.int64()), S.Field("d", T.decimal(7, 2)),
        S.Field("f", T.float64()), S.Field("o", T.int64()), S.Field("dt", T.date32()),
        S.Field("i", T.int32()), S.Field("x", T.float64()),
    ])


def _strings(values, valid, width=8):
    data = np.zeros((len(values), width), np.uint8)
    lengths = np.zeros(len(values), np.int32)
    for r, (v, ok) in enumerate(zip(values, valid)):
        if ok:
            b = v.encode()
            data[r, :len(b)] = np.frombuffer(b, np.uint8)
            lengths[r] = len(b)
    return data, lengths


def _table(seed=3, n=N_ROWS):
    g = np.random.default_rng(seed)
    keys = np.array(["a", "bb", "ccc", "dd", "e"])
    kv = g.random(n) > 0.08
    k = keys[g.integers(0, 5, n)]
    gv = g.random(n) > 0.08
    f = g.choice([np.nan, -0.0, 0.0, 0.25, -1.5, 2.0, 7.5, 1e3, -3.25], n)
    return {
        "k": _strings(k, kv) + (kv,),
        "g": (g.integers(0, 4, n).astype(np.int64), None, gv),
        "d": (g.integers(-50_000, 50_000, n).astype(np.int64), None, g.random(n) > 0.1),
        "f": (f, None, g.random(n) > 0.1),
        "o": (g.integers(0, 12, n).astype(np.int64), None, g.random(n) > 0.1),
        "dt": (g.integers(10_000, 10_030, n).astype(np.int32), None, g.random(n) > 0.1),
        "i": (g.integers(-100, 100, n).astype(np.int32), None, g.random(n) > 0.1),
        # sums take a float column with no NaN: the reference's running
        # sums difference one cumsum over every partition, so a NaN
        # poisons the partitions after it
        # (test_reference_float_running_sum_carries_a_nan_into_later_partitions)
        "x": (g.choice([-0.0, 0.0, 0.25, -1.5, 2.0, 7.5, 1e3, -3.25], n), None, g.random(n) > 0.1),
    }


def _parts(table, to_batches, schema, layout, **kw):
    """Two scan partitions, then an empty one.  "batches": several
    batches a partition, -0.0 read as 0.0 (the reference's concatenation
    drops the sign, ROADMAP queue C defect 4); "one": one batch a
    partition, -0.0 kept."""
    if layout == "batches":
        table = {c: (np.where(v[0] == 0, 0.0, v[0]),) + v[1:] if v[0].dtype.kind == "f" else v
                 for c, v in table.items()}
        return to_batches(table, schema, 2, batch_rows=BATCH_ROWS, **kw) + [[]]
    return to_batches(table, schema, 2, batch_rows=N_ROWS, **kw) + [[]]


def _run(plan, to_pydict, context):
    out = {f.name: [] for f in plan.schema.fields}
    n = plan.num_partitions()
    for p in range(n):
        for b in plan.execute(p, context(p, n)):
            for k, v in to_pydict(b).items():
                out[k].extend(v)
    return out


def _functions(M, order, ord_type):
    """Every kind the spec allows, as (kind, name, expr name, options)."""
    col = M.col
    fs = [("row_number", "rn", None, {}), ("rank", "rk", None, {}), ("dense_rank", "drk", None, {}),
          ("ntile", "nt3", None, {"offset": 3}),
          ("nth_value", "nth2", "k", {"offset": 2}), ("nth_value", "nth2w", "d", {"offset": 2, "whole_partition": True}),
          ("first_value", "fv", "k", {}), ("last_value", "lv", "f", {}),
          ("last_value", "lvw", "d", {"whole_partition": True})]
    for kind, off, ign in (("lag", 1, False), ("lead", 1, False), ("lag", 2, True), ("lead", 2, True)):
        for src in ("k", "f", "d"):
            fs.append((kind, f"{kind}{off}{'n' if ign else ''}_{src}", src, {"offset": off, "ignore_nulls": ign}))
    frames = [("run", {}), ("whole", {"whole_partition": True}), ("rows21", {"rows_frame": (2, 1)}),
              ("rowsup", {"rows_frame": (None, 0)}), ("rowsdown", {"rows_frame": (1, None)}),
              ("rows00", {"rows_frame": (0, 0)})]
    if len(order) == 1 and ord_type in ("int", "date", "decimal"):
        # a RANGE frame's binary search is the reference's slowest
        # compile: each kind once per frame
        for fname, opts in (("range21", {"range_frame": (2, 1)}), ("rangeup", {"range_frame": (None, 1)}),
                            ("rangedown", {"range_frame": (0, None)})):
            fs += [(kind, f"{kind}_{src}_{fname}", src, opts)
                   for kind, src in (("sum", "x"), ("avg", "d"), ("count", "i"), ("min", "f"), ("max", "d"))]
    for fname, opts in frames:
        for kind in ("sum", "count", "avg"):
            for src in ("d", "x", "i"):
                fs.append((kind, f"{kind}_{src}_{fname}", src, opts))
        bounded = "rows_frame" not in opts or None not in opts["rows_frame"]
        if bounded:
            for kind in ("min", "max"):
                for src in ("d", "f", "i", "dt"):
                    fs.append((kind, f"{kind}_{src}_{fname}", src, opts))
    return [M.WindowFunction(kind, name, None if src is None else col(src), **opts)
            for kind, name, src, opts in fs]


# (partition keys, [(order key, ascending, nulls_first)], the order
# key's type, the scan's layout: see _parts)
SPECS = {
    "no_keys": ([], [], None, "batches"),
    "part_k": (["k"], [], None, "one"),
    "part_k_order_o": (["k"], [("o", True, True)], "int", "one"),
    "order_d": ([], [("d", True, True)], "decimal", "batches"),
    "part_gk_order_f_desc": (["g", "k"], [("f", False, False)], "float", "one"),
    "part_g_order_dt_desc": (["g"], [("dt", False, True)], "date", "batches"),
    "part_k_order_o_f": (["k"], [("o", True, False), ("f", True, True)], None, "one"),
}


def _plan(M, scan_cls, parts, schema, spec):
    part_by, order, ord_type, _ = SPECS[spec]
    col = M.col
    sort_fields = [M.SortField(col(c)) for c in part_by] + [M.SortField(col(c), a, nf) for c, a, nf in order]
    child = scan_cls(parts, schema)
    if sort_fields:
        child = M.SortExec(child, sort_fields)
    return M.WindowExec(child, _functions(M, order, ord_type), [col(c) for c in part_by],
                        [M.SortField(col(c), a, nf) for c, a, nf in order])


class _Jax:
    col, SortField, SortExec, WindowExec = JIR.col, JOPS.SortField, JOPS.SortExec, JOPS.WindowExec
    from blaze_tpu.ops.window import WindowFunction


class _Torch:
    col, SortField, SortExec, WindowExec = TIR.col, TOPS.SortField, TOPS.SortExec, TOPS.WindowExec
    WindowFunction = TOPS.WindowFunction


def _torch_scan(parts, schema):
    return TOPS.MemoryScanExec(parts, schema, device="cpu")


def _same(a, b, zero_sign: bool) -> bool:
    if a is None or b is None:
        return a is b
    if isinstance(a, float) or isinstance(b, float):
        a, b = float(a), float(b)
        if math.isnan(a) or math.isnan(b):
            return math.isnan(a) and math.isnan(b)
        if a == 0.0 and b == 0.0:
            return not zero_sign or math.copysign(1, a) == math.copysign(1, b)
        return abs(a - b) <= 1e-9 * max(abs(a), abs(b))
    return a == b


def assert_rows_equal(got, want):
    """Columns equal, floats within 1e-9 relative.  A zero's sign counts
    where a value is gathered (the inputs, lead, lag, first, last, nth);
    not in sums, averages and extremes, where Spark compares -0.0 equal
    to 0.0 (the reference's running min over 2.0, -0.0 gives 0.0, the
    port's -0.0: test_extremes_order_negative_zero_below_zero)."""
    assert list(got) == list(want)
    for name in got:
        assert len(got[name]) == len(want[name]), name
        zero_sign = not name.startswith(("sum_", "avg_", "min_", "max_"))
        bad = [(r, x, y) for r, (x, y) in enumerate(zip(got[name], want[name])) if not _same(x, y, zero_sign)]
        assert not bad, (name, bad[:5])


@pytest.fixture(scope="module")
def table():
    return _table()


def check_spec(table, spec):
    """Every kind of ``spec`` through both packages, rows equal."""
    layout = SPECS[spec][3]
    tparts = _parts(table, table_to_batches, _schema(TSCH), layout, device="cpu")
    jparts = _parts(table, jax_table_to_batches, _schema(JSCH), layout)
    got = _run(_plan(_Torch, _torch_scan, tparts, _schema(TSCH), spec), batch_to_pydict, TaskContext)
    want = _run(_plan(_Jax, JOPS.MemoryScanExec, jparts, _schema(JSCH), spec), jax_to_pydict, JaxContext)
    assert len(got["rn"]) == N_ROWS
    assert_rows_equal(got, want)


# the other specs are in test_torch_window_frames.py (each spec's
# reference compile takes 5-20 s)
@pytest.mark.parametrize("spec", ["no_keys", "part_k", "part_k_order_o", "part_gk_order_f_desc"])
def test_every_kind_equals_the_reference(table, spec):
    check_spec(table, spec)


def test_fused_chain_over_a_partition_buffer_equals_the_operator(table):
    """Filter(Window(Sort)) through tier 4: the window is the chain's
    bottom over a BufferPartitionExec, and the rows are the unfused
    operator's."""
    schema = _schema(TSCH)
    col = TIR.col

    def plan():
        parts = _parts(table, table_to_batches, schema, "batches", device="cpu")
        w = TOPS.WindowExec(TOPS.SortExec(_torch_scan(parts, schema), [TOPS.SortField(col("k"))]),
                            [TOPS.WindowFunction("sum", "s", col("d"), whole_partition=True),
                             TOPS.WindowFunction("rank", "r")], [col("k")], [])
        return TOPS.FilterExec(w, col("s") > TIR.lit(0))

    fused = fusion.fuse_traceable_chains(plan())
    assert type(fused).__name__ == "FusedStageExec"
    assert [type(o).__name__ for o in fused.ops] == ["WindowExec", "FilterExec"]
    assert type(fused.children[0]).__name__ == "BufferPartitionExec"
    got = _run(fused, batch_to_pydict, TaskContext)
    want = _run(plan(), batch_to_pydict, TaskContext)
    assert got["s"] and all(s > 0 for s in got["s"])
    assert_rows_equal(got, want)


def test_extremes_order_negative_zero_below_zero():
    """min and max over every frame order -0.0 below 0.0 and NaN above
    every number, and a NaN in the frame makes either NaN (a Python
    oracle over one partition ordered by row)."""
    vals = [2.0, -0.0, 0.0, None, float("nan"), -1.5, 0.0]
    n = len(vals)
    schema = TSCH.Schema([TSCH.Field("o", TSCH.DataType.int64()), TSCH.Field("v", TSCH.DataType.float64())])
    t = {"o": (np.arange(n, dtype=np.int64), None),
         "v": (np.array([0.0 if v is None else v for v in vals]), None, np.array([v is not None for v in vals]))}
    col, W = TIR.col, TOPS.WindowFunction
    fs = [W(k, f"{k}_{name}", col("v"), **opts) for k in ("min", "max")
          for name, opts in (("run", {}), ("whole", {"whole_partition": True}), ("rows", {"rows_frame": (1, 1)}),
                             ("range", {"range_frame": (1, 0)}))]
    w = TOPS.WindowExec(_torch_scan(table_to_batches(t, schema, 1, device="cpu"), schema), fs, [],
                        [TOPS.SortField(col("o"))])
    got = _run(w, batch_to_pydict, TaskContext)

    def key(v):
        return (1, 0.0) if math.isnan(v) else (0, v, math.copysign(1, v))

    def oracle(kind, lo, hi):
        frame = [v for v in vals[max(lo, 0):hi + 1] if v is not None]
        if not frame:
            return None
        if any(math.isnan(v) for v in frame):
            return float("nan")
        return (min if kind == "min" else max)(frame, key=key)

    for kind in ("min", "max"):
        for name, bounds in (("run", lambda r: (0, r)), ("whole", lambda r: (0, n - 1)),
                             ("rows", lambda r: (r - 1, r + 1)), ("range", lambda r: (r - 1, r))):
            want = [oracle(kind, *bounds(r)) for r in range(n)]
            assert all(_same(a, b, True) for a, b in zip(got[f"{kind}_{name}"], want)), (kind, name, want)
    assert math.copysign(1, got["min_run"][1]) == -1 and math.copysign(1, got["max_rows"][1]) == 1


def test_one_row_partitions(table):
    """Every partition one row: ranks 1, lag/lead null, frames of one
    row."""
    one = {c: tuple(None if a is None else a[:1] for a in v) for c, v in table.items()}
    schema = _schema(TSCH)
    tparts = [table_to_batches(one, schema, 1, device="cpu")[0]] * 2
    jparts = [jax_table_to_batches(one, _schema(JSCH), 1)[0]] * 2
    got = _run(_plan(_Torch, _torch_scan, tparts, schema, "part_k_order_o"), batch_to_pydict, TaskContext)
    want = _run(_plan(_Jax, JOPS.MemoryScanExec, jparts, _schema(JSCH), "part_k_order_o"), jax_to_pydict,
                JaxContext)
    assert got["rk"] == [1, 1] and got["lag1_k"] == [None, None]
    assert_rows_equal(got, want)


def _decimal_avg(values, M, scan, to_batches, context, to_pydict, S, **kw):
    schema = S.Schema([S.Field("g", S.DataType.int64()), S.Field("v", S.DataType.decimal(17, 2))])
    t = {"g": (np.zeros(len(values), np.int64), None), "v": (np.array(values, np.int64), None)}
    w = M.WindowExec(scan(to_batches(t, schema, 1, **kw), schema),
                     [M.WindowFunction("avg", "a", M.col("v"), whole_partition=True),
                      M.WindowFunction("sum", "s", M.col("v"), whole_partition=True)], [M.col("g")], [])
    return _run(w, to_pydict, context)


def test_reference_decimal_window_avg_wraps_where_the_port_divides_on_int128():
    """avg over decimal(17,2) gives decimal(21,6): the reference
    multiplies the int64 sum by 10^4 and wraps once the sum passes
    9.2e14 units (ROADMAP queue C, reference defect 12); the port
    divides on int128 and gives Spark's value, 5e12 exactly."""
    values = [500_000_000_000_000, 500_000_000_000_000]  # 5e12 each, unscaled at scale 2
    got = _decimal_avg(values, _Torch, _torch_scan, table_to_batches, TaskContext, batch_to_pydict, TSCH,
                       device="cpu")
    want = _decimal_avg(values, _Jax, JOPS.MemoryScanExec, jax_table_to_batches, JaxContext, jax_to_pydict, JSCH)
    exact = 500_000_000_000_000 * 10**4  # 5e12 at scale 6
    assert got["a"] == [exact, exact] and got["s"] == [10**15, 10**15]
    assert want["s"] == got["s"] and want["a"] != got["a"]


def test_unsupported_frames_raise_naming_themselves():
    schema = _schema(TSCH)
    scan = _torch_scan([[]], schema)
    col, W = TIR.col, TOPS.WindowFunction
    for f, order, what in (
        (W("rank", "r", rows_frame=(1, 1)), [], "ROWS frame for window kind 'rank'"),
        (W("min", "m", col("i"), rows_frame=(None, 1)), [], "unbounded ROWS min/max"),
        (W("sum", "s", col("d"), range_frame=(1, 1)), [], "exactly one ORDER BY key"),
        (W("sum", "s", col("d"), range_frame=(1, 1)), [TOPS.SortField(col("f"))], "integral order key"),
        (W("lag", "l", col("d"), range_frame=(1, 1)), [TOPS.SortField(col("o"))], "RANGE frame for window kind"),
        (W("max", "m", col("k")), [], "over a string"),
    ):
        with pytest.raises(NotImplementedError, match=what):
            TOPS.WindowExec(scan, [f], [], order)
    with pytest.raises(NotImplementedError, match="percent_rank"):
        TOPS.WindowExec(scan, [W("percent_rank", "p")], [], [])


def test_reference_float_running_sum_carries_a_nan_into_later_partitions():
    """The reference's running and ROWS-frame float sums difference one
    cumsum over the whole batch, so a NaN in one partition makes every
    later partition's sums NaN (ROADMAP queue C, reference defect 13);
    the port's segmented scan restarts at each partition and gives
    Spark's sums (a Python oracle).  Smallest input: partition "a" holds
    [NaN], partition "b" [1.0, 2.0]."""
    def plan(S, M, scan, to_batches, **kw):
        schema = S.Schema([S.Field("k", S.DataType.string(8)), S.Field("v", S.DataType.float64())])
        t = {"k": _strings(["a", "b", "b"], [True] * 3) + (np.ones(3, bool),),
             "v": (np.array([np.nan, 1.0, 2.0]), None)}
        c = M.col
        return M.WindowExec(scan(to_batches(t, schema, 1, **kw), schema),
                            [M.WindowFunction("sum", "run", c("v")),
                             M.WindowFunction("sum", "rows", c("v"), rows_frame=(1, 0)),
                             M.WindowFunction("sum", "whole", c("v"), whole_partition=True)],
                            [c("k")], [M.SortField(c("v"))])

    got = _run(plan(TSCH, _Torch, _torch_scan, table_to_batches, device="cpu"), batch_to_pydict, TaskContext)
    want = _run(plan(JSCH, _Jax, JOPS.MemoryScanExec, jax_table_to_batches), jax_to_pydict, JaxContext)
    assert got["run"][1:] == [1.0, 3.0] and got["rows"][1:] == [1.0, 3.0] and got["whole"][1:] == [3.0, 3.0]
    assert all(math.isnan(v) for v in want["run"][1:] + want["rows"][1:])
    assert want["whole"][1:] == [3.0, 3.0]
