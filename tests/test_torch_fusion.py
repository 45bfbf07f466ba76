"""The port's task optimizer (``blaze_tpu_torch/ops/fusion.py``) against
the reference's (``blaze_tpu/ops/fusion.py``) and a Python oracle.

(a) Both packages' builders give every TPC-H query, TPC-DS q03 and
q07, the 15 TPC-DS window queries, the 11 of ``EXISTS_STDDEV_QUERIES``,
the 31 of ``REPORT_QUERIES`` and the 26 of ``JOINED_QUERIES`` the same
unoptimized plan (node for node), and ``optimize_plan`` must then give
the same node-class sequence in both, fused chains compared by their
operators too (a window at a chain's bottom over a
``BufferPartitionExec``, a fused expand; a ``RenameColumnsExec`` stays
where it is in both).  No query is skipped: all 107 build the same plan
in both packages.  q65, q1, q30, q81 and q59 alone optimize to another
plan (an exchange under two consumers stays one node in the port);
``test_torch_tpcds_report_share.py`` and
``test_torch_tpcds_joined_share.py`` check them.

(b) Each tier alone, column pruning alone and the whole optimizer leave
the rows of five plans over one seeded table equal to the unoptimized
port's, to the reference's (unoptimized, as its ``plan.execute`` runs)
and to a Python oracle.  The table has nulls in every column, NaN, -0.0
and 0.0, strings for a LIKE with no device form (``'%a%b%'``: the host
LIKE, under an agg and under a shuffle write) and one batch where no
row passes the filters.  Tier 5 is checked through a
``ShuffleWriterExec``: the files it commits read back to the same rows
and are byte for byte those of the unfused writer.
"""

import math
import os

import numpy as np
import pytest

import blaze_tpu.exprs.ir as JIR
import blaze_tpu.ops as JOPS
from blaze_tpu import schema as JSCH
from blaze_tpu.batch import batch_to_pydict as jax_to_pydict
from blaze_tpu.ops.fusion import optimize_plan as jax_optimize_plan
from blaze_tpu.parallel import exchange as JEX
from blaze_tpu.parallel import shuffle as JSH
from blaze_tpu.runtime.context import TaskContext as JaxContext
from blaze_tpu.tpcds import TPCDS_SCHEMAS as JAX_DS_SCHEMAS
from blaze_tpu.tpcds import build_query as jax_build_ds
from blaze_tpu.tpch import TPCH_SCHEMAS as JAX_SCHEMAS
from blaze_tpu.tpch import build_query as jax_build_query
from blaze_tpu.tpch.datagen import generate_all as jax_generate_all
from blaze_tpu.tpch.datagen import table_to_batches as jax_table_to_batches

import blaze_tpu_torch.exprs.ir as TIR
import blaze_tpu_torch.ops as TOPS
from blaze_tpu_torch import conf
from blaze_tpu_torch import schema as TSCH
from blaze_tpu_torch.batch import batch_to_pydict, table_to_batches
from blaze_tpu_torch.ops import fusion
from blaze_tpu_torch.ops.pruning import prune_columns
from blaze_tpu_torch.parallel import exchange as TEX
from blaze_tpu_torch.parallel import shuffle as TSH
from blaze_tpu_torch.parallel.shuffle import IpcReaderExec, LocalShuffleManager
from blaze_tpu_torch.runtime.context import RESOURCES, TaskContext
from blaze_tpu_torch.tpcds import TPCDS_SCHEMAS
from blaze_tpu_torch.tpcds import build_query as build_ds
from blaze_tpu_torch.tpcds.queries import EXISTS_STDDEV_QUERIES, JOINED_QUERIES, REPORT_QUERIES, WINDOW_QUERIES
from blaze_tpu_torch.tpch import TPCH_SCHEMAS, build_query
from blaze_tpu_torch.tpch.datagen import generate_all

SCALE = 0.002
N_PARTS = 2


def node_classes(node, depth=0):
    """The plan's nodes, depth first: (depth, class, fused operators)."""
    ops = tuple(type(o).__name__ for o in getattr(node, "ops", ()))
    out = [(depth, type(node).__name__, ops)]
    for c in node.children:
        out += node_classes(c, depth + 1)
    return out


# ------------------------------------------------- (a) node sequences


@pytest.fixture(scope="module")
def tpch_data():
    return generate_all(SCALE), jax_generate_all(SCALE)


def _tpch_plans(tpch_data, q):
    data, jax_data = tpch_data
    scans = {k: TOPS.MemoryScanExec(table_to_batches(data[k], TPCH_SCHEMAS[k], N_PARTS, 4096, "cpu"),
                                    TPCH_SCHEMAS[k], device="cpu") for k in TPCH_SCHEMAS}
    jscans = {k: JOPS.MemoryScanExec(jax_table_to_batches(jax_data[k], JAX_SCHEMAS[k], N_PARTS, batch_rows=4096),
                                     JAX_SCHEMAS[k]) for k in JAX_SCHEMAS}
    return build_query(q, scans, N_PARTS), jax_build_query(q, jscans, N_PARTS)


def _ds_plans(q):
    """TPC-DS plans over empty scans: building them reads no row."""
    scans = {k: TOPS.MemoryScanExec([[]] * N_PARTS, s, device="cpu") for k, s in TPCDS_SCHEMAS.items()}
    jscans = {k: JOPS.MemoryScanExec([[]] * N_PARTS, s) for k, s in JAX_DS_SCHEMAS.items()}
    return build_ds(q, scans, N_PARTS), jax_build_ds(q, jscans, N_PARTS)


@pytest.mark.parametrize("q", [f"q{i}" for i in range(1, 23)] + ["ds_q3", "ds_q7"]
                         + [f"ds_{q}" for q in WINDOW_QUERIES + EXISTS_STDDEV_QUERIES
                            + tuple(q for q in REPORT_QUERIES if q != "q65")
                            + tuple(q for q in JOINED_QUERIES if q not in ("q1", "q30", "q81", "q59"))])
def test_optimized_plan_has_the_reference_node_sequence(tpch_data, q):
    port, ref = _ds_plans(q[3:]) if q.startswith("ds_") else _tpch_plans(tpch_data, q)
    assert node_classes(port) == node_classes(ref)
    opt = fusion.optimize_plan(port)
    assert node_classes(opt) == node_classes(jax_optimize_plan(ref))
    if q in ("q1", "q3", "q6"):
        # the tiers really rewrote them: q01's and q06's filters became
        # pre_filters, q03's sort and limit a post_sort on its final agg
        assert node_classes(opt) != node_classes(_tpch_plans(tpch_data, q)[0])


def test_fusion_disabled_only_prunes(tpch_data):
    conf.FUSION_ENABLE.set(False)
    try:
        plan = fusion.optimize_plan(_tpch_plans(tpch_data, "q6")[0])
    finally:
        conf.FUSION_ENABLE.set(True)
    classes = [c for _, c, _ in node_classes(plan)]
    assert "FilterExec" in classes and "FusedStageExec" not in classes
    assert all(a.pre_filter is None for a in _walk(plan) if isinstance(a, TOPS.AggExec))


def _walk(node):
    yield node
    for c in node.children:
        yield from _walk(c)


# ------------------------------------------------ (b) rows, tier by tier

N_ROWS = 300
BATCH_ROWS = 64  # rows 64-127 (partition 0's second batch) pass no filter


def _table():
    """The seeded table, its host layout shared by both packages:
    k string group key, f float64, d decimal(12,2), i int64, s string;
    every column with nulls."""
    g = np.random.default_rng(11)
    keys = np.array([b"a", b"b", b"c", b"dd"])
    k = keys[g.integers(0, 4, N_ROWS)]
    f = g.choice([np.nan, -0.0, 0.0, 0.25, -1.5, 2.0, 7.5], N_ROWS)
    d = g.integers(-50_000, 50_000, N_ROWS).astype(np.int64)
    i = g.integers(0, 200, N_ROWS).astype(np.int64)
    i[64:128] = g.integers(0, 40, 64)  # a whole batch below every filter
    words = np.array([b"xaybz", b"ab", b"bxa", b"aab", b"zzz", b"a", b""])
    s = words[g.integers(0, len(words), N_ROWS)]
    valid = {c: g.random(N_ROWS) > 0.1 for c in "kfdis"}
    # a null's bytes are zero, as the engines write them
    for arr, c in ((f, "f"), (d, "d"), (i, "i")):
        arr[~valid[c]] = 0
    k[~valid["k"]] = b""
    s[~valid["s"]] = b""

    def strings(v):
        out = np.zeros((N_ROWS, 8), np.uint8)
        for r, b in enumerate(v):
            out[r, :len(b)] = np.frombuffer(b, np.uint8)
        return out, np.array([len(b) for b in v], np.int32)

    table = {"k": (*strings(k), valid["k"]), "f": (f, None, valid["f"]), "d": (d, None, valid["d"]),
             "i": (i, None, valid["i"]), "s": (*strings(s), valid["s"])}
    vals = {"k": [x.decode() for x in k], "f": f.tolist(), "d": d.tolist(), "i": i.tolist(),
            "s": [x.decode() for x in s]}
    py = [{c: vals[c][r] if valid[c][r] else None for c in "kfdis"} for r in range(N_ROWS)]
    return table, py


class Pkg:
    """One package's plan-building names."""

    def __init__(self, ir, ops, sch, ex, sh):
        self.ir, self.ops, self.sch, self.ex, self.sh = ir, ops, sch, ex, sh

    def schema(self):
        S = self.sch
        return S.Schema([S.Field("k", S.DataType.string(8)), S.Field("f", S.DataType.float64()),
                         S.Field("d", S.DataType.decimal(12, 2)), S.Field("i", S.DataType.int64()),
                         S.Field("s", S.DataType.string(8))])


PORT = Pkg(TIR, TOPS, TSCH, TEX, TSH)
REF = Pkg(JIR, JOPS, JSCH, JEX, JSH)


def plan_agg(P, scan):
    """Limit(Sort(FINAL agg)) over one partition, over a PARTIAL agg
    over project(filter): tiers 1 and 3."""
    col, lit, O = P.ir.col, P.ir.lit, P.ops
    pred = ((col("i") > lit(50)) & (col("d") > P.ir.lit(-400, P.sch.DataType.decimal(12, 2)))) | (col("f") > lit(5.0))
    proj = O.ProjectExec(O.FilterExec(scan, pred),
                         [col("k"), col("f"), col("d"), (col("d") + col("d")).alias("d2")], ["k", "f", "d", "d2"])
    aggs = [O.AggFunction("sum", col("d2"), "sd"), O.AggFunction("count", col("f"), "cf"),
            O.AggFunction("count_star", None, "n"), O.AggFunction("min", col("f"), "lo"),
            O.AggFunction("max", col("f"), "hi"), O.AggFunction("avg", col("d"), "ad")]
    partial = O.AggExec(proj, O.AggMode.PARTIAL, [O.GroupingExpr(col("k"), "k")], aggs)
    one = P.ex.NativeShuffleExchangeExec(partial, P.sh.SinglePartitioning())
    final = O.AggExec(one, O.AggMode.FINAL, [O.GroupingExpr(col("k"), "k")], aggs)
    return O.LimitExec(O.SortExec(final, [O.SortField(col("n"), ascending=False), O.SortField(col("k"))]), 3)


def plan_float_keys(P, scan):
    """A global agg and a float-keyed agg whose exchanges into one
    partition from one partition move nothing: tier 2, with the
    filter absorbed (tier 1) and -0.0/NaN group keys."""
    col, lit, O = P.ir.col, P.ir.lit, P.ops
    partial = O.AggExec(O.FilterExec(scan, col("i") > lit(50)), O.AggMode.PARTIAL,
                        [O.GroupingExpr(col("f"), "f")], [O.AggFunction("count_star", None, "n")])
    one = P.ex.NativeShuffleExchangeExec(partial, P.sh.SinglePartitioning())
    final = O.AggExec(one, O.AggMode.FINAL, [O.GroupingExpr(col("f"), "f")], [O.AggFunction("count_star", None, "n")])
    return P.ex.NativeShuffleExchangeExec(P.ex.NativeShuffleExchangeExec(final, P.sh.SinglePartitioning()),
                                          P.sh.SinglePartitioning())


def chain(P, scan):
    """filter -> project -> filter: a traceable chain of three kernels."""
    col, lit, O = P.ir.col, P.ir.lit, P.ops
    f1 = O.FilterExec(scan, col("i") > lit(50))
    proj = O.ProjectExec(f1, [col("k"), (col("f") + lit(0.0)).alias("f0"), col("i"), (col("i") * lit(3)).alias("i3"),
                              col("s")], ["k", "f0", "i", "i3", "s"])
    return O.FilterExec(proj, col("k").is_not_null() | (col("i3") > lit(400)))


def plan_chain(P, scan):
    """The chain under a hash exchange: tier 4 (and tier 5 as a map
    task's shuffle write, below)."""
    return P.ex.NativeShuffleExchangeExec(chain(P, scan), P.sh.HashPartitioning([P.ir.col("i")], N_PARTS))


def host_like(P, scan):
    return P.ops.FilterExec(scan, P.ir.Like(P.ir.col("s"), "%a%b%"))


def plan_like_agg(P, scan):
    """A host LIKE under a PARTIAL agg: tier 1 leaves that filter."""
    col, O = P.ir.col, P.ops
    aggs = [O.AggFunction("count_star", None, "n"), O.AggFunction("sum", col("i"), "si")]
    partial = O.AggExec(host_like(P, scan), O.AggMode.PARTIAL, [O.GroupingExpr(col("k"), "k")], aggs)
    ex = P.ex.NativeShuffleExchangeExec(partial, P.sh.HashPartitioning([col("k")], N_PARTS))
    return O.AggExec(ex, O.AggMode.FINAL, [O.GroupingExpr(col("k"), "k")], aggs)


def plan_like_exchange(P, scan):
    """A host LIKE under a hash exchange (a shuffle write, below)."""
    return P.ex.NativeShuffleExchangeExec(host_like(P, scan), P.sh.HashPartitioning([P.ir.col("k")], N_PARTS))


PLANS = {"agg": plan_agg, "float_keys": plan_float_keys, "chain": plan_chain, "like_agg": plan_like_agg,
         "like_exchange": plan_like_exchange}


def _fkey(x):
    return (math.isnan(x), x, math.copysign(1.0, x))


def _canon(v):
    """A hashable, exact stand-in of a value (NaN and -0.0 distinct)."""
    return repr(v) if isinstance(v, float) else v


def oracle(name, py):
    """Rows of plan ``name`` (as dicts), by Python over the table."""
    def avg_half_up(vals):
        # decimal(12,2) avg -> decimal(16,6): sum * 10^4 / count, HALF_UP
        num, den = sum(vals) * 10**4, len(vals)
        q = (abs(num) * 2 + den) // (2 * den)
        return q if num >= 0 else -q

    gt = lambda a, b: None if a is None else a > b  # noqa: E731
    if name == "agg":
        def passes(r):
            a = gt(r["i"], 50)
            b = None if r["d"] is None else r["d"] > -40000
            left = False if a is False or b is False else (None if a is None or b is None else True)
            right = gt(r["f"], 5.0)
            return left is True or right is True

        groups = {}
        for r in py:
            if passes(r):
                groups.setdefault(r["k"], []).append(r)
        out = []
        for key, rs in groups.items():
            ds = [2 * r["d"] for r in rs if r["d"] is not None]
            fs = [r["f"] for r in rs if r["f"] is not None]
            ad = [r["d"] for r in rs if r["d"] is not None]
            lo = float("nan") if any(math.isnan(x) for x in fs) else (min(fs, key=_fkey) if fs else None)
            out.append({"k": key, "sd": sum(ds) if ds else None, "cf": len(fs), "n": len(rs), "lo": lo,
                        "hi": max(fs, key=_fkey) if fs else None, "ad": avg_half_up(ad) if ad else None})
        # n descending, then k ascending, nulls first
        out.sort(key=lambda r: (-r["n"], r["k"] is not None, r["k"] or ""))
        return out[:3]
    if name == "float_keys":
        counts = {}
        for r in py:
            if gt(r["i"], 50):
                f = r["f"]
                key = None if f is None else ("nan" if math.isnan(f) else repr(f + 0.0))
                counts[key] = counts.get(key, 0) + 1
        return [{"f": None if k is None else float(k), "n": n} for k, n in counts.items()]
    if name == "chain":
        out = []
        for r in py:
            if gt(r["i"], 50) and (r["k"] is not None or gt(3 * r["i"], 400)):
                out.append({"k": r["k"], "f0": None if r["f"] is None else r["f"] + 0.0, "i": r["i"],
                            "i3": 3 * r["i"], "s": r["s"]})
        return out
    import re

    rx = re.compile("^.*a.*b.*$", re.DOTALL)
    like = [r for r in py if r["s"] is not None and rx.match(r["s"])]
    if name == "like_exchange":
        return like
    groups = {}
    for r in like:
        groups.setdefault(r["k"], []).append(r)
    return [{"k": k, "n": len(rs), "si": sum(r["i"] for r in rs if r["i"] is not None)
             if any(r["i"] is not None for r in rs) else None} for k, rs in groups.items()]


def rows_of(plan, to_pydict, context):
    out = []
    n = plan.num_partitions()
    for p in range(n):
        for b in plan.execute(p, context(p, n)):
            d = to_pydict(b)
            out += [dict(zip(d, vals)) for vals in zip(*d.values())] if d else []
    return out


def as_set(rows, zero_sign=True):
    """Rows as a sorted list of canonical tuples; without
    ``zero_sign``, -0.0 reads 0.0 (reference defect 4 loses it)."""
    fix = (lambda v: v) if zero_sign else (lambda v: v + 0.0 if isinstance(v, float) else v)
    return sorted((tuple((k, _canon(fix(v))) for k, v in sorted(r.items())) for r in rows), key=repr)


@pytest.fixture(scope="module")
def table():
    return _table()


def port_scan(table):
    return TOPS.MemoryScanExec(table_to_batches(table[0], PORT.schema(), N_PARTS, BATCH_ROWS, "cpu"),
                               PORT.schema(), device="cpu")


def ref_scan(table):
    return JOPS.MemoryScanExec(jax_table_to_batches(table[0], REF.schema(), N_PARTS, batch_rows=BATCH_ROWS),
                               REF.schema())


REWRITES = {
    "none": lambda p: p,
    "fuse_stages": fusion.fuse_stages,
    "tier2": fusion._drop_noop_exchanges,
    "tier3": fusion._fuse_final_sort,
    "prune_columns": prune_columns,
    "tier4": fusion.fuse_traceable_chains,
    "optimize_plan": fusion.optimize_plan,
}

def _count(plan, cls):
    return sum(isinstance(n, cls) for n in _walk(plan))


# what each rewrite must have done to a plan, so that every tier is
# seen to act
ACTS = {
    ("fuse_stages", "agg"): lambda p: any(getattr(n, "pre_filter", None) is not None for n in _walk(p))
    and any(getattr(n, "post_sort", None) is not None for n in _walk(p)),
    ("fuse_stages", "float_keys"): lambda p: any(getattr(n, "pre_filter", None) is not None for n in _walk(p)),
    ("tier2", "float_keys"): lambda p: _count(p, TEX.NativeShuffleExchangeExec) == 1,
    ("tier3", "agg"): lambda p: any(getattr(n, "post_sort", None) is not None for n in _walk(p)),
    ("prune_columns", "agg"): lambda p: any(isinstance(n, TOPS.ProjectExec) and n._select_names
                                            and isinstance(n.children[0], TOPS.MemoryScanExec) for n in _walk(p)),
    ("tier4", "chain"): lambda p: _count(p, fusion.FusedStageExec) == 1,
    ("optimize_plan", "chain"): lambda p: _count(p, fusion.FusedStageExec) == 1,
    ("optimize_plan", "agg"): lambda p: _count(p, TOPS.SortExec) == 0,
}


@pytest.mark.parametrize("rewrite", list(REWRITES))
@pytest.mark.parametrize("name", list(PLANS))
def test_each_tier_keeps_the_rows(table, name, rewrite):
    base = rows_of(PLANS[name](PORT, port_scan(table)), batch_to_pydict, TaskContext)
    plan = REWRITES[rewrite](PLANS[name](PORT, port_scan(table)))
    assert ACTS.get((rewrite, name), lambda p: True)(plan)
    if name.startswith("like"):
        # the host LIKE stays a FilterExec of its own, unabsorbed, unfused
        assert any(isinstance(n, TOPS.FilterExec) and n.host for n in _walk(plan))
    got = rows_of(plan, batch_to_pydict, TaskContext)
    exp = oracle(name, table[1])
    if name == "agg":  # sorted, top 3
        assert [tuple(map(_canon, r.values())) for r in got] == [tuple(map(_canon, r.values())) for r in base]
        assert [r["k"] for r in got] == [r["k"] for r in exp]
    assert as_set(got) == as_set(base) == as_set(exp)
    ref = rows_of(PLANS[name](REF, ref_scan(table)), jax_to_pydict, JaxContext)
    assert as_set(got, zero_sign=False) == as_set(ref, zero_sign=False)


def _write(child, fuse: bool, root: str):
    """Map task 0 of ``child`` through a ShuffleWriterExec (tier 5 when
    ``fuse``): the committed bytes and the rows read back."""
    mgr = LocalShuffleManager(root)
    rows, raw = [], []
    for m in range(child.num_partitions()):
        writer = mgr.map_writer(child, TSH.HashPartitioning([TIR.col("i")], N_PARTS), 0, m)
        if fuse:
            fusion.fuse_shuffle_write(writer)
        assert writer.fused == fuse
        for _ in writer.execute(m, TaskContext(m, child.num_partitions())):
            pass
        for path in mgr.map_output_paths(0, m):
            with open(path, "rb") as f:
                raw.append(f.read())
    schema = child.schema
    for p in range(N_PARTS):
        with mgr.reduce_registration(RESOURCES, 0, child.num_partitions(), p):
            reader = IpcReaderExec(schema, "shuffle_0", N_PARTS, device="cpu")
            for b in reader.execute(p, TaskContext(p, N_PARTS)):
                d = batch_to_pydict(b)
                rows += [dict(zip(d, vals)) for vals in zip(*d.values())]
    mgr.cleanup()
    return raw, rows


@pytest.mark.parametrize("name", ["chain", "like"])
def test_tier5_shuffle_write_keeps_the_bytes(table, tmp_path, name):
    """Tier 5 over a traceable chain (absorbed: the writer's child is
    then the scan) and over a host LIKE filter (nothing absorbed): the
    files equal the unfused writer's byte for byte and read back to the
    oracle's rows, the all-false batch included."""
    make = chain if name == "chain" else host_like
    raw, rows = _write(make(PORT, port_scan(table)), False, str(tmp_path / "a"))
    child = make(PORT, port_scan(table))
    fused_raw, fused_rows = _write(child, True, str(tmp_path / "b"))
    assert fused_raw == raw
    assert as_set(fused_rows) == as_set(rows) == as_set(oracle("chain" if name == "chain" else "like_exchange",
                                                             table[1]))
    assert len(RESOURCES) == 0 and not os.path.exists(tmp_path / "b")


def test_tier5_absorbs_the_chain(table, tmp_path):
    mgr = LocalShuffleManager(str(tmp_path))
    writer = mgr.map_writer(chain(PORT, port_scan(table)), TSH.HashPartitioning([TIR.col("i")], N_PARTS), 0, 0)
    fusion.optimize_plan(writer)
    assert isinstance(writer.children[0], TOPS.MemoryScanExec)
    assert writer.schema.names == ["k", "f0", "i", "i3", "s"]
    like = mgr.map_writer(host_like(PORT, port_scan(table)), TSH.HashPartitioning([TIR.col("k")], N_PARTS), 1, 0)
    fusion.optimize_plan(like)
    assert isinstance(like.children[0], TOPS.FilterExec) and like.fused
    mgr.cleanup()
