"""Nested columns in the port against the JAX package: ARRAY, MAP and
STRUCT batches, the nested expressions and functions, explode and
pos_explode, collect_list and collect_set (≙ the reference's
``tests/test_nested.py``).

The same python rows go into both packages.  Batches, wire bytes and
type messages must be equal; each plan's ``batch_to_pydict`` must be
equal, exactly.  The reference's plans run once a module (their
compiles are most of this file's time); the cases read the shared
results.  Collects over nested elements, whose merges the reference's
own tests hold to python oracles, are held to the same oracles.
"""

import numpy as np
import pytest
import torch

import blaze_tpu.batch as JB
from blaze_tpu.exprs import ir as JI
from blaze_tpu.io import batch_serde as JBS
from blaze_tpu.ops import MemoryScanExec as JScan, ProjectExec as JProject
from blaze_tpu.ops.agg import AggExec as JAgg, AggFunction as JAF, AggMode as JMode, GroupingExpr as JGE
from blaze_tpu.ops.agg import agg_result_type as jax_agg_result_type
from blaze_tpu.ops.generate import GenerateExec as JGenerate, NativeGenerator as JNative
from blaze_tpu.ops.generate import json_tuple_generator as jax_json_tuple
from blaze_tpu.runtime.context import TaskContext as JCtx
from blaze_tpu.schema import DataType as JT, Field as JF, Schema as JS
from blaze_tpu.serde import to_proto as jax_to_proto

import blaze_tpu_torch
from blaze_tpu_torch import batch as TB
from blaze_tpu_torch import conf
from blaze_tpu_torch.exprs import ir as TI
from blaze_tpu_torch.io import batch_serde as BS
from blaze_tpu_torch.ops import GenerateExec, MemoryScanExec, NativeGenerator, ProjectExec
from blaze_tpu_torch.ops.agg import AggExec, AggFunction, AggMode, GroupingExpr, agg_result_type
from blaze_tpu_torch.ops.generate import json_tuple_generator
from blaze_tpu_torch.parallel.exchange import NativeShuffleExchangeExec
from blaze_tpu_torch.parallel.shuffle import HashPartitioning
from blaze_tpu_torch.runtime.context import TaskContext
from blaze_tpu_torch.schema import DataType as TT, Field as TF, Schema as TS
from blaze_tpu_torch.serde import from_proto, to_proto
from blaze_tpu_torch.tpch.queries import two_stage_agg

PKG = {"port": (TT, TF, TS), "ref": (JT, JF, JS)}


@pytest.fixture(autouse=True, scope="module")
def on_cpu():
    prev = blaze_tpu_torch._default_device
    blaze_tpu_torch.set_default_device("cpu")
    yield
    blaze_tpu_torch.set_default_device(prev)


def _types(T, F):
    return {
        "a": T.array(T.int64(), 4),
        "m": T.map(T.string(8), T.int32(), 4),
        "st": T.struct([F("x", T.int32()), F("s", T.string(8))]),
        "nn": T.array(T.array(T.int32(), 3), 2),
        "fa": T.array(T.float64(), 3),
    }


def schema(pkg):
    T, F, S = PKG[pkg]
    t = _types(T, F)
    return S([F("id", T.int32())] + [F(n, t[n]) for n in ("a", "m", "st", "nn", "fa")])


DATA = {
    "id": [1, 2, 3, 4, 5],
    "a": [[10, 20], None, [], [30, None, 50], [-7, 10, -7, 20]],
    "m": [{"x": 1}, None, {}, {"y": 2, "z": None}, {"x": 5, "y": 6, "w": 7, "v": 8}],
    "st": [{"x": 1, "s": "hi"}, None, {"x": None, "s": "yo"}, {"x": 4, "s": None}, {"x": -1, "s": "zz"}],
    "nn": [[[1, 2], [3]], None, [], [None, [4, 5, 6]], [[], [7]]],
    "fa": [[0.0, -0.0, 1.5], [float("nan")], None, [], [2.5, 2.5, -1.0]],
}


def port_batch(data=DATA, sch=None):
    return TB.batch_from_pydict(data, sch or schema("port"), device="cpu")


def ref_batch(data=DATA, sch=None):
    return JB.batch_from_pydict(data, sch or schema("ref"))


def _rows(plan, ctx_cls, to_pydict, concat):
    out = []
    for p in range(plan.num_partitions()):
        out += list(plan.execute(p, ctx_cls(p, plan.num_partitions())))
    if not out:
        return None
    return to_pydict(out[0] if len(out) == 1 else concat(out))


def port_rows(plan):
    return _rows(plan, TaskContext, TB.batch_to_pydict, TB.concat_batches)


def ref_rows(plan):
    return _rows(plan, JCtx, JB.batch_to_pydict, JB.concat_batches)


def _canon(v):
    """A python value with NaN and -0.0 spelled out, so that rows
    compare exactly (NaN != NaN in ``==``)."""
    if isinstance(v, list):
        return [_canon(x) for x in v]
    if isinstance(v, dict):
        return {k: _canon(x) for k, x in v.items()}
    if isinstance(v, float):
        return repr(v)
    return v


# ------------------------------------------------------------ layouts


def test_pydict_roundtrip():
    assert _canon(TB.batch_to_pydict(port_batch())) == _canon(DATA) == _canon(JB.batch_to_pydict(ref_batch()))


def test_concat_take_capacity():
    b = port_batch()
    two = TB.concat_batches([b, b])
    assert _canon(TB.batch_to_pydict(two)) == _canon({k: v + v for k, v in DATA.items()})
    d = TB.batch_to_pydict(b.take(torch.tensor([3, 0]), 2))
    assert d["a"] == [[30, None, 50], [10, 20]] and d["nn"] == [[None, [4, 5, 6]], [[1, 2], [3]]]
    jd = JB.batch_to_pydict(ref_batch().take(np.array([3, 0]), 2))
    assert _canon(d) == _canon(jd)
    assert _canon(TB.batch_to_pydict(TB.slice_rows(b, 1, 3))) == _canon({k: v[1:4] for k, v in DATA.items()})
    padded = TB.RecordBatch(b.schema, [c.pad(64) for c in b.columns], b.num_rows)
    assert padded.capacity == 64 and _canon(TB.batch_to_pydict(padded)) == _canon(DATA)


def test_serde_bytes_equal_the_reference():
    raw = BS.serialize_batch(port_batch())
    assert raw == JBS.serialize_batch(ref_batch())
    back = BS.deserialize_batch(raw, schema("port"), "cpu")
    assert _canon(TB.batch_to_pydict(back)) == _canon(DATA)
    TB.reset_copy_counts()
    BS.deserialize_batch(BS.serialize_batch(back), schema("port"), "cpu")
    assert TB.COPIES == {"device_to_host": 1, "host_to_device": 1}


def test_dtype_proto_bytes_equal_the_reference():
    extra = lambda T, F: T.map(T.int64(), _types(T, F)["st"], 3)
    for name in ("a", "m", "st", "nn", "fa", "extra"):
        pt = extra(TT, TF) if name == "extra" else _types(TT, TF)[name]
        jt = extra(JT, JF) if name == "extra" else _types(JT, JF)[name]
        raw = to_proto.dtype_to_proto(pt).encode()
        assert raw == jax_to_proto.dtype_to_proto(jt).SerializeToString()
        assert from_proto.dtype_from_proto(to_proto.pb.DataTypeProto.decode(raw)) == pt


# ------------------------------------------------------------- exprs


def _exprs(I):
    f = I.ScalarFunc
    return [
        I.GetIndexedField(I.col("a"), 0).alias("a0"), I.GetIndexedField(I.col("a"), 9).alias("a9"),
        I.GetIndexedField(I.col("a"), -1).alias("am"), I.GetIndexedField(I.col("nn"), 1).alias("nn1"),
        I.GetMapValue(I.col("m"), "y").alias("my"), I.GetMapValue(I.col("m"), "toolongkey").alias("mlong"),
        I.GetStructField(I.col("st"), "s").alias("ss"), I.GetStructField(I.col("st"), "x").alias("sx"),
        I.NamedStruct(["u", "v"], [I.col("id"), I.lit(5)]).alias("ns"),
        f("make_array", [I.col("id"), I.lit(None)]).alias("ma"),
        f("make_array", [I.GetStructField(I.col("st"), "s"), I.lit("k")]).alias("mas"),
        f("size", [I.col("a")]).alias("sz"), f("cardinality", [I.col("m")]).alias("card"),
        f("map_keys", [I.col("m")]).alias("mk"), f("map_values", [I.col("m")]).alias("mv"),
        f("array_contains", [I.col("a"), I.lit(30)]).alias("ac"),
        f("array_contains", [I.col("a"), I.lit(999)]).alias("ac2"),
        f("array_contains", [f("map_keys", [I.col("m")]), I.lit("y")]).alias("acs"),
        f("array_union", [I.col("a"), f("make_array", [I.lit(20), I.lit(99)])]).alias("au"),
        f("brickhouse_array_union", [I.col("a"), I.col("a")]).alias("bau"),
        I.Col("nn").get_item(0).alias("nn0"),
    ]


EXPR_NAMES = [e.name for e in _exprs(TI)]


@pytest.fixture(scope="module")
def exprs():
    port = port_rows(ProjectExec(MemoryScanExec([[port_batch()]], schema("port")), _exprs(TI)))
    ref = ref_rows(JProject(JScan([[ref_batch()]], schema("ref")), _exprs(JI)))
    return port, ref


#: row 3 of ``a`` holds a null element: the reference's ``array_union``
#: encodes a null element as its zero data and returns 0 in its place
#: (ROADMAP queue C); the port keeps one null, as Spark does
NULL_ELEMENT_ROW = 3


@pytest.mark.parametrize("name", EXPR_NAMES)
def test_nested_expr_equals_the_reference(exprs, name):
    port, ref = exprs
    if name in ("au", "bau"):
        keep = [i for i in range(len(port[name])) if i != NULL_ELEMENT_ROW]
        assert [port[name][i] for i in keep] == [ref[name][i] for i in keep]
        assert None in port[name][NULL_ELEMENT_ROW] and 0 in ref[name][NULL_ELEMENT_ROW]
    else:
        assert port[name] == ref[name]


def test_nested_expr_values(exprs):
    d = exprs[0]
    assert d["a0"] == [10, None, None, 30, -7] and d["a9"] == [None] * 5
    assert d["my"] == [None, None, None, 2, 6] and d["ss"] == ["hi", None, "yo", None, "zz"]
    assert d["sz"] == [2, -1, 0, 3, 4]  # size(NULL) = -1 (legacy sizeOfNull)
    assert d["ac"] == [False, None, False, True, False]
    assert d["ac2"] == [False, None, False, None, False]  # no match + a null element: null
    assert d["au"][0] == [10, 20, 99] and d["au"][1] is None


def test_nested_expr_proto_bytes_equal_the_reference(exprs):
    b = port_batch()
    for pe, je in zip(_exprs(TI)[:9], _exprs(JI)[:9]):
        raw = to_proto.expr_to_proto(pe).encode()
        assert raw == jax_to_proto.expr_to_proto(je).SerializeToString()
        back = from_proto.expr_from_proto(to_proto.pb.ExprNode.decode(raw))
        got = port_rows(ProjectExec(MemoryScanExec([[b]], schema("port")), [back]))
        assert got[pe.name] == exprs[0][pe.name]


# ----------------------------------------------------------- explode

GENERATES = {
    "explode-array": ("explode", "a", False, True), "pos_explode-outer": ("pos_explode", "a", True, True),
    "explode-map": ("explode", "m", False, True), "pos_explode-map-outer": ("pos_explode", "m", True, True),
    "explode-nested": ("explode", "nn", False, False), "explode-floats-outer": ("explode", "fa", True, False),
}


def _generate(pkg, kind, column, outer, keep):
    if pkg == "port":
        scan = MemoryScanExec([[port_batch()]], schema("port"))
        return GenerateExec(scan, NativeGenerator(kind, TI.col(column)), [], outer=outer, keep_input=keep)
    scan = JScan([[ref_batch()]], schema("ref"))
    return JGenerate(scan, JNative(kind, JI.col(column)), [], outer=outer, keep_input=keep)


@pytest.fixture(scope="module")
def generated():
    return {k: (port_rows(_generate("port", *v)), ref_rows(_generate("ref", *v))) for k, v in GENERATES.items()}


@pytest.mark.parametrize("case", list(GENERATES))
def test_explode_equals_the_reference(generated, case):
    port, ref = generated[case]
    assert _canon(port) == _canon(ref)


def test_explode_values(generated):
    d = generated["pos_explode-outer"][0]
    assert d["id"] == [1, 1, 2, 3, 4, 4, 4, 5, 5, 5, 5]
    assert d["pos"] == [0, 1, None, None, 0, 1, 2, 0, 1, 2, 3]
    assert d["col"] == [10, 20, None, None, 30, None, 50, -7, 10, -7, 20]
    d = generated["explode-map"][0]
    assert d["key"] == ["x", "y", "z", "x", "y", "w", "v"] and d["value"] == [1, 2, None, 5, 6, 7, 8]


@pytest.mark.parametrize("case", ["explode-array", "pos_explode-map-outer"])
def test_explode_proto_bytes_equal_the_reference(generated, case):
    plan = _generate("port", *GENERATES[case])
    msg = to_proto.plan_to_proto(plan)
    rt = from_proto.plan_from_proto(msg)
    assert _canon(port_rows(rt)) == _canon(generated[case][0])
    # the memory scans' resource ids differ; the generate nodes do not
    jmsg = jax_to_proto.plan_to_proto(_generate("ref", *GENERATES[case]))
    assert msg.generate.native_kind == jmsg.generate.native_kind
    assert msg.generate.native_expr.encode() == jmsg.generate.native_expr.SerializeToString()
    assert [f.encode() for f in msg.generate.gen_fields] == [f.SerializeToString() for f in jmsg.generate.gen_fields]
    assert (msg.generate.outer, msg.generate.keep_input) == (jmsg.generate.outer, jmsg.generate.keep_input)


def test_explode_in_a_fused_chain_rebuckets():
    from blaze_tpu_torch.ops.fusion import FusedStageExec, optimize_plan

    scan = MemoryScanExec([[port_batch()]], schema("port"))
    proj = ProjectExec(scan, [TI.col("id"), TI.ScalarFunc("map_values", [TI.col("m")]).alias("mv")])
    gen = GenerateExec(proj, NativeGenerator("explode", TI.col("mv")), [])
    plan = optimize_plan(ProjectExec(gen, [(TI.col("col") + TI.lit(1)).alias("c1"), TI.col("id")]))
    assert isinstance(plan, FusedStageExec)
    out = list(plan.execute(0, TaskContext(0, 1)))
    # cap * M rows, a bucket already here (M = 4): kept as the reference keeps it
    assert all(b.capacity == TB.bucket_capacity(b.capacity) for b in out)
    d = TB.batch_to_pydict(out[0])
    assert d["c1"] == [2, 3, None, 6, 7, 8, 9] and d["id"] == [1, 4, 4, 5, 5, 5, 5]


def test_json_tuple_equals_the_reference():
    docs = ['{"a":1,"b":"x"}', None, "not json", '{"b":[1,2],"a":{"c":null}}', "[1]"]
    outs = []
    for T, F, S, B, Scan, Gen, jt, to_dict, rows in (
            (TT, TF, TS, lambda d, s: TB.batch_from_pydict(d, s, device="cpu"), MemoryScanExec, GenerateExec,
             json_tuple_generator, TB.batch_to_pydict, port_rows),
            (JT, JF, JS, JB.batch_from_pydict, JScan, JGenerate, jax_json_tuple, JB.batch_to_pydict, ref_rows)):
        sch = S([F("j", T.string(64))])
        I = TI if T is TT else JI
        gen = Gen(Scan([[B({"j": docs}, sch)]], sch), jt(["a", "b"]), [I.col("j")],
                  [F("a", T.string(16)), F("b", T.string(16))], outer=True)
        outs.append(rows(gen))
    assert outs[0] == outs[1]
    assert outs[0]["b"] == ["x", None, None, "[1,2]", None]


# ------------------------------------------------------ collect aggs

AGG_DATA = {
    "g": [1, 2, 1, 1, 2, 3, 1, 3, 2],
    "v": [10, 20, 10, None, 40, 50, 30, -5, 20],
    "s": ["a", "b", "a", "c", None, "d", "a", "dd", "b"],
    "f": [0.0, 1.0, -0.0, float("nan"), None, 2.0, float("nan"), 2.0, 1.0],
}


def agg_schema(pkg):
    T, F, S = PKG[pkg]
    return S([F("g", T.int32()), F("v", T.int64()), F("s", T.string(8)), F("f", T.float64())])


COLLECTS = [("collect_list", "v", "cl"), ("collect_set", "v", "cs"), ("collect_list", "s", "sl"),
            ("collect_set", "s", "ss"), ("collect_set", "f", "fs"), ("brickhouse_collect", "v", "bc"),
            ("brickhouse_combine_unique", "s", "bu")]


def _collect_plan(pkg, grouped: bool, split: int):
    I, Scan, Agg, AF, Mode, GE = ((TI, MemoryScanExec, AggExec, AggFunction, AggMode, GroupingExpr) if pkg == "port"
                                  else (JI, JScan, JAgg, JAF, JMode, JGE))
    mk = (lambda d: port_batch(d, agg_schema("port"))) if pkg == "port" else (lambda d: ref_batch(d, agg_schema("ref")))
    parts = [{k: v[:split] for k, v in AGG_DATA.items()}, {k: v[split:] for k, v in AGG_DATA.items()}]
    fns = [AF(fn, I.col(c), name) for fn, c, name in COLLECTS]
    groups = [GE(I.col("g"), "g")] if grouped else []
    src = Scan([[mk(p) for p in parts]], agg_schema(pkg))
    return Agg(Agg(src, Mode.PARTIAL, groups, fns), Mode.FINAL, groups, fns)


@pytest.fixture(scope="module")
def collected():
    return port_rows(_collect_plan("port", True, 4)), ref_rows(_collect_plan("ref", True, 4))


@pytest.mark.parametrize("name", [c[2] for c in COLLECTS])
def test_collect_equals_the_reference(collected, name):
    port, ref = collected
    assert _canon(port[name]) == _canon(ref[name])


def test_global_collect_merges_both_batches():
    """No groups: one array a state, the two batches' states appended in
    arrival order at the merge, the set deduplicated over both."""
    d = port_rows(_collect_plan("port", False, 4))
    assert d["cl"] == [[10, 20, 10, 40, 50, 30, -5, 20]] and d["bc"] == d["cl"]
    assert d["cs"] == [[10, 20, 30, 40, 50, -5]] and d["ss"] == [["a", "b", "c", "d", "dd"]] == d["bu"]
    assert _canon(d["fs"]) == [["0.0", "1.0", "2.0", "nan"]]
    sch = agg_schema("port")
    empty = AggExec(AggExec(MemoryScanExec([[]], sch, device="cpu"), AggMode.PARTIAL, [],
                            [AggFunction("collect_list", TI.col("v"), "cl")]),
                    AggMode.FINAL, [], [AggFunction("collect_list", TI.col("v"), "cl")])
    assert port_rows(empty) == {"cl": [[]]}  # a global collect over no rows: one empty array


def test_collect_values(collected):
    d = collected[0]
    assert d["g"] == [1, 2, 3]
    assert d["cl"] == [[10, 10, 30], [20, 40, 20], [50, -5]]  # input order, nulls skipped
    assert d["cs"] == [[10, 30], [20, 40], [50, -5]]  # unsigned word order: -5 after 50
    assert [sorted(x) for x in d["ss"]] == [["a", "c"], ["b"], ["d", "dd"]]
    assert _canon(d["fs"][0]) == ["0.0", "nan"]  # -0.0 and 0.0 one element, NaNs one


def test_collect_merge_of_states_keeps_arrival_order():
    """Three batches of one partition: each batch's state appends in
    arrival order at the merge."""
    sch = agg_schema("port")
    parts = [port_batch({k: v[i:i + 3] for k, v in AGG_DATA.items()}, sch) for i in (0, 3, 6)]
    fns = [AggFunction("collect_list", TI.col("v"), "cl")]
    g = [GroupingExpr(TI.col("g"), "g")]
    plan = AggExec(AggExec(MemoryScanExec([parts], sch), AggMode.PARTIAL, g, fns), AggMode.FINAL, g, fns)
    assert port_rows(plan)["cl"] == [[10, 10, 30], [20, 40, 20], [50, -5]]


def test_collect_max_elems_drops_past_the_budget():
    n = 100
    data = {"g": [1] * n, "v": list(range(n)), "s": ["x"] * n, "f": [1.0] * n}
    plan_data = port_batch(data, agg_schema("port"))
    fns = [AggFunction("collect_list", TI.col("v"), "cl")]
    g = [GroupingExpr(TI.col("g"), "g")]
    old = conf.COLLECT_MAX_ELEMS.get()
    conf.COLLECT_MAX_ELEMS.set(8)
    try:
        plan = AggExec(AggExec(MemoryScanExec([[plan_data]], agg_schema("port")), AggMode.PARTIAL, g, fns),
                       AggMode.FINAL, g, fns)
        assert plan.schema.field("cl").dtype == TT.array(TT.int64(), 8)
        assert port_rows(plan)["cl"] == [list(range(8))]
    finally:
        conf.COLLECT_MAX_ELEMS.set(old)
    plan = AggExec(AggExec(MemoryScanExec([[plan_data]], agg_schema("port")), AggMode.PARTIAL, g, fns),
                   AggMode.FINAL, g, fns)
    assert port_rows(plan)["cl"] == [list(range(64))]


def test_collect_set_of_a_map_is_refused_like_spark():
    for art, T in ((agg_result_type, TT), (jax_agg_result_type, JT)):
        with pytest.raises(NotImplementedError, match="[Mm]ap"):
            art("collect_set", T.map(T.string(8), T.int64(), 4))
        assert art("collect_list", T.map(T.string(8), T.int64(), 4)).max_elems == 64


def _two_stage(rows, value_t, fn, exchange: bool = True):
    sch = TS([TF("g", TT.int64()), TF("v", value_t)])
    data = {"g": [r[0] for r in rows], "v": [r[1] for r in rows]}
    half = len(rows) // 2
    parts = [[port_batch({k: v[:half] for k, v in data.items()}, sch)],
             [port_batch({k: v[half:] for k, v in data.items()}, sch)]]
    plan = two_stage_agg(MemoryScanExec(parts, sch), [GroupingExpr(TI.col("g"), "g")],
                         [AggFunction(fn, TI.col("v"), "out")], 2)
    got = {}
    for p in range(plan.num_partitions()):
        for b in plan.execute(p, TaskContext(p, plan.num_partitions())):
            d = TB.batch_to_pydict(b)
            got.update(zip(d["g"], d["out"]))
    return got


def _key(v):
    if isinstance(v, list):
        return ("L",) + tuple(_key(x) for x in v)
    if isinstance(v, dict):
        return ("D",) + tuple(sorted((k, _key(x)) for k, x in v.items()))
    return v


A3 = TT.array(TT.int64(), 3)
ELEMENT_CASES = {
    "array": (A3, [(0, [1, 2]), (0, [1, 2]), (0, [2, 1]), (0, []), (1, [3]), (1, [3, None]), (1, [3, None]),
                   (1, None), (2, [1, 2]), (2, []), (2, [1, 2, 3])]),
    "list-of-lists": (TT.array(TT.array(TT.int64(), 3), 3),
                      [(0, [[1], [2]]), (0, [[1], [2]]), (0, [[1, 2]]), (0, [[2], [1]]), (1, [[]]), (1, []),
                       (1, None), (1, [[]]), (2, [[1, None]]), (2, [[1, None]]), (2, [[1]]), (2, [[None, 1]])]),
    "list-of-structs": (TT.array(TT.struct([TF("a", TT.int64()), TF("s", TT.string(8))]), 3),
                        [(0, [{"a": 1, "s": "x"}]), (0, [{"a": 1, "s": "x"}]), (0, [{"a": 1, "s": "y"}]),
                         (0, [{"a": None, "s": "x"}]), (1, [{"a": 2, "s": None}]), (1, [{"a": 2, "s": None}]),
                         (1, [{"a": 2, "s": "z"}, {"a": 3, "s": "w"}]), (1, [{"a": 3, "s": "w"}, {"a": 2, "s": "z"}])]),
    "list-of-strings": (TT.array(TT.string(8), 3),
                        [(0, ["ab"]), (0, ["ab"]), (0, ["abc"]), (0, ["ab", "cd"]), (1, ["x", None]),
                         (1, ["x", None]), (1, [None, "x"]), (1, [])]),
    "wide-array": (TT.array(TT.int64(), 70),
                   [(0, list(range(70))), (0, list(range(70))), (0, list(range(66)) + [None] + list(range(67, 70))),
                    (0, list(range(67)) + [None] + list(range(68, 70))), (0, list(range(69)) + [999]),
                    (1, list(range(65))), (1, list(range(65))), (1, list(range(66)))]),
    "struct": (TT.struct([TF("a", TT.int64()), TF("s", TT.string(8))]),
               [(0, {"a": 1, "s": "x"}), (0, {"a": 1, "s": "x"}), (0, None), (1, {"a": None, "s": None}),
                (1, {"a": None, "s": "q"}), (1, {"a": None, "s": None})]),
}


@pytest.mark.parametrize("fn", ["collect_list", "collect_set"])
@pytest.mark.parametrize("case", list(ELEMENT_CASES))
def test_collect_over_nested_elements_through_a_shuffle(case, fn):
    value_t, rows = ELEMENT_CASES[case]
    got = _two_stage(rows, value_t, fn)
    want = {}
    for g, v in rows:
        if v is not None:  # collect skips null rows (Spark)
            want.setdefault(g, []).append(_key(v))
    assert set(got) == set(want)
    for g, vals in want.items():
        if fn == "collect_set":
            assert sorted(map(repr, {_key(x) for x in got[g]})) == sorted(map(repr, set(vals))), g
            assert len(got[g]) == len(set(vals))
        else:
            assert sorted(map(repr, (_key(x) for x in got[g]))) == sorted(map(repr, vals)), g


def test_nested_columns_through_a_shuffle():
    ex = NativeShuffleExchangeExec(MemoryScanExec([[port_batch()]], schema("port")),
                                   HashPartitioning([TI.col("id")], 3))
    rows = []
    for p in range(3):
        for ob in ex.execute(p, TaskContext(p, 3)):
            d = TB.batch_to_pydict(ob)
            rows += [repr(_canon([d[k][i] for k in DATA])) for i in range(ob.num_rows)]
    want = [repr(_canon([DATA[k][i] for k in DATA])) for i in range(len(DATA["id"]))]
    assert sorted(rows) == sorted(want)
    with pytest.raises(NotImplementedError, match="nested"):
        bad = NativeShuffleExchangeExec(MemoryScanExec([[port_batch()]], schema("port")),
                                        HashPartitioning([TI.col("a")], 3))
        list(bad.execute(0, TaskContext(0, 3)))
    from blaze_tpu_torch.ops import SortExec, SortField

    for plan in (SortExec(MemoryScanExec([[port_batch()]], schema("port")), [SortField(TI.col("st"))]),
                 AggExec(MemoryScanExec([[port_batch()]], schema("port")), AggMode.PARTIAL,
                         [GroupingExpr(TI.col("a"), "a")], [AggFunction("count_star", None, "n")])):
        with pytest.raises(NotImplementedError, match="nested"):
            port_rows(plan)


def test_reference_json_tuple_generator_does_not_pickle():
    """Reference defect 17: the reference's ``json_tuple_generator``
    returns a closure, which pickle refuses, so a plan holding it cannot
    be written as a TaskDefinition there; the port's pickles, and its
    plan travels the wire."""
    import pickle

    with pytest.raises((AttributeError, pickle.PicklingError)):
        pickle.dumps(jax_json_tuple(["a"]))
    sch = TS([TF("j", TT.string(32))])
    docs = ['{"a":"x"}', None, '{"a":[1]}']
    gen = GenerateExec(MemoryScanExec([[port_batch({"j": docs}, sch)]], sch), json_tuple_generator(["a"]),
                       [TI.col("j")], [TF("a", TT.string(16))])
    back = from_proto.plan_from_proto(to_proto.pb.PhysicalPlanNode.decode(to_proto.plan_to_proto(gen).encode()))
    assert port_rows(back) == port_rows(gen) == {"j": docs, "a": ["x", None, "[1]"]}


def test_nested_columns_ride_through_every_row_gather():
    """Sort, limit, union, expand, window (pass-through and lead over an
    array), a filter and a shuffled join: each moves whole nested rows."""
    from blaze_tpu_torch.ops import (
        ExpandExec, FilterExec, LimitExec, SortExec, SortField, UnionExec, WindowExec, WindowFunction,
    )
    from blaze_tpu_torch.ops.joins import JoinType
    from blaze_tpu_torch.tpch.queries import shuffle_join

    rows = [[DATA[k][i] for k in DATA] for i in range(len(DATA["id"]))]
    canon_rows = lambda d: sorted(repr(_canon([d[k][i] for k in DATA])) for i in range(len(d["id"])))
    scan = lambda: MemoryScanExec([[port_batch()]], schema("port"))
    by_id_desc = port_rows(SortExec(scan(), [SortField(TI.col("id"), False, False)]))
    assert _canon([by_id_desc[k] for k in DATA]) == _canon([[r[j] for r in rows[::-1]] for j in range(len(DATA))])
    top2 = port_rows(LimitExec(SortExec(scan(), [SortField(TI.col("id"), True, False)]), 2))
    assert top2["nn"] == DATA["nn"][:2] and top2["st"] == DATA["st"][:2]
    both = port_rows(UnionExec([scan(), scan()]))
    assert canon_rows(both) == sorted(canon_rows(DATA) * 2)
    names = list(DATA)
    exp = port_rows(ExpandExec(scan(), [[TI.col(n) for n in names], [TI.col(n) for n in names]], names))
    assert canon_rows(exp) == sorted(canon_rows(DATA) * 2)
    win = port_rows(WindowExec(scan(), [WindowFunction("lead", "next_a", TI.col("a")),
                                        WindowFunction("row_number", "rn")], [], [SortField(TI.col("id"), True, False)]))
    assert win["a"] == DATA["a"] and win["st"] == DATA["st"]
    assert win["next_a"] == DATA["a"][1:] + [None] and win["rn"] == [1, 2, 3, 4, 5]
    odd = port_rows(FilterExec(scan(), TI.col("id") % TI.lit(2) == TI.lit(1)))
    assert _canon(odd["fa"]) == _canon(DATA["fa"][0::2]) and odd["m"] == DATA["m"][0::2]
    keys = TS([TF("kid", TT.int32()), TF("tag", TT.string(8))])
    right = MemoryScanExec([[port_batch({"kid": [4, 1, 9], "tag": ["d", "a", "z"]}, keys)]], keys)
    joined = port_rows(shuffle_join(scan(), right, [TI.col("id")], [TI.col("kid")], JoinType.INNER, 3))
    got = sorted(zip(joined["id"], map(repr, joined["nn"]), map(repr, joined["m"]), joined["tag"]))
    assert got == [(1, repr(DATA["nn"][0]), repr(DATA["m"][0]), "a"), (4, repr(DATA["nn"][3]), repr(DATA["m"][3]), "d")]


def test_pickled_generator_gate():
    from blaze_tpu_torch import conf as tconf

    sch = TS([TF("j", TT.string(32))])
    gen = GenerateExec(MemoryScanExec([[port_batch({"j": ['{"a":"x"}']}, sch)]], sch), json_tuple_generator(["a"]),
                       [TI.col("j")], [TF("a", TT.string(16))])
    raw = to_proto.plan_to_proto(gen).encode()
    tconf.ALLOW_PICKLED_UDFS.set(False)
    try:
        with pytest.raises(PermissionError, match="allowPickled"):
            from_proto.plan_from_proto(to_proto.pb.PhysicalPlanNode.decode(raw))
    finally:
        tconf.ALLOW_PICKLED_UDFS.set(True)
    from blaze_tpu_torch.runtime.context import RESOURCES

    for key in list(RESOURCES.keys()):  # the scan staged by the refused decode
        RESOURCES.get(key)
