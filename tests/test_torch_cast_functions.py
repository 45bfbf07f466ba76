"""Casts, the scalar functions, the host LIKE evaluator and joins with
no build rows: the port against the JAX package and Python.

- ``Cast`` over every ported route (integer widening and wrapping
  narrowing, integer/float/decimal -> decimal with HALF_UP and overflow
  to null, decimal -> integer/float, float -> integer with Java's
  clamping, dates), on seeded vectors with nulls and overflow;
- ``year``/``month``/``day`` across leap years and negative days;
- ``substring`` with positions past the end, and with positions <= 0,
  where the reference reads the padded width (ROADMAP queue C,
  reference defect 10) and the port follows Spark;
- LIKE patterns with ``_`` and with several segments, negated or not,
  in a filter and in a projection, alone and nested (the host
  evaluator);
- each join type with an empty build side, broadcast and shuffled.

Every comparison is exact.
"""

import datetime
import math
import re

import numpy as np
import pytest

import blaze_tpu.batch as JB
import blaze_tpu.exprs.compile as JC
from blaze_tpu.batch import batch_to_pydict as jax_to_pydict
from blaze_tpu.exprs import col as jcol, lit as jlit
from blaze_tpu.exprs.ir import Like as JLike, func as jfunc
from blaze_tpu.ops import FilterExec as JFilter, MemoryScanExec as JaxScan, ProjectExec as JProject
from blaze_tpu.ops.joins import JoinType as JJoinType
from blaze_tpu.tpch import queries as JQ
from blaze_tpu.runtime.context import TaskContext as JaxContext
from blaze_tpu.schema import DataType as JT, Field as JF, Schema as JSchema
from blaze_tpu.tpch.datagen import table_to_batches as jax_table_to_batches

import blaze_tpu_torch.batch as TB
import blaze_tpu_torch.exprs.compile as TC
from blaze_tpu_torch.batch import batch_to_pydict, table_to_batches
from blaze_tpu_torch.exprs import col as tcol, func as tfunc, lit as tlit
from blaze_tpu_torch.exprs.ir import Like
from blaze_tpu_torch.ops import FilterExec, MemoryScanExec, ProjectExec
from blaze_tpu_torch.ops.joins import JoinType
from blaze_tpu_torch.tpch import queries as Q
from blaze_tpu_torch.runtime.context import TaskContext
from blaze_tpu_torch.schema import DataType as TT, Field as TF, Schema as TSchema

CPU = "cpu"
N = 400


def lower_both(texpr, jexpr, fields, arrays, valids):
    """Both packages' lowering of one expression: the same type and the
    same values (None where null); returns the port's."""
    n = len(next(iter(arrays.values())))
    tenv, jenv = {}, {}
    for nm, tt, jt in fields:
        if tt.is_string:
            vals = [s if ok else None for s, ok in zip(arrays[nm], valids[nm])]
            tenv[nm] = TB.column_from_strings(vals, width=tt.string_width, capacity=n, device=CPU)
            jenv[nm] = JB.column_from_strings(vals, width=jt.string_width, capacity=n).to_device()
        else:
            tenv[nm] = TB.column_from_numpy(tt, arrays[nm], valids[nm], capacity=n, device=CPU)
            jenv[nm] = JB.column_from_numpy(jt, arrays[nm], valids[nm], capacity=n).to_device()
    tc = TC.lower(texpr, TSchema([TF(nm, tt) for nm, tt, _ in fields]), tenv, n)
    jc = JC.lower(jexpr, JSchema([JF(nm, jt) for nm, _, jt in fields]), jenv, n)
    assert repr(tc.dtype) == repr(jc.dtype)
    got, want = TB.column_to_pylist(tc, n), JB.column_to_pylist(jc, n)
    assert [repr(v) for v in got] == [repr(v) for v in want]
    return got


# ------------------------------------------------------------------ casts

_SPECIAL_FLOATS = [np.nan, np.inf, -np.inf, 0.5, -0.5, 1.5, -2.5, 2.5, 0.0, -0.0, 127.9, -128.9, 3e9, -3e9,
                   1e19, -1e19, 9.2e18, 12345.675, -0.005, 0.015]

_SOURCES = {
    "int8": (TT.int8(), JT.int8(), lambda r: r.integers(-128, 128, N).astype(np.int8)),
    "int32": (TT.int32(), JT.int32(), lambda r: np.concatenate(
        [[2**31 - 1, -(2**31), 0, 99999], r.integers(-(2**31), 2**31, N - 4)]).astype(np.int32)),
    "int64": (TT.int64(), JT.int64(), lambda r: np.concatenate(
        [[2**63 - 1, -(2**63), 2**31, -(2**31) - 1, 10**10, -(10**10)],
         r.integers(-(10**12), 10**12, N - 6)]).astype(np.int64)),
    "float64": (TT.float64(), JT.float64(), lambda r: np.concatenate(
        [_SPECIAL_FLOATS, r.standard_normal(N - len(_SPECIAL_FLOATS)) * 10.0 ** r.integers(0, 12, N - 20)])),
    "float32": (TT.float32(), JT.float32(), lambda r: np.concatenate(
        [_SPECIAL_FLOATS, r.standard_normal(N - len(_SPECIAL_FLOATS)) * 1e4]).astype(np.float32)),
    "decimal(12,2)": (TT.decimal(12, 2), JT.decimal(12, 2), lambda r: np.concatenate(
        [[10**12 - 1, -(10**12) + 1, 5, -5, 15, -15, 50, -50], r.integers(-(10**12) + 1, 10**12, N - 8)])),
    "decimal(18,6)": (TT.decimal(18, 6), JT.decimal(18, 6), lambda r: np.concatenate(
        [[10**18 - 1, -(10**18) + 1, 500, -500, 1500000], r.integers(-(10**18) + 1, 10**18, N - 5)])),
    "date32": (TT.date32(), JT.date32(), lambda r: r.integers(-800000, 3000000, N).astype(np.int32)),
    "bool": (TT.bool_(), JT.bool_(), lambda r: r.integers(0, 2, N).astype(np.bool_)),
}
_TARGETS = {
    "int8": (TT.int8(), JT.int8()), "int16": (TT.int16(), JT.int16()), "int32": (TT.int32(), JT.int32()),
    "int64": (TT.int64(), JT.int64()), "float32": (TT.float32(), JT.float32()),
    "float64": (TT.float64(), JT.float64()), "date32": (TT.date32(), JT.date32()),
    "decimal(10,0)": (TT.decimal(10, 0), JT.decimal(10, 0)), "decimal(12,2)": (TT.decimal(12, 2), JT.decimal(12, 2)),
    "decimal(7,3)": (TT.decimal(7, 3), JT.decimal(7, 3)), "decimal(16,6)": (TT.decimal(16, 6), JT.decimal(16, 6)),
    "decimal(12,1)": (TT.decimal(12, 1), JT.decimal(12, 1)),
}
ROUTES = [
    # integer widening, wrapping narrowing, to float
    ("int8", "int64"), ("int32", "int8"), ("int64", "int32"), ("int64", "int16"), ("int32", "float64"),
    ("int64", "float32"), ("bool", "int32"),
    # integer / float / decimal -> decimal: HALF_UP, overflow to null
    ("int32", "decimal(10,0)"), ("int32", "decimal(7,3)"), ("int64", "decimal(12,2)"), ("bool", "decimal(7,3)"),
    ("float64", "decimal(12,2)"), ("float64", "decimal(7,3)"), ("float32", "decimal(12,2)"),
    ("decimal(12,2)", "decimal(16,6)"), ("decimal(12,2)", "decimal(7,3)"), ("decimal(12,2)", "decimal(12,1)"),
    ("decimal(18,6)", "decimal(12,2)"), ("decimal(18,6)", "decimal(10,0)"),
    # decimal -> integer (truncation, wrapping) and float
    ("decimal(12,2)", "int64"), ("decimal(12,2)", "int32"), ("decimal(18,6)", "int16"),
    ("decimal(12,2)", "float64"), ("decimal(18,6)", "float64"), ("decimal(12,2)", "float32"),
    # float -> integer: truncation, NaN -> 0, clamping
    ("float64", "int32"), ("float64", "int8"), ("float64", "int64"), ("float32", "int16"), ("float32", "float64"),
    ("float64", "float32"), ("float64", "date32"),
    # dates
    ("date32", "int32"), ("date32", "int64"), ("int32", "date32"),
]


def _java_float_to_int(x: float, bits: int) -> int:
    lo, hi = -(2 ** (bits - 1)), 2 ** (bits - 1) - 1
    if math.isnan(x):
        return 0
    return hi if x >= hi else lo if x <= lo else int(x)


def _half_up(num: int, den: int) -> int:
    q = (abs(num) + den // 2) // den
    return -q if num < 0 else q


@pytest.mark.parametrize("route", ROUTES, ids=[f"{a}->{b}" for a, b in ROUTES])
def test_cast_route_matches_reference(route):
    src, dst = route
    tt, jt, gen = _SOURCES[src]
    rng = np.random.default_rng(sum(map(ord, src + dst)))
    vals, valid = gen(rng), rng.random(N) > 0.15
    valid[:len(_SPECIAL_FLOATS)] = True
    if src == "int64" and dst.startswith("decimal"):
        # int64's extremes wrap in the reference (pinned below, defect 11)
        valid[:2] = False
    to_t, to_j = _TARGETS[dst]
    got = lower_both(tcol("x").cast(to_t), jcol("x").cast(to_j), [("x", tt, jt)], {"x": vals}, {"x": valid})
    assert sum(v is None for v in got) >= (~valid).sum()
    # the same values from Python integers and floats, route by route
    for v, ok, g in zip(vals.tolist(), valid, got):
        if not ok:
            assert g is None
        elif to_t.is_decimal and src.startswith("decimal"):
            e = _half_up(v * 10**to_t.scale, 10**tt.scale) if to_t.scale < tt.scale else v * 10 ** (to_t.scale - tt.scale)
            assert g == (e if abs(e) < 10**to_t.precision else None)
        elif to_t.is_decimal and src.startswith(("int", "bool")):
            e = int(v) * 10**to_t.scale
            assert g == (e if abs(e) < 10**to_t.precision else None)
        elif src.startswith("decimal") and to_t.is_integer:
            t = abs(v) // 10**tt.scale * (1 if v >= 0 else -1)
            bits = {"int16": 16, "int32": 32, "int64": 64}[dst]
            assert g == (t + 2 ** (bits - 1)) % 2**bits - 2 ** (bits - 1)
        elif src.startswith("float") and to_t.is_integer:
            assert g == _java_float_to_int(float(v), {"int8": 8, "int16": 16, "int32": 32, "int64": 64}[dst])
        elif src.startswith("int") and to_t.is_integer:
            bits = {"int8": 8, "int16": 16, "int32": 32, "int64": 64}[dst]
            assert g == (v + 2 ** (bits - 1)) % 2**bits - 2 ** (bits - 1)


def test_cast_overflows_and_rounds_on_the_sample_values():
    """Spot values: HALF_UP away from zero, decimal overflow to null,
    NaN -> null as a decimal and 0 as an integer, infinities clamp."""
    vals = np.array([2.5, -2.5, 0.015, -0.005, np.nan, np.inf, -np.inf, 1e19, 99999999.995])
    valid = np.ones(len(vals), bool)
    f = [("x", TT.float64(), JT.float64())]
    dec = lower_both(tcol("x").cast(TT.decimal(12, 2)), jcol("x").cast(JT.decimal(12, 2)), f, {"x": vals}, {"x": valid})
    assert dec == [250, -250, 2, -1, None, None, None, None, 10**10]
    ints = lower_both(tcol("x").cast(TT.int32()), jcol("x").cast(JT.int32()), f, {"x": vals}, {"x": valid})
    assert ints == [2, -2, 0, 0, 0, 2**31 - 1, -(2**31), 2**31 - 1, 99999999]


def test_int64_to_decimal_past_int64_is_null_where_the_reference_wraps():
    """Reference defect 11: the reference multiplies an int64 by
    ``10^scale`` with no check, so 2^63 - 1 cast to decimal(12,2) wraps
    to -1.00; Spark (and the port) give null, as for any overflow."""
    vals = np.array([2**63 - 1, -(2**63), 2**62, 10**10, -5])
    tenv = {"x": TB.column_from_numpy(TT.int64(), vals, device=CPU)}
    jenv = {"x": JB.column_from_numpy(JT.int64(), vals).to_device()}
    got = TC.lower(tcol("x").cast(TT.decimal(12, 2)), TSchema([TF("x", TT.int64())]), tenv, 5)
    ref = JC.lower(jcol("x").cast(JT.decimal(12, 2)), JSchema([JF("x", JT.int64())]), jenv, 5)
    assert TB.column_to_pylist(got, 5) == [None, None, None, None, -500]
    assert JB.column_to_pylist(ref, 5)[:2] == [-100, 0] and JB.column_to_pylist(ref, 5)[3:] == [None, -500]


# ------------------------------------------------------------ date parts

_DATES = [datetime.date(y, m, d) for y, m, d in (
    (1970, 1, 1), (1969, 12, 31), (2000, 2, 29), (2000, 3, 1), (1900, 2, 28), (1900, 3, 1), (1600, 2, 29),
    (2024, 2, 29), (2100, 2, 28), (2100, 3, 1), (1, 1, 1), (9999, 12, 31), (1582, 10, 4), (1992, 1, 1),
    (1998, 12, 31), (1804, 2, 29))]


def test_year_month_day_match_reference_and_calendar():
    rng = np.random.default_rng(60)
    epoch = datetime.date(1970, 1, 1)
    days = np.concatenate([[(d - epoch).days for d in _DATES],
                           rng.integers((datetime.date(1, 1, 1) - epoch).days,
                                        (datetime.date(9999, 12, 31) - epoch).days, N)]).astype(np.int32)
    valid = rng.random(len(days)) > 0.1
    valid[:len(_DATES)] = True
    fields = [("d", TT.date32(), JT.date32())]
    parts = {name: lower_both(tfunc(name, tcol("d")), jfunc(name, jcol("d")), fields, {"d": days}, {"d": valid})
             for name in ("year", "month", "day")}
    assert (days < 0).sum() > N // 10
    for i, (x, ok) in enumerate(zip(days.tolist(), valid)):
        want = epoch + datetime.timedelta(days=x)
        got = (parts["year"][i], parts["month"][i], parts["day"][i])
        assert got == ((want.year, want.month, want.day) if ok else (None, None, None))


# ------------------------------------------------------------- substring

_STRS = ["", "a", "ab", "abc", "13-555-123-4567", "hello world", "x" * 15, "PROMO BRUSHED", "zz"]


def spark_substring(s: str, pos: int, length=None):
    """UTF8String.substringSQL over bytes."""
    b = s.encode()
    start = pos - 1 if pos > 0 else len(b) + pos if pos < 0 else 0
    end = start + length if length is not None else len(b)
    start = max(start, 0)
    return "" if start >= end else b[start:end].decode()


def _substring_args(pos, length):
    targs = (tlit(pos),) if length is None else (tlit(pos), tlit(length))
    jargs = (jlit(pos),) if length is None else (jlit(pos), jlit(length))
    return tfunc("substring", tcol("s"), *targs), jfunc("substring", jcol("s"), *jargs)


@pytest.mark.parametrize("pos,length", [(1, 2), (2, 3), (1, None), (3, None), (5, 100), (14, 4), (16, 2),
                                       (40, 3), (1, 0), (1, 20), (-20, None)])
def test_substring_matches_reference_and_spark(pos, length):
    """A position before every string's start with no length takes the
    whole string, where the reference agrees with Spark."""
    rng = np.random.default_rng(61 + pos)
    arrays = {"s": [_STRS[i] for i in rng.integers(0, len(_STRS), 200)]}
    valids = {"s": rng.random(200) > 0.1}
    texpr, jexpr = _substring_args(pos, length)
    got = lower_both(texpr, jexpr, [("s", TT.string(16), JT.string(16))], arrays, valids)
    assert got == [spark_substring(s, pos, length) if ok else None for s, ok in zip(arrays["s"], valids["s"])]


@pytest.mark.parametrize("pos,length", [(0, 2), (0, None), (-1, None), (-3, 2), (-4, 10), (-20, 18), (-2, 1)])
def test_substring_from_the_end_follows_spark_where_the_reference_reads_the_padding(pos, length):
    """Reference defect 10: the reference starts a position <= 0 at
    ``W + pos`` of the padded width W, so "abc" with W = 16 gives "" for
    every such position; Spark (and the port) count from each string's
    own end, and 0 acts as 1."""
    strs = ["abc", "13-555-123-4567", "", "hello world"]
    texpr, jexpr = _substring_args(pos, length)
    n = len(strs)
    tenv = {"s": TB.column_from_strings(strs, width=16, capacity=n, device=CPU)}
    jenv = {"s": JB.column_from_strings(strs, width=16, capacity=n).to_device()}
    got = TB.column_to_pylist(TC.lower(texpr, TSchema([TF("s", TT.string(16))]), tenv, n), n)
    ref = JB.column_to_pylist(JC.lower(jexpr, JSchema([JF("s", JT.string(16))]), jenv, n), n)
    assert got == [spark_substring(s, pos, length) for s in strs]

    def reference(s, width=16):
        start = pos - 1 if pos > 0 else max(0, width + pos)
        n = max(0, min(len(s) - start, width if length is None else length))
        return s[start:start + n]

    assert ref == [reference(s) for s in strs]
    assert got != ref


def test_substring_with_a_negative_length_is_empty():
    """Reference defect 10, too: a negative length clips the reference's
    row lengths to -1; Spark (and the port) give the empty string."""
    strs = ["abc", "13-555-123-4567", ""]
    texpr, jexpr = _substring_args(2, -1)
    tenv = {"s": TB.column_from_strings(strs, width=16, capacity=3, device=CPU)}
    jenv = {"s": JB.column_from_strings(strs, width=16, capacity=3).to_device()}
    got = TB.column_to_pylist(TC.lower(texpr, TSchema([TF("s", TT.string(16))]), tenv, 3), 3)
    ref = JB.column_to_pylist(JC.lower(jexpr, JSchema([JF("s", JT.string(16))]), jenv, 3), 3)
    assert got == ["", "", ""] and ref != got


# ------------------------------------------------------------- host LIKE


def _encode_strings(vals, width):
    data = np.zeros((len(vals), width), np.uint8)
    lengths = np.zeros(len(vals), np.int32)
    for i, s in enumerate(vals):
        b = s.encode()
        data[i, :len(b)] = np.frombuffer(b, np.uint8)
        lengths[i] = len(b)
    return data, lengths


def _scan_pair(table, fields, parts, batch_rows):
    ts = TSchema([TF(n, t) for n, t, _ in fields])
    js = JSchema([JF(n, j) for n, _, j in fields])
    return (MemoryScanExec(table_to_batches(table, ts, parts, batch_rows, device=CPU), ts, device=CPU),
            JaxScan(jax_table_to_batches(table, js, parts, batch_rows=batch_rows), js))


def _rows(out):
    return sorted(zip(*out.values()), key=repr)


def _run(p, to_pydict, context):
    out = {f.name: [] for f in p.schema.fields}
    for i in range(p.num_partitions()):
        for b in p.execute(i, context(i, p.num_partitions())):
            for k, v in to_pydict(b).items():
                out[k].extend(v)
    return out

_LIKE_WORDS = ["special requests", "the special big requests", "requests special", "special", "PROMO",
               "PXOMO BRASS", "POMO", "abc", "a-b-c", "ab", "xyz abc", "", "_", "%", "a_c", "天地_x"]
HOST_PATTERNS = ["%special%requests%", "P_OMO%", "a%b%c", "_", "%_%", "a_c", "%a%b%", "__", "天_%", "%\\%"]


def _like_table(seed, n=300):
    rng = np.random.default_rng(seed)
    strs = [_LIKE_WORDS[i] for i in rng.integers(0, len(_LIKE_WORDS), n)]
    return {"s": (*_encode_strings(strs, 32), rng.random(n) > 0.15),
            "k": (rng.integers(-3, 4, n).astype(np.int32), None, None)}, strs


def _python_like(pattern, s):
    rx = "^" + "".join(".*" if ch == "%" else "." if ch == "_" else re.escape(ch) for ch in pattern) + "$"
    return re.match(rx, s, re.DOTALL) is not None


@pytest.mark.parametrize("negated", [False, True], ids=["like", "not-like"])
@pytest.mark.parametrize("pattern", HOST_PATTERNS)
def test_host_like_in_filter_and_project_matches_reference_and_re(pattern, negated):
    table, strs = _like_table(64)
    fields = [("s", TT.string(32), JT.string(32)), ("k", TT.int32(), JT.int32())]
    assert TC.like_needs_host(pattern) or "_" not in pattern and pattern.count("%") < 3
    tscan, jscan = _scan_pair(table, fields, 2, 128)
    # a host part beside a device part in one predicate
    tpred = Like(tcol("s"), pattern, negated) & (tcol("k") > tlit(-2))
    jpred = JLike(jcol("s"), pattern, negated) & (jcol("k") > jlit(-2))
    got = _run(FilterExec(tscan, tpred), batch_to_pydict, TaskContext)
    want = _run(JFilter(jscan, jpred), jax_to_pydict, JaxContext)
    assert got == want
    valid = table["s"][2]
    keep = [i for i in range(len(strs))
            if valid[i] and _python_like(pattern, strs[i]) != negated and table["k"][0][i] > -2]
    assert got["s"] == [strs[i] for i in keep]
    tproj = ProjectExec(tscan, [Like(tcol("s"), pattern, negated).alias("m"), tcol("k")], ["m", "k"])
    jproj = JProject(jscan, [JLike(jcol("s"), pattern, negated).alias("m"), jcol("k")], ["m", "k"])
    got = _run(tproj, batch_to_pydict, TaskContext)
    assert got == _run(jproj, jax_to_pydict, JaxContext)
    assert got["m"] == [(_python_like(pattern, s) != negated) if ok else None for s, ok in zip(strs, valid)]


def test_host_like_nested_under_case_and_not_matches_reference_and_re():
    """``lower`` evaluates a host LIKE wherever it stands: here under NOT
    and AND in a predicate and as a CASE condition in a projection,
    where the reference hoists it out at construction."""
    from blaze_tpu.exprs.ir import Case as JCase
    from blaze_tpu_torch.exprs.ir import Case

    table, strs = _like_table(65, 120)
    fields = [("s", TT.string(32), JT.string(32)), ("k", TT.int32(), JT.int32())]
    tscan, jscan = _scan_pair(table, fields, 2, 64)
    tpred = ~Like(tcol("s"), "%special%requests%") & Like(tcol("s"), "%abc")
    jpred = ~JLike(jcol("s"), "%special%requests%") & JLike(jcol("s"), "%abc")
    got = _run(FilterExec(tscan, tpred), batch_to_pydict, TaskContext)
    assert got == _run(JFilter(jscan, jpred), jax_to_pydict, JaxContext)
    valid = table["s"][2]
    assert got["s"] == [s for s, ok in zip(strs, valid)
                        if ok and not _python_like("%special%requests%", s) and s.endswith("abc")]
    tcase = Case([(Like(tcol("s"), "P_OMO%"), tcol("k"))], tlit(0) - tcol("k")).alias("v")
    jcase = JCase([(JLike(jcol("s"), "P_OMO%"), jcol("k"))], jlit(0) - jcol("k")).alias("v")
    got = _run(ProjectExec(tscan, [tcase], ["v"]), batch_to_pydict, TaskContext)
    assert got == _run(JProject(jscan, [jcase], ["v"]), jax_to_pydict, JaxContext)
    ks = table["k"][0]
    assert got["v"] == [int(k) if ok and _python_like("P_OMO%", s) else -int(k)
                        for s, ok, k in zip(strs, valid, ks)]


# ------------------------------------------------ joins with no build rows

_JL = [("lk", TT.int64(), JT.int64()), ("lv", TT.int64(), JT.int64())]
_JR = [("rk", TT.int64(), JT.int64()), ("rv", TT.int32(), JT.int32())]


@pytest.mark.parametrize("shuffled", [False, True], ids=["broadcast", "shuffled"])
@pytest.mark.parametrize("kind", [t.name for t in JoinType])
def test_join_type_with_an_empty_build_side(kind, shuffled):
    """No build rows: INNER, LEFT_SEMI, RIGHT_SEMI, RIGHT_ANTI and the
    build-preserving RIGHT nothing; LEFT_ANTI and the probe-preserving
    LEFT and FULL every probe row (the build side null); EXISTENCE every
    probe row with False."""
    rng = np.random.default_rng(66)
    left = {"lk": (rng.integers(0, 20, 150), None, rng.random(150) > 0.1), "lv": (rng.integers(0, 9, 150), None, None)}
    right = {"rk": (np.zeros(0, np.int64), None, None), "rv": (np.zeros(0, np.int32), None, None)}
    build_preserved = kind in ("RIGHT", "FULL", "RIGHT_SEMI", "RIGHT_ANTI")
    probe_parts = 1 if build_preserved and not shuffled else 2
    tl, jl = _scan_pair(left, _JL, probe_parts, 64)
    tr, jr = _scan_pair(right, _JR, 2, 64)

    def plan(mod, lscan, rscan, c, jt):
        if shuffled:
            return mod.shuffle_join(lscan, rscan, [c("lk")], [c("rk")], jt[kind], 2, build_left=False)
        return mod.broadcast_join(rscan, lscan, [c("rk")], [c("lk")], jt[kind], build_is_left=False)

    got = _run(plan(Q, tl, tr, tcol, JoinType), batch_to_pydict, TaskContext)
    want = _run(plan(JQ, jl, jr, jcol, JJoinType), jax_to_pydict, JaxContext)
    assert _rows(got) == _rows(want)
    n = len(next(iter(got.values())))
    assert n == (150 if kind in ("LEFT_ANTI", "LEFT", "FULL", "EXISTENCE") else 0)
    if kind in ("LEFT", "FULL"):
        assert set(got["rk"]) == {None}
    if kind == "EXISTENCE":
        assert set(got["exists#0"]) == {False}
