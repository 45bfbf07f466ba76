"""The port's device scalar functions against the JAX package: every
flat device name of the reference's registry, one parametrised case
each, over one seeded table with nulls (date, math, string, hash and
decimal families; one ProjectExec per family in each package).

Integers, decimals, dates, strings and booleans are compared exactly,
and so are ``sqrt``, ``ceil``, ``floor``, ``trunc``, ``signum``,
``negative`` and the ``round`` of a decimal (``sqrt`` also exactly to
numpy's; the ``sqrt`` of a decimal is within an ulp of the reference's,
whose decimal -> double is an ulp off, reference defect 5).  The other float results
(transcendental functions, ``cbrt``, ``degrees``/``radians``,
``pow``/``atan2``, ``round`` of a float) are held within ``ORACLE_ULPS``
(1) units in the last place of numpy's (NaN equal to NaN), and within
``REF_ULPS`` of the reference's: XLA's CPU ``sinh``, ``cosh``, ``tanh``,
``log1p`` and ``cbrt`` are less accurate than numpy's (up to 15, 15, 7,
65 and 101 ulps apart over this table; ``tanh(19.18)`` is
0.9999999999999992 in XLA, 1.0 in numpy and the port).  The nested names (``make_array``, ``size``,
``cardinality``, ``map_keys``, ``map_values``, ``array_contains``,
``array_union``, ``brickhouse_array_union``) take nested columns: their
cases are in ``test_torch_nested.py`` (``split``'s in
``test_torch_host_functions.py``); an unknown name raises.
"""

import datetime

import numpy as np
import pytest

from blaze_tpu.exprs import functions as JFN
from blaze_tpu.schema import DataType as JT

import blaze_tpu_torch
from blaze_tpu_torch.exprs import functions as FN
from blaze_tpu_torch.schema import DataType as TT

from test_torch_fn_tables import date, host_table, run_family, ulps

N = 900
ORACLE_ULPS = 1
REF_ULPS = {"sinh": 16, "cosh": 16, "tanh": 8, "log1p": 80, "cbrt": 128, "expm1": 2}
DEFAULT_REF_ULPS = 1

NESTED = {"make_array", "size", "cardinality", "map_keys", "map_values", "array_contains", "array_union",
          "brickhouse_array_union", "split"}

FIELDS = [
    ("a", TT.int32(), JT.int32()), ("b", TT.int64(), JT.int64()), ("k", TT.int32(), JT.int32()),
    ("x", TT.float64(), JT.float64()), ("y", TT.float64(), JT.float64()),
    ("d", TT.decimal(12, 2), JT.decimal(12, 2)), ("dt", TT.date32(), JT.date32()),
    ("ts", TT.timestamp(), JT.timestamp()), ("s", TT.string(32), JT.string(32)),
    ("t", TT.string(16), JT.string(16)),
]


def _table():
    rng = np.random.RandomState(15)
    valid = lambda p=0.1: rng.rand(N) > p
    words = ["  Hello World ", "abc", "", "xyzzy", "ÄÖü ok", "  ", "ab ", "za", "Mixed CASE str",
             "trailing   ", "   leading", "x", "abcabcabcabc", "🙂 emoji", "a b c", "zz z "]
    x = rng.gamma(2.0, 3.0, N) * rng.choice([-1.0, 1.0], N)
    x[:12] = [np.nan, np.inf, -np.inf, 0.0, -0.0, 1.0, -1.0, 0.5, -0.5, 2.5, -2.5, 1e-300]
    dt = rng.randint(-40000, 60000, N)
    dt[:10] = [0, 59, 11016, 11017, -1, date(2000, 12, 31), date(2004, 2, 29), date(1900, 3, 1),
               date(2021, 1, 3), date(2020, 12, 31)]
    cols = {
        "a": (np.int32, rng.randint(-50, 51, N), valid()),
        "b": (np.int64, rng.randint(-10**6, 10**6, N), valid()),
        "k": (np.int32, rng.randint(0, 6, N), valid(0.05)),
        "x": (np.float64, x, valid()),
        "y": (np.float64, rng.normal(0, 4, N), valid()),
        "d": (np.int64, rng.randint(-10**8, 10**8, N), valid()),
        "dt": (np.int32, dt, valid()),
        "ts": (np.int64, rng.randint(-10**15, 2 * 10**15, N), valid()),
        "s": (("string", 32), [words[i] for i in rng.randint(0, len(words), N)], valid()),
        "t": (("string", 16), [words[i][:16] for i in rng.randint(0, len(words), N)], valid()),
    }
    return host_table(cols)


def _date_cases():
    c = lambda n: (lambda S: S.col(n))
    cases = [(f, (lambda f: lambda S: S.func(f, S.col("dt")))(f))
             for f in ("quarter", "dayofweek", "weekday", "dayofyear", "weekofyear", "last_day")]
    cases += [
        ("add_months", lambda S: S.func("add_months", S.col("dt"), S.col("a"))),
        ("add_months-literal", lambda S: S.func("add_months", S.col("dt"), S.lit(1))),
        ("date_add", lambda S: S.func("date_add", S.col("dt"), S.col("a"))),
        ("date_sub", lambda S: S.func("date_sub", S.col("dt"), S.lit(7))),
        ("datediff", lambda S: S.func("datediff", S.col("dt"), S.lit(datetime.date(2000, 1, 1)))),
        ("hour", lambda S: S.func("hour", S.col("ts"))),
        ("minute", lambda S: S.func("minute", S.col("ts"))),
        ("second", lambda S: S.func("second", S.col("ts"))),
        ("unix_timestamp-date", lambda S: S.func("unix_timestamp", S.col("dt"))),
        ("unix_timestamp", lambda S: S.func("unix_timestamp", S.col("ts"))),
    ]
    del c
    return cases


MATH_1 = ("sin", "cos", "tan", "asin", "acos", "atan", "sinh", "cosh", "tanh", "exp", "expm1", "ln", "log",
          "log2", "log10", "log1p", "sqrt", "cbrt", "signum", "degrees", "radians", "ceil", "floor", "trunc")
EXACT_FLOAT = {"sqrt", "signum", "trunc", "sqrt-decimal"}


def _numpy_oracle(cid, table):
    """The numpy value of a tolerant float case, per row (None: the
    case has no numpy form here)."""
    x, y = table["x"][0], table["y"][0]
    d = table["d"][0] / 100.0
    a, k = table["a"][0].astype(np.float64), table["k"][0].astype(np.float64)
    fns = {"sin": np.sin, "cos": np.cos, "tan": np.tan, "asin": np.arcsin, "acos": np.arccos,
           "atan": np.arctan, "sinh": np.sinh, "cosh": np.cosh, "tanh": np.tanh, "exp": np.exp,
           "expm1": np.expm1, "ln": np.log, "log": np.log, "log2": np.log2, "log10": np.log10,
           "log1p": np.log1p, "cbrt": np.cbrt, "degrees": lambda v: v * (180.0 / np.pi),
           "radians": lambda v: v * (np.pi / 180.0)}
    with np.errstate(all="ignore"):
        if cid in fns:
            return fns[cid](x)
        return {"ln-decimal": lambda: np.log(d), "sqrt": lambda: np.sqrt(x), "sqrt-decimal": lambda: np.sqrt(d),
                "pow": lambda: np.power(x, y),
                "power": lambda: np.power(y, 3.0), "pow-int": lambda: np.power(a, k),
                "atan2": lambda: np.arctan2(x, y)}.get(cid, lambda: None)()


def _math_cases():
    cases = [(f, (lambda f: lambda S: S.func(f, S.col("x")))(f)) for f in MATH_1]
    cases += [
        ("sqrt-decimal", lambda S: S.func("sqrt", S.col("d"))),
        ("ln-decimal", lambda S: S.func("ln", S.col("d"))),
        ("ceil-decimal", lambda S: S.func("ceil", S.col("d"))),
        ("floor-decimal", lambda S: S.func("floor", S.col("d"))),
        ("pow", lambda S: S.func("pow", S.col("x"), S.col("y"))),
        ("power", lambda S: S.func("power", S.col("y"), S.lit(3.0))),
        ("pow-int", lambda S: S.func("pow", S.col("a"), S.col("k"))),
        ("atan2", lambda S: S.func("atan2", S.col("x"), S.col("y"))),
        ("round", lambda S: S.func("round", S.col("y"), S.lit(2))),
        ("round-decimal", lambda S: S.func("round", S.col("d"), S.lit(1))),
        ("round-int", lambda S: S.func("round", S.col("a"))),
        ("negative", lambda S: S.func("negative", S.col("a"))),
        ("negative-decimal", lambda S: S.func("negative", S.col("d"))),
    ]
    return cases


def _string_cases():
    one = lambda f: (f, lambda S: S.func(f, S.col("s")))
    cases = [one(f) for f in ("length", "char_length", "character_length", "upper", "lower", "bit_length",
                              "octet_length", "trim", "btrim", "ltrim", "rtrim")]
    cases += [
        ("starts_with", lambda S: S.func("starts_with", S.col("s"), S.lit("ab"))),
        ("ends_with", lambda S: S.func("ends_with", S.col("s"), S.lit("z "))),
        ("trim-chars", lambda S: S.func("trim", S.col("s"), S.lit("a x"))),
        ("ltrim-chars", lambda S: S.func("ltrim", S.col("s"), S.lit(" H"))),
        ("space", lambda S: S.func("space", S.col("k"))),
        ("space-literal", lambda S: S.func("space", S.lit(3))),
        ("repeat", lambda S: S.func("repeat", S.col("t"), S.lit(2))),
        ("repeat-column", lambda S: S.func("repeat", S.col("t"), S.col("k"))),
        ("repeat-zero", lambda S: S.func("repeat", S.col("s"), S.lit(0))),
        ("concat_ws", lambda S: S.func("concat_ws", S.lit("-"), S.col("s"), S.col("t"))),
        ("concat_ws-three", lambda S: S.func("concat_ws", S.lit(", "), S.col("t"), S.col("s"), S.col("t"))),
        ("coalesce", lambda S: S.func("coalesce", S.col("s"), S.col("t"))),
        ("coalesce-widening", lambda S: S.func("coalesce", S.col("a"), S.col("b"), S.lit(0))),
        ("nullif", lambda S: S.func("nullif", S.col("a"), S.col("k"))),
        ("null_if", lambda S: S.func("null_if", S.col("s"), S.col("t"))),
        ("null_if_zero", lambda S: S.func("null_if_zero", S.col("a"))),
        ("nullifzero", lambda S: S.func("nullifzero", S.col("b"))),
    ]
    return cases


def _hash_cases():
    return [
        ("murmur3_hash", lambda S: S.func("murmur3_hash", S.col("a"))),
        ("murmur3_hash-string", lambda S: S.func("murmur3_hash", S.col("s"))),
        ("murmur3_hash-many", lambda S: S.func("murmur3_hash", S.col("b"), S.col("s"), S.col("d"), S.col("dt"))),
        ("xxhash64", lambda S: S.func("xxhash64", S.col("b"))),
        ("xxhash64-string", lambda S: S.func("xxhash64", S.col("t"))),
        ("xxhash64-many", lambda S: S.func("xxhash64", S.col("x"), S.col("a"), S.col("ts"))),
    ]


def _decimal_cases():
    return [
        ("unscaled_value", lambda S: S.func("unscaled_value", S.col("d"))),
        ("make_decimal", lambda S: S.func("make_decimal", S.col("b"), S.lit(18), S.lit(2))),
        ("check_overflow", lambda S: S.func("check_overflow", S.col("d"), S.lit(7), S.lit(1))),
        ("check_overflow-widen", lambda S: S.func("check_overflow", S.col("d"), S.lit(14), S.lit(3))),
        ("abs-decimal", lambda S: S.func("abs", S.col("d"))),
    ]


FAMILIES = {"date": _date_cases(), "math": _math_cases(), "string": _string_cases(), "hash": _hash_cases(),
            "decimal": _decimal_cases()}
CASES = [(fam, cid) for fam, cases in FAMILIES.items() for cid, _ in cases]


@pytest.fixture(scope="module")
def results():
    table = _table()
    out = {fam: run_family(table, FIELDS, cases) for fam, cases in FAMILIES.items()}
    out["table"] = table
    return out


def _float_tolerant(cid: str) -> bool:
    name = cid.split("-")[0]
    return cid not in EXACT_FLOAT and name not in ("ceil", "floor", "negative", "round") or cid == "round"


@pytest.mark.parametrize("fam,cid", CASES, ids=[f"{f}-{c}" for f, c in CASES])
def test_function_equals_the_reference(results, fam, cid):
    got, want = results[fam][0][cid], results[fam][1][cid]
    assert len(got) == len(want) == N
    assert sum(v is not None for v in got) > N // 2
    if any(isinstance(v, float) for v in want) and _float_tolerant(cid):
        assert [v is None for v in got] == [v is None for v in want]
        worst = max(ulps(g, w) for g, w in zip(got, want) if w is not None)
        assert worst <= REF_ULPS.get(cid, DEFAULT_REF_ULPS), worst
        oracle = _numpy_oracle(cid, results["table"])
        if oracle is not None:
            assert max(ulps(g, float(o)) for g, o in zip(got, oracle) if g is not None) <= ORACLE_ULPS
    elif cid == "sqrt-decimal":
        # the reference divides by 10^scale under jit, a multiply by the
        # reciprocal (ROADMAP queue C, reference defect 5): an ulp apart
        assert max(ulps(g, w) for g, w in zip(got, want) if w is not None) <= 1
    else:
        assert [repr(v) for v in got] == [repr(v) for v in want]
    if cid in ("sqrt", "sqrt-decimal"):
        oracle = _numpy_oracle(cid, results["table"])
        assert all(repr(g) == repr(float(o)) for g, o in zip(got, oracle) if g is not None)


def test_every_flat_reference_name_resolves_in_the_port():
    ref_names = set(JFN._REGISTRY) | set(JFN.HOST_IMPLS) | {"get_json_object", "get_parsed_json_object",
                                                               "parse_json"}
    port = set(FN._REGISTRY) | set(FN.HOST_IMPLS) | set(FN.JSON_FUNCS)
    assert ref_names <= port and NESTED <= port
    assert set(FN._TYPES) == port
    tested = {cid.split("-")[0] for _, cid in CASES}
    device = set(FN._REGISTRY) - {"year", "month", "day", "substring", "concat", "might_contain"} - NESTED
    assert device <= tested, device - tested


def test_an_unknown_name_raises_naming_it():
    from blaze_tpu_torch.exprs.compile import infer_dtype, lower
    from blaze_tpu_torch.exprs.ir import col, func
    from blaze_tpu_torch.batch import column_from_numpy
    from blaze_tpu_torch.schema import Field, Schema

    schema = Schema([Field("a", TT.int32())])
    c = column_from_numpy(TT.int32(), np.arange(4, dtype=np.int32), device="cpu")
    with pytest.raises(KeyError, match="no_such_fn"):
        infer_dtype(func("no_such_fn", col("a")), schema)
    with pytest.raises(KeyError, match="no_such_fn"):
        lower(func("no_such_fn", col("a")), schema, {"a": c}, 4)
    # ``size`` resolves since nested columns came; over a flat column it
    # raises naming the type
    assert infer_dtype(func("size", col("a")), schema) == TT.int32()
    with pytest.raises(TypeError, match="size over"):
        lower(func("size", col("a")), schema, {"a": c}, 4)


def test_cbrt_has_no_torch_counterpart_and_is_exact_on_cubes():
    import torch

    assert not hasattr(torch, "cbrt")
    cubes = torch.tensor([-27.0, -8.0, 0.0, -0.0, 1.0, 8.0, 27.0, 1e-300, float("inf"), float("-inf")],
                         dtype=torch.float64)
    got = FN.cbrt(cubes).tolist()
    assert got[:7] == [-3.0, -2.0, 0.0, -0.0, 1.0, 2.0, 3.0]
    assert str(got[3]) == "-0.0" and got[8:] == [float("inf"), float("-inf")]
