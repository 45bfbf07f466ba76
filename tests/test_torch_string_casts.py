"""The string casts of the port against the JAX package and Python
oracles (Spark non-ANSI: malformed or overflowing input is null).

- string -> bool, int8/16/32/64, decimal and date32 over seeded strings
  (signs, spaces and control bytes trimmed, fractions, exponents and
  junk, values at and past every bound, calendar-invalid dates);
- bool, integers, decimals and date32 -> string, with renderings wider
  than the target null and years outside 0..9999 null;
- string -> float or timestamp and float -> string raise
  ``NotImplementedError``, as in the reference.

One ProjectExec per direction in each package; every comparison is
exact.
"""

import datetime
import decimal as D

import numpy as np
import pytest

from blaze_tpu.schema import DataType as JT

import blaze_tpu_torch
from blaze_tpu_torch.batch import column_from_numpy, column_from_strings, column_to_pylist
from blaze_tpu_torch.exprs.cast import lower_cast
from blaze_tpu_torch.schema import DataType as TT

from test_torch_fn_tables import date, host_table, run_family

EDGES = ["42", " -17 ", "+8", "0", "9223372036854775807", "-9223372036854775808", "9223372036854775808",
         "3.7", "-3.7", "abc", "", "  ", "1e3", "--5", "12a", "1 2", "- 5", "00042", "-0", "\x0c42\x7f",
         "127", "128", "-128", "-129", "32767", "32768", "2147483647", "2147483648", "-2147483649",
         "1.005", "-1.005", ".5", "-.25", "12345678.90", "99999999999", "1.2.3", "0.125", "-0.0049",
         "true", "FALSE", " t ", "no", "Y", "1", "maybe", "yes ", "N", "f", "TRUE1",
         "1994-01-01", "2000-02-29", "1970-01-01", "1969-12-31", "2015-13-01", "2015-00-10", "20150101",
         "2015-1-1", "2021-02-29", "2020-02-29", "2021-02-30", "2000-04-31", "1900-02-29", " 2001-09-09 ",
         "0001-01-01", "9999-12-31", "2001-09-0x"]
N_FROM = 1200
N_TO = 800


def _from_table():
    rng = np.random.RandomState(31)
    vals = [EDGES[i] for i in rng.randint(0, len(EDGES), N_FROM)]
    ints = rng.randint(-(2**62), 2**62, N_FROM)
    for i in range(0, N_FROM, 5):
        vals[i] = str(int(ints[i]))
    for i in range(1, N_FROM, 7):
        vals[i] = f"{ints[i] % 10**9 / 10**int(ints[i] % 5):.{int(ints[i] % 6)}f}"
    valid = rng.rand(N_FROM) > 0.08
    return host_table({"s": (("string", 32), vals, valid)})


FROM_FIELDS = [("s", TT.string(32), JT.string(32))]
TARGETS = [("bool", "bool_", ()), ("int8", "int8", ()), ("int16", "int16", ()), ("int32", "int32", ()),
           ("int64", "int64", ()), ("decimal-10-2", "decimal", (10, 2)), ("decimal-18-0", "decimal", (18, 0)),
           ("decimal-5-3", "decimal", (5, 3)), ("decimal-38-6", "decimal", (38, 6)), ("date32", "date32", ())]


def _from_cases():
    return [(f"string-to-{cid}", (lambda ctor, args: lambda S: S.cast(S.col("s"), getattr(S.T, ctor)(*args)))(c, a))
            for cid, c, a in TARGETS]


def _to_table():
    rng = np.random.RandomState(32)
    i64 = rng.randint(-(2**62), 2**62, N_TO)
    i64[:6] = [0, -1, 2**63 - 1, -(2**63), 10**18, -(10**18)]
    i32 = rng.randint(-(2**31), 2**31, N_TO)
    i32[:3] = [2**31 - 1, -(2**31), 0]
    dec = rng.randint(-(10**12), 10**12, N_TO)
    dec[:6] = [0, 5, -5, 150, -150, 10**11]
    dt = rng.randint(-800000, 3200000, N_TO)
    dt[:6] = [0, -1, date(2024, 2, 29), date(1, 1, 1), date(9999, 12, 31), date(9999, 12, 31) + 1]
    valid = lambda: rng.rand(N_TO) > 0.08
    return host_table({
        "i8": (np.int8, rng.randint(-128, 128, N_TO), valid()),
        "i32": (np.int32, i32, valid()), "i64": (np.int64, i64, valid()),
        "d": (np.int64, dec, valid()), "d4": (np.int64, dec, valid()),
        "bo": (np.bool_, rng.rand(N_TO) > 0.5, valid()), "dt": (np.int32, dt, valid()),
    })


TO_FIELDS = [("i8", TT.int8(), JT.int8()), ("i32", TT.int32(), JT.int32()), ("i64", TT.int64(), JT.int64()),
             ("d", TT.decimal(14, 2), JT.decimal(14, 2)), ("d4", TT.decimal(18, 4), JT.decimal(18, 4)),
             ("bo", TT.bool_(), JT.bool_()), ("dt", TT.date32(), JT.date32())]


def _to_cases():
    out = []
    for name, _, _ in TO_FIELDS:
        for w in (32, 8):
            out.append((f"{name}-to-string{w}", (lambda n, w: lambda S: S.cast(S.col(n), S.T.string(w)))(name, w)))
    return out


@pytest.fixture(scope="module")
def results():
    return {"from": run_family(_from_table(), FROM_FIELDS, _from_cases()),
            "to": run_family(_to_table(), TO_FIELDS, _to_cases())}


CASES = [("from", cid) for cid, _ in _from_cases()] + [("to", cid) for cid, _ in _to_cases()]


@pytest.mark.parametrize("fam,cid", CASES, ids=[c for _, c in CASES])
def test_string_cast_equals_the_reference(results, fam, cid):
    got, want = results[fam][0][cid], results[fam][1][cid]
    assert [repr(v) for v in got] == [repr(v) for v in want]
    assert any(v is not None for v in got) and any(v is None for v in got)


def _cast(values, to, width=32):
    c = column_from_strings(values, width=width, device="cpu")
    return column_to_pylist(lower_cast(c, to), len(values))


def test_string_to_integers_follow_spark():
    vals = ["42", " -17 ", "+8", "0", "9223372036854775807", "-9223372036854775808", "9223372036854775808",
            "3.7", "-3.7", "abc", "", "  ", "1e3", "--5", "12a", "1 2", "- 5", None, "00042", "-0", "\x0c42\x7f"]
    assert _cast(vals, TT.int64()) == [42, -17, 8, 0, 2**63 - 1, -(2**63), None, 3, -3, None, None, None, None,
                                       None, None, None, None, None, 42, 0, 42]
    assert _cast(["2147483647", "2147483648", "-2147483648", "-2147483649"], TT.int32()) == \
        [2147483647, None, -2147483648, None]


def test_string_to_decimal_rounds_half_up():
    vals = ["1.005", "-1.005", "3", "3.1", "3.14159", ".5", "-.25", "12345678.90", "99999999999", "x", "", None,
            "1.2.3"]

    def py(s):
        if s is None or s.strip() == "":
            return None
        try:
            u = int(D.Decimal(s.strip()).scaleb(2).quantize(D.Decimal(1), rounding=D.ROUND_HALF_UP))
        except D.InvalidOperation:
            return None
        return u if abs(u) < 10**10 else None

    assert _cast(vals, TT.decimal(10, 2)) == [py(v) for v in vals]


def test_string_to_bool_and_date():
    assert _cast(["true", "FALSE", " t ", "no", "Y", "1", "0", "maybe", "", None], TT.bool_()) == \
        [True, False, True, False, True, True, False, None, None, None]
    vals = ["1994-01-01", "2000-02-29", "2021-02-29", "2015-13-01", "20150101", "2015-1-1", None]

    def py(s):
        try:
            return (datetime.date.fromisoformat(s) - datetime.date(1970, 1, 1)).days if len(s) == 10 else None
        except (TypeError, ValueError):
            return None

    assert _cast(vals, TT.date32()) == [py(v) for v in vals]


def test_renderings_round_trip():
    rng = np.random.RandomState(33)
    ints = rng.randint(-(2**62), 2**62, 300)
    c = column_from_numpy(TT.int64(), ints, device="cpu")
    strs = column_to_pylist(lower_cast(c, TT.string(32)), 300)
    assert strs == [str(int(v)) for v in ints]
    assert _cast(strs, TT.int64()) == [int(v) for v in ints]
    t = TT.decimal(15, 3)
    dc = column_from_numpy(t, ints % 10**12, device="cpu")
    assert _cast(column_to_pylist(lower_cast(dc, TT.string(32)), 300), t) == [int(v) for v in ints % 10**12]
    assert column_to_pylist(lower_cast(column_from_numpy(TT.decimal(12, 2), np.array([0, 5, -5, -150, 100]),
                                                         device="cpu"), TT.string(16)), 5) == \
        ["0.00", "0.05", "-0.05", "-1.50", "1.00"]


@pytest.mark.parametrize("src,to", [("string", "float64"), ("string", "float32"), ("string", "timestamp"),
                                    ("float64", "string")])
def test_unported_routes_raise(src, to):
    if src == "string":
        c = column_from_strings(["1.5"], width=8, device="cpu")
        to_t = getattr(TT, to)()
    else:
        c = column_from_numpy(TT.float64(), np.array([1.5]), device="cpu")
        to_t = TT.string(32)
    with pytest.raises(NotImplementedError):
        lower_cast(c, to_t)
