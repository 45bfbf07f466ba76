"""The port's host functions and JSON paths against the JAX package.

Every name of the reference's ``HOST_IMPLS`` (digests, regular
expressions, padding, positions, formatting) is one parametrised case
over one seeded table with nulls, and so are ``get_json_object``,
``get_parsed_json_object`` and ``parse_json`` over documents the
smoke's shape builds (``concat`` of casts and strings) and the
reference's golden documents.  ``lower`` evaluates them on the host one
batch at a time, wherever they stand (nested in a device expression or
in one another); the reference hoists them out of the projection.
Every comparison is exact.  The reference's golden cases of
``tests/test_json.py`` also hold for the port's ``get_json_object`` and
``parse_path``.
"""

import numpy as np
import pytest

from blaze_tpu.exprs import functions as JFN
from blaze_tpu.schema import DataType as JT

from blaze_tpu_torch.exprs import functions as FN
from blaze_tpu_torch.exprs.compile import needs_host
from blaze_tpu_torch.exprs.json_path import get_json_object, parse_json, parse_path
from blaze_tpu_torch.exprs.ir import col, func, lit
from blaze_tpu_torch.schema import DataType as TT

from test_torch_fn_tables import date, host_table, run_family

N = 600

FIELDS = [
    ("a", TT.int32(), JT.int32()), ("b", TT.int64(), JT.int64()), ("dt", TT.date32(), JT.date32()),
    ("ts", TT.timestamp(), JT.timestamp()), ("s", TT.string(32), JT.string(32)),
    ("t", TT.string(16), JT.string(16)), ("doc", TT.string(64), JT.string(64)),
]

WORDS = ["hello world", "abc", "", "Aab ab abc", "ÄÖü ok", "2024-02-29", "1999-12-31 extra", "x1y22z333",
         "the quick brown", "aaa", "a.b.c", "  pad  ", "2021-13-01", "été-über", "CamelCase word", "ab"]
DOCS = ['{"a":{"b":"x"},"n":1}', '{"a":[1,2,3]}', '{"a":[{"b":1},{"b":2}]}', '{"a":[{"b":[1,2]},{"b":3}]}',
        '{"*":7,"a":true}', '{"名":"ü","a":null}', '{"a":1.5}', "not json", '{"a":["x","y"]}',
        '{"a":{"b":[{"c":1},{"c":2}]}}', '{ "a" : 1 , "b": [1, 2] }', "[1,2]"]


def _table():
    rng = np.random.RandomState(21)
    valid = lambda p=0.1: rng.rand(N) > p
    return host_table({
        "a": (np.int32, rng.randint(-20, 300, N), valid()),
        "b": (np.int64, rng.randint(-10**9, 10**9, N), valid()),
        "dt": (np.int32, rng.randint(-20000, 40000, N), valid()),
        "ts": (np.int64, rng.randint(-10**15, 2 * 10**15, N), valid()),
        "s": (("string", 32), [WORDS[i] for i in rng.randint(0, len(WORDS), N)], valid()),
        "t": (("string", 16), [WORDS[i][:16] for i in rng.randint(0, len(WORDS), N)], valid()),
        "doc": (("string", 64), [DOCS[i] for i in rng.randint(0, len(DOCS), N)], valid()),
    })


def _host_cases():
    s = lambda f, *extra: (lambda S: S.func(f, S.col("s"), *[S.lit(v) for v in extra]))
    return [
        ("md5", s("md5")), ("sha1", s("sha1")), ("sha2", s("sha2", 256)), ("sha2-0", s("sha2", 0)),
        ("sha2-512", s("sha2", 512)), ("crc32", s("crc32")), ("rlike", s("rlike", "^a.c")),
        ("regexp_like", s("regexp_like", "[0-9]+")), ("regexp_replace", s("regexp_replace", "l+", "L")),
        ("regexp_replace-groups", s("regexp_replace", "(a)(b)", "$2$1")),
        ("regexp_extract", s("regexp_extract", "([a-z]+) ([a-z]+)", 2)),
        ("regexp_extract-missing", s("regexp_extract", "(x)?y", 1)),
        ("replace", s("replace", "ab", "X")), ("reverse", s("reverse")), ("initcap", s("initcap")),
        ("translate", s("translate", "abc", "xy")), ("lpad", s("lpad", 10, "*-")), ("rpad", s("rpad", 12, "-")),
        ("lpad-empty", s("lpad", 20, "")), ("left", s("left", 3)), ("right", s("right", 4)),
        ("instr", s("instr", "b")), ("strpos", s("strpos", "c")), ("position", s("position", "a")),
        ("locate", lambda S: S.func("locate", S.lit("a"), S.col("s"), S.lit(2))),
        ("ascii", s("ascii")), ("chr", lambda S: S.func("chr", S.col("a"))),
        ("to_hex", lambda S: S.func("to_hex", S.col("b"))), ("split_part", s("split_part", " ", 2)),
        ("split", s("split", " ")), ("split-limit", s("split", "[ab]", 2)),
        ("from_unixtime", lambda S: S.func("from_unixtime", S.col("b"))),
        ("from_unixtime-format", lambda S: S.func("from_unixtime", S.col("b"), S.lit("yyyy/MM/dd"))),
        ("date_format", lambda S: S.func("date_format", S.col("dt"), S.lit("yyyy-MM-dd"))),
        ("date_format-timestamp", lambda S: S.func("date_format", S.col("ts"), S.lit("yyyy/MM/dd HH:mm:ss"))),
        ("to_date", s("to_date")),
        ("nested-in-device", lambda S: S.func("length", S.func("reverse", S.func("upper", S.col("t"))))),
        ("host-in-host", lambda S: S.func("md5", S.func("lpad", S.col("t"), S.lit(8), S.lit("0")))),
    ]


def _json_cases():
    j = lambda path: (lambda S: S.func("get_json_object", S.col("doc"), S.lit(path)))
    return [
        ("get_json_object", j("$.a")), ("get_json_object-b", j("$.a.b")), ("get_json_object-index", j("$.a[1]")),
        ("get_json_object-wild", j("$.a[*]")), ("get_json_object-deep", j("$.a.b[*].c")),
        ("get_json_object-star", j("$.*")), ("get_json_object-root", j("$")),
        ("get_json_object-bad-path", j("a.b")),
        ("parse_json", lambda S: S.func("parse_json", S.col("doc"))),
        ("get_parsed_json_object", lambda S: S.func("get_parsed_json_object",
                                                    S.func("parse_json", S.col("doc")), S.lit("$.b"))),
        ("get_json_object-built", lambda S: S.func(
            "get_json_object",
            S.func("concat", S.lit('{"key":'), S.cast(S.col("a"), S.T.string(16)), S.lit(',"name":"'),
                   S.col("t"), S.lit('"}')),
            S.lit("$.name"))),
        ("get_json_object-built-key", lambda S: S.func(
            "get_json_object",
            S.func("concat", S.lit('{"key":'), S.cast(S.col("b"), S.T.string(24)), S.lit("}")),
            S.lit("$.key"))),
    ]


FAMILIES = {"host": _host_cases(), "json": _json_cases()}
CASES = [(fam, cid) for fam, cases in FAMILIES.items() for cid, _ in cases]


@pytest.fixture(scope="module")
def results():
    table = _table()
    return {fam: run_family(table, FIELDS, cases) for fam, cases in FAMILIES.items()}


@pytest.mark.parametrize("fam,cid", CASES, ids=[f"{f}-{c}" for f, c in CASES])
def test_host_function_equals_the_reference(results, fam, cid):
    got, want = results[fam][0][cid], results[fam][1][cid]
    assert len(got) == N and [repr(v) for v in got] == [repr(v) for v in want]
    assert any(v is not None for v in got) != cid.endswith("bad-path")


def test_every_reference_host_name_is_a_case():
    names = {cid.split("-")[0] for _, cid in CASES}
    assert set(JFN.HOST_IMPLS) <= names
    assert set(FN.HOST_IMPLS) == set(JFN.HOST_IMPLS)


def test_host_functions_mark_their_operator_as_host():
    assert needs_host(func("length", func("md5", col("s"))))
    assert needs_host(func("get_json_object", col("s"), lit("$.a")))
    assert not needs_host(func("length", func("upper", col("s"))))


GOLDEN = [
    ('{"a":{"b":"x"}}', "$.a.b", "x"), ('{"a":[1,2,3]}', "$.a", "[1,2,3]"), ('{"a":[1,2,3]}', "$.a[1]", "2"),
    ('{"a":[1,2,3]}', "$.a[*]", "[1,2,3]"), ('{"a":[{"b":1},{"b":2}]}', "$.a[*].b", "[1,2]"),
    ('{"a":[{"b":1}]}', "$.a[*].b", "[1]"), ('{"a":[{"b":1}]}', "$.a.b", "[1]"),
    ('{"a":[{"b":1},{"b":2}]}', "$.a.b", "[1,2]"), ('{"a":[{"b":[1,2]},{"b":3}]}', "$.a.b", "[1,2,3]"),
    ('{"a":[{"b":[[1],2]}]}', "$.a.b", "[[1],2]"), ('{"a":[1,2]}', "$.a.[0]", "1"), ('{"a":[1,2]}', "$.a[]", "[1,2]"),
    ('{"*":7}', "$.*", "7"), ('{"名":"ü"}', "$", '{"名":"ü"}'), ('{"a":"b"}', "$", '{"a":"b"}'),
    ('{"a":1.5}', "$.a", "1.5"), ('{"a":true}', "$.a", "true"), ('{"a":null}', "$.a", None),
    ('{"a":1}', "$.b", None), ("not json", "$.a", None), ('{"a":["x","y"]}', "$.a[*]", '["x","y"]'),
    ('{"a":{"b":2}}', "$['a']['b']", None), ('{"a":[1,2]}', "$.a[5]", None), ('{"a":1}', "a.b", None),
    ('{"a":1}', "$.", None), (None, "$.a", None), ('{"a":{"b":[{"c":1},{"c":2}]}}', "$.a.b[*].c", "[1,2]"),
]


@pytest.mark.parametrize("doc,path,want", GOLDEN)
def test_get_json_object_golden(doc, path, want):
    from blaze_tpu.exprs.json_path import get_json_object as jax_get

    assert get_json_object(doc, path) == want == jax_get(doc, path)


def test_parse_json_and_parse_path_forms():
    assert parse_json('{ "a" : 1 , "b": [1, 2] }') == '{"a":1,"b":[1,2]}'
    assert parse_json("nope") is None and parse_json(None) is None
    assert parse_path("$.a[0].d[*]") == [("key", "a"), ("index", 0), ("key", "d"), ("wild",)]
    assert parse_path("$.a.[3].b[]") == [("key", "a"), ("index", 3), ("key", "b"), ("wild",)]
    for bad in ("$['a']", "$.a[-1]", "$.a[ 1 ]", "", "$x"):
        assert parse_path(bad) is None
