"""The port's expressions against the JAX package's, on the same numpy
inputs made from a seed: Spark hashes (plus Spark's golden vectors),
two-limb int128 arithmetic, the wide decimal arithmetic of q03's
revenue, and string comparison.  All integer results compare exactly."""

import datetime

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import blaze_tpu.batch as JB
import blaze_tpu.exprs.compile as JC
import blaze_tpu.exprs.hash as JH
import blaze_tpu.exprs.int128 as JI
import blaze_tpu.exprs.strings as JS
from blaze_tpu.exprs import col as jcol, lit as jlit
from blaze_tpu.schema import DataType as JT, Field as JF, Schema as JSchema

import blaze_tpu_torch.batch as TB
import blaze_tpu_torch.exprs.compile as TC
import blaze_tpu_torch.exprs.hash as TH
import blaze_tpu_torch.exprs.int128 as TI
import blaze_tpu_torch.exprs.strings as TS
from blaze_tpu_torch.exprs import col as tcol, lit as tlit
from blaze_tpu_torch.schema import DataType as TT, Field as TF, Schema as TSchema

CPU = "cpu"


def _u(x):
    return int(np.int32(np.uint32(x)))


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


# ------------------------------------------------------------ golden vectors


def test_murmur3_golden_int32():
    c = TB.column_from_numpy(TT.int32(), np.array([1, 2, 3, 4], np.int32), device=CPU)
    assert TH.murmur3_columns([c])[:4].tolist() == [-559580957, 1765031574, -1823081949, -397064898]


def test_murmur3_golden_int8():
    c = TB.column_from_numpy(TT.int8(), np.array([1, 0, -1, 127, -128], np.int8), device=CPU)
    want = [_u(0xDEA578E3), _u(0x379FAE8F), _u(0xA0590E3D), _u(0x43B4D8ED), _u(0x422A1365)]
    assert TH.murmur3_columns([c])[:5].tolist() == want


def test_murmur3_golden_int64():
    vals = np.array([1, 0, -1, np.iinfo(np.int64).max, np.iinfo(np.int64).min], np.int64)
    c = TB.column_from_numpy(TT.int64(), vals, device=CPU)
    want = [_u(0x99F0149D), _u(0x9C67B85D), _u(0xC8008529), _u(0xA05B5D7B), _u(0xCD1E64FB)]
    assert TH.murmur3_columns([c])[:5].tolist() == want


def test_murmur3_golden_strings():
    c = TB.column_from_strings(["hello", "bar", "", "😁", "天地"], device=CPU)
    want = [_u(3286402344), _u(2486176763), _u(142593372), _u(885025535), _u(2395000894)]
    assert TH.murmur3_columns([c])[:5].tolist() == want


def test_xxhash64_golden_int64():
    vals = np.array([1, 0, -1, np.iinfo(np.int64).max], np.int64)
    c = TB.column_from_numpy(TT.int64(), vals, device=CPU)
    assert TH.xxhash64_columns([c])[:4].tolist() == [
        -7001672635703045582, -5252525462095825812, 3858142552250413010, -3246596055638297850]


def test_xxhash64_golden_strings():
    c = TB.column_from_strings(["hello", "bar", "", "😁", "天地"], device=CPU)
    assert TH.xxhash64_columns([c])[:5].tolist() == [
        -4367754540140381902, -1798770879548125814, -7444071767201028348,
        -6337236088984028203, -235771157374669727]


def test_null_leaves_murmur3_unchanged():
    c = TB.column_from_numpy(TT.int32(), np.array([1, 1], np.int32), np.array([True, False]), device=CPU)
    assert TH.murmur3_columns([c])[:2].tolist() == [-559580957, 42]


# ---------------------------------------------------- differential hashes

_FIXED = {
    "int8": (TT.int8(), JT.int8(), lambda r, n: r.integers(-128, 128, n).astype(np.int8)),
    "int32": (TT.int32(), JT.int32(), lambda r, n: r.integers(-(2**31), 2**31, n).astype(np.int32)),
    "int64": (TT.int64(), JT.int64(), lambda r, n: r.integers(-(2**63), 2**63 - 1, n, dtype=np.int64)),
    "float32": (TT.float32(), JT.float32(),
                lambda r, n: np.concatenate([[0.0, -0.0], r.standard_normal(n - 2)]).astype(np.float32)),
    "float64": (TT.float64(), JT.float64(),
                lambda r, n: np.concatenate([[0.0, -0.0, np.inf], r.standard_normal(n - 3) * 1e300])),
    "decimal": (TT.decimal(12, 2), JT.decimal(12, 2), lambda r, n: r.integers(-(10**12) + 1, 10**12, n)),
    "date32": (TT.date32(), JT.date32(), lambda r, n: r.integers(0, 20000, n).astype(np.int32)),
    "bool": (TT.bool_(), JT.bool_(), lambda r, n: r.integers(0, 2, n).astype(np.bool_)),
}


def _fixed_pair(kind, rng, n):
    tt, jt, gen = _FIXED[kind]
    vals, valid = gen(rng, n), rng.random(n) > 0.2
    return (TB.column_from_numpy(tt, vals, valid, capacity=n, device=CPU),
            JB.column_from_numpy(jt, vals, valid, capacity=n).to_device())


def _string_pair(rng, n):
    words = ["", "a", "abc", "abcd", "hello world", "x" * 31, "y" * 33, "天地", "😁!", "z" * 63]
    vals = [None if rng.random() < 0.2 else words[i] for i in rng.integers(0, len(words), n)]
    return (TB.column_from_strings(vals, width=64, capacity=n, device=CPU),
            JB.column_from_strings(vals, width=64, capacity=n).to_device())


@pytest.mark.parametrize("kind", sorted(_FIXED) + ["string"])
def test_hashes_match_reference(kind):
    rng = np.random.default_rng(5)
    n = 700
    tc, jc = _string_pair(rng, n) if kind == "string" else _fixed_pair(kind, rng, n)
    np.testing.assert_array_equal(TH.murmur3_columns([tc]).numpy(), np.asarray(JH.murmur3_columns([jc])))
    np.testing.assert_array_equal(TH.xxhash64_columns([tc]).numpy(), np.asarray(JH.xxhash64_columns([jc])))


def test_chained_hashes_and_pmod_match_reference():
    rng = np.random.default_rng(6)
    n = 500
    pairs = [_fixed_pair("int64", rng, n), _string_pair(rng, n), _fixed_pair("date32", rng, n)]
    tcols, jcols = [p[0] for p in pairs], [p[1] for p in pairs]
    th = TH.murmur3_columns(tcols)
    np.testing.assert_array_equal(th.numpy(), np.asarray(JH.murmur3_columns(jcols)))
    np.testing.assert_array_equal(TH.pmod(th, 13).numpy(), np.asarray(JH.pmod(JH.murmur3_columns(jcols), 13)))
    np.testing.assert_array_equal(TH.xxhash64_columns(tcols).numpy(), np.asarray(JH.xxhash64_columns(jcols)))


# ------------------------------------------------------------------ int128


def _i64_edges(rng, n):
    edges = np.array([0, 1, -1, 2**31, -(2**31), 2**32, 2**62, -(2**62), 2**63 - 1, -(2**63),
                      10**18, -(10**18)], np.int64)
    return np.concatenate([edges, rng.integers(-(2**63), 2**63 - 1, n, dtype=np.int64),
                           rng.integers(-(10**9), 10**9, n)])


def test_int128_mul_add_sub_match_reference():
    rng = np.random.default_rng(1)
    a, b = _i64_edges(rng, 400), np.roll(_i64_edges(rng, 400), 7)
    th, tl = TI.mul_i64(_t(a), _t(b))
    jh, jl = JI.mul_i64(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl).view(np.int64))
    for top, jop in ((TI.add, JI.add), (TI.sub, JI.sub)):
        rh, rl = top(th, tl, th.flip(0), tl.flip(0))
        qh, ql = jop(jh, jl, jh[::-1], jl[::-1])
        np.testing.assert_array_equal(rh.numpy(), np.asarray(qh))
        np.testing.assert_array_equal(rl.numpy(), np.asarray(ql).view(np.int64))
    # exact against python integers
    got = [(int(h) << 64) + (int(l) & (2**64 - 1)) for h, l in zip(th.tolist(), tl.tolist())]
    assert got == [int(x) * int(y) for x, y in zip(a, b)]


def test_int128_rescale_and_division_match_reference():
    rng = np.random.default_rng(2)
    a, b = _i64_edges(rng, 300), np.roll(_i64_edges(rng, 300), 3)
    th, tl = TI.mul_i64(_t(a), _t(b))
    jh, jl = JI.mul_i64(jnp.asarray(a), jnp.asarray(b))
    for k in (1, 2, 4, 9, 18):
        tq, tok = TI.rescale_down(th, tl, k)
        jq, jok = JI.rescale_down(jh, jl, k)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
        ok = tok.numpy()
        np.testing.assert_array_equal(tq.numpy()[ok], np.asarray(jq)[ok])
    den = np.where(b == 0, 7, b)
    tq, tok = TI.div_round_half_up(th, tl, _t(den))
    jq, jok = JI.div_round_half_up(jh, jl, jnp.asarray(den))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    np.testing.assert_array_equal(tq.numpy()[tok.numpy()], np.asarray(jq)[tok.numpy()])


def test_int128_mul_pow10_matches_reference():
    """mul_small / mul_pow10 (avg's rescale) against the JAX limbs and
    python integers, for products that fit 128 bits."""
    rng = np.random.default_rng(5)
    a, b = _i64_edges(rng, 300), np.roll(_i64_edges(rng, 300), 5)
    th, tl = TI.mul_i64(_t(a), _t(b))
    jh, jl = JI.mul_i64(jnp.asarray(a), jnp.asarray(b))
    for k in (0, 1, 4, 9, 10):
        rh, rl = TI.mul_pow10(th, tl, k)
        qh, ql = JI.mul_pow10(jh, jl, k)
        want = [int(x) * int(y) * 10**k for x, y in zip(a, b)]
        fits = np.array([-(2**127) <= w < 2**127 for w in want])
        np.testing.assert_array_equal(rh.numpy()[fits], np.asarray(qh)[fits])
        np.testing.assert_array_equal(rl.numpy()[fits], np.asarray(ql).view(np.int64)[fits])
        got = [(int(h) << 64) + (int(l) & (2**64 - 1)) for h, l in zip(rh.tolist(), rl.tolist())]
        assert [x for x, f in zip(got, fits) if f] == [w for w, f in zip(want, fits) if f]
    mh, ml = TI.mul_small(th, tl, 2**31 - 1)
    qh, ql = JI.mul_small(jh, jl, 2**31 - 1)
    np.testing.assert_array_equal(mh.numpy(), np.asarray(qh))
    np.testing.assert_array_equal(ml.numpy(), np.asarray(ql).view(np.int64))


# ------------------------------------------------------- decimal lowering


def _lower_both(texpr, jexpr, fields, arrays, valids):
    n = len(next(iter(arrays.values())))
    tschema = TSchema([TF(nm, tt) for nm, tt, _ in fields])
    jschema = JSchema([JF(nm, jt) for nm, _, jt in fields])
    tenv = {nm: TB.column_from_numpy(tt, arrays[nm], valids[nm], capacity=n, device=CPU)
            for nm, tt, _ in fields}
    jenv = {nm: JB.column_from_numpy(jt, arrays[nm], valids[nm], capacity=n).to_device()
            for nm, _, jt in fields}
    tc = TC.lower(texpr, tschema, tenv, n)
    jc = JC.lower(jexpr, jschema, jenv, n)
    assert repr(tc.dtype) == repr(jc.dtype)
    tv, jv = tc.validity.numpy(), np.asarray(jc.validity)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tc.data.numpy()[tv], np.asarray(jc.data)[jv])
    return tc


def test_revenue_expr_wide_decimal_matches_reference():
    """decimal(12,2) * (1 - decimal(12,2)): the decimal(26,4) int128
    product of q03's revenue, with nulls."""
    rng = np.random.default_rng(3)
    n = 2000
    price = rng.integers(-(10**12) + 1, 10**12, n)
    disc = rng.integers(-(10**12) + 1, 10**12, n)
    arrays = {"p": price, "d": disc}
    valids = {"p": rng.random(n) > 0.1, "d": rng.random(n) > 0.1}
    fields = [("p", TT.decimal(12, 2), JT.decimal(12, 2)), ("d", TT.decimal(12, 2), JT.decimal(12, 2))]
    t12 = TT.decimal(12, 2)
    j12 = JT.decimal(12, 2)
    out = _lower_both(tcol("p") * (tlit(1, t12) - tcol("d")), jcol("p") * (jlit(1, j12) - jcol("d")),
                      fields, arrays, valids)
    assert repr(out.dtype) == "decimal(26,4)"
    # the q06 product, and a narrow one
    _lower_both(tcol("p") * tcol("d"), jcol("p") * jcol("d"), fields, arrays, valids)
    _lower_both(tcol("p") + tcol("d"), jcol("p") + jcol("d"), fields, arrays, valids)


def test_wide_decimal_product_overflows_to_null_like_reference():
    """decimal(20,0) products past int64 become null; a rescale-down
    product (decimal(38,x) bounds) rounds HALF_UP like the reference."""
    rng = np.random.default_rng(4)
    n = 1000
    a = np.concatenate([[2**62, -(2**62), 3, 10**18], rng.integers(-(2**62), 2**62, n - 4)])
    b = np.concatenate([[4, 4, -(10**18), 10], rng.integers(-(2**40), 2**40, n - 4)])
    valids = {"a": np.ones(n, bool), "b": np.ones(n, bool)}
    fields = [("a", TT.decimal(20, 0), JT.decimal(20, 0)), ("b", TT.decimal(20, 0), JT.decimal(20, 0))]
    out = _lower_both(tcol("a") * tcol("b"), jcol("a") * jcol("b"), fields, {"a": a, "b": b}, valids)
    assert not out.validity.numpy().all()
    fields = [("a", TT.decimal(30, 10), JT.decimal(30, 10)), ("b", TT.decimal(30, 10), JT.decimal(30, 10))]
    _lower_both(tcol("a") * tcol("b"), jcol("a") * jcol("b"), fields, {"a": a, "b": b}, valids)


def test_q01_charge_product_matches_reference():
    """q01's charge: decimal(26,4) * (1 + decimal(12,2)) is bounded to
    decimal(38,6) with no rescale; the int128 product narrows to int64
    or overflows to null, as in the reference."""
    rng = np.random.default_rng(6)
    n = 2000
    dp = np.concatenate([[10**18, -(10**18), 2**62, 4 * 10**16], rng.integers(-(10**15), 10**15, n - 4)])
    tax = np.concatenate([[100, 100, 50, 99], rng.integers(-(10**4), 10**4, n - 4)])
    arrays = {"dp": dp, "tax": tax}
    valids = {"dp": rng.random(n) > 0.1, "tax": rng.random(n) > 0.1}
    valids["dp"][:4] = valids["tax"][:4] = True
    fields = [("dp", TT.decimal(26, 4), JT.decimal(26, 4)), ("tax", TT.decimal(12, 2), JT.decimal(12, 2))]
    out = _lower_both(tcol("dp") * (tlit(1, TT.decimal(12, 2)) + tcol("tax")),
                      jcol("dp") * (jlit(1, JT.decimal(12, 2)) + jcol("tax")), fields, arrays, valids)
    assert repr(out.dtype) == "decimal(38,6)"
    assert out.validity[:4].tolist() == [False, False, False, True]


def test_comparisons_and_three_valued_logic_match_reference():
    rng = np.random.default_rng(8)
    n = 600
    arrays = {"d": rng.integers(8000, 10000, n).astype(np.int32), "q": rng.integers(0, 5000, n)}
    valids = {"d": rng.random(n) > 0.2, "q": rng.random(n) > 0.2}
    fields = [("d", TT.date32(), JT.date32()), ("q", TT.decimal(12, 2), JT.decimal(12, 2))]
    day = datetime.date(1995, 3, 15)
    t = ((tcol("d") >= tlit(day)) & ~(tcol("q") < tlit(24, TT.decimal(12, 2)))) | tcol("q").is_null()
    j = ((jcol("d") >= jlit(day)) & ~(jcol("q") < jlit(24, JT.decimal(12, 2)))) | jcol("q").is_null()
    _lower_both(t, j, fields, arrays, valids)


# ----------------------------------------------------------------- strings


def test_string_equality_and_order_match_reference():
    rng = np.random.default_rng(9)
    words = ["", "A", "AUTOMOBILE", "BUILDING", "BUILDINGS", "BUILD", "FURNITURE", "b" * 16, "天地"]
    n = 300
    a = [words[i] for i in rng.integers(0, len(words), n)]
    b = [words[i] for i in rng.integers(0, len(words), n)]
    ta, tb = TB.column_from_strings(a, width=16, device=CPU), TB.column_from_strings(b, width=32, device=CPU)
    ja, jb = JB.column_from_strings(a, width=16).to_device(), JB.column_from_strings(b, width=32).to_device()
    for top, jop in ((TS.str_eq, JS.str_eq), (TS.str_lt, JS.str_lt), (TS.str_le, JS.str_le)):
        np.testing.assert_array_equal(top(ta, tb).numpy(), np.asarray(jop(ja, jb)))
    assert TS.str_eq(ta, tb)[:n].tolist() == [x == y for x, y in zip(a, b)]


# --------------------------------------------- decimal -> double (C.1)


def test_decimal_minus_double_is_correctly_rounded():
    """decimal(12,2) 0.38 - double 1.5 is -1.12, numpy's answer: the
    decimal divides by a float64 tensor (on the card a host scalar
    divisor becomes a reciprocal multiply, an ulp off)."""
    schema = TSchema([TF("d", TT.decimal(12, 2)), TF("x", TT.float64())])
    env = {"d": TB.column_from_numpy(TT.decimal(12, 2), np.array([38]), capacity=1, device=CPU),
           "x": TB.column_from_numpy(TT.float64(), np.array([1.5]), capacity=1, device=CPU)}
    out = TC.lower(tcol("d") - tcol("x"), schema, env, 1)
    assert out.data.tolist() == [-1.12] == (np.array([38]) / 10**2 - 1.5).tolist()


@pytest.mark.parametrize("scale", [0, 2, 4, 6])
def test_decimal_to_double_equals_numpy_on_a_seeded_vector(scale):
    rng = np.random.default_rng(40 + scale)
    v = np.concatenate([[38, -38, 1, 10**12 - 1], rng.integers(-(10**12) + 1, 10**12, 5000)])
    c = TB.column_from_numpy(TT.decimal(18, scale), v, capacity=len(v), device=CPU)
    got = TC._coerce(c, TT.float64()).data.numpy()
    np.testing.assert_array_equal(got, v / 10**scale)


def test_reference_jitted_decimal_to_double_is_an_ulp_off():
    """Reference defect 5 (ROADMAP queue C): the reference lowers the
    same subtraction under ``jit``, where XLA multiplies by the
    reciprocal; the port holds to numpy's -1.12."""
    import jax

    jschema = JSchema([JF("d", JT.decimal(12, 2)), JF("x", JT.float64())])

    @jax.jit
    def sub(d, x):
        env = {"d": JB.Column(JT.decimal(12, 2), d, jnp.ones(1, bool)),
               "x": JB.Column(JT.float64(), x, jnp.ones(1, bool))}
        return JC.lower(jcol("d") - jcol("x"), jschema, env, 1).data

    ref = float(np.asarray(sub(jnp.asarray([38], jnp.int64), jnp.asarray([1.5]))[0]))
    assert ref == -1.1199999999999999 != -1.12


# ------------------------------------------------------ CASE, IN, LIKE


def _env(fields, arrays, valids):
    n = len(next(iter(arrays.values())))
    tenv, jenv = {}, {}
    for nm, tt, jt in fields:
        if tt.is_string:
            vals = [None if not ok else s for s, ok in zip(arrays[nm], valids[nm])]
            tenv[nm] = TB.column_from_strings(vals, width=tt.string_width, capacity=n, device=CPU)
            jenv[nm] = JB.column_from_strings(vals, width=jt.string_width, capacity=n).to_device()
        else:
            tenv[nm] = TB.column_from_numpy(tt, arrays[nm], valids[nm], capacity=n, device=CPU)
            jenv[nm] = JB.column_from_numpy(jt, arrays[nm], valids[nm], capacity=n).to_device()
    return n, tenv, jenv


def _lower_pair(texpr, jexpr, fields, arrays, valids):
    """Both lowerings of one expression; equal types, validity and
    valid values (strings as bytes up to their lengths)."""
    n, tenv, jenv = _env(fields, arrays, valids)
    tschema = TSchema([TF(nm, tt) for nm, tt, _ in fields])
    jschema = JSchema([JF(nm, jt) for nm, _, jt in fields])
    tc, jc = TC.lower(texpr, tschema, tenv, n), JC.lower(jexpr, jschema, jenv, n)
    assert repr(tc.dtype) == repr(jc.dtype)
    tv = tc.validity.numpy()
    np.testing.assert_array_equal(tv, np.asarray(jc.validity))
    got, want = TB.column_to_pylist(tc, n), JB.column_to_pylist(jc, n)
    assert got == want
    return got


_WORDS = ["PROMO BRUSHED", "PROMO", "PROM", "STANDARD BRASS", "BRASS", "xgreeny", "green", "gree", "",
          "forest green", "天地 green"]


def _string_fields(rng, n):
    arrays = {"s": [_WORDS[i] for i in rng.integers(0, len(_WORDS), n)],
              "t": [_WORDS[i] for i in rng.integers(0, len(_WORDS), n)],
              "k": rng.integers(-3, 4, n).astype(np.int32),
              "p": rng.integers(-(10**6), 10**6, n)}
    valids = {k: rng.random(n) > 0.2 for k in arrays}
    fields = [("s", TT.string(16), JT.string(16)), ("t", TT.string(32), JT.string(32)),
              ("k", TT.int32(), JT.int32()), ("p", TT.decimal(12, 2), JT.decimal(12, 2))]
    return fields, arrays, valids


@pytest.mark.parametrize("pattern", ["PROMO%", "%BRASS", "%green%", "PROMO", "P%D", "%", "", "%天地%"])
@pytest.mark.parametrize("negated", [False, True], ids=["like", "not-like"])
def test_like_matches_reference_and_python(pattern, negated):
    from blaze_tpu.exprs.ir import Like as JLike
    from blaze_tpu_torch.exprs import Like

    fields, arrays, valids = _string_fields(np.random.default_rng(50), 400)
    got = _lower_pair(Like(tcol("s"), pattern, negated), JLike(jcol("s"), pattern, negated),
                      fields, arrays, valids)
    head, _, rest = pattern.partition("%")
    if not _:
        want = [s == pattern for s in arrays["s"]]
    elif "%" in rest:
        want = [rest[:-1] in s for s in arrays["s"]]
    else:
        want = [len(s) >= len(head) + len(rest) and s.startswith(head) and s.endswith(rest)
                for s in arrays["s"]]
    want = [None if not ok else w != negated for w, ok in zip(want, valids["s"])]
    assert got == want and None in got and len(set(got)) == 3 - (pattern == "%")


@pytest.mark.parametrize("pattern", ["P_OMO%", "%a%b%", "a%b%c"])
def test_like_patterns_for_the_host_evaluator_raise(pattern):
    """These patterns once raised in the lowering; they now go to the
    host evaluator, which equals Python's ``re`` (the broader cases:
    ``test_torch_cast_functions.py``)."""
    import re

    from blaze_tpu_torch.exprs import Like

    fields, arrays, valids = _string_fields(np.random.default_rng(51), 10)
    n, tenv, _ = _env(fields, arrays, valids)
    assert TC.like_needs_host(pattern)
    got = TC.lower(Like(tcol("s"), pattern), TSchema([TF(nm, tt) for nm, tt, _ in fields]), tenv, n)
    rx = re.compile("^" + pattern.replace("%", ".*").replace("_", ".") + "$", re.DOTALL)
    want = [bool(rx.match(s)) if ok else None for s, ok in zip(arrays["s"], valids["s"])]
    assert TB.column_to_pylist(got, n) == want


def test_in_list_three_valued_matches_reference():
    """A null child is null; no match with a null in the list is null;
    NOT IN negates the value and keeps the validity."""
    fields, arrays, valids = _string_fields(np.random.default_rng(52), 500)
    from blaze_tpu.exprs.ir import InList as JIn
    from blaze_tpu_torch.exprs import InList

    cases = [
        (tcol("k").isin(1, 2), jcol("k").isin(1, 2)),
        (tcol("k").isin(1, None), jcol("k").isin(1, None)),
        (InList(tcol("k"), [tlit(1), tlit(None)], True), JIn(jcol("k"), [jlit(1), jlit(None)], True)),
        (InList(tcol("s"), [tlit("PROMO"), tlit("green")], True), JIn(jcol("s"), [jlit("PROMO"), jlit("green")], True)),
        (tcol("s").isin("BRASS", tcol("t")), jcol("s").isin("BRASS", jcol("t"))),
        (tcol("p").isin(tlit("1.5", TT.decimal(3, 1)), 2), jcol("p").isin(jlit("1.5", JT.decimal(3, 1)), 2)),
    ]
    got = [_lower_pair(t, j, fields, arrays, valids) for t, j in cases]
    k, kv = arrays["k"], valids["k"]
    assert got[0] == [None if not ok else int(x) in (1, 2) for x, ok in zip(k, kv)]
    assert got[1] == [None if not ok else (True if x == 1 else None) for x, ok in zip(k, kv)]
    assert got[2] == [None if not ok else (False if x == 1 else None) for x, ok in zip(k, kv)]
    assert True in got[3] and False in got[3] and None in got[3]


def test_case_matches_reference_with_nulls_strings_and_no_else():
    from blaze_tpu.exprs.ir import Case as JCase
    from blaze_tpu_torch.exprs import Case, Like

    fields, arrays, valids = _string_fields(np.random.default_rng(53), 500)
    cases = [
        # q12's shape: int branches
        (Case([(tcol("k").isin(1, 2), tlit(1))], tlit(0)), JCase([(jcol("k").isin(1, 2), jlit(1))], jlit(0))),
        # q14's shape: a decimal value or an int ELSE, a LIKE condition
        (Case([(Like(tcol("s"), "PROMO%"), tcol("p"))], tlit(0)),
         JCase([(jcol("s").like("PROMO%"), jcol("p"))], jlit(0))),
        # string branches of two widths, no ELSE (null), a null condition
        (Case([(tcol("k") > 0, tcol("s")), (tcol("k") < -1, tcol("t"))]),
         JCase([(jcol("k") > 0, jcol("s")), (jcol("k") < -1, jcol("t"))])),
        (Case([(tcol("k") == 0, tlit("zero")), (tcol("k") == 1, tlit(None))], tcol("s")),
         JCase([(jcol("k") == 0, jlit("zero")), (jcol("k") == 1, jlit(None))], jcol("s"))),
    ]
    got = [_lower_pair(t, j, fields, arrays, valids) for t, j in cases]
    k, kv = arrays["k"], valids["k"]
    assert got[0] == [1 if ok and x in (1, 2) else 0 for x, ok in zip(k, kv)]
    s, sv, t, tv = arrays["s"], valids["s"], arrays["t"], valids["t"]
    want = [(s[i] if sv[i] else None) if kv[i] and k[i] > 0 else
            (t[i] if tv[i] else None) if kv[i] and k[i] < -1 else None for i in range(len(k))]
    assert got[2] == want and len({w for w in want if w}) > 3


# ---------------------------------------------------------- division


def _half_up_quotient(a: int, b: int, shift: int):
    """Exact Spark HALF_UP of (a * 10^shift) / b, in python ints."""
    num, den = abs(a) * 10 ** max(shift, 0), abs(b) * 10 ** max(-shift, 0)
    q = (2 * num + den) // (2 * den)
    return -q if (a < 0) != (b < 0) else q


def _check_decimal_div(ta, tb, a, b, valid_b=None):
    fields = [("a", ta, JT.decimal(ta.precision, ta.scale)), ("b", tb, JT.decimal(tb.precision, tb.scale))]
    n = len(a)
    valids = {"a": np.ones(n, bool), "b": np.ones(n, bool) if valid_b is None else valid_b}
    tschema = TSchema([TF(nm, tt) for nm, tt, _ in fields])
    _, tenv, _ = _env(fields, {"a": a, "b": b}, valids)
    out = TC.lower(tcol("a") / tcol("b"), tschema, tenv, n)
    out_t = TC.infer_dtype(tcol("a") / tcol("b"), tschema)
    assert repr(out.dtype) == repr(out_t)
    shift = out_t.scale - ta.scale + tb.scale
    want = []
    for x, y, ok in zip(a.tolist(), b.tolist(), valids["b"]):
        q = _half_up_quotient(x, y, shift) if ok and y != 0 else None
        if q is not None and (abs(q) >= 10**out_t.precision or not -(2**63) <= q < 2**63):
            q = None
        want.append(q)
    got = [int(d) if v else None for d, v in zip(out.data.tolist(), out.validity.tolist())]
    assert got == want
    return out, fields, valids


def test_decimal_division_int64_path_is_exact_half_up():
    """decimal(5,2) / decimal(5,2) -> decimal(13,8): precision + shift
    <= 18, the int64 path.  Every sign pair, exact halves, a zero
    divisor (null) and a null divisor.  The reference's int64 path is
    wrong where the numerator is >= 0 and the divisor < 0 (ROADMAP
    queue C, reference defect 7): 0.05 / -0.02 gives -2.49999999."""
    rng = np.random.default_rng(60)
    a = np.concatenate([[200, -200, 200, -200, 5, -5, 5, 0, 7], rng.integers(-99999, 100000, 2000)])
    b = np.concatenate([[-300, 300, 300, -300, -2, 2, 0, -7, 1], rng.integers(-99999, 100000, 2000)])
    vb = np.ones(len(a), bool)
    vb[8] = False
    out, _, _ = _check_decimal_div(TT.decimal(5, 2), TT.decimal(5, 2), a, b, vb)
    assert repr(out.dtype) == "decimal(13,8)"
    assert out.data[:6].tolist() == [-66666667, -66666667, 66666667, 66666667, -250000000, -250000000]
    assert out.validity[6:9].tolist() == [False, True, False]

    _, jt, jenv = _env([("a", TT.decimal(5, 2), JT.decimal(5, 2)), ("b", TT.decimal(5, 2), JT.decimal(5, 2))],
                       {"a": a[4:5], "b": b[4:5]}, {"a": np.ones(1, bool), "b": np.ones(1, bool)})
    jschema = JSchema([JF("a", JT.decimal(5, 2)), JF("b", JT.decimal(5, 2))])
    assert np.asarray(JC.lower(jcol("a") / jcol("b"), jschema, jenv, 1).data).tolist() == [-249999999]


@pytest.mark.parametrize("types", [
    ((38, 6), (36, 4)),     # q14: 100.00 * sp / sr, the int128 path with a positive shift
    ((20, 0), (10, 2)),     # a shift past int64
    ((38, 10), (38, 30)),   # a negative shift: the divisor folds, tiny quotients
    ((38, 2), (20, 19)),    # a shift of -19: the largest int128 compare
    ((38, 0), (38, 37)),    # a shift past -19: every folded divisor passes int64
], ids=lambda t: f"{t[0]}/{t[1]}")
def test_decimal_division_int128_paths_match_reference_and_python(types):
    (pa, sa), (pb, sb) = types
    rng = np.random.default_rng(pa * 100 + pb)
    n = 1500
    a = np.concatenate([[2**63 - 1, -(2**63) + 1, 10**17, 5, -5, 0],
                        rng.integers(-(2**62), 2**62, n // 2), rng.integers(-(10**9), 10**9, n // 2)])
    b = np.concatenate([[3, -7, 2, 10, -10, 9],
                        rng.integers(-(10**6), 10**6, n // 2), rng.integers(-(2**62), 2**62, n // 2)])
    b[7] = 0
    ta, tb = TT.decimal(pa, sa), TT.decimal(pb, sb)
    out, fields, valids = _check_decimal_div(ta, tb, a, b)
    assert out.validity.any() and not out.validity.all()
    _lower_both(tcol("a") / tcol("b"), jcol("a") / jcol("b"), fields, {"a": a, "b": b}, valids)


def test_decimal_remainder_matches_reference():
    rng = np.random.default_rng(61)
    n = 800
    a = np.concatenate([[-(2**62), 7, -7, 7], rng.integers(-(10**11), 10**11, n)])
    b = np.concatenate([[-1, 0, 3, -3], rng.integers(-(10**4), 10**4, n)])
    valids = {"a": rng.random(n + 4) > 0.1, "b": np.ones(n + 4, bool)}
    fields = [("a", TT.decimal(12, 2), JT.decimal(12, 2)), ("b", TT.decimal(6, 1), JT.decimal(6, 1))]
    out = _lower_both(tcol("a") % tcol("b"), jcol("a") % jcol("b"), fields, {"a": a, "b": b}, valids)
    assert repr(out.dtype) == "decimal(12,2)"
    assert out.validity[1].item() is False


@pytest.mark.parametrize("kind", ["float64", "float32", "int32", "int64", "decimal-double"])
def test_float_and_integer_division_and_remainder_match_reference(kind):
    """``/`` is double division; ``%`` keeps the dividend's sign; a zero
    divisor is null for both."""
    rng = np.random.default_rng(62)
    n = 900
    if kind.startswith("float"):
        a = np.concatenate([[5.5, -5.5, 1.0, -0.0], rng.standard_normal(n) * 1e3])
        b = np.concatenate([[2.0, 2.0, 0.0, 3.0], rng.standard_normal(n)])
        t = (TT.float64(), JT.float64()) if kind == "float64" else (TT.float32(), JT.float32())
        dt = np.float64 if kind == "float64" else np.float32
        a, b = a.astype(dt), b.astype(dt)
        fields = [("a", *t), ("b", *t)]
    elif kind == "decimal-double":
        a = rng.integers(-(10**9), 10**9, n + 4)
        b = np.concatenate([[0.0, 2.5, -1.0, 3.0], rng.standard_normal(n)])
        fields = [("a", TT.decimal(12, 2), JT.decimal(12, 2)), ("b", TT.float64(), JT.float64())]
    else:
        dt = np.int32 if kind == "int32" else np.int64
        lo = np.iinfo(dt).min
        a = np.concatenate([[7, -7, lo, 5], rng.integers(-1000, 1000, n)]).astype(dt)
        b = np.concatenate([[2, 2, -1, 0], rng.integers(-9, 10, n)]).astype(dt)
        t = (TT.int32(), JT.int32()) if kind == "int32" else (TT.int64(), JT.int64())
        fields = [("a", *t), ("b", *t)]
    valids = {"a": rng.random(n + 4) > 0.1, "b": np.ones(n + 4, bool)}
    div = _lower_both(tcol("a") / tcol("b"), jcol("a") / jcol("b"), fields, {"a": a, "b": b}, valids)
    assert repr(div.dtype) == "float64"
    if kind != "decimal-double":
        rem = _lower_both(tcol("a") % tcol("b"), jcol("a") % jcol("b"), fields, {"a": a, "b": b}, valids)
        want = np.fmod(a, np.where(b == 0, 1, b))
        v = rem.validity.numpy()
        np.testing.assert_array_equal(rem.data.numpy()[v], want[v])
        assert not v[(b == 0)].any()
