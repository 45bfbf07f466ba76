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
