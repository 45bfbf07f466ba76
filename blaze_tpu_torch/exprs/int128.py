"""Two-limb int128 arithmetic over torch int64 tensors
(≙ ``blaze_tpu/exprs/int128.py``).

A signed 128-bit value ``v`` is carried as ``(hi, lo)`` with
``v = hi * 2^64 + lo``: ``hi`` is a signed int64, ``lo`` is the bit
pattern of an unsigned 64-bit word held in an int64 tensor (torch has
no uint64 arithmetic on the CPU).  Unsigned words therefore follow
three rules: multiplication and addition wrap in two's complement
exactly as uint64 does; a logical right shift is the arithmetic shift
then a mask; unsigned order is signed order after flipping the sign
bit (``x ^ SIGN``).
"""

from __future__ import annotations

import torch

SIGN = -(1 << 63)        # the int64 with only the sign bit set
_M32 = 0xFFFFFFFF
_TWO64 = 18446744073709551616.0


def srl(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of the 64-bit pattern by ``0 < k < 64``."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def ult(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unsigned 64-bit ``a < b``."""
    return (a ^ SIGN) < (b ^ SIGN)


def from_i64(v: torch.Tensor):
    """Sign-extend an int64 tensor to (hi, lo)."""
    return v >> 63, v


def to_i64(hi: torch.Tensor, lo: torch.Tensor):
    """(value as int64, fits) — exact narrowing check."""
    return lo, hi == (lo >> 63)


def neg(hi: torch.Tensor, lo: torch.Tensor):
    """Two's complement negate: (~hi, ~lo) + 1."""
    return (~hi) + (lo == 0).to(torch.int64), (~lo) + 1


def add(ahi, alo, bhi, blo):
    lo = alo + blo
    return ahi + bhi + ult(lo, alo).to(torch.int64), lo


def sub(ahi, alo, bhi, blo):
    return add(ahi, alo, *neg(bhi, blo))


def abs128(hi, lo):
    nhi, nlo = neg(hi, lo)
    n = hi < 0
    return torch.where(n, nhi, hi), torch.where(n, nlo, lo)


def mul_u64(a: torch.Tensor, b: torch.Tensor):
    """Unsigned 64x64 -> 128 over 32-bit limbs: (hi, lo) words."""
    a0, a1 = a & _M32, srl(a, 32)
    b0, b1 = b & _M32, srl(b, 32)
    p00, p01, p10, p11 = a0 * b0, a0 * b1, a1 * b0, a1 * b1
    mid = srl(p00, 32) + (p01 & _M32) + (p10 & _M32)
    lo = (p00 & _M32) | ((mid & _M32) << 32)
    hi = p11 + srl(p01, 32) + srl(p10, 32) + srl(mid, 32)
    return hi, lo


def mul_i64(a: torch.Tensor, b: torch.Tensor):
    """Exact signed 64x64 -> 128 multiply."""
    sign = (a < 0) ^ (b < 0)
    # -(-2^63) wraps to itself, whose unsigned pattern is 2^63: exact
    hi, lo = mul_u64(torch.where(a < 0, -a, a), torch.where(b < 0, -b, b))
    nhi, nlo = neg(hi, lo)
    return torch.where(sign, nhi, hi), torch.where(sign, nlo, lo)


def mul_small(hi, lo, m: int):
    """(hi, lo) * m for 0 < m < 2^31, sign carried by hi; exact while
    the true product fits 128 bits."""
    neg_in = hi < 0
    ah, al = abs128(hi, lo)
    l0 = (al & _M32) * m
    l1 = srl(al, 32) * m
    mid = srl(l0, 32) + (l1 & _M32)
    lo_out = (l0 & _M32) | ((mid & _M32) << 32)
    hi_out = ah * m + srl(l1, 32) + srl(mid, 32)
    nh, nl = neg(hi_out, lo_out)
    return torch.where(neg_in, nh, hi_out), torch.where(neg_in, nl, lo_out)


def mul_pow10(hi, lo, k: int):
    """(hi, lo) * 10^k for k >= 0, in factors of at most 10^9 (each
    below 2^31)."""
    while k > 0:
        step = min(k, 9)
        hi, lo = mul_small(hi, lo, 10**step)
        k -= step
    return hi, lo


def _to_f64(hi, lo):
    """Approximate signed-128 -> float64 without cancellation:
    v = (hi + carry) * 2^64 + lo_signed, carry = lo >= 2^63."""
    return (hi + srl(lo, 63)).to(torch.float64) * _TWO64 + lo.to(torch.float64)


def _f64_to_u64(q: torch.Tensor) -> torch.Tensor:
    """Non-negative float64 below 2^64 -> its uint64 pattern."""
    big = q >= 9223372036854775808.0
    return torch.where(big, (q - _TWO64).to(torch.int64), torch.where(big, 0.0, q).to(torch.int64))


def div_round_half_up(hi, lo, den):
    """round_half_up((hi, lo) / den) -> (q int64, ok).

    ``den`` int64, nonzero (the caller masks zeros).  A float64
    quotient estimate refined by exact int128 residuals (two
    correction passes, then a +-2 exact clamp), as the reference
    does; ``ok`` is False where the quotient overflows int64."""
    sign = (hi < 0) ^ (den < 0)
    nhi, nlo = abs128(hi, lo)
    uden = torch.where(den < 0, -den, den)
    zero = torch.zeros_like(nhi)
    # HALF_UP = floor((|num| + |den| / 2) / |den|), sign applied after
    nhi, nlo = add(nhi, nlo, zero, srl(uden, 1))
    fden = uden.to(torch.float64)
    q = _f64_to_u64(torch.clamp(torch.floor(_to_f64(nhi, nlo) / fden), 0.0, _TWO64 - 4096.0))
    for _ in range(2):
        ph, pl = mul_u64(q, uden)
        rh, rl = sub(nhi, nlo, ph, pl)
        adj = torch.clamp(torch.floor(_to_f64(rh, rl) / fden), -9.2e18, 9.2e18)
        q = q + adj.to(torch.int64)
    for _ in range(2):
        ph, pl = mul_u64(q, uden)
        rh, _ = sub(nhi, nlo, ph, pl)
        q = q - (rh < 0).to(torch.int64)
    ph, pl = mul_u64(q, uden)
    rh, rl = sub(nhi, nlo, ph, pl)
    too_big = (rh > 0) | ((rh == 0) & ~ult(rl, uden))
    q = q + too_big.to(torch.int64)
    # magnitude 2^63 is representable only when negative
    ok = (q >= 0) | (sign & (q == SIGN))
    return torch.where(sign, -q, q), ok


def rescale_down(hi, lo, k: int):
    """(hi, lo) / 10^k with HALF_UP -> (q int64, ok); 1 <= k <= 18."""
    assert 1 <= k <= 18, k
    return div_round_half_up(hi, lo, torch.full_like(hi, 10**k))
