"""Spark-exact hashes over torch tensors (≙ ``blaze_tpu/exprs/hash.py``).

Murmur3_x86_32 with seed 42 (the shuffle partitioning hash) and
XXH64 (the join key hash), bit-exact with Spark: golden vectors in
``tests/test_hash.py`` hold both packages to them.

torch has no uint32/uint64 arithmetic on the CPU, so unsigned words
travel in int64: murmur3's 32-bit words as int64 values masked to
``0xFFFFFFFF``, XXH64's 64-bit words as int64 bit patterns (wrapping
multiply and add, logical shifts through ``int128.srl``).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ..batch import Column
from ..schema import TypeKind
from .int128 import srl

_M32 = 0xFFFFFFFF
_SEED = 42


def _s64(c: int) -> int:
    """An unsigned 64-bit constant as the int64 with its bit pattern."""
    return c - (1 << 64) if c >= 1 << 63 else c


# ---------------------------------------------------------------- murmur3


def _rotl32(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _M32


def _mix_k1(k1):
    k1 = (k1 * 0xCC9E2D51) & _M32
    k1 = _rotl32(k1, 15)
    return (k1 * 0x1B873593) & _M32


def _mix_h1(h1, k1):
    h1 = _rotl32(h1 ^ k1, 13)
    return (h1 * 5 + 0xE6546B64) & _M32


def _fmix(h1, length):
    h1 = h1 ^ length
    h1 = h1 ^ (h1 >> 16)
    h1 = (h1 * 0x85EBCA6B) & _M32
    h1 = h1 ^ (h1 >> 13)
    h1 = (h1 * 0xC2B2AE35) & _M32
    return h1 ^ (h1 >> 16)


def murmur3_hash_int32(words, seed):
    """Murmur3_x86_32.hashInt over uint32 words (int64-carried)."""
    return _fmix(_mix_h1(seed, _mix_k1(words)), 4)


def murmur3_hash_int64(v: torch.Tensor, seed):
    """Murmur3_x86_32.hashLong: low word, then high word."""
    h1 = _mix_h1(seed, _mix_k1(v & _M32))
    h1 = _mix_h1(h1, _mix_k1(srl(v, 32)))
    return _fmix(h1, 8)


def murmur3_hash_bytes(data: torch.Tensor, lengths: torch.Tensor, seed):
    """Murmur3_x86_32.hashUnsafeBytes over zero-padded (N, W) uint8
    rows: 4-byte little-endian words for the aligned prefix, then the
    tail bytes one at a time, sign-extended (Java byte semantics)."""
    n, w = data.shape
    lengths = lengths.to(torch.int64)
    h1 = seed
    d = data.to(torch.int64)
    for i in range(w // 4):
        b = d[:, 4 * i: 4 * i + 4]
        le = b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16) | (b[:, 3] << 24)
        h1 = torch.where(4 * (i + 1) <= lengths, _mix_h1(h1, _mix_k1(le)), h1)
    aligned = (lengths // 4) * 4
    for pos in range(w):
        in_tail = (pos >= aligned) & (pos < lengths)
        byte = data[:, pos].view(torch.int8).to(torch.int64) & _M32
        h1 = torch.where(in_tail, _mix_h1(h1, _mix_k1(byte)), h1)
    return _fmix(h1, lengths & _M32)


# ---------------------------------------------------------------- xxhash64

_P1 = _s64(0x9E3779B185EBCA87)
_P2 = _s64(0xC2B2AE3D27D4EB4F)
_P3 = _s64(0x165667B19E3779F9)
_P4 = _s64(0x85EBCA77C2B2AE63)
_P5 = _s64(0x27D4EB2F165667C5)


def _rotl64(x, r: int):
    return (x << r) | srl(x, 64 - r)


def _xx_fmix(h):
    h = h ^ srl(h, 33)
    h = h * _P2
    h = h ^ srl(h, 29)
    h = h * _P3
    return h ^ srl(h, 32)


def xxhash64_int32(words, seed):
    """XXH64 of a 4-byte value (its uint32 word, int64-carried)."""
    h = seed + _P5 + 4
    h = h ^ (words * _P1)
    h = _rotl64(h, 23) * _P2 + _P3
    return _xx_fmix(h)


def xxhash64_int64(v, seed):
    h = seed + _P5 + 8
    h = h ^ (_rotl64(v * _P2, 31) * _P1)
    h = _rotl64(h, 27) * _P1 + _P4
    return _xx_fmix(h)


def _xx_merge(hash_, v):
    hash_ = hash_ ^ (_rotl64(v * _P2, 31) * _P1)
    return hash_ * _P1 + _P4


def xxhash64_bytes(data: torch.Tensor, lengths: torch.Tensor, seed):
    """XXH64 over zero-padded (N, W) uint8 rows (Spark's
    XXH64.hashUnsafeBytes: unsigned tail bytes, little-endian words)."""
    n, w = data.shape
    lengths = lengths.to(torch.int64)
    n_words = (w + 7) // 8
    padded_w = n_words * 8
    d = data.to(torch.int64)
    if padded_w != w:
        d = torch.nn.functional.pad(d, (0, padded_w - w))
    b = d.reshape(n, n_words, 8)
    words = b[..., 0]
    for j in range(1, 8):
        words = words | (b[..., j] << (8 * j))
    seed = torch.as_tensor(seed, dtype=torch.int64, device=data.device).expand(n)
    if n_words // 4:
        v1, v2, v3, v4 = seed + _P1 + _P2, seed + _P2, seed.clone(), seed - _P1
        rnd = lambda v, wd: _rotl64(v + wd * _P2, 31) * _P1
        for s in range(n_words // 4):
            ok = 32 * (s + 1) <= lengths
            v1 = torch.where(ok, rnd(v1, words[:, 4 * s + 0]), v1)
            v2 = torch.where(ok, rnd(v2, words[:, 4 * s + 1]), v2)
            v3 = torch.where(ok, rnd(v3, words[:, 4 * s + 2]), v3)
            v4 = torch.where(ok, rnd(v4, words[:, 4 * s + 3]), v4)
        merged = _rotl64(v1, 1) + _rotl64(v2, 7) + _rotl64(v3, 12) + _rotl64(v4, 18)
        for v in (v1, v2, v3, v4):
            merged = _xx_merge(merged, v)
        h = torch.where(lengths >= 32, merged, seed + _P5)
    else:
        h = seed + _P5
    h = h + lengths
    stripe_end = (lengths // 32) * 32
    for i in range(n_words):
        pos = 8 * i
        ok = (pos >= stripe_end) & (pos + 8 <= lengths)
        step = _rotl64(h ^ (_rotl64(words[:, i] * _P2, 31) * _P1), 27) * _P1 + _P4
        h = torch.where(ok, step, h)
    word_end = (lengths // 8) * 8
    halves = d.reshape(n, padded_w // 4, 4)
    half_words = halves[..., 0] | (halves[..., 1] << 8) | (halves[..., 2] << 16) | (halves[..., 3] << 24)
    for j in range(padded_w // 4):
        ok = (4 * j == word_end) & (lengths - word_end >= 4)
        h = torch.where(ok, _rotl64(h ^ (half_words[:, j] * _P1), 23) * _P2 + _P3, h)
    tail_start = torch.where(lengths - word_end >= 4, word_end + 4, word_end)
    for pos in range(w):
        ok = (pos >= tail_start) & (pos < lengths)
        h = torch.where(ok, _rotl64(h ^ (d[:, pos] * _P5), 11) * _P1, h)
    return _xx_fmix(h)


# ------------------------------------------------------- column dispatch


def normalize_float(col: Column) -> Tuple[torch.Tensor, TypeKind]:
    """Spark normalizes -0.0 before hashing; returns the float bits
    as int32 (float32) or int64 (float64) and the kind they hash as."""
    d = torch.where(col.data == 0, torch.zeros((), dtype=col.data.dtype, device=col.data.device), col.data)
    if d.dtype == torch.float32:
        return d.view(torch.int32), TypeKind.INT32
    return d.view(torch.int64), TypeKind.INT64


_INT32_KINDS = (TypeKind.BOOL, TypeKind.INT8, TypeKind.INT16, TypeKind.INT32, TypeKind.DATE32)
_INT64_KINDS = (TypeKind.INT64, TypeKind.TIMESTAMP, TypeKind.DECIMAL)


def fixed_width_words(col: Column) -> Tuple[torch.Tensor, int]:
    """(values, width) of a fixed-width column as its hash sees it:
    width 1 is a 4-byte value (bool/int8/int16/int32/date32, float32
    bits), width 2 an 8-byte one (int64/timestamp/decimal, float64
    bits); floats are -0.0-normalized first.  The values keep their
    integer dtype."""
    d, k = col.data, col.dtype.kind
    if col.dtype.is_float:
        d, k = normalize_float(col)
    if k in _INT32_KINDS:
        return d, 1
    if k in _INT64_KINDS:
        return d, 2
    raise NotImplementedError(f"hash over {col.dtype!r}")


def murmur3_columns(cols: Sequence[Column], seed: int = _SEED) -> torch.Tensor:
    """Spark Murmur3Hash(cols, 42) -> int32 hashes (chained per column;
    a null leaves the running hash unchanged)."""
    h = torch.full(cols[0].validity.shape, seed, dtype=torch.int64, device=cols[0].device)
    for c in cols:
        if c.dtype.is_string:
            hv = murmur3_hash_bytes(c.data, c.lengths, h)
        else:
            v, width = fixed_width_words(c)
            v = v.to(torch.int64)
            hv = murmur3_hash_int32(v & _M32, h) if width == 1 else murmur3_hash_int64(v, h)
        h = torch.where(c.validity, hv, h)
    return torch.where(h >= 1 << 31, h - (1 << 32), h).to(torch.int32)


def xxhash64_columns(cols: Sequence[Column], seed: int = _SEED) -> torch.Tensor:
    """Spark XxHash64(cols, 42) -> int64 hashes."""
    h = torch.full(cols[0].validity.shape, seed, dtype=torch.int64, device=cols[0].device)
    for c in cols:
        if c.dtype.is_string:
            hv = xxhash64_bytes(c.data, c.lengths, h)
        else:
            v, width = fixed_width_words(c)
            v = v.to(torch.int64)
            hv = xxhash64_int32(v & _M32, h) if width == 1 else xxhash64_int64(v, h)
        h = torch.where(c.validity, hv, h)
    return h


def pmod(hashes: torch.Tensor, n: int) -> torch.Tensor:
    """Spark's Pmod(hash, numPartitions): the shuffle partition ids."""
    return torch.remainder(hashes.to(torch.int64), n).to(torch.int32)
