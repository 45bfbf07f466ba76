"""Spark-binary-compatible bloom filter (≙ ``blaze_tpu/exprs/bloom.py``).

Spark 3.5's bloom-filter join and ``might_contain``: double hashing
with Murmur3 hashLong/hashBytes (seed 0, then seeded with the first
hash), Java int wraparound, ``combined = h1 + i * h2`` (complemented
when negative) mod the bit count, and the BloomFilterImpl stream format
(VERSION 1, numHashFunctions, numWords, big-endian longs).

The build runs on the host in numpy (the build side of a join, as in
the reference); the probe runs on the batch's device, a gather over the
bit words.  Unsigned words ride in int64 (torch has no uint64 shift on
the CPU): an arithmetic shift right then ``& 1`` reads the same bit.
"""

from __future__ import annotations

import math
import struct
import threading
from typing import Dict

import numpy as np
import torch

from ..batch import Column
from ..schema import TypeKind
from .hash import murmur3_hash_bytes, murmur3_hash_int64

_LN2 = math.log(2.0)
_M32 = 0xFFFFFFFF


def optimal_num_bits(n_items: int, fpp: float = 0.03) -> int:
    n_items = max(1, n_items)
    bits = int(-n_items * math.log(fpp) / (_LN2 * _LN2))
    return max(64, (bits + 63) // 64 * 64)


def optimal_num_hashes(n_items: int, n_bits: int) -> int:
    n_items = max(1, n_items)
    return max(1, int(round(n_bits / n_items * _LN2)))


def _mm3_long_np(v: np.ndarray, seed: np.ndarray) -> np.ndarray:
    """numpy Murmur3_x86_32.hashLong (int32 out)."""
    def mix_k1(k1):
        k1 = k1 * np.uint32(0xCC9E2D51)
        k1 = (k1 << np.uint32(15)) | (k1 >> np.uint32(17))
        return k1 * np.uint32(0x1B873593)

    def mix_h1(h1, k1):
        h1 = h1 ^ k1
        h1 = (h1 << np.uint32(13)) | (h1 >> np.uint32(19))
        return h1 * np.uint32(5) + np.uint32(0xE6546B64)

    def fmix(h1, n):
        h1 = h1 ^ np.uint32(n)
        h1 ^= h1 >> np.uint32(16)
        h1 = h1 * np.uint32(0x85EBCA6B)
        h1 ^= h1 >> np.uint32(13)
        h1 = h1 * np.uint32(0xC2B2AE35)
        h1 ^= h1 >> np.uint32(16)
        return h1

    with np.errstate(over="ignore"):
        v = v.astype(np.int64)
        low = (v & 0xFFFFFFFF).astype(np.uint32)
        high = ((v >> 32) & 0xFFFFFFFF).astype(np.uint32)
        h1 = mix_h1(seed.astype(np.uint32), mix_k1(low))
        h1 = mix_h1(h1, mix_k1(high))
        return fmix(h1, 8).view(np.int32)


def _bit_indexes_np(v: np.ndarray, num_hashes: int, num_bits: int):
    """The ``num_hashes`` bit indexes (int64 arrays) of each value."""
    h1 = _mm3_long_np(v, np.zeros(len(v), np.uint32))
    h2 = _mm3_long_np(v, h1.view(np.uint32))
    with np.errstate(over="ignore"):
        for i in range(1, num_hashes + 1):
            combined = h1 + np.int32(i) * h2
            combined = np.where(combined < 0, ~combined, combined)
            yield combined.astype(np.int64) % num_bits


def _as_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 values wrapped to the int32 range, as Java int arithmetic."""
    return ((x + (1 << 31)) & _M32) - (1 << 31)


class SparkBloomFilter:
    def __init__(self, num_bits: int, num_hashes: int):
        assert num_bits % 64 == 0
        self.num_bits = num_bits
        self.num_hashes = num_hashes
        self.words = np.zeros(num_bits // 64, np.uint64)
        self._device_words: Dict[torch.device, torch.Tensor] = {}
        self._lock = threading.Lock()

    @classmethod
    def create(cls, expected_items: int, fpp: float = 0.03) -> "SparkBloomFilter":
        bits = optimal_num_bits(expected_items, fpp)
        return cls(bits, optimal_num_hashes(expected_items, bits))

    # ------------------------------------------------------------- build

    def put_longs(self, values: np.ndarray) -> None:
        for idx in _bit_indexes_np(values.astype(np.int64), self.num_hashes, self.num_bits):
            np.bitwise_or.at(self.words, idx >> 6, np.uint64(1) << (idx & 63).astype(np.uint64))
        self._device_words.clear()

    # ------------------------------------------------------------- probe

    def device_words(self, device: torch.device) -> torch.Tensor:
        """The bit words as an int64 tensor on ``device``, staged once
        per device."""
        with self._lock:
            w = self._device_words.get(device)
            if w is None:
                w = self._device_words[device] = torch.from_numpy(self.words.view(np.int64)).to(device)
            return w

    def might_contain_device(self, col: Column) -> torch.Tensor:
        """The probe on the column's device; a null input gives False
        (join pruning: a null key never matches)."""
        k = col.dtype.kind
        if k in (TypeKind.INT8, TypeKind.INT16, TypeKind.INT32, TypeKind.INT64,
                 TypeKind.DATE32, TypeKind.TIMESTAMP, TypeKind.DECIMAL):
            v = col.data.to(torch.int64)
            h1 = murmur3_hash_int64(v, 0)
            h2 = murmur3_hash_int64(v, h1)
        elif col.dtype.is_string:
            h1 = murmur3_hash_bytes(col.data, col.lengths, 0)
            h2 = murmur3_hash_bytes(col.data, col.lengths, h1)
        else:
            raise NotImplementedError(f"bloom probe over {col.dtype!r}")
        h1, h2 = _as_int32(h1), _as_int32(h2)
        words = self.device_words(col.device)
        out = col.validity.clone()
        for i in range(1, self.num_hashes + 1):
            combined = _as_int32(h1 + i * h2)
            combined = torch.where(combined < 0, ~combined, combined)
            idx = combined % self.num_bits
            out &= ((words[idx >> 6] >> (idx & 63)) & 1) != 0
        return out

    def might_contain_longs(self, values: np.ndarray) -> np.ndarray:
        """The probe on the host, in numpy."""
        out = np.ones(len(values), bool)
        for idx in _bit_indexes_np(values.astype(np.int64), self.num_hashes, self.num_bits):
            out &= ((self.words[idx >> 6] >> (idx & 63).astype(np.uint64)) & np.uint64(1)) != 0
        return out

    # ------------------------------------------------------------- serde

    def serialize(self) -> bytes:
        """Spark BloomFilterImpl stream format (big-endian)."""
        return struct.pack(">iii", 1, self.num_hashes, len(self.words)) + self.words.astype(">u8").tobytes()

    @classmethod
    def deserialize(cls, data: bytes) -> "SparkBloomFilter":
        version, num_hashes, num_words = struct.unpack_from(">iii", data, 0)
        if version != 1:
            raise ValueError(f"unsupported bloom filter version {version}")
        f = cls(num_words * 64, num_hashes)
        f.words = np.frombuffer(data, ">u8", count=num_words, offset=12).astype(np.uint64)
        return f
