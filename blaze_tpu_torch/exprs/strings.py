"""String comparisons over zero-padded (N, W) uint8 columns
(≙ ``blaze_tpu/exprs/strings.py``).

Because rows are zero-padded, a string whose tail holds NUL bytes
compares equal to its NUL-trimmed sibling, as in the reference.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..batch import Column
from .int128 import SIGN


def _common(a: Column, b: Column):
    w = max(a.data.shape[1], b.data.shape[1])
    pad = lambda d: d if d.shape[1] == w else F.pad(d, (0, w - d.shape[1]))
    return pad(a.data), pad(b.data)


def packed_be(data: torch.Tensor) -> torch.Tensor:
    """(N, W) uint8 -> (N, ceil(W/8)) int64 big-endian words whose
    SIGNED order is the bytes' lexicographic order (sign bit
    flipped)."""
    n, w = data.shape
    nw = (w + 7) // 8
    d = data.to(torch.int64)
    if nw * 8 != w:
        d = F.pad(d, (0, nw * 8 - w))
    b = d.reshape(n, nw, 8)
    out = b[..., 0] << 56
    for j in range(1, 8):
        out = out | (b[..., j] << (8 * (7 - j)))
    return out ^ SIGN


def str_eq(a: Column, b: Column) -> torch.Tensor:
    da, db = _common(a, b)
    return torch.all(da == db, dim=1)


def str_lt(a: Column, b: Column) -> torch.Tensor:
    da, db = _common(a, b)
    wa, wb = packed_be(da), packed_be(db)
    lt = torch.zeros(wa.shape[0], dtype=torch.bool, device=wa.device)
    eq = torch.ones_like(lt)
    for k in range(wa.shape[1]):
        lt = lt | (eq & (wa[:, k] < wb[:, k]))
        eq = eq & (wa[:, k] == wb[:, k])
    return lt


def str_le(a: Column, b: Column) -> torch.Tensor:
    return str_lt(a, b) | str_eq(a, b)
