"""String comparisons and the LIKE kernels over zero-padded (N, W)
uint8 columns (≙ ``blaze_tpu/exprs/strings.py``).

Because rows are zero-padded, a string whose tail holds NUL bytes
compares equal to its NUL-trimmed sibling, as in the reference.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..batch import Column
from .int128 import SIGN


def pad_width(data: torch.Tensor, w: int) -> torch.Tensor:
    """(N, W) bytes zero-padded to at least ``w`` columns."""
    return data if data.shape[1] >= w else F.pad(data, (0, w - data.shape[1]))


def _common(a: Column, b: Column):
    w = max(a.data.shape[1], b.data.shape[1])
    return pad_width(a.data, w), pad_width(b.data, w)


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


def _needle(needle: bytes, device) -> torch.Tensor:
    return torch.tensor(list(needle), dtype=torch.uint8, device=device)


def starts_with(col: Column, needle: bytes) -> torch.Tensor:
    n, w = col.data.shape
    if not needle:
        return torch.ones(n, dtype=torch.bool, device=col.device)
    if len(needle) > w:
        return torch.zeros(n, dtype=torch.bool, device=col.device)
    head = col.data[:, : len(needle)]
    return (col.lengths >= len(needle)) & torch.all(head == _needle(needle, col.device), dim=1)


def ends_with(col: Column, needle: bytes) -> torch.Tensor:
    n, w = col.data.shape
    k = len(needle)
    if not k:
        return torch.ones(n, dtype=torch.bool, device=col.device)
    if k > w:
        return torch.zeros(n, dtype=torch.bool, device=col.device)
    # the last k bytes of each row, gathered at its own offset
    start = torch.clamp(col.lengths.to(torch.int64) - k, 0, w - k)
    tail = torch.gather(col.data, 1, start[:, None] + torch.arange(k, device=col.device))
    return (col.lengths >= k) & torch.all(tail == _needle(needle, col.device), dim=1)


def contains(col: Column, needle: bytes) -> torch.Tensor:
    n, w = col.data.shape
    k = len(needle)
    if not k:
        return torch.ones(n, dtype=torch.bool, device=col.device)
    if k > w:
        return torch.zeros(n, dtype=torch.bool, device=col.device)
    # every k-byte window (N, W - k + 1, k), matched where it ends
    # inside the row's length
    hit = torch.all(col.data.unfold(1, k, 1) == _needle(needle, col.device), dim=2)
    ends = torch.arange(k, w + 1, device=col.device)
    return torch.any(hit & (ends[None, :] <= col.lengths[:, None]), dim=1)
