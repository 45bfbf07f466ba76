"""Wrappers of the hand-written CUDA kernels, with their plain
PyTorch versions (≙ ``blaze_tpu/kernels/pallas_ops.py``).

Each wrapper dispatches on the device of its inputs: a CPU tensor
takes the plain version, a CUDA tensor launches the kernel (building
the library on first use) or raises.  Nothing falls back.  The plain
versions are what the CPU tests run and what ``chip_smoke.py`` holds
the kernels against on the card.

``LAUNCHES`` counts kernel launches (never plain-version calls), so a
run can show that its path went through the kernels.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Sequence, Tuple

import torch

from ..batch import Column
from ..exprs.hash import fixed_width_words, murmur3_hash_int32, murmur3_hash_int64
from ..exprs.int128 import SIGN

LAUNCHES: Dict[str, int] = {
    "murmur3_pids": 0, "sorted_lookup": 0, "pid_histogram": 0, "fused_group_sums": 0,
}
# key columns one murmur3_pids launch takes (kMaxKeys in the source);
# longer key lists chain launches through the running hash
KEYS_PER_LAUNCH = 8


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check(dev: torch.device, name: str, tensors: Sequence[torch.Tensor]) -> None:
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if dev.type == "cuda" and not t.is_contiguous():
            raise ValueError(f"{name}: kernel inputs must be contiguous")


def _launch(fn, *args) -> None:
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{fn.__name__}: CUDA error {err}")


# ---------------------------------------------------------------- murmur3

def column_word_planes(col: Column) -> Tuple[torch.Tensor, int]:
    """(plane, width) of a fixed-width key column for murmur3_pids:
    width 1 is an (N,) int32 plane of uint32 words; width 2 is the
    (N,) int64 data itself, whose little-endian words are the low then
    the high word the reference splits into two planes.  Floats are
    -0.0-normalized bit views.  Strings raise NotImplementedError:
    they take the plain murmur3 path, as in the reference."""
    if col.dtype.is_string:
        raise NotImplementedError("string keys use the plain murmur3 path")
    v, width = fixed_width_words(col)
    return v.to(torch.int32 if width == 1 else torch.int64).contiguous(), width


def murmur3_pids_plain(planes, widths, valids, n_parts: int) -> torch.Tensor:
    """Plain version: murmur3 words carried in int64 (torch has no
    uint32 arithmetic on the CPU)."""
    h = torch.full(planes[0].shape, 42, dtype=torch.int64, device=planes[0].device)
    for p, w, v in zip(planes, widths, valids):
        if w == 1:
            hv = murmur3_hash_int32(p.to(torch.int64) & 0xFFFFFFFF, h)
        else:
            hv = murmur3_hash_int64(p, h)
        h = torch.where(v, hv, h)
    signed = torch.where(h >= 1 << 31, h - (1 << 32), h)
    return torch.remainder(signed, n_parts).to(torch.int32)


def murmur3_pids(
    planes: Sequence[torch.Tensor],
    widths: Sequence[int],
    valids: Sequence[torch.Tensor],
    n_parts: int,
) -> torch.Tensor:
    """Spark murmur3(seed 42) + pmod partition ids of K key columns:
    ``planes`` from :func:`column_word_planes`, one bool validity per
    column.  Returns (N,) int32.  On the card, every KEYS_PER_LAUNCH
    columns are one launch, each starting from the hash the one
    before it wrote."""
    k = len(planes)
    if k < 1 or len(widths) != k or len(valids) != k:
        raise ValueError("murmur3_pids: at least one key column, with widths/valids each")
    if n_parts < 1:
        raise ValueError(f"murmur3_pids: n_parts {n_parts} < 1")
    n = planes[0].shape[0]
    for p, w, v in zip(planes, widths, valids):
        want = {1: torch.int32, 2: torch.int64}.get(w)
        if p.dtype != want or p.shape != (n,) or v.dtype != torch.bool or v.shape != (n,):
            raise ValueError(f"murmur3_pids: plane {p.dtype}{tuple(p.shape)} width {w}, "
                             f"validity {v.dtype}{tuple(v.shape)}")
    dev = planes[0].device
    _check(dev, "murmur3_pids", list(planes) + list(valids))
    if dev.type == "cpu":
        return murmur3_pids_plain(planes, widths, valids, n_parts)
    out = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return out
    from .build import library

    lib = library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    for c0 in range(0, k, KEYS_PER_LAUNCH):
        c1 = min(c0 + KEYS_PER_LAUNCH, k)
        data_ptrs = (ctypes.c_void_p * (c1 - c0))(*[p.data_ptr() for p in planes[c0:c1]])
        valid_ptrs = (ctypes.c_void_p * (c1 - c0))(*[v.data_ptr() for v in valids[c0:c1]])
        width_arr = (ctypes.c_int32 * (c1 - c0))(*widths[c0:c1])
        _launch(
            lib.blaze_murmur3_pids,
            ctypes.cast(data_ptrs, ctypes.c_void_p), ctypes.cast(valid_ptrs, ctypes.c_void_p),
            ctypes.cast(width_arr, ctypes.c_void_p), c1 - c0, n,
            out.data_ptr() if c0 else None,  # the hash of columns [0, c0)
            n_parts if c1 == k else 0, out.data_ptr(), stream,
        )
        LAUNCHES["murmur3_pids"] += 1
    return out


# ----------------------------------------------------------- sorted lookup


def sorted_lookup_plain(table: torch.Tensor, probe: torch.Tensor):
    """Plain version: the kernel's two binary searches, vectorized over
    probes, on sign-flipped keys (signed order of ``x ^ SIGN`` is the
    unsigned order of ``x``)."""
    t = table.shape[0]
    tb, qb = table ^ SIGN, probe ^ SIGN

    def bound(strict: bool) -> torch.Tensor:
        lo = torch.zeros(qb.shape, dtype=torch.int64, device=qb.device)
        hi = torch.full(qb.shape, t, dtype=torch.int64, device=qb.device)
        for _ in range(t.bit_length()):
            mid = (lo + hi) // 2
            v = tb[mid.clamp(max=t - 1)]
            right = (v < qb) if strict else (v <= qb)
            active = lo < hi
            lo = torch.where(active & right, mid + 1, lo)
            hi = torch.where(active & ~right, mid, hi)
        return lo.to(torch.int32)

    return bound(True), bound(False)


def sorted_lookup(table: torch.Tensor, probe: torch.Tensor):
    """(lo, hi) per probe key: ``lo = #{t < q}``, ``hi = #{t <= q}``
    over ``table`` (int64 bit patterns of uint64 keys, sorted in
    unsigned order), comparing as unsigned.  Returns two (N,) int32."""
    if table.dtype != torch.int64 or probe.dtype != torch.int64 or table.dim() != 1 or probe.dim() != 1:
        raise ValueError("sorted_lookup: 1-D int64 table and probe keys")
    if table.shape[0] >= 2**31:
        raise ValueError("sorted_lookup: table too long for int32 bounds")
    dev = probe.device
    _check(dev, "sorted_lookup", [table, probe])
    if dev.type == "cpu":
        return sorted_lookup_plain(table, probe)
    n = probe.shape[0]
    lo = torch.empty(n, dtype=torch.int32, device=dev)
    hi = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return lo, hi
    from .build import library

    _launch(
        library().blaze_sorted_lookup,
        table.data_ptr(), table.shape[0], probe.data_ptr(), n, lo.data_ptr(), hi.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    LAUNCHES["sorted_lookup"] += 1
    return lo, hi


# ----------------------------------------------------------- pid histogram


def pid_histogram_plain(pids: torch.Tensor, n_parts: int) -> torch.Tensor:
    """Plain version: a masked scatter-add of ones."""
    counted = (pids >= 0) & (pids < n_parts)
    out = torch.zeros(n_parts, dtype=torch.int32, device=pids.device)
    return out.scatter_add_(0, torch.where(counted, pids, 0).to(torch.int64), counted.to(torch.int32))


def pid_histogram(pids: torch.Tensor, n_parts: int) -> torch.Tensor:
    """Rows per partition of (N,) int32 ``pids``; a pid outside
    ``[0, n_parts)`` (padding's -1) is not counted.  Returns
    (n_parts,) int32."""
    if pids.dtype != torch.int32 or pids.dim() != 1:
        raise ValueError(f"pid_histogram: 1-D int32 pids, not {pids.dtype}{tuple(pids.shape)}")
    if n_parts < 1:
        raise ValueError(f"pid_histogram: n_parts {n_parts} < 1")
    if pids.shape[0] >= 2**31:
        raise ValueError("pid_histogram: too many rows for int32 counts")
    dev = pids.device
    _check(dev, "pid_histogram", [pids])
    if dev.type == "cpu":
        return pid_histogram_plain(pids, n_parts)
    out = torch.zeros(n_parts, dtype=torch.int32, device=dev)
    if pids.shape[0] == 0:
        return out
    from .build import library

    _launch(library().blaze_pid_histogram, pids.data_ptr(), pids.shape[0], n_parts,
            out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    LAUNCHES["pid_histogram"] += 1
    return out


# -------------------------------------------------------- fused group sums

# value columns one fused_group_sums launch takes (kMaxValues in the
# source); more columns take one launch per group of them
VALUES_PER_LAUNCH = 8


def fused_group_sums_plain(gids: torch.Tensor, values: Sequence[torch.Tensor], n_groups: int) -> torch.Tensor:
    """Plain version: one-hot (rows, G) membership times each value
    column, summed over the rows (the TPU kernel's one-hot form), over
    chunks of rows that keep the one-hot block near 2^24 entries."""
    groups = torch.arange(n_groups, device=gids.device)
    out = torch.zeros((len(values), n_groups), dtype=torch.float32, device=gids.device)
    rows = max(1, (1 << 24) // n_groups)
    for r0 in range(0, gids.shape[0], rows):
        onehot = (gids[r0:r0 + rows].unsqueeze(1) == groups).to(torch.float32)
        out += torch.stack([(onehot * v[r0:r0 + rows].unsqueeze(1)).sum(0) for v in values])
    return out


def fused_group_sums(gids: torch.Tensor, values: Sequence[torch.Tensor], n_groups: int) -> torch.Tensor:
    """Sums of K (N,) float32 ``values`` per group id in
    ``[0, n_groups)``; a gid outside it (a filtered-out row's -1)
    contributes nothing.  Returns (K, n_groups) float32."""
    k = len(values)
    if gids.dtype != torch.int32 or gids.dim() != 1:
        raise ValueError(f"fused_group_sums: 1-D int32 gids, not {gids.dtype}{tuple(gids.shape)}")
    if k < 1 or n_groups < 1:
        raise ValueError(f"fused_group_sums: {k} value columns, {n_groups} groups")
    n = gids.shape[0]
    for v in values:
        if v.dtype != torch.float32 or v.shape != (n,):
            raise ValueError(f"fused_group_sums: values {v.dtype}{tuple(v.shape)}, want float32 ({n},)")
    dev = gids.device
    _check(dev, "fused_group_sums", [gids, *values])
    if dev.type == "cpu":
        return fused_group_sums_plain(gids, values, n_groups)
    out = torch.zeros((k, n_groups), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    from .build import library

    lib = library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    for c0 in range(0, k, VALUES_PER_LAUNCH):
        c1 = min(c0 + VALUES_PER_LAUNCH, k)
        ptrs = (ctypes.c_void_p * (c1 - c0))(*[v.data_ptr() for v in values[c0:c1]])
        _launch(lib.blaze_fused_group_sums, gids.data_ptr(), ctypes.cast(ptrs, ctypes.c_void_p),
                c1 - c0, n_groups, n, out[c0].data_ptr(), stream)
        LAUNCHES["fused_group_sums"] += 1
    return out


__all__: List[str] = [
    "LAUNCHES", "column_word_planes", "fused_group_sums",
    "fused_group_sums_plain", "murmur3_pids", "murmur3_pids_plain", "pid_histogram",
    "pid_histogram_plain", "reset_launch_counts", "sorted_lookup", "sorted_lookup_plain",
]
