"""Spark-semantics casts between fixed-width types
(≙ ``blaze_tpu/exprs/cast.py`` ``lower_cast``, without the string
routes).  Non-ANSI Spark:

- integer -> narrower integer wraps (Java's ``(int)(long)``);
- float -> integer truncates toward zero, NaN gives 0, and values past
  the target's range clamp to its min/max (Java's cast);
- integer or float -> decimal and decimal -> decimal round HALF_UP, and
  a value past the target precision gives null;
- decimal -> integer truncates the logical value toward zero;
- decimal -> float divides by ``10^scale`` in float64.
"""

from __future__ import annotations

import torch

from ..batch import Column, torch_dtype
from ..schema import DataType, TypeKind

_INT_BOUNDS = {
    TypeKind.INT8: (-(2**7), 2**7 - 1),
    TypeKind.INT16: (-(2**15), 2**15 - 1),
    TypeKind.INT32: (-(2**31), 2**31 - 1),
    TypeKind.INT64: (-(2**63), 2**63 - 1),
}


def rescale_decimal(data: torch.Tensor, from_scale: int, to_scale: int) -> torch.Tensor:
    """Exact int64 rescale, HALF_UP when narrowing."""
    if to_scale == from_scale:
        return data
    if to_scale > from_scale:
        return data * 10 ** (to_scale - from_scale)
    div = 10 ** (from_scale - to_scale)
    adj = torch.where(data >= 0, data + div // 2, data - div // 2)
    return torch.where(adj >= 0, adj // div, -((-adj) // div))


def decimal_overflow_null(data: torch.Tensor, validity: torch.Tensor, precision: int):
    """check_overflow: |unscaled| >= 10^p -> null (precisions past
    int64 are bounded by the int64 narrowing instead)."""
    if precision >= 19:
        return validity
    bound = 10**precision
    return validity & (data < bound) & (data > -bound)


def decimal_to_float(col: Column, to: DataType) -> Column:
    """``unscaled / 10^scale`` in float64.  The divisor is a float64
    tensor on the column's device, not a python float: CUDA multiplies
    by the reciprocal of a host scalar divisor, which can be an ulp off
    the correctly rounded quotient."""
    scale = torch.full((), float(10**col.dtype.scale), dtype=torch.float64, device=col.device)
    data = col.data.to(torch.float64) / scale
    return Column(to, data.to(torch_dtype(to)), col.validity)


def lower_cast(col: Column, to: DataType) -> Column:
    src = col.dtype
    if src == to:
        return col
    if src.is_string or to.is_string:
        raise NotImplementedError(f"cast {src!r} -> {to!r}: the string casts are not ported")
    data, validity = col.data, col.validity
    if src.is_decimal:
        if to.is_decimal:
            out = rescale_decimal(data, src.scale, to.scale)
            return Column(to, out, decimal_overflow_null(out, validity, to.precision))
        if to.is_float:
            return decimal_to_float(col, to)
        if to.is_integer:
            d = 10**src.scale
            trunc = torch.where(data >= 0, data // d, -((-data) // d))
            return Column(to, trunc.to(torch_dtype(to)), validity)
        raise NotImplementedError(f"cast decimal -> {to!r}")
    if to.is_decimal:
        if src.is_integer or src.kind in (TypeKind.BOOL, TypeKind.NULL):
            wide = data.to(torch.int64)
            # a value whose unscaled form passes int64 overflows every
            # precision: null, where the product would wrap into range
            lim = (2**63 - 1) // 10**to.scale
            validity = validity & (wide <= lim) & (wide >= -lim)
            out = torch.where(validity, wide, 0) * 10**to.scale
            return Column(to, out, decimal_overflow_null(out, validity, to.precision))
        if src.is_float:
            scaled = data.to(torch.float64) * float(10**to.scale)
            rounded = torch.where(scaled >= 0, torch.floor(scaled + 0.5), torch.ceil(scaled - 0.5))
            # past int64 (or inf) the unscaled value exists nowhere: null
            fits = rounded.abs() < 2.0**63
            out = torch.where(fits, rounded, 0.0).to(torch.int64)
            validity = decimal_overflow_null(out, validity & fits & ~torch.isnan(data), to.precision)
            return Column(to, out, validity)
        raise NotImplementedError(f"cast {src!r} -> decimal")
    if src.is_float and (to.is_integer or to.kind in (TypeKind.DATE32, TypeKind.TIMESTAMP)):
        lo, hi = _INT_BOUNDS[to.kind if to.is_integer else TypeKind.INT32]
        t = torch.trunc(data.to(torch.float64))
        t = torch.where(torch.isnan(t), 0.0, t)
        # 2^63 - 1 rounds up to 2^63 in float64, past int64: compare in
        # float and put the bound in exactly
        high = t >= float(hi)
        t = torch.where(high, 0.0, t.clamp(min=float(lo))).to(torch_dtype(to))
        return Column(to, torch.where(high, hi, t), validity)
    # every other fixed-width pair converts as it is (integer narrowing wraps)
    return Column(to, data.to(torch_dtype(to)), validity)
