"""Spark-semantics casts (≙ ``blaze_tpu/exprs/cast.py`` ``lower_cast``).
Non-ANSI Spark:

- integer -> narrower integer wraps (Java's ``(int)(long)``);
- float -> integer truncates toward zero, NaN gives 0, and values past
  the target's range clamp to its min/max (Java's cast);
- integer or float -> decimal and decimal -> decimal round HALF_UP, and
  a value past the target precision gives null;
- decimal -> integer truncates the logical value toward zero;
- decimal -> float divides by ``10^scale`` in float64;
- string -> bool, integer, decimal or date32 parses on the device over
  the padded byte matrix, null on malformed input or overflow (the
  reference's subset: no exponents, dates strictly yyyy-MM-dd);
- bool, integer, decimal or date32 -> string renders on the device; a
  rendering wider than the target string is null, and so is a year
  outside 0..9999.

String -> float or timestamp and float -> string raise
``NotImplementedError``, as in the reference.
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


# ------------------------------------------------------------ strings


def _string_scan(col: Column):
    """(data, n, w, positions, trimmed start, trimmed end) of a string
    column: the trim strips every byte <= 0x20 and DEL (Spark's
    UTF8String.trimAll); ``end`` is inclusive."""
    data = col.data
    n, w = data.shape
    idx = torch.arange(w, device=data.device)
    in_range = idx[None, :] < col.lengths.to(torch.int64)[:, None]
    nonspace = in_range & (data > 32) & (data != 127)
    start = torch.where(nonspace, idx[None, :], w).min(dim=1).values if w else torch.zeros(n, dtype=torch.int64)
    end = torch.where(nonspace, idx[None, :], -1).max(dim=1).values if w else torch.full((n,), -1)
    return data, n, w, idx, start, end


def _byte_at(data: torch.Tensor, at: torch.Tensor) -> torch.Tensor:
    return torch.gather(data, 1, at.clamp(0, data.shape[1] - 1)[:, None])[:, 0].to(torch.int64)


def _string_to_unscaled(col: Column, scale: int, truncate: bool = False):
    """``[sign][digits][.digits]`` as an unscaled int64 at ``scale``:
    extra fraction digits round HALF_UP (``truncate``: dropped).
    Returns (value, ok); ok is False on malformed input or overflow.
    The magnitude accumulates negated, so -9223372036854775808 parses."""
    data, n, w, idx, start, end = _string_scan(col)
    dev = data.device
    first = _byte_at(data, start)
    neg = first == 45  # '-'
    dstart = start + (neg | (first == 43)).to(torch.int64)
    is_digit = (data >= 48) & (data <= 57)
    is_dot = data == 46
    value = torch.zeros(n, dtype=torch.int64, device=dev)
    frac_seen = torch.zeros(n, dtype=torch.int64, device=dev)
    seen_dot = torch.zeros(n, dtype=torch.bool, device=dev)
    seen_digit = torch.zeros_like(seen_dot)
    bad = torch.zeros_like(seen_dot)
    overflow = torch.zeros_like(seen_dot)
    round_up = torch.zeros_like(seen_dot)
    lim = -(2**63 // 10)
    for j in range(w):
        active = (j >= dstart) & (j <= end)
        digit = is_digit[:, j] & active
        dot = is_dot[:, j] & active
        # any other byte inside the trimmed string is malformed
        bad = bad | (active & ~digit & ~dot) | (dot & seen_dot)
        take = digit & (~seen_dot | (frac_seen < scale))
        d = data[:, j].to(torch.int64) - 48
        will_of = take & ((value < lim) | ((value == lim) & (d > 8)))
        overflow = overflow | will_of
        value = torch.where(take & ~will_of, value * 10 - d, value)
        if not truncate:
            round_up = torch.where(digit & seen_dot & (frac_seen == scale), d >= 5, round_up)
        frac_seen = frac_seen + (digit & seen_dot).to(torch.int64)
        seen_dot = seen_dot | dot
        seen_digit = seen_digit | digit
    pad = (scale - frac_seen).clamp(0, scale)
    for _ in range(scale):
        grow = pad > 0
        will_of = grow & (value < lim)
        overflow = overflow | will_of
        value = torch.where(grow & ~will_of, value * 10, value)
        pad = pad - grow.to(torch.int64)
    overflow = overflow | (round_up & (value == -(2**63)))
    value = value - round_up.to(torch.int64)
    overflow = overflow | (~neg & (value == -(2**63)))
    ok = seen_digit & ~bad & ~overflow & (end >= dstart)
    return torch.where(neg, value, -value), ok


def _int_to_string(values: torch.Tensor, to: DataType, scale: int = 0):
    """int64 values (unscaled decimals with ``scale``) as ASCII rows of
    the target width: (bytes, lengths, fits)."""
    w = to.string_width
    n = values.shape[0]
    dev = values.device
    neg = values < 0
    # digits of the non-positive magnitude, least significant first
    # (INT64_MIN has no positive counterpart)
    rem = torch.where(neg, values, -values)
    digs = []
    for _ in range(20):
        digs.append(-torch.fmod(rem, 10))
        rem = torch.div(rem, 10, rounding_mode="trunc")
    digits = torch.stack(digs, dim=1)  # (n, 20)
    lead_zeros = torch.cumprod((digits == 0).flip(1).to(torch.int64), 1).sum(1)
    ndig = (20 - lead_zeros).clamp(min=1)
    if scale:
        ndig = ndig.clamp(min=scale + 1)  # "0.xx" keeps its leading zero
    negi = neg.to(torch.int64)
    total = ndig + negi + (1 if scale else 0)
    out = torch.zeros((n, w), dtype=torch.uint8, device=dev)
    for p in range(min(w, 22)):
        di = p - negi
        if scale:
            dot_at = total - scale - 1
            is_dot = (dot_at == p) & (total > p)
            di = di - (p > dot_at).to(torch.int64)
        else:
            is_dot = torch.zeros(n, dtype=torch.bool, device=dev)
        ch = torch.gather(digits, 1, (ndig - 1 - di).clamp(0, 19)[:, None])[:, 0] + 48
        ch = torch.where(is_dot, 46, ch)
        if p == 0:
            ch = torch.where(neg, 45, ch)
        out[:, p] = torch.where(total > p, ch, 0).to(torch.uint8)
    return out, total.clamp(max=w).to(torch.int32), total <= w


def _cast_from_string(col: Column, to: DataType) -> Column:
    validity = col.validity
    if to.kind == TypeKind.BOOL:
        data, n, w, idx, start, end = _string_scan(col)
        lower = torch.where((data >= 65) & (data <= 90), data + 32, data)
        tl = end - start + 1

        def word(s: bytes):
            m = tl == len(s)
            for k, ch in enumerate(s):
                m = m & (_byte_at(lower, start + k) == ch)
            return m

        t = word(b"t") | word(b"true") | word(b"y") | word(b"yes") | word(b"1")
        f = word(b"f") | word(b"false") | word(b"n") | word(b"no") | word(b"0")
        return Column(to, t, validity & (t | f))
    if to.is_integer:
        # Spark's UTF8String.toLong: one decimal point, its fraction
        # checked and dropped ("3.7" -> 3)
        v, ok = _string_to_unscaled(col, 0, truncate=True)
        if to.kind != TypeKind.INT64:
            lo, hi = _INT_BOUNDS[to.kind]
            ok = ok & (v >= lo) & (v <= hi)
        return Column(to, v.to(torch_dtype(to)), validity & ok)
    if to.is_decimal:
        v, ok = _string_to_unscaled(col, to.scale)
        return Column(to, v, validity & decimal_overflow_null(v, ok, to.precision))
    if to.kind == TypeKind.DATE32:
        from .functions import civil_from_days, days_from_civil

        data, n, w, idx, start, end = _string_scan(col)
        ok = (end - start + 1) == 10

        def num(k0, k1):
            v = torch.zeros(n, dtype=torch.int64, device=data.device)
            good = torch.ones(n, dtype=torch.bool, device=data.device)
            for k in range(k0, k1 + 1):
                c = _byte_at(data, start + k)
                good = good & (c >= 48) & (c <= 57)
                v = v * 10 + (c - 48)
            return v, good

        y, gy = num(0, 3)
        m, gm = num(5, 6)
        d, gd = num(8, 9)
        ok = ok & gy & gm & gd & (_byte_at(data, start + 4) == 45) & (_byte_at(data, start + 7) == 45)
        ok = ok & (m >= 1) & (m <= 12) & (d >= 1) & (d <= 31)
        days = days_from_civil(y, m, d)
        # Feb 30 and the like pass the 1..31 gate: the round trip catches them
        _, m2, d2 = civil_from_days(days)
        return Column(to, days, validity & ok & (m2 == m) & (d2 == d))
    raise NotImplementedError(f"cast string -> {to!r} is not evaluated on the device (as in the reference)")


def _cast_to_string(col: Column, to: DataType) -> Column:
    src = col.dtype
    n, w = col.validity.shape[0], to.string_width
    dev = col.device
    if src.kind == TypeKind.BOOL:
        t = col.data.to(torch.bool)
        out = torch.zeros((n, w), dtype=torch.uint8, device=dev)
        for k, (ct, cf) in enumerate(zip(b"true\0", b"false")):
            out[:, k] = torch.where(t, ct, cf).to(torch.uint8)
        return Column(to, out, col.validity, torch.where(t, 4, 5).to(torch.int32))
    if src.is_integer or src.is_decimal:
        out, lengths, fits = _int_to_string(col.data.to(torch.int64), to, src.scale if src.is_decimal else 0)
        return Column(to, out, col.validity & fits, lengths)
    if src.kind == TypeKind.DATE32:
        from .functions import civil_from_days

        y, m, d = (x.to(torch.int64) for x in civil_from_days(col.data))
        out = torch.zeros((n, w), dtype=torch.uint8, device=dev)
        for k, (v, div) in enumerate([(y, 1000), (y, 100), (y, 10), (y, 1), (None, 0),
                                      (m, 10), (m, 1), (None, 0), (d, 10), (d, 1)]):
            if k < w:
                out[:, k] = 45 if v is None else ((v // div) % 10 + 48).to(torch.uint8)
        return Column(to, out, col.validity & (y >= 0) & (y <= 9999),
                      torch.full((n,), 10, dtype=torch.int32, device=dev))
    raise NotImplementedError(f"cast {src!r} -> string is not evaluated on the device (as in the reference)")


def lower_cast(col: Column, to: DataType) -> Column:
    src = col.dtype
    if src == to:
        return col
    # BINARY shares the byte layout but not these semantics
    if src.kind == TypeKind.STRING and to.kind != TypeKind.STRING:
        return _cast_from_string(col, to)
    if to.kind == TypeKind.STRING and src.kind != TypeKind.STRING:
        return _cast_to_string(col, to)
    if src.is_string or to.is_string:
        raise NotImplementedError(f"cast {src!r} -> {to!r}")
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
