"""Scalar function registry (≙ ``blaze_tpu/exprs/functions.py``):
functions resolve by name, so the plan contract carries them as
strings.

Device functions (``register``) lower to torch ops on the batch's
device: date parts and date math (Hinnant's civil calendar, pure
integer ops), string functions over the padded byte matrix, math,
decimal interop, hashes and ``might_contain``.  The long tail
(``register_host``: digests, regular expressions, padding, formatting)
runs per row in python on the host, as in the reference;
``compile.lower`` evaluates such a call one batch at a time wherever it
stands in an expression, and so it does the JSON functions
(``exprs/json_path.py``).  The nested functions (``make_array``,
``size``/``cardinality``, ``map_keys``, ``map_values``,
``array_contains``, ``array_union``/``brickhouse_array_union``) run on
the device over the padded element layout; ``split`` runs on the host
and keeps at most 16 parts, as in the reference.  An unknown name
raises, naming it.
"""

from __future__ import annotations

import logging
import math
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..batch import Column
from ..schema import DataType, Schema, TypeKind, string_width_for
from .ir import Lit, ScalarFunc

_REGISTRY: Dict[str, Callable] = {}
_TYPES: Dict[str, Callable] = {}

def register(name: str, infer: Callable):
    """Registers ``fn(expr, schema, cols, n, lower_fn) -> Column`` under
    ``name``, with ``infer(expr, arg_types) -> DataType``."""

    def deco(fn):
        _REGISTRY[name] = fn
        _TYPES[name] = infer
        return fn

    return deco


def infer_func_dtype(expr: ScalarFunc, schema: Schema) -> DataType:
    if expr.name not in _TYPES:
        raise KeyError(f"unknown function {expr.name!r}")
    from .compile import infer_dtype

    return _TYPES[expr.name](expr, [infer_dtype(a, schema) for a in expr.args])


def lower_func(expr: ScalarFunc, schema, cols, n, lower_fn) -> Column:
    if expr.name not in _REGISTRY:
        raise KeyError(f"unknown function {expr.name!r}")
    return _REGISTRY[expr.name](expr, schema, cols, n, lower_fn)


def _arange(w: int, device) -> torch.Tensor:
    return torch.arange(w, device=device)[None, :]


def _fit_width(data: torch.Tensor, w: int) -> torch.Tensor:
    """A byte matrix cut or zero-padded to width ``w``."""
    sw = data.shape[1]
    return torch.nn.functional.pad(data, (0, w - sw)) if sw < w else data[:, :w]


# ----------------------------------------------------------- date parts


def civil_from_days(days: torch.Tensor):
    """date32 days since 1970-01-01 -> int32 (year, month, day)."""
    z = days.to(torch.int64) + 719468
    era = torch.where(z >= 0, z, z - 146096) // 146097
    doe = z - era * 146097
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
    y = yoe + era * 400
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)
    mp = (5 * doy + 2) // 153
    d = doy - (153 * mp + 2) // 5 + 1
    m = torch.where(mp < 10, mp + 3, mp - 9)
    y = torch.where(m <= 2, y + 1, y)
    return y.to(torch.int32), m.to(torch.int32), d.to(torch.int32)


def _date_part(which: int):
    def fn(expr, schema, cols, n, lower_fn):
        c = lower_fn(expr.args[0], schema, cols, n)
        return Column(DataType.int32(), civil_from_days(c.data)[which], c.validity)

    return fn


_int32_t = lambda e, ts: DataType.int32()
register("year", _int32_t)(_date_part(0))
register("month", _int32_t)(_date_part(1))
register("day", _int32_t)(_date_part(2))


# --------------------------------------------------------------- string


def _substring_t(e, ts):
    w = ts[0].string_width
    if len(e.args) > 2:
        w = min(w, max(8, int(e.args[2].value)))
    return DataType.string(string_width_for(w))


@register("substring", _substring_t)
def _substring(expr, schema, cols, n, lower_fn):
    """Spark's ``substring(s, pos[, len])`` over bytes, with literal
    ``pos`` and ``len`` (UTF8String.substringSQL): ``pos`` counts from
    1, 0 acts as 1, and a negative ``pos`` counts from the end of each
    row's string; the window ``[start, start + len)`` is cut to the
    string."""
    c = lower_fn(expr.args[0], schema, cols, n)
    if not all(isinstance(a, Lit) for a in expr.args[1:]):
        raise NotImplementedError("substring with a non-literal position or length")
    pos = int(expr.args[1].value)
    w_in = c.data.shape[1]
    w = _substring_t(expr, [c.dtype]).string_width
    lengths = c.lengths.to(torch.int64)
    if pos > 0:
        start = torch.full_like(lengths, pos - 1)
    elif pos < 0:
        start = lengths + pos
    else:
        start = torch.zeros_like(lengths)
    # with no length the window runs to each string's end
    end = torch.minimum(start + int(expr.args[2].value), lengths) if len(expr.args) > 2 else lengths
    start = start.clamp(min=0)
    new_len = (end - start).clamp(min=0, max=w)
    idx = start[:, None] + torch.arange(w, device=c.device)[None, :]
    data = torch.gather(c.data, 1, idx.clamp(max=w_in - 1))
    # zero the tail past each row's length so padding stays canonical
    data = torch.where(torch.arange(w, device=c.device)[None, :] < new_len[:, None], data, 0)
    return Column(DataType.string(w), data.to(torch.uint8), c.validity, new_len.to(torch.int32))


def _concat_t(e, ts):
    return DataType.string(string_width_for(sum(t.string_width for t in ts)))


def _place_at_offsets(data: torch.Tensor, lengths: torch.Tensor, src: Column, w: int,
                      live: Optional[torch.Tensor] = None):
    """``src``'s bytes written into ``data`` (n x w) at each row's offset
    ``lengths``; returns (data, lengths + src's lengths).  ``live`` masks
    the rows that take part (``concat_ws`` skips null arguments)."""
    pos = _arange(w, data.device)
    sdata = _fit_width(src.data, w)
    start = lengths.to(torch.int64)[:, None]
    shifted = torch.gather(sdata, 1, (pos - start).clamp(0, sdata.shape[1] - 1))
    ln = src.lengths if live is None else torch.where(live, src.lengths, 0)
    write = (pos >= start) & (pos < start + ln.to(torch.int64)[:, None])
    return torch.where(write, shifted, data), lengths + ln


@register("concat", _concat_t)
def _concat(expr, schema, cols, n, lower_fn):
    """Spark's ``concat(s1, s2, ...)``: the strings one after another in
    a ``string(string_width_for(sum of widths))``, null if any argument
    is null."""
    parts = [lower_fn(a, schema, cols, n) for a in expr.args]
    w = _concat_t(expr, [p.dtype for p in parts]).string_width
    dev = parts[0].device
    data = torch.zeros((n, w), dtype=torch.uint8, device=dev)
    lengths = torch.zeros(n, dtype=torch.int32, device=dev)
    validity = torch.ones(n, dtype=torch.bool, device=dev)
    for p in parts:
        validity = validity & p.validity
        data, lengths = _place_at_offsets(data, lengths, p, w)
    return Column(DataType.string(w), data, validity, lengths)


# -------------------------------------------------------------- numeric


@register("abs", lambda e, ts: ts[0])
def _abs(expr, schema, cols, n, lower_fn):
    c = lower_fn(expr.args[0], schema, cols, n)
    return Column(c.dtype, torch.abs(c.data), c.validity)


def _same_t(e, ts):
    return ts[0]


def _float_t(e, ts):
    return DataType.float64()


def _long_t(e, ts):
    return DataType.int64()


def _bool_t(e, ts):
    return DataType.bool_()


def _date32_t(e, ts):
    return DataType.date32()


def _literal_arg(expr: ScalarFunc, i: int, what: str):
    a = expr.args[i]
    if not isinstance(a, Lit):
        raise NotImplementedError(f"{expr.name}: the {what} must be a literal")
    return a.value


def _as_float64(c: Column) -> torch.Tensor:
    """The logical value as float64; a decimal divides by 10^scale
    through a device tensor, so the quotient is correctly rounded."""
    if c.dtype.is_decimal:
        from .cast import decimal_to_float

        return decimal_to_float(c, DataType.float64()).data
    return c.data.to(torch.float64)


def _f64_to_i64(x: torch.Tensor) -> torch.Tensor:
    """float64 -> int64 saturating as XLA (and Java) convert: NaN gives
    0, values past the range clamp to its ends."""
    hi = x >= 2.0**63
    lo = x < -(2.0**63)
    safe = torch.where(torch.isnan(x) | hi | lo, 0.0, x).to(torch.int64)
    safe = torch.where(hi, 2**63 - 1, safe)
    return torch.where(lo, -(2**63), safe)


# -------------------------------------------------------------- string


@register("length", _int32_t)
def _length(expr, schema, cols, n, lower_fn):
    """Characters: the UTF-8 bytes that are not continuation bytes."""
    c = lower_fn(expr.args[0], schema, cols, n)
    in_str = _arange(c.data.shape[1], c.device) < c.lengths[:, None]
    chars = (in_str & ((c.data & 0xC0) != 0x80)).sum(dim=1, dtype=torch.int32)
    return Column(DataType.int32(), chars, c.validity)


register("char_length", _int32_t)(_length)
register("character_length", _int32_t)(_length)


def _case_shift(to_upper: bool):
    def fn(expr, schema, cols, n, lower_fn):
        c = lower_fn(expr.args[0], schema, cols, n)
        d = c.data
        lo, hi = (ord("a"), ord("z")) if to_upper else (ord("A"), ord("Z"))
        shift = ((d >= lo) & (d <= hi)).to(torch.uint8) * 32
        return Column(c.dtype, d - shift if to_upper else d + shift, c.validity, c.lengths)

    return fn


register("upper", _same_t)(_case_shift(True))
register("lower", _same_t)(_case_shift(False))


@register("bit_length", _int32_t)
def _bit_length(expr, schema, cols, n, lower_fn):
    c = lower_fn(expr.args[0], schema, cols, n)
    return Column(DataType.int32(), (c.lengths * 8).to(torch.int32), c.validity)


@register("octet_length", _int32_t)
def _octet_length(expr, schema, cols, n, lower_fn):
    c = lower_fn(expr.args[0], schema, cols, n)
    return Column(DataType.int32(), c.lengths.to(torch.int32), c.validity)


def _starts_ends(which: str):
    def fn(expr, schema, cols, n, lower_fn):
        from . import strings as S

        c = lower_fn(expr.args[0], schema, cols, n)
        needle = _literal_arg(expr, 1, "needle").encode("utf-8")
        return Column(DataType.bool_(), getattr(S, which)(c, needle), c.validity)

    return fn


register("starts_with", _bool_t)(_starts_ends("starts_with"))
register("ends_with", _bool_t)(_starts_ends("ends_with"))


def _trim(c: Column, left: bool, right: bool, chars: Optional[bytes]) -> Column:
    """Trim over the padded byte matrix: spaces (Spark's trim), or the
    bytes of ``chars`` (trim(BOTH 'xy' FROM s))."""
    w = c.data.shape[1]
    dev = c.device
    pos = _arange(w, dev)
    lengths = c.lengths.to(torch.int64)
    if chars is None:
        trimmable = c.data == 32
    else:
        table = torch.zeros(256, dtype=torch.bool)
        table[list(chars)] = True
        trimmable = table.to(dev)[c.data.to(torch.int64)]
    zero = torch.zeros_like(lengths)
    lead = torch.cumprod((trimmable & (pos < lengths[:, None])).to(torch.int64), 1).sum(1) if left else zero
    if right:
        ridx = (lengths[:, None] - 1 - pos).clamp(0, w - 1)
        rmask = torch.gather(trimmable, 1, ridx) & (pos < lengths[:, None])
        trail = torch.cumprod(rmask.to(torch.int64), 1).sum(1)
    else:
        trail = zero
    new_len = (lengths - lead - trail).clamp(min=0)
    data = torch.gather(c.data, 1, (pos + lead[:, None]).clamp(0, w - 1))
    data = torch.where(pos < new_len[:, None], data, 0).to(torch.uint8)
    return Column(c.dtype, data, c.validity, new_len.to(torch.int32))


def _register_trim(name: str, left: bool, right: bool):
    def fn(expr, schema, cols, n, lower_fn):
        c = lower_fn(expr.args[0], schema, cols, n)
        chars = _literal_arg(expr, 1, "trim set").encode("utf-8") if len(expr.args) > 1 else None
        return _trim(c, left, right, chars)

    register(name, _same_t)(fn)


_register_trim("trim", True, True)
_register_trim("btrim", True, True)
_register_trim("ltrim", True, False)
_register_trim("rtrim", False, True)

_DYNAMIC_STR_CAP = 128  # output width when a repeat count is not a literal


def _space_t(e, ts):
    a = e.args[0]
    if isinstance(a, Lit) and a.value is not None:
        return DataType.string(string_width_for(max(int(a.value), 1)))
    return DataType.string(_DYNAMIC_STR_CAP)


@register("space", _space_t)
def _space(expr, schema, cols, n, lower_fn):
    """space(k): k spaces; a non-literal k clips at the column width."""
    c = lower_fn(expr.args[0], schema, cols, n)
    w = _space_t(expr, None).string_width
    lengths = c.data.to(torch.int64).clamp(0, w)
    data = torch.where(_arange(w, c.device) < lengths[:, None], 0x20, 0).to(torch.uint8)
    return Column(DataType.string(w), data, c.validity, lengths.to(torch.int32))


def _repeat_t(e, ts):
    w = ts[0].string_width
    a = e.args[1]
    if isinstance(a, Lit) and a.value is not None:
        return DataType.string(string_width_for(max(w * int(a.value), 1)))
    return DataType.string(max(_DYNAMIC_STR_CAP, w))


@register("repeat", _repeat_t)
def _repeat(expr, schema, cols, n, lower_fn):
    """repeat(s, k); a non-literal k clips at the column width."""
    s = lower_fn(expr.args[0], schema, cols, n)
    cnt = lower_fn(expr.args[1], schema, cols, n)
    out_t = _repeat_t(expr, [s.dtype])
    w = out_t.string_width
    src_len = s.lengths.to(torch.int64)
    lengths = (src_len * cnt.data.to(torch.int64).clamp(min=0)).clamp(0, w)
    pos = _arange(w, s.device)
    # the output may be narrower than the source (repeat(s, 0))
    idx = (pos % src_len.clamp(min=1)[:, None]).clamp(max=w - 1)
    tiled = torch.gather(_fit_width(s.data, w), 1, idx)
    data = torch.where(pos < lengths[:, None], tiled, 0).to(torch.uint8)
    return Column(out_t, data, cnt.validity & s.validity, lengths.to(torch.int32))


def _concat_ws_t(e, ts):
    total = sum(t.string_width for t in ts[1:]) + ts[0].string_width * max(len(ts) - 2, 0)
    return DataType.string(string_width_for(max(total, 1)))


@register("concat_ws", _concat_ws_t)
def _concat_ws(expr, schema, cols, n, lower_fn):
    """concat_ws(sep, s1, s2, ...): null arguments are skipped (Spark),
    a null separator gives null."""
    parts = [lower_fn(a, schema, cols, n) for a in expr.args]
    sep, rest = parts[0], parts[1:]
    w = _concat_ws_t(expr, [p.dtype for p in parts]).string_width
    dev = sep.device
    data = torch.zeros((n, w), dtype=torch.uint8, device=dev)
    lengths = torch.zeros(n, dtype=torch.int32, device=dev)
    first = torch.ones(n, dtype=torch.bool, device=dev)
    for p in rest:
        live = p.validity
        data, lengths = _place_at_offsets(data, lengths, sep, w, live & ~first)
        data, lengths = _place_at_offsets(data, lengths, p, w, live)
        first = first & ~live
    return Column(DataType.string(w), data, sep.validity, lengths.clamp(max=w))


# -------------------------------------------------------------- numeric


@register("negative", _same_t)
def _negative(expr, schema, cols, n, lower_fn):
    c = lower_fn(expr.args[0], schema, cols, n)
    return Column(c.dtype, -c.data, c.validity)


def _round_t(e, ts):
    t = ts[0]
    if t.is_decimal:
        s = int(e.args[1].value) if len(e.args) > 1 else 0
        return DataType.decimal(t.precision, min(t.scale, max(s, 0)))
    return t


@register("round", _round_t)
def _round(expr, schema, cols, n, lower_fn):
    """HALF_UP (away from zero): a decimal to the literal scale (never
    above its own, never below 0, as in the reference), a float to that
    many places; integers pass through."""
    from .cast import rescale_decimal

    c = lower_fn(expr.args[0], schema, cols, n)
    s = int(expr.args[1].value) if len(expr.args) > 1 else 0
    if c.dtype.is_decimal:
        out_t = _round_t(expr, [c.dtype])
        return Column(out_t, rescale_decimal(c.data, c.dtype.scale, out_t.scale), c.validity)
    if c.dtype.is_float:
        f = torch.full((), 10.0**s, dtype=c.data.dtype, device=c.device)
        scaled = c.data * f
        data = torch.where(scaled >= 0, torch.floor(scaled + 0.5), torch.ceil(scaled - 0.5)) / f
        return Column(c.dtype, data, c.validity)
    return c


def _coalesce_t(e, ts):
    from .compile import _common_type

    t = ts[0]
    for u in ts[1:]:
        t = _common_type(t, u)
    return t


@register("coalesce", _coalesce_t)
def _coalesce(expr, schema, cols, n, lower_fn):
    from . import strings as S
    from .compile import _coerce

    parts = [lower_fn(a, schema, cols, n) for a in expr.args]
    out_t = _coalesce_t(expr, [p.dtype for p in parts])
    parts = [_coerce(p, out_t) for p in parts]
    result = parts[-1]
    for p in reversed(parts[:-1]):
        take = p.validity
        validity = p.validity | result.validity
        if out_t.is_string:
            w = max(p.data.shape[1], result.data.shape[1])
            result = Column(out_t, torch.where(take[:, None], S.pad_width(p.data, w), S.pad_width(result.data, w)),
                            validity, torch.where(take, p.lengths, result.lengths))
        else:
            result = Column(out_t, torch.where(take, p.data, result.data), validity)
    return result


@register("null_if_zero", _same_t)
@register("nullifzero", _same_t)
def _null_if_zero(expr, schema, cols, n, lower_fn):
    c = lower_fn(expr.args[0], schema, cols, n)
    return Column(c.dtype, c.data, c.validity & (c.data != 0), c.lengths)


@register("nullif", _same_t)
@register("null_if", _same_t)
def _nullif(expr, schema, cols, n, lower_fn):
    """a unless a == b, else null."""
    from .strings import str_eq

    a = lower_fn(expr.args[0], schema, cols, n)
    b = lower_fn(expr.args[1], schema, cols, n)
    eq = str_eq(a, b) if a.dtype.is_string else a.data == b.data
    return Column(a.dtype, a.data, a.validity & ~(a.validity & b.validity & eq), a.lengths)


def _register_math(name: str, fn, out_int: bool = False):
    def lower_math(expr, schema, cols, n, lower_fn):
        c = lower_fn(expr.args[0], schema, cols, n)
        y = fn(_as_float64(c))
        if out_int:
            return Column(DataType.int64(), _f64_to_i64(y), c.validity)
        return Column(DataType.float64(), y, c.validity)

    register(name, _long_t if out_int else _float_t)(lower_math)


def cbrt(x: torch.Tensor) -> torch.Tensor:
    """The real cube root (torch has none): ``|x|^(1/3)`` with the sign
    of ``x``, then one Newton step where the estimate is finite and
    nonzero (zeros, infinities and NaN pass through)."""
    y = torch.copysign(torch.pow(x.abs(), 1.0 / 3.0), x)
    step = torch.isfinite(y) & (y != 0)
    safe = torch.where(step, y, 1.0)
    return torch.where(step, safe - (safe * safe * safe - x) / (3.0 * safe * safe), y)


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root.  The card's ``torch.sqrt`` is
    (IEEE); torch's CPU kernel can be an ulp off (sqrt(0.5) on torch
    2.13+cpu), so a CPU tensor takes numpy's."""
    if x.device.type == "cpu":
        with np.errstate(invalid="ignore"):
            return torch.from_numpy(np.sqrt(x.numpy()))
    return torch.sqrt(x)


def _signum(x: torch.Tensor) -> torch.Tensor:
    """Math.signum: NaN and both zeros pass through."""
    return torch.where(torch.isnan(x) | (x == 0), x, torch.sign(x))


for _name, _fn in {
    "sin": torch.sin, "cos": torch.cos, "tan": torch.tan,
    "asin": torch.asin, "acos": torch.acos, "atan": torch.atan,
    "sinh": torch.sinh, "cosh": torch.cosh, "tanh": torch.tanh,
    "exp": torch.exp, "expm1": torch.expm1,
    "ln": torch.log, "log": torch.log, "log2": torch.log2, "log10": torch.log10,
    "log1p": torch.log1p, "sqrt": sqrt, "cbrt": cbrt, "signum": _signum,
    "degrees": lambda x: x * (180.0 / math.pi), "radians": lambda x: x * (math.pi / 180.0),
    "trunc": torch.trunc,
}.items():
    _register_math(_name, _fn)
_register_math("ceil", torch.ceil, out_int=True)
_register_math("floor", torch.floor, out_int=True)


def _binary_math(fn):
    def lower_binary(expr, schema, cols, n, lower_fn):
        a = lower_fn(expr.args[0], schema, cols, n)
        b = lower_fn(expr.args[1], schema, cols, n)
        return Column(DataType.float64(), fn(a.data.to(torch.float64), b.data.to(torch.float64)),
                      a.validity & b.validity)

    return lower_binary


register("pow", _float_t)(_binary_math(torch.pow))
register("power", _float_t)(_binary_math(torch.pow))
register("atan2", _float_t)(_binary_math(torch.atan2))


# ----------------------------------------------------- decimal interop


@register("unscaled_value", _long_t)
def _unscaled_value(expr, schema, cols, n, lower_fn):
    """A decimal's unscaled int64 (Spark's UnscaledValue)."""
    c = lower_fn(expr.args[0], schema, cols, n)
    if not c.dtype.is_decimal:
        raise TypeError("unscaled_value takes a decimal")
    return Column(DataType.int64(), c.data, c.validity)


def _decimal_args_t(e, ts):
    return DataType.decimal(int(e.args[1].value), int(e.args[2].value))


@register("make_decimal", _decimal_args_t)
def _make_decimal(expr, schema, cols, n, lower_fn):
    """An unscaled int64 as decimal(p, s) (Spark's MakeDecimal)."""
    c = lower_fn(expr.args[0], schema, cols, n)
    return Column(_decimal_args_t(expr, None), c.data.to(torch.int64), c.validity)


@register("check_overflow", _decimal_args_t)
def _check_overflow(expr, schema, cols, n, lower_fn):
    """A decimal rescaled to (p, s); null where it passes p digits
    (Spark's CheckOverflow, null on overflow)."""
    from .cast import decimal_overflow_null, rescale_decimal

    c = lower_fn(expr.args[0], schema, cols, n)
    if not c.dtype.is_decimal:
        raise TypeError("check_overflow takes a decimal")
    out_t = _decimal_args_t(expr, None)
    data = rescale_decimal(c.data, c.dtype.scale, out_t.scale)
    ok = decimal_overflow_null(data, torch.ones_like(c.validity), out_t.precision)
    return Column(out_t, torch.where(ok, data, 0), c.validity & ok)


# --------------------------------------------------------------- hashes


@register("murmur3_hash", _int32_t)
def _murmur3_hash(expr, schema, cols, n, lower_fn):
    """Spark's Murmur3Hash(args, seed 42)."""
    from .hash import murmur3_columns

    parts = [lower_fn(a, schema, cols, n) for a in expr.args]
    return Column(DataType.int32(), murmur3_columns(parts),
                  torch.ones(n, dtype=torch.bool, device=parts[0].device))


@register("xxhash64", _long_t)
def _xxhash64(expr, schema, cols, n, lower_fn):
    """Spark's XxHash64(args, seed 42)."""
    from .hash import xxhash64_columns

    parts = [lower_fn(a, schema, cols, n) for a in expr.args]
    return Column(DataType.int64(), xxhash64_columns(parts),
                  torch.ones(n, dtype=torch.bool, device=parts[0].device))


_bloom_cache: Dict[bytes, object] = {}


@register("might_contain", _bool_t)
def _might_contain(expr, schema, cols, n, lower_fn):
    """might_contain(serialized filter literal, value): Spark's
    BloomFilterMightContain, probed on the value's device; a filter is
    decoded (and its words staged) once per payload."""
    from .bloom import SparkBloomFilter

    payload = _literal_arg(expr, 0, "bloom filter")
    if not isinstance(payload, (bytes, bytearray)):
        raise TypeError("might_contain takes a binary bloom filter literal")
    key = bytes(payload)
    filt = _bloom_cache.get(key)
    if filt is None:
        filt = _bloom_cache[key] = SparkBloomFilter.deserialize(key)
    c = lower_fn(expr.args[1], schema, cols, n)
    return Column(DataType.bool_(), filt.might_contain_device(c),
                  torch.ones(n, dtype=torch.bool, device=c.device))


# ------------------------------------------------------------ date/time


def days_from_civil(y, m, d) -> torch.Tensor:
    """(year, month, day) -> int32 days since 1970-01-01 (Hinnant)."""
    y, m, d = y.to(torch.int64), m.to(torch.int64), d.to(torch.int64)
    y = torch.where(m <= 2, y - 1, y)
    era = torch.where(y >= 0, y, y - 399) // 400
    yoe = y - era * 400
    mp = torch.where(m > 2, m - 3, m + 9)
    doy = (153 * mp + 2) // 5 + d - 1
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    return (era * 146097 + doe - 719468).to(torch.int32)


def _date_shift(sign: int):
    def fn(expr, schema, cols, n, lower_fn):
        c = lower_fn(expr.args[0], schema, cols, n)
        k = lower_fn(expr.args[1], schema, cols, n)
        return Column(DataType.date32(), c.data + sign * k.data.to(torch.int32), c.validity & k.validity)

    return fn


register("date_add", _date32_t)(_date_shift(1))
register("date_sub", _date32_t)(_date_shift(-1))


@register("datediff", _int32_t)
def _datediff(expr, schema, cols, n, lower_fn):
    a = lower_fn(expr.args[0], schema, cols, n)
    b = lower_fn(expr.args[1], schema, cols, n)
    return Column(DataType.int32(), (a.data - b.data).to(torch.int32), a.validity & b.validity)


@register("quarter", _int32_t)
def _quarter(expr, schema, cols, n, lower_fn):
    c = lower_fn(expr.args[0], schema, cols, n)
    m = civil_from_days(c.data)[1]
    return Column(DataType.int32(), (m - 1) // 3 + 1, c.validity)


@register("dayofweek", _int32_t)
def _dayofweek(expr, schema, cols, n, lower_fn):
    """1 = Sunday (Spark)."""
    c = lower_fn(expr.args[0], schema, cols, n)
    return Column(DataType.int32(), ((c.data.to(torch.int64) + 4) % 7 + 1).to(torch.int32), c.validity)


@register("weekday", _int32_t)
def _weekday(expr, schema, cols, n, lower_fn):
    """0 = Monday (Spark)."""
    c = lower_fn(expr.args[0], schema, cols, n)
    return Column(DataType.int32(), ((c.data.to(torch.int64) + 3) % 7).to(torch.int32), c.validity)


def _jan1(y: torch.Tensor) -> torch.Tensor:
    return days_from_civil(y, torch.ones_like(y), torch.ones_like(y))


@register("dayofyear", _int32_t)
def _dayofyear(expr, schema, cols, n, lower_fn):
    c = lower_fn(expr.args[0], schema, cols, n)
    y = civil_from_days(c.data)[0]
    return Column(DataType.int32(), (c.data - _jan1(y) + 1).to(torch.int32), c.validity)


@register("weekofyear", _int32_t)
def _weekofyear(expr, schema, cols, n, lower_fn):
    """The ISO-8601 week: the week of its Thursday."""
    c = lower_fn(expr.args[0], schema, cols, n)
    days = c.data.to(torch.int64)
    thursday = days + (3 - (days + 3) % 7)
    y = civil_from_days(thursday)[0]
    return Column(DataType.int32(), ((thursday - _jan1(y)) // 7 + 1).to(torch.int32), c.validity)


@register("last_day", _date32_t)
def _last_day(expr, schema, cols, n, lower_fn):
    c = lower_fn(expr.args[0], schema, cols, n)
    y, m, _ = civil_from_days(c.data)
    first_next = days_from_civil(torch.where(m == 12, y + 1, y), torch.where(m == 12, 1, m + 1),
                                 torch.ones_like(m))
    return Column(DataType.date32(), first_next - 1, c.validity)


@register("add_months", _date32_t)
def _add_months(expr, schema, cols, n, lower_fn):
    """Spark's AddMonths: the day clamps to the target month's end."""
    c = lower_fn(expr.args[0], schema, cols, n)
    k = lower_fn(expr.args[1], schema, cols, n)
    y, m, d = civil_from_days(c.data)
    total = y.to(torch.int64) * 12 + (m.to(torch.int64) - 1) + k.data.to(torch.int64)
    ny, nm = total // 12, total % 12 + 1
    last = days_from_civil(torch.where(nm == 12, ny + 1, ny), torch.where(nm == 12, 1, nm + 1),
                           torch.ones_like(nm)) - 1
    nd = torch.minimum(d.to(torch.int64), civil_from_days(last)[2].to(torch.int64))
    return Column(DataType.date32(), days_from_civil(ny, nm, nd), c.validity & k.validity)


def _ts_part(div: int, mod: int):
    def fn(expr, schema, cols, n, lower_fn):
        c = lower_fn(expr.args[0], schema, cols, n)
        secs = c.data.to(torch.int64) // 1_000_000  # micros -> seconds, floored
        return Column(DataType.int32(), ((secs // div) % mod).to(torch.int32), c.validity)

    return fn


register("hour", _int32_t)(_ts_part(3600, 24))
register("minute", _int32_t)(_ts_part(60, 60))
register("second", _int32_t)(_ts_part(1, 60))


@register("unix_timestamp", _long_t)
def _unix_timestamp(expr, schema, cols, n, lower_fn):
    c = lower_fn(expr.args[0], schema, cols, n)
    if c.dtype.kind == TypeKind.DATE32:
        secs = c.data.to(torch.int64) * 86400
    else:
        secs = c.data.to(torch.int64) // 1_000_000
    return Column(DataType.int64(), secs, c.validity)


# --------------------------------------------------------------- nested


def _make_array_t(e, ts):
    from .compile import _common_type

    t = DataType.null()
    for a in ts:
        t = _common_type(t, a)
    if t.kind == TypeKind.NULL:
        t = DataType.int32()
    return DataType.array(t, max(1, len(ts)))


def _stack_elems(cols) -> Column:
    """Columns of one type as the elements of k-element rows: every
    buffer stacked along a new element axis."""
    first = cols[0]
    st = lambda get: None if get(first) is None else torch.stack([get(c) for c in cols], 1)
    kids = None
    if first.children is not None:
        kids = tuple(_stack_elems([c.children[i] for c in cols]) for i in range(len(first.children)))
    return Column(first.dtype, st(lambda c: c.data), st(lambda c: c.validity), st(lambda c: c.lengths), kids)


@register("make_array", _make_array_t)
def _make_array(expr, schema, cols, n, lower_fn):
    """``make_array(e1, ..., ek)``: k-element arrays, never null; a null
    argument is a null element (Spark's CreateArray)."""
    from .compile import _coerce, infer_dtype

    out_t = _make_array_t(expr, [infer_dtype(a, schema) for a in expr.args])
    elems = [_coerce(lower_fn(a, schema, cols, n), out_t.elem) for a in expr.args]
    if out_t.elem.is_string:
        w = out_t.elem.string_width
        elems = [Column(e.dtype, _fit_width(e.data, w), e.validity, e.lengths) for e in elems]
    dev = elems[0].validity.device
    return Column(out_t, None, torch.ones(n, dtype=torch.bool, device=dev),
                  torch.full((n,), len(expr.args), dtype=torch.int32, device=dev), (_stack_elems(elems),))


@register("size", _int32_t)
@register("cardinality", _int32_t)
def _size(expr, schema, cols, n, lower_fn):
    """The element count of an array or map; -1 for a null one (Spark's
    ``spark.sql.legacy.sizeOfNull``, as in the reference)."""
    c = lower_fn(expr.args[0], schema, cols, n)
    if c.dtype.kind not in (TypeKind.ARRAY, TypeKind.MAP):
        raise TypeError(f"size over {c.dtype!r}")
    return Column(DataType.int32(), torch.where(c.validity, c.lengths, -1).to(torch.int32),
                  torch.ones_like(c.validity))


def _map_keys_t(e, ts):
    return DataType.array(ts[0].key, ts[0].max_elems)


def _map_values_t(e, ts):
    return DataType.array(ts[0].value, ts[0].max_elems)


@register("map_keys", _map_keys_t)
def _map_keys(expr, schema, cols, n, lower_fn):
    c = lower_fn(expr.args[0], schema, cols, n)
    return Column(_map_keys_t(expr, [c.dtype]), None, c.validity, c.lengths, (c.children[0],))


@register("map_values", _map_values_t)
def _map_values(expr, schema, cols, n, lower_fn):
    c = lower_fn(expr.args[0], schema, cols, n)
    return Column(_map_values_t(expr, [c.dtype]), None, c.validity, c.lengths, (c.children[1],))


@register("array_contains", lambda e, ts: DataType.bool_())
def _array_contains(expr, schema, cols, n, lower_fn):
    """True where an element equals the value; null where the array or
    the value is null, or where no element matches and one is null
    (Spark's three-valued ArrayContains)."""
    from .compile import _coerce

    c = lower_fn(expr.args[0], schema, cols, n)
    elem = c.children[0]
    m = c.dtype.max_elems
    needle = _coerce(lower_fn(expr.args[1], schema, cols, n), c.dtype.elem)
    in_bounds = torch.arange(m, device=c.device)[None, :] < c.lengths[:, None]
    has_null = (in_bounds & ~elem.validity).any(1)
    if c.dtype.elem.is_string:
        w = max(elem.data.shape[-1], needle.data.shape[-1])
        ed = torch.nn.functional.pad(elem.data, (0, w - elem.data.shape[-1]))
        nd = _fit_width(needle.data, w)
        eq = (ed == nd[:, None, :]).all(-1) & (elem.lengths == needle.lengths[:, None])
    else:
        eq = elem.data == needle.data[:, None]
    hit = (eq & in_bounds & elem.validity).any(1)
    return Column(DataType.bool_(), hit, c.validity & needle.validity & (hit | ~has_null))


def _array_union_t(e, ts):
    return DataType.array(ts[0].elem, ts[0].max_elems + ts[1].max_elems)


@register("brickhouse_array_union", _array_union_t)
@register("array_union", _array_union_t)
def _array_union(expr, schema, cols, n, lower_fn):
    """The distinct elements of two arrays, a budget of both arrays'
    (≙ the reference's: a's elements, then b's, deduplicated by
    ``ops.agg.dedup_array_state``); null where either array is null."""
    from ..ops.agg import dedup_array_state

    a = lower_fn(expr.args[0], schema, cols, n)
    b = lower_fn(expr.args[1], schema, cols, n)
    out_t = _array_union_t(expr, [a.dtype, b.dtype])
    m, ma = out_t.max_elems, a.dtype.max_elems
    la = torch.where(a.validity, a.lengths, 0)
    lb = torch.where(b.validity, b.lengths, 0)
    pos = torch.arange(m, device=a.device)[None, :]
    from_b = pos >= la[:, None]
    # slot j holds a's element j below a's length, else b's element j - la
    src = torch.where(from_b, ma + (pos - la[:, None]).clamp(0, m - ma - 1), pos.clamp(max=ma - 1))

    def merged(ta, tb):
        if ta is None:
            return None
        if tb.shape[2:] != ta.shape[2:]:  # string widths
            w = max(ta.shape[-1], tb.shape[-1])
            ta = torch.nn.functional.pad(ta, (0, w - ta.shape[-1]))
            tb = torch.nn.functional.pad(tb, (0, w - tb.shape[-1]))
        cat = torch.cat([ta, tb], 1)
        ix = src.view(src.shape + (1,) * (cat.dim() - 2)).expand((cat.shape[0], m) + tuple(cat.shape[2:]))
        return torch.gather(cat, 1, ix)

    def zip_cols(ca: Column, cb: Column) -> Column:
        return Column(ca.dtype, merged(ca.data, cb.data), merged(ca.validity, cb.validity),
                      merged(ca.lengths, cb.lengths),
                      None if ca.children is None else tuple(zip_cols(x, y) for x, y in zip(ca.children, cb.children)))

    elem = zip_cols(a.children[0], b.children[0])
    total = la + lb
    elem = Column(elem.dtype, elem.data, elem.validity & (pos < total[:, None]), elem.lengths, elem.children)
    merged_col = Column(out_t, None, a.validity & b.validity, total.to(torch.int32), (elem,))
    return dedup_array_state(merged_col)


# ------------------------------------------------- JSON (host-evaluated)


def _json_out_t(e, ts):
    """Wide enough for any extraction from the input plus the
    re-serialization overhead of a multi-match array."""
    in_w = ts[0].string_width if ts and ts[0].is_string else 64
    return DataType.string(string_width_for(in_w + 32))


JSON_FUNCS = frozenset({"get_json_object", "get_parsed_json_object", "parse_json"})
for _name in JSON_FUNCS:
    _TYPES[_name] = _json_out_t


# ---------------------------------------------------- host: long tail

#: name -> (fn, wants_types): per-row python functions, null for a null argument
HOST_IMPLS: Dict[str, tuple] = {}


def register_host(name: str, infer: Callable, wants_types: bool = False):
    """Registers a per-row python function, evaluated on the host by
    ``compile.lower`` one batch at a time over the rows whose arguments
    are all valid (a null argument gives null).  ``wants_types``: it is
    called as ``fn(arg_types, *row)``."""

    def deco(fn):
        _TYPES[name] = infer
        HOST_IMPLS[name] = (fn, wants_types)
        return fn

    return deco


def is_host_function(name: str) -> bool:
    """True for the functions ``lower`` evaluates on the host."""
    return name in HOST_IMPLS or name in JSON_FUNCS


def _str_w_t(width):
    return lambda e, ts: DataType.string(string_width_for(width))


def _str_same_t(e, ts):
    return DataType.string(ts[0].string_width)


def _utf8(s):
    return s.encode("utf-8") if isinstance(s, str) else s


@register_host("md5", _str_w_t(32))
def _md5(s):
    import hashlib

    return hashlib.md5(_utf8(s)).hexdigest()


@register_host("sha1", _str_w_t(40))
def _sha1(s):
    import hashlib

    return hashlib.sha1(_utf8(s)).hexdigest()


@register_host("sha2", lambda e, ts: DataType.string(128))
def _sha2(s, bits):
    import hashlib

    bits = int(bits) or 256
    fn = {224: hashlib.sha224, 256: hashlib.sha256, 384: hashlib.sha384, 512: hashlib.sha512}.get(bits)
    return fn(_utf8(s)).hexdigest() if fn else None


@register_host("crc32", _long_t)
def _crc32(s):
    import zlib

    return zlib.crc32(_utf8(s))


def _java_repl_to_python(repl: str) -> str:
    """$1-style group references as \\1 (Java -> python)."""
    import re

    return re.sub(r"\$(\d+)", r"\\\1", repl)


@register_host("rlike", _bool_t)
@register_host("regexp_like", _bool_t)
def _rlike(s, pattern):
    import re

    return re.search(pattern, s) is not None


def _double_width_t(e, ts):
    return DataType.string(string_width_for(max(ts[0].string_width * 2, 8)))


@register_host("regexp_replace", _double_width_t)
def _regexp_replace(s, pattern, repl):
    import re

    return re.sub(pattern, _java_repl_to_python(repl), s)


@register_host("regexp_extract", _str_same_t)
def _regexp_extract(s, pattern, idx=1):
    import re

    m = re.search(pattern, s)
    if m is None:
        return ""
    try:
        g = m.group(int(idx))
    except IndexError:
        return None
    return g if g is not None else ""


@register_host("replace", _double_width_t)
def _replace(s, search, repl=""):
    return s.replace(search, repl)


@register_host("reverse", _str_same_t)
def _reverse(s):
    return s[::-1]


@register_host("initcap", _str_same_t)
def _initcap(s):
    out = []
    prev_alpha = False
    for ch in s:
        out.append((ch.lower() if prev_alpha else ch.upper()) if ch.isalpha() else ch)
        prev_alpha = ch.isalpha()
    return "".join(out)


@register_host("translate", _str_same_t)
def _translate(s, frm, to):
    table = {}
    for i, ch in enumerate(frm):
        if ord(ch) not in table:  # the first occurrence wins (Spark)
            table[ord(ch)] = to[i] if i < len(to) else None
    return s.translate(table)


def _literal_width_t(e, ts):
    ln = e.args[1].value if isinstance(e.args[1], Lit) else ts[0].string_width
    return DataType.string(string_width_for(max(int(ln), 1)))


@register_host("lpad", _literal_width_t)
def _lpad(s, ln, pad=" "):
    ln = int(ln)
    if len(s) >= ln:
        return s[:ln]
    if not pad:
        return s
    return (pad * ln)[: ln - len(s)] + s


@register_host("rpad", _literal_width_t)
def _rpad(s, ln, pad=" "):
    ln = int(ln)
    if len(s) >= ln:
        return s[:ln]
    if not pad:
        return s
    return s + (pad * ln)[: ln - len(s)]


@register_host("left", _literal_width_t)
def _left(s, ln):
    ln = int(ln)
    return "" if ln <= 0 else s[:ln]


@register_host("right", _literal_width_t)
def _right(s, ln):
    ln = int(ln)
    return "" if ln <= 0 else s[-ln:] if ln <= len(s) else s


@register_host("instr", _int32_t)
@register_host("strpos", _int32_t)
@register_host("position", _int32_t)
def _instr(s, sub):
    return s.find(sub) + 1


@register_host("locate", _int32_t)
def _locate(sub, s, pos=1):
    pos = int(pos)
    if pos < 1:
        return 0
    return s.find(sub, pos - 1) + 1


@register_host("ascii", _int32_t)
def _ascii(s):
    return ord(s[0]) if s else 0


@register_host("chr", lambda e, ts: DataType.string(8))
def _chr(k):
    k = int(k)
    return "" if k < 0 else chr(k % 256)


@register_host("to_hex", lambda e, ts: DataType.string(16))
def _to_hex(x):
    return format(int(x) & 0xFFFFFFFFFFFFFFFF, "X")


@register_host("split", lambda e, ts: DataType.array(DataType.string(ts[0].string_width), 16))
def _split(s, pattern, limit=-1):
    """Spark's ``split(str, regex[, limit])``; at most 16 parts (the
    result's element budget, as in the reference): more are cut, with a
    warning."""
    import re

    limit = int(limit)
    parts = re.split(pattern, s) if limit <= 0 else re.split(pattern, s, maxsplit=limit - 1)
    if len(parts) > 16:
        logging.getLogger(__name__).warning("split: %d parts truncated to the 16-element array budget", len(parts))
    return parts[:16]


@register_host("split_part", _str_same_t)
def _split_part(s, delim, idx):
    parts = s.split(delim)
    idx = int(idx)
    if idx < 1 or idx > len(parts):
        return ""
    return parts[idx - 1]


_SPARK_FMT = [("yyyy", "%Y"), ("MM", "%m"), ("dd", "%d"), ("HH", "%H"), ("mm", "%M"), ("ss", "%S")]


def _spark_fmt_to_strftime(fmt: str) -> str:
    for a, b in _SPARK_FMT:
        fmt = fmt.replace(a, b)
    return fmt


@register_host("from_unixtime", _str_w_t(32))
def _from_unixtime(secs, fmt="yyyy-MM-dd HH:mm:ss"):
    import datetime

    t = datetime.datetime.fromtimestamp(int(secs), datetime.timezone.utc)
    return t.strftime(_spark_fmt_to_strftime(fmt))


@register_host("date_format", _str_w_t(32), wants_types=True)
def _date_format(arg_types, v, fmt):
    import datetime

    if arg_types[0].kind == TypeKind.TIMESTAMP:
        t = datetime.datetime.fromtimestamp(int(v) / 1_000_000, datetime.timezone.utc)
    else:
        t = datetime.datetime.combine(datetime.date(1970, 1, 1) + datetime.timedelta(days=int(v)),
                                      datetime.time())
    return t.strftime(_spark_fmt_to_strftime(fmt))


@register_host("to_date", _date32_t)
def _to_date(s):
    import datetime

    try:
        return (datetime.date.fromisoformat(str(s)[:10]) - datetime.date(1970, 1, 1)).days
    except ValueError:
        return None


# ------------------------------------------------ host evaluation


def host_function(expr: ScalarFunc, schema: Schema, cols: Dict[str, Column], n: int, lower_fn) -> Column:
    """A host function (``HOST_IMPLS``) or JSON function over the first
    ``n`` rows: each argument is lowered on the device (nested host
    calls through ``lower_fn`` too); every function here gives null for
    a null argument, so only the rows whose arguments are all valid
    (never the padding) are copied to the host, once an argument, and
    run through the python function; the results go back to the
    arguments' device in one copy and are scattered to their rows.  A
    string result wider than the declared width is null (a fixed-width
    column cannot hold it), as in the reference."""
    from ..batch import column_from_pylist, column_to_pylist
    from .compile import infer_dtype
    from .json_path import get_json_object, parse_json

    device = next(iter(cols.values())).device
    out_t = infer_dtype(expr, schema)
    lowered = [None if isinstance(a, Lit) else lower_fn(a, schema, cols, n) for a in expr.args]
    live = torch.ones(n, dtype=torch.bool, device=device)
    for c in lowered:
        if c is not None:
            live &= c.validity[:n]
    idx = torch.nonzero(live).squeeze(1)
    k = int(idx.shape[0])
    args = [[a.value] * k if c is None else column_to_pylist(c.take(idx), k) for a, c in zip(expr.args, lowered)]
    if expr.name in JSON_FUNCS:
        if expr.name == "parse_json":
            out = [parse_json(s) for s in args[0]]
        else:
            cache: dict = {}
            out = [get_json_object(s, p, cache) for s, p in zip(args[0], args[1])]
    else:
        fn, wants_types = HOST_IMPLS[expr.name]
        arg_types = [infer_dtype(a, schema) for a in expr.args] if wants_types else None
        out = [None if any(v is None for v in row) else fn(arg_types, *row) if wants_types else fn(*row)
               for row in zip(*args)]
    if out_t.is_string:
        w = out_t.string_width
        long = sum(1 for v in out if v is not None and len(v.encode("utf-8")) > w)
        if long:
            logging.getLogger(__name__).warning(
                "%s: %d result(s) exceeded string width %d and were nulled", expr.name, long, w)
            out = [None if v is not None and len(v.encode("utf-8")) > w else v for v in out]
    cap = max(next(iter(cols.values())).capacity, n)
    small = column_from_pylist(out_t, out, capacity=max(k, 1), device=device)

    def scatter(t):
        full = torch.zeros((cap,) + tuple(t.shape[1:]), dtype=t.dtype, device=device)
        return full.index_copy_(0, idx, t[:k])

    return small.map_buffers(scatter)
