"""Scalar function registry (≙ ``blaze_tpu/exprs/functions.py``):
functions resolve by name, so the plan contract carries them as
strings.  The port has ``year``, ``month``, ``day`` (Hinnant's
civil-from-days, pure integer ops), ``substring``, ``concat`` and
``abs``.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from ..batch import Column
from ..schema import DataType, Schema, string_width_for
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


def _place_at_offsets(data: torch.Tensor, lengths: torch.Tensor, src: Column, w: int):
    """``src``'s bytes written into ``data`` (n x w) at each row's offset
    ``lengths``; returns (data, lengths + src's lengths)."""
    pos = torch.arange(w, device=data.device)[None, :]
    sw = src.data.shape[1]
    sdata = torch.nn.functional.pad(src.data, (0, w - sw)) if sw < w else src.data[:, :w]
    start = lengths.to(torch.int64)[:, None]
    shifted = torch.gather(sdata, 1, (pos - start).clamp(0, sdata.shape[1] - 1))
    end = start + src.lengths.to(torch.int64)[:, None]
    return torch.where((pos >= start) & (pos < end), shifted, data), lengths + src.lengths


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
