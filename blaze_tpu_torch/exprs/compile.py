"""Expression lowering: IR -> torch ops over Columns
(≙ ``blaze_tpu/exprs/compile.py`` ``lower``, for the expressions the
TPC-H q03/q06 slice reaches).

Spark three-valued null logic is carried as (data, validity) pairs.
Data in invalid rows may be garbage; every lowering is garbage-safe.
Decimals are unscaled int64 with Spark result types; products whose
precision can exceed int64 run on exact two-limb int128
(``exprs/int128.py``) with HALF_UP rescale and overflow-to-null.
Everything else raises ``NotImplementedError``: this slice lowers
column refs, literals, comparisons, AND/OR/NOT, IS [NOT] NULL,
integer/float ``+ - *``, decimal ``+ - *`` and aliases.
"""

from __future__ import annotations

import datetime
from decimal import Decimal
from typing import Dict, Optional

import numpy as np
import torch

from ..batch import Column, torch_dtype
from ..schema import (
    DataType,
    Schema,
    TypeKind,
    decimal_add_type,
    decimal_mul_type,
    string_width_for,
)
from . import int128 as I
from . import strings as S
from .ir import Alias, BinOp, Col, Expr, IsNotNull, IsNull, Lit, Not

_RANK = {
    TypeKind.INT8: 0,
    TypeKind.INT16: 1,
    TypeKind.INT32: 2,
    TypeKind.INT64: 3,
    TypeKind.FLOAT32: 4,
    TypeKind.FLOAT64: 5,
}
_INT_DECIMAL_PRECISION = {
    TypeKind.BOOL: 1,
    TypeKind.INT8: 3,
    TypeKind.INT16: 5,
    TypeKind.INT32: 10,
    TypeKind.INT64: 20,
}

_CMP_OPS = ("==", "!=", "<", "<=", ">", ">=")
_LOGIC_OPS = ("and", "or")


# ------------------------------------------------------------- inference


def infer_lit_dtype(value, dtype: Optional[DataType]) -> DataType:
    if dtype is not None:
        return dtype
    if value is None:
        return DataType.null()
    if isinstance(value, bool):
        return DataType.bool_()
    if isinstance(value, int):
        return DataType.int32() if -(2**31) <= value < 2**31 else DataType.int64()
    if isinstance(value, float):
        return DataType.float64()
    if isinstance(value, str):
        return DataType.string(string_width_for(len(value.encode("utf-8"))))
    if isinstance(value, datetime.date):
        return DataType.date32()
    raise TypeError(f"cannot infer literal type of {value!r}")


def _as_decimal(t: DataType) -> DataType:
    return t if t.is_decimal else DataType.decimal(_INT_DECIMAL_PRECISION[t.kind], 0)


def _common_type(a: DataType, b: DataType) -> DataType:
    if a == b:
        return a
    if a.kind == TypeKind.NULL:
        return b
    if b.kind == TypeKind.NULL:
        return a
    if a.is_string and b.is_string:
        return DataType.string(max(a.string_width, b.string_width))
    if a.is_decimal or b.is_decimal:
        if a.is_float or b.is_float:
            return DataType.float64()
        da, db = _as_decimal(a), _as_decimal(b)
        scale = max(da.scale, db.scale)
        intd = max(da.precision - da.scale, db.precision - db.scale)
        return DataType.decimal(min(intd + scale, 38), scale)
    if a.kind in _RANK and b.kind in _RANK:
        return a if _RANK[a.kind] >= _RANK[b.kind] else b
    if a.kind == b.kind:
        return a
    raise TypeError(f"no common type for {a!r} and {b!r}")


def infer_dtype(expr: Expr, schema: Schema) -> DataType:
    if isinstance(expr, Col):
        return schema.field(expr.name).dtype
    if isinstance(expr, Alias):
        return infer_dtype(expr.child, schema)
    if isinstance(expr, Lit):
        return infer_lit_dtype(expr.value, expr.dtype)
    if isinstance(expr, (IsNull, IsNotNull, Not)):
        return DataType.bool_()
    if isinstance(expr, BinOp):
        if expr.op in _CMP_OPS or expr.op in _LOGIC_OPS:
            return DataType.bool_()
        lt = infer_dtype(expr.left, schema)
        rt = infer_dtype(expr.right, schema)
        if (lt.is_decimal or rt.is_decimal) and not (lt.is_float or rt.is_float):
            if expr.op in ("+", "-"):
                return decimal_add_type(_as_decimal(lt), _as_decimal(rt))
            if expr.op == "*":
                return decimal_mul_type(_as_decimal(lt), _as_decimal(rt))
            raise NotImplementedError(f"decimal {expr.op}")
        return _common_type(lt, rt)
    raise NotImplementedError(f"type of {type(expr).__name__}")


# ------------------------------------------------------------- decimals


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


# ------------------------------------------------------------- lowering


def _coerce(col: Column, to: DataType) -> Column:
    """Implicit widening to a common type."""
    if col.dtype == to:
        return col
    n, dev = col.capacity, col.device
    if col.dtype.kind == TypeKind.NULL:
        zeros_b = torch.zeros(n, dtype=torch.bool, device=dev)
        if to.is_string:
            return Column(
                to,
                torch.zeros((n, to.string_width), dtype=torch.uint8, device=dev),
                zeros_b,
                torch.zeros(n, dtype=torch.int32, device=dev),
            )
        return Column(to, torch.zeros(n, dtype=torch_dtype(to), device=dev), zeros_b)
    if to.is_string and col.dtype.is_string:
        w = to.string_width - col.data.shape[1]
        data = col.data if w <= 0 else torch.nn.functional.pad(col.data, (0, w))
        return Column(to, data, col.validity, col.lengths)
    if to.is_decimal and col.dtype.is_decimal:
        data = rescale_decimal(col.data, col.dtype.scale, to.scale)
        return Column(to, data, decimal_overflow_null(data, col.validity, to.precision))
    if to.is_decimal and (col.dtype.is_integer or col.dtype.kind == TypeKind.BOOL):
        data = col.data.to(torch.int64) * 10**to.scale
        return Column(to, data, decimal_overflow_null(data, col.validity, to.precision))
    if to.is_float and col.dtype.is_decimal:
        data = col.data.to(torch.float64) / float(10**col.dtype.scale)
        return Column(to, data.to(torch_dtype(to)), col.validity)
    if to.kind in _RANK and (col.dtype.kind in _RANK or col.dtype.kind == TypeKind.BOOL):
        return Column(to, col.data.to(torch_dtype(to)), col.validity)
    raise NotImplementedError(f"coercion {col.dtype!r} -> {to!r}")


def unscaled_decimal(value, dtype: DataType) -> int:
    """The unscaled int of a logical decimal literal value (a string
    or int exactly, a float rounded)."""
    if isinstance(value, str):
        return int(Decimal(value).scaleb(dtype.scale).to_integral_value())
    if isinstance(value, float):
        return int(round(value * 10**dtype.scale))
    return int(value) * 10**dtype.scale


def _lit_column(value, dtype: DataType, n: int, device: torch.device,
                is_unscaled: bool = False) -> Column:
    if value is None:
        null = Column(
            DataType.null(),
            torch.zeros(n, dtype=torch.bool, device=device),
            torch.zeros(n, dtype=torch.bool, device=device),
        )
        return _coerce(null, dtype)
    valid = torch.ones(n, dtype=torch.bool, device=device)
    if dtype.is_string:
        b = value.encode("utf-8") if isinstance(value, str) else bytes(value)
        row = np.zeros(dtype.string_width, np.uint8)
        row[: len(b)] = np.frombuffer(b, np.uint8)
        data = torch.from_numpy(row).to(device).expand(n, dtype.string_width)
        return Column(dtype, data, valid, torch.full((n,), len(b), dtype=torch.int32, device=device))
    if dtype.is_decimal:
        unscaled = value if is_unscaled else unscaled_decimal(value, dtype)
        return Column(dtype, torch.full((n,), unscaled, dtype=torch.int64, device=device), valid)
    if dtype.kind == TypeKind.DATE32:
        if isinstance(value, str):
            value = datetime.date.fromisoformat(value)
        if isinstance(value, datetime.date):
            value = (value - datetime.date(1970, 1, 1)).days
        return Column(dtype, torch.full((n,), int(value), dtype=torch.int32, device=device), valid)
    return Column(dtype, torch.full((n,), value, dtype=torch_dtype(dtype), device=device), valid)


def _decimal_binop(op: str, l: Column, r: Column) -> Column:
    ld = _coerce(l, _as_decimal(l.dtype))
    rd = _coerce(r, _as_decimal(r.dtype))
    validity = ld.validity & rd.validity
    if op in ("+", "-"):
        out_t = decimal_add_type(ld.dtype, rd.dtype)
        a = rescale_decimal(ld.data, ld.dtype.scale, out_t.scale)
        b = rescale_decimal(rd.data, rd.dtype.scale, out_t.scale)
        data = a + b if op == "+" else a - b
        return Column(out_t, data, decimal_overflow_null(data, validity, out_t.precision))
    if op == "*":
        out_t = decimal_mul_type(ld.dtype, rd.dtype)
        raw_scale = ld.dtype.scale + rd.dtype.scale
        if ld.dtype.precision + rd.dtype.precision + 1 <= 18:
            # the raw product provably fits int64
            data = rescale_decimal(ld.data * rd.data, raw_scale, out_t.scale)
            return Column(out_t, data, decimal_overflow_null(data, validity, out_t.precision))
        # wide multiply: exact int128 product, HALF_UP rescale (Spark's
        # result scale never exceeds the raw scale), narrowed to int64
        hi, lo = I.mul_i64(ld.data, rd.data)
        if out_t.scale < raw_scale:
            data, fits = I.rescale_down(hi, lo, raw_scale - out_t.scale)
        else:
            data, fits = I.to_i64(hi, lo)
        validity = validity & fits
        return Column(out_t, data, decimal_overflow_null(data, validity, out_t.precision))
    raise NotImplementedError(f"decimal {op}")


def _arith(op: str, l: Column, r: Column) -> Column:
    if (l.dtype.is_decimal or r.dtype.is_decimal) and not (l.dtype.is_float or r.dtype.is_float):
        return _decimal_binop(op, l, r)
    common = _common_type(l.dtype, r.dtype)
    l, r = _coerce(l, common), _coerce(r, common)
    if op == "+":
        data = l.data + r.data
    elif op == "-":
        data = l.data - r.data
    elif op == "*":
        data = l.data * r.data
    else:
        raise NotImplementedError(op)
    return Column(common, data, l.validity & r.validity)


def _cmp(op: str, l: Column, r: Column) -> Column:
    validity = l.validity & r.validity
    if l.dtype.is_string or r.dtype.is_string:
        v = {
            "==": lambda: S.str_eq(l, r),
            "!=": lambda: ~S.str_eq(l, r),
            "<": lambda: S.str_lt(l, r),
            "<=": lambda: S.str_le(l, r),
            ">": lambda: S.str_lt(r, l),
            ">=": lambda: S.str_le(r, l),
        }[op]()
        return Column(DataType.bool_(), v, validity)
    common = _common_type(l.dtype, r.dtype)
    a, b = _coerce(l, common).data, _coerce(r, common).data
    v = {"==": torch.eq, "!=": torch.ne, "<": torch.lt, "<=": torch.le,
         ">": torch.gt, ">=": torch.ge}[op](a, b)
    return Column(DataType.bool_(), v, validity)


def _logic(op: str, l: Column, r: Column) -> Column:
    ld, rd = l.data.to(torch.bool), r.data.to(torch.bool)
    la, lf = l.validity & ld, l.validity & ~ld
    ra, rf = r.validity & rd, r.validity & ~rd
    if op == "and":
        return Column(DataType.bool_(), la & ra, (l.validity & r.validity) | lf | rf)
    return Column(DataType.bool_(), la | ra, (l.validity & r.validity) | la | ra)


def lower(expr: Expr, schema: Schema, cols: Dict[str, Column], n: int) -> Column:
    """Lower ``expr`` against resolved input columns of ``n`` rows."""
    if isinstance(expr, Col):
        return cols[expr.name]
    if isinstance(expr, Alias):
        return lower(expr.child, schema, cols, n)
    if isinstance(expr, Lit):
        device = next(iter(cols.values())).device
        return _lit_column(expr.value, infer_lit_dtype(expr.value, expr.dtype), n, device,
                           expr.unscaled)
    if isinstance(expr, Not):
        c = lower(expr.child, schema, cols, n)
        return Column(DataType.bool_(), ~c.data.to(torch.bool), c.validity)
    if isinstance(expr, (IsNull, IsNotNull)):
        c = lower(expr.child, schema, cols, n)
        v = ~c.validity if isinstance(expr, IsNull) else c.validity
        return Column(DataType.bool_(), v, torch.ones_like(c.validity))
    if isinstance(expr, BinOp):
        l = lower(expr.left, schema, cols, n)
        r = lower(expr.right, schema, cols, n)
        if expr.op in _LOGIC_OPS:
            return _logic(expr.op, l, r)
        if expr.op in _CMP_OPS:
            return _cmp(expr.op, l, r)
        return _arith(expr.op, l, r)
    raise NotImplementedError(f"lowering of {type(expr).__name__}")
