"""Expression lowering: IR -> torch ops over Columns
(≙ ``blaze_tpu/exprs/compile.py`` ``lower``).

Spark three-valued null logic is carried as (data, validity) pairs.
Data in invalid rows may be garbage; every lowering is garbage-safe.
Decimals are unscaled int64 with Spark result types; products and
quotients whose precision can exceed int64 run on exact two-limb
int128 (``exprs/int128.py``) with HALF_UP rounding and overflow to
null.  The port lowers column refs, literals, aliases, comparisons,
AND/OR/NOT, IS [NOT] NULL, ``+ - * / %`` over integers, floats and
decimals, casts (``exprs/cast.py``), the registered scalar functions
(``exprs/functions.py``), CASE, IN and LIKE, and the nested accessors
(an array's element at a literal index, a map's value at a literal key,
a struct's field, ``named_struct``; ≙ the reference's
``_lower_get_indexed``/``_lower_get_map_value``, the same 0-based index
and null rules); anything else raises ``NotImplementedError``.

A LIKE pattern with ``_`` or with more than one inner segment has no
device form, and neither have the host functions and the JSON functions
(``functions.HOST_IMPLS``, ``functions.JSON_FUNCS``): ``lower``
evaluates them on the host, one batch at a time (``host_like``,
``functions.host_function``), wherever they stand in an expression.  The
reference hoists such subtrees out of filter and project at
construction (``split_host_exprs``) because its lowering runs under
jit; eager lowering needs no hoist.
"""

from __future__ import annotations

import datetime
import re
from decimal import Decimal
from typing import Dict, List, Optional

import numpy as np
import torch

from ..batch import Column, torch_dtype
from ..schema import (
    DataType,
    Field,
    Schema,
    TypeKind,
    decimal_add_type,
    decimal_div_type,
    decimal_mul_type,
    string_width_for,
)
from . import int128 as I
from . import strings as S
from .cast import decimal_overflow_null, decimal_to_float, lower_cast, rescale_decimal
from .ir import (
    Alias, BinOp, Case, Cast, Col, Expr, GetIndexedField, GetMapValue, GetStructField, InList, IsNotNull, IsNull,
    Like, Lit, NamedStruct, Not, ScalarFunc,
)

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
    if isinstance(value, bytes):
        return DataType.binary(string_width_for(len(value)))
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
    if isinstance(expr, Cast):
        return expr.to
    if isinstance(expr, ScalarFunc):
        from .functions import infer_func_dtype

        return infer_func_dtype(expr, schema)
    if isinstance(expr, (IsNull, IsNotNull, Not, InList, Like)):
        return DataType.bool_()
    if isinstance(expr, BinOp):
        if expr.op in _CMP_OPS or expr.op in _LOGIC_OPS:
            return DataType.bool_()
        lt = infer_dtype(expr.left, schema)
        rt = infer_dtype(expr.right, schema)
        if (lt.is_decimal or rt.is_decimal) and not (lt.is_float or rt.is_float):
            return _decimal_result_type(expr.op, _as_decimal(lt), _as_decimal(rt))
        if expr.op == "/":
            return DataType.float64()
        return _common_type(lt, rt)
    if isinstance(expr, Case):
        t = DataType.null()
        for _, v in expr.branches:
            t = _common_type(t, infer_dtype(v, schema))
        if expr.else_ is not None:
            t = _common_type(t, infer_dtype(expr.else_, schema))
        return t
    if isinstance(expr, GetIndexedField):
        t = infer_dtype(expr.child, schema)
        if t.kind != TypeKind.ARRAY:
            raise TypeError(f"get_item over {t!r}")
        return t.elem
    if isinstance(expr, GetMapValue):
        t = infer_dtype(expr.child, schema)
        if t.kind != TypeKind.MAP:
            raise TypeError(f"map_value over {t!r}")
        return t.value
    if isinstance(expr, GetStructField):
        t = infer_dtype(expr.child, schema)
        if t.kind != TypeKind.STRUCT:
            raise TypeError(f"get_field over {t!r}")
        for f in t.struct_fields:
            if f.name == expr.name:
                return f.dtype
        raise KeyError(f"no struct field {expr.name!r} in {t!r}")
    if isinstance(expr, NamedStruct):
        return DataType.struct([Field(nm, infer_dtype(e, schema)) for nm, e in zip(expr.names, expr.exprs)])
    raise NotImplementedError(f"type of {type(expr).__name__}")


def _decimal_result_type(op: str, a: DataType, b: DataType) -> DataType:
    if op in ("+", "-"):
        return decimal_add_type(a, b)
    if op == "*":
        return decimal_mul_type(a, b)
    if op == "/":
        return decimal_div_type(a, b)
    if op == "%":
        return DataType.decimal(min(38, max(a.precision, b.precision)), max(a.scale, b.scale))
    raise NotImplementedError(f"decimal {op}")


# ------------------------------------------------------------- lowering


def _coerce(col: Column, to: DataType) -> Column:
    """Implicit widening to a common type."""
    if col.dtype == to:
        return col
    n, dev = col.capacity, col.device
    if col.dtype.kind == TypeKind.NULL and to.is_nested:
        return null_nested_column(to, (n,), dev)
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
        return decimal_to_float(col, to)
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


def null_column(dtype: DataType, n: int, device: torch.device) -> Column:
    """An all-null column of ``n`` rows."""
    return _lit_column(None, dtype, n, device)


def null_nested_column(dtype: DataType, shape: tuple, device: torch.device) -> Column:
    """An all-null column of any type whose buffers lead with ``shape``
    (an element layout adds an axis at each ARRAY/MAP level)."""
    zeros_b = torch.zeros(shape, dtype=torch.bool, device=device)
    if dtype.kind in (TypeKind.ARRAY, TypeKind.MAP):
        inner = shape + (dtype.max_elems,)
        kids = [dtype.elem] if dtype.kind == TypeKind.ARRAY else [dtype.key, dtype.value]
        return Column(dtype, None, zeros_b, torch.zeros(shape, dtype=torch.int32, device=device),
                      tuple(null_nested_column(k, inner, device) for k in kids))
    if dtype.kind == TypeKind.STRUCT:
        return Column(dtype, None, zeros_b, None,
                      tuple(null_nested_column(f.dtype, shape, device) for f in dtype.struct_fields))
    if dtype.is_string:
        return Column(dtype, torch.zeros(shape + (dtype.string_width,), dtype=torch.uint8, device=device),
                      zeros_b, torch.zeros(shape, dtype=torch.int32, device=device))
    return Column(dtype, torch.zeros(shape, dtype=torch_dtype(dtype), device=device), zeros_b)


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
    if op == "/":
        return _decimal_div(ld, rd, validity)
    if op == "%":
        out_t = _decimal_result_type("%", ld.dtype, rd.dtype)
        a = rescale_decimal(ld.data, ld.dtype.scale, out_t.scale)
        b = rescale_decimal(rd.data, rd.dtype.scale, out_t.scale)
        # x % -1 == x % 1 == 0, and -1 would trap on INT64_MIN
        den = torch.where((b == 0) | (b == -1), 1, b)
        return Column(out_t, torch.fmod(a, den), validity & (b != 0))
    raise NotImplementedError(f"decimal {op}")


def _div_half_up_i64(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """HALF_UP ``num / den`` for int64 operands whose magnitudes leave
    room for ``|num| + |den| / 2`` (``den`` nonzero)."""
    an, ad = num.abs(), den.abs()
    q = (an + ad // 2) // ad
    return torch.where((num < 0) ^ (den < 0), -q, q)


def _decimal_div(ld: Column, rd: Column, validity: torch.Tensor) -> Column:
    """decimal / decimal with Spark's result type: the quotient at the
    result scale, HALF_UP; a zero divisor or a quotient past the
    precision gives null."""
    out_t = decimal_div_type(ld.dtype, rd.dtype)
    validity = validity & (rd.data != 0)
    # num * 10^shift / den is the unscaled quotient at the result scale
    shift = out_t.scale - ld.dtype.scale + rd.dtype.scale
    den = torch.where(rd.data == 0, 1, rd.data)
    if ld.dtype.precision + shift <= 18:
        # the shifted numerator provably fits int64
        q = _div_half_up_i64(ld.data * 10**shift, den)
        return Column(out_t, q, decimal_overflow_null(q, validity, out_t.precision))
    hi, lo = I.from_i64(ld.data)
    if shift >= 0:
        # mul_pow10 wraps past 2^127: a numerator whose shifted value
        # cannot fit int128 has a quotient past 38 digits: null
        lim = (2**127 - 1) // 10**shift
        if lim < 2**63:
            fits_num = ld.data.abs() <= lim
            validity = validity & fits_num
            hi = torch.where(fits_num, hi, 0)
            lo = torch.where(fits_num, lo, 0)
        hi, lo = I.mul_pow10(hi, lo, shift)
        q, fits = I.div_round_half_up(hi, lo, den)
    else:
        # a down-shift folds into the divisor (one rounding).  Where the
        # folded divisor passes int64, |quotient| <= 1: HALF_UP gives
        # +-1 iff 2|num| >= |den| * 10^k (an exact int128 compare), else 0
        k10 = -shift
        if k10 <= 18:
            fits_den = den.abs() <= (2**63 - 1) // 10**k10
            folded = torch.where(fits_den, den * 10**k10, 1)
        else:
            fits_den = torch.zeros_like(validity)
            folded = torch.ones_like(den)
        if k10 <= 19:
            # |den| * 10^19 < 2^127: exact
            dh, dl = I.mul_pow10(*I.abs128(*I.from_i64(rd.data)), k10)
            nh, nl = I.abs128(*I.from_i64(ld.data))
            nh, nl = I.add(nh, nl, nh, nl)
            ge_half = (dh < nh) | ((dh == nh) & ~I.ult(nl, dl))
        else:
            # |den| * 10^20 > 2|num| for every int64 num
            ge_half = torch.zeros_like(validity)
        neg = (ld.data < 0) ^ (rd.data < 0)
        tiny = torch.where(ge_half, torch.where(neg, -1, 1), 0)
        q, fits = I.div_round_half_up(hi, lo, folded)
        q = torch.where(fits_den, q, tiny)
        fits = fits | ~fits_den
    validity = validity & fits
    return Column(out_t, q, decimal_overflow_null(q, validity, out_t.precision))


def _arith(op: str, l: Column, r: Column) -> Column:
    if (l.dtype.is_decimal or r.dtype.is_decimal) and not (l.dtype.is_float or r.dtype.is_float):
        return _decimal_binop(op, l, r)
    validity = l.validity & r.validity
    if op == "/":
        # Spark's `/` is double division; a zero divisor gives null
        a, b = _coerce(l, DataType.float64()).data, _coerce(r, DataType.float64()).data
        den = torch.where(b == 0, 1.0, b)
        return Column(DataType.float64(), a / den, validity & (b != 0))
    common = _common_type(l.dtype, r.dtype)
    a, b = _coerce(l, common).data, _coerce(r, common).data
    if op == "+":
        data = a + b
    elif op == "-":
        data = a - b
    elif op == "*":
        data = a * b
    elif op == "%":
        # the sign of the dividend, as Spark's (and lax.rem's); a zero
        # divisor gives null, and an integer -1 divides as 1 (the same
        # 0, without INT_MIN's trap)
        zero = b == 0
        den = torch.where(zero | (b == -1), 1, b) if not common.is_float else torch.where(zero, 1.0, b)
        data = torch.fmod(a, den)
        validity = validity & ~zero
    else:
        raise NotImplementedError(op)
    return Column(common, data, validity)


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
    if isinstance(expr, Cast):
        return lower_cast(lower(expr.child, schema, cols, n), expr.to)
    if isinstance(expr, ScalarFunc):
        from .functions import host_function, is_host_function, lower_func

        if is_host_function(expr.name):
            return host_function(expr, schema, cols, n, lower)
        return lower_func(expr, schema, cols, n, lower)
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
    if isinstance(expr, InList):
        return _lower_in(expr, schema, cols, n)
    if isinstance(expr, Like):
        return _lower_like(expr, schema, cols, n)
    if isinstance(expr, Case):
        return _lower_case(expr, schema, cols, n)
    if isinstance(expr, GetIndexedField):
        return _lower_get_indexed(expr, schema, cols, n)
    if isinstance(expr, GetMapValue):
        return _lower_get_map_value(expr, schema, cols, n)
    if isinstance(expr, GetStructField):
        c = lower(expr.child, schema, cols, n)
        kid = c.children[[f.name for f in c.dtype.struct_fields].index(expr.name)]
        return Column(kid.dtype, kid.data, kid.validity & c.validity, kid.lengths, kid.children)
    if isinstance(expr, NamedStruct):
        kids = tuple(lower(e, schema, cols, n) for e in expr.exprs)
        return Column(infer_dtype(expr, schema), None, torch.ones_like(kids[0].validity), None, kids)
    raise NotImplementedError(f"lowering of {type(expr).__name__}")


def elem_at(elem: Column, i: int) -> Column:
    """Element ``i`` of every row of an element-layout column
    (``(cap, M, ...)`` buffers -> ``(cap, ...)``)."""
    return elem.map_buffers(lambda t: t[:, i])


def elem_gather(elem: Column, idx: torch.Tensor) -> Column:
    """Per row ``r``, element ``idx[r]`` of an element-layout column."""
    def g(t):
        ix = idx.to(torch.int64).view((-1, 1) + (1,) * (t.dim() - 2))
        return torch.gather(t, 1, ix.expand((t.shape[0], 1) + tuple(t.shape[2:]))).squeeze(1)

    return elem.map_buffers(g)


def _lower_get_indexed(expr: GetIndexedField, schema: Schema, cols: Dict[str, Column], n: int) -> Column:
    """The element at a literal 0-based index: null where the array is
    null, shorter than the index, or its element is null; an index
    outside ``[0, M)`` is null everywhere."""
    c = lower(expr.child, schema, cols, n)
    i = expr.index
    if i < 0 or i >= c.dtype.max_elems:
        return null_nested_column(c.dtype.elem, (c.capacity,), c.device)
    out = elem_at(c.children[0], i)
    valid = c.validity & (c.lengths > i) & out.validity
    return Column(out.dtype, out.data, valid, out.lengths, out.children)


def _lower_get_map_value(expr: GetMapValue, schema: Schema, cols: Dict[str, Column], n: int) -> Column:
    """The value at the first key equal to a literal key; null where the
    map is null, the key absent or its value null."""
    c = lower(expr.child, schema, cols, n)
    keys, vals = c.children
    m = c.dtype.max_elems
    within = (torch.arange(m, device=c.device)[None, :] < c.lengths[:, None]) & keys.validity
    if c.dtype.key.is_string:
        kb = expr.key.encode("utf-8") if isinstance(expr.key, str) else bytes(expr.key)
        w = keys.data.shape[-1]
        if len(kb) > w:
            eq = torch.zeros_like(within)
        else:
            pat = np.zeros(w, np.uint8)
            pat[:len(kb)] = np.frombuffer(kb, np.uint8)
            eq = (keys.data == torch.from_numpy(pat).to(c.device)).all(-1) & (keys.lengths == len(kb))
    else:
        key = _lit_column(expr.key, c.dtype.key, 1, c.device)
        eq = keys.data == key.data[0]
    hit = eq & within
    found = hit.any(1)
    out = elem_gather(vals, hit.to(torch.int8).argmax(1))
    valid = c.validity & found & out.validity
    return Column(out.dtype, out.data, valid, out.lengths, out.children)


def _lower_in(expr: InList, schema: Schema, cols: Dict[str, Column], n: int) -> Column:
    """``child IN (v...)`` as an OR of equalities, three-valued: a null
    child is null, and so is no match with a null in the list."""
    c = lower(expr.child, schema, cols, n)
    acc = None
    for v in expr.values:
        eq = _cmp("==", c, lower(v, schema, cols, n))
        acc = eq if acc is None else _logic("or", acc, eq)
    if expr.negated:
        return Column(DataType.bool_(), ~acc.data, acc.validity)
    return acc


def _lower_case(expr: Case, schema: Schema, cols: Dict[str, Column], n: int) -> Column:
    """The first branch whose condition is true (a null condition is
    false) picks its value; else the ELSE value, or null."""
    out_t = infer_dtype(expr, schema)
    if expr.else_ is not None:
        result = _coerce(lower(expr.else_, schema, cols, n), out_t)
    else:
        result = _lit_column(None, out_t, n, next(iter(cols.values())).device)
    for cond, val in reversed(expr.branches):
        c = lower(cond, schema, cols, n)
        v = _coerce(lower(val, schema, cols, n), out_t)
        picked = c.validity & c.data.to(torch.bool)
        validity = torch.where(picked, v.validity, result.validity)
        if out_t.is_string:
            w = max(v.data.shape[1], result.data.shape[1])
            data = torch.where(picked[:, None], S.pad_width(v.data, w), S.pad_width(result.data, w))
            result = Column(out_t, data, validity, torch.where(picked, v.lengths, result.lengths))
        else:
            result = Column(out_t, torch.where(picked, v.data, result.data), validity)
    return result


def like_pattern_parts(pattern: str) -> Optional[List[bytes]]:
    """The pattern split on ``%`` (empty first/last parts: unanchored),
    or None when it holds ``_``."""
    if "_" in pattern:
        return None
    return [p.encode("utf-8") for p in pattern.split("%")]


def like_needs_host(pattern: str) -> bool:
    """True for a pattern with no device form: one with ``_``, or with
    an inner segment beside another segment (``%a%b%``, ``a%b%``)."""
    parts = like_pattern_parts(pattern)
    if parts is None:
        return True
    middle = [p for p in parts[1:-1] if p]
    return bool(middle) and (len(middle) > 1 or bool(parts[0]) or bool(parts[-1]))


def expr_children(expr: Expr) -> List[Expr]:
    """The direct sub-expressions of ``expr``."""
    if isinstance(expr, (Alias, Not, IsNull, IsNotNull, Cast, Like)):
        return [expr.child]
    if isinstance(expr, BinOp):
        return [expr.left, expr.right]
    if isinstance(expr, InList):
        return [expr.child] + list(expr.values)
    if isinstance(expr, Case):
        out = [x for branch in expr.branches for x in branch]
        return out + ([] if expr.else_ is None else [expr.else_])
    if isinstance(expr, ScalarFunc):
        return list(expr.args)
    if isinstance(expr, (GetIndexedField, GetMapValue, GetStructField)):
        return [expr.child]
    if isinstance(expr, NamedStruct):
        return list(expr.exprs)
    return []


def needs_host(expr: Expr) -> bool:
    """True when ``lower`` evaluates part of the tree on the host (a
    LIKE with no device form, a host or JSON function): an operator
    holding such an expression cannot join a fused chain, whose
    transforms never wait for the device (≙ the reference's
    ``needs_host``)."""
    from .functions import is_host_function

    if isinstance(expr, Like) and like_needs_host(expr.pattern):
        return True
    if isinstance(expr, ScalarFunc) and is_host_function(expr.name):
        return True
    return any(needs_host(c) for c in expr_children(expr))


def _lower_like(expr: Like, schema: Schema, cols: Dict[str, Column], n: int) -> Column:
    c = lower(expr.child, schema, cols, n)
    if like_needs_host(expr.pattern):
        return host_like(c, n, expr.pattern, expr.negated)
    parts = like_pattern_parts(expr.pattern)
    middle = [p for p in parts[1:-1] if p]
    if len(parts) == 1:
        v = S.starts_with(c, parts[0]) & (c.lengths == len(parts[0]))
    elif middle:
        # one inner segment, unanchored (like_needs_host took the rest)
        v = S.contains(c, middle[0])
    else:
        v = S.starts_with(c, parts[0]) & S.ends_with(c, parts[-1])
        # the anchored parts may not overlap
        v = v & (c.lengths >= len(parts[0]) + len(parts[-1]))
    if expr.negated:
        v = ~v
    return Column(DataType.bool_(), v, c.validity)


# ------------------------------------------------------------ host LIKE


def like_regex(pattern: str) -> "re.Pattern":
    """The pattern as an anchored regular expression: ``%`` any run of
    characters, ``_`` one character, everything else literal."""
    body = "".join(".*" if ch == "%" else "." if ch == "_" else re.escape(ch) for ch in pattern)
    return re.compile("^" + body + "$", re.DOTALL)


def host_like(c: Column, n: int, pattern: str, negated: bool) -> Column:
    """LIKE over the first ``n`` rows of a string column, on the host:
    one copy of the column to the host, a regular expression per row,
    one copy of the result back; padding rows come back null."""
    from ..batch import column_from_numpy, column_to_pylist

    rx = like_regex(pattern)
    vals = column_to_pylist(c, n)
    cap = c.capacity
    out = np.zeros(cap, np.bool_)
    validity = np.zeros(cap, np.bool_)
    for i, v in enumerate(vals):
        if v is not None:
            validity[i] = True
            out[i] = (rx.match(v) is None) == negated
    return column_from_numpy(DataType.bool_(), out, validity, cap, device=c.device)
