"""Logical type system and schemas (the port's own copy of
``blaze_tpu/schema.py``; numpy only).

Physical lowering onto torch tensors:

====================  =========================================================
logical               device representation
====================  =========================================================
BOOL                  ``torch.bool (N,)``
INT8..INT64           ``torch.int8..int64 (N,)``
FLOAT32/FLOAT64       ``torch.float32/float64 (N,)``
DECIMAL(p, s)         unscaled ``torch.int64 (N,)``; results wider than int64
                      overflow to null, wide sums run on two int64 limbs
DATE32                days since epoch, ``torch.int32 (N,)``
TIMESTAMP             microseconds since epoch, ``torch.int64 (N,)``
STRING                utf8 bytes, zero-padded ``torch.uint8 (N, W)`` +
                      ``torch.int32 (N,)`` byte lengths; ``W`` is a per-column
                      power of two
BINARY                same as STRING
NULL                  ``torch.bool (N,)`` of zeros
====================  =========================================================

Every column additionally carries a validity mask ``torch.bool (N,)``
(True = valid), and batches are padded to a power-of-two capacity.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np


class TypeKind(enum.Enum):
    NULL = 0
    BOOL = 1
    INT8 = 2
    INT16 = 3
    INT32 = 4
    INT64 = 5
    FLOAT32 = 6
    FLOAT64 = 7
    DECIMAL = 8
    STRING = 9
    BINARY = 10
    DATE32 = 11
    TIMESTAMP = 12
    # nested types (fixed max-elements padded device layout; see Column)
    ARRAY = 13
    MAP = 14
    STRUCT = 15
    # host-only opaque python objects (≙ reference UserDefinedArray,
    # datafusion-ext-commons/src/uda.rs:25 — an Arrow array of opaque
    # JVM objects carrying partial ObjectHashAggregate states)
    OPAQUE = 16


_FIXED_NP = {
    TypeKind.NULL: np.bool_,
    TypeKind.BOOL: np.bool_,
    TypeKind.INT8: np.int8,
    TypeKind.INT16: np.int16,
    TypeKind.INT32: np.int32,
    TypeKind.INT64: np.int64,
    TypeKind.FLOAT32: np.float32,
    TypeKind.FLOAT64: np.float64,
    TypeKind.DECIMAL: np.int64,
    TypeKind.DATE32: np.int32,
    TypeKind.TIMESTAMP: np.int64,
}

_INT_KINDS = (TypeKind.INT8, TypeKind.INT16, TypeKind.INT32, TypeKind.INT64)
_FLOAT_KINDS = (TypeKind.FLOAT32, TypeKind.FLOAT64)


@dataclass(frozen=True)
class DataType:
    """Logical type.  Nested kinds (ARRAY/MAP/STRUCT — ≙ the Arrow
    List/Map/Struct encodings in the reference's blaze.proto:738-941)
    carry their child types and, for ARRAY/MAP, the fixed per-row
    element budget ``max_elems`` that sets the padded device layout
    width (elements beyond it cannot be stored)."""

    kind: TypeKind
    precision: int = 0          # DECIMAL only
    scale: int = 0              # DECIMAL only
    string_width: int = 64      # STRING/BINARY only: padded byte width W
    elem: Optional["DataType"] = None         # ARRAY element type
    key: Optional["DataType"] = None          # MAP key type
    value: Optional["DataType"] = None        # MAP value type
    struct_fields: Optional[Tuple["Field", ...]] = None  # STRUCT
    max_elems: int = 0          # ARRAY/MAP padded element count M

    # ---- constructors ----
    @staticmethod
    def bool_() -> "DataType":
        return DataType(TypeKind.BOOL)

    @staticmethod
    def int8() -> "DataType":
        return DataType(TypeKind.INT8)

    @staticmethod
    def int16() -> "DataType":
        return DataType(TypeKind.INT16)

    @staticmethod
    def int32() -> "DataType":
        return DataType(TypeKind.INT32)

    @staticmethod
    def int64() -> "DataType":
        return DataType(TypeKind.INT64)

    @staticmethod
    def float32() -> "DataType":
        return DataType(TypeKind.FLOAT32)

    @staticmethod
    def float64() -> "DataType":
        return DataType(TypeKind.FLOAT64)

    @staticmethod
    def decimal(precision: int, scale: int) -> "DataType":
        return DataType(TypeKind.DECIMAL, precision=precision, scale=scale)

    @staticmethod
    def string(width: int = 64) -> "DataType":
        return DataType(TypeKind.STRING, string_width=width)

    @staticmethod
    def binary(width: int = 64) -> "DataType":
        return DataType(TypeKind.BINARY, string_width=width)

    @staticmethod
    def date32() -> "DataType":
        return DataType(TypeKind.DATE32)

    @staticmethod
    def timestamp() -> "DataType":
        return DataType(TypeKind.TIMESTAMP)

    @staticmethod
    def null() -> "DataType":
        return DataType(TypeKind.NULL)

    @staticmethod
    def opaque() -> "DataType":
        """Host-only opaque python objects (UDAF partial states;
        ≙ UserDefinedArray, uda.rs:25)."""
        return DataType(TypeKind.OPAQUE)

    @staticmethod
    def array(elem: "DataType", max_elems: int = 16) -> "DataType":
        return DataType(TypeKind.ARRAY, elem=elem, max_elems=max_elems)

    @staticmethod
    def map(key: "DataType", value: "DataType", max_elems: int = 16) -> "DataType":
        return DataType(TypeKind.MAP, key=key, value=value, max_elems=max_elems)

    @staticmethod
    def struct(fields) -> "DataType":
        return DataType(TypeKind.STRUCT, struct_fields=tuple(fields))

    # ---- predicates ----
    @property
    def is_string(self) -> bool:
        return self.kind in (TypeKind.STRING, TypeKind.BINARY)

    @property
    def is_integer(self) -> bool:
        return self.kind in _INT_KINDS

    @property
    def is_float(self) -> bool:
        return self.kind in _FLOAT_KINDS

    @property
    def is_decimal(self) -> bool:
        return self.kind == TypeKind.DECIMAL

    @property
    def is_numeric(self) -> bool:
        return self.is_integer or self.is_float or self.is_decimal

    @property
    def is_nested(self) -> bool:
        return self.kind in (TypeKind.ARRAY, TypeKind.MAP, TypeKind.STRUCT)

    @property
    def np_dtype(self) -> np.dtype:
        """Physical numpy dtype of the data buffer."""
        if self.is_nested:
            raise TypeError(f"nested type {self!r} has no single buffer dtype")
        if self.is_string:
            return np.dtype(np.uint8)
        if self.kind == TypeKind.OPAQUE:
            return np.dtype(object)
        return np.dtype(_FIXED_NP[self.kind])

    def __repr__(self) -> str:  # compact, e.g. decimal(12,2), string[64]
        if self.kind == TypeKind.DECIMAL:
            return f"decimal({self.precision},{self.scale})"
        if self.is_string:
            return f"{self.kind.name.lower()}[{self.string_width}]"
        if self.kind == TypeKind.ARRAY:
            return f"array<{self.elem!r}>[{self.max_elems}]"
        if self.kind == TypeKind.MAP:
            return f"map<{self.key!r},{self.value!r}>[{self.max_elems}]"
        if self.kind == TypeKind.STRUCT:
            inner = ", ".join(repr(f) for f in self.struct_fields)
            return f"struct<{inner}>"
        return self.kind.name.lower()


@dataclass(frozen=True)
class Field:
    name: str
    dtype: DataType
    nullable: bool = True

    def __repr__(self) -> str:
        n = "" if self.nullable else " not null"
        return f"{self.name}: {self.dtype!r}{n}"


@dataclass(frozen=True)
class Schema:
    fields: Tuple[Field, ...]

    def __init__(self, fields):
        object.__setattr__(self, "fields", tuple(fields))

    @property
    def names(self) -> List[str]:
        return [f.name for f in self.fields]

    def field(self, name: str) -> Field:
        for f in self.fields:
            if f.name == name:
                return f
        raise KeyError(f"no field {name!r} in {self.names}")

    def index(self, name: str) -> int:
        for i, f in enumerate(self.fields):
            if f.name == name:
                return i
        raise KeyError(f"no field {name!r} in {self.names}")

    def __len__(self) -> int:
        return len(self.fields)

    def __iter__(self):
        return iter(self.fields)

    def __repr__(self) -> str:
        return "Schema(" + ", ".join(repr(f) for f in self.fields) + ")"


def string_width_for(max_len: int) -> int:
    """Smallest power-of-two padded width covering ``max_len`` bytes
    (min 8, so a row of widths stays lane-aligned)."""
    w = 8
    while w < max_len:
        w *= 2
    return w


# Spark result-type rules for decimal arithmetic
# (Spark DecimalPrecision; the reference inherits these from Spark's
# planner and enforces them natively in its spark-semantics CastExpr /
# check_overflow — datafusion-ext-commons/src/cast.rs,
# datafusion-ext-functions check_overflow).
MAX_PRECISION = 38


def _bounded(p: int, s: int) -> DataType:
    """Spark's DecimalType.adjustPrecisionScale (allowPrecisionLoss):
    when the ideal precision exceeds 38, keep the integral digits and
    shrink the scale, but never below min(s, 6)."""
    if p <= MAX_PRECISION:
        return DataType.decimal(p, s)
    digits = p - s
    min_scale = min(s, 6)
    adj_scale = max(MAX_PRECISION - digits, min_scale)
    return DataType.decimal(MAX_PRECISION, adj_scale)


def decimal_add_type(a: DataType, b: DataType) -> DataType:
    s = max(a.scale, b.scale)
    p = max(a.precision - a.scale, b.precision - b.scale) + s + 1
    return _bounded(p, s)


def decimal_mul_type(a: DataType, b: DataType) -> DataType:
    return _bounded(a.precision + b.precision + 1, a.scale + b.scale)


def decimal_div_type(a: DataType, b: DataType) -> DataType:
    p = a.precision - a.scale + b.scale + max(6, a.scale + b.precision + 1)
    s = max(6, a.scale + b.precision + 1)
    return _bounded(p, s)


def decimal_sum_agg_type(a: DataType) -> DataType:
    # Spark: sum(decimal(p, s)) -> decimal(p + 10, s)
    return _bounded(a.precision + 10, a.scale)


def decimal_avg_agg_type(a: DataType) -> DataType:
    # Spark: avg(decimal(p, s)) -> decimal(p + 4, s + 4)
    return _bounded(a.precision + 4, a.scale + 4)
