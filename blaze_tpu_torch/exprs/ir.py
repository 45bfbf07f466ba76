"""Expression IR (the port's own copy of the part of
``blaze_tpu/exprs/ir.py`` that its lowering covers).

A small tree with python operator sugar for building plans:
``(col("a") + lit(1)) < col("b")``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional, Tuple

from ..schema import DataType


class Expr:
    """Base class.  Operator overloads build trees."""

    # arithmetic
    def __add__(self, o): return BinOp("+", self, _wrap(o))
    def __radd__(self, o): return BinOp("+", _wrap(o), self)
    def __sub__(self, o): return BinOp("-", self, _wrap(o))
    def __rsub__(self, o): return BinOp("-", _wrap(o), self)
    def __mul__(self, o): return BinOp("*", self, _wrap(o))
    def __rmul__(self, o): return BinOp("*", _wrap(o), self)
    def __truediv__(self, o): return BinOp("/", self, _wrap(o))
    def __mod__(self, o): return BinOp("%", self, _wrap(o))
    # comparison
    def __eq__(self, o): return BinOp("==", self, _wrap(o))  # type: ignore[override]
    def __ne__(self, o): return BinOp("!=", self, _wrap(o))  # type: ignore[override]
    def __lt__(self, o): return BinOp("<", self, _wrap(o))
    def __le__(self, o): return BinOp("<=", self, _wrap(o))
    def __gt__(self, o): return BinOp(">", self, _wrap(o))
    def __ge__(self, o): return BinOp(">=", self, _wrap(o))
    # logic (bitwise sugar like pyspark)
    def __and__(self, o): return BinOp("and", self, _wrap(o))
    def __or__(self, o): return BinOp("or", self, _wrap(o))
    def __invert__(self): return Not(self)

    def __hash__(self):
        return id(self)

    def __bool__(self):
        # `==` builds a BinOp, so the truth value of an Expr is always a bug
        raise TypeError("Expr has no truth value")

    def is_null(self) -> "Expr":
        return IsNull(self)

    def is_not_null(self) -> "Expr":
        return IsNotNull(self)

    def cast(self, to: DataType) -> "Expr":
        return Cast(self, to)

    def isin(self, *values) -> "Expr":
        return InList(self, [_wrap(v) for v in values])

    def alias(self, name: str) -> "Expr":
        return Alias(self, name)

    def get_item(self, index: int) -> "Expr":
        return GetIndexedField(self, index)

    def map_value(self, key) -> "Expr":
        return GetMapValue(self, key)

    def get_field(self, name: str) -> "Expr":
        return GetStructField(self, name)


@dataclass(eq=False)
class Col(Expr):
    name: str


@dataclass(eq=False)
class Lit(Expr):
    value: Any                       # logical python value (None = null)
    dtype: Optional[DataType] = None  # inferred from value when omitted
    # a decimal whose ``value`` is already the unscaled int (as a plan
    # decoded from its protobuf carries it), not a logical value
    unscaled: bool = False


@dataclass(eq=False)
class Alias(Expr):
    child: Expr
    name: str


@dataclass(eq=False)
class BinOp(Expr):
    op: str  # + - * / % == != < <= > >= and or
    left: Expr
    right: Expr


@dataclass(eq=False)
class Not(Expr):
    child: Expr


@dataclass(eq=False)
class IsNull(Expr):
    child: Expr


@dataclass(eq=False)
class IsNotNull(Expr):
    child: Expr


@dataclass(eq=False)
class Cast(Expr):
    """Spark-semantics cast (non-ANSI: integer narrowing wraps, decimal
    overflow gives null; lowered by ``exprs/cast.py``)."""

    child: Expr
    to: DataType


@dataclass(eq=False)
class Case(Expr):
    """CASE WHEN c1 THEN v1 ... ELSE e END (no ELSE: null)."""

    branches: List[Tuple[Expr, Expr]]
    else_: Optional[Expr] = None


@dataclass(eq=False)
class InList(Expr):
    child: Expr
    values: List[Expr]
    negated: bool = False


@dataclass(eq=False)
class Like(Expr):
    """SQL LIKE.  ``abc``, ``abc%``, ``%abc``, ``%abc%`` and ``abc%xyz``
    lower to device string ops; a pattern with ``_`` or with more than
    one inner segment is evaluated on the host (``compile.host_like``)."""

    child: Expr
    pattern: str
    negated: bool = False


@dataclass(eq=False)
class ScalarFunc(Expr):
    """A named scalar function, resolved through the registry of
    ``exprs/functions.py``."""

    name: str
    args: List[Expr]


@dataclass(eq=False)
class GetIndexedField(Expr):
    """``array[index]``, a literal 0-based index (Spark's GetArrayItem):
    null past the row's length or the type's budget."""

    child: Expr
    index: int


@dataclass(eq=False)
class GetMapValue(Expr):
    """``map[key]`` for a literal key: null where the key is absent."""

    child: Expr
    key: Any


@dataclass(eq=False)
class GetStructField(Expr):
    """``struct.field`` by name: null where the struct is null."""

    child: Expr
    name: str


@dataclass(eq=False)
class NamedStruct(Expr):
    """``named_struct(n1, e1, ...)``: never null."""

    names: List[str]
    exprs: List[Expr]


def _wrap(v) -> Expr:
    return v if isinstance(v, Expr) else Lit(v)


def col(name: str) -> Col:
    return Col(name)


def lit(value: Any, dtype: Optional[DataType] = None) -> Lit:
    return Lit(value, dtype)


def func(name: str, *args) -> ScalarFunc:
    return ScalarFunc(name, [_wrap(a) for a in args])
