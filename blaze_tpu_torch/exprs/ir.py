"""Expression IR (the port's own copy of the part of
``blaze_tpu/exprs/ir.py`` that its lowering covers).

A small tree with python operator sugar for building plans:
``(col("a") + lit(1)) < col("b")``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

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

    def alias(self, name: str) -> "Expr":
        return Alias(self, name)


@dataclass(eq=False)
class Col(Expr):
    name: str


@dataclass(eq=False)
class Lit(Expr):
    value: Any                       # logical python value (None = null)
    dtype: Optional[DataType] = None  # inferred from value when omitted


@dataclass(eq=False)
class Alias(Expr):
    child: Expr
    name: str


@dataclass(eq=False)
class BinOp(Expr):
    op: str  # + - * == != < <= > >= and or
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


def _wrap(v) -> Expr:
    return v if isinstance(v, Expr) else Lit(v)


def col(name: str) -> Col:
    return Col(name)


def lit(value: Any, dtype: Optional[DataType] = None) -> Lit:
    return Lit(value, dtype)
