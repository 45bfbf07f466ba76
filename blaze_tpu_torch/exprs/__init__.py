"""Expression layer: Spark-semantics expression IR lowered to torch
ops over columns (≙ ``blaze_tpu/exprs``)."""

from .compile import infer_dtype, lower
from .ir import (
    Alias, BinOp, Case, Cast, Col, Expr, InList, IsNotNull, IsNull, Like, Lit, Not, ScalarFunc, col,
    func, lit,
)

__all__ = [
    "Alias", "BinOp", "Case", "Cast", "Col", "Expr", "InList", "IsNotNull", "IsNull", "Like", "Lit",
    "Not", "ScalarFunc", "col", "func", "lit", "infer_dtype", "lower",
]
