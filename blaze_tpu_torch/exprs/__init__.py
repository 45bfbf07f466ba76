"""Expression layer: Spark-semantics expression IR lowered to torch
ops over columns (≙ ``blaze_tpu/exprs``)."""

from .compile import infer_dtype, lower
from .ir import Alias, BinOp, Col, Expr, IsNotNull, IsNull, Lit, Not, col, lit

__all__ = [
    "Alias", "BinOp", "Col", "Expr", "IsNotNull", "IsNull", "Lit", "Not",
    "col", "lit", "infer_dtype", "lower",
]
