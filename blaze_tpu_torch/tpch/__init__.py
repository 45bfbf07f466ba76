"""TPC-H for the port: schemas, generator, plans and oracles of q01,
q03, q04, q05, q06, q10, q12, q14 and q19."""

from .queries import build_query
from .schema import TPCH_SCHEMAS

__all__ = ["TPCH_SCHEMAS", "build_query"]
