"""TPC-H for the port: schemas, generator, q03/q06 plans and oracles."""

from .queries import build_query
from .schema import TPCH_SCHEMAS

__all__ = ["TPCH_SCHEMAS", "build_query"]
