"""TPC-H for the port: schemas, generator, plans and oracles of the 22
queries."""

from .queries import build_query
from .schema import TPCH_SCHEMAS

__all__ = ["TPCH_SCHEMAS", "build_query"]
