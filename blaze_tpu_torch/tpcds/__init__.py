"""TPC-DS for the port: schemas, generator, and the plans and oracles
of q03 and q07 (≙ ``blaze_tpu/tpcds``)."""

from .datagen import generate_all, generate_table
from .queries import QUERIES, build_query
from .schema import TPCDS_SCHEMAS

__all__ = ["QUERIES", "TPCDS_SCHEMAS", "build_query", "generate_all", "generate_table"]
