"""Host tables written as partitioned Parquet or ORC files: one file per
partition, with the partition boundaries of ``batch.table_to_batches``
and row groups (stripes) of ``group_rows``, so a file scan over them
yields the batches a memory scan over the same table yields."""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

from ..batch import HostTable
from ..schema import Schema
from . import orc, parquet


def write_table_files(table: HostTable, schema: Schema, directory: str, n_parts: int, group_rows: int,
                      fmt: str = "parquet", codec: Optional[object] = None, workers: int = 1) -> List[List[str]]:
    """The ``schema`` columns of ``table`` as ``n_parts`` files under
    ``directory``, ``workers`` files at a time (compression releases
    the GIL); returns the file groups of a scan (one file each).
    ``codec``: a parquet codec id (default gzip) or an ORC compression
    name (default zlib, Spark's ORC default)."""
    if fmt not in ("parquet", "orc"):
        raise ValueError(f"file format {fmt!r}: parquet or orc")
    n = next(iter(table.values()))[0].shape[0]

    def write(p: int) -> List[str]:
        lo, hi = p * n // n_parts, (p + 1) * n // n_parts
        cols = {}
        for f in schema.fields:
            entry = table[f.name]
            validity = entry[2][lo:hi] if len(entry) > 2 and entry[2] is not None else None
            cols[f.name] = (entry[0][lo:hi], validity, None if entry[1] is None else entry[1][lo:hi])
        path = os.path.join(directory, f"part-{p:05d}.{fmt}")
        if fmt == "parquet":
            parquet.write_parquet(path, schema, cols, row_group_rows=group_rows,
                                  codec=parquet.CODEC_GZIP if codec is None else codec)
        else:
            orc.write_orc(path, schema, cols, stripe_rows=group_rows, compression=codec or "zlib")
        return [path]

    if workers <= 1:
        return [write(p) for p in range(n_parts)]
    with ThreadPoolExecutor(workers) as pool:
        return list(pool.map(write, range(n_parts)))
