"""Parquet sink (≙ ``blaze_tpu/ops/parquet_sink.py``): drains the child
stream into parquet files, one per partition, with hive-style
``col=value`` subdirectories when partition columns are set (dynamic
partitioning).  Each batch is read back from its device once.  The
sink yields no batch; ``written_files`` lists what it wrote.  There is
no plan-contract node for it, as in the reference.
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..io import parquet as pq
from ..io.batch_serde import host_columns
from ..runtime.context import TaskContext
from ..schema import Schema
from .base import BatchStream, ExecNode


class ParquetSinkExec(ExecNode):
    def __init__(self, child: ExecNode, output_path: str, partition_columns: Sequence[str] = ()):
        super().__init__([child])
        self.output_path = output_path
        self.partition_columns = list(partition_columns)
        self.written_files: List[str] = []

    @property
    def schema(self) -> Schema:
        return self.children[0].schema

    def _host_batches(self, partition: int, ctx: TaskContext):
        """(rows, {name: (data, validity, lengths)}) of each child batch,
        in one device-to-host copy a batch."""
        for batch in self.children[0].execute(partition, ctx):
            cols, _ = host_columns(batch)
            yield batch.num_rows, dict(zip(self.schema.names, cols))

    def _write(self, path: str, parts: List[Dict[str, tuple]], schema: Schema) -> None:
        arrays = {}
        for f in schema.fields:
            pieces = [p[f.name] for p in parts]
            if f.dtype.is_string:
                w = f.dtype.string_width
                n = sum(d.shape[0] for d, _, _ in pieces)
                data = np.zeros((n, w), np.uint8)
                off = 0
                for d, _, _ in pieces:
                    data[off:off + d.shape[0], :d.shape[1]] = d[:, :w]
                    off += d.shape[0]
                lengths = np.concatenate([ln for _, _, ln in pieces]) if pieces else np.zeros(0, np.int32)
            else:
                data = np.concatenate([d for d, _, _ in pieces]) if pieces else np.zeros(0, f.dtype.np_dtype)
                lengths = None
            validity = np.concatenate([v for _, v, _ in pieces]) if pieces else np.zeros(0, bool)
            arrays[f.name] = (data, validity, lengths)
        pq.write_parquet(path, schema, arrays)
        self.written_files.append(path)

    def execute(self, partition: int, ctx: TaskContext) -> BatchStream:
        name = f"part-{partition:05d}.parquet"

        def stream():
            if not self.partition_columns:
                parts, rows = [], 0
                for n, cols in self._host_batches(partition, ctx):
                    parts.append(cols)
                    rows += n
                if rows or partition == 0:
                    with self.metrics.timer("output_io_time"):
                        self._write(os.path.join(self.output_path, name), parts, self.schema)
                    self.metrics.add("output_rows", rows)
                return
            # dynamic partitions: rows grouped by their partition columns' values
            out_schema = Schema([f for f in self.schema.fields if f.name not in self.partition_columns])
            buckets: Dict[Tuple, List[Dict[str, tuple]]] = {}
            for n, cols in self._host_batches(partition, ctx):
                keys = []
                for pc in self.partition_columns:
                    d, v, ln = cols[pc]
                    if ln is not None:
                        keys.append([bytes(d[i, :ln[i]]).decode("utf-8", errors="replace") if v[i] else None
                                     for i in range(n)])
                    else:
                        keys.append([d[i] if v[i] else None for i in range(n)])
                row_keys = list(zip(*keys))
                for key in sorted(set(row_keys), key=lambda t: tuple(str(x) for x in t)):
                    idx = np.array([i for i, rk in enumerate(row_keys) if rk == key], np.int64)
                    buckets.setdefault(key, []).append({
                        f.name: tuple(None if a is None else a[idx] for a in cols[f.name])
                        for f in out_schema.fields})
            with self.metrics.timer("output_io_time"):
                for key, parts in buckets.items():
                    dirs = "/".join(f"{pc}={'__HIVE_DEFAULT_PARTITION__' if v is None else v}"
                                    for pc, v in zip(self.partition_columns, key))
                    self._write(os.path.join(self.output_path, dirs, name), parts, out_schema)
            return
            yield  # pragma: no cover

        return stream()
