"""Parquet scan (≙ ``blaze_tpu/ops/parquet_scan.py``).

Per-partition file groups, a projected read schema matched to the
file's columns by name (a missing column reads as nulls), and row
groups pruned by the pushed-down predicate over chunk statistics
(``spark.blaze.parquet.enable.pageFiltering``).  A row group is decoded
on the host, column by column, and emitted in slices of ``batch_rows``;
each slice reaches the scan's device in one host-to-device copy from a
page-locked buffer (``io.batch_serde.stage_columns``).  Decoding runs on
a producer thread ahead of the consumer (``spark.blaze.pipeline.depth``).

Metrics: ``input_io_time`` (decode), ``bytes_read`` (the column chunks
read), ``pruned_row_groups``, ``pruned_rows``, ``skipped_corrupt_files``.
"""

from __future__ import annotations

import datetime
import struct
from decimal import Decimal
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from .. import conf
from ..exprs.compile import infer_lit_dtype
from ..exprs.ir import BinOp, Col, Expr, Lit
from ..io import parquet as pq
from ..io.batch_serde import host_rows, stage_columns
from ..runtime.context import TaskContext
from ..schema import DataType, Schema, TypeKind
from .base import BatchStream, ExecNode


def _lit_physical(lit: Lit, dtype: DataType):
    """A literal as the physical value chunk statistics hold: decimals
    unscaled, dates in days, strings as utf-8 bytes."""
    value = lit.value
    if dtype.is_decimal:
        if lit.unscaled:
            return int(value)
        if isinstance(value, float):
            return int(round(value * 10**dtype.scale))
        if isinstance(value, str):
            return int(Decimal(value).scaleb(dtype.scale).to_integral_value())
        return int(value) * 10**dtype.scale
    if dtype.kind == TypeKind.DATE32:
        if isinstance(value, str):
            value = datetime.date.fromisoformat(value)
        if isinstance(value, datetime.date):
            return (value - datetime.date(1970, 1, 1)).days
        return int(value)
    if dtype.is_string:
        return value.encode("utf-8") if isinstance(value, str) else bytes(value)
    return value


_FLIP = {"<": ">", "<=": ">=", ">": "<", ">=": "<=", "==": "=="}


def _prune_conjuncts(predicate: Optional[Expr]) -> List:
    """(column, op, physical literal) of each conjunct of ``predicate``
    that compares a column with a literal: what chunk or stripe
    statistics can rule out."""
    out = []

    def walk(e: Optional[Expr]):
        if not isinstance(e, BinOp):
            return
        if e.op == "and":
            walk(e.left)
            walk(e.right)
            return
        if e.op in _FLIP:
            col, lit, op = e.left, e.right, e.op
            if isinstance(lit, Col) and isinstance(col, Lit):
                col, lit, op = lit, col, _FLIP[op]
            if isinstance(col, Col) and isinstance(lit, Lit) and lit.value is not None:
                out.append((col.name, op, _lit_physical(lit, infer_lit_dtype(lit.value, lit.dtype))))

    walk(predicate)
    return out


def _compare(lo, hi, op: str, lit_v) -> bool:
    """False only where no value in ``[lo, hi]`` can satisfy ``op lit_v``."""
    try:
        if op == "<":
            return lo < lit_v
        if op == "<=":
            return lo <= lit_v
        if op == ">":
            return hi > lit_v
        if op == ">=":
            return hi >= lit_v
        if op == "==":
            return lo <= lit_v <= hi
    except TypeError:
        return True
    return True


def _maybe_match(chunk: pq.ChunkMeta, dtype: DataType, op: str, lit_v) -> bool:
    """False only when the chunk's min/max rule out every row."""
    if chunk.min_value is None or chunk.max_value is None:
        return True
    try:
        if chunk.phys == pq.T_FLBA:
            # FLBA stats (decimal): big-endian signed
            lo = int.from_bytes(chunk.min_value, "big", signed=True)
            hi = int.from_bytes(chunk.max_value, "big", signed=True)
        else:
            lo = pq._stat_value(dtype, chunk.min_value)
            hi = pq._stat_value(dtype, chunk.max_value)
    except (struct.error, ValueError):
        return True  # statistics of another shape prune nothing
    return _compare(lo, hi, op, lit_v)


def null_host_column(dtype: DataType, n: int):
    """``n`` null rows as a host column (schema adaption)."""
    if dtype.is_nested:
        from ..exprs.compile import null_nested_column
        from ..io.batch_serde import host_column

        return host_column(null_nested_column(dtype, (n,), torch.device("cpu")))
    if dtype.is_string:
        return (np.zeros((n, dtype.string_width), np.uint8), np.zeros(n, np.bool_), np.zeros(n, np.int32))
    return (np.zeros(n, dtype.np_dtype), np.zeros(n, np.bool_), None)


def staged_slices(node: ExecNode, schema: Schema, host_cols, rows: int, batch_rows: int,
                  device: torch.device) -> BatchStream:
    """Rows ``[0, rows)`` of the host columns in slices of at most
    ``batch_rows``, each one batch on ``device`` (one host-to-device
    copy, page-locked on the card)."""
    pinned = device.type == "cuda"
    for s in range(0, rows, batch_rows):
        e = min(s + batch_rows, rows)
        part = [host_rows(c, s, e) for c in host_cols]
        b = stage_columns(schema, [(e - s, part)], device, pinned)
        node._record_batch(b)
        yield b


class ParquetScanExec(ExecNode):
    """Reads ``file_groups[p]`` for partition ``p``, staged on ``device``
    (the package default, the card, when None)."""

    def __init__(
        self,
        file_groups: Sequence[Sequence[str]],
        schema: Schema,
        predicate: Optional[Expr] = None,
        batch_rows: int = 0,
        device: Union[None, str, torch.device] = None,
    ):
        from .. import resolve_device

        super().__init__([])
        for f in schema.fields:
            if f.dtype.is_nested:
                raise NotImplementedError(f"parquet scan of nested field {f.name!r} ({f.dtype.kind.name} {f.dtype!r})")
        self.file_groups = [list(g) for g in file_groups]
        self._schema = schema
        self.predicate = predicate
        self.batch_rows = batch_rows or int(conf.BATCH_SIZE.get())
        self._device = resolve_device(device)
        self._conjuncts = _prune_conjuncts(predicate) if bool(conf.PARQUET_FILTER_PUSHDOWN.get()) else []

    @property
    def schema(self) -> Schema:
        return self._schema

    @property
    def device(self) -> torch.device:
        return self._device

    def num_partitions(self) -> int:
        return max(1, len(self.file_groups))

    def _pruned(self, rg: pq.RowGroupMeta) -> bool:
        for name, op, lit_v in self._conjuncts:
            ch = rg.chunks.get(name)
            if ch is None or name not in self._schema.names:
                continue  # no statistics, or a column the read schema lost to pruning
            if not _maybe_match(ch, self._schema.field(name).dtype, op, lit_v):
                return True
        return False

    def execute(self, partition: int, ctx: TaskContext) -> BatchStream:
        from ..runtime.pipeline import maybe_pipelined

        files = self.file_groups[partition] if partition < len(self.file_groups) else []

        def stream():
            for path in files:
                try:
                    meta = pq.read_metadata(path)
                except Exception:
                    if not bool(conf.IGNORE_CORRUPT_FILES.get()):
                        raise
                    self.metrics.add("skipped_corrupt_files", 1)
                    continue
                for rg in meta.row_groups:
                    if rg.rows == 0:
                        continue
                    if self._pruned(rg):
                        self.metrics.add("pruned_row_groups", 1)
                        self.metrics.add("pruned_rows", rg.rows)
                        continue
                    with self.metrics.timer("input_io_time"):
                        cols = []
                        for f in self._schema.fields:
                            ch = rg.chunks.get(f.name)
                            if ch is None:
                                cols.append(null_host_column(f.dtype, rg.rows))
                                continue
                            self.metrics.add("bytes_read", ch.total_comp)
                            cols.append(pq.read_column_chunk(path, ch, f.dtype))
                    yield from staged_slices(self, self._schema, cols, rg.rows, self.batch_rows, self._device)

        # decode overlaps the consumer's work on the batches before
        return maybe_pipelined(stream(), ctx, "parquet_scan")
