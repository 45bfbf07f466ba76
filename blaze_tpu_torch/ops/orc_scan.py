"""ORC scan (≙ ``blaze_tpu/ops/orc_scan.py``).

Per-partition file groups, a projected read schema matched to the
file's fields by name (a missing field reads as nulls), and stripes
pruned by the pushed-down predicate over the file's stripe statistics.
Only the read schema's columns of a stripe are decoded; a stripe is
emitted in slices of ``batch_rows``, each reaching the scan's device in
one host-to-device copy, behind the same producer thread as the parquet
scan.  Nested fields (≙ the reference's): a LIST of a fixed-width type
from the reader's vectorized path, at the read schema's ``max_elems``
(a longer list raises); a MAP, STRUCT or other LIST from python values
through ``batch.column_from_pylist``; a missing nested field reads as
nulls.

Metrics: ``input_io_time`` (decode), ``bytes_read`` (the stripes read),
``pruned_stripes``, ``pruned_rows``, ``skipped_corrupt_files``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch

from .. import conf
from ..exprs.ir import Expr
from ..io import orc
from ..runtime.context import TaskContext
from ..schema import DataType, Field, Schema, TypeKind
from .base import BatchStream, ExecNode
from .parquet_scan import _compare, _prune_conjuncts, null_host_column, staged_slices


def _stat_comparable(dtype: DataType, v):
    if v is None:
        return None
    if dtype.is_string and isinstance(v, (bytes, bytearray)):
        # string statistics compare with the predicate's utf-8 bytes
        return bytes(v)
    return v


def _stripe_maybe_match(stats, dtype: DataType, op: str, lit_v) -> bool:
    """False only when the stripe's min/max rule out every row."""
    mn, mx, _ = stats
    lo, hi = _stat_comparable(dtype, mn), _stat_comparable(dtype, mx)
    if lo is None or hi is None:
        return True
    return _compare(lo, hi, op, lit_v)


def _nested_host(f: Field, raw):
    """A nested field's host column from the reader's output, at the
    read schema's type."""
    from ..batch import column_from_pylist
    from ..io.batch_serde import HostNested, host_column

    if raw[0] == "py":
        return host_column(column_from_pylist(f.dtype, raw[1], capacity=max(len(raw[1]), 1),
                                              device="cpu").head(len(raw[1])))
    _, validity, lengths, (edata, evalid) = raw
    m = f.dtype.max_elems
    if int(np.max(lengths, initial=0)) > m:
        raise NotImplementedError(
            f"ORC subset: list length {int(np.max(lengths))} exceeds max_elems {m} for {f.name!r}")
    k = min(m, edata.shape[1])
    ed = np.zeros((edata.shape[0], m), f.dtype.elem.np_dtype)
    ev = np.zeros((edata.shape[0], m), np.bool_)
    ed[:, :k] = edata[:, :k]
    ev[:, :k] = evalid[:, :k]
    return HostNested(validity, lengths, [(ed, ev, None)])


class OrcScanExec(ExecNode):
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
        self.file_groups = [list(g) for g in file_groups]
        self._schema = schema
        self.predicate = predicate
        self.batch_rows = batch_rows or int(conf.BATCH_SIZE.get())
        self._device = resolve_device(device)
        self._conjuncts = _prune_conjuncts(predicate)

    @property
    def schema(self) -> Schema:
        return self._schema

    @property
    def device(self) -> torch.device:
        return self._device

    def num_partitions(self) -> int:
        return max(1, len(self.file_groups))

    def _pruned(self, stripe: orc.StripeInfo) -> bool:
        for name, op, lit_v in self._conjuncts:
            st = stripe.stats.get(name)
            if st is None or name not in self._schema.names:
                continue  # no statistics, or a column the read schema lost to pruning
            if not _stripe_maybe_match(st, self._schema.field(name).dtype, op, lit_v):
                return True
        return False

    def execute(self, partition: int, ctx: TaskContext) -> BatchStream:
        from ..runtime.pipeline import maybe_pipelined

        files = self.file_groups[partition] if partition < len(self.file_groups) else []
        width = max([f.dtype.string_width for f in self._schema.fields if f.dtype.is_string], default=64)
        max_elems = max([f.dtype.max_elems for f in self._schema.fields if f.dtype.kind == TypeKind.ARRAY],
                        default=16)

        def stream():
            for path in files:
                try:
                    meta = orc.read_metadata(path, list_elems=max_elems, string_width=width)
                except Exception:
                    if not bool(conf.IGNORE_CORRUPT_FILES.get()):
                        raise
                    self.metrics.add("skipped_corrupt_files", 1)
                    continue
                in_file = [n for n in self._schema.names if n in meta.schema.names]
                for stripe in meta.stripes:
                    if stripe.rows == 0:
                        continue
                    if self._pruned(stripe):
                        self.metrics.add("pruned_stripes", 1)
                        self.metrics.add("pruned_rows", stripe.rows)
                        continue
                    with self.metrics.timer("input_io_time"):
                        raw = orc.read_stripe(path, meta, stripe, in_file)
                    self.metrics.add("bytes_read", stripe.data_length + stripe.footer_length)
                    cols = []
                    for f in self._schema.fields:
                        if f.name not in raw:
                            cols.append(null_host_column(f.dtype, stripe.rows))
                            continue
                        if f.dtype.is_nested:
                            cols.append(_nested_host(f, raw[f.name]))
                            continue
                        data, validity, lengths = raw[f.name]
                        if f.dtype.is_string:
                            w = f.dtype.string_width
                            data, lengths = data[:, :w], np.minimum(lengths, w)
                        else:
                            data = data.astype(f.dtype.np_dtype, copy=False)
                        cols.append((data, validity, lengths))
                    yield from staged_slices(self, self._schema, cols, stripe.rows, self.batch_rows, self._device)

        # decode overlaps the consumer's work on the batches before
        return maybe_pipelined(stream(), ctx, "orc_scan")
