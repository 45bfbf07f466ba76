"""Shuffle partitioning (≙ ``blaze_tpu/parallel/shuffle.py``).

Partition ids are Spark's murmur3(seed 42) pmod N, so a map stage
places every row where vanilla Spark would.  Fixed-width keys go
through the ``murmur3_pids`` kernel when ``spark.blaze.tpu.pallas.enable``
is on; string keys take the plain murmur3 path, as in the reference.
The choice is by key dtype alone: a kernel that fails to build or
launch raises.  Every batch's per-partition row counts come from the
``pid_histogram`` kernel.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import torch

from .. import conf
from ..batch import Column, RecordBatch, slice_rows
from ..exprs.compile import lower
from ..exprs.hash import murmur3_columns, pmod
from ..exprs.ir import Expr
from ..kernels import cuda_ops
from ..schema import Schema


class Partitioning:
    """Base marker; subclasses carry num_partitions."""

    num_partitions: int = 1


@dataclass
class SinglePartitioning(Partitioning):
    num_partitions: int = 1


@dataclass
class HashPartitioning(Partitioning):
    """murmur3(seed 42) pmod N over ``exprs`` — Spark's HashPartitioning."""

    exprs: Sequence[Expr]
    num_partitions: int


def hash_pids(schema: Schema, exprs: Sequence[Expr], cols: Sequence[Column], n: int, n_out: int) -> torch.Tensor:
    """(n,) int32 partition ids of ``n`` rows of ``cols``."""
    env = {f.name: c for f, c in zip(schema.fields, cols)}
    key_cols = [lower(e, schema, env, n) for e in exprs]
    if bool(conf.PALLAS_ENABLE.get()) and not any(c.dtype.is_string for c in key_cols):
        planes, widths = zip(*(cuda_ops.column_word_planes(c) for c in key_cols))
        valids = [c.validity.contiguous() for c in key_cols]
        return cuda_ops.murmur3_pids(list(planes), list(widths), valids, n_out)
    return pmod(murmur3_columns(key_cols), n_out)


def sort_by_pid(batch: RecordBatch, pids: torch.Tensor, n_out: int) -> Tuple[RecordBatch, torch.Tensor]:
    """The batch's live rows stably sorted by partition id (rows of one
    partition keep their order, as with ``lax.sort``), and the (n_out,)
    int32 per-partition row counts, still on the device."""
    order = torch.sort(pids, stable=True).indices
    counts = cuda_ops.pid_histogram(pids, n_out)
    cols = [c.head(batch.num_rows) for c in batch.columns]
    return RecordBatch(batch.schema, cols, batch.num_rows).take(order, batch.capacity), counts


def split_by_counts(pending: List[Tuple[RecordBatch, torch.Tensor]], n_out: int) -> List[List[RecordBatch]]:
    """Slice each pid-sorted batch into its partitions' row ranges,
    reading every batch's counts in ONE device-to-host copy."""
    out: List[List[RecordBatch]] = [[] for _ in range(n_out)]
    if not pending:
        return out
    all_counts = torch.stack([c for _, c in pending]).cpu().tolist()
    for (batch, _), counts in zip(pending, all_counts):
        lo = 0
        for pid, k in enumerate(counts):
            if k:
                out[pid].append(slice_rows(batch, lo, k))
            lo += k
    return out
