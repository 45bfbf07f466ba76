"""Join core: the sorted-key table and its probe
(≙ ``blaze_tpu/ops/joins/core.py``).

Keys are Spark XXH64 hashes carried as int64 bit patterns.  The table
is sorted in UNSIGNED order (a signed sort of ``key ^ SIGN``) so that
the all-ones sentinel of null-key rows sorts last, as in the
reference's uint64 table; ``sorted_lookup`` compares as unsigned.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch

from ...batch import Column, RecordBatch, bucket_capacity
from ...exprs.compile import lower
from ...exprs.hash import xxhash64_columns
from ...exprs.int128 import SIGN
from ...exprs.ir import Expr
from ...exprs import strings as S
from ...kernels import cuda_ops
from ...schema import Schema

SENTINEL = -1  # 0xFFFF_FFFF_FFFF_FFFF: null keys (and nothing else) carry it


class JoinType(enum.Enum):
    INNER = "inner"


@dataclass
class JoinMap:
    """Build-side keys sorted in unsigned order, the build row of each,
    the build batch they index and its key columns."""

    sorted_keys: torch.Tensor  # int64 (n,), unsigned order
    sorted_rows: torch.Tensor  # int64 (n,)
    batch: RecordBatch
    key_cols: List[Column]


def key_hash(cols: Sequence[Column]) -> torch.Tensor:
    """int64 key hashes; a row with ANY null key gets the sentinel
    (null never equals null in join equality)."""
    all_valid = cols[0].validity
    for c in cols[1:]:
        all_valid = all_valid & c.validity
    return torch.where(all_valid, xxhash64_columns(cols), SENTINEL)


def _key_cols(schema: Schema, keys: Sequence[Expr], batch: RecordBatch) -> List[Column]:
    n = batch.num_rows
    env = {f.name: c.head(n) for f, c in zip(schema.fields, batch.columns)}
    return [lower(e, schema, env, n) for e in keys]


def build_join_map(batch: RecordBatch, keys: Sequence[Expr]) -> JoinMap:
    key_cols = _key_cols(batch.schema, keys, batch)
    s = torch.sort(key_hash(key_cols) ^ SIGN, stable=True)
    return JoinMap(s.values ^ SIGN, s.indices, batch, key_cols)


def probe_counts(table: torch.Tensor, probe: torch.Tensor):
    """(lo, counts): the first candidate position in the sorted table
    and the number of candidates, per probe key, from the
    ``sorted_lookup`` kernel (its plain version on the CPU)."""
    lo, hi = cuda_ops.sorted_lookup(table, probe)
    lo, hi = lo.to(torch.int64), hi.to(torch.int64)
    return lo, torch.where(probe == SENTINEL, 0, hi - lo)


def expand_pairs(lo: torch.Tensor, counts: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(probe row, table position) of every candidate pair."""
    total = int(counts.sum())
    probe_row = torch.repeat_interleave(
        torch.arange(counts.shape[0], device=counts.device), counts, output_size=total)
    first = torch.cumsum(counts, 0) - counts
    pos = lo[probe_row] + torch.arange(total, device=counts.device) - first[probe_row]
    return probe_row, pos


def _eq_col(a: Column, b: Column) -> torch.Tensor:
    """Join-key equality (null != null)."""
    if a.dtype.is_string:
        v = S.str_eq(a, b)
    else:
        da, db = a.data, b.data
        if da.dtype != db.dtype:
            da, db = da.to(torch.int64), db.to(torch.int64)
        v = da == db
    return v & a.validity & b.validity


class Joiner:
    """Build/probe driver of an INNER equi-join; the output columns are
    the left side's, then the right side's."""

    def __init__(self, probe_schema: Schema, build_schema: Schema,
                 probe_keys: Sequence[Expr], build_keys: Sequence[Expr],
                 join_type: JoinType, probe_is_left: bool):
        if join_type != JoinType.INNER:
            raise NotImplementedError(f"{join_type} join")
        self.probe_schema, self.build_schema = probe_schema, build_schema
        self.probe_keys, self.build_keys = list(probe_keys), list(build_keys)
        self.probe_is_left = probe_is_left
        left, right = (probe_schema, build_schema) if probe_is_left else (build_schema, probe_schema)
        self.out_schema = Schema(list(left.fields) + list(right.fields))

    def build_map(self, batch: RecordBatch) -> JoinMap:
        return build_join_map(batch, self.build_keys)

    def probe_batch(self, jmap: JoinMap, batch: RecordBatch) -> Optional[RecordBatch]:
        n = batch.num_rows
        probe_cols = _key_cols(self.probe_schema, self.probe_keys, batch)
        lo, counts = probe_counts(jmap.sorted_keys, key_hash(probe_cols))
        p_idx, pos = expand_pairs(lo, counts)
        b_idx = jmap.sorted_rows[pos]
        keep = torch.ones(p_idx.shape, dtype=torch.bool, device=p_idx.device)
        for pk, bk in zip(probe_cols, jmap.key_cols):
            keep &= _eq_col(pk.take(p_idx), bk.take(b_idx))
        kept = torch.nonzero(keep).squeeze(1)
        m = int(kept.shape[0])
        if m == 0:
            return None
        p_idx, b_idx = p_idx[kept], b_idx[kept]
        cap = bucket_capacity(m)
        probe_out = [c.head(n).take(p_idx, cap) for c in batch.columns]
        build_out = [c.head(jmap.batch.num_rows).take(b_idx, cap) for c in jmap.batch.columns]
        cols = probe_out + build_out if self.probe_is_left else build_out + probe_out
        return RecordBatch(self.out_schema, cols, m)
