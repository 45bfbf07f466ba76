"""Join core: the sorted-key table and its probe
(≙ ``blaze_tpu/ops/joins/core.py``).

Keys are Spark XXH64 hashes carried as int64 bit patterns.  The table
is sorted in UNSIGNED order (a signed sort of ``key ^ SIGN``) so that
the all-ones sentinel of null-key rows sorts last, as in the
reference's uint64 table; ``sorted_lookup`` compares as unsigned.

Every join type of the reference runs: INNER, the outer joins (LEFT,
RIGHT, FULL), LEFT_SEMI/LEFT_ANTI and EXISTENCE per probe batch, and
RIGHT_SEMI/RIGHT_ANTI and the build side of an outer join from the
build rows no probe row matched, once the probe side is exhausted
(``Joiner.finish``).

A map serializes in the reference's wire layout (``JoinMap.serialize``),
so a broadcast can carry the built map instead of its rows
(``broadcast.BroadcastJoinBuildHashMapExec``): a probe task rebuilds
it by copying buffers, with no hash and no sort.
"""

from __future__ import annotations

import enum
import struct
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ...batch import Column, RecordBatch, bucket_capacity
from ...exprs.compile import lower, null_column
from ...exprs.hash import xxhash64_columns
from ...exprs.int128 import SIGN
from ...exprs.ir import Expr
from ...exprs import strings as S
from ...kernels import cuda_ops
from ...schema import DataType, Field, Schema

SENTINEL = -1  # 0xFFFF_FFFF_FFFF_FFFF: null keys (and nothing else) carry it


class JoinType(enum.Enum):
    INNER = "inner"
    LEFT = "left"
    RIGHT = "right"
    FULL = "full"
    LEFT_SEMI = "left_semi"
    LEFT_ANTI = "left_anti"
    RIGHT_SEMI = "right_semi"
    RIGHT_ANTI = "right_anti"
    EXISTENCE = "existence"


SEMI_TYPES = (JoinType.LEFT_SEMI, JoinType.LEFT_ANTI)
BUILD_SEMI_TYPES = (JoinType.RIGHT_SEMI, JoinType.RIGHT_ANTI)


@dataclass
class JoinMap:
    """Build-side keys sorted in unsigned order, the build row of each,
    the build batch they index and its key columns."""

    sorted_keys: torch.Tensor  # int64 (n,), unsigned order
    sorted_rows: torch.Tensor  # int64 (n,)
    batch: RecordBatch
    key_cols: List[Column]

    def serialize(self) -> bytes:
        """The reference's bytes for the same build batch (one
        device-to-host copy)::

            <II num_rows, cap ; cap x uint64 sorted keys ;
            cap x int32 rows ; serialize_batch(batch)

        ``cap`` is the reference's capacity for the batch; its table
        holds ``cap`` entries, the dead rows ``num_rows..cap-1`` keyed
        by the all-ones sentinel after every live row (its sort is
        stable), which is the padding here."""
        from ...io.batch_serde import host_columns, serialize_columns

        n = self.batch.num_rows
        cap = bucket_capacity(n)
        cols, (keys, rows) = host_columns(self.batch, [self.sorted_keys, self.sorted_rows])
        pad_keys = np.full(cap, SENTINEL, dtype=np.int64)
        pad_keys[:n] = keys
        pad_rows = np.arange(cap, dtype=np.int32)
        pad_rows[:n] = rows
        return struct.pack("<II", n, cap) + pad_keys.tobytes() + pad_rows.tobytes() + serialize_columns(cols, n)

    @staticmethod
    def deserialize(data: Union[bytes, memoryview], schema: Schema, keys: Sequence[Expr]) -> Optional["JoinMap"]:
        """The map of :meth:`serialize`'s bytes (either package's) on the
        package's device: the live entries and the batch copied in, the
        key columns a projection of the batch; None for a build side
        with no rows."""
        from ... import resolve_device
        from ...io.batch_serde import decode_columns, stage_columns

        n, cap = struct.unpack_from("<II", data, 0)
        if n == 0:
            return None
        dev = resolve_device()
        keys_np = np.frombuffer(data, np.int64, n, 8)
        rows_np = np.frombuffer(data, np.int32, n, 8 + 8 * cap).astype(np.int64)
        batch = stage_columns(schema, [decode_columns(memoryview(data)[8 + 12 * cap:], schema)], dev)
        table = torch.from_numpy(np.stack([keys_np, rows_np])).to(dev)
        return JoinMap(table[0], table[1], batch, _key_cols(schema, keys, batch))


class JoinerState:
    """What one execution's probe batches leave for ``Joiner.finish``:
    how many verified pairs each build row was in."""

    def __init__(self):
        self.build_matches: Optional[torch.Tensor] = None


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
    out = [lower(e, schema, env, n) for e in keys]
    for c in out:
        if c.dtype.is_nested:
            raise NotImplementedError(f"join key of nested type {c.dtype!r}")
    return out


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


def null_columns(schema: Schema, cap: int, device: torch.device) -> List[Column]:
    """All-null columns of ``schema``, ``cap`` rows."""
    return [null_column(f.dtype, cap, device) for f in schema.fields]


def _gather_or_null(c: Column, idx: torch.Tensor, valid: torch.Tensor, cap: int) -> Column:
    """Rows ``idx`` of ``c``, null (and zeroed) where ``valid`` is
    False, padded to ``cap``."""
    return c.take(idx).mask_rows(valid).pad(cap)


class Joiner:
    """Builds and probes an equi-join.  INNER and the outer joins
    output the left side's columns, then the right side's (an outer
    join's unmatched rows with the other side null); LEFT_SEMI and
    LEFT_ANTI output the probe rows with (SEMI) or without (ANTI) a
    match, in the probe's schema; EXISTENCE every probe row with a bool
    ``existence_col``; RIGHT_SEMI and RIGHT_ANTI the build rows with or
    without a match, in the build's schema.  A null key never matches.

    LEFT and RIGHT name the preserved side as left or right of the
    output, whichever of them probes; ``build_preserved`` is True where
    the build side's unmatched rows are output, which ``finish`` does
    after the last probe batch."""

    def __init__(self, probe_schema: Schema, build_schema: Schema,
                 probe_keys: Sequence[Expr], build_keys: Sequence[Expr],
                 join_type: JoinType, probe_is_left: bool, existence_col: str = "exists#0"):
        jt = self.join_type = join_type
        self.probe_schema, self.build_schema = probe_schema, build_schema
        self.probe_keys, self.build_keys = list(probe_keys), list(build_keys)
        self.probe_is_left = probe_is_left
        self.existence_col = existence_col
        self._build_outer = jt == JoinType.FULL or jt == (JoinType.RIGHT if probe_is_left else JoinType.LEFT)
        self._probe_outer = jt == JoinType.FULL or jt == (JoinType.LEFT if probe_is_left else JoinType.RIGHT)
        self.build_preserved = self._build_outer or jt in BUILD_SEMI_TYPES
        if jt == JoinType.EXISTENCE:
            self.out_schema = Schema(list(probe_schema.fields) + [Field(existence_col, DataType.bool_())])
        elif jt in SEMI_TYPES:
            self.out_schema = probe_schema
        elif jt in BUILD_SEMI_TYPES:
            self.out_schema = build_schema
        else:
            left, right = (probe_schema, build_schema) if probe_is_left else (build_schema, probe_schema)
            self.out_schema = Schema(list(left.fields) + list(right.fields))

    @property
    def output_without_build_rows(self) -> bool:
        """Whether probe batches have output when the build side has no
        rows (an anti join, EXISTENCE, a probe-preserving outer join)."""
        return self.join_type in (JoinType.LEFT_ANTI, JoinType.EXISTENCE) or self._probe_outer

    def build_map(self, batch: RecordBatch) -> JoinMap:
        return build_join_map(batch, self.build_keys)

    def probe_batch(self, jmap: Optional[JoinMap], batch: RecordBatch,
                    state: JoinerState) -> Optional[RecordBatch]:
        """The output rows of one probe batch (None when there are none);
        ``jmap`` None is a build side with no rows.  Build-side matches
        accumulate in ``state`` for ``finish``."""
        jt, n, dev = self.join_type, batch.num_rows, batch.device
        if jmap is None:
            matches = torch.zeros(n, dtype=torch.int64, device=dev)
        else:
            probe_cols = _key_cols(self.probe_schema, self.probe_keys, batch)
            lo, counts = probe_counts(jmap.sorted_keys, key_hash(probe_cols))
            p_idx, pos = expand_pairs(lo, counts)
            b_idx = jmap.sorted_rows[pos]
            keep = torch.ones(p_idx.shape, dtype=torch.bool, device=dev)
            for pk, bk in zip(probe_cols, jmap.key_cols):
                keep &= _eq_col(pk.take(p_idx), bk.take(b_idx))
            if self.build_preserved:
                if state.build_matches is None:
                    state.build_matches = torch.zeros(jmap.batch.num_rows, dtype=torch.int64, device=dev)
                state.build_matches.scatter_add_(0, b_idx, keep.to(torch.int64))
            if jt != JoinType.INNER and jt not in BUILD_SEMI_TYPES:
                # verified matches per probe row (INNER needs none)
                matches = torch.zeros(n, dtype=torch.int64, device=dev).scatter_add_(
                    0, p_idx, keep.to(torch.int64))
        if jt in BUILD_SEMI_TYPES:
            return None
        if jt == JoinType.EXISTENCE:
            cap = batch.capacity
            exists = Column(DataType.bool_(), pad_flags(matches > 0, cap), pad_flags(matches >= 0, cap))
            return RecordBatch(self.out_schema, list(batch.columns) + [exists], n)
        if jt in SEMI_TYPES:
            want = matches > 0 if jt == JoinType.LEFT_SEMI else matches == 0
            rows = torch.nonzero(want).squeeze(1)
            m = int(rows.shape[0])
            if m == 0:
                return None
            cap = bucket_capacity(m)
            return RecordBatch(self.out_schema, [c.head(n).take(rows, cap) for c in batch.columns], m)
        if jmap is None:
            if not self._probe_outer or n == 0:
                return None
            # every probe row unmatched, the build side null
            probe_rows = torch.arange(n, device=dev)
            is_pair = torch.zeros(n, dtype=torch.bool, device=dev)
            b_rows, build = probe_rows, None
        elif not self._probe_outer:
            kept = torch.nonzero(keep).squeeze(1)
            probe_rows, b_rows, build = p_idx[kept], b_idx[kept], jmap.batch
        else:
            # one compaction for the verified pairs and, after them, the
            # probe rows with no pair
            sel = torch.nonzero(torch.cat([keep, matches == 0])).squeeze(1)
            n_pairs = p_idx.shape[0]
            is_pair = sel < n_pairs
            pair = sel.clamp(max=max(n_pairs - 1, 0))
            if n_pairs:
                probe_rows = torch.where(is_pair, p_idx[pair], sel - n_pairs)
                b_rows = torch.where(is_pair, b_idx[pair], 0)
            else:
                probe_rows, b_rows = sel - n_pairs, torch.zeros_like(sel)
            build = jmap.batch
        m = int(probe_rows.shape[0])
        if m == 0:
            return None
        cap = bucket_capacity(m)
        probe_out = [c.head(n).take(probe_rows, cap) for c in batch.columns]
        if build is None:
            build_out = null_columns(self.build_schema, cap, dev)
        elif self._probe_outer:
            build_out = [_gather_or_null(c.head(build.num_rows), b_rows, is_pair, cap) for c in build.columns]
        else:
            build_out = [c.head(build.num_rows).take(b_rows, cap) for c in build.columns]
        cols = probe_out + build_out if self.probe_is_left else build_out + probe_out
        return RecordBatch(self.out_schema, cols, m)

    def finish(self, jmap: Optional[JoinMap], state: JoinerState) -> Optional[RecordBatch]:
        """After the last probe batch: RIGHT_SEMI's matched build rows,
        or RIGHT_ANTI's and a build-preserving outer join's unmatched
        ones (the probe side null); None otherwise."""
        if not self.build_preserved or jmap is None:
            return None
        nb = jmap.batch.num_rows
        matched = (state.build_matches if state.build_matches is not None
                   else torch.zeros(nb, dtype=torch.int64, device=jmap.batch.device)) > 0
        rows = torch.nonzero(matched if self.join_type == JoinType.RIGHT_SEMI else ~matched).squeeze(1)
        m = int(rows.shape[0])
        if m == 0:
            return None
        cap = bucket_capacity(m)
        build_out = [c.head(nb).take(rows, cap) for c in jmap.batch.columns]
        if self.join_type in BUILD_SEMI_TYPES:
            return RecordBatch(self.out_schema, build_out, m)
        probe_out = null_columns(self.probe_schema, cap, jmap.batch.device)
        cols = probe_out + build_out if self.probe_is_left else build_out + probe_out
        return RecordBatch(self.out_schema, cols, m)


def pad_flags(v: torch.Tensor, cap: int) -> torch.Tensor:
    """A bool vector padded with False to ``cap`` rows."""
    out = torch.zeros(cap, dtype=torch.bool, device=v.device)
    out[: v.shape[0]] = v
    return out
