"""Aggregation by exact sort + segment reduce (≙ ``blaze_tpu/ops/agg.py``).

Grouped: group keys encode into equality-preserving int64 words
(:func:`encode_key_words`), rows sort lexicographically by them (one
stable sort per word, last word first), segment boundaries fall where
any word changes, and per-group reduces are cumulative-sum
differences at the segment ends — exact for integers, with no atomics.
The global (no-grouping) path is a plain reduction.

Each input batch reduces to a state batch; at the end the states
concatenate and re-reduce (PARTIAL and FINAL states share one layout),
and FINAL mode finalizes.  Wide decimal sums (result precision > 18)
accumulate on two radix-2^32 int64 limbs, ``#sum_hi`` and
``#sum_lo<p>``, summed independently and combined into int128 at
finalize, like the reference.  Functions: sum, count, count_star, avg
(avg keeps a sum beside its ``#count`` and divides at finalize, with
Spark's HALF_UP decimal rounding).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch

from ..batch import Column, RecordBatch, bucket_capacity, concat_batches, pad_rows
from ..exprs import int128 as I
from ..exprs.compile import infer_dtype, lower
from ..exprs.ir import Expr
from ..exprs.strings import packed_be
from ..runtime.context import TaskContext
from ..schema import DataType, Field, Schema, decimal_avg_agg_type, decimal_sum_agg_type
from .base import BatchStream, ExecNode


class AggMode(enum.Enum):
    PARTIAL = 0
    FINAL = 2


@dataclass
class GroupingExpr:
    expr: Expr
    name: str


@dataclass
class AggFunction:
    """One aggregate call: ``fn`` in sum/count/count_star/avg."""

    fn: str
    expr: Optional[Expr]
    name: str


# ---------------------------------------------------------------- typing


def sum_result_type(t: DataType) -> DataType:
    if t.is_decimal:
        return decimal_sum_agg_type(t)
    if t.is_float:
        return DataType.float64()
    return DataType.int64()


def agg_result_type(fn: str, in_t: Optional[DataType]) -> DataType:
    if fn in ("count", "count_star"):
        return DataType.int64()
    if fn == "sum":
        return sum_result_type(in_t)
    if fn == "avg":
        return decimal_avg_agg_type(in_t) if in_t.is_decimal else DataType.float64()
    raise NotImplementedError(f"agg fn {fn}")


def sum_is_wide(in_t: Optional[DataType]) -> bool:
    """True when a decimal sum's result precision exceeds 18 digits:
    it then accumulates on two radix-2^32 limbs."""
    return in_t is not None and in_t.is_decimal and sum_result_type(in_t).precision > 18


def agg_state_fields(fn: str, in_t: Optional[DataType], name: str) -> List[Field]:
    """State columns: a count; or a sum (one column, or the wide
    ``#sum_hi``/``#sum_lo<p>`` limbs) beside its count of non-null
    inputs, ``#nonnull`` for sum and ``#count`` for avg."""
    if fn in ("count", "count_star"):
        return [Field(f"{name}#count", DataType.int64())]
    if fn not in ("sum", "avg"):
        raise NotImplementedError(f"agg fn {fn}")
    count = Field(f"{name}#nonnull" if fn == "sum" else f"{name}#count", DataType.int64())
    if sum_is_wide(in_t):
        # the lo limb's name carries the true input precision
        return [
            Field(f"{name}#sum_hi", sum_result_type(in_t)),
            Field(f"{name}#sum_lo{in_t.precision}", DataType.int64()),
            count,
        ]
    return [Field(f"{name}#sum", sum_result_type(in_t)), count]


def _state_input_type(a: AggFunction, in_schema: Schema) -> Optional[DataType]:
    """The input value type of ``a``, recovered from its state columns
    (sum and avg states both hold decimal(p + 10, s); wide states name
    p)."""
    if a.fn in ("count", "count_star"):
        return None
    if f"{a.name}#sum" in in_schema.names:
        st = in_schema.field(f"{a.name}#sum").dtype
        return DataType.decimal(max(1, st.precision - 10), st.scale) if st.is_decimal else st
    st = in_schema.field(f"{a.name}#sum_hi").dtype
    prefix = f"{a.name}#sum_lo"
    p = next(int(nm[len(prefix):]) for nm in in_schema.names if nm.startswith(prefix))
    return DataType.decimal(p, st.scale)


# ------------------------------------------------------- key word encode


def encode_key_words(cols: Sequence[Column]) -> List[torch.Tensor]:
    """Equality-preserving int64 words per group column: a null word,
    then the value words (strings: length + big-endian byte words;
    floats: -0.0- and NaN-canonical bits)."""
    words: List[torch.Tensor] = []
    for c in cols:
        words.append((~c.validity).to(torch.int64))
        if c.dtype.is_string:
            vals = [c.lengths.to(torch.int64)] + list(packed_be(c.data).unbind(1))
        elif c.dtype.is_float:
            d = torch.where(c.data == 0, torch.zeros_like(c.data), c.data)
            d = torch.where(torch.isnan(d), torch.full_like(d, float("nan")), d)
            bits = d.view(torch.int32) if d.dtype == torch.float32 else d.view(torch.int64)
            vals = [bits.to(torch.int64)]
        else:
            vals = [c.data.to(torch.int64)]
        words.extend(torch.where(c.validity, v, 0) for v in vals)
    return words


def lexsort(words: Sequence[torch.Tensor]) -> torch.Tensor:
    """Stable row order sorting by ``words[0]``, then ``words[1]``, ..."""
    n = words[0].shape[0]
    order = torch.arange(n, device=words[0].device)
    for w in reversed(words):
        order = order[torch.sort(w[order], stable=True).indices]
    return order


@dataclass
class Segments:
    """Groups of a key-sorted row block: ``order`` sorts the rows,
    ``starts``/``ends`` (int64, one per group) index the sorted rows."""

    order: torch.Tensor
    starts: torch.Tensor
    ends: torch.Tensor

    @property
    def n_groups(self) -> int:
        return int(self.starts.shape[0])


def group_segments(words: Sequence[torch.Tensor]) -> Segments:
    order = lexsort(words)
    n = order.shape[0]
    changed = torch.zeros(n, dtype=torch.bool, device=order.device)
    if n:
        changed[0] = True
    for w in words:
        sw = w[order]
        changed[1:] |= sw[1:] != sw[:-1]
    starts = torch.nonzero(changed).squeeze(1)
    ends = torch.cat([starts[1:], starts.new_tensor([n])]) - 1
    return Segments(order, starts, ends)


def seg_sum(values: torch.Tensor, valid: torch.Tensor, seg: Optional[Segments]) -> torch.Tensor:
    """Per-group sums of ``values`` where ``valid`` (already in sorted
    order), as differences of one cumulative sum at the segment ends —
    exact for integers, whose wraparound cancels in the difference;
    ``seg`` None is the global (one-group) reduction."""
    z = torch.where(valid, values, torch.zeros((), dtype=values.dtype, device=values.device))
    if seg is None:
        return z.sum(dtype=z.dtype).reshape(1)
    incl = torch.cumsum(z, 0, dtype=z.dtype)
    at_end = incl[seg.ends]
    return at_end - torch.cat([at_end.new_zeros(1), at_end[:-1]])


def _combine_limbs(hi: Column, lo: Column):
    """Wide-sum limbs (hi * 2^32 + lo) -> int128 (hi64, lo64)."""
    return I.add(hi.data >> 32, hi.data << 32, *I.from_i64(lo.data))


# ---------------------------------------------------------------- AggExec


class AggExec(ExecNode):
    def __init__(
        self,
        child: ExecNode,
        mode: AggMode,
        groupings: Sequence[GroupingExpr],
        aggs: Sequence[AggFunction],
        supports_partial_skipping: bool = False,
    ):
        super().__init__([child])
        self.mode = mode
        # the plan contract's hint that a PARTIAL agg may pass rows
        # through unaggregated; carried through serde, and the port
        # always aggregates (the same result)
        self.supports_partial_skipping = supports_partial_skipping
        self.groupings = list(groupings)
        self.aggs = list(aggs)
        in_schema = child.schema
        if mode == AggMode.PARTIAL:
            self._in_types = [None if a.expr is None else infer_dtype(a.expr, in_schema)
                              for a in self.aggs]
        else:
            self._in_types = [_state_input_type(a, in_schema) for a in self.aggs]
        group_fields = [Field(g.name, infer_dtype(g.expr, in_schema)) for g in self.groupings]
        state_fields = [f for a, t in zip(self.aggs, self._in_types)
                        for f in agg_state_fields(a.fn, t, a.name)]
        self._state_schema = Schema(group_fields + state_fields)
        if mode == AggMode.FINAL:
            self._schema = Schema(group_fields + [
                Field(a.name, agg_result_type(a.fn, t)) for a, t in zip(self.aggs, self._in_types)
            ])
        else:
            self._schema = self._state_schema

    @property
    def schema(self) -> Schema:
        return self._schema

    # ------------------------------------------------------- reduce

    def _reduce(self, batch: RecordBatch, merging: bool) -> RecordBatch:
        """One batch (raw rows, or states when ``merging``) -> its state
        batch, one row per group."""
        n = batch.num_rows
        cols = [c.head(n) for c in batch.columns]
        env = {f.name: c for f, c in zip(batch.schema.fields, cols)}
        schema = batch.schema
        if merging:
            key_cols = [env[g.name] for g in self.groupings]
        else:
            key_cols = [lower(g.expr, schema, env, n) for g in self.groupings]
        seg = group_segments(encode_key_words(key_cols)) if self.groupings else None
        perm = (lambda t: t) if seg is None else (lambda t: t[seg.order])
        out: List[torch.Tensor] = []
        if seg is not None:
            first = seg.order[seg.starts]
            out_keys = [c.take(first) for c in key_cols]
        for a, t in zip(self.aggs, self._in_types):
            fields = agg_state_fields(a.fn, t, a.name)
            if merging:
                # every state column sums; nulls never occur in states
                for f in fields:
                    c = env[f.name]
                    out.append(seg_sum(perm(c.data), perm(c.validity), seg))
                continue
            if a.fn == "count_star":
                out.append(seg_sum(torch.ones(n, dtype=torch.int64, device=batch.device),
                                   torch.ones(n, dtype=torch.bool, device=batch.device), seg))
                continue
            v = lower(a.expr, schema, env, n)
            data, valid = perm(v.data), perm(v.validity)
            ones = valid.to(torch.int64)
            if a.fn == "count":
                out.append(seg_sum(ones, valid, seg))
            elif sum_is_wide(t):
                d = data.to(torch.int64)
                out.append(seg_sum(d >> 32, valid, seg))
                out.append(seg_sum(d & 0xFFFFFFFF, valid, seg))
                out.append(seg_sum(ones, valid, seg))
            else:
                out.append(seg_sum(data.to(torch.int64 if not t.is_float else torch.float64), valid, seg))
                out.append(seg_sum(ones, valid, seg))
        n_out = 1 if seg is None else seg.n_groups
        cap = bucket_capacity(n_out)
        state_cols = [] if seg is None else [c.pad(cap) for c in out_keys]
        state_fields = self._state_schema.fields[len(self.groupings):]
        for f, d in zip(state_fields, out):
            state_cols.append(Column(
                f.dtype, pad_rows(d, cap),
                pad_rows(torch.ones(n_out, dtype=torch.bool, device=d.device), cap)))
        return RecordBatch(self._state_schema, state_cols, n_out)

    def _empty_state(self) -> RecordBatch:
        """The state of a global aggregate over no rows."""
        cap = bucket_capacity(1)
        dev = self.device
        cols = [Column(f.dtype,
                       pad_rows(torch.zeros(1, dtype=torch.float64 if f.dtype.is_float else torch.int64,
                                            device=dev), cap),
                       pad_rows(torch.ones(1, dtype=torch.bool, device=dev), cap))
                for f in self._state_schema.fields]
        return RecordBatch(self._state_schema, cols, 1)

    # ----------------------------------------------------- finalize

    def _finalize(self, state: RecordBatch) -> RecordBatch:
        env = {f.name: c for f, c in zip(state.schema.fields, state.columns)}
        out: List[Column] = [env[g.name] for g in self.groupings]
        for a, t in zip(self.aggs, self._in_types):
            if a.fn in ("count", "count_star"):
                out.append(env[f"{a.name}#count"])
                continue
            if a.fn == "avg":
                out.append(self._finalize_avg(env, a.name, t))
                continue
            nn = env[f"{a.name}#nonnull"]
            if sum_is_wide(t):
                hc = env[f"{a.name}#sum_hi"]
                # values past int64 overflow to null
                data, fits = I.to_i64(*_combine_limbs(hc, env[f"{a.name}#sum_lo{t.precision}"]))
                out.append(Column(hc.dtype, torch.where(fits, data, 0),
                                  hc.validity & fits & (nn.data > 0)))
            else:
                s = env[f"{a.name}#sum"]
                out.append(Column(s.dtype, s.data, s.validity & (nn.data > 0)))
        return RecordBatch(self._schema, out, state.num_rows)

    @staticmethod
    def _finalize_avg(env, name: str, t: DataType) -> Column:
        """sum / count: a decimal sum rescaled to the result scale and
        divided with HALF_UP (away from zero) on int128, a float sum
        divided in float64.  A zero count, or a decimal quotient past
        int64, gives null."""
        res_t = agg_result_type("avg", t)
        c = env[f"{name}#count"].data
        den = torch.where(c == 0, torch.ones_like(c), c)
        if sum_is_wide(t):
            hc = env[f"{name}#sum_hi"]
            vh, vl = I.mul_pow10(*_combine_limbs(hc, env[f"{name}#sum_lo{t.precision}"]),
                                 res_t.scale - hc.dtype.scale)
            q, fits = I.div_round_half_up(vh, vl, den)
            return Column(res_t, torch.where(fits, q, 0), hc.validity & (c > 0) & fits)
        s = env[f"{name}#sum"]
        valid = s.validity & (c > 0)
        if not res_t.is_decimal:
            return Column(res_t, s.data.to(torch.float64) / den.to(torch.float64), valid)
        shift = res_t.scale - s.dtype.scale
        if s.dtype.precision + shift <= 18:
            # the shifted sum provably fits int64
            num = s.data * 10**shift
            adj = torch.where(num >= 0, num + den // 2, num - den // 2)
            q = torch.where(adj >= 0, adj // den, -((-adj) // den))
            return Column(res_t, q, valid)
        q, fits = I.div_round_half_up(*I.mul_pow10(*I.from_i64(s.data), shift), den)
        return Column(res_t, torch.where(fits, q, 0), valid & fits)

    # ------------------------------------------------------ execute

    def execute(self, partition: int, ctx: TaskContext) -> BatchStream:
        child_stream = self.children[0].execute(partition, ctx)
        merging = self.mode == AggMode.FINAL

        def stream():
            states: List[RecordBatch] = []
            for batch in child_stream:
                if not ctx.is_task_running():
                    return
                if batch.num_rows:
                    with self.metrics.timer("elapsed_compute"):
                        states.append(self._reduce(batch, merging))
            with self.metrics.timer("elapsed_compute"):
                if len(states) > 1:
                    state = self._reduce(concat_batches(states), merging=True)
                elif states:
                    state = states[0]
                elif not self.groupings:
                    state = self._empty_state()
                else:
                    return
                out = self._finalize(state) if self.mode == AggMode.FINAL else state
            self._record_batch(out)
            yield out

        return stream()
