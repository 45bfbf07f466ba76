"""Aggregation by exact sort + segment reduce (≙ ``blaze_tpu/ops/agg.py``).

Grouped: group keys encode into equality-preserving int64 words
(:func:`encode_key_words`), rows sort lexicographically by them (one
stable sort per word, last word first), segment boundaries fall where
any word changes, and per-group reduces are cumulative-sum
differences at the segment ends — exact for integers, with no atomics.
The global (no-grouping) path is a plain reduction.

Each input batch reduces to a state batch; at the end the states
concatenate and re-reduce (PARTIAL and FINAL states share one layout),
and FINAL mode finalizes.  A PARTIAL agg with groupings may stop
aggregating partway and stream each batch's state instead
(:class:`_PartialSkip`, ``spark.blaze.partialAggSkipping.*``).  Wide
decimal sums (result precision > 18) accumulate on two radix-2^32 int64
limbs, ``#sum_hi`` and ``#sum_lo<p>``, summed independently and
combined into int128 at finalize, like the reference.  Functions: sum,
count, count_star, avg
(avg keeps a sum beside its ``#count`` and divides at finalize, with
Spark's HALF_UP decimal rounding), min and max (one ``#value`` state
column of the input's type, null where a group has no non-null input;
integers, dates, decimals, floats and strings; as in the reference, a
float NaN is larger than every number and any NaN in a group makes
its min NaN too), and stddev_samp and var_samp (a ``#cnt``, a float64
``#fsum`` and the float64 ``#m2`` of deviations from the group's mean:
each batch centres its values on its own group means, and states merge
by Chan's ``M2 = sum M2_i + sum n_i (mean_i - mean)^2``, so no sum of
squares cancels; a decimal is divided by ``10**scale`` first, and the
value is null unless a group counts two values).  Float sums accumulate
within each group (a segmented scan), so one group's magnitude never
cancels against another's; integer sums difference one cumulative sum.
``first`` and ``first_ignores_null`` keep a ``#value`` state: the
group's first row in input order (every sort here is stable), its first
non-null one for ``first_ignores_null``; a merge of states skips null
states for both, as the reference's does.
"""

from __future__ import annotations

import enum
import threading
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch

from .. import conf
from ..batch import Column, RecordBatch, bucket_capacity, concat_batches, pad_rows
from ..exprs import int128 as I
from ..exprs.compile import infer_dtype, lower, null_column, null_nested_column
from ..exprs.ir import Expr
from ..exprs.strings import packed_be
from ..runtime.context import TaskContext
from ..schema import DataType, Field, Schema, TypeKind, decimal_avg_agg_type, decimal_sum_agg_type
from .base import BatchStream, ExecNode
from .filter import predicate_mask


class AggMode(enum.Enum):
    PARTIAL = 0
    PARTIAL_MERGE = 1
    FINAL = 2


@dataclass
class GroupingExpr:
    expr: Expr
    name: str


@dataclass
class AggFunction:
    """One aggregate call: ``fn`` in sum/count/count_star/avg/min/max/
    first/first_ignores_null/stddev_samp/var_samp/collect_list/
    collect_set (or a Brickhouse alias of a collect)."""

    fn: str
    expr: Optional[Expr]
    name: str


# ---------------------------------------------------------------- typing

MINMAX = ("min", "max")
FIRST = ("first", "first_ignores_null")
VARIANCE = ("stddev_samp", "var_samp")
COLLECT = ("collect_list", "collect_set")
#: the reference's aliases of its Brickhouse UDAFs
ALIASES = {"brickhouse_collect": "collect_list", "brickhouse_combine_unique": "collect_set"}


def sum_result_type(t: DataType) -> DataType:
    if t.is_decimal:
        return decimal_sum_agg_type(t)
    if t.is_float:
        return DataType.float64()
    return DataType.int64()


def agg_result_type(fn: str, in_t: Optional[DataType]) -> DataType:
    if fn in COLLECT:
        if fn == "collect_set" and in_t.is_nested and not collect_set_elem_supported(in_t):
            raise NotImplementedError(
                f"collect_set over {in_t!r} (Spark refuses MAP elements: \"collect_set() cannot have map "
                "type data\"; or more than 128 sort words)")
        return DataType.array(in_t, int(conf.COLLECT_MAX_ELEMS.get()))
    if fn in ("count", "count_star"):
        return DataType.int64()
    if fn == "sum":
        return sum_result_type(in_t)
    if fn == "avg":
        return decimal_avg_agg_type(in_t) if in_t.is_decimal else DataType.float64()
    if fn in MINMAX or fn in FIRST:
        return in_t
    if fn in VARIANCE:
        return DataType.float64()
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
    if fn in COLLECT:
        return [Field(f"{name}#list", agg_result_type(fn, in_t))]
    if fn in MINMAX or fn in FIRST:
        return [Field(f"{name}#value", in_t)]
    if fn in VARIANCE:
        return [Field(f"{name}#cnt", DataType.int64()), Field(f"{name}#fsum", DataType.float64()),
                Field(f"{name}#m2", DataType.float64())]
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
    p; a variance state is float64)."""
    if a.fn in ("count", "count_star"):
        return None
    if a.fn in COLLECT:
        return in_schema.field(f"{a.name}#list").dtype.elem
    if a.fn in MINMAX or a.fn in FIRST:
        return in_schema.field(f"{a.name}#value").dtype
    if a.fn in VARIANCE:
        return DataType.float64()
    if a.fn not in ("sum", "avg"):
        raise NotImplementedError(f"agg fn {a.fn}")
    if f"{a.name}#sum" in in_schema.names:
        st = in_schema.field(f"{a.name}#sum").dtype
        return DataType.decimal(max(1, st.precision - 10), st.scale) if st.is_decimal else st
    st = in_schema.field(f"{a.name}#sum_hi").dtype
    prefix = f"{a.name}#sum_lo"
    p = next(int(nm[len(prefix):]) for nm in in_schema.names if nm.startswith(prefix))
    return DataType.decimal(p, st.scale)


# ------------------------------------------------------- key word encode


def canonical_float(d: torch.Tensor) -> torch.Tensor:
    """-0.0 as 0.0 and every NaN as one NaN (Spark's
    NormalizeFloatingNumbers on grouping keys)."""
    d = torch.where(d == 0, torch.zeros_like(d), d)
    return torch.where(torch.isnan(d), torch.full_like(d, float("nan")), d)


def encode_key_words(cols: Sequence[Column]) -> List[torch.Tensor]:
    """Equality-preserving int64 words per group column: a null word,
    then the value words (strings: length + big-endian byte words;
    floats: -0.0- and NaN-canonical bits)."""
    words: List[torch.Tensor] = []
    for c in cols:
        if c.dtype.is_nested:
            raise NotImplementedError(f"group key of nested type {c.dtype!r}")
        words.append((~c.validity).to(torch.int64))
        if c.dtype.is_string:
            vals = [c.lengths.to(torch.int64)] + list(packed_be(c.data).unbind(1))
        elif c.dtype.is_float:
            d = canonical_float(c.data)
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


def group_segments(words: Sequence[torch.Tensor], keep: Optional[torch.Tensor] = None) -> Segments:
    """The groups of rows by ``words``; with ``keep``, only of the rows
    it marks: the others sort after every kept row and start no group."""
    if keep is not None:
        words = [(~keep).to(torch.int64)] + [torch.where(keep, w, 0) for w in words]
    order = lexsort(words)
    n = order.shape[0]
    changed = torch.zeros(n, dtype=torch.bool, device=order.device)
    if n:
        changed[0] = True
    for w in words:
        sw = w[order]
        changed[1:] |= sw[1:] != sw[:-1]
    total = order.new_tensor([n])
    if keep is not None:
        changed &= keep[order]
        total = keep.sum().reshape(1)
    starts = torch.nonzero(changed).squeeze(1)
    ends = torch.cat([starts[1:], total])[:starts.shape[0]] - 1
    return Segments(order, starts, ends)


def seg_scan(x: torch.Tensor, starts: torch.Tensor, op) -> torch.Tensor:
    """Inclusive scan of ``x`` under ``op`` that restarts where
    ``starts`` holds (Hillis-Steele, log2(len) steps)."""
    f = starts.clone()
    d = 1
    n = x.shape[0]
    while d < n:
        tail = torch.where(f[d:], x[d:], op(x[:-d], x[d:]))
        x = torch.cat([x[:d], tail])
        f = torch.cat([f[:d], f[d:] | f[:-d]])
        d *= 2
    return x


def seg_sum(values: torch.Tensor, valid: torch.Tensor, seg: Optional[Segments]) -> torch.Tensor:
    """Per-group sums of ``values`` where ``valid`` (already in sorted
    order); ``seg`` None is the global (one-group) reduction.  Integers
    difference one cumulative sum at the segment ends (exact: wraparound
    cancels in the difference); floats scan within each segment, so a
    small group after a large one keeps its own precision (≙ the
    reference's ``_seg_sum``)."""
    z = torch.where(valid, values, torch.zeros((), dtype=values.dtype, device=values.device))
    if seg is None:
        return z.sum(dtype=z.dtype).reshape(1)
    if z.is_floating_point():
        starts = torch.zeros(z.shape[0], dtype=torch.bool, device=z.device)
        starts[seg.starts] = True
        return seg_scan(z, starts, torch.add)[seg.ends]
    incl = torch.cumsum(z, 0, dtype=z.dtype)
    at_end = incl[seg.ends]
    return at_end - torch.cat([at_end.new_zeros(1), at_end[:-1]])


def seg_minmax(v: Column, seg: Optional[Segments], is_min: bool) -> Column:
    """Per-group min or max of ``v`` (rows already in group order),
    nulls skipped: one stable sort of the rows by (group, null last,
    value), whose first row in each group is its extreme; a group of
    nulls only gives null.  Floats order -0.0 below 0.0 and NaN above
    everything, and a NaN in a group makes its min NaN (the reference's
    NaN-propagating minimum)."""
    from .sort import order_words

    n = v.capacity
    if v.dtype.is_float:
        # one NaN (a negative NaN would order below every number)
        v = Column(v.dtype, torch.where(torch.isnan(v.data), float("nan"), v.data), v.validity)
    if seg is None:
        gid = torch.zeros(n, dtype=torch.int64, device=v.device)
        starts = gid[:1]
    else:
        mark = torch.zeros(n, dtype=torch.int64, device=v.device)
        mark[seg.starts] = 1
        gid, starts = torch.cumsum(mark, 0) - 1, seg.starts
    order = lexsort([gid] + order_words(v, ascending=is_min, nulls_first=False))
    out = v.take(order[starts])
    if is_min and v.dtype.is_float:
        nan = seg_sum(torch.isnan(v.data).to(torch.int64), v.validity, seg) > 0
        out = Column(out.dtype, torch.where(nan, torch.full_like(out.data, float("nan")), out.data),
                     out.validity)
    return out


def seg_first(v: Column, pick: torch.Tensor, seg: Optional[Segments]) -> Column:
    """Per group, the first row (rows already in group order, each
    group's in input order) where ``pick`` holds; null where no row
    does (≙ the reference's ``_seg_first``/``_seg_gather_first``)."""
    n = v.capacity
    idx = torch.where(pick, torch.arange(n, device=v.device), n)
    if seg is None:
        first = idx.min().reshape(1) if n else idx.new_full((1,), n)
    else:
        mark = torch.zeros(n, dtype=torch.int64, device=v.device)
        mark[seg.starts] = 1
        first = torch.full((seg.n_groups,), n, dtype=torch.int64, device=v.device)
        first = first.scatter_reduce(0, torch.cumsum(mark, 0) - 1, idx, "amin")
    has = first < n
    out = v.take(first.clamp(max=max(n - 1, 0)))
    valid = out.validity & has
    if v.dtype.is_string:
        return Column(v.dtype, out.data, valid, torch.where(has, out.lengths, 0))
    return Column(v.dtype, torch.where(valid, out.data, torch.zeros((), dtype=out.data.dtype,
                                                                      device=v.device)), valid)


# ------------------------------------------------ collect_list/set


def _scatter_elems(c: Column, tgt: torch.Tensor, lead: int, g: int, m: int) -> Column:
    """Every buffer of ``c`` (whose first ``lead`` axes index the source
    entries) scattered to flat slot ``tgt`` of a ``(g, m)`` element
    layout.  Dropped entries aim at slot ``g*m``, a dead row cut off
    after the scatter; live targets never collide."""
    flat_tgt = tgt.reshape(-1)

    def sc(t):
        src = t.reshape((-1,) + tuple(t.shape[lead:]))
        out = torch.zeros((g * m + 1,) + tuple(src.shape[1:]), dtype=t.dtype, device=t.device)
        return out.index_copy_(0, flat_tgt, src)[:g * m].reshape((g, m) + tuple(src.shape[1:]))

    return c.map_buffers(sc)


def collect_reduce(v: Column, arr_t: DataType, gid: torch.Tensor, starts: torch.Tensor, g: int,
                   merging: bool) -> Column:
    """Per group (``gid``: each row's group, rows in group order; a
    group's rows in input order), its values as one array of
    ``arr_t``'s padded layout (≙ the reference's ``_collect_reduce``):
    null values skipped, values past ``max_elems`` dropped.  Merging,
    ``v`` holds array states, whose elements append in row order."""
    m = arr_t.max_elems
    dev = v.device
    if g == 0:
        return null_nested_column(arr_t, (0,), dev)
    slots = torch.arange(m, device=dev)
    if not merging:
        cnt = v.validity.to(torch.int64)
        excl = torch.cumsum(cnt, 0) - cnt
        pos = excl - excl[starts][gid]              # rank among the group's valid rows
        tgt = torch.where(v.validity & (pos < m), gid * m + pos, g * m)
        elem, lead = v, 1
    else:
        cnt = torch.where(v.validity, v.lengths, 0).to(torch.int64)
        excl = torch.cumsum(cnt, 0) - cnt
        pos = (excl - excl[starts][gid])[:, None] + torch.arange(v.dtype.max_elems, device=dev)[None, :]
        live = torch.arange(v.dtype.max_elems, device=dev)[None, :] < cnt[:, None]
        tgt = torch.where(live & (pos < m), gid[:, None] * m + pos, g * m)
        elem, lead = v.children[0], 2
    counts = torch.zeros(g, dtype=torch.int64, device=dev).index_add_(0, gid, cnt).clamp(max=m)
    out = _scatter_elems(elem, tgt, lead, g, m)
    ev = slots[None, :] < counts[:, None]
    out = Column(out.dtype, out.data, ev, out.lengths, out.children)
    return Column(arr_t, None, torch.ones(g, dtype=torch.bool, device=dev), counts.to(torch.int32), (out,))


def canon_float_bits(data: torch.Tensor) -> torch.Tensor:
    """Equality-canonical float bits as int64: -0.0 as 0.0, one NaN
    (float32 bits sign-extended, as in the reference)."""
    d = canonical_float(data)
    return (d.view(torch.int32) if d.dtype == torch.float32 else d.view(torch.int64)).to(torch.int64)


def value_words(dtype: DataType, col: Column, live: torch.Tensor) -> List[torch.Tensor]:
    """Equality-preserving int64 words (unsigned bit patterns) of values
    of any supported nesting, each shaped like ``live`` (≙ the
    reference's ``_value_words``): an ARRAY level gives its length, its
    element-validity flags (64 a word) and each child word once per
    element slot; a STRUCT a null flag and the words of each field."""
    zero = lambda w: torch.where(live, w, 0)
    if dtype.kind == TypeKind.ARRAY:
        m = dtype.max_elems
        child = col.children[0]
        words = [zero(col.lengths.to(torch.int64))]
        inner = (torch.arange(m, device=live.device) < col.lengths[..., None]) & live[..., None]
        lv = inner & child.validity
        for base in range(0, m, 64):
            flags = torch.zeros(live.shape, dtype=torch.int64, device=live.device)
            for j in range(base, min(base + 64, m)):
                flags = flags | (lv[..., j].to(torch.int64) << (j - base))
            words.append(flags)
        for w in value_words(dtype.elem, child, lv):
            words.extend(w[..., j] for j in range(m))
        return words
    if dtype.kind == TypeKind.STRUCT:
        words = []
        for f, ch in zip(dtype.struct_fields, col.children):
            lv = live & ch.validity
            words.append(lv.to(torch.int64))
            words.extend(value_words(f.dtype, ch, lv))
        return words
    if dtype.is_string:
        d = col.data
        packed = packed_be(d.reshape(-1, d.shape[-1])).reshape(live.shape + (-1,)) ^ I.SIGN
        return [zero(col.lengths.to(torch.int64))] + [zero(packed[..., k]) for k in range(packed.shape[-1])]
    bits = canon_float_bits(col.data) if dtype.is_float else col.data.to(torch.int64)
    return [zero(bits)]


def word_count(dtype: DataType) -> int:
    """The words :func:`value_words` gives a value of ``dtype``."""
    if dtype.kind == TypeKind.ARRAY:
        return 1 + (dtype.max_elems + 63) // 64 + dtype.max_elems * word_count(dtype.elem)
    if dtype.kind == TypeKind.STRUCT:
        return sum(1 + word_count(f.dtype) for f in dtype.struct_fields)
    if dtype.is_string:
        return 1 + (dtype.string_width + 7) // 8
    return 1


def collect_set_elem_supported(dtype: DataType) -> bool:
    """Element types the set dedup encodes: flat types and ARRAY/STRUCT
    nestings of them, in at most 128 words.  MAP elements are refused,
    as Spark's CollectSet refuses them."""
    def ok(t: DataType) -> bool:
        if t.kind == TypeKind.ARRAY:
            return ok(t.elem)
        if t.kind == TypeKind.STRUCT:
            return all(ok(f.dtype) for f in t.struct_fields)
        return t.kind not in (TypeKind.MAP, TypeKind.OPAQUE)

    return ok(dtype) and word_count(dtype) <= 128


def dedup_array_state(col: Column) -> Column:
    """Each row's distinct elements (collect_set, array_union): the
    elements sorted within the row by their words in unsigned order,
    live slots first and null elements after the values, then the first
    of each run of equal elements, compacted to the front (≙ the
    reference's ``_dedup_array_state``; a null element stays one null
    element)."""
    elem = col.children[0]
    m = col.dtype.max_elems
    dev = col.device
    within = torch.arange(m, device=dev)[None, :] < col.lengths[:, None]
    live = within & elem.validity
    words = [(~within).to(torch.int64), (within & ~elem.validity).to(torch.int64)]
    words += [w ^ I.SIGN for w in value_words(elem.dtype, elem, live)]
    order = torch.arange(m, device=dev).expand(col.capacity, m)
    for w in reversed(words):
        order = torch.gather(order, 1, torch.sort(torch.gather(w, 1, order), dim=1, stable=True).indices)
    changed = torch.zeros_like(within)
    changed[:, 0] = True
    for w in words:
        sw = torch.gather(w, 1, order)
        changed[:, 1:] |= sw[:, 1:] != sw[:, :-1]
    keep = torch.gather(within, 1, order) & changed
    counts = keep.sum(1)
    src = torch.gather(order, 1, torch.sort((~keep).to(torch.int8), dim=1, stable=True).indices)

    def g(t):
        ix = src.view(src.shape + (1,) * (t.dim() - 2)).expand(tuple(src.shape) + tuple(t.shape[2:]))
        return torch.gather(t, 1, ix)

    out = elem.map_buffers(g).mask_rows(torch.arange(m, device=dev)[None, :] < counts[:, None])
    return Column(col.dtype, None, col.validity, counts.to(torch.int32), (out,))


def _combine_limbs(hi: Column, lo: Column):
    """Wide-sum limbs (hi * 2^32 + lo) -> int128 (hi64, lo64)."""
    return I.add(hi.data >> 32, hi.data << 32, *I.from_i64(lo.data))


def _empty_list(dtype: DataType, cap: int, device) -> Column:
    """One empty (valid) array, padded to ``cap`` rows."""
    c = null_nested_column(dtype, (cap,), device)
    validity = c.validity.clone()
    validity[0] = True
    return Column(dtype, None, validity, c.lengths, c.children)


# ------------------------------------------------------ partial skipping

#: since the last :func:`reset_partial_totals`: PARTIAL aggs that
#: stopped aggregating, the rows and batches PARTIAL aggs emitted, and
#: the merges the skip's bookkeeping asked for (each one reduce)
PARTIAL_TOTALS = {"partial_skipped": 0, "partial_rows": 0, "partial_batches": 0, "skip_merges": 0}
_totals_lock = threading.Lock()


def reset_partial_totals() -> None:
    with _totals_lock:
        for k in PARTIAL_TOTALS:
            PARTIAL_TOTALS[k] = 0


def _count_partial(key: str, v: int = 1) -> None:
    with _totals_lock:
        PARTIAL_TOTALS[key] += v


class _PartialSkip:
    """Partial aggregate skipping (``spark.blaze.partialAggSkipping.*``)
    for one PARTIAL agg's stream: the held states and the decision to
    stop aggregating, taken on the batch the reference takes it.

    The reference folds each batch into one accumulator and stops once
    ``acc_rows / in_rows > ratio`` with ``in_rows >= minRows``, where
    ``in_rows`` counts the input rows before any ``pre_filter`` and
    ``acc_rows`` is the accumulator's row count as its host knows it
    then.  Under its defaults (``_FusedGroupedUpdate``) that count is
    ``min(last proven count + the batch's rows, the accumulator's
    capacity)``, the proven count one fold behind; a fold whose true
    count passes the capacity is rebuilt (re-bucketed) one batch later;
    and once the accumulator's capacity passes a batch's, that batch
    takes the eager path, whose count adds the pending states' rows and
    the batch's own, merging them in when they reach ``max(acc_rows,
    4096)``.  The port keeps each batch's reduced state apart (the
    accumulator's items, in fold order, and the eager path's pending
    ones) and replays that bookkeeping on host integers; an exact
    count of the accumulator's first items comes from merging them
    (``merge``: one reduce, with its one read of the card), asked only
    where the bounds the held row counts give cannot settle a
    comparison.  The replay takes the batches' capacities as they come:
    it decides as the reference does where its input batches have the
    reference's capacities.

    After the decision every batch's own state streams out (:meth:`add`
    returns it); the accumulator so far, with the batch that decided it
    when that batch was folded, comes last (:meth:`rest`).  The
    reference's memory consumer and spill of the accumulator wait for
    the port's memory manager."""

    def __init__(self, merge, metrics):
        self._merge = merge
        self._metrics = metrics
        self._ratio = float(conf.PARTIAL_AGG_SKIPPING_RATIO.get())
        self._min_rows = int(conf.PARTIAL_AGG_SKIPPING_MIN_ROWS.get())
        # batches before the first that can decide: (state, rows,
        # capacity), replayed when it comes, so a stream that never
        # reaches minRows merges nothing early
        self._queue: list = []
        self._queued_rows = 0
        self._items: List[Optional[RecordBatch]] = []  # the accumulator's, in fold order
        self._rows: List[int] = []                     # their row counts
        self._merged: Optional[RecordBatch] = None     # items[:self._merged_n], merged
        self._merged_n = 0
        self._known = {0: 0}  # exact group counts of the first n items
        self._eager: List[Optional[RecordBatch]] = []
        self._eager_rows = 0
        # the accumulator as the reference's host sees it: (lazy, its
        # row count (lazy: the hint), its capacity, items folded)
        self._state: Optional[Tuple[bool, int, int, int]] = None
        self._good = 0          # items whose count was proven last
        self._pending = None    # the fold whose check is deferred: (items, capacity)
        self.in_rows = 0
        self.skipping = False

    # ---- exact counts and bounds
    def _exact(self, n: int) -> int:
        """Groups of the accumulator's first ``n`` items."""
        if n not in self._known:
            assert n >= self._merged_n, "counts are asked in fold order"
            held = [b for b in [self._merged] + self._items[self._merged_n:n] if b is not None and b.num_rows]
            if len(held) > 1:
                self._metrics.add("partial_skip_merges")
                _count_partial("skip_merges")
            self._merged = self._merge(held) if len(held) > 1 else held[0] if held else None
            self._merged_n = n
            self._known[n] = 0 if self._merged is None else self._merged.num_rows
        return self._known[n]

    def _bounds(self, n: int) -> Tuple[int, int]:
        base = max(m for m in self._known if m <= n)
        rows = self._rows[base:n]
        return max([self._known[base]] + rows), self._known[base] + sum(rows)

    def _at_most(self, n: int, cap: int) -> bool:
        """Whether the first ``n`` items hold at most ``cap`` groups;
        exact counts, when the bounds cannot tell, of the last proven
        items first (a rebuild needs them) and then of ``n``."""
        lo, hi = self._bounds(n)
        if hi <= cap or lo > cap:
            return hi <= cap
        self._exact(self._good)
        return self._exact(n) <= cap

    def _hint(self, n: int, rows: int, cap: int) -> int:
        """``min(count of n items + rows, cap)``."""
        return cap if self._bounds(n)[0] + rows >= cap else min(self._exact(n) + rows, cap)

    # ---- the reference's accumulator
    def _resolve(self, pending, following: bool) -> None:
        """The deferred check of the fold of ``pending``; past its
        capacity, the accumulator is rebuilt from the last proven one
        and that fold (and the ``following`` fold after it)."""
        n, cap = pending
        if self._at_most(n, cap):
            self._good = n
            return
        base = self._good
        if following and self._pending is not None and self._pending[0] != n:
            base, n = n, self._pending[0]
        cap = bucket_capacity(self._exact(base) + self._rows[n - 1])
        self._state = (False, self._exact(n), cap, n)
        self._pending = None
        self._good = n

    def _resolve_state(self) -> None:
        """The accumulator as a plain batch (its deferred check first)."""
        if self._pending is not None:
            pending, self._pending = self._pending, None
            self._resolve(pending, following=False)
        lazy, _, cap, n = self._state
        if lazy:
            self._state = (False, self._exact(n), cap, n)

    def _check(self, acc_rows: int) -> None:
        if self.in_rows >= self._min_rows and acc_rows / max(1, self.in_rows) > self._ratio:
            self.skipping = True
            self._metrics.add("partial_skipped", 1)
            _count_partial("partial_skipped")

    def add(self, part: Optional[RecordBatch], rows: int, cap: int) -> Optional[RecordBatch]:
        """One input batch of ``rows`` live rows and capacity ``cap``,
        reduced to ``part`` (None when it had no rows): returns the
        state to emit now, else None."""
        if self.skipping:
            self.in_rows += rows
            return part
        self._queue.append((part, rows, cap))
        self._queued_rows += rows
        if self._queued_rows < self._min_rows:
            return None
        queue, self._queue = self._queue, []
        out = None
        for item in queue:  # only the last can decide
            out = self._step(*item)
        return out

    def _step(self, part: Optional[RecordBatch], rows: int, cap: int) -> Optional[RecordBatch]:
        self.in_rows += rows
        p = 0 if part is None else part.num_rows
        if self._state is None:
            # the first batch seeds the accumulator, shrunk to its own bucket
            self._items.append(part)
            self._rows.append(p)
            self._known[1] = p
            self._state = (False, p, min(cap, bucket_capacity(max(p, 1))), 1)
            self._good = 1
            self._check(p + self._eager_rows)
            return None
        if self._state[2] <= cap:
            # a fold: the count the host knows is a hint
            lazy, st_rows, acc_cap, n = self._state
            if not lazy:
                self._good = n
            self._items.append(part)
            self._rows.append(p)
            n = len(self._items)
            self._state = (True, self._hint(self._good, rows, acc_cap), acc_cap, n)
            prev, self._pending = self._pending, (n, acc_cap)
            if prev is not None:
                self._resolve(prev, following=True)
            self._check(self._state[1] + self._eager_rows)
            return None
        # the eager path
        self._resolve_state()
        acc_rows = self._state[1]
        self._check(acc_rows + self._eager_rows + p)
        if self.skipping:
            return part
        self._eager.append(part)
        self._eager_rows += p
        if acc_rows == 0 or self._eager_rows >= max(acc_rows, 4096):
            cap_m = bucket_capacity(acc_rows + self._eager_rows)
            self._items.extend(self._eager)
            self._rows.extend(0 if b is None else b.num_rows for b in self._eager)
            self._eager, self._eager_rows = [], 0
            n = len(self._items)
            self._state = (False, self._exact(n), cap_m, n)
        return None

    def rest(self) -> List[RecordBatch]:
        """The held states, to merge into the stream's last batch."""
        held = [self._merged] + self._items[self._merged_n:] + self._eager + [b for b, _, _ in self._queue]
        return [b for b in held if b is not None and b.num_rows]


# ---------------------------------------------------------------- AggExec


class AggExec(ExecNode):
    def __init__(
        self,
        child: ExecNode,
        mode: AggMode,
        groupings: Sequence[GroupingExpr],
        aggs: Sequence[AggFunction],
        supports_partial_skipping: bool = False,
        pre_filter: Optional[Expr] = None,
        post_sort: Optional[Sequence] = None,
        post_fetch: Optional[int] = None,
    ):
        super().__init__([child])
        self.mode = mode
        # the optimizer's folds (ops/fusion.py): a PARTIAL agg's
        # ``pre_filter`` is an absorbed filter's predicate, which drops
        # rows from the reduce; a FINAL agg's ``post_sort`` (SortFields
        # over its output) and ``post_fetch`` are an absorbed sort and
        # limit, applied to its one finalized batch
        assert pre_filter is None or mode == AggMode.PARTIAL
        assert post_sort is None or mode == AggMode.FINAL
        self.pre_filter = pre_filter
        self.post_sort = list(post_sort) if post_sort else None
        self.post_fetch = post_fetch
        # a PARTIAL agg with groupings may stop aggregating once its
        # groups pass spark.blaze.partialAggSkipping.ratio of its input
        # rows (_PartialSkip); the merge after the exchange finishes it
        self.supports_partial_skipping = supports_partial_skipping
        self.groupings = list(groupings)
        self.aggs = [AggFunction(ALIASES.get(a.fn, a.fn), a.expr, a.name) for a in aggs]
        in_schema = child.schema
        if mode == AggMode.PARTIAL:
            self._in_types = [None if a.expr is None else infer_dtype(a.expr, in_schema)
                              for a in self.aggs]
        else:
            self._in_types = [_state_input_type(a, in_schema) for a in self.aggs]
        group_fields = [Field(g.name, infer_dtype(g.expr, in_schema)) for g in self.groupings]
        state_fields = [
            # a merge keeps its input states' element budget (the conf
            # may differ between stages)
            in_schema.field(f"{a.name}#list") if a.fn in COLLECT and mode != AggMode.PARTIAL else f
            for a, t in zip(self.aggs, self._in_types) for f in agg_state_fields(a.fn, t, a.name)]
        self._state_schema = Schema(group_fields + state_fields)
        if mode == AggMode.FINAL:
            self._schema = Schema(group_fields + [
                Field(a.name, self._state_schema.field(f"{a.name}#list").dtype if a.fn in COLLECT
                      else agg_result_type(a.fn, t)) for a, t in zip(self.aggs, self._in_types)
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
        keep = None
        if self.pre_filter is not None and not merging:
            # a row the absorbed filter drops starts no group and is
            # null in every aggregate's input
            keep = predicate_mask(self.pre_filter, schema, env, n, n, batch.device)
        if merging:
            key_cols = [env[g.name] for g in self.groupings]
        else:
            key_cols = [lower(g.expr, schema, env, n) for g in self.groupings]
        seg = group_segments(encode_key_words(key_cols), keep) if self.groupings else None
        perm = (lambda t: t) if seg is None else (lambda t: t[seg.order])
        # one state column per entry: a reduced tensor (valid in every
        # group), or a min/max Column (null where a group had no value)
        out: list = []
        if seg is not None:
            first = seg.order[seg.starts]
            # a group's key is its first row's, canonical where it is a float
            out_keys = [c.take(first) for c in key_cols]
            out_keys = [Column(c.dtype, canonical_float(c.data), c.validity) if c.dtype.is_float else c
                        for c in out_keys]
        for a, t in zip(self.aggs, self._in_types):
            fields = agg_state_fields(a.fn, t, a.name)
            if a.fn in MINMAX:
                v = env[fields[0].name] if merging else lower(a.expr, schema, env, n)
                if keep is not None:
                    v = Column(v.dtype, v.data, v.validity & keep, v.lengths)
                out.append(seg_minmax(Column(v.dtype, perm(v.data), perm(v.validity),
                                             None if v.lengths is None else perm(v.lengths)),
                                      seg, a.fn == "min"))
                continue
            if a.fn in FIRST:
                # a merge skips null states (the reference's rule:
                # ``ignore = ... or mode != PARTIAL``)
                v = env[fields[0].name] if merging else lower(a.expr, schema, env, n)
                pick = v.validity if a.fn == "first_ignores_null" or merging else torch.ones_like(v.validity)
                if keep is not None:
                    pick = pick & keep
                    v = Column(v.dtype, v.data, v.validity & keep, v.lengths)
                out.append(seg_first(Column(v.dtype, perm(v.data), perm(v.validity),
                                            None if v.lengths is None else perm(v.lengths)),
                                     perm(pick), seg))
                continue
            if a.fn in VARIANCE:
                out.extend(self._variance_state(a, fields, schema, env, n, keep, perm, seg, merging))
                continue
            if a.fn in COLLECT:
                v = env[f"{a.name}#list"] if merging else lower(a.expr, schema, env, n)
                if keep is not None:
                    v = Column(v.dtype, v.data, v.validity & keep, v.lengths, v.children)
                if seg is not None:
                    v = v.take(seg.order)
                    mark = torch.zeros(n, dtype=torch.int64, device=batch.device)
                    mark[seg.starts] = 1
                    gid, starts, g = torch.cumsum(mark, 0) - 1, seg.starts, seg.n_groups
                else:
                    gid = torch.zeros(n, dtype=torch.int64, device=batch.device)
                    starts, g = gid[:1], 1
                arr_t = self._state_schema.field(f"{a.name}#list").dtype
                col = collect_reduce(v, arr_t, gid, starts, g, merging)
                out.append(dedup_array_state(col) if a.fn == "collect_set" else col)
                continue
            if merging:
                # every state column sums; nulls never occur in states
                for f in fields:
                    c = env[f.name]
                    out.append(seg_sum(perm(c.data), perm(c.validity), seg))
                continue
            if a.fn == "count_star":
                out.append(seg_sum(torch.ones(n, dtype=torch.int64, device=batch.device),
                                   torch.ones(n, dtype=torch.bool, device=batch.device) if keep is None
                                   else perm(keep), seg))
                continue
            v = lower(a.expr, schema, env, n)
            if keep is not None:
                v = Column(v.dtype, v.data, v.validity & keep, v.lengths)
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
            if isinstance(d, Column):
                state_cols.append(d.pad(cap))
                continue
            state_cols.append(Column(
                f.dtype, pad_rows(d, cap),
                pad_rows(torch.ones(n_out, dtype=torch.bool, device=d.device), cap)))
        return RecordBatch(self._state_schema, state_cols, n_out)

    @staticmethod
    def _variance_state(a, fields, schema, env, n, keep, perm, seg, merging) -> list:
        """(count, float sum, M2) per group of a stddev_samp/var_samp:
        raw values' deviations from their group's mean in this batch, or
        states merged by Chan's formula."""
        def per_row(group_values):
            if seg is None:
                return group_values
            mark = torch.zeros(seg.order.shape[0], dtype=torch.int64, device=group_values.device)
            mark[seg.starts] = 1
            return group_values[torch.cumsum(mark, 0) - 1]

        def mean_of(total, count):
            return total / torch.where(count > 0, count, 1).to(torch.float64)

        if merging:
            cc, sc, mc = (env[f.name] for f in fields)
            n_i, fs_i, m2_i = perm(cc.data), perm(sc.data), perm(mc.data)
            cnt = seg_sum(n_i, perm(cc.validity), seg)
            fs = seg_sum(fs_i, perm(sc.validity), seg)
            d = mean_of(fs_i, n_i) - per_row(mean_of(fs, cnt))
            term = torch.where(n_i > 0, n_i.to(torch.float64) * d * d, 0.0)
            return [cnt, fs, seg_sum(m2_i + term, perm(mc.validity), seg)]
        v = lower(a.expr, schema, env, n)
        f = v.data.to(torch.float64)
        if v.dtype.is_decimal:
            # the unscaled integer; every moment is of the logical value
            f = f / 10**v.dtype.scale
        valid = v.validity if keep is None else v.validity & keep
        f, valid = perm(f), perm(valid)
        cnt = seg_sum(valid.to(torch.int64), valid, seg)
        fs = seg_sum(f, valid, seg)
        dev = f - per_row(mean_of(fs, cnt))
        return [cnt, fs, seg_sum(dev * dev, valid, seg)]

    def _empty_state(self) -> RecordBatch:
        """The state of a global aggregate over no rows: zero counts and
        sums, null extremes."""
        cap = bucket_capacity(1)
        dev = self.device
        cols = [null_column(f.dtype, cap, dev) if f.name.endswith("#value") else
                _empty_list(f.dtype, cap, dev) if f.name.endswith("#list") else
                Column(f.dtype,
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
            if a.fn in MINMAX or a.fn in FIRST:
                out.append(env[f"{a.name}#value"])
                continue
            if a.fn in COLLECT:
                out.append(env[f"{a.name}#list"])
                continue
            if a.fn == "avg":
                out.append(self._finalize_avg(env, a.name, t))
                continue
            if a.fn in VARIANCE:
                cnt, m2 = env[f"{a.name}#cnt"].data, env[f"{a.name}#m2"].data
                var = m2.clamp(min=0) / torch.where(cnt > 1, cnt - 1, 1).to(torch.float64)
                out.append(Column(DataType.float64(), torch.sqrt(var) if a.fn == "stddev_samp" else var, cnt > 1))
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
        merging = self.mode != AggMode.PARTIAL
        partial = self.mode == AggMode.PARTIAL

        def merge(states: List[RecordBatch]) -> RecordBatch:
            return self._reduce(concat_batches(states), merging=True)

        def emit(out: RecordBatch) -> RecordBatch:
            self._record_batch(out)
            if partial:
                _count_partial("partial_rows", out.num_rows)
                _count_partial("partial_batches")
            return out

        def stream():
            skip = None
            if partial and self.groupings and self.supports_partial_skipping \
                    and bool(conf.ENABLE_PARTIAL_AGG_SKIPPING.get()):
                skip = _PartialSkip(merge, self.metrics)
            states: List[RecordBatch] = []
            for batch in child_stream:
                if not ctx.is_task_running():
                    return
                state = None
                if batch.num_rows:
                    with self.metrics.timer("elapsed_compute"):
                        state = self._reduce(batch, merging)
                if skip is not None:
                    state = skip.add(state, batch.num_rows, batch.capacity)
                    if state is not None and state.num_rows:
                        yield emit(state)
                # a grouped batch whose rows the pre_filter all dropped
                elif state is not None and state.num_rows:
                    states.append(state)
            if skip is not None:
                states = skip.rest()
            with self.metrics.timer("elapsed_compute"):
                if len(states) > 1:
                    state = merge(states)
                elif states:
                    state = states[0]
                elif not self.groupings:
                    state = self._empty_state()
                else:
                    return
                out = self._finalize(state) if self.mode == AggMode.FINAL else state
                if self.post_sort is not None:
                    from .sort import sort_batch

                    out = sort_batch(out, self.post_sort, self.post_fetch)
            yield emit(out)

        return stream()
