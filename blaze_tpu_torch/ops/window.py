"""Window functions over one buffered partition (≙
``blaze_tpu/ops/window.py``).

The plan sorts each partition by its PARTITION BY and ORDER BY keys
(Spark's EnsureRequirements); :class:`WindowExec` concatenates the
partition's batches on the device and computes every window column over
that one batch with segmented prefix operations, eagerly, in torch:

- partition and peer boundaries where a key word changes (the group
  words of ``ops/agg.py`` and the order words of ``ops/sort.py``);
- each row's partition start is the running maximum of the boundary
  positions (``torch.cummax``), its partition end and peer-group end
  the running minimum of the next boundary (``torch.cummin`` on the
  flipped tensor);
- ``row_number``, ``rank``, ``dense_rank``, ``ntile`` from those
  positions; ``lead``/``lag``, ``first_value``/``last_value`` and
  ``nth_value`` as gathers;
- ``sum``/``count``/``avg`` as prefix-sum differences at the frame's
  ends: Spark's default RANGE frame (up to the current row's last
  peer), ``whole_partition``, a ROWS frame (``rows_frame``) or a RANGE
  offset frame on one integral key (``range_frame``, its bounds by a
  binary search of the sorted key).  Integers and decimals difference
  one global ``cumsum`` (exact: wraparound cancels); a decimal sum wider
  than 18 digits runs on two radix-2^32 limbs and a decimal average
  divides on int128 with HALF_UP, so no value wraps (the reference
  multiplies in int64).  Floats take a segmented scan that restarts at
  each partition (log2(rows) steps), so one partition's magnitude never
  cancels against another's;
- ``min``/``max`` over order-preserving int64 keys (floats: -0.0 below
  0.0, NaN above everything; a NaN in the frame makes either NaN, as
  the reference's NaN-propagating ``jnp.minimum``/``maximum`` do): a
  segmented scan for the running and whole-partition frames, a sparse
  table for ROWS and RANGE frames.

No float sum goes through ``index_add_``/``scatter_add_``, whose atomics
make the result depend on their order.  The transform is exact only
over the whole partition in one batch, so its traced form advertises
``trace_requires_buffer``: the optimizer plants
``ops.fusion.BufferPartitionExec`` below a fused chain that ends in a
window.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch

from ..batch import Column, RecordBatch, concat_batches
from ..exprs import int128 as I
from ..exprs.compile import infer_dtype, lower
from ..exprs.ir import Expr
from ..runtime.context import TaskContext
from ..schema import DataType, Field, Schema, decimal_avg_agg_type
from .agg import encode_key_words, seg_scan, sum_is_wide, sum_result_type
from .base import BatchStream, ExecNode
from .filter import live_mask
from .project import mask_padding
from .sort import SortField, order_words

_I64_MAX = (1 << 63) - 1
_I64_MIN = -(1 << 63)
_MAG = 0x7FFFFFFFFFFFFFFF


@dataclass
class WindowFunction:
    """kind: row_number | rank | dense_rank | ntile | nth_value | lead |
    lag | first_value | last_value | sum | count | avg | min | max.

    Frames: default = RANGE unbounded preceding .. the current row's
    last peer; ``whole_partition`` = unbounded .. unbounded;
    ``rows_frame`` = ROWS BETWEEN p PRECEDING AND q FOLLOWING (None:
    unbounded on that side; sum, count, avg, and min/max with both
    bounds); ``range_frame`` = RANGE BETWEEN x PRECEDING AND y
    FOLLOWING in logical values of the one integral ORDER BY key.
    ``offset``: the lead/lag row offset, the ntile bucket count, the n
    of nth_value; ``ignore_nulls``: lead/lag skip null values."""

    kind: str
    name: str
    expr: Optional[Expr] = None
    whole_partition: bool = False
    rows_frame: Optional[Tuple[Optional[int], Optional[int]]] = None
    offset: int = 1
    ignore_nulls: bool = False
    range_frame: Optional[Tuple[Optional[int], Optional[int]]] = None


# ------------------------------------------------------------ helpers


def _boundaries(words: Sequence[torch.Tensor], live: torch.Tensor) -> torch.Tensor:
    """True at row 0 and wherever a word changes from the row before
    (padding rows read as zero words)."""
    cap = live.shape[0]
    ch = torch.zeros(cap, dtype=torch.bool, device=live.device)
    for w in words:
        w = torch.where(live, w, 0)
        ch[1:] |= w[1:] != w[:-1]
    ch[:1] = True
    return ch


def _next_boundary(b: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Per row, the smallest boundary position after it (cap if none)."""
    cap = b.shape[0]
    at = torch.where(b, pos, cap)
    nearest = torch.flip(torch.cummin(torch.flip(at, (0,)), 0).values, (0,))
    return torch.cat([nearest[1:], nearest.new_full((1,), cap)])


def _gather(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``t[idx]`` with ``idx`` clamped into the batch."""
    return t.index_select(0, idx.clamp(0, t.shape[0] - 1))


def _before(prefix: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """The inclusive prefix at ``lo - 1`` (0 where ``lo`` is 0)."""
    return torch.where(lo > 0, _gather(prefix, lo - 1), torch.zeros((), dtype=prefix.dtype,
                                                                    device=prefix.device))


def _minmax_keys(c: Column) -> torch.Tensor:
    """Order-preserving int64 keys of a fixed-width column (floats: one
    positive NaN above +inf, -0.0 below 0.0)."""
    if not c.dtype.is_float:
        return c.data.to(torch.int64)
    d = torch.where(torch.isnan(c.data), torch.full_like(c.data, float("nan")), c.data)
    bits = (d.view(torch.int32) if d.dtype == torch.float32 else d.view(torch.int64)).to(torch.int64)
    return bits ^ ((bits >> 63) & _MAG)


def _from_keys(keys: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """The values of :func:`_minmax_keys` back in ``like``'s dtype."""
    if not like.dtype.is_floating_point:
        return keys.to(like.dtype)
    bits = keys ^ ((keys >> 63) & _MAG)
    if like.dtype == torch.float32:
        return bits.to(torch.int32).view(torch.float32)
    return bits.view(torch.float64)


def _sparse_table(keys: torch.Tensor, op, sentinel: int, levels: int) -> List[torch.Tensor]:
    """Level ``j`` holds ``op`` over rows ``[i, i + 2^j)``."""
    table = [keys]
    for j in range(1, levels):
        half = 1 << (j - 1)
        prev = table[-1]
        table.append(op(prev, torch.cat([prev[half:], prev.new_full((min(half, prev.shape[0]),), sentinel)])))
    return table


def _sparse_query(table: List[torch.Tensor], op, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """``op`` over rows ``[lo, hi]`` (two overlapping power-of-two
    spans); rows where ``hi < lo`` read one row."""
    cap = table[0].shape[0]
    length = torch.clamp(hi - lo + 1, min=1)
    lev = torch.zeros_like(length)
    for k in range(1, len(table)):
        lev = lev + (length >= (1 << k)).to(torch.int64)
    stacked = torch.stack(table)  # (levels, cap)
    a = stacked[lev, lo.clamp(0, cap - 1)]
    b = stacked[lev, (hi - (torch.ones_like(lev) << lev) + 1).clamp(0, cap - 1)]
    return op(a, b)


def _levels(span: int) -> int:
    return max(1, int(math.ceil(math.log2(max(span, 2)))) + 1)


# ------------------------------------------------------ the transform


def window_columns(in_schema: Schema, functions_: Sequence[WindowFunction], part_by: Sequence[Expr],
                   ord_by: Sequence[SortField], cols: Sequence[Column], num_rows) -> List[Column]:
    """The input columns followed by one column per window function,
    over one batch holding whole partitions in key order.  ``num_rows``
    is an int or a 0-d tensor (never read back)."""
    cap = cols[0].capacity
    dev = cols[0].device
    env = {f.name: c for f, c in zip(in_schema.fields, cols)}
    live = live_mask(cap, num_rows, dev)
    pos = torch.arange(cap, device=dev)
    zero = torch.zeros((), dtype=torch.int64, device=dev)

    pwords = encode_key_words([lower(e, in_schema, env, cap) for e in part_by]) if part_by else []
    part_b = _boundaries(pwords, live)
    owords: List[torch.Tensor] = []
    for f in ord_by:
        owords.extend(order_words(lower(f.expr, in_schema, env, cap), f.ascending, f.nulls_first))
    peer_b = _boundaries(pwords + owords, live) if ord_by else part_b

    start = torch.cummax(torch.where(part_b, pos, 0), 0).values
    last_live = torch.as_tensor(num_rows, device=dev) - 1
    part_end = torch.minimum(_next_boundary(part_b, pos) - 1, last_live)
    peer_end = torch.minimum(_next_boundary(peer_b, pos) - 1, part_end)

    def range_bounds(f: WindowFunction):
        """[lo, hi] rows of a RANGE offset frame: a binary search of the
        partition's sorted key; a null key's frame is its null peers."""
        o = ord_by[0]
        kc = lower(o.expr, in_schema, env, cap)
        key = kc.data.to(torch.int64)
        kvalid = kc.validity & live
        x, y = f.range_frame
        if kc.dtype.is_decimal:
            # the frame's offsets are logical values, the key unscaled
            sc = 10 ** kc.dtype.scale
            x = None if x is None else x * sc
            y = None if y is None else y * sc
        if not o.ascending:
            key = -key
        cnulls = torch.cumsum((~kvalid & live).to(torch.int64), 0)
        n_nulls = _gather(cnulls, part_end) - _before(cnulls, start)
        if o.nulls_first:
            region_lo, region_hi = start + n_nulls, part_end
        else:
            region_lo, region_hi = start, part_end - n_nulls
        steps = _levels(cap)

        def search(target, left: bool):
            lo_b, hi_b = region_lo, region_hi + 1
            for _ in range(steps):
                mid = (lo_b + hi_b) // 2
                kv = _gather(key, mid)
                right = (kv < target) if left else (kv <= target)
                go = (mid < hi_b) & right
                lo_b = torch.where(go, mid + 1, lo_b)
                hi_b = torch.where(go, hi_b, mid)
            return lo_b

        lo = region_lo if x is None else search(key - x, True)
        hi = region_hi if y is None else search(key + y, False) - 1
        null_row = ~kvalid
        if o.nulls_first:
            lo = torch.where(null_row, start, lo)
            hi = torch.where(null_row, region_lo - 1, hi)
        else:
            lo = torch.where(null_row, region_hi + 1, lo)
            hi = torch.where(null_row, part_end, hi)
        return lo, hi

    def frame(f: WindowFunction):
        """The [lo, hi] rows of an aggregate's frame."""
        if f.rows_frame is not None:
            p_, q_ = f.rows_frame
            lo = start if p_ is None else torch.maximum(pos - p_, start)
            hi = part_end if q_ is None else torch.minimum(pos + q_, part_end)
            return lo, hi
        if f.range_frame is not None:
            return range_bounds(f)
        return start, (part_end if f.whole_partition else peer_end)

    def framed_sum(vals: torch.Tensor, lo, hi) -> torch.Tensor:
        """Sum of ``vals`` over each row's [lo, hi] (0 when empty)."""
        if vals.dtype.is_floating_point:
            seg = seg_scan(vals, part_b, torch.add)
            s = _gather(seg, hi) - torch.where(lo > start, _gather(seg, lo - 1), torch.zeros_like(seg))
        else:
            c = torch.cumsum(vals, 0)
            s = _gather(c, hi) - _before(c, lo)
        return torch.where(hi < lo, torch.zeros_like(s), s)

    out: List[Column] = list(cols)

    def emit(c: Column) -> None:
        out.append(mask_padding(c, live))

    int64 = DataType.int64()
    for f in functions_:
        if f.kind == "row_number":
            emit(Column(int64, pos - start + 1, live))
        elif f.kind == "rank":
            last_peer_start = torch.cummax(torch.where(peer_b, pos, 0), 0).values
            emit(Column(int64, last_peer_start - start + 1, live))
        elif f.kind == "dense_rank":
            seen = torch.cumsum(peer_b.to(torch.int64), 0)
            emit(Column(int64, seen - _gather(seen, start) + 1, live))
        elif f.kind == "ntile":
            rn0 = pos - start
            count = part_end - start + 1
            base = count // f.offset
            rem = count % f.offset
            fat = rem * (base + 1)
            v = torch.where(rn0 < fat, rn0 // torch.clamp(base + 1, min=1),
                            rem + (rn0 - fat) // torch.clamp(base, min=1)) + 1
            emit(Column(int64, v, live))
        elif f.kind == "nth_value":
            c = lower(f.expr, in_schema, env, cap)
            src = start + (f.offset - 1)
            g = c.take(src.clamp(0, cap - 1))
            in_frame = src <= (part_end if f.whole_partition else peer_end)
            emit(g.mask_rows(in_frame))
        elif f.kind in ("lead", "lag"):
            c = lower(f.expr, in_schema, env, cap)
            if f.ignore_nulls:
                # the k-th non-null neighbour: map each non-null rank to
                # its row once, then gather each row's target rank
                valid = c.validity & live
                cv = torch.cumsum(valid.to(torch.int64), 0)
                slot = torch.where(valid, cv, 0)
                row_of_rank = torch.zeros(cap + 1, dtype=torch.int64, device=dev).scatter_(
                    0, slot, torch.where(valid, pos, 0))
                if f.kind == "lag":
                    target = cv - valid.to(torch.int64) - (f.offset - 1)
                    in_part = target > _before(cv, start)
                else:
                    target = cv + f.offset
                    in_part = target <= _gather(cv, part_end)
                src = row_of_rank.index_select(0, target.clamp(0, cap))
            else:
                src = pos + (f.offset if f.kind == "lead" else -f.offset)
                in_part = (src >= start) & (src <= part_end)
            g = c.take(src.clamp(0, cap - 1))
            emit(g.mask_rows(in_part))
        elif f.kind in ("first_value", "last_value"):
            c = lower(f.expr, in_schema, env, cap)
            if f.kind == "first_value":
                src = start
            else:
                src = part_end if f.whole_partition else peer_end
            emit(c.take(src.clamp(0, cap - 1)))
        elif f.kind in ("sum", "count", "avg"):
            c = lower(f.expr, in_schema, env, cap)
            valid = c.validity & live
            lo, hi = frame(f)
            cnt = framed_sum(valid.to(torch.int64), lo, hi)
            if f.kind == "count":
                emit(Column(int64, cnt, live))
                continue
            has = live & (cnt > 0)
            if c.dtype.is_float:
                s = framed_sum(torch.where(valid, c.data.to(torch.float64), 0.0), lo, hi)
                if f.kind == "sum":
                    emit(Column(DataType.float64(), s, has))
                else:
                    emit(Column(DataType.float64(), s / torch.clamp(cnt, min=1).to(torch.float64), has))
                continue
            d = torch.where(valid, c.data.to(torch.int64), zero)
            st = sum_result_type(c.dtype)
            if c.dtype.is_decimal and sum_is_wide(c.dtype):
                # two radix-2^32 limbs, combined on int128
                hs, ls = framed_sum(d >> 32, lo, hi), framed_sum(d & 0xFFFFFFFF, lo, hi)
                wide = I.add(hs >> 32, hs << 32, *I.from_i64(ls))
            else:
                s = framed_sum(d, lo, hi)
                wide = I.from_i64(s)
            if f.kind == "sum":
                v, fits = I.to_i64(*wide)
                emit(Column(st, torch.where(fits, v, zero), has & fits))
            elif c.dtype.is_decimal:
                rt = decimal_avg_agg_type(c.dtype)
                q, fits = I.div_round_half_up(*I.mul_pow10(*wide, rt.scale - c.dtype.scale),
                                              torch.clamp(cnt, min=1))
                emit(Column(rt, torch.where(fits, q, zero), has & fits))
            else:
                v, _ = I.to_i64(*wide)
                emit(Column(DataType.float64(), v.to(torch.float64) / torch.clamp(cnt, min=1).to(torch.float64),
                            has))
        else:  # min, max
            c = lower(f.expr, in_schema, env, cap)
            valid = c.validity & live
            is_min = f.kind == "min"
            op = torch.minimum if is_min else torch.maximum
            sentinel = _I64_MAX if is_min else _I64_MIN
            keys = torch.where(valid, _minmax_keys(c), sentinel)
            lo, hi = frame(f)
            if f.rows_frame is None and f.range_frame is None:
                run = _gather(seg_scan(keys, part_b, op), hi)
            else:
                span = cap if f.range_frame is not None else f.rows_frame[0] + f.rows_frame[1] + 1
                run = _sparse_query(_sparse_table(keys, op, sentinel, min(_levels(span), _levels(cap))),
                                    op, lo, hi)
            has = live & (framed_sum(valid.to(torch.int64), lo, hi) > 0) & (hi >= lo)
            data = _from_keys(run, c.data)
            if is_min and c.dtype.is_float:
                # a NaN in the frame makes the minimum NaN
                nan = framed_sum((valid & torch.isnan(c.data)).to(torch.int64), lo, hi) > 0
                data = torch.where(nan, torch.full_like(data, float("nan")), data)
            emit(Column(c.dtype, torch.where(has, data, torch.zeros_like(data)), has))
    return out


def _check_frames(functions_: Sequence[WindowFunction], order_by: Sequence[SortField], in_schema: Schema) -> None:
    """The frames the transform computes; anything else raises, naming
    itself."""
    for f in functions_:
        if f.kind in ("min", "max") and infer_dtype(f.expr, in_schema).is_string:
            raise NotImplementedError(f"window {f.kind} over a string")
        if f.range_frame is not None:
            if f.kind not in ("sum", "count", "avg", "min", "max"):
                raise NotImplementedError(f"RANGE frame for window kind {f.kind!r}")
            if len(order_by) != 1:
                raise NotImplementedError("RANGE offset frame requires exactly one ORDER BY key")
            kt = infer_dtype(order_by[0].expr, in_schema)
            if not (kt.is_integer or kt.is_decimal or kt.kind.name == "DATE32"):
                raise NotImplementedError("RANGE offset frame requires an integral order key")
        elif f.rows_frame is not None:
            if f.kind in ("min", "max"):
                if None in f.rows_frame:
                    raise NotImplementedError("unbounded ROWS min/max frame (the running and "
                                              "whole-partition frames cover those bounds)")
            elif f.kind not in ("sum", "count", "avg"):
                raise NotImplementedError(f"ROWS frame for window kind {f.kind!r}")


_KINDS = ("row_number", "rank", "dense_rank", "ntile", "nth_value", "lead", "lag", "first_value",
          "last_value", "sum", "count", "avg", "min", "max")


def window_output_type(f: WindowFunction, in_schema: Schema) -> DataType:
    if f.kind not in _KINDS:
        raise NotImplementedError(f"window function {f.kind!r}")
    if f.kind in ("row_number", "rank", "dense_rank", "count", "ntile"):
        return DataType.int64()
    t = infer_dtype(f.expr, in_schema)
    if f.kind == "sum":
        return sum_result_type(t)
    if f.kind == "avg":
        return decimal_avg_agg_type(t) if t.is_decimal else DataType.float64()
    return t


class WindowExec(ExecNode):
    def __init__(self, child: ExecNode, functions: Sequence[WindowFunction], partition_by: Sequence[Expr],
                 order_by: Sequence[SortField]):
        super().__init__([child])
        self.functions = list(functions)
        self.partition_by = list(partition_by)
        self.order_by = list(order_by)
        in_schema = child.schema
        _check_frames(self.functions, self.order_by, in_schema)
        self._schema = Schema(list(in_schema.fields)
                              + [Field(f.name, window_output_type(f, in_schema)) for f in self.functions])

    @property
    def schema(self) -> Schema:
        return self._schema

    def _columns(self, cols, num_rows) -> List[Column]:
        return window_columns(self.children[0].schema, self.functions, self.partition_by, self.order_by,
                              cols, num_rows)

    # ---------------------------------------------- tracing contract
    #
    # Exact only over the whole partition in one batch: the optimizer
    # plants a BufferPartitionExec (the same concatenation ``execute``
    # does) below a fused chain that ends in a window, which then runs
    # the window and the operators above it per buffered batch.

    def trace_fn(self):
        return lambda cols, num_rows: (self._columns(cols, num_rows), num_rows)

    def trace_key(self):
        return ("window", repr(self.children[0].schema),
                tuple((f.kind, f.name, repr(f.expr), f.whole_partition, f.rows_frame, f.offset,
                       f.ignore_nulls, f.range_frame) for f in self.functions),
                tuple(repr(e) for e in self.partition_by),
                tuple((repr(f.expr), f.ascending, f.nulls_first) for f in self.order_by))

    @property
    def trace_requires_buffer(self) -> bool:
        return True

    def required_child_orderings(self):
        """The segment scans assume the layout a sort below set up; the
        builders sort by prefixes of (partition_by, order_by), so this
        only asks for some sort below (the reference's relaxed form)."""
        return [()]

    @property
    def preserves_ordering(self) -> bool:
        # a window appends columns and keeps the row order, so a window
        # stacked on another (TPC-DS q47/q57) still sees the sort below
        return True

    def execute(self, partition: int, ctx: TaskContext) -> BatchStream:
        child_stream = self.children[0].execute(partition, ctx)

        def stream():
            buffered = list(child_stream)
            if not buffered:
                return
            merged = concat_batches(buffered)  # on the device
            with self.metrics.timer("elapsed_compute"):
                cols = self._columns(merged.columns, merged.num_rows)
            out = RecordBatch(self._schema, cols, merged.num_rows)
            self._record_batch(out)
            yield out

        return stream()
