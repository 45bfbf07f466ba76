"""Columnar batches over torch tensors (≙ ``blaze_tpu/batch.py``).

- ``num_rows`` is a host int; rows ``[num_rows, capacity)`` are
  padding: validity False, data zeroed, string lengths zero.
- capacities are powers of two (>= conf.MIN_CAPACITY), the reference's
  shape buckets; operators here may compute on the live prefix, but
  every batch they emit keeps the padded layout.
- strings are fixed-width ``(cap, W)`` uint8 rows plus int32 lengths.

A batch's device is the device of its tensors; operators create new
tensors on the device of their inputs, so data never changes device
except where a scan or builder is told to stage it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from . import conf
from .schema import DataType, Schema, TypeKind, string_width_for

# column -> (data, lengths|None[, validity]) numpy arrays: the host
# table layout of the TPC-H generator (≙ blaze_tpu/tpch/datagen.py)
HostTable = Dict[str, Tuple[np.ndarray, ...]]


def bucket_capacity(n: int) -> int:
    """Round a row count up to its capacity bucket (power of two)."""
    cap = int(conf.MIN_CAPACITY.get())
    while cap < n:
        cap *= 2
    return cap


def torch_dtype(dtype: DataType) -> torch.dtype:
    """The torch dtype of a column's data buffer."""
    return _TORCH_OF_NP[np.dtype(dtype.np_dtype)]


_TORCH_OF_NP = {
    np.dtype(np.bool_): torch.bool,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
    np.dtype(np.uint8): torch.uint8,
}


def pad_rows(t: torch.Tensor, cap: int) -> torch.Tensor:
    """``t`` with its leading axis cut or zero-padded to ``cap`` rows."""
    n = t.shape[0]
    if n == cap:
        return t
    if n > cap:
        return t[:cap]
    out = torch.zeros((cap,) + tuple(t.shape[1:]), dtype=t.dtype, device=t.device)
    out[:n] = t
    return out


@dataclass
class Column:
    """data + validity (+ byte lengths for strings)."""

    dtype: DataType
    data: torch.Tensor                      # (cap,) or (cap, W) uint8 strings
    validity: torch.Tensor                  # bool (cap,)
    lengths: Optional[torch.Tensor] = None  # int32 (cap,) strings only

    @property
    def capacity(self) -> int:
        return int(self.validity.shape[0])

    @property
    def device(self) -> torch.device:
        return self.validity.device

    def to(self, device: torch.device) -> "Column":
        mv = lambda t: None if t is None else t.to(device)
        return Column(self.dtype, mv(self.data), mv(self.validity), mv(self.lengths))

    def take(self, idx: torch.Tensor, cap: Optional[int] = None) -> "Column":
        """Rows ``idx`` (int64 indices of rows to keep), padded with
        invalid zero rows to ``cap`` (default: no padding)."""
        g = lambda t: None if t is None else t.index_select(0, idx)
        out = Column(self.dtype, g(self.data), g(self.validity), g(self.lengths))
        return out if cap is None else out.pad(cap)

    def pad(self, cap: int) -> "Column":
        p = lambda t: None if t is None else pad_rows(t, cap)
        return Column(self.dtype, p(self.data), p(self.validity), p(self.lengths))

    def head(self, n: int) -> "Column":
        """The first ``n`` rows, unpadded (views)."""
        h = lambda t: None if t is None else t[:n]
        return Column(self.dtype, h(self.data), h(self.validity), h(self.lengths))


@dataclass
class RecordBatch:
    """Equally-sized columns; ``num_rows`` live rows."""

    schema: Schema
    columns: List[Column]
    num_rows: int

    @property
    def capacity(self) -> int:
        if not self.columns:
            return bucket_capacity(self.num_rows)
        return self.columns[0].capacity

    @property
    def device(self) -> torch.device:
        return self.columns[0].device

    def to(self, device: torch.device) -> "RecordBatch":
        if self.columns and self.device == torch.device(device):
            return self
        return RecordBatch(self.schema, [c.to(device) for c in self.columns], self.num_rows)

    def take(self, idx: torch.Tensor, cap: Optional[int] = None) -> "RecordBatch":
        """Rows ``idx`` re-padded to ``cap`` (default: their bucket)."""
        n = int(idx.shape[0])
        cap = bucket_capacity(n) if cap is None else cap
        return RecordBatch(self.schema, [c.take(idx, cap) for c in self.columns], n)


# ------------------------------------------------------------ builders


def column_from_numpy(
    dtype: DataType,
    values: np.ndarray,
    validity: Optional[np.ndarray] = None,
    capacity: Optional[int] = None,
    device: Union[None, str, torch.device] = None,
) -> Column:
    """A fixed-width column from numpy values; invalid and padding
    rows are zeroed."""
    from . import resolve_device

    if dtype.is_string:
        raise ValueError("use column_from_strings for string columns")
    n = values.shape[0]
    cap = capacity or bucket_capacity(n)
    valid = np.zeros(cap, np.bool_)
    valid[:n] = True if validity is None else validity.astype(np.bool_)
    data = np.zeros(cap, dtype.np_dtype)
    data[:n] = values.astype(dtype.np_dtype, copy=False)
    data = np.where(valid, data, np.zeros((), dtype=data.dtype))
    dev = resolve_device(device)
    return Column(dtype, torch.from_numpy(data).to(dev), torch.from_numpy(valid).to(dev))


def column_from_strings(
    values: Sequence[Optional[Union[str, bytes]]],
    width: Optional[int] = None,
    capacity: Optional[int] = None,
    dtype: Optional[DataType] = None,
    device: Union[None, str, torch.device] = None,
) -> Column:
    """A string column from python values (None = null)."""
    from . import resolve_device

    bs = [
        (v.encode("utf-8") if isinstance(v, str) else v) if v is not None else b""
        for v in values
    ]
    if width is None:
        width = (
            dtype.string_width
            if dtype is not None
            else string_width_for(max((len(b) for b in bs), default=1))
        )
    if any(len(b) > width for b in bs):
        raise ValueError(f"string longer than column width {width}")
    dtype = dtype or DataType.string(width)
    cap = capacity or bucket_capacity(len(bs))
    data = np.zeros((cap, width), np.uint8)
    lengths = np.zeros(cap, np.int32)
    validity = np.zeros(cap, np.bool_)
    for i, (v, b) in enumerate(zip(values, bs)):
        if v is None:
            continue
        validity[i] = True
        lengths[i] = len(b)
        data[i, : len(b)] = np.frombuffer(b, np.uint8)
    dev = resolve_device(device)
    return Column(
        dtype,
        torch.from_numpy(data).to(dev),
        torch.from_numpy(validity).to(dev),
        torch.from_numpy(lengths).to(dev),
    )


def batch_from_numpy(
    schema: Schema,
    host_table: HostTable,
    device: Union[None, str, torch.device] = None,
    lo: int = 0,
    hi: Optional[int] = None,
) -> RecordBatch:
    """Rows ``[lo, hi)`` of a host table as one padded batch on
    ``device`` — the port's counterpart of the reference staging its
    numpy tables (``blaze_tpu/tpch/datagen.py`` ``table_to_batches``):
    the same arrays become the same rows in both packages."""
    from . import resolve_device

    dev = resolve_device(device)
    if hi is None:
        hi = next(iter(host_table.values()))[0].shape[0]
    n = hi - lo
    cap = bucket_capacity(n)
    cols = []
    for f in schema.fields:
        entry = host_table[f.name]
        data, lengths = entry[0], entry[1]
        vsrc = entry[2] if len(entry) > 2 else None
        validity = np.zeros(cap, np.bool_)
        validity[:n] = True if vsrc is None else vsrc[lo:hi]
        if f.dtype.is_string:
            d = np.zeros((cap, data.shape[1]), np.uint8)
            d[:n] = data[lo:hi]
            ln = np.zeros(cap, np.int32)
            ln[:n] = lengths[lo:hi]
            cols.append(Column(
                f.dtype, torch.from_numpy(d).to(dev), torch.from_numpy(validity).to(dev),
                torch.from_numpy(ln).to(dev)))
        else:
            d = np.zeros(cap, f.dtype.np_dtype)
            d[:n] = data[lo:hi].astype(f.dtype.np_dtype, copy=False)
            cols.append(Column(
                f.dtype, torch.from_numpy(d).to(dev), torch.from_numpy(validity).to(dev)))
    return RecordBatch(schema, cols, n)


def table_to_batches(
    table: HostTable,
    schema: Schema,
    n_partitions: int = 1,
    batch_rows: int = 65536,
    device: Union[None, str, torch.device] = None,
) -> List[List[RecordBatch]]:
    """Split a host table into per-partition batch lists, with the
    partition and batch boundaries of the reference's
    ``table_to_batches`` (``blaze_tpu/tpch/datagen.py``)."""
    n = next(iter(table.values()))[0].shape[0]
    parts: List[List[RecordBatch]] = []
    for p in range(n_partitions):
        lo = p * n // n_partitions
        hi = (p + 1) * n // n_partitions
        parts.append([
            batch_from_numpy(schema, table, device, s, min(s + batch_rows, hi))
            for s in range(lo, hi, batch_rows)
        ])
    return parts


# ------------------------------------------------- host <-> device copies

#: copies made by :func:`tensors_to_host` and :meth:`HostStaging.to_device`
#: since the last :func:`reset_copy_counts`
COPIES = {"device_to_host": 0, "host_to_device": 0}


def reset_copy_counts() -> None:
    for k in COPIES:
        COPIES[k] = 0


def _aligned(nbytes: int) -> int:
    """Regions start 8-byte aligned, so any dtype views them."""
    return (nbytes + 7) & ~7


def tensors_to_host(tensors: Sequence[torch.Tensor]) -> List[np.ndarray]:
    """The tensors as numpy arrays in ONE device-to-host copy: their
    bytes are packed into one buffer on their device, the buffer is
    copied, and the host copy is split into views."""
    if not tensors:
        return []
    parts, layout = [], []
    off = 0
    for t in tensors:
        raw = t.contiguous().reshape(-1).view(torch.uint8)
        pad = _aligned(raw.numel()) - raw.numel()
        parts.append(raw)
        if pad:
            parts.append(torch.zeros(pad, dtype=torch.uint8, device=t.device))
        layout.append((off, raw.numel(), t.dtype, tuple(t.shape)))
        off += raw.numel() + pad
    host = torch.cat(parts).cpu().numpy()
    COPIES["device_to_host"] += 1
    out = []
    for o, nbytes, dtype, shape in layout:
        np_dtype = torch.empty((), dtype=dtype).numpy().dtype
        out.append(host[o:o + nbytes].view(np_dtype).reshape(shape))
    return out


class HostStaging:
    """Zeroed host arrays allocated in one byte buffer, filled by the
    caller, then moved to a device in ONE host-to-device copy."""

    def __init__(self):
        self._regions: List[Tuple[int, np.dtype, tuple]] = []
        self._size = 0
        self._buf: Optional[np.ndarray] = None

    def region(self, shape: tuple, np_dtype) -> int:
        """Reserve a region; returns its index (allocate before filling)."""
        np_dtype = np.dtype(np_dtype)
        nbytes = int(np.prod(shape, dtype=np.int64)) * np_dtype.itemsize
        self._regions.append((self._size, np_dtype, tuple(shape)))
        self._size += _aligned(nbytes)
        return len(self._regions) - 1

    def array(self, i: int) -> np.ndarray:
        """The host view of region ``i`` (zeroed until written)."""
        if self._buf is None:
            self._buf = np.zeros(self._size, np.uint8)
        off, np_dtype, shape = self._regions[i]
        nbytes = int(np.prod(shape, dtype=np.int64)) * np_dtype.itemsize
        return self._buf[off:off + nbytes].view(np_dtype).reshape(shape)

    def to_device(self, device: torch.device) -> List[torch.Tensor]:
        """Every region as a tensor on ``device``."""
        if self._buf is None:
            self._buf = np.zeros(self._size, np.uint8)
        dev = torch.from_numpy(self._buf).to(device)
        COPIES["host_to_device"] += 1
        out = []
        for off, np_dtype, shape in self._regions:
            nbytes = int(np.prod(shape, dtype=np.int64)) * np_dtype.itemsize
            out.append(dev[off:off + nbytes].view(_TORCH_OF_NP[np_dtype]).reshape(shape))
        return out


# --------------------------------------------------------- host readout


def column_to_pylist(col: Column, num_rows: int) -> List:
    """Python values of the first ``num_rows`` rows (None = null;
    decimals unscaled, as exact ints)."""
    validity = col.validity[:num_rows].cpu().numpy()
    data = col.data[:num_rows].cpu().numpy()
    if col.dtype.is_string:
        lengths = col.lengths[:num_rows].cpu().numpy()
        raw = [bytes(data[i, : lengths[i]]) if validity[i] else None for i in range(num_rows)]
        if col.dtype.kind == TypeKind.BINARY:
            return raw
        return [None if b is None else b.decode("utf-8", errors="replace") for b in raw]
    conv = bool if col.dtype.kind == TypeKind.BOOL else float if col.dtype.is_float else int
    return [conv(data[i]) if validity[i] else None for i in range(num_rows)]


def batch_to_pydict(batch: RecordBatch) -> Dict[str, List]:
    """Materialize a batch on the host as python values."""
    return {
        f.name: column_to_pylist(c, batch.num_rows)
        for f, c in zip(batch.schema.fields, batch.columns)
    }


# ------------------------------------------------------------- reshape


def concat_columns(parts: Sequence[Column], cap: int) -> Column:
    """Row-concatenate live column prefixes (given by ``Column.head``)
    into one column padded to ``cap``; string widths merge to the
    widest part."""
    dtype = parts[0].dtype
    if dtype.is_string:
        w = max(p.data.shape[1] for p in parts)
        datas = [
            p.data if p.data.shape[1] == w
            else torch.nn.functional.pad(p.data, (0, w - p.data.shape[1]))
            for p in parts
        ]
        data = torch.cat(datas)
        lengths = pad_rows(torch.cat([p.lengths for p in parts]), cap)
    else:
        data = torch.cat([p.data for p in parts])
        lengths = None
    return Column(dtype, pad_rows(data, cap),
                  pad_rows(torch.cat([p.validity for p in parts]), cap), lengths)


def concat_batches(batches: Sequence[RecordBatch]) -> RecordBatch:
    """One batch holding every input batch's live rows, in order."""
    assert batches
    if len(batches) == 1:
        return batches[0]
    schema = batches[0].schema
    n = sum(b.num_rows for b in batches)
    cap = bucket_capacity(n)
    cols = [
        concat_columns([b.columns[i].head(b.num_rows) for b in batches], cap)
        for i in range(len(schema.fields))
    ]
    return RecordBatch(schema, cols, n)


def slice_rows(batch: RecordBatch, lo: int, n: int) -> RecordBatch:
    """Rows ``[lo, lo + n)`` re-padded to their own bucket."""
    cap = bucket_capacity(n)
    cols = [
        Column(c.dtype, *(None if t is None else pad_rows(t[lo:lo + n], cap)
                          for t in (c.data, c.validity, c.lengths)))
        for c in batch.columns
    ]
    return RecordBatch(batch.schema, cols, n)
