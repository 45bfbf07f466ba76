"""Columnar batches over torch tensors (≙ ``blaze_tpu/batch.py``).

- ``num_rows`` is a host int; rows ``[num_rows, capacity)`` are
  padding: validity False, data zeroed, string lengths zero.
- capacities are powers of two (>= conf.MIN_CAPACITY), the reference's
  shape buckets; operators here may compute on the live prefix, but
  every batch they emit keeps the padded layout.
- strings are fixed-width ``(cap, W)`` uint8 rows plus int32 lengths.
- ARRAY/MAP/STRUCT columns carry child columns in the reference's
  padded layout (``Column``): arrays and maps hold at most
  ``max_elems`` elements a row.
- OPAQUE columns (UDAF states) hold python objects in a numpy object
  array with a CPU validity tensor: they never leave the host, and every
  reshape below moves them on the host beside the device columns.

A batch's device is the device of its tensors; operators create new
tensors on the device of their inputs, so data never changes device
except where a scan or builder is told to stage it.
"""

from __future__ import annotations

import threading
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


def pad_objects(objs: np.ndarray, cap: int) -> np.ndarray:
    """An object array cut or padded with None to ``cap`` rows."""
    out = np.empty(cap, dtype=object)
    k = min(cap, objs.shape[0])
    out[:k] = objs[:k]
    return out


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


def _bcast(mask: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """A row mask (``(cap,)``, or ``(cap, M)`` over an element layout)
    viewed to broadcast over ``t``'s trailing axes."""
    return mask.view(tuple(mask.shape) + (1,) * (t.dim() - mask.dim()))


@dataclass
class Column:
    """data + validity (+ byte lengths for strings; + children for
    nested types).

    Nested layouts (≙ ``blaze_tpu/batch.py`` ``Column``: a fixed
    element budget ``M = dtype.max_elems``, padded):

    - ARRAY(T, M): ``data`` None, ``validity (cap,)`` row validity,
      ``lengths (cap,)`` int32 element counts, ``children = (elem,)``,
      a Column of T whose buffers lead with ``(cap, M)``: data
      ``(cap, M)`` (strings ``(cap, M, W)``), validity ``(cap, M)``
      element validity, lengths ``(cap, M)`` for strings.
    - MAP(K, V, M): like ARRAY with ``children = (keys, values)``
      sharing ``lengths``.
    - STRUCT: ``data`` None, ``validity (cap,)``, one child Column per
      field.

    Every buffer at every depth leads with the row axis, so a row
    gather, pad or slice applies to each alike, recursively."""

    dtype: DataType
    data: Optional[torch.Tensor]            # (cap,), (cap, W) strings, None nested
    validity: torch.Tensor                  # bool (cap,)
    lengths: Optional[torch.Tensor] = None  # int32 (cap,): strings, array/map counts
    children: Optional[Tuple["Column", ...]] = None  # nested types only

    @property
    def capacity(self) -> int:
        return int(self.validity.shape[0])

    @property
    def device(self) -> torch.device:
        return self.validity.device

    @property
    def is_opaque(self) -> bool:
        return self.dtype.kind == TypeKind.OPAQUE

    def map_buffers(self, fn) -> "Column":
        """Every buffer (children's included) through ``fn``; None
        stays None."""
        f = lambda t: None if t is None else fn(t)
        return Column(self.dtype, f(self.data), f(self.validity), f(self.lengths),
                      None if self.children is None else tuple(k.map_buffers(fn) for k in self.children))

    def to(self, device: torch.device) -> "Column":
        if self.is_opaque:
            return self  # python objects never leave the host
        return self.map_buffers(lambda t: t.to(device))

    def take(self, idx: torch.Tensor, cap: Optional[int] = None,
             host_idx: Optional[torch.Tensor] = None) -> "Column":
        """Rows ``idx`` (int64 indices of rows to keep), padded with
        invalid zero rows to ``cap`` (default: no padding).  An opaque
        column gathers on the host, by ``host_idx`` (``idx`` on the
        CPU; copied from ``idx`` when None)."""
        if self.is_opaque:
            h = idx.cpu() if host_idx is None else host_idx
            out = Column(self.dtype, self.data[h.numpy()], self.validity.index_select(0, h))
        else:
            out = self.map_buffers(lambda t: t.index_select(0, idx))
        return out if cap is None else out.pad(cap)

    def pad(self, cap: int) -> "Column":
        if self.is_opaque:
            return Column(self.dtype, pad_objects(self.data, cap), pad_rows(self.validity, cap))
        return self.map_buffers(lambda t: pad_rows(t, cap))

    def head(self, n: int) -> "Column":
        """The first ``n`` rows, unpadded (views)."""
        return self.rows(0, n)

    def rows(self, lo: int, hi: int) -> "Column":
        """Rows ``[lo, hi)``, unpadded (views; an opaque column's data
        is a view of its object array)."""
        if self.is_opaque:
            return Column(self.dtype, self.data[lo:hi], self.validity[lo:hi])
        return self.map_buffers(lambda t: t[lo:hi])

    def mask_rows(self, live: torch.Tensor) -> "Column":
        """Rows where ``live`` (bool (cap,), or (cap, M) over an element
        layout) is False become padding: invalid, data and lengths
        zeroed, at every depth."""
        zero = lambda t: torch.where(_bcast(live, t), t, torch.zeros((), dtype=t.dtype, device=t.device))
        return Column(
            self.dtype,
            None if self.data is None else zero(self.data),
            self.validity & _bcast(live, self.validity),
            None if self.lengths is None else zero(self.lengths),
            None if self.children is None else tuple(k.mask_rows(live) for k in self.children),
        )


def child_types(dtype: DataType) -> List[DataType]:
    """A nested type's child column types, in ``children`` order."""
    if dtype.kind == TypeKind.ARRAY:
        return [dtype.elem]
    if dtype.kind == TypeKind.MAP:
        return [dtype.key, dtype.value]
    return [f.dtype for f in dtype.struct_fields]


def _reshape_leading(col: Column, cap: int, m: int) -> Column:
    """A flat ``(cap*m, ...)`` column in element layout ``(cap, m, ...)``."""
    return col.map_buffers(lambda t: t.reshape((cap, m) + tuple(t.shape[1:])))


def _flatten_leading(col: Column) -> Column:
    """Inverse of :func:`_reshape_leading`: ``(cap, m, ...)`` -> ``(cap*m, ...)``."""
    return col.map_buffers(lambda t: t.reshape((-1,) + tuple(t.shape[2:])))


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
        """The device of the batch's first device column (the CPU when
        every column is opaque)."""
        for c in self.columns:
            if not c.is_opaque:
                return c.device
        return torch.device("cpu")

    def to(self, device: torch.device) -> "RecordBatch":
        if self.columns and self.device == torch.device(device):
            return self
        return RecordBatch(self.schema, [c.to(device) for c in self.columns], self.num_rows)

    def take(self, idx: torch.Tensor, cap: Optional[int] = None) -> "RecordBatch":
        """Rows ``idx`` re-padded to ``cap`` (default: their bucket)."""
        n = int(idx.shape[0])
        cap = bucket_capacity(n) if cap is None else cap
        # one host copy of the order serves every opaque column
        h = idx.cpu() if any(c.is_opaque for c in self.columns) else None
        return RecordBatch(self.schema, [c.take(idx, cap, h) for c in self.columns], n)


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
    n = len(bs)
    cap = capacity or bucket_capacity(n)
    # the host holds the rows alone; the padding is zeroed on the device
    # (a 0.9 MB bloom filter payload is one row of a 1 MiB-wide column)
    data = np.zeros((n, width), np.uint8)
    lengths = np.zeros(n, np.int32)
    validity = np.zeros(n, np.bool_)
    for i, (v, b) in enumerate(zip(values, bs)):
        if v is None:
            continue
        validity[i] = True
        lengths[i] = len(b)
        data[i, : len(b)] = np.frombuffer(b, np.uint8)
    dev = resolve_device(device)
    return Column(
        dtype,
        pad_rows(torch.from_numpy(data).to(dev), cap),
        pad_rows(torch.from_numpy(validity).to(dev), cap),
        pad_rows(torch.from_numpy(lengths).to(dev), cap),
    )


def column_from_pylist(
    dtype: DataType,
    values: Sequence,
    capacity: Optional[int] = None,
    device: Union[None, str, torch.device] = None,
) -> Column:
    """A column from python values (None = null): strings and
    binaries as str/bytes, decimals as unscaled ints, dates as days
    since the epoch, opaque columns as any objects (kept on the host);
    arrays as lists, maps as dicts (insertion-ordered) and structs as
    dicts keyed by field name."""
    from . import resolve_device

    n = len(values)
    cap = capacity or bucket_capacity(n)
    if dtype.is_nested:
        return _nested_from_pylist(dtype, values, cap, device)
    if dtype.is_string:
        return column_from_strings(values, capacity=cap, dtype=dtype, device=device)
    validity = np.zeros(cap, np.bool_)
    validity[:n] = [v is not None for v in values]
    if dtype.kind == TypeKind.OPAQUE:
        objs = np.empty(cap, dtype=object)
        for i, v in enumerate(values):
            objs[i] = v
        return Column(dtype, objs, torch.from_numpy(validity))
    data = np.zeros(cap, dtype.np_dtype)
    data[:n] = [0 if v is None else v for v in values]
    dev = resolve_device(device)
    return Column(dtype, torch.from_numpy(data).to(dev), torch.from_numpy(validity).to(dev))


def _nested_from_pylist(dtype: DataType, values: Sequence, cap: int, device) -> Column:
    from . import resolve_device

    dev = resolve_device(device)
    n = len(values)
    validity = np.zeros(cap, np.bool_)
    validity[:n] = [v is not None for v in values]
    if dtype.kind == TypeKind.STRUCT:
        kids = tuple(
            column_from_pylist(f.dtype, [None if v is None else v.get(f.name) for v in values], cap, dev)
            for f in dtype.struct_fields)
        return Column(dtype, None, torch.from_numpy(validity).to(dev), None, kids)
    m = dtype.max_elems
    lengths = np.zeros(cap, np.int32)
    flats = [[None] * (cap * m) for _ in child_types(dtype)]
    for i, v in enumerate(values):
        if v is None:
            continue
        items = list(v.items()) if dtype.kind == TypeKind.MAP and isinstance(v, dict) else list(v)
        if len(items) > m:
            raise ValueError(f"{dtype.kind.name.lower()} of {len(items)} elements exceeds max_elems {m}")
        lengths[i] = len(items)
        for j, e in enumerate(items):
            if dtype.kind == TypeKind.MAP:
                flats[0][i * m + j], flats[1][i * m + j] = e
            else:
                flats[0][i * m + j] = e
    kids = tuple(_reshape_leading(column_from_pylist(t, flat, cap * m, dev), cap, m)
                 for t, flat in zip(child_types(dtype), flats))
    return Column(dtype, None, torch.from_numpy(validity).to(dev), torch.from_numpy(lengths).to(dev), kids)


def batch_from_pydict(
    data: Dict[str, Sequence],
    schema: Schema,
    capacity: Optional[int] = None,
    device: Union[None, str, torch.device] = None,
) -> RecordBatch:
    """A batch from python lists (None = null), one per field."""
    n = len(next(iter(data.values()))) if data else 0
    cap = capacity or bucket_capacity(n)
    cols = [column_from_pylist(f.dtype, data[f.name], cap, device) for f in schema.fields]
    return RecordBatch(schema, cols, n)


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

#: copies made by :func:`tensors_to_host`, :meth:`HostCopy.result` and
#: :meth:`HostStaging.to_device` since the last :func:`reset_copy_counts`
COPIES = {"device_to_host": 0, "host_to_device": 0}
_copies_lock = threading.Lock()


def reset_copy_counts() -> None:
    with _copies_lock:
        for k in COPIES:
            COPIES[k] = 0


def count_copy(kind: str) -> None:
    """One more copy of ``kind`` (map tasks count from several threads)."""
    with _copies_lock:
        COPIES[kind] += 1


def _aligned(nbytes: int) -> int:
    """Regions start 8-byte aligned, so any dtype views them."""
    return (nbytes + 7) & ~7


def _pack(tensors: Sequence[torch.Tensor]):
    """The tensors' bytes packed into one buffer on their device, and
    the layout that splits it again."""
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
    return torch.cat(parts), layout


def _unpack(host: np.ndarray, layout) -> List[np.ndarray]:
    out = []
    for o, nbytes, dtype, shape in layout:
        np_dtype = torch.empty((), dtype=dtype).numpy().dtype
        out.append(host[o:o + nbytes].view(np_dtype).reshape(shape))
    return out


def tensors_to_host(tensors: Sequence[torch.Tensor]) -> List[np.ndarray]:
    """The tensors as numpy arrays in ONE device-to-host copy: their
    bytes are packed into one buffer on their device, the buffer is
    copied, and the host copy is split into views."""
    if not tensors:
        return []
    packed, layout = _pack(tensors)
    host = packed.cpu().numpy()
    count_copy("device_to_host")
    return _unpack(host, layout)


_copy_streams = threading.local()


class HostCopy:
    """:func:`tensors_to_host` split in two, for a copy that another
    thread waits for.  The constructor packs the tensors on the caller's
    stream and records an event there; :meth:`result`, on any thread,
    copies the packed buffer into pinned host memory on a stream of its
    thread's own, ordered after the event alone (not after the caller's
    later work), waits for that copy and returns the arrays.  The packed
    buffer is held until its copy has finished."""

    def __init__(self, tensors: Sequence[torch.Tensor]):
        self._event = None
        self._packed, self._layout = _pack(tensors) if tensors else (None, [])
        if self._packed is not None and self._packed.is_cuda:
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(self._packed.device))

    def result(self) -> List[np.ndarray]:
        packed = self._packed
        if packed is None:
            return []  # nothing on a device: every column was opaque
        if self._event is None:
            host = packed.numpy()  # a CPU tensor packs into a host buffer
        else:
            streams = getattr(_copy_streams, "by_device", None)
            if streams is None:
                streams = _copy_streams.by_device = {}
            stream = streams.get(packed.device)
            if stream is None:
                stream = streams[packed.device] = torch.cuda.Stream(packed.device)
            pinned = torch.empty(packed.shape, dtype=torch.uint8, pin_memory=True)
            with torch.cuda.stream(stream):
                stream.wait_event(self._event)
                pinned.copy_(packed, non_blocking=True)
            stream.synchronize()
            host = pinned.numpy()
        self._packed = None
        count_copy("device_to_host")
        return _unpack(host, self._layout)


class HostStaging:
    """Zeroed host arrays allocated in one byte buffer, filled by the
    caller, then moved to a device in ONE host-to-device copy.  With
    ``pinned`` the buffer is page-locked (from torch's caching host
    allocator) and the copy is issued without waiting for it; the
    allocator keeps the buffer until the copy has finished."""

    def __init__(self, pinned: bool = False):
        self._regions: List[Tuple[int, np.dtype, tuple]] = []
        self._size = 0
        self._buf: Optional[np.ndarray] = None
        self._pinned = pinned
        self._host: Optional[torch.Tensor] = None

    def _alloc(self) -> None:
        if self._pinned:
            self._host = torch.zeros(self._size, dtype=torch.uint8, pin_memory=True)
            self._buf = self._host.numpy()
        else:
            self._buf = np.zeros(self._size, np.uint8)

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
            self._alloc()
        off, np_dtype, shape = self._regions[i]
        nbytes = int(np.prod(shape, dtype=np.int64)) * np_dtype.itemsize
        return self._buf[off:off + nbytes].view(np_dtype).reshape(shape)

    def to_device(self, device: torch.device) -> List[torch.Tensor]:
        """Every region as a tensor on ``device``."""
        if self._buf is None:
            self._alloc()
        if self._host is not None:
            dev = self._host.to(device, non_blocking=True)
        else:
            dev = torch.from_numpy(self._buf).to(device)
        count_copy("host_to_device")
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
    if col.dtype.is_nested:
        return _nested_to_pylist(col, num_rows, validity)
    if col.is_opaque:
        return [col.data[i] if validity[i] else None for i in range(num_rows)]
    data = col.data[:num_rows].cpu().numpy()
    if col.dtype.is_string:
        lengths = col.lengths[:num_rows].cpu().numpy()
        raw = [bytes(data[i, : lengths[i]]) if validity[i] else None for i in range(num_rows)]
        if col.dtype.kind == TypeKind.BINARY:
            return raw
        return [None if b is None else b.decode("utf-8", errors="replace") for b in raw]
    conv = bool if col.dtype.kind == TypeKind.BOOL else float if col.dtype.is_float else int
    return [conv(data[i]) if validity[i] else None for i in range(num_rows)]


def _nested_to_pylist(col: Column, num_rows: int, validity: np.ndarray) -> List:
    dtype = col.dtype
    if dtype.kind == TypeKind.STRUCT:
        kids = [column_to_pylist(k, num_rows) for k in col.children]
        return [{f.name: kids[j][i] for j, f in enumerate(dtype.struct_fields)} if validity[i] else None
                for i in range(num_rows)]
    m = dtype.max_elems
    lengths = col.lengths[:num_rows].cpu().numpy()
    kids = [column_to_pylist(_flatten_leading(k.head(num_rows)), num_rows * m) for k in col.children]
    out: List = []
    for i in range(num_rows):
        if not validity[i]:
            out.append(None)
        elif dtype.kind == TypeKind.MAP:
            out.append({kids[0][i * m + j]: kids[1][i * m + j] for j in range(int(lengths[i]))})
        else:
            out.append(kids[0][i * m:i * m + int(lengths[i])])
    return out


def batch_to_pydict(batch: RecordBatch) -> Dict[str, List]:
    """Materialize a batch on the host as python values."""
    return {
        f.name: column_to_pylist(c, batch.num_rows)
        for f, c in zip(batch.schema.fields, batch.columns)
    }


# ------------------------------------------------------------- reshape


def concat_columns(parts: Sequence[Column], cap: int) -> Column:
    """Row-concatenate live column prefixes (given by ``Column.head``)
    into one column padded to ``cap``; string widths (at any depth)
    merge to the widest part."""
    dtype = parts[0].dtype
    if dtype.kind == TypeKind.OPAQUE:
        return Column(dtype, pad_objects(np.concatenate([p.data for p in parts]), cap),
                      pad_rows(torch.cat([p.validity for p in parts]), cap))
    cat = lambda ts: pad_rows(torch.cat(ts), cap)
    lengths = None if parts[0].lengths is None else cat([p.lengths for p in parts])
    if dtype.is_nested:
        kids = tuple(concat_columns([p.children[i] for p in parts], cap)
                     for i in range(len(parts[0].children)))
        return Column(dtype, None, cat([p.validity for p in parts]), lengths, kids)
    if dtype.is_string:
        w = max(p.data.shape[-1] for p in parts)
        data = cat([p.data if p.data.shape[-1] == w
                    else torch.nn.functional.pad(p.data, (0, w - p.data.shape[-1])) for p in parts])
    else:
        data = cat([p.data for p in parts])
    return Column(dtype, data, cat([p.validity for p in parts]), lengths)


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
    return RecordBatch(batch.schema, [c.rows(lo, lo + n).pad(cap) for c in batch.columns], n)
