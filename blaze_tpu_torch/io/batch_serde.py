"""Columnar batch (de)serialization, the shuffle and broadcast wire
format (≙ ``blaze_tpu/io/batch_serde.py``, byte for byte).

Layout per batch (little-endian)::

    u32 num_rows
    per column, in schema order (recursive):
      flat:   u8 tag (0 = fixed width, 1 = string, 3 = opaque)
              u32 data_nbytes | data buffer, trimmed to num_rows (opaque:
                              | the pickle of the rows' objects, None
                              | where null)
              [u32 width]     | strings only: the padded byte width W
              bitmap          | validity, ceil(rows / 8) bytes, little bit order
              [lengths]       | strings only: rows x i32
      nested: u8 tag (2)
              bitmap          | row validity
              [counts]        | ARRAY/MAP: rows x i32 element counts
              children        | recursively; an ARRAY/MAP's children
                              | flattened to rows x M rows

Padding never crosses the wire.  On read, rows are re-bucketed to a
power-of-two capacity with zeroed padding on the target device, in one
host-to-device copy, nested columns included; opaque columns stay on
the host.  Decoding an opaque column runs pickle, so
``spark.blaze.udf.allowPickled`` gates it.
"""

from __future__ import annotations

import pickle
import struct
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import conf
from ..batch import (
    Column, HostStaging, RecordBatch, bucket_capacity, child_types, pad_objects, pad_rows, tensors_to_host,
)
from ..schema import DataType, Schema, TypeKind


@dataclass
class HostNested:
    """A nested column on the host: row validity, element counts (None
    for a STRUCT) and the children, each a host column whose arrays
    lead with the same row axis (an ARRAY/MAP's with ``(rows, M)``)."""

    validity: np.ndarray
    lengths: Optional[np.ndarray]
    kids: list


#: one column on the host, live rows only: (data, validity, lengths or
#: None), an opaque column's data an object array; or a HostNested
HostColumn = Union[Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]], HostNested]


def host_column(c: Column) -> HostColumn:
    """A column on the CPU as a host column (views of its tensors)."""
    if c.dtype.is_nested:
        return HostNested(c.validity.numpy(), None if c.lengths is None else c.lengths.numpy(),
                          [host_column(k) for k in c.children])
    return (c.data.numpy(), c.validity.numpy(), None if c.lengths is None else c.lengths.numpy())


def host_rows(c: HostColumn, lo: int, hi: int) -> HostColumn:
    """Rows ``[lo, hi)`` of a host column (views)."""
    if isinstance(c, HostNested):
        return HostNested(c.validity[lo:hi], None if c.lengths is None else c.lengths[lo:hi],
                          [host_rows(k, lo, hi) for k in c.kids])
    return tuple(None if a is None else a[lo:hi] for a in c)


def concat_host_columns(parts: Sequence[Sequence[HostColumn]]) -> List[HostColumn]:
    """Row-concatenate the columns of several host row blocks; string
    widths (at any depth) merge to the widest block."""
    if len(parts) == 1:
        return list(parts[0])
    return [_concat_host([cols[i] for cols in parts]) for i in range(len(parts[0]))]


def _concat_host(cs: Sequence[HostColumn]) -> HostColumn:
    cat = lambda arrs: None if arrs[0] is None else np.concatenate(arrs)
    if isinstance(cs[0], HostNested):
        return HostNested(cat([c.validity for c in cs]), cat([c.lengths for c in cs]),
                          [_concat_host([c.kids[i] for c in cs]) for i in range(len(cs[0].kids))])
    datas = [c[0] for c in cs]
    if datas[0].dtype != object and datas[0].ndim >= 2 and cs[0][2] is not None:
        w = max(d.shape[-1] for d in datas)
        datas = [d if d.shape[-1] == w else np.pad(d, [(0, 0)] * (d.ndim - 1) + [(0, w - d.shape[-1])])
                 for d in datas]
    return (np.concatenate(datas), cat([c[1] for c in cs]), cat([c[2] for c in cs]))


def _flatten_host(c: HostColumn) -> HostColumn:
    """An element-layout host column ``(n, M, ...)`` as ``(n*M, ...)``."""
    fl = lambda a: None if a is None else a.reshape((-1,) + a.shape[2:])
    if isinstance(c, HostNested):
        return HostNested(fl(c.validity), fl(c.lengths), [_flatten_host(k) for k in c.kids])
    return tuple(fl(a) for a in c)


def _reshape_host(c: HostColumn, n: int, m: int) -> HostColumn:
    rs = lambda a: None if a is None else a.reshape((n, m) + a.shape[1:])
    if isinstance(c, HostNested):
        return HostNested(rs(c.validity), rs(c.lengths), [_reshape_host(k, n, m) for k in c.kids])
    return tuple(rs(a) for a in c)


def _col_tensors(c: Column, cut) -> List[torch.Tensor]:
    if c.dtype.is_nested:
        out = [cut(c.validity)] + ([] if c.lengths is None else [cut(c.lengths)])
        for k in c.children:
            out += _col_tensors(k, cut)
        return out
    return [cut(c.data), cut(c.validity)] + ([] if c.lengths is None else [cut(c.lengths)])


def column_tensors(cols: Sequence[Column], n: Optional[int] = None) -> List[torch.Tensor]:
    """Each device column's buffers (data, validity, lengths; a nested
    column's validity, counts and then its children's), cut to ``n``
    rows (all rows when None): the tensors of one host copy.  Opaque
    columns are already on the host and take no part
    (:func:`column_layout` carries them)."""
    cut = (lambda t: t) if n is None else (lambda t: t[:n])
    out: List[torch.Tensor] = []
    for c in cols:
        if not c.is_opaque:
            out += _col_tensors(c, cut)
    return out


def _layout(c: Column):
    if c.dtype.is_nested:
        return ("nested", c.lengths is not None, [_layout(k) for k in c.children])
    return c.lengths is not None


def column_layout(cols: Sequence[Column], n: Optional[int] = None) -> list:
    """What :func:`split_host_columns` needs to rebuild the columns
    from :func:`column_tensors`' host copy: per column, whether it has
    lengths (a nested column: its children's layouts), or an opaque
    column's host rows (cut to ``n``)."""
    cut = slice(None) if n is None else slice(0, n)
    return [(c.data[cut], c.validity[cut].numpy(), None) if c.is_opaque else _layout(c) for c in cols]


def _split(host: Sequence[np.ndarray], i: int, layout) -> Tuple[HostColumn, int]:
    if isinstance(layout, tuple) and isinstance(layout[0], str):  # ("nested", has lengths, kids)
        validity, i = host[i], i + 1
        lengths = None
        if layout[1]:
            lengths, i = host[i], i + 1
        kids = []
        for kl in layout[2]:
            k, i = _split(host, i, kl)
            kids.append(k)
        return HostNested(validity, lengths, kids), i
    if isinstance(layout, tuple):
        return layout, i  # an opaque column, on the host already
    if layout:
        return (host[i], host[i + 1], host[i + 2]), i + 3
    return (host[i], host[i + 1], None), i + 2


def split_host_columns(host: Sequence[np.ndarray], layout: Sequence
                       ) -> Tuple[List[HostColumn], List[np.ndarray]]:
    """The host arrays of :func:`column_tensors` (and any after them)
    as host columns, in the order of ``layout`` (:func:`column_layout`),
    and the arrays after them."""
    cols, i = [], 0
    for lay in layout:
        c, i = _split(host, i, lay)
        cols.append(c)
    return cols, list(host[i:])


def host_columns(batch: RecordBatch, extra: Sequence[torch.Tensor] = ()) -> Tuple[List[HostColumn], List[np.ndarray]]:
    """The batch's live rows on the host, and ``extra`` tensors beside
    them, in one device-to-host copy."""
    host = tensors_to_host(column_tensors(batch.columns, batch.num_rows) + list(extra))
    return split_host_columns(host, column_layout(batch.columns, batch.num_rows))


def _ser(out: List[bytes], c: HostColumn, n: int) -> None:
    if isinstance(c, HostNested):
        out += [struct.pack("<B", 2), np.packbits(c.validity[:n].astype(np.bool_), bitorder="little").tobytes()]
        if c.lengths is None:
            for k in c.kids:
                _ser(out, k, n)
            return
        out.append(np.ascontiguousarray(c.lengths[:n], np.int32).tobytes())
        for k in c.kids:
            m = k.validity.shape[1] if isinstance(k, HostNested) else k[1].shape[1]
            _ser(out, _flatten_host(host_rows(k, 0, n)), n * m)
        return
    data, validity, lengths = c
    bitmap = np.packbits(validity[:n].astype(np.bool_), bitorder="little").tobytes()
    if data.dtype == object:
        payload = pickle.dumps([data[i] if validity[i] else None for i in range(n)])
        out += [struct.pack("<BI", 3, len(payload)), payload, bitmap]
        return
    raw = np.ascontiguousarray(data[:n]).tobytes()
    if lengths is not None:
        out.append(struct.pack("<BII", 1, len(raw), data.shape[-1]))
        out += [raw, bitmap, np.ascontiguousarray(lengths[:n], np.int32).tobytes()]
    else:
        out += [struct.pack("<BI", 0, len(raw)), raw, bitmap]


def serialize_columns(cols: Sequence[HostColumn], n: int) -> bytes:
    """One batch of ``n`` rows from host columns (live rows first)."""
    out: List[bytes] = [struct.pack("<I", n)]
    for c in cols:
        _ser(out, c, n)
    return b"".join(out)


def serialize_batch(batch: RecordBatch) -> bytes:
    """The wire bytes of a batch's live rows (one device-to-host copy
    when the batch is on a card)."""
    return serialize_columns(host_columns(batch)[0], batch.num_rows)


def _bitmap(data: bytes, off: int, n: int) -> Tuple[np.ndarray, int]:
    vbytes = (n + 7) // 8
    bits = np.unpackbits(np.frombuffer(data, np.uint8, count=vbytes, offset=off), bitorder="little")
    return bits[:n].astype(np.bool_), off + vbytes


def _de(name: str, dtype: DataType, data: bytes, off: int, n: int) -> Tuple[HostColumn, int]:
    """One column of exactly ``n`` rows at ``off``."""
    (tag,) = struct.unpack_from("<B", data, off)
    off += 1
    if tag == 2:
        if not dtype.is_nested:
            raise ValueError(f"column {name!r}: wire tag 2 for non-nested {dtype!r}")
        validity, off = _bitmap(data, off, n)
        if dtype.kind == TypeKind.STRUCT:
            kids = []
            for f, kt in zip(dtype.struct_fields, child_types(dtype)):
                k, off = _de(f"{name}.{f.name}", kt, data, off, n)
                kids.append(k)
            return HostNested(validity, None, kids), off
        lengths = np.frombuffer(data, np.int32, count=n, offset=off)
        off += 4 * n
        m = dtype.max_elems
        kids = []
        for kt in child_types(dtype):
            k, off = _de(name, kt, data, off, n * m)
            kids.append(_reshape_host(k, n, m))
        return HostNested(validity, lengths, kids), off
    if tag == 3:
        if dtype.kind != TypeKind.OPAQUE:
            raise ValueError(f"column {name!r}: wire tag 3 for {dtype!r}")
        (nbytes,) = struct.unpack_from("<I", data, off)
        off += 4
        if not bool(conf.ALLOW_PICKLED_UDFS.get()):
            raise PermissionError("opaque column deserialization requires spark.blaze.udf.allowPickled")
        objs = np.empty(n, dtype=object)
        objs[:] = pickle.loads(data[off:off + nbytes]) if n else []
        off += nbytes
        validity, off = _bitmap(data, off, n)
        return (objs, validity, None), off
    if tag not in (0, 1):
        raise ValueError(f"column {name!r}: unknown wire tag {tag}")
    if dtype.is_nested or (tag == 1) != dtype.is_string:
        raise ValueError(f"column {name!r}: wire tag {tag} for {dtype!r}")
    (nbytes,) = struct.unpack_from("<I", data, off)
    off += 4
    if tag == 1:
        (width,) = struct.unpack_from("<I", data, off)
        off += 4
        if nbytes != n * width:
            raise ValueError(f"column {name!r}: {nbytes} bytes for {n} rows of width {width}")
        raw = np.frombuffer(data, np.uint8, count=nbytes, offset=off).reshape(n, width)
        off += nbytes
        validity, off = _bitmap(data, off, n)
        lengths = np.frombuffer(data, np.int32, count=n, offset=off)
        return (raw, validity, lengths), off + 4 * n
    dt = dtype.np_dtype
    if nbytes != n * dt.itemsize:
        raise ValueError(f"column {name!r}: {nbytes} bytes for {n} rows of {dtype!r}")
    raw = np.frombuffer(data, dt, count=n, offset=off)
    validity, off = _bitmap(data, off + nbytes, n)
    return (raw, validity, None), off


def decode_columns(data: bytes, schema: Schema) -> Tuple[int, List[HostColumn]]:
    """``(num_rows, host columns)`` of one serialized batch (views of
    ``data``, exactly ``num_rows`` rows)."""
    (n,) = struct.unpack_from("<I", data, 0)
    off = 4
    cols: List[HostColumn] = []
    for f in schema.fields:
        c, off = _de(f.name, f.dtype, data, off, n)
        cols.append(c)
    return n, cols


def _plan_regions(staging: HostStaging, dtype: DataType, cols: Sequence[HostColumn], lead: tuple):
    """Reserve the staging regions of one column (``cols``: its host
    blocks in order) with leading shape ``lead``: (validity, data,
    lengths, children plans) as region indexes."""
    if dtype.is_nested:
        inner = lead if dtype.kind == TypeKind.STRUCT else lead + (dtype.max_elems,)
        return (staging.region(lead, np.bool_), None,
                None if dtype.kind == TypeKind.STRUCT else staging.region(lead, np.int32),
                [_plan_regions(staging, kt, [c.kids[i] for c in cols], inner)
                 for i, kt in enumerate(child_types(dtype))])
    if dtype.is_string:
        w = max(c[0].shape[-1] for c in cols)
        return (staging.region(lead, np.bool_), staging.region(lead + (w,), np.uint8),
                staging.region(lead, np.int32), None)
    return staging.region(lead, np.bool_), staging.region(lead, dtype.np_dtype), None, None


def _fill(staging: HostStaging, plan, c: HostColumn, lo: int, k: int) -> None:
    v, d, ln, kids = plan
    if isinstance(c, HostNested):
        srcs = [(v, c.validity), (ln, c.lengths)]
        for kp, kc in zip(kids, c.kids):
            _fill(staging, kp, kc, lo, k)
    else:
        srcs = [(d, c[0]), (v, c[1]), (ln, c[2])]
    for r, src in srcs:
        if r is not None:
            dst = staging.array(r)
            if dst.dtype == np.uint8 and src.shape[-1] != dst.shape[-1]:
                dst[lo:lo + k, ..., :src.shape[-1]] = src
            else:
                dst[lo:lo + k] = src


def _build(dtype: DataType, plan, tensors: List[torch.Tensor]) -> Column:
    v, d, ln, kids = plan
    return Column(dtype, None if d is None else tensors[d], tensors[v], None if ln is None else tensors[ln],
                  None if kids is None else tuple(_build(kt, kp, tensors)
                                                  for kt, kp in zip(child_types(dtype), kids)))


def stage_columns(schema: Schema, parts: Sequence[Tuple[int, Sequence[HostColumn]]],
                  device: torch.device, pinned: bool = False) -> RecordBatch:
    """The rows of every part, in order, as one batch on ``device``:
    padded to its capacity bucket with zeroed padding, string widths
    merged to the widest part (at any depth), in one host-to-device
    copy (from a page-locked buffer with ``pinned``).  Opaque columns
    stay on the host."""
    n = sum(k for k, _ in parts)
    cap = bucket_capacity(max(n, 1))
    staging = HostStaging(pinned)
    plans = [None if f.dtype.kind == TypeKind.OPAQUE
             else _plan_regions(staging, f.dtype, [cols[i] for _, cols in parts], (cap,))
             for i, f in enumerate(schema.fields)]
    for i, plan in enumerate(plans):
        if plan is None:
            continue
        lo = 0
        for k, cols in parts:
            _fill(staging, plan, cols[i], lo, k)
            lo += k
    tensors = staging.to_device(device)
    cols = []
    for i, (f, plan) in enumerate(zip(schema.fields, plans)):
        if plan is None:
            objs = np.concatenate([pc[i][0] for _, pc in parts])
            valid = torch.from_numpy(np.concatenate([pc[i][1] for _, pc in parts]).astype(np.bool_))
            cols.append(Column(f.dtype, pad_objects(objs, cap), pad_rows(valid, cap)))
        else:
            cols.append(_build(f.dtype, plan, tensors))
    return RecordBatch(schema, cols, n)


def deserialize_batch(data: bytes, schema: Schema,
                      device: Union[None, str, torch.device] = None) -> RecordBatch:
    """One serialized batch on ``device`` (the package default when
    None), re-bucketed with zeroed padding."""
    from .. import resolve_device

    return stage_columns(schema, [decode_columns(data, schema)], resolve_device(device))
