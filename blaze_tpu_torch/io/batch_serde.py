"""Columnar batch (de)serialization, the shuffle and broadcast wire
format (≙ ``blaze_tpu/io/batch_serde.py``, flat columns).

Layout per batch (little-endian)::

    u32 num_rows
    per column, in schema order:
      u8 tag (0 = fixed width, 1 = string, 3 = opaque)
      u32 data_nbytes | data buffer, trimmed to num_rows (opaque: the
                      | pickle of the rows' objects, None where null)
      [u32 width]     | strings only: the padded byte width W
      bitmap          | validity, ceil(rows / 8) bytes, little bit order
      [lengths]       | strings only: rows x i32

Padding never crosses the wire.  On read, rows are re-bucketed to a
power-of-two capacity with zeroed padding on the target device, in one
host-to-device copy; opaque columns stay on the host.  Decoding an
opaque column runs pickle, so ``spark.blaze.udf.allowPickled`` gates
it.  Nested columns (tag 2) wait for the port's nested batch model and
raise.
"""

from __future__ import annotations

import pickle
import struct
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import conf
from ..batch import Column, HostStaging, RecordBatch, bucket_capacity, pad_objects, pad_rows, tensors_to_host
from ..schema import Schema, TypeKind

#: one column on the host: (data, validity, lengths or None), live rows
#: only; an opaque column's data is an object array
HostColumn = Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]


def column_tensors(cols: Sequence[Column], n: Optional[int] = None) -> List[torch.Tensor]:
    """Each device column's data, validity (and lengths), cut to ``n``
    rows (all rows when None): the tensors of one host copy.  Opaque
    columns are already on the host and take no part
    (:func:`column_layout` carries them)."""
    cut = (lambda t: t) if n is None else (lambda t: t[:n])
    out: List[torch.Tensor] = []
    for c in cols:
        if c.is_opaque:
            continue
        out += [cut(c.data), cut(c.validity)] + ([] if c.lengths is None else [cut(c.lengths)])
    return out


def column_layout(cols: Sequence[Column], n: Optional[int] = None) -> list:
    """What :func:`split_host_columns` needs to rebuild the columns
    from :func:`column_tensors`' host copy: per column, whether it has
    lengths, or an opaque column's host rows (cut to ``n``)."""
    cut = slice(None) if n is None else slice(0, n)
    return [(c.data[cut], c.validity[cut].numpy(), None) if c.is_opaque else c.lengths is not None
            for c in cols]


def split_host_columns(host: Sequence[np.ndarray], layout: Sequence
                       ) -> Tuple[List[HostColumn], List[np.ndarray]]:
    """The host arrays of :func:`column_tensors` (and any after them)
    as host columns, in the order of ``layout`` (:func:`column_layout`;
    a plain bool per column when none is opaque), and the arrays after
    them."""
    cols, i = [], 0
    for lengths in layout:
        if isinstance(lengths, tuple):
            cols.append(lengths)  # an opaque column, on the host already
        elif lengths:
            cols.append((host[i], host[i + 1], host[i + 2]))
            i += 3
        else:
            cols.append((host[i], host[i + 1], None))
            i += 2
    return cols, list(host[i:])


def host_columns(batch: RecordBatch, extra: Sequence[torch.Tensor] = ()) -> Tuple[List[HostColumn], List[np.ndarray]]:
    """The batch's live rows on the host, and ``extra`` tensors beside
    them, in one device-to-host copy."""
    host = tensors_to_host(column_tensors(batch.columns, batch.num_rows) + list(extra))
    return split_host_columns(host, column_layout(batch.columns, batch.num_rows))


def serialize_columns(cols: Sequence[HostColumn], n: int) -> bytes:
    """One batch of ``n`` rows from host columns (live rows first)."""
    out: List[bytes] = [struct.pack("<I", n)]
    for data, validity, lengths in cols:
        bitmap = np.packbits(validity[:n].astype(np.bool_), bitorder="little").tobytes()
        if data.dtype == object:
            payload = pickle.dumps([data[i] if validity[i] else None for i in range(n)])
            out += [struct.pack("<BI", 3, len(payload)), payload, bitmap]
            continue
        raw = np.ascontiguousarray(data[:n]).tobytes()
        if lengths is not None:
            out.append(struct.pack("<BII", 1, len(raw), data.shape[1]))
            out += [raw, bitmap, np.ascontiguousarray(lengths[:n], np.int32).tobytes()]
        else:
            out += [struct.pack("<BI", 0, len(raw)), raw, bitmap]
    return b"".join(out)


def serialize_batch(batch: RecordBatch) -> bytes:
    """The wire bytes of a batch's live rows (one device-to-host copy
    when the batch is on a card)."""
    return serialize_columns(host_columns(batch)[0], batch.num_rows)


def _bitmap(data: bytes, off: int, n: int) -> Tuple[np.ndarray, int]:
    vbytes = (n + 7) // 8
    bits = np.unpackbits(np.frombuffer(data, np.uint8, count=vbytes, offset=off), bitorder="little")
    return bits[:n].astype(np.bool_), off + vbytes


def decode_columns(data: bytes, schema: Schema) -> Tuple[int, List[HostColumn]]:
    """``(num_rows, host columns)`` of one serialized batch (views of
    ``data``, exactly ``num_rows`` rows)."""
    (n,) = struct.unpack_from("<I", data, 0)
    off = 4
    cols: List[HostColumn] = []
    for f in schema.fields:
        (tag,) = struct.unpack_from("<B", data, off)
        off += 1
        if tag == 2:
            raise NotImplementedError(
                f"column {f.name!r}: wire tag 2 (nested) waits for nested columns in the port")
        if tag == 3:
            if f.dtype.kind != TypeKind.OPAQUE:
                raise ValueError(f"column {f.name!r}: wire tag 3 for {f.dtype!r}")
            (nbytes,) = struct.unpack_from("<I", data, off)
            off += 4
            if not bool(conf.ALLOW_PICKLED_UDFS.get()):
                raise PermissionError("opaque column deserialization requires spark.blaze.udf.allowPickled")
            objs = np.empty(n, dtype=object)
            objs[:] = pickle.loads(data[off:off + nbytes]) if n else []
            off += nbytes
            validity, off = _bitmap(data, off, n)
            cols.append((objs, validity, None))
            continue
        if tag not in (0, 1):
            raise ValueError(f"column {f.name!r}: unknown wire tag {tag}")
        if (tag == 1) != f.dtype.is_string:
            raise ValueError(f"column {f.name!r}: wire tag {tag} for {f.dtype!r}")
        (nbytes,) = struct.unpack_from("<I", data, off)
        off += 4
        if tag == 1:
            (width,) = struct.unpack_from("<I", data, off)
            off += 4
            if nbytes != n * width:
                raise ValueError(f"column {f.name!r}: {nbytes} bytes for {n} rows of width {width}")
            raw = np.frombuffer(data, np.uint8, count=nbytes, offset=off).reshape(n, width)
            off += nbytes
            validity, off = _bitmap(data, off, n)
            lengths = np.frombuffer(data, np.int32, count=n, offset=off)
            off += 4 * n
            cols.append((raw, validity, lengths))
            continue
        dt = f.dtype.np_dtype
        if nbytes != n * dt.itemsize:
            raise ValueError(f"column {f.name!r}: {nbytes} bytes for {n} rows of {f.dtype!r}")
        raw = np.frombuffer(data, dt, count=n, offset=off)
        off += nbytes
        validity, off = _bitmap(data, off, n)
        cols.append((raw, validity, None))
    return n, cols


def stage_columns(schema: Schema, parts: Sequence[Tuple[int, Sequence[HostColumn]]],
                  device: torch.device, pinned: bool = False) -> RecordBatch:
    """The rows of every part, in order, as one batch on ``device``:
    padded to its capacity bucket with zeroed padding, string widths
    merged to the widest part, in one host-to-device copy (from a
    page-locked buffer with ``pinned``).  Opaque columns stay on the
    host."""
    n = sum(k for k, _ in parts)
    cap = bucket_capacity(max(n, 1))
    staging = HostStaging(pinned)
    slots = []
    for i, f in enumerate(schema.fields):
        if f.dtype.kind == TypeKind.OPAQUE:
            slots.append(None)
        elif f.dtype.is_string:
            w = max(cols[i][0].shape[1] for _, cols in parts)
            slots.append((staging.region((cap, w), np.uint8), staging.region((cap,), np.bool_),
                          staging.region((cap,), np.int32)))
        else:
            slots.append((staging.region((cap,), f.dtype.np_dtype), staging.region((cap,), np.bool_),
                          None))
    for i, regions in enumerate(slots):
        if regions is None:
            continue
        lo = 0
        for k, cols in parts:
            for r, src in zip(regions, cols[i]):
                if r is not None:
                    dst = staging.array(r)
                    if src.ndim == 2:
                        dst[lo:lo + k, :src.shape[1]] = src
                    else:
                        dst[lo:lo + k] = src
            lo += k
    tensors = iter(staging.to_device(device))
    cols = []
    for i, (f, regions) in enumerate(zip(schema.fields, slots)):
        if regions is None:
            objs = np.concatenate([pc[i][0] for _, pc in parts])
            valid = torch.from_numpy(np.concatenate([pc[i][1] for _, pc in parts]).astype(np.bool_))
            cols.append(Column(f.dtype, pad_objects(objs, cap), pad_rows(valid, cap)))
            continue
        data, validity = next(tensors), next(tensors)
        lengths = next(tensors) if regions[2] is not None else None
        cols.append(Column(f.dtype, data, validity, lengths))
    return RecordBatch(schema, cols, n)


def deserialize_batch(data: bytes, schema: Schema,
                      device: Union[None, str, torch.device] = None) -> RecordBatch:
    """One serialized batch on ``device`` (the package default when
    None), re-bucketed with zeroed padding."""
    from .. import resolve_device

    return stage_columns(schema, [decode_columns(data, schema)], resolve_device(device))
