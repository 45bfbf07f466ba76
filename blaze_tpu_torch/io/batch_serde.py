"""Columnar batch (de)serialization, the shuffle and broadcast wire
format (≙ ``blaze_tpu/io/batch_serde.py``, flat columns).

Layout per batch (little-endian)::

    u32 num_rows
    per column, in schema order:
      u8 tag (0 = fixed width, 1 = string)
      u32 data_nbytes | data buffer, trimmed to num_rows
      [u32 width]     | strings only: the padded byte width W
      bitmap          | validity, ceil(rows / 8) bytes, little bit order
      [lengths]       | strings only: rows x i32

Padding never crosses the wire.  On read, rows are re-bucketed to a
power-of-two capacity with zeroed padding on the target device, in one
host-to-device copy.  Nested columns (tag 2) and opaque columns (tag 3)
wait for the port's nested batch model and raise.
"""

from __future__ import annotations

import struct
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..batch import Column, HostStaging, RecordBatch, bucket_capacity, tensors_to_host
from ..schema import Schema

#: one column on the host: (data, validity, lengths or None), live rows only
HostColumn = Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]


def host_columns(batch: RecordBatch, extra: Sequence[torch.Tensor] = ()) -> Tuple[List[HostColumn], List[np.ndarray]]:
    """The batch's live rows on the host, and ``extra`` tensors beside
    them, in one device-to-host copy."""
    n = batch.num_rows
    tensors = []
    for c in batch.columns:
        tensors += [c.data[:n], c.validity[:n]] + ([] if c.lengths is None else [c.lengths[:n]])
    host = tensors_to_host(tensors + list(extra))
    cols, i = [], 0
    for c in batch.columns:
        if c.lengths is None:
            cols.append((host[i], host[i + 1], None))
            i += 2
        else:
            cols.append((host[i], host[i + 1], host[i + 2]))
            i += 3
    return cols, host[i:]


def serialize_columns(cols: Sequence[HostColumn], n: int) -> bytes:
    """One batch of ``n`` rows from host columns (live rows first)."""
    out: List[bytes] = [struct.pack("<I", n)]
    for data, validity, lengths in cols:
        bitmap = np.packbits(validity[:n].astype(np.bool_), bitorder="little").tobytes()
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
        if tag not in (0, 1):
            raise NotImplementedError(
                f"column {f.name!r}: wire tag {tag} (nested or opaque) is not ported")
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
                  device: torch.device) -> RecordBatch:
    """The rows of every part, in order, as one batch on ``device``:
    padded to its capacity bucket with zeroed padding, string widths
    merged to the widest part, in one host-to-device copy."""
    n = sum(k for k, _ in parts)
    cap = bucket_capacity(max(n, 1))
    staging = HostStaging()
    slots = []
    for i, f in enumerate(schema.fields):
        if f.dtype.is_string:
            w = max(cols[i][0].shape[1] for _, cols in parts)
            slots.append((staging.region((cap, w), np.uint8), staging.region((cap,), np.bool_),
                          staging.region((cap,), np.int32)))
        else:
            slots.append((staging.region((cap,), f.dtype.np_dtype), staging.region((cap,), np.bool_),
                          None))
    for i, regions in enumerate(slots):
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
    for f, regions in zip(schema.fields, slots):
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
