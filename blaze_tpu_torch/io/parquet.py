"""Self-contained Parquet subset writer/reader (the port's own copy of
``blaze_tpu/io/parquet.py``; numpy only, no pyarrow).

- written files: PAR1 magic, one DATA_PAGE v1 per column chunk per row
  group, PLAIN encoding, RLE definition levels (every column is written
  OPTIONAL), UNCOMPRESSED / GZIP / SNAPPY (Spark's default, pure-python
  LZ77) / ZSTD (``io/zstd.py``) / LZ4_RAW pages, thrift-compact FileMetaData with min/max
  statistics per chunk.
- reader: dictionary pages, v1 and v2 data pages, PLAIN and dictionary
  encodings, REQUIRED and OPTIONAL columns, FLBA decimals, INT96
  timestamps; pages in any of the writer's codecs and in Hadoop-framed
  LZ4.  Row groups are pruned with the pushed-down predicate over chunk
  statistics (``ops/parquet_scan.py``).
- ZSTD pages go through the port's own zstd codec both ways (the
  card's machine has no ``zstandard``): a page from any zstd writer
  reads, a page the port writes reads with ``zstandard``.

The reference's per-value loops over strings, definition levels,
FLBA and INT96 values are numpy here, with byte-for-byte the same
files and arrays (``tests/test_torch_parquet.py``).

Physical mapping: BOOLEAN (bit-packed) <- bool; INT32 <- int8/16/32 +
DATE; INT64 <- int64/timestamp/decimal [ConvertedType DECIMAL];
FLOAT/DOUBLE; BYTE_ARRAY(UTF8) <- string.
"""

from __future__ import annotations

import gzip
import os
import struct
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..schema import DataType, Schema, TypeKind
from .ipc_compression import lz4_block_compress, lz4_block_decompress
from .zstd import compress as zstd_compress
from .zstd import decompress as zstd_decompress
from .thrift_compact import (
    CT_BINARY, CT_I32, CT_I64, CT_STRUCT, CompactReader, CompactWriter,
)

MAGIC = b"PAR1"

# parquet physical types
T_BOOLEAN, T_INT32, T_INT64, T_INT96, T_FLOAT, T_DOUBLE, T_BYTE_ARRAY, T_FLBA = range(8)
# converted types
CONV_UTF8, CONV_DECIMAL, CONV_DATE, CONV_TS_MICROS = 0, 5, 6, 10
# codecs (parquet CompressionCodec enum)
CODEC_UNCOMPRESSED, CODEC_SNAPPY, CODEC_GZIP = 0, 1, 2
CODEC_LZO, CODEC_BROTLI, CODEC_LZ4, CODEC_ZSTD, CODEC_LZ4_RAW = 3, 4, 5, 6, 7
# page types
PAGE_DATA, PAGE_INDEX, PAGE_DICT, PAGE_DATA_V2 = 0, 1, 2, 3
# encodings
ENC_PLAIN, ENC_PLAIN_DICT, ENC_RLE, ENC_RLE_DICT = 0, 2, 3, 8


def _snappy_decompress(src: bytes) -> bytes:
    """Pure-python snappy raw-block decode (no external lib in image)."""
    # uvarint: uncompressed length
    pos = 0
    total = 0
    shift = 0
    while True:
        b = src[pos]
        pos += 1
        total |= (b & 0x7F) << shift
        if not (b & 0x80):
            break
        shift += 7
    out = bytearray()
    n = len(src)
    while pos < n:
        tag = src[pos]
        pos += 1
        t = tag & 3
        if t == 0:  # literal
            ln = (tag >> 2) + 1
            if ln > 60:
                extra = ln - 60
                ln = int.from_bytes(src[pos : pos + extra], "little") + 1
                pos += extra
            out += src[pos : pos + ln]
            pos += ln
            continue
        if t == 1:
            ln = ((tag >> 2) & 7) + 4
            off = ((tag >> 5) << 8) | src[pos]
            pos += 1
        elif t == 2:
            ln = (tag >> 2) + 1
            off = int.from_bytes(src[pos : pos + 2], "little")
            pos += 2
        else:
            ln = (tag >> 2) + 1
            off = int.from_bytes(src[pos : pos + 4], "little")
            pos += 4
        start = len(out) - off
        if off >= ln:
            out += out[start : start + ln]
        else:  # overlapping copy
            for i in range(ln):
                out.append(out[start + i])
    if len(out) != total:
        raise ValueError(f"snappy: decoded {len(out)} bytes, expected {total}")
    return bytes(out)


def _snappy_compress(src: bytes) -> bytes:
    """Pure-python snappy raw-block encode: greedy LZ77 over a 4-byte
    hash table, the inverse of _snappy_decompress (differential-tested
    against it and against the ORC C++ reader via pyarrow).  Callers
    pass bounded chunks (ORC framing: 64 KiB, parquet pages ~1 MiB), so
    2-byte literal lengths and 2-byte copy offsets always suffice; the
    4-byte copy form is still emitted for completeness when an offset
    exceeds 64 KiB."""
    n = len(src)
    out = bytearray()
    v = n
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)

    def emit_literal(lo: int, hi: int) -> None:
        ln = hi - lo
        while ln > 0:
            take = min(ln, 1 << 16)
            if take <= 60:
                out.append((take - 1) << 2)
            elif take <= 0x100:
                out.append(60 << 2)
                out.append(take - 1)
            else:
                out.append(61 << 2)
                out.extend((take - 1).to_bytes(2, "little"))
            out.extend(src[lo : lo + take])
            lo += take
            ln -= take

    def emit_copy(off: int, ln: int) -> None:
        while ln > 0:
            take = min(ln, 64)
            if 4 <= take <= 11 and off < 2048:
                out.append(1 | ((take - 4) << 2) | ((off >> 8) << 5))
                out.append(off & 0xFF)
            elif off <= 0xFFFF:
                out.append(2 | ((take - 1) << 2))
                out.extend(off.to_bytes(2, "little"))
            else:
                out.append(3 | ((take - 1) << 2))
                out.extend(off.to_bytes(4, "little"))
            ln -= take

    table: dict = {}
    i = 0
    lit = 0
    limit = n - 3
    while i < limit:
        key = src[i : i + 4]
        j = table.get(key)
        table[key] = i
        if j is None:
            i += 1
            continue
        # extend the match (source-vs-source compare is exact: emitted
        # output always equals the src prefix, overlap included)
        L = 4
        max_l = n - i
        while L < max_l:
            step = min(512, max_l - L)
            if src[i + L : i + L + step] == src[j + L : j + L + step]:
                L += step
                continue
            while L < max_l and src[i + L] == src[j + L]:
                L += 1
            break
        emit_literal(lit, i)
        emit_copy(i - j, L)
        # index the match tail so immediately-following repeats hit
        if i + L < limit:
            table[src[i + L - 1 : i + L + 3]] = i + L - 1
        i += L
        lit = i
    emit_literal(lit, n)
    return bytes(out)


def _lz4_block_decompress(src: bytes) -> bytes:
    """LZ4 raw-block decode (``io.ipc_compression``'s)."""
    return bytes(lz4_block_decompress(src))


def _decompress(payload: bytes, codec: int, uncompressed_size: int) -> bytes:
    if codec == CODEC_UNCOMPRESSED:
        return payload
    if codec == CODEC_GZIP:
        return gzip.decompress(payload)
    if codec == CODEC_SNAPPY:
        return _snappy_decompress(payload)
    if codec == CODEC_ZSTD:
        return zstd_decompress(payload)
    if codec == CODEC_LZ4_RAW:
        return _lz4_block_decompress(payload)
    if codec == CODEC_LZ4:
        # hadoop framing: [u32be total][u32be block_len][block]...
        out = bytearray()
        pos = 0
        while pos < len(payload):
            total = int.from_bytes(payload[pos : pos + 4], "big")
            pos += 4
            got = 0
            while got < total:
                blen = int.from_bytes(payload[pos : pos + 4], "big")
                pos += 4
                piece = _lz4_block_decompress(payload[pos : pos + blen])
                pos += blen
                got += len(piece)
                out += piece
        return bytes(out)
    raise NotImplementedError(f"parquet codec {codec}")


def _rle_bp_decode(data: bytes, bit_width: int, num_values: int) -> np.ndarray:
    """General RLE / bit-packed hybrid decode -> int32 values."""
    out = np.zeros(num_values, np.int32)
    if bit_width == 0:
        return out
    pos = 0
    filled = 0
    mask = (1 << bit_width) - 1
    byte_w = (bit_width + 7) // 8
    n = len(data)
    while filled < num_values and pos < n:
        hdr = 0
        shift = 0
        while True:
            b = data[pos]
            pos += 1
            hdr |= (b & 0x7F) << shift
            if not (b & 0x80):
                break
            shift += 7
        if hdr & 1:  # bit-packed groups of 8
            groups = hdr >> 1
            nbytes = groups * bit_width
            chunk = data[pos : pos + nbytes]
            pos += nbytes
            bits = np.unpackbits(
                np.frombuffer(chunk, np.uint8), bitorder="little"
            ).reshape(-1, bit_width)
            vals = (bits.astype(np.int64) << np.arange(bit_width)).sum(axis=1)
            take = min(len(vals), num_values - filled)
            out[filled : filled + take] = vals[:take]
            filled += take
        else:
            run = hdr >> 1
            v = int.from_bytes(data[pos : pos + byte_w], "little") & mask
            pos += byte_w
            take = min(run, num_values - filled)
            out[filled : filled + take] = v
            filled += take
    return out


def _physical(dtype: DataType) -> int:
    k = dtype.kind
    if k == TypeKind.BOOL:
        return T_BOOLEAN
    if k in (TypeKind.INT8, TypeKind.INT16, TypeKind.INT32, TypeKind.DATE32):
        return T_INT32
    if k in (TypeKind.INT64, TypeKind.TIMESTAMP, TypeKind.DECIMAL):
        return T_INT64
    if k == TypeKind.FLOAT32:
        return T_FLOAT
    if k == TypeKind.FLOAT64:
        return T_DOUBLE
    if dtype.is_string:
        return T_BYTE_ARRAY
    raise NotImplementedError(f"parquet type for {dtype!r}")


def _varint_bytes(v: int) -> bytes:
    out = bytearray()
    while True:
        byte = v & 0x7F
        v >>= 7
        if not v:
            out.append(byte)
            return bytes(out)
        out.append(byte | 0x80)


def _rle_encode_defs(validity: np.ndarray) -> bytes:
    """RLE runs of the 1-bit definition levels (bit width 1): per run,
    varint(count << 1) and the value in one byte."""
    v = np.asarray(validity).astype(bool)
    n = v.shape[0]
    if n == 0:
        return b""
    starts = np.concatenate([[0], np.flatnonzero(v[1:] != v[:-1]) + 1])
    ends = np.append(starts[1:], n)
    out = bytearray()
    for s0, e0 in zip(starts.tolist(), ends.tolist()):
        out += _varint_bytes((e0 - s0) << 1)
        out.append(1 if v[s0] else 0)
    return bytes(out)


def _rle_decode_defs(data: bytes, num_values: int) -> Tuple[np.ndarray, int]:
    """Decode 1-bit RLE/bit-packed hybrid definition levels."""
    out = np.zeros(num_values, np.bool_)
    pos = 0
    filled = 0
    while filled < num_values:
        hdr = 0
        shift = 0
        while True:
            b = data[pos]
            pos += 1
            hdr |= (b & 0x7F) << shift
            if not (b & 0x80):
                break
            shift += 7
        if hdr & 1:
            # bit-packed: groups of 8 values, 1 bit each
            groups = hdr >> 1
            bits = np.unpackbits(np.frombuffer(bytes(data[pos:pos + groups]), np.uint8), bitorder="little")
            pos += groups
            take = min(bits.shape[0], num_values - filled)
            out[filled:filled + take] = bits[:take]
            filled += take
        else:
            run = hdr >> 1
            v = data[pos]
            pos += 1
            out[filled : filled + run] = bool(v)
            filled += run
    return out, pos


_ROWS_PER_GATHER = 1 << 16


def _byte_array_offsets(raw, count: int) -> Tuple[np.ndarray, np.ndarray]:
    """(start, length) of each of ``count`` PLAIN byte-array values:
    a u32 length, then the bytes.  Raises where ``raw`` ends early."""
    starts = np.empty(count, np.int64)
    lens = np.empty(count, np.int64)
    unpack = struct.Struct("<I").unpack_from
    pos = 0
    for k in range(count):
        (ln,) = unpack(raw, pos)
        starts[k] = pos + 4
        lens[k] = ln
        pos += 4 + ln
    if pos > len(raw):
        raise ValueError(f"parquet byte array: {pos} bytes of values in a {len(raw)}-byte page")
    return starts, lens


def _gather_strings(raw, starts: np.ndarray, lens: np.ndarray, data: np.ndarray, rows: np.ndarray) -> None:
    """``data[rows[k], :lens[k]] = raw[starts[k]:starts[k] + lens[k]]``
    (``lens`` already cut to the width), in blocks of rows."""
    src = np.frombuffer(raw, np.uint8)
    width = data.shape[1]
    flat = data.reshape(-1)
    for lo in range(0, rows.shape[0], _ROWS_PER_GATHER):
        hi = min(lo + _ROWS_PER_GATHER, rows.shape[0])
        ln = lens[lo:hi]
        total = int(ln.sum())
        if not total:
            continue
        within = np.arange(total, dtype=np.int64) - np.repeat(np.cumsum(ln) - ln, ln)
        flat[np.repeat(rows[lo:hi].astype(np.int64) * width, ln) + within] = src[np.repeat(starts[lo:hi], ln) + within]


def _decode_byte_arrays(raw, count: int, width: int, data: np.ndarray, lengths: np.ndarray,
                        rows: np.ndarray) -> None:
    """``count`` PLAIN byte arrays into ``data``/``lengths`` at ``rows``,
    each cut to ``width`` bytes."""
    starts, lens = _byte_array_offsets(raw, count)
    cut = np.minimum(lens, width)
    lengths[rows] = cut
    _gather_strings(raw, starts, cut, data, rows)


def _encode_byte_arrays(data: np.ndarray, lengths: np.ndarray, rows: np.ndarray) -> bytes:
    """PLAIN byte arrays of ``rows``: a u32 length, then that row's
    bytes (at most the row's width)."""
    width = data.shape[1]
    ln = lengths[rows].astype(np.int64)
    pay = np.minimum(ln, width)
    total = int(4 * rows.shape[0] + pay.sum())
    out = np.empty(total, np.uint8)
    starts = np.arange(rows.shape[0], dtype=np.int64) * 4 + (np.cumsum(pay) - pay)
    out[(starts[:, None] + np.arange(4)).reshape(-1)] = ln.astype("<u4").view(np.uint8)
    flat = data.reshape(-1)
    for lo in range(0, rows.shape[0], _ROWS_PER_GATHER):
        hi = min(lo + _ROWS_PER_GATHER, rows.shape[0])
        p = pay[lo:hi]
        n = int(p.sum())
        if not n:
            continue
        within = np.arange(n, dtype=np.int64) - np.repeat(np.cumsum(p) - p, p)
        out[np.repeat(starts[lo:hi] + 4, p) + within] = flat[np.repeat(rows[lo:hi].astype(np.int64) * width, p)
                                                             + within]
    return out.tobytes()


def _string_min_max(data: np.ndarray, lengths: np.ndarray, rows: np.ndarray) -> Tuple[bytes, bytes]:
    """The least and greatest of the byte strings ``data[i, :lengths[i]]``
    over ``rows``, as python's bytes order has them.  A row zeroed past
    its length orders as its bytes do, with a shorter string first among
    rows equal once zero-padded; so the rows are cut down one big-endian
    8-byte word at a time, then by length."""
    width = data.shape[1]
    ln = np.minimum(lengths[rows].astype(np.int64), width)
    words = -(-width // 8)
    padded = np.zeros((rows.shape[0], words * 8), np.uint8)
    padded[:, :width] = np.where(np.arange(width) < ln[:, None], data[rows], 0)
    keys = padded.view(">u8")

    def pick(best) -> bytes:
        cand = np.arange(rows.shape[0])
        for w in range(words):
            col = keys[cand, w]
            cand = cand[col == best(col)]
            if cand.shape[0] == 1:
                break
        k = cand[np.argmin(ln[cand]) if best is np.min else np.argmax(ln[cand])]
        return padded[k, :ln[k]].tobytes()

    return pick(np.min), pick(np.max)


def _plain_encode(dtype: DataType, data: np.ndarray, validity: np.ndarray,
                  lengths: Optional[np.ndarray]) -> bytes:
    """PLAIN values for non-null rows only."""
    phys = _physical(dtype)
    nn = validity.astype(bool)
    if phys == T_BOOLEAN:
        vals = data[nn].astype(np.bool_)
        return np.packbits(vals, bitorder="little").tobytes()
    if phys == T_INT32:
        return data[nn].astype("<i4").tobytes()
    if phys == T_INT64:
        return data[nn].astype("<i8").tobytes()
    if phys == T_FLOAT:
        return data[nn].astype("<f4").tobytes()
    if phys == T_DOUBLE:
        return data[nn].astype("<f8").tobytes()
    # byte array: u32 length + bytes per value
    return _encode_byte_arrays(data, lengths, np.flatnonzero(nn))


def _flba_to_int64(raw: bytes, count: int, type_length: int) -> np.ndarray:
    """FIXED_LEN_BYTE_ARRAY big-endian two's-complement -> int64 (the
    Spark/pyarrow decimal physical encoding)."""
    if type_length > 8:
        out = np.zeros(count, np.int64)
        for i in range(count):
            b = raw[i * type_length:(i + 1) * type_length]
            out[i] = int.from_bytes(b, "big", signed=True)
        return out
    be = np.frombuffer(raw, np.uint8, count * type_length).reshape(count, type_length)
    full = np.empty((count, 8), np.uint8)
    full[:, :8 - type_length] = np.where(be[:, :1] >= 0x80, 0xFF, 0).astype(np.uint8)
    full[:, 8 - type_length:] = be
    return full.view(">i8").reshape(count).astype(np.int64)


def _plain_decode_phys(phys: int, raw: bytes, validity: np.ndarray, width: int,
                       type_length: int = 0):
    """PLAIN decode by the FILE's physical type; caller converts to the
    requested logical dtype (schema adaption)."""
    n = len(validity)
    nn = int(validity.sum())
    if phys == T_BOOLEAN:
        bits = np.unpackbits(np.frombuffer(raw, np.uint8), bitorder="little")[:nn].astype(np.bool_)
        out = np.zeros(n, np.bool_)
        out[validity] = bits
        return out, None
    np_map = {T_INT32: "<i4", T_INT64: "<i8", T_FLOAT: "<f4", T_DOUBLE: "<f8"}
    if phys in np_map:
        vals = np.frombuffer(raw, np_map[phys], count=nn)
        out = np.zeros(n, vals.dtype)
        out[validity] = vals
        return out, None
    if phys == T_FLBA:
        vals = _flba_to_int64(raw, nn, type_length)
        out = np.zeros(n, np.int64)
        out[validity] = vals
        return out, None
    if phys == T_INT96:
        # legacy Spark timestamps: 8B nanos-of-day LE + 4B julian day
        out = np.zeros(n, np.int64)
        words = np.frombuffer(raw, np.uint8, nn * 12).reshape(nn, 12)
        nanos = np.ascontiguousarray(words[:, :8]).view("<u8").reshape(nn)
        julian = np.ascontiguousarray(words[:, 8:]).view("<u4").reshape(nn)
        out[validity] = (julian.astype(np.int64) - 2440588) * 86_400_000_000 + (nanos // 1000).astype(np.int64)
        return out, None
    # byte array
    data = np.zeros((n, width), np.uint8)
    lengths = np.zeros(n, np.int32)
    _decode_byte_arrays(raw, nn, width, data, lengths, np.flatnonzero(validity))
    return data, lengths


def _stat_bytes(dtype: DataType, v) -> bytes:
    phys = _physical(dtype)
    if phys == T_INT32:
        return struct.pack("<i", int(v))
    if phys == T_INT64:
        return struct.pack("<q", int(v))
    if phys == T_FLOAT:
        return struct.pack("<f", float(v))
    if phys == T_DOUBLE:
        return struct.pack("<d", float(v))
    if phys == T_BOOLEAN:
        return struct.pack("<?", bool(v))
    return bytes(v)  # byte array: raw bytes


def _stat_value(dtype: DataType, b: bytes):
    phys = _physical(dtype)
    if phys == T_INT32:
        return struct.unpack("<i", b)[0]
    if phys == T_INT64:
        return struct.unpack("<q", b)[0]
    if phys == T_FLOAT:
        return struct.unpack("<f", b)[0]
    if phys == T_DOUBLE:
        return struct.unpack("<d", b)[0]
    if phys == T_BOOLEAN:
        return b[0] != 0
    return bytes(b)


# ------------------------------------------------------------------ writer

def write_parquet(
    path: str,
    schema: Schema,
    columns: Dict[str, Tuple[np.ndarray, Optional[np.ndarray], Optional[np.ndarray]]],
    row_group_rows: int = 1 << 20,
    codec: int = CODEC_GZIP,
):
    """columns: name -> (data, validity|None, lengths|None) host arrays."""
    from .fs import get_fs

    n = next(iter(columns.values()))[0].shape[0]
    f = get_fs(path).create(path)
    f.write(MAGIC)
    row_groups: List[dict] = []
    for rg_start in range(0, max(n, 1), row_group_rows):
        rg_end = min(rg_start + row_group_rows, n)
        rg_rows = rg_end - rg_start
        chunks = []
        total_bytes = 0
        for fld in schema.fields:
            data, validity, lengths = columns[fld.name]
            v = (
                validity[rg_start:rg_end].astype(bool)
                if validity is not None
                else np.ones(rg_rows, bool)
            )
            d = data[rg_start:rg_end]
            l = lengths[rg_start:rg_end] if lengths is not None else None
            defs = _rle_encode_defs(v)
            values = _plain_encode(fld.dtype, d, v, l)
            payload = struct.pack("<I", len(defs)) + defs + values
            if codec == CODEC_GZIP:
                comp = gzip.compress(payload, 1)
            elif codec == CODEC_SNAPPY:  # Spark's parquet default codec
                comp = _snappy_compress(payload)
            elif codec == CODEC_ZSTD:
                comp = zstd_compress(payload)
            elif codec == CODEC_LZ4_RAW:
                comp = lz4_block_compress(payload)
            elif codec == CODEC_UNCOMPRESSED:
                comp = payload
            else:
                raise NotImplementedError(f"parquet writer codec {codec}")
            # min/max over non-null rows
            stats = None
            if v.any():
                if fld.dtype.is_string:
                    stats = _string_min_max(d, l, np.flatnonzero(v))
                else:
                    nn = d[v]
                    stats = (nn.min(), nn.max())
            ph = CompactWriter()
            ph.write_i(1, 0)                        # type = DATA_PAGE
            ph.write_i(2, len(payload))             # uncompressed size
            ph.write_i(3, len(comp))                # compressed size
            ph.begin_struct(5)                      # data_page_header
            ph.write_i(1, rg_rows)                  # num_values
            ph.write_i(2, 0)                        # encoding PLAIN
            ph.write_i(3, 3)                        # def levels RLE
            ph.write_i(4, 3)                        # rep levels RLE
            ph.end_struct()
            ph.buf.append(0)                        # end PageHeader struct
            header = ph.getvalue()
            offset = f.tell()
            f.write(header)
            f.write(comp)
            chunk_bytes = len(header) + len(comp)
            total_bytes += chunk_bytes
            chunks.append(
                dict(
                    field=fld, offset=offset, num_values=rg_rows,
                    total_comp=chunk_bytes, total_uncomp=len(header) + len(payload),
                    stats=stats, null_count=int((~v).sum()), codec=codec,
                )
            )
        row_groups.append(dict(chunks=chunks, rows=rg_rows, bytes=total_bytes))
        if n == 0:
            break

    # FileMetaData
    w = CompactWriter()
    w.write_i(1, 1)  # version
    # schema: root element + one per field
    w.begin_list(2, CT_STRUCT, len(schema.fields) + 1)
    w.list_elem_struct_begin()
    _w_string(w, 4, "schema")
    w.write_i(5, len(schema.fields))  # num_children
    w.list_elem_struct_end()
    for fld in schema.fields:
        w.list_elem_struct_begin()
        w.write_i(1, _physical(fld.dtype))
        w.write_i(3, 1)  # always OPTIONAL: def levels are always written
        _w_string(w, 4, fld.name)
        conv = None
        if fld.dtype.kind == TypeKind.STRING:
            conv = CONV_UTF8
        elif fld.dtype.is_decimal:
            conv = CONV_DECIMAL
        elif fld.dtype.kind == TypeKind.DATE32:
            conv = CONV_DATE
        elif fld.dtype.kind == TypeKind.TIMESTAMP:
            conv = CONV_TS_MICROS
        if conv is not None:
            w.write_i(6, conv)
        if fld.dtype.is_decimal:
            w.write_i(7, fld.dtype.scale)
            w.write_i(8, fld.dtype.precision)
        w.list_elem_struct_end()
    w.write_i64(3, n)  # num_rows
    w.begin_list(4, CT_STRUCT, len(row_groups))
    for rg in row_groups:
        w.list_elem_struct_begin()
        w.begin_list(1, CT_STRUCT, len(rg["chunks"]))
        for ch in rg["chunks"]:
            w.list_elem_struct_begin()
            w.write_i64(2, ch["offset"])  # file_offset
            w.begin_struct(3)             # ColumnMetaData
            w.write_i(1, _physical(ch["field"].dtype))
            w.begin_list(2, CT_I32, 2)
            w.list_elem_varint(0)  # PLAIN
            w.list_elem_varint(3)  # RLE
            w.begin_list(3, CT_BINARY, 1)
            w.list_elem_binary(ch["field"].name.encode())
            w.write_i(4, ch["codec"])
            w.write_i64(5, ch["num_values"])
            w.write_i64(6, ch["total_uncomp"])
            w.write_i64(7, ch["total_comp"])
            w.write_i64(9, ch["offset"])  # data_page_offset
            if ch["stats"] is not None:
                w.begin_struct(12)
                w.write_i(3, ch["null_count"], CT_I64)  # null_count: i64 per spec
                # use modern min_value/max_value fields
                w.write_binary(5, _stat_bytes(ch["field"].dtype, ch["stats"][1]))
                w.write_binary(6, _stat_bytes(ch["field"].dtype, ch["stats"][0]))
                w.end_struct()
            w.end_struct()
            w.list_elem_struct_end()
        w.write_i64(2, rg["bytes"])
        w.write_i64(3, rg["rows"])
        w.list_elem_struct_end()
    _w_string(w, 6, "blaze-tpu parquet 0.1")
    w.buf.append(0)  # FileMetaData stop

    meta = w.getvalue()
    f.write(meta)
    f.write(struct.pack("<I", len(meta)))
    f.write(MAGIC)
    f.close()


def _w_string(w: CompactWriter, fid: int, s: str):
    w.write_binary(fid, s.encode("utf-8"))


# ------------------------------------------------------------------ reader

@dataclass
class ChunkMeta:
    name: str
    phys: int
    codec: int
    num_values: int
    offset: int                      # first page (dict page if present)
    total_comp: int
    min_value: Optional[bytes] = None
    max_value: Optional[bytes] = None
    null_count: Optional[int] = None
    max_def: int = 1                 # 0 = REQUIRED column (no def levels)
    type_length: int = 0             # FLBA byte width


@dataclass
class RowGroupMeta:
    rows: int
    chunks: Dict[str, ChunkMeta]


@dataclass
class ParquetFileMeta:
    num_rows: int
    schema_elements: List[dict]
    row_groups: List[RowGroupMeta]


def read_metadata(path: str) -> ParquetFileMeta:
    from .fs import get_fs

    with get_fs(path).open(path) as f:
        f.seek(-8, os.SEEK_END)
        tail = f.read(8)
        assert tail[4:] == MAGIC, "not a parquet file"
        meta_len = struct.unpack("<I", tail[:4])[0]
        f.seek(-8 - meta_len, os.SEEK_END)
        meta = f.read(meta_len)
    r = CompactReader(meta)
    fm = r.read_struct()
    schema_elems = [dict(e) for e in fm.get(2, [])]
    # leaf nullability + FLBA width by name
    repetition: Dict[str, int] = {}
    type_lengths: Dict[str, int] = {}
    for e in schema_elems:
        if e.get(5):  # has children -> group node (root)
            continue
        nm = e.get(4, b"?")
        nm = nm.decode() if isinstance(nm, (bytes, bytearray)) else str(nm)
        repetition[nm] = e.get(3, 1)
        type_lengths[nm] = e.get(2, 0)
    rgs: List[RowGroupMeta] = []
    for rg in fm.get(4, []):
        chunks: Dict[str, ChunkMeta] = {}
        for ch in rg.get(1, []):
            md = ch.get(3, {})
            name = b"/".join(md.get(3, [b"?"])).decode()
            stats = md.get(12, {})
            data_off = md.get(9, md.get(2, ch.get(2, 0)))
            dict_off = md.get(11)  # dictionary_page_offset
            first = min(data_off, dict_off) if dict_off else data_off
            nc = stats.get(3)  # null_count: i64 (spec); old subset files: 8B binary
            if isinstance(nc, (bytes, bytearray)) and len(nc) == 8:
                nc = struct.unpack("<q", bytes(nc))[0]
            elif not isinstance(nc, int):
                nc = None
            # min/max: prefer modern min_value/max_value (5/6), fall
            # back to deprecated max/min (1/2)
            mx = stats.get(5, stats.get(1))
            mn = stats.get(6, stats.get(2))
            chunks[name] = ChunkMeta(
                name=name,
                phys=md.get(1, 0),
                codec=md.get(4, 0),
                num_values=md.get(5, 0),
                offset=first,
                total_comp=md.get(7, 0),
                min_value=bytes(mn) if mn is not None else None,
                max_value=bytes(mx) if mx is not None else None,
                null_count=nc,
                max_def=0 if repetition.get(name) == 0 else 1,
                type_length=type_lengths.get(name, 0),
            )
        rgs.append(RowGroupMeta(rows=rg.get(3, 0), chunks=chunks))
    return ParquetFileMeta(num_rows=fm.get(3, 0), schema_elements=schema_elems, row_groups=rgs)


def _plain_decode_dict_values(phys: int, raw: bytes, count: int, width: int,
                              type_length: int = 0):
    """Decode a PLAIN dictionary page into a lookup table."""
    if phys == T_FLBA:
        return _flba_to_int64(raw, count, type_length)
    if phys == T_INT32:
        return np.frombuffer(raw, "<i4", count=count)
    if phys == T_INT64:
        return np.frombuffer(raw, "<i8", count=count)
    if phys == T_FLOAT:
        return np.frombuffer(raw, "<f4", count=count)
    if phys == T_DOUBLE:
        return np.frombuffer(raw, "<f8", count=count)
    if phys == T_BOOLEAN:
        return np.unpackbits(np.frombuffer(raw, np.uint8), bitorder="little")[:count].astype(bool)
    # byte arrays: (data (count, width), lengths)
    data = np.zeros((count, width), np.uint8)
    lengths = np.zeros(count, np.int32)
    _decode_byte_arrays(raw, count, width, data, lengths, np.arange(count))
    return data, lengths


def read_column_chunk(path: str, chunk: ChunkMeta, dtype: DataType):
    """Decode a full column chunk: every page (v1/v2), PLAIN or
    dictionary encodings, all supported codecs.  Returns
    (data, validity, lengths|None) numpy arrays of chunk.num_values
    rows.  ≙ the arrow-rs page machinery behind parquet_exec.rs:65-418."""
    from .fs import get_fs

    with get_fs(path).open(path) as f:
        f.seek(chunk.offset)
        blob = f.read(chunk.total_comp if chunk.total_comp else None)

    n_total = chunk.num_values
    width = dtype.string_width if dtype.is_string else 0
    validity = np.zeros(n_total, np.bool_)
    if dtype.is_string:
        data = np.zeros((n_total, width), np.uint8)
        lengths = np.zeros(n_total, np.int32)
    else:
        data = np.zeros(n_total, dtype.np_dtype)
        lengths = None
    dict_table = None  # (values[, lengths]) from the dictionary page

    def emit_values(encoding: int, values: bytes, page_valid: np.ndarray, row0: int):
        nv = page_valid.shape[0]
        nn = int(page_valid.sum())
        sl = slice(row0, row0 + nv)
        validity[sl] = page_valid
        if nn == 0:
            return
        if encoding in (ENC_PLAIN_DICT, ENC_RLE_DICT):
            bit_width = values[0]
            idx = _rle_bp_decode(values[1:], bit_width, nn)
            if dtype.is_string:
                dvals, dlens = dict_table
                rows = row0 + np.nonzero(page_valid)[0]
                data[rows] = dvals[idx]
                lengths[rows] = dlens[idx]
            else:
                out = np.zeros(nv, dtype.np_dtype)
                out[page_valid] = dict_table[idx].astype(dtype.np_dtype, copy=False)
                data[sl] = out
        elif encoding == ENC_RLE and chunk.phys == T_BOOLEAN:
            # v2 booleans: u32 length + RLE/bit-packed hybrid, width 1
            (rl,) = struct.unpack_from("<I", values, 0)
            bits = _rle_bp_decode(values[4 : 4 + rl], 1, nn).astype(bool)
            out = np.zeros(nv, np.bool_)
            out[page_valid] = bits
            data[sl] = out
        elif encoding != ENC_PLAIN:
            # gated, not silently wrong: DELTA_* / BYTE_STREAM_SPLIT
            raise NotImplementedError(f"parquet page encoding {encoding}")
        else:  # PLAIN — decode by the file's physical type, then adapt
            d, l = _plain_decode_phys(chunk.phys, values, page_valid, width,
                                      chunk.type_length)
            if dtype.is_string:
                data[sl, : d.shape[1]] = d[:, :width]
                lengths[sl] = l
            else:
                data[sl] = d.astype(dtype.np_dtype, copy=False)

    pos = 0
    decoded = 0
    blob_len = len(blob)
    view = memoryview(blob)
    while decoded < n_total and pos < blob_len:
        r = CompactReader(view[pos:])
        ph = r.read_struct()
        header_len = r.pos
        ptype = ph.get(1, PAGE_DATA)
        uncomp_size = ph.get(2, 0)
        comp_size = ph.get(3, uncomp_size)
        page_raw = blob[pos + header_len : pos + header_len + comp_size]
        pos += header_len + comp_size
        if ptype == PAGE_DICT:
            dh = ph.get(7, {})
            count = dh.get(1, 0)
            payload = _decompress(page_raw, chunk.codec, uncomp_size)
            dict_table = _plain_decode_dict_values(
                chunk.phys, payload, count, width or 64, chunk.type_length
            )
            continue
        if ptype == PAGE_DATA:
            dph = ph.get(5, {})
            nv = dph.get(1, 0)
            encoding = dph.get(2, ENC_PLAIN)
            payload = _decompress(page_raw, chunk.codec, uncomp_size)
            if chunk.max_def > 0:
                (def_len,) = struct.unpack_from("<I", payload, 0)
                page_valid, _ = _rle_decode_defs(payload[4 : 4 + def_len], nv)
                values = payload[4 + def_len :]
            else:
                page_valid = np.ones(nv, np.bool_)
                values = payload
            emit_values(encoding, values, page_valid, decoded)
            decoded += nv
            continue
        if ptype == PAGE_DATA_V2:
            dph = ph.get(8, {})
            nv = dph.get(1, 0)
            num_nulls = dph.get(2, 0)
            encoding = dph.get(4, ENC_PLAIN)
            def_len = dph.get(5, 0)
            rep_len = dph.get(6, 0)
            is_compressed = dph.get(7, True)
            levels = page_raw[: rep_len + def_len]  # NEVER compressed
            rest = page_raw[rep_len + def_len :]
            if is_compressed:
                rest = _decompress(rest, chunk.codec, max(uncomp_size - rep_len - def_len, 1))
            if chunk.max_def > 0 and def_len:
                # v2 def levels: RLE hybrid WITHOUT the u32 length prefix
                page_valid = _rle_bp_decode(levels[rep_len:], 1, nv).astype(bool)
            else:
                page_valid = np.ones(nv, np.bool_)
            emit_values(encoding, rest, page_valid, decoded)
            decoded += nv
            continue
        # index or unknown page: skip
    return data, validity, lengths
