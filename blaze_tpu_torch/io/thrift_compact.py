"""Minimal Thrift Compact Protocol reader/writer (the port's own copy of
``blaze_tpu/io/thrift_compact.py``).

Parquet metadata (FileMetaData, PageHeader, ...) is thrift-compact
encoded; this is the self-contained codec of ``io/parquet.py``.  It
implements the subset the parquet structures use: structs,
i16/i32/i64 (zigzag varints), binary, bool, double, lists.
"""

from __future__ import annotations

import struct
from typing import Any, Dict

# compact type ids
CT_STOP = 0x00
CT_BOOL_TRUE = 0x01
CT_BOOL_FALSE = 0x02
CT_BYTE = 0x03
CT_I16 = 0x04
CT_I32 = 0x05
CT_I64 = 0x06
CT_DOUBLE = 0x07
CT_BINARY = 0x08
CT_LIST = 0x09
CT_STRUCT = 0x0C


def _zigzag(n: int) -> int:
    return (n << 1) ^ (n >> 63)


def _unzigzag(n: int) -> int:
    return (n >> 1) ^ -(n & 1)


class CompactWriter:
    def __init__(self):
        self.buf = bytearray()
        self._last_fid = [0]

    def _varint(self, n: int):
        while True:
            b = n & 0x7F
            n >>= 7
            if n:
                self.buf.append(b | 0x80)
            else:
                self.buf.append(b)
                return

    def field_header(self, fid: int, ctype: int):
        delta = fid - self._last_fid[-1]
        if 0 < delta <= 15:
            self.buf.append((delta << 4) | ctype)
        else:
            self.buf.append(ctype)
            self._varint(_zigzag(fid) & 0xFFFFFFFF)
        self._last_fid[-1] = fid

    def write_i(self, fid: int, v: int, ctype: int = CT_I32):
        self.field_header(fid, ctype)
        self._varint(_zigzag(v))

    def write_i64(self, fid: int, v: int):
        self.write_i(fid, v, CT_I64)

    def write_binary(self, fid: int, v: bytes):
        self.field_header(fid, CT_BINARY)
        self._varint(len(v))
        self.buf.extend(v)

    def write_string(self, fid: int, v: str):
        self.write_binary(fid, v.encode("utf-8"))

    def write_bool(self, fid: int, v: bool):
        self.field_header(fid, CT_BOOL_TRUE if v else CT_BOOL_FALSE)

    def begin_struct(self, fid: int):
        self.field_header(fid, CT_STRUCT)
        self._last_fid.append(0)

    def end_struct(self):
        self.buf.append(CT_STOP)
        self._last_fid.pop()

    def begin_list(self, fid: int, elem_ctype: int, size: int):
        self.field_header(fid, CT_LIST)
        if size < 15:
            self.buf.append((size << 4) | elem_ctype)
        else:
            self.buf.append(0xF0 | elem_ctype)
            self._varint(size)
        # list elements are written raw by the caller

    def list_elem_varint(self, v: int):
        self._varint(_zigzag(v))

    def list_elem_binary(self, v: bytes):
        self._varint(len(v))
        self.buf.extend(v)

    def list_elem_struct_begin(self):
        self._last_fid.append(0)

    def list_elem_struct_end(self):
        self.buf.append(CT_STOP)
        self._last_fid.pop()

    def getvalue(self) -> bytes:
        return bytes(self.buf)


class CompactReader:
    """Parses a struct into {fid: value}; nested structs become dicts,
    lists become python lists.  Untyped-schema generic decode — the
    caller interprets fids."""

    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.pos = pos

    def _varint(self) -> int:
        out = 0
        shift = 0
        while True:
            b = self.data[self.pos]
            self.pos += 1
            out |= (b & 0x7F) << shift
            if not (b & 0x80):
                return out
            shift += 7

    def _zig(self) -> int:
        return _unzigzag(self._varint())

    def read_struct(self) -> Dict[int, Any]:
        out: Dict[int, Any] = {}
        last_fid = 0
        while True:
            b = self.data[self.pos]
            self.pos += 1
            if b == CT_STOP:
                return out
            ctype = b & 0x0F
            delta = b >> 4
            fid = last_fid + delta if delta else _unzigzag(self._varint())
            last_fid = fid
            out[fid] = self._read_value(ctype)

    def _read_value(self, ctype: int):
        if ctype == CT_BOOL_TRUE:
            return True
        if ctype == CT_BOOL_FALSE:
            return False
        if ctype == CT_BYTE:
            v = self.data[self.pos]
            self.pos += 1
            return v
        if ctype in (CT_I16, CT_I32, CT_I64):
            return self._zig()
        if ctype == CT_DOUBLE:
            v = struct.unpack_from("<d", self.data, self.pos)[0]
            self.pos += 8
            return v
        if ctype == CT_BINARY:
            n = self._varint()
            v = self.data[self.pos : self.pos + n]
            self.pos += n
            return v
        if ctype == CT_LIST:
            hdr = self.data[self.pos]
            self.pos += 1
            size = hdr >> 4
            elem = hdr & 0x0F
            if size == 15:
                size = self._varint()
            return [self._read_value(elem if elem != CT_BOOL_TRUE else CT_BOOL_TRUE) for _ in range(size)]
        if ctype == CT_STRUCT:
            return self.read_struct()
        raise ValueError(f"unsupported compact type {ctype}")
