"""Framed compressed IPC blocks (≙ ``blaze_tpu/io/ipc_compression.py``).

    plain:       [u32 len][u8 codec][stored]
    checksummed: [u32 len][u8 codec|0x80][stored][u8 algo][u32 sum]

``len`` is the stored-byte length either way.  Codecs: ``raw``,
``zlib`` (level 1, :data:`DEFAULT_CODEC`, the reference's default) and
``lz4`` (a self-contained LZ4
Frame codec: the writer emits greedy-compressed independent blocks,
the reader takes compressed, stored, linked and independent blocks).
A frame is stored raw when compression does not make it smaller.
``zstd`` is not ported: the port has no zstd decoder (the card's
machine has no ``zstandard``), so writing or reading a zstd frame
raises.  A stream written as one unit (a broadcast blob) may end with
a block-trailer frame (codec ``0x7E``) carrying the frame count and
the XOR of the frame checksums, so a missing whole frame is detected.
"""

from __future__ import annotations

import struct
import zlib
from typing import BinaryIO, Dict, Iterator, Optional, Tuple

from ..runtime.integrity import (
    CHECKSUM_FLAG, FRAME_ALGO, TRAILER_LEN, BlockCorruptionError, frame_trailer, verify_bytes,
)

CODEC_RAW = 0
CODEC_ZLIB = 1
CODEC_ZSTD = 2
CODEC_LZ4 = 3
#: codec byte of a block-trailer frame: payload [u32 count][u8 algo][u32 xor]
CODEC_BLOCK_TRAILER = 0x7E
#: the codec the port's writers use
DEFAULT_CODEC = "zlib"
_CODEC_IDS: Dict[str, int] = {"zlib": CODEC_ZLIB, "zstd": CODEC_ZSTD, "lz4": CODEC_LZ4,
                              "raw": CODEC_RAW, "none": CODEC_RAW}

_LZ4_MAGIC = 0x184D2204


class MissingCodecError(NotImplementedError):
    """A frame needs a codec the port does not have."""


def _no_zstd() -> MissingCodecError:
    return MissingCodecError("zstd frames need a zstd decoder, which the port does not have "
                             "(no zstandard package on the card's machine); use zlib, lz4 or raw")


# ------------------------------------------------------------------- lz4


def xxh32(data: bytes, seed: int = 0) -> int:
    """xxHash32 (the LZ4 frame hash)."""
    P1, P2, P3, P4, P5 = 2654435761, 2246822519, 3266489917, 668265263, 374761393
    M = 0xFFFFFFFF

    def rotl(x, r):
        return ((x << r) | (x >> (32 - r))) & M

    n = len(data)
    pos = 0
    if n >= 16:
        v1 = (seed + P1 + P2) & M
        v2 = (seed + P2) & M
        v3 = seed
        v4 = (seed - P1) & M
        while pos + 16 <= n:
            k1, k2, k3, k4 = struct.unpack_from("<IIII", data, pos)
            v1 = (rotl((v1 + k1 * P2) & M, 13) * P1) & M
            v2 = (rotl((v2 + k2 * P2) & M, 13) * P1) & M
            v3 = (rotl((v3 + k3 * P2) & M, 13) * P1) & M
            v4 = (rotl((v4 + k4 * P2) & M, 13) * P1) & M
            pos += 16
        h = (rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18)) & M
    else:
        h = (seed + P5) & M
    h = (h + n) & M
    while pos + 4 <= n:
        (k,) = struct.unpack_from("<I", data, pos)
        h = (rotl((h + k * P3) & M, 17) * P4) & M
        pos += 4
    while pos < n:
        h = (rotl((h + data[pos] * P5) & M, 11) * P1) & M
        pos += 1
    h ^= h >> 15
    h = (h * P2) & M
    h ^= h >> 13
    h = (h * P3) & M
    h ^= h >> 16
    return h


def lz4_block_compress(src: bytes) -> bytes:
    """Greedy hash-match LZ4 block compressor (spec-valid output)."""
    n = len(src)
    out = bytearray()

    def emit(lit: bytes, off: int = 0, mlen: int = 0):
        ll = len(lit)
        ml = mlen - 4 if mlen else 0
        out.append((min(ll, 15) << 4) | (min(ml, 15) if mlen else 0))
        if ll >= 15:
            rest = ll - 15
            while rest >= 255:
                out.append(255)
                rest -= 255
            out.append(rest)
        out.extend(lit)
        if mlen:
            out.append(off & 0xFF)
            out.append(off >> 8)
            if ml >= 15:
                rest = ml - 15
                while rest >= 255:
                    out.append(255)
                    rest -= 255
                out.append(rest)

    if n < 13:  # too short for any match (the spec's end rules)
        emit(src)
        return bytes(out)
    table: Dict[bytes, int] = {}
    anchor = 0
    i = 0
    limit = n - 12  # the last match starts 12 or more bytes before the end
    while i <= limit:
        key = src[i:i + 4]
        j = table.get(key, -1)
        table[key] = i
        if j >= 0 and i - j <= 0xFFFF and src[j:j + 4] == key:
            mlen = 4
            end = n - 5  # the last 5 bytes are literals
            while i + mlen < end and src[j + mlen] == src[i + mlen]:
                mlen += 1
            emit(src[anchor:i], i - j, mlen)
            i += mlen
            anchor = i
        else:
            i += 1
    emit(src[anchor:])
    return bytes(out)


def lz4_block_decompress(src: bytes, out: Optional[bytearray] = None) -> bytearray:
    """LZ4 block decode, appending to ``out`` (a linked frame's earlier
    output, which matches may reach back into)."""
    out = bytearray() if out is None else out
    pos = 0
    n = len(src)
    while pos < n:
        token = src[pos]
        pos += 1
        lit = token >> 4
        if lit == 15:
            while True:
                b = src[pos]
                pos += 1
                lit += b
                if b != 255:
                    break
        out += src[pos:pos + lit]
        pos += lit
        if pos >= n:
            break  # the final literal run has no match part
        off = src[pos] | (src[pos + 1] << 8)
        pos += 2
        mlen = token & 15
        if mlen == 15:
            while True:
                b = src[pos]
                pos += 1
                mlen += b
                if b != 255:
                    break
        mlen += 4
        start = len(out) - off
        if off >= mlen:
            out += out[start:start + mlen]
        else:
            for i in range(mlen):
                out.append(out[start + i])
    return out


def lz4_frame_compress(payload: bytes, checksums: bool = False) -> bytes:
    """LZ4 Frame writer: independent 4 MB blocks, each stored when
    compression does not help; with ``checksums`` the spec's xxh32
    block and content checksums."""
    out = bytearray(struct.pack("<I", _LZ4_MAGIC))
    out.append(0b0110_0000 | (0b0001_0100 if checksums else 0))  # FLG: v01, independent
    out.append(7 << 4)  # BD: 4 MB blocks
    out.append((xxh32(bytes(out[4:6])) >> 8) & 0xFF)  # HC
    block_max = 4 << 20
    for off in range(0, len(payload), block_max):
        chunk = payload[off:off + block_max]
        comp = lz4_block_compress(chunk)
        if len(comp) < len(chunk):
            out += struct.pack("<I", len(comp))
            block = comp
        else:
            out += struct.pack("<I", len(chunk) | 0x80000000)
            block = chunk
        out += block
        if checksums:
            out += struct.pack("<I", xxh32(block))
    out += struct.pack("<I", 0)  # EndMark
    if checksums:
        out += struct.pack("<I", xxh32(payload))
    return bytes(out)


def lz4_frame_decompress(src: bytes) -> bytes:
    """LZ4 Frame reader; verifies the header, block and content
    checksums the frame carries."""
    (magic,) = struct.unpack_from("<I", src, 0)
    if magic != _LZ4_MAGIC:
        raise ValueError("not an LZ4 frame")
    flg = src[4]
    pos = 6  # magic, FLG, BD
    block_checksum = (flg >> 4) & 1
    content_checksum = (flg >> 2) & 1
    if (flg >> 3) & 1:
        pos += 8  # content size
    if flg & 1:
        pos += 4  # dictionary id
    want_hc = (xxh32(src[4:pos]) >> 8) & 0xFF
    if src[pos] != want_hc:
        raise BlockCorruptionError("lz4.frame", "header checksum (HC byte) mismatch",
                                   expected=want_hc, got=src[pos])
    pos += 1
    out = bytearray()
    while True:
        (bsize,) = struct.unpack_from("<I", src, pos)
        pos += 4
        if bsize == 0:
            break
        stored = bool(bsize & 0x80000000)
        bsize &= 0x7FFFFFFF
        block = src[pos:pos + bsize]
        pos += bsize
        if block_checksum:
            (want,) = struct.unpack_from("<I", src, pos)
            pos += 4
            got = xxh32(block)
            if got != want:
                raise BlockCorruptionError("lz4.frame", "block checksum mismatch",
                                           expected=want, got=got)
        if stored:
            out += block
        else:
            lz4_block_decompress(block, out)
    if content_checksum:
        (want,) = struct.unpack_from("<I", src, pos)
        got = xxh32(bytes(out))
        if got != want:
            raise BlockCorruptionError("lz4.frame", "content checksum mismatch",
                                       expected=want, got=got)
    return bytes(out)


# ----------------------------------------------------------------- frames


def compress_frame(payload: bytes, codec: str = DEFAULT_CODEC,
                   checksum_algo: Optional[int] = None) -> bytes:
    """One frame of ``payload``; with ``checksum_algo`` (an
    ``integrity`` algorithm id) the checksum flag and trailer.  An
    unknown codec name raises."""
    if codec not in _CODEC_IDS:
        raise ValueError(f"unknown codec {codec!r} (known: {', '.join(_CODEC_IDS)})")
    cid = _CODEC_IDS[codec]
    stored, out_cid = payload, CODEC_RAW
    if cid == CODEC_ZSTD:
        raise _no_zstd()
    if cid == CODEC_LZ4:
        comp = lz4_frame_compress(payload)
        if len(comp) < len(payload):
            stored, out_cid = comp, CODEC_LZ4
    elif cid == CODEC_ZLIB:
        comp = zlib.compress(payload, 1)
        if len(comp) < len(payload):
            stored, out_cid = comp, CODEC_ZLIB
    if checksum_algo is None:
        return struct.pack("<IB", len(stored), out_cid) + stored
    return (struct.pack("<IB", len(stored), out_cid | CHECKSUM_FLAG)
            + stored + frame_trailer(stored, checksum_algo))


def block_trailer(frame_count: int, checksum_xor: int, algo: int) -> bytes:
    """The block-trailer frame closing a stream written as one unit."""
    payload = struct.pack("<IBI", frame_count, algo, checksum_xor & 0xFFFFFFFF)
    return struct.pack("<IB", len(payload), CODEC_BLOCK_TRAILER) + payload


def frame_span(buf: bytes, off: int) -> Tuple[int, int, int, int]:
    """``(cid, stored_start, stored_len, next_off)`` of the frame at
    ``off``; ``cid`` keeps the checksum flag, ``next_off`` includes the
    trailer of a checksummed frame."""
    ln, cid = struct.unpack_from("<IB", buf, off)
    start = off + 5
    nxt = start + ln
    if cid & CHECKSUM_FLAG:
        nxt += TRAILER_LEN
    return cid, start, ln, nxt


def _decode(cid: int, stored: bytes) -> bytes:
    if cid == CODEC_ZLIB:
        return zlib.decompress(stored)
    if cid == CODEC_ZSTD:
        raise _no_zstd()
    if cid == CODEC_LZ4:
        return lz4_frame_decompress(stored)
    if cid != CODEC_RAW:
        raise ValueError(f"unknown frame codec {cid}")
    return stored


def decompress_frame(frame: bytes, site: str = "frame", path: Optional[str] = None) -> bytes:
    """Decode one frame; a checksummed frame is verified first."""
    ln, cid = struct.unpack_from("<IB", frame, 0)
    stored = frame[5:5 + ln]
    if cid & CHECKSUM_FLAG:
        verify_bytes(stored, frame[5 + ln:5 + ln + TRAILER_LEN], site, path=path)
        cid &= ~CHECKSUM_FLAG
    return _decode(cid, stored)


def _verify_block_trailer(stored: bytes, count: int, xor: int, site: str,
                          path: Optional[str]) -> None:
    if len(stored) != 9:
        raise BlockCorruptionError(site, "torn block trailer", path=path)
    want_count, algo, want_xor = struct.unpack("<IBI", stored)
    if want_count != count:
        raise BlockCorruptionError(site, f"block trailer frame count {want_count} != {count} read",
                                   path=path)
    if algo and want_xor != (xor & 0xFFFFFFFF):
        raise BlockCorruptionError(site, "block trailer checksum mismatch", path=path,
                                   expected=want_xor, got=xor & 0xFFFFFFFF, algo=algo)


class _FrameWalk:
    """The checks shared by the blob and stream readers: each
    checksummed frame verified, a block trailer checked against the
    frames before it, nothing after it."""

    def __init__(self, site: str, path: Optional[str]):
        self.site, self.path = site, path
        self.count = self.xor = 0
        self.trailer_seen = False

    def payload(self, cid: int, stored: bytes, trailer: bytes) -> Optional[bytes]:
        if (cid & ~CHECKSUM_FLAG) == CODEC_BLOCK_TRAILER:
            _verify_block_trailer(stored, self.count, self.xor, self.site, self.path)
            self.trailer_seen = True
            return None
        if self.trailer_seen:
            raise BlockCorruptionError(self.site, "frames after the block trailer", path=self.path)
        if cid & CHECKSUM_FLAG:
            verify_bytes(stored, trailer, self.site, path=self.path)
            self.xor ^= struct.unpack("<BI", trailer)[1]
        self.count += 1
        return _decode(cid & ~CHECKSUM_FLAG, stored)


def iter_blob_frames(blob: bytes, site: str = "block", path: Optional[str] = None) -> Iterator[bytes]:
    """The payload of every frame of an in-memory blob, verified."""
    walk = _FrameWalk(site, path)
    off = 0
    while off < len(blob):
        if off + 5 > len(blob):
            raise BlockCorruptionError(site, "torn frame header", path=path)
        cid, start, ln, nxt = frame_span(blob, off)
        if nxt > len(blob):
            raise BlockCorruptionError(site, "torn frame", path=path)
        payload = walk.payload(cid, blob[start:start + ln], blob[start + ln:nxt])
        off = nxt
        if payload is not None:
            yield payload


class IpcFrameWriter:
    """Writes payloads as frames to a binary stream, zlib-compressed
    and checksummed with :data:`FRAME_ALGO`."""

    def __init__(self, f: BinaryIO):
        self._f = f
        self.bytes_written = 0

    def write(self, payload: bytes) -> int:
        frame = compress_frame(payload, checksum_algo=FRAME_ALGO)
        self._f.write(frame)
        self.bytes_written += len(frame)
        return len(frame)


def iter_stream_frames(f: BinaryIO, limit: int, site: str = "frame",
                       path: Optional[str] = None) -> Iterator[bytes]:
    """The payload of every frame in the next ``limit`` bytes of ``f``,
    verified; a segment that ends inside a frame is torn."""
    walk = _FrameWalk(site, path)
    remaining = limit
    while remaining > 0:
        hdr = f.read(5)
        if len(hdr) < 5 or remaining < 5:
            raise BlockCorruptionError(site, "torn frame header", path=path)
        ln, cid = struct.unpack("<IB", hdr)
        tail = TRAILER_LEN if cid & CHECKSUM_FLAG else 0
        remaining -= 5 + ln + tail
        stored = f.read(ln)
        trailer = f.read(tail)
        if remaining < 0 or len(stored) < ln or len(trailer) < tail:
            raise BlockCorruptionError(site, "torn frame", path=path)
        payload = walk.payload(cid, stored, trailer)
        if payload is not None:
            yield payload
