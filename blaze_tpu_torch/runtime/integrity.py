"""Checksums of framed blocks (≙ ``blaze_tpu/runtime/integrity.py``).

A checksummed frame carries a 5-byte trailer ``[u8 algo][u32 sum]``
over its stored (compressed) bytes; the high bit of the frame's codec
byte marks it.  Readers verify every marked frame and raise
:class:`BlockCorruptionError` on a mismatch.  Writers stamp
:data:`FRAME_ALGO` (crc32, the reference's default); readers also
verify ``crc32c`` and ``xxh32`` (the LZ4 frame hash) frames.  The
algorithm ids are wire format, shared with the reference.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Optional

ALGO_CRC32 = 1
ALGO_CRC32C = 2
ALGO_XXH32 = 3

_ALGO_NAMES = {ALGO_CRC32: "crc32", ALGO_CRC32C: "crc32c", ALGO_XXH32: "xxh32"}

#: the algorithm the port's writers stamp on every frame
FRAME_ALGO = ALGO_CRC32

#: size of the per-frame checksum trailer: [u8 algo][u32 sum]
TRAILER_LEN = 5
#: codec-byte flag marking a checksummed frame
CHECKSUM_FLAG = 0x80

#: frames whose checksum was computed and matched, since the last reset
COUNTS = {"frames_verified": 0}


class BlockCorruptionError(ValueError):
    """Checksummed bytes failed verification at a read boundary: names
    the site, the file behind the block when there is one, and the
    checksum pair."""

    def __init__(self, site: str, detail: str = "", path: Optional[str] = None,
                 expected: Optional[int] = None, got: Optional[int] = None,
                 algo: Optional[int] = None):
        self.site = site
        self.path = path
        self.expected = expected
        self.got = got
        self.algo = _ALGO_NAMES.get(algo) if algo else None
        msg = f"block corruption at {site}"
        if detail:
            msg += f" ({detail})"
        if path:
            msg += f" in {path!r}"
        if expected is not None:
            msg += (f": {self.algo or 'checksum'} mismatch "
                    f"expected={expected:#010x} got={got:#010x}")
        super().__init__(msg)


def _crc32c_table():
    poly = 0x82F63B78  # reflected Castagnoli
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        table.append(c)
    return table


_CRC32C_TABLE = _crc32c_table()


def crc32c(data: bytes, crc: int = 0) -> int:
    """CRC32C (Castagnoli), table-driven."""
    c = crc ^ 0xFFFFFFFF
    t = _CRC32C_TABLE
    for b in data:
        c = t[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def checksum(data: bytes, algo: int) -> int:
    if algo == ALGO_CRC32:
        return zlib.crc32(data) & 0xFFFFFFFF
    if algo == ALGO_CRC32C:
        return crc32c(data)
    if algo == ALGO_XXH32:
        from ..io.ipc_compression import xxh32

        return xxh32(data)
    raise ValueError(f"unknown checksum algorithm id {algo}")


def frame_trailer(stored: bytes, algo: int) -> bytes:
    """The 5-byte trailer ``[u8 algo][u32 sum]`` over the stored bytes."""
    return struct.pack("<BI", algo, checksum(stored, algo))


def verify_bytes(stored: bytes, trailer: bytes, site: str, detail: str = "",
                 path: Optional[str] = None) -> None:
    """Check stored bytes against their trailer; raises
    :class:`BlockCorruptionError` on a mismatch.  A marked frame whose
    trailer names no known algorithm is itself corrupt: one flipped
    algo byte must not switch verification off."""
    if len(trailer) != TRAILER_LEN:
        raise BlockCorruptionError(site, detail or "torn checksum trailer", path=path)
    algo, want = struct.unpack("<BI", trailer)
    if algo not in _ALGO_NAMES:
        raise BlockCorruptionError(site, detail or f"corrupt checksum-trailer algo byte {algo}",
                                   path=path)
    got = checksum(stored, algo)
    if got != want:
        raise BlockCorruptionError(site, detail, path=path, expected=want, got=got, algo=algo)
    COUNTS["frames_verified"] += 1


def flip_byte_in_file(path: str, offset: Optional[int] = None) -> int:
    """Flip one bit of a committed file in place and return its offset
    (by default inside the first frame's stored bytes: past the 5-byte
    header, before a small frame's trailer)."""
    size = os.path.getsize(path)
    if size <= 6:
        raise ValueError(f"{path}: {size} bytes hold no frame payload to flip")
    if offset is None:
        offset = min(5 + size % max(1, size - 11), size - 1)
    with open(path, "r+b") as f:
        f.seek(offset)
        b = f.read(1)
        f.seek(offset)
        f.write(bytes([b[0] ^ 0x01]))
    return offset
