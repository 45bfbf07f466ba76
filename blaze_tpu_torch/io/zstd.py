"""Zstandard frames (RFC 8878), both ways, in python and numpy.

The reference calls the ``zstandard`` C library; the card's machine
has no such package, so the port decodes and encodes the format
itself.

:func:`decompress` reads any conforming frame sequence: frames with
or without a content size, single-segment or windowed, concatenated,
skippable frames (skipped), the content checksum (the low 32 bits of
XXH64), raw, RLE and compressed blocks; literals raw, RLE,
Huffman-coded (weights FSE-compressed or direct, one stream or four)
and treeless; sequences in the Predefined, RLE, FSE_Compressed and
Repeat modes, the three repeat offsets and matches reaching back
into earlier blocks.  Huffman and Repeat tables carry across the
blocks of a frame and reset at the next one.  A malformed frame
raises a :class:`ZstdError`: :class:`ZstdDictionaryError` (a frame
that needs a dictionary), :class:`ZstdFormatError` (reserved bits or
block type, bad tables), :class:`ZstdTruncatedError` (the input or a
bitstream ends early, a bitstream does not end on its padding bit),
:class:`ZstdChecksumError`, :class:`ZstdSizeError` (output other
than the frame content size).

:func:`compress` writes one frame: a content size, single-segment up
to 2^27 bytes, blocks of at most 128 KiB, each the smallest of raw,
RLE and compressed.  A compressed block carries raw literals and the
sequences of a greedy match finder (exact 4-byte keys, the most recent
earlier position, matches up to 2 MiB back), coded with the
predefined FSE tables.  The output differs from ``zstandard``'s (the
format leaves the encoder free); both decoders read it.  Its
``level`` is accepted and ignored.

Decoding walks Huffman streams from tables of every bit position
(numpy) and sequences per symbol in python; neither is fast (the
host's MB/s are in PERF.md).
"""

from __future__ import annotations

import struct
from typing import List, Optional, Sequence, Tuple

import numpy as np

MAGIC = 0xFD2FB528
SKIPPABLE_MASK, SKIPPABLE_MAGIC = 0xFFFFFFF0, 0x184D2A50
BLOCK_MAX = 128 << 10
#: the largest frame written single-segment (libzstd's default window limit)
SINGLE_SEGMENT_MAX = 1 << 27
#: the match finder's segment: matches reach at most two segments back
_SEGMENT = 1 << 20
_WINDOW_LOG = 21
_MIN_MATCH = 4

M64 = (1 << 64) - 1


class ZstdError(ValueError):
    """A zstd frame the decoder cannot read."""


class ZstdDictionaryError(ZstdError, NotImplementedError):
    """The frame names a dictionary, which the port does not have."""


class ZstdFormatError(ZstdError):
    """A reserved field, block type or table the format forbids."""


class ZstdTruncatedError(ZstdError):
    """The input, a block or a bitstream ends early, or a bitstream
    does not end on its padding bit."""


class ZstdChecksumError(ZstdError):
    """The content checksum does not match the decoded bytes."""


class ZstdSizeError(ZstdError):
    """The frame decodes to another size than its header says."""


# ------------------------------------------------------------------ xxh64

_P1, _P2, _P3 = 11400714785074694791, 14029467366897019727, 1609587929392839161
_P4, _P5 = 9650029242287828579, 2870177450012600261


def xxh64(data: bytes, seed: int = 0) -> int:
    """xxHash64 of ``data`` (the zstd content checksum's hash)."""
    n = len(data)
    pos = 0
    if n >= 32:
        v1, v2, v3, v4 = (seed + _P1 + _P2) & M64, (seed + _P2) & M64, seed & M64, (seed - _P1) & M64
        lanes = struct.unpack_from(f"<{(n // 32) * 4}Q", data)
        for k in range(0, len(lanes), 4):
            v1 = (v1 + lanes[k] * _P2) & M64
            v1 = (((v1 << 31) | (v1 >> 33)) & M64) * _P1 & M64
            v2 = (v2 + lanes[k + 1] * _P2) & M64
            v2 = (((v2 << 31) | (v2 >> 33)) & M64) * _P1 & M64
            v3 = (v3 + lanes[k + 2] * _P2) & M64
            v3 = (((v3 << 31) | (v3 >> 33)) & M64) * _P1 & M64
            v4 = (v4 + lanes[k + 3] * _P2) & M64
            v4 = (((v4 << 31) | (v4 >> 33)) & M64) * _P1 & M64
        pos = len(lanes) * 8
        h = (_rotl(v1, 1) + _rotl(v2, 7) + _rotl(v3, 12) + _rotl(v4, 18)) & M64
        for v in (v1, v2, v3, v4):
            h = ((h ^ _round(0, v)) * _P1 + _P4) & M64
    else:
        h = (seed + _P5) & M64
    h = (h + n) & M64
    while pos + 8 <= n:
        (k,) = struct.unpack_from("<Q", data, pos)
        h = (_rotl(h ^ _round(0, k), 27) * _P1 + _P4) & M64
        pos += 8
    if pos + 4 <= n:
        (k,) = struct.unpack_from("<I", data, pos)
        h = (_rotl(h ^ (k * _P1 & M64), 23) * _P2 + _P3) & M64
        pos += 4
    while pos < n:
        h = _rotl(h ^ (data[pos] * _P5 & M64), 11) * _P1 & M64
        pos += 1
    h ^= h >> 33
    h = h * _P2 & M64
    h ^= h >> 29
    h = h * _P3 & M64
    return h ^ (h >> 32)


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & M64


def _round(acc: int, lane: int) -> int:
    acc = (acc + lane * _P2) & M64
    return _rotl(acc, 31) * _P1 & M64


# ------------------------------------------------------------ code tables

LL_BASE = list(range(16)) + [16, 18, 20, 22, 24, 28, 32, 40, 48, 64, 128, 256, 512, 1024, 2048, 4096, 8192,
                             16384, 32768, 65536]
LL_BITS = [0] * 16 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16]
ML_BASE = list(range(3, 35)) + [35, 37, 39, 41, 43, 47, 51, 59, 67, 83, 99, 131, 259, 515, 1027, 2051, 4099, 8195,
                                16387, 32771, 65539]
ML_BITS = [0] * 32 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16]

LL_DEFAULT = ([4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1]
              + [-1] * 4, 6)
ML_DEFAULT = ([1, 4, 3, 2, 2, 2, 2, 2, 2] + [1] * 37 + [-1] * 7, 6)
OF_DEFAULT = ([1, 1, 1, 1, 1, 1, 2, 2, 2] + [1] * 15 + [-1] * 5, 5)

# (max accuracy log, max symbol) of each sequence code table
LL_LIMITS, ML_LIMITS, OF_LIMITS = (9, 35), (9, 52), (8, 31)

FseTable = Tuple[List[int], List[int], List[int], int]  # symbol, nb_bits, baseline per state; accuracy log


def fse_table(norm: Sequence[int], log: int) -> FseTable:
    """The decoding table of a normalized distribution (-1: a
    probability below one, given one cell at the top of the table)."""
    size = 1 << log
    symbol = [0] * size
    high = size - 1
    nxt = [0] * len(norm)
    for s, c in enumerate(norm):
        if c == -1:
            symbol[high] = s
            high -= 1
            nxt[s] = 1
        else:
            nxt[s] = c
    step = (size >> 1) + (size >> 3) + 3
    mask = size - 1
    pos = 0
    for s, c in enumerate(norm):
        for _ in range(c if c > 0 else 0):
            symbol[pos] = s
            pos = (pos + step) & mask
            while pos > high:
                pos = (pos + step) & mask
    if pos != 0:
        raise ZstdFormatError("FSE distribution does not fill its table")
    nb = [0] * size
    base = [0] * size
    for u in range(size):
        s = symbol[u]
        x = nxt[s]
        nxt[s] += 1
        nb[u] = log - (x.bit_length() - 1)
        base[u] = (x << nb[u]) - size
    return symbol, nb, base, log


def _rle_table(sym: int) -> FseTable:
    return [sym], [0], [0], 0


def read_fse_description(data: bytes, off: int, end: int, max_log: int, max_symbol: int) -> Tuple[List[int], int, int]:
    """(normalized counts, accuracy log, offset after) of an FSE table
    description at ``data[off:end]``."""
    if off >= end:
        raise ZstdTruncatedError("FSE table description missing")
    v = int.from_bytes(data[off:min(end, off + 1024)], "little")
    avail = 8 * (min(end, off + 1024) - off)
    log = (v & 15) + 5
    if log > max_log:
        raise ZstdFormatError(f"FSE accuracy log {log} above {max_log}")
    bit = 4
    remaining = (1 << log) + 1
    threshold = 1 << log
    nbits = log + 1
    norm: List[int] = []
    prev0 = False
    while remaining > 1 and len(norm) <= max_symbol:
        if prev0:
            n0 = len(norm)
            while True:
                flag = (v >> bit) & 3
                bit += 2
                n0 += flag
                if flag != 3:
                    break
            if n0 > max_symbol + 1:
                raise ZstdFormatError("FSE description: zero run past the last symbol")
            norm += [0] * (n0 - len(norm))
            if len(norm) > max_symbol:
                break
        mx = (2 * threshold - 1) - remaining
        low = (v >> bit) & (threshold - 1)
        if low < mx:
            count = low
            bit += nbits - 1
        else:
            count = (v >> bit) & (2 * threshold - 1)
            if count >= threshold:
                count -= mx
            bit += nbits
        count -= 1
        remaining -= -count if count < 0 else count
        norm.append(count)
        prev0 = count == 0
        while remaining < threshold:
            nbits -= 1
            threshold >>= 1
        if bit > avail:
            raise ZstdTruncatedError("FSE table description ends early")
    if remaining != 1:
        raise ZstdFormatError("FSE description's counts do not sum to its table")
    return norm, log, off + (bit + 7) // 8


_PREDEFINED = {"ll": fse_table(*LL_DEFAULT), "ml": fse_table(*ML_DEFAULT), "of": fse_table(*OF_DEFAULT)}


# ------------------------------------------------------------ bitstreams


def _backward_start(stream: bytes) -> int:
    """The number of bits below the padding bit of a backward stream."""
    if not stream or stream[-1] == 0:
        raise ZstdTruncatedError("bitstream without its padding bit")
    return 8 * (len(stream) - 1) + stream[-1].bit_length() - 1


class _Backward:
    """Reads a backward bitstream from its padding bit down."""

    def __init__(self, stream: bytes):
        self.s = bytes(stream) + bytes(9)
        self.pos = _backward_start(stream)

    def read(self, n: int) -> int:
        p = self.pos - n
        if p < 0:
            raise ZstdTruncatedError("bitstream read past its start")
        self.pos = p
        return (int.from_bytes(self.s[p >> 3:(p >> 3) + 9], "little") >> (p & 7)) & ((1 << n) - 1)

    def read_zero_fill(self, n: int) -> int:
        """``read`` where bits past the start read as zeros; ``pos``
        goes negative (an overflow)."""
        p = self.pos - n
        self.pos = p
        if p >= 0:
            return (int.from_bytes(self.s[p >> 3:(p >> 3) + 9], "little") >> (p & 7)) & ((1 << n) - 1)
        return (int.from_bytes(self.s[:9], "little") << -p) & ((1 << n) - 1)


def pack_bits(values: Sequence[int], widths: Sequence[int]) -> bytes:
    """A backward bitstream: ``values`` written low bit first in order
    (each below 2^width), then the padding bit; a reader from the end
    gets them last first."""
    v = np.asarray(values, dtype=np.uint64)
    w = np.asarray(widths, dtype=np.int64)
    total = int(w.sum())
    rep = np.repeat(np.arange(v.shape[0]), w)
    shift = (np.arange(total) - np.repeat(np.cumsum(w) - w, w)).astype(np.uint64)
    bits = np.empty(total + 1, dtype=np.uint8)
    bits[:total] = (v[rep] >> shift) & np.uint64(1)
    bits[total] = 1
    return np.packbits(bits, bitorder="little").tobytes()


# ------------------------------------------------------------- literals


class _Huffman:
    """A literal decoding table: symbol and code length of every
    ``max_bits``-bit window."""

    def __init__(self, weights: List[int]):
        total = sum(1 << (w - 1) for w in weights if w)
        if total == 0:
            raise ZstdFormatError("Huffman weights all zero")
        max_bits = total.bit_length()
        left = (1 << max_bits) - total
        if left & (left - 1):
            raise ZstdFormatError("Huffman weights leave no power of two for the last symbol")
        weights = weights + [left.bit_length()]
        if max_bits > 11:
            raise ZstdFormatError(f"Huffman code of {max_bits} bits (at most 11)")
        sym = np.zeros(1 << max_bits, dtype=np.uint8)
        ln = np.zeros(1 << max_bits, dtype=np.int64)
        pos = 0
        for w in range(1, max_bits + 1):
            for s, ws in enumerate(weights):
                if ws == w:
                    k = 1 << (w - 1)
                    sym[pos:pos + k] = s
                    ln[pos:pos + k] = max_bits + 1 - w
                    pos += k
        self.sym, self.len, self.max_bits = sym, ln, max_bits

    def decode(self, stream: bytes, n: int) -> bytes:
        """``n`` literals of one Huffman stream, which they must use up."""
        total = _backward_start(stream)
        bits = np.unpackbits(np.frombuffer(stream, dtype=np.uint8), bitorder="little")[:total][::-1]
        mb = self.max_bits
        padded = np.concatenate([bits, np.zeros(mb, dtype=np.uint8)]).astype(np.int64)
        win = np.zeros(total, dtype=np.int64)
        for j in range(mb):
            win = (win << 1) | padded[j:j + total]
        steps = self.len[win].tolist()
        path = [0] * n
        p = 0
        try:
            for i in range(n):
                path[i] = p
                p += steps[p]
        except IndexError:
            raise ZstdTruncatedError("Huffman stream ends before its literals") from None
        if p != total:
            raise ZstdTruncatedError(f"Huffman stream: {total - p} bits left after its literals")
        return self.sym[win[path]].tobytes() if n else b""


def _huffman_description(data: bytes, off: int, end: int) -> Tuple[_Huffman, int]:
    if off >= end:
        raise ZstdTruncatedError("Huffman tree description missing")
    head = data[off]
    off += 1
    if head >= 128:
        n = head - 127
        nbytes = (n + 1) // 2
        if off + nbytes > end:
            raise ZstdTruncatedError("Huffman weights end early")
        weights = []
        for b in data[off:off + nbytes]:
            weights += [b >> 4, b & 15]
        return _Huffman(weights[:n]), off + nbytes
    if off + head > end:
        raise ZstdTruncatedError("Huffman weights end early")
    norm, log, start = read_fse_description(data, off, off + head, 6, 255)
    table = fse_table(norm, log)
    weights = _fse_two_states(table, data[start:off + head])
    return _Huffman(weights), off + head


def _fse_two_states(table: FseTable, stream: bytes) -> List[int]:
    """Huffman weights: two FSE states take turns over one backward
    stream; when an update reads past its start, the other state's
    symbol is the last."""
    sym, nb, base, log = table
    r = _Backward(stream)
    states = [r.read(log), r.read(log)]
    out: List[int] = []
    cur = 0
    while True:
        st = states[cur]
        out.append(sym[st])
        states[cur] = base[st] + r.read_zero_fill(nb[st])
        if r.pos < 0:
            out.append(sym[states[1 - cur]])
            break
        if len(out) > 255:
            break
        cur ^= 1
    if len(out) > 255:
        raise ZstdFormatError("more than 255 Huffman weights")
    return out


def _literals(data: bytes, off: int, end: int, state: "_FrameState") -> Tuple[bytes, int]:
    b0 = data[off]
    kind, fmt = b0 & 3, (b0 >> 2) & 3
    if kind < 2:
        if fmt in (0, 2):
            regen, off = b0 >> 3, off + 1
        elif fmt == 1:
            regen, off = (b0 >> 4) | (data[off + 1] << 4), off + 2
        else:
            regen, off = (b0 >> 4) | (data[off + 1] << 4) | (data[off + 2] << 12), off + 3
        if regen > BLOCK_MAX:
            raise ZstdFormatError(f"{regen} literals in a block")
        if kind == 0:
            if off + regen > end:
                raise ZstdTruncatedError("raw literals end early")
            return data[off:off + regen], off + regen
        if off >= end:
            raise ZstdTruncatedError("RLE literal missing")
        return bytes([data[off]]) * regen, off + 1
    hsize, bits = ((3, 10), (3, 10), (4, 14), (5, 18))[fmt]
    if off + hsize > end:
        raise ZstdTruncatedError("literals header ends early")
    hv = int.from_bytes(data[off:off + hsize], "little") >> 4
    regen, comp = hv & ((1 << bits) - 1), hv >> bits
    four = fmt != 0
    off += hsize
    stop = off + comp
    if stop > end:
        raise ZstdTruncatedError("compressed literals end early")
    if regen > BLOCK_MAX:
        raise ZstdFormatError(f"{regen} literals in a block")
    if kind == 2:
        state.huffman, off = _huffman_description(data, off, stop)
    elif state.huffman is None:
        raise ZstdFormatError("treeless literals with no earlier Huffman table in the frame")
    huf = state.huffman
    if not four:
        return huf.decode(data[off:stop], regen), stop
    if off + 6 > stop:
        raise ZstdTruncatedError("jump table ends early")
    s1, s2, s3 = struct.unpack_from("<HHH", data, off)
    off += 6
    s4 = stop - off - s1 - s2 - s3
    if s4 < 1:
        raise ZstdTruncatedError("four Huffman streams overrun their literals")
    each = (regen + 3) // 4
    counts = (each, each, each, regen - 3 * each)
    if counts[3] < 0:
        raise ZstdFormatError("four Huffman streams for fewer than four literals")
    parts = []
    for size, count in zip((s1, s2, s3, s4), counts):
        parts.append(huf.decode(data[off:off + size], count))
        off += size
    return b"".join(parts), stop


# ------------------------------------------------------------- sequences


def _seq_table(data: bytes, off: int, end: int, mode: int, key: str, limits, state: "_FrameState"
               ) -> Tuple[FseTable, int]:
    if mode == 0:
        table = _PREDEFINED[key]
    elif mode == 1:
        if off >= end:
            raise ZstdTruncatedError("RLE sequence symbol missing")
        if data[off] > limits[1]:
            raise ZstdFormatError(f"{key} RLE symbol {data[off]} above {limits[1]}")
        table, off = _rle_table(data[off]), off + 1
    elif mode == 2:
        norm, log, off = read_fse_description(data, off, end, limits[0], limits[1])
        table = fse_table(norm, log)
    else:
        table = state.tables.get(key)
        if table is None:
            raise ZstdFormatError(f"{key} Repeat mode with no earlier table in the frame")
    state.tables[key] = table
    return table, off


def _sequences(data: bytes, off: int, end: int, lits: bytes, out: bytearray, state: "_FrameState") -> None:
    """Decode the sequences section at ``data[off:end]`` and execute it
    onto ``out`` with the block's literals."""
    if off >= end:
        raise ZstdTruncatedError("sequences section missing")
    b0 = data[off]
    if b0 == 0:
        if off + 1 != end:
            raise ZstdFormatError("bytes after an empty sequences section")
        out += lits
        return
    if b0 < 128:
        nseq, off = b0, off + 1
    elif b0 < 255:
        nseq, off = ((b0 - 128) << 8) + data[off + 1], off + 2
    else:
        nseq, off = data[off + 1] + (data[off + 2] << 8) + 0x7F00, off + 3
    if off >= end:
        raise ZstdTruncatedError("sequence modes missing")
    modes = data[off]
    off += 1
    if modes & 3:
        raise ZstdFormatError("reserved bits of the sequence modes are set")
    ll_t, off = _seq_table(data, off, end, modes >> 6, "ll", LL_LIMITS, state)
    of_t, off = _seq_table(data, off, end, (modes >> 4) & 3, "of", OF_LIMITS, state)
    ml_t, off = _seq_table(data, off, end, (modes >> 2) & 3, "ml", ML_LIMITS, state)
    stream = data[off:end]
    p = _backward_start(stream)
    s = bytes(stream)
    # per state: (the code's base value, its extra bits, the state's
    # update bits, its baseline), one lookup a stream a sequence
    ll_sym, ll_nb, ll_base, ll_log = ll_t
    of_sym, of_nb, of_base, of_log = of_t
    ml_sym, ml_nb, ml_base, ml_log = ml_t
    if max(of_sym) > 31:
        raise ZstdFormatError("offset code above 31")
    llt = [(LL_BASE[c], LL_BITS[c], n, b) for c, n, b in zip(ll_sym, ll_nb, ll_base)]
    mlt = [(ML_BASE[c], ML_BITS[c], n, b) for c, n, b in zip(ml_sym, ml_nb, ml_base)]
    oft = [(1 << c, c, n, b) for c, n, b in zip(of_sym, of_nb, of_base)]
    # the bits below p sit in ``win``, an int of the stream's bytes from
    # bit ``lo`` (zeros below the stream's start, which only the last
    # sequence's unused state update may read): shifts stay short, and
    # it is refilled every ~60 bytes
    lo = max(0, (p >> 3) - 64)
    win = int.from_bytes(s[lo:(p >> 3) + 1], "little")
    lo <<= 3
    t = ll_log + of_log + ml_log
    p -= t
    if p < 0:
        raise ZstdTruncatedError("sequences bitstream read past its start")
    v = (win >> (p - lo)) & ((1 << t) - 1)
    ll_s, of_s, ml_s = v >> (of_log + ml_log), (v >> ml_log) & ((1 << of_log) - 1), v & ((1 << ml_log) - 1)
    r0, r1, r2 = state.rep
    lp = 0
    nlits = len(lits)
    u = 0
    for _ in range(nseq):
        llbase, llb, lln, llst = llt[ll_s]
        mlbase, mlb, mln, mlst = mlt[ml_s]
        ofbase, ofb, ofn, ofst = oft[of_s]
        # the extras (offset, match, literal length), then the state
        # updates (literal length, match, offset): one read
        u = lln + mln + ofn
        t = ofb + mlb + llb + u
        p -= t
        if p < lo:
            if p + u < 0:
                raise ZstdTruncatedError("sequences bitstream read past its start")
            hi = (p + t + 7) >> 3
            lo = (p >> 3) - 64
            win = int.from_bytes(s[max(0, lo):hi], "little") << (8 * max(0, -lo))
            lo <<= 3
        v = (win >> (p - lo)) & ((1 << t) - 1)
        w = v & ((1 << u) - 1)
        v >>= u
        ll_s = llst + (w >> (mln + ofn))
        ml_s = mlst + ((w >> ofn) & ((1 << mln) - 1))
        of_s = ofst + (w & ((1 << ofn) - 1))
        ll = llbase + (v & ((1 << llb) - 1))
        ml = mlbase + ((v >> llb) & ((1 << mlb) - 1))
        ofv = ofbase + (v >> (llb + mlb))
        if ofv > 3:
            offset = ofv - 3
            r0, r1, r2 = offset, r0, r1
        else:
            k = ofv + (ll == 0)
            if k == 1:
                offset = r0
            elif k == 2:
                offset = r1
                r0, r1 = r1, r0
            elif k == 3:
                offset = r2
                r0, r1, r2 = r2, r0, r1
            else:
                offset = r0 - 1
                r0, r1, r2 = offset, r0, r1
        if ll:
            if lp + ll > nlits:
                raise ZstdFormatError("a sequence reads past the block's literals")
            out += lits[lp:lp + ll]
            lp += ll
        start = len(out) - offset
        if offset <= 0 or start < 0:
            raise ZstdFormatError(f"match offset {offset} outside the {len(out)} bytes decoded")
        if offset >= ml:
            out += out[start:start + ml]
        else:
            out += (out[start:] * (ml // offset + 1))[:ml]
    # the last sequence reads no state update: its bits are the ones past the start
    p += u
    if p != 0:
        raise ZstdTruncatedError(f"sequences bitstream: {p} bits left after its sequences")
    state.rep = (r0, r1, r2)
    out += lits[lp:]


# ---------------------------------------------------------------- frames


class _FrameState:
    """What the blocks of one frame share."""

    def __init__(self):
        self.huffman: Optional[_Huffman] = None
        self.tables: dict = {}
        self.rep = (1, 4, 8)


def _frame(data: bytes, off: int, out_parts: List[bytes]) -> int:
    n = len(data)
    if off >= n:
        raise ZstdTruncatedError("frame header ends early")
    fhd = data[off]
    off += 1
    fcs_flag, single, checksum, dict_flag = fhd >> 6, (fhd >> 5) & 1, (fhd >> 2) & 1, fhd & 3
    if fhd & 8:
        raise ZstdFormatError("reserved bit of the frame header descriptor is set")
    if not single:
        if off >= n:
            raise ZstdTruncatedError("window descriptor missing")
        off += 1
    did_size = (0, 1, 2, 4)[dict_flag]
    fcs_size = (1 if single else 0, 2, 4, 8)[fcs_flag]
    if off + did_size + fcs_size > n:
        raise ZstdTruncatedError("frame header ends early")
    did = int.from_bytes(data[off:off + did_size], "little")
    off += did_size
    if did:
        raise ZstdDictionaryError(f"frame needs dictionary {did}")
    fcs = None
    if fcs_size:
        fcs = int.from_bytes(data[off:off + fcs_size], "little") + (256 if fcs_size == 2 else 0)
        off += fcs_size
    out = bytearray()
    state = _FrameState()
    while True:
        if off + 3 > n:
            raise ZstdTruncatedError("block header ends early")
        bh = int.from_bytes(data[off:off + 3], "little")
        off += 3
        last, btype, bsize = bh & 1, (bh >> 1) & 3, bh >> 3
        if btype == 3:
            raise ZstdFormatError("reserved block type")
        if btype == 1:
            if off >= n:
                raise ZstdTruncatedError("RLE block ends early")
            if bsize > BLOCK_MAX:
                raise ZstdFormatError(f"RLE block of {bsize} bytes")
            out += bytes([data[off]]) * bsize
            off += 1
        else:
            if bsize > BLOCK_MAX:
                raise ZstdFormatError(f"block of {bsize} bytes")
            if off + bsize > n:
                raise ZstdTruncatedError("block ends early")
            if btype == 0:
                out += data[off:off + bsize]
            else:
                before = len(out)
                lits, loff = _literals(data, off, off + bsize, state)
                _sequences(data, loff, off + bsize, lits, out, state)
                if len(out) - before > BLOCK_MAX:
                    raise ZstdFormatError("a block decodes to more than 128 KiB")
            off += bsize
        if fcs is not None and len(out) > fcs:
            raise ZstdSizeError(f"frame decodes past its content size {fcs}")
        if last:
            break
    if fcs is not None and len(out) != fcs:
        raise ZstdSizeError(f"frame decodes to {len(out)} bytes, its content size is {fcs}")
    if checksum:
        if off + 4 > n:
            raise ZstdTruncatedError("content checksum missing")
        (want,) = struct.unpack_from("<I", data, off)
        off += 4
        got = xxh64(bytes(out)) & 0xFFFFFFFF
        if got != want:
            raise ZstdChecksumError(f"content checksum {got:#010x}, the frame says {want:#010x}")
    out_parts.append(bytes(out))
    return off


def decompress(data: bytes) -> bytes:
    """The content of every frame in ``data``, in order (skippable
    frames skipped)."""
    data = bytes(data)
    if not data:
        raise ZstdTruncatedError("no zstd frame")
    parts: List[bytes] = []
    off = 0
    n = len(data)
    while off < n:
        if off + 4 > n:
            raise ZstdTruncatedError("frame magic ends early")
        (magic,) = struct.unpack_from("<I", data, off)
        if magic & SKIPPABLE_MASK == SKIPPABLE_MAGIC:
            if off + 8 > n:
                raise ZstdTruncatedError("skippable frame header ends early")
            off += 8 + struct.unpack_from("<I", data, off + 4)[0]
            if off > n:
                raise ZstdTruncatedError("skippable frame ends early")
            continue
        if magic != MAGIC:
            raise ZstdFormatError(f"not a zstd frame (magic {magic:#010x})")
        try:
            off = _frame(data, off + 4, parts)
        except (IndexError, struct.error) as e:
            # a header field read past the end of the input
            raise ZstdTruncatedError(f"frame ends early ({e})") from e
    return b"".join(parts)


# --------------------------------------------------------------- encoder


_POW2 = 1 << np.arange(40, dtype=np.int64)


def _bit_length(x: np.ndarray) -> np.ndarray:
    return np.searchsorted(_POW2, x, side="right")


def _codes(values: np.ndarray, bases: Sequence[int], direct: int, past: int) -> np.ndarray:
    """The code of each value: the last base at or below it, from a
    table below ``direct``, its bit length + ``past`` from there."""
    table = np.searchsorted(np.asarray(bases), np.arange(direct), side="right") - 1
    return np.where(values < direct, table[np.minimum(values, direct - 1)], _bit_length(values) + past)


def _fse_encoder(table: FseTable) -> List[List[int]]:
    """Per symbol, the state to leave from for every next state."""
    sym, nb, base, log = table
    enc = [[-1] * (1 << log) for _ in range(max(sym) + 1)]
    for u, s in enumerate(sym):
        row = enc[s]
        for t in range(base[u], base[u] + (1 << nb[u])):
            row[t] = u
    return enc


_ENCODERS = {k: _fse_encoder(t) for k, t in _PREDEFINED.items()}


def _chain(enc: List[List[int]], codes: List[int]) -> List[int]:
    """The encoder's state before each symbol, last symbol first."""
    u = enc[codes[-1]][0]
    states = [u]
    append = states.append
    for c in reversed(codes[:-1]):
        u = enc[c][u]
        append(u)
    return states


def _sequence_section(ll: np.ndarray, offset: np.ndarray, ml: np.ndarray) -> bytes:
    """The sequences section of (literal length, offset, match length)
    triples, coded with the predefined tables: every offset as itself
    (offset value = offset + 3), no repeat offset."""
    n = ll.shape[0]
    if n < 128:
        head = bytes([n])
    elif n < 0x7F00:
        head = bytes([(n >> 8) + 128, n & 0xFF])
    else:
        head = bytes([255, (n - 0x7F00) & 0xFF, (n - 0x7F00) >> 8])
    llc = _codes(ll, LL_BASE, 64, 18)
    mlc = _codes(ml - 3, [b - 3 for b in ML_BASE], 128, 35)
    ofv = offset + 3
    ofc = _bit_length(ofv) - 1
    extras = np.stack([ll - np.asarray(LL_BASE)[llc], ml - np.asarray(ML_BASE)[mlc], ofv - (1 << ofc)], 1)
    xbits = np.stack([np.asarray(LL_BITS)[llc], np.asarray(ML_BITS)[mlc], ofc], 1)
    cols = []
    for key, codes in (("of", ofc), ("ml", mlc), ("ll", llc)):
        _, nb, base, log = _PREDEFINED[key]
        u = np.asarray(_chain(_ENCODERS[key], codes.tolist()), dtype=np.int64)[::-1]  # state of each sequence
        nb, base = np.asarray(nb), np.asarray(base)
        # the update after sequence k leaves state u[k] for u[k + 1]
        cols.append((u[1:] - base[u[:-1]], nb[u[:-1]], u[0], log))
    # write order: the last sequence's extras, then for k = n-2 .. 0 the
    # updates (OF, ML, LL) and the extras (LL, ML, OF), then the initial
    # states (ML, OF, LL): the reverse of the decoder's reads
    vals = np.empty((n - 1, 6), dtype=np.int64)
    widths = np.empty((n - 1, 6), dtype=np.int64)
    for c, (v, w, _, _) in enumerate(cols):
        vals[:, c], widths[:, c] = v, w
    vals[:, 3:] = extras[:-1]
    widths[:, 3:] = xbits[:-1]
    (_, _, of0, of_log), (_, _, ml0, ml_log), (_, _, ll0, ll_log) = cols
    v_all = np.concatenate([extras[-1], vals[::-1].ravel(), [ml0, of0, ll0]])
    w_all = np.concatenate([xbits[-1], widths[::-1].ravel(), [ml_log, of_log, ll_log]])
    return head + b"\x00" + pack_bits(v_all, w_all)


def _raw_literals(lits: bytes) -> bytes:
    n = len(lits)
    if n < 32:
        return bytes([n << 3]) + lits
    if n < 4096:
        return bytes([((n & 15) << 4) | 4, n >> 4]) + lits
    return bytes([((n & 15) << 4) | 12, (n >> 4) & 0xFF, n >> 12]) + lits


def _candidates(a: np.ndarray, lo: int, hi: int) -> np.ndarray:
    """For each position of ``[lo, hi - 3)``, the latest earlier
    position (from one segment back) holding the same 4 bytes, or -1."""
    h = max(0, lo - _SEGMENT)
    m = hi - 3 - h
    if m <= 0:
        return np.full(max(0, hi - 3 - lo), -1, dtype=np.int64)
    w = a[h:hi].astype(np.uint32)
    key = w[:m] | (w[1:m + 1] << 8) | (w[2:m + 2] << 16) | (w[3:m + 3] << 24)
    # one sort of (key, position) packed in 64 bits: equal keys in
    # position order
    packed = np.sort((key.astype(np.uint64) << np.uint64(32)) | np.arange(m, dtype=np.uint64))
    order = (packed & np.uint64(0xFFFFFFFF)).astype(np.int64)
    sk = packed >> np.uint64(32)
    prev = np.empty(m, dtype=np.int64)
    prev[order[0]] = -1
    prev[order[1:]] = np.where(sk[1:] == sk[:-1], order[:-1] + h, -1)
    return prev[lo - h:]


#: 8-byte steps the match lengths take in numpy
_VECTOR_STEPS = 4


def _words(windows: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """The little-endian uint64 at each byte position ``idx``."""
    return np.ascontiguousarray(windows[idx]).view("<u8").ravel()


def _match_lengths(windows: np.ndarray, c: np.ndarray, j: np.ndarray, limit: np.ndarray) -> np.ndarray:
    """The length of the match at each candidate ``c`` against ``j < c``
    (4 bytes known equal), at most ``limit - c``: measured 8 bytes at a
    time for ``_VECTOR_STEPS`` steps, and at least as long as the run
    of following candidates that keep its offset (a repeat's length).
    A match longer than both is cut, and the parse takes up its rest.
    ``windows`` holds the input's 8 bytes at every position."""
    length = np.full(c.shape, _MIN_MATCH, dtype=np.int64)
    open_ = np.arange(c.shape[0])
    for _ in range(_VECTOR_STEPS):
        if not open_.size:
            break
        x = _words(windows, c[open_] + length[open_]) ^ _words(windows, j[open_] + length[open_])
        same = x == 0
        low = x & (~x + np.uint64(1))
        equal = np.where(same, 8, np.log2(np.where(same, 1, low).astype(np.float64)).astype(np.int64) >> 3)
        length[open_] += equal
        open_ = open_[same]
    if c.shape[0]:
        brk = np.flatnonzero((c[1:] != c[:-1] + 1) | (j[1:] != j[:-1] + 1))
        run_end = np.append(brk, c.shape[0] - 1)[np.searchsorted(brk, np.arange(c.shape[0]))]
        length = np.maximum(length, c[run_end] - c + _MIN_MATCH)
    return np.minimum(length, limit - c)


def _segment_blocks(src: bytes, a: np.ndarray, windows: np.ndarray, lo: int, hi: int):
    """Greedy parse of the segment ``src[lo:hi]`` into blocks of at
    most 128 KiB, no match crossing a block's end: per block
    ``(start, end, literal lengths, offsets, match lengths, literals)``."""
    prev = _candidates(a, lo, hi)
    pos = np.flatnonzero(prev >= 0) + lo
    block_end = np.minimum((pos - lo) // BLOCK_MAX * BLOCK_MAX + lo + BLOCK_MAX, hi)
    pos = pos[pos + _MIN_MATCH <= block_end]
    block_end = np.minimum((pos - lo) // BLOCK_MAX * BLOCK_MAX + lo + BLOCK_MAX, hi)
    j = prev[pos - lo]
    length = _match_lengths(windows, pos, j, block_end)
    nxt = np.searchsorted(pos, pos + length).tolist()
    path = []
    t, n = 0, len(nxt)
    while t < n:
        path.append(t)
        t = nxt[t]
    p = pos[path]
    ml = length[path]
    offsets = p - j[path]
    ends = p + ml
    block = (p - lo) // BLOCK_MAX
    covered = np.zeros(hi - lo + 1, dtype=np.int64)
    np.add.at(covered, p - lo, 1)
    np.add.at(covered, ends - lo, -1)
    literal = np.cumsum(covered[:-1]) == 0
    out = []
    for b, start in enumerate(range(lo, hi, BLOCK_MAX)):
        end = min(hi, start + BLOCK_MAX)
        k0, k1 = np.searchsorted(block, [b, b + 1])
        bp, be = p[k0:k1], ends[k0:k1]
        anchors = np.concatenate([[start], be[:-1]]).astype(np.int64)
        lits = a[start:end][literal[start - lo:end - lo]].tobytes()
        out.append((start, end, bp - anchors, offsets[k0:k1], ml[k0:k1], lits))
    return out


def compress(data: bytes, level: Optional[int] = None) -> bytes:
    """One zstd frame of ``data``, with its content size and no content
    checksum (the IPC frames carry a checksum of their own).  ``level``
    is accepted and ignored: the encoder has one setting."""
    src = bytes(data)
    n = len(src)
    single = n <= SINGLE_SEGMENT_MAX
    if n < 256 and single:
        fcs_flag, fcs = 0, bytes([n])
    elif n < 65536 + 256:
        fcs_flag, fcs = 1, struct.pack("<H", n - 256)
    elif n < 1 << 32:
        fcs_flag, fcs = 2, struct.pack("<I", n)
    else:
        fcs_flag, fcs = 3, struct.pack("<Q", n)
    out = bytearray(struct.pack("<I", MAGIC))
    out.append((fcs_flag << 6) | (single << 5))
    if not single:
        out.append((_WINDOW_LOG - 10) << 3)
    out += fcs
    if n == 0:
        out += b"\x01\x00\x00"
    a = np.frombuffer(src, dtype=np.uint8)
    # every position's 8-byte window (zero past the end, as far as a
    # match's vector steps read)
    pad = 8 * (_VECTOR_STEPS + 2) + _MIN_MATCH
    windows = np.lib.stride_tricks.sliding_window_view(np.concatenate([a, np.zeros(pad, dtype=np.uint8)]), 8)
    for seg_lo in range(0, n, _SEGMENT):
        for start, end, ll, offsets, ml, lits in _segment_blocks(src, a, windows, seg_lo, min(n, seg_lo + _SEGMENT)):
            last = int(end == n)
            size = end - start
            if src[start:end].count(src[start]) == size:
                out += struct.pack("<I", last | (1 << 1) | (size << 3))[:3]
                out.append(src[start])
                continue
            body = _raw_literals(lits) + _sequence_section(ll, offsets, ml) if ll.shape[0] else b""
            if body and len(body) < size:
                out += struct.pack("<I", last | (2 << 1) | (len(body) << 3))[:3]
                out += body
            else:
                out += struct.pack("<I", last | (size << 3))[:3]
                out += src[start:end]
    return bytes(out)

