"""The port's zstd codec (``blaze_tpu_torch/io/zstd.py``) against the
``zstandard`` package and the JAX package.

The port decodes ``zstandard``'s frames at levels 1, 3, 19 and -5, of
0 bytes to 1 MiB of random, repetitive and real shuffle-block bytes,
with and without a content size and a checksum, concatenated and
between skippable frames, and the committed fixtures
(``tests/data/zstd``, which the smoke decodes on the card's machine);
``zstandard`` decodes the port's frames; frames built by hand reach
the paths ``zstandard`` does not write (direct Huffman weights, RLE
literals, Repeat-mode tables); each malformed frame raises its typed
error, and seeded corruptions raise one or decode.  Shuffle files written under ``spark.io.compression.codec=zstd``
carry q06 and q01 through ``run_stages``, and the reference's frame
reader and the port's read each other's files.
"""

import hashlib
import io
import json
import os
import struct
from pathlib import Path

import numpy as np
import pytest
import zstandard

from blaze_tpu.io import ipc_compression as JIC

import blaze_tpu_torch
import blaze_tpu_torch.batch as TB
from blaze_tpu_torch import conf
from blaze_tpu_torch.io import ipc_compression as IC
from blaze_tpu_torch.io import zstd as Z
from blaze_tpu_torch.io.batch_serde import serialize_columns
from blaze_tpu_torch.ops import MemoryScanExec
from blaze_tpu_torch.runtime import integrity
from blaze_tpu_torch.runtime import scheduler as S
from blaze_tpu_torch.runtime.context import RESOURCES
from blaze_tpu_torch.tpch import TPCH_SCHEMAS, build_query
from blaze_tpu_torch.tpch import oracle as O
from blaze_tpu_torch.tpch.datagen import generate_all

FIXTURES = Path(__file__).resolve().parent / "data" / "zstd"
SIZES = [0, 1, 100, 128 << 10, (128 << 10) + 1, 1 << 20]
LEVELS = [1, 3, 19, -5]
KINDS = ["random", "repetitive", "shuffle"]
SCALE = 0.002
N_PARTS = 2


@pytest.fixture(scope="module")
def tables():
    return generate_all(SCALE)


@pytest.fixture(scope="module")
def contents(tables):
    """kind -> 1 MiB of bytes: seeded random bytes, a short pattern
    repeated, and the wire bytes of lineitem's shuffle columns."""
    li = tables["lineitem"]
    cols = ["l_orderkey", "l_quantity", "l_extendedprice", "l_discount", "l_shipdate", "l_returnflag"]
    n = li["l_orderkey"][0].shape[0]
    host = []
    for c in cols:
        data, lengths = li[c][0], (li[c][1] if len(li[c]) > 1 else None)
        host.append((data, np.ones(n, bool), lengths if lengths is not None and data.ndim == 2 else None))
    block = serialize_columns(host, n)
    return {"random": np.random.default_rng(7).integers(0, 256, 1 << 20, dtype=np.uint8).tobytes(),
            "repetitive": (b"blaze zstd frame " * 70000)[:1 << 20],
            "shuffle": (block * (1 + (1 << 20) // len(block)))[:1 << 20]}


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("level", LEVELS)
def test_decodes_zstandard_frames(contents, level, size, kind):
    data = contents[kind][:size]
    for kw in (dict(), dict(write_content_size=False, write_checksum=True)):
        assert Z.decompress(zstandard.ZstdCompressor(level=level, **kw).compress(data)) == data


def test_decodes_streamed_concatenated_and_skippable_frames(contents):
    a, b = contents["shuffle"][:70000], contents["repetitive"][:5000]
    out = io.BytesIO()
    with zstandard.ZstdCompressor(level=3, write_checksum=True).stream_writer(out, closefd=False) as w:
        for k in range(0, len(a), 7000):
            w.write(a[k:k + 7000])
    streamed = out.getvalue()
    assert Z.decompress(streamed) == a
    skip = struct.pack("<II", 0x184D2A5F, 3) + b"xyz"
    frames = skip + streamed + struct.pack("<II", 0x184D2A50, 0) + zstandard.ZstdCompressor(level=19).compress(b)
    assert Z.decompress(frames) == a + b


@pytest.mark.parametrize("name", sorted(p.stem for p in FIXTURES.glob("*.zst")))
def test_decodes_the_committed_fixtures(name):
    want = json.loads((FIXTURES / "manifest.json").read_text())[name]
    got = Z.decompress((FIXTURES / f"{name}.zst").read_bytes())
    assert len(got) == want["decoded_bytes"] and hashlib.sha256(got).hexdigest() == want["sha256"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("size", SIZES)
def test_zstandard_decodes_the_ports_frames(contents, size, kind):
    data = contents[kind][:size]
    frame = Z.compress(data)
    assert zstandard.ZstdDecompressor().decompress(frame) == data == Z.decompress(frame)
    params = zstandard.get_frame_parameters(frame)
    assert params.content_size == size and not params.has_checksum
    if kind == "repetitive" and size > 1000:
        assert len(frame) < size // 50


def test_xxh64_equals_the_reference_hash():
    # the low 32 bits are the checksum zstandard writes
    for n in (0, 1, 3, 4, 7, 8, 31, 32, 33, 100, 1000):
        data = bytes(range(256))[:n] * (1 + n // 256)
        frame = zstandard.ZstdCompressor(write_checksum=True).compress(data)
        assert Z.xxh64(data) & 0xFFFFFFFF == struct.unpack("<I", frame[-4:])[0]
    assert Z.xxh64(b"") == 0xEF46DB3751D8E999


# ---------------------------------------------------- frames built by hand


def _frame(blocks, content: bytes) -> bytes:
    """A single-segment frame with a 4-byte content size around
    ``blocks`` (each (type, body, decoded size))."""
    out = bytearray(struct.pack("<IB", Z.MAGIC, (2 << 6) | (1 << 5)) + struct.pack("<I", len(content)))
    for i, (btype, body, size) in enumerate(blocks):
        last = int(i == len(blocks) - 1)
        out += struct.pack("<I", last | (btype << 1) | ((size if btype == 1 else len(body)) << 3))[:3] + body
    return bytes(out)


def _huffman_literals(lits: bytes) -> bytes:
    """A literals section of one Huffman stream whose table travels as
    direct 4-bit weights."""
    symbols = sorted(set(lits))
    weights = [0] * (max(symbols) + 1)
    for k, s in enumerate(symbols):  # a complete code: 1, 2, ..., n-1, n-1 bits
        weights[s] = max(1, len(symbols) - k - 1) if k < len(symbols) - 1 else 1
    # weights[w] -> codes: take those of the decoder's table
    table = Z._Huffman(weights[:-1])
    codes = {}
    for idx in range(len(table.sym) - 1, -1, -1):
        codes[int(table.sym[idx])] = (idx >> (table.max_bits - int(table.len[idx])), int(table.len[idx]))
    vals, widths = zip(*[codes[b] for b in reversed(lits)])
    stream = Z.pack_bits(vals, widths)
    n = len(weights) - 1
    packed = bytes((weights[i] << 4) | (weights[i + 1] if i + 1 < n else 0) for i in range(0, n, 2))
    tree = bytes([127 + n]) + packed
    regen, comp = len(lits), len(tree) + len(stream)
    head = (2 | (0 << 2) | (regen << 4) | (comp << 14)).to_bytes(3, "little")
    return head + tree + stream


def test_hand_built_frames_decode_as_zstandard_decodes_them():
    ll, off, ml = np.array([3, 0, 5]), np.array([3, 1, 9]), np.array([4, 6, 5])
    # RLE literals (11 x "q"), predefined sequences
    content = b"q" * 26  # 11 literals, matches of 4 + 6 + 5
    rle = bytes([1 | (11 << 3)]) + b"q"
    body = rle + Z._sequence_section(ll, off, ml)
    frames = [_frame([(2, body, len(content))], content)]
    # Huffman literals with direct weights (libzstd wants them shorter
    # compressed than regenerated)
    lits = b"abacabadabacaba!" * 8
    frames.append(_frame([(2, _huffman_literals(lits) + b"\x00", len(lits))], lits))
    # a second block repeating the first's sequence tables (Repeat mode)
    seqs = Z._sequence_section(np.array([2]), np.array([2]), np.array([6]))
    repeat = seqs[:1] + bytes([0b11111100]) + seqs[2:]
    first, second = b"xy" + b"xyxyxy", b"zw" + b"zwzwzw"
    content = first + second
    frames.append(_frame([(2, bytes([2 << 3]) + b"xy" + seqs, 0), (2, bytes([2 << 3]) + b"zw" + repeat, 0)],
                         content))
    for frame in frames:
        assert Z.decompress(frame) == zstandard.ZstdDecompressor().decompress(frame)


def _single_segment(frame: bytes) -> bytes:
    assert frame[4] >> 6 == 1 and (frame[4] >> 5) & 1  # 2-byte content size, single segment
    return frame


def test_each_malformed_frame_raises_its_typed_error(contents):
    data = contents["shuffle"][:3000]
    frame = _single_segment(Z.compress(data))
    hdr = 4 + 1 + 2  # magic, descriptor, content size
    with pytest.raises(Z.ZstdDictionaryError):
        Z.decompress(frame[:4] + bytes([frame[4] | 1, 9]) + frame[5:])
    assert issubclass(Z.ZstdDictionaryError, NotImplementedError)
    with pytest.raises(Z.ZstdFormatError, match="reserved bit"):
        Z.decompress(frame[:4] + bytes([frame[4] | 8]) + frame[5:])
    bad = bytearray(frame)
    bad[hdr] |= 6  # block type 3
    with pytest.raises(Z.ZstdFormatError, match="reserved block type"):
        Z.decompress(bytes(bad))
    bad = bytearray(_single_segment(zstandard.ZstdCompressor(level=1, write_checksum=True).compress(data)))
    bad[-1] ^= 0x55
    with pytest.raises(Z.ZstdChecksumError):
        Z.decompress(bytes(bad))
    for cut in (2, 5, hdr + 1, hdr + 40, len(frame) - 9, len(frame) - 1):
        with pytest.raises(Z.ZstdTruncatedError):
            Z.decompress(frame[:cut])
    # a size field one short: the output passes the frame content size
    bad = bytearray(frame)
    bad[5:7] = struct.pack("<H", len(data) - 256 - 1)
    with pytest.raises(Z.ZstdSizeError):
        Z.decompress(bytes(bad))
    # the sequences bitstream's last byte lost its padding bit
    bad = bytearray(frame)
    bad[-1] = 0
    with pytest.raises(Z.ZstdTruncatedError, match="padding bit"):
        Z.decompress(bytes(bad))
    # reserved bits of the sequence modes byte
    body = bytes([3 << 3]) + b"abc" + Z._sequence_section(np.array([3]), np.array([3]), np.array([4]))
    hand = bytearray(_frame([(2, body, 0)], b"abcabca"))
    assert Z.decompress(bytes(hand)) == b"abcabca"
    hand[-len(body) + 4 + 1] |= 1
    with pytest.raises(Z.ZstdFormatError, match="reserved bits"):
        Z.decompress(bytes(hand))
    with pytest.raises(Z.ZstdFormatError, match="magic"):
        Z.decompress(b"\x00" * 8)


def test_corrupted_frames_decode_or_raise_a_typed_error(contents):
    """Seeded corruptions of frames of both writers: each decodes (no
    checksum or a field no decoder reads) or raises a ZstdError, never
    another exception."""
    rng = np.random.default_rng(11)
    bases = [zstandard.ZstdCompressor(level=level, write_checksum=ck).compress(contents[kind][:6000])
             for level, ck, kind in ((1, True, "shuffle"), (19, False, "shuffle"), (3, True, "repetitive"))]
    bases.append(Z.compress(contents["shuffle"][:6000]))
    raised = 0
    for trial in range(400):
        frame = bytearray(bases[trial % len(bases)])
        for _ in range(int(rng.integers(1, 4))):
            frame[int(rng.integers(0, len(frame)))] = int(rng.integers(0, 256))
        try:
            Z.decompress(bytes(frame))
        except Z.ZstdError:
            raised += 1
    assert raised > 200


# ---------------------------------------- shuffle files under codec zstd


def _scans(data):
    return {name: MemoryScanExec(TB.table_to_batches(data[name], TPCH_SCHEMAS[name], N_PARTS, 4096, "cpu"),
                                 TPCH_SCHEMAS[name], device="cpu") for name in TPCH_SCHEMAS}


def _run(tables, q, codec):
    """q's rows through run_stages under ``codec`` and every .data
    file's bytes as the run left them."""
    conf.IO_COMPRESSION_CODEC.set(codec)
    files = {}
    try:
        stages, manager = S.split_stages(build_query(q, _scans(tables), N_PARTS))
        cleanup = manager.cleanup

        def keep_then_cleanup():
            for name in os.listdir(manager.root):
                if name.endswith(".data"):
                    files[name] = Path(manager.root, name).read_bytes()
            cleanup()

        manager.cleanup = keep_then_cleanup
        rows = {}
        for b in S.run_stages(stages, manager):
            for k, v in TB.batch_to_pydict(b).items():
                rows.setdefault(k, []).extend(v)
    finally:
        conf.IO_COMPRESSION_CODEC.set(conf.IO_COMPRESSION_CODEC.default)
    assert len(RESOURCES) == 0
    return rows, files


@pytest.mark.parametrize("q", ["q6", "q1"])
def test_shuffle_files_under_zstd_both_ways(tables, q):
    prev = blaze_tpu_torch._default_device
    blaze_tpu_torch.set_default_device("cpu")
    try:
        rows, files = _run(tables, q, "zstd")
        zrows, zfiles = _run(tables, q, "zlib")
    finally:
        blaze_tpu_torch.set_default_device(prev)
    assert rows == zrows and len(files) == len(zfiles)
    if q == "q6":
        assert rows["revenue"] == [O.oracle_q6(tables)]
    else:
        assert len(rows["l_returnflag"]) == len(O.oracle_q1(tables))
    codecs = set()
    every = []
    for blob in files.values():
        off = 0
        while off < len(blob):
            cid, start, ln, off = IC.frame_span(blob, off)
            codecs.add(cid & ~integrity.CHECKSUM_FLAG)
        # the reference's reader takes the port's file, payload for payload
        payloads = list(IC.iter_blob_frames(blob))
        assert list(JIC.iter_blob_frames(blob)) == payloads
        every += payloads
        # and the port's reader the reference's writer's file
        buf = io.BytesIO()
        w = JIC.IpcFrameWriter(buf, "zstd", integrity.ALGO_CRC32)
        for p in payloads:
            w.write(p)
        assert list(IC.iter_stream_frames(io.BytesIO(buf.getvalue()), len(buf.getvalue()))) == payloads
    assert IC.CODEC_ZSTD in codecs
    assert sorted(every) == sorted(p for blob in zfiles.values() for p in IC.iter_blob_frames(blob))
