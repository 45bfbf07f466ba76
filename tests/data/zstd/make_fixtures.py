"""Writes the zstd fixture frames beside this file with the
``zstandard`` package (a reference implementation of the format), and
``manifest.json``: each frame's settings, decoded size and the SHA-256
of its decoded bytes.  The port's decoder must give those bytes
(``tests/test_torch_zstd.py`` and ``chip_smoke.py``, where no
``zstandard`` is installed).  Run once: ``python make_fixtures.py``."""

import hashlib
import json
import struct
from pathlib import Path

import numpy as np
import zstandard

HERE = Path(__file__).resolve().parent
LIMIT = 64 << 10


def _text(n: int, seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    vocab = [bytes(rng.integers(97, 123, rng.integers(2, 9), dtype=np.uint8)) for _ in range(300)]
    # a skewed choice of words: Huffman literals and FSE sequences both
    idx = np.minimum(rng.geometric(0.02, n // 4), len(vocab) - 1)
    return b" ".join(vocab[i] for i in idx)[:n]


def _records(n: int, seed: int) -> bytes:
    """Shuffle-block-like rows: int64 keys, small int32 codes, dates."""
    rng = np.random.default_rng(seed)
    rows = n // 16
    keys = np.repeat(np.arange(rows // 4 + 1) * 32, 4)[:rows].astype("<i8")
    codes = rng.integers(0, 3, rows).astype("<i4")
    dates = (8000 + np.repeat(rng.integers(0, 50, rows // 8 + 1), 8)[:rows]).astype("<i4")
    rec = np.zeros(rows, dtype=[("k", "<i8"), ("c", "<i4"), ("d", "<i4")])
    rec["k"], rec["c"], rec["d"] = keys, codes, dates
    return rec.tobytes()[:n]


def _frames():
    yield "l1_text", dict(level=1), _text(40_000, 1)
    yield "l19_text_checksum", dict(level=19, write_checksum=True), _text(60_000, 2)
    yield "l3_no_content_size", dict(level=3, write_content_size=False), _text(30_000, 3)
    yield "l19_multiblock_records", dict(level=19, write_checksum=True), _records(400_000, 4)
    yield "l1_multiblock_no_size", dict(level=1, write_content_size=False), _records(300_000, 5)
    yield "lneg5_text", dict(level=-5), _text(20_000, 6)


def main() -> None:
    manifest = {}
    for name, kw, content in _frames():
        frame = zstandard.ZstdCompressor(**kw).compress(content)
        assert len(frame) < LIMIT, (name, len(frame))
        (HERE / f"{name}.zst").write_bytes(frame)
        manifest[name] = {**kw, "decoded_bytes": len(content), "sha256": hashlib.sha256(content).hexdigest()}
    # two frames with a skippable frame between them
    a, b = _text(5_000, 7), _records(9_000, 8)
    frame = (zstandard.ZstdCompressor(level=3).compress(a) + struct.pack("<II", 0x184D2A53, 5) + b"skip!"
             + zstandard.ZstdCompressor(level=19, write_checksum=True).compress(b))
    (HERE / "concatenated_skippable.zst").write_bytes(frame)
    manifest["concatenated_skippable"] = {"frames": 2, "skippable": 1, "decoded_bytes": len(a + b),
                                          "sha256": hashlib.sha256(a + b).hexdigest()}
    manifest["zstandard_version"] = zstandard.__version__
    (HERE / "manifest.json").write_text(json.dumps(manifest, indent=1, sort_keys=True) + "\n")


if __name__ == "__main__":
    main()
