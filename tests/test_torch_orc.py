"""The port's ORC reader, writer and scan against the JAX package's.

Files come from three writers: the port's, the reference's and
pyarrow's (RLEv2 integers, dictionary and direct strings, timestamps,
every codec pyarrow and the port share).  The port's ``read_stripe``
must give exactly the reference's arrays, its writer byte-identical
files, its ``OrcScanExec`` the reference scan's rows and its stripe
pruning the reference's counts.  ZSTD chunks go through the port's own
zstd codec, the reference's through ``zstandard``: each reads the
other's files.  Nested fields beside flat ones read as the reference reads them
(``test_torch_orc_nested.py`` has the rest of the nested cases).
"""

import decimal
import struct

import numpy as np
import pyarrow as pa
import pyarrow.orc as paorc
import pytest
import torch

from blaze_tpu import conf as jax_conf
from blaze_tpu import schema as RS
from blaze_tpu.batch import batch_to_pydict as jax_to_pydict
from blaze_tpu.exprs import ir as jax_ir
from blaze_tpu.io import orc as rorc
from blaze_tpu.ops.orc_scan import OrcScanExec as JaxOrcScan
from blaze_tpu.runtime.context import TaskContext as JaxContext

from blaze_tpu_torch import conf
from blaze_tpu_torch import schema as PS
from blaze_tpu_torch.batch import batch_to_pydict
from blaze_tpu_torch.exprs import ir
from blaze_tpu_torch.io import orc as porc
from blaze_tpu_torch.ops import OrcScanExec
from blaze_tpu_torch.runtime.context import TaskContext

N = 3000
COLUMNS = ("i8", "i16", "i32", "i64", "f32", "f64", "dec", "date", "ts", "flag", "s")


def _dtype(S, name: str):
    return {"i8": S.DataType.int8(), "i16": S.DataType.int16(), "i32": S.DataType.int32(),
            "i64": S.DataType.int64(), "f32": S.DataType.float32(), "f64": S.DataType.float64(),
            "dec": S.DataType.decimal(12, 2), "date": S.DataType.date32(), "ts": S.DataType.timestamp(),
            "flag": S.DataType.bool_(), "s": S.DataType.string(16)}[name]


def _schema(S, names=COLUMNS):
    return S.Schema([S.Field(n, _dtype(S, n)) for n in names])


@pytest.fixture(scope="module")
def host():
    rng = np.random.default_rng(41)
    valid = rng.random(N) > 0.2
    lens = rng.integers(0, 17, N).astype(np.int32)
    strs = np.zeros((N, 16), np.uint8)
    for i in range(N):
        strs[i, :lens[i]] = 0x41 + rng.integers(0, 3, lens[i])
    return {
        "i8": (rng.integers(-128, 128, N).astype(np.int8), valid, None),
        "i16": (rng.integers(-2**15, 2**15, N).astype(np.int16), None, None),
        "i32": (rng.integers(-2**31, 2**31, N).astype(np.int32), valid, None),
        "i64": (np.concatenate([[-2**63, 2**63 - 1, 0], rng.integers(-2**62, 2**62, N - 3)]), None, None),
        "f32": (rng.standard_normal(N).astype(np.float32), valid, None),
        "f64": (rng.standard_normal(N), None, None),
        "dec": (rng.integers(-10**11, 10**11, N), valid, None),
        "date": (rng.integers(-5000, 20000, N).astype(np.int32), valid, None),
        "ts": (rng.integers(-10**15, 10**15, N), valid, None),
        "flag": (rng.random(N) > 0.5, valid, None),
        "s": (strs, valid, lens),
    }


def _same_stripes(path, names, width=16):
    rm, pm = rorc.read_metadata(path, string_width=width), porc.read_metadata(path, string_width=width)
    assert [(s.offset, s.rows, s.stats) for s in rm.stripes] == [(s.offset, s.rows, s.stats) for s in pm.stripes]
    for st, pst in zip(rm.stripes, pm.stripes):
        want, got = rorc.read_stripe(path, rm, st), porc.read_stripe(path, pm, pst, names)
        assert sorted(got) == sorted(names)
        for name in names:
            for u, v in zip(want[name], got[name]):
                assert (u is None and v is None) or (u.dtype == v.dtype and np.array_equal(u, v))


@pytest.mark.parametrize("compression", ["none", "zlib", "snappy", "lz4"])
def test_writer_bytes_equal_the_reference(tmp_path, host, compression):
    a, b = tmp_path / "ref.orc", tmp_path / "port.orc"
    rorc.write_orc(str(a), _schema(RS), host, stripe_rows=1100, compression=compression)
    porc.write_orc(str(b), _schema(PS), host, stripe_rows=1100, compression=compression)
    assert a.read_bytes() == b.read_bytes()
    _same_stripes(str(b), COLUMNS)


def test_zstd_streams_read_both_ways(tmp_path, host):
    # the port's zstd chunks: the reference (zstandard) reads them; the
    # reference's: the port reads them, each array the reference's own
    port = str(tmp_path / "port.orc")
    porc.write_orc(port, _schema(PS), host, stripe_rows=1100, compression="zstd")
    _same_stripes(port, COLUMNS)
    path = str(tmp_path / "ref.orc")
    rorc.write_orc(path, _schema(RS), host, stripe_rows=1100, compression="zstd")
    _same_stripes(path, COLUMNS)


def _arrow_table(host, names=COLUMNS):
    arrays = {}
    for name in names:
        data, valid, lens = host[name]
        mask = None if valid is None else ~valid
        if name == "s":
            arrays[name] = pa.array([bytes(data[i, :lens[i]]).decode() if valid[i] else None for i in range(N)],
                                    type=pa.string())
        elif name == "dec":
            arrays[name] = pa.array([decimal.Decimal(int(v)).scaleb(-2) for v in data], type=pa.decimal128(12, 2),
                                    mask=mask)
        elif name == "date":
            arrays[name] = pa.array(data, mask=mask).cast(pa.date32())
        elif name == "ts":
            arrays[name] = pa.array(data, type=pa.timestamp("us"), mask=mask)
        else:
            arrays[name] = pa.array(data, mask=mask)
    return pa.table(arrays)


ARROW_CASES = {
    "zlib, dictionary strings": dict(compression="zlib", dictionary_key_size_threshold=1.0),
    "snappy, direct strings": dict(compression="snappy"),
    "uncompressed, small stripes": dict(compression="uncompressed", stripe_size=4096),
    "lz4": dict(compression="lz4", dictionary_key_size_threshold=1.0),
}


@pytest.mark.parametrize("case", list(ARROW_CASES))
def test_pyarrow_files_decode_as_the_reference(tmp_path, host, case):
    path = str(tmp_path / "arrow.orc")
    paorc.write_table(_arrow_table(host), path, **ARROW_CASES[case])
    _same_stripes(path, COLUMNS)


def test_pyarrow_values(tmp_path, host):
    """pyarrow's RLEv2 integers, decimals and timestamps decode to its own
    values."""
    path = str(tmp_path / "arrow.orc")
    paorc.write_table(_arrow_table(host), path, compression="zlib")
    meta = porc.read_metadata(path, string_width=16)
    got = {n: [] for n in COLUMNS}
    for st in meta.stripes:
        for n, (d, v, ln) in porc.read_stripe(path, meta, st).items():
            got[n].append((d, v, ln))
    for n in ("i64", "i32", "dec", "date", "ts", "s"):
        d = np.concatenate([p[0] for p in got[n]])
        v = np.concatenate([p[1] for p in got[n]])
        want_d, want_v, want_ln = host[n]
        want_v = np.ones(N, bool) if want_v is None else want_v
        np.testing.assert_array_equal(v, want_v)
        np.testing.assert_array_equal(d[v], want_d[want_v])


# ------------------------------------------- the loops that are numpy here


@pytest.mark.parametrize("signed", [True, False])
def test_rlev1_equals_the_reference(signed):
    rng = np.random.default_rng(5)
    for n in (0, 1, 127, 128, 129, 1000):
        v = rng.integers(-2**63 if signed else 0, 2**63 - 1, n)
        v[: n // 3] = rng.integers(-3 if signed else 0, 300, n // 3)
        enc = porc._rlev1_encode(v, signed)
        assert enc == rorc._rlev1_encode(v, signed)
        np.testing.assert_array_equal(porc._rlev1_decode(enc, n, signed), v)
    # runs (3-130 values, an int8 delta, a varint base) among literal groups
    stream = bytearray()
    for h, delta, base in ((0, 1, 7), (127, -1, 10**12), (5, 0, 300)):
        stream += bytes([h]) + struct.pack("<b", delta) + porc._uvarint(porc._zz(base) if signed else base)
        stream += porc._rlev1_encode(np.arange(200) * 99991, signed)
    count = 3 + 130 + 8 + 3 * 200
    np.testing.assert_array_equal(porc._rlev1_decode(bytes(stream), count, signed),
                                  rorc._rlev1_decode(bytes(stream), count, signed))


def test_decimal_varints_equal_the_reference():
    rng = np.random.default_rng(6)
    v = np.concatenate([[0, -1, 2**62, -2**62], rng.integers(-10**17, 10**17, 2000)])
    raw = porc._varints_encode(porc._zigzag64(v))[0].tobytes()
    assert raw == b"".join(rorc._uvarint(rorc._zz(int(x))) for x in v)
    np.testing.assert_array_equal(porc._varint_stream_decode(raw, v.shape[0]), rorc._varint_stream_decode(raw, v.shape[0]))


# --------------------------------------------------------------- the scan


def _port_rows(scan):
    out = []
    for p in range(scan.num_partitions()):
        for b in scan.execute(p, TaskContext(p, scan.num_partitions())):
            assert b.device == torch.device("cpu")
            out.append(batch_to_pydict(b))
    return out


def _jax_rows(scan):
    return [jax_to_pydict(b) for p in range(scan.num_partitions())
            for b in scan.execute(p, JaxContext(p, scan.num_partitions()))]


@pytest.fixture(scope="module")
def files(tmp_path_factory, host):
    d = tmp_path_factory.mktemp("orc")
    paths = []
    for k in range(2):
        path = str(d / f"part-{k}.orc")
        porc.write_orc(path, _schema(PS), {n: tuple(None if a is None else a[k * 1500:(k + 1) * 1500]
                                                    for a in host[n]) for n in COLUMNS},
                       stripe_rows=600, compression="zlib")
        paths.append(path)
    return paths


@pytest.mark.parametrize("batch_rows", [0, 256])
def test_scan_batches_equal_the_reference_scan(files, batch_rows):
    names = ("s", "i64", "missing", "dec", "date", "flag")
    typ = lambda S: S.Schema([S.Field(n, _dtype(S, "i32" if n == "missing" else n)) for n in names])  # noqa: E731
    port = OrcScanExec([[files[0]], [files[1]]], typ(PS), batch_rows=batch_rows, device="cpu")
    ref = JaxOrcScan([[files[0]], [files[1]]], typ(RS), batch_rows=batch_rows)
    got = _port_rows(port)
    assert got == _jax_rows(ref)
    assert len(got) == 2 * sum(-(-rows // (batch_rows or 8192)) for rows in (600, 600, 300))
    assert all(v is None for b in got for v in b["missing"])
    assert port.metrics.values["bytes_read"] > 0


@pytest.mark.parametrize("col,op,value", [("i32", ">", 2**31 - 10**7), ("date", "<", 40), ("dec", ">=", 10**11 - 10**8)])
def test_stripe_pruning_counts_equal_the_reference(tmp_path, col, op, value):
    rng = np.random.default_rng(8)
    n = 1000
    host = {"i32": (np.sort(rng.integers(-2**31, 2**31, n)).astype(np.int32), None, None),
            "date": (np.sort(rng.integers(0, 20000, n)).astype(np.int32), None, None),
            "dec": (np.sort(rng.integers(-10**11, 10**11, n)), None, None)}
    names = ("i32", "date", "dec")
    path = str(tmp_path / "sorted.orc")
    porc.write_orc(path, _schema(PS, names), host, stripe_rows=100)
    if col == "dec":
        value = decimal.Decimal(value).scaleb(-2)
    method = {"<": "__lt__", ">": "__gt__", ">=": "__ge__"}[op]
    pred = lambda m, S: getattr(m.col(col), method)(m.lit(value, _dtype(S, col)))  # noqa: E731
    port = OrcScanExec([[path]], _schema(PS, names), pred(ir, PS), device="cpu")
    ref = JaxOrcScan([[path]], _schema(RS, names), pred(jax_ir, RS))
    assert _port_rows(port) == _jax_rows(ref)
    assert port.metrics.values["pruned_stripes"] == ref.metrics.values["pruned_stripes"] >= 8
    assert port.metrics.values["pruned_rows"] == ref.metrics.values["pruned_rows"]


def test_string_stripe_pruning(tmp_path):
    """String statistics compare with the literal's utf-8 bytes (the
    reference compares a str with bytes and so never prunes on them)."""
    s = np.zeros((400, 8), np.uint8)
    s[:, 0] = np.repeat(np.frombuffer(b"ABCD", np.uint8), 100)
    path = str(tmp_path / "s.orc")
    porc.write_orc(path, _schema(PS, ("s",)), {"s": (s, None, np.ones(400, np.int32))}, stripe_rows=100)
    scan = OrcScanExec([[path]], _schema(PS, ("s",)), ir.col("s") == ir.lit("C"), device="cpu")
    rows = [v for b in _port_rows(scan) for v in b["s"]]
    assert rows == ["C"] * 100 and scan.metrics.values["pruned_stripes"] == 3


def test_nested_fields_raise_naming_their_type(tmp_path):
    """A file with a list and a struct beside flat fields: the flat
    fields read as the reference reads them, and so do the nested ones
    since the port has nested columns; a list longer than the read
    schema's element budget raises naming the field, in both packages."""
    path = str(tmp_path / "nested.orc")
    t = pa.table({"a": pa.array([1, 2, None], pa.int64()), "l": pa.array([[1], [2, 3], None], pa.list_(pa.int32())),
                  "st": pa.array([{"x": 1}, None, {"x": 3}]), "s": pa.array(["p", None, "q"])})
    paorc.write_table(t, path)
    _same_stripes(path, ("a", "s"))
    pmeta, rmeta = porc.read_metadata(path), rorc.read_metadata(path)
    names = ("a", "l", "st", "s")
    port = OrcScanExec([[path]], PS.Schema([pmeta.schema.field(n) for n in names]), device="cpu")
    ref = JaxOrcScan([[path]], RS.Schema([rmeta.schema.field(n) for n in names]))
    assert _port_rows(port) == _jax_rows(ref)
    assert _port_rows(port)[0]["l"] == [[1], [2, 3], None]
    narrow = lambda S: S.Schema([S.Field("l", S.DataType.array(S.DataType.int32(), 1))])
    with pytest.raises(NotImplementedError, match="'l'"):
        _port_rows(OrcScanExec([[path]], narrow(PS), device="cpu"))
    with pytest.raises(NotImplementedError, match="'l'"):
        _jax_rows(JaxOrcScan([[path]], narrow(RS)))
    scan = OrcScanExec([[path]], _schema(PS, ("s",)), device="cpu")
    assert [v for b in _port_rows(scan) for v in b["s"]] == ["p", None, "q"]


def test_corrupt_file_raises_or_is_skipped_and_counted(tmp_path, files):
    bad = tmp_path / "bad.orc"
    bad.write_bytes(b"ORC garbage\x05")
    scan = lambda: OrcScanExec([[str(bad), files[0]]], _schema(PS, ("i64",)), device="cpu")  # noqa: E731
    with pytest.raises(Exception):
        _port_rows(scan())
    conf.IGNORE_CORRUPT_FILES.set(True)
    jax_conf.IGNORE_CORRUPT_FILES.set(True)
    try:
        port = scan()
        ref = JaxOrcScan([[str(bad), files[0]]], _schema(RS, ("i64",)))
        assert _port_rows(port) == _jax_rows(ref)
        assert port.metrics.values["skipped_corrupt_files"] == ref.metrics.values["skipped_corrupt_files"] == 1
    finally:
        conf.IGNORE_CORRUPT_FILES.set(False)
        jax_conf.IGNORE_CORRUPT_FILES.set(False)
