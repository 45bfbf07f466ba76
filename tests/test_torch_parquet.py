"""The port's Parquet reader, writer and scan against the JAX package's.

Files come from three writers: the port's, the reference's and pyarrow's
(dictionary strings, v1 and v2 data pages, required and optional
columns, FLBA decimals, INT96 timestamps, every codec).  The port's
``read_column_chunk`` must give exactly the reference's arrays for each,
its writer byte-identical files, its ``ParquetScanExec`` the reference
scan's rows and its row-group pruning the reference's counts.  ZSTD
pages go through the port's own zstd codec, the reference's through
``zstandard``: each reads the other's files.  gzip stamps the current second into each page; both
writers run with gzip's clock frozen, as they would within one second.
"""

import datetime
import decimal
import gzip
import types

import numpy as np
import pyarrow as pa
import pyarrow.parquet as papq
import pytest
import torch

from blaze_tpu import conf as jax_conf
from blaze_tpu import schema as RS
from blaze_tpu.batch import batch_to_pydict as jax_to_pydict
from blaze_tpu.exprs import ir as jax_ir
from blaze_tpu.io import parquet as rpq
from blaze_tpu.ops import ParquetScanExec as JaxParquetScan
from blaze_tpu.runtime.context import TaskContext as JaxContext

from blaze_tpu_torch import conf
from blaze_tpu_torch import schema as PS
from blaze_tpu_torch.batch import batch_to_pydict
from blaze_tpu_torch.exprs import ir
from blaze_tpu_torch.io import parquet as ppq
from blaze_tpu_torch.ops import ParquetScanExec
from blaze_tpu_torch.runtime.context import TaskContext

N = 3000
COLUMNS = ("i8", "i16", "i32", "i64", "f32", "f64", "dec", "date", "ts", "flag", "s")


def _dtype(S, name: str):
    return {"i8": S.DataType.int8(), "i16": S.DataType.int16(), "i32": S.DataType.int32(),
            "i64": S.DataType.int64(), "f32": S.DataType.float32(), "f64": S.DataType.float64(),
            "dec": S.DataType.decimal(12, 2), "date": S.DataType.date32(), "ts": S.DataType.timestamp(),
            "flag": S.DataType.bool_(), "s": S.DataType.string(16), "r": S.DataType.int64()}[name]


def _schema(S, names=COLUMNS):
    return S.Schema([S.Field(n, _dtype(S, n)) for n in names])


@pytest.fixture(scope="module")
def host():
    """name -> (data, validity, lengths) from one seed: nulls in most
    columns, strings with zero bytes inside and at their ends, -0.0 and
    NaN among the floats."""
    rng = np.random.default_rng(14)
    valid = rng.random(N) > 0.2
    lens = rng.integers(0, 17, N).astype(np.int32)
    strs = np.zeros((N, 16), np.uint8)
    for i in range(N):
        strs[i, :lens[i]] = rng.integers(0, 4, lens[i]) * 60  # many ties and zero bytes
    f64 = rng.standard_normal(N)
    f64[:3] = (-0.0, np.nan, np.inf)
    return {
        "i8": (rng.integers(-128, 128, N).astype(np.int8), valid, None),
        "i16": (rng.integers(-2**15, 2**15, N).astype(np.int16), None, None),
        "i32": (rng.integers(-2**31, 2**31, N).astype(np.int32), valid, None),
        "i64": (rng.integers(-2**62, 2**62, N), None, None),
        "f32": (rng.standard_normal(N).astype(np.float32), valid, None),
        "f64": (f64, None, None),
        "dec": (rng.integers(-10**11, 10**11, N), valid, None),
        "date": (rng.integers(0, 20000, N).astype(np.int32), valid, None),
        "ts": (rng.integers(-10**15, 10**15, N), valid, None),
        "flag": (rng.random(N) > 0.5, valid, None),
        "s": (strs, valid, lens),
    }


@pytest.fixture
def frozen_gzip(monkeypatch):
    monkeypatch.setattr(gzip, "time", types.SimpleNamespace(time=lambda: 1_700_000_000.0))


def _same_arrays(x, y):
    assert len(x) == len(y) == 3
    for u, v in zip(x, y):
        assert (u is None and v is None) or (u.dtype == v.dtype and np.array_equal(u, v, equal_nan=u.dtype.kind == "f"))


def _chunks_equal(path, names=COLUMNS):
    """Every column chunk of ``path``: the port's arrays are the
    reference's."""
    rm, pm = rpq.read_metadata(path), ppq.read_metadata(path)
    assert rm.num_rows == pm.num_rows and len(rm.row_groups) == len(pm.row_groups)
    for rg, prg in zip(rm.row_groups, pm.row_groups):
        assert rg.rows == prg.rows
        for name in names:
            assert vars(rg.chunks[name]) == vars(prg.chunks[name])
            _same_arrays(rpq.read_column_chunk(path, rg.chunks[name], _dtype(RS, name)),
                         ppq.read_column_chunk(path, prg.chunks[name], _dtype(PS, name)))


CODECS = [ppq.CODEC_UNCOMPRESSED, ppq.CODEC_GZIP, ppq.CODEC_SNAPPY, ppq.CODEC_LZ4_RAW]


@pytest.mark.parametrize("codec", CODECS, ids=["none", "gzip", "snappy", "lz4_raw"])
def test_writer_bytes_equal_the_reference(tmp_path, host, frozen_gzip, codec):
    a, b = tmp_path / "ref.parquet", tmp_path / "port.parquet"
    rpq.write_parquet(str(a), _schema(RS), host, row_group_rows=1100, codec=codec)
    ppq.write_parquet(str(b), _schema(PS), host, row_group_rows=1100, codec=codec)
    assert a.read_bytes() == b.read_bytes()
    _chunks_equal(str(b))


def test_zstd_pages_read_both_ways(tmp_path, host):
    # the port's zstd pages: the reference (zstandard) reads them; the
    # reference's: the port reads them, each array the reference's own
    port = str(tmp_path / "port_zstd.parquet")
    ppq.write_parquet(port, _schema(PS), host, row_group_rows=1100, codec=ppq.CODEC_ZSTD)
    _chunks_equal(port)
    for rg in rpq.read_metadata(port).row_groups:
        assert all(c.codec == rpq.CODEC_ZSTD for c in rg.chunks.values())
    path = str(tmp_path / "ref_zstd.parquet")
    rpq.write_parquet(path, _schema(RS), host, row_group_rows=1100, codec=rpq.CODEC_ZSTD)
    _chunks_equal(path)


def _arrow_table(host, names=COLUMNS):
    arrays = {}
    for name in names:
        data, valid, lens = host[name]
        mask = None if valid is None else ~valid
        if name == "s":
            arrays[name] = pa.array([bytes(data[i, :lens[i]]).decode("latin-1") if valid[i] else None
                                     for i in range(N)], type=pa.string())
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
    "v1 dictionary, snappy": dict(compression="snappy"),
    "v1 plain, uncompressed": dict(compression="none", use_dictionary=False),
    "v2 dictionary, gzip": dict(data_page_version="2.0", compression="gzip"),
    "v2 plain, lz4": dict(data_page_version="2.0", compression="lz4", use_dictionary=False),
    "small pages and row groups": dict(data_page_size=512, row_group_size=700),
    "INT96 timestamps": dict(use_deprecated_int96_timestamps=True, use_dictionary=False),
}


@pytest.mark.parametrize("case", list(ARROW_CASES))
def test_pyarrow_files_decode_as_the_reference(tmp_path, host, case):
    """The strings hold bytes 0x3c-0xb4 (latin-1 text in utf-8), so
    pyarrow's utf-8 strings run longer than 16 bytes: both decoders cut
    them to the declared width alike."""
    path = str(tmp_path / "arrow.parquet")
    papq.write_table(_arrow_table(host), path, **ARROW_CASES[case])
    _chunks_equal(path)


def test_pyarrow_required_columns_and_values(tmp_path, host):
    """A REQUIRED column has no definition levels; FLBA decimals and
    INT96 timestamps decode to pyarrow's own values."""
    path = str(tmp_path / "req.parquet")
    t = pa.table({"r": pa.array(host["i64"][0]), "dec": _arrow_table(host, ["dec"])["dec"],
                  "ts": _arrow_table(host, ["ts"])["ts"]},
                 schema=pa.schema([pa.field("r", pa.int64(), nullable=False), pa.field("dec", pa.decimal128(12, 2)),
                                   pa.field("ts", pa.timestamp("us"))]))
    papq.write_table(t, path, use_deprecated_int96_timestamps=True, use_dictionary=False)
    meta = ppq.read_metadata(path)
    chunks = meta.row_groups[0].chunks
    assert chunks["r"].max_def == 0 and chunks["dec"].phys == ppq.T_FLBA and chunks["ts"].phys == ppq.T_INT96
    _chunks_equal(path, ("r", "dec", "ts"))
    for name in ("dec", "ts"):
        data, valid, _ = ppq.read_column_chunk(path, chunks[name], _dtype(PS, name))
        np.testing.assert_array_equal(valid, host[name][1])
        np.testing.assert_array_equal(data[valid], host[name][0][valid])


def test_pyarrow_zstd_decodes_as_the_reference(tmp_path, host):
    path = str(tmp_path / "zstd.parquet")
    papq.write_table(_arrow_table(host, ["i64"]), path, compression="zstd")
    rm, pm = rpq.read_metadata(path), ppq.read_metadata(path)
    data, _, _ = rpq.read_column_chunk(path, rm.row_groups[0].chunks["i64"], _dtype(RS, "i64"))
    np.testing.assert_array_equal(data, host["i64"][0])
    _same_arrays(rpq.read_column_chunk(path, rm.row_groups[0].chunks["i64"], _dtype(RS, "i64")),
                 ppq.read_column_chunk(path, pm.row_groups[0].chunks["i64"], _dtype(PS, "i64")))


# ------------------------------------------- the loops that are numpy here


@pytest.mark.parametrize("seed", range(4))
def test_definition_levels_equal_the_reference(seed):
    rng = np.random.default_rng(seed)
    for n, p in ((0, 0.5), (1, 0.5), (257, 0.5), (5000, 0.02), (5000, 0.98), (3000, 1.0)):
        v = rng.random(n) < p
        enc = ppq._rle_encode_defs(v)
        assert enc == rpq._rle_encode_defs(v)
        # bit-packed groups as pyarrow writes them: 8 values a byte
        packed = bytes([((n + 7) // 8) << 1 | 1]) if n < 512 else None
        if packed is not None:
            bits = packed + np.packbits(v, bitorder="little").tobytes()
            assert np.array_equal(ppq._rle_decode_defs(bits, n)[0], rpq._rle_decode_defs(bits, n)[0])
            assert ppq._rle_decode_defs(bits, n)[1] == rpq._rle_decode_defs(bits, n)[1]
        got, pos = ppq._rle_decode_defs(enc, n)
        assert np.array_equal(got, v) and pos == len(enc)


def test_string_statistics_order_as_bytes():
    """A string zero-padded past its length ties with a shorter one: the
    shorter is the least (``b"a" < b"a\\x00"``), as python orders bytes."""
    data = np.zeros((5, 8), np.uint8)
    for i, s in enumerate((b"a\x00", b"a", b"\xff\x00\x00", b"\xff", b"")):
        data[i, :len(s)] = np.frombuffer(s, np.uint8)
    data[1, 3] = 9  # a byte past its length must not count
    lengths = np.array([2, 1, 3, 1, 0], np.int32)
    rows = np.arange(5)
    assert ppq._string_min_max(data, lengths, rows) == (b"", b"\xff\x00\x00")
    assert ppq._string_min_max(data, lengths, rows[:2]) == (b"a", b"a\x00")


# --------------------------------------------------------------- the scan


def _port_scan_rows(scan):
    out = []
    for p in range(scan.num_partitions()):
        for b in scan.execute(p, TaskContext(p, scan.num_partitions())):
            assert b.device == torch.device("cpu")
            out.append(batch_to_pydict(b))
    return out


def _jax_scan_rows(scan):
    return [jax_to_pydict(b) for p in range(scan.num_partitions())
            for b in scan.execute(p, JaxContext(p, scan.num_partitions()))]


@pytest.fixture(scope="module")
def files(tmp_path_factory, host):
    d = tmp_path_factory.mktemp("scan")
    paths = []
    for k in range(2):
        path = str(d / f"part-{k}.parquet")
        ppq.write_parquet(path, _schema(PS), {n: tuple(None if a is None else a[k * 1500:(k + 1) * 1500]
                                                      for a in host[n]) for n in COLUMNS}, row_group_rows=600)
        paths.append(path)
    return paths


@pytest.mark.parametrize("batch_rows", [0, 256, 600, 1000])
def test_scan_batches_equal_the_reference_scan(files, batch_rows):
    """Two partitions of 1500 rows, row groups of 600: the default batch
    size (8192), 600 and 1000 emit a row group a batch, 256 slices them;
    a missing column reads as nulls in both."""
    names = ("i32", "s", "dec", "missing", "flag", "ts")
    typ = lambda S: S.Schema([S.Field(n, _dtype(S, "i64" if n == "missing" else n)) for n in names])  # noqa: E731
    port = ParquetScanExec([[files[0]], [files[1]]], typ(PS), batch_rows=batch_rows, device="cpu")
    ref = JaxParquetScan([[files[0]], [files[1]]], typ(RS), batch_rows=batch_rows)
    got, want = _port_scan_rows(port), _jax_scan_rows(ref)
    assert got == want
    assert len(got) == 2 * sum(-(-rows // (batch_rows or 8192)) for rows in (600, 600, 300))
    assert all(v is None for b in got for v in b["missing"])
    assert port.metrics.values["output_rows"] == N
    assert port.metrics.values["bytes_read"] > 0 and port.metrics.values["input_io_time"] > 0


PREDICATES = [
    ("i32", ">", 2**31 - 1000), ("i32", "<", -2**31 + 100), ("date", ">=", 19990), ("date", "==", 5),
    ("dec", "<=", -10**11 + 10**6), ("f64", ">", 10.0), ("s", "<", "\x00"), ("s", "==", "<<"),
]


@pytest.mark.parametrize("col,op,value", PREDICATES)
def test_row_group_pruning_counts_equal_the_reference(tmp_path, col, op, value):
    """Row groups of 100 rows over a column sorted ascending, so the
    statistics of most row groups rule a literal out; the pruned counts
    and the rows left equal the reference scan's."""
    rng = np.random.default_rng(3)
    n = 1000
    host = {"i32": (np.sort(rng.integers(-2**31, 2**31, n)).astype(np.int32), None, None),
            "date": (np.sort(rng.integers(0, 20000, n)).astype(np.int32), None, None),
            "dec": (np.sort(rng.integers(-10**11, 10**11, n)), None, None),
            "f64": (np.sort(rng.standard_normal(n) * 20), None, None)}
    s = np.zeros((n, 16), np.uint8)
    s[:, 0] = np.sort(rng.integers(0, 256, n))
    host["s"] = (s, None, np.ones(n, np.int32))
    names = ("i32", "date", "dec", "f64", "s")
    path = str(tmp_path / "sorted.parquet")
    ppq.write_parquet(path, _schema(PS, names), host, row_group_rows=100)
    if col == "dec":
        value = decimal.Decimal(value).scaleb(-2)
    if col == "date":
        value = (datetime.date(1970, 1, 1) + datetime.timedelta(days=value)).isoformat()
    pred = lambda m, S: getattr(m.col(col), {"<": "__lt__", "<=": "__le__", ">": "__gt__", ">=": "__ge__",  # noqa
                                             "==": "__eq__"}[op])(m.lit(value, _dtype(S, col)))
    port = ParquetScanExec([[path]], _schema(PS, names), pred(ir, PS), device="cpu")
    ref = JaxParquetScan([[path]], _schema(RS, names), pred(jax_ir, RS))
    got, want = _port_scan_rows(port), _jax_scan_rows(ref)
    assert got == want
    assert port.metrics.values.get("pruned_row_groups", 0) == ref.metrics.values.get("pruned_row_groups", 0)
    assert port.metrics.values.get("pruned_rows", 0) == ref.metrics.values.get("pruned_rows", 0)
    if col != "s" or op == "<":
        assert port.metrics.values.get("pruned_row_groups", 0) >= 5
    conf.PARQUET_FILTER_PUSHDOWN.set(False)
    try:
        off = ParquetScanExec([[path]], _schema(PS, names), pred(ir, PS), device="cpu")
        assert sum(len(b["i32"]) for b in _port_scan_rows(off)) == n
        assert "pruned_row_groups" not in off.metrics.values
    finally:
        conf.PARQUET_FILTER_PUSHDOWN.set(True)


def test_corrupt_file_raises_or_is_skipped_and_counted(tmp_path, files):
    bad = tmp_path / "bad.parquet"
    bad.write_bytes(b"PAR1 not a parquet file")
    scan = lambda: ParquetScanExec([[str(bad), files[0]]], _schema(PS, ("i64",)), device="cpu")  # noqa: E731
    with pytest.raises(AssertionError, match="not a parquet file"):
        _port_scan_rows(scan())
    conf.IGNORE_CORRUPT_FILES.set(True)
    jax_conf.IGNORE_CORRUPT_FILES.set(True)
    try:
        port = scan()
        ref = JaxParquetScan([[str(bad), files[0]]], _schema(RS, ("i64",)))
        assert _port_scan_rows(port) == _jax_scan_rows(ref)
        assert port.metrics.values["skipped_corrupt_files"] == ref.metrics.values["skipped_corrupt_files"] == 1
    finally:
        conf.IGNORE_CORRUPT_FILES.set(False)
        jax_conf.IGNORE_CORRUPT_FILES.set(False)
