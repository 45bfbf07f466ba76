"""The port's ParquetSinkExec against the JAX package's: the same
batches, two partitions of several batches each, written without and
with partition columns (string, int and date keys, nulls among them),
give byte-identical files at the same relative paths, in the same order
in ``written_files``.  gzip's clock is frozen, as in
``test_torch_parquet.py``; the sink's files read back through the
port's scan give the rows written."""

import gzip
import os
import types

import numpy as np
import pytest

from blaze_tpu import schema as RS
from blaze_tpu.ops import MemoryScanExec as JaxScan
from blaze_tpu.ops import ParquetSinkExec as JaxSink
from blaze_tpu.runtime.context import TaskContext as JaxContext
from blaze_tpu.tpch.datagen import table_to_batches as jax_table_to_batches

from blaze_tpu_torch import schema as PS
from blaze_tpu_torch.batch import batch_to_pydict, table_to_batches
from blaze_tpu_torch.ops import MemoryScanExec, ParquetScanExec, ParquetSinkExec
from blaze_tpu_torch.runtime.context import TaskContext

N = 2500
NAMES = ("k", "region", "day", "amount", "note")


def _schema(S):
    return S.Schema([S.Field("k", S.DataType.int32()), S.Field("region", S.DataType.string(8)),
                     S.Field("day", S.DataType.date32()), S.Field("amount", S.DataType.decimal(12, 2)),
                     S.Field("note", S.DataType.string(16))])


@pytest.fixture(scope="module")
def table():
    """The host table layout: (data, lengths, validity)."""
    rng = np.random.default_rng(9)
    region = np.zeros((N, 8), np.uint8)
    rlen = np.zeros(N, np.int32)
    for i, r in enumerate(rng.integers(0, 3, N)):
        w = (b"east", b"west", b"north")[r]
        region[i, :len(w)] = np.frombuffer(w, np.uint8)
        rlen[i] = len(w)
    note = np.zeros((N, 16), np.uint8)
    nlen = rng.integers(0, 17, N).astype(np.int32)
    for i in range(N):
        note[i, :nlen[i]] = 0x61 + rng.integers(0, 26, nlen[i])
    return {
        "k": (rng.integers(0, 4, N).astype(np.int32), None, rng.random(N) > 0.1),
        "region": (region, rlen, rng.random(N) > 0.05),
        "day": (rng.integers(9000, 9003, N).astype(np.int32), None),
        "amount": (rng.integers(-10**9, 10**9, N), None, rng.random(N) > 0.2),
        "note": (note, nlen),
    }


@pytest.fixture
def frozen_gzip(monkeypatch):
    monkeypatch.setattr(gzip, "time", types.SimpleNamespace(time=lambda: 1_700_000_000.0))


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out


@pytest.mark.parametrize("partition_columns", [(), ("region",), ("k", "day")], ids=["none", "string", "int+date"])
def test_sink_files_equal_the_reference(tmp_path, table, frozen_gzip, partition_columns):
    port_dir, ref_dir = tmp_path / "port", tmp_path / "ref"
    port = ParquetSinkExec(
        MemoryScanExec(table_to_batches(table, _schema(PS), 2, 700, device="cpu"), _schema(PS), device="cpu"),
        str(port_dir), partition_columns)
    ref = JaxSink(JaxScan(jax_table_to_batches(table, _schema(RS), 2, 700), _schema(RS)), str(ref_dir),
                  partition_columns)
    for p in range(2):
        assert list(port.execute(p, TaskContext(p, 2))) == []
        list(ref.execute(p, JaxContext(p, 2)))
    assert [os.path.relpath(f, port_dir) for f in port.written_files] == \
        [os.path.relpath(f, ref_dir) for f in ref.written_files]
    got, want = _files(port_dir), _files(ref_dir)
    assert sorted(got) == sorted(want) and len(got) >= 2
    assert all(got[k] == want[k] for k in want)
    # read back: the rows written, less the partition columns
    keep = [n for n in NAMES if n not in partition_columns]
    schema = PS.Schema([_schema(PS).field(n) for n in keep])
    rows = []
    for f in port.written_files:
        scan = ParquetScanExec([[f]], schema, device="cpu")
        for b in scan.execute(0, TaskContext(0, 1)):
            d = batch_to_pydict(b)
            rows += list(zip(*(d[n] for n in keep)))
    assert len(rows) == N
    assert port.metrics.values["output_io_time"] > 0


def test_empty_partition_zero_writes_an_empty_file(tmp_path):
    """Partition 0 writes a file of no rows; another empty partition writes none."""
    sink = ParquetSinkExec(MemoryScanExec([[], []], _schema(PS), device="cpu"), str(tmp_path))
    for p in range(2):
        list(sink.execute(p, TaskContext(p, 2)))
    assert [os.path.basename(f) for f in sink.written_files] == ["part-00000.parquet"]
    scan = ParquetScanExec([sink.written_files], _schema(PS), device="cpu")
    assert list(scan.execute(0, TaskContext(0, 1))) == []
