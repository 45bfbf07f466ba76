"""The port's file shuffle against the JAX package's.

The same seeded table (int64, date, decimal, string and float columns,
with nulls) goes through each package's ``ShuffleWriterExec`` into
``.data``/``.index`` files, 2 map tasks hash-partitioned 8 ways on the
int64 key.  Each package's ``IpcReaderExec`` reads the other's files,
and every reduce partition holds the same rows, in the same order.  A
flipped byte in a committed block raises the port's typed
``BlockCorruptionError``; a missing block raises ``FetchFailedError``.
The in-process entry (``plan.execute``) with
``spark.blaze.exchange.inProcess=false`` gives the default's rows.
"""

import os

import numpy as np
import pytest

import blaze_tpu.batch as JB
from blaze_tpu.exprs import col as jcol
from blaze_tpu.ops import MemoryScanExec as JaxScan
from blaze_tpu.parallel.shuffle import HashPartitioning as JaxHash
from blaze_tpu.parallel.shuffle import IpcReaderExec as JaxReader
from blaze_tpu.parallel.shuffle import LocalShuffleManager as JaxManager
from blaze_tpu.parallel.shuffle import ShuffleWriterExec as JaxWriter
from blaze_tpu.runtime.context import RESOURCES as JAX_RESOURCES
from blaze_tpu.runtime.context import TaskContext as JaxContext
from blaze_tpu.schema import DataType as JT, Field as JF, Schema as JSchema

import blaze_tpu_torch
import blaze_tpu_torch.batch as TB
from blaze_tpu_torch import conf
from blaze_tpu_torch.exprs import col
from blaze_tpu_torch.ops import MemoryScanExec
from blaze_tpu_torch.parallel.shuffle import (
    FetchFailedError, HashPartitioning, IpcReaderExec, LocalShuffleManager, ShuffleWriterExec,
    SinglePartitioning,
)
from blaze_tpu_torch.runtime import integrity
from blaze_tpu_torch.runtime.context import RESOURCES, TaskContext
from blaze_tpu_torch.schema import DataType as TT, Field as TF, Schema as TSchema
from blaze_tpu_torch.tpch import TPCH_SCHEMAS, build_query
from blaze_tpu_torch.tpch.datagen import generate_all

N_OUT = 8
N_MAPS = 2

TYPES = [("k", TT.int64(), JT.int64()), ("d", TT.date32(), JT.date32()),
         ("m", TT.decimal(12, 2), JT.decimal(12, 2)), ("s", TT.string(16), JT.string(16)),
         ("f", TT.float64(), JT.float64())]
TSCHEMA = TSchema([TF(n, t) for n, t, _ in TYPES])
JSCHEMA = JSchema([JF(n, j) for n, _, j in TYPES])


@pytest.fixture(autouse=True)
def on_cpu():
    prev = blaze_tpu_torch._default_device
    blaze_tpu_torch.set_default_device("cpu")
    yield
    blaze_tpu_torch.set_default_device(prev)


def _columns(rng, n):
    valid = rng.random(n) > 0.15
    return {
        "k": (rng.integers(-(2**40), 2**40, n), rng.random(n) > 0.05),
        "d": (rng.integers(8000, 11000, n).astype(np.int32), valid),
        "m": (rng.integers(-10**9, 10**9, n), None),
        "s": ([None if not v else "ab" * int(k) for v, k in zip(valid, rng.integers(0, 8, n))], None),
        "f": (rng.standard_normal(n), valid),
    }


def _batches(seed):
    """N_MAPS partitions of two batches each, in both packages."""
    rng = np.random.default_rng(seed)
    tparts, jparts = [], []
    for _ in range(N_MAPS):
        tb, jb = [], []
        for n in (700, 333):
            c = _columns(rng, n)
            tcols, jcols = [], []
            for name, tt, jt in TYPES:
                vals, valid = c[name]
                if name == "s":
                    tcols.append(TB.column_from_strings(vals, width=16, dtype=tt, device="cpu"))
                    jcols.append(JB.column_from_strings(vals, width=16, dtype=jt))
                else:
                    tcols.append(TB.column_from_numpy(tt, vals, valid, device="cpu"))
                    jcols.append(JB.column_from_numpy(jt, vals, valid))
            tb.append(TB.RecordBatch(TSCHEMA, tcols, n))
            jb.append(JB.RecordBatch(JSCHEMA, jcols, n))
        tparts.append(tb)
        jparts.append(jb)
    return tparts, jparts


def _write_port(root, sid, partitioning=None):
    tparts, _ = _batches(11)
    scan = MemoryScanExec(tparts, TSCHEMA, device="cpu")
    mgr = LocalShuffleManager(root)
    for m in range(N_MAPS):
        w = mgr.map_writer(scan, partitioning or HashPartitioning([col("k")], N_OUT), sid, m)
        assert isinstance(w, ShuffleWriterExec) and (w.data_path, w.index_path) == mgr.map_output_paths(sid, m)
        assert list(w.execute(m, TaskContext(m, N_MAPS))) == []
    return mgr


def _write_jax(root, sid):
    _, jparts = _batches(11)
    scan = JaxScan(jparts, JSCHEMA)
    mgr = JaxManager(root)
    for m in range(N_MAPS):
        w = JaxWriter(scan, JaxHash([jcol("k")], N_OUT), *mgr.map_output_paths(sid, m))
        for _ in w.execute(m, JaxContext(m, N_MAPS)):
            pass
    return mgr


def _read_port(mgr, sid, p):
    RESOURCES.put(f"shuffle_{sid}.{p}", mgr.reduce_blocks(sid, N_MAPS, p))
    out = list(IpcReaderExec(TSCHEMA, f"shuffle_{sid}", N_OUT, "cpu").execute(p, TaskContext(p, N_OUT)))
    assert len(out) <= 1  # one batch per reduce partition, as in process
    return _rows(out, TB.batch_to_pydict)


def _read_jax(mgr, sid, p):
    JAX_RESOURCES.put(f"shuffle_{sid}.{p}", mgr.reduce_blocks(sid, N_MAPS, p))
    return _rows(list(JaxReader(JSCHEMA, f"shuffle_{sid}", N_OUT).execute(p, JaxContext(p, N_OUT))),
                 JB.batch_to_pydict)


def _rows(batches, to_pydict):
    out = {n: [] for n, _, _ in TYPES}
    for b in batches:
        for k, v in to_pydict(b).items():
            out[k].extend(v)
    return out


def _all_rows():
    tparts, _ = _batches(11)
    return sum(b.num_rows for p in tparts for b in p)


def test_port_files_read_by_the_reference_and_reference_files_by_the_port(tmp_path):
    port = _write_port(str(tmp_path / "port"), 3)
    ref = _write_jax(str(tmp_path / "ref"), 3)
    total = 0
    for p in range(N_OUT):
        want = _read_jax(ref, 3, p)  # the reference reading its own files
        assert _read_jax(port, 3, p) == want, p
        assert _read_port(ref, 3, p) == want, p
        assert _read_port(port, 3, p) == want, p
        total += len(want["k"])
    assert total == _all_rows()
    assert len(RESOURCES) == 0 and not [k for k in JAX_RESOURCES._map if k.startswith("shuffle_3.")]


def test_index_offsets_and_partition_lengths(tmp_path):
    mgr = _write_port(str(tmp_path), 4)
    for m in range(N_MAPS):
        data, index = mgr.map_output_paths(4, m)
        offsets = np.fromfile(index, dtype="<u8")
        assert len(offsets) == N_OUT + 1 and offsets[0] == 0
        assert offsets[-1] == os.path.getsize(data) and (np.diff(offsets) >= 0).all()
    assert not [f for f in os.listdir(tmp_path) if ".inprogress" in f]
    assert mgr.data_bytes(4, N_MAPS) == sum(os.path.getsize(mgr.map_output_paths(4, m)[0])
                                            for m in range(N_MAPS))


def test_single_partitioning_writes_one_block_per_map(tmp_path):
    mgr = _write_port(str(tmp_path), 5, SinglePartitioning())
    assert len(mgr.reduce_blocks(5, N_MAPS, 0)) == N_MAPS
    RESOURCES.put("shuffle_5.0", mgr.reduce_blocks(5, N_MAPS, 0))
    (b,) = IpcReaderExec(TSCHEMA, "shuffle_5", 1, "cpu").execute(0, TaskContext(0))
    assert b.num_rows == _all_rows()


def test_map_task_is_one_copy_per_batch(tmp_path):
    TB.reset_copy_counts()
    _write_port(str(tmp_path), 6)
    assert TB.COPIES == {"device_to_host": 2 * N_MAPS, "host_to_device": 0}


def test_flipped_byte_raises_block_corruption(tmp_path):
    mgr = _write_port(str(tmp_path), 7)
    path = mgr.map_output_paths(7, 1)[0]
    integrity.flip_byte_in_file(path)
    blocks = mgr.reduce_blocks(7, N_MAPS, 0)
    assert any(b[0] == path and b[1] == 0 for b in blocks)
    RESOURCES.put("shuffle_7.0", blocks)
    with pytest.raises(integrity.BlockCorruptionError, match="crc32 mismatch") as e:
        list(IpcReaderExec(TSCHEMA, "shuffle_7", N_OUT, "cpu").execute(0, TaskContext(0, N_OUT)))
    assert e.value.path == path
    assert len(RESOURCES) == 0


def test_missing_blocks_raise_fetch_failed(tmp_path):
    mgr = _write_port(str(tmp_path), 8)
    with pytest.raises(FetchFailedError, match="no blocks registered"):
        list(IpcReaderExec(TSCHEMA, "shuffle_8", N_OUT, "cpu").execute(1, TaskContext(1, N_OUT)))
    blocks = mgr.reduce_blocks(8, N_MAPS, 1)
    os.unlink(blocks[0][0])
    RESOURCES.put("shuffle_8.1", blocks)
    with pytest.raises(FetchFailedError, match="shuffle_8 partition 1"):
        list(IpcReaderExec(TSCHEMA, "shuffle_8", N_OUT, "cpu").execute(1, TaskContext(1, N_OUT)))
    os.unlink(mgr.map_output_paths(8, 1)[1])
    with pytest.raises(FetchFailedError, match="map 1"):
        mgr.reduce_blocks(8, N_MAPS, 1)


def test_torn_segment_raises(tmp_path):
    mgr = _write_port(str(tmp_path), 9)
    data, lo, ln = mgr.reduce_blocks(9, N_MAPS, 2)[0]
    RESOURCES.put("shuffle_9.2", [(data, lo, ln - 3)])
    with pytest.raises(integrity.BlockCorruptionError, match="torn"):
        list(IpcReaderExec(TSCHEMA, "shuffle_9", N_OUT, "cpu").execute(2, TaskContext(2, N_OUT)))


def test_reduce_registration_is_consumed_or_discarded(tmp_path):
    mgr = _write_port(str(tmp_path), 10)
    with mgr.reduce_registration(RESOURCES, 10, N_MAPS, 3) as n_blocks:
        assert n_blocks == len(mgr.reduce_blocks(10, N_MAPS, 3)) > 0
        assert RESOURCES.keys() == ["shuffle_10.3"]
        (b,) = IpcReaderExec(TSCHEMA, "shuffle_10", N_OUT, "cpu").execute(3, TaskContext(3, N_OUT))
        assert len(RESOURCES) == 0
    assert TB.batch_to_pydict(b) == _read_port(mgr, 10, 3)
    with pytest.raises(RuntimeError, match="before reading"):
        with mgr.reduce_registration(RESOURCES, 10, N_MAPS, 4):
            raise RuntimeError("a reduce task that fails before reading")
    assert len(RESOURCES) == 0


def test_cleanup_removes_the_directory():
    mgr = LocalShuffleManager()
    open(mgr.map_output_paths(0, 0)[0], "wb").close()
    mgr.cleanup()
    assert not os.path.exists(mgr.root)
    mgr.cleanup()  # twice is fine


# ------------------------------------------------- plan.execute through files


@pytest.fixture(scope="module")
def data():
    return generate_all(0.002)


def _run(data, q):
    scans = {name: MemoryScanExec(TB.table_to_batches(data[name], TPCH_SCHEMAS[name], 2, 4096, "cpu"),
                                  TPCH_SCHEMAS[name], device="cpu") for name in TPCH_SCHEMAS}
    plan = build_query(q, scans, 2)
    out = []
    for p in range(plan.num_partitions()):
        out += [TB.batch_to_pydict(b) for b in plan.execute(p, TaskContext(p, plan.num_partitions()))]
    return out


@pytest.mark.parametrize("q", ["q1", "q3", "q6"])
def test_exchange_through_files_gives_the_in_process_rows(data, q):
    want = _run(data, q)
    conf.EXCHANGE_IN_PROCESS.set(False)
    try:
        TB.reset_copy_counts()
        got = _run(data, q)
    finally:
        conf.EXCHANGE_IN_PROCESS.set(True)
    assert got == want
    assert TB.COPIES["device_to_host"] > 0 and TB.COPIES["host_to_device"] > 0
    assert len(RESOURCES) == 0
