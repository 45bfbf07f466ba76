"""Corruption recovery (the reference's ``tests/test_integrity.py``),
the in-process exchange's recovery tier and the retry window of a
result task, on the port.

A ``@corrupt`` rule flips a byte of a committed map output: the
reader's checksum catches it, names the map task, and only that task
re-runs; the rows and the counters equal the reference's under the same
spec.  A file that fails twice is quarantined.  A corrupt broadcast blob
regenerates its broadcast stage.
"""

import os

import pytest

from blaze_tpu.runtime.retry import FetchFailedError as JFetchFailed

import blaze_tpu_torch.batch as TB
from blaze_tpu_torch import conf
from blaze_tpu_torch.exprs import col
from blaze_tpu_torch.ops import MemoryScanExec
from blaze_tpu_torch.parallel.exchange import NativeShuffleExchangeExec
from blaze_tpu_torch.parallel.shuffle import HashPartitioning, IpcReaderExec, LocalShuffleManager, ShuffleWriterExec
from blaze_tpu_torch.runtime import faults, integrity, retry
from blaze_tpu_torch.runtime import scheduler as S
from blaze_tpu_torch.runtime.context import RESOURCES, TaskContext
from blaze_tpu_torch.schema import DataType, Field, Schema
from blaze_tpu_torch.serde import from_proto

from test_torch_faults import (  # noqa: F401 - the fixtures are this module's too
    N_PARTS, _clean_faults, _inject, _on_cpu, counters, data, fault_free, jax_data, run_jax, run_port,
)


@pytest.mark.parametrize("spec,reruns", [
    # map 0's commit: its first frame fails the first reduce task that reads it
    ("shuffle.write@1@corrupt", 1),
    # and its re-run's commit (hits: maps 0-2, then map 0 again): the path
    # fails twice, is quarantined, and map 0 runs a third time
    ("shuffle.write@1@corrupt,shuffle.write@4@corrupt", 2),
])
def test_a_corrupt_shuffle_block_is_detected_and_recovered(data, jax_data, fault_free, spec, reruns):
    want = fault_free("q6")
    _inject(spec)
    rows, stats, left = run_port(data, "q6")
    _inject(spec)
    jrows, jm = run_jax(jax_data, "q6")
    assert rows == jrows == want
    assert counters(stats) == counters(None, jm)
    assert stats.fetch_failures == stats.map_stage_reruns == stats.map_tasks_rerun == reruns
    assert stats.map_tasks_rerun == jm.get("map_tasks_rerun")
    assert len([f for f in left if f.endswith(".corrupt")]) == reruns - 1  # the quarantined file is kept


def test_the_reader_counts_and_quarantines(tmp_path):
    """The reader's metrics count each corruption; the second at one
    path quarantines it: renamed ``.corrupt``, its index gone, and the
    manager's next registration names the map task to re-run."""
    schema = Schema([Field("x", DataType.int64())])
    scan = MemoryScanExec([[TB.batch_from_pydict({"x": list(range(100))}, schema, device="cpu")]], schema,
                          device="cpu")
    manager = LocalShuffleManager(str(tmp_path))
    data_p, index_p = manager.map_output_paths(3, 0)
    list(ShuffleWriterExec(scan, HashPartitioning([col("x")], 2), data_p, index_p).execute(0, TaskContext(0, 1)))
    integrity.flip_byte_in_file(data_p)
    reader = IpcReaderExec(schema, "shuffle_3", 2, "cpu")
    for n in (1, 2):
        part = next(p for p in range(2) if manager.reduce_blocks(3, 1, p) and
                    manager.reduce_blocks(3, 1, p)[0][1] == 0)
        RESOURCES.put(f"shuffle_3.{part}", manager.reduce_blocks(3, 1, part))
        with pytest.raises(retry.FetchFailedError) as e:
            list(reader.execute(part, TaskContext(part, 2)))
        assert e.value.map_ids == [0] and isinstance(e.value.__cause__, integrity.BlockCorruptionError)
        assert reader.metrics.values["corruption_detected"] == n
    assert reader.metrics.values["blocks_quarantined"] == 1
    assert os.listdir(tmp_path) == ["shuffle_3_0.data.corrupt"]
    with pytest.raises(retry.FetchFailedError) as e:
        manager.reduce_blocks(3, 1, 0)
    assert e.value.map_ids == [0]


def test_quarantine_renames_and_drops_the_index(tmp_path):
    data_p, index_p = tmp_path / "shuffle_5_0.data", tmp_path / "shuffle_5_0.index"
    data_p.write_bytes(b"bad bytes")
    index_p.write_bytes(b"\x00" * 16)
    assert [integrity.note_corruption(str(data_p)) for _ in range(2)] == [1, 2]
    assert integrity.quarantine(str(data_p)) == str(data_p) + ".corrupt"
    assert os.listdir(tmp_path) == ["shuffle_5_0.data.corrupt"]
    assert integrity.note_corruption(str(data_p)) == 1  # a regenerated file starts clean
    assert integrity.quarantine(str(data_p)) is None  # gone already


def test_a_corrupt_broadcast_blob_regenerates_its_stage(data, monkeypatch):
    """q03's broadcast stage (its first blob flipped): the consumer's
    reader raises a fetch failure on ``broadcast_<id>`` and the broadcast
    stage runs again, not a map stage.  (The reference's ``run_stages``
    is wrong on q03, ROADMAP queue C: the port is held to its own
    fault-free rows.)"""
    want = run_port(data, "q3")[0]
    _inject("broadcast.write@1@corrupt")
    rows, stats, _ = run_port(data, "q3")
    assert rows == want
    assert (stats.fetch_failures, stats.broadcast_stage_reruns, stats.map_stage_reruns) == (1, 1, 0)
    assert stats.task_retries == 0


def test_fetch_failed_names_its_producer_as_the_reference():
    for package in (retry.FetchFailedError, JFetchFailed):
        assert package("broadcast_7", 0).broadcast_id == 7
        assert package("broadcast_7", 0).shuffle_id is None
        assert package("shuffle_3", 0).broadcast_id is None
        assert package("shuffle_3.2", 0).shuffle_id == 3
    e = retry.FetchFailedError("shuffle_3", 1, "gone", map_ids=[2, 0, 2])
    assert e.map_ids == [0, 2] and str(e) == "fetch failed: shuffle_3 partition 1 map_ids [0, 2]: gone"


def test_the_in_process_file_exchange_recovers_once():
    """With ``spark.blaze.exchange.inProcess`` false, a fetch failure
    before a reduce partition's first batch runs the exchange's map
    tasks again, once; a second one raises to the task."""
    schema = Schema([Field("x", DataType.int64())])
    batches = [[TB.batch_from_pydict({"x": list(range(m * 50, m * 50 + 50))}, schema, device="cpu")]
               for m in range(3)]

    def rows(spec):
        _inject(spec)
        ex = NativeShuffleExchangeExec(MemoryScanExec(batches, schema, device="cpu"),
                                       HashPartitioning([col("x")], 2))
        out = sorted(x for p in range(2) for b in ex.execute(p, TaskContext(p, 2))
                     for x in TB.batch_to_pydict(b)["x"])
        return out, ex._generation

    conf.EXCHANGE_IN_PROCESS.set(False)
    try:
        assert rows("") == (list(range(150)), 0)
        assert rows("shuffle.fetch@1") == (list(range(150)), 1)
        with pytest.raises(retry.FetchFailedError):
            rows("shuffle.fetch@1,shuffle.fetch@4")  # partition 0's first block, then its third after the re-run
    finally:
        conf.EXCHANGE_IN_PROCESS.set(True)
    assert len(RESOURCES) == 0


def test_a_result_task_that_yielded_fails_without_repeating_rows(data, monkeypatch):
    """Past its first batch a result task is not replayed: the stream
    raises, and the caller has each row once."""
    real = from_proto.run_task

    def failing_after_one(td, **kw):
        stream = real(td, **kw)
        if "task_1_" not in str(from_proto.pb.TaskDefinition.decode(td).task_id):
            return stream

        def one_then_fail():
            yield next(iter(stream))
            raise faults.InjectedFault("task.compute", 0, "after a batch")

        return one_then_fail()

    monkeypatch.setattr(from_proto, "run_task", failing_after_one)
    got = []
    with pytest.raises(faults.InjectedFault, match="after a batch"):
        for b in S.run_stages(*S.split_stages(_q6_plan(data)), S.RunStats()):
            got.append(b)
    assert len(got) == 1


def _q6_plan(data):
    from blaze_tpu_torch.tpch import TPCH_SCHEMAS, build_query

    scans = {name: MemoryScanExec(TB.table_to_batches(data[name], TPCH_SCHEMAS[name], N_PARTS, 4096, "cpu"),
                                  TPCH_SCHEMAS[name], device="cpu") for name in TPCH_SCHEMAS}
    return build_query("q6", scans, N_PARTS)


def test_a_handled_failure_keeps_no_frames(data):
    """A retried failure drops its traceback and its causes': their
    frames would hold the failed attempt's tensors through the retry."""
    stages, manager = S.split_stages(_q6_plan(data))
    runner = S.StageRunner(stages, manager)

    def fail():
        try:
            raise OSError("the cause")
        except OSError as e:
            raise faults.InjectedFault("task.compute", 1) from e

    try:
        fail()
    except faults.InjectedFault as exc:
        assert exc.__traceback__ is not None
        assert runner.handle_failure(stages[0], 0, exc, 0, 0) == (1, 0, 0.0)
        assert exc.__traceback__ is None and exc.__cause__.__traceback__ is None
    finally:
        manager.cleanup()
    assert runner.stats.task_retries == 1
    with pytest.raises(retry.TaskRetriesExhausted):
        runner.handle_failure(stages[0], 0, faults.InjectedFault("task.compute", 2), 3, 0)
    with pytest.raises(NotImplementedError):
        runner.handle_failure(stages[0], 0, NotImplementedError("unported"), 0, 0)
