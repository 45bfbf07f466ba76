"""Shuffle (≙ ``blaze_tpu/parallel/shuffle.py``): partitioning, the
map-side writer of ``.data``/``.index`` files, the reduce-side reader
and the local shuffle manager.

Hash partition ids are Spark's murmur3(seed 42) pmod N, so a map stage
places every row where vanilla Spark would.  Fixed-width keys always go
through ``cuda_ops.murmur3_pids`` (the kernel on the card, its plain
version on the CPU); string keys take the plain murmur3 path, as in the
reference.  The choice is by key dtype alone, with no knob: a kernel
that fails to build or launch raises.  Round-robin ids are ``(i + r) %
N``; range ids count the boundaries a row's order words are at or past
(:func:`range_pids`).  Every batch's per-partition row counts come from
the ``pid_histogram`` kernel, whatever the partitioning.

The file shuffle: a map task (:class:`ShuffleWriterExec`) sorts each
batch by partition id on the device and brings the sorted live rows and
the counts to the host in one copy; host slices are buffered per
partition and committed as ``.data`` (one frame per partition, zlib and
crc32 by default) plus ``.index`` (u64 offsets), data first and index
last, each by atomic rename.  With ``spark.blaze.shuffle.asyncWrite``
(the default) the host copies and slicing run on a second thread
(:class:`_AsyncInserter`), in batch order, while the map task issues
the next batch's device work.  The optimizer's tier 5 folds the
traceable chain feeding a hash, round-robin or range writer into its
per-batch work (:meth:`ShuffleWriterExec.absorb_traceable_chain`): the
batch's live count then stays on the device until that copy, and so
does the round-robin offset it moves.  A reduce task
(:class:`IpcReaderExec`) takes its blocks from the resources map,
verifies every frame's checksum and stages the partition's rows on the
device as one batch in one copy, as the in-process exchange hands a
reduce partition one batch.  There is no spill yet.

Recovery: a block that is missing, torn, fails its checksum or its
decode raises ``FetchFailedError`` (``runtime/retry.py``) naming the
map task that wrote it (:func:`block_map_id`), the
``BlockCorruptionError`` or ``OSError`` as its cause, and the
scheduler re-runs that map task; a file that fails twice is
quarantined.  A commit probes the ``shuffle.write`` fault site, and is
never made by a cancelled attempt (a speculative loser), however late
it gets there; :meth:`LocalShuffleManager.invalidate` drops map outputs
and :meth:`LocalShuffleManager.sweep_inprogress` an abandoned
attempt's temporary files.
"""

from __future__ import annotations

import contextlib
import os
import queue
import re
import shutil
import struct
import tempfile
import threading
import zlib
from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import conf
from ..batch import Column, HostCopy, RecordBatch, slice_rows, tensors_to_host
from ..exprs.compile import lower
from ..exprs.hash import murmur3_columns, pmod
from ..exprs.int128 import SIGN
from ..exprs.ir import Expr
from ..io.batch_serde import (
    HostColumn, column_layout, column_tensors, concat_host_columns, decode_columns, host_rows, serialize_columns,
    split_host_columns, stage_columns,
)
from ..io.ipc_compression import IpcFrameWriter, iter_blob_frames, iter_stream_frames
from ..kernels import cuda_ops
from ..ops.base import BatchStream, ExecNode
from ..ops.filter import live_mask
from ..runtime import faults, integrity
from ..runtime.context import ResourcesMap, TaskContext
from ..runtime.integrity import BlockCorruptionError
from ..runtime.retry import FetchFailedError
from ..schema import Schema, TypeKind


class Partitioning:
    """Base marker; subclasses carry num_partitions."""

    num_partitions: int = 1


@dataclass
class SinglePartitioning(Partitioning):
    num_partitions: int = 1


@dataclass
class HashPartitioning(Partitioning):
    """murmur3(seed 42) pmod N over ``exprs`` — Spark's HashPartitioning."""

    exprs: Sequence[Expr]
    num_partitions: int


@dataclass
class RoundRobinPartitioning(Partitioning):
    """Row ``i`` of a map task's stream to partition ``(i + r) % N``
    (``df.repartition(N)``): ``r`` is 0 at a writer's first batch and
    the map task's index in the in-process exchange, as in the
    reference."""

    num_partitions: int = 1


@dataclass
class RangePartitioning(Partitioning):
    """Range partitioning on sort keys (Spark's global-sort exchange):
    partition p holds the rows in ``[boundary_{p-1}, boundary_p)`` of
    the key order, a row equal to a boundary going right, so sorting
    each partition and reading them in order gives the total order.

    ``boundaries``: one int64 array a key word (the reference's uint64
    order words, bit for bit; ``ops.sort.range_key_words``), each of
    ``num_partitions - 1`` words.  The in-process exchange computes
    exact order statistics and leaves this None; the stage scheduler's
    boundary pass fills it from a sample before the map stage runs (a
    writer refuses to run without it)."""

    fields: Sequence  # ops.sort.SortField
    num_partitions: int
    boundaries: Optional[tuple] = None


def hash_pids(schema: Schema, exprs: Sequence[Expr], cols: Sequence[Column], n: int, n_out: int) -> torch.Tensor:
    """(n,) int32 partition ids of ``n`` rows of ``cols``."""
    env = {f.name: c for f, c in zip(schema.fields, cols)}
    key_cols = [lower(e, schema, env, n) for e in exprs]
    for c in key_cols:
        if c.dtype.is_nested:
            raise NotImplementedError(f"hash partitioning by a key of nested type {c.dtype!r}")
    if not any(c.dtype.is_string for c in key_cols):
        planes, widths = zip(*(cuda_ops.column_word_planes(c) for c in key_cols))
        valids = [c.validity.contiguous() for c in key_cols]
        return cuda_ops.murmur3_pids(list(planes), list(widths), valids, n_out)
    return pmod(murmur3_columns(key_cols), n_out)


def range_pids(words: Sequence[torch.Tensor], boundaries: Sequence[torch.Tensor]) -> torch.Tensor:
    """(rows,) int32 partition ids: how many boundaries each row's
    unsigned ``words`` are at or past, compared lexicographically (≙
    the reference's ``pids`` in ``_build_range_kernels``).  Boundaries
    are compared a chunk at a time, so the (rows, chunk) masks stay
    under 2^26 entries."""
    rows, n_bounds = words[0].shape[0], boundaries[0].shape[0]
    pid = torch.zeros(rows, dtype=torch.int32, device=words[0].device)
    step = max(1, (1 << 26) // max(rows, 1))
    signed = [w ^ SIGN for w in words]
    for lo in range(0, n_bounds, step):
        past = torch.zeros((rows, min(step, n_bounds - lo)), dtype=torch.bool, device=pid.device)
        tied = torch.ones_like(past)
        for w, b in zip(signed, boundaries):
            bw = (b[lo:lo + step] ^ SIGN)[None, :]
            past |= tied & (w[:, None] > bw)
            tied &= w[:, None] == bw
        pid += (past | tied).sum(1, dtype=torch.int32)
    return pid


def round_robin_pids(rows: int, offset, n_out: int, device) -> torch.Tensor:
    """(rows,) int32 ``(i + offset) % n_out``; ``offset`` an int or a
    0-d tensor."""
    return ((torch.arange(rows, device=device) + offset) % n_out).to(torch.int32)


def sort_by_pid(batch: RecordBatch, pids: torch.Tensor, n_out: int) -> Tuple[RecordBatch, torch.Tensor]:
    """The batch's live rows stably sorted by partition id (rows of one
    partition keep their order, as with ``lax.sort``), and the (n_out,)
    int32 per-partition row counts, still on the device."""
    order = torch.sort(pids, stable=True).indices
    counts = cuda_ops.pid_histogram(pids, n_out)
    cols = [c.head(batch.num_rows) for c in batch.columns]
    return RecordBatch(batch.schema, cols, batch.num_rows).take(order, batch.capacity), counts


def split_by_counts(pending: List[Tuple[RecordBatch, torch.Tensor]], n_out: int) -> List[List[RecordBatch]]:
    """Slice each pid-sorted batch into its partitions' row ranges,
    reading every batch's counts in ONE device-to-host copy."""
    out: List[List[RecordBatch]] = [[] for _ in range(n_out)]
    if not pending:
        return out
    all_counts = torch.stack([c for _, c in pending]).cpu().tolist()
    for (batch, _), counts in zip(pending, all_counts):
        lo = 0
        for pid, k in enumerate(counts):
            if k:
                out[pid].append(slice_rows(batch, lo, k))
            lo += k
    return out


# ------------------------------------------------------------ file shuffle


class ShuffleRepartitioner:
    """Buffers a map task's host rows per output partition and commits
    them as one ``.data``/``.index`` pair (≙ the reference's
    ``ShuffleRepartitioner`` without its spill path)."""

    def __init__(self, n_out: int, task_attempt_id: int = 0):
        self.n_out = n_out
        self.task_attempt_id = task_attempt_id
        self._buffers: List[List[Tuple[int, Sequence[HostColumn]]]] = [[] for _ in range(n_out)]

    def insert_sorted(self, cols: Sequence[HostColumn], counts: Sequence[int]) -> None:
        """Append the per-partition slices (views) of pid-sorted host rows."""
        lo = 0
        for pid, k in enumerate(counts):
            k = int(k)
            if k:
                self._buffers[pid].append((k, [host_rows(c, lo, lo + k) for c in cols]))
            lo += k

    def write_output(self, data_path: str, index_path: str,
                     cancel: Optional[threading.Event] = None) -> Optional[List[int]]:
        """Commit ``.data`` (one frame per non-empty partition) and
        ``.index`` (n_out + 1 u64 offsets): each is written under an
        attempt-qualified temporary name and renamed into place, data
        first and index last, so a reader that finds the index finds
        whole data.  Returns the partitions' byte lengths, or None, with
        nothing committed, when ``cancel`` is set before the renames.
        Probes ``shuffle.write`` first and its ``@corrupt`` after the
        renames (the Nth block that committed)."""
        faults.hit("shuffle.write", attempt=self.task_attempt_id, detail=data_path, cancel=cancel)
        if cancel is not None and cancel.is_set():
            return None
        suffix = f".inprogress.a{self.task_attempt_id}"
        tmp_data, tmp_index = data_path + suffix, index_path + suffix
        lengths: List[int] = []
        offsets = [0]
        committed = False
        try:
            with open(tmp_data, "wb") as f:
                w = IpcFrameWriter(f)
                for parts in self._buffers:
                    start = w.bytes_written
                    if parts:
                        w.write(serialize_columns(concat_host_columns([c for _, c in parts]),
                                                  sum(k for k, _ in parts)))
                    lengths.append(w.bytes_written - start)
                    offsets.append(w.bytes_written)
            with open(tmp_index, "wb") as f:
                f.write(struct.pack(f"<{len(offsets)}Q", *offsets))
            if cancel is None or not cancel.is_set():  # a loser's output must not replace the winner's
                os.replace(tmp_data, data_path)
                os.replace(tmp_index, index_path)
                committed = True
        finally:
            if not committed:
                for p in (tmp_data, tmp_index):
                    if os.path.exists(p):
                        os.unlink(p)
        if not committed:
            return None
        self._buffers = [[] for _ in range(self.n_out)]
        if faults.corrupt("shuffle.write", attempt=self.task_attempt_id):
            integrity.flip_byte_in_file(data_path)
        return lengths


def _insert_host(rep: ShuffleRepartitioner, host: Sequence[np.ndarray], layout: Sequence,
                 n: Optional[int], counts: Optional[Sequence[int]]) -> None:
    """Hand one batch's host copy to the repartitioner: the arrays of
    its pid-sorted device columns, then (hashed) its counts; ``layout``
    (``column_layout``) puts the opaque columns' host rows in place.
    ``n`` None: the rows came padded to their capacity and the counts'
    sum is the live count (the fused write); ``counts`` None: they are
    in ``host``."""
    cols, rest = split_host_columns(host, layout)
    if counts is None:
        counts = rest[0].tolist()
    if n is None:
        n = sum(counts)
        cols = [host_rows(c, 0, n) for c in cols]
    rep.insert_sorted(cols, counts)


class _AsyncInserter:
    """The shuffle write's stager (≙ the reference's ``_AsyncInserter``,
    ``spark.blaze.shuffle.asyncWrite``): one thread takes each batch's
    pending host copy, waits for it and hands the arrays to the
    repartitioner, in the order the batches were put, while the map
    task issues the next batch's device work.  The queue holds at most
    ``depth`` batches, so device outputs in flight stay bounded.  A
    staging error surfaces at the next :meth:`put` or at :meth:`close`;
    :meth:`abort` stops the thread and drops what is queued."""

    _DONE = object()

    def __init__(self, rep: ShuffleRepartitioner, depth: int, metrics):
        self._rep = rep
        self._metrics = metrics
        self._q: "queue.Queue" = queue.Queue(max(1, depth))
        # appended by the stager alone; the producer reads it racily at
        # put (one batch late at worst) and again at close, after the join
        self._errs: List[BaseException] = []
        self._aborted = False
        self._thread = threading.Thread(target=self._drain, name="shuffle-async-insert", daemon=True)
        self._thread.start()

    def _drain(self) -> None:
        while True:
            item = self._q.get()
            if item is _AsyncInserter._DONE:
                return
            if self._errs or self._aborted:
                continue  # failing or cancelled: discard, stage nothing
            copy, layout, n, counts = item
            try:
                with self._metrics.timer("shuffle_host_stage_time"):
                    _insert_host(self._rep, copy.result(), layout, n, counts)
            except BaseException as e:  # noqa: BLE001 - surfaced to the producer
                self._errs.append(e)

    def put(self, item) -> None:
        if self._errs:
            raise self._errs[0]
        self._q.put(item)

    def close(self) -> None:
        """Stage everything put, join, and raise the first staging
        error: call before committing the output."""
        self._q.put(self._DONE)
        self._thread.join()
        if self._errs:
            raise self._errs[0]

    def abort(self) -> None:
        """Stop without raising (an error is already on its way, or the
        task was cancelled) and skip whatever is still queued."""
        self._aborted = True
        self._q.put(self._DONE)
        self._thread.join()


class ShuffleWriterExec(ExecNode):
    """One map task: runs the child's partition and commits its rows,
    partitioned, to ``data_path``/``index_path``.  The output stream is
    empty (the files are the output), as in the reference.  A range
    writer needs its partitioning's boundaries (the stage scheduler's
    boundary pass); a round-robin writer starts each map task at
    partition 0 and moves on by each batch's live rows."""

    def __init__(self, child: ExecNode, partitioning: Partitioning, data_path: str, index_path: str):
        super().__init__([child])
        if not isinstance(partitioning, (HashPartitioning, SinglePartitioning, RoundRobinPartitioning,
                                         RangePartitioning)):
            raise NotImplementedError(f"{type(partitioning).__name__} is not ported")
        self.partitioning = partitioning
        self.data_path = data_path
        self.index_path = index_path
        # tier 5 (absorb_traceable_chain): the absorbed chain's
        # transform and output schema; None: not fused
        self._fused_chain = None
        self._out_schema: Optional[Schema] = None

    @property
    def schema(self) -> Schema:
        return self._out_schema if self._out_schema is not None else self.children[0].schema

    @property
    def fused(self) -> bool:
        return self._out_schema is not None

    def absorb_traceable_chain(self) -> None:
        """Tier 5: fold the traceable chain feeding this writer (often
        one FusedStageExec) into its per-batch work, which then runs the
        chain, the pids over the batch's whole capacity (padding's pid
        -1, sorted last and counted nowhere), the pid sort and the counts
        with no host read: the batch's host copy is its one read.  Hash,
        round-robin and range partitioning over more than one partition;
        idempotent."""
        from ..ops.fusion import BufferPartitionExec, compose, traceable_chain_from

        part = self.partitioning
        if (self.fused or part.num_partitions <= 1
                or not isinstance(part, (HashPartitioning, RoundRobinPartitioning, RangePartitioning))):
            return
        ops, bottom, buffered = traceable_chain_from(self.children[0])
        self._out_schema = self.children[0].schema
        if ops:
            self._fused_chain = compose([op.trace_fn() for op in reversed(ops)])
            self.children[0] = BufferPartitionExec(bottom) if buffered else bottom

    def _pids(self, cols: Sequence[Column], n, rr, bounds) -> Tuple[torch.Tensor, object]:
        """(int32 partition ids of every row of ``cols``, the next
        round-robin offset); ``n`` live rows lead."""
        part, n_out, rows = self.partitioning, self.partitioning.num_partitions, cols[0].capacity
        if isinstance(part, HashPartitioning):
            return hash_pids(self.schema, part.exprs, cols, rows, n_out), rr
        if isinstance(part, RoundRobinPartitioning):
            return round_robin_pids(rows, rr, n_out, cols[0].device), (rr + n) % n_out
        from ..ops.sort import range_key_words

        return range_pids(range_key_words(self.schema, part.fields, cols, n), bounds), rr

    def _sorted_rows(self, batch: RecordBatch, rr, bounds):
        """(the tensors of the batch's one host copy: its device rows
        sorted by partition id, then, partitioned, the counts; the
        columns' ``column_layout``, with the opaque columns' sorted host
        rows; the live row count, None when only the counts know it; the
        counts when the host knows them already; the next round-robin
        offset).  No host read, but for one copy of the sort order when
        a column is opaque."""
        n_out = self.partitioning.num_partitions
        cols, n = batch.columns, batch.num_rows
        if self._fused_chain is not None:
            cols, n = self._fused_chain(cols, n)
        if isinstance(self.partitioning, SinglePartitioning) or n_out <= 1:
            return column_tensors(cols, n), column_layout(cols, n), n, [n] + [0] * (n_out - 1), rr
        if not self.fused:
            pids, rr = self._pids([c.head(n) for c in cols], n, rr, bounds)
            batch, counts = sort_by_pid(batch, pids, n_out)
            return (column_tensors(batch.columns, n) + [counts], column_layout(batch.columns, n),
                    n, None, rr)
        cap = cols[0].capacity
        live = live_mask(cap, n, cols[0].device)
        pids, rr = self._pids(cols, n, rr, bounds)
        pids = torch.where(live, pids, -1)
        counts = cuda_ops.pid_histogram(pids, n_out)
        order = torch.sort(torch.where(live, pids, n_out), stable=True).indices
        cols = [c.take(order) for c in cols]
        return column_tensors(cols) + [counts], column_layout(cols), None, None, rr

    def execute(self, partition: int, ctx: TaskContext) -> BatchStream:
        part = self.partitioning
        if isinstance(part, RangePartitioning) and part.boundaries is None and part.num_partitions > 1:
            raise NotImplementedError("range partitioning needs global boundaries: run the stage "
                                      "scheduler's boundary pass (or the in-process exchange)")

        def stream():
            rep = ShuffleRepartitioner(part.num_partitions, ctx.task_attempt_id)
            inserter = None
            if bool(conf.SHUFFLE_ASYNC_WRITE.get()):
                inserter = _AsyncInserter(rep, int(conf.SHUFFLE_ASYNC_QUEUE_DEPTH.get()), self.metrics)
            # the round-robin offset: a host int while the live counts
            # are, a 0-d tensor after a fused chain's count (no read)
            rr, bounds = 0, None
            try:
                for batch in self.children[0].execute(partition, ctx):
                    if not ctx.is_task_running():
                        return
                    with self.metrics.timer("elapsed_compute"):
                        if bounds is None and isinstance(part, RangePartitioning) and part.num_partitions > 1:
                            bounds = [torch.as_tensor(np.asarray(b, np.int64), device=batch.device)
                                      for b in part.boundaries]
                        tensors, layout, n, counts, rr = self._sorted_rows(batch, rr, bounds)
                        if inserter is None:
                            _insert_host(rep, tensors_to_host(tensors), layout, n, counts)
                        else:
                            inserter.put((HostCopy(tensors), layout, n, counts))
                if inserter is not None:
                    inserter, staging = None, inserter
                    staging.close()
                if not ctx.is_task_running():
                    return  # a cancelled map task never commits a partial output
                with self.metrics.timer("output_io_time"):
                    lengths = rep.write_output(self.data_path, self.index_path, ctx.cancel_event)
                if lengths is not None:
                    self.metrics.add("data_size", sum(lengths))
            finally:
                if inserter is not None:
                    inserter.abort()
            return
            yield  # an empty stream

        return stream()


#: a shuffle block: in-memory frames, or (path, offset, length) of a file segment
BlockObject = Union[bytes, Tuple[str, int, int]]

_MAP_FILE_RE = re.compile(r"shuffle_\d+_(\d+)\.data$")


def block_map_id(block: BlockObject) -> Optional[int]:
    """The map task that wrote a file block (from the manager's
    ``shuffle_<sid>_<map>.data`` names), or None for in-memory frames:
    what lets a fetch failure re-run only that map task."""
    if isinstance(block, bytes):
        return None
    m = _MAP_FILE_RE.search(os.path.basename(block[0]))
    return int(m.group(1)) if m else None


class IpcReaderExec(ExecNode):
    """The reduce side: reads partition ``p``'s blocks, registered in
    the task's resources under ``<resource_id>.<p>``, verifies every
    frame and yields the partition's rows as one batch on ``device``
    (the package default when None).  A broadcast reads the same way
    from checksummed blobs.  Every failure to read a block raises
    ``FetchFailedError``; the metrics count ``corruption_detected`` and
    ``blocks_quarantined``."""

    def __init__(self, schema: Schema, resource_id: str, num_partitions: int = 1,
                 device: Union[None, str, torch.device] = None):
        super().__init__([])
        self._schema = schema
        self.resource_id = resource_id
        self._num_partitions = num_partitions
        self._device = device

    @property
    def schema(self) -> Schema:
        return self._schema

    @property
    def device(self) -> torch.device:
        from .. import resolve_device

        return resolve_device(self._device)

    def num_partitions(self) -> int:
        return self._num_partitions

    def _fetch_failed(self, block: BlockObject, partition: int, e: BaseException) -> FetchFailedError:
        """Bad producer bytes as a fetch failure naming the map task that
        wrote them; a corruption is counted, and a file that has now
        failed twice quarantined, so that its map task re-runs in full."""
        path = None if isinstance(block, bytes) else block[0]
        if isinstance(e, BlockCorruptionError):
            self.metrics.add("corruption_detected")
            if path is not None and integrity.note_corruption(path) >= 2 and integrity.quarantine(path):
                self.metrics.add("blocks_quarantined")
        mid = block_map_id(block)
        return FetchFailedError(self.resource_id, partition, f"{type(e).__name__}: {e}",
                                map_ids=None if mid is None else [mid])

    def _decoded(self, block: BlockObject, partition: int) -> list:
        """The block's (rows, host columns) frames, verified."""
        try:
            if isinstance(block, bytes):
                payloads = list(iter_blob_frames(block, site=self.resource_id))
            else:
                path, offset, length = block
                with open(path, "rb") as f:
                    f.seek(offset)
                    payloads = list(iter_stream_frames(f, length, site=self.resource_id, path=path))
            return [decode_columns(p, self._schema) for p in payloads]
        except (OSError, struct.error, zlib.error, ValueError, EOFError) as e:
            raise self._fetch_failed(block, partition, e) from e

    def execute(self, partition: int, ctx: TaskContext) -> BatchStream:
        def stream():
            key = f"{self.resource_id}.{partition}"
            try:
                blocks = ctx.resources.get(key)
            except KeyError as e:
                raise FetchFailedError(self.resource_id, partition, "no blocks registered") from e
            parts = []
            with self.metrics.timer("shuffle_read_total_time"):
                for block in blocks:
                    faults.hit("shuffle.fetch", attempt=ctx.task_attempt_id, detail=self.resource_id,
                               cancel=ctx.cancel_event)
                    parts += [(n, cols) for n, cols in self._decoded(block, partition) if n]
                    self.metrics.add("blocks_read")
                if not parts:
                    return
                out = stage_columns(self._schema, parts, self.device)
            self._record_batch(out)
            yield out

        return stream()


class LocalShuffleManager:
    """Map outputs under one local directory (≙ the reference's
    ``LocalShuffleManager``): ``shuffle_<sid>_<map>.data``/``.index``.
    ``root`` defaults to a fresh temporary directory, which
    :meth:`cleanup` removes.

    Both file-shuffle drivers, the exchange with
    ``spark.blaze.exchange.inProcess=false`` and the stage scheduler,
    take a map task from :meth:`map_writer` and register a reduce
    task's input with :meth:`reduce_registration`."""

    def __init__(self, root: Optional[str] = None):
        self.root = root or tempfile.mkdtemp(prefix="blaze_shuffle_")
        os.makedirs(self.root, exist_ok=True)

    def map_output_paths(self, shuffle_id: int, map_id: int) -> Tuple[str, str]:
        base = os.path.join(self.root, f"shuffle_{shuffle_id}_{map_id}")
        return base + ".data", base + ".index"

    def map_writer(self, child: ExecNode, partitioning: Partitioning, shuffle_id: int,
                   map_id: int) -> "ShuffleWriterExec":
        """Map task ``map_id`` of shuffle ``shuffle_id``: partition
        ``map_id`` of ``child`` written to this manager's files."""
        return ShuffleWriterExec(child, partitioning, *self.map_output_paths(shuffle_id, map_id))

    @contextlib.contextmanager
    def reduce_registration(self, resources: ResourcesMap, shuffle_id: int, num_maps: int,
                            reduce_id: int) -> Iterator[int]:
        """Registers reduce partition ``reduce_id``'s blocks under
        ``shuffle_<sid>.<reduce_id>``, the key an :class:`IpcReaderExec`
        over the shuffle reads, and yields their count; on exit a
        registration the reader did not consume is discarded."""
        key = f"shuffle_{shuffle_id}.{reduce_id}"
        blocks = self.reduce_blocks(shuffle_id, num_maps, reduce_id)
        resources.put(key, blocks)
        try:
            yield len(blocks)
        finally:
            resources.discard(key)

    def reduce_blocks(self, shuffle_id: int, num_maps: int, reduce_id: int) -> List[BlockObject]:
        """Reduce partition ``reduce_id``'s non-empty segment of every
        map output; a map output without an index raises
        ``FetchFailedError`` naming that map (the reference skips it)."""
        blocks: List[BlockObject] = []
        for m in range(num_maps):
            data, index = self.map_output_paths(shuffle_id, m)
            try:
                with open(index, "rb") as f:
                    raw = f.read()
            except OSError as e:
                raise FetchFailedError(f"shuffle_{shuffle_id}", reduce_id, f"map {m}: {e}", map_ids=[m]) from e
            offsets = struct.unpack(f"<{len(raw) // 8}Q", raw)
            if reduce_id + 1 >= len(offsets):
                raise FetchFailedError(f"shuffle_{shuffle_id}", reduce_id,
                                       f"map {m}: index of {len(offsets)} offsets", map_ids=[m])
            lo, hi = offsets[reduce_id], offsets[reduce_id + 1]
            if hi > lo:
                blocks.append((data, lo, hi - lo))
        return blocks

    def _remove(self, keep) -> int:
        """Unlink the files under the root whose names ``keep`` rejects;
        returns how many went."""
        removed = 0
        for fn in os.listdir(self.root) if os.path.isdir(self.root) else ():
            if not keep(fn):
                try:
                    os.unlink(os.path.join(self.root, fn))
                    removed += 1
                except OSError:
                    pass
        return removed

    def invalidate(self, shuffle_id: int, map_ids: Optional[Sequence[int]] = None) -> int:
        """Drop a shuffle's map outputs (and temporary files), those of
        ``map_ids`` only when given, before their map tasks re-run; a
        quarantined ``.corrupt`` file stays.  Returns the files removed."""
        prefixes = tuple(f"shuffle_{shuffle_id}_{m}." for m in map_ids) if map_ids is not None \
            else (f"shuffle_{shuffle_id}_",)
        return self._remove(lambda fn: not fn.startswith(prefixes) or fn.endswith(".corrupt"))

    def sweep_inprogress(self, shuffle_id: Optional[int] = None, map_id: Optional[int] = None,
                         attempt: Optional[int] = None) -> int:
        """Remove the ``.inprogress`` temporary files of a shuffle, of one
        of its map tasks, of one attempt of it (what an abandoned or
        cancelled attempt may leave).  Returns the files removed."""
        prefix = "shuffle_" if shuffle_id is None else f"shuffle_{shuffle_id}_" if map_id is None \
            else f"shuffle_{shuffle_id}_{map_id}."
        suffix = f".inprogress.a{attempt}" if attempt is not None else ".inprogress"

        def keep(fn: str) -> bool:
            if not fn.startswith(prefix) or ".inprogress" not in fn or fn.endswith(".corrupt"):
                return True
            return attempt is not None and not fn.endswith(suffix)

        return self._remove(keep)

    def data_bytes(self, shuffle_id: int, num_maps: int) -> int:
        """Bytes of the committed ``.data`` files of a shuffle."""
        return sum(os.path.getsize(self.map_output_paths(shuffle_id, m)[0]) for m in range(num_maps))

    def cleanup(self) -> None:
        """Remove the root and every file under it."""
        if os.path.isdir(self.root):
            shutil.rmtree(self.root)
