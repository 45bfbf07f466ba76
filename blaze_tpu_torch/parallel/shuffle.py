"""Shuffle (≙ ``blaze_tpu/parallel/shuffle.py``): partitioning, the
map-side writer of ``.data``/``.index`` files, the reduce-side reader
and the local shuffle manager.

Partition ids are Spark's murmur3(seed 42) pmod N, so a map stage
places every row where vanilla Spark would.  Fixed-width keys always go
through ``cuda_ops.murmur3_pids`` (the kernel on the card, its plain
version on the CPU); string keys take the plain murmur3 path, as in the
reference.  The choice is by key dtype alone, with no knob: a kernel
that fails to build or launch raises.  Every batch's per-partition row
counts come from the ``pid_histogram`` kernel.

The file shuffle: a map task (:class:`ShuffleWriterExec`) sorts each
batch by partition id on the device and brings the sorted live rows and
the counts to the host in one copy; host slices are buffered per
partition and committed as ``.data`` (one frame per partition, zlib and
crc32 by default) plus ``.index`` (u64 offsets), data first and index
last, each by atomic rename.  A reduce task (:class:`IpcReaderExec`)
takes its blocks from the resources map, verifies every frame's
checksum and stages the partition's rows on the device as one batch in
one copy, as the in-process exchange hands a reduce partition one
batch.  There is no spill yet.
"""

from __future__ import annotations

import contextlib
import os
import shutil
import struct
import tempfile
import zlib
from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..batch import Column, RecordBatch, slice_rows
from ..exprs.compile import lower
from ..exprs.hash import murmur3_columns, pmod
from ..exprs.ir import Expr
from ..io.batch_serde import HostColumn, decode_columns, host_columns, serialize_columns, stage_columns
from ..io.ipc_compression import IpcFrameWriter, iter_blob_frames, iter_stream_frames
from ..kernels import cuda_ops
from ..ops.base import BatchStream, ExecNode
from ..runtime.context import ResourcesMap, TaskContext
from ..runtime.integrity import BlockCorruptionError
from ..schema import Schema


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


def hash_pids(schema: Schema, exprs: Sequence[Expr], cols: Sequence[Column], n: int, n_out: int) -> torch.Tensor:
    """(n,) int32 partition ids of ``n`` rows of ``cols``."""
    env = {f.name: c for f, c in zip(schema.fields, cols)}
    key_cols = [lower(e, schema, env, n) for e in exprs]
    if not any(c.dtype.is_string for c in key_cols):
        planes, widths = zip(*(cuda_ops.column_word_planes(c) for c in key_cols))
        valids = [c.validity.contiguous() for c in key_cols]
        return cuda_ops.murmur3_pids(list(planes), list(widths), valids, n_out)
    return pmod(murmur3_columns(key_cols), n_out)


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


class FetchFailedError(RuntimeError):
    """A reduce task's block is missing: not registered, or its file or
    index is gone or torn.  (A block whose checksum fails raises
    :class:`BlockCorruptionError`.)"""

    def __init__(self, resource_id: str, partition: int, detail: str):
        self.resource_id = resource_id
        self.partition = partition
        super().__init__(f"fetch failed: {resource_id} partition {partition}: {detail}")


def _concat_host(parts: Sequence[Tuple[int, Sequence[HostColumn]]]) -> List[HostColumn]:
    """Row-concatenate host column slices; string widths merge to the
    widest slice."""
    if len(parts) == 1:
        return list(parts[0][1])
    out = []
    for i in range(len(parts[0][1])):
        datas = [cols[i][0] for _, cols in parts]
        if datas[0].ndim == 2:
            w = max(d.shape[1] for d in datas)
            datas = [d if d.shape[1] == w else np.pad(d, ((0, 0), (0, w - d.shape[1])))
                     for d in datas]
        lengths = None if parts[0][1][i][2] is None else np.concatenate([cols[i][2] for _, cols in parts])
        out.append((np.concatenate(datas), np.concatenate([cols[i][1] for _, cols in parts]), lengths))
    return out


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
                self._buffers[pid].append(
                    (k, [tuple(None if a is None else a[lo:lo + k] for a in c) for c in cols]))
            lo += k

    def write_output(self, data_path: str, index_path: str) -> List[int]:
        """Commit ``.data`` (one frame per non-empty partition) and
        ``.index`` (n_out + 1 u64 offsets): each is written under an
        attempt-qualified temporary name and renamed into place, data
        first and index last, so a reader that finds the index finds
        whole data.  Returns the partitions' byte lengths."""
        suffix = f".inprogress.a{self.task_attempt_id}"
        tmp_data, tmp_index = data_path + suffix, index_path + suffix
        lengths: List[int] = []
        offsets = [0]
        try:
            with open(tmp_data, "wb") as f:
                w = IpcFrameWriter(f)
                for parts in self._buffers:
                    start = w.bytes_written
                    if parts:
                        w.write(serialize_columns(_concat_host(parts), sum(k for k, _ in parts)))
                    lengths.append(w.bytes_written - start)
                    offsets.append(w.bytes_written)
            with open(tmp_index, "wb") as f:
                f.write(struct.pack(f"<{len(offsets)}Q", *offsets))
            os.replace(tmp_data, data_path)
            os.replace(tmp_index, index_path)
        except BaseException:
            for p in (tmp_data, tmp_index):
                if os.path.exists(p):
                    os.unlink(p)
            raise
        self._buffers = [[] for _ in range(self.n_out)]
        return lengths


class ShuffleWriterExec(ExecNode):
    """One map task: runs the child's partition and commits its rows,
    partitioned, to ``data_path``/``index_path``.  The output stream is
    empty (the files are the output), as in the reference."""

    def __init__(self, child: ExecNode, partitioning: Partitioning, data_path: str, index_path: str):
        super().__init__([child])
        if not isinstance(partitioning, (HashPartitioning, SinglePartitioning)):
            raise NotImplementedError(f"{type(partitioning).__name__} is not ported")
        self.partitioning = partitioning
        self.data_path = data_path
        self.index_path = index_path

    @property
    def schema(self) -> Schema:
        return self.children[0].schema

    def _host_rows(self, batch: RecordBatch) -> Tuple[List[HostColumn], Sequence[int]]:
        """A batch's live rows on the host sorted by partition id, and
        the rows per partition: one device-to-host copy."""
        n_out = self.partitioning.num_partitions
        if isinstance(self.partitioning, HashPartitioning) and n_out > 1:
            cols = [c.head(batch.num_rows) for c in batch.columns]
            pids = hash_pids(self.schema, self.partitioning.exprs, cols, batch.num_rows, n_out)
            batch, counts = sort_by_pid(batch, pids, n_out)
            host, (counts,) = host_columns(batch, extra=(counts,))
            return host, counts.tolist()
        return host_columns(batch)[0], [batch.num_rows] + [0] * (n_out - 1)

    def execute(self, partition: int, ctx: TaskContext) -> BatchStream:
        def stream():
            rep = ShuffleRepartitioner(self.partitioning.num_partitions, ctx.task_attempt_id)
            for batch in self.children[0].execute(partition, ctx):
                if not ctx.is_task_running():
                    return
                with self.metrics.timer("elapsed_compute"):
                    rep.insert_sorted(*self._host_rows(batch))
            if not ctx.is_task_running():
                return  # a cancelled map task never commits a partial output
            with self.metrics.timer("output_io_time"):
                lengths = rep.write_output(self.data_path, self.index_path)
            self.metrics.add("data_size", sum(lengths))
            return
            yield  # an empty stream

        return stream()


#: a shuffle block: in-memory frames, or (path, offset, length) of a file segment
BlockObject = Union[bytes, Tuple[str, int, int]]


class IpcReaderExec(ExecNode):
    """The reduce side: reads partition ``p``'s blocks, registered in
    the task's resources under ``<resource_id>.<p>``, verifies every
    frame and yields the partition's rows as one batch on ``device``
    (the package default when None).  A broadcast reads the same way
    from checksummed blobs."""

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

    def _payloads(self, block: BlockObject, partition: int) -> List[bytes]:
        if isinstance(block, bytes):
            return list(iter_blob_frames(block, site=self.resource_id))
        path, offset, length = block
        try:
            with open(path, "rb") as f:
                f.seek(offset)
                return list(iter_stream_frames(f, length, site=self.resource_id, path=path))
        except OSError as e:
            raise FetchFailedError(self.resource_id, partition, f"{path}: {e}") from e

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
                    for payload in self._payloads(block, partition):
                        try:
                            n, cols = decode_columns(payload, self._schema)
                        except (struct.error, zlib.error, ValueError) as e:
                            if isinstance(e, BlockCorruptionError):
                                raise
                            raise FetchFailedError(self.resource_id, partition,
                                                   f"undecodable frame: {e}") from e
                        if n:
                            parts.append((n, cols))
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
        :class:`FetchFailedError` (the reference skips it)."""
        blocks: List[BlockObject] = []
        for m in range(num_maps):
            data, index = self.map_output_paths(shuffle_id, m)
            try:
                with open(index, "rb") as f:
                    raw = f.read()
            except OSError as e:
                raise FetchFailedError(f"shuffle_{shuffle_id}", reduce_id, f"map {m}: {e}") from e
            offsets = struct.unpack(f"<{len(raw) // 8}Q", raw)
            if reduce_id + 1 >= len(offsets):
                raise FetchFailedError(f"shuffle_{shuffle_id}", reduce_id,
                                       f"map {m}: index of {len(offsets)} offsets")
            lo, hi = offsets[reduce_id], offsets[reduce_id + 1]
            if hi > lo:
                blocks.append((data, lo, hi - lo))
        return blocks

    def data_bytes(self, shuffle_id: int, num_maps: int) -> int:
        """Bytes of the committed ``.data`` files of a shuffle."""
        return sum(os.path.getsize(self.map_output_paths(shuffle_id, m)[0]) for m in range(num_maps))

    def cleanup(self) -> None:
        """Remove the root and every file under it."""
        if os.path.isdir(self.root):
            shutil.rmtree(self.root)
