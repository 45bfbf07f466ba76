"""Broadcast hash join (≙ ``blaze_tpu/ops/joins/broadcast.py``
``BroadcastJoinExec``): the build side is the replicated output of a
broadcast exchange; its join map is built once and probed by every
probe partition.

With a ``cached_build_id`` (the scheduler sets one per broadcast) the
map is also kept in a small process-wide cache, so the tasks of a
stage, each decoded afresh from its TaskDefinition, build it once
(≙ the reference's per-executor cached build).

A join that outputs build rows a probe row did or did not match (FULL,
RIGHT with the probe on the left, LEFT with the probe on the right,
RIGHT_SEMI, RIGHT_ANTI) needs every probe partition's matches at once,
which no single partition's task sees: over more than one probe
partition it raises at construction (the reference runs it and emits
the last partition's view alone, ROADMAP queue C, reference defect 8).
Over one probe partition it runs, and the build side's rows follow the
probe's.

Map mode (≙ the reference's ``BroadcastJoinBuildHashMapExec``, Spark's
``BroadcastJoinBuildHashMapNode``): the broadcast carries the built
join map, serialized (``JoinMap.serialize``, the reference's bytes),
as a binary column; the join detects it from its build side's schema
and rebuilds the map by copying buffers, with no hash and no sort.
The map cache then holds the deserialized map, keyed by the build
id and the data schema."""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import List, Optional, Sequence

import numpy as np
import torch

from ... import conf
from ...batch import Column, RecordBatch, batch_from_pydict, concat_batches
from ...exprs.ir import Expr
from ...runtime.context import TaskCancelled, TaskContext
from ...schema import DataType, Field, Schema
from ..base import BatchStream, ExecNode
from .core import Joiner, JoinerState, JoinMap, JoinType, build_join_map

#: the one column of a serialized join map
MAP_COL = "join_map#bytes"


def is_map_schema(schema: Schema) -> bool:
    """Whether ``schema`` is a serialized join map's."""
    return len(schema.fields) == 1 and schema.fields[0].name == MAP_COL

_MAP_CACHE: "OrderedDict[str, Optional[JoinMap]]" = OrderedDict()
_MAP_CACHE_LOCK = threading.Lock()
_MAP_CACHE_MAX = 8


def _cache_get(key: str):
    """(hit, map); a cached build side with no rows is a hit of None."""
    with _MAP_CACHE_LOCK:
        if key not in _MAP_CACHE:
            return False, None
        _MAP_CACHE.move_to_end(key)
        return True, _MAP_CACHE[key]


def _cache_put(key: str, m: Optional[JoinMap]) -> None:
    with _MAP_CACHE_LOCK:
        _MAP_CACHE[key] = m
        _MAP_CACHE.move_to_end(key)
        while len(_MAP_CACHE) > _MAP_CACHE_MAX:
            _MAP_CACHE.popitem(last=False)


def clear_join_map_cache(prefix: str = "") -> None:
    """Drop the cached maps whose build id starts with ``prefix``
    (all of them by default), freeing their device memory."""
    with _MAP_CACHE_LOCK:
        for key in [k for k in _MAP_CACHE if k.startswith(prefix)]:
            del _MAP_CACHE[key]


def _drain(child: ExecNode, ctx: TaskContext) -> Optional[RecordBatch]:
    """Every partition of ``child`` as one batch (None without rows).
    A cancelled drain raises: a map of part of the input would be
    cached and broadcast as if whole."""
    n = child.num_partitions()
    batches = []
    for p in range(n):
        for b in child.execute(p, ctx.child_context(p, n)):
            if not ctx.is_task_running():
                raise TaskCancelled("broadcast build drain cancelled")
            if b.num_rows:
                batches.append(b)
    return concat_batches(batches) if batches else None


class BroadcastJoinBuildHashMapExec(ExecNode):
    """Drains its child (a broadcast's build side) once, builds the join
    map over ``keys`` and emits it serialized: the bytes cut into
    ``spark.blaze.tpu.minBatchCapacity`` rows of a binary column, each
    ``max(8, ceil(len / rows))`` bytes wide, so what the broadcast
    carries is the map, not the rows (≙ the reference's
    ``ops/joins/broadcast.py``).  Its schema is a nominal
    ``binary(8)``: the batch and the wire carry the true width."""

    def __init__(self, child: ExecNode, keys: Sequence[Expr]):
        super().__init__([child])
        self.keys = list(keys)
        self._payload: Optional[bytes] = None
        self._lock = threading.Lock()

    @property
    def data_schema(self) -> Schema:
        return self.children[0].schema

    @property
    def schema(self) -> Schema:
        return Schema([Field(MAP_COL, DataType.binary(8))])

    def num_partitions(self) -> int:
        return 1

    def payload(self, ctx: TaskContext) -> bytes:
        """The serialized map, built on the first call (under the lock:
        concurrent first callers drain the child once)."""
        with self._lock:
            if self._payload is None:
                data = _drain(self.children[0], ctx)
                with self.metrics.timer("build_hash_map_time"):
                    if data is None:
                        data = batch_from_pydict({f.name: [] for f in self.data_schema.fields}, self.data_schema)
                    self._payload = build_join_map(data, self.keys).serialize()
                self.metrics.add("payload_bytes", len(self._payload))
            return self._payload

    def execute(self, partition: int, ctx: TaskContext) -> BatchStream:
        def stream():
            from ... import resolve_device

            payload = self.payload(ctx)
            rows = int(conf.MIN_CAPACITY.get())
            w = max(8, -(-len(payload) // rows))
            data = np.zeros(rows * w, dtype=np.uint8)
            data[:len(payload)] = np.frombuffer(payload, dtype=np.uint8)
            lengths = np.clip(len(payload) - np.arange(rows) * w, 0, w).astype(np.int32)
            dev = resolve_device()
            col = Column(DataType.binary(w), torch.from_numpy(data.reshape(rows, w)).to(dev),
                         torch.ones(rows, dtype=torch.bool, device=dev), torch.from_numpy(lengths).to(dev))
            out = RecordBatch(self.schema, [col], rows)
            self._record_batch(out)
            yield out

        return stream()


def map_payload(batches) -> bytes:
    """The serialized map a map-mode build side's batches carry, in one
    device-to-host copy of each batch's column."""
    from ...io.batch_serde import host_columns

    parts: List[bytes] = []
    for b in batches:
        (data, _, lengths), = host_columns(b)[0]
        parts.append(data[np.arange(data.shape[1]) < lengths[:, None]].tobytes())
    if not parts:
        raise ValueError("a map-mode build side sent no join-map payload")
    return b"".join(parts)


class BroadcastJoinExec(ExecNode):
    def __init__(self, build: ExecNode, probe: ExecNode, build_keys: Sequence[Expr],
                 probe_keys: Sequence[Expr], join_type: JoinType, build_is_left: bool,
                 build_data_schema: Optional[Schema] = None,
                 cached_build_id: Optional[str] = None):
        super().__init__([build, probe])
        self.map_mode = is_map_schema(build.schema)
        if self.map_mode and build_data_schema is None:
            # the data schema of a BuildHashMap node in the build subtree
            node = build
            while node is not None and not isinstance(node, BroadcastJoinBuildHashMapExec):
                node = node.children[0] if node.children else None
            if node is None:
                raise ValueError("a map-mode build side needs build_data_schema")
            build_data_schema = node.data_schema
        if not self.map_mode and build_data_schema is not None and build_data_schema != build.schema:
            raise ValueError("build_data_schema differs from the build side's schema outside map mode")
        self.build_keys = list(build_keys)
        self.probe_keys = list(probe_keys)
        self.join_type = join_type
        self.build_is_left = build_is_left
        self.build_data_schema = build_data_schema or build.schema
        self.cached_build_id = cached_build_id
        self._joiner = Joiner(probe.schema, self.build_data_schema, probe_keys, build_keys,
                              join_type, probe_is_left=not build_is_left)
        if self._joiner.build_preserved and probe.num_partitions() > 1:
            raise NotImplementedError(
                f"a {join_type.name} broadcast join with the build on the "
                f"{'left' if build_is_left else 'right'} outputs build rows, which needs every "
                f"probe partition's matches: over {probe.num_partitions()} probe partitions "
                f"plan a shuffled hash join")
        self._lock = threading.Lock()
        self._map: Optional[JoinMap] = None
        self._built = False

    @property
    def schema(self) -> Schema:
        return self._joiner.out_schema

    def num_partitions(self) -> int:
        return self.children[1].num_partitions()

    def _build(self, ctx: TaskContext) -> Optional[JoinMap]:
        key = None
        if self.cached_build_id is not None:
            key = f"{self.cached_build_id}|{self.build_data_schema!r}"
            hit, m = _cache_get(key)
            if hit:
                self.metrics.add("hashmap_cache_hit")
                return m
        build = self.children[0].execute(0, ctx.child_context(0, 1))
        if self.map_mode:
            # the build side drains first: the timer holds the rebuild alone
            payload = map_payload(build)
            with self.metrics.timer("build_hash_map_time"):
                m = JoinMap.deserialize(payload, self.build_data_schema, self.build_keys)
        else:
            with self.metrics.timer("build_hash_map_time"):
                batches = [b for b in build if b.num_rows]
                m = self._joiner.build_map(concat_batches(batches)) if batches else None
        if key is not None:
            _cache_put(key, m)
        return m

    def _get_map(self, ctx: TaskContext) -> Optional[JoinMap]:
        with self._lock:
            if not self._built:
                self._map = self._build(ctx)
                self._built = True
            return self._map

    def execute(self, partition: int, ctx: TaskContext) -> BatchStream:
        def stream():
            jmap = self._get_map(ctx)
            if jmap is None and not self._joiner.output_without_build_rows:
                return  # no build rows, so no output
            state = JoinerState()
            for batch in self.children[1].execute(partition, ctx):
                if not ctx.is_task_running():
                    return
                with self.metrics.timer("probe_time"):
                    out = self._joiner.probe_batch(jmap, batch, state)
                if out is not None:
                    self._record_batch(out)
                    yield out
            # one probe partition (the constructor's rule): it saw every match
            tail = self._joiner.finish(jmap, state)
            if tail is not None:
                self._record_batch(tail)
                yield tail

        return stream()
