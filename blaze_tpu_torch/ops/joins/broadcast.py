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
probe's."""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Optional, Sequence

from ...batch import concat_batches
from ...exprs.ir import Expr
from ...runtime.context import TaskContext
from ...schema import Schema
from ..base import BatchStream, ExecNode
from .core import Joiner, JoinerState, JoinMap, JoinType

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


class BroadcastJoinExec(ExecNode):
    def __init__(self, build: ExecNode, probe: ExecNode, build_keys: Sequence[Expr],
                 probe_keys: Sequence[Expr], join_type: JoinType, build_is_left: bool,
                 build_data_schema: Optional[Schema] = None,
                 cached_build_id: Optional[str] = None):
        super().__init__([build, probe])
        if build_data_schema is not None and build_data_schema != build.schema:
            raise NotImplementedError("a serialized join-map build side (map mode) is not ported")
        self.build_keys = list(build_keys)
        self.probe_keys = list(probe_keys)
        self.join_type = join_type
        self.build_is_left = build_is_left
        self.build_data_schema = build.schema
        self.cached_build_id = cached_build_id
        self._joiner = Joiner(probe.schema, build.schema, probe_keys, build_keys,
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
        with self.metrics.timer("build_hash_map_time"):
            batches = [b for b in self.children[0].execute(0, ctx.child_context(0, 1)) if b.num_rows]
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
