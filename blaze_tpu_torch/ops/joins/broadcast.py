"""Broadcast hash join (≙ ``blaze_tpu/ops/joins/broadcast.py``
``BroadcastJoinExec``): the build side is the replicated output of a
broadcast exchange; its join map is built once and probed by every
probe partition."""

from __future__ import annotations

import threading
from typing import Optional, Sequence

from ...batch import concat_batches
from ...exprs.ir import Expr
from ...runtime.context import TaskContext
from ...schema import Schema
from ..base import BatchStream, ExecNode
from .core import Joiner, JoinMap, JoinType


class BroadcastJoinExec(ExecNode):
    def __init__(self, build: ExecNode, probe: ExecNode, build_keys: Sequence[Expr],
                 probe_keys: Sequence[Expr], join_type: JoinType, build_is_left: bool):
        super().__init__([build, probe])
        self._joiner = Joiner(probe.schema, build.schema, probe_keys, build_keys,
                              join_type, probe_is_left=not build_is_left)
        self._lock = threading.Lock()
        self._map: Optional[JoinMap] = None
        self._built = False

    @property
    def schema(self) -> Schema:
        return self._joiner.out_schema

    def num_partitions(self) -> int:
        return self.children[1].num_partitions()

    def _get_map(self, ctx: TaskContext) -> Optional[JoinMap]:
        with self._lock:
            if not self._built:
                with self.metrics.timer("build_hash_map_time"):
                    batches = list(self.children[0].execute(0, ctx.child_context(0, 1)))
                    self._map = self._joiner.build_map(concat_batches(batches)) if batches else None
                self._built = True
            return self._map

    def execute(self, partition: int, ctx: TaskContext) -> BatchStream:
        def stream():
            jmap = self._get_map(ctx)
            if jmap is None:
                return  # INNER: no build rows, no output
            for batch in self.children[1].execute(partition, ctx):
                if not ctx.is_task_running():
                    return
                with self.metrics.timer("probe_time"):
                    out = self._joiner.probe_batch(jmap, batch)
                if out is not None:
                    self._record_batch(out)
                    yield out

        return stream()
