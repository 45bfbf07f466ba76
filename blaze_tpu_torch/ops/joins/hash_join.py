"""Shuffled hash join (≙ ``blaze_tpu/ops/joins/hash_join.py``): the
build side is THIS partition of an exchange hash-partitioned on the
join keys, like the probe side, so every join type is right here: a
build row's matches all come from this partition's probe rows, and
``Joiner.finish`` emits the build-preserved rows after them."""

from __future__ import annotations

from typing import Sequence

from ...batch import concat_batches
from ...exprs.ir import Expr
from ...runtime.context import TaskContext
from ...schema import Schema
from ..base import BatchStream, ExecNode
from .core import Joiner, JoinerState, JoinType


class HashJoinExec(ExecNode):
    def __init__(self, build: ExecNode, probe: ExecNode, build_keys: Sequence[Expr],
                 probe_keys: Sequence[Expr], join_type: JoinType, build_is_left: bool):
        super().__init__([build, probe])
        self.build_keys = list(build_keys)
        self.probe_keys = list(probe_keys)
        self.join_type = join_type
        self.build_is_left = build_is_left
        self._joiner = Joiner(probe.schema, build.schema, probe_keys, build_keys,
                              join_type, probe_is_left=not build_is_left)

    @property
    def schema(self) -> Schema:
        return self._joiner.out_schema

    def num_partitions(self) -> int:
        return self.children[1].num_partitions()

    def execute(self, partition: int, ctx: TaskContext) -> BatchStream:
        def stream():
            with self.metrics.timer("build_hash_map_time"):
                batches = [b for b in self.children[0].execute(partition, ctx) if b.num_rows]
                if not batches and not self._joiner.output_without_build_rows:
                    return  # no build rows, so no output
                jmap = self._joiner.build_map(concat_batches(batches)) if batches else None
            state = JoinerState()
            for batch in self.children[1].execute(partition, ctx):
                if not ctx.is_task_running():
                    return
                with self.metrics.timer("probe_time"):
                    out = self._joiner.probe_batch(jmap, batch, state)
                if out is not None:
                    self._record_batch(out)
                    yield out
            tail = self._joiner.finish(jmap, state)
            if tail is not None:
                self._record_batch(tail)
                yield tail

        return stream()
