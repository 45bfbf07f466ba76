"""ExecNode: the operator interface (≙ ``blaze_tpu/ops/base.py``).

``execute(partition, ctx)`` returns a python iterator of RecordBatches;
operators issue torch ops on the device their input batches live on.
"""

from __future__ import annotations

from typing import Iterator, List, Sequence

import torch

from ..batch import RecordBatch
from ..runtime.context import TaskContext, tick
from ..runtime.metrics import MetricsSet
from ..schema import Schema

BatchStream = Iterator[RecordBatch]


class ExecNode:
    """Base physical operator."""

    def __init__(self, children: Sequence["ExecNode"]):
        self.children: List[ExecNode] = list(children)
        self.metrics = MetricsSet()

    @property
    def schema(self) -> Schema:
        raise NotImplementedError

    def execute(self, partition: int, ctx: TaskContext) -> BatchStream:
        raise NotImplementedError

    # ------------------------------------------------- tracing contract
    #
    # The task optimizer (ops/fusion.py) composes consecutive unary
    # operators that expose a per-batch transform into one
    # FusedStageExec, whose intermediates never reach the host: a chain
    # reads its live row count back once per batch, not once per
    # operator.

    def trace_fn(self):
        """Per-batch transform ``(cols, num_rows) -> (cols, num_rows)``
        that never waits for the device (``num_rows`` may be a 0-d
        int64 tensor on the batch's device), or None when this operator
        cannot be composed (blocking, stateful across batches,
        multi-child, or evaluated on the host)."""
        return None

    def trace_key(self):
        """A structural key of :meth:`trace_fn` (non-None whenever it
        is): the operator kind and its expressions."""
        return None

    def trace_slots(self) -> tuple:
        """Literal values the transform expects appended after its
        columns.  The port lowers literals in place, so this is always
        empty; it is kept for the reference's contract."""
        return ()

    @property
    def trace_changes_count(self) -> bool:
        """True when the transform can change ``num_rows`` (a filter)."""
        return False

    @property
    def trace_requires_buffer(self) -> bool:
        """True when the transform is exact only over a whole partition
        in one batch (the window): a fused chain stops below it, over a
        partition buffer."""
        return False

    @property
    def has_kernel(self) -> bool:
        """False when the operator issues no device work of its own (a
        pure column select); a chain is fused only when it replaces at
        least two operators that do."""
        return True

    @property
    def preserves_ordering(self) -> bool:
        """True when this unary operator passes its child's row order
        through."""
        return False

    @property
    def device(self) -> torch.device:
        """The device this node's output lives on (its scans')."""
        return self.children[0].device

    def num_partitions(self) -> int:
        """Output partitioning degree (the first child's by default)."""
        if self.children:
            return self.children[0].num_partitions()
        return 1

    def _record_batch(self, b: RecordBatch) -> None:
        self.metrics.add("output_rows", b.num_rows)
        self.metrics.add("output_batches")
        tick()  # the task's heartbeat (runtime/context.py)
