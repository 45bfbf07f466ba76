"""Object aggregation: user-defined aggregates over opaque host states
(≙ ``blaze_tpu/ops/object_agg.py``).

A :class:`Udaf` supplies init/update/merge/finish over python states;
:class:`ObjectAggExec` lowers group keys and arguments with ``lower`` on
the batch's device, brings them to the host, aggregates the states in a
host dict row by row (as the reference does), and emits OPAQUE state
columns, which cross exchanges on the host (the batch wire format's tag
3: pickle, gated by ``spark.blaze.udf.allowPickled``).
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Any, Callable, List, Sequence

from ..batch import RecordBatch, batch_from_pydict, column_to_pylist
from ..exprs.compile import infer_dtype, lower
from ..exprs.ir import Expr
from ..runtime.context import TaskContext
from ..schema import DataType, Field, Schema
from .agg import AggMode
from .base import BatchStream, ExecNode


@dataclass
class Udaf:
    """User-defined aggregate over opaque python states.

    - ``init()`` -> state
    - ``update(state, *arg_values)`` -> state (None args = SQL null)
    - ``merge(a, b)`` -> state.  ``a`` may be mutated and returned (the
      executor deep-copies seeds before merging); ``b`` is read-only and
      must not be captured into the result: incoming states alias the
      exchange's re-readable output, which a retried task reads again.
    - ``finish(state)`` -> the final value (of ``result_dtype``)

    States must pickle to cross exchanges, and so must the functions
    (module-level) to travel in a TaskDefinition.
    """

    name: str
    init: Callable[[], Any]
    update: Callable[..., Any]
    merge: Callable[[Any, Any], Any]
    finish: Callable[[Any], Any]
    args: List[Expr]
    result_dtype: DataType


class ObjectAggExec(ExecNode):
    """Group-by aggregation carrying opaque states on the host.

    PARTIAL: raw inputs -> (group keys, OPAQUE ``<name>#state``) batches.
    PARTIAL_MERGE: state batches -> merged state batches.
    FINAL: state batches -> (group keys, finished values).
    """

    def __init__(self, child: ExecNode, mode: AggMode, groupings: Sequence, udafs: Sequence[Udaf]):
        super().__init__([child])
        self.mode = mode
        self.groupings = list(groupings)
        self.udafs = list(udafs)
        in_schema = child.schema
        if mode == AggMode.PARTIAL:
            key_fields = [Field(g.name, infer_dtype(g.expr, in_schema)) for g in self.groupings]
        else:
            key_fields = [in_schema.field(g.name) for g in self.groupings]
        if mode == AggMode.FINAL:
            out_fields = key_fields + [Field(u.name, u.result_dtype) for u in self.udafs]
        else:
            out_fields = key_fields + [Field(f"{u.name}#state", DataType.opaque()) for u in self.udafs]
        self._schema = Schema(out_fields)

    @property
    def schema(self) -> Schema:
        return self._schema

    def execute(self, partition: int, ctx: TaskContext) -> BatchStream:
        child = self.children[0]
        in_schema = child.schema
        merging = self.mode != AggMode.PARTIAL

        def eval_columns(batch: RecordBatch, exprs: List[Expr]) -> List[List]:
            env = {f.name: c for f, c in zip(in_schema.fields, batch.columns)}
            return [column_to_pylist(lower(e, in_schema, env, batch.capacity), batch.num_rows)
                    for e in exprs]

        def stream():
            groups = {}  # key tuple -> [state, ...]
            for batch in child.execute(partition, ctx):
                if not ctx.is_task_running():
                    return
                with self.metrics.timer("elapsed_compute"):
                    key_vals = eval_columns(batch, [g.expr for g in self.groupings])
                    if merging:
                        state_cols = [
                            column_to_pylist(batch.columns[in_schema.index(f"{u.name}#state")],
                                             batch.num_rows)
                            for u in self.udafs
                        ]
                        for i in range(batch.num_rows):
                            key = tuple(kv[i] for kv in key_vals)
                            accs = groups.get(key)
                            if accs is None:
                                # a copy: merge() mutates its left state,
                                # and these objects are the exchange's
                                # re-readable output
                                groups[key] = [copy.deepcopy(sc[i]) for sc in state_cols]
                            else:
                                for ui, u in enumerate(self.udafs):
                                    accs[ui] = u.merge(accs[ui], state_cols[ui][i])
                    else:
                        arg_cols = [eval_columns(batch, u.args) for u in self.udafs]
                        for i in range(batch.num_rows):
                            key = tuple(kv[i] for kv in key_vals)
                            accs = groups.get(key)
                            if accs is None:
                                accs = groups[key] = [u.init() for u in self.udafs]
                            for ui, u in enumerate(self.udafs):
                                accs[ui] = u.update(accs[ui], *[c[i] for c in arg_cols[ui]])
            if not groups and self.groupings:
                return
            if not groups:  # a global aggregate over no rows: one empty state
                groups[()] = [u.init() for u in self.udafs]
            data = {f.name: [] for f in self._schema.fields}
            for key, accs in groups.items():
                for g, kv in zip(self.groupings, key):
                    data[g.name].append(kv)
                for u, acc in zip(self.udafs, accs):
                    if self.mode == AggMode.FINAL:
                        data[u.name].append(u.finish(acc))
                    else:
                        data[f"{u.name}#state"].append(acc)
            # the plan's device: a batch of states alone lives on the host
            out = batch_from_pydict(data, self._schema, device=self.device)
            self._record_batch(out)
            yield out

        return stream()
