"""Generate: table-generating functions (≙ ``blaze_tpu/ops/generate.py``).

``explode`` and ``pos_explode`` over an ARRAY or a MAP run on the
device: a flat emit mask over every row's ``M`` element slots, its
prefix sum giving each emitted element its output row, and one scatter
of the source slots to those rows; every output column is then a
gather.  ``outer`` keeps a null or empty input as one row of nulls (its
``pos`` null too); ``keep_input`` puts the input columns before the
generated ones.  ``execute`` reads the emitted count back once per
batch and cuts the output to its capacity bucket; the traced form
(:meth:`GenerateExec.trace_fn`) never waits for the device and leaves
``cap * M`` rows, which ``FusedStageExec`` re-buckets, as the
reference's does.

Other generators (``json_tuple_generator``, user generators) run per row
on the host: the input expressions are projected on the device, the
rows come to the host, and the generated rows go back in one batch.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..batch import Column, RecordBatch, _flatten_leading, batch_from_pydict, batch_to_pydict, bucket_capacity
from ..exprs.compile import infer_dtype, lower
from ..exprs.ir import Expr
from ..runtime.context import TaskContext
from ..schema import DataType, Field, Schema, TypeKind
from .base import BatchStream, ExecNode

#: a host generator: a row's input values -> its output tuples
Generator = Callable[[Tuple], List[Tuple]]


@dataclass
class NativeGenerator:
    """``explode`` or ``pos_explode`` of an expression of ARRAY or MAP
    type, on the device."""

    kind: str
    expr: Expr

    def gen_fields(self, schema: Schema) -> List[Field]:
        """Spark's output fields: ``col`` (ARRAY) or ``key``, ``value``
        (MAP), after ``pos`` for pos_explode."""
        t = infer_dtype(self.expr, schema)
        if t.kind == TypeKind.ARRAY:
            fields = [Field("col", t.elem)]
        elif t.kind == TypeKind.MAP:
            fields = [Field("key", t.key), Field("value", t.value)]
        else:
            raise TypeError(f"{self.kind} over {t!r}")
        if self.kind == "pos_explode":
            fields = [Field("pos", DataType.int32())] + fields
        return fields


class JsonTupleGenerator:
    """``json_tuple(s, f1, ...)``: the top-level values of a JSON object
    (nested values as compact JSON text); nulls for a null, malformed or
    non-object document.  A class, so a plan carrying it pickles."""

    def __init__(self, fields: Sequence[str]):
        self.fields = list(fields)

    def __call__(self, row: Tuple) -> List[Tuple]:
        (s,) = row
        nulls = [tuple(None for _ in self.fields)]
        if s is None:
            return nulls
        try:
            obj = json.loads(s)
        except (ValueError, TypeError):
            return nulls
        if not isinstance(obj, dict):
            return nulls
        vals = []
        for f in self.fields:
            v = obj.get(f)
            vals.append(None if v is None else v if isinstance(v, str) else json.dumps(v, separators=(",", ":")))
        return [tuple(vals)]


def json_tuple_generator(fields: Sequence[str]) -> Generator:
    return JsonTupleGenerator(fields)


def explode_body(child_schema: Schema, spec: NativeGenerator, outer: bool, keep_input: bool):
    """The explode transform ``(cols, num_rows, out_cap, gc) -> (cols,
    total)``: ``total`` a 0-d tensor; ``out_cap`` None is ``cap * M``
    (no host read), else the caller's bucket for the known total;
    ``gc``: the generator expression already lowered over ``cols``."""
    with_pos = spec.kind == "pos_explode"

    def fn(cols: Sequence[Column], num_rows, out_cap: Optional[int] = None, gc: Optional[Column] = None):
        cap = cols[0].capacity
        dev = cols[0].device
        if gc is None:
            gc = lower(spec.expr, child_schema, {f.name: c for f, c in zip(child_schema.fields, cols)}, cap)
        m = gc.dtype.max_elems
        live = torch.arange(cap, device=dev) < num_rows
        within = torch.arange(m, device=dev)[None, :] < gc.lengths[:, None]
        emit = within & (gc.validity & live)[:, None]
        if outer:
            emit[:, 0] |= live & (~gc.validity | (gc.lengths == 0))
        flat = emit.reshape(-1)
        total = flat.sum()
        if out_cap is None:
            out_cap = cap * m
        # each emitted slot's output row; the others aim at a dead row
        pos = torch.cumsum(flat, 0) - 1
        tgt = torch.where(flat, pos, out_cap)
        src = torch.zeros(out_cap + 1, dtype=torch.int64, device=dev).index_copy_(
            0, tgt, torch.arange(cap * m, device=dev))[:out_cap]
        out_live = torch.arange(out_cap, device=dev) < total
        elem_live = out_live & within.reshape(-1)[src]
        out: List[Column] = []
        if keep_input:
            out += [c.take(src // m).mask_rows(out_live) for c in cols]
        if with_pos:
            out.append(Column(DataType.int32(), torch.where(elem_live, src % m, 0).to(torch.int32), elem_live))
        out += [_flatten_leading(k).take(src).mask_rows(elem_live) for k in gc.children]
        return out, total

    return fn


class GenerateExec(ExecNode):
    def __init__(
        self,
        child: ExecNode,
        generator,
        input_exprs: Sequence[Expr],
        gen_fields: Optional[Sequence[Field]] = None,
        outer: bool = False,
        keep_input: bool = True,
    ):
        super().__init__([child])
        self.generator = generator
        self.input_exprs = list(input_exprs)
        if gen_fields is None:
            gen_fields = generator.gen_fields(child.schema)
        self.gen_fields = list(gen_fields)
        self.outer = outer
        self.keep_input = keep_input
        self._schema = Schema((list(child.schema.fields) if keep_input else []) + self.gen_fields)
        self._native = isinstance(generator, NativeGenerator)
        if self._native:
            self._body = explode_body(child.schema, generator, outer, keep_input)
        else:
            from .project import ProjectExec

            self._input_proj = ProjectExec(child, self.input_exprs,
                                           [f"__gen_in_{i}" for i in range(len(self.input_exprs))])

    @property
    def schema(self) -> Schema:
        return self._schema

    # ---------------------------------------------- tracing contract

    def trace_fn(self):
        """The native explode, as a transform that never waits for the
        device (``cap * M`` output rows); None for a host generator."""
        if not self._native:
            return None
        body = self._body
        return lambda cols, num_rows: body(cols, num_rows)

    def trace_key(self):
        if not self._native:
            return None
        return ("generate", self.generator.kind, repr(self.generator.expr), self.outer, self.keep_input)

    @property
    def trace_changes_count(self) -> bool:
        return True  # a row becomes its element count of rows

    # ----------------------------------------------------- execute

    def execute(self, partition: int, ctx: TaskContext) -> BatchStream:
        child_stream = self.children[0].execute(partition, ctx)
        run = self._native_batch if self._native else self._host_batch

        def stream():
            for batch in child_stream:
                if not ctx.is_task_running():
                    return
                with self.metrics.timer("elapsed_compute"):
                    out = run(batch)
                if out is None:
                    continue
                self._record_batch(out)
                yield out

        return stream()

    def _native_batch(self, batch: RecordBatch) -> Optional[RecordBatch]:
        """One read of the device a batch: the emitted count, which sets
        the output's capacity bucket."""
        cap = batch.capacity
        gc = lower(self.generator.expr, batch.schema, {f.name: c for f, c in zip(batch.schema.fields, batch.columns)},
                   cap)
        live = torch.arange(cap, device=batch.device) < batch.num_rows
        counts = torch.where(gc.validity & live, gc.lengths, 0)
        if self.outer:
            counts = torch.where(live, counts.clamp(min=1), 0)
        total = int(counts.sum())
        if total == 0:
            return None
        cols, _ = self._body(batch.columns, batch.num_rows, bucket_capacity(total), gc)
        return RecordBatch(self._schema, cols, total)

    def _host_batch(self, batch: RecordBatch) -> Optional[RecordBatch]:
        """The generator per row on the host (≙ the reference's UDTF
        round trip)."""
        in_rows = batch_to_pydict(self._input_proj.project_batch(batch))
        keys = list(in_rows)
        child = self.children[0]
        base = batch_to_pydict(batch) if self.keep_input else {}
        out_rows: Dict[str, List] = {f.name: [] for f in self._schema.fields}
        for i in range(batch.num_rows):
            produced = self.generator(tuple(in_rows[k][i] for k in keys))
            if not produced and self.outer:
                produced = [tuple(None for _ in self.gen_fields)]
            for tup in produced:
                if self.keep_input:
                    for f in child.schema.fields:
                        out_rows[f.name].append(base[f.name][i])
                for f, v in zip(self.gen_fields, tup):
                    out_rows[f.name].append(v)
        n = len(next(iter(out_rows.values()))) if out_rows else 0
        if n == 0:
            return None
        return batch_from_pydict(out_rows, self._schema, device=batch.device)
