"""Plan-contract messages -> ExecNode and Expr trees, and the task
runner (≙ ``blaze_tpu/serde/from_proto.py``).

The same subset as ``to_proto``; any other node, expression,
partitioning or join type raises ``NotImplementedError`` naming it.
Decimal literals arrive unscaled and are decoded as ``Lit(...,
unscaled=True)``.
"""

from __future__ import annotations

import pickle

import numpy as np

from ..exprs.ir import (
    Alias, BinOp, Case, Cast, Col, Expr, GetIndexedField, GetMapValue, GetStructField, InList, IsNotNull, IsNull,
    Like, Lit, NamedStruct, Not, ScalarFunc,
)
from ..schema import DataType, Field, Schema, TypeKind
from . import wire as pb


def dtype_from_proto(t: pb.DataTypeProto) -> DataType:
    kind = TypeKind(t.kind)
    if kind == TypeKind.DECIMAL:
        return DataType.decimal(t.precision, t.scale)
    if kind in (TypeKind.STRING, TypeKind.BINARY):
        return DataType(kind, string_width=t.string_width or 64)
    if kind == TypeKind.ARRAY:
        return DataType.array(dtype_from_proto(t.elem), t.max_elems)
    if kind == TypeKind.MAP:
        return DataType.map(dtype_from_proto(t.key), dtype_from_proto(t.value), t.max_elems)
    if kind == TypeKind.STRUCT:
        return DataType.struct([Field(f.name, dtype_from_proto(f.dtype), f.nullable) for f in t.struct_fields])
    return DataType(kind)


def schema_from_proto(s: pb.SchemaProto) -> Schema:
    return Schema([Field(f.name, dtype_from_proto(f.dtype), f.nullable) for f in s.fields])


def _lit_from_proto(lit: pb.LiteralValue) -> Lit:
    t = dtype_from_proto(lit.dtype)
    if lit.is_null:
        return Lit(None, t)
    kind = lit.which_oneof("value")
    if kind == "bool_value":
        return Lit(lit.bool_value, t)
    if kind == "float_value":
        return Lit(lit.float_value, t)
    if kind == "bytes_value":
        v = lit.bytes_value
        return Lit(v.decode("utf-8") if t.kind == TypeKind.STRING else v, t)
    return Lit(lit.int_value, t, unscaled=t.is_decimal)


def expr_from_proto(n: pb.ExprNode) -> Expr:
    kind = n.which_oneof("expr")
    if kind == "column":
        return Col(n.column)
    if kind == "literal":
        return _lit_from_proto(n.literal)
    if kind == "alias":
        return Alias(expr_from_proto(n.alias.child), n.alias.name)
    if kind == "binary":
        return BinOp(n.binary.op, expr_from_proto(n.binary.left), expr_from_proto(n.binary.right))
    if kind == "not":
        return Not(expr_from_proto(getattr(n, "not")))
    if kind == "is_null":
        return IsNull(expr_from_proto(n.is_null))
    if kind == "is_not_null":
        return IsNotNull(expr_from_proto(n.is_not_null))
    if kind == "cast":
        return Cast(expr_from_proto(n.cast.child), dtype_from_proto(n.cast.to))
    if kind == "scalar_func":
        return ScalarFunc(n.scalar_func.name, [expr_from_proto(a) for a in n.scalar_func.args])
    if kind == "case":
        c = n.case
        return Case([(expr_from_proto(b.condition), expr_from_proto(b.value)) for b in c.branches],
                    expr_from_proto(c.else_expr) if c.has_else else None)
    if kind == "in_list":
        i = n.in_list
        return InList(expr_from_proto(i.child), [expr_from_proto(v) for v in i.values], i.negated)
    if kind == "like":
        return Like(expr_from_proto(n.like.child), n.like.pattern, n.like.negated)
    if kind == "get_indexed_field":
        return GetIndexedField(expr_from_proto(n.get_indexed_field.child), n.get_indexed_field.index)
    if kind == "get_map_value":
        return GetMapValue(expr_from_proto(n.get_map_value.child), _lit_from_proto(n.get_map_value.key).value)
    if kind == "get_struct_field":
        return GetStructField(expr_from_proto(n.get_struct_field.child), n.get_struct_field.name)
    if kind == "named_struct":
        return NamedStruct(list(n.named_struct.names), [expr_from_proto(e) for e in n.named_struct.exprs])
    raise NotImplementedError(f"from_proto expr {kind}")


def _partitioning_from_proto(p: pb.PartitioningProto):
    from ..ops.sort import SortField
    from ..parallel.shuffle import HashPartitioning, RangePartitioning, RoundRobinPartitioning, SinglePartitioning

    if p.kind == pb.PartitioningProto.HASH:
        return HashPartitioning([expr_from_proto(e) for e in p.exprs], p.num_partitions)
    if p.kind == pb.PartitioningProto.ROUND_ROBIN:
        return RoundRobinPartitioning(p.num_partitions)
    if p.kind == pb.PartitioningProto.RANGE:
        # uint64 words back to int64, bit for bit
        flat = np.array(list(p.boundary_words), np.uint64).view(np.int64)
        nw = int(p.num_boundary_words)
        per = len(flat) // nw if nw else 0
        fields = [SortField(expr_from_proto(f.expr), f.ascending, f.nulls_first) for f in p.sort_fields]
        return RangePartitioning(fields, p.num_partitions,
                                 boundaries=tuple(flat[i * per:(i + 1) * per] for i in range(nw)))
    if p.kind == pb.PartitioningProto.SINGLE:
        return SinglePartitioning(p.num_partitions)
    raise NotImplementedError(f"from_proto partitioning {pb.PartitioningProto.Kind(p.kind).name}")


def _join_type(v: int):
    """The join type of the same name."""
    from ..ops.joins import JoinType

    return JoinType[pb.JoinTypeProto(v).name]


def _window_function(f: pb.WindowFunctionProto):
    from ..ops import WindowFunction

    def bounds(has: bool, a: int, b: int):
        return (None if a < 0 else a, None if b < 0 else b) if has else None

    return WindowFunction(
        f.kind, f.name, expr_from_proto(f.expr) if f.has_expr else None, f.whole_partition,
        rows_frame=bounds(f.has_rows_frame, f.frame_preceding, f.frame_following),
        # lead/lag: 0 is a legal offset (the current row); the other
        # kinds never encode 0 (default 1)
        offset=f.offset if f.kind in ("lead", "lag") else (f.offset or 1),
        ignore_nulls=f.ignore_nulls,
        range_frame=bounds(f.has_range_frame, f.range_preceding, f.range_following))


def plan_from_proto(n: pb.PhysicalPlanNode):
    """A plan tree from its message.  A memory scan pops its partitions
    from ``RESOURCES``; every scan stages on the package's default
    device."""
    from ..ops import (
        AggExec, AggFunction, AggMode, CoalesceBatchesExec, DebugExec, EmptyPartitionsExec, ExpandExec, FilterExec,
        GroupingExpr, LimitExec, MemoryScanExec, OrcScanExec, ParquetScanExec, ProjectExec, RenameColumnsExec,
        SortExec, SortField, UnionExec, WindowExec,
    )
    from ..ops.joins import BroadcastJoinBuildHashMapExec, BroadcastJoinExec, HashJoinExec
    from ..parallel.broadcast import IpcWriterExec
    from ..parallel.shuffle import IpcReaderExec, ShuffleWriterExec
    from ..runtime.context import RESOURCES

    kind = n.which_oneof("node")
    if kind == "memory_scan":
        m = n.memory_scan
        return MemoryScanExec(RESOURCES.get(m.resource_id), schema_from_proto(m.schema))
    if kind in ("parquet_scan", "orc_scan"):
        s = getattr(n, kind)
        pred = None
        for e in s.predicate:
            sub = expr_from_proto(e)
            pred = sub if pred is None else (pred & sub)
        groups = [g.split(";") if g else [] for g in s.file_groups]
        cls = ParquetScanExec if kind == "parquet_scan" else OrcScanExec
        return cls(groups, schema_from_proto(s.schema), pred)
    if kind == "empty_partitions":
        e = n.empty_partitions
        return EmptyPartitionsExec(schema_from_proto(e.schema), e.num_partitions)
    if kind == "debug":
        return DebugExec(plan_from_proto(n.debug.input), n.debug.tag, n.debug.verbose)
    if kind == "coalesce_batches":
        c = n.coalesce_batches
        return CoalesceBatchesExec(plan_from_proto(c.input), c.target_rows)
    if kind == "project":
        p = n.project
        return ProjectExec(plan_from_proto(p.input), [expr_from_proto(e) for e in p.exprs], list(p.names))
    if kind == "filter":
        f = n.filter
        project = None
        if len(f.project_exprs):
            project = ([expr_from_proto(e) for e in f.project_exprs], list(f.project_names))
        return FilterExec(plan_from_proto(f.input), expr_from_proto(f.predicate), project)
    if kind == "agg":
        a = n.agg
        if a.mode not in (m.value for m in AggMode):
            raise NotImplementedError(f"from_proto agg mode {pb.AggMode(a.mode).name}")
        return AggExec(
            plan_from_proto(a.input), AggMode(a.mode),
            [GroupingExpr(expr_from_proto(g.expr), g.name) for g in a.groupings],
            [AggFunction(f.fn, expr_from_proto(f.expr) if f.has_expr else None, f.name) for f in a.aggs],
            supports_partial_skipping=a.supports_partial_skipping,
        )
    if kind == "sort":
        s = n.sort
        return SortExec(plan_from_proto(s.input),
                        [SortField(expr_from_proto(f.expr), f.ascending, f.nulls_first) for f in s.fields],
                        fetch=s.fetch if s.has_fetch else None)
    if kind == "limit":
        return LimitExec(plan_from_proto(n.limit.input), n.limit.limit)
    if kind == "union":
        return UnionExec([plan_from_proto(c) for c in n.union.inputs])
    if kind == "rename_columns":
        return RenameColumnsExec(plan_from_proto(n.rename_columns.input), list(n.rename_columns.names))
    if kind == "expand":
        e = n.expand
        return ExpandExec(plan_from_proto(e.input), [[expr_from_proto(x) for x in p.exprs] for p in e.projections],
                          list(e.names))
    if kind == "generate":
        from ..ops import GenerateExec, NativeGenerator

        g = n.generate
        if g.native_kind:
            gen = NativeGenerator(g.native_kind, expr_from_proto(g.native_expr))
        else:
            from .. import conf

            if not bool(conf.ALLOW_PICKLED_UDFS.get()):
                raise PermissionError("pickled generator payload rejected: spark.blaze.udf.allowPickled is false")
            gen = pickle.loads(g.generator_payload)
        return GenerateExec(plan_from_proto(g.input), gen, [expr_from_proto(e) for e in g.input_exprs],
                            [Field(f.name, dtype_from_proto(f.dtype), f.nullable) for f in g.gen_fields],
                            g.outer, g.keep_input)
    if kind == "window":
        w = n.window
        return WindowExec(plan_from_proto(w.input), [_window_function(f) for f in w.functions],
                          [expr_from_proto(e) for e in w.partition_by],
                          [SortField(expr_from_proto(f.expr), f.ascending, f.nulls_first) for f in w.order_by])
    if kind == "shuffle_writer":
        w = n.shuffle_writer
        return ShuffleWriterExec(plan_from_proto(w.input), _partitioning_from_proto(w.partitioning),
                                 w.output_data_file, w.output_index_file)
    if kind == "ipc_reader":
        r = n.ipc_reader
        return IpcReaderExec(schema_from_proto(r.schema), r.ipc_provider_resource_id, r.num_partitions)
    if kind == "ipc_writer":
        return IpcWriterExec(plan_from_proto(n.ipc_writer.input), n.ipc_writer.ipc_consumer_resource_id)
    if kind in ("broadcast_join", "hash_join"):
        j = getattr(n, kind)
        args = (plan_from_proto(j.build), plan_from_proto(j.probe),
                [expr_from_proto(e) for e in j.build_keys], [expr_from_proto(e) for e in j.probe_keys],
                _join_type(j.join_type), j.build_is_left)
        if kind == "hash_join":
            return HashJoinExec(*args)
        return BroadcastJoinExec(
            *args,
            build_data_schema=schema_from_proto(j.build_data_schema) if len(j.build_data_schema.fields) else None,
            cached_build_id=j.cached_build_id or None)
    if kind == "broadcast_join_build_hash_map":
        b = n.broadcast_join_build_hash_map
        return BroadcastJoinBuildHashMapExec(plan_from_proto(b.input), [expr_from_proto(e) for e in b.keys])
    if kind == "object_agg":
        from .. import conf
        from ..ops.object_agg import ObjectAggExec

        o = n.object_agg
        if not bool(conf.ALLOW_PICKLED_UDFS.get()):
            raise PermissionError("pickled UDAF payload rejected: set spark.blaze.udf.allowPickled")
        return ObjectAggExec(plan_from_proto(o.input), AggMode(o.mode),
                             [GroupingExpr(expr_from_proto(g.expr), g.name) for g in o.groupings],
                             pickle.loads(o.udafs_payload))
    if kind == "bloom_filter_agg":
        from ..ops.bloom_agg import BloomFilterAggExec

        b = n.bloom_filter_agg
        return BloomFilterAggExec(plan_from_proto(b.input), expr_from_proto(b.expr) if b.has_expr else None,
                                  b.name, AggMode(b.mode), b.expected_items, b.num_bits or None)
    raise NotImplementedError(f"from_proto node {kind}")


def run_task(task_def_bytes: bytes, task_attempt_id: int = 0, resources=None, on_plan=None, cancel_event=None,
             on_beat=None):
    """Decode a TaskDefinition, optimize its plan
    (``ops.fusion.optimize_plan``: fusion tiers 1-5 under
    ``spark.blaze.fusion.enabled``, and column pruning) and run it for
    its partition; returns the task's batch stream.  The task reads its
    reduce blocks and broadcast blobs from ``resources`` (default the
    process-wide ``RESOURCES``, from which decoding takes the scans).
    ``on_plan``, when given, is called with the optimized plan first
    (its operators' metrics fill as the stream runs).

    The ``task.compute`` fault site is probed before the plan is built.
    ``cancel_event`` cancels the task cooperatively (a speculative
    loser, a wedged attempt); ``on_beat`` is the task's heartbeat, the
    wedge detector's clock, called at each operator's output batch
    while the stream runs (``runtime/context.py`` ``beating``)."""
    from ..ops.fusion import optimize_plan
    from ..runtime import faults
    from ..runtime.context import TaskContext, beating

    td = pb.TaskDefinition.decode(task_def_bytes)
    faults.hit("task.compute", attempt=task_attempt_id, detail=td.task_id, cancel=cancel_event)
    plan = optimize_plan(plan_from_proto(td.plan))
    if on_plan is not None:
        on_plan(plan)
    ctx = TaskContext(td.partition, max(plan.num_partitions(), td.partition + 1), resources, cancel_event,
                      stage_id=td.stage_id, task_attempt_id=task_attempt_id)
    stream = plan.execute(td.partition, ctx)
    if on_beat is None:
        return stream
    return beating(stream, on_beat)
