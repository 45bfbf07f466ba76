"""ExecNode and Expr trees -> plan-contract messages (≙
``blaze_tpu/serde/to_proto.py``).

Covers the nodes and expressions the port has: memory, parquet and ORC
scans, empty partitions, project, filter, agg, sort, limit, union,
rename, expand, window, generate, debug, coalesce, shuffle writer, IPC
reader and writer, broadcast and shuffled hash joins, the broadcast
join's serialized map (``BroadcastJoinBuildHashMapNode``), object and
bloom-filter aggregates (the parquet sink has no node, as in the
reference); nested types; columns, literals, aliases, binary operators,
NOT, IS [NOT] NULL, casts, CASE, IN, LIKE, scalar functions and the
nested accessors.  Anything else raises ``NotImplementedError`` naming
it.
"""

from __future__ import annotations

import contextvars
import datetime
import itertools
import pickle

import numpy as np

from ..exprs.compile import infer_lit_dtype, unscaled_decimal
from ..exprs.ir import (
    Alias, BinOp, Case, Cast, Col, Expr, GetIndexedField, GetMapValue, GetStructField, InList, IsNotNull, IsNull,
    Like, Lit, NamedStruct, Not, ScalarFunc,
)
from ..schema import DataType, Schema, TypeKind
from . import wire as pb

# each serialization of a memory scan stages its partitions under a new id
_memscan_rids = itertools.count()

#: when set to a list, every resource id staged while serializing is
#: appended to it, so a caller can discard what a task never consumed
STAGED_RIDS: contextvars.ContextVar = contextvars.ContextVar("blaze_torch_staged_rids", default=None)


def dtype_to_proto(t: DataType) -> pb.DataTypeProto:
    out = pb.DataTypeProto(kind=t.kind.value, precision=t.precision, scale=t.scale,
                           string_width=t.string_width, max_elems=t.max_elems)
    if t.elem is not None:
        out.elem = dtype_to_proto(t.elem)
    if t.key is not None:
        out.key = dtype_to_proto(t.key)
    if t.value is not None:
        out.value = dtype_to_proto(t.value)
    if t.struct_fields is not None:
        out.struct_fields = [pb.FieldProto(name=f.name, dtype=dtype_to_proto(f.dtype), nullable=f.nullable)
                             for f in t.struct_fields]
    return out


def schema_to_proto(s: Schema) -> pb.SchemaProto:
    return pb.SchemaProto(fields=[pb.FieldProto(name=f.name, dtype=dtype_to_proto(f.dtype),
                                                nullable=f.nullable) for f in s.fields])


def _lit_to_proto(e: Lit) -> pb.LiteralValue:
    """Decimals travel unscaled, dates as days since the epoch."""
    t = infer_lit_dtype(e.value, e.dtype)
    out = pb.LiteralValue(dtype=dtype_to_proto(t))
    v = e.value
    if v is None:
        out.is_null = True
    elif t.kind == TypeKind.BOOL:
        out.bool_value = bool(v)
    elif t.is_string:
        out.bytes_value = v.encode("utf-8") if isinstance(v, str) else bytes(v)
    elif t.is_float:
        out.float_value = float(v)
    elif t.is_decimal:
        out.int_value = int(v) if e.unscaled else unscaled_decimal(v, t)
    elif t.kind == TypeKind.DATE32:
        if isinstance(v, str):
            v = datetime.date.fromisoformat(v)
        if isinstance(v, datetime.date):
            v = (v - datetime.date(1970, 1, 1)).days
        out.int_value = int(v)
    else:
        out.int_value = int(v)
    return out


def expr_to_proto(e: Expr) -> pb.ExprNode:
    if isinstance(e, Col):
        return pb.ExprNode(column=e.name)
    if isinstance(e, Lit):
        return pb.ExprNode(literal=_lit_to_proto(e))
    if isinstance(e, Alias):
        return pb.ExprNode(alias=pb.AliasExpr(child=expr_to_proto(e.child), name=e.name))
    if isinstance(e, BinOp):
        return pb.ExprNode(binary=pb.BinaryExpr(op=e.op, left=expr_to_proto(e.left),
                                                right=expr_to_proto(e.right)))
    if isinstance(e, Not):
        return pb.ExprNode(**{"not": expr_to_proto(e.child)})
    if isinstance(e, IsNull):
        return pb.ExprNode(is_null=expr_to_proto(e.child))
    if isinstance(e, IsNotNull):
        return pb.ExprNode(is_not_null=expr_to_proto(e.child))
    if isinstance(e, Cast):
        return pb.ExprNode(cast=pb.CastExpr(child=expr_to_proto(e.child), to=dtype_to_proto(e.to)))
    if isinstance(e, Case):
        case = pb.CaseExpr(branches=[pb.CaseBranch(condition=expr_to_proto(c), value=expr_to_proto(v))
                                     for c, v in e.branches])
        if e.else_ is not None:
            case.has_else = True
            case.else_expr = expr_to_proto(e.else_)
        return pb.ExprNode(case=case)
    if isinstance(e, InList):
        return pb.ExprNode(in_list=pb.InListExpr(child=expr_to_proto(e.child),
                                                 values=[expr_to_proto(v) for v in e.values],
                                                 negated=e.negated))
    if isinstance(e, Like):
        return pb.ExprNode(like=pb.LikeExpr(child=expr_to_proto(e.child), pattern=e.pattern,
                                            negated=e.negated))
    if isinstance(e, ScalarFunc):
        return pb.ExprNode(scalar_func=pb.ScalarFuncExpr(name=e.name, args=[expr_to_proto(a) for a in e.args]))
    if isinstance(e, GetIndexedField):
        return pb.ExprNode(get_indexed_field=pb.GetIndexedFieldExpr(child=expr_to_proto(e.child), index=e.index))
    if isinstance(e, GetMapValue):
        return pb.ExprNode(get_map_value=pb.GetMapValueExpr(child=expr_to_proto(e.child),
                                                            key=_lit_to_proto(Lit(e.key))))
    if isinstance(e, GetStructField):
        return pb.ExprNode(get_struct_field=pb.GetStructFieldExpr(child=expr_to_proto(e.child), name=e.name))
    if isinstance(e, NamedStruct):
        return pb.ExprNode(named_struct=pb.NamedStructExpr(names=list(e.names),
                                                           exprs=[expr_to_proto(x) for x in e.exprs]))
    raise NotImplementedError(f"to_proto for {type(e).__name__}")


def _partitioning_to_proto(p) -> pb.PartitioningProto:
    from ..parallel.shuffle import HashPartitioning, RangePartitioning, RoundRobinPartitioning, SinglePartitioning

    if isinstance(p, HashPartitioning):
        return pb.PartitioningProto(kind=pb.PartitioningProto.HASH, num_partitions=p.num_partitions,
                                    exprs=[expr_to_proto(e) for e in p.exprs])
    if isinstance(p, RoundRobinPartitioning):
        return pb.PartitioningProto(kind=pb.PartitioningProto.ROUND_ROBIN, num_partitions=p.num_partitions)
    if isinstance(p, RangePartitioning):
        if p.boundaries is None:
            # a map task cannot compute global boundaries alone
            raise NotImplementedError("range partitioning crosses the serde boundary only with boundaries "
                                      "(the stage scheduler's boundary pass)")
        # the int64 words go out as uint64, bit for bit
        words = [int(v) for b in p.boundaries for v in np.asarray(b, np.int64).view(np.uint64)]
        return pb.PartitioningProto(kind=pb.PartitioningProto.RANGE, num_partitions=p.num_partitions,
                                    sort_fields=[_sort_field(f) for f in p.fields], boundary_words=words,
                                    num_boundary_words=len(p.boundaries))
    if isinstance(p, SinglePartitioning):
        return pb.PartitioningProto(kind=pb.PartitioningProto.SINGLE, num_partitions=p.num_partitions)
    raise NotImplementedError(f"to_proto for {type(p).__name__}")


def _sort_field(f) -> pb.SortFieldProto:
    return pb.SortFieldProto(expr=expr_to_proto(f.expr), ascending=f.ascending, nulls_first=f.nulls_first)


def _window_function(f) -> pb.WindowFunctionProto:
    """Every field of a WindowFunction; an unbounded frame side is -1."""
    fp = pb.WindowFunctionProto(kind=f.kind, name=f.name, whole_partition=f.whole_partition, offset=f.offset,
                                ignore_nulls=f.ignore_nulls)
    if f.expr is not None:
        fp.has_expr = True
        fp.expr = expr_to_proto(f.expr)
    if f.rows_frame is not None:
        fp.has_rows_frame = True
        fp.frame_preceding, fp.frame_following = (-1 if b is None else b for b in f.rows_frame)
    if f.range_frame is not None:
        fp.has_range_frame = True
        fp.range_preceding, fp.range_following = (-1 if b is None else b for b in f.range_frame)
    return fp


def plan_to_proto(node) -> pb.PhysicalPlanNode:
    """A plan tree as a message.  A memory scan stages its partitions
    in ``RESOURCES`` under a new id per serialization (``get`` pops, so
    one serialized task reads them once): a serialized plan that is
    never run strands its entry, so serialize only what runs."""
    from ..ops import (
        AggExec, CoalesceBatchesExec, DebugExec, EmptyPartitionsExec, ExpandExec, FilterExec, GenerateExec,
        LimitExec, MemoryScanExec, NativeGenerator, OrcScanExec, ParquetScanExec, ProjectExec, RenameColumnsExec,
        SortExec, UnionExec, WindowExec,
    )
    from ..ops.bloom_agg import BloomFilterAggExec
    from ..ops.joins import BroadcastJoinBuildHashMapExec, BroadcastJoinExec, HashJoinExec
    from ..ops.object_agg import ObjectAggExec
    from ..parallel.broadcast import IpcWriterExec
    from ..parallel.shuffle import IpcReaderExec, ShuffleWriterExec
    from ..runtime.context import RESOURCES

    out = pb.PhysicalPlanNode()
    if isinstance(node, MemoryScanExec):
        # the reference's memscan_s<source>e<epoch>_<id>_<n> shape; the
        # port keeps no table identity, so source and epoch are 0
        rid = f"memscan_s0e0_{id(node)}_{next(_memscan_rids)}"
        RESOURCES.put(rid, node._partitions)
        staged = STAGED_RIDS.get()
        if staged is not None:
            staged.append(rid)
        out.memory_scan = pb.MemoryScanNode(resource_id=rid, schema=schema_to_proto(node.schema),
                                            num_partitions=node.num_partitions())
    elif isinstance(node, (ParquetScanExec, OrcScanExec)):
        # a partition's files ';'-joined; the predicate is one conjunct,
        # which the decoder ANDs back with any others
        scan = (pb.ParquetScanNode if isinstance(node, ParquetScanExec) else pb.OrcScanNode)(
            schema=schema_to_proto(node.schema), file_groups=[";".join(g) for g in node.file_groups],
            predicate=[] if node.predicate is None else [expr_to_proto(node.predicate)])
        if isinstance(node, ParquetScanExec):
            out.parquet_scan = scan
        else:
            out.orc_scan = scan
    elif isinstance(node, EmptyPartitionsExec):
        out.empty_partitions = pb.EmptyPartitionsNode(schema=schema_to_proto(node.schema),
                                                      num_partitions=node.num_partitions())
    elif isinstance(node, DebugExec):
        out.debug = pb.DebugNode(input=plan_to_proto(node.children[0]), tag=node.tag, verbose=node.verbose)
    elif isinstance(node, CoalesceBatchesExec):
        out.coalesce_batches = pb.CoalesceBatchesNode(input=plan_to_proto(node.children[0]),
                                                      target_rows=node.target_rows)
    elif isinstance(node, ProjectExec):
        out.project = pb.ProjectNode(input=plan_to_proto(node.children[0]),
                                     exprs=[expr_to_proto(e) for e in node.exprs], names=node.names)
    elif isinstance(node, FilterExec):
        out.filter = pb.FilterNode(input=plan_to_proto(node.children[0]),
                                   predicate=expr_to_proto(node.predicate))
        if node.project is not None:
            # the fused projection (tier 1), as the reference writes it
            exprs, names = node.project
            out.filter.project_exprs = [expr_to_proto(e) for e in exprs]
            out.filter.project_names = list(names)
    elif isinstance(node, AggExec):
        agg = pb.AggNode(input=plan_to_proto(node.children[0]), mode=node.mode.value,
                         supports_partial_skipping=node.supports_partial_skipping)
        for g in node.groupings:
            agg.groupings.add(expr=expr_to_proto(g.expr), name=g.name)
        for a in node.aggs:
            ap = agg.aggs.add(fn=a.fn, name=a.name)
            if a.expr is not None:
                ap.has_expr = True
                ap.expr = expr_to_proto(a.expr)
        out.agg = agg
    elif isinstance(node, SortExec):
        sort = pb.SortNode(input=plan_to_proto(node.children[0]),
                           fields=[_sort_field(f) for f in node.fields])
        if node.fetch is not None:
            sort.has_fetch = True
            sort.fetch = node.fetch
        out.sort = sort
    elif isinstance(node, LimitExec):
        out.limit = pb.LimitNode(input=plan_to_proto(node.children[0]), limit=node.limit)
    elif isinstance(node, UnionExec):
        out.union = pb.UnionNode(inputs=[plan_to_proto(c) for c in node.children])
    elif isinstance(node, RenameColumnsExec):
        out.rename_columns = pb.RenameColumnsNode(input=plan_to_proto(node.children[0]), names=node.schema.names)
    elif isinstance(node, ExpandExec):
        out.expand = pb.ExpandNode(
            input=plan_to_proto(node.children[0]),
            projections=[pb.ExpandProjection(exprs=[expr_to_proto(e) for e in p]) for p in node.projections],
            names=node.schema.names)
    elif isinstance(node, GenerateExec):
        gen = pb.GenerateNode(input=plan_to_proto(node.children[0]),
                              input_exprs=[expr_to_proto(e) for e in node.input_exprs],
                              gen_fields=[pb.FieldProto(name=f.name, dtype=dtype_to_proto(f.dtype),
                                                        nullable=f.nullable) for f in node.gen_fields],
                              outer=node.outer, keep_input=node.keep_input)
        if isinstance(node.generator, NativeGenerator):
            gen.native_kind = node.generator.kind
            gen.native_expr = expr_to_proto(node.generator.expr)
        else:
            gen.generator_payload = pickle.dumps(node.generator)
        out.generate = gen
    elif isinstance(node, WindowExec):
        out.window = pb.WindowNode(input=plan_to_proto(node.children[0]),
                                   functions=[_window_function(f) for f in node.functions],
                                   partition_by=[expr_to_proto(e) for e in node.partition_by],
                                   order_by=[_sort_field(f) for f in node.order_by])
    elif isinstance(node, ShuffleWriterExec):
        out.shuffle_writer = pb.ShuffleWriterNode(
            input=plan_to_proto(node.children[0]),
            partitioning=_partitioning_to_proto(node.partitioning),
            output_data_file=node.data_path, output_index_file=node.index_path)
    elif isinstance(node, IpcReaderExec):
        out.ipc_reader = pb.IpcReaderNode(schema=schema_to_proto(node.schema),
                                          ipc_provider_resource_id=node.resource_id,
                                          num_partitions=node.num_partitions())
    elif isinstance(node, IpcWriterExec):
        out.ipc_writer = pb.IpcWriterNode(input=plan_to_proto(node.children[0]),
                                          ipc_consumer_resource_id=node.resource_id)
    elif isinstance(node, (BroadcastJoinExec, HashJoinExec)):
        msg = (pb.BroadcastJoinNode if isinstance(node, BroadcastJoinExec) else pb.HashJoinNode)(
            build=plan_to_proto(node.children[0]), probe=plan_to_proto(node.children[1]),
            build_keys=[expr_to_proto(e) for e in node.build_keys],
            probe_keys=[expr_to_proto(e) for e in node.probe_keys],
            join_type=pb.JoinTypeProto[node.join_type.name], build_is_left=node.build_is_left)
        if isinstance(node, BroadcastJoinExec):
            msg.build_data_schema = schema_to_proto(node.build_data_schema)
            if node.cached_build_id:
                msg.cached_build_id = node.cached_build_id
            out.broadcast_join = msg
        else:
            out.hash_join = msg
    elif isinstance(node, BroadcastJoinBuildHashMapExec):
        out.broadcast_join_build_hash_map = pb.BroadcastJoinBuildHashMapNode(
            input=plan_to_proto(node.children[0]), keys=[expr_to_proto(e) for e in node.keys])
    elif isinstance(node, ObjectAggExec):
        # the UDAFs travel pickled: a TaskDefinition names the module of
        # the package that wrote it, so each package reads only its own
        out.object_agg = pb.ObjectAggNode(
            input=plan_to_proto(node.children[0]), mode=node.mode.value,
            groupings=[pb.NamedExpr(expr=expr_to_proto(g.expr), name=g.name) for g in node.groupings],
            udafs_payload=pickle.dumps(node.udafs))
    elif isinstance(node, BloomFilterAggExec):
        bloom = pb.BloomFilterAggNode(input=plan_to_proto(node.children[0]), name=node.agg_name,
                                      mode=node.mode.value, expected_items=node.expected_items,
                                      num_bits=node.num_bits)
        if node.expr is not None:
            bloom.has_expr = True
            bloom.expr = expr_to_proto(node.expr)
        out.bloom_filter_agg = bloom
    else:
        raise NotImplementedError(f"to_proto for {type(node).__name__}")
    return out


def task_definition(plan, task_id: str, stage_id: int, partition: int) -> bytes:
    """The TaskDefinition bytes of one task."""
    return pb.TaskDefinition(task_id=task_id, stage_id=stage_id, partition=partition,
                             plan=plan_to_proto(plan)).encode()
