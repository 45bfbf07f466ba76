"""ExecNode and Expr trees -> plan-contract messages (≙
``blaze_tpu/serde/to_proto.py``).

Covers the nodes and expressions the port has: memory scan, project,
filter, agg, sort, limit, shuffle writer, IPC reader and writer,
broadcast and shuffled hash joins; columns, literals, aliases, binary
operators, NOT, IS [NOT] NULL.  Anything else raises
``NotImplementedError`` naming it.
"""

from __future__ import annotations

import contextvars
import datetime
import itertools

from ..exprs.compile import infer_lit_dtype, unscaled_decimal
from ..exprs.ir import Alias, BinOp, Col, Expr, IsNotNull, IsNull, Lit, Not
from ..schema import DataType, Schema, TypeKind
from . import wire as pb

# each serialization of a memory scan stages its partitions under a new id
_memscan_rids = itertools.count()

#: when set to a list, every resource id staged while serializing is
#: appended to it, so a caller can discard what a task never consumed
STAGED_RIDS: contextvars.ContextVar = contextvars.ContextVar("blaze_torch_staged_rids", default=None)


def dtype_to_proto(t: DataType) -> pb.DataTypeProto:
    if t.is_nested:
        raise NotImplementedError(f"to_proto for nested type {t!r}")
    return pb.DataTypeProto(kind=t.kind.value, precision=t.precision, scale=t.scale,
                            string_width=t.string_width, max_elems=t.max_elems)


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
    raise NotImplementedError(f"to_proto for {type(e).__name__}")


def _partitioning_to_proto(p) -> pb.PartitioningProto:
    from ..parallel.shuffle import HashPartitioning, SinglePartitioning

    if isinstance(p, HashPartitioning):
        return pb.PartitioningProto(kind=pb.PartitioningProto.HASH, num_partitions=p.num_partitions,
                                    exprs=[expr_to_proto(e) for e in p.exprs])
    if isinstance(p, SinglePartitioning):
        return pb.PartitioningProto(kind=pb.PartitioningProto.SINGLE, num_partitions=p.num_partitions)
    raise NotImplementedError(f"to_proto for {type(p).__name__}")


def _sort_field(f) -> pb.SortFieldProto:
    return pb.SortFieldProto(expr=expr_to_proto(f.expr), ascending=f.ascending, nulls_first=f.nulls_first)


def plan_to_proto(node) -> pb.PhysicalPlanNode:
    """A plan tree as a message.  A memory scan stages its partitions
    in ``RESOURCES`` under a new id per serialization (``get`` pops, so
    one serialized task reads them once): a serialized plan that is
    never run strands its entry, so serialize only what runs."""
    from ..ops import AggExec, FilterExec, LimitExec, MemoryScanExec, ProjectExec, SortExec
    from ..ops.joins import BroadcastJoinExec, HashJoinExec
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
    elif isinstance(node, ProjectExec):
        out.project = pb.ProjectNode(input=plan_to_proto(node.children[0]),
                                     exprs=[expr_to_proto(e) for e in node.exprs], names=node.names)
    elif isinstance(node, FilterExec):
        out.filter = pb.FilterNode(input=plan_to_proto(node.children[0]),
                                   predicate=expr_to_proto(node.predicate))
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
    else:
        raise NotImplementedError(f"to_proto for {type(node).__name__}")
    return out


def task_definition(plan, task_id: str, stage_id: int, partition: int) -> bytes:
    """The TaskDefinition bytes of one task."""
    return pb.TaskDefinition(task_id=task_id, stage_id=stage_id, partition=partition,
                             plan=plan_to_proto(plan)).encode()
