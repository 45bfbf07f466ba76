"""Plan-contract messages -> ExecNode and Expr trees, and the task
runner (≙ ``blaze_tpu/serde/from_proto.py``).

The same subset as ``to_proto``; any other node, expression,
partitioning or join type raises ``NotImplementedError`` naming it.
Decimal literals arrive unscaled and are decoded as ``Lit(...,
unscaled=True)``.
"""

from __future__ import annotations


from ..exprs.ir import Alias, BinOp, Col, Expr, IsNotNull, IsNull, Lit, Not
from ..schema import DataType, Field, Schema, TypeKind
from . import wire as pb


def dtype_from_proto(t: pb.DataTypeProto) -> DataType:
    kind = TypeKind(t.kind)
    if kind == TypeKind.DECIMAL:
        return DataType.decimal(t.precision, t.scale)
    if kind in (TypeKind.STRING, TypeKind.BINARY):
        return DataType(kind, string_width=t.string_width or 64)
    if kind in (TypeKind.ARRAY, TypeKind.MAP, TypeKind.STRUCT, TypeKind.OPAQUE):
        raise NotImplementedError(f"from_proto for type {kind.name}")
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
    raise NotImplementedError(f"from_proto expr {kind}")


def _partitioning_from_proto(p: pb.PartitioningProto):
    from ..parallel.shuffle import HashPartitioning, SinglePartitioning

    if p.kind == pb.PartitioningProto.HASH:
        return HashPartitioning([expr_from_proto(e) for e in p.exprs], p.num_partitions)
    if p.kind == pb.PartitioningProto.SINGLE:
        return SinglePartitioning(p.num_partitions)
    raise NotImplementedError(f"from_proto partitioning {pb.PartitioningProto.Kind(p.kind).name}")


def _join_type(v: int):
    from ..ops.joins import JoinType

    name = pb.JoinTypeProto(v).name
    if name not in JoinType.__members__:
        raise NotImplementedError(f"from_proto join type {name}")
    return JoinType[name]


def plan_from_proto(n: pb.PhysicalPlanNode):
    """A plan tree from its message.  A memory scan pops its partitions
    from ``RESOURCES`` and stages them on the package's default device."""
    from ..ops import (
        AggExec, AggFunction, AggMode, FilterExec, GroupingExpr, LimitExec, MemoryScanExec,
        ProjectExec, SortExec, SortField,
    )
    from ..ops.joins import BroadcastJoinExec, HashJoinExec
    from ..parallel.broadcast import IpcWriterExec
    from ..parallel.shuffle import IpcReaderExec, ShuffleWriterExec
    from ..runtime.context import RESOURCES

    kind = n.which_oneof("node")
    if kind == "memory_scan":
        m = n.memory_scan
        return MemoryScanExec(RESOURCES.get(m.resource_id), schema_from_proto(m.schema))
    if kind == "project":
        p = n.project
        return ProjectExec(plan_from_proto(p.input), [expr_from_proto(e) for e in p.exprs], list(p.names))
    if kind == "filter":
        f = n.filter
        if len(f.project_exprs):
            raise NotImplementedError("from_proto filter with a fused projection")
        return FilterExec(plan_from_proto(f.input), expr_from_proto(f.predicate))
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
    raise NotImplementedError(f"from_proto node {kind}")


def run_task(task_def_bytes: bytes, task_attempt_id: int = 0):
    """Decode a TaskDefinition and run its plan for its partition;
    returns the task's batch stream.  The port has no optimizer
    (fusion, column pruning), so the decoded plan runs as it was
    serialized."""
    from ..runtime.context import TaskContext

    td = pb.TaskDefinition.decode(task_def_bytes)
    plan = plan_from_proto(td.plan)
    ctx = TaskContext(td.partition, max(plan.num_partitions(), td.partition + 1),
                      stage_id=td.stage_id, task_attempt_id=task_attempt_id)
    return plan.execute(td.partition, ctx)
