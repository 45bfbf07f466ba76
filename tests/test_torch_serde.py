"""The port's plan contract and wire formats against the JAX package's.

- The codec's table, parsed from the port's copy of ``plan.proto``,
  equals the reference's generated ``plan_pb2`` descriptors.
- Every TaskDefinition the reference's ``split_stages``/``build_task``
  makes for TPC-H q01, q03, q04, q05, q06, q10, q12, q14 and q19 decodes and re-encodes byte for byte in the
  port; the port's own TaskDefinitions for the same tasks, parsed by
  ``plan_pb2``, equal the reference's once the resource ids, shuffle ids
  and file paths that each process mints are normalized.
- Decimal literals travel unscaled and are never scaled again on the
  way back: pinned through encode and decode.
- Batch bytes, frame bytes (raw and zlib, with and without a
  checksum) and broadcast blobs equal the reference's; LZ4 frames and
  blobs decode both ways.
"""

import io
import re
import shutil
import struct

import numpy as np
import pytest
import torch

import blaze_tpu.batch as JB
from blaze_tpu.io import batch_serde as JBS
from blaze_tpu.io import ipc_compression as JIC
from blaze_tpu.ops import MemoryScanExec as JaxScan
from blaze_tpu.parallel.broadcast import _collect_blob as jax_collect_blob
from blaze_tpu.runtime import scheduler as JS
from blaze_tpu.runtime.context import RESOURCES as JAX_RESOURCES
from blaze_tpu.schema import DataType as JT, Field as JF, Schema as JSchema
from blaze_tpu.serde import plan_pb2 as pb
from blaze_tpu.serde import to_proto as jax_to_proto
from blaze_tpu.tpch import TPCH_SCHEMAS as JAX_SCHEMAS
from blaze_tpu.tpch import build_query as jax_build_query
from blaze_tpu.tpch.datagen import generate_all as jax_generate_all
from blaze_tpu.tpch.datagen import table_to_batches as jax_table_to_batches

import blaze_tpu_torch
import blaze_tpu_torch.batch as TB
from blaze_tpu_torch.exprs import lit
from blaze_tpu_torch.exprs.compile import lower
from blaze_tpu_torch.io import batch_serde as BS
from blaze_tpu_torch.io import ipc_compression as IC
from blaze_tpu_torch.ops import MemoryScanExec
from blaze_tpu_torch.parallel.broadcast import collect_blob
from blaze_tpu_torch.parallel.shuffle import IpcReaderExec
from blaze_tpu_torch.runtime import integrity
from blaze_tpu_torch.runtime import scheduler as S
from blaze_tpu_torch.runtime.context import RESOURCES, TaskContext
from blaze_tpu_torch.schema import DataType as TT, Field as TF, Schema as TSchema
from blaze_tpu_torch.serde import from_proto, to_proto, wire
from blaze_tpu_torch.tpch import TPCH_SCHEMAS, build_query
from blaze_tpu_torch.tpch.datagen import generate_all

SCALE = 0.002
N_PARTS = 2
QUERIES = ("q1", "q3", "q4", "q5", "q6", "q10", "q12", "q14", "q19")

_FD = pb.DESCRIPTOR.message_types_by_name["FieldProto"].fields[0].__class__
_TYPE_NAMES = {
    _FD.TYPE_INT64: "int64", _FD.TYPE_UINT64: "uint64", _FD.TYPE_INT32: "int32",
    _FD.TYPE_UINT32: "uint32", _FD.TYPE_BOOL: "bool", _FD.TYPE_STRING: "string",
    _FD.TYPE_BYTES: "bytes", _FD.TYPE_DOUBLE: "double", _FD.TYPE_MESSAGE: "message",
    _FD.TYPE_ENUM: "enum",
}


def _all_descriptors():
    out = {}

    def walk(d, prefix):
        name = prefix + d.name
        out[name] = d
        for n in d.nested_types:
            walk(n, name + ".")

    for d in pb.DESCRIPTOR.message_types_by_name.values():
        walk(d, "")
    return out


DESCRIPTORS = _all_descriptors()


@pytest.fixture(autouse=True)
def on_cpu():
    """Decoded plans stage on the package's default device: the CPU here."""
    prev = blaze_tpu_torch._default_device
    blaze_tpu_torch.set_default_device("cpu")
    yield
    blaze_tpu_torch.set_default_device(prev)


def _short(full_name):
    return full_name[len("blaze_tpu."):]


# ------------------------------------------------------------- wire table


@pytest.mark.parametrize("name", sorted(DESCRIPTORS))
def test_wire_table_equals_plan_pb2(name):
    """Each message's fields, numbers, types, labels and oneofs, as
    parsed from the port's plan.proto, equal the generated code's."""
    d = DESCRIPTORS[name]
    spec = wire.MESSAGES[name]
    want = [(f.name, f.number, _TYPE_NAMES[f.type], f.is_repeated,
             f.containing_oneof.name if f.containing_oneof else None,
             _short(f.message_type.full_name) if f.message_type else
             _short(f.enum_type.full_name) if f.enum_type else None)
            for f in sorted(d.fields, key=lambda f: f.number)]
    got = [(f.name, f.number, f.type, f.repeated, f.oneof, f.type_name) for f in spec.fields]
    assert got == want
    assert {k: list(v) for k, v in spec.oneofs.items()} == {
        o.name: [f.name for f in o.fields] for o in d.oneofs}


def test_wire_messages_and_enums_are_all_there():
    assert set(wire.MESSAGES) == set(DESCRIPTORS)
    want_enums = {_short(e.full_name): {v.name: v.number for v in e.values}
                  for e in list(pb.DESCRIPTOR.enum_types_by_name.values())
                  + [e for d in DESCRIPTORS.values() for e in d.enum_types]}
    assert wire.ENUMS == want_enums


def test_port_proto_is_a_copy_of_the_reference():
    from pathlib import Path

    ref = Path(pb.__file__).with_name("plan.proto").read_bytes()
    assert wire.PROTO_PATH.read_bytes() == ref


# ---------------------------------------------------------- wire edge cases


def _roundtrip(msg):
    """Port decode -> encode of the reference's bytes, and the port's
    own bytes equal to the reference's."""
    raw = msg.SerializeToString()
    port = getattr(wire, type(msg).__name__).decode(raw)
    assert port.encode() == raw
    return port


def test_negative_varints_are_ten_bytes():
    m = pb.LiteralValue(int_value=-1)
    raw = m.SerializeToString()
    assert len(raw) == 11  # tag + ten bytes
    assert _roundtrip(m).int_value == -1
    assert wire.LiteralValue(int_value=-(2**63)).encode() == pb.LiteralValue(int_value=-(2**63)).SerializeToString()
    g = pb.GetIndexedFieldExpr(index=-5)
    assert _roundtrip(g).index == -5


def test_packed_uint64_boundary_words():
    m = pb.PartitioningProto(kind=pb.PartitioningProto.RANGE, num_partitions=4,
                             boundary_words=[0, 1, 2**63, 2**64 - 1], num_boundary_words=1)
    port = _roundtrip(m)
    assert list(port.boundary_words) == [0, 1, 2**63, 2**64 - 1]
    again = wire.PartitioningProto(kind=wire.PartitioningProto.RANGE, num_partitions=4,
                                   boundary_words=[0, 1, 2**63, 2**64 - 1], num_boundary_words=1)
    assert again.encode() == m.SerializeToString()


@pytest.mark.parametrize("case", ["int_zero", "bool_false", "empty_bytes", "empty_message", "float_zero"])
def test_oneof_member_set_to_its_default_is_written(case):
    m = {
        "int_zero": pb.LiteralValue(int_value=0),
        "bool_false": pb.LiteralValue(bool_value=False),
        "empty_bytes": pb.LiteralValue(bytes_value=b""),
        "float_zero": pb.LiteralValue(float_value=0.0),
        "empty_message": pb.ExprNode(is_null=pb.ExprNode()),
    }[case]
    assert m.SerializeToString()  # written, though a default
    port = _roundtrip(m)
    group = "expr" if case == "empty_message" else "value"
    assert port.which_oneof(group) == m.WhichOneof(group)


def test_unset_and_default_scalars_are_not_written():
    assert wire.DataTypeProto(kind=0, precision=0, string_width=0).encode() == b""
    assert wire.SortNode(has_fetch=False, fetch=0).encode() == b""
    m = wire.SortNode()
    assert m.fetch == 0 and m.has_fetch is False and not m.has_field("input")
    assert m.input.encode() == b"" and not m.has_field("input")  # reading does not set


def test_unknown_fields_are_skipped():
    known = pb.FieldProto(name="a", nullable=True).SerializeToString()
    # fields 10-13, one of each wire type (varint, length, fixed64, fixed32),
    # and field 200 (a two-byte tag)
    unknown = bytes([(10 << 3) | 0, 5, (11 << 3) | 2, 2, 7, 7, (12 << 3) | 1]) + bytes(8) \
        + bytes([(13 << 3) | 5]) + bytes(4) + bytes([0xC0, 0x0C, 1])
    port = wire.FieldProto.decode(unknown + known)
    assert port.name == "a" and port.nullable and port.encode() == known


def test_truncated_bytes_raise():
    raw = pb.FieldProto(name="abcdef").SerializeToString()
    with pytest.raises(ValueError):
        wire.FieldProto.decode(raw[:-2])


def test_setting_another_oneof_member_clears_the_first():
    n = wire.ExprNode(column="a")
    n.literal = wire.LiteralValue(int_value=3)
    assert n.which_oneof("expr") == "literal" and not n.has_field("column")
    assert n.encode() == pb.ExprNode(literal=pb.LiteralValue(int_value=3)).SerializeToString()


def test_wrong_submessage_type_raises():
    with pytest.raises(TypeError):
        wire.ExprNode(alias=wire.BinaryExpr(op="+"))


# ---------------------------------------------------------- query tasks


@pytest.fixture(scope="module")
def data():
    return generate_all(SCALE)


@pytest.fixture(scope="module")
def jax_data():
    return jax_generate_all(SCALE)


def _port_scans(data):
    return {name: MemoryScanExec(TB.table_to_batches(data[name], TPCH_SCHEMAS[name], N_PARTS, 4096, "cpu"),
                                 TPCH_SCHEMAS[name], device="cpu") for name in TPCH_SCHEMAS}


def _jax_scans(jax_data):
    return {name: JaxScan(jax_table_to_batches(jax_data[name], JAX_SCHEMAS[name], N_PARTS, batch_rows=4096),
                          JAX_SCHEMAS[name]) for name in JAX_SCHEMAS}


def jax_task_defs(jax_data, q):
    """The reference's TaskDefinition bytes for every task of ``q``;
    the memory-scan partitions its serialization staged are discarded."""
    stages, manager = JS.split_stages(jax_build_query(q, _jax_scans(jax_data), N_PARTS))
    staged = []
    token = jax_to_proto.STAGED_RIDS.set(staged)
    try:
        tds = [JS.build_task(s, manager, t)[1] for s in stages for t in range(s.n_tasks)]
    finally:
        jax_to_proto.STAGED_RIDS.reset(token)
        for rid in staged:
            JAX_RESOURCES.discard(rid)
        shutil.rmtree(manager.root)
    return stages, manager, tds


def port_task_defs(data, q):
    stages, manager = S.split_stages(build_query(q, _port_scans(data), N_PARTS))
    staged = []
    token = to_proto.STAGED_RIDS.set(staged)
    try:
        tds = [S.build_task(s, manager, t)[1] for s in stages for t in range(s.n_tasks)]
    finally:
        to_proto.STAGED_RIDS.reset(token)
        for rid in staged:
            RESOURCES.discard(rid)
        manager.cleanup()
    return stages, tds


def normalized(tds):
    """The TaskDefinitions as text, with what each process mints made
    comparable: memory-scan resource ids, cached build ids, shuffle and
    broadcast ids (renumbered in order of appearance) and the shuffle
    directory."""
    from google.protobuf import text_format

    ids = {}

    def renumber(m):
        key = (m.group(1), m.group(2))
        ids.setdefault(key, sum(1 for k in ids if k[0] == m.group(1)))
        return f"{m.group(1)}_#{ids[key]}"

    out = []
    for raw in tds:
        text = text_format.MessageToString(pb.TaskDefinition.FromString(raw))
        text = re.sub(r'resource_id: "memscan_[^"]*"', 'resource_id: "memscan"', text)
        text = re.sub(r'cached_build_id: "[^"]*"', 'cached_build_id: "cached"', text)
        text = re.sub(r'_file: "[^"]*/(shuffle_[^"]*)"', r'_file: "\1"', text)
        text = re.sub(r"(shuffle|broadcast)_(\d+)", renumber, text)
        out.append(text)
    return out


@pytest.mark.parametrize("q", QUERIES)
def test_reference_task_definitions_roundtrip_byte_identical(jax_data, q):
    _, manager, tds = jax_task_defs(jax_data, q)
    assert len(tds) > 2
    for raw in tds:
        assert wire.TaskDefinition.decode(raw).encode() == raw


@pytest.mark.parametrize("q", QUERIES)
def test_port_task_definitions_equal_the_reference(data, jax_data, q):
    jstages, _, jtds = jax_task_defs(jax_data, q)
    stages, tds = port_task_defs(data, q)
    assert [(s.kind, s.n_tasks) for s in stages] == [(s.kind, s.n_tasks) for s in jstages]
    assert normalized(tds) == normalized(jtds)
    assert len(RESOURCES) == 0


def memory_scans(msg):
    """Every MemoryScanNode under a decoded message."""
    if isinstance(msg, wire.MemoryScanNode):
        return [msg]
    out = []
    for f in msg._spec.fields:
        if f.type != "message":
            continue
        if f.repeated:
            for m in getattr(msg, f.name):
                out += memory_scans(m)
        elif msg.has_field(f.name):
            out += memory_scans(getattr(msg, f.name))
    return out


@pytest.mark.parametrize("q", QUERIES)
def test_plan_decodes_and_encodes_the_reference_bytes(jax_data, q):
    """The reference's bytes -> the port's plan -> the port's bytes:
    equal up to the memory-scan ids the port's serialization mints."""
    _, _, tds = jax_task_defs(jax_data, q)
    for raw in tds:
        td = wire.TaskDefinition.decode(raw)
        for scan in memory_scans(td.plan):
            RESOURCES.put(scan.resource_id, [[] for _ in range(scan.num_partitions)])
        plan = from_proto.plan_from_proto(td.plan)
        staged = []
        token = to_proto.STAGED_RIDS.set(staged)
        try:
            again = to_proto.task_definition(plan, td.task_id, td.stage_id, td.partition)
        finally:
            to_proto.STAGED_RIDS.reset(token)
            for rid in staged:
                RESOURCES.discard(rid)
        port_ids = [scan.resource_id for scan in memory_scans(wire.TaskDefinition.decode(again).plan)]
        assert all(re.fullmatch(r"memscan_s0e0_\d+_\d+", rid) for rid in port_ids)
        assert _scan_ids_normalized(again) == _scan_ids_normalized(raw)
    assert len(RESOURCES) == 0


def _scan_ids_normalized(raw: bytes) -> bytes:
    """TaskDefinition bytes re-encoded with every memory-scan id set to
    one string (the enclosing length prefixes follow the id)."""
    td = wire.TaskDefinition.decode(raw)
    for scan in memory_scans(td.plan):
        scan.resource_id = "memscan"
    return td.encode()


# --------------------------------------------------------- decimal literals


DEC = TT.decimal(12, 2)
JDEC = JT.decimal(12, 2)


@pytest.mark.parametrize("value,dtype,jdtype,unscaled", [
    ("0.05", DEC, JDEC, 5), ("0.07", DEC, JDEC, 7), (24, DEC, JDEC, 2400), (1, DEC, JDEC, 100),
    ("-1.25", DEC, JDEC, -125), (2**40, None, None, 2**40), (-(2**35), None, None, -(2**35)),
    ("12345678901.23", TT.decimal(38, 6), JT.decimal(38, 6), 12345678901230000),
], ids=["q6-0.05", "q6-0.07", "q6-24", "q1q3-1", "negative", "int64-past-2^31", "negative-int64",
        "wide-decimal"])
def test_literals_travel_unscaled_once(value, dtype, jdtype, unscaled):
    from blaze_tpu.exprs import lit as jlit

    node = to_proto.expr_to_proto(lit(value, dtype))
    assert node.literal.int_value == unscaled
    assert node.encode() == jax_to_proto.expr_to_proto(jlit(value, jdtype)).SerializeToString()
    back = from_proto.expr_from_proto(wire.ExprNode.decode(node.encode()))
    assert to_proto.expr_to_proto(back).encode() == node.encode()  # re-encoded, not scaled again
    assert back.unscaled == (dtype is not None and dtype.is_decimal)
    env = {"x": TB.column_from_numpy(TT.int32(), np.zeros(2, np.int32), device="cpu")}
    got = lower(back, TSchema([TF("x", TT.int32())]), env, 2)
    assert got.data.tolist() == [unscaled, unscaled]


def test_q6_and_q3_literals_in_the_tasks(data):
    """q06's 0.05 / 0.07 / 24 and q03's 1 reach the tasks unscaled."""
    _, tds = port_task_defs(data, "q6")
    text = "".join(normalized(tds))
    for v in (5, 7, 2400):
        assert re.search(rf"precision: 12\s+scale: 2\s+string_width: 64\s+}}\s+int_value: {v}\n", text), v
    _, tds = port_task_defs(data, "q3")
    assert re.search(r"scale: 2\s+string_width: 64\s+}\s+int_value: 100\n", "".join(normalized(tds)))


def test_unsupported_nodes_raise_naming_them():
    n = pb.PhysicalPlanNode(sort_merge_join=pb.SortMergeJoinNode()).SerializeToString()
    with pytest.raises(NotImplementedError, match="sort_merge_join"):
        from_proto.plan_from_proto(wire.PhysicalPlanNode.decode(n))
    e = pb.ExprNode(host_udf=pb.HostUdfExpr()).SerializeToString()
    with pytest.raises(NotImplementedError, match="host_udf"):
        from_proto.expr_from_proto(wire.ExprNode.decode(e))
    with pytest.raises(NotImplementedError, match="TaskContext"):
        to_proto.plan_to_proto(TaskContext(0))


def test_filter_with_a_fused_projection_travels_whole():
    """A FilterExec's fused projection (the optimizer's tier 1) rides
    the wire as ``project_exprs``/``project_names``, both ways, byte for
    byte as the reference writes it."""
    from blaze_tpu.exprs import ir as JI
    from blaze_tpu.ops import FilterExec as JaxFilter
    from blaze_tpu_torch.exprs import ir as TI
    from blaze_tpu_torch.ops import FilterExec

    data = {"a": [1, 2, 3], "b": [10, 20, 30]}
    tschema = TSchema([TF("a", TT.int64()), TF("b", TT.int64())])
    jschema = JSchema([JF("a", JT.int64()), JF("b", JT.int64())])
    tb = TB.batch_from_pydict(data, tschema, device="cpu")
    port = FilterExec(MemoryScanExec([[tb]], tschema), TI.col("a") > TI.lit(1),
                      project=([(TI.col("a") + TI.col("b")).alias("s")], ["s"]))
    ref = JaxFilter(JaxScan([[JB.batch_from_pydict(data, jschema)]], jschema), JI.col("a") > JI.lit(1),
                    project=([(JI.col("a") + JI.col("b")).alias("s")], ["s"]))

    def rows(plan):
        prev = blaze_tpu_torch._default_device
        blaze_tpu_torch.set_default_device("cpu")
        try:
            return [TB.batch_to_pydict(b) for b in plan.execute(0, TaskContext(0, 1))]
        finally:
            blaze_tpu_torch.set_default_device(prev)

    msg = to_proto.plan_to_proto(port)
    back = from_proto.plan_from_proto(wire.PhysicalPlanNode.decode(msg.encode()))  # takes the staged scan
    assert back.schema.names == ["s"] and rows(back) == [{"s": [22, 33]}]
    jmsg = jax_to_proto.plan_to_proto(ref)
    JAX_RESOURCES.get(jmsg.filter.input.memory_scan.resource_id)  # the reference's staged scan, unread
    for m in (msg.filter.input.memory_scan, jmsg.filter.input.memory_scan):
        m.resource_id = "memscan_c1"
    assert msg.encode() == jmsg.SerializeToString()
    RESOURCES.put("memscan_c1", [[tb]])
    from_ref = from_proto.plan_from_proto(wire.PhysicalPlanNode.decode(jmsg.SerializeToString()))
    assert rows(from_ref) == [{"s": [22, 33]}]


# ------------------------------------------------------- batches and frames


def _table(n=300, seed=5):
    rng = np.random.default_rng(seed)
    valid = rng.random(n) > 0.2
    return {
        "i64": (rng.integers(-(2**62), 2**62, n), valid),
        "d32": (rng.integers(8000, 11000, n).astype(np.int32), None),
        "dec": (rng.integers(-10**11, 10**11, n), valid),
        "wide": (rng.integers(-(2**62), 2**62, n), None),
        "s": ([None if not v else "x" * int(k) for v, k in zip(valid, rng.integers(0, 20, n))], None),
        "f": (rng.standard_normal(n), valid),
        "b": (rng.random(n) > 0.5, None),
    }


_TYPES = [("i64", TT.int64(), JT.int64()), ("d32", TT.date32(), JT.date32()),
          ("dec", TT.decimal(12, 2), JT.decimal(12, 2)), ("wide", TT.decimal(38, 6), JT.decimal(38, 6)),
          ("s", TT.string(32), JT.string(32)), ("f", TT.float64(), JT.float64()),
          ("b", TT.bool_(), JT.bool_())]


def _both_batches(n=300, seed=5):
    t = _table(n, seed)
    tcols, jcols = [], []
    for name, tt, jt in _TYPES:
        vals, valid = t[name]
        if name == "s":
            tcols.append(TB.column_from_strings(vals, width=32, dtype=tt, device="cpu"))
            jcols.append(JB.column_from_strings(vals, width=32, dtype=jt))
        else:
            tcols.append(TB.column_from_numpy(tt, vals, valid, device="cpu"))
            jcols.append(JB.column_from_numpy(jt, vals, valid))
    tschema = TSchema([TF(name, tt) for name, tt, _ in _TYPES])
    jschema = JSchema([JF(name, jt) for name, _, jt in _TYPES])
    return TB.RecordBatch(tschema, tcols, n), JB.RecordBatch(jschema, jcols, n)


@pytest.mark.parametrize("n", [0, 1, 300])
def test_serialize_batch_equals_the_reference(n):
    tb, jb = _both_batches(n)
    raw = BS.serialize_batch(tb)
    assert raw == JBS.serialize_batch(jb)
    back = BS.deserialize_batch(raw, tb.schema, "cpu")
    assert back.capacity == TB.bucket_capacity(max(n, 1))
    assert TB.batch_to_pydict(back) == TB.batch_to_pydict(tb)
    for c in back.columns:  # padding zeroed
        assert not c.validity[n:].any() and not c.data[n:].to(torch.bool).any()
    assert TB.batch_to_pydict(back) == JB.batch_to_pydict(JBS.deserialize_batch(raw, jb.schema))


def test_serialize_batch_is_one_copy_each_way():
    tb, _ = _both_batches(50)
    TB.reset_copy_counts()
    BS.deserialize_batch(BS.serialize_batch(tb), tb.schema, "cpu")
    assert TB.COPIES == {"device_to_host": 1, "host_to_device": 1}


def test_nested_wire_columns_raise():
    """A nested frame (tag 2) for a flat field raises in both packages
    (the reference asserts); a nested field's frame decodes and
    re-encodes as the reference's bytes."""
    raw = struct.pack("<IBB", 1, 2, 1)
    with pytest.raises(ValueError, match="wire tag 2"):
        BS.decode_columns(raw, TSchema([TF("a", TT.int64())]))
    with pytest.raises(AssertionError):
        JBS.deserialize_batch(raw, JSchema([JF("a", JT.int64())]))
    data = {"a": [[1, 2], None, [], [None, 5, 6]]}
    jb = JB.batch_from_pydict(data, JSchema([JF("a", JT.array(JT.int64(), 3))]))
    ref = JBS.serialize_batch(jb)
    tschema = TSchema([TF("a", TT.array(TT.int64(), 3))])
    back = BS.deserialize_batch(ref, tschema, "cpu")
    assert TB.batch_to_pydict(back) == data and BS.serialize_batch(back) == ref


PAYLOAD = b"blaze " * 300 + bytes(range(256)) * 4


@pytest.mark.parametrize("codec", ["raw", "zlib"])
@pytest.mark.parametrize("algo", [None, integrity.ALGO_CRC32, integrity.ALGO_CRC32C, integrity.ALGO_XXH32],
                         ids=["unstamped", "crc32", "crc32c", "xxh32"])
def test_compress_frame_equals_the_reference(codec, algo):
    frame = IC.compress_frame(PAYLOAD, codec, checksum_algo=algo)
    assert frame == JIC.compress_frame(PAYLOAD, codec, checksum_algo=algo)
    assert IC.decompress_frame(frame) == PAYLOAD == JIC.decompress_frame(frame)
    assert IC.frame_span(frame, 0) == JIC.frame_span(frame, 0)


@pytest.mark.parametrize("checksums", [False, True])
def test_lz4_frames_decode_both_ways(checksums):
    port = IC.lz4_frame_compress(PAYLOAD, checksums)
    ref = JIC.lz4_frame_compress(PAYLOAD, checksums)
    assert IC.lz4_frame_decompress(ref) == PAYLOAD == JIC.lz4_frame_decompress(port)
    for algo in (None, integrity.ALGO_CRC32):
        assert JIC.decompress_frame(IC.compress_frame(PAYLOAD, "lz4", algo)) == PAYLOAD
        assert IC.decompress_frame(JIC.compress_frame(PAYLOAD, "lz4", algo)) == PAYLOAD


def test_lz4_checksum_mismatch_raises():
    frame = bytearray(IC.lz4_frame_compress(PAYLOAD, checksums=True))
    frame[-1] ^= 1
    with pytest.raises(integrity.BlockCorruptionError, match="content checksum"):
        IC.lz4_frame_decompress(bytes(frame))


def test_zstd_frames_decode_both_ways():
    for algo in (None, integrity.ALGO_CRC32):
        frame = IC.compress_frame(PAYLOAD, "zstd", algo)
        assert IC.frame_span(frame, 0)[0] & ~integrity.CHECKSUM_FLAG == IC.CODEC_ZSTD
        assert JIC.decompress_frame(frame) == PAYLOAD == IC.decompress_frame(frame)
        assert IC.decompress_frame(JIC.compress_frame(PAYLOAD, "zstd", algo)) == PAYLOAD


def test_compress_frame_rejects_an_unknown_codec():
    with pytest.raises(ValueError, match="unknown codec 'snappy'"):
        IC.compress_frame(PAYLOAD, "snappy")


def test_writers_stamp_crc32_and_readers_verify_whatever_the_environment(monkeypatch):
    # the reference's checksum knob (off disarms its readers) has no
    # counterpart in the port; its codec knob does (the writers follow
    # spark.io.compression.codec, here raw)
    monkeypatch.setenv("BLAZE_IO_CHECKSUM", "off")
    monkeypatch.setenv("BLAZE_SPARK_IO_COMPRESSION_CODEC", "raw")
    buf = io.BytesIO()
    IC.IpcFrameWriter(buf).write(PAYLOAD)
    tb, _ = _both_batches(40, seed=3)
    for stream in (buf.getvalue(), collect_blob([tb])):
        cid, start, ln, nxt = IC.frame_span(stream, 0)
        assert cid == IC.CODEC_RAW | integrity.CHECKSUM_FLAG
        assert stream[start + ln] == integrity.ALGO_CRC32 == integrity.FRAME_ALGO
        flipped = bytearray(stream)
        flipped[start + 2] ^= 1
        with pytest.raises(integrity.BlockCorruptionError, match="crc32 mismatch"):
            list(IC.iter_blob_frames(bytes(flipped)))


def test_flipped_frame_byte_raises_typed_error():
    frame = bytearray(IC.compress_frame(PAYLOAD, "zlib", checksum_algo=integrity.ALGO_CRC32))
    frame[9] ^= 1
    with pytest.raises(integrity.BlockCorruptionError, match="crc32 mismatch"):
        IC.decompress_frame(bytes(frame))
    frame[-5] = 0  # the trailer's algo byte: itself corruption
    with pytest.raises(integrity.BlockCorruptionError, match="algo byte"):
        list(IC.iter_blob_frames(bytes(frame)))


def test_broadcast_blobs_read_both_ways():
    tb, jb = _both_batches(120, seed=9)
    blob = collect_blob([tb, tb])
    assert blob == jax_collect_blob([jb, jb], "test")
    payloads = list(JIC.iter_blob_frames(blob))
    assert len(payloads) == 2
    RESOURCES.put("broadcast_t.0", [blob])
    got = next(IpcReaderExec(tb.schema, "broadcast_t", 1, "cpu").execute(0, TaskContext(0)))
    want = TB.batch_to_pydict(tb)
    assert TB.batch_to_pydict(got) == {k: v + v for k, v in want.items()}
    truncated = blob[:IC.frame_span(blob, 0)[3]] + blob[IC.frame_span(blob, IC.frame_span(blob, 0)[3])[3]:]
    with pytest.raises(integrity.BlockCorruptionError, match="frame count"):
        list(IC.iter_blob_frames(truncated))
