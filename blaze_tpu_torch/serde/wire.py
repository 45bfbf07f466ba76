"""A proto3 wire codec for the plan contract, without ``google.protobuf``.

The message layout comes from one source, ``plan.proto`` beside this
file (a byte-identical copy of the reference's contract), parsed at
import into :data:`MESSAGES` and :data:`ENUMS`.  Every message becomes a
small class of this module (``wire.TaskDefinition``,
``wire.PhysicalPlanNode``, ...) with attribute access, ``add()`` on
repeated message fields and :meth:`Message.which_oneof`.

Encoding writes fields in field-number order, as the reference's
serializer does, so a message decoded from the reference's bytes
encodes back to the same bytes.  Proto3 presence: a scalar outside a
``oneof`` is written only when it differs from its default; a ``oneof``
member and a sub-message are written whenever they are set, even to a
default value or an empty message.  Repeated scalars are packed.
Decoding skips fields the table does not know.

The port speaks the wire format itself because the machine that runs
it on the card has no ``protobuf`` package; the tests hold these bytes
against the reference's generated ``plan_pb2``.
"""

from __future__ import annotations

import enum
import re
import struct
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

PROTO_PATH = Path(__file__).with_name("plan.proto")

# scalar type -> wire type; "message" and "enum" are resolved per field
_WIRE_TYPE = {
    "int64": 0, "uint64": 0, "int32": 0, "uint32": 0, "bool": 0, "enum": 0,
    "double": 1, "string": 2, "bytes": 2, "message": 2,
}
_PACKABLE = {"int64", "uint64", "int32", "uint32", "bool", "enum", "double"}
_DEFAULTS = {"int64": 0, "uint64": 0, "int32": 0, "uint32": 0, "bool": False, "enum": 0,
             "double": 0.0, "string": "", "bytes": b""}
_U64 = (1 << 64) - 1


@dataclass(frozen=True)
class FieldSpec:
    """One field of a message: ``type`` is a scalar type name,
    ``"message"`` or ``"enum"``; ``type_name`` names the message or enum
    (nested names dotted, without the package)."""

    name: str
    number: int
    type: str
    repeated: bool
    oneof: Optional[str]
    type_name: Optional[str]


@dataclass(frozen=True)
class MessageSpec:
    name: str
    fields: Tuple[FieldSpec, ...]  # in field-number order
    oneofs: Dict[str, Tuple[str, ...]]

    def field(self, name: str) -> FieldSpec:
        for f in self.fields:
            if f.name == name:
                return f
        raise AttributeError(f"{self.name} has no field {name!r}")


# ------------------------------------------------------------ .proto parse

_TOKEN = re.compile(r'"[^"]*"|[A-Za-z_][A-Za-z0-9_.]*|-?\d+|[{}=;<>,\[\]()]')


def parse_proto(text: str) -> Tuple[Dict[str, MessageSpec], Dict[str, Dict[str, int]]]:
    """(messages, enums) of a proto3 file, keyed by dotted names
    without the package.  Covers what ``plan.proto`` uses: messages,
    nested messages and enums, ``oneof``, ``repeated`` and scalars."""
    text = re.sub(r"//[^\n]*", "", text)
    toks = _TOKEN.findall(text)
    pos = 0
    raw_fields: Dict[str, List[tuple]] = {}
    enums: Dict[str, Dict[str, int]] = {}

    def take(expect: Optional[str] = None) -> str:
        nonlocal pos
        t = toks[pos]
        pos += 1
        if expect is not None and t != expect:
            raise ValueError(f"plan.proto: expected {expect!r}, got {t!r} (token {pos})")
        return t

    def parse_enum(scope: str) -> None:
        name = f"{scope}{take()}"
        take("{")
        values: Dict[str, int] = {}
        while toks[pos] != "}":
            key = take()
            take("=")
            values[key] = int(take())
            take(";")
        take("}")
        enums[name] = values

    def parse_field(msg: str, oneof: Optional[str], repeated: bool) -> None:
        ftype, fname = take(), take()
        take("=")
        raw_fields[msg].append((fname, int(take()), ftype, repeated, oneof))
        take(";")

    def parse_message(scope: str) -> None:
        name = f"{scope}{take()}"
        raw_fields[name] = []
        take("{")
        while toks[pos] != "}":
            t = toks[pos]
            if t == "message":
                take()
                parse_message(name + ".")
            elif t == "enum":
                take()
                parse_enum(name + ".")
            elif t == "oneof":
                take()
                group = take()
                take("{")
                while toks[pos] != "}":
                    parse_field(name, group, False)
                take("}")
            elif t == "repeated":
                take()
                parse_field(name, None, True)
            else:
                parse_field(name, None, False)
        take("}")

    while pos < len(toks):
        t = take()
        if t in ("syntax", "package"):
            while take() != ";":
                pass
        elif t == "enum":
            parse_enum("")
        elif t == "message":
            parse_message("")
        else:
            raise ValueError(f"plan.proto: unexpected {t!r}")

    def resolve(msg: str, tname: str) -> Tuple[str, Optional[str]]:
        if tname in _DEFAULTS:
            return tname, None
        scope = msg
        while True:
            full = f"{scope}.{tname}" if scope else tname
            if full in raw_fields:
                return "message", full
            if full in enums:
                return "enum", full
            if not scope:
                raise ValueError(f"plan.proto: unknown type {tname!r} in {msg}")
            scope = scope.rpartition(".")[0]

    messages: Dict[str, MessageSpec] = {}
    for msg, fields in raw_fields.items():
        specs = []
        oneofs: Dict[str, List[str]] = {}
        for fname, number, ftype, repeated, oneof in fields:
            kind, tname = resolve(msg, ftype)
            specs.append(FieldSpec(fname, number, kind, repeated, oneof, tname))
            if oneof is not None:
                oneofs.setdefault(oneof, []).append(fname)
        messages[msg] = MessageSpec(msg, tuple(sorted(specs, key=lambda f: f.number)),
                                    {k: tuple(v) for k, v in oneofs.items()})
    return messages, enums


MESSAGES, ENUMS = parse_proto(PROTO_PATH.read_text())


# ---------------------------------------------------------------- messages


class RepeatedField(list):
    """A repeated field's values; ``add(**fields)`` appends a new
    element of a repeated message field and returns it."""

    def __init__(self, spec: FieldSpec, values: Iterable = ()):
        super().__init__(values)
        self._spec = spec

    def add(self, **fields) -> "Message":
        if self._spec.type != "message":
            raise TypeError(f"add() on repeated {self._spec.type} field {self._spec.name}")
        m = CLASSES[self._spec.type_name](**fields)
        self.append(m)
        return m


class Message:
    """Base of the generated message classes.  Unset fields read as
    their defaults (a fresh empty message for a message field, not
    attached to this one); set a sub-message by assigning it."""

    _spec: MessageSpec

    def __init__(self, **fields):
        object.__setattr__(self, "_values", {})
        object.__setattr__(self, "_cases", {})
        for k, v in fields.items():
            setattr(self, k, v)

    def __getattr__(self, name: str):
        f = self._spec.field(name)
        values = self._values
        if name in values:
            return values[name]
        if f.repeated:
            values[name] = RepeatedField(f)
            return values[name]
        if f.type == "message":
            return CLASSES[f.type_name]()
        return _DEFAULTS[f.type]

    def __setattr__(self, name: str, value) -> None:
        f = self._spec.field(name)
        if f.repeated:
            value = RepeatedField(f, value)
        elif f.type == "message":
            if not isinstance(value, CLASSES[f.type_name]):
                raise TypeError(f"{self._spec.name}.{name} takes a {f.type_name}, not {type(value).__name__}")
        elif f.type in ("string", "bytes"):
            value = str(value) if f.type == "string" else bytes(value)
        elif f.type == "double":
            value = float(value)
        elif f.type == "bool":
            value = bool(value)
        else:
            value = int(value)
        if f.oneof is not None:
            prev = self._cases.get(f.oneof)
            if prev is not None and prev != name:
                del self._values[prev]
            self._cases[f.oneof] = name
        self._values[name] = value

    def which_oneof(self, group: str) -> Optional[str]:
        """The name of the set member of ``oneof`` group, or None."""
        if group not in self._spec.oneofs:
            raise ValueError(f"{self._spec.name} has no oneof {group!r}")
        return self._cases.get(group)

    def has_field(self, name: str) -> bool:
        """Whether a message field or ``oneof`` member is set."""
        f = self._spec.field(name)
        if f.repeated or (f.type != "message" and f.oneof is None):
            raise ValueError(f"{self._spec.name}.{name} has no presence")
        return name in self._values

    def encode(self) -> bytes:
        out = bytearray()
        _encode(self, out)
        return bytes(out)

    @classmethod
    def decode(cls, data: bytes) -> "Message":
        m = cls()
        _decode_into(m, memoryview(data))
        return m

    def __eq__(self, other) -> bool:
        return type(other) is type(self) and other.encode() == self.encode()

    __hash__ = None  # mutable

    def __repr__(self) -> str:
        inner = ", ".join(f"{k}={v!r}" for k, v in self._values.items())
        return f"{self._spec.name}({inner})"


def _varint(v: int, out: bytearray) -> None:
    v &= _U64
    while v > 0x7F:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)


def _scalar_bytes(ftype: str, v, out: bytearray) -> None:
    if ftype == "double":
        out += struct.pack("<d", v)
    elif ftype in ("string", "bytes"):
        b = v.encode("utf-8") if ftype == "string" else v
        _varint(len(b), out)
        out += b
    else:
        _varint(int(v), out)


def _is_default(ftype: str, v) -> bool:
    if ftype == "double":
        return struct.pack("<d", v) == bytes(8)  # -0.0 is written
    return v == _DEFAULTS[ftype]


def _encode(msg: Message, out: bytearray) -> None:
    values, cases = msg._values, msg._cases
    for f in msg._spec.fields:
        if f.name not in values:
            continue
        v = values[f.name]
        if f.repeated:
            if not v:
                continue
            if f.type in _PACKABLE:
                _varint((f.number << 3) | 2, out)
                body = bytearray()
                for x in v:
                    _scalar_bytes(f.type, x, body)
                _varint(len(body), out)
                out += body
                continue
            for x in v:
                _encode_one(f, x, out)
            continue
        if f.oneof is None and f.type != "message" and _is_default(f.type, v):
            continue
        if f.oneof is not None and cases.get(f.oneof) != f.name:
            continue
        _encode_one(f, v, out)


def _encode_one(f: FieldSpec, v, out: bytearray) -> None:
    _varint((f.number << 3) | _WIRE_TYPE[f.type], out)
    if f.type == "message":
        body = v.encode()
        _varint(len(body), out)
        out += body
    else:
        _scalar_bytes(f.type, v, out)


def _read_varint(buf: memoryview, pos: int) -> Tuple[int, int]:
    shift = result = 0
    while True:
        if pos >= len(buf):
            raise ValueError("truncated varint")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result & _U64, pos
        shift += 7
        if shift >= 70:
            raise ValueError("varint longer than 10 bytes")


def _from_varint(ftype: str, v: int):
    if ftype == "int64":
        return v - (1 << 64) if v >> 63 else v
    if ftype in ("int32", "enum"):
        v &= 0xFFFFFFFF
        return v - (1 << 32) if v >> 31 else v
    if ftype == "uint32":
        return v & 0xFFFFFFFF
    if ftype == "bool":
        return v != 0
    return v


def _read_scalar(ftype: str, buf: memoryview, pos: int):
    if ftype == "double":
        if pos + 8 > len(buf):
            raise ValueError("truncated double")
        return struct.unpack_from("<d", buf, pos)[0], pos + 8
    if ftype in ("string", "bytes"):
        n, pos = _read_varint(buf, pos)
        if pos + n > len(buf):
            raise ValueError("truncated length-delimited field")
        raw = bytes(buf[pos:pos + n])
        return (raw.decode("utf-8") if ftype == "string" else raw), pos + n
    v, pos = _read_varint(buf, pos)
    return _from_varint(ftype, v), pos


def _skip(wt: int, buf: memoryview, pos: int) -> int:
    if wt == 0:
        return _read_varint(buf, pos)[1]
    if wt == 1:
        return pos + 8
    if wt == 2:
        n, pos = _read_varint(buf, pos)
        return pos + n
    if wt == 5:
        return pos + 4
    raise ValueError(f"unsupported wire type {wt}")


def _decode_into(msg: Message, buf: memoryview) -> None:
    spec = msg._spec
    by_number = {f.number: f for f in spec.fields}
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        number, wt = tag >> 3, tag & 7
        f = by_number.get(number)
        if f is None:
            pos = _skip(wt, buf, pos)
            if pos > len(buf):
                raise ValueError("truncated unknown field")
            continue
        if f.repeated and f.type in _PACKABLE and wt == 2:
            n, pos = _read_varint(buf, pos)
            end = pos + n
            if end > len(buf):
                raise ValueError("truncated packed field")
            items = getattr(msg, f.name)
            while pos < end:
                v, pos = _read_scalar(f.type, buf, pos)
                items.append(v)
            continue
        if wt != _WIRE_TYPE[f.type]:
            raise ValueError(f"{spec.name}.{f.name}: wire type {wt}, expected {_WIRE_TYPE[f.type]}")
        if f.type == "message":
            n, pos = _read_varint(buf, pos)
            if pos + n > len(buf):
                raise ValueError("truncated message field")
            sub = buf[pos:pos + n]
            pos += n
            if f.repeated:
                getattr(msg, f.name).append(CLASSES[f.type_name].decode(sub))
            elif msg.has_field(f.name):
                _decode_into(msg._values[f.name], sub)  # a repeated occurrence merges
            else:
                setattr(msg, f.name, CLASSES[f.type_name].decode(sub))
            continue
        v, pos = _read_scalar(f.type, buf, pos)
        if f.repeated:
            getattr(msg, f.name).append(v)
        else:
            setattr(msg, f.name, v)


# ------------------------------------------------------- generated classes

CLASSES: Dict[str, type] = {}
for _name, _spec in MESSAGES.items():
    CLASSES[_name] = type(_name.rpartition(".")[2], (Message,), {"_spec": _spec, "__slots__": ()})
for _name, _values in ENUMS.items():
    _scope, _, _short = _name.rpartition(".")
    _enum = enum.IntEnum(_short, _values)
    if _scope:
        # a nested enum: the type and its values on the message class,
        # as the generated protobuf classes have them
        setattr(CLASSES[_scope], _short, _enum)
        for _k, _v in _values.items():
            setattr(CLASSES[_scope], _k, _v)
    else:
        globals()[_short] = _enum
for _name, _cls in CLASSES.items():
    if "." not in _name:
        globals()[_name] = _cls
