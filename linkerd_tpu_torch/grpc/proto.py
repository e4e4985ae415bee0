"""Protobuf wire-format codec with a declarative message DSL.

The reference generates Scala case classes + codecs from .proto via its own
protoc plugin (ref: grpc/gen/src/main/scala/io/buoyant/grpc/gen/Generator.scala:73-794).
Python needs no codegen: a message is a class with a ``FIELDS`` table; this
module supplies proto3-semantics encode/decode over the standard wire format
(varint / 64-bit / len-delimited / 32-bit), so our messages interoperate with
any protobuf peer (e.g. the reference's mesh API,
mesh/core/src/main/protobuf/interpreter.proto).
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Optional, Tuple, Type

# wire types
_VARINT, _I64, _LEN, _I32 = 0, 1, 2, 5

_SCALAR_WIRE = {
    "int32": _VARINT, "int64": _VARINT, "uint32": _VARINT, "uint64": _VARINT,
    "sint32": _VARINT, "sint64": _VARINT, "bool": _VARINT, "enum": _VARINT,
    "fixed64": _I64, "sfixed64": _I64, "double": _I64,
    "fixed32": _I32, "sfixed32": _I32, "float": _I32,
    "string": _LEN, "bytes": _LEN, "message": _LEN,
}


def encode_varint(value: int) -> bytes:
    if value < 0:  # proto int32/int64 negatives are 10-byte twos-complement
        value &= (1 << 64) - 1
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def decode_varint(data: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        if pos >= len(data):
            raise ValueError("truncated varint")
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 70:
            raise ValueError("varint too long")


def _zigzag(v: int) -> int:
    return (v << 1) ^ (v >> 63)


def _unzigzag(v: int) -> int:
    return (v >> 1) ^ -(v & 1)


def _to_signed(v: int, bits: int) -> int:
    if v >= 1 << (bits - 1):
        v -= 1 << bits
    return v


class Field:
    """One field descriptor: wire number, scalar kind, optional nesting."""

    __slots__ = ("number", "kind", "message", "repeated", "packed", "default")

    def __init__(self, number: int, kind: str,
                 message: Optional[type] = None,
                 repeated: bool = False,
                 packed: Optional[bool] = None,
                 default: Any = None):
        if kind not in _SCALAR_WIRE:
            raise ValueError(f"unknown field kind {kind!r}")
        if kind == "message" and message is None:
            raise ValueError("message fields need a message class")
        self.number = number
        self.kind = kind
        self.message = message
        self.repeated = repeated
        # proto3 packs repeated numeric scalars by default
        if packed is None:
            packed = repeated and _SCALAR_WIRE[kind] != _LEN
        self.packed = packed
        if default is None:
            default = [] if repeated else _PROTO_DEFAULTS.get(kind)
        self.default = default


_PROTO_DEFAULTS: Dict[str, Any] = {
    "int32": 0, "int64": 0, "uint32": 0, "uint64": 0, "sint32": 0,
    "sint64": 0, "bool": False, "enum": 0, "fixed64": 0, "sfixed64": 0,
    "double": 0.0, "fixed32": 0, "sfixed32": 0, "float": 0.0,
    "string": "", "bytes": b"", "message": None,
}


class MapField:
    """A proto3 ``map<K, V>`` field: a dict on the message, encoded as
    repeated entry submessages {1: key, 2: value} per the spec."""

    __slots__ = ("number", "key_kind", "val_kind", "val_message")

    def __init__(self, number: int, key_kind: str, val_kind: str,
                 val_message: Optional[type] = None):
        if key_kind not in _SCALAR_WIRE or key_kind in ("message", "bytes",
                                                        "float", "double"):
            raise ValueError(f"invalid map key kind {key_kind!r}")
        if val_kind not in _SCALAR_WIRE:
            raise ValueError(f"unknown map value kind {val_kind!r}")
        if val_kind == "message" and val_message is None:
            raise ValueError("message-valued maps need a message class")
        self.number = number
        self.key_kind = key_kind
        self.val_kind = val_kind
        self.val_message = val_message

    def encode_entries(self, d: Dict[Any, Any]) -> bytes:
        out = bytearray()
        tag = encode_varint((self.number << 3) | _LEN)
        ktag = encode_varint((1 << 3) | _SCALAR_WIRE[self.key_kind])
        vtag = encode_varint((2 << 3) | _SCALAR_WIRE[self.val_kind])
        for k, v in d.items():
            payload = ktag + _encode_scalar(self.key_kind, k)
            if not (self.val_kind != "message" and
                    v == _PROTO_DEFAULTS.get(self.val_kind)):
                payload += vtag + _encode_scalar(self.val_kind, v)
            out += tag
            out += encode_varint(len(payload))
            out += payload
        return bytes(out)

    def decode_entry(self, chunk: bytes) -> Tuple[Any, Any]:
        key = _PROTO_DEFAULTS.get(self.key_kind)
        val = (self.val_message() if self.val_kind == "message"
               else _PROTO_DEFAULTS.get(self.val_kind))
        pos = 0
        while pos < len(chunk):
            k, pos = decode_varint(chunk, pos)
            number, wire = k >> 3, k & 0x7
            if number == 1:
                key, pos = _decode_scalar(self.key_kind, None, chunk, pos,
                                          wire)
            elif number == 2:
                val, pos = _decode_scalar(self.val_kind, self.val_message,
                                          chunk, pos, wire)
            else:
                pos = _skip(chunk, pos, wire)
        return key, val


def _encode_scalar(kind: str, value: Any) -> bytes:
    if kind in ("int32", "int64", "uint32", "uint64", "enum"):
        return encode_varint(int(value))
    if kind in ("sint32", "sint64"):
        return encode_varint(_zigzag(int(value)))
    if kind == "bool":
        return encode_varint(1 if value else 0)
    if kind in ("fixed64", "sfixed64"):
        return struct.pack("<q" if kind == "sfixed64" else "<Q", int(value))
    if kind == "double":
        return struct.pack("<d", float(value))
    if kind in ("fixed32", "sfixed32"):
        return struct.pack("<i" if kind == "sfixed32" else "<I", int(value))
    if kind == "float":
        return struct.pack("<f", float(value))
    if kind == "string":
        b = value.encode("utf-8")
        return encode_varint(len(b)) + b
    if kind == "bytes":
        b = bytes(value)
        return encode_varint(len(b)) + b
    if kind == "message":
        b = value.encode()
        return encode_varint(len(b)) + b
    raise AssertionError(kind)


def _decode_scalar(kind: str, message: Optional[type],
                   data: bytes, pos: int, wire: int) -> Tuple[Any, int]:
    if wire == _VARINT:
        raw, pos = decode_varint(data, pos)
        if kind in ("sint32", "sint64"):
            return _unzigzag(raw), pos
        if kind == "bool":
            return bool(raw), pos
        if kind == "int32":
            return _to_signed(raw & 0xFFFFFFFFFFFFFFFF, 64), pos
        if kind == "int64":
            return _to_signed(raw, 64), pos
        return raw, pos
    if wire == _I64:
        chunk = data[pos:pos + 8]
        pos += 8
        if kind == "double":
            return struct.unpack("<d", chunk)[0], pos
        if kind == "sfixed64":
            return struct.unpack("<q", chunk)[0], pos
        return struct.unpack("<Q", chunk)[0], pos
    if wire == _I32:
        chunk = data[pos:pos + 4]
        pos += 4
        if kind == "float":
            return struct.unpack("<f", chunk)[0], pos
        if kind == "sfixed32":
            return struct.unpack("<i", chunk)[0], pos
        return struct.unpack("<I", chunk)[0], pos
    if wire == _LEN:
        ln, pos = decode_varint(data, pos)
        chunk = data[pos:pos + ln]
        if len(chunk) != ln:
            raise ValueError("truncated length-delimited field")
        pos += ln
        if kind == "string":
            return chunk.decode("utf-8"), pos
        if kind == "bytes":
            return chunk, pos
        if kind == "message":
            return message.decode(chunk), pos
        raise ValueError(f"{kind} cannot be length-delimited")
    raise ValueError(f"unsupported wire type {wire}")


def _skip(data: bytes, pos: int, wire: int) -> int:
    if wire == _VARINT:
        _, pos = decode_varint(data, pos)
        return pos
    if wire == _I64:
        return pos + 8
    if wire == _I32:
        return pos + 4
    if wire == _LEN:
        ln, pos = decode_varint(data, pos)
        return pos + ln
    raise ValueError(f"cannot skip wire type {wire}")


class ProtoMessage:
    """Base class; subclasses declare ``FIELDS: Dict[str, Field]``."""

    FIELDS: Dict[str, Field] = {}

    def __init__(self, **kwargs: Any):
        for name, fd in self.FIELDS.items():
            if name in kwargs:
                v = kwargs.pop(name)
            elif isinstance(fd, MapField):
                v = {}
            elif fd.repeated:
                v = []
            else:
                v = fd.default
            setattr(self, name, v)
        if kwargs:
            raise TypeError(f"unknown fields {sorted(kwargs)} "
                            f"for {type(self).__name__}")

    def encode(self) -> bytes:
        out = bytearray()
        for name, fd in self.FIELDS.items():
            value = getattr(self, name)
            if isinstance(fd, MapField):
                if value:
                    out += fd.encode_entries(value)
                continue
            wire = _SCALAR_WIRE[fd.kind]
            tag = encode_varint((fd.number << 3) | wire)
            if fd.repeated:
                if not value:
                    continue
                if fd.packed:
                    payload = b"".join(
                        _encode_scalar(fd.kind, v) for v in value)
                    out += encode_varint((fd.number << 3) | _LEN)
                    out += encode_varint(len(payload))
                    out += payload
                else:
                    for v in value:
                        out += tag
                        out += _encode_scalar(fd.kind, v)
            else:
                if value is None:
                    continue
                # proto3: zero-valued scalars are omitted (messages always
                # emitted when present/non-None so presence survives)
                if fd.kind != "message" and value == fd.default:
                    continue
                out += tag
                out += _encode_scalar(fd.kind, value)
        return bytes(out)

    @classmethod
    def decode(cls, data: bytes) -> "ProtoMessage":
        by_number = {fd.number: (name, fd) for name, fd in cls.FIELDS.items()}
        msg = cls()
        pos = 0
        while pos < len(data):
            key, pos = decode_varint(data, pos)
            number, wire = key >> 3, key & 0x7
            entry = by_number.get(number)
            if entry is None:
                pos = _skip(data, pos, wire)
                continue
            name, fd = entry
            if isinstance(fd, MapField):
                if wire != _LEN:
                    pos = _skip(data, pos, wire)
                    continue
                ln, pos = decode_varint(data, pos)
                chunk = data[pos:pos + ln]
                if len(chunk) != ln:
                    raise ValueError("truncated map entry")
                pos += ln
                k, v = fd.decode_entry(chunk)
                getattr(msg, name)[k] = v
                continue
            if fd.repeated and wire == _LEN and \
                    _SCALAR_WIRE[fd.kind] != _LEN:
                # packed numeric run
                ln, pos = decode_varint(data, pos)
                end = pos + ln
                vals = getattr(msg, name)
                while pos < end:
                    v, pos = _decode_scalar(
                        fd.kind, fd.message, data, pos, _SCALAR_WIRE[fd.kind])
                    vals.append(v)
                continue
            v, pos = _decode_scalar(fd.kind, fd.message, data, pos, wire)
            if fd.repeated:
                getattr(msg, name).append(v)
            else:
                setattr(msg, name, v)
        return msg

    def __eq__(self, other: Any) -> bool:
        if type(other) is not type(self):
            return NotImplemented
        return all(getattr(self, n) == getattr(other, n) for n in self.FIELDS)

    def __repr__(self) -> str:
        parts = []
        for name, fd in self.FIELDS.items():
            v = getattr(self, name)
            if v is None or (isinstance(fd, MapField) and not v) or (
                    not isinstance(fd, MapField) and fd.repeated and not v):
                continue
            parts.append(f"{name}={v!r}")
        return f"{type(self).__name__}({', '.join(parts)})"


class Enum:
    """Namespace helper for proto enums: class attrs are int values."""

    @classmethod
    def name_of(cls, value: int) -> str:
        for k, v in vars(cls).items():
            if not k.startswith("_") and v == value:
                return k
        return str(value)
