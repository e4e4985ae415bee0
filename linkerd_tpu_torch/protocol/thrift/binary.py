"""TBinaryProtocol struct serialization with a declarative struct DSL.

The reference's thrift surfaces (namerd's long-poll interface, the ping
router IDL) are generated by scrooge from .thrift files; here — matching
this repo's proto-DSL approach for gRPC (grpc/proto.py) — structs declare
a ``FIELDS`` table and this module provides wire-compatible
TBinaryProtocol encode/decode. Ref: the namer IDL at
/root/reference/namerd/iface/interpreter-thrift-idl/src/main/thrift/namer.thrift
and thrift's binary protocol spec (strict framing is handled by codec.py).

Type names accepted in FIELDS:
  bool, byte, i16, i32, i64, double, string, binary,
  ("struct", cls), ("list", itemtype), ("set", itemtype),
  ("map", keytype, valtype)
where itemtype/keytype/valtype recurse. Unions are TStructs with
exactly one field set (enforced by the union flag).

A copy of ``linkerd_tpu/protocol/thrift/binary.py``.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Optional, Tuple

# thrift binary protocol type ids
T_STOP = 0
T_BOOL = 2
T_BYTE = 3
T_DOUBLE = 4
T_I16 = 6
T_I32 = 8
T_I64 = 10
T_STRING = 11  # also binary
T_STRUCT = 12
T_MAP = 13
T_SET = 14
T_LIST = 15


class ThriftProtocolError(Exception):
    pass


def _type_id(t: Any) -> int:
    if isinstance(t, tuple):
        kind = t[0]
        return {"struct": T_STRUCT, "list": T_LIST, "set": T_SET,
                "map": T_MAP}[kind]
    return {"bool": T_BOOL, "byte": T_BYTE, "i16": T_I16, "i32": T_I32,
            "i64": T_I64, "double": T_DOUBLE, "string": T_STRING,
            "binary": T_STRING}[t]


class Writer:
    def __init__(self) -> None:
        self._parts: List[bytes] = []

    def bytes(self) -> bytes:
        return b"".join(self._parts)

    def write(self, b: bytes) -> None:
        self._parts.append(b)

    def write_value(self, t: Any, v: Any) -> None:
        if isinstance(t, tuple):
            kind = t[0]
            if kind == "struct":
                write_struct(self, v)
            elif kind in ("list", "set"):
                items = list(v)
                self.write(struct.pack(">bi", _type_id(t[1]), len(items)))
                for item in items:
                    self.write_value(t[1], item)
            elif kind == "map":
                items = list(v.items())
                self.write(struct.pack(
                    ">bbi", _type_id(t[1]), _type_id(t[2]), len(items)))
                for k, val in items:
                    self.write_value(t[1], k)
                    self.write_value(t[2], val)
            else:
                raise ThriftProtocolError(f"unknown compound {kind}")
            return
        if t == "bool":
            self.write(b"\x01" if v else b"\x00")
        elif t == "byte":
            self.write(struct.pack(">b", v))
        elif t == "i16":
            self.write(struct.pack(">h", v))
        elif t == "i32":
            self.write(struct.pack(">i", v))
        elif t == "i64":
            self.write(struct.pack(">q", v))
        elif t == "double":
            self.write(struct.pack(">d", v))
        elif t == "string":
            b = v.encode("utf-8") if isinstance(v, str) else bytes(v)
            self.write(struct.pack(">i", len(b)) + b)
        elif t == "binary":
            b = bytes(v)
            self.write(struct.pack(">i", len(b)) + b)
        else:
            raise ThriftProtocolError(f"unknown type {t}")


class Reader:
    def __init__(self, buf: bytes, pos: int = 0):
        self.buf = buf
        self.pos = pos

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.buf):
            raise ThriftProtocolError("truncated thrift payload")
        b = self.buf[self.pos:self.pos + n]
        self.pos += n
        return b

    def read_value(self, t: Any) -> Any:
        if isinstance(t, tuple):
            kind = t[0]
            if kind == "struct":
                return read_struct(self, t[1])
            if kind in ("list", "set"):
                tid, n = struct.unpack(">bi", self.take(5))
                if n < 0:
                    raise ThriftProtocolError("negative container size")
                exp = _type_id(t[1])
                if tid != exp:
                    # tolerate item-type mismatches: skip the items and
                    # yield an empty container
                    for _ in range(n):
                        self._skip(tid)
                    return []
                out = [self.read_value(t[1]) for _ in range(n)]
                return set(out) if kind == "set" and all(
                    isinstance(x, (str, bytes, int, float, tuple))
                    for x in out) else out
            if kind == "map":
                ktid, vtid, n = struct.unpack(">bbi", self.take(6))
                if n < 0:
                    raise ThriftProtocolError("negative map size")
                out = {}
                for _ in range(n):
                    k = self.read_value(t[1])
                    v = self.read_value(t[2])
                    out[k] = v
                return out
            raise ThriftProtocolError(f"unknown compound {kind}")
        if t == "bool":
            return self.take(1) != b"\x00"
        if t == "byte":
            return struct.unpack(">b", self.take(1))[0]
        if t == "i16":
            return struct.unpack(">h", self.take(2))[0]
        if t == "i32":
            return struct.unpack(">i", self.take(4))[0]
        if t == "i64":
            return struct.unpack(">q", self.take(8))[0]
        if t == "double":
            return struct.unpack(">d", self.take(8))[0]
        if t in ("string", "binary"):
            (n,) = struct.unpack(">i", self.take(4))
            if n < 0:
                raise ThriftProtocolError("negative string size")
            b = self.take(n)
            return b.decode("utf-8", "replace") if t == "string" else b
        raise ThriftProtocolError(f"unknown type {t}")

    def _skip(self, tid: int) -> None:
        if tid == T_BOOL or tid == T_BYTE:
            self.take(1)
        elif tid == T_I16:
            self.take(2)
        elif tid == T_I32:
            self.take(4)
        elif tid in (T_I64, T_DOUBLE):
            self.take(8)
        elif tid == T_STRING:
            (n,) = struct.unpack(">i", self.take(4))
            self.take(max(0, n))
        elif tid == T_STRUCT:
            while True:
                ftid = struct.unpack(">b", self.take(1))[0]
                if ftid == T_STOP:
                    return
                self.take(2)  # field id
                self._skip(ftid)
        elif tid in (T_LIST, T_SET):
            itid, n = struct.unpack(">bi", self.take(5))
            for _ in range(max(0, n)):
                self._skip(itid)
        elif tid == T_MAP:
            ktid, vtid, n = struct.unpack(">bbi", self.take(6))
            for _ in range(max(0, n)):
                self._skip(ktid)
                self._skip(vtid)
        else:
            raise ThriftProtocolError(f"cannot skip type {tid}")


class TStruct:
    """Declarative thrift struct: subclasses define
    ``FIELDS = {name: (field_id, type)}`` (see module docstring for
    types). Unset fields serialize as absent; unions set UNION=True."""

    FIELDS: Dict[str, Tuple[int, Any]] = {}
    UNION = False

    def __init__(self, **kw: Any) -> None:
        for name in self.FIELDS:
            setattr(self, name, kw.pop(name, None))
        if kw:
            raise TypeError(f"unknown fields {sorted(kw)} "
                            f"for {type(self).__name__}")
        if self.UNION:
            set_ = [n for n in self.FIELDS if getattr(self, n) is not None]
            if len(set_) > 1:
                raise TypeError(
                    f"union {type(self).__name__} with {set_} set")

    def __repr__(self) -> str:
        kv = ", ".join(f"{n}={getattr(self, n)!r}" for n in self.FIELDS
                       if getattr(self, n) is not None)
        return f"{type(self).__name__}({kv})"

    def __eq__(self, other: Any) -> bool:
        return (type(other) is type(self) and
                all(getattr(self, n) == getattr(other, n)
                    for n in self.FIELDS))

    def union_field(self) -> Optional[str]:
        for n in self.FIELDS:
            if getattr(self, n) is not None:
                return n
        return None


def write_struct(w: Writer, s: TStruct) -> None:
    for name, (fid, t) in s.FIELDS.items():
        v = getattr(s, name)
        if v is None:
            continue
        w.write(struct.pack(">bh", _type_id(t), fid))
        w.write_value(t, v)
    w.write(b"\x00")  # T_STOP


def read_struct(r: Reader, cls: type) -> TStruct:
    by_id = {fid: (name, t) for name, (fid, t) in cls.FIELDS.items()}
    out = cls()
    while True:
        tid = struct.unpack(">b", r.take(1))[0]
        if tid == T_STOP:
            return out
        (fid,) = struct.unpack(">h", r.take(2))
        hit = by_id.get(fid)
        if hit is None or _type_id(hit[1]) != tid:
            r._skip(tid)  # unknown/mistyped field: skip for compat
            continue
        setattr(out, hit[0], r.read_value(hit[1]))


def encode_struct(s: TStruct) -> bytes:
    w = Writer()
    write_struct(w, s)
    return w.bytes()


def decode_struct(cls: type, buf: bytes, pos: int = 0) -> TStruct:
    return read_struct(Reader(buf, pos), cls)


# ---- call/reply payloads (framing + message header live in codec.py) ------

def header_len(payload: bytes) -> int:
    """Byte length of the message header (strict or legacy encoding) —
    the single place the offset math lives; codec.parse_message_header
    yields the parsed fields."""
    (first,) = struct.unpack(">i", payload[:4])
    if first < 0:  # strict: version word, len-prefixed name, seqid
        (nlen,) = struct.unpack(">I", payload[4:8])
        return 12 + nlen
    return 9 + first  # legacy: len-prefixed name, type byte, seqid


def encode_call(name: str, seqid: int, req: TStruct,
                version_call_word: int) -> bytes:
    """A strict CALL message whose args struct has the request at
    field 1 (thrift's generated-service convention)."""
    nb = name.encode("utf-8")
    out = struct.pack(">I", version_call_word & 0xFFFFFFFF)
    out += struct.pack(">I", len(nb)) + nb
    out += struct.pack(">i", seqid)
    w = Writer()
    w.write(struct.pack(">bh", T_STRUCT, 1))
    write_struct(w, req)
    w.write(b"\x00")
    return out + w.bytes()


def decode_call_reply(payload: bytes, success_cls: type,
                      exception_cls: Optional[type] = None) -> Any:
    """Decode a REPLY payload's result struct: field 0 = success,
    field 1 = the method's declared exception (raised)."""
    r = Reader(payload, header_len(payload))
    while True:
        tid = struct.unpack(">b", r.take(1))[0]
        if tid == T_STOP:
            raise ThriftProtocolError("thrift reply with no result")
        (fid,) = struct.unpack(">h", r.take(2))
        if fid == 0:
            return r.read_value(("struct", success_cls))
        if fid == 1 and exception_cls is not None:
            raise ThriftApplicationError(
                r.read_value(("struct", exception_cls)))
        r._skip(tid)


class ThriftApplicationError(Exception):
    """A declared thrift exception, carrying the decoded struct."""

    def __init__(self, payload: TStruct):
        super().__init__(repr(payload))
        self.payload = payload
