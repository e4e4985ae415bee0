"""Thrift transports + protocol message headers.

Framed transport: 4-byte big-endian length prefix per message. Buffered
(unframed) transport: no prefix — message boundaries come from skipping
the TBinaryProtocol struct (ref: ThriftInitializer.scala:68-72
``thriftFramed: false``).

TBinaryProtocol (strict) message header: i32 (VERSION_1 | type),
len-prefixed name, i32 seqid. TCompactProtocol message header: 0x82,
(type<<5 | 1), varint seqid, varint name-len, name (ref:
ThriftInitializer.scala:47 ``thriftProtocol``). The proxy only needs the
header — payloads pass through opaque (ref: router/thrift treats args as
unparsed).

A copy of ``linkerd_tpu/protocol/thrift/codec.py``.
"""

from __future__ import annotations

import asyncio
import struct
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

VERSION_1 = 0x80010000
VERSION_MASK = 0xFFFF0000

CALL, REPLY, EXCEPTION, ONEWAY = 1, 2, 3, 4

MAX_FRAME = 16 * 1024 * 1024


class ThriftCodecError(Exception):
    pass


@dataclass
class ThriftCall:
    """One framed thrift message with its parsed header."""

    payload: bytes        # the full message (header + args)
    name: str
    seqid: int
    type: int
    ctx: Dict[str, object] = None  # type: ignore[assignment]

    def __post_init__(self):
        if self.ctx is None:
            self.ctx = {}

    @property
    def oneway(self) -> bool:
        return self.type == ONEWAY


def parse_message_header(payload: bytes) -> Tuple[str, int, int]:
    """-> (name, seqid, type). Supports strict and legacy encoding."""
    if len(payload) < 4:
        raise ThriftCodecError("message too short")
    first = struct.unpack(">i", payload[:4])[0]
    if first < 0:  # strict: version word
        # python's & on a negative int yields the positive masked value
        if (first & VERSION_MASK) != VERSION_1:
            raise ThriftCodecError(f"bad thrift version {first:#x}")
        mtype = first & 0xFF
        (nlen,) = struct.unpack(">I", payload[4:8])
        name = payload[8:8 + nlen].decode("utf-8")
        (seqid,) = struct.unpack(">i", payload[8 + nlen:12 + nlen])
        return name, seqid, mtype
    # legacy: len-prefixed name, byte type, i32 seqid
    nlen = first
    name = payload[4:4 + nlen].decode("utf-8")
    mtype = payload[4 + nlen]
    (seqid,) = struct.unpack(">i", payload[5 + nlen:9 + nlen])
    return name, seqid, mtype


def encode_exception(name: str, seqid: int, message: str) -> bytes:
    """A TApplicationException(INTERNAL_ERROR) reply frame."""
    nb = name.encode("utf-8")
    mb = message.encode("utf-8")
    out = struct.pack(">I", (VERSION_1 | EXCEPTION) & 0xFFFFFFFF)
    out += struct.pack(">I", len(nb)) + nb
    out += struct.pack(">i", seqid)
    # TApplicationException struct: field 1 message (string), field 2 type
    out += b"\x0b" + struct.pack(">hI", 1, len(mb)) + mb
    out += b"\x08" + struct.pack(">hi", 2, 6)  # INTERNAL_ERROR = 6
    out += b"\x00"  # stop
    return out


COMPACT_PROTOCOL_ID = 0x82
COMPACT_VERSION = 1


def _cvarint(v: int) -> bytes:
    out = bytearray()
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)
    return bytes(out)


def encode_exception_compact(name: str, seqid: int, message: str) -> bytes:
    """A TApplicationException(INTERNAL_ERROR) reply in TCompactProtocol
    (the binary-protocol encoder would desync compact clients)."""
    nb = name.encode("utf-8")
    mb = message.encode("utf-8")
    out = bytearray([COMPACT_PROTOCOL_ID,
                     (EXCEPTION << 5) | COMPACT_VERSION])
    out += _cvarint(seqid) + _cvarint(len(nb)) + nb
    # compact struct: field 1 message (BINARY=8), field 2 type (I32=5)
    out += bytes([(1 << 4) | 8]) + _cvarint(len(mb)) + mb
    out += bytes([(1 << 4) | 5]) + _cvarint(6 << 1)  # zigzag(6)=12
    out += b"\x00"  # stop
    return bytes(out)


def encode_exception_for(protocol: str, name: str, seqid: int,
                         message: str) -> bytes:
    if protocol == "compact":
        return encode_exception_compact(name, seqid, message)
    return encode_exception(name, seqid, message)


def parse_compact_header(payload: bytes) -> Tuple[str, int, int]:
    """TCompactProtocol message header -> (name, seqid, type)."""
    if len(payload) < 4 or payload[0] != COMPACT_PROTOCOL_ID:
        raise ThriftCodecError("not a compact-protocol message")
    if (payload[1] & 0x1F) != COMPACT_VERSION:
        raise ThriftCodecError(f"bad compact version {payload[1]:#x}")
    mtype = (payload[1] >> 5) & 0x7

    def varint(pos: int) -> Tuple[int, int]:
        shift = v = 0
        while True:
            if pos >= len(payload) or shift > 35:
                raise ThriftCodecError("truncated varint")
            b = payload[pos]
            pos += 1
            v |= (b & 0x7F) << shift
            shift += 7
            if not (b & 0x80):
                return v, pos

    seqid, pos = varint(2)
    nlen, pos = varint(pos)
    name = payload[pos:pos + nlen].decode("utf-8")
    return name, seqid, mtype


def parse_header(payload: bytes, protocol: str = "binary"
                 ) -> Tuple[str, int, int]:
    if protocol == "compact":
        return parse_compact_header(payload)
    return parse_message_header(payload)


# TBinaryProtocol wire type ids (TType)
_T_STOP, _T_BOOL, _T_BYTE, _T_DOUBLE = 0, 2, 3, 4
_T_I16, _T_I32, _T_I64, _T_STRING = 6, 8, 10, 11
_T_STRUCT, _T_MAP, _T_SET, _T_LIST = 12, 13, 14, 15
_FIXED = {_T_BOOL: 1, _T_BYTE: 1, _T_DOUBLE: 8, _T_I16: 2, _T_I32: 4,
          _T_I64: 8}


def _skip_value(b: bytes, pos: int, ttype: int, depth: int = 0) -> int:
    """Skip one TBinaryProtocol value; -> new pos. Raises IndexError when
    truncated (caller treats as 'need more bytes')."""
    if depth > 32:
        raise ThriftCodecError("thrift struct nested too deep")
    fixed = _FIXED.get(ttype)
    if fixed is not None:
        if pos + fixed > len(b):
            raise IndexError
        return pos + fixed
    if ttype == _T_STRING:
        if pos + 4 > len(b):
            raise IndexError
        (n,) = struct.unpack_from(">I", b, pos)
        if n > MAX_FRAME:
            raise ThriftCodecError("string too long")
        if pos + 4 + n > len(b):
            raise IndexError
        return pos + 4 + n
    if ttype == _T_STRUCT:
        while True:
            if pos >= len(b):
                raise IndexError
            ft = b[pos]
            pos += 1
            if ft == _T_STOP:
                return pos
            if pos + 2 > len(b):
                raise IndexError
            pos = _skip_value(b, pos + 2, ft, depth + 1)  # +2: field id
    if ttype == _T_MAP:
        if pos + 6 > len(b):
            raise IndexError
        kt, vt = b[pos], b[pos + 1]
        (n,) = struct.unpack_from(">I", b, pos + 2)
        if n > MAX_FRAME:
            raise ThriftCodecError("map too long")
        pos += 6
        for _ in range(n):
            pos = _skip_value(b, pos, kt, depth + 1)
            pos = _skip_value(b, pos, vt, depth + 1)
        return pos
    if ttype in (_T_SET, _T_LIST):
        if pos + 5 > len(b):
            raise IndexError
        et = b[pos]
        (n,) = struct.unpack_from(">I", b, pos + 1)
        if n > MAX_FRAME:
            raise ThriftCodecError("list too long")
        pos += 5
        for _ in range(n):
            pos = _skip_value(b, pos, et, depth + 1)
        return pos
    raise ThriftCodecError(f"unknown thrift type {ttype}")


def message_length(buf: bytes) -> Optional[int]:
    """Byte length of the complete TBinaryProtocol message at the head of
    ``buf`` (header + args struct), or None when more bytes are needed —
    the unframed (buffered) transport's message-boundary scan."""
    try:
        if len(buf) < 4:
            return None
        first = struct.unpack_from(">i", buf, 0)[0]
        if first < 0:  # strict
            if (first & VERSION_MASK) != VERSION_1:
                raise ThriftCodecError(f"bad thrift version {first:#x}")
            if len(buf) < 8:
                return None
            (nlen,) = struct.unpack_from(">I", buf, 4)
            pos = 8 + nlen + 4  # name + seqid
        else:  # legacy
            nlen = first
            pos = 4 + nlen + 1 + 4  # name + type byte + seqid
        if nlen > MAX_FRAME:
            raise ThriftCodecError("name too long")
        if pos > len(buf):
            return None
        return _skip_value(buf, pos, _T_STRUCT)
    except IndexError:
        return None


class UnframedReader:
    """Accumulates stream bytes and yields whole unframed messages."""

    def __init__(self, reader: asyncio.StreamReader):
        self._reader = reader
        self._buf = bytearray()

    async def read_message(self) -> Optional[bytes]:
        """One complete message; None on clean EOF at a boundary."""
        while True:
            n = message_length(bytes(self._buf))
            if n is not None:
                msg = bytes(self._buf[:n])
                del self._buf[:n]
                return msg
            if len(self._buf) > MAX_FRAME:
                raise ThriftCodecError("unframed message exceeds max")
            chunk = await self._reader.read(65536)
            if not chunk:
                if self._buf:
                    raise ThriftCodecError("EOF mid-message (unframed)")
                return None
            self._buf += chunk


async def read_framed(reader: asyncio.StreamReader) -> Optional[bytes]:
    """One framed message; None on clean EOF."""
    try:
        head = await reader.readexactly(4)
    except asyncio.IncompleteReadError:
        return None
    (n,) = struct.unpack(">I", head)
    if n > MAX_FRAME:
        raise ThriftCodecError(f"frame of {n} bytes exceeds max")
    return await reader.readexactly(n)


def write_framed(writer: asyncio.StreamWriter, payload: bytes) -> None:
    writer.write(struct.pack(">I", len(payload)) + payload)
