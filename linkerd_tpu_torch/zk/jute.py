"""Jute (ZooKeeper wire) primitive codec.

ZooKeeper's protocol serializes records with Hadoop's jute format: all
integers big-endian, buffers and strings length-prefixed with an i32
(-1 encodes null), booleans one byte, vectors an i32 count followed by
elements. The reference reaches this format through the ZooKeeper Java
client (namer/serversets, namerd/storage/zk ZkSession.scala); here it is
implemented directly for the asyncio client.
"""

from __future__ import annotations

import struct
from typing import List, Optional

_I32 = struct.Struct(">i")
_I64 = struct.Struct(">q")


class Writer:
    __slots__ = ("buf",)

    def __init__(self) -> None:
        self.buf = bytearray()

    def int32(self, v: int) -> "Writer":
        self.buf += _I32.pack(v)
        return self

    def int64(self, v: int) -> "Writer":
        self.buf += _I64.pack(v)
        return self

    def boolean(self, v: bool) -> "Writer":
        self.buf.append(1 if v else 0)
        return self

    def buffer(self, v: Optional[bytes]) -> "Writer":
        if v is None:
            return self.int32(-1)
        self.int32(len(v))
        self.buf += v
        return self

    def ustring(self, v: Optional[str]) -> "Writer":
        return self.buffer(None if v is None else v.encode("utf-8"))

    def ustring_vector(self, v: Optional[List[str]]) -> "Writer":
        if v is None:
            return self.int32(-1)
        self.int32(len(v))
        for s in v:
            self.ustring(s)
        return self

    def packet(self) -> bytes:
        """The framed wire form: i32 length prefix + payload."""
        return _I32.pack(len(self.buf)) + bytes(self.buf)


class Reader:
    __slots__ = ("data", "pos")

    def __init__(self, data: bytes, pos: int = 0) -> None:
        self.data = data
        self.pos = pos

    def int32(self) -> int:
        v = _I32.unpack_from(self.data, self.pos)[0]
        self.pos += 4
        return v

    def int64(self) -> int:
        v = _I64.unpack_from(self.data, self.pos)[0]
        self.pos += 8
        return v

    def boolean(self) -> bool:
        v = self.data[self.pos] != 0
        self.pos += 1
        return v

    def buffer(self) -> Optional[bytes]:
        n = self.int32()
        if n < 0:
            return None
        v = bytes(self.data[self.pos:self.pos + n])
        self.pos += n
        return v

    def ustring(self) -> Optional[str]:
        b = self.buffer()
        return None if b is None else b.decode("utf-8")

    def ustring_vector(self) -> List[str]:
        n = self.int32()
        if n < 0:
            return []
        return [self.ustring() or "" for _ in range(n)]

    def remaining(self) -> int:
        return len(self.data) - self.pos
