"""Mux wire format.

Frame: 4-byte big-endian length, then 1-byte type + 3-byte tag + body.
Types (finagle mux spec): Tdispatch=2/Rdispatch=-2, Tping=65/Rping=-65,
Tdiscarded=66, Tinit=68/Rinit=-68, Rerr=-128 (two's complement on the
wire). Tdispatch body: contexts (n16, then len16-prefixed k/v pairs),
dest (len16 string), dtab (n16, then len16 src/dst pairs), payload.

A copy of ``linkerd_tpu/protocol/mux/codec.py``.
"""

from __future__ import annotations

import asyncio
import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

TDISPATCH = 2
RDISPATCH = 254   # -2
TPING = 65
RPING = 191       # -65
TDISCARDED = 66
TINIT = 68
RINIT = 188       # -68
RERR = 128        # -128

MAX_FRAME = 16 * 1024 * 1024

# Rdispatch reply statuses
ROK, RERROR, RNACK = 0, 1, 2


class MuxCodecError(Exception):
    pass


@dataclass
class MuxMessage:
    type: int
    tag: int
    body: bytes
    fragment: bool = False  # tag MSB: fragmented frame (not supported)


@dataclass
class Tdispatch:
    tag: int
    contexts: List[Tuple[bytes, bytes]]
    dest: str
    dtab: List[Tuple[str, str]]
    payload: bytes
    ctx: Dict[str, object] = field(default_factory=dict)


async def read_mux_frame(reader: asyncio.StreamReader
                         ) -> Optional[MuxMessage]:
    try:
        head = await reader.readexactly(4)
    except asyncio.IncompleteReadError:
        return None
    (n,) = struct.unpack(">I", head)
    if n > MAX_FRAME or n < 4:
        raise MuxCodecError(f"bad mux frame length {n}")
    buf = await reader.readexactly(n)
    mtype = buf[0]
    raw_tag = int.from_bytes(buf[1:4], "big")
    # The tag MSB is the fragment bit (finagle mux framing). This codec
    # does not reassemble fragments, so silently masking it would corrupt
    # payloads from a peer that negotiated fragmentation — surface it for
    # the caller to reject with Rerr instead.
    return MuxMessage(mtype, raw_tag & 0x7FFFFF, buf[4:],
                      fragment=bool(raw_tag & 0x800000))


def write_mux_frame(writer: asyncio.StreamWriter, mtype: int, tag: int,
                    body: bytes) -> None:
    writer.write(struct.pack(">I", 4 + len(body))
                 + bytes([mtype & 0xFF]) + tag.to_bytes(3, "big") + body)


def decode_tdispatch(msg: MuxMessage) -> Tdispatch:
    b = msg.body
    pos = 0

    def u16() -> int:
        nonlocal pos
        v = struct.unpack_from(">H", b, pos)[0]
        pos += 2
        return v

    def lv() -> bytes:
        nonlocal pos
        n = u16()
        v = b[pos:pos + n]
        if len(v) != n:
            raise MuxCodecError("truncated Tdispatch")
        pos += n
        return v

    try:
        nctx = u16()
        contexts = [(lv(), lv()) for _ in range(nctx)]
        dest = lv().decode("utf-8")
        ndtab = u16()
        dtab = [(lv().decode("utf-8"), lv().decode("utf-8"))
                for _ in range(ndtab)]
    except struct.error as e:
        raise MuxCodecError(f"truncated Tdispatch: {e}") from None
    return Tdispatch(msg.tag, contexts, dest, dtab, b[pos:])


def encode_tdispatch(tag: int, contexts: List[Tuple[bytes, bytes]],
                     dest: str, dtab: List[Tuple[str, str]],
                     payload: bytes) -> Tuple[int, int, bytes]:
    out = bytearray()
    out += struct.pack(">H", len(contexts))
    for k, v in contexts:
        out += struct.pack(">H", len(k)) + k
        out += struct.pack(">H", len(v)) + v
    d = dest.encode("utf-8")
    out += struct.pack(">H", len(d)) + d
    out += struct.pack(">H", len(dtab))
    for src, dst in dtab:
        s, t = src.encode(), dst.encode()
        out += struct.pack(">H", len(s)) + s
        out += struct.pack(">H", len(t)) + t
    out += payload
    return TDISPATCH, tag, bytes(out)


def encode_rdispatch(tag: int, payload: bytes,
                     status: int = ROK) -> Tuple[int, int, bytes]:
    # contexts: none
    return RDISPATCH, tag, bytes([status]) + struct.pack(">H", 0) + payload


def decode_rdispatch(msg: MuxMessage) -> Tuple[int, bytes]:
    b = msg.body
    if len(b) < 3:
        raise MuxCodecError("truncated Rdispatch")
    status = b[0]
    nctx = struct.unpack_from(">H", b, 1)[0]
    pos = 3
    for _ in range(nctx):
        for _ in range(2):
            if pos + 2 > len(b):
                raise MuxCodecError("truncated Rdispatch contexts")
            n = struct.unpack_from(">H", b, pos)[0]
            pos += 2 + n
            if pos > len(b):
                raise MuxCodecError("truncated Rdispatch contexts")
    return status, b[pos:]


def encode_rerr(tag: int, why: str) -> Tuple[int, int, bytes]:
    return RERR, tag, why.encode("utf-8")
