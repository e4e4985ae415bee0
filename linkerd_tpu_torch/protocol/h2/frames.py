"""HTTP/2 frame codec (RFC 7540 §4-6).

Reference parity: the reference patches Netty's frame codec
(finagle/h2/.../netty4/H2FrameCodec.scala:287); here frames are read and
written directly on asyncio streams. Each frame is a 9-byte header
(24-bit length, type, flags, 31-bit stream id) plus payload.
"""

from __future__ import annotations

import struct
from typing import List, NamedTuple, Tuple

# frame types
DATA = 0x0
HEADERS = 0x1
PRIORITY = 0x2
RST_STREAM = 0x3
SETTINGS = 0x4
PUSH_PROMISE = 0x5
PING = 0x6
GOAWAY = 0x7
WINDOW_UPDATE = 0x8
CONTINUATION = 0x9

# flags
FLAG_END_STREAM = 0x1   # DATA, HEADERS
FLAG_ACK = 0x1          # SETTINGS, PING
FLAG_END_HEADERS = 0x4  # HEADERS, CONTINUATION
FLAG_PADDED = 0x8       # DATA, HEADERS
FLAG_PRIORITY = 0x20    # HEADERS

# settings ids
SETTINGS_HEADER_TABLE_SIZE = 0x1
SETTINGS_ENABLE_PUSH = 0x2
SETTINGS_MAX_CONCURRENT_STREAMS = 0x3
SETTINGS_INITIAL_WINDOW_SIZE = 0x4
SETTINGS_MAX_FRAME_SIZE = 0x5
SETTINGS_MAX_HEADER_LIST_SIZE = 0x6

# error codes (RFC 7540 §7)
NO_ERROR = 0x0
PROTOCOL_ERROR = 0x1
INTERNAL_ERROR = 0x2
FLOW_CONTROL_ERROR = 0x3
SETTINGS_TIMEOUT = 0x4
STREAM_CLOSED = 0x5
FRAME_SIZE_ERROR = 0x6
REFUSED_STREAM = 0x7
CANCEL = 0x8
COMPRESSION_ERROR = 0x9
CONNECT_ERROR = 0xA
ENHANCE_YOUR_CALM = 0xB
INADEQUATE_SECURITY = 0xC
HTTP_1_1_REQUIRED = 0xD

DEFAULT_MAX_FRAME_SIZE = 16384
DEFAULT_INITIAL_WINDOW = 65535
MAX_WINDOW = (1 << 31) - 1

CONNECTION_PREFACE = b"PRI * HTTP/2.0\r\n\r\nSM\r\n\r\n"


class FrameHeader(NamedTuple):
    length: int
    type: int
    flags: int
    stream_id: int


class H2ProtocolError(Exception):
    def __init__(self, code: int, message: str = ""):
        super().__init__(message or f"h2 protocol error {code:#x}")
        self.code = code


def pack_frame(ftype: int, flags: int, stream_id: int, payload: bytes) -> bytes:
    return struct.pack("!I", len(payload))[1:] + bytes(
        [ftype, flags]) + struct.pack("!I", stream_id & 0x7FFFFFFF) + payload


def unpack_header(data: bytes) -> FrameHeader:
    length = (data[0] << 16) | (data[1] << 8) | data[2]
    stream_id = struct.unpack("!I", data[5:9])[0] & 0x7FFFFFFF
    return FrameHeader(length, data[3], data[4], stream_id)


def strip_padding(flags: int, payload: bytes) -> bytes:
    if flags & FLAG_PADDED:
        if not payload:
            raise H2ProtocolError(PROTOCOL_ERROR, "padded frame w/o pad length")
        pad = payload[0]
        if pad >= len(payload):
            raise H2ProtocolError(PROTOCOL_ERROR, "pad length >= payload")
        return payload[1:len(payload) - pad]
    return payload


def pack_settings(settings: List[Tuple[int, int]], ack: bool = False) -> bytes:
    payload = b"".join(struct.pack("!HI", k, v) for k, v in settings)
    return pack_frame(SETTINGS, FLAG_ACK if ack else 0, 0, payload)


def unpack_settings(payload: bytes) -> List[Tuple[int, int]]:
    if len(payload) % 6:
        raise H2ProtocolError(FRAME_SIZE_ERROR, "settings size not 6n")
    return [struct.unpack("!HI", payload[i:i + 6])
            for i in range(0, len(payload), 6)]


def pack_window_update(stream_id: int, increment: int) -> bytes:
    return pack_frame(WINDOW_UPDATE, 0, stream_id, struct.pack("!I", increment))


def pack_rst(stream_id: int, code: int) -> bytes:
    return pack_frame(RST_STREAM, 0, stream_id, struct.pack("!I", code))


def pack_goaway(last_stream_id: int, code: int, debug: bytes = b"") -> bytes:
    return pack_frame(GOAWAY, 0, 0,
                      struct.pack("!II", last_stream_id, code) + debug)


def pack_ping(data: bytes = b"\0" * 8, ack: bool = False) -> bytes:
    return pack_frame(PING, FLAG_ACK if ack else 0, 0, data)
