"""gRPC length-prefixed message framing.

Ref: grpc/runtime/src/main/scala/io/buoyant/grpc/runtime/Codec.scala:130 —
each gRPC message on the wire is a 1-byte compressed flag + 4-byte big-endian
length + payload, possibly split across / coalesced within h2 DATA frames.
``GrpcFramer`` is the incremental re-assembler (ref: DecodingStream.scala).
"""

from __future__ import annotations

import gzip
import struct
from typing import Callable, List, Optional, Type

from linkerd_tpu_torch.grpc.proto import ProtoMessage

_HDR = struct.Struct(">BI")
HEADER_LEN = 5


class Codec:
    """Encode/decode one typed message to/from a gRPC frame."""

    def __init__(self, msg_cls: Type[ProtoMessage], compress: bool = False):
        self.msg_cls = msg_cls
        self.compress = compress

    def encode_frame(self, msg: ProtoMessage) -> bytes:
        payload = msg.encode()
        flag = 0
        if self.compress:
            payload = gzip.compress(payload)
            flag = 1
        return _HDR.pack(flag, len(payload)) + payload

    def decode_payload(self, flag: int, payload: bytes) -> ProtoMessage:
        if flag == 1:
            payload = gzip.decompress(payload)
        elif flag != 0:
            raise ValueError(f"bad gRPC compression flag {flag}")
        return self.msg_cls.decode(payload)


class GrpcFramer:
    """Stateful splitter: feed h2 DATA bytes, emit complete (flag, payload).

    Handles messages spanning multiple DATA frames and multiple messages in
    one DATA frame (ref: DecodingStream.scala:95 incremental re-framing).
    """

    def __init__(self) -> None:
        self._buf = bytearray()

    def feed(self, data: bytes) -> List[tuple]:
        self._buf += data
        out = []
        while True:
            if len(self._buf) < HEADER_LEN:
                return out
            flag, length = _HDR.unpack_from(self._buf, 0)
            if len(self._buf) < HEADER_LEN + length:
                return out
            payload = bytes(self._buf[HEADER_LEN:HEADER_LEN + length])
            del self._buf[:HEADER_LEN + length]
            out.append((flag, payload))

    @property
    def pending_bytes(self) -> int:
        return len(self._buf)
