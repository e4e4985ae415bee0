"""Thrift protocol: framed-transport proxying.

Ref: router/thrift (static ``Identifier.scala:34`` — one logical dst per
router), linkerd/protocol/thrift ThriftInitializer.scala:103 (protocol
framed|buffered, attemptTTwitterUpgrade). The router treats messages as
opaque framed payloads but parses the TBinaryProtocol header for the
method name + seqid (stats / response matching).

A copy of ``linkerd_tpu/protocol/thrift/__init__.py``.
"""

from linkerd_tpu_torch.protocol.thrift.codec import (
    ThriftCall, parse_message_header, read_framed, write_framed,
)
from linkerd_tpu_torch.protocol.thrift.server import ThriftServer, serve_thrift
from linkerd_tpu_torch.protocol.thrift.client import ThriftClient

__all__ = [
    "ThriftCall", "parse_message_header", "read_framed", "write_framed",
    "ThriftServer", "serve_thrift", "ThriftClient",
]
