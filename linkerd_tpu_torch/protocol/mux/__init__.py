"""Mux: finagle's tag-multiplexed session protocol.

Ref: router/mux (Mux.scala, experimental) and router/thriftmux
(ThriftMux.scala:66 — thrift semantics over the mux transport). The
codec implements the mux framing needed to proxy: Tdispatch/Rdispatch
(with contexts, dest and dtab fields), Tping/Rping, Tinit/Rinit handshake
passthrough, Rerr, and Tdiscarded.

A copy of ``linkerd_tpu/protocol/mux/__init__.py``.
"""

from linkerd_tpu_torch.protocol.mux.codec import (
    MuxMessage, RDISPATCH, RERR, RPING, TDISPATCH, TPING,
    decode_tdispatch, encode_rdispatch, encode_rerr, read_mux_frame,
    write_mux_frame,
)
from linkerd_tpu_torch.protocol.mux.server import MuxServer, serve_mux
from linkerd_tpu_torch.protocol.mux.client import MuxClient

__all__ = [
    "MuxMessage", "RDISPATCH", "RERR", "RPING", "TDISPATCH", "TPING",
    "decode_tdispatch", "encode_rdispatch", "encode_rerr",
    "read_mux_frame", "write_mux_frame", "MuxServer", "serve_mux",
    "MuxClient",
]
