"""HTTP/2 for the TPU-native mesh: hand-written codec + stream engine.

Reference parity: finagle/h2 (the reference's largest subsystem, ~2,900
LoC on raw Netty4 Http2Frames — H2.scala, Stream.scala,
netty4/Netty4StreamTransport.scala RFC7540 state machine). Here the whole
wire layer — HPACK, framing, flow control, stream lifecycle — is
implemented natively on asyncio transports, keeping the reference's
pull-based Stream/release() semantics that retry-buffering and
stream-stats depend on.
"""

from linkerd_tpu_torch.protocol.h2.messages import (  # noqa: F401
    H2Request, H2Response, Headers as H2Headers,
)
from linkerd_tpu_torch.protocol.h2.stream import (  # noqa: F401
    DataFrame, H2Stream, StreamReset, Trailers,
)
