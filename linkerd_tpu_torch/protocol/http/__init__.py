"""HTTP/1.1 message model: a copy of ``linkerd_tpu/protocol/http/message.py``."""

from linkerd_tpu_torch.protocol.http.message import Headers, Request, Response

__all__ = ["Headers", "Request", "Response"]
