"""One-shot HTTP/1.1 GET helper for control-plane API clients.

The consul / k8s / marathon discovery clients all need the same thing:
a single authenticated GET over a fresh connection, fully framed
(content-length or chunked), possibly held open for minutes (blocking
queries). Built on the shared protocol/http codec so framing behavior has
exactly one implementation.

A copy of ``linkerd_tpu/protocol/http/simple_client.py``.
"""

from __future__ import annotations

import asyncio
from typing import Dict, Optional

from linkerd_tpu_torch.protocol.http import codec
from linkerd_tpu_torch.protocol.http.message import Headers, Request, Response


async def request(host: str, port: int, method: str, path: str,
                  body: bytes = b"",
                  headers: Optional[Dict[str, str]] = None,
                  ssl=None, timeout: float = 330.0,
                  max_body: int = codec.MAX_BODY) -> Response:
    """One ``method`` request with ``Connection: close``; returns the full
    Response. ``timeout`` bounds the whole exchange (long-poll friendly
    default)."""

    async def go() -> Response:
        reader, writer = await asyncio.open_connection(host, port, ssl=ssl)
        try:
            hdrs = Headers([("Host", host), ("Accept", "application/json"),
                            ("Connection", "close")])
            for k, v in (headers or {}).items():
                hdrs.set(k, v)
            codec.write_request(writer, Request(
                method=method, uri=path, headers=hdrs, body=body))
            await writer.drain()
            return await codec.read_response(
                reader, max_body=max_body, request_method=method)
        finally:
            try:
                writer.close()
            except (OSError, RuntimeError):  # transport already detached
                pass

    return await asyncio.wait_for(go(), timeout)


async def get(host: str, port: int, path: str,
              headers: Optional[Dict[str, str]] = None,
              ssl=None, timeout: float = 330.0,
              max_body: int = codec.MAX_BODY) -> Response:
    """GET ``path`` with ``Connection: close``; returns the full Response."""
    return await request(host, port, "GET", path, headers=headers,
                         ssl=ssl, timeout=timeout, max_body=max_body)
