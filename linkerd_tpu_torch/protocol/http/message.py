"""HTTP/1.1 message model: a copy of
``linkerd_tpu/protocol/http/message.py``.

Order-preserving, case-insensitive multimap headers (proxies must preserve
header order and repetition — ref: the reference routes finagle-http
messages through header-rewriting filters like AddForwardedHeader.scala,
StripHopByHopHeadersFilter.scala).
"""

from __future__ import annotations

from typing import Dict, Iterable, Iterator, List, Optional, Tuple


class Headers:
    """Ordered, case-insensitive multimap of header fields."""

    __slots__ = ("_items",)

    def __init__(self, items: Iterable[Tuple[str, str]] = ()):
        self._items: List[Tuple[str, str]] = [(k, v) for k, v in items]

    # -- reads ------------------------------------------------------------
    def get(self, name: str, default: Optional[str] = None) -> Optional[str]:
        ln = name.lower()
        for k, v in self._items:
            if k.lower() == ln:
                return v
        return default

    def get_all(self, name: str) -> List[str]:
        ln = name.lower()
        return [v for k, v in self._items if k.lower() == ln]

    def contains(self, name: str) -> bool:
        return self.get(name) is not None

    def items(self) -> List[Tuple[str, str]]:
        return list(self._items)

    def __iter__(self) -> Iterator[Tuple[str, str]]:
        return iter(self._items)

    def __len__(self) -> int:
        return len(self._items)

    # -- writes -----------------------------------------------------------
    def add(self, name: str, value: str) -> None:
        self._items.append((name, str(value)))

    def set(self, name: str, value: str) -> None:
        self.remove(name)
        self.add(name, value)

    def remove(self, name: str) -> int:
        ln = name.lower()
        before = len(self._items)
        self._items = [(k, v) for k, v in self._items if k.lower() != ln]
        return before - len(self._items)

    def copy(self) -> "Headers":
        return Headers(self._items)

    def __repr__(self) -> str:
        return f"Headers({self._items!r})"


class Request:
    __slots__ = ("method", "uri", "version", "headers", "body", "ctx")

    def __init__(self, method: str = "GET", uri: str = "/",
                 version: str = "HTTP/1.1",
                 headers: Optional[Headers] = None,
                 body: bytes = b""):
        self.method = method
        self.uri = uri
        self.version = version
        self.headers = headers if headers is not None else Headers()
        self.body = body
        # Per-request context (ref: finagle Contexts / DstPathCtx etc.);
        # carries Dst, trace info, response class through the stack.
        self.ctx: Dict[str, object] = {}

    @property
    def host(self) -> Optional[str]:
        return self.headers.get("host")

    @property
    def path(self) -> str:
        """URI path without query string."""
        uri = self.uri
        # absolute-form (proxy) URIs: strip scheme://authority
        if uri.startswith("http://") or uri.startswith("https://"):
            rest = uri.split("://", 1)[1]
            slash = rest.find("/")
            uri = rest[slash:] if slash >= 0 else "/"
        q = uri.find("?")
        return uri[:q] if q >= 0 else uri

    def __repr__(self) -> str:
        return f"Request({self.method} {self.uri})"


class Response:
    __slots__ = ("status", "reason", "version", "headers", "body",
                 "body_stream", "ctx")

    def __init__(self, status: int = 200, reason: Optional[str] = None,
                 version: str = "HTTP/1.1",
                 headers: Optional[Headers] = None,
                 body: bytes = b"",
                 body_stream: Optional[object] = None):
        self.status = status
        self.reason = reason if reason is not None else REASONS.get(status, "Unknown")
        self.version = version
        self.headers = headers if headers is not None else Headers()
        self.body = body
        # async iterator of bytes -> Transfer-Encoding: chunked streaming
        # (the watch=true control-API path, ref: HttpControlService
        # streaming responses). When set, ``body`` is ignored.
        self.body_stream = body_stream
        self.ctx: Dict[str, object] = {}

    def __repr__(self) -> str:
        return f"Response({self.status})"


REASONS = {
    100: "Continue", 101: "Switching Protocols",
    200: "OK", 201: "Created", 202: "Accepted", 204: "No Content",
    206: "Partial Content", 301: "Moved Permanently", 302: "Found",
    303: "See Other", 304: "Not Modified", 307: "Temporary Redirect",
    308: "Permanent Redirect",
    400: "Bad Request", 401: "Unauthorized", 403: "Forbidden",
    404: "Not Found", 405: "Method Not Allowed", 408: "Request Timeout",
    409: "Conflict", 410: "Gone", 411: "Length Required",
    413: "Payload Too Large", 414: "URI Too Long", 429: "Too Many Requests",
    431: "Request Header Fields Too Large",
    500: "Internal Server Error", 501: "Not Implemented", 502: "Bad Gateway",
    503: "Service Unavailable", 504: "Gateway Timeout",
    505: "HTTP Version Not Supported",
}
