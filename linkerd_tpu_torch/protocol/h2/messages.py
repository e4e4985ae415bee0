"""HTTP/2 request/response message model.

Reference parity: finagle/h2/.../Message.scala, Method.scala, Status.scala —
messages carry pseudo-header fields plus a Headers list and an H2Stream
body. Header names are kept lowercase (RFC 7540 §8.1.2).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

from linkerd_tpu_torch.protocol.h2.stream import H2Stream, stream_of


class Headers:
    """An ordered multi-map of lowercase header names."""

    __slots__ = ("_items",)

    def __init__(self, items: Optional[Iterable[Tuple[str, str]]] = None):
        self._items: List[Tuple[str, str]] = [
            (n.lower(), v) for n, v in (items or [])]

    def get(self, name: str) -> Optional[str]:
        name = name.lower()
        for n, v in self._items:
            if n == name:
                return v
        return None

    def get_all(self, name: str) -> List[str]:
        name = name.lower()
        return [v for n, v in self._items if n == name]

    def set(self, name: str, value: str) -> None:
        name = name.lower()
        self.remove(name)
        self._items.append((name, value))

    def add(self, name: str, value: str) -> None:
        self._items.append((name.lower(), value))

    def remove(self, name: str) -> None:
        name = name.lower()
        self._items = [(n, v) for n, v in self._items if n != name]

    def items(self) -> List[Tuple[str, str]]:
        return list(self._items)

    def __contains__(self, name: str) -> bool:
        return self.get(name) is not None

    def __len__(self) -> int:
        return len(self._items)

    def copy(self) -> "Headers":
        return Headers(self._items)

    def __repr__(self) -> str:
        return f"Headers({self._items!r})"


class H2Request:
    """An h2 request: pseudo-headers + headers + pull-stream body."""

    __slots__ = ("scheme", "method", "authority", "path", "headers",
                 "stream", "ctx")

    def __init__(self, method: str = "GET", path: str = "/",
                 authority: str = "", scheme: str = "http",
                 headers: Optional[Headers] = None,
                 stream: Optional[H2Stream] = None,
                 body: Optional[bytes] = None):
        self.method = method
        self.path = path
        self.authority = authority
        self.scheme = scheme
        self.headers = headers if headers is not None else Headers()
        if stream is None:
            stream = stream_of(body or b"")
        self.stream = stream
        self.ctx: Dict[str, object] = {}

    def to_header_list(self) -> List[Tuple[str, str]]:
        pseudo = [(":method", self.method), (":scheme", self.scheme)]
        if self.authority:
            pseudo.append((":authority", self.authority))
        pseudo.append((":path", self.path))
        return pseudo + self.headers.items()

    @staticmethod
    def from_header_list(items: List[Tuple[str, str]]) -> "H2Request":
        pseudo: Dict[str, str] = {}
        rest: List[Tuple[str, str]] = []
        for n, v in items:
            if n.startswith(":"):
                pseudo[n] = v
            else:
                rest.append((n, v))
        return H2Request(
            method=pseudo.get(":method", "GET"),
            path=pseudo.get(":path", "/"),
            authority=pseudo.get(":authority", ""),
            scheme=pseudo.get(":scheme", "http"),
            headers=Headers(rest),
            stream=H2Stream(),
        )

    def __repr__(self) -> str:
        return f"H2Request({self.method} {self.authority}{self.path})"


class H2Response:
    __slots__ = ("status", "headers", "stream", "ctx")

    def __init__(self, status: int = 200,
                 headers: Optional[Headers] = None,
                 stream: Optional[H2Stream] = None,
                 body: Optional[bytes] = None,
                 trailers: Optional[List[Tuple[str, str]]] = None):
        self.status = status
        self.headers = headers if headers is not None else Headers()
        if stream is None:
            stream = stream_of(body or b"", trailers)
        self.stream = stream
        self.ctx: Dict[str, object] = {}

    def to_header_list(self) -> List[Tuple[str, str]]:
        return [(":status", str(self.status))] + self.headers.items()

    @staticmethod
    def from_header_list(items: List[Tuple[str, str]]) -> "H2Response":
        status = 200
        rest: List[Tuple[str, str]] = []
        for n, v in items:
            if n == ":status":
                status = int(v)
            elif not n.startswith(":"):
                rest.append((n, v))
        return H2Response(status=status, headers=Headers(rest),
                          stream=H2Stream())

    def __repr__(self) -> str:
        return f"H2Response({self.status})"
