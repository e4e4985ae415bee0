"""HTTP/1.1 wire codec over asyncio streams: a copy of
``linkerd_tpu/protocol/http/codec.py``.

Reads/writes request and response messages with Content-Length and chunked
transfer-encoding bodies, enforcing max header/body sizes (ref: the
reference's maxHeadersKB / maxRequestKB / maxResponseKB config,
HttpConfig.scala:192-249, and the FramingFilter's dup-Content-Length
rejection, linkerd/protocol/http/.../FramingFilter.scala).
"""

from __future__ import annotations

import asyncio
from typing import Optional, Tuple

from linkerd_tpu_torch.protocol.http.message import Headers, Request, Response

MAX_LINE = 8 * 1024
MAX_HEADERS_BYTES = 64 * 1024
MAX_BODY = 8 * 1024 * 1024


class HttpCodecError(Exception):
    """Malformed message framing; maps to 400 (request) / 502 (response)."""


class BodyTooLarge(HttpCodecError):
    pass


async def _read_line(reader: asyncio.StreamReader) -> bytes:
    try:
        line = await reader.readuntil(b"\r\n")
    except asyncio.IncompleteReadError as e:
        if not e.partial:
            raise EOFError("connection closed") from None
        raise HttpCodecError("truncated line") from None
    except asyncio.LimitOverrunError:
        raise HttpCodecError("line too long") from None
    line = line[:-2]
    if len(line) > MAX_LINE:
        raise HttpCodecError("line too long")
    return line


def _parse_request_line(line: bytes) -> Tuple[str, str, str]:
    """One shared implementation for the streaming and block paths
    (CRLF already stripped)."""
    if len(line) > MAX_LINE:
        raise HttpCodecError("line too long")
    if b"\n" in line or b"\r" in line:
        # a bare LF/CR inside a line is a parser-differential smuggling
        # vector (lines are CRLF-delimited; embedded ones re-serialize
        # as new lines downstream)
        raise HttpCodecError("bare CR/LF in request line")
    parts = line.decode("latin-1").split(" ")
    if len(parts) != 3:
        raise HttpCodecError(f"malformed request line: {line[:64]!r}")
    method, uri, version = parts
    if version not in ("HTTP/1.1", "HTTP/1.0"):
        raise HttpCodecError(f"unsupported version: {version!r}")
    return method, uri, version


def _parse_header_line(line: bytes, headers: Headers, total: int) -> int:
    """Validate + add one header line (CRLF stripped); returns the new
    running byte total. Shared by streaming and block paths."""
    if len(line) > MAX_LINE:
        raise HttpCodecError("line too long")
    if b"\n" in line or b"\r" in line:
        raise HttpCodecError("bare CR/LF in header line")
    total += len(line)
    if total > MAX_HEADERS_BYTES:
        raise HttpCodecError("headers too large")
    if line[0:1] in (b" ", b"\t"):
        raise HttpCodecError("obsolete header folding rejected")
    idx = line.find(b":")
    if idx <= 0:
        raise HttpCodecError(f"malformed header line: {line[:64]!r}")
    name = line[:idx].decode("latin-1").strip()
    value = line[idx + 1:].decode("latin-1").strip()
    if not name or any(c in name for c in " \t"):
        raise HttpCodecError(f"malformed header name: {name!r}")
    headers.add(name, value)
    return total


async def _read_headers(reader: asyncio.StreamReader) -> Headers:
    headers = Headers()
    total = 0
    while True:
        line = await _read_line(reader)
        if not line:
            return headers
        total = _parse_header_line(line, headers, total)


def _body_framing(headers: Headers) -> Tuple[str, int]:
    """Returns ("chunked", 0) | ("length", n) | ("none", 0).

    Duplicate, differing Content-Length headers are rejected outright
    (request-smuggling guard — ref: FramingFilter semantics).
    """
    te = [v.lower() for v in headers.get_all("transfer-encoding")]
    if te:
        if any("chunked" in v for v in te):
            if headers.get_all("content-length"):
                raise HttpCodecError("both Transfer-Encoding and Content-Length")
            return ("chunked", 0)
        raise HttpCodecError(f"unsupported transfer-encoding: {te}")
    cls = headers.get_all("content-length")
    if not cls:
        return ("none", 0)
    vals = set(cls)
    if len(vals) > 1:
        raise HttpCodecError("conflicting Content-Length headers")
    try:
        n = int(next(iter(vals)))
    except ValueError:
        raise HttpCodecError(f"bad Content-Length: {cls[0]!r}") from None
    if n < 0:
        raise HttpCodecError("negative Content-Length")
    return ("length", n)


async def _read_body(reader: asyncio.StreamReader, framing: Tuple[str, int],
                     max_body: int = MAX_BODY) -> bytes:
    kind, n = framing
    if kind == "none":
        return b""
    if kind == "length":
        if n > max_body:
            raise BodyTooLarge(f"body {n} > {max_body}")
        try:
            return await reader.readexactly(n)
        except asyncio.IncompleteReadError:
            raise HttpCodecError("truncated body") from None
    # chunked
    chunks = []
    total = 0
    while True:
        size_line = await _read_line(reader)
        # chunk extensions after ';' are ignored
        size_s = size_line.split(b";", 1)[0].strip()
        try:
            size = int(size_s, 16)
        except ValueError:
            raise HttpCodecError(f"bad chunk size: {size_line[:32]!r}") from None
        if size == 0:
            # trailers (ignored) until blank line
            while True:
                t = await _read_line(reader)
                if not t:
                    break
            return b"".join(chunks)
        total += size
        if total > max_body:
            raise BodyTooLarge(f"chunked body > {max_body}")
        try:
            chunks.append(await reader.readexactly(size))
            crlf = await reader.readexactly(2)
        except asyncio.IncompleteReadError:
            raise HttpCodecError("truncated chunk") from None
        if crlf != b"\r\n":
            raise HttpCodecError("bad chunk terminator")


async def read_request(reader: asyncio.StreamReader,
                       max_body: int = MAX_BODY) -> Request:
    """Read one request; raises EOFError on clean close before a request.

    The port parses the head line by line in Python only: the
    reference's native C head parser is not bound here.
    """
    line = await _read_line(reader)
    method, uri, version = _parse_request_line(line)
    headers = await _read_headers(reader)
    body = await _read_body(reader, _body_framing(headers), max_body)
    return Request(method=method, uri=uri, version=version,
                   headers=headers, body=body)


async def read_response(reader: asyncio.StreamReader, request_method: str = "GET",
                        max_body: int = MAX_BODY) -> Response:
    line = await _read_line(reader)
    parts = line.decode("latin-1").split(" ", 2)
    if len(parts) < 2 or not parts[0].startswith("HTTP/"):
        raise HttpCodecError(f"malformed status line: {line[:64]!r}")
    version = parts[0]
    try:
        status = int(parts[1])
    except ValueError:
        raise HttpCodecError(f"bad status: {parts[1]!r}") from None
    reason = parts[2] if len(parts) > 2 else ""
    headers = await _read_headers(reader)
    if request_method == "HEAD" or status in (204, 304) \
            or 100 <= status < 200 \
            or (request_method == "CONNECT" and 200 <= status < 300):
        # a 2xx to CONNECT switches to tunnel mode: what follows the
        # header block is tunnel payload, never a response body
        body = b""
    else:
        framing = _body_framing(headers)
        if framing[0] == "none" and headers.get("content-length") is None:
            # No framing info: body runs to EOF (HTTP/1.0 style)
            conn = (headers.get("connection") or "").lower()
            if "close" in conn or version == "HTTP/1.0":
                body = await reader.read(max_body + 1)
                if len(body) > max_body:
                    raise BodyTooLarge("eof-delimited body too large")
            else:
                body = b""
        else:
            body = await _read_body(reader, framing, max_body)
    return Response(status=status, reason=reason, version=version,
                    headers=headers, body=body)


def _ensure_length(headers: Headers, body: bytes) -> None:
    if headers.get("transfer-encoding") is None and (
            body or headers.get("content-length") is None):
        headers.set("Content-Length", str(len(body)))


def write_request(writer: asyncio.StreamWriter, req: Request) -> None:
    _ensure_length(req.headers, req.body)
    lines = [f"{req.method} {req.uri} {req.version}\r\n"]
    lines += [f"{k}: {v}\r\n" for k, v in req.headers]
    lines.append("\r\n")
    writer.write("".join(lines).encode("latin-1") + req.body)


def write_response(writer: asyncio.StreamWriter, rsp: Response) -> None:
    if rsp.status not in (204, 304) and not (100 <= rsp.status < 200):
        _ensure_length(rsp.headers, rsp.body)
    lines = [f"{rsp.version} {rsp.status} {rsp.reason}\r\n"]
    lines += [f"{k}: {v}\r\n" for k, v in rsp.headers]
    lines.append("\r\n")
    writer.write("".join(lines).encode("latin-1") + rsp.body)


async def write_streaming_response(writer: asyncio.StreamWriter,
                                   rsp: Response) -> None:
    """Write a chunked response from ``rsp.body_stream`` (an async iterator
    of bytes), draining after every chunk so watchers see updates live."""
    rsp.headers.remove("content-length")
    rsp.headers.set("Transfer-Encoding", "chunked")
    lines = [f"{rsp.version} {rsp.status} {rsp.reason}\r\n"]
    lines += [f"{k}: {v}\r\n" for k, v in rsp.headers]
    lines.append("\r\n")
    writer.write("".join(lines).encode("latin-1"))
    await writer.drain()
    async for chunk in rsp.body_stream:
        if not chunk:
            continue
        writer.write(f"{len(chunk):x}\r\n".encode("latin-1")
                     + chunk + b"\r\n")
        await writer.drain()
    writer.write(b"0\r\n\r\n")
    await writer.drain()
