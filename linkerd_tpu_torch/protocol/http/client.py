"""HTTP/1.1 client with keep-alive connection pooling: a copy of
``linkerd_tpu/protocol/http/client.py``.

Reference parity: the client-side stack's connection pool
(ref: hostConnectionPool config, ClientConfig.scala; finagle's
WatermarkPool/CachingPool). One pool per concrete endpoint; idle
connections are reused FIFO, created on demand up to ``max_connections``,
and reaped after ``idle_ttl`` seconds.
"""

from __future__ import annotations

import asyncio
import time
from typing import List, Optional, Tuple

from linkerd_tpu_torch.protocol.http import codec
from linkerd_tpu_torch.protocol.http.message import Request, Response
from linkerd_tpu_torch.router.service import Service, Status


class _Conn:
    __slots__ = ("reader", "writer", "last_used")

    def __init__(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        self.reader = reader
        self.writer = writer
        self.last_used = time.monotonic()

    @property
    def closed(self) -> bool:
        return self.writer.is_closing()

    def close(self) -> None:
        try:
            self.writer.close()
        except (OSError, RuntimeError):  # transport already detached
            pass


class HttpClient(Service[Request, Response]):
    """A pooled HTTP/1.1 client Service for one host:port endpoint."""

    def __init__(self, host: str, port: int,
                 max_connections: int = 64,
                 idle_ttl: float = 60.0,
                 connect_timeout: float = 3.0,
                 max_body: int = codec.MAX_BODY,
                 ssl_context=None,
                 server_hostname: Optional[str] = None):
        self.host = host
        self.port = port
        self.max_connections = max_connections
        self.idle_ttl = idle_ttl
        self.connect_timeout = connect_timeout
        self.max_body = max_body
        # TLS origination (ref: TlsClientConfig.scala; per-client tls in
        # ClientConfig.scala). server_hostname carries the (possibly
        # PathMatcher-substituted) commonName for SNI + verification.
        self.ssl_context = ssl_context
        self.server_hostname = server_hostname
        self._idle: List[_Conn] = []
        self._n_open = 0
        self._waiters: asyncio.Queue = asyncio.Queue()
        self._sem = asyncio.Semaphore(max_connections)
        self._closed = False
        # live instrumentation for balancers (pending = in-flight requests)
        self.pending = 0

    @property
    def status(self) -> Status:
        return Status.CLOSED if self._closed else Status.OPEN

    async def _checkout(self) -> _Conn:
        now = time.monotonic()
        while self._idle:
            conn = self._idle.pop()
            if conn.closed or now - conn.last_used > self.idle_ttl:
                conn.close()
                self._n_open -= 1
                self._sem.release()
                continue
            return conn
        await self._sem.acquire()
        try:
            kw = {}
            if self.ssl_context is not None:
                kw["ssl"] = self.ssl_context
                if self.server_hostname is not None:
                    kw["server_hostname"] = self.server_hostname
            reader, writer = await asyncio.wait_for(
                asyncio.open_connection(self.host, self.port, **kw),
                self.connect_timeout)
        except Exception:
            self._sem.release()
            raise
        self._n_open += 1
        return _Conn(reader, writer)

    def _checkin(self, conn: _Conn, reusable: bool) -> None:
        if reusable and not self._closed and not conn.closed:
            conn.last_used = time.monotonic()
            self._idle.append(conn)
        else:
            conn.close()
            self._n_open -= 1
            self._sem.release()

    async def __call__(self, req: Request) -> Response:
        if self._closed:
            raise ConnectionError(f"client {self.host}:{self.port} closed")
        if req.headers.get("host") is None:
            req.headers.set("Host", f"{self.host}:{self.port}")
        conn = await self._checkout()
        if self._closed:
            # close() ran while we were checking out/connecting: the
            # entry guard above is stale. Surrender the connection
            # instead of dispatching on a closed client (the fresh
            # socket would otherwise outlive close() forever).
            self._checkin(conn, reusable=False)
            raise ConnectionError(f"client {self.host}:{self.port} closed")
        self.pending += 1
        try:
            codec.write_request(conn.writer, req)
            await conn.writer.drain()
            rsp = await codec.read_response(conn.reader, req.method,
                                            self.max_body)
        except BaseException:
            self._checkin(conn, reusable=False)
            self.pending -= 1
            raise
        self.pending -= 1
        if rsp.status == 101 or (req.method == "CONNECT"
                                 and 200 <= rsp.status < 300):
            # protocol switch: the connection IS the tunnel now. Hand
            # the raw streams to the server edge for byte relay; the
            # conn never returns to the pool (tunnel_done releases its
            # slot when the relay ends).
            rsp.ctx["tunnel"] = (conn.reader, conn.writer)
            rsp.ctx["tunnel_done"] = lambda: self._checkin(
                conn, reusable=False)
            return rsp
        reusable = (
            (rsp.headers.get("connection") or "").lower() != "close"
            and (req.headers.get("connection") or "").lower() != "close"
            and rsp.version == "HTTP/1.1"
        )
        self._checkin(conn, reusable)
        return rsp

    async def close(self) -> None:
        self._closed = True
        for conn in self._idle:
            conn.close()
        self._idle.clear()
