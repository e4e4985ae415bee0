"""HTTP/2 client: one multiplexed connection per endpoint.

Reference parity: finagle/h2/.../H2.scala:29 — the client uses a
SingletonPool: all streams to an endpoint multiplex over a single h2
connection, re-established on failure.
"""

from __future__ import annotations

import asyncio
from typing import List, Optional

from linkerd_tpu_torch.core.tasks import spawn
from linkerd_tpu_torch.protocol.h2.connection import H2Connection
from linkerd_tpu_torch.protocol.h2.messages import H2Request, H2Response
from linkerd_tpu_torch.router.service import Service, Status


class H2Client(Service[H2Request, H2Response]):
    """A singleton-connection h2 client for one host:port endpoint."""

    def __init__(self, host: str, port: int,
                 connect_timeout: float = 3.0,
                 ssl_context=None, server_hostname: Optional[str] = None,
                 h2_settings: Optional[dict] = None):
        self.host = host
        self.port = port
        self.connect_timeout = connect_timeout
        if ssl_context is not None:
            ssl_context.set_alpn_protocols(["h2"])
        self.ssl_context = ssl_context
        self.server_hostname = server_hostname
        self._h2_settings = dict(h2_settings or {})
        self._conn: Optional[H2Connection] = None
        self._connecting: Optional[asyncio.Future] = None
        # GOAWAY drain: replaced connections park here until their
        # in-flight streams (at/below the peer's last_stream_id) finish
        self._draining: List[H2Connection] = []
        self._closed = False
        self.pending = 0  # live balancer instrumentation

    @property
    def status(self) -> Status:
        return Status.CLOSED if self._closed else Status.OPEN

    def _retire(self, conn: H2Connection) -> None:
        """Park a GOAWAY'd/closed conn for drain instead of leaking it.

        The engine already failed only streams above last_stream_id; the
        rest finish on the old socket while new requests ride a fresh
        conn. A watcher closes the parked conn once it empties (GOAWAY
        drain — not abort — per the reference's SingletonPool rebuild)."""
        self._draining.append(conn)

        async def _watch() -> None:
            try:
                while conn.active_streams and not conn.is_closed:
                    await asyncio.sleep(0.05)
                await conn.close()
            finally:
                if conn in self._draining:
                    self._draining.remove(conn)

        spawn(_watch(), what="h2-client-goaway-drain")

    async def _get_conn(self) -> H2Connection:
        cur = self._conn  # l5d: ignore[await-atomicity] — singleton dedup: concurrent connects serialize on _connecting, and the _closed re-check below covers the only concurrent writer (close)
        if cur is not None and not cur.is_closed \
                and not cur.goaway_received:
            return cur
        if cur is not None:
            # GOAWAY'd/dead singleton: retire it for drain (synchronous
            # pop — no await between the read above and here)
            self._conn = None
            self._retire(cur)
        if self._connecting is not None:
            return await asyncio.shield(self._connecting)
        loop = asyncio.get_running_loop()
        self._connecting = loop.create_future()
        try:
            kw = {}
            if self.ssl_context is not None:
                kw["ssl"] = self.ssl_context
                if self.server_hostname is not None:
                    kw["server_hostname"] = self.server_hostname
            reader, writer = await asyncio.wait_for(
                asyncio.open_connection(self.host, self.port, **kw),
                self.connect_timeout)
            conn = H2Connection(reader, writer, is_client=True,
                                **self._h2_settings)
            await conn.start()
            if self._closed:
                # close() ran during the handshake: the entry guard is
                # stale, and the fresh connection (socket + read loop)
                # must not outlive its client
                await conn.close()
                raise ConnectionError(
                    f"h2 client {self.host}:{self.port} closed")
            # singleton reconnect: concurrent callers dedup through
            # _connecting; close-vs-connect is handled by the re-check
            self._conn = conn  # l5d: ignore[await-atomicity] — only this path (serialized by _connecting) assigns a live conn; close() was just re-checked above
            self._connecting.set_result(conn)
            return conn
        except BaseException as e:
            self._connecting.set_exception(e)
            fut, self._connecting = self._connecting, None
            # consume the exception if nobody else awaited it
            fut.exception()
            raise
        finally:
            if self._connecting is not None and self._connecting.done():
                self._connecting = None

    async def __call__(self, req: H2Request) -> H2Response:
        if self._closed:
            raise ConnectionError(f"h2 client {self.host}:{self.port} closed")
        if not req.authority:
            # :authority is mandatory for gRPC peers (grpc-go/grpcio
            # reject requests without it); default to the endpoint
            req.authority = f"{self.host}:{self.port}"
        conn = await self._get_conn()
        if self._closed:
            # close() ran while we were connecting: the entry guard is
            # stale and the request must not ride a dead client
            raise ConnectionError(
                f"h2 client {self.host}:{self.port} closed")
        self.pending += 1
        try:
            return await conn.request(req)
        finally:
            self.pending -= 1

    async def close(self) -> None:
        self._closed = True
        # detach before awaiting: a connect finishing during the await
        # must find _conn already cleared (it re-checks _closed and
        # closes its own socket), not re-cache over our teardown
        conn, self._conn = self._conn, None
        if conn is not None:
            await conn.close()
        draining, self._draining = self._draining, []
        for conn in draining:
            await conn.close()
