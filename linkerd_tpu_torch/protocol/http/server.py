"""HTTP/1.1 server: asyncio listener dispatching requests into a Service: a copy of
``linkerd_tpu/protocol/http/server.py``.

Reference parity: the server side of ProtocolInitializer
(linkerd/core/.../ProtocolInitializer.scala:92-102 serves the adapted router
service) with keep-alive, pipelined-sequential request handling, and error
responses for framing failures.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Optional, Tuple

from linkerd_tpu_torch.protocol.http import codec
from linkerd_tpu_torch.protocol.http.message import Request, Response
from linkerd_tpu_torch.protocol.tls import sni_of
from linkerd_tpu_torch.router.service import Service

log = logging.getLogger(__name__)


#: content types worth compressing when compression_level is -1 (auto);
#: binary media (images, archives, protobuf) is already entropy-coded
_COMPRESSIBLE = ("text/", "application/json", "application/javascript",
                 "application/xml", "+json", "+xml", "ecmascript")


class HttpServer:
    def __init__(self, service: Service[Request, Response],
                 host: str = "127.0.0.1", port: int = 0,
                 max_body: int = codec.MAX_BODY,
                 max_concurrency: Optional[int] = None,
                 ssl_context=None,
                 compression_level: Optional[int] = None):
        self.service = service
        self.host = host
        self.port = port
        self.max_body = max_body
        # TLS termination (ref: TlsServerConfig.scala via ServerConfig tls)
        self.ssl_context = ssl_context
        # gzip response compression (ref: HttpConfig.scala:202,248
        # compressionLevel): None/0 = off, -1 = automatic (compressible
        # content types at zlib default), 1..9 = always, at that level
        self.compression_level = compression_level
        self._server: Optional[asyncio.base_events.Server] = None
        self._sem = (asyncio.Semaphore(max_concurrency)
                     if max_concurrency else None)
        self._conns: set = set()
        self._conn_tasks: set = set()

    @property
    def bound_port(self) -> int:
        assert self._server is not None, "server not started"
        return self._server.sockets[0].getsockname()[1]

    async def start(self) -> "HttpServer":
        # the stream limit must exceed the largest legal head so the
        # block-read fast path (readuntil in codec.read_request) never
        # trips LimitOverrunError before the codec's own size checks
        self._server = await asyncio.start_server(
            self._handle_conn, self.host, self.port, ssl=self.ssl_context,
            limit=codec.MAX_HEADERS_BYTES + 2 * codec.MAX_LINE)
        return self

    async def close(self) -> None:
        if self._server is not None:
            self._server.close()
        for w in list(self._conns):
            try:
                w.close()
            except (OSError, RuntimeError):  # transport already detached
                pass
        # cancel parked handlers (e.g. watch streams blocked on state
        # changes) — 3.12's wait_closed() waits for ALL handlers
        for t in list(self._conn_tasks):
            t.cancel()
        if self._server is not None:
            await self._server.wait_closed()

    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        self._conns.add(writer)
        task = asyncio.current_task()
        if task is not None:
            self._conn_tasks.add(task)
            task.add_done_callback(self._conn_tasks.discard)
        # SNI is a per-connection fact: read it once, stamp it on every
        # request of the conn (tenantIdentifier: sni on the Python data
        # plane; the native engines surface the same name natively)
        sni = sni_of(writer)
        try:
            while True:
                try:
                    req = await codec.read_request(reader, self.max_body)
                except EOFError:
                    return
                except codec.BodyTooLarge:
                    codec.write_response(writer, Response(status=413))
                    await writer.drain()
                    return
                except codec.HttpCodecError as e:
                    codec.write_response(
                        writer, Response(status=400, body=str(e).encode()))
                    await writer.drain()
                    return

                req.ctx["client_addr"] = writer.get_extra_info("peername")
                req.ctx["server_addr"] = writer.get_extra_info("sockname")
                if sni is not None:
                    req.ctx["sni"] = sni
                if self._sem is not None:
                    # Admission control (ref: maxConcurrentRequests ->
                    # RequestSemaphoreFilter, Server.scala:89-97)
                    if self._sem.locked():
                        rsp = Response(status=503, body=b"too many requests")
                        codec.write_response(writer, rsp)
                        await writer.drain()
                        continue
                    async with self._sem:
                        rsp = await self._dispatch(req)
                else:
                    rsp = await self._dispatch(req)

                if rsp.ctx.get("tunnel") is not None:
                    # protocol switch (101 Upgrade / CONNECT 2xx): relay
                    # raw bytes between client and upstream; terminal
                    # for this connection either way
                    await self._serve_tunnel(req, rsp, reader, writer)
                    return

                conn_close = (
                    (req.headers.get("connection") or "").lower() == "close"
                    or req.version == "HTTP/1.0"
                )
                if conn_close:
                    rsp.headers.set("Connection", "close")
                if self.compression_level:
                    self._maybe_compress(req, rsp)
                if rsp.body_stream is not None:
                    # watch-style chunked stream; terminal for this conn
                    # (the stream usually ends only when the client goes)
                    try:
                        await codec.write_streaming_response(writer, rsp)
                    finally:
                        aclose = getattr(rsp.body_stream, "aclose", None)
                        if aclose is not None:
                            try:
                                await aclose()
                            except Exception as e:  # noqa: BLE001 — a
                                # failing generator finalizer must not
                                # mask the response outcome, but say so
                                log.debug("body stream aclose: %r", e)
                    return
                codec.write_response(writer, rsp)
                await writer.drain()
                if conn_close:
                    return
        except (ConnectionResetError, BrokenPipeError):
            pass
        except Exception:  # noqa: BLE001
            log.exception("connection handler error")
        finally:
            self._conns.discard(writer)
            try:
                writer.close()
            except (OSError, RuntimeError):  # transport already detached
                pass

    async def _serve_tunnel(self, req: Request, rsp: Response,
                            reader: asyncio.StreamReader,
                            writer: asyncio.StreamWriter) -> None:
        """Byte-relay a switched connection (WebSocket 101 / CONNECT).

        ``rsp.ctx["tunnel"]`` holds the upstream (reader, writer) pair the
        HttpClient handed over instead of pooling; ``tunnel_done`` releases
        its pool slot when the relay ends. The relay runs until either side
        hits EOF or errors; first exit tears down both directions."""
        up_reader, up_writer = rsp.ctx["tunnel"]
        done = rsp.ctx.get("tunnel_done")
        conn_tokens = {t.strip().lower()
                       for t in (req.headers.get("connection") or "").split(",")
                       if t.strip()}
        legit = (rsp.status == 101 and "upgrade" in conn_tokens) or (
            req.method == "CONNECT" and 200 <= rsp.status < 300)
        try:
            if not legit:
                # a switch the client never asked for (stray 101) is a
                # protocol violation upstream: surface a gateway error
                # rather than relaying bytes the client can't frame
                codec.write_response(writer, Response(
                    status=502, body=b"unsolicited protocol switch"))
                await writer.drain()
                return
            codec.write_response(writer, rsp)
            await writer.drain()

            async def pump(src: asyncio.StreamReader,
                           dst: asyncio.StreamWriter) -> None:
                while True:
                    chunk = await src.read(65536)
                    if not chunk:
                        break
                    dst.write(chunk)
                    await dst.drain()

            up = asyncio.ensure_future(pump(reader, up_writer))
            down = asyncio.ensure_future(pump(up_reader, writer))
            try:
                await asyncio.wait({up, down},
                                   return_when=asyncio.FIRST_COMPLETED)
            finally:
                for t in (up, down):
                    t.cancel()
                for t in (up, down):
                    try:
                        await t
                    except (asyncio.CancelledError, ConnectionError,
                            OSError):
                        pass
        finally:
            try:
                up_writer.close()
            except (OSError, RuntimeError):  # transport already detached
                pass
            if done is not None:
                done()

    def _maybe_compress(self, req: Request, rsp: Response) -> None:
        """gzip the response in place when the configured level, the
        client's Accept-Encoding, and the payload all warrant it. Bodies
        that gzip would inflate (tiny or already-compressed) pass
        through untouched."""
        lvl = self.compression_level or 0
        if (rsp.body_stream is not None or not rsp.body
                or req.method == "HEAD"
                or rsp.status in (204, 304) or rsp.status < 200
                or rsp.headers.get("content-encoding") is not None):
            return
        accept = (req.headers.get("accept-encoding") or "").lower()
        if "gzip" not in accept:
            return
        if lvl < 0:  # automatic: compressible content types only
            ctype = (rsp.headers.get("content-type") or "").lower()
            if not any(t in ctype for t in _COMPRESSIBLE):
                return
            lvl = 6  # zlib default
        import gzip
        body = gzip.compress(rsp.body, compresslevel=lvl)
        if len(body) >= len(rsp.body):
            return
        rsp.body = body
        rsp.headers.set("Content-Encoding", "gzip")
        rsp.headers.remove("content-length")  # _ensure_length re-derives
        if "accept-encoding" not in (rsp.headers.get("vary") or "").lower():
            rsp.headers.add("Vary", "Accept-Encoding")

    async def _dispatch(self, req: Request) -> Response:
        try:
            return await self.service(req)
        except Exception as e:  # noqa: BLE001 — last-resort error responder
            log.debug("service error: %r", e)
            return Response(status=502, body=repr(e).encode())


async def serve(service: Service, host: str = "127.0.0.1",
                port: int = 0, **kw) -> HttpServer:
    return await HttpServer(service, host, port, **kw).start()
