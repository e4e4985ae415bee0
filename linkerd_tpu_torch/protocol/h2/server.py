"""HTTP/2 server listener (prior-knowledge h2c, or TLS with ALPN h2).

Reference parity: finagle/h2/.../H2.scala server side +
Netty4H2Listener.scala. Each accepted connection runs one H2Connection
engine dispatching streams into the Service.
"""

from __future__ import annotations

import asyncio
import functools
import logging
from typing import Optional

from linkerd_tpu_torch.protocol.h2.connection import H2Connection
from linkerd_tpu_torch.protocol.h2.frames import REFUSED_STREAM
from linkerd_tpu_torch.protocol.h2.messages import H2Request, H2Response
from linkerd_tpu_torch.protocol.h2.stream import StreamReset
from linkerd_tpu_torch.protocol.tls import sni_of
from linkerd_tpu_torch.router.service import Service

log = logging.getLogger(__name__)


class H2Server:
    def __init__(self, service: Service[H2Request, H2Response],
                 host: str = "127.0.0.1", port: int = 0,
                 ssl_context=None,
                 max_concurrency: Optional[int] = None,
                 h2_settings: Optional[dict] = None,
                 stream_observer_factory=None):
        self.service = service
        # stream sentinel (streamScoring): one fresh H2FrameObserver
        # per accepted connection, sharing the router's sentinel
        self._mk_observer = stream_observer_factory
        self.host = host
        self.port = port
        if ssl_context is not None:
            ssl_context.set_alpn_protocols(["h2"])
        self.ssl_context = ssl_context
        self._h2_settings = dict(h2_settings or {})
        self._server: Optional[asyncio.base_events.Server] = None
        self._conns: set = set()
        # admission control (ref: maxConcurrentRequests ->
        # RequestSemaphoreFilter, Server.scala:89-97)
        self._sem = (asyncio.Semaphore(max_concurrency)
                     if max_concurrency else None)

    @property
    def bound_port(self) -> int:
        assert self._server is not None, "server not started"
        return self._server.sockets[0].getsockname()[1]

    async def start(self) -> "H2Server":
        self._server = await asyncio.start_server(
            self._on_conn, self.host, self.port, ssl=self.ssl_context)
        return self

    async def close(self) -> None:
        if self._server is not None:
            self._server.close()
        # Close live connections BEFORE wait_closed(): on Python >=3.12.1
        # wait_closed blocks until every connection handler returns, and
        # handlers run for the life of their connection's read loop.
        for conn in list(self._conns):
            await conn.close()
        if self._server is not None:
            await self._server.wait_closed()

    async def _on_conn(self, reader: asyncio.StreamReader,
                       writer: asyncio.StreamWriter) -> None:
        # Sniff prior-knowledge h2c (connection preface) vs an HTTP/1.1
        # request upgrading with ``Upgrade: h2c`` + HTTP2-Settings on the
        # SAME port (ref: ServerUpgradeHandler.scala:1-70).
        from linkerd_tpu_torch.protocol.h2.frames import CONNECTION_PREFACE

        upgraded = None
        try:
            buf = b""
            while (len(buf) < len(CONNECTION_PREFACE)
                   and CONNECTION_PREFACE.startswith(buf)):
                chunk = await reader.read(len(CONNECTION_PREFACE) - len(buf))
                if not chunk:
                    writer.close()
                    return
                buf += chunk
            surplus = b""
            if buf != CONNECTION_PREFACE:
                upgraded = await self._h1_upgrade(buf, reader, writer)
                if upgraded is None:
                    return  # answered (426 / 4xx) and closed
                # after the 101 the client sends the h2 preface; it may
                # have been coalesced with the upgrade request, and any
                # bytes past it are already h2 frames
                data = upgraded[3]
                while len(data) < len(CONNECTION_PREFACE):
                    chunk = await reader.read(
                        len(CONNECTION_PREFACE) - len(data))
                    if not chunk:
                        writer.close()
                        return
                    data += chunk
                if data[:len(CONNECTION_PREFACE)] != CONNECTION_PREFACE:
                    writer.close()
                    return
                surplus = data[len(CONNECTION_PREFACE):]
        except (ConnectionError, asyncio.IncompleteReadError):
            writer.close()
            return
        # SNI is a per-connection fact: read it once, stamp it on every
        # stream's request (tenantIdentifier: sni on the Python data
        # plane; the native h2 engine surfaces the same name natively)
        sni = sni_of(writer)
        handler = self._dispatch
        if sni is not None:
            handler = functools.partial(self._dispatch, sni=sni)
        conn = H2Connection(reader, writer, is_client=False,
                            **self._h2_settings,
                            handler=handler,
                            preface_consumed=True,
                            initial_data=surplus,
                            observer=(self._mk_observer()
                                      if self._mk_observer else None))
        self._conns.add(conn)
        try:
            if upgraded is not None:
                req, body, settings_payload, _ = upgraded
                conn.apply_upgrade_settings(settings_payload)
            await conn.start()
            if upgraded is not None:
                conn.adopt_upgraded_request(req, body)
            # the connection lives as long as its read loop
            await asyncio.shield(conn._read_task)  # noqa: SLF001
        except asyncio.CancelledError:
            pass
        except Exception as e:  # noqa: BLE001 — read loop already logged
            log.debug("h2 connection serve exit: %r", e)  # the details
        finally:
            self._conns.discard(conn)
            await conn.close()

    # headers that must not cross the h1 -> h2 translation (RFC 7540
    # §8.1.2.2 connection-specific headers + the upgrade machinery)
    _H1_ONLY = frozenset({
        "connection", "upgrade", "http2-settings", "host", "keep-alive",
        "proxy-connection", "transfer-encoding", "te",
    })

    async def _h1_upgrade(self, buf: bytes, reader: asyncio.StreamReader,
                          writer: asyncio.StreamWriter):
        """Parse one h1 request; 101-switch when it upgrades to h2c.

        -> (H2Request, body, settings_payload) on success; None when the
        connection was answered and closed here (non-upgrade h1 gets 426
        Upgrade Required — this port speaks h2)."""
        import base64

        from linkerd_tpu_torch.protocol.h2.messages import H2Request

        def respond(status: int, reason: str, extra: str = "") -> None:
            writer.write((f"HTTP/1.1 {status} {reason}\r\n{extra}"
                          f"Content-Length: 0\r\n"
                          f"Connection: close\r\n\r\n").encode())
            writer.close()

        data = buf
        while b"\r\n\r\n" not in data:
            if len(data) > 64 * 1024:
                respond(431, "Request Header Fields Too Large")
                return None
            chunk = await reader.read(65536)
            if not chunk:
                writer.close()
                return None
            data += chunk
        end = data.index(b"\r\n\r\n") + 4
        head, rest = data[:end], data[end:]
        try:
            # the SAME strict head parser as the http server (shared
            # line rules, header caps) — no second h1 parser to drift
            from linkerd_tpu_torch.protocol.http.codec import _parse_head_bytes
            method, uri, version, headers = _parse_head_bytes(head)
        except Exception:  # noqa: BLE001 — malformed head
            respond(400, "Bad Request")
            return None
        if not version.startswith("HTTP/1"):
            respond(400, "Bad Request")
            return None

        conn_tokens = {t.strip().lower()
                       for t in (headers.get("connection") or "").split(",")
                       if t.strip()}
        settings_b64 = headers.get("http2-settings")
        if ("upgrade" not in conn_tokens
                or (headers.get("upgrade") or "").lower() != "h2c"
                or settings_b64 is None):
            respond(426, "Upgrade Required",
                    "Upgrade: h2c\r\nConnection: Upgrade\r\n")
            return None
        try:
            pad = -len(settings_b64) % 4
            settings_payload = base64.urlsafe_b64decode(
                settings_b64 + "=" * pad)
        except Exception:  # noqa: BLE001
            respond(400, "Bad Request")
            return None
        if headers.get("transfer-encoding") is not None:
            respond(400, "Bad Request")
            return None
        try:
            n_body = int(headers.get("content-length") or 0)
        except ValueError:
            respond(400, "Bad Request")
            return None
        if n_body < 0:
            respond(400, "Bad Request")
            return None
        if n_body > 1 << 20:
            respond(413, "Payload Too Large")
            return None
        while len(rest) < n_body:
            chunk = await reader.read(n_body - len(rest))
            if not chunk:
                writer.close()
                return None
            rest += chunk
        # bytes past the body belong to the h2 connection (a client may
        # coalesce its preface with the upgrade request)
        body, leftover = rest[:n_body], rest[n_body:]

        writer.write(b"HTTP/1.1 101 Switching Protocols\r\n"
                     b"Connection: Upgrade\r\nUpgrade: h2c\r\n\r\n")
        await writer.drain()

        # strip connection-specific headers, including any the client
        # nominated in Connection (RFC 7230 §6.1 / RFC 7540 §8.1.2.2)
        drop = self._H1_ONLY | conn_tokens
        h2_headers = [(":method", method), (":scheme", "http"),
                      (":authority", headers.get("host") or ""),
                      (":path", uri)]
        h2_headers.extend((n.lower(), v) for n, v in headers.items()
                          if n.lower() not in drop)
        return H2Request.from_header_list(h2_headers), body, \
            settings_payload, leftover

    async def _dispatch(self, req: H2Request,
                        sni: Optional[str] = None) -> H2Response:
        if sni is not None:
            req.ctx["sni"] = sni
        try:
            if self._sem is not None:
                if self._sem.locked():
                    # shed with a RETRYABLE signal: RST_STREAM
                    # REFUSED_STREAM tells the peer the stream was never
                    # processed (not a synthesized 503 body the client
                    # can't distinguish from an app error)
                    raise StreamReset(REFUSED_STREAM,
                                      "server concurrency limit")
                async with self._sem:
                    return await self.service(req)
            return await self.service(req)
        except StreamReset:
            # surfaces as an RST_STREAM frame (_serve_stream), keeping
            # the refusal's error code on the wire
            raise
        except Exception as e:  # noqa: BLE001 — last-resort responder
            log.debug("h2 service error: %r", e)
            return H2Response(status=502, body=repr(e).encode())


async def serve_h2(service: Service, host: str = "127.0.0.1",
                   port: int = 0, **kw) -> H2Server:
    return await H2Server(service, host, port, **kw).start()
