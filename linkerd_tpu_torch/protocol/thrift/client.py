"""Framed-thrift client: one pooled connection per endpoint, serial
request/response (framed thrift is not multiplexed — finagle pools
connections the same way; ref: ThriftClientPrep).

A copy of ``linkerd_tpu/protocol/thrift/client.py``.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Optional

from linkerd_tpu_torch.protocol.thrift.codec import (
    ThriftCall, read_framed, write_framed,
)
from linkerd_tpu_torch.router.service import Service, Status

log = logging.getLogger(__name__)


class ThriftClient(Service[ThriftCall, Optional[bytes]]):
    def __init__(self, host: str, port: int, connect_timeout: float = 3.0,
                 attempt_ttwitter: bool = False, dest: str = "",
                 client_id: str = "", framed: bool = True,
                 protocol: str = "binary"):
        self.host = host
        self.port = port
        self.connect_timeout = connect_timeout
        # Negotiate the TTwitter upgrade on connect; on success every
        # request carries a RequestHeader with trace + dtab context
        # (ref: TTwitterClientFilter, attemptTTwitterUpgrade). The
        # upgrade protocol is framed-only.
        self.framed = framed
        self.protocol = protocol
        self.attempt_ttwitter = (attempt_ttwitter and framed
                                 and protocol == "binary")
        self.dest = dest
        self.client_id = client_id
        self._unframed_reader = None  # lazy UnframedReader (buffered)
        self._upgraded = False
        self._reader: Optional[asyncio.StreamReader] = None
        self._writer: Optional[asyncio.StreamWriter] = None
        self._lock = asyncio.Lock()
        self._closed = False
        self.pending = 0

    @property
    def status(self) -> Status:
        return Status.CLOSED if self._closed else Status.OPEN

    async def _ensure_conn(self) -> None:
        if self._closed:
            # close() may have run while this exchange queued on _lock;
            # reconnecting now would leak a socket past it
            raise ConnectionError(
                f"thrift client {self.host}:{self.port} closed")
        if self._writer is None or self._writer.is_closing():
            self._upgraded = False
            reader, writer = await asyncio.wait_for(
                asyncio.open_connection(self.host, self.port),
                self.connect_timeout)
            if self._closed:
                # close() ran during the connect: abandon before
                # installing, or this exchange would dispatch on a
                # closed client and wedge close() behind the lock
                try:
                    writer.close()
                except (OSError, RuntimeError):
                    pass
                raise ConnectionError(
                    f"thrift client {self.host}:{self.port} closed")
            self._reader, self._writer = reader, writer
            if not self.framed:
                from linkerd_tpu_torch.protocol.thrift.codec import UnframedReader
                self._unframed_reader = UnframedReader(self._reader)
            if self.attempt_ttwitter:
                await self._try_upgrade()

    async def _try_upgrade(self) -> None:
        from linkerd_tpu_torch.protocol.thrift import ttwitter as ttw
        from linkerd_tpu_torch.protocol.thrift.codec import (
            REPLY, parse_message_header,
        )
        try:
            write_framed(self._writer, ttw.encode_upgrade_request(0))
            await self._writer.drain()
            reply = await asyncio.wait_for(
                read_framed(self._reader), self.connect_timeout)
            if reply is None:
                raise ConnectionError("closed during ttwitter upgrade")
            _, _, mtype = parse_message_header(reply)
            # EXCEPTION means a plain server: fall back silently
            self._upgraded = mtype == REPLY
        except Exception as e:  # noqa: BLE001
            # ANY failed probe leaves the connection desynced (its reply
            # may still be in flight and could be served to a later
            # caller) — never cache it
            self._teardown()
            raise ConnectionError(
                f"thrift backend lost during upgrade: {e!r}") from None

    def _wrap_request(self, call: ThriftCall) -> bytes:
        from linkerd_tpu_torch.protocol.thrift import ttwitter as ttw
        header = ttw.mk_request_header(
            trace=call.ctx.get("trace"),
            dest=call.ctx.get("dest") or self.dest,
            dtab=call.ctx.get("dtab"),
            client_id=self.client_id)
        return ttw.prepend_struct(header, call.payload)

    async def __call__(self, call: ThriftCall) -> Optional[bytes]:
        self.pending += 1
        try:
            # serial per connection: frame pairs must not interleave
            async with self._lock:
                await self._ensure_conn()
                payload = (self._wrap_request(call) if self._upgraded
                           else call.payload)
                try:
                    if self.framed:
                        write_framed(self._writer, payload)
                    else:
                        self._writer.write(payload)
                    await self._writer.drain()
                    if call.oneway:
                        return None
                    reply = (await read_framed(self._reader)
                             if self.framed else
                             await self._unframed_reader.read_message())
                except (ConnectionResetError, BrokenPipeError,
                        asyncio.IncompleteReadError) as e:
                    self._teardown()
                    raise ConnectionError(f"thrift backend: {e}") from None
                except asyncio.CancelledError:
                    # canceled mid-exchange (e.g. total timeout): the
                    # connection has an in-flight reply -> unusable
                    self._teardown()
                    raise
                if reply is None:
                    self._teardown()
                    raise ConnectionError("thrift backend closed connection")
                if self._upgraded:
                    from linkerd_tpu_torch.protocol.thrift import ttwitter as ttw
                    try:
                        _, reply = ttw.peel_struct(
                            ttw.TResponseHeader, reply)
                    except Exception:  # noqa: BLE001 — desynced
                        self._teardown()
                        raise ConnectionError(
                            "unparseable ttwitter response header")
                # Verify the reply matches this request; a mismatched
                # seqid means a stale/desynced exchange (never serve
                # caller A's payload to caller B).
                try:
                    from linkerd_tpu_torch.protocol.thrift.codec import (
                        parse_header,
                    )
                    _, seqid, _ = parse_header(reply, self.protocol)
                except Exception:  # noqa: BLE001 - unparseable reply
                    self._teardown()
                    raise ConnectionError("unparseable thrift reply")
                if seqid != call.seqid:
                    self._teardown()
                    raise ConnectionError(
                        f"thrift seqid mismatch (got {seqid}, "
                        f"want {call.seqid})")
                return reply
        finally:
            self.pending -= 1

    def _teardown(self) -> None:
        if self._writer is not None:
            try:
                self._writer.close()
            except (OSError, RuntimeError):  # transport already detached
                pass
        self._reader = self._writer = self._unframed_reader = None

    async def close(self) -> None:
        # flag first (outside the lock) so exchanges already queued on
        # it observe closure in _ensure_conn instead of reconnecting
        self._closed = True  # l5d: ignore[lock-guard] — monotonic flag set-before-lock: queued exchanges must see it when they win the lock
        # break any wedged in-flight exchange BEFORE waiting for the
        # lock: a peer that blackholes the reply would otherwise hold
        # the lock (and this close) forever. Closing the transport is a
        # read-only poke — the exchange's own error path runs teardown.
        w = self._writer
        if w is not None:
            try:
                w.close()
            except (OSError, RuntimeError):  # transport already detached
                pass
        async with self._lock:
            # serialize the final teardown with a dispatch that was
            # mid-connect when the flag published (its fresh writer
            # must not outlive close)
            self._teardown()  # l5d: ignore[await-atomicity] — the pre-lock read is a fail-fast alias only; this locked teardown re-nulls whatever generation is current
