"""Mux server: tag-demultiplexed concurrent dispatch.

Each Tdispatch runs as its own task (tags identify the exchange); Tping
and Tinit are answered inline (ref: finagle mux ServerDispatcher).

A copy of ``linkerd_tpu/protocol/mux/server.py``.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Optional

from linkerd_tpu_torch.protocol.mux.codec import (
    MuxMessage, RINIT, ROK, TDISCARDED, TDISPATCH, TINIT, TPING, RPING,
    Tdispatch, decode_tdispatch, encode_rdispatch, encode_rerr,
    read_mux_frame, write_mux_frame,
)
from linkerd_tpu_torch.router.service import Service

log = logging.getLogger(__name__)


class MuxServer:
    """service: Tdispatch -> reply payload bytes."""

    def __init__(self, service: Service[Tdispatch, bytes],
                 host: str = "127.0.0.1", port: int = 0):
        self.service = service
        self.host = host
        self.port = port
        self._server: Optional[asyncio.base_events.Server] = None
        self._conns: set = set()
        self._conn_tasks: set = set()

    @property
    def bound_port(self) -> int:
        assert self._server is not None
        return self._server.sockets[0].getsockname()[1]

    async def start(self) -> "MuxServer":
        self._server = await asyncio.start_server(
            self._on_conn, self.host, self.port)
        return self

    async def close(self) -> None:
        if self._server is not None:
            self._server.close()
        for w in list(self._conns):
            try:
                w.close()
            except (OSError, RuntimeError):  # transport already detached
                pass
        for t in list(self._conn_tasks):
            t.cancel()
        if self._server is not None:
            await self._server.wait_closed()

    async def _on_conn(self, reader: asyncio.StreamReader,
                       writer: asyncio.StreamWriter) -> None:
        self._conns.add(writer)
        me = asyncio.current_task()
        if me is not None:
            self._conn_tasks.add(me)
            me.add_done_callback(self._conn_tasks.discard)
        pending: dict = {}
        write_lock = asyncio.Lock()

        async def reply(mtype: int, tag: int, body: bytes) -> None:
            async with write_lock:
                write_mux_frame(writer, mtype, tag, body)
                await writer.drain()

        async def dispatch(msg: MuxMessage) -> None:
            try:
                td = decode_tdispatch(msg)
                payload = await self.service(td)
                await reply(*encode_rdispatch(msg.tag, payload, ROK))
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001 -> Rerr
                try:
                    await reply(*encode_rerr(msg.tag, repr(e)))
                except Exception as e2:  # noqa: BLE001 — the Rerr is
                    # best-effort, but a failed one means the peer never
                    # learns the dispatch died: leave a trace
                    log.debug("mux Rerr write failed: %r", e2)
            finally:
                pending.pop(msg.tag, None)

        try:
            while True:
                msg = await read_mux_frame(reader)
                if msg is None:
                    return
                if msg.fragment:
                    # this codec never negotiates fragmentation (Rinit
                    # advertises no params); reject rather than misparse
                    await reply(*encode_rerr(
                        msg.tag, "mux fragmentation not supported"))
                    continue
                if msg.type == TDISPATCH:
                    task = asyncio.get_running_loop().create_task(
                        dispatch(msg))
                    pending[msg.tag] = task
                elif msg.type == TPING:
                    await reply(RPING, msg.tag, b"")
                elif msg.type == TINIT:
                    # advertise OUR params (none — in particular, no
                    # fragmentation) instead of echoing the client's,
                    # which would imply agreement to whatever it proposed
                    version = msg.body[:2] if len(msg.body) >= 2 else b"\x00\x01"
                    await reply(RINIT, msg.tag, version)
                elif msg.type == TDISCARDED:
                    # body: 3-byte tag being discarded + why
                    if len(msg.body) >= 3:
                        tag = int.from_bytes(msg.body[:3], "big") & 0x7FFFFF
                        task = pending.pop(tag, None)
                        if task is not None:
                            task.cancel()
                else:
                    await reply(*encode_rerr(
                        msg.tag, f"unsupported mux type {msg.type}"))
        except (ConnectionResetError, BrokenPipeError,
                asyncio.IncompleteReadError):
            pass
        except asyncio.CancelledError:
            raise
        except Exception:  # noqa: BLE001
            log.exception("mux connection handler error")
        finally:
            for task in pending.values():
                task.cancel()
            self._conns.discard(writer)
            try:
                writer.close()
            except (OSError, RuntimeError):  # transport already detached
                pass


async def serve_mux(service: Service, host: str = "127.0.0.1",
                    port: int = 0) -> MuxServer:
    return await MuxServer(service, host, port).start()
