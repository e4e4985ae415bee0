"""Thrift server: framed or buffered transport, binary or compact
protocol, pipelined per-connection dispatch.

Ref: finagle-thrift server semantics as used by router/thrift —
requests on one connection dispatch CONCURRENTLY (finagle pipelines
thrift), with responses written back in request order so plain Apache
clients (which match replies positionally, not by seqid) stay correct.
Transport/protocol knobs per ThriftInitializer.scala:47,68-72
(``thriftProtocol``, ``thriftFramed``).

A copy of ``linkerd_tpu/protocol/thrift/server.py``.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Optional

from linkerd_tpu_torch.protocol.thrift.codec import (
    ThriftCall, UnframedReader, encode_exception, encode_exception_for,
    parse_header, read_framed, write_framed,
)
from linkerd_tpu_torch.router.service import Service

from linkerd_tpu_torch.protocol.thrift.ttwitter import (  # noqa: E402
    CAN_TRACE_METHOD as _CAN_TRACE,
)

log = logging.getLogger(__name__)


class ThriftServer:
    def __init__(self, service: Service[ThriftCall, Optional[bytes]],
                 host: str = "127.0.0.1", port: int = 0,
                 ttwitter: bool = True, framed: bool = True,
                 protocol: str = "binary", max_pipelined: int = 32):
        self.service = service
        self.host = host
        self.port = port
        # answer TTwitter upgrade requests; upgraded connections carry
        # RequestHeader/ResponseHeader framing (ref: TTwitterServerFilter).
        # The upgrade protocol itself is framed-binary only.
        self.ttwitter = ttwitter and framed and protocol == "binary"
        self.framed = framed
        self.protocol = protocol
        if protocol not in ("binary", "compact"):
            raise ValueError(f"unknown thrift protocol {protocol!r}")
        if not framed and protocol != "binary":
            raise ValueError("buffered transport requires the binary "
                             "protocol (message-boundary scan)")
        self.max_pipelined = max_pipelined
        self._server: Optional[asyncio.base_events.Server] = None
        self._conns: set = set()
        self._conn_tasks: set = set()

    @property
    def bound_port(self) -> int:
        assert self._server is not None
        return self._server.sockets[0].getsockname()[1]

    async def start(self) -> "ThriftServer":
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
        task = asyncio.current_task()
        if task is not None:
            self._conn_tasks.add(task)
            task.add_done_callback(self._conn_tasks.discard)
        upgraded = False  # per-connection TTwitter state
        unframed = (UnframedReader(reader) if not self.framed else None)
        # pipelining: requests dispatch concurrently (bounded); replies
        # are written in REQUEST order via an ordered queue of futures so
        # positional (non-seqid) clients stay correct
        sem = asyncio.Semaphore(self.max_pipelined)
        reply_q: asyncio.Queue = asyncio.Queue()
        pending_tasks: set = set()

        def send(reply: bytes) -> None:
            if self.framed:
                write_framed(writer, reply)
            else:
                writer.write(reply)

        async def write_loop() -> None:
            try:
                while True:
                    fut = await reply_q.get()
                    if fut is None:
                        return
                    reply = await fut
                    if reply is not None:
                        send(reply)
                        await writer.drain()
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001 — write side gone:
                # kill the conn so the read loop unwinds instead of
                # stalling, but leave a trace of WHY the writer died
                log.debug("thrift write loop failed: %r", e)
                try:
                    writer.close()
                except (OSError, RuntimeError):
                    pass

        async def run_one(call: ThriftCall, was_upgraded: bool) -> Optional[bytes]:
            async with sem:
                try:
                    reply = await self.service(call)
                except Exception as e:  # noqa: BLE001 -> thrift exception
                    # encode in the CONNECTION's protocol: a binary-
                    # encoded exception desyncs compact clients
                    reply = encode_exception_for(
                        self.protocol, call.name, call.seqid, repr(e))
                if call.oneway or reply is None:
                    return None
                if was_upgraded:
                    from linkerd_tpu_torch.protocol.thrift import ttwitter as ttw
                    reply = ttw.prepend_struct(ttw.TResponseHeader(), reply)
                return reply

        writer_task = asyncio.get_running_loop().create_task(write_loop())
        try:
            while True:
                payload = (await read_framed(reader) if self.framed
                           else await unframed.read_message())
                if payload is None:
                    return
                ctx: dict = {}
                if upgraded:
                    from linkerd_tpu_torch.protocol.thrift import ttwitter as ttw
                    try:
                        header, payload = ttw.peel_struct(
                            ttw.TRequestHeader, payload)
                    except Exception as e:  # noqa: BLE001 — desynced conn
                        log.debug("bad ttwitter header: %s", e)
                        return
                    trace = ttw.header_trace(header)
                    if trace is not None:
                        ctx["trace"] = trace
                    ctx["dtab"] = ttw.header_dtab(header)
                    if header.dest:
                        ctx["dest"] = header.dest
                    if header.client_id is not None:
                        ctx["clientId"] = header.client_id.name
                try:
                    name, seqid, mtype = parse_header(payload,
                                                      self.protocol)
                except Exception as e:  # noqa: BLE001 - bad frame: drop conn
                    log.debug("bad thrift frame: %s", e)
                    return
                if not upgraded and mtype == 1 and name == _CAN_TRACE \
                        and self.framed and self.protocol == "binary":
                    if self.ttwitter:
                        from linkerd_tpu_torch.protocol.thrift import (
                            ttwitter as ttw,
                        )
                        upgraded = True
                        probe_reply = ttw.encode_upgrade_reply(seqid)
                    else:
                        # never forward the probe downstream: a REPLY from
                        # there would desync BOTH hops. Answer like any
                        # plain thrift server (unknown method).
                        probe_reply = encode_exception(
                            name, seqid, "Invalid method name")
                    # ride the ordered reply queue: a direct write would
                    # overtake replies still pending for earlier
                    # pipelined requests (positional clients pair
                    # replies by order, not seqid)
                    fut = asyncio.get_running_loop().create_future()
                    fut.set_result(probe_reply)
                    reply_q.put_nowait(fut)
                    continue
                call = ThriftCall(payload, name, seqid, mtype, ctx=ctx)
                task = asyncio.get_running_loop().create_task(
                    run_one(call, upgraded))
                pending_tasks.add(task)
                task.add_done_callback(pending_tasks.discard)
                if not call.oneway:
                    reply_q.put_nowait(task)
                # backpressure: don't read unboundedly ahead of dispatch
                if sem.locked():
                    async with sem:
                        pass
        except (ConnectionResetError, BrokenPipeError,
                asyncio.IncompleteReadError):
            pass
        except asyncio.CancelledError:
            raise
        except Exception:  # noqa: BLE001
            log.exception("thrift connection handler error")
        finally:
            # drain in-flight replies (bounded), then stop the writer.
            # CancelledError (BaseException) must not skip the cleanup
            # below — re-raise it after the conn is fully torn down.
            cancelled: Optional[BaseException] = None
            try:
                reply_q.put_nowait(None)
                await asyncio.wait_for(writer_task, 5.0)
            except asyncio.CancelledError as e:
                writer_task.cancel()
                cancelled = e
            except Exception:  # noqa: BLE001
                writer_task.cancel()
            for t in list(pending_tasks):
                t.cancel()
            self._conns.discard(writer)
            try:
                writer.close()
            except (OSError, RuntimeError):  # transport already detached
                pass
            if cancelled is not None:
                raise cancelled


async def serve_thrift(service: Service, host: str = "127.0.0.1",
                       port: int = 0) -> ThriftServer:
    return await ThriftServer(service, host, port).start()
