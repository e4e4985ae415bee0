"""Mux client: one multiplexed connection per endpoint, tag-matched
concurrent exchanges (ref: finagle mux ClientDispatcher).

A copy of ``linkerd_tpu/protocol/mux/client.py``.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Dict, Optional

from linkerd_tpu_torch.protocol.mux.codec import (
    MuxCodecError, RDISPATCH, RERR, RNACK, ROK, RPING, TDISCARDED,
    TDISPATCH, TPING, Tdispatch, decode_rdispatch, encode_tdispatch,
    read_mux_frame, write_mux_frame,
)
from linkerd_tpu_torch.router.service import Service, Status

log = logging.getLogger(__name__)

MAX_TAG = 0x7FFFFF


class MuxApplicationError(Exception):
    """Rdispatch status != ok or an Rerr reply."""


class MuxClient(Service[Tdispatch, bytes]):
    def __init__(self, host: str, port: int, connect_timeout: float = 3.0):
        self.host = host
        self.port = port
        self.connect_timeout = connect_timeout
        self._writer: Optional[asyncio.StreamWriter] = None
        self._read_task: Optional[asyncio.Task] = None
        self._pending: Dict[int, asyncio.Future] = {}
        self._next_tag = 1
        self._lock = asyncio.Lock()
        self._closed = False
        self.pending = 0

    @property
    def status(self) -> Status:
        return Status.CLOSED if self._closed else Status.OPEN

    async def _ensure_conn(self) -> None:
        if self._closed:
            # close() may have run while this dispatch queued on _lock;
            # reconnecting now would leak a socket + read loop past it
            raise ConnectionError(
                f"mux client {self.host}:{self.port} closed")
        if self._writer is not None and not self._writer.is_closing():
            return
        reader, writer = await asyncio.wait_for(
            asyncio.open_connection(self.host, self.port),
            self.connect_timeout)
        if self._closed:
            # close() ran during the connect: abandon before installing
            # the generation — dispatching on a closed client would
            # wedge close() behind the lock
            try:
                writer.close()
            except (OSError, RuntimeError):
                pass
            raise ConnectionError(
                f"mux client {self.host}:{self.port} closed")
        # fresh pending map per connection generation: the read loop
        # tears down ONLY its own generation's state, so a stale loop's
        # cleanup can never close a freshly reconnected writer or fail
        # the new connection's in-flight futures
        pending: Dict[int, asyncio.Future] = {}
        self._writer = writer
        self._pending = pending
        from linkerd_tpu_torch.core.tasks import monitor
        self._read_task = monitor(
            asyncio.get_running_loop().create_task(
                self._read_loop(reader, writer, pending)),
            what="mux-client-read-loop")

    async def _read_loop(self, reader: asyncio.StreamReader,
                         writer: asyncio.StreamWriter,
                         pending: Dict[int, asyncio.Future]) -> None:
        try:
            while True:
                msg = await read_mux_frame(reader)
                if msg is None:
                    break
                fut = pending.pop(msg.tag, None)
                if fut is None or fut.done():
                    continue
                if msg.fragment:
                    # fragmentation is never negotiated by this client
                    fut.set_exception(MuxApplicationError(
                        "mux fragmentation not supported"))
                    continue
                if msg.type == RDISPATCH:
                    try:
                        status, payload = decode_rdispatch(msg)
                    except MuxCodecError as e:
                        fut.set_exception(e)
                        continue
                    if status == ROK:
                        fut.set_result(payload)
                    elif status == RNACK:
                        fut.set_exception(
                            ConnectionError("mux backend nack"))
                    else:
                        fut.set_exception(MuxApplicationError(
                            payload.decode("utf-8", "replace")))
                elif msg.type == RERR:
                    fut.set_exception(MuxApplicationError(
                        msg.body.decode("utf-8", "replace")))
                elif msg.type == RPING:
                    fut.set_result(b"")
        except (ConnectionResetError, asyncio.IncompleteReadError,
                MuxCodecError) as e:
            log.debug("mux client read loop: %s", e)
        finally:
            # tear down THIS generation only (see _ensure_conn)
            err = ConnectionError("mux connection closed")
            for fut in pending.values():
                if not fut.done():
                    fut.set_exception(err)
            pending.clear()
            try:
                writer.close()
            except (OSError, RuntimeError):  # transport already detached
                pass
            # generation-guarded: this loop only clears ITS OWN writer;
            # losing the race to a reconnect leaves the newer generation
            # untouched (the identity check makes the write idempotent)
            if self._writer is writer:  # l5d: ignore[lock-guard] — generation identity check; stale loop can only null its own dead writer
                self._writer = None  # l5d: ignore[lock-guard] — see identity check above: newer generations are never clobbered

    def _alloc_tag(self) -> int:
        for _ in range(MAX_TAG):
            tag = self._next_tag
            self._next_tag = self._next_tag % MAX_TAG + 1
            if tag not in self._pending:
                return tag
        raise ConnectionError("mux tags exhausted")

    async def __call__(self, td: Tdispatch) -> bytes:
        self.pending += 1
        try:
            async with self._lock:
                await self._ensure_conn()
                # capture THIS generation's writer+pending: by the time
                # the cancel path runs, a reconnect may have swapped in a
                # new generation that reuses the same tag numbers
                writer = self._writer
                pending = self._pending
                tag = self._alloc_tag()
                fut = asyncio.get_running_loop().create_future()
                pending[tag] = fut
                write_mux_frame(writer, *encode_tdispatch(
                    tag, td.contexts, td.dest, td.dtab, td.payload))
                await writer.drain()
            try:
                return await fut
            except asyncio.CancelledError:
                pending.pop(tag, None)
                # tell the server to abandon the exchange so a late reply
                # can't be misdelivered if the tag is reused (the mux
                # Tdiscarded handshake exists exactly for this)
                if not writer.is_closing():
                    try:
                        write_mux_frame(
                            writer, TDISCARDED, 0,
                            tag.to_bytes(3, "big") + b"canceled")
                    except (OSError, RuntimeError):
                        pass  # best effort: peer is likely gone already
                raise
        finally:
            self.pending -= 1

    async def ping(self) -> None:
        async with self._lock:
            await self._ensure_conn()
            tag = self._alloc_tag()
            fut = asyncio.get_running_loop().create_future()
            self._pending[tag] = fut
            write_mux_frame(self._writer, TPING, tag, b"")
            await self._writer.drain()
        await fut

    async def close(self) -> None:
        # the flag is published BEFORE taking the lock so dispatches
        # already queued on it observe closure in _ensure_conn instead
        # of reconnecting after our teardown
        self._closed = True  # l5d: ignore[lock-guard] — monotonic flag set-before-lock: queued dispatches must see it when they win the lock
        # break any wedged in-flight dispatch BEFORE waiting for the
        # lock (a peer that stopped reading parks drain() forever, and
        # the lock with it): read-only pokes, the owning paths clean up
        task, w = self._read_task, self._writer
        if task is not None:
            task.cancel()
        if w is not None:
            try:
                w.close()
            except (OSError, RuntimeError):  # transport detached
                pass
        async with self._lock:
            # serialize the final teardown with a dispatch that was
            # mid-connect when the flag published: its fresh generation
            # must not outlive close
            if self._read_task is not None:
                self._read_task.cancel()
            if self._writer is not None:
                try:
                    self._writer.close()
                except (OSError, RuntimeError):  # transport detached
                    pass
                self._writer = None
