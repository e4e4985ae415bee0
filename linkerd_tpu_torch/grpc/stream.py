"""Typed gRPC message streams over h2 frame streams.

Ref: grpc/runtime/.../Stream.scala:162 (pull-based typed stream),
DecodingStream.scala (h2 DATA -> messages), ServerDispatcher's
``Stream.Provider`` side. Pull semantics are preserved: consumers ``recv()``
one message at a time. Note: producer-side frames buffer in-process
unbounded (H2Stream queue); h2 flow control throttles only the socket
drain, not the application producer.
"""

from __future__ import annotations

import asyncio
from typing import AsyncIterator, Generic, List, Optional, TypeVar

from linkerd_tpu_torch.grpc.codec import Codec, GrpcFramer
from linkerd_tpu_torch.grpc.status import GrpcError, GrpcStatus, INTERNAL, OK
from linkerd_tpu_torch.protocol.h2.stream import (
    DataFrame, H2Stream, StreamReset, Trailers,
)

T = TypeVar("T")

_END = object()


class GrpcStream(Generic[T]):
    """In-memory typed stream: producer send()/close()/fail(), consumer recv().

    recv() raises ``StopAsyncIteration`` at end-of-stream and ``GrpcError``
    on failure — mirroring Stream.recv's Releasable/end semantics.
    """

    def __init__(self, maxsize: int = 0):
        self._q: asyncio.Queue = asyncio.Queue(maxsize=maxsize)
        self._err: Optional[GrpcError] = None
        self._done = False

    async def send(self, item: T) -> None:
        if self._done:
            raise RuntimeError("send on closed stream")
        await self._q.put(item)

    def close(self) -> None:
        if not self._done:
            self._done = True
            self._q.put_nowait(_END)

    def fail(self, err: GrpcError) -> None:
        if not self._done:
            self._done = True
            self._err = err
            self._q.put_nowait(_END)

    async def recv(self) -> T:
        item = await self._q.get()
        if item is _END:
            self._q.put_nowait(_END)  # keep terminal state observable
            if self._err is not None:
                raise self._err
            raise StopAsyncIteration
        return item

    def __aiter__(self) -> AsyncIterator[T]:
        return self

    async def __anext__(self) -> T:
        return await self.recv()

    @staticmethod
    def of(items: List[T]) -> "GrpcStream[T]":
        s: GrpcStream[T] = GrpcStream()
        for it in items:
            s._q.put_nowait(it)
        s.close()
        return s


class DecodingStream(Generic[T]):
    """Pull typed messages out of an h2 frame stream.

    Reads DATA frames, re-frames gRPC messages across frame boundaries
    (ref: DecodingStream.scala:95), releases h2 frames as they are consumed
    (restoring flow-control window), and resolves the terminal GrpcStatus
    from trailers or reset.
    """

    def __init__(self, h2: H2Stream, codec: Codec):
        self._h2 = h2
        self._codec = codec
        self._framer = GrpcFramer()
        self._ready: List[tuple] = []
        self._status: Optional[GrpcStatus] = None

    @property
    def status(self) -> Optional[GrpcStatus]:
        """Terminal status; None until the stream completes."""
        return self._status

    def resolve_status(self, status: GrpcStatus) -> None:
        """Pre-resolve the terminal status (Trailers-Only responses,
        transport-level failures mapped by the caller)."""
        if self._status is None:
            self._status = status

    async def recv(self) -> T:
        while True:
            if self._ready:
                flag, payload = self._ready.pop(0)
                return self._codec.decode_payload(flag, payload)
            if self._status is not None:
                if not self._status.ok:
                    raise GrpcError(self._status)
                raise StopAsyncIteration
            try:
                frame = await self._h2.read()
            except StreamReset as rst:
                self._status = GrpcStatus.from_reset(rst)
                continue
            if isinstance(frame, DataFrame):
                # release on the exception edge too: a malformed gRPC
                # frame raising out of the re-framer must not strand the
                # h2 flow credit this DATA frame holds
                try:
                    self._ready.extend(self._framer.feed(frame.data))
                    eos = frame.eos
                finally:
                    frame.release()
                if eos and self._status is None:
                    # end without trailers: OK iff no partial message
                    if self._framer.pending_bytes:
                        self._status = GrpcStatus(
                            INTERNAL, "stream ended mid-message "
                            f"({self._framer.pending_bytes}B partial)")
                    else:
                        self._status = GrpcStatus(OK)
            elif isinstance(frame, Trailers):
                try:
                    self._status = GrpcStatus.from_trailers(frame)
                finally:
                    frame.release()
            else:  # pragma: no cover - unknown frame kind
                raise GrpcError.of(13, f"unexpected frame {frame!r}")

    def __aiter__(self) -> AsyncIterator[T]:
        return self

    async def __anext__(self) -> T:
        return await self.recv()

    async def collect(self) -> List[T]:
        out: List[T] = []
        async for m in self:
            out.append(m)
        return out


class EncodingStream:
    """Push typed messages into an h2 frame stream as gRPC frames."""

    def __init__(self, h2: H2Stream, codec: Codec):
        self._h2 = h2
        self._codec = codec

    @property
    def is_broken(self) -> bool:
        """True once the consumer is gone (stream reset) — long-lived
        producers should stop emitting."""
        return self._h2.is_reset

    def send(self, msg) -> None:
        self._h2.offer(DataFrame(self._codec.encode_frame(msg)))

    def close(self, status: GrpcStatus) -> None:
        self._h2.offer(status.to_trailers())

    def close_eos(self) -> None:
        """End with a bare END_STREAM (no trailers) — the wire shape of a
        finished gRPC *request* stream; only responses carry status
        trailers."""
        self._h2.offer(DataFrame(b"", eos=True))

    def fail(self, status: GrpcStatus) -> None:
        self.close(status)
