"""Pull-based HTTP/2 stream model with explicit release() flow control.

Reference parity: finagle/h2/.../Stream.scala:20-246 (pull-based frame
stream; consumers release() each Data frame, which returns flow-control
credit upstream) and BufferedStream.scala:29 (bounded replay buffer that
makes a stream retryable). The release() callback is how WINDOW_UPDATEs
propagate: the connection wires it to its window accounting.
"""

from __future__ import annotations

import asyncio
from typing import Awaitable, Callable, List, Optional, Tuple


class StreamReset(Exception):
    """The stream was reset (RST_STREAM or connection error).

    Reference parity: finagle/h2 Error.scala Reset ADT (Cancel, Refused,
    InternalError, ...).
    """

    def __init__(self, error_code: int = 0x8, message: str = ""):
        super().__init__(message or f"stream reset (code {error_code})")
        self.error_code = error_code


from linkerd_tpu_torch.protocol.h2.frames import (  # noqa: E402
    CANCEL as RST_CANCEL,
    FLOW_CONTROL_ERROR as RST_FLOW_CONTROL_ERROR,
    INTERNAL_ERROR as RST_INTERNAL_ERROR,
    NO_ERROR as RST_NO_ERROR,
    PROTOCOL_ERROR as RST_PROTOCOL_ERROR,
    REFUSED_STREAM as RST_REFUSED_STREAM,
    STREAM_CLOSED as RST_STREAM_CLOSED,
)


class DataFrame:
    """A chunk of stream data; ``release()`` returns its flow credit."""

    __slots__ = ("data", "eos", "_release")

    def __init__(self, data: bytes, eos: bool = False,
                 release: Optional[Callable[[int], None]] = None):
        self.data = data
        self.eos = eos
        self._release = release

    def release(self) -> None:
        r, self._release = self._release, None
        if r is not None and self.data:
            r(len(self.data))

    def __repr__(self) -> str:
        return f"DataFrame({len(self.data)}B, eos={self.eos})"


class Trailers:
    """End-of-stream trailing headers (gRPC status rides here)."""

    __slots__ = ("headers",)
    eos = True

    def __init__(self, headers: List[Tuple[str, str]]):
        self.headers = headers

    def release(self) -> None:
        return

    def __repr__(self) -> str:
        return f"Trailers({self.headers})"


Frame = "DataFrame | Trailers"


class H2Stream:
    """An async pull queue of DataFrame/Trailers.

    Producers ``offer`` frames; the consumer ``read()``s them one at a
    time. A reset propagates to both sides. ``at_end`` is True once a
    frame with eos has been read.

    Implemented on a plain deque + single-waiter future (streams have
    exactly one consumer) — measurably cheaper per stream than an
    asyncio.Queue on the request hot path.
    """

    __slots__ = ("_q", "_waiter", "_reset", "at_end", "_ended_write")

    def __init__(self) -> None:
        from collections import deque
        self._q = deque()
        self._waiter: Optional[asyncio.Future] = None
        self._reset: Optional[StreamReset] = None
        self.at_end = False
        self._ended_write = False

    def _wake(self) -> None:
        w = self._waiter
        if w is not None:
            self._waiter = None
            if not w.done():
                w.set_result(None)

    # -- producer ---------------------------------------------------------
    def offer(self, frame) -> None:
        if self._reset is not None or self._ended_write:
            frame.release()  # don't strand flow credit
            return
        if frame.eos:
            self._ended_write = True
        self._q.append(frame)
        self._wake()

    def reset(self, error_code: int = RST_CANCEL, message: str = "") -> None:
        if self._reset is None:
            self._reset = StreamReset(error_code, message)
            self._q.append(self._reset)
            self._wake()

    # -- consumer ---------------------------------------------------------
    async def read(self):
        """Next frame; raises StreamReset after a reset."""
        while True:
            item = self.read_nowait()
            if item is not None:
                return item
            if self._reset is not None:
                raise self._reset
            self._waiter = asyncio.get_running_loop().create_future()
            await self._waiter

    def read_nowait(self):
        """Next frame if one is queued, else None (never suspends) —
        lets consumers that would otherwise wrap read() in wait_for (a
        task + timer per call) take the common already-buffered frames
        synchronously."""
        if self.at_end:
            raise EOFError("stream already ended")
        if not self._q:
            return None
        item = self._q.popleft()
        if isinstance(item, StreamReset):
            self._q.append(item)  # keep terminal state observable
            raise item
        if item.eos:
            self.at_end = True
        return item

    async def read_all(self, max_bytes: int = 1 << 26) -> Tuple[bytes, Optional[Trailers]]:
        """Drain the stream into (body, trailers) — the unary-message path."""
        chunks: List[bytes] = []
        total = 0
        trailers: Optional[Trailers] = None
        while not self.at_end:
            frame = await self.read()
            if isinstance(frame, Trailers):
                trailers = frame
            else:
                total += len(frame.data)
                if total > max_bytes:
                    self.reset(RST_CANCEL, "body too large")
                    raise StreamReset(RST_CANCEL, "body too large")
                chunks.append(frame.data)
                frame.release()
        return b"".join(chunks), trailers

    @property
    def is_reset(self) -> bool:
        return self._reset is not None


def stream_of(body: bytes = b"",
              trailers: Optional[List[Tuple[str, str]]] = None) -> H2Stream:
    """A pre-filled stream (the Stream.const of the reference)."""
    s = H2Stream()
    if trailers is not None:
        if body:
            s.offer(DataFrame(body, eos=False))
        s.offer(Trailers(trailers))
    else:
        s.offer(DataFrame(body, eos=True))
    return s


async def pump(src: H2Stream,
               write: Callable[["DataFrame | Trailers"], Awaitable[None]]
               ) -> None:
    """Copy frames from ``src`` into an async writer until EOS."""
    while not src.at_end:
        frame = await src.read()
        await write(frame)


class BufferedStream:
    """Tees a source stream while buffering up to ``capacity`` bytes so the
    consumer can be replayed (enables retrying streaming requests).

    Reference parity: finagle/h2/.../BufferedStream.scala:29 (8KB default);
    used by router/h2 ClassifiedRetryFilter.scala:237. Once the buffer
    overflows, ``discard_buffer()`` semantics apply: no further forks.
    """

    DEFAULT_CAPACITY = 8 * 1024

    def __init__(self, source: H2Stream, capacity: int = DEFAULT_CAPACITY):
        self._source = source
        self.capacity = capacity
        self._buffer: List = []  # (bytes, eos) | Trailers
        self._buffered_bytes = 0
        self.overflowed = False
        self._pump_task: Optional[asyncio.Task] = None
        self._forks: List[H2Stream] = []
        self._done = False

    def fork(self) -> H2Stream:
        """A fresh consumer stream replaying the buffer then following live.

        Raises RuntimeError once the buffer has overflowed.
        """
        if self.overflowed:
            raise RuntimeError("buffer discarded (overflow); cannot fork")
        out = H2Stream()
        for item in self._buffer:
            if isinstance(item, Trailers):
                out.offer(Trailers(list(item.headers)))
            else:
                data, eos = item
                out.offer(DataFrame(data, eos))
        self._forks.append(out)
        if self._pump_task is None and not self._done:
            self._pump_task = asyncio.get_running_loop().create_task(
                self._pump())
        return out

    async def _pump(self) -> None:
        try:
            while not self._source.at_end:
                frame = await self._source.read()
                if isinstance(frame, Trailers):
                    self._record(frame)
                    for f in self._forks:
                        f.offer(Trailers(list(frame.headers)))
                else:
                    self._record((frame.data, frame.eos))
                    for f in self._forks:
                        f.offer(DataFrame(frame.data, frame.eos))
                    # Credit flows back as soon as we've buffered — the
                    # buffer bound (not the consumer) is the backpressure.
                    frame.release()
            self._done = True
        except StreamReset as e:
            for f in self._forks:
                f.reset(e.error_code, str(e))

    def _record(self, item) -> None:
        size = len(item[0]) if isinstance(item, tuple) else 0
        if self._buffered_bytes + size > self.capacity:
            self.overflowed = True
            self._buffer.clear()
        elif not self.overflowed:
            self._buffer.append(item)
            self._buffered_bytes += size

    def release_buffer(self) -> None:
        """Stop buffering (no further forks) but keep pumping live frames
        to existing forks — used once a response is committed and replay
        will never be needed (ref: BufferedStream discardBuffer)."""
        self.overflowed = True
        self._buffer.clear()
        self._buffered_bytes = 0

    def unfork(self, stream: H2Stream) -> None:
        """Detach an abandoned consumer (e.g. a failed attempt's request
        stream) so its queue stops accumulating frames."""
        if stream in self._forks:
            self._forks.remove(stream)

    async def close(self) -> None:
        if self._pump_task is not None:
            self._pump_task.cancel()
            try:
                await self._pump_task
            except (asyncio.CancelledError, StreamReset):
                pass
