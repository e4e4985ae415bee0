"""HTTP/2 connection engine: multiplexed streams on one asyncio transport.

Reference parity: finagle/h2/.../netty4/Netty4DispatcherBase.scala,
Netty4ClientDispatcher.scala, Netty4ServerDispatcher.scala (stream-id
allocation, GOAWAY, ping) and Netty4StreamTransport.scala:53-70 (the RFC
7540 §5.1 stream state machine). One engine class serves both roles; the
client allocates odd stream ids, the server even (we never push).

Flow control: the peer's send rate into us is bounded by the windows we
advertise; credit returns when the application release()s DataFrames
(the reference's Stream.release() semantics, Stream.scala:20). Our send
rate is bounded by peer windows; senders block on a condition until
WINDOW_UPDATE arrives.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Awaitable, Callable, Dict, List, Optional, Tuple

from linkerd_tpu_torch.core.tasks import monitor, spawn
from linkerd_tpu_torch.protocol.h2 import frames, hpack
from linkerd_tpu_torch.protocol.h2.frames import (
    CONNECTION_PREFACE, DEFAULT_INITIAL_WINDOW, DEFAULT_MAX_FRAME_SIZE,
    H2ProtocolError,
)
from linkerd_tpu_torch.protocol.h2.messages import H2Request, H2Response
from linkerd_tpu_torch.protocol.h2.stream import (
    DataFrame, H2Stream, StreamReset, Trailers,
)

log = logging.getLogger(__name__)

# We advertise a 1MB stream window (SETTINGS) and grow the connection
# window to 4MB — long-haul streams shouldn't stall on the default 64KB
# (ref: flow-control window params, finagle/h2/.../param.scala).
LOCAL_INITIAL_WINDOW = 1 << 20
LOCAL_CONN_WINDOW = 4 << 20
MAX_HEADER_LIST = 64 * 1024
# Deferred-credit thresholds: WINDOW_UPDATEs are batched until this much
# credit is pending, collapsing the per-DATA-frame update chatter (2 tiny
# frames per received chunk) into one update per ~half window.
CONN_CREDIT_THRESHOLD = LOCAL_CONN_WINDOW // 4
STREAM_CREDIT_THRESHOLD = LOCAL_INITIAL_WINDOW // 2
# Transport write buffer size above which senders yield to drain().
WRITE_HIGH_WATER = 256 * 1024
READ_CHUNK = 1 << 18


class _StreamState:
    __slots__ = ("id", "recv_stream", "send_window", "recv_window",
                 "send_closed", "recv_closed", "got_headers",
                 "response_fut", "pump_task", "reset_sent",
                 "pending_credit")

    def __init__(self, sid: int, send_window: int, recv_window: int):
        self.id = sid
        self.recv_stream = H2Stream()
        self.send_window = send_window
        self.recv_window = recv_window
        self.send_closed = False
        self.recv_closed = False
        self.got_headers = False      # first HEADERS seen (vs trailers)
        self.response_fut: Optional[asyncio.Future] = None
        self.pump_task: Optional[asyncio.Task] = None
        self.reset_sent = False
        self.pending_credit = 0       # released but not yet WINDOW_UPDATEd


class H2Connection:
    def __init__(self, reader: asyncio.StreamReader,
                 writer: asyncio.StreamWriter, is_client: bool,
                 handler: Optional[Callable[[H2Request],
                                            Awaitable[H2Response]]] = None,
                 huffman: bool = False,
                 initial_window: int = LOCAL_INITIAL_WINDOW,
                 max_frame: int = DEFAULT_MAX_FRAME_SIZE,
                 max_header_list: int = MAX_HEADER_LIST,
                 max_concurrent_streams: Optional[int] = None,
                 preface_consumed: bool = False,
                 initial_data: bytes = b"",
                 observer=None):
        self._reader = reader
        self._writer = writer
        self.is_client = is_client
        self._handler = handler
        # stream sentinel (server side): an H2FrameObserver fed every
        # DATA / WINDOW_UPDATE / RST so long-lived streams are scored
        # mid-flight (linkerd_tpu/streams); None = no stream scoring
        self._observer = observer.bind(self) if observer is not None \
            else None
        # server side: the listener already consumed the client preface
        # while sniffing prior-knowledge h2c vs an h1 Upgrade
        # (ref: ServerUpgradeHandler.scala channelRead); bytes it
        # over-read past the preface seed the frame loop
        self._preface_consumed = preface_consumed
        self._initial_data = initial_data
        # advertised SETTINGS (ref: finagle/h2 param.scala — configurable
        # per router via initialStreamWindowBytes/maxFrameBytes/
        # maxHeaderListBytes/maxConcurrentStreamsPerConnection)
        self._local_initial_window = initial_window
        self._local_max_frame = max_frame
        self._max_header_list = max_header_list
        self._max_concurrent = max_concurrent_streams
        self._stream_credit_threshold = max(1, initial_window // 2)
        # the connection window must dominate the stream window or a
        # single long-haul stream stalls below its advertised window
        self._local_conn_window = max(LOCAL_CONN_WINDOW, 4 * initial_window)
        self._conn_credit_threshold = max(1, self._local_conn_window // 4)
        self._encoder = hpack.Encoder(huffman=huffman)
        self._decoder = hpack.Decoder()
        self._streams: Dict[int, _StreamState] = {}
        self._next_stream_id = 1 if is_client else 2
        self._send_window = DEFAULT_INITIAL_WINDOW
        self._recv_window = DEFAULT_INITIAL_WINDOW
        self._peer_initial_window = DEFAULT_INITIAL_WINDOW
        self._peer_max_frame = DEFAULT_MAX_FRAME_SIZE
        self._window_cond = asyncio.Condition()
        self._read_task: Optional[asyncio.Task] = None
        self._closed = False
        self.goaway_received = False
        self._last_peer_stream = 0
        self._settings_acked = asyncio.Event()
        self._handler_tasks: set = set()
        self._refused: set = set()  # recently REFUSED_STREAM ids
        self._peer_max_concurrent: Optional[int] = None
        self._slot_waiters: List[asyncio.Future] = []
        # contiguous header-block assembly state
        self._hdr_accum: Optional[Tuple[int, int, bytearray]] = None
        # write coalescing: frames written within one event-loop iteration
        # are batched into a single transport write (one send() syscall)
        self._wbuf = bytearray()
        self._flush_scheduled = False
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._pending_conn_credit = 0

    # ── coalesced writes ─────────────────────────────────────────────────
    def _write(self, data: bytes) -> None:
        self._wbuf += data
        if not self._flush_scheduled:
            self._flush_scheduled = True
            self._loop.call_soon(self._do_flush)

    def _do_flush(self) -> None:
        self._flush_scheduled = False
        if self._wbuf:
            data, self._wbuf = self._wbuf, bytearray()
            try:
                self._writer.write(data)
            except (OSError, RuntimeError):  # transport torn down
                pass

    async def _drain(self) -> None:
        """Flush now; apply backpressure only when the transport buffer is
        actually backed up (plain drain() is an unconditional await)."""
        self._do_flush()
        try:
            if (self._writer.transport.get_write_buffer_size()
                    > WRITE_HIGH_WATER):
                await self._writer.drain()
        except (OSError, RuntimeError):  # transport torn down mid-drain
            pass

    # ── lifecycle ────────────────────────────────────────────────────────
    async def start(self) -> "H2Connection":
        self._loop = asyncio.get_running_loop()
        settings = [
            (frames.SETTINGS_INITIAL_WINDOW_SIZE,
             self._local_initial_window),
            (frames.SETTINGS_MAX_FRAME_SIZE, self._local_max_frame),
            (frames.SETTINGS_MAX_HEADER_LIST_SIZE, self._max_header_list),
        ]
        if self._max_concurrent is not None:
            settings.append((frames.SETTINGS_MAX_CONCURRENT_STREAMS,
                             self._max_concurrent))
        if self.is_client:
            self._write(CONNECTION_PREFACE)
            settings.append((frames.SETTINGS_ENABLE_PUSH, 0))
        elif not self._preface_consumed:
            preface = await self._reader.readexactly(len(CONNECTION_PREFACE))
            if preface != CONNECTION_PREFACE:
                raise H2ProtocolError(frames.PROTOCOL_ERROR, "bad preface")
        self._write(frames.pack_settings(settings))
        self._write(frames.pack_window_update(
            0, self._local_conn_window - DEFAULT_INITIAL_WINDOW))
        self._recv_window = self._local_conn_window
        await self._drain()
        # a crashed read loop must be loud: it looks exactly like a hung
        # peer from the application side
        self._read_task = monitor(
            self._loop.create_task(self._read_loop()), what="h2-read-loop")
        return self

    @property
    def is_closed(self) -> bool:
        return self._closed

    @property
    def active_streams(self) -> int:
        return len(self._streams)

    async def close(self, code: int = frames.NO_ERROR) -> None:
        first = not self._closed
        self._closed = True
        if first:
            try:
                self._wbuf += frames.pack_goaway(self._last_peer_stream, code)
                self._do_flush()
                await self._drain()
            except (OSError, RuntimeError):  # peer already gone
                pass
        if self._read_task is not None and not self._read_task.done():
            self._read_task.cancel()
            try:
                await self._read_task
            except asyncio.CancelledError:
                pass
            except Exception as e:  # noqa: BLE001 — already closing, but
                log.debug("h2 read loop exit on close: %r", e)  # be loud-ish
        self._fail_all(StreamReset(frames.CANCEL, "connection closed"))
        if self._observer is not None:
            self._observer.close()
        for t in list(self._handler_tasks):
            t.cancel()
        # Always close the transport, even if the read loop already marked
        # us closed on EOF — a still-attached transport wedges
        # Server.wait_closed().
        try:
            self._writer.close()
        except (OSError, RuntimeError):  # transport already detached
            pass

    def _fail_all(self, err: StreamReset) -> None:
        for st in list(self._streams.values()):
            st.recv_stream.reset(err.error_code, str(err))
            if st.response_fut is not None and not st.response_fut.done():
                st.response_fut.set_exception(
                    StreamReset(err.error_code, str(err)))
            if st.pump_task is not None:
                st.pump_task.cancel()
        self._streams.clear()
        for w in self._slot_waiters:
            if not w.done():
                w.set_result(None)
        self._slot_waiters.clear()
        # wake any senders blocked on flow-control so they observe closure
        spawn(self._notify_windows(), what="h2-notify-windows-close")

    # ── client API ───────────────────────────────────────────────────────
    async def request(self, req: H2Request) -> H2Response:
        """Dispatch one request; resolves when response HEADERS arrive.

        The response body streams through rsp.stream afterwards
        (ref: Netty4ClientDispatcher request/response offer).
        """
        assert self.is_client
        if self._closed or self.goaway_received:
            raise ConnectionError("h2 connection closed/goaway")
        # honor the peer's advertised concurrent-stream limit: wait for a
        # slot instead of provoking REFUSED_STREAM failures
        while (self._peer_max_concurrent is not None
               and len(self._streams) >= self._peer_max_concurrent):
            waiter = asyncio.get_running_loop().create_future()
            self._slot_waiters.append(waiter)
            await waiter
            if self._closed or self.goaway_received:
                raise ConnectionError("h2 connection closed/goaway")
        sid = self._next_stream_id
        self._next_stream_id += 2
        st = _StreamState(sid, self._peer_initial_window,
                          self._local_initial_window)
        st.response_fut = asyncio.get_running_loop().create_future()
        self._streams[sid] = st

        body = _poll_const_body(req.stream)
        if body is not None:
            data, trailers = body
            if trailers is None and not data:
                self._send_headers(sid, req.to_header_list(), end_stream=True)
            else:
                self._send_headers(sid, req.to_header_list(),
                                   end_stream=False)
                if data:
                    await self._send_data(st, data, eos=trailers is None)
                if trailers is not None:
                    self._send_headers(sid, trailers, end_stream=True)
            st.send_closed = True
            await self._drain()
        else:
            self._send_headers(sid, req.to_header_list(), end_stream=False)
            await self._drain()
            st.pump_task = asyncio.get_running_loop().create_task(
                self._pump_out(st, req.stream))
        try:
            rsp: H2Response = await st.response_fut
        except BaseException:
            if st.pump_task is not None:
                st.pump_task.cancel()
            if not st.reset_sent and sid in self._streams:
                self._rst(st, frames.CANCEL)
            raise
        return rsp

    # ── internals: sending ───────────────────────────────────────────────
    def _send_headers(self, sid: int, header_list: List[Tuple[str, str]],
                      end_stream: bool) -> None:
        # encode + write must not interleave with another encode (shared
        # HPACK dynamic table); both are synchronous here, which is the
        # serialization (single event loop, no await between them).
        block = self._encoder.encode(header_list)
        flags = frames.FLAG_END_HEADERS | (
            frames.FLAG_END_STREAM if end_stream else 0)
        max_frag = self._peer_max_frame
        if len(block) <= max_frag:
            self._write(frames.pack_frame(
                frames.HEADERS, flags, sid, block))
        else:
            first, rest = block[:max_frag], block[max_frag:]
            self._write(frames.pack_frame(
                frames.HEADERS,
                flags & ~frames.FLAG_END_HEADERS, sid, first))
            while rest:
                frag, rest = rest[:max_frag], rest[max_frag:]
                cflags = frames.FLAG_END_HEADERS if not rest else 0
                self._write(frames.pack_frame(
                    frames.CONTINUATION, cflags, sid, frag))

    async def _pump_out(self, st: _StreamState, stream: H2Stream) -> None:
        """Copy an app stream into DATA/trailer frames w/ flow control."""
        try:
            while not stream.at_end:
                frame = await stream.read()
                if isinstance(frame, Trailers):
                    self._send_headers(st.id, frame.headers, end_stream=True)
                    st.send_closed = True
                    await self._drain()
                    break
                await self._send_data(st, frame.data, frame.eos)
                frame.release()
                if frame.eos:
                    st.send_closed = True
        except StreamReset as e:
            if not st.reset_sent:
                self._rst(st, e.error_code)
            # peer RST'd an active stream: the producer must see it too
            stream.reset(e.error_code, "consumer gone")
        except (ConnectionError, asyncio.CancelledError):
            # consumer is gone (peer RST / connection teardown): reset the
            # app-side source so long-lived producers (e.g. gRPC watch
            # streams) observe the death instead of pumping into the void
            stream.reset(frames.CANCEL, "consumer gone")
        except Exception:  # noqa: BLE001
            log.exception("h2 outbound pump failed (stream %d)", st.id)
            if not st.reset_sent:
                self._rst(st, frames.INTERNAL_ERROR)
            stream.reset(frames.INTERNAL_ERROR, "pump failed")
        finally:
            self._maybe_gc(st)

    async def _send_data(self, st: _StreamState, data: bytes,
                         eos: bool) -> None:
        if eos and not data:
            # an empty END_STREAM DATA frame consumes no flow-control
            # credit, so it may be sent even when a window is negative
            # (peer shrank SETTINGS_INITIAL_WINDOW_SIZE, RFC 7540 §6.9.2)
            if st.reset_sent or st.id not in self._streams:
                raise StreamReset(frames.STREAM_CLOSED, "stream reset")
            self._write(frames.pack_frame(
                frames.DATA, frames.FLAG_END_STREAM, st.id, b""))
            await self._drain()
            return
        view = memoryview(data)
        offset = 0
        while offset < len(data):
            if self._closed:
                raise ConnectionError("connection closed")
            n = max(0, min(len(data) - offset, self._peer_max_frame,
                           self._send_window, st.send_window))
            if st.reset_sent or st.id not in self._streams:
                raise StreamReset(frames.STREAM_CLOSED, "stream reset")
            if n <= 0:
                async with self._window_cond:
                    await self._window_cond.wait()
                continue
            chunk = bytes(view[offset:offset + n])
            offset += n
            last = offset >= len(data)
            self._send_window -= n
            st.send_window -= n
            self._write(frames.pack_frame(
                frames.DATA,
                frames.FLAG_END_STREAM if (eos and last) else 0,
                st.id, chunk))
            await self._drain()
            if last:
                break

    def _rst(self, st: _StreamState, code: int) -> None:
        st.reset_sent = True
        self._wake_slot()
        if not self._closed:
            try:
                self._write(frames.pack_rst(st.id, code))
            except (OSError, RuntimeError):  # transport torn down
                pass
        st.recv_stream.reset(code)
        self._streams.pop(st.id, None)
        if self._observer is not None:
            self._observer.on_close(st.id)

    def shed_stream(self, sid: int,
                    code: int = frames.ENHANCE_YOUR_CALM) -> bool:
        """Mid-stream actuation entry point (stream sentinel): RST a
        live stream without touching the connection. Returns False when
        the stream is already gone."""
        st = self._streams.get(sid)
        if st is None or self._closed:
            return False
        if st.pump_task is not None:
            st.pump_task.cancel()
        if st.response_fut is not None and not st.response_fut.done():
            st.response_fut.set_exception(
                StreamReset(code, "stream shed"))
        self._rst(st, code)
        return True

    async def _notify_windows(self) -> None:
        async with self._window_cond:
            self._window_cond.notify_all()

    def _conn_credit(self, n: int) -> None:
        """Batch connection-level WINDOW_UPDATEs until a threshold of
        credit is pending (the stream-update twin lives in _on_data)."""
        self._recv_window += n
        self._pending_conn_credit += n
        if self._pending_conn_credit >= self._conn_credit_threshold:
            self._write(frames.pack_window_update(
                0, self._pending_conn_credit))
            self._pending_conn_credit = 0

    # ── internals: receiving ─────────────────────────────────────────────
    async def _read_loop(self) -> None:
        # Batched frame parsing: read whatever the transport has (many
        # frames arrive per wakeup under load) and walk complete frames in
        # the buffer — two readexactly() awaits per frame becomes one
        # read() per TCP burst.
        read = self._reader.read
        buf = bytearray(self._initial_data)
        self._initial_data = b""
        # seeded bytes must be processed BEFORE the first read: waiting
        # for more transport data while the peer's SETTINGS already sit
        # in the buffer would deadlock the handshake
        skip_read = bool(buf)
        FrameHeader = frames.FrameHeader
        CONTINUATION = frames.CONTINUATION
        try:
            while not self._closed:
                if skip_read:
                    skip_read = False
                else:
                    chunk = await read(READ_CHUNK)
                    if not chunk:
                        raise EOFError("connection closed by peer")
                    buf += chunk
                pos = 0
                n = len(buf)
                while n - pos >= 9:
                    length = (buf[pos] << 16) | (buf[pos + 1] << 8) | buf[pos + 2]
                    if length > self._local_max_frame + 1024:
                        raise H2ProtocolError(frames.FRAME_SIZE_ERROR,
                                              f"frame too large: {length}")
                    end = pos + 9 + length
                    if n < end:
                        break
                    ftype = buf[pos + 3]
                    fh = FrameHeader(
                        length, ftype, buf[pos + 4],
                        ((buf[pos + 5] << 24) | (buf[pos + 6] << 16)
                         | (buf[pos + 7] << 8) | buf[pos + 8]) & 0x7FFFFFFF)
                    payload = bytes(buf[pos + 9:end]) if length else b""
                    pos = end
                    # CONTINUATION contiguity (RFC 7540 §6.2)
                    if self._hdr_accum is not None and ftype != CONTINUATION:
                        raise H2ProtocolError(frames.PROTOCOL_ERROR,
                                              "expected CONTINUATION")
                    await self._dispatch(fh, payload)
                if pos:
                    del buf[:pos]
        except (asyncio.IncompleteReadError, ConnectionResetError,
                BrokenPipeError, EOFError):
            self._closed = True
            self._fail_all(StreamReset(frames.CANCEL, "connection lost"))
            try:
                self._writer.close()
            except (OSError, RuntimeError):  # transport already detached
                pass
        except asyncio.CancelledError:
            raise
        except H2ProtocolError as e:
            log.warning("h2 protocol error: %s", e)
            self._closed = True
            try:
                self._write(frames.pack_goaway(
                    self._last_peer_stream, e.code))
                await self._drain()
                self._writer.close()
            except (OSError, RuntimeError):  # peer already gone
                pass
            self._fail_all(StreamReset(frames.PROTOCOL_ERROR, str(e)))
        except Exception:  # noqa: BLE001
            log.exception("h2 read loop crashed")
            self._closed = True  # l5d: ignore[await-atomicity] — monotonic teardown flag in an exclusive except arm; the loop test re-reads it every iteration and close() is idempotent
            self._fail_all(StreamReset(frames.INTERNAL_ERROR, "read loop"))

    async def _dispatch(self, fh: frames.FrameHeader, payload: bytes) -> None:
        t = fh.type
        if t == frames.DATA:
            await self._on_data(fh, payload)
        elif t == frames.HEADERS:
            payload = frames.strip_padding(fh.flags, payload)
            if fh.flags & frames.FLAG_PRIORITY:
                payload = payload[5:]
            if fh.flags & frames.FLAG_END_HEADERS:
                self._on_header_block(fh.stream_id, payload,
                                      bool(fh.flags & frames.FLAG_END_STREAM))
            else:
                self._hdr_accum = (fh.stream_id,
                                   fh.flags & frames.FLAG_END_STREAM,
                                   bytearray(payload))
        elif t == frames.CONTINUATION:
            if self._hdr_accum is None or self._hdr_accum[0] != fh.stream_id:
                raise H2ProtocolError(frames.PROTOCOL_ERROR,
                                      "unexpected CONTINUATION")
            sid, es_flag, buf = self._hdr_accum
            buf += payload
            if len(buf) > self._max_header_list * 2:
                raise H2ProtocolError(frames.ENHANCE_YOUR_CALM,
                                      "header block too large")
            if fh.flags & frames.FLAG_END_HEADERS:
                self._hdr_accum = None
                self._on_header_block(sid, bytes(buf), bool(es_flag))
        elif t == frames.SETTINGS:
            if fh.flags & frames.FLAG_ACK:
                self._settings_acked.set()
                return
            self._apply_settings(frames.unpack_settings(payload))
            self._write(frames.pack_settings([], ack=True))
        elif t == frames.WINDOW_UPDATE:
            if len(payload) != 4:
                raise H2ProtocolError(frames.FRAME_SIZE_ERROR, "bad WU size")
            inc = int.from_bytes(payload, "big") & 0x7FFFFFFF
            if inc == 0:
                raise H2ProtocolError(frames.PROTOCOL_ERROR, "WU of 0")
            if fh.stream_id == 0:
                self._send_window += inc
            else:
                st = self._streams.get(fh.stream_id)
                if st is not None:
                    st.send_window += inc
                    if self._observer is not None:
                        self._observer.on_frame(
                            st.id, 1, 0)  # FRAME_WINDOW_UPDATE
            await self._notify_windows()
        elif t == frames.RST_STREAM:
            code = int.from_bytes(payload[:4], "big")
            st = self._streams.pop(fh.stream_id, None)
            if st is not None and self._observer is not None:
                # a peer reset is the anomaly signal itself; fold it in
                # before the slot is retired
                self._observer.on_frame(st.id, 2, 0)  # FRAME_ANOMALY
                self._observer.on_close(st.id)
            if st is not None:
                st.reset_sent = True  # no further sends on this stream
                st.recv_stream.reset(code, f"peer RST ({code:#x})")
                if st.response_fut is not None and not st.response_fut.done():
                    st.response_fut.set_exception(StreamReset(code, "peer RST"))
                if st.pump_task is not None:
                    st.pump_task.cancel()
                # wake any sender parked on flow control for this stream
                await self._notify_windows()
        elif t == frames.PING:
            if not fh.flags & frames.FLAG_ACK:
                self._write(frames.pack_ping(payload[:8], ack=True))
        elif t == frames.GOAWAY:
            self.goaway_received = True
            last_sid = int.from_bytes(payload[:4], "big") & 0x7FFFFFFF
            # fail only streams the peer will never process
            for sid in list(self._streams):
                if self.is_client and sid > last_sid:
                    st = self._streams.pop(sid)
                    err = StreamReset(frames.REFUSED_STREAM, "goaway")
                    st.recv_stream.reset(err.error_code, str(err))
                    if st.response_fut is not None and not st.response_fut.done():
                        st.response_fut.set_exception(err)
        elif t in (frames.PRIORITY, frames.PUSH_PROMISE):
            if t == frames.PUSH_PROMISE:
                raise H2ProtocolError(frames.PROTOCOL_ERROR,
                                      "push not enabled")
        # unknown frame types are ignored (RFC 7540 §4.1)

    async def _on_data(self, fh: frames.FrameHeader, payload: bytes) -> None:
        data = frames.strip_padding(fh.flags, payload)
        flow = len(payload)  # padding counts toward flow control
        self._recv_window -= flow
        eos = bool(fh.flags & frames.FLAG_END_STREAM)
        st = self._streams.get(fh.stream_id)
        if st is None or st.recv_closed:
            # stream gone (e.g. reset); return the connection credit we
            # just consumed (local accounting AND the peer's view)
            if flow:
                self._conn_credit(flow)
            return
        st.recv_window -= flow
        if st.recv_window < 0 or self._recv_window < 0:
            if self._observer is not None:
                # flow-control violation is a stream anomaly (the
                # feature the sentinel keys hostile senders on)
                self._observer.on_frame(st.id, 2, 0)  # FRAME_ANOMALY
            raise H2ProtocolError(frames.FLOW_CONTROL_ERROR,
                                  "peer overran window")
        if self._observer is not None:
            self._observer.on_frame(st.id, 0, flow)  # FRAME_DATA
            if st.id not in self._streams:
                # the sentinel shed this stream mid-sample: return the
                # connection credit this frame consumed (it will never
                # be offered, so release() can't) and stop delivering
                if flow:
                    self._conn_credit(flow)
                return
        sid = st.id

        def credit(n: int, _sid: int = sid) -> None:
            # called from app-land release(); returns window to the peer.
            # Credit is batched (thresholded) rather than sent per frame.
            if self._closed:
                return
            try:
                self._conn_credit(n)
                stt = self._streams.get(_sid)
                if stt is not None and not stt.recv_closed:
                    stt.recv_window += n
                    stt.pending_credit += n
                    if stt.pending_credit >= self._stream_credit_threshold:
                        self._write(frames.pack_window_update(
                            _sid, stt.pending_credit))
                        stt.pending_credit = 0
            except Exception as e:  # noqa: BLE001 — app-land release()
                # must never throw into the consumer, but a failed
                # credit return wedges the peer's send window: say so
                log.debug("h2 credit return failed (stream %d): %r",
                          _sid, e)

        st.recv_stream.offer(DataFrame(data, eos, release=credit))
        if eos:
            st.recv_closed = True
            self._maybe_gc(st)

    def _on_header_block(self, sid: int, block: bytes, end_stream: bool) -> None:
        try:
            headers = self._decoder.decode(block)
        except hpack.HpackError as e:
            raise H2ProtocolError(frames.COMPRESSION_ERROR, str(e)) from e
        st = self._streams.get(sid)
        if self.is_client:
            if st is None:
                return  # stale/reset stream
            if not st.got_headers:
                st.got_headers = True
                status = next((v for n, v in headers if n == ":status"), "200")
                if status.startswith("1"):  # 1xx interim: not final
                    st.got_headers = False
                    return
                rsp = H2Response.from_header_list(headers)
                rsp.stream = st.recv_stream
                if end_stream:
                    st.recv_stream.offer(DataFrame(b"", eos=True))
                    st.recv_closed = True
                if st.response_fut is not None and not st.response_fut.done():
                    st.response_fut.set_result(rsp)
                self._maybe_gc(st)
            else:  # trailers
                st.recv_stream.offer(Trailers(headers))
                st.recv_closed = True
                self._maybe_gc(st)
        else:
            if st is None:
                if sid in self._refused:
                    return  # trailing frames of a refused stream (§5.1)
                if sid <= self._last_peer_stream or sid % 2 == 0:
                    raise H2ProtocolError(frames.PROTOCOL_ERROR,
                                          f"bad stream id {sid}")
                self._last_peer_stream = sid
                if (self._max_concurrent is not None
                        and len(self._streams) >= self._max_concurrent):
                    # over our advertised limit: refuse, not kill the conn
                    self._write(frames.pack_rst(sid, frames.REFUSED_STREAM))
                    if len(self._refused) > 64:
                        self._refused.clear()
                    self._refused.add(sid)
                    return
                st = _StreamState(sid, self._peer_initial_window,
                                  self._local_initial_window)
                st.got_headers = True
                self._streams[sid] = st
                req = H2Request.from_header_list(headers)
                req.stream = st.recv_stream
                if end_stream:
                    st.recv_stream.offer(DataFrame(b"", eos=True))
                    st.recv_closed = True
                task = asyncio.get_running_loop().create_task(
                    self._serve_stream(st, req))
                self._handler_tasks.add(task)
                task.add_done_callback(self._handler_tasks.discard)
            else:  # request trailers
                st.recv_stream.offer(Trailers(headers))
                st.recv_closed = True

    async def _serve_stream(self, st: _StreamState, req: H2Request) -> None:
        """Run the app handler for one server stream and write its response
        (ref: Netty4ServerDispatcher serve)."""
        try:
            rsp = await self._handler(req)
        except StreamReset as e:
            self._rst(st, e.error_code)
            return
        except Exception:  # noqa: BLE001
            log.exception("h2 handler error (stream %d)", st.id)
            if st.id in self._streams and not self._closed:
                self._send_headers(st.id, [(":status", "500")],
                                   end_stream=True)
                st.send_closed = True
                try:
                    await self._drain()
                except (OSError, RuntimeError):  # peer already gone
                    pass
                self._maybe_gc(st)
            return
        if self._closed or st.id not in self._streams:
            return
        body = _poll_const_body(rsp.stream)
        try:
            if body is not None:
                data, trailers = body
                if trailers is None:
                    if data:
                        self._send_headers(st.id, rsp.to_header_list(),
                                           end_stream=False)
                        await self._send_data(st, data, eos=True)
                    else:
                        self._send_headers(st.id, rsp.to_header_list(),
                                           end_stream=True)
                else:
                    self._send_headers(st.id, rsp.to_header_list(),
                                       end_stream=False)
                    if data:
                        await self._send_data(st, data, eos=False)
                    self._send_headers(st.id, trailers, end_stream=True)
                st.send_closed = True
                await self._drain()
                self._maybe_gc(st)
            else:
                self._send_headers(st.id, rsp.to_header_list(),
                                   end_stream=False)
                await self._drain()
                await self._pump_out(st, rsp.stream)
        except (ConnectionError, asyncio.CancelledError):
            pass

    def _maybe_gc(self, st: _StreamState) -> None:
        if st.recv_closed and st.send_closed:
            self._streams.pop(st.id, None)
            self._wake_slot()
            if self._observer is not None:
                self._observer.on_close(st.id)

    def _wake_slot(self) -> None:
        while self._slot_waiters:
            w = self._slot_waiters.pop(0)
            if not w.done():
                w.set_result(None)
                break

    def adopt_upgraded_request(self, req: H2Request,
                               body: bytes = b"") -> None:
        """RFC 7540 §3.2: after a 101 Switching Protocols, the HTTP/1.1
        request that carried ``Upgrade: h2c`` becomes stream 1,
        half-closed (remote); its response goes out as h2 frames on
        stream 1 (ref: Netty's Http2FrameCodec server upgrade path wired
        by ServerUpgradeHandler.scala:38-41)."""
        st = _StreamState(1, self._peer_initial_window,
                          self._local_initial_window)
        st.got_headers = True
        self._streams[1] = st
        self._last_peer_stream = max(self._last_peer_stream, 1)
        req.stream = st.recv_stream
        st.recv_stream.offer(DataFrame(body, eos=True))
        st.recv_closed = True
        task = asyncio.get_running_loop().create_task(
            self._serve_stream(st, req))
        self._handler_tasks.add(task)
        task.add_done_callback(self._handler_tasks.discard)

    def apply_upgrade_settings(self, payload: bytes) -> None:
        """Apply the decoded HTTP2-Settings header payload (the client's
        SETTINGS, carried in the h1 upgrade request) before any h2 frame
        arrives (RFC 7540 §3.2.1)."""
        self._apply_settings(frames.unpack_settings(payload))

    def _apply_settings(self, settings: List[Tuple[int, int]]) -> None:
        for key, value in settings:
            if key == frames.SETTINGS_INITIAL_WINDOW_SIZE:
                if value > frames.MAX_WINDOW:
                    raise H2ProtocolError(frames.FLOW_CONTROL_ERROR,
                                          "window > 2^31-1")
                delta = value - self._peer_initial_window
                self._peer_initial_window = value
                for st in self._streams.values():
                    st.send_window += delta
            elif key == frames.SETTINGS_MAX_FRAME_SIZE:
                if not (16384 <= value <= (1 << 24) - 1):
                    raise H2ProtocolError(frames.PROTOCOL_ERROR,
                                          "bad max frame size")
                self._peer_max_frame = value
            elif key == frames.SETTINGS_MAX_CONCURRENT_STREAMS:
                self._peer_max_concurrent = value
            elif key == frames.SETTINGS_HEADER_TABLE_SIZE:
                self._encoder.set_max_table_size(value)
        spawn(self._notify_windows(), what="h2-notify-windows-settings")


def _poll_const_body(stream: H2Stream):
    """(body, trailers|None) if the stream is fully buffered right now,
    else None (must pump live). Lets unary messages skip the pump task."""
    try:
        q = stream._q  # noqa: SLF001 — engine-internal fast path
        items = list(q)
    except Exception:  # noqa: BLE001
        return None
    if not items or not getattr(items[-1], "eos", False):
        return None
    chunks: List[bytes] = []
    trailers = None
    for it in items:
        if isinstance(it, Trailers):
            trailers = it.headers
        elif isinstance(it, DataFrame):
            chunks.append(it.data)
        else:
            return None
    # drain the queue so at_end bookkeeping stays consistent, returning
    # each frame's flow credit (frames may originate from another h2
    # connection when a handler forwards a received stream)
    while q:
        item = q.popleft()
        if isinstance(item, DataFrame):
            item.release()
    stream.at_end = True
    return b"".join(chunks), trailers
