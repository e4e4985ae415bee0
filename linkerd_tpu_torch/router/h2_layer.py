"""Stream-aware h2 router filters.

Ref: router/h2 — StreamStatsFilter.scala (latency to headers + stream
duration + byte counts), ClassifiedRetryFilter.scala:237 (buffers request
AND response streams so streaming calls can be retried after a
final-frame classification, e.g. a grpc-status trailer), and the h2
ErrorReseter. All filters speak H2Request/H2Response with pull streams.
"""

from __future__ import annotations

import asyncio
import time
from typing import Iterable, List, Optional, Tuple

from linkerd_tpu_torch.protocol.h2.classifiers import H2Classifier
from linkerd_tpu_torch.protocol.h2.messages import H2Request, H2Response, Headers
from linkerd_tpu_torch.protocol.h2.stream import (
    RST_REFUSED_STREAM, BufferedStream, DataFrame, H2Stream, StreamReset,
    Trailers,
)
from linkerd_tpu_torch.router.admission import OverloadShed
from linkerd_tpu_torch.router.balancer import NoBrokersAvailable
from linkerd_tpu_torch.router.binding import BindingFailed, UnboundError
from linkerd_tpu_torch.router.classifiers import (
    SUCCESS_CLASS_HEADER, ResponseClass,
)
from linkerd_tpu_torch.router.deadline import deadline_of
from linkerd_tpu_torch.router.retries import RetryBudget
from linkerd_tpu_torch.router.routing import IdentificationError
from linkerd_tpu_torch.router.service import Filter, Service
from linkerd_tpu_torch.telemetry.metrics import MetricsTree


class _TapStream:
    """Pass-through pull stream observing frames and stream end."""

    def __init__(self, inner, on_data=None, on_end=None):
        self._inner = inner
        self._on_data = on_data
        self._on_end = on_end
        self._ended = False

    @property
    def at_end(self) -> bool:
        return self._inner.at_end

    @property
    def is_reset(self) -> bool:
        return self._inner.is_reset

    def offer(self, frame) -> None:
        self._inner.offer(frame)

    def reset(self, *a, **kw) -> None:
        self._inner.reset(*a, **kw)

    def _end(self, exc) -> None:
        if not self._ended:
            self._ended = True
            if self._on_end is not None:
                self._on_end(exc)

    async def read(self):
        try:
            frame = await self._inner.read()
        except StreamReset as e:
            self._end(e)
            raise
        if isinstance(frame, DataFrame) and self._on_data is not None:
            self._on_data(len(frame.data))
        if self._inner.at_end or isinstance(frame, Trailers):
            self._end(None)
        return frame

    async def read_all(self, max_bytes: int = 1 << 26):
        return await _read_all(self, max_bytes)


class _ReplayStream:
    """Replays collected frames, then follows a live tail, propagates a
    terminal reset, or ends cleanly — in that priority order."""

    def __init__(self, frames: Iterable, tail=None,
                 terminal_reset: Optional[StreamReset] = None):
        self._frames = list(frames)
        self._tail = tail
        self._terminal_reset = terminal_reset
        self.at_end = False

    @property
    def is_reset(self) -> bool:
        if self._terminal_reset is not None:
            return True
        return self._tail.is_reset if self._tail is not None else False

    def reset(self, *a, **kw) -> None:
        if self._tail is not None:
            self._tail.reset(*a, **kw)
        self.at_end = True

    async def read(self):
        if self._frames:
            frame = self._frames.pop(0)
            if isinstance(frame, Trailers) or (
                    isinstance(frame, DataFrame) and frame.eos):
                self.at_end = True
            if (not self._frames and self._tail is None
                    and self._terminal_reset is None and not self.at_end):
                # collected frames ended without EOS marker
                self.at_end = True
            return frame
        if self._terminal_reset is not None:
            # the buffered response ended in a reset: propagate it so the
            # downstream client doesn't see a truncated-but-clean body
            self.at_end = True
            raise self._terminal_reset
        if self._tail is not None:
            frame = await self._tail.read()
            self.at_end = self._tail.at_end  # l5d: ignore[await-atomicity] — streams are single-consumer by contract (one pump per stream); at_end mirrors the tail we just read from
            return frame
        raise EOFError("stream already ended")

    async def read_all(self, max_bytes: int = 1 << 26):
        return await _read_all(self, max_bytes)


async def _read_all(stream, max_bytes: int):
    """Drain ``stream`` into (body, trailers), bounded like
    H2Stream.read_all (resets past the cap)."""
    chunks: List[bytes] = []
    total = 0
    trailers = None
    while not stream.at_end:
        frame = await stream.read()
        if isinstance(frame, Trailers):
            trailers = frame
        else:
            total += len(frame.data)
            if total > max_bytes:
                stream.reset(0x8, "body too large")
                raise StreamReset(0x8, "body too large")
            chunks.append(frame.data)
            frame.release()
    return b"".join(chunks), trailers


class H2StreamStatsFilter(Filter[H2Request, H2Response]):
    """Counters/latency to response HEADERS + stream duration/bytes to
    stream end (ref: StreamStatsFilter.scala)."""

    def __init__(self, metrics: MetricsTree, *scope: str):
        node = metrics.scope(*scope)
        self._requests = node.counter("requests")
        self._success = node.counter("success")
        self._failures = node.counter("failures")
        self._latency = node.stat("request_latency_ms")
        self._stream_ms = node.scope("stream").stat("stream_duration_ms")
        self._data_bytes = node.scope("stream").counter("data_bytes")
        self._status_node = node.scope("status")

    async def apply(self, req: H2Request, service: Service) -> H2Response:
        self._requests.incr()
        t0 = time.monotonic()
        try:
            rsp = await service(req)
        except BaseException:
            self._failures.incr()
            self._latency.add((time.monotonic() - t0) * 1e3)
            raise
        self._latency.add((time.monotonic() - t0) * 1e3)
        self._status_node.counter(str(rsp.status)).incr()
        self._status_node.counter(f"{rsp.status // 100}XX").incr()
        if rsp.status >= 500:
            self._failures.incr()
        else:
            self._success.incr()

        def on_end(exc, _t0=t0):
            self._stream_ms.add((time.monotonic() - _t0) * 1e3)

        rsp.stream = _TapStream(
            rsp.stream, on_data=lambda n: self._data_bytes.incr(n),
            on_end=on_end)
        return rsp


async def _collect_response(stream, limit: int, hold_s: float
                            ) -> Tuple[list, Optional[Trailers],
                                       bool, Optional[StreamReset]]:
    """Read a response stream to its end, bounded by ``limit`` buffered
    bytes AND a total hold deadline of ``hold_s`` seconds (so a
    server-streaming response that won't end soon is released to the
    caller instead of being held for classification).
    Returns (frames, trailers, gave_up, reset)."""
    frames: list = []
    total = 0
    trailers: Optional[Trailers] = None
    deadline = time.monotonic() + hold_s
    read_nowait = getattr(stream, "read_nowait", None)  # wrappers: absent
    try:
        while not stream.at_end:
            # already-buffered frames (the common unary case) are taken
            # synchronously — wait_for costs a task + timer per call
            frame = read_nowait() if read_nowait is not None else None
            if frame is None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return frames, None, True, None
                try:
                    frame = await asyncio.wait_for(stream.read(), remaining)
                except asyncio.TimeoutError:
                    return frames, None, True, None
            if isinstance(frame, Trailers):
                trailers = frame
                frames.append(frame)
            else:
                total += len(frame.data)
                frames.append(frame)
                frame.release()
                if total > limit:
                    return frames, None, True, None
    except StreamReset as e:
        return frames, None, False, e
    return frames, trailers, False, None


class H2ClassifiedRetries(Filter[H2Request, H2Response]):
    """Retry streaming requests on final-frame classification.

    The request stream is teed through a BufferedStream (so it can be
    replayed); the response is buffered up to ``rsp_buffer_bytes`` while
    awaiting the classifying frame, bounded by ``rsp_hold_s`` — the
    retryability-vs-streaming-latency knob: a final frame (e.g.
    grpc-status trailer) later than this forfeits the retry and streams
    the response through. Either buffer overflowing does the same
    (ref: ClassifiedRetryFilter.scala).
    """

    def __init__(self, classifier: H2Classifier,
                 budget: Optional[RetryBudget] = None,
                 backoffs: Optional[Iterable[float]] = None,
                 max_retries: int = 25,
                 metrics: Optional[MetricsTree] = None,
                 scope: tuple = (),
                 req_buffer_bytes: int = BufferedStream.DEFAULT_CAPACITY,
                 rsp_buffer_bytes: int = 64 * 1024,
                 rsp_hold_s: float = 1.0):
        self._classifier = classifier
        self._budget = budget if budget is not None else RetryBudget()
        self._backoffs = list(backoffs) if backoffs is not None else [0.0] * 25
        self._max_retries = max_retries
        self._req_buffer = req_buffer_bytes
        self._rsp_buffer = rsp_buffer_bytes
        self._rsp_hold_s = rsp_hold_s
        node = (metrics.scope(*scope, "retries") if metrics is not None
                else MetricsTree().scope("retries"))
        self._retry_count = node.counter("total")
        self._budget_exhausted = node.counter("budget_exhausted")
        self._deadline_skipped = node.counter("deadline_skipped")

    def _replayed(self, req: H2Request, stream) -> H2Request:
        clone = H2Request(method=req.method, path=req.path,
                          authority=req.authority, scheme=req.scheme,
                          headers=req.headers.copy(), stream=stream)
        clone.ctx = req.ctx
        return clone

    async def apply(self, req: H2Request, service: Service) -> H2Response:
        self._budget.deposit()
        buffered = BufferedStream(req.stream, self._req_buffer)
        attempt = 0
        fork = None
        while True:
            rsp: Optional[H2Response] = None
            exc: Optional[BaseException] = None
            fork = buffered.fork()
            cur = self._replayed(req, fork)
            try:
                rsp = await service(cur)
            except asyncio.CancelledError:
                await buffered.close()
                raise
            except Exception as e:  # noqa: BLE001 — classified below
                exc = e

            retry_possible = (
                attempt < min(self._max_retries, len(self._backoffs))
                and not buffered.overflowed)

            if exc is None:
                early = self._classifier.early(req, rsp)
                if early is not None and (not early.is_retryable
                                          or not retry_possible):
                    req.ctx["response_class"] = early
                    buffered.release_buffer()
                    return rsp
                # need (or may need) the final frame
                frames, trailers, gave_up, rst = await _collect_response(
                    rsp.stream, self._rsp_buffer, self._rsp_hold_s)
                if gave_up:
                    # response won't end soon / too big: commit and
                    # stream through; no retry. Only claim SUCCESS when
                    # the classifier had an early verdict saying so —
                    # otherwise the class is simply unknown-yet.
                    if early is not None:
                        req.ctx["response_class"] = early
                    rsp.stream = _ReplayStream(frames, tail=rsp.stream)
                    buffered.release_buffer()
                    return rsp
                rc = self._classifier.classify(req, rsp, trailers, rst)
                replay = _ReplayStream(frames, terminal_reset=rst)
            else:
                rc = self._classifier.classify(req, None, None, exc)
                replay = None

            req.ctx["response_class"] = rc
            if not rc.is_retryable or not retry_possible:
                break
            pause = self._backoffs[attempt]
            dl = deadline_of(req)
            if dl is not None and pause >= dl.remaining_s():
                # backoff would overrun the propagated deadline budget:
                # forfeit the retry, serve the classified outcome
                self._deadline_skipped.incr()
                break
            if not self._budget.try_withdraw():
                self._budget_exhausted.incr()
                break
            buffered.unfork(fork)  # abandoned attempt
            attempt += 1
            self._retry_count.incr()
            if pause > 0:
                await asyncio.sleep(pause)
            if buffered.overflowed:
                # request kept streaming past the buffer during backoff;
                # forfeit the retry and serve the classified response
                break

        buffered.release_buffer()
        if exc is not None:
            # nothing will consume the request stream now
            if fork is not None:
                buffered.unfork(fork)
            await buffered.close()
            raise exc
        assert rsp is not None
        rsp.stream = replay
        return rsp


class H2ClassifierFilter(Filter[H2Request, H2Response]):
    """Stamp this router's final response classification onto the
    response headers as ``l5d-success-class`` (1.0/0.0) so an upstream
    linkerd can trust it (via io.l5d.h2.successClass) instead of
    re-deriving a weaker verdict from the status line — the h2 twin of
    the http ClassifierFilter (ref: router/h2/.../ClassifierFilter.scala:23).

    Sits OUTSIDE H2ClassifiedRetries in the path stack: by the time the
    response passes here, the retries filter has recorded the verdict on
    the stream it is actually returning in ``ctx['response_class']``
    (early header-only classification, or the held final-frame one). A
    stream whose classification forfeited (hold timeout) gets no stamp
    — unknown must not masquerade as a verdict."""

    async def apply(self, req: H2Request, service: Service) -> H2Response:
        rsp = await service(req)
        rc = req.ctx.get("response_class")
        if rc is not None:
            rsp.headers.set(SUCCESS_CLASS_HEADER,
                            "0.0" if rc.is_failure else "1.0")
        return rsp


class H2ClearContextFilter(Filter[H2Request, H2Response]):
    """Strip inbound ``l5d-*`` context headers at the server edge
    (ref: ServerConfig clearContext — same semantics as the HTTP/1
    ClearContextFilter, over h2 headers)."""

    async def apply(self, req: H2Request, service: Service) -> H2Response:
        doomed = [n for n, _ in req.headers.items()
                  if n.lower().startswith("l5d-")]
        for n in doomed:
            req.headers.remove(n)
        return await service(req)


class H2ErrorResponder(Filter[H2Request, H2Response]):
    """Maps routing/dispatch failures to h2 responses with ``l5d-err``
    (ref: linkerd/protocol/h2 ErrorReseter + LinkerdHeaders err).

    Routing and shed failures do NOT synthesize a 502 body: they raise
    ``StreamReset(REFUSED_STREAM)``, which the h2 server turns into an
    ``RST_STREAM REFUSED_STREAM`` frame (ref: ErrorReseter.scala:14-31)
    — gRPC clients observe UNAVAILABLE and edge linkerds retry safely,
    because a refused stream was never processed. Deadline expiry on a
    gRPC request answers Trailers-Only ``grpc-status: 4``
    (DEADLINE_EXCEEDED) instead of an opaque 504."""

    ERR_HEADER = "l5d-err"

    async def apply(self, req: H2Request, service: Service) -> H2Response:
        try:
            return await service(req)
        except IdentificationError as e:
            return self._err(400, f"identification failed: {e}")
        except UnboundError as e:
            return self._err(400, f"no binding: {e}")
        except (BindingFailed, NoBrokersAvailable) as e:
            raise StreamReset(RST_REFUSED_STREAM,
                              f"binding failed: {e}") from None
        except OverloadShed as e:
            raise StreamReset(RST_REFUSED_STREAM,
                              f"overloaded: {e}") from None
        except StreamReset as e:
            if e.error_code == RST_REFUSED_STREAM:
                raise  # propagate refusal so the edge retries
            return self._err(502, f"stream reset: {e}")
        except ConnectionError as e:
            return self._err(502, f"connection failed: {e}")
        except TimeoutError as e:
            if _is_grpc(req):
                return _grpc_deadline_exceeded(req, e)
            return self._err(504, f"timeout: {e}")

    def _err(self, status: int, msg: str) -> H2Response:
        rsp = H2Response(status=status, body=msg.encode())
        rsp.headers.set(self.ERR_HEADER, msg.replace("\n", " ")[:512])
        return rsp


def _is_grpc(req: H2Request) -> bool:
    ct = req.headers.get("content-type") or ""
    return ct.startswith("application/grpc")


def _grpc_deadline_exceeded(req: H2Request, exc: BaseException) -> H2Response:
    """Trailers-Only gRPC error: HTTP 200 + grpc-status in the initial
    HEADERS with END_STREAM (the shape gRPC clients require; a plain 504
    surfaces as the opaque UNKNOWN instead of DEADLINE_EXCEEDED)."""
    from linkerd_tpu_torch.grpc.status import DEADLINE_EXCEEDED, GrpcStatus

    dl = deadline_of(req)
    detail = (f"deadline expired {-dl.remaining_s() * 1e3:.0f}ms ago"
              if dl is not None and dl.expired
              else str(exc) or "request timed out")
    rsp = H2Response(status=200, body=b"")
    rsp.headers.set("content-type", "application/grpc")
    for n, v in GrpcStatus(DEADLINE_EXCEEDED, detail).to_headers():
        rsp.headers.set(n, v)
    return rsp
