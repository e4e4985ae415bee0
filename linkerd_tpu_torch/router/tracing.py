"""Distributed tracing: context propagation + span recording: a copy of
``linkerd_tpu/router/tracing.py``.

Reference parity: finagle Trace threaded through every stack (SURVEY.md §5):
per-protocol TraceInitializers decode/encode ids from wire headers
(HttpTraceInitializer.scala:65), ``l5d-ctx-trace`` + ``l5d-sample`` headers
(LinkerdHeaders.scala:24,117,291), router annotations for label/paths/
classification (DstTracing.scala, ClassifiedTracing.scala). Span sinks are
telemeter Tracers (zipkin/tracelog/recentRequests).

Wire format for ``l5d-ctx-trace``: ``<trace_id>-<span_id>-<parent_id>-<flags>``
hex fields (128/64/64-bit), flags bit0 = sampled.
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from linkerd_tpu_torch.protocol.http.message import Request, Response
from linkerd_tpu_torch.router.service import Filter, Service
from linkerd_tpu_torch.telemetry.telemeter import Tracer

CTX_TRACE = "l5d-ctx-trace"
SAMPLE_HEADER = "l5d-sample"

# mux/thriftmux carry the SAME wire encodings in Tdispatch context
# sections (the finagle analogue: Trace context rides mux contexts, not
# headers) — one codec, two transports, so a trace crosses protocol
# boundaries without re-encoding
MUX_CTX_TRACE = CTX_TRACE.encode("ascii")
MUX_CTX_SAMPLE = SAMPLE_HEADER.encode("ascii")

_rng = random.Random()


@dataclass
class TraceId:
    trace_id: int
    span_id: int
    parent_id: int = 0
    sampled: bool = True

    def encode(self) -> str:
        flags = 1 if self.sampled else 0
        return (f"{self.trace_id:032x}-{self.span_id:016x}-"
                f"{self.parent_id:016x}-{flags:02x}")

    @staticmethod
    def decode(s: str) -> Optional["TraceId"]:
        parts = s.strip().split("-")
        if len(parts) != 4:
            return None
        try:
            return TraceId(
                trace_id=int(parts[0], 16),
                span_id=int(parts[1], 16),
                parent_id=int(parts[2], 16),
                sampled=bool(int(parts[3], 16) & 1))
        except ValueError:
            return None

    @staticmethod
    def mk_root(sampled: bool = True) -> "TraceId":
        return TraceId(_rng.getrandbits(128), _rng.getrandbits(64), 0, sampled)

    def child(self) -> "TraceId":
        return TraceId(self.trace_id, _rng.getrandbits(64), self.span_id,
                       self.sampled)


class ServerTraceFilter(Filter[Request, Response]):
    """Server-side trace init: join the caller's trace from l5d-ctx-trace
    or start a new root; record the server span to the tracer."""

    def __init__(self, tracer: Tracer, router_label: str,
                 sample_rate: float = 1.0):
        self.tracer = tracer
        self.router_label = router_label
        self.sample_rate = sample_rate

    async def apply(self, req: Request, service: Service) -> Response:
        hdr = req.headers.get(CTX_TRACE)
        parent = TraceId.decode(hdr) if hdr else None
        if parent is not None:
            span = parent.child()
        else:
            sample_hdr = req.headers.get(SAMPLE_HEADER)
            if sample_hdr is not None:
                try:
                    sampled = _rng.random() < float(sample_hdr)
                except ValueError:
                    sampled = _rng.random() < self.sample_rate
            else:
                sampled = _rng.random() < self.sample_rate
            span = TraceId.mk_root(sampled)
        req.ctx["trace"] = span
        # wall clock for the reported span instant, monotonic for the
        # measured duration (NTP steps must not produce negative spans)
        ts_us = int(time.time() * 1e6)
        t0 = time.monotonic()
        status = None
        try:
            rsp = await service(req)
            status = rsp.status
            return rsp
        finally:
            if span.sampled:
                dst = req.ctx.get("dst")
                tags = {
                    "router.label": self.router_label,
                    "dst.path": dst.path.show if dst else "",
                    "http.status_code": str(status) if status else "error",
                    "response.class": str(
                        getattr(req.ctx.get("response_class"), "value", "")),
                }
                # per-stage decomposition rides the span so one trace
                # answers "where did my millisecond go" for this hop
                timer = req.ctx.get("stages")
                if timer is not None:
                    for stage, ms in timer.totals.items():
                        tags[f"stage.{stage}_ms"] = f"{ms:.3f}"
                self.tracer.record({
                    "traceId": f"{span.trace_id:032x}",
                    "id": f"{span.span_id:016x}",
                    "parentId": (f"{span.parent_id:016x}"
                                 if span.parent_id else None),
                    "kind": "SERVER",
                    "name": f"{req.method} {req.path}",
                    "timestamp": ts_us,
                    "duration": int((time.monotonic() - t0) * 1e6),
                    "localEndpoint": {"serviceName": self.router_label},
                    "tags": tags,
                })


class ClientTraceFilter(Filter[Request, Response]):
    """Client-side: propagate the child trace ctx downstream via headers
    and record the client span."""

    def __init__(self, tracer: Tracer, client_id: str):
        self.tracer = tracer
        self.client_id = client_id

    async def apply(self, req: Request, service: Service) -> Response:
        span: Optional[TraceId] = req.ctx.get("trace")  # type: ignore[assignment]
        if span is None:
            return await service(req)
        child = span.child()
        req.headers.set(CTX_TRACE, child.encode())
        ts_us = int(time.time() * 1e6)
        t0 = time.monotonic()
        status = None
        try:
            rsp = await service(req)
            status = rsp.status
            return rsp
        finally:
            if child.sampled:
                self.tracer.record({
                    "traceId": f"{child.trace_id:032x}",
                    "id": f"{child.span_id:016x}",
                    "parentId": f"{child.parent_id:016x}",
                    "kind": "CLIENT",
                    "name": f"{req.method} {req.path}",
                    "timestamp": ts_us,
                    "duration": int((time.monotonic() - t0) * 1e6),
                    "localEndpoint": {"serviceName": self.client_id},
                    "tags": {
                        "client.id": self.client_id,
                        "http.status_code": str(status) if status else "error",
                    },
                })


def mux_ctx_get(contexts, key: bytes) -> Optional[bytes]:
    """First value for ``key`` in a Tdispatch context section."""
    for k, v in contexts:
        if k == key:
            return v
    return None


def mux_ctx_set(contexts, key: bytes, value: bytes):
    """Context section with ``key`` replaced (appended if absent)."""
    out = [(k, v) for k, v in contexts if k != key]
    out.append((key, value))
    return out


class MuxServerTraceFilter(Filter):
    """mux/thriftmux server-side trace init: join the caller's trace
    from the ``l5d-ctx-trace`` Tdispatch context entry (same wire
    encoding as the http header) or start a new root; record the server
    span. The mux twin of ServerTraceFilter."""

    def __init__(self, tracer: Tracer, router_label: str,
                 sample_rate: float = 1.0):
        self.tracer = tracer
        self.router_label = router_label
        self.sample_rate = sample_rate

    async def apply(self, td, service: Service):
        raw = mux_ctx_get(td.contexts, MUX_CTX_TRACE)
        parent = (TraceId.decode(raw.decode("ascii", "replace"))
                  if raw else None)
        if parent is not None:
            span = parent.child()
        else:
            sample_raw = mux_ctx_get(td.contexts, MUX_CTX_SAMPLE)
            if sample_raw is not None:
                try:
                    sampled = _rng.random() < float(sample_raw)
                except ValueError:
                    sampled = _rng.random() < self.sample_rate
            else:
                sampled = _rng.random() < self.sample_rate
            span = TraceId.mk_root(sampled)
        td.ctx["trace"] = span
        ts_us = int(time.time() * 1e6)
        t0 = time.monotonic()
        ok = False
        try:
            rsp = await service(td)
            ok = True
            return rsp
        finally:
            if span.sampled:
                dst = td.ctx.get("dst")
                self.tracer.record({
                    "traceId": f"{span.trace_id:032x}",
                    "id": f"{span.span_id:016x}",
                    "parentId": (f"{span.parent_id:016x}"
                                 if span.parent_id else None),
                    "kind": "SERVER",
                    "name": f"mux {td.dest or '/'}",
                    "timestamp": ts_us,
                    "duration": int((time.monotonic() - t0) * 1e6),
                    "localEndpoint": {"serviceName": self.router_label},
                    "tags": {
                        "router.label": self.router_label,
                        "dst.path": dst.path.show if dst else "",
                        "mux.ok": str(ok).lower(),
                    },
                })


class MuxClientTraceFilter(Filter):
    """mux/thriftmux client-side: propagate the child trace downstream
    in the Tdispatch context section and record the client span."""

    def __init__(self, tracer: Tracer, client_id: str):
        self.tracer = tracer
        self.client_id = client_id

    async def apply(self, td, service: Service):
        span: Optional[TraceId] = td.ctx.get("trace")
        if span is None:
            return await service(td)
        child = span.child()
        from linkerd_tpu_torch.protocol.mux.codec import Tdispatch
        out = Tdispatch(
            td.tag,
            mux_ctx_set(td.contexts, MUX_CTX_TRACE,
                        child.encode().encode("ascii")),
            td.dest, td.dtab, td.payload, td.ctx)
        ts_us = int(time.time() * 1e6)
        t0 = time.monotonic()
        ok = False
        try:
            rsp = await service(out)
            ok = True
            return rsp
        finally:
            if child.sampled:
                self.tracer.record({
                    "traceId": f"{child.trace_id:032x}",
                    "id": f"{child.span_id:016x}",
                    "parentId": f"{child.parent_id:016x}",
                    "kind": "CLIENT",
                    "name": f"mux {td.dest or '/'}",
                    "timestamp": ts_us,
                    "duration": int((time.monotonic() - t0) * 1e6),
                    "localEndpoint": {"serviceName": self.client_id},
                    "tags": {
                        "client.id": self.client_id,
                        "mux.ok": str(ok).lower(),
                    },
                })


class AccessLogger(Filter[Request, Response]):
    """Common Log Format access logging (ref: AccessLogger.scala:8)."""

    def __init__(self, emit):
        self._emit = emit  # callable(str)

    async def apply(self, req: Request, service: Service) -> Response:
        t0 = time.time()
        rsp = await service(req)
        peer = req.ctx.get("client_addr") or ("-",)
        host = peer[0] if isinstance(peer, tuple) else "-"
        ts = time.strftime("%d/%b/%Y:%H:%M:%S +0000", time.gmtime(t0))
        self._emit(
            f'{host} - - [{ts}] "{req.method} {req.uri} {req.version}" '
            f"{rsp.status} {len(rsp.body)}")
        return rsp
