"""Stream-aware h2 response classification, including gRPC.

Ref: finagle/h2 service/H2Classifiers.scala (classification over
``H2ReqRepFrame`` — a response is judged on its *final frame*, because for
gRPC success/failure lives in the ``grpc-status`` trailer) and
linkerd/protocol/h2 grpc/GrpcClassifier.scala:77 (kinds
``io.l5d.h2.grpc.{default,alwaysRetryable,neverRetryable,
retryableStatusCodes}``).

An H2Classifier has two phases:
- ``early(req, rsp)``: a verdict from response headers alone, or None if
  the stream end is needed (gRPC always needs trailers);
- ``classify(req, rsp, trailers, exc)``: the final verdict.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from linkerd_tpu_torch.config import register
from linkerd_tpu_torch.protocol.h2.messages import H2Request, H2Response
from linkerd_tpu_torch.protocol.h2.stream import (
    RST_REFUSED_STREAM, StreamReset, Trailers,
)
from linkerd_tpu_torch.router.classifiers import (
    IDEMPOTENT_METHODS, READ_METHODS, SUCCESS_CLASS_HEADER, ResponseClass,
)

GRPC_STATUS = "grpc-status"
# gRPC codes the default classifier deems safe to retry
# (GrpcClassifier.scala default: UNAVAILABLE)
RETRYABLE_GRPC_CODES = frozenset({14})


class H2Classifier:
    def early(self, req: H2Request,
              rsp: Optional[H2Response]) -> Optional[ResponseClass]:
        """Verdict from headers alone, or None to wait for stream end."""
        return None

    def classify(self, req: H2Request, rsp: Optional[H2Response],
                 trailers: Optional[Trailers],
                 exc: Optional[BaseException]) -> ResponseClass:
        raise NotImplementedError


def _grpc_code(rsp: Optional[H2Response],
               trailers: Optional[Trailers]) -> Optional[int]:
    """grpc-status from trailers, or headers (Trailers-Only)."""
    raw = None
    if trailers is not None:
        for k, v in trailers.headers:
            if k == GRPC_STATUS:
                raw = v
    if raw is None and rsp is not None:
        raw = rsp.headers.get(GRPC_STATUS)
    if raw is None:
        return None
    try:
        return int(raw)
    except ValueError:
        return None


def _refused(exc: Optional[BaseException]) -> bool:
    """RST_STREAM REFUSED_STREAM: the peer never processed the stream
    (RFC 7540 §8.1.4 explicitly blesses retrying it), so refusal is
    retryable regardless of method idempotence."""
    return (isinstance(exc, StreamReset)
            and exc.error_code == RST_REFUSED_STREAM)


class _StatusClassifier(H2Classifier):
    """HTTP-status based classification; retryability by method policy."""

    def __init__(self, retryable_methods: frozenset):
        self._retryable = retryable_methods

    def early(self, req, rsp):
        if rsp is None:
            return None
        if rsp.status < 500:
            return ResponseClass.SUCCESS
        if req.method in self._retryable:
            return ResponseClass.RETRYABLE_FAILURE
        return ResponseClass.FAILURE

    def classify(self, req, rsp, trailers, exc):
        if exc is not None:
            if _refused(exc):
                return ResponseClass.RETRYABLE_FAILURE
            return (ResponseClass.RETRYABLE_FAILURE
                    if req.method in self._retryable
                    else ResponseClass.FAILURE)
        got = self.early(req, rsp)
        assert got is not None
        return got


@register("h2classifier", "io.l5d.h2.nonRetryable5XX")
@dataclass
class H2NonRetryable5XX:
    """5xx is failure, never retryable (h2 twin of
    io.l5d.http.nonRetryable5XX)."""

    def mk(self) -> H2Classifier:
        return _StatusClassifier(frozenset())


@register("h2classifier", "io.l5d.h2.retryableRead5XX")
@dataclass
class H2RetryableRead5XX:
    """5xx on read methods (GET/HEAD/OPTIONS/TRACE) is retryable."""

    def mk(self) -> H2Classifier:
        return _StatusClassifier(READ_METHODS)


@register("h2classifier", "io.l5d.h2.retryableIdempotent5XX")
@dataclass
class H2RetryableIdempotent5XX:
    """5xx on idempotent methods (reads + PUT/DELETE) is retryable."""

    def mk(self) -> H2Classifier:
        return _StatusClassifier(IDEMPOTENT_METHODS)


class _AllSuccessfulClassifier(H2Classifier):
    """Every response (any status) is a success; transport errors fail
    NON-retryably, matching the http twin (router/classifiers.py
    io.l5d.http.allSuccessful) — the request may have had side effects
    before the transport died (ref: h2 AllSuccessfulInitializer)."""

    def early(self, req, rsp):
        return ResponseClass.SUCCESS if rsp is not None else None

    def classify(self, req, rsp, trailers, exc):
        if exc is not None:
            return ResponseClass.FAILURE
        return ResponseClass.SUCCESS


@register("h2classifier", "io.l5d.h2.allSuccessful")
@dataclass
class H2AllSuccessful:
    """Every response is a success; only transport errors fail (and
    non-retryably — side effects may have happened)."""

    def mk(self) -> H2Classifier:
        return _AllSuccessfulClassifier()


class _SuccessClassClassifier(H2Classifier):
    """Trust the downstream router's ``l5d-success-class`` response
    header (stamped by its H2ClassifierFilter); defer to the wrapped
    classifier when absent/garbled. A failure verdict keeps the
    fallback's retryability analysis (h2 twin of
    io.l5d.http.successClass; ref router/h2/.../ClassifierFilter.scala:23)."""

    def __init__(self, inner: H2Classifier):
        self._inner = inner

    def _header_success(self, rsp: Optional[H2Response]) -> Optional[bool]:
        if rsp is None:
            return None
        hdr = rsp.headers.get(SUCCESS_CLASS_HEADER)
        if hdr is None:
            return None
        try:
            return float(hdr) >= 0.5
        except ValueError:
            return None

    def early(self, req, rsp):
        success = self._header_success(rsp)
        if success:
            return ResponseClass.SUCCESS
        if success is None:
            return self._inner.early(req, rsp)
        # downstream says failed: let classify() decide retryability
        return None

    def classify(self, req, rsp, trailers, exc):
        success = self._header_success(rsp)
        if success:
            return ResponseClass.SUCCESS
        rc = self._inner.classify(req, rsp, trailers, exc)
        if success is False and not rc.is_failure:
            return ResponseClass.FAILURE
        return rc


@register("h2classifier", "io.l5d.h2.successClass")
@dataclass
class H2SuccessClass:
    """Trust a downstream linkerd's l5d-success-class verdict; fall back
    to the wrapped kind when the header is absent."""

    fallback: str = "io.l5d.h2.nonRetryable5XX"

    def mk(self) -> H2Classifier:
        from linkerd_tpu_torch.config import lookup
        return _SuccessClassClassifier(
            lookup("h2classifier", self.fallback)().mk())


class _GrpcClassifier(H2Classifier):
    """Success iff grpc-status == 0; retryability of failures per policy.
    Falls back to HTTP-status classification for non-gRPC responses."""

    def __init__(self, retryable_codes: frozenset, always: bool = False,
                 never: bool = False):
        self._codes = retryable_codes
        self._always = always
        self._never = never

    def _failure(self, code: int) -> ResponseClass:
        if self._never:
            return ResponseClass.FAILURE
        if self._always or code in self._codes:
            return ResponseClass.RETRYABLE_FAILURE
        return ResponseClass.FAILURE

    def classify(self, req, rsp, trailers, exc):
        if exc is not None:
            if self._never:
                return ResponseClass.FAILURE
            if self._always or _refused(exc):
                return ResponseClass.RETRYABLE_FAILURE
            return ResponseClass.FAILURE
        code = _grpc_code(rsp, trailers)
        if code is None:
            # not gRPC: treat like HTTP status
            if rsp is not None and rsp.status < 500:
                return ResponseClass.SUCCESS
            return self._failure(-1)
        if code == 0:
            return ResponseClass.SUCCESS
        return self._failure(code)


@register("h2classifier", "io.l5d.h2.grpc.default")
@dataclass
class GrpcDefault:
    """grpc-status 0 is success; the conventionally-safe codes
    (UNAVAILABLE, ...) retry."""

    def mk(self) -> H2Classifier:
        return _GrpcClassifier(RETRYABLE_GRPC_CODES)


@register("h2classifier", "io.l5d.h2.grpc.alwaysRetryable")
@dataclass
class GrpcAlwaysRetryable:
    """Any non-zero grpc-status retries."""

    def mk(self) -> H2Classifier:
        return _GrpcClassifier(frozenset(), always=True)


@register("h2classifier", "io.l5d.h2.grpc.neverRetryable")
@dataclass
class GrpcNeverRetryable:
    """No grpc-status ever retries."""

    def mk(self) -> H2Classifier:
        return _GrpcClassifier(frozenset(), never=True)


@register("h2classifier", "io.l5d.h2.grpc.retryableStatusCodes")
@dataclass
class GrpcRetryableStatusCodes:
    """Exactly the listed grpc-status codes retry."""

    retryableStatusCodes: List[int] = field(default_factory=list)

    def mk(self) -> H2Classifier:
        return _GrpcClassifier(frozenset(self.retryableStatusCodes))
