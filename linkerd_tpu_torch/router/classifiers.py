"""Response classification: success / failure x retryability: a copy of
``linkerd_tpu/router/classifiers.py``.

Reference parity: linkerd/protocol/http/.../ResponseClassifiers.scala
(NonRetryable5XX default, RetryableIdempotent5XX, RetryableRead5XX,
AllSuccessful, HeaderRetryable) and router/core's response-class-driven
retry/stats plumbing (ClassifiedRetries.scala, ResponseClassifierCtx).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Callable, Optional

from linkerd_tpu_torch.config import register
from linkerd_tpu_torch.protocol.http.message import Request, Response
from linkerd_tpu_torch.router.service import Filter, Service


class ResponseClass(enum.Enum):
    SUCCESS = "success"
    FAILURE = "failure"              # non-retryable failure
    RETRYABLE_FAILURE = "retryable"  # safe to re-dispatch

    @property
    def is_failure(self) -> bool:
        return self is not ResponseClass.SUCCESS

    @property
    def is_retryable(self) -> bool:
        return self is ResponseClass.RETRYABLE_FAILURE


Classifier = Callable[[Request, Optional[Response], Optional[BaseException]],
                      ResponseClass]
"""(request, response | None, exception | None) -> ResponseClass."""

IDEMPOTENT_METHODS = frozenset({"GET", "HEAD", "OPTIONS", "TRACE", "PUT", "DELETE"})
READ_METHODS = frozenset({"GET", "HEAD", "OPTIONS", "TRACE"})

RETRYABLE_HEADER = "l5d-retryable"  # ref: HeaderRetryable / ClassifierFilter
SUCCESS_CLASS_HEADER = "l5d-success-class"  # ref: ClassifierFilter.scala:31


class ClassifierFilter(Filter[Request, Response]):
    """Stamp this router's response classification onto the response as
    ``l5d-success-class`` (1.0 success / 0.0 failure) so an UPSTREAM
    linkerd can trust the verdict of the router closest to the server —
    which sees app-level semantics (classifier config, grpc-status,
    retry outcomes) the edge can't reconstruct from the status line.
    Ref: router/http/.../ClassifierFilter.scala:33; the edge trusts it
    via the ``io.l5d.http.successClass`` classifier kind.

    Prefers the class recorded in ctx by ClassifiedRetries (the verdict
    on the response actually returned, after retries); falls back to
    classifying directly when no retry filter ran."""

    def __init__(self, classifier: Classifier):
        self._classifier = classifier

    async def apply(self, req: Request, service: Service) -> Response:
        rsp = await service(req)
        rc = req.ctx.get("response_class")
        if rc is None:
            rc = self._classifier(req, rsp, None)
        rsp.headers.set(SUCCESS_CLASS_HEADER,
                        "0.0" if rc.is_failure else "1.0")
        return rsp


def _status_class(req: Request, rsp: Optional[Response],
                  exc: Optional[BaseException],
                  retryable_methods: frozenset) -> ResponseClass:
    if exc is not None:
        # connection-level failures are retryable for retryable methods
        # (the write may not have reached the server)
        if req.method in retryable_methods and isinstance(
                exc, (ConnectionError, OSError, EOFError)):
            return ResponseClass.RETRYABLE_FAILURE
        return ResponseClass.FAILURE
    assert rsp is not None
    if rsp.status >= 500:
        if req.method in retryable_methods:
            return ResponseClass.RETRYABLE_FAILURE
        return ResponseClass.FAILURE
    return ResponseClass.SUCCESS


@register("classifier", "io.l5d.http.nonRetryable5XX")
@dataclass
class NonRetryable5XX:
    """5XX is failure, never retried (the linkerd default)."""

    def mk(self) -> Classifier:
        def classify(req, rsp, exc):
            return _status_class(req, rsp, exc, frozenset())

        return classify


@register("classifier", "io.l5d.http.retryableIdempotent5XX")
@dataclass
class RetryableIdempotent5XX:
    """5XX on idempotent methods is retryable."""

    def mk(self) -> Classifier:
        def classify(req, rsp, exc):
            return _status_class(req, rsp, exc, IDEMPOTENT_METHODS)

        return classify


@register("classifier", "io.l5d.http.retryableRead5XX")
@dataclass
class RetryableRead5XX:
    """5XX on read methods is retryable."""

    def mk(self) -> Classifier:
        def classify(req, rsp, exc):
            return _status_class(req, rsp, exc, READ_METHODS)

        return classify


@register("classifier", "io.l5d.http.allSuccessful")
@dataclass
class AllSuccessful:
    """Every response (even 5XX) is success; exceptions are failures."""

    def mk(self) -> Classifier:
        def classify(req, rsp, exc):
            if exc is not None:
                return ResponseClass.FAILURE
            return ResponseClass.SUCCESS

        return classify


@register("classifier", "io.l5d.http.successClass")
@dataclass
class SuccessClassHeader:
    """Trust a downstream linkerd's ``l5d-success-class`` header
    (stamped by its ClassifierFilter): >= 0.5 is success regardless of
    status; < 0.5 is a failure whose retryability the fallback decides
    (the status-based analysis still knows idempotency). Without the
    header, the fallback classifies alone — a chain ending at a
    non-linkerd backend degrades to reference behavior."""

    fallback: str = "io.l5d.http.nonRetryable5XX"

    def mk(self) -> Classifier:
        from linkerd_tpu_torch.config import lookup
        inner = lookup("classifier", self.fallback)().mk()

        def classify(req, rsp, exc):
            if rsp is not None:
                hdr = rsp.headers.get(SUCCESS_CLASS_HEADER)
                if hdr is not None:
                    try:
                        success = float(hdr) >= 0.5
                    except ValueError:
                        return inner(req, rsp, exc)
                    if success:
                        return ResponseClass.SUCCESS
                    rc = inner(req, rsp, exc)
                    return rc if rc.is_failure else ResponseClass.FAILURE
            return inner(req, rsp, exc)

        return classify


@register("classifier", "io.l5d.http.headerRetryable")
@dataclass
class HeaderRetryable:
    """Trust the downstream's l5d-retryable response header; fall back to
    the wrapped classifier (ref: HeaderRetryable + ClassifierFilter which
    propagates classification upstream via header)."""

    fallback: str = "io.l5d.http.nonRetryable5XX"

    def mk(self) -> Classifier:
        from linkerd_tpu_torch.config import lookup
        inner = lookup("classifier", self.fallback)().mk()

        def classify(req, rsp, exc):
            if rsp is not None and rsp.status >= 500:
                hdr = rsp.headers.get(RETRYABLE_HEADER)
                if hdr is not None:
                    if hdr.lower() == "true":
                        return ResponseClass.RETRYABLE_FAILURE
                    return ResponseClass.FAILURE
            return inner(req, rsp, exc)

        return classify
