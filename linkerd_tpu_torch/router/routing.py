"""RoutingService: identify -> bind -> dispatch, plus edge filters: a copy of
``linkerd_tpu/router/routing.py``.

Reference parity: router/core/.../RoutingFactory.scala:132-190 (the
per-request identify/bind/dispatch loop with UnknownDst handling) and the
stats/error filters the protocol stacks install
(linkerd/protocol/http/.../HttpConfig.scala stack surgery: ErrorResponder,
StatusCodeStatsFilter; router/core PerDstPathStatsFilter).
"""

from __future__ import annotations

import time
from typing import Awaitable, Callable, Optional

from linkerd_tpu_torch.core import Dtab, Path
from linkerd_tpu_torch.protocol.http.message import Request, Response
from linkerd_tpu_torch.router.admission import OverloadShed
from linkerd_tpu_torch.router.balancer import NoBrokersAvailable
from linkerd_tpu_torch.router.binding import (
    BindingFailed, DstBindingFactory, DstPath, UnboundError,
)
from linkerd_tpu_torch.router.service import Filter, Service
from linkerd_tpu_torch.router.stages import staged
from linkerd_tpu_torch.telemetry.metrics import MetricsTree

Identifier = Callable[[Request], DstPath]
"""An identifier assigns each request its logical name
(ref: RoutingFactory.Identifier, router/core/.../RoutingFactory.scala:19)."""


class IdentificationError(Exception):
    """The identifier could not name the request (-> 400)."""


DTAB_HEADER = "l5d-dtab"  # per-request dtab override (ref: LinkerdHeaders.scala)


class RoutingService(Service[Request, Response]):
    def __init__(self, identifier: Identifier, binding: DstBindingFactory,
                 local_dtab_fn: Optional[
                     Callable[[Path], Dtab]] = None):
        self._identifier = identifier
        self._binding = binding
        # control-plane seam: per-request extra local dtab for the
        # identified path (the reactor's LocalOverrideBook — partition-
        # time overrides that cannot reach the namerd store). Returning
        # an empty dtab leaves the request untouched, including its
        # binding-cache key.
        self._local_dtab_fn = local_dtab_fn

    async def __call__(self, req: Request) -> Response:
        with staged(req, "identification"):
            dst = self._identifier(req)  # raises IdentificationError
            if hasattr(dst, "__await__"):
                # async identifiers (istio: cluster + route-rule lookups)
                dst = await dst
        if not isinstance(dst, DstPath):
            # identifier answered directly (istio redirect responses —
            # ref IstioIdentifierBase.redirectRequest)
            return dst
        if self._local_dtab_fn is not None:
            extra = self._local_dtab_fn(dst.path)
            if len(extra):
                import dataclasses
                dst = dataclasses.replace(
                    dst, local_dtab=dst.local_dtab + extra)
        req.ctx["dst"] = dst
        # binding + service stages are attributed inside DynBoundService
        # (the pending-bind wait and the dispatch through the bound tree)
        svc = self._binding.path_service(dst)
        return await svc(req)

    async def close(self) -> None:
        await self._binding.close()


def parse_local_dtab(req: Request) -> Dtab:
    """Read the l5d-dtab request header into a local dtab override.
    Malformed dtabs are the client's fault (-> 400 via IdentificationError)."""
    raw = req.headers.get_all(DTAB_HEADER)
    if not raw:
        return Dtab.empty()
    try:
        return Dtab.read(";".join(raw))
    except ValueError as e:
        raise IdentificationError(f"bad {DTAB_HEADER} header: {e}") from None


class ErrorResponder(Filter[Request, Response]):
    """Maps routing/binding/dispatch failures to HTTP statuses
    (ref: linkerd/protocol/http ErrorResponder + l5d-err header)."""

    ERR_HEADER = "l5d-err"

    async def apply(self, req: Request, service: Service) -> Response:
        try:
            return await service(req)
        except IdentificationError as e:
            return self._err(400, f"identification failed: {e}")
        except UnboundError as e:
            return self._err(400, f"no binding: {e}")
        except (BindingFailed, NoBrokersAvailable) as e:
            return self._err(502, f"binding failed: {e}")
        except OverloadShed as e:
            # retryable by contract: the request was never admitted, so
            # an edge router may safely re-dispatch it elsewhere
            rsp = self._err(503, f"overloaded: {e}")
            rsp.headers.set("l5d-retryable", "true")
            return rsp
        except ConnectionError as e:
            return self._err(502, f"connection failed: {e}")
        except TimeoutError as e:
            return self._err(504, f"timeout: {e}")

    def _err(self, status: int, msg: str) -> Response:
        rsp = Response(status=status, body=msg.encode())
        rsp.headers.set(self.ERR_HEADER, msg.replace("\n", " ")[:512])
        return rsp


class StatsFilter(Filter[Request, Response]):
    """requests/success/failures counters + latency stat under a scope
    (ref: finagle StatsFilter as installed by the path stack,
    Router.scala:321-362; scope convention rt/<router>/...)."""

    def __init__(self, metrics: MetricsTree, *scope: str):
        node = metrics.scope(*scope)
        self._requests = node.counter("requests")
        self._success = node.counter("success")
        self._failures = node.counter("failures")
        self._latency = node.stat("request_latency_ms")

    async def apply(self, req: Request, service: Service) -> Response:
        self._requests.incr()
        t0 = time.monotonic()
        try:
            rsp = await service(req)
        except BaseException:
            self._failures.incr()
            self._latency.add((time.monotonic() - t0) * 1e3)
            raise
        self._latency.add((time.monotonic() - t0) * 1e3)
        if rsp.status >= 500:
            self._failures.incr()
        else:
            self._success.incr()
        return rsp


class BasicStatsFilter(Filter):
    """Protocol-agnostic requests/success/failures + latency under a
    metrics node; success judged by an optional ``classify(req, rsp)``
    callable (default: everything that returns is a success). Used by
    the byte-oriented routers (thrift, mux)."""

    def __init__(self, node, classify=None):
        self._requests = node.counter("requests")
        self._success = node.counter("success")
        self._failures = node.counter("failures")
        self._latency = node.stat("request_latency_ms")
        self._classify = classify

    async def apply(self, req, service):
        self._requests.incr()
        t0 = time.monotonic()
        try:
            rsp = await service(req)
        except BaseException:
            self._failures.incr()
            self._latency.add((time.monotonic() - t0) * 1e3)
            raise
        self._latency.add((time.monotonic() - t0) * 1e3)
        if self._classify is None or self._classify(req, rsp):
            self._success.incr()
        else:
            self._failures.incr()
        return rsp


class StatusCodeStatsFilter(Filter[Request, Response]):
    """Per-status-code counters (ref: StatusCodeStatsFilter.scala)."""

    def __init__(self, metrics: MetricsTree, *scope: str):
        self._node = metrics.scope(*scope, "status")

    async def apply(self, req: Request, service: Service) -> Response:
        rsp = await service(req)
        self._node.counter(str(rsp.status)).incr()
        self._node.counter(f"{rsp.status // 100}XX").incr()
        return rsp


class PerDstPathStatsFilter(Filter[Request, Response]):
    """Scopes stats by the request's logical dst path
    (ref: PerDstPathStatsFilter.scala; scope service/<path>)."""

    def __init__(self, metrics: MetricsTree, *scope: str):
        self._metrics = metrics
        self._scope = scope

    async def apply(self, req: Request, service: Service) -> Response:
        dst: Optional[DstPath] = req.ctx.get("dst")  # type: ignore[assignment]
        if dst is None:
            return await service(req)
        name = dst.path.show.lstrip("/").replace("/", ".") or "root"
        filt = StatsFilter(self._metrics, *self._scope, name)
        return await filt.apply(req, service)
