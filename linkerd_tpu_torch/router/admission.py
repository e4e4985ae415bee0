"""Admission control: bounded concurrency + bounded pending queue: a copy of
``linkerd_tpu/router/admission.py``.

Reference parity: finagle's RequestSemaphoreFilter as ServerConfig's
``maxConcurrentRequests`` installs it (Server.scala:89-97), extended the
way the reference deployments actually run it — with a small wait queue
in front so short bursts absorb instead of shedding, and a RETRYABLE
shed signal so edge routers re-dispatch safely: http sheds surface as
503 + ``l5d-retryable: true`` (ErrorResponder), h2/gRPC sheds surface as
``RST_STREAM REFUSED_STREAM`` (H2ErrorResponder), which clients treat as
safe-to-retry because the request was never admitted.

The concurrency bound is dynamic: ``set_limit`` narrows the effective
limit below the configured ceiling (and back), which is how the control
loop's AdaptiveAdmission (control/admission.py) sheds preemptively when
anomaly scores or model drift say trouble is coming. The queue is FIFO
and admission is strict: while anyone waits, new arrivals queue behind
them rather than stealing freed slots.
"""

from __future__ import annotations

import asyncio
import collections
from typing import Deque, Optional

from linkerd_tpu_torch.router.service import Filter, Service
from linkerd_tpu_torch.router.stages import staged


class OverloadShed(Exception):
    """The request was refused by admission control before any work
    happened — safe to retry elsewhere."""


class AdmissionControlFilter(Filter):
    """At most ``effective_concurrency`` requests dispatch concurrently
    (<= the configured ``max_concurrency`` ceiling); up to
    ``max_pending`` more may queue for a slot; beyond that the request
    is shed with OverloadShed. One instance per router (the bound is a
    router property, shared across its servers).

    The top-level gate is shared fairly (FIFO); per-TENANT sub-limits
    (``set_tenant_limit``, keyed by the hash TenantTagFilter stamps
    into ``ctx["tenant_hash"]``) bound any single tenant's share of it
    on top: a tenant at its sub-limit is shed retryably up front — no
    queue slot, no global slot — while every other tenant's budget is
    untouched. The TenantAdmission governor shrinks a sick tenant's
    sub-limit toward its floor and clears it on recovery."""

    def __init__(self, max_concurrency: int, max_pending: int = 0,
                 metrics_node=None):
        if max_concurrency < 1:
            raise ValueError("max_concurrency must be >= 1")
        if max_pending < 0:
            raise ValueError("max_pending must be >= 0")
        self.max_concurrency = max_concurrency
        self.max_pending = max_pending
        self._limit = max_concurrency
        self._inflight = 0
        self._pending = 0
        self._waiters: Deque[asyncio.Future] = collections.deque()
        # per-tenant sub-limits + inflight, keyed by tenant hash
        self._tenant_limits: dict = {}
        self._tenant_inflight: dict = {}
        if metrics_node is not None:
            self._shed = metrics_node.counter("shed_total")
            self._tenant_shed = metrics_node.counter("tenant_shed_total")
            metrics_node.gauge("inflight", fn=lambda: float(self._inflight))
            metrics_node.gauge("pending", fn=lambda: float(self._pending))
            metrics_node.gauge("limit", fn=lambda: float(self._limit))
            metrics_node.gauge(
                "tenant_limits",
                fn=lambda: float(len(self._tenant_limits)))
        else:
            self._shed = None
            self._tenant_shed = None

    def set_tenant_limit(self, tenant_hash: int,
                         limit: Optional[int]) -> None:
        """Install (or clear, with ``None``) one tenant's concurrency
        sub-limit. Narrowing never cancels in-flight work."""
        if limit is None:
            self._tenant_limits.pop(tenant_hash, None)
        else:
            self._tenant_limits[tenant_hash] = max(0, int(limit))

    def tenant_limit_of(self, tenant_hash: int) -> Optional[int]:
        return self._tenant_limits.get(tenant_hash)

    @property
    def effective_concurrency(self) -> int:
        return self._limit

    def set_limit(self, limit: int) -> None:
        """Narrow (or re-widen) the live concurrency bound, clamped to
        [1, max_concurrency]. Widening admits queued waiters
        immediately; narrowing never cancels in-flight work — the bound
        tightens as requests complete."""
        self._limit = max(1, min(int(limit), self.max_concurrency))
        self._admit_waiters()

    def _admit_waiters(self) -> None:
        while self._waiters and self._inflight < self._limit:
            fut = self._waiters.popleft()
            if fut.done():
                continue  # cancelled while queued
            self._inflight += 1
            fut.set_result(None)

    async def apply(self, req, service: Service):
        # per-tenant sub-limit first: an over-limit tenant is refused
        # before it can take a queue slot or a global slot (the shed is
        # retryable by the same contract as the global gate's)
        th = req.ctx.get("tenant_hash") if hasattr(req, "ctx") else None
        if th is not None:
            tl = self._tenant_limits.get(th)
            if tl is not None \
                    and self._tenant_inflight.get(th, 0) >= tl:
                if self._tenant_shed is not None:
                    self._tenant_shed.incr()
                raise OverloadShed(
                    f"admission control: tenant over its sub-limit "
                    f"({tl}); shedding")
            # the tenant slot is taken NOW (not after the queue wait)
            # so queued same-tenant arrivals count against the
            # sub-limit instead of slipping past it
            self._tenant_inflight[th] = \
                self._tenant_inflight.get(th, 0) + 1
        try:
            return await self._admit_and_serve(req, service)
        finally:
            if th is not None:
                left = self._tenant_inflight.get(th, 0) - 1
                if left <= 0:
                    self._tenant_inflight.pop(th, None)
                else:
                    self._tenant_inflight[th] = left

    async def _admit_and_serve(self, req, service: Service):
        if self._inflight < self._limit and not self._waiters:
            self._inflight += 1
        elif self._pending >= self.max_pending:
            if self._shed is not None:
                self._shed.incr()
            raise OverloadShed(
                f"admission control: {self._limit} in flight "
                f"+ {self.max_pending} pending; shedding")
        else:
            loop = asyncio.get_running_loop()
            fut = loop.create_future()
            self._waiters.append(fut)
            self._pending += 1
            try:
                with staged(req, "queue"):
                    await fut
            except asyncio.CancelledError:
                if fut.done() and not fut.cancelled():
                    # admitted on the same tick the caller cancelled:
                    # hand the slot to the next waiter
                    self._inflight -= 1
                    self._admit_waiters()
                raise
            finally:
                self._pending -= 1
        try:
            return await service(req)
        finally:
            self._inflight -= 1
            self._admit_waiters()
