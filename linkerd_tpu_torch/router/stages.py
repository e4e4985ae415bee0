"""Per-stage latency decomposition: where did my millisecond go?: a copy of
``linkerd_tpu/router/stages.py``.

A ``StageTimer`` rides each request through the router (``req.ctx``) and
attributes wall time to the pipeline stages the stack actually executes:

- ``identification`` — the identifier naming the request
- ``binding``        — dtab delegation / binding-cache materialization
- ``queue``          — admission-control wait for a dispatch slot
- ``retry``          — backoff pauses between classified retry attempts
- ``service``        — the dispatched attempt(s): client stack + wire +
                       downstream (everything below the routing seam)

Each stage feeds a histogram under ``rt/<router>/stage/<stage>_ms`` plus
a ``total_ms`` recorded by the edge filter, so ``sum(stage p50s)`` vs
``total_ms p50`` exposes unattributed time. The same per-request totals
are exported as span tags by the tracing filters when the request is
sampled, so a single Zipkin trace decomposes the hop it describes.

There is no reference twin for this file: the reference leans on
finagle's per-module stats. This build's seam (one RoutingService for
four protocols) makes a single explicit decomposition layer cheaper
than per-module filters.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Dict, Optional

from linkerd_tpu_torch.router.service import Filter, Service
from linkerd_tpu_torch.telemetry.metrics import MetricsTree

STAGES = ("identification", "binding", "queue", "retry", "service")

CTX_KEY = "stages"


class StageTimer:
    """Accumulates per-stage milliseconds for ONE request and mirrors
    them into the router's shared stage histograms."""

    __slots__ = ("_node", "totals")

    def __init__(self, node: Optional[MetricsTree] = None):
        self._node = node
        self.totals: Dict[str, float] = {}

    def record(self, stage: str, ms: float) -> None:
        self.totals[stage] = self.totals.get(stage, 0.0) + ms
        if self._node is not None:
            self._node.stat(f"{stage}_ms").add(ms)

    @contextmanager
    def stage(self, name: str):
        t0 = time.monotonic()
        try:
            yield
        finally:
            self.record(name, (time.monotonic() - t0) * 1e3)


def timer_of(req) -> Optional[StageTimer]:
    """The request's StageTimer, or None when the router doesn't
    decompose (h2/mux requests share the same ctx-dict protocol)."""
    ctx = getattr(req, "ctx", None)
    if ctx is None:
        return None
    return ctx.get(CTX_KEY)


@contextmanager
def staged(req, name: str):
    """Time a block against ``req``'s StageTimer; no-op without one."""
    timer = timer_of(req)
    if timer is None:
        yield
        return
    with timer.stage(name):
        yield


class StageTimerFilter(Filter):
    """Server-edge filter: installs a StageTimer in ``req.ctx`` and
    records the request's total wall time. One instance per router;
    histograms live under ``rt/<router>/stage/*``."""

    def __init__(self, metrics: MetricsTree, *scope: str):
        self._node = metrics.scope(*scope, "stage")
        self._total = self._node.stat("total_ms")

    async def apply(self, req, service: Service):
        timer = StageTimer(self._node)
        req.ctx[CTX_KEY] = timer
        t0 = time.monotonic()
        try:
            return await service(req)
        finally:
            self._total.add((time.monotonic() - t0) * 1e3)
