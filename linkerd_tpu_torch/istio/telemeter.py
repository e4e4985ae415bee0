"""Istio mixer telemeter: reports every proxied response to istio-mixer.

The reference wires mixer reporting as a request-logger plugin
(IstioLoggerBase.scala:46: one mixerClient.report per response with
response code, path, target service, source/target labels, and duration).
Here it is a telemeter whose ``recorder()`` filter taps the server stack —
the same plugin point the jaxAnomaly telemeter uses — and reports
asynchronously so the request path never waits on mixer.

A copy of ``linkerd_tpu/istio/telemeter.py``.
"""

from __future__ import annotations

import asyncio
import logging
import time
from dataclasses import dataclass
from typing import Optional

from linkerd_tpu_torch.config import register
from linkerd_tpu_torch.router.service import Filter, Service
from linkerd_tpu_torch.telemetry.telemeter import Telemeter

log = logging.getLogger(__name__)


class MixerReportFilter(Filter):
    def __init__(self, telemeter: "IstioTelemeter"):
        self.telemeter = telemeter

    async def apply(self, req, service: Service):
        t0 = time.monotonic()
        status = 0
        try:
            rsp = await service(req)
            status = getattr(rsp, "status", 0)
            return rsp
        except BaseException:
            status = 500
            raise
        finally:
            self.telemeter.enqueue_report(
                status=status,
                path=getattr(req, "uri", getattr(req, "path", "/")),
                target=(getattr(req, "host", None)
                        or getattr(req, "authority", "") or ""),
                duration_s=time.monotonic() - t0)


@register("telemeter", "io.l5d.istio")
@dataclass
class IstioTelemeterConfig:
    """Mixer telemetry (ref IstioLoggerConfig / IstioLoggerBase)."""

    mixerHost: str = "istio-mixer"
    mixerPort: int = 9091
    sourceApp: str = "linkerd"
    targetVersion: str = ""
    experimental: bool = True

    def mk(self, metrics) -> "IstioTelemeter":
        return IstioTelemeter(self, metrics)


class IstioTelemeter(Telemeter):
    def __init__(self, cfg: IstioTelemeterConfig, metrics):
        self.cfg = cfg
        self.metrics = metrics
        self._client = None
        self._h2 = None
        self._queue: asyncio.Queue = asyncio.Queue(maxsize=4096)
        self._task: Optional[asyncio.Task] = None
        self._reported = metrics.scope("istio").counter("reports")
        self._failed = metrics.scope("istio").counter("report_failures")

    def recorder(self) -> MixerReportFilter:
        return MixerReportFilter(self)

    def enqueue_report(self, status: int, path: str, target: str,
                       duration_s: float) -> None:
        self._ensure_task()
        try:
            self._queue.put_nowait((status, path, target, duration_s))
        except asyncio.QueueFull:
            pass  # telemetry is best-effort; never block the data path

    def _ensure_task(self) -> None:
        if self._task is None or self._task.done():
            self._task = asyncio.ensure_future(self._run())

    def _ensure_client(self):
        if self._client is None:
            from linkerd_tpu_torch.istio.mixer import MixerClient
            from linkerd_tpu_torch.protocol.h2.client import H2Client
            self._h2 = H2Client(self.cfg.mixerHost, self.cfg.mixerPort)
            self._client = MixerClient(
                self._h2, authority=self.cfg.mixerHost)
        return self._client

    async def _run(self) -> None:
        while True:
            status, path, target, duration_s = await self._queue.get()
            try:
                await self._ensure_client().report(
                    response_code=status,
                    request_path=path,
                    target_service=target,
                    source_label_app=self.cfg.sourceApp,
                    target_label_app=target.split(".")[0] if target else "",
                    target_label_version=self.cfg.targetVersion,
                    duration_s=duration_s)
                self._reported.incr()
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001 — drop + count
                self._failed.incr()
                log.debug("mixer report failed: %r", e)

    async def run(self) -> None:
        self._ensure_task()

    def close(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None
        if self._h2 is not None:
            h2, self._h2 = self._h2, None
            try:
                asyncio.get_running_loop()
            except RuntimeError:
                # no running loop (interpreter teardown): the transport
                # dies with the process. Checked BEFORE h2.close() is
                # called so no never-awaited coroutine is orphaned.
                return
            from linkerd_tpu_torch.core.tasks import spawn
            spawn(h2.close(), what="istio-mixer-h2-close")


class _IstioLoggerFilter(MixerReportFilter):
    """MixerReportFilter owning a private telemeter (the logger plugin
    shape: materialized per router, closed with the linker)."""

    def close(self) -> None:
        self.telemeter.close()


@register("logger", "io.l5d.k8s.istio")
@dataclass
class IstioLoggerConfig(IstioTelemeterConfig):
    """Request-logger plugin reporting each response to istio-mixer —
    the reference's logger-plugin wiring of the same mixer machinery the
    io.l5d.istio telemeter uses (ref IstioLogger.scala:15-35 + the h2
    twin; kind io.l5d.k8s.istio under `loggers`). Inherits the
    telemeter's mixer fields so the two kinds cannot drift."""

    def mk(self, metrics=None) -> Filter:
        # given the linker tree, the istio reports/report_failures
        # counters surface in /admin/metrics.json like the telemeter's
        if metrics is None:
            from linkerd_tpu_torch.telemetry.metrics import MetricsTree
            metrics = MetricsTree()
        return _IstioLoggerFilter(IstioTelemeter(self, metrics))
