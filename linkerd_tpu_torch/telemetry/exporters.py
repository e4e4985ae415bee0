"""Exporter telemeters: prometheus, influxdb, statsd, tracelog,
recentRequests, zipkin: a copy of ``linkerd_tpu/telemetry/exporters.py``.

Reference parity (SURVEY.md §2.3): telemetry/prometheus
(label-rewriting text exposition, PrometheusTelemeter.scala:62-80),
telemetry/influxdb (LINE protocol for Telegraf pull), telemetry/statsd
(dogstatsd push), telemetry/tracelog (sampled span logging),
telemetry/recent-requests (in-memory ring + admin table).
"""

from __future__ import annotations

import asyncio
import collections
import json
import logging
import re
import time
from dataclasses import dataclass
from typing import Deque, Dict, List, Optional, Tuple

from linkerd_tpu_torch.config import register
from linkerd_tpu_torch.protocol.http.message import Request, Response
from linkerd_tpu_torch.telemetry.metrics import Counter, Gauge, MetricsTree, Stat
from linkerd_tpu_torch.telemetry.telemeter import Telemeter, Tracer

log = logging.getLogger(__name__)

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")
_STATSD_RE = re.compile(r"[^a-zA-Z0-9_.]")


def _sanitize(name: str) -> str:
    return _NAME_RE.sub("_", name)


def _sanitize_statsd(name: str) -> str:
    return _STATSD_RE.sub("_", name)


def _labeled_name(names: Tuple[str, ...]) -> Tuple[str, Dict[str, str]]:
    """Rewrite the rt/<router>/{server,service/<svc>,client/<id>} scope
    convention into labels (ref: PrometheusTelemeter.scala:62-80)."""
    labels: Dict[str, str] = {}
    rest = list(names)
    if len(rest) >= 2 and rest[0] == "rt":
        labels["rt"] = rest[1]
        rest = rest[2:]
        if rest and rest[0] == "server":
            rest = rest[1:]
        elif len(rest) >= 2 and rest[0] in ("service", "client"):
            labels[rest[0]] = rest[1]
            rest = rest[2:]
    return _sanitize("_".join(rest) or "value"), labels


def _fmt_labels(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def prometheus_text(metrics: MetricsTree) -> str:
    lines: List[str] = []
    for names, metric in metrics.walk():
        name, labels = _labeled_name(names)
        if isinstance(metric, Counter):
            lines.append(f"{name}{_fmt_labels(labels)} {metric.value}")
        elif isinstance(metric, Gauge):
            lines.append(f"{name}{_fmt_labels(labels)} {metric.value}")
        elif isinstance(metric, Stat):
            snap = metric.snapshot()
            if snap["count"] == 0:
                continue
            quantiles = {"p50": "0.5", "p90": "0.9", "p95": "0.95",
                         "p99": "0.99", "p999": "0.999"}
            for q, qv in quantiles.items():
                ql = dict(labels)
                ql["quantile"] = qv
                lines.append(f"{name}{_fmt_labels(ql)} {snap[q]}")
            lines.append(f"{name}_count{_fmt_labels(labels)} {snap['count']}")
            lines.append(f"{name}_sum{_fmt_labels(labels)} {snap['sum']}")
            lines.append(f"{name}_avg{_fmt_labels(labels)} {snap['avg']}")
    return "\n".join(lines) + "\n"


def influxdb_line(metrics: MetricsTree, host: str = "localhost") -> str:
    """LINE protocol, one measurement per scope prefix
    (ref: InfluxDbTelemeter.scala:17)."""
    by_prefix: Dict[Tuple[Tuple[str, ...], Tuple[Tuple[str, str], ...]],
                    Dict[str, float]] = {}
    for names, metric in metrics.walk():
        if len(names) < 1:
            continue
        name, labels = _labeled_name(names)
        key_prefix = tuple(sorted(labels.items()))
        measurement = names[0] if names[0] != "rt" else "rt"
        if isinstance(metric, (Counter, Gauge)):
            fields = {name: float(metric.value)}
        else:
            snap = metric.snapshot()
            if snap["count"] == 0:
                continue
            fields = {f"{name}_{k}": float(v) for k, v in snap.items()}
        by_prefix.setdefault((measurement, key_prefix), {}).update(fields)
    lines = []
    for (measurement, labels), fields in sorted(by_prefix.items()):
        tag_str = "".join(f",{k}={v}" for k, v in labels)
        field_str = ",".join(f"{k}={v}" for k, v in sorted(fields.items()))
        lines.append(f"{measurement},host={host}{tag_str} {field_str}")
    return "\n".join(lines) + "\n"


@register("telemeter", "io.l5d.prometheus")
@dataclass
class PrometheusConfig:
    """Expose the MetricsTree in Prometheus text format at ``path``
    on the admin server."""

    path: str = "/admin/metrics/prometheus"

    def mk(self, metrics: MetricsTree) -> Telemeter:
        return PrometheusTelemeter(metrics, self.path)


class PrometheusTelemeter(Telemeter):
    def __init__(self, metrics: MetricsTree, path: str):
        self.metrics = metrics
        self.path = path

    def admin_handlers(self):
        async def handler(req: Request) -> Response:
            rsp = Response(body=prometheus_text(self.metrics).encode())
            rsp.headers.set("Content-Type", "text/plain; version=0.0.4")
            return rsp

        return [(self.path, handler)]


@register("telemeter", "io.l5d.influxdb")
@dataclass
class InfluxDbConfig:
    """Expose the MetricsTree as InfluxDB line protocol at ``path``
    on the admin server (for Telegraf scrapes)."""

    path: str = "/admin/metrics/influxdb"

    def mk(self, metrics: MetricsTree) -> Telemeter:
        return InfluxDbTelemeter(metrics, self.path)


class InfluxDbTelemeter(Telemeter):
    def __init__(self, metrics: MetricsTree, path: str):
        self.metrics = metrics
        self.path = path

    def admin_handlers(self):
        async def handler(req: Request) -> Response:
            rsp = Response(body=influxdb_line(self.metrics).encode())
            rsp.headers.set("Content-Type", "text/plain")
            return rsp

        return [(self.path, handler)]


@register("telemeter", "io.l5d.statsd", experimental=True)
@dataclass
class StatsDConfig:
    """Push counters/timings to a StatsD agent over UDP; gauges
    flush every ``gaugeIntervalMs``."""

    host: str = "127.0.0.1"
    port: int = 8125
    prefix: str = "linkerd"
    gaugeIntervalMs: int = 10000

    def mk(self, metrics: MetricsTree) -> Telemeter:
        return StatsDTelemeter(metrics, self)


class StatsDTelemeter(Telemeter):
    """Pushes counters (as deltas) and gauges over UDP dogstatsd lines
    every gaugeIntervalMs (ref: StatsDTelemeter.scala:9)."""

    def __init__(self, metrics: MetricsTree, cfg: StatsDConfig):
        self.metrics = metrics
        self.cfg = cfg
        self._last_counters: Dict[str, int] = {}
        self._transport = None
        self._stop = asyncio.Event()

    async def run(self) -> None:
        loop = asyncio.get_running_loop()
        self._transport, _ = await loop.create_datagram_endpoint(
            asyncio.DatagramProtocol,
            remote_addr=(self.cfg.host, self.cfg.port))
        try:
            while not self._stop.is_set():
                await asyncio.sleep(self.cfg.gaugeIntervalMs / 1e3)
                self.flush()
        except asyncio.CancelledError:
            pass
        finally:
            if self._transport:
                self._transport.close()

    def flush(self) -> None:
        if self._transport is None:
            return
        out = []
        for names, metric in self.metrics.walk():
            key = f"{self.cfg.prefix}.{'.'.join(names)}"
            key = _sanitize_statsd(key.replace("/", "."))
            if isinstance(metric, Counter):
                delta = metric.value - self._last_counters.get(key, 0)
                self._last_counters[key] = metric.value
                if delta:
                    out.append(f"{key}:{delta}|c")
            elif isinstance(metric, Gauge):
                out.append(f"{key}:{metric.value}|g")
            elif isinstance(metric, Stat):
                snap = metric.snapshot()
                if snap["count"]:
                    out.append(f"{key}.p99:{snap['p99']}|g")
                    out.append(f"{key}.p50:{snap['p50']}|g")
        for line in out:
            self._transport.sendto(line.encode())

    def close(self) -> None:
        self._stop.set()


@register("telemeter", "io.l5d.tracelog")
@dataclass
class TracelogConfig:
    """Write sampled trace annotations to the python log at
    ``level``."""

    sampleRate: float = 1.0
    level: str = "INFO"

    def mk(self, metrics: MetricsTree) -> Telemeter:
        return TracelogTelemeter(self)


class TracelogTelemeter(Telemeter):
    """Logs sampled spans (ref: TracelogInitializer.scala:47)."""

    def __init__(self, cfg: TracelogConfig):
        self.cfg = cfg
        self._log = logging.getLogger("linkerd_tpu.tracelog")
        self._level = getattr(logging, cfg.level.upper(), logging.INFO)
        self._tracer = _FnTracer(self._record)
        import random
        self._rng = random.Random()

    def _record(self, span: dict) -> None:
        if self._rng.random() < self.cfg.sampleRate:
            self._log.log(self._level, "trace %s span %s %s %sus %s",
                          span.get("traceId"), span.get("id"),
                          span.get("name"), span.get("duration"),
                          span.get("tags"))

    @property
    def tracer(self) -> Tracer:
        return self._tracer


class _FnTracer(Tracer):
    def __init__(self, fn):
        self._fn = fn

    def record(self, span: dict) -> None:
        self._fn(span)


@register("telemeter", "io.l5d.recentRequests")
@dataclass
class RecentRequestsConfig:
    """Keep an in-memory ring of the last ``capacity`` sampled
    requests, served at /requests.json on the admin server."""

    sampleRate: float = 1.0
    capacity: int = 100

    def mk(self, metrics: MetricsTree) -> Telemeter:
        return RecentRequestsTelemeter(self)


class RecentRequestsTelemeter(Telemeter):
    """In-memory ring of sampled spans + /requests admin table
    (ref: RecentRequetsTracer.scala:14)."""

    def __init__(self, cfg: RecentRequestsConfig):
        self.cfg = cfg
        self.ring: Deque[dict] = collections.deque(maxlen=cfg.capacity)
        import random
        self._rng = random.Random()
        self._tracer = _FnTracer(self._record)

    def _record(self, span: dict) -> None:
        if span.get("kind") == "SERVER" and (
                self._rng.random() < self.cfg.sampleRate):
            self.ring.append(span)

    @property
    def tracer(self) -> Tracer:
        return self._tracer

    def admin_handlers(self):
        from linkerd_tpu_torch.admin.server import json_response

        async def requests(req: Request) -> Response:
            return json_response(list(self.ring))

        return [("/requests.json", requests)]


@register("telemeter", "io.l5d.zipkin")
@dataclass
class ZipkinConfig:
    """Ship sampled spans to a Zipkin collector (v2 JSON API) in
    batches every ``batchIntervalMs``; bounded buffering, exponential
    backoff on collector failure, stats at ``/tracer.json``."""

    host: str = "127.0.0.1"
    port: int = 9411
    sampleRate: float = 0.001
    batchIntervalMs: int = 1000
    # bounded buffering: spans beyond this are dropped (and counted) —
    # a dead collector must cost memory-bounded, never unbounded
    maxBufferedSpans: int = 10000
    # spans per POST (zipkin collectors reject oversized bodies)
    maxBatch: int = 500
    # backoff bounds after a failed POST
    backoffMinMs: int = 1000
    backoffMaxMs: int = 30000

    def mk(self, metrics: MetricsTree) -> Telemeter:
        return ZipkinTelemeter(self)


class ZipkinTelemeter(Telemeter):
    """Zipkin v2 JSON span sink over HTTP POST /api/v2/spans.

    The reference ships scribe-thrift (ZipkinInitializer.scala:27-60, a
    2017-era protocol); the v2 HTTP API is the modern equivalent of the
    same component. Sampling is decided at trace creation (the
    ``l5d-sample`` header / router sampleRate drive span.sampled, and
    the trace filters only record sampled spans), so everything handed
    to this tracer ships — unless a span explicitly carries
    ``sampled: false``, which is dropped here and counted.

    Failure posture: telemetry must never block or destabilize the data
    plane. The buffer is bounded (overflow drops the NEWEST span and
    counts it), a failed POST re-buffers its batch and backs off
    exponentially, and all of it is observable at ``/tracer.json``.
    """

    def __init__(self, cfg: ZipkinConfig):
        self.cfg = cfg
        self._buf: Deque[dict] = collections.deque()
        self._tracer = _FnTracer(self._record)
        self._stop = asyncio.Event()
        self._client = None
        # stats surfaced at /tracer.json
        self.sent_spans = 0
        self.dropped_spans = 0
        self.sampled_out = 0
        self.failed_posts = 0
        self.posts = 0
        self._backoff_s = 0.0
        self._next_send_after = 0.0  # monotonic gate while backing off

    @property
    def tracer(self) -> Tracer:
        return self._tracer

    @property
    def sample_rate(self) -> float:
        return self.cfg.sampleRate

    @property
    def buffer_depth(self) -> int:
        return len(self._buf)

    def _record(self, span: dict) -> None:
        if span.get("sampled") is False:
            self.sampled_out += 1
            return
        if len(self._buf) >= self.cfg.maxBufferedSpans:
            self.dropped_spans += 1
            return
        self._buf.append(span)

    def _ensure_client(self):
        if self._client is None:
            from linkerd_tpu_torch.protocol.http.client import HttpClient
            self._client = HttpClient(self.cfg.host, self.cfg.port,
                                      max_connections=2)
        return self._client

    async def run(self) -> None:
        try:
            while not self._stop.is_set():
                await asyncio.sleep(self.cfg.batchIntervalMs / 1e3)
                if time.monotonic() < self._next_send_after:
                    continue  # backing off after a failed POST
                await self.flush()
        except asyncio.CancelledError:
            pass
        finally:
            # detach before awaiting: a flush() racing this teardown
            # sees None and builds a fresh client instead of a closed one
            client, self._client = self._client, None
            if client is not None:
                await client.close()

    async def flush(self, client=None) -> int:
        """POST buffered spans in bounded batches; returns spans sent.
        On failure the batch is re-buffered (oldest-first, dropped if
        the buffer refilled meanwhile) and the backoff window opens."""
        sent = 0
        client = client or self._ensure_client()
        while self._buf:
            batch = [self._buf.popleft()
                     for _ in range(min(len(self._buf), self.cfg.maxBatch))]
            req = Request(method="POST", uri="/api/v2/spans",
                          body=json.dumps(batch).encode())
            req.headers.set("Content-Type", "application/json")
            req.headers.set("Host", f"{self.cfg.host}:{self.cfg.port}")
            self.posts += 1
            try:
                rsp = await client(req)
                if rsp.status >= 300:
                    raise ConnectionError(
                        f"zipkin rejected spans: {rsp.status}")
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001 — re-buffer + back off
                self.failed_posts += 1
                self._backoff_s = min(
                    max(self._backoff_s * 2, self.cfg.backoffMinMs / 1e3),
                    self.cfg.backoffMaxMs / 1e3)
                self._next_send_after = time.monotonic() + self._backoff_s
                for i, span in enumerate(reversed(batch)):
                    if len(self._buf) >= self.cfg.maxBufferedSpans:
                        # everything not re-buffered is lost — count all
                        # of it, not just the span that hit the wall
                        self.dropped_spans += len(batch) - i
                        break
                    self._buf.appendleft(span)
                log.debug("zipkin send failed (backoff %.1fs): %r",
                          self._backoff_s, e)
                return sent
            sent += len(batch)
            self.sent_spans += len(batch)
        self._backoff_s = 0.0
        self._next_send_after = 0.0
        return sent

    def stats(self) -> dict:
        return {
            "collector": f"{self.cfg.host}:{self.cfg.port}",
            "buffer_depth": len(self._buf),
            "buffer_capacity": self.cfg.maxBufferedSpans,
            "sent_spans": self.sent_spans,
            "dropped_spans": self.dropped_spans,
            "sampled_out": self.sampled_out,
            "posts": self.posts,
            "failed_posts": self.failed_posts,
            "backoff_s": round(self._backoff_s, 3),
            "sample_rate": self.cfg.sampleRate,
        }

    def admin_handlers(self):
        from linkerd_tpu_torch.admin.server import json_response

        async def tracer_json(req: Request) -> Response:
            return json_response(self.stats())

        return [("/tracer.json", tracer_json)]

    def close(self) -> None:
        self._stop.set()
