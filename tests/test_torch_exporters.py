"""The port's exporter and tracer telemeters and trace filters against the
JAX package's, on the same inputs, on the CPU.

- The same ``MetricsTree`` contents through both packages give equal
  Prometheus text, InfluxDB lines and StatsD datagrams (a second flush
  sends the counters' deltas).
- Tracelog, recentRequests and Zipkin take the same spans with their
  sampling RNGs seeded alike, and keep, log and batch the same ones.
  Zipkin's overflow, re-buffer and backoff mirror
  ``tests/test_observability.py:297-410``, package beside package.
- Tracing end to end: the same config and requests through both linkers
  (the port's on the CPU) with the trace RNGs seeded alike give equal
  span dicts (timing fields normalized), the same ``l5d-ctx-trace`` at
  the backend, and for one drained batch the same scorer spans (shape,
  tags and links), as ``tests/test_observability.py:72`` and
  ``tests/test_telemetry_exporters.py:78`` drive the reference.
"""

import asyncio
import json
import logging

import numpy as np
import pytest

from linkerd_tpu.linker import load_linker as ref_load_linker
from linkerd_tpu.protocol.http import Request, Response
from linkerd_tpu.protocol.http.client import HttpClient
from linkerd_tpu.protocol.http.server import serve
from linkerd_tpu.router import tracing as ref_tracing
from linkerd_tpu.router.service import FnService
from linkerd_tpu.telemetry import exporters as ref_exp
from linkerd_tpu.telemetry import metrics as ref_metrics
from linkerd_tpu_torch.linker import load_linker as port_load_linker
from linkerd_tpu_torch.protocol.http import message as port_message
from linkerd_tpu_torch.router import service as port_service
from linkerd_tpu_torch.router import tracing as port_tracing
from linkerd_tpu_torch.telemetry import exporters as port_exp
from linkerd_tpu_torch.telemetry import metrics as port_metrics

PKGS = {
    "ref": (ref_exp, ref_metrics, ref_tracing, Request, Response, FnService),
    "port": (port_exp, port_metrics, port_tracing, port_message.Request,
             port_message.Response, port_service.FnService),
}


def run(coro, timeout=30):
    return asyncio.run(asyncio.wait_for(coro, timeout))


def fill(mt, seed: int = 0) -> None:
    """Counters, gauges and stats under the router, service, client and
    telemeter scopes, with values from a seed."""
    rng = np.random.default_rng(seed)
    for scope in (("rt", "web", "server"), ("rt", "web", "service",
                                             "svc.web"),
                  ("rt", "web", "client", "#.io.l5d.fs.web"),
                  ("anomaly",), ("rt", "web", "stage")):
        node = mt.scope(*scope)
        node.counter("requests").incr(int(rng.integers(1, 1000)))
        node.counter("status", "200").incr(int(rng.integers(0, 50)))
        node.gauge("level").set(float(rng.random()))
        s = node.stat("request_latency_ms")
        for v in rng.gamma(2.0, 3.0, size=int(rng.integers(1, 200))):
            s.add(float(v))
        node.stat("empty_ms")  # a stat with no samples
    mt.gauge("anomaly", "dst", "svc.web").set(0.25)


def both_trees(seed: int = 0):
    out = {}
    for pkg, (_, metrics, *_rest) in PKGS.items():
        mt = metrics.MetricsTree()
        fill(mt, seed)
        out[pkg] = mt
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_prometheus_and_influxdb_text_equal(seed):
    trees = both_trees(seed)
    prom = {pkg: PKGS[pkg][0].prometheus_text(mt)
            for pkg, mt in trees.items()}
    influx = {pkg: PKGS[pkg][0].influxdb_line(mt, host="h1")
              for pkg, mt in trees.items()}
    assert prom["port"] == prom["ref"]
    assert influx["port"] == influx["ref"]
    assert 'requests{client="#.io.l5d.fs.web",rt="web"}' in prom["port"]


def test_admin_text_handlers_equal():
    """The Prometheus and InfluxDB telemeters' admin handlers serve the
    same bodies and content types."""
    async def go():
        out = {}
        for pkg, (exp, _, _, Req, _, _) in PKGS.items():
            mt = both_trees()[pkg]
            got = []
            for cfg in (exp.PrometheusConfig(), exp.InfluxDbConfig()):
                (path, h), = cfg.mk(mt).admin_handlers()
                rsp = await h(Req())
                got.append((path, rsp.headers.get("Content-Type"),
                            rsp.body.count(b"\n")))
            out[pkg] = got
        return out

    out = run(go())
    assert out["port"] == out["ref"]


class _Datagrams:
    def __init__(self):
        self.lines = []

    def sendto(self, data):
        self.lines.append(data.decode())

    def close(self):
        pass


def test_statsd_datagrams_equal():
    """Two flushes of the same tree: the first sends every counter, gauge
    and stat quantile, the second only the counters that moved."""
    out = {}
    for pkg, (exp, metrics, *_rest) in PKGS.items():
        mt = metrics.MetricsTree()
        fill(mt)
        tele = exp.StatsDConfig(prefix="l5d").mk(mt)
        tele._transport = _Datagrams()
        tele.flush()
        mt.counter("rt", "web", "server", "requests").incr(7)
        tele.flush()
        out[pkg] = tele._transport.lines
    assert out["port"] == out["ref"]
    assert "l5d.rt.web.server.requests:7|c" in out["port"]


def spans(n: int, seed: int = 0):
    """``n`` span dicts of both kinds from a seed."""
    rng = np.random.default_rng(seed)
    return [{"traceId": f"{int(rng.integers(1 << 62)):032x}",
             "id": f"{i:016x}", "kind": ("SERVER", "CLIENT")[i % 3 == 2],
             "name": "GET /", "duration": int(rng.integers(1, 9000)),
             "tags": {"router.label": "web"}} for i in range(n)]


@pytest.mark.parametrize("rate", [1.0, 0.3])
def test_recent_requests_and_tracelog_keep_the_same_spans(rate, caplog):
    out = {}
    for pkg, (exp, metrics, _, Req, _, _) in PKGS.items():
        rr = exp.RecentRequestsConfig(sampleRate=rate, capacity=16).mk(
            metrics.MetricsTree())
        tl = exp.TracelogConfig(sampleRate=rate).mk(metrics.MetricsTree())
        rr._rng.seed(5)
        tl._rng.seed(5)
        caplog.clear()
        with caplog.at_level(logging.INFO, logger="linkerd_tpu.tracelog"):
            for s in spans(40):
                rr.tracer.record(dict(s))
                tl.tracer.record(dict(s))
        (path, h), = rr.admin_handlers()
        body = json.loads(run(h(Req())).body)
        out[pkg] = (path, body, [r.getMessage() for r in caplog.records])
    assert out["port"] == out["ref"]
    assert out["port"][1] and all(s["kind"] == "SERVER"
                                  for s in out["port"][1])


def zipkin_scenario(pkg: str, case: str):
    """One of the reference's Zipkin exporter scenarios
    (tests/test_observability.py:297-410) on ``pkg``; returns what it
    reads: stats, buffer depth and what was posted."""
    exp, metrics, _, Req, Rsp, Fn = PKGS[pkg]
    posted = []

    async def ok(req):
        posted.append(json.loads(req.body))
        return Rsp(status=202)

    async def failing(req):
        raise ConnectionError("collector down")

    async def reject(req):
        return Rsp(status=500)

    async def go():
        if case == "overflow":
            tele = exp.ZipkinConfig(maxBufferedSpans=3).mk(
                metrics.MetricsTree())
            for i in range(5):
                tele.tracer.record({"traceId": f"{i:032x}", "id": "01"})
        elif case == "unsampled":
            tele = exp.ZipkinConfig().mk(metrics.MetricsTree())
            tele.tracer.record({"traceId": "ab", "id": "01",
                                "sampled": False})
        elif case == "backoff":
            tele = exp.ZipkinConfig(backoffMinMs=500).mk(
                metrics.MetricsTree())
            tele.tracer.record({"traceId": "ab", "id": "01"})
            steps = [await tele.flush(Fn(failing)), tele.stats()]
            steps += [await tele.flush(Fn(failing)), tele.stats()]
            steps += [await tele.flush(Fn(ok)), tele.stats()]
            return steps, posted
        elif case == "rebuffer_overflow":
            tele = exp.ZipkinConfig(maxBufferedSpans=2, maxBatch=2).mk(
                metrics.MetricsTree())
            tele.tracer.record({"traceId": "aa", "id": "01"})
            tele.tracer.record({"traceId": "bb", "id": "02"})

            async def filling(req):
                tele.tracer.record({"traceId": "cc", "id": "03"})
                tele.tracer.record({"traceId": "dd", "id": "04"})
                raise ConnectionError("collector down")

            await tele.flush(Fn(filling))
        elif case == "rejected":
            tele = exp.ZipkinConfig().mk(metrics.MetricsTree())
            tele.tracer.record({"traceId": "ab", "id": "01"})
            await tele.flush(Fn(reject))
        elif case == "max_batch":
            tele = exp.ZipkinConfig(maxBatch=2).mk(metrics.MetricsTree())
            for i in range(5):
                tele.tracer.record({"traceId": f"{i:032x}", "id": "01"})
            await tele.flush(Fn(ok))
        (path, h), = tele.admin_handlers()
        tracer_json = json.loads((await h(Req())).body)
        return path, tracer_json, tele.buffer_depth, posted

    return run(go())


@pytest.mark.parametrize("case", ["overflow", "unsampled", "backoff",
                                  "rebuffer_overflow", "rejected",
                                  "max_batch"])
def test_zipkin_buffering_and_backoff_match(case):
    ref, port = (zipkin_scenario(pkg, case) for pkg in ("ref", "port"))
    assert port == ref
    if case == "backoff":
        (s0, st0, s1, st1, s2, st2), posted = port
        assert (s0, st0["backoff_s"], st1["backoff_s"], s2,
                st2["backoff_s"]) == (0, 0.5, 1.0, 1, 0.0)
        assert posted[0][0]["traceId"] == "ab"
    if case == "max_batch":
        assert [len(b) for b in port[3]] == [2, 2, 1]


# -- tracing end to end ------------------------------------------------------


class StubScorer:
    """Zero scores and a fixed timing decomposition, so one drained
    batch's scorer spans are the same through both packages."""

    def __init__(self):
        self.last_timing = {"queue_ms": 0.5, "device_ms": 1.25,
                            "transfer_ms": 0.75, "bytes": 4096}

    async def score(self, x):
        return np.zeros(len(x), np.float32)

    async def fit(self, x, labels, mask):
        return 0.0

    def close(self):
        pass


TRACE_CONFIG = """
routers:
- protocol: http
  label: tr
  sampleRate: 1.0
  dtab: |
    /svc => /#/io.l5d.fs ;
  servers: [{{port: 0}}]
telemetry:
- kind: io.l5d.recentRequests
  capacity: 50
- kind: io.l5d.zipkin
  port: {collector}
  batchIntervalMs: 60000
- kind: io.l5d.jaxAnomaly
  trainEveryBatches: 0
namers:
- kind: io.l5d.fs
  rootDir: {disco}
"""

TIMING = ("timestamp", "duration")


def normalized(span: dict) -> dict:
    """A span with its timing fields, the stage timings' values and
    the scorer's queue wait (host timing) blanked; ids, names, kinds,
    links and every other tag are kept."""
    out = {k: (None if k in TIMING else v) for k, v in span.items()}
    out["tags"] = {k: (None if k.startswith("stage.")
                       or k == "scorer.queue_ms" else v)
                   for k, v in span.get("tags", {}).items()}
    if "annotations" in out:
        out["annotations"] = [a["value"] for a in out["annotations"]]
    return out


def traced_run(pkg: str, root_dir):
    """Four requests through a linker of ``pkg`` (two carrying a caller's
    trace, one ``l5d-sample: 0``), then one drained batch; returns the
    exported spans, the recent requests ring and the trace headers the
    backend saw."""
    disco = root_dir / pkg
    disco.mkdir()
    seen, batches = [], []
    load = {"ref": ref_load_linker,
            "port": lambda t: port_load_linker(t, device="cpu")}[pkg]
    tracing = PKGS[pkg][2]

    async def backend(req: Request) -> Response:
        seen.append(req.headers.get(ref_tracing.CTX_TRACE))
        return Response(200, body=b"ok")

    async def collector(req: Request) -> Response:
        batches.append(json.loads(req.body))
        return Response(status=202)

    async def go():
        d = await serve(FnService(backend))
        coll = await serve(FnService(collector))
        (disco / "web").write_text(f"127.0.0.1 {d.bound_port}\n")
        linker = load(TRACE_CONFIG.format(collector=coll.bound_port,
                                          disco=disco))
        tele = linker._anomaly_telemeter()
        tele._scorer = StubScorer()
        await linker.start()
        proxy = HttpClient("127.0.0.1", linker.routers[0].server_ports[0])
        try:
            tracing._rng.seed(11)
            caller = tracing.TraceId.mk_root(sampled=True)
            for hdr in (caller.encode(), None, "sample0", caller.encode()):
                req = Request(uri="/")
                req.headers.set("Host", "web")
                if hdr == "sample0":
                    req.headers.set(ref_tracing.SAMPLE_HEADER, "0")
                elif hdr is not None:
                    req.headers.set(ref_tracing.CTX_TRACE, hdr)
                assert (await proxy(req)).status == 200
            assert await tele.drain_once() == 4
            zipkin = next(t for t in linker.telemeters
                          if hasattr(t, "flush"))
            await zipkin.flush()
            rr = next(t for t in linker.telemeters if hasattr(t, "ring")
                      and t is not tele)
            return ([s for b in batches for s in b], list(rr.ring),
                    list(seen))
        finally:
            await proxy.close()
            await linker.close()
            await d.close()
            await coll.close()

    return run(go())


def test_spans_and_propagation_match(tmp_path):
    ref, port = (traced_run(pkg, tmp_path) for pkg in ("ref", "port"))
    (r_spans, r_ring, r_seen), (p_spans, p_ring, p_seen) = ref, port
    assert p_seen == r_seen
    assert [s is None for s in p_seen] == [False] * 4
    assert [normalized(s) for s in p_spans] == \
        [normalized(s) for s in r_spans]
    assert [normalized(s) for s in p_ring] == \
        [normalized(s) for s in r_ring]
    kinds = sorted((s["localEndpoint"]["serviceName"], s["kind"])
                   for s in p_spans)
    # three sampled requests: a server and a client span each; one batch
    # span and one child span a sampled request
    assert kinds == sorted([("tr", "SERVER")] * 3
                           + [("#.io.l5d.fs.web", "CLIENT")] * 3
                           + [("scorer", "CONSUMER")] * 4)
    batch = next(s for s in p_spans if s["name"] == "scorer.batch")
    assert batch["tags"]["scorer.batch_size"] == "4"
    assert batch["tags"]["scorer.linked"] == "3"
    assert batch["tags"]["scorer.device_ms"] == "1.250"
    servers = [s for s in p_spans if s["kind"] == "SERVER"]
    links = {a["value"] for a in batch["annotations"]}
    assert links == {f"link:{s['traceId']}:{s['id']}" for s in servers}
