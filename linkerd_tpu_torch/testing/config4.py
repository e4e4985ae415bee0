"""BASELINE config 4 on the port: the io.l5d.k8s namer over a scripted
Kubernetes API server, the router's dtab in a ConfigMap (the
io.l5d.k8s.configMap interpreter), zipkin tracing to a collector, and a
rolling restart of one service whose surviving pod degrades with
latency alone, scored by the io.l5d.jaxAnomaly telemeter.

The config and schedule of ``benchmarks/config4_k8s.py``, importing only
the port. ``drive`` takes a started linker of ``CONFIG`` through a
``Traffic``: phase A of round-robin sweeps over the ten services, six
retrain epochs on the ring's copy, then four restart windows of
``svc-3`` (one pod leaves the Endpoints, the other answers 4-16 ms
late, no error status) each followed by a calm stretch with the pod
back, then score-only; ``evaluate`` scores the windows' labeled rows
and takes their AUC, and ``run_schedule`` does both.

Where the benchmark calls ``drain_once`` once, the schedule drains the
ring empty (``drain``), so that a run of any size leaves no row
unscored. Where the benchmark pushes an Endpoints change and sends at
once, ``Traffic.restart`` returns once the router's binding shows it,
so that no request of a window reaches the pod that left.

``Topology`` is the benchmark's topology in this process: the fake API
server, twenty pods that count what they serve, the collector, the
linker and one client; ``bench`` runs the schedule on it.

    python -m linkerd_tpu_torch.testing.config4 [--requests 600]
        [--device cpu]
"""

from __future__ import annotations

import argparse
import asyncio
import json
import time
from dataclasses import dataclass
from typing import Any, Awaitable, Callable, Dict, List, Optional, Tuple

N_SVCS = 10
PODS = 2         # pods a service
EPOCHS = 6       # retrain epochs on phase A's ring copy
WINDOWS = 4      # restart windows of VICTIM
VICTIM = "svc-3"
BINDING_S = 5.0  # longest wait for the binding to show a restart

CONFIG = """
routers:
- protocol: http
  label: k8s
  interpreter:
    kind: io.l5d.k8s.configMap
    name: l5d-dtab
    host: 127.0.0.1
    port: {k8s_port}
  servers: [{{port: 0}}]
  client:
    failureAccrual: {{kind: none}}
telemetry:
- kind: io.l5d.jaxAnomaly
  maxBatch: 512
  trainEveryBatches: 1
  reconWeight: 1.0
- kind: io.l5d.zipkin
  host: 127.0.0.1
  port: {zipkin_port}
  sampleRate: 1.0
  batchIntervalMs: 200
namers:
- kind: io.l5d.k8s
  host: 127.0.0.1
  port: {k8s_port}
"""

DTAB = "/svc => /#/io.l5d.k8s/default/http ;"


def body_of(svc: str) -> bytes:
    """What every pod of ``svc`` answers."""
    return svc.encode() * 20


class FakeK8s:
    """Endpoints + ConfigMap API with a scriptable watch stream (the
    benchmark's). ``dtab`` is the ConfigMap's dtab; ``set_dtab`` changes
    it and sends the change to every ConfigMap watch."""

    def __init__(self, pods, dtab: str = DTAB):
        # pods: svc -> list[(ip, port)]
        self.pods = pods
        self.version = 100
        self.queues: Dict[str, List[asyncio.Queue]] = {}  # svc -> queues
        self.dtab = dtab
        self.cm_version = 1
        self.cm_queues: List[asyncio.Queue] = []

    def _endpoints(self, svc):
        # one subset per pod: local pods listen on distinct ports, and
        # k8s pairs addresses x ports within a subset
        return {
            "kind": "Endpoints",
            "metadata": {"name": svc, "namespace": "default",
                         "resourceVersion": str(self.version)},
            "subsets": [{
                "addresses": [{"ip": ip}],
                "ports": [{"name": "http", "port": port}],
            } for ip, port in self.pods[svc]],
        }

    def _configmap(self):
        return {"kind": "ConfigMap",
                "metadata": {"name": "l5d-dtab", "namespace": "default",
                             "resourceVersion": str(self.cm_version)},
                "data": {"dtab": self.dtab}}

    def push(self, svc):
        self.version += 1
        evt = {"type": "MODIFIED", "object": self._endpoints(svc)}
        for q in self.queues.get(svc, []):
            q.put_nowait(evt)

    def set_dtab(self, dtab: str) -> None:
        self.dtab = dtab
        self.cm_version += 1
        evt = {"type": "MODIFIED", "object": self._configmap()}
        for q in self.cm_queues:
            q.put_nowait(evt)

    def close_watches(self) -> None:
        """End every open watch stream."""
        for q in [*self.cm_queues,
                  *(q for qs in self.queues.values() for q in qs)]:
            q.put_nowait(None)

    @staticmethod
    def _stream(queues: list, q: asyncio.Queue):
        async def gen():
            try:
                while True:
                    evt = await q.get()
                    if evt is None:
                        return
                    yield (json.dumps(evt) + "\n").encode()
            finally:
                if q in queues:
                    queues.remove(q)
        return gen()

    def service(self):
        from linkerd_tpu_torch.protocol.http.message import Request, Response
        from linkerd_tpu_torch.router.service import FnService

        async def handler(req: Request) -> Response:
            uri = req.uri
            if "/configmaps/l5d-dtab" in uri:
                if "watch=true" in uri:
                    q: asyncio.Queue = asyncio.Queue()
                    self.cm_queues.append(q)
                    return Response(status=200, body_stream=self._stream(
                        self.cm_queues, q))
                return Response(status=200, body=json.dumps(
                    self._configmap()).encode())
            if "/endpoints/" in uri and "watch=true" in uri:
                svc = uri.split("?")[0].rsplit("/", 1)[1]
                q = asyncio.Queue()
                queues = self.queues.setdefault(svc, [])
                queues.append(q)
                return Response(status=200, body_stream=self._stream(
                    queues, q))
            if "/endpoints/" in uri:
                svc = uri.split("?")[0].rsplit("/", 1)[1]
                if svc in self.pods:
                    return Response(status=200, body=json.dumps(
                        self._endpoints(svc)).encode())
                return Response(status=404, body=json.dumps(
                    {"kind": "Status", "code": 404}).encode())
            if "/endpoints" in uri:
                return Response(status=200, body=json.dumps({
                    "kind": "EndpointsList",
                    "metadata": {"resourceVersion": str(self.version)},
                    "items": [self._endpoints(s) for s in self.pods],
                }).encode())
            return Response(status=404, body=json.dumps(
                {"kind": "Status", "code": 404}).encode())
        return FnService(handler)


class Binding:
    """What the router's interpreter binds ``/svc/<svc>`` to, read as the
    ports of its one bound leaf (``ports``); the activity is held for
    the topology's life."""

    def __init__(self, router, svc: str):
        from linkerd_tpu_torch.core import Dtab, Path

        self.act = router.interpreter.bind(Dtab.empty(),
                                           Path.read(f"/svc/{svc}"))

    def ports(self) -> Optional[frozenset]:
        """None until the binding is a leaf with bound addresses."""
        from linkerd_tpu_torch.core.activity import Ok
        from linkerd_tpu_torch.core.addr import Bound
        from linkerd_tpu_torch.core.nametree import Leaf

        state = self.act.current
        if not isinstance(state, Ok) or not isinstance(state.value, Leaf):
            return None
        addr = state.value.value.addr.sample()
        if not isinstance(addr, Bound):
            return None
        return frozenset(a.port for a in addr.addresses)

    async def wait(self, want: frozenset, timeout: float = BINDING_S
                   ) -> float:
        """Seconds until the binding's ports are ``want``; raises
        AssertionError after ``timeout``."""
        t0 = time.monotonic()
        while self.ports() != want:
            if time.monotonic() - t0 > timeout:
                raise AssertionError(
                    f"config 4: the binding shows {self.ports()} after "
                    f"{timeout} s, not {sorted(want)}")
            await asyncio.sleep(1e-3)
        return time.monotonic() - t0


@dataclass
class Traffic:
    """How the schedule reaches the linker: ``send(host, n)`` sends ``n``
    requests with that Host in turn, ``restart(pod, down)`` takes pod
    ``pod`` of VICTIM out of its Endpoints (``down``) or puts it back,
    returning once the router's binding shows it, and ``set_fault``
    turns the survivor's latency and the window's labels on and off."""

    send: Callable[[str, int], Awaitable[Any]]
    restart: Callable[[int, bool], Awaitable[Any]]
    set_fault: Callable[[bool], None]


async def drain(tele) -> int:
    """``drain_once`` until the ring is empty; rows scored."""
    total = 0
    while tele.ring:
        total += await tele.drain_once()
    return total


async def drive(linker, traffic: Traffic, n_requests: int) -> dict:
    """Config 4's traffic and drains on a started ``linker`` of
    ``CONFIG``: the size of phase A's ring copy and the restart windows'
    ring items."""
    tele = linker.telemeters[0]
    send = traffic.send

    async def sweep(n_per_svc: int) -> None:
        # round-robin, one request at a time: the event loop must not
        # queue-inflate normal latencies, or the subtle signal drowns
        for _ in range(n_per_svc):
            for i in range(N_SVCS):
                await send(f"svc-{i}", 1)

    # Phase A: steady traffic over all ten services; train on it.
    await sweep(max(10, n_requests // N_SVCS))
    ring_copy = list(tele.ring)
    for _ in range(EPOCHS):
        await drain(tele)
        for item in ring_copy:
            tele.ring.append(item)
    await drain(tele)

    # Phase B: rolling restart of VICTIM with subtle latency windows.
    for w in range(WINDOWS):
        # pod w % 2 restarts: it leaves the Endpoints, the survivor
        # degrades
        await traffic.restart(w % 2, True)
        traffic.set_fault(True)
        await send(VICTIM, n_requests // (2 * WINDOWS))
        await sweep(n_requests // (8 * N_SVCS))
        await traffic.restart(w % 2, False)
        traffic.set_fault(False)
        await send(VICTIM, n_requests // (2 * WINDOWS))
        await sweep(n_requests // (8 * N_SVCS))

    tele.cfg.trainEveryBatches = 0  # score-only
    items = list(tele.ring)
    await drain(tele)
    return {"ring_copy": len(ring_copy), "items": items}


async def evaluate(tele, items) -> dict:
    """The windows' labeled rows scored by the telemeter's scorer in one
    call, and their AUC."""
    from linkerd_tpu_torch.models.features import featurize_batch
    from linkerd_tpu_torch.testing.faults import auc

    # ring items are (fv, label, trace, enqueued_at, endpoint); index
    # instead of unpacking, as external producers may append 2-tuples
    fvs = [it[0] for it in items]
    labels = [it[1] for it in items]
    x = featurize_batch(fvs)
    scores = await tele._ensure_scorer().score(x)
    pairs = [(lab, s) for lab, s in zip(labels, scores) if lab is not None]
    return {"fault_auc_subtle_k8s": auc([lab for lab, _ in pairs],
                                        [float(s) for _, s in pairs]),
            "labeled_n": len(pairs),
            "anomalous_n": sum(1 for lab, _ in pairs if lab > 0.5)}


async def run_schedule(linker, traffic: Traffic, n_requests: int) -> dict:
    """Config 4's schedule on a started ``linker`` of ``CONFIG``; returns
    the benchmark's numbers, unrounded."""
    out = await drive(linker, traffic, n_requests)
    items = out.pop("items")
    out.update(await evaluate(linker.telemeters[0], items))
    out.update(config=4, restart_windows=WINDOWS, window_rows=len(items))
    return out


class Topology:
    """The benchmark's topology in this process: ten services of two
    pods (VICTIM's behind a FaultInjector and a WindowLabeler), the fake
    API server, a zipkin collector, a linker of ``CONFIG`` whose
    telemeters run on ``device`` and one client.

    Each pod counts what it serves (``served``); a pod that the router's
    binding shows gone is ``down`` until it is put back, and what it
    serves meanwhile counts in ``strays``. ``answers`` counts the
    replies by whether they came from the service asked
    (``"right"``, ``"wrong"``, ``"failed"``); ``spans`` holds what the
    collector received."""

    def __init__(self, device=None):
        self.device = device
        self.spans: List[dict] = []
        self.served: Dict[Tuple[str, int], int] = {}
        self.down: set = set()
        self.strays = 0
        self.answers = {"right": 0, "wrong": 0, "failed": 0}
        self.binding_s: List[float] = []
        self._closers: List[Callable[[], Awaitable[Any]]] = []

    async def start(self) -> "Topology":
        from linkerd_tpu_torch.linker import load_linker
        from linkerd_tpu_torch.protocol.http import Request, Response
        from linkerd_tpu_torch.protocol.http.client import HttpClient
        from linkerd_tpu_torch.protocol.http.server import HttpServer, serve
        from linkerd_tpu_torch.router.service import FnService
        from linkerd_tpu_torch.testing.faults import (
            FaultInjector, FaultSpec, WindowLabeler,
        )

        async def zipkin_handler(req: Request) -> Response:
            try:
                self.spans.extend(json.loads(req.body))
            except Exception:  # noqa: BLE001 — a malformed post
                pass
            return Response(status=202)

        zipkin = await serve(FnService(zipkin_handler))
        self._closers.append(zipkin.close)
        # latency alone, overlapping the baseline: +4-16 ms, no error
        self.injector = FaultInjector(FaultSpec(
            error_rate=0.0, latency_ms=4.0, latency_jitter_ms=12.0))
        self.labeler = WindowLabeler()

        pods: Dict[str, list] = {}
        for i in range(N_SVCS):
            svc = f"svc-{i}"
            pods[svc] = []
            for p in range(PODS):
                async def handler(req: Request, _svc=svc, _p=p) -> Response:
                    self.served[(_svc, _p)] = \
                        self.served.get((_svc, _p), 0) + 1
                    if (_svc, _p) in self.down:
                        self.strays += 1
                    await asyncio.sleep(0.001)
                    return Response(200, body=body_of(_svc))
                base = FnService(handler)
                if svc == VICTIM:
                    base = self.labeler.and_then(self.injector.and_then(base))
                server = await serve(base)
                self._closers.append(server.close)
                pods[svc].append(("127.0.0.1", server.bound_port))
        self.all_pods = {s: list(p) for s, p in pods.items()}

        self.fake = FakeK8s(pods)
        k8s_srv = await HttpServer(self.fake.service()).start()
        # the held-open watches end before the server closes
        self._closers.append(k8s_srv.close)
        self._closers.append(self._end_watches)

        self.linker = load_linker(CONFIG.format(
            k8s_port=k8s_srv.bound_port, zipkin_port=zipkin.bound_port),
            device=self.device)
        await self.linker.start()
        self._closers.append(self.linker.close)
        # the zipkin telemeter's batch loop runs from __main__ in a
        # deployment; here it runs beside the schedule (the anomaly
        # telemeter's drains stay in the schedule's hands)
        self._zipkin_task = asyncio.get_running_loop().create_task(
            self.linker.telemeters[1].run())
        self.proxy = HttpClient("127.0.0.1",
                                self.linker.routers[0].server_ports[0])
        self._closers.append(self.proxy.close)
        self.victim_binding = Binding(self.linker.routers[0], VICTIM)
        return self

    async def _end_watches(self) -> None:
        self.fake.close_watches()
        await asyncio.sleep(0)

    async def close(self) -> None:
        self._zipkin_task.cancel()
        for close in reversed(self._closers):
            await close()

    async def __aenter__(self) -> "Topology":
        return await self.start()

    async def __aexit__(self, *exc) -> None:
        await self.close()

    async def send(self, svc: str, n: int) -> None:
        from linkerd_tpu_torch.protocol.http import Request

        for _ in range(n):
            req = Request(method="GET", uri="/api")
            req.headers.set("Host", svc)
            try:
                rsp = await self.proxy(req)
            except Exception:  # noqa: BLE001 — counted, as the rows are
                self.answers["failed"] += 1
                continue
            self.answers["right" if rsp.status == 200 and
                         rsp.body == body_of(svc) else "wrong"] += 1

    def pod_ports(self, svc: str) -> frozenset:
        return frozenset(port for _, port in self.fake.pods[svc])

    async def restart(self, pod: int, down: bool) -> None:
        pods = self.fake.pods[VICTIM]
        if down:
            pods.remove(self.all_pods[VICTIM][pod])
        else:
            self.down.discard((VICTIM, pod))
            pods.insert(pod, self.all_pods[VICTIM][pod])
        self.fake.push(VICTIM)
        self.binding_s.append(
            await self.victim_binding.wait(self.pod_ports(VICTIM)))
        if down:
            self.down.add((VICTIM, pod))

    def set_fault(self, on: bool) -> None:
        self.injector.active = on
        self.labeler.active = on

    def traffic(self) -> Traffic:
        return Traffic(self.send, self.restart, self.set_fault)

    async def wait_spans(self, n: int, timeout: float = 10.0) -> float:
        """Seconds until the collector holds at least ``n`` spans, or
        ``timeout``."""
        t0 = time.monotonic()
        while len(self.spans) < n and time.monotonic() - t0 < timeout:
            await asyncio.sleep(0.05)
        return time.monotonic() - t0


async def bench(n_requests: int, device=None) -> dict:
    """The benchmark's schedule on ``Topology``; the telemeter's scorer on
    ``device``."""
    async with Topology(device) as top:
        out = await run_schedule(top.linker, top.traffic(), n_requests)
        await asyncio.sleep(0.5)  # let the final span batch flush
        snap = top.linker.metrics.flatten()
        out.update(zipkin_spans=len(top.spans),
                   requests=snap.get("rt/k8s/server/requests"),
                   answers=dict(top.answers), strays=top.strays,
                   binding_ms=[s * 1e3 for s in top.binding_s])
    return out


def main() -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=600)
    ap.add_argument("--device", default=None,
                    help="the telemeter's device (default: CUDA)")
    args = ap.parse_args()
    result = asyncio.run(bench(args.requests, device=args.device))
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
