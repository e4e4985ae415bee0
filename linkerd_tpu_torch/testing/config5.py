"""BASELINE config 5 on the port: istio mixer reporting over a
50-service, three-tier replay through two routers, with a latency-only
cascade and partial errors, scored by the io.l5d.jaxAnomaly telemeter.

The config and schedule of ``benchmarks/config5_istio.py``, importing
only the port. Frontends ``svc-0..19`` call their mid
``svc-(20 + i % 20)`` through the ``back`` router, mids their db
``svc-(40 + j % 10)``; both routers carry the io.l5d.istio telemeter,
which reports every response to a fake mixer served by the port's gRPC
runtime. ``drive`` takes a started linker of ``CONFIG`` through a
``Traffic``: phase A of zipf-skewed replay over the frontends
(``random.Random(7)``, exponent 0.9), six retrain epochs on the ring's
copy, then four alternating windows (even: db ``svc-45`` answers 4-16 ms
late, and ``svc-25`` and ``svc-5`` inherit it through the chain, all
three labeled; odd: db ``svc-47`` answers 503 to 15% of requests, which
its mids turn into 502 with the label carried up), each followed by a
calm stretch, then score-only; ``evaluate`` takes the AUC of every
labeled row (``fault_auc_subtle_istio``) and of those without a 5xx
(``fault_auc_latency_only``).

Where the benchmark calls ``drain_once`` once, the schedule drains the
ring empty (``drain``), so that a run of any size leaves no row
unscored. Requests stay sequential, as the benchmark keeps them: the
backends call back into the ``back`` router on the same loop.

    python -m linkerd_tpu_torch.testing.config5 [--requests 500]
        [--device cpu]
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import random
import tempfile
import time
from dataclasses import dataclass
from typing import Any, Awaitable, Callable, Dict, List, Tuple

N_FRONT, N_MID, N_DB = 20, 20, 10
EPOCHS = 6       # retrain epochs on phase A's ring copy
WINDOWS = 4      # alternating fault windows
CASCADE = "svc-45"   # latency-only; svc-25 and svc-5 inherit it
ERRORS = "svc-47"    # 15% 503s
ZIPF_SEED, ZIPF_EXPONENT = 7, 0.9

CONFIG = """
routers:
- protocol: http
  label: front
  dtab: |
    /svc => /#/io.l5d.fs ;
  servers: [{{port: 0}}]
  client:
    failureAccrual: {{kind: none}}
- protocol: http
  label: back
  dtab: |
    /svc => /#/io.l5d.fs ;
  servers: [{{port: 0}}]
  client:
    failureAccrual: {{kind: none}}
telemetry:
- kind: io.l5d.jaxAnomaly
  maxBatch: 1024
  trainEveryBatches: 1
  reconWeight: 1.0
- kind: io.l5d.istio
  experimental: true
  mixerHost: 127.0.0.1
  mixerPort: {mixer_port}
namers:
- kind: io.l5d.fs
  rootDir: {disco}
"""


def mid_of(i: int) -> int:
    return N_FRONT + (i % N_MID)


def db_of(j: int) -> int:
    return N_FRONT + N_MID + (j % N_DB)


async def start_fake_mixer():
    """A mixer serving bidi Report over the port's gRPC runtime; returns
    the server and the list its reports land in."""
    from linkerd_tpu_torch.grpc import ServerDispatcher
    from linkerd_tpu_torch.istio import mixer_pb as pb
    from linkerd_tpu_torch.protocol.h2.server import H2Server

    reports: list = []
    disp = ServerDispatcher()

    async def report(reqs):
        async def gen():
            async for r in reqs:
                reports.append(r)
                yield pb.ReportResponse(request_index=r.request_index)
        return gen()

    disp.register(pb.MIXER_SVC, "Report", report)
    server = await H2Server(disp).start()
    return server, reports


@dataclass
class Traffic:
    """How the schedule reaches the linker: ``send(frontend, n)`` sends
    ``n`` requests to ``svc-<frontend>`` through the ``front`` router in
    turn, and ``set_fault(kind, on)`` switches the ``"cascade"`` or the
    ``"errors"`` window."""

    send: Callable[[int, int], Awaitable[Any]]
    set_fault: Callable[[str, bool], None]


async def drain(tele) -> int:
    """``drain_once`` until the ring is empty; rows scored."""
    total = 0
    while tele.ring:
        total += await tele.drain_once()
    return total


async def drive(linker, traffic: Traffic, n_requests: int) -> dict:
    """Config 5's traffic and drains on a started ``linker`` of
    ``CONFIG``: the size of phase A's ring copy and the windows' ring
    items."""
    tele = linker.telemeters[0]
    send = traffic.send
    # zipf-skewed replay over frontends (hot head, long tail)
    rng = random.Random(ZIPF_SEED)
    weights = [1.0 / (r + 1) ** ZIPF_EXPONENT for r in range(N_FRONT)]

    async def replay(n: int) -> None:
        for _ in range(n):
            await send(rng.choices(range(N_FRONT), weights=weights)[0], 1)

    # Phase A: normal replay; train on it.
    await replay(n_requests)
    ring_copy = list(tele.ring)
    for _ in range(EPOCHS):
        await drain(tele)
        for item in ring_copy:
            tele.ring.append(item)
    await drain(tele)

    # Phase B: alternating fault windows.
    per = max(20, n_requests // (2 * WINDOWS))

    async def mixed_load(per_chain: int) -> None:
        # interleaved in turn: a backlog on the loop must not inflate
        # normal latencies (harness noise, not mesh signal)
        for _ in range(per_chain):
            await send(5, 1)
            await send(7, 1)
            await replay(1)

    for w in range(WINDOWS):
        kind = "cascade" if w % 2 == 0 else "errors"
        traffic.set_fault(kind, True)
        await mixed_load(per)
        traffic.set_fault(kind, False)
        await mixed_load(per // 2)

    tele.cfg.trainEveryBatches = 0  # score-only
    items = list(tele.ring)
    await drain(tele)
    return {"ring_copy": len(ring_copy), "items": items}


async def evaluate(tele, items) -> dict:
    """The windows' labeled rows scored by the telemeter's scorer in one
    call: their AUC, and that of the rows without a 5xx."""
    from linkerd_tpu_torch.models.features import featurize_batch
    from linkerd_tpu_torch.testing.faults import auc

    # ring items are (fv, label, trace, enqueued_at, endpoint); index
    # instead of unpacking, as external producers may append 2-tuples
    fvs = [it[0] for it in items]
    labels = [it[1] for it in items]
    x = featurize_batch(fvs)
    scores = await tele._ensure_scorer().score(x)
    pairs = [(lab, float(s), fv.status)
             for lab, s, fv in zip(labels, scores, fvs) if lab is not None]
    lat = [(lab, s) for lab, s, st in pairs if st < 500]
    return {"fault_auc_subtle_istio": auc([p[0] for p in pairs],
                                          [p[1] for p in pairs]),
            "fault_auc_latency_only": auc([p[0] for p in lat],
                                          [p[1] for p in lat]),
            "labeled_n": len(pairs),
            "anomalous_n": sum(1 for p in pairs if p[0] > 0.5)}


async def run_schedule(linker, traffic: Traffic, n_requests: int) -> dict:
    """Config 5's schedule on a started ``linker`` of ``CONFIG``; returns
    the benchmark's numbers, unrounded."""
    out = await drive(linker, traffic, n_requests)
    items = out.pop("items")
    out.update(await evaluate(linker.telemeters[0], items))
    out.update(config=5, windows=WINDOWS, window_rows=len(items))
    return out


class Topology:
    """The benchmark's topology in this process: the fake mixer, the 50
    backends over an fs namer's directory, a linker of ``CONFIG`` whose
    telemeters run on ``device``, and one client a router.

    ``answers`` holds each front request's (frontend, status, window)
    in order, ``window`` being the fault window open when it was sent
    (``"cascade"``, ``"errors"`` or None); ``db_served`` counts what each
    db served."""

    def __init__(self, device=None):
        self.device = device
        self.answers: List[Tuple[int, int, Any]] = []
        self.db_served: Dict[int, int] = {}
        self.window = None
        self._closers: List[Callable[[], Awaitable[Any]]] = []

    async def start(self) -> "Topology":
        from linkerd_tpu_torch.linker import load_linker
        from linkerd_tpu_torch.protocol.http import Request, Response
        from linkerd_tpu_torch.protocol.http.client import HttpClient
        from linkerd_tpu_torch.protocol.http.server import serve
        from linkerd_tpu_torch.router.service import FnService
        from linkerd_tpu_torch.testing.faults import (
            FaultInjector, FaultSpec, WindowLabeler,
        )

        tmp = tempfile.TemporaryDirectory(prefix="l5d-config5-")
        self._closers.append(self._cleanup(tmp))
        disco = os.path.join(tmp.name, "disco")
        os.makedirs(disco)
        self.mixer, self.reports = await start_fake_mixer()
        self._closers.append(self.mixer.close)
        self.linker = load_linker(CONFIG.format(
            disco=disco, mixer_port=self.mixer.bound_port),
            device=self.device)

        # cascade source: latency-only on the db CASCADE
        self.lat_injector = FaultInjector(FaultSpec(
            error_rate=0.0, latency_ms=4.0, latency_jitter_ms=12.0))
        # partial errors: 15% 503s on the db ERRORS
        self.err_injector = FaultInjector(FaultSpec(
            error_rate=0.15, error_status=503))
        self.cascade_labeler = WindowLabeler()
        label = FaultInjector.LABEL_HEADER
        cascade, errors = (int(s.split("-")[1]) for s in (CASCADE, ERRORS))
        chained = {int(s.split("-")[1]) for s in ("svc-5", "svc-25")}

        async def call_via_mesh(svc: str) -> Response:
            req = Request(method="GET", uri="/dep")
            req.headers.set("Host", svc)
            return await self.back_proxy(req)

        def mk_backend(idx: int):
            if idx >= N_FRONT + N_MID:  # db tier: leaf
                async def db_handler(req: Request, _i=idx) -> Response:
                    self.db_served[_i] = self.db_served.get(_i, 0) + 1
                    await asyncio.sleep(0.001)
                    return Response(200, body=b"db" * 30)
                svc: Any = FnService(db_handler)
                if idx == cascade:
                    svc = self.cascade_labeler.and_then(
                        self.lat_injector.and_then(svc))
                elif idx == errors:
                    svc = self.err_injector.and_then(svc)
                return svc

            # frontend or mid: call the next tier through the mesh
            dep = (f"svc-{mid_of(idx)}" if idx < N_FRONT
                   else f"svc-{db_of(idx)}")

            async def chain_handler(req: Request, _dep=dep) -> Response:
                try:
                    sub = await call_via_mesh(_dep)
                except Exception:  # noqa: BLE001 — downstream unreachable
                    return Response(502, body=b"chain failed")
                rsp = (Response(200, body=b"ok" * 20) if sub.status < 500
                       else Response(502, body=b"dep failed"))
                # the fault label travels up the chain, so partially
                # failed and cascade-inflated requests stay labeled
                sub_label = sub.headers.get(label)
                if sub_label is not None:
                    rsp.headers.set(label, sub_label)
                return rsp

            svc = FnService(chain_handler)
            if idx in chained:  # cascade chain members inherit the label
                svc = self.cascade_labeler.and_then(svc)
            return svc

        for i in range(N_FRONT + N_MID + N_DB):
            server = await serve(mk_backend(i))
            self._closers.append(server.close)
            with open(os.path.join(disco, f"svc-{i}"), "w") as f:
                f.write(f"127.0.0.1 {server.bound_port}\n")

        await self.linker.start()
        self._closers.append(self.linker.close)
        self.front_proxy = HttpClient(
            "127.0.0.1", self.linker.routers[0].server_ports[0])
        self.back_proxy = HttpClient(
            "127.0.0.1", self.linker.routers[1].server_ports[0])
        self._closers += [self.front_proxy.close, self.back_proxy.close]
        return self

    @staticmethod
    def _cleanup(tmp):
        async def cleanup():
            tmp.cleanup()
        return cleanup

    async def close(self) -> None:
        for close in reversed(self._closers):
            await close()

    async def __aenter__(self) -> "Topology":
        return await self.start()

    async def __aexit__(self, *exc) -> None:
        await self.close()

    async def send(self, frontend: int, n: int) -> None:
        from linkerd_tpu_torch.protocol.http import Request

        for _ in range(n):
            req = Request(method="GET", uri="/api")
            req.headers.set("Host", f"svc-{frontend}")
            try:
                status = (await self.front_proxy(req)).status
            except Exception:  # noqa: BLE001 — kept as status 0
                status = 0
            self.answers.append((frontend, status, self.window))

    def set_fault(self, kind: str, on: bool) -> None:
        self.window = kind if on else None
        if kind == "cascade":
            self.lat_injector.active = on
            self.cascade_labeler.active = on
        else:
            self.err_injector.active = on

    def traffic(self) -> Traffic:
        return Traffic(self.send, self.set_fault)

    def served(self) -> Tuple[int, ...]:
        """The front and back routers' server requests (their counters,
        read without walking the metrics tree)."""
        return tuple(self.linker.metrics.counter(
            "rt", r.label, "server", "requests").value
            for r in self.linker.routers)

    async def wait_reports(self, timeout: float = 10.0) -> float:
        """Seconds until the mixer holds a report for every request the
        two routers served, or ``timeout``."""
        t0 = time.monotonic()
        while len(self.reports) < sum(self.served()) and \
                time.monotonic() - t0 < timeout:
            await asyncio.sleep(0.05)
        return time.monotonic() - t0


async def bench(n_requests: int, device=None) -> dict:
    """The benchmark's schedule on ``Topology``; the telemeter's scorer on
    ``device``."""
    async with Topology(device) as top:
        out = await run_schedule(top.linker, top.traffic(), n_requests)
        # give the mixer queue a beat to drain
        await asyncio.sleep(0.5)
        snap = top.linker.metrics.flatten()
        out.update(mixer_reports=len(top.reports),
                   front_requests=snap.get("rt/front/server/requests"),
                   back_requests=snap.get("rt/back/server/requests"),
                   injected_503=top.err_injector.injected,
                   front_502=sum(s == 502 for _, s, _ in top.answers))
    return out


def main() -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=500)
    ap.add_argument("--device", default=None,
                    help="the telemeter's device (default: CUDA)")
    args = ap.parse_args()
    result = asyncio.run(bench(args.requests, device=args.device))
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
