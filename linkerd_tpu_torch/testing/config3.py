"""BASELINE config 3 on the port: mixed http + thriftmux routers, three
downstreams, injected 5xx and latency spikes, and the labeled anomaly
traces they leave scored by the io.l5d.jaxAnomaly telemeter.

The config and schedule of ``benchmarks/config3_faults.py``, importing
only the port. ``drive`` takes a started linker of ``CONFIG`` through a
``Traffic`` (how requests reach its two routers and how the fault on
``svc-a`` is switched): phase A of normal mixed traffic, six retrain
epochs on the ring's copy, four alternating fault bursts on ``svc-a``
with ``svc-b`` and the thriftmux router calm, then score-only;
``evaluate`` scores the fault window's rows and takes their AUC, and
``run_schedule`` does both.
Where the benchmark calls ``drain_once`` once, the schedule drains the
ring empty (``drain``): one call does that at the benchmark's default
120 requests, and larger runs leave no row unscored. ``bench`` is the
benchmark's own topology: in-process backends and one client a router.

Only http traffic is scored: the thriftmux router carries no
FeatureRecorder, as the reference's, so the AUC is over the http rows.

    python -m linkerd_tpu_torch.testing.config3 [--requests 120]
        [--device cpu]
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import struct
import tempfile
from dataclasses import dataclass
from typing import Any, Awaitable, Callable

CONFIG = """
routers:
- protocol: http
  label: web
  dtab: |
    /svc => /#/io.l5d.fs ;
  servers: [{{port: 0}}]
  client:
    failureAccrual: {{kind: none}}
- protocol: thriftmux
  label: tmx
  dtab: |
    /svc => /#/io.l5d.fs ;
  servers: [{{port: 0}}]
telemetry:
- kind: io.l5d.jaxAnomaly
  maxBatch: 512
  trainEveryBatches: 1
  reconWeight: 1.0
namers:
- kind: io.l5d.fs
  rootDir: {disco}
"""

EPOCHS = 6   # retrain epochs on phase A's ring copy
BURSTS = 4   # fault bursts on svc-a
FAULTED = "/svc/svc-a"


def mk_message(name: str, seqid: int, mtype: int) -> bytes:
    """A strict TBinaryProtocol message with an empty struct."""
    from linkerd_tpu_torch.protocol.thrift.codec import VERSION_1

    nb = name.encode()
    return (struct.pack(">I", (VERSION_1 | mtype) & 0xFFFFFFFF)
            + struct.pack(">I", len(nb)) + nb
            + struct.pack(">i", seqid) + b"\x00")


def mk_call(name: str, seqid: int) -> bytes:
    from linkerd_tpu_torch.protocol.thrift.codec import CALL

    return mk_message(name, seqid, CALL)


async def mux_echo(td) -> bytes:
    """The thriftmux downstream: a REPLY of the call's method and seqid."""
    from linkerd_tpu_torch.protocol.thrift.codec import (
        REPLY, parse_message_header,
    )

    name, seqid, _ = parse_message_header(td.payload)
    return mk_message(name, seqid, REPLY)


@dataclass
class Traffic:
    """How the schedule reaches the linker: ``send_http(host, n)`` sends
    ``n`` requests with that Host to the http router, ``send_tmx(n)`` n
    calls of ``ping`` to the thriftmux router, and ``set_fault`` turns
    svc-a's injected faults on and off."""

    send_http: Callable[[str, int], Awaitable[Any]]
    send_tmx: Callable[[int], Awaitable[Any]]
    set_fault: Callable[[bool], None]


async def drain(tele) -> int:
    """``drain_once`` until the ring is empty; rows scored."""
    total = 0
    while tele.ring:
        total += await tele.drain_once()
    return total


async def drive(linker, traffic: Traffic, n_requests: int) -> dict:
    """Config 3's traffic and drains on a started ``linker`` of
    ``CONFIG``: the board's score of svc-a after the normal phase and
    after the faults, and the fault window's ring items."""
    tele = linker.telemeters[0]
    send_http, send_tmx = traffic.send_http, traffic.send_tmx

    # Phase A: normal mixed traffic; train on it.
    await asyncio.gather(send_http("svc-a", n_requests),
                         send_http("svc-b", n_requests),
                         send_tmx(n_requests))
    ring_copy = list(tele.ring)  # snapshot once: each epoch re-trains
    for _ in range(EPOCHS):      # on the same normal-traffic batch
        await drain(tele)
        for item in ring_copy:
            tele.ring.append(item)
        await drain(tele)
    baseline = tele.board.score_of(FAULTED)

    # Phase B: alternating fault bursts on svc-a; svc-b and tmx stay
    # healthy.
    for _ in range(BURSTS):
        traffic.set_fault(True)
        await asyncio.gather(send_http("svc-a", n_requests // 4),
                             send_tmx(n_requests // 8))
        traffic.set_fault(False)
        await asyncio.gather(send_http("svc-a", n_requests // 4),
                             send_http("svc-b", n_requests // 8))
    tele.cfg.trainEveryBatches = 0  # score-only
    items = list(tele.ring)
    await drain(tele)
    return {"score_baseline": float(baseline),
            "score_anomalous": float(tele.board.score_of(FAULTED)),
            "ring_copy": len(ring_copy), "items": items}


async def evaluate(tele, items) -> dict:
    """The fault window's labeled rows scored by the telemeter's scorer
    in one call, and their AUC."""
    from linkerd_tpu_torch.models.features import featurize_batch
    from linkerd_tpu_torch.testing.faults import auc

    # ring items are (fv, label, trace, enqueued_at, endpoint); index
    # instead of unpacking, as external producers may append 2-tuples
    fvs = [it[0] for it in items]
    labels = [it[1] for it in items]
    x = featurize_batch(fvs)
    scores = await tele._ensure_scorer().score(x)
    pairs = [(lab, s) for lab, s in zip(labels, scores) if lab is not None]
    return {"fault_auc": auc([lab for lab, _ in pairs],
                             [float(s) for _, s in pairs]),
            "labeled_n": len(pairs)}


async def run_schedule(linker, traffic: Traffic, n_requests: int) -> dict:
    """Config 3's schedule on a started ``linker`` of ``CONFIG``; returns
    the benchmark's numbers, unrounded."""
    out = await drive(linker, traffic, n_requests)
    items = out.pop("items")
    out.update(await evaluate(linker.telemeters[0], items))
    out.update(config=3, window_rows=len(items))
    return out


async def bench(n_requests: int, device=None) -> dict:
    """The benchmark's topology: two http downstreams (svc-a behind a
    FaultInjector), one thriftmux echo, all in this process, and one
    client a router sending in turn; the telemeter's scorer on
    ``device``."""
    from linkerd_tpu_torch.linker import load_linker
    from linkerd_tpu_torch.protocol.http import Request, Response
    from linkerd_tpu_torch.protocol.http.client import HttpClient
    from linkerd_tpu_torch.protocol.http.server import serve
    from linkerd_tpu_torch.protocol.mux.client import MuxClient
    from linkerd_tpu_torch.protocol.mux.codec import Tdispatch
    from linkerd_tpu_torch.protocol.mux.server import MuxServer
    from linkerd_tpu_torch.protocol.thrift.codec import parse_message_header
    from linkerd_tpu_torch.router.service import FnService
    from linkerd_tpu_torch.testing.faults import FaultInjector, FaultSpec

    tmp = tempfile.TemporaryDirectory(prefix="l5d-config3-")
    disco = os.path.join(tmp.name, "disco")
    os.makedirs(disco)
    injector = FaultInjector(FaultSpec(error_rate=0.9, latency_ms=40.0))

    async def backend_a(req: Request) -> Response:
        return Response(200, body=b"a" * 200)

    async def backend_b(req: Request) -> Response:
        return Response(200, body=b"b" * 120)

    d_a = await serve(injector.and_then(FnService(backend_a)))
    d_b = await serve(FnService(backend_b))
    d_m = await MuxServer(FnService(mux_echo)).start()
    for name, port in (("svc-a", d_a.bound_port), ("svc-b", d_b.bound_port),
                       ("thriftmux", d_m.bound_port)):
        with open(os.path.join(disco, name), "w") as f:
            f.write(f"127.0.0.1 {port}\n")

    linker = load_linker(CONFIG.format(disco=disco), device=device)
    await linker.start()
    proxy = HttpClient("127.0.0.1", linker.routers[0].server_ports[0])
    mux = MuxClient("127.0.0.1", linker.routers[1].server_ports[0])

    async def send_http(host: str, n: int) -> None:
        for _ in range(n):
            req = Request(method="GET", uri="/")
            req.headers.set("Host", host)
            await proxy(req)

    async def send_tmx(n: int) -> None:
        for i in range(n):
            rsp = await mux(Tdispatch(0, [], "", [], mk_call("ping", i)))
            parse_message_header(rsp)

    def set_fault(on: bool) -> None:
        injector.active = on

    try:
        out = await run_schedule(
            linker, Traffic(send_http, send_tmx, set_fault), n_requests)
        snap = linker.metrics.flatten()
        out["http_requests"] = snap.get("rt/web/server/requests")
        out["tmx_requests"] = snap.get("rt/tmx/server/requests")
    finally:
        await proxy.close()
        await mux.close()
        await linker.close()
        await d_a.close()
        await d_b.close()
        await d_m.close()
        tmp.cleanup()
    return out


def main() -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=120)
    ap.add_argument("--device", default=None,
                    help="the telemeter's device (default: CUDA)")
    args = ap.parse_args()
    result = asyncio.run(bench(args.requests, device=args.device))
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
