"""The slice as a whole on the CPU: one http router of each package on
the same YAML — tenant isolation, a file request logger, the access log,
an fs namer behind ``io.l5d.specificHost`` and ``io.l5d.jaxAnomaly`` —
driven by the same seeded requests, with both telemeters' scorers
restored from one snapshot.

Each package's telemeter module reads a scripted clock that the
backends move by a seeded latency, so the rows are the same in both.
Bounds: every score call's rows bit-equal; the port's scores within the
bf16 bounds in force (ROADMAP Queue 3) of the JAX package's fused
scorer (Pallas, interpreted, compiled with ``xla_allow_excess_precision``
off) under the same model: 1e-3 on every row and 1e-5 on all but 1%;
the answers, ``/tenants.json``, the log lines (apart from their times),
the client scopes (the transformed bound ids) and the score board equal.
"""

import asyncio
import json
import random
import re

import jax
import numpy as np
import pytest

import linkerd_tpu.admin.handlers as ref_handlers
import linkerd_tpu.linker as ref_linker
import linkerd_tpu.protocol.http as ref_http
import linkerd_tpu.protocol.http.client as ref_client
import linkerd_tpu.protocol.http.server as ref_server
import linkerd_tpu.router.service as ref_service
import linkerd_tpu_torch.admin.handlers as port_handlers
import linkerd_tpu_torch.linker as port_linker
import linkerd_tpu_torch.protocol.http as port_http
import linkerd_tpu_torch.protocol.http.client as port_client
import linkerd_tpu_torch.protocol.http.server as port_server
import linkerd_tpu_torch.router.service as port_service
from linkerd_tpu.telemetry import anomaly as ref
from linkerd_tpu_torch.telemetry import anomaly as port
from tests.test_torch_config3 import Clock, Recorder, to_port, to_ref
from tests.test_torch_linker import jax_scores

ROW_TOL, ROW_SHARE, TOL = 1e-5, 0.01, 1e-3   # bf16 score bounds
N = 192
DSTS = ("svc0", "svc1", "svc2", "svc3")   # svc3 answers 500 every other
TENANTS = ("t00", "t01", "t02", "t03")

CONFIG = """
routers:
- protocol: http
  label: edge
  dtab: |
    /svc => /#/io.l5d.fs ;
  admissionControl: {{maxConcurrency: 64}}
  tenantIdentifier: {{kind: header}}
  tenants: {{floor: 0.1, enterThreshold: 0.7, exitThreshold: 0.3,
            quorum: 3, cooldownS: 2}}
  loggers: [{{kind: io.l5d.http.file, path: {flog}}}]
  httpAccessLog: {alog}
  client: {{failureAccrual: {{kind: none}}}}
  servers: [{{port: 0}}]
namers:
- kind: io.l5d.fs
  rootDir: {disco}
  transformers: [{{kind: io.l5d.specificHost, host: 127.0.0.1}}]
telemetry:
- kind: io.l5d.jaxAnomaly
  trainEveryBatches: 0
  maxBatch: 48
"""

PKGS = {
    "ref": dict(linker=ref_linker, http=ref_http, client=ref_client,
                server=ref_server, service=ref_service,
                handlers=ref_handlers),
    "port": dict(linker=port_linker, http=port_http, client=port_client,
                 server=port_server, service=port_service,
                 handlers=port_handlers),
}


async def session(pkg: str, root, clock: Clock):
    m = PKGS[pkg]
    http = m["http"]
    rng = random.Random(3)
    hits = {d: 0 for d in DSTS}

    def replica(name):
        async def handle(req):
            clock.now += 1e-3 * (1.0 + rng.random())
            hits[name] += 1
            status = 500 if name == "svc3" and hits[name] % 2 else 200
            return http.Response(status=status, body=name.encode())
        return m["service"].FnService(handle)

    backends = [await m["server"].serve(replica(d)) for d in DSTS]
    disco = root / f"disco-{pkg}"
    disco.mkdir()
    for d, b in zip(DSTS, backends):
        # the dead 127.0.0.2 entry is the one the transformer drops
        (disco / d).write_text(f"127.0.0.2 {b.bound_port}\n"
                               f"127.0.0.1 {b.bound_port}\n")
    flog, alog = root / f"req-{pkg}.log", root / f"access-{pkg}.log"
    text = CONFIG.format(flog=flog, alog=alog, disco=disco)
    linker = (m["linker"].load_linker(text, device="cpu") if pkg == "port"
              else m["linker"].load_linker(text))
    tele = linker.telemeters[0]
    await linker.start()
    proxy = m["client"].HttpClient("127.0.0.1",
                                   linker.routers[0].server_ports[0])
    order = random.Random(5)
    answers = []
    try:
        for _ in range(N):
            req = http.Request(uri="/")
            dst = order.choice(DSTS)
            req.headers.set("Host", dst)
            req.headers.set("l5d-tenant", order.choice(TENANTS))
            rsp = await proxy(req)
            answers.append((dst, rsp.status, rsp.body))
        while tele.ring:
            await tele.drain_once()
        _, board, adm = linker.tenant_views[0]
        adm.step()
        rsp = await m["handlers"].mk_tenants_handler(linker)(
            http.Request(uri="/tenants.json"))
        tenants = json.loads(rsp.body)
        clients = sorted({k.split("/")[3] for k in linker.metrics.flatten()
                          if k.startswith("rt/edge/client/")})
        scores = {k: round(v, 6)
                  for k, v in tele.board.effective_scores().items()}
    finally:
        await proxy.close()
        await linker.close()
        for b in backends:
            await b.close()
    flines = [json.loads(ln) for ln in flog.read_text().splitlines()]
    for ln in flines:
        ln.pop("ts"), ln.pop("latency_ms")
    alines = [re.sub(r"\[[^\]]+\]", "[ts]", ln)
              for ln in alog.read_text().splitlines()]
    return dict(answers=answers, tenants=tenants, clients=clients,
                scores=scores, flines=flines, alines=alines)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("edge")
    with pytest.MonkeyPatch.context() as monkeypatch:
        clocks = Clock(), Clock()
        for mod, clock in ((ref, clocks[0]), (port, clocks[1])):
            monkeypatch.setattr(mod, "time", clock)
        rs = ref.InProcessScorer(devices=jax.devices()[:1], recon_weight=0.7)
        ps = port.InProcessScorer(device="cpu", recon_weight=0.7)
        ps.restore(to_port(rs.snapshot()))
        recs = {"port": Recorder(ps, lambda i: None),
                "ref": Recorder(rs, lambda i: None)}
        monkeypatch.setattr(ref.JaxAnomalyTelemeter, "_mk_inprocess",
                            lambda self: rs)
        monkeypatch.setattr(port.JaxAnomalyTelemeter, "_mk_inprocess",
                            lambda self: ps)

        async def both():
            return {"port": await session("port", root, clocks[1]),
                    "ref": await session("ref", root, clocks[0])}
        out = asyncio.run(asyncio.wait_for(both(), 120))
    return out, recs


def test_answers_logs_tenants_and_clients_alike(runs):
    out, _ = runs
    got, want = out["port"], out["ref"]
    for key in ("answers", "tenants", "clients", "flines", "alines"):
        assert got[key] == want[key], key
    # every request answered by the destination it named (svc3 fails
    # every other), through the transformed bound ids only
    assert all(body == dst.encode() for dst, _, body in got["answers"])
    assert got["clients"] == [f"%.io.l5d.specificHost.#.io.l5d.fs.{d}"
                              for d in DSTS]
    assert len(got["flines"]) == len(got["alines"]) == N
    edge = got["tenants"]["edge"]
    assert sorted(edge["tenants"]) == list(TENANTS)
    assert edge["quotas"]["sick"] == []


def test_rows_bit_equal_and_scores_within_bounds(runs):
    out, recs = runs
    p, r = recs["port"], recs["ref"]
    assert len(p.scored) == len(r.scored) >= N // 48
    assert sum(len(x) for x, _, _ in p.scored) == N
    gaps = []
    for (xp, sp, snap), (xr, _, _) in zip(p.scored, r.scored):
        assert np.array_equal(xp, xr)
        gaps.append(np.abs(sp - jax_scores(to_ref(snap), xp)))
    gap = np.concatenate(gaps)
    assert gap.max() <= TOL, gap.max()
    assert (gap > ROW_TOL).mean() <= ROW_SHARE
    # the boards fold the same scores (within the same bounds)
    got, want = out["port"]["scores"], out["ref"]["scores"]
    assert sorted(got) == sorted(want) == [f"/svc/{d}" for d in DSTS]
    assert max(abs(got[k] - want[k]) for k in got) <= TOL
