"""The slice as a whole on the CPU: one http router of each package on
the same YAML, with the five discovery namers (``io.l5d.consul``,
``io.l5d.marathon``, ``io.l5d.serversets``, ``io.l5d.zkLeader``,
``io.l5d.curator``) over one scripted consul, one scripted Marathon and
one ZooKeeper, and ``io.l5d.jaxAnomaly``, driven by the same seeded
requests with both telemeters' scorers restored from one snapshot.

Each package's telemeter module reads a scripted clock that the
backends move by a seeded latency, so the rows are the same in both.
Bounds: the answers and the bound ids (the client scopes) equal; every
score call's rows bit-equal; the port's scores within the bf16 bounds in
force (ROADMAP Queue 3) of the JAX package's fused scorer under the same
model: 1e-3 on every row and 1e-5 on all but 1%; the boards within 1e-3.

Also the linker's device order: a config whose telemeters take no
device loads with no device on a host without CUDA, and one with
``io.l5d.jaxAnomaly`` still raises there.
"""

import asyncio
import json
import random

import jax
import numpy as np
import pytest

import linkerd_tpu.linker as ref_linker
import linkerd_tpu.namer.zk as ref_zk
import linkerd_tpu.protocol.http as ref_http
import linkerd_tpu.protocol.http.client as ref_client
import linkerd_tpu.protocol.http.server as ref_server
import linkerd_tpu.router.service as ref_service
import linkerd_tpu_torch.linker as port_linker
import linkerd_tpu_torch.namer.zk as port_zk
import linkerd_tpu_torch.protocol.http as port_http
import linkerd_tpu_torch.protocol.http.client as port_client
import linkerd_tpu_torch.protocol.http.server as port_server
import linkerd_tpu_torch.router.service as port_service
from linkerd_tpu.telemetry import anomaly as ref
from linkerd_tpu_torch.telemetry import anomaly as port
from linkerd_tpu_torch.testing.discovery import FakeConsul, FakeMarathon
from linkerd_tpu_torch.testing.zkserver import FakeZkServer
from tests.test_torch_config3 import Clock, Recorder, to_port, to_ref
from tests.test_torch_linker import jax_scores

ROW_TOL, ROW_SHARE, TOL = 1e-5, 0.01, 1e-3   # bf16 score bounds
N = 160
REPLICAS = 2
# request paths: two consul services and one destination of each other namer
DSTS = ("/c/web0", "/c/web1", "/m/app0", "/s/users", "/l/jobs", "/k/api")

CONFIG = """
routers:
- protocol: http
  label: disco
  identifier: {{kind: io.l5d.path, segments: 2}}
  dtab: |
    /svc/c => /#/io.l5d.consul/dc1 ;
    /svc/m => /#/io.l5d.marathon ;
    /svc/s => /#/io.l5d.serversets/discovery ;
    /svc/l => /#/io.l5d.zkLeader/election ;
    /svc/k => /#/io.l5d.curator ;
  client: {{failureAccrual: {{kind: none}}}}
  servers: [{{port: 0}}]
namers:
- {{kind: io.l5d.consul, host: 127.0.0.1, port: {consul}}}
- {{kind: io.l5d.marathon, host: 127.0.0.1, port: {marathon}, ttlMs: 100}}
- kind: io.l5d.serversets
  zkAddrs: [{{host: 127.0.0.1, port: {zk}}}]
- kind: io.l5d.zkLeader
  zkAddrs: [{{host: 127.0.0.1, port: {zk}}}]
- kind: io.l5d.curator
  zkAddrs: [{{host: 127.0.0.1, port: {zk}}}]
  basePath: /services
telemetry:
- kind: io.l5d.jaxAnomaly
  trainEveryBatches: 0
  maxBatch: 40
usage: {{enabled: false}}
"""

PKGS = {
    "ref": dict(linker=ref_linker, http=ref_http, client=ref_client,
                server=ref_server, service=ref_service, zk=ref_zk),
    "port": dict(linker=port_linker, http=port_http, client=port_client,
                 server=port_server, service=port_service, zk=port_zk),
}


def publish(consul, marathon, zk, ports: dict) -> None:
    """Points every namer's source at this session's backends: ``ports``
    maps a destination to its replicas' ports."""
    for d in ("/c/web0", "/c/web1"):
        consul.set_service(d.split("/")[2],
                           [("127.0.0.1", p) for p in ports[d]])
    marathon.set_app("/app0", [("127.0.0.1", p) for p in ports["/m/app0"]])
    for path in [p for p in list(zk.nodes) if p != "/"]:
        if path.count("/") == 1:
            zk.delete_node(path)
    for i, p in enumerate(ports["/s/users"]):
        zk.set_node(f"/discovery/users/member_{i:010d}", json.dumps({
            "serviceEndpoint": {"host": "127.0.0.1", "port": p},
            "additionalEndpoints": {}, "status": "ALIVE"}).encode())
    for i, p in enumerate(ports["/l/jobs"]):
        zk.set_node(f"/election/jobs/c_{i:010d}", f"127.0.0.1:{p}".encode())
    for i, p in enumerate(ports["/k/api"]):
        zk.set_node(f"/services/api/i-{i}", json.dumps({
            "name": "api", "id": f"i-{i}", "address": "127.0.0.1",
            "port": p, "sslPort": None}).encode())


async def session(pkg: str, clock: Clock, fakes) -> dict:
    m = PKGS[pkg]
    http = m["http"]
    rng = random.Random(3)
    consul, marathon, zk = fakes

    def replica(dst):
        async def handle(req):
            clock.now += 1e-3 * (1.0 + rng.random())
            return http.Response(status=200, body=dst.encode())
        return m["service"].FnService(handle)

    backends = {d: [await m["server"].serve(replica(d))
                    for _ in range(REPLICAS)] for d in DSTS}
    publish(consul, marathon, zk, {d: [b.bound_port for b in bs]
                                   for d, bs in backends.items()})
    text = CONFIG.format(consul=consul.port, marathon=marathon.port,
                         zk=zk.port)
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
            dst = order.choice(DSTS)
            rsp = await asyncio.wait_for(proxy(http.Request(uri=dst)), 10)
            answers.append((dst, rsp.status, rsp.body))
        while tele.ring:
            await tele.drain_once()
        clients = sorted({k.split("/")[3] for k in linker.metrics.flatten()
                          if k.startswith("rt/disco/client/")})
        scores = {k: round(v, 6)
                  for k, v in tele.board.effective_scores().items()}
    finally:
        await proxy.close()
        await linker.close()
        await m["zk"].close_shared_zk()
        for bs in backends.values():
            for b in bs:
                await b.close()
    return dict(answers=answers, clients=clients, scores=scores)


@pytest.fixture(scope="module")
def runs():
    with pytest.MonkeyPatch.context() as monkeypatch:
        monkeypatch.delenv("DCOS_SERVICE_ACCOUNT_CREDENTIAL", raising=False)
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
            fakes = (await FakeConsul(hold_s=1.0).start(),
                     await FakeMarathon().start(),
                     await FakeZkServer().start())
            try:
                return {"port": await session("port", clocks[1], fakes),
                        "ref": await session("ref", clocks[0], fakes)}
            finally:
                for f in fakes:
                    await f.close()
        out = asyncio.run(asyncio.wait_for(both(), 120))
    return out, recs


def test_answers_and_bound_ids_alike(runs):
    out, _ = runs
    got, want = out["port"], out["ref"]
    assert got["answers"] == want["answers"]
    assert got["clients"] == want["clients"]
    # every request answered 200 by the destination it named, through
    # each of the five namers
    assert all(status == 200 and body == dst.encode()
               for dst, status, body in got["answers"])
    assert {d for d, _, _ in got["answers"]} == set(DSTS)
    assert got["clients"] == sorted([
        "#.io.l5d.consul.dc1.web0", "#.io.l5d.consul.dc1.web1",
        "#.io.l5d.marathon.app0", "#.io.l5d.serversets.discovery.users",
        "#.io.l5d.zkLeader.election.jobs", "#.io.l5d.curator.api"])


def test_rows_bit_equal_and_scores_within_bounds(runs):
    out, recs = runs
    p, r = recs["port"], recs["ref"]
    assert len(p.scored) == len(r.scored) >= N // 40
    assert sum(len(x) for x, _, _ in p.scored) == N
    gaps = []
    for (xp, sp, snap), (xr, _, _) in zip(p.scored, r.scored):
        assert np.array_equal(xp, xr)
        gaps.append(np.abs(sp - jax_scores(to_ref(snap), xp)))
    gap = np.concatenate(gaps)
    assert gap.max() <= TOL, gap.max()
    assert (gap > ROW_TOL).mean() <= ROW_SHARE
    got, want = out["port"]["scores"], out["ref"]["scores"]
    assert sorted(got) == sorted(want) == sorted(f"/svc{d}" for d in DSTS)
    assert max(abs(got[k] - want[k]) for k in got) <= TOL


# -- the linker's device order ----------------------------------------------

NO_DEVICE = """
routers:
- protocol: http
  dtab: /svc => /#/io.l5d.fs ;
  servers: [{{port: 0}}]
namers:
- {{kind: io.l5d.fs, rootDir: {disco}}}
telemetry:
- {{kind: io.l5d.prometheus}}
- {{kind: io.l5d.recentRequests, sampleRate: 1.0}}
"""


def no_cuda(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_linker_without_device_telemeters_loads_without_cuda(
        monkeypatch, tmp_path):
    no_cuda(monkeypatch)
    linker = port_linker.load_linker(NO_DEVICE.format(disco=tmp_path))
    try:
        assert linker.device is None
        assert len(linker.telemeters) == 2
    finally:
        for _, n in linker.namers:
            n.close()


def test_anomaly_telemeter_without_device_still_raises(monkeypatch,
                                                      tmp_path):
    no_cuda(monkeypatch)
    text = NO_DEVICE.format(disco=tmp_path) + "- {kind: io.l5d.jaxAnomaly}\n"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_linker.load_linker(text)
    linker = port_linker.load_linker(text, device="cpu")
    try:
        assert linker.device.type == "cpu"
    finally:
        for t in linker.telemeters:
            t.close()
        for _, n in linker.namers:
            n.close()
