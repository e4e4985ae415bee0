"""The slices as a whole: a JAX-package linker whose ``io.l5d.jaxAnomaly``
telemeter scores its HTTP traffic through the port's scorer sidecar,
and trains and checkpoints the port's model.

The router side is the unchanged JAX package, pointed at the sidecar
with ``sidecarTier: primary`` so the sidecar is its only scorer; the
sidecar is ``linkerd_tpu_torch``'s, serving the plain PyTorch path on
the CPU. Requests flow recorder -> micro-batch -> gRPC Score -> the
port's dispatch ring -> ScoreBoard, and with training on, every batch
that is not held out goes on as a gRPC Fit into the port's optimizer.
"""

import asyncio

import numpy as np

from linkerd_tpu.linker import load_linker
from linkerd_tpu.protocol.http import Request, Response
from linkerd_tpu.protocol.http.client import HttpClient
from linkerd_tpu.protocol.http.server import serve
from linkerd_tpu.router.service import FnService
from linkerd_tpu_torch.lifecycle import LifecycleConfig, store
from linkerd_tpu_torch.telemetry.anomaly import InProcessScorer
from linkerd_tpu_torch.telemetry.sidecar import (
    GrpcScorerClient, ScorerSidecar,
)

REQUESTS = 120
ROUNDS = 8


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, 120))


class TestLinkerThroughPortSidecar:
    def test_http_traffic_scored_by_port_sidecar(self, tmp_path):
        disco = tmp_path / "disco"
        disco.mkdir()

        async def backend(req: Request) -> Response:
            return Response(200, body=b"x" * 200)

        async def go():
            port = await ScorerSidecar(
                scorer=InProcessScorer(device="cpu"), warmup_rows=4).start()
            d = await serve(FnService(backend))
            (disco / "web").write_text(f"127.0.0.1 {d.bound_port}\n")
            linker = load_linker(f"""
routers:
- protocol: http
  label: rt
  dtab: |
    /svc => /#/io.l5d.fs ;
  servers: [{{port: 0}}]
  client:
    failureAccrual: {{kind: none}}
telemetry:
- kind: io.l5d.jaxAnomaly
  maxBatch: 512
  trainEveryBatches: 0
  sidecarAddress: 127.0.0.1:{port.port}
  sidecarTier: primary
  nativeTier: "off"
namers:
- kind: io.l5d.fs
  rootDir: {disco}
""")
            await linker.start()
            tele = linker.telemeters[0]
            proxy = HttpClient("127.0.0.1", linker.routers[0].server_ports[0])
            try:
                for _ in range(REQUESTS):
                    req = Request(method="GET", uri="/")
                    req.headers.set("Host", "web")
                    rsp = await proxy(req)
                    assert rsp.status == 200
                # drain what the line-rate loop has not yet scored
                while len(tele.ring):
                    await tele.drain_once()
                loop = asyncio.get_running_loop()
                deadline = loop.time() + 30
                while port.service.rows_scored < REQUESTS:
                    assert loop.time() < deadline, "rows not scored"
                    await asyncio.sleep(0.01)
                assert port.service.rows_scored == REQUESTS
                score = tele.board.score_of("/svc/web")
                assert np.isfinite(score) and 0.0 < score < 1.0
                assert "/svc/web" in tele.board.scores.sample()
            finally:
                await proxy.close()
                await linker.close()
                await d.close()
                await port.close()

        run(go())


async def quiet(scorer, settle_s=0.5, timeout_s=60.0):
    """Wait until no fit has run on ``scorer`` for ``settle_s``."""
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout_s
    last, since = scorer._step, loop.time()
    while loop.time() - since < settle_s or scorer._lock.locked():
        assert loop.time() < deadline, "fits did not settle"
        await asyncio.sleep(0.05)
        if scorer._step != last:
            last, since = scorer._step, loop.time()


class TestLinkerTrainsPortSidecar:
    def test_fit_rpcs_train_and_lifecycle_promotes(self, tmp_path):
        disco = tmp_path / "disco"
        disco.mkdir()
        ckpt = tmp_path / "ckpt"

        async def backend(req: Request) -> Response:
            return Response(200, body=b"x" * 200)

        async def go():
            scorer = InProcessScorer(device="cpu")
            port = await ScorerSidecar(scorer=scorer, warmup_rows=4).start()
            d = await serve(FnService(backend))
            (disco / "web").write_text(f"127.0.0.1 {d.bound_port}\n")
            linker = load_linker(f"""
routers:
- protocol: http
  label: rt
  dtab: |
    /svc => /#/io.l5d.fs ;
  servers: [{{port: 0}}]
  client:
    failureAccrual: {{kind: none}}
telemetry:
- kind: io.l5d.jaxAnomaly
  maxBatch: 512
  trainEveryBatches: 1
  sidecarAddress: 127.0.0.1:{port.port}
  sidecarTier: primary
  nativeTier: "off"
  lifecycle:
    directory: {ckpt}
    checkpointEveryS: 0
    minReplayRows: 8
namers:
- kind: io.l5d.fs
  rootDir: {disco}
""")
            await linker.start()
            tele = linker.telemeters[0]
            proxy = HttpClient("127.0.0.1", linker.routers[0].server_ports[0])
            restarted = client = None
            try:
                # rounds of traffic, each drained as its own batches:
                # every fourth batch is held out for the replay window,
                # each of the others goes on as a Fit
                for _ in range(ROUNDS):
                    for _ in range(REQUESTS // ROUNDS):
                        req = Request(method="GET", uri="/")
                        req.headers.set("Host", "web")
                        rsp = await proxy(req)
                        assert rsp.status == 200
                    while len(tele.ring):
                        await tele.drain_once()
                loop = asyncio.get_running_loop()
                deadline = loop.time() + 30
                while port.service.rows_scored < REQUESTS:
                    assert loop.time() < deadline, "rows not scored"
                    await asyncio.sleep(0.01)
                await quiet(scorer)
                assert port.service.rows_scored == REQUESTS
                assert scorer._step > 0
                assert scorer._step % scorer.fit_steps == 0
                assert scorer._norm_initialized

                outcome = await tele.lifecycle_cycle()
                assert outcome["action"] == "promoted", outcome
                version, snap = store.CheckpointStore(str(ckpt)).load()
                assert version == outcome["version"]
                assert snap.step == scorer._step
                assert store.encode_snapshot(snap) == \
                    store.encode_snapshot(scorer.snapshot())
                x = np.random.default_rng(0).standard_normal(
                    (300, 36)).astype(np.float32)
                served = await scorer.score(x)

                # a restarted port sidecar bootstraps from the store
                fresh = InProcessScorer(seed=9, device="cpu")
                manager = LifecycleConfig(directory=str(ckpt)).mk_manager(
                    device="cpu")
                assert await manager.bootstrap(fresh) == version
                restarted = await ScorerSidecar(scorer=fresh).start()
                client = GrpcScorerClient(f"127.0.0.1:{restarted.port}")
                again = await client.score(x)
                assert again.tobytes() == served.tobytes()
            finally:
                if client is not None:
                    await client.aclose()
                if restarted is not None:
                    await restarted.close()
                await proxy.close()
                await linker.close()
                await d.close()
                await port.close()

        run(go())
