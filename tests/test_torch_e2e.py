"""The slice as a whole: a JAX-package linker whose ``io.l5d.jaxAnomaly``
telemeter scores its HTTP traffic through the port's scorer sidecar.

The router side is the unchanged JAX package, pointed at the sidecar
with ``sidecarTier: primary`` so the sidecar is its only scorer; the
sidecar is ``linkerd_tpu_torch``'s, serving the plain PyTorch path on
the CPU. Requests flow recorder -> micro-batch -> gRPC Score -> the
port's dispatch ring -> ScoreBoard.
"""

import asyncio

import numpy as np

from linkerd_tpu.linker import load_linker
from linkerd_tpu.protocol.http import Request, Response
from linkerd_tpu.protocol.http.client import HttpClient
from linkerd_tpu.protocol.http.server import serve
from linkerd_tpu.router.service import FnService
from linkerd_tpu_torch.telemetry.anomaly import InProcessScorer
from linkerd_tpu_torch.telemetry.sidecar import ScorerSidecar

REQUESTS = 120


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
