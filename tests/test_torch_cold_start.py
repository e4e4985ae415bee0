"""The telemeter's cold start, on the CPU: ``JaxAnomalyTelemeter.run()``
builds its scorer on a worker thread and warms it up before the first
batch, so the router's event loop serves while the scorer is built (the
reference builds it on the loop).

With the scorer's build slowed to 2 s: the admin server's ``/ping`` and
a proxied request are answered during the build, the rows recorded
meanwhile wait in the ring and are all scored after it, and the warmed
scorer's state and scores equal those of a fresh scorer from the same
seed bit for bit.
"""

import asyncio
import json
import time

import numpy as np

from linkerd_tpu_torch.admin.handlers import linkerd_admin_handlers
from linkerd_tpu_torch.admin.server import AdminServer
from linkerd_tpu_torch.core.tasks import monitor
from linkerd_tpu_torch.linker import load_linker
from linkerd_tpu_torch.protocol.http.client import HttpClient
from linkerd_tpu_torch.protocol.http.message import Request, Response
from linkerd_tpu_torch.protocol.http.server import serve
from linkerd_tpu_torch.router.service import FnService
from linkerd_tpu_torch.telemetry import anomaly

BUILD_S = 2.0
WAIT_S = 10


def bounded(aw, timeout=WAIT_S):
    return asyncio.wait_for(aw, timeout)


async def get(port: int, uri: str, host: str = None) -> Response:
    client = HttpClient("127.0.0.1", port, max_connections=1)
    try:
        req = Request(uri=uri)
        if host:
            req.headers.set("Host", host)
        return await bounded(client(req))
    finally:
        await client.close()


def test_router_serves_while_the_scorer_is_built(tmp_path, monkeypatch):
    built = []
    mk = anomaly.JaxAnomalyTelemeter._mk_inprocess

    def slow_mk(self):
        time.sleep(BUILD_S)  # on the worker thread: the loop runs on
        scorer = mk(self)
        built.append(time.monotonic())
        return scorer

    monkeypatch.setattr(anomaly.JaxAnomalyTelemeter, "_mk_inprocess",
                        slow_mk)

    async def go():
        backend = await serve(FnService(
            lambda req: _answer(Response(200, body=b"web"))))
        (tmp_path / "web").write_text(f"127.0.0.1 {backend.bound_port}\n")
        linker = load_linker(json.dumps({
            "routers": [{"protocol": "http", "label": "cold",
                         "dtab": "/svc => /#/io.l5d.fs ;",
                         "servers": [{"port": 0}]}],
            "namers": [{"kind": "io.l5d.fs", "rootDir": str(tmp_path)}],
            "telemetry": [{"kind": "io.l5d.jaxAnomaly",
                           "trainEveryBatches": 0}]}), device="cpu")
        await bounded(linker.start())
        admin = AdminServer(linker.metrics, linker.config_dict, port=0)
        admin.add_handlers(linkerd_admin_handlers(linker))
        await bounded(admin.start())
        tele = linker.telemeters[0]
        t0 = time.monotonic()
        task = monitor(asyncio.create_task(tele.run()), what="telemeter")
        try:
            await asyncio.sleep(0.05)  # run() is in the build now
            ping = await get(admin.bound_port, "/ping")
            pinged = time.monotonic()
            proxied = [await get(linker.routers[0].server_ports[0], "/",
                                 "web") for _ in range(8)]
            during = (tele._scorer, len(tele.ring))
            t1 = time.monotonic()
            while tele._scored.value < 8:
                assert time.monotonic() - t1 < WAIT_S, "rows not scored"
                await asyncio.sleep(0.02)
            x = np.random.default_rng(5).random((64, 36), np.float32)
            warmed = tele._scorer
            got = await warmed.score(x)
            fresh = anomaly.InProcessScorer(device="cpu")
            try:
                want = await fresh.score(x)
                same_state = _same(warmed.snapshot(), fresh.snapshot())
            finally:
                fresh.close()
        finally:
            task.cancel()
            await asyncio.gather(task, return_exceptions=True)
            await admin.close()
            await bounded(linker.close())
            await bounded(backend.close())
        return (ping, pinged - t0, proxied, during, built[0] - t0, got,
                want, same_state, tele._requests.value)

    (ping, ping_s, proxied, during, built_s, got, want, same_state,
     rows) = asyncio.run(asyncio.wait_for(go(), 30))
    assert (ping.status, ping.body) == (200, b"pong")
    assert ping_s < BUILD_S <= built_s
    assert [(r.status, r.body) for r in proxied] == [(200, b"web")] * 8
    assert during == (None, 8)  # recorded rows wait for the scorer
    assert rows == 8
    assert same_state
    assert np.array_equal(np.asarray(got), np.asarray(want))


async def _answer(rsp):
    return rsp


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    return [np.asarray(tree)]


def _same(a, b) -> bool:
    """Two snapshots hold the same parameters, stats and step."""
    pa, pb = _leaves(a.params), _leaves(b.params)
    return (a.step == b.step and len(pa) == len(pb)
            and np.array_equal(a.mu, b.mu) and np.array_equal(a.var, b.var)
            and all(np.array_equal(p, q) for p, q in zip(pa, pb)))
