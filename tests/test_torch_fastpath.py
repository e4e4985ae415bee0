"""The port's ``fastPath: true`` router against the JAX package's, on the
CPU: ``router/fastpath.FastPathController`` and the linker's native
router.

- The controller, both packages' on one scripted engine (a stub that
  records every call): routes installed on a miss, an ``io.l5d.fs``
  rewrite re-installs, a deleted file (Neg) removes, the pushed route
  feature (hash column, sign) and route hash equal, engine stats land
  under ``rt/<label>/fastpath`` with equal values, and engine rows reach
  each telemeter's native ring with the same route attribution.
- The linker: ``load_linker(..., device="cpu")`` with a ``fastPath:
  true`` router proxies to fs-named backends through the port's own
  engine as the reference's linker does through its engine (a cold
  host, an unknown host, a live rebind), the telemeter scoring every
  engine row (``nativeTier: off``) or receiving them pre-scored after
  its initial publish (``nativeTier: primary``); bound through the
  port's namerd (``interpreter: {kind: io.l5d.namerd.http}``), both
  linkers install the route and move it on a namespace write.
- The fastPath refusals of the reference (``service``, ``loggers``,
  ``admissionControl``, a server's ``timeoutMs``, ``compressionLevel``,
  ``workers`` without fastPath) raise the reference's own text, and a
  ``failureAccrual`` block on a fastPath router is accepted and unused,
  as in the reference.

Every await is bounded (``asyncio.wait_for``), so a wedged socket fails
the test rather than the suite's clock.
"""

import asyncio
import json

import numpy as np
import pytest

from linkerd_tpu import native as ref_native
from linkerd_tpu.config import ConfigError as RefConfigError
from linkerd_tpu.core import Dtab as RefDtab
from linkerd_tpu.core import Path as RefPath
from linkerd_tpu.linker import load_linker as ref_load_linker
from linkerd_tpu.namer.core import ConfiguredDtabNamer as RefInterpreter
from linkerd_tpu.namer.fs import FsNamer as RefFsNamer
from linkerd_tpu.router.fastpath import FastPathController as RefController
from linkerd_tpu.telemetry import metrics as ref_metrics
from linkerd_tpu_torch import native
from linkerd_tpu_torch.config import ConfigError
from linkerd_tpu_torch.core import Dtab, Path
from linkerd_tpu_torch.core.tasks import monitor
from linkerd_tpu_torch.lifecycle.export import route_hash
from linkerd_tpu_torch.linker import load_linker
from linkerd_tpu_torch.models.features import path_hash_cols
from linkerd_tpu_torch.namer.core import ConfiguredDtabNamer
from linkerd_tpu_torch.namer.fs import FsNamer
from linkerd_tpu_torch.namerd import InMemoryDtabStore, Namerd
from linkerd_tpu_torch.namerd.http_api import HttpControlService
from linkerd_tpu_torch.protocol.http.message import Response
from linkerd_tpu_torch.protocol.http.server import serve
from linkerd_tpu_torch.router.fastpath import FastPathController
from linkerd_tpu_torch.router.service import FnService
from linkerd_tpu_torch.telemetry import metrics
from linkerd_tpu_torch.telemetry.linerate import NATIVE_ROW_WIDTH
from tests.test_torch_telemeter import start_snapshot, telemeters

WAIT_S = 10


def bounded(aw, timeout=WAIT_S):
    return asyncio.wait_for(aw, timeout)


def run(coro, timeout=60):
    return asyncio.run(asyncio.wait_for(coro, timeout))


async def until(cond, what: str, timeout=WAIT_S):
    t0 = asyncio.get_running_loop().time()
    while not cond():
        if asyncio.get_running_loop().time() - t0 > timeout:
            raise AssertionError(f"timed out waiting for {what}")
        await asyncio.sleep(0.01)


# -- the controller on a scripted engine -------------------------------------


class StubEngine:
    """Records the controller's calls; serves scripted misses, stats and
    feature rows."""

    def __init__(self):
        self.calls, self.misses, self.rows = [], [], np.zeros(
            (0, NATIVE_ROW_WIDTH), np.float32)
        self.snap = {}

    def start(self):
        self.calls.append(("start",))

    def set_route(self, host, eps):
        self.calls.append(("set_route", host, tuple(eps)))

    def remove_route(self, host):
        self.calls.append(("remove_route", host))

    def set_route_feature(self, host, col, sign):
        self.calls.append(("set_route_feature", host, col, sign))
        return True

    def set_route_hash(self, host, rhash):
        self.calls.append(("set_route_hash", host, rhash))
        return True

    def publish_weights(self, blob):
        self.calls.append(("publish_weights", len(blob)))

    def publish_delta(self, blob):
        self.calls.append(("publish_delta", len(blob)))

    def drain_misses(self):
        out, self.misses = self.misses, []
        return out

    def stats(self):
        return self.snap

    def drain_features(self):
        out, self.rows = self.rows, self.rows[:0]
        return out

    def drain_features_into(self, view):
        n = min(len(view), len(self.rows))
        view[:n] = self.rows[:n]
        self.rows = self.rows[n:]
        return n

    def close(self):
        self.calls.append(("close",))


STATS = {
    "accepted": 3,
    "routes": {"web": {"id": 0, "requests": 5, "success": 4, "f4xx": 0,
                       "f5xx": 1, "conn_fail": 0},
               "api": {"id": 1, "requests": 2, "success": 2, "f4xx": 0,
                       "f5xx": 0, "conn_fail": 0}},
    "native_scorer": {"weights": True, "version": 4, "crc": 77,
                      "generation": 0, "heads": 0, "scored": 6,
                      "specialist_scored": 0, "unscored": 1, "swaps": 1,
                      "delta_swaps": 0, "retries": 0},
}


def controllers(disco, snap):
    """(reference, port) controllers, each on its own fs namer over
    ``disco``, metrics tree, stub engine and telemeter."""
    rt, pt, _, _ = telemeters(snap, dict(maxBatch=64, trainEveryBatches=0,
                                         nativeTier="off"))
    ref_ctl = RefController(
        StubEngine(), RefInterpreter([(RefPath.read("/io.l5d.fs"),
                                       RefFsNamer(str(disco), 0.05))]),
        RefDtab.read("/svc => /#/io.l5d.fs ;"), RefPath.read("/svc"), "fp",
        ref_metrics.MetricsTree(), telemeters=[rt], miss_poll_s=0.005,
        stats_poll_s=3600)
    port_ctl = FastPathController(
        StubEngine(), ConfiguredDtabNamer([(Path.read("/io.l5d.fs"),
                                            FsNamer(str(disco), 0.05))]),
        Dtab.read("/svc => /#/io.l5d.fs ;"), Path.read("/svc"), "fp",
        metrics.MetricsTree(), telemeters=[pt], miss_poll_s=0.005,
        stats_poll_s=3600)
    return ref_ctl, port_ctl


def test_controller_matches_reference(tmp_path):
    snap = start_snapshot()

    async def go():
        (tmp_path / "web").write_text("127.0.0.1 1111\n127.0.0.1 1112\n")
        (tmp_path / "api").write_text("127.0.0.1 2222\n")
        ctls = controllers(tmp_path, snap)
        for c in ctls:
            await c.start()
        try:
            for c in ctls:  # misses -> bind -> route install
                c.engine.misses = ["web", "API", "ghost", ""]
            for c in ctls:
                await until(lambda: sum(k[0] == "set_route_hash"
                                        for k in c.engine.calls) == 2,
                            "routes installed on the misses")
            (tmp_path / "web").write_text("127.0.0.1 1113\n")
            for c in ctls:
                c.interpreter.namers[0][1].refresh()
            (tmp_path / "api").unlink()
            for c in ctls:
                c.interpreter.namers[0][1].refresh()
            for c in ctls:
                await until(lambda: ("remove_route", "api")
                            in c.engine.calls, "Neg removes the route")
            ref_calls, port_calls = (c.engine.calls for c in ctls)
            assert port_calls == ref_calls
            col, sign = path_hash_cols("/svc/web")
            assert ("set_route_feature", "web", col, sign) in port_calls
            assert ("set_route_hash", "web", route_hash("/svc/web")) \
                in port_calls
            assert ("set_route", "web", (("127.0.0.1", 1113),)) \
                in port_calls
            assert not any(k[1:2] == ("ghost",) for k in port_calls
                           if k[0] == "set_route")
            # stats under rt/fp/fastpath, twice (deltas)
            for c in ctls:
                c.engine.snap = json.loads(json.dumps(STATS))
                c._export_stats()
                c.engine.snap["routes"]["web"]["requests"] = 9
                c._export_stats()
            flats = [{k: v for k, v in c.metrics.flatten().items()
                      if k.startswith("rt/")} for c in ctls]
            assert flats[1] == flats[0]
            assert flats[1]["rt/fp/fastpath/route/web/requests"] == 9
            assert flats[1]["rt/fp/fastpath/scorer/scored"] == 6
            # engine rows into each telemeter's native ring
            rng = np.random.default_rng(4)
            rows = np.zeros((40, NATIVE_ROW_WIDTH), np.float32)
            rows[:, 0] = rng.integers(3, size=40)  # id 2: not in stats
            rows[:, 1] = rng.gamma(2.0, 4.0, 40)
            rows[:, 2] = 200
            for c in ctls:
                c.engine.rows = rows.copy()
                c._forward_features()
            teles = [c.telemeters[0] for c in ctls]
            for t in teles:
                assert len(t.native_ring) == 40
                assert t._requests.value == 40
            assert [c._route_dst(i) for i in range(3)] == \
                [ctls[0]._route_dst(i) for i in range(3)] == \
                ["/svc/web", "/svc/api", None]
            assert np.array_equal(teles[1].native_ring.consume(64),
                                  teles[0].native_ring.consume(64))
        finally:
            for c in ctls:
                await c.close()
                for _, n in c.interpreter.namers:
                    n.close()
                c.telemeters[0].close()
            assert ctls[1].engine.calls[-1] == ("close",)

    run(go())


# -- the linker ---------------------------------------------------------------


def linker_text(disco, telemetry=None, **router):
    cfg = {"routers": [dict({
        "protocol": "http", "label": "fp", "fastPath": True,
        "dtab": "/svc => /#/io.l5d.fs ;", "servers": [{"port": 0}]},
        **router)],
        "namers": [{"kind": "io.l5d.fs", "rootDir": str(disco),
                    "pollIntervalSecs": 0.05}]}
    if telemetry is not None:
        cfg["telemetry"] = [dict({"kind": "io.l5d.jaxAnomaly"}, **telemetry)]
    return json.dumps(cfg)


async def http_get(port: int, host: str):
    r, w = await bounded(asyncio.open_connection("127.0.0.1", port))
    try:
        w.write(f"GET / HTTP/1.1\r\nHost: {host}\r\n\r\n".encode())
        await bounded(w.drain())
        raw = await bounded(r.readuntil(b"\r\n\r\n"))
        lines = raw.decode().split("\r\n")
        headers = dict((k.strip().lower(), v.strip()) for k, _, v in
                       (ln.partition(":") for ln in lines[1:] if ln))
        n = int(headers.get("content-length", 0))
        body = await bounded(r.readexactly(n)) if n else b""
        return int(lines[0].split()[1]), "l5d-err" in headers, body
    finally:
        w.close()


def downstream(name: str):
    async def handle(req):
        return Response(200, body=name.encode())
    return serve(FnService(handle))


@pytest.fixture(scope="module")
def engines():
    """Both engine libraries, built before any event loop runs."""
    native.ensure_built()
    if not ref_native.ensure_built():
        pytest.fail("the reference's native library did not build")


async def scenario(load, disco, device_kw):
    """The reference e2e's steps: a cold host, an unknown host, a live
    rebind; returns what each step answered and the engine's counts."""
    a, b = await downstream("svc-a"), await downstream("svc-b")
    (disco / "web").write_text(f"127.0.0.1 {a.bound_port}\n")
    linker = load(linker_text(disco), **device_kw)
    await bounded(linker.start())
    port = linker.routers[0].server_ports[0]
    out = []
    try:
        out.append(await http_get(port, "web"))
        status, err, _ = await http_get(port, "nope")
        out.append((status, err))
        (disco / "web").write_text(f"127.0.0.1 {b.bound_port}\n")
        linker.namers[0][1].refresh()
        for _ in range(200):
            got = await http_get(port, "web")
            if got[2] == b"svc-b":
                break
            await asyncio.sleep(0.02)
        out.append(got)
        ctl = linker.routers[0].controller
        ctl._export_stats()
        flat = linker.metrics.flatten()
        out.append(flat["rt/fp/fastpath/route/web/requests"] >= 2)
        out.append(type(linker.routers[0]).__name__)
    finally:
        await bounded(linker.close())
        await bounded(a.close())
        await bounded(b.close())
    return out


def test_linker_serves_as_the_reference(engines, tmp_path):
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    want = run(scenario(ref_load_linker, tmp_path / "ref", {}))
    got = run(scenario(load_linker, tmp_path / "port", {"device": "cpu"}))
    assert got == want
    assert got[:3] == [(200, False, b"svc-a"), (400, True),
                       (200, False, b"svc-b")]


async def namerd_scenario(load, disco, device_kw):
    """A fastPath router with no dtab of its own, bound through the
    port's namerd over ``io.l5d.namerd.http``: the first request installs
    the route to ``web``; a write of the namespace that sends ``/svc/web``
    to ``web-b`` moves it. Returns what each step answered."""
    a, b = await downstream("svc-a"), await downstream("svc-b")
    (disco / "web").write_text(f"127.0.0.1 {a.bound_port}\n")
    (disco / "web-b").write_text(f"127.0.0.1 {b.bound_port}\n")
    base = "/svc => /#/io.l5d.fs ;"
    namerd = Namerd(InMemoryDtabStore({"default": Dtab.read(base)}),
                    namers=[(Path.read("/io.l5d.fs"),
                             FsNamer(str(disco), 0.05))])
    srv = await serve(HttpControlService(namerd))
    linker = load(linker_text(disco, dtab="", interpreter={
        "kind": "io.l5d.namerd.http",
        "dst": f"/$/inet/127.0.0.1/{srv.bound_port}",
        "namespace": "default"}), **device_kw)
    await bounded(linker.start())
    port = linker.routers[0].server_ports[0]
    out = []
    try:
        out.append(await http_get(port, "web"))
        vd = await bounded(namerd.store.observe("default").to_future())
        await namerd.store.update(
            "default", Dtab.read(base + " /svc/web => /svc/web-b ;"),
            vd.version)
        for _ in range(200):
            got = await http_get(port, "web")
            if got[2] == b"svc-b":
                break
            await asyncio.sleep(0.02)
        out.append(got)
        out.append(type(linker.routers[0]).__name__)
    finally:
        await bounded(linker.close())
        await bounded(srv.close())
        await bounded(namerd.close())
        await bounded(a.close())
        await bounded(b.close())
    return out


def test_fastpath_binds_through_namerd(engines, tmp_path):
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    want = run(namerd_scenario(ref_load_linker, tmp_path / "ref", {}))
    got = run(namerd_scenario(load_linker, tmp_path / "port",
                              {"device": "cpu"}))
    assert got == want == [(200, False, b"svc-a"), (200, False, b"svc-b"),
                           "_FastPathRouter"]


async def drive(disco, telemetry, n=60, **router):
    """``n`` requests over two fs-named destinations through a port
    fastPath linker with the telemeter's ``run()`` as a task; waits
    until every engine row is scored. Returns (flattened metrics,
    board, telemeter state)."""
    a, b = await downstream("svc-a"), await downstream("svc-b")
    (disco / "web").write_text(f"127.0.0.1 {a.bound_port}\n")
    (disco / "api").write_text(f"127.0.0.1 {b.bound_port}\n")
    linker = load_linker(linker_text(disco, telemetry, **router),
                         device="cpu")
    linker.routers[0].controller.stats_poll_s = 0.05
    await bounded(linker.start())
    tele = linker.telemeters[0]
    task = monitor(asyncio.create_task(tele.run()), what="telemeter")
    port = linker.routers[0].server_ports[0]
    try:
        if telemetry.get("nativeTier") == "primary":
            # run() builds the scorer off the loop: the engine scores
            # rows once the telemeter's initial publish has landed
            await until(lambda: tele.native_tier_state()["publishes"],
                        "the initial publish")
        for i in range(n):
            host = ("web", "api")[i % 2]
            status, _, body = await http_get(port, host)
            assert (status, body) == (200, f"svc-{'ab'[i % 2]}".encode())
        await until(lambda: tele._scored.value >= n, "every row scored")
        return (linker.metrics.flatten(), tele.board.scores.sample(),
                tele.native_tier_state())
    finally:
        task.cancel()
        await asyncio.gather(task, return_exceptions=True)
        await bounded(linker.close())
        await bounded(a.close())
        await bounded(b.close())


def test_engine_rows_reach_the_telemeter(engines, tmp_path):
    """nativeTier off: every engine row is scored by the device tier
    (the plain path here) and folded into the board per destination."""
    flat, board, state = run(drive(tmp_path, {
        "nativeTier": "off", "trainEveryBatches": 0}))
    assert flat["anomaly/requests_total"] == flat["anomaly/scored_total"] \
        == 60
    assert flat["anomaly/native_scored_total"] == 0
    assert flat["anomaly/native_ring_dropped"] == 0
    assert flat["rt/fp/fastpath/scorer/unscored"] == 60
    assert sorted(board) == ["/svc/api", "/svc/web"]
    assert state["blob"] is None and state["publishes"] == 0


def test_primary_tier_rows_arrive_prescored(engines, tmp_path):
    """nativeTier primary: the telemeter's initial publish lands in the
    engine, whose rows then arrive pre-scored; the board folds them
    with no device call."""
    flat, board, state = run(drive(tmp_path, {
        "nativeTier": "primary", "trainEveryBatches": 0}))
    assert flat["anomaly/scored_total"] == 60
    assert flat["anomaly/native_scored_total"] == 60
    assert flat["anomaly/native_scored_fraction"] == 1.0
    assert flat["rt/fp/fastpath/scorer/scored"] == 60
    assert flat["rt/fp/fastpath/scorer/weights"] == 1.0
    assert flat["rt/fp/fastpath/scorer/crc"] == state["blob"]["crc"]
    assert state["engines"] == 1 and state["publishes"] == 1
    assert sorted(board) == ["/svc/api", "/svc/web"]
    assert flat["anomaly/batches"] >= 1


def test_accrual_block_is_accepted_and_unused(engines, tmp_path):
    """A jaxAnomaly failureAccrual block on a fastPath router: both
    linkers build the native router and ignore the client block (the
    engine has no Python accrual)."""
    text = linker_text(tmp_path, {"trainEveryBatches": 0}, client={
        "failureAccrual": {"kind": "io.l5d.jaxAnomaly"}})
    for load, kw in ((ref_load_linker, {}), (load_linker,
                                             {"device": "cpu"})):
        linker = load(text, **kw)
        router = linker.routers[0]
        try:
            assert type(router).__name__ == "_FastPathRouter"
            assert router.service is None and router.binding is None
        finally:
            run(linker.close())


REFUSALS = {
    "service": {"service": {"totalTimeoutMs": 100}},
    "loggers": {"loggers": [{"kind": "io.l5d.http.file", "path": "x"}]},
    "admissionControl": {"admissionControl": {"maxConcurrency": 4}},
    "timeoutMs": {"servers": [{"port": 0, "timeoutMs": 100}]},
    "compressionLevel": {"servers": [{"port": 0, "compressionLevel": 6}]},
    "workers without fastPath": {"fastPath": False, "workers": 1},
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_fastpath_refusals_word_for_word(case, tmp_path):
    text = linker_text(tmp_path, **REFUSALS[case])
    with pytest.raises(RefConfigError) as want:
        ref_load_linker(text)
    with pytest.raises(ConfigError) as got:
        load_linker(text, device="cpu")
    assert str(got.value) == str(want.value)
