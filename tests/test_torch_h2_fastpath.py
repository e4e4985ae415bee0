"""The port's native h2/gRPC engine (``native.H2FastPathEngine``) and its
``protocol: h2``, ``fastPath: true`` router against the JAX package's, on
the CPU. Both packages build their engine library here from
``native/``.

- The engine: the same seeded gRPC calls (unary, a gRPC error carried
  in the trailers) routed by ``:authority`` give the same answers, route
  counters and exported rows (every column but the latency and the
  timestamp); a route miss parks until the route is installed; an
  unknown route gets 400; an 8 MB body crosses both flow-control
  levels; a hung backend gets 504 under ``set_response_timeout_ms``;
  ``set_flood_guard`` takes and rejects the same values, and closes a
  rapid-reset client and counts it alike; two workers' merged stats are
  the sum of theirs.
- The linker: ``load_linker(..., device="cpu")`` answers as the
  reference's (a routed call, an unknown authority, a live fs rebind);
  its rows reach the telemeter (``nativeTier: off``), whose scores of
  them are within 1e-5 of the JAX scorer's (Pallas, interpreted, from the
  same weights) on all but 1% of rows and within 1e-3 on every row, or
  arrive pre-scored (``primary``); ``streamScoring`` sends the engine's
  kind-1 stream samples to the telemeter's ring and the sentinel, as the
  reference's; a TLS server negotiates ALPN h2; ``connectionGuard``'s
  flood caps reach the engine.
- The four fixed-SETTINGS refusals raise the reference's own text; a
  server ``timeoutMs`` loads; tenants stay refused by name (ROADMAP
  Queue 1 item 10).

Every await is bounded (``asyncio.wait_for``).
"""

import asyncio
import json
import ssl
import subprocess

import numpy as np
import pytest

from linkerd_tpu import native as ref_native
from linkerd_tpu.config import ConfigError as RefConfigError
from linkerd_tpu.linker import load_linker as ref_load_linker
from linkerd_tpu_torch import grpc, native
from linkerd_tpu_torch.config import ConfigError
from linkerd_tpu_torch.core.tasks import monitor
from linkerd_tpu_torch.linker import load_linker
from linkerd_tpu_torch.protocol.h2 import frames, hpack
from linkerd_tpu_torch.protocol.h2.client import H2Client
from linkerd_tpu_torch.protocol.h2.messages import H2Request, H2Response
from linkerd_tpu_torch.protocol.h2.server import H2Server
from linkerd_tpu_torch.router.service import FnService
from linkerd_tpu_torch.telemetry.linerate import NATIVE_COL_KIND
from tests.test_torch_linker import jax_scores

ATOL = 1e-5             # bf16 bounds, ROADMAP Queue 3
BF16_SCORE_ATOL = 1e-3
BF16_ROW_SHARE = 0.01
WAIT_S = 10
ENGINES = {"ref": ref_native, "port": native}
# row columns that do not depend on the host's timing: route id, status,
# request and response bytes, score, scored, tenant, kind, stream key,
# frame count (1 is the latency, 5 the timestamp)
STABLE_COLS = [0, 2, 3, 4, 6, 7, 8, 9, 10, 11]


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


@pytest.fixture(scope="module")
def engines():
    """Both engine libraries, built before any event loop runs."""
    native.ensure_built()
    if not ref_native.ensure_built():
        pytest.fail("the reference's native library did not build")


class Echo(grpc.ProtoMessage):
    FIELDS = {"payload": grpc.Field(1, "bytes"), "n": grpc.Field(2, "int32")}


SVC = grpc.ServiceDef("fp.Echo", [
    grpc.Rpc("Echo", Echo, Echo), grpc.Rpc("Fail", Echo, Echo),
    grpc.Rpc("Watch", Echo, Echo, server_streaming=True)])


async def backend(name: str):
    """A gRPC backend whose answers carry ``name``; ``Fail`` answers
    UNAVAILABLE in the trailers, ``Watch`` streams ``n`` messages."""
    disp = grpc.ServerDispatcher()

    async def echo(req):
        return Echo(payload=name.encode() + b":" + req.payload)

    async def fail(req):
        raise grpc.GrpcError.of(14, "try again later")

    async def watch(req):
        async def gen():
            for i in range(req.n):
                yield Echo(payload=name.encode(), n=i)
        return gen()

    disp.register_all(SVC, {"Echo": echo, "Fail": fail, "Watch": watch})
    return await bounded(H2Server(disp).start())


async def call(client, method: str, payload: bytes):
    """One unary call: the answer's payload, or the grpc code and
    message of the error."""
    try:
        rep = await bounded(client.unary(SVC, method, Echo(payload=payload)))
    except grpc.GrpcError as e:
        return (e.status.code, e.status.message)
    return rep.payload


# -- the engine --------------------------------------------------------------


async def engine_session(pkg: str, seed: int = 5) -> list:
    """A seeded sequence of calls through ``pkg``'s engine to two
    routes: answers, route counters, stable row columns."""
    rng = np.random.default_rng(seed)
    a, b = await backend("a"), await backend("b")
    eng = ENGINES[pkg].H2FastPathEngine()
    port = eng.listen("127.0.0.1", 0)
    eng.start()
    eng.set_route("a", [("127.0.0.1", a.bound_port)])
    eng.set_route("b", [("127.0.0.1", b.bound_port)])
    h2 = H2Client("127.0.0.1", port)
    clients = {d: grpc.ClientDispatcher(h2, authority=d) for d in "ab"}
    out = []
    try:
        for i in range(40):
            d = "ab"[int(rng.integers(2))]
            method = "Fail" if rng.random() < 0.15 else "Echo"
            payload = bytes(int(rng.integers(0, 2000)))
            out.append(await call(clients[d], method, payload))
        stats = eng.stats()["routes"]
        out.append({h: {k: r[k] for k in ("requests", "success", "f4xx",
                                            "f5xx", "conn_fail")}
                    for h, r in stats.items()})
        out.append(eng.drain_features()[:, STABLE_COLS].tolist())
    finally:
        await bounded(h2.close())
        eng.close()
        await bounded(a.close())
        await bounded(b.close())
    return out


def test_engine_routes_and_exports_alike(engines):
    want = run(engine_session("ref"))
    got = run(engine_session("port"))
    assert got == want
    answers, stats, rows = got[:40], got[40], got[41]
    assert (14, "try again later") in answers
    assert all(x == (14, "try again later") or x.startswith((b"a:", b"b:"))
               for x in answers)
    assert sum(r["requests"] for r in stats.values()) == len(rows) == 40
    assert {r[1] for r in rows} == {200.0}  # gRPC errors ride the trailers


async def miss_session(pkg: str) -> list:
    """A call to an authority with no route parks until the route is
    installed; one to an authority that never gets one is answered
    400 with ``l5d-err``."""
    b = await backend("late")
    eng = ENGINES[pkg].H2FastPathEngine()
    port = eng.listen("127.0.0.1", 0)
    eng.start()
    h2 = H2Client("127.0.0.1", port)
    out = []
    try:
        fut = asyncio.ensure_future(call(grpc.ClientDispatcher(
            h2, authority="late"), "Echo", b"wait"))
        misses = []
        await until(lambda: misses.extend(eng.drain_misses())
                    or "late" in misses, "the miss")
        out.append("late" in misses)
        eng.set_route("late", [("127.0.0.1", b.bound_port)])
        out.append(await bounded(fut))
        rsp = await bounded(h2(H2Request(method="POST", path="/x",
                                         authority="ghost", body=b"")))
        out.append((rsp.status, rsp.headers.get("l5d-err") is not None))
    finally:
        await bounded(h2.close())
        eng.close()
        await bounded(b.close())
    return out


def test_route_miss_parks_and_unknown_route_gets_400_alike(engines):
    want = run(miss_session("ref"))
    got = run(miss_session("port"))
    assert got == want == [True, b"late:wait", (400, True)]


def test_8mb_body_crosses_both_flow_control_levels(engines):
    big = bytes(range(256)) * (32 * 1024)  # 8 MB

    async def echo_body(req):
        body, _ = await req.stream.read_all(max_bytes=1 << 27)
        return H2Response(status=200, body=body)

    async def go():
        srv = await bounded(H2Server(FnService(echo_body)).start())
        eng = native.H2FastPathEngine()
        port = eng.listen("127.0.0.1", 0)
        eng.start()
        eng.set_route("big", [("127.0.0.1", srv.bound_port)])
        h2 = H2Client("127.0.0.1", port)
        try:
            rsp = await bounded(h2(H2Request(method="POST", path="/up",
                                             authority="big", body=big)))
            body, _ = await bounded(rsp.stream.read_all(max_bytes=1 << 27))
            assert rsp.status == 200 and body == big
        finally:
            await bounded(h2.close())
            eng.close()
            await bounded(srv.close())

    run(go())


async def hung_session(pkg: str) -> tuple:
    hung = asyncio.Event()

    async def never(req):
        await hung.wait()

    srv = await bounded(H2Server(FnService(never)).start())
    eng = ENGINES[pkg].H2FastPathEngine()
    port = eng.listen("127.0.0.1", 0)
    eng.set_response_timeout_ms(300)
    eng.start()
    eng.set_route("hang", [("127.0.0.1", srv.bound_port)])
    h2 = H2Client("127.0.0.1", port)
    try:
        t0 = asyncio.get_running_loop().time()
        rsp = await bounded(h2(H2Request(method="GET", path="/x",
                                         authority="hang")))
        took = asyncio.get_running_loop().time() - t0
        return (rsp.status, rsp.headers.get("l5d-err") is not None,
                eng.stats()["routes"]["hang"]["f5xx"], took < 5)
    finally:
        hung.set()
        await bounded(h2.close())
        eng.close()
        await bounded(srv.close())


def test_hung_backend_gets_504_alike(engines):
    want = run(hung_session("ref"))
    got = run(hung_session("port"))
    assert got == want == (504, True, 1, True)
    for mod in ENGINES.values():
        with pytest.raises(ValueError, match="response timeout"):
            mod.H2FastPathEngine().set_response_timeout_ms(0)


FLOOD_CONFIGS = [
    {}, {"max_streams": 0, "rst_burst": 0}, {"rst_burst": -1},
    {"ping_burst": -3}, {"settings_burst": -1}, {"window_ms": 0},
    {"max_streams": 7, "window_ms": 1},
]


def test_flood_guard_takes_and_rejects_alike(engines):
    def outcome(mod, kw):
        eng = mod.H2FastPathEngine()
        try:
            eng.set_flood_guard(**kw)
            return "ok"
        except ValueError as e:
            return str(e)
        finally:
            eng.close()

    got = [outcome(native, kw) for kw in FLOOD_CONFIGS]
    assert got == [outcome(ref_native, kw) for kw in FLOOD_CONFIGS]
    assert got.count("ok") == 3


async def rapid_reset(port: int, n: int, authority: str = "a") -> str:
    """A client that opens ``n`` streams and resets each at once
    (CVE-2023-44487): "closed" when the server ends the connection, with
    a GOAWAY ENHANCE_YOUR_CALM or before the client reads one (the
    frames still unread make the close a reset), else the GOAWAY's
    error code."""
    r, w = await bounded(asyncio.open_connection("127.0.0.1", port))
    enc = hpack.Encoder()
    try:
        w.write(frames.CONNECTION_PREFACE + frames.pack_settings([]))
        for i in range(n):
            sid = 2 * i + 1
            block = enc.encode([(":method", "POST"), (":scheme", "http"),
                                (":path", "/fp.Echo/Echo"),
                                (":authority", authority),
                                ("content-type", "application/grpc")])
            w.write(frames.pack_frame(frames.HEADERS,
                                      frames.FLAG_END_HEADERS, sid, block)
                    + frames.pack_rst(sid, frames.CANCEL))
        await bounded(w.drain())
        while True:
            head = await bounded(r.read(9))
            if len(head) < 9:
                return "closed"
            fh = frames.unpack_header(head)
            payload = await bounded(r.readexactly(fh.length))
            if fh.type == frames.GOAWAY:
                code = int.from_bytes(payload[4:8], "big")
                return "closed" if code == frames.ENHANCE_YOUR_CALM \
                    else str(code)
    except (ConnectionError, asyncio.IncompleteReadError):
        return "closed"
    finally:
        w.close()


async def flood_session(pkg: str) -> tuple:
    a = await backend("a")
    eng = ENGINES[pkg].H2FastPathEngine()
    port = eng.listen("127.0.0.1", 0)
    eng.set_flood_guard(rst_burst=10)
    eng.start()
    eng.set_route("a", [("127.0.0.1", a.bound_port)])
    h2 = H2Client("127.0.0.1", port)
    try:
        calm = await call(grpc.ClientDispatcher(h2, authority="a"), "Echo",
                          b"calm")
        code = await rapid_reset(port, 32)
        after = await call(grpc.ClientDispatcher(h2, authority="a"), "Echo",
                           b"still")
        return code, eng.stats()["guard"]["rapid_reset_closed"], calm, after
    finally:
        await bounded(h2.close())
        eng.close()
        await bounded(a.close())


def test_rapid_reset_client_is_closed_alike(engines):
    want = run(flood_session("ref"))
    got = run(flood_session("port"))
    assert got == want == ("closed", 1, b"a:calm", b"a:still")


def test_two_workers_merged_stats_are_the_sum(engines):
    async def go():
        a = await backend("a")
        eng = native.H2FastPathEngine(workers=2)
        port = eng.listen("127.0.0.1", 0)
        eng.start()
        eng.set_route("a", [("127.0.0.1", a.bound_port)])
        conns = [H2Client("127.0.0.1", port) for _ in range(8)]
        try:
            for h2 in conns:
                stub = grpc.ClientDispatcher(h2, authority="a")
                for i in range(4):
                    assert await call(stub, "Echo", b"x") == b"a:x"
            stats = eng.stats()
            per = stats["workers"]
            assert len(per) == 2
            for k in ("requests", "success"):
                assert stats["routes"]["a"][k] == 32 == sum(
                    w["routes"].get("a", {}).get(k, 0) for w in per)
            assert stats["accepted"] == sum(w["accepted"] for w in per) == 8
            assert len(eng.drain_features()) == 32
        finally:
            for h2 in conns:
                await bounded(h2.close())
            eng.close()
            await bounded(a.close())

    run(go())


# -- the linker --------------------------------------------------------------


def linker_text(disco, telemetry=None, **router) -> str:
    cfg = {"routers": [dict({
        "protocol": "h2", "label": "h2fp", "fastPath": True,
        "dtab": "/svc => /#/io.l5d.fs ;", "servers": [{"port": 0}]},
        **router)],
        "namers": [{"kind": "io.l5d.fs", "rootDir": str(disco),
                    "pollIntervalSecs": 0.05}]}
    if telemetry is not None:
        cfg["telemetry"] = [dict({"kind": "io.l5d.jaxAnomaly"}, **telemetry)]
    return json.dumps(cfg)


def load(pkg: str, text: str):
    return (load_linker(text, device="cpu") if pkg == "port"
            else ref_load_linker(text))


async def linker_session(pkg: str, disco) -> list:
    """The reference e2e's steps through an h2 fastPath linker: a routed
    call, an unknown authority, a live rebind by an fs edit."""
    a, b = await backend("svc-a"), await backend("svc-b")
    (disco / "web").write_text(f"127.0.0.1 {a.bound_port}\n")
    linker = load(pkg, linker_text(disco))
    await bounded(linker.start())
    port = linker.routers[0].server_ports[0]
    h2 = H2Client("127.0.0.1", port)
    web = grpc.ClientDispatcher(h2, authority="web")
    out = []
    try:
        out.append(await call(web, "Echo", b"hi"))
        rsp = await bounded(h2(H2Request(method="POST", path="/x",
                                         authority="nope", body=b"")))
        out.append((rsp.status, rsp.headers.get("l5d-err") is not None))
        (disco / "web").write_text(f"127.0.0.1 {b.bound_port}\n")
        linker.namers[0][1].refresh()
        for _ in range(200):
            got = await call(web, "Echo", b"hi")
            if got == b"svc-b:hi":
                break
            await asyncio.sleep(0.02)
        out.append(got)
        linker.routers[0].controller._export_stats()
        flat = linker.metrics.flatten()
        out.append(flat["rt/h2fp/fastpath/route/web/requests"] >= 2)
        out.append((type(linker.routers[0]).__name__,
                    type(linker.routers[0].controller.engine).__name__))
    finally:
        await bounded(h2.close())
        await bounded(linker.close())
        await bounded(a.close())
        await bounded(b.close())
    return out


def test_linker_serves_as_the_reference(engines, tmp_path):
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    want = run(linker_session("ref", tmp_path / "ref"))
    got = run(linker_session("port", tmp_path / "port"))
    assert got == want
    assert got[:3] == [b"svc-a:hi", (400, True), b"svc-b:hi"]
    assert got[4] == ("_FastPathRouter", "H2FastPathEngine")


async def drive(disco, telemetry, n=64, **router):
    """``n`` calls over two fs-named destinations through a port h2
    fastPath linker with the telemeter's ``run()`` as a task, until every
    engine row is scored. Returns (flattened metrics, board, telemeter
    state, the rows and scores each score call took)."""
    a, b = await backend("svc-a"), await backend("svc-b")
    (disco / "web").write_text(f"127.0.0.1 {a.bound_port}\n")
    (disco / "api").write_text(f"127.0.0.1 {b.bound_port}\n")
    linker = load_linker(linker_text(disco, telemetry, **router),
                         device="cpu")
    linker.routers[0].controller.stats_poll_s = 0.05
    await bounded(linker.start())
    tele = linker.telemeters[0]
    scorer = tele._ensure_scorer()
    scored, score = [], scorer.score

    async def scoring(x):
        s = await score(x)
        scored.append((x, s))
        return s

    scorer.score = scoring
    task = monitor(asyncio.create_task(tele.run()), what="telemeter")
    h2 = H2Client("127.0.0.1", linker.routers[0].server_ports[0])
    try:
        if telemetry.get("nativeTier") == "primary":
            await until(lambda: tele.native_tier_state()["publishes"],
                        "the initial publish")
        stubs = [grpc.ClientDispatcher(h2, authority=d)
                 for d in ("web", "api")]
        for lo in range(0, n, 32):  # 32 calls in flight
            got = await asyncio.gather(*(call(stubs[i % 2], "Echo", b"x")
                                         for i in range(lo, min(n, lo + 32))))
            assert got == [f"svc-{'ab'[i % 2]}:x".encode()
                           for i in range(lo, min(n, lo + 32))]
        await until(lambda: tele._scored.value >= n, "every row scored")
        return (linker.metrics.flatten(), tele.board.scores.sample(),
                tele.native_tier_state(), scored, scorer)
    finally:
        task.cancel()
        await asyncio.gather(task, return_exceptions=True)
        await bounded(h2.close())
        await bounded(linker.close())
        await bounded(a.close())
        await bounded(b.close())


def test_engine_rows_scored_as_jax_scores_them(engines, tmp_path):
    """nativeTier off: every h2 engine row is scored by the device tier
    (the plain path here), keyed to its destination; the scores are
    held to the bf16 bounds against the JAX scorer on the same rows and
    weights. 1,024 rows: the rows' latencies are the host's, and now and
    then a row's bf16 activation tips against JAX's float32 sums (ROADMAP
    Queue 3, bounds in force), so the 1% share needs rows to count."""
    n = 1024
    flat, board, state, scored, scorer = run(drive(tmp_path, {
        "nativeTier": "off", "trainEveryBatches": 0}, n=n))
    assert flat["anomaly/requests_total"] == flat["anomaly/scored_total"] \
        == n
    assert flat["anomaly/native_scored_total"] == 0
    assert flat["anomaly/native_ring_dropped"] == 0
    assert flat["rt/h2fp/fastpath/scorer/unscored"] == n
    assert sorted(board) == ["/svc/api", "/svc/web"]
    assert state["blob"] is None and state["publishes"] == 0
    x = np.concatenate([x for x, _ in scored])
    port = np.concatenate([s for _, s in scored])
    assert len(x) == n
    want = jax_scores(scorer.snapshot(), x)
    diff = np.abs(port - want)
    assert diff.max() <= BF16_SCORE_ATOL, diff.max()
    assert (diff > ATOL).mean() <= BF16_ROW_SHARE, (diff > ATOL).mean()


def test_primary_tier_rows_arrive_prescored(engines, tmp_path):
    """nativeTier primary: the telemeter's initial publish lands in the
    h2 engine, whose rows then arrive pre-scored; the board folds them
    with no device call."""
    flat, board, state, scored, _ = run(drive(tmp_path, {
        "nativeTier": "primary", "trainEveryBatches": 0}))
    assert flat["anomaly/scored_total"] == 64
    assert flat["anomaly/native_scored_total"] == 64
    assert flat["rt/h2fp/fastpath/scorer/scored"] == 64
    assert flat["rt/h2fp/fastpath/scorer/crc"] == state["blob"]["crc"]
    assert state["engines"] == 1 and state["publishes"] == 1
    assert sorted(board) == ["/svc/api", "/svc/web"]
    assert not scored


async def stream_session(pkg: str, disco) -> dict:
    """One server-streaming call of 24 messages through an h2 fastPath
    router with ``streamScoring`` (observe, a sample every 2 frames) and
    the telemeter: the engine's kind-1 rows in the telemeter's ring and
    the Python sentinel's snapshot."""
    a = await backend("svc-a")
    (disco / "web").write_text(f"127.0.0.1 {a.bound_port}\n")
    linker = load(pkg, linker_text(
        disco, {"nativeTier": "off", "trainEveryBatches": 0},
        streamScoring={"sampleEveryFrames": 2, "minGapMs": 0,
                       "action": "observe"}))
    await bounded(linker.start())
    ctl = linker.routers[0].controller
    h2 = H2Client("127.0.0.1", linker.routers[0].server_ports[0])
    try:
        stub = grpc.ClientDispatcher(h2, authority="web")
        reps = await bounded(stub.server_stream(SVC, "Watch", Echo(n=24)))
        msgs = [m.n async for m in reps]
        await bounded(h2.close())
        await asyncio.sleep(0.2)  # the engine retires the stream
        ctl._forward_features()
        ring = linker.telemeters[0].native_ring
        rows = ring.consume(1024)
        snap = ctl.stream_sentinel.snapshot()
        return {"messages": msgs,
                "kinds": sorted(int(k) for k in rows[:, NATIVE_COL_KIND]),
                "streams": snap["count"] if "count" in snap
                else len(snap["by_stream"]),
                "samples": sum(s["samples"] for s in
                               snap["by_stream"].values())}
    finally:
        await bounded(h2.close())
        await bounded(linker.close())
        await bounded(a.close())


def test_stream_samples_reach_ring_and_sentinel_alike(engines, tmp_path):
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    want = run(stream_session("ref", tmp_path / "ref"))
    got = run(stream_session("port", tmp_path / "port"))
    assert got == want
    assert got["messages"] == list(range(24))
    kinds = got["kinds"]
    assert kinds.count(0) == 1 and kinds.count(1) == got["samples"] > 0
    assert got["streams"] == 1


@pytest.fixture(scope="module")
def certs(tmp_path_factory, engines):
    """A self-signed pair for localhost (openssl CLI)."""
    if not native.H2FastPathEngine.tls_runtime_available():
        pytest.fail("the engine cannot load the OpenSSL runtime")
    d = tmp_path_factory.mktemp("tls")
    cert, key = str(d / "cert.pem"), str(d / "key.pem")
    subprocess.run(
        ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-keyout", key,
         "-out", cert, "-days", "2", "-nodes", "-subj", "/CN=localhost",
         "-addext", "subjectAltName=DNS:localhost"],
        check=True, capture_output=True, timeout=60)
    return cert, key


async def tls_session(pkg: str, disco, cert: str, key: str) -> list:
    """An h2 fastPath router with a cleartext and a TLS server and
    ``connectionGuard`` (rstBurst 10): a call on each, the TLS counters
    (ALPN h2), then a rapid-reset client on the cleartext server and the
    guard counter it leaves."""
    a = await backend("svc-a")
    (disco / "web").write_text(f"127.0.0.1 {a.bound_port}\n")
    linker = load(pkg, linker_text(
        disco, servers=[{"port": 0}, {"port": 0, "tls": {
            "certPath": cert, "keyPath": key}}],
        connectionGuard={"rstBurst": 10}))
    await bounded(linker.start())
    ctl = linker.routers[0].controller
    clear, tls = linker.routers[0].server_ports
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    ctx.load_verify_locations(cert)
    clients = [H2Client("127.0.0.1", clear),
               H2Client("127.0.0.1", tls, ssl_context=ctx,
                        server_hostname="localhost")]
    out = []
    try:
        for h2 in clients:
            out.append(await call(grpc.ClientDispatcher(
                h2, authority="web"), "Echo", b"hi"))
        t = ctl.engine.stats()["tls"]
        out.append({k: t[k] for k in ("enabled", "handshakes", "failures",
                                      "alpn_h2", "alpn_http1")})
        out.append(await rapid_reset(clear, 32, "web"))
        ctl._export_stats()
        out.append(linker.metrics.flatten().get(
            "rt/h2fp/fastpath/guard/rapid_reset_closed"))
        out.append(type(ctl.engine).__name__)
    finally:
        for h2 in clients:
            await bounded(h2.close())
        await bounded(linker.close())
        await bounded(a.close())
    return out


def test_tls_alpn_h2_and_flood_guard_through_the_linker_alike(
        certs, tmp_path):
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    want = run(tls_session("ref", tmp_path / "ref", *certs))
    got = run(tls_session("port", tmp_path / "port", *certs))
    assert got == want
    assert got[:2] == [b"svc-a:hi", b"svc-a:hi"]
    assert got[2] == {"enabled": True, "handshakes": 1, "failures": 0,
                      "alpn_h2": 1, "alpn_http1": 0}
    assert got[3:] == ["closed", 1, "H2FastPathEngine"]


SETTINGS_KNOBS = {
    "maxFrameBytes": 65536, "initialStreamWindowBytes": 131072,
    "maxHeaderListBytes": 65536, "maxConcurrentStreamsPerConnection": 8}


@pytest.mark.parametrize("knob", sorted(SETTINGS_KNOBS))
def test_fixed_settings_refusals_word_for_word(knob, tmp_path):
    text = linker_text(tmp_path, **{knob: SETTINGS_KNOBS[knob]})
    with pytest.raises(RefConfigError) as want:
        ref_load_linker(text)
    with pytest.raises(ConfigError) as got:
        load_linker(text, device="cpu")
    assert str(got.value) == str(want.value)
    assert "fixed SETTINGS" in str(got.value)


def test_server_timeout_loads_and_tenants_stay_refused(engines, tmp_path):
    """A server ``timeoutMs`` (the engine's response timeout, the
    strictest server's) loads in both packages; ``tenants`` and
    ``tenantIdentifier`` on an h2 fastPath router, refused by name until
    the port took them, load in both to the same tenant views, and
    ``sni`` extraction without a TLS server fails with the reference's
    words."""
    text = linker_text(tmp_path, servers=[
        {"port": 0, "timeoutMs": 500}, {"port": 0, "timeoutMs": 250}])
    for pkg in ("ref", "port"):
        linker = load(pkg, text)
        assert type(linker.routers[0]).__name__ == "_FastPathRouter"
        run(linker.close())
    for keys in ({"tenants": {}}, {"tenantIdentifier": {"kind": "header"}},
                 {"tenantIdentifier": {"kind": "header"}, "tenants": {}}):
        out = []
        for pkg in ("ref", "port"):
            linker = load(pkg, linker_text(tmp_path, **keys))
            out.append([(label, type(a).__name__ if a else None)
                        for label, _b, a in linker.tenant_views])
            run(linker.close())
        assert out[1] == out[0], keys
    sni = linker_text(tmp_path, tenantIdentifier={"kind": "sni"})
    with pytest.raises(RefConfigError) as want:
        ref_load_linker(sni)
    with pytest.raises(ConfigError) as got:
        load_linker(sni, device="cpu")
    assert str(got.value) == str(want.value)
