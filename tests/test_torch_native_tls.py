"""Native TLS on the port's HTTP/1.1 engine, and the slice end to end, on
the CPU.

- The engine (``native.FastPathEngine``): ALPN selects http/1.1, a TLS
  exchange is byte-identical to its cleartext twin, a cleartext client
  at a TLS listener is a counted handshake failure, a session ticket
  resumes: the h1 cases of the reference's native TLS tests.
- The port's linker: TLS in and TLS out through an assembled fastPath
  router (handshakes under ``rt/<label>/fastpath/tls``); the step back
  to the Python data plane, with the reference's warning, when the
  OpenSSL runtime cannot be loaded natively; a router without a tls
  block stays native cleartext; the TLS subsets with no native seam
  fail the load with the reference's text.
- The slice end to end: a port linker with ``fastPath``, ``workers:
  1``, a cleartext and a TLS server, ``connectionGuard``,
  ``streamScoring`` and the jaxAnomaly telemeter on ``device="cpu"``
  serves real sockets (requests on both servers, 101 tunnels, slow
  clients); the scores of the rows it drains equal the JAX package's
  ``best_scorer`` on the same feature rows within the bf16 bounds.

Every socket wait has its own deadline of at most 30 s.
"""

import asyncio
import json
import logging
import socket
import ssl
import subprocess
import time

import jax
import numpy as np
import pytest

from linkerd_tpu.config import ConfigError as RefConfigError
from linkerd_tpu.linker import load_linker as ref_load_linker
from linkerd_tpu.models import anomaly as jax_model
from linkerd_tpu.ops import scoring as jax_scoring
from linkerd_tpu_torch import native
from linkerd_tpu_torch.config import ConfigError
from linkerd_tpu_torch.core.tasks import monitor
from linkerd_tpu_torch.linker import _FastPathRouter, load_linker
from linkerd_tpu_torch.protocol.http.message import Response
from linkerd_tpu_torch.protocol.http.server import serve
from linkerd_tpu_torch.router.service import FnService
from linkerd_tpu_torch.telemetry.linerate import (
    NATIVE_COL_KIND, NATIVE_KIND_TUNNEL,
)

WAIT_S = 10
ATOL = 1e-5            # bf16 bounds, ROADMAP Queue 3
BF16_SCORE_ATOL = 1e-3
BF16_ROW_SHARE = 0.01


def bounded(aw, timeout=WAIT_S):
    return asyncio.wait_for(aw, timeout)


def run(coro, timeout=30):
    return asyncio.run(asyncio.wait_for(coro, timeout))


async def until(cond, what: str, timeout=WAIT_S):
    t0 = asyncio.get_running_loop().time()
    while not cond():
        if asyncio.get_running_loop().time() - t0 > timeout:
            raise AssertionError(f"timed out waiting for {what}")
        await asyncio.sleep(0.01)


@pytest.fixture(scope="module")
def certs(tmp_path_factory):
    """A self-signed pair for localhost and ``echo`` (openssl CLI), the
    port's engine built before any event loop runs."""
    native.ensure_built()
    if not native.FastPathEngine.tls_runtime_available():
        pytest.fail("the engine cannot load the OpenSSL runtime")
    d = tmp_path_factory.mktemp("tls")
    cert, key = str(d / "cert.pem"), str(d / "key.pem")
    subprocess.run(
        ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-keyout", key,
         "-out", cert, "-days", "2", "-nodes", "-subj", "/CN=localhost",
         "-addext", "subjectAltName=DNS:localhost,DNS:echo,DNS:web"],
        check=True, capture_output=True, timeout=60)
    return cert, key


def client_ctx(cert: str) -> ssl.SSLContext:
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    ctx.load_verify_locations(cert)
    return ctx


def h1_get(sock, host=b"echo") -> bytes:
    sock.settimeout(WAIT_S)
    sock.sendall(b"GET / HTTP/1.1\r\nHost: " + host + b"\r\n\r\n")
    buf = b""
    while b"\r\n\r\n" not in buf or not buf.endswith(b"ok"):
        d = sock.recv(4096)
        if not d:
            break
        buf += d
    return buf


@pytest.fixture
def h1_backend():
    """Threaded keep-alive HTTP/1.1 backend with a fixed response."""
    import threading

    lsock = socket.socket()
    lsock.bind(("127.0.0.1", 0))
    lsock.listen(16)

    def serve_forever():
        while True:
            try:
                c, _ = lsock.accept()
            except OSError:
                return

            def one(c=c):
                buf = b""
                with c:
                    while True:
                        try:
                            d = c.recv(4096)
                        except OSError:
                            return
                        if not d:
                            return
                        buf += d
                        while b"\r\n\r\n" in buf:
                            buf = buf.split(b"\r\n\r\n", 1)[1]
                            c.sendall(b"HTTP/1.1 200 OK\r\n"
                                      b"Content-Length: 2\r\n\r\nok")

            threading.Thread(target=one, daemon=True).start()

    threading.Thread(target=serve_forever, daemon=True).start()
    yield lsock.getsockname()[1]
    lsock.close()


def tls_engine(cert, key, backend):
    """A started one-worker engine with a TLS listener and a cleartext
    one, routing ``echo`` to ``backend``: (engine, tls port, port)."""
    eng = native.FastPathEngine()
    eng.set_tls(cert, key)
    tls_port = eng.listen_tls("127.0.0.1", 0)
    clear_port = eng.listen("127.0.0.1", 0)
    eng.start()
    eng.set_route("echo", [("127.0.0.1", backend)])
    return eng, tls_port, clear_port


class TestAlpnNegotiation:
    def test_h1_engine_selects_http11(self, certs, h1_backend):
        eng, port, _ = tls_engine(*certs, h1_backend)
        try:
            ctx = client_ctx(certs[0])
            ctx.set_alpn_protocols(["h2", "http/1.1"])
            with socket.create_connection(("127.0.0.1", port), WAIT_S) as s:
                with ctx.wrap_socket(s, server_hostname="localhost") as ts:
                    assert ts.selected_alpn_protocol() == "http/1.1"
                    assert b"200 OK" in h1_get(ts)
            tls = eng.stats()["tls"]
            assert tls["alpn_http1"] == 1 and tls["handshakes"] == 1
        finally:
            eng.close()


class TestH1Tls:
    def test_byte_identical_tls_vs_cleartext(self, certs, h1_backend):
        eng, tls_port, clear_port = tls_engine(*certs, h1_backend)
        try:
            ctx = client_ctx(certs[0])
            with socket.create_connection(("127.0.0.1", tls_port),
                                          WAIT_S) as s:
                with ctx.wrap_socket(s, server_hostname="localhost") as ts:
                    via_tls = h1_get(ts)
                    assert h1_get(ts) == via_tls  # keep-alive
            with socket.create_connection(("127.0.0.1", clear_port),
                                          WAIT_S) as s:
                via_clear = h1_get(s)
            assert via_tls == via_clear and b"200 OK" in via_tls
        finally:
            eng.close()

    def test_handshake_failure_accounted(self, certs, h1_backend):
        eng, port, _ = tls_engine(*certs, h1_backend)
        try:
            with socket.create_connection(("127.0.0.1", port), WAIT_S) as s:
                s.sendall(b"GET / HTTP/1.1\r\nHost: echo\r\n\r\n")
                assert s.recv(4096) == b""  # closed, no plaintext answer
            deadline = time.monotonic() + WAIT_S
            while not eng.stats()["tls"]["failures"] and \
                    time.monotonic() < deadline:
                time.sleep(0.02)
            tls = eng.stats()["tls"]
            assert tls["failures"] == 1 and tls["handshakes"] == 0
        finally:
            eng.close()

    def test_session_resumption(self, certs, h1_backend):
        eng, port, _ = tls_engine(*certs, h1_backend)
        try:
            ctx = client_ctx(certs[0])
            with socket.create_connection(("127.0.0.1", port), WAIT_S) as s:
                with ctx.wrap_socket(s, server_hostname="localhost") as ts:
                    assert b"200 OK" in h1_get(ts)
                    session = ts.session
            with socket.create_connection(("127.0.0.1", port), WAIT_S) as s:
                with ctx.wrap_socket(s, server_hostname="localhost",
                                     session=session) as ts:
                    assert b"200 OK" in h1_get(ts)
            tls = eng.stats()["tls"]
            assert tls["handshakes"] == 2 and tls["resumed"] == 1
        finally:
            eng.close()

    def test_two_workers_share_the_tls_identity(self, certs, h1_backend):
        """``set_tls`` and ``listen_tls`` on a sharded engine: every
        worker holds the identity and joins the one port."""
        eng = native.FastPathEngine(workers=2)
        try:
            eng.set_tls(*certs)
            port = eng.listen_tls("127.0.0.1", 0)
            eng.start()
            eng.set_route("echo", [("127.0.0.1", h1_backend)])
            ctx = client_ctx(certs[0])
            for _ in range(8):
                with socket.create_connection(("127.0.0.1", port),
                                              WAIT_S) as s:
                    with ctx.wrap_socket(
                            s, server_hostname="localhost") as ts:
                        assert b"200 OK" in h1_get(ts)
            st = eng.stats()
            assert st["tls"]["handshakes"] == 8
            assert [w["tls"]["enabled"] for w in st["workers"]] == \
                [True, True]
        finally:
            eng.close()


# -- the linker ------------------------------------------------------------


def fp_config(disco, cert, key, *, client_tls=None, extra=None) -> str:
    router = {"protocol": "http", "label": "fp", "fastPath": True,
              "dtab": "/svc => /#/io.l5d.fs ;",
              "servers": [{"port": 0, "tls": {"certPath": cert,
                                              "keyPath": key}}]}
    if client_tls is not None:
        router["client"] = {"tls": client_tls}
    router.update(extra or {})
    return json.dumps({"routers": [router], "namers": [{
        "kind": "io.l5d.fs", "rootDir": str(disco),
        "pollIntervalSecs": 0.05}]})


async def tls_get(port: int, cert: str, host: str) -> bytes:
    """The raw bytes of one GET's answer on a fresh connection (TLS with
    ``cert``), with ``Connection: close``."""
    r, w = await bounded(asyncio.open_connection(
        "127.0.0.1", port, ssl=client_ctx(cert) if cert else None,
        server_hostname="localhost" if cert else None))
    try:
        w.write(f"GET / HTTP/1.1\r\nHost: {host}\r\n"
                f"Connection: close\r\n\r\n".encode())
        await bounded(w.drain())
        head = await bounded(r.readuntil(b"\r\n\r\n"))
        length = next(int(ln.split(b":", 1)[1]) for ln in head.split(
            b"\r\n") if ln.lower().startswith(b"content-length:"))
        return head + await bounded(r.readexactly(length))
    finally:
        w.close()


class TestLinkerTls:
    def test_tls_both_legs_through_assembled_linker(self, certs, tmp_path):
        """TLS in -> the port's engine -> TLS out to a Python TLS
        backend, with the handshakes of both legs under
        ``rt/fp/fastpath/tls``."""
        cert, key = certs

        async def go():
            sctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            sctx.load_cert_chain(cert, key)
            backend = await serve(FnService(
                lambda req: _ok(b"secure-web")), ssl_context=sctx)
            (tmp_path / "web").write_text(
                f"127.0.0.1 {backend.bound_port}\n")
            linker = load_linker(fp_config(
                tmp_path, cert, key, client_tls={"trustCerts": [cert]}),
                device="cpu")
            assert isinstance(linker.routers[0], _FastPathRouter)
            ctl = linker.routers[0].controller
            ctl.stats_poll_s = 0.05
            await bounded(linker.start())
            try:
                got = await tls_get(linker.routers[0].server_ports[0],
                                    cert, "web")
                assert got.startswith(b"HTTP/1.1 200") and \
                    got.endswith(b"secure-web")
                await until(lambda: linker.metrics.flatten().get(
                    "rt/fp/fastpath/tls/upstream_handshakes", 0) >= 1,
                    "the upstream handshake exported")
                flat = linker.metrics.flatten()
                assert flat["rt/fp/fastpath/tls/handshakes"] == 1
            finally:
                await bounded(linker.close())
                await bounded(backend.close())

        run(go())

    def test_python_fallback_when_runtime_unavailable(
            self, certs, tmp_path, monkeypatch, caplog):
        """No OpenSSL runtime natively: the router steps back to the
        Python data plane, which serves the TLS config, with the
        reference's warning."""
        cert, key = certs
        monkeypatch.setattr(native.FastPathEngine, "tls_runtime_available",
                            classmethod(lambda cls: False))

        async def go():
            backend = await serve(FnService(lambda req: _ok(b"py")))
            (tmp_path / "web").write_text(
                f"127.0.0.1 {backend.bound_port}\n")
            linker = load_linker(fp_config(tmp_path, cert, key),
                                 device="cpu")
            assert not isinstance(linker.routers[0], _FastPathRouter)
            await bounded(linker.start())
            try:
                got = await tls_get(linker.routers[0].server_ports[0],
                                    cert, "web")
                assert got.startswith(b"HTTP/1.1 200") and \
                    got.endswith(b"py")
            finally:
                await bounded(linker.close())
                await bounded(backend.close())

        with caplog.at_level(logging.WARNING):
            run(go())
        assert ("fp: fastPath TLS requested but the OpenSSL runtime is "
                "unavailable natively; serving this router on the Python "
                "data plane instead") in caplog.messages

    def test_no_cert_stays_native_cleartext(self, tmp_path):
        text = json.dumps({"routers": [{
            "protocol": "http", "label": "fp", "fastPath": True,
            "dtab": "/svc => /#/io.l5d.fs ;", "servers": [{"port": 0}]}],
            "namers": [{"kind": "io.l5d.fs", "rootDir": str(tmp_path)}]})
        linker = load_linker(text, device="cpu")
        try:
            router = linker.routers[0]
            assert isinstance(router, _FastPathRouter)
            tls = router.controller.engine.stats()["tls"]
            assert tls["enabled"] is False
            assert tls["client_enabled"] is False
        finally:
            run(linker.close())

    @pytest.mark.parametrize("case", [
        "commonName", "clientAuth", "per-prefix", "caCertPath"])
    def test_unsupported_tls_subsets_fail_load(self, certs, tmp_path, case):
        """The TLS subsets with no native seam fail the load with the
        reference's text."""
        cert, key = certs
        server_tls = {"certPath": cert, "keyPath": key}
        client = {
            "commonName": {"tls": {"commonName": "x"}},
            "clientAuth": {"tls": {"disableValidation": True, "clientAuth":
                                   {"certPath": cert, "keyPath": key}}},
            "per-prefix": {"kind": "io.l5d.static", "configs": [
                {"prefix": "/svc", "tls": {"disableValidation": True}}]},
            "caCertPath": None}[case]
        if case == "caCertPath":
            server_tls["caCertPath"] = cert
        router = {"protocol": "http", "label": "bad", "fastPath": True,
                  "dtab": "/svc => /#/io.l5d.fs ;",
                  "servers": [{"port": 0, "tls": server_tls}]}
        if client is not None:
            router["client"] = client
        text = json.dumps({"routers": [router], "namers": [{
            "kind": "io.l5d.fs", "rootDir": str(tmp_path)}]})
        with pytest.raises(RefConfigError) as want:
            ref_load_linker(text)
        with pytest.raises(ConfigError, match=case) as got:
            load_linker(text, device="cpu")
        assert str(got.value) == str(want.value)


def _ok(body: bytes):
    async def answer():
        return Response(200, body=body)
    return answer()


# -- the slice end to end --------------------------------------------------


def jax_best_scores(snap, x: np.ndarray) -> np.ndarray:
    """The JAX package's ``best_scorer`` on the port's weights and
    stats (the plain XLA path on the CPU), compiled with
    ``xla_allow_excess_precision`` off."""
    jcfg = jax_model.AnomalyModelConfig(recon_weight=snap.cfg.recon_weight)
    params = jax.tree_util.tree_map(np.asarray, snap.params)
    step = jax_scoring.best_scorer(jcfg)
    mu, var = np.asarray(snap.mu), np.asarray(snap.var)
    compiled = step.lower(params, x, mu, var).compile(compiler_options={
        "xla_allow_excess_precision": False})
    return np.asarray(compiled(params, x, mu, var))


async def slow_head(port: int):
    """A client that sends half a request head and waits: its
    connection, closed by the guard's header budget."""
    r, w = await bounded(asyncio.open_connection("127.0.0.1", port))
    w.write(b"GET / HTTP/1.1\r\nHost: we")
    await bounded(w.drain())
    try:
        return await bounded(r.read(), 20)
    finally:
        w.close()


async def echo_upstream():
    """Answers a 101 upgrade, then echoes each chunk as ``echo:<chunk>``."""
    async def on_conn(reader, writer):
        try:
            await reader.readuntil(b"\r\n\r\n")
            writer.write(b"HTTP/1.1 101 Switching Protocols\r\n"
                         b"Upgrade: echo\r\nConnection: Upgrade\r\n\r\n")
            await writer.drain()
            while chunk := await reader.read(65536):
                writer.write(b"echo:" + chunk)
                await writer.drain()
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        finally:
            writer.close()

    return await asyncio.start_server(on_conn, "127.0.0.1", 0)


async def tunnel(port: int, frames: int, cert=None) -> None:
    """One 101 tunnel to the echo upstream (Host ``ws``), over TLS with
    ``cert``, exchanging ``frames`` echoed writes."""
    r, w = await bounded(asyncio.open_connection(
        "127.0.0.1", port, ssl=client_ctx(cert) if cert else None,
        server_hostname="localhost" if cert else None))
    try:
        w.write(b"GET /ws HTTP/1.1\r\nHost: ws\r\nConnection: Upgrade\r\n"
                b"Upgrade: echo\r\n\r\n")
        head = await bounded(r.readuntil(b"\r\n\r\n"))
        assert b" 101 " in head.split(b"\r\n")[0], head
        for i in range(frames):
            payload = b"frame-%03d" % i
            w.write(payload)
            await bounded(w.drain())
            assert await bounded(r.readexactly(5 + len(payload))) == \
                b"echo:" + payload
            await asyncio.sleep(0.005)
    finally:
        w.close()


def test_slice_end_to_end_against_the_jax_scorer(certs, tmp_path):
    """The whole slice on the CPU: requests on the cleartext and the TLS
    server (byte-identical answers), two tunnels sampled into kind-2
    rows, two slow clients closed by the guard; every drained row
    scored, and the port's scores of each batch's feature rows equal
    the JAX package's ``best_scorer`` on the same rows."""
    cert, key = certs
    n = 48

    async def go():
        web = await serve(FnService(lambda req: _ok(b"web" * 40)))
        api = await serve(FnService(lambda req: _ok(b"api" * 10)))
        ws = await echo_upstream()
        for name, port in (("web", web.bound_port), ("api", api.bound_port),
                           ("ws", ws.sockets[0].getsockname()[1])):
            (tmp_path / name).write_text(f"127.0.0.1 {port}\n")
        text = json.dumps({
            "routers": [{
                "protocol": "http", "label": "fp", "fastPath": True,
                "workers": 1, "dtab": "/svc => /#/io.l5d.fs ;",
                "servers": [{"port": 0}, {"port": 0, "tls": {
                    "certPath": cert, "keyPath": key}}],
                "connectionGuard": {"headerBudgetMs": 1000,
                                    "tunnelIdleMs": 2000},
                "streamScoring": {"action": "observe",
                                  "sampleEveryFrames": 2, "minGapMs": 0}}],
            "namers": [{"kind": "io.l5d.fs", "rootDir": str(tmp_path),
                        "pollIntervalSecs": 0.05}],
            "telemetry": [{"kind": "io.l5d.jaxAnomaly", "nativeTier": "off",
                           "trainEveryBatches": 0, "maxBatch": 32}]})
        linker = load_linker(text, device="cpu")
        router = linker.routers[0]
        ctl = router.controller
        ctl.stats_poll_s = 0.05
        await bounded(linker.start())
        tele = linker.telemeters[0]
        scored, consumed = [], []
        consume = tele.native_ring.consume

        def consuming(m):
            v = consume(m)
            consumed.append(v.copy())
            return v

        tele.native_ring.consume = consuming
        task = monitor(asyncio.create_task(tele.run()), what="telemeter")
        try:
            await until(lambda: tele._scorer is not None, "the scorer")
            score = tele._scorer.score

            async def scoring(x):
                s = await score(x)
                scored.append((np.array(x, copy=True), np.asarray(s)))
                return s

            tele._scorer.score = scoring
            clear, tls = router.server_ports
            slow = [asyncio.ensure_future(slow_head(clear))
                    for _ in range(2)]
            answers = {}
            for i in range(n):
                host = ("web", "api")[i % 2]
                answers.setdefault(host, set()).update([
                    await tls_get(clear, None, host),
                    await tls_get(tls, cert, host)])
            await asyncio.gather(tunnel(clear, 12), tunnel(tls, 12, cert))
            assert [await bounded(s, 20) for s in slow] == [b"", b""]
            await until(lambda: ctl.stream_sentinel.snapshot()["count"]
                        == 2 and not len(tele.native_ring)
                        and tele._requests.value >= 2 * n + 4
                        and tele._scored.value == tele._requests.value,
                        "every row scored", timeout=20)
            ctl._export_stats()
            stats = ctl.engine.stats()
            flat = linker.metrics.flatten()
            snap = tele._scorer.snapshot()
            sentinel = ctl.stream_sentinel.snapshot()
        finally:
            task.cancel()
            await asyncio.gather(task, return_exceptions=True)
            await bounded(linker.close())
            for s in (web, api):
                await bounded(s.close())
            ws.close()
        return answers, stats, flat, snap, scored, consumed, sentinel

    answers, stats, flat, snap, scored, consumed, sentinel = run(
        go(), timeout=90)
    # one answer a host whichever server carried it: TLS adds nothing
    assert {h: len(a) for h, a in answers.items()} == {"web": 1, "api": 1}
    # the TLS requests and one tunnel: n + 1 handshakes in the engine
    assert stats["tls"]["handshakes"] == n + 1
    assert stats["guard"]["slowloris_closed"] >= 2
    assert flat["rt/fp/fastpath/streams/tunnels_opened"] == 2
    assert flat["rt/fp/fastpath/guard/slowloris_closed"] >= 2
    rows = np.concatenate(consumed)
    tunnel_rows = int((rows[:, NATIVE_COL_KIND] == NATIVE_KIND_TUNNEL).sum())
    assert len(rows) - tunnel_rows == 2 * n  # a tunnel retires no request row
    assert tunnel_rows == sum(e["samples"] for e in
                              sentinel["by_stream"].values()) >= 4
    assert flat["anomaly/requests_total"] == flat["anomaly/scored_total"] \
        == len(rows)
    # the scorer's warm-up scores zero batches; every drained row once
    scored = [(x, s) for x, s in scored if x.any()]
    x = np.concatenate([x for x, _ in scored])
    got = np.concatenate([s for _, s in scored])
    assert len(got) == len(rows)
    want = jax_best_scores(snap, x)
    diff = np.abs(got - want)
    assert diff.max() <= BF16_SCORE_ATOL, diff.max()
    assert (diff > ATOL).mean() <= BF16_ROW_SHARE, (diff > ATOL).mean()
