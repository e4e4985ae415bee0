"""The port's admin server and handlers against the JAX package's, on the
same config and traffic, on the CPU; and TLS on the port's Python HTTP
router against the reference's.

Admin: both linkers are assembled as both CLIs assemble them (the admin
server, ``linkerd_admin_handlers``, every telemeter's handlers), with
each telemeter's recorder on a scripted clock and both scorers restored
from one snapshot, so both record and score the same rows. Then:
``/config.json``, ``/delegator.json``, ``/bound-names.json``,
``/identifier.json``, ``/logging.json``, ``/tenants.json`` and
``/streams.json`` are equal; ``/admin/metrics.json`` has the same keys
and equal deterministic counters; ``/anomaly.json`` scores agree within
the bf16 bounds (1e-3 every row, 1e-5 on all but 1%); ``/model.json``
and ``/control.json`` have the same keys; the handler list is the
reference's, ``/config-check.json`` included.

TLS: server termination, client origination with the commonName taken
from the path, and a wrong commonName answered 5xx, through both
routers (``tests/test_static_config_tls.py:166-255``).
"""

import asyncio
import json
import ssl
import subprocess
import time

import jax
import numpy as np
import pytest

from linkerd_tpu.admin.handlers import (
    linkerd_admin_handlers as ref_handlers,
)
from linkerd_tpu.admin.server import AdminServer as RefAdminServer
from linkerd_tpu.lifecycle import store as ref_store
from linkerd_tpu.linker import load_linker as ref_load_linker
from linkerd_tpu.protocol.http import Request, Response
from linkerd_tpu.protocol.http.client import HttpClient
from linkerd_tpu.protocol.http.server import HttpServer, serve
from linkerd_tpu.router.service import FnService
from linkerd_tpu.telemetry import anomaly as ref_anomaly
from linkerd_tpu_torch.admin.handlers import (
    linkerd_admin_handlers as port_handlers,
)
from linkerd_tpu_torch.admin.server import AdminServer as PortAdminServer
from linkerd_tpu_torch.lifecycle import store as port_store
from linkerd_tpu_torch.linker import load_linker as port_load_linker
from linkerd_tpu_torch.telemetry import anomaly as port_anomaly

ATOL = 1e-5            # bf16 bounds, ROADMAP Queue 3
BF16_SCORE_ATOL = 1e-3
BF16_ROW_SHARE = 0.01
ROUTES = ("web", "api", "db")


def run(coro, timeout=60):
    return asyncio.run(asyncio.wait_for(coro, timeout))


class Clock:
    """A scripted ``time`` module: ``monotonic`` reads ``now``, which the
    backend moves by a latency drawn from a seed; ``time`` is real."""

    def __init__(self, seed=0):
        self.now = 1000.0
        self.rng = np.random.default_rng(seed)

    def monotonic(self):
        return self.now

    def step(self, slow: bool) -> None:
        self.now += (30.0 + self.rng.uniform(0, 5) if slow
                     else self.rng.gamma(2.0, 0.5)) / 1e3

    @staticmethod
    def time():
        return time.time()


ADMIN_CONFIG = """
routers:
- protocol: http
  label: web
  dtab: |
    /svc => /#/io.l5d.fs ;
  servers: [{{port: 0}}]
  admissionControl: {{maxConcurrency: 64}}
  client:
    failureAccrual: {{kind: none}}
telemetry:
- kind: io.l5d.jaxAnomaly
  maxBatch: 256
  trainEveryBatches: 0
  control: {{}}
- kind: io.l5d.prometheus
namers:
- kind: io.l5d.fs
  rootDir: {disco}
admin:
  port: 0
usage: {{enabled: false}}
"""

GETS = ("/config.json", "/delegator.json?router=web&path=/svc/web",
        "/bound-names.json", "/identifier.json?host=api&path=/x",
        "/logging.json", "/tenants.json", "/streams.json",
        "/admin/metrics.json", "/admin/metrics.json?q=rt",
        "/admin/metrics.json?tree=true", "/metrics.json",
        "/anomaly.json", "/model.json", "/control.json",
        "/admin/metrics/prometheus", "/ping")


@pytest.fixture(scope="module")
def snap():
    """A snapshot both scorers restore: the reference's initial model."""
    s = ref_anomaly.InProcessScorer(devices=jax.devices()[:1])
    out = s.snapshot()
    s.close()
    return out


def admin_run(pkg: str, root, snap, monkeypatch):
    """``pkg``'s linker and admin server on ADMIN_CONFIG; 90 requests
    over three routes (every third answered slowly), one drained batch;
    returns every GET's status and body, and the handler paths."""
    # one directory for both packages, so their configs are the same text
    disco = root / "disco"
    disco.mkdir(exist_ok=True)
    clock = Clock()
    monkeypatch.setattr(ref_anomaly if pkg == "ref" else port_anomaly,
                        "time", clock)

    async def backend(req: Request) -> Response:
        clock.step(req.headers.get("x-slow") == "1")
        return Response(200, body=b"x" * 100)

    async def go():
        d = await serve(FnService(backend))
        for r in ROUTES:
            (disco / r).write_text(f"127.0.0.1 {d.bound_port}\n")
        text = ADMIN_CONFIG.format(disco=disco)
        if pkg == "ref":
            linker = ref_load_linker(text)
            scorer = ref_anomaly.InProcessScorer(devices=jax.devices()[:1])
            scorer.restore(snap)
            admin = RefAdminServer(linker.metrics, linker.config_dict,
                                   port=0)
            admin.add_handlers(ref_handlers(linker))
        else:
            linker = port_load_linker(text, device="cpu")
            scorer = port_anomaly.InProcessScorer(device="cpu")
            scorer.restore(port_store.decode_snapshot(
                ref_store.encode_snapshot(snap)))
            admin = PortAdminServer(linker.metrics, linker.config_dict,
                                    port=0)
            admin.add_handlers(port_handlers(linker))
        tele = linker._anomaly_telemeter()
        tele._scorer = scorer
        for t in linker.telemeters:
            admin.add_handlers(t.admin_handlers())
        await linker.start()
        await admin.start()
        proxy = HttpClient("127.0.0.1", linker.routers[0].server_ports[0])
        client = HttpClient("127.0.0.1", admin.bound_port)
        try:
            for i in range(90):
                req = Request(uri="/")
                req.headers.set("Host", ROUTES[i % 3])
                if i % 3 == 2:
                    req.headers.set("x-slow", "1")
                assert (await proxy(req)).status == 200
            assert await tele.drain_once() == 90
            out = {}
            for path in GETS:
                rsp = await client(Request(uri=path))
                out[path] = (rsp.status, rsp.body)
            return out, sorted(admin._handlers)
        finally:
            await proxy.close()
            await client.close()
            await admin.close()
            await linker.close()
            await d.close()

    return run(go())


@pytest.fixture(scope="module")
def both(tmp_path_factory, snap):
    mp = pytest.MonkeyPatch()
    try:
        root = tmp_path_factory.mktemp("admin")
        return {pkg: admin_run(pkg, root, snap, mp)
                for pkg in ("ref", "port")}
    finally:
        mp.undo()


EQUAL = ("/delegator.json?router=web&path=/svc/web", "/bound-names.json",
         "/identifier.json?host=api&path=/x", "/logging.json",
         "/tenants.json", "/streams.json", "/ping")


@pytest.mark.parametrize("path", EQUAL)
def test_endpoint_equal(both, path):
    assert both["port"][0][path] == both["ref"][0][path]
    assert both["port"][0][path][0] == 200


def test_config_json_equal(both):
    ref, port = (json.loads(both[p][0]["/config.json"][1])
                 for p in ("ref", "port"))
    assert port == ref
    assert port["routers"][0]["label"] == "web"


def test_tenants_and_streams_are_empty(both):
    for pkg in ("ref", "port"):
        for path in ("/tenants.json", "/streams.json"):
            assert json.loads(both[pkg][0][path][1]) == {}


DETERMINISTIC = ("/requests", "/success", "/failures", "/status/200",
                 "requests_total", "scored_total", "batches",
                 "scored_fraction", "dropped_batches", "score_failures")


@pytest.mark.parametrize("path", ["/admin/metrics.json",
                                  "/admin/metrics.json?q=rt"])
def test_metrics_keys_and_counters_equal(both, path):
    ref, port = (json.loads(both[p][0][path][1]) for p in ("ref", "port"))
    assert sorted(port) == sorted(ref)
    counted = {k: v for k, v in port.items() if k.endswith(DETERMINISTIC)}
    assert counted == {k: ref[k] for k in counted}
    if path.endswith("=rt"):
        assert port["rt/web/server/requests"] == 90
        assert all(k.startswith("rt") for k in port)
    else:
        assert port["anomaly/scored_total"] == 90


def key_paths(tree, prefix=()):
    """Every path of keys in a nested dict."""
    if not isinstance(tree, dict):
        return {prefix}
    return set().union(*(key_paths(v, prefix + (k,))
                         for k, v in tree.items())) | {prefix}


def test_metrics_tree_and_alias_equal(both):
    """``?tree=true`` nests the same keys in both packages, and
    ``/metrics.json`` is ``/admin/metrics.json``'s alias."""
    ref, port = (json.loads(both[p][0]["/admin/metrics.json?tree=true"][1])
                 for p in ("ref", "port"))
    assert key_paths(port) == key_paths(ref)
    for pkg in ("ref", "port"):
        alias = json.loads(both[pkg][0]["/metrics.json"][1])
        flat = json.loads(both[pkg][0]["/admin/metrics.json"][1])
        assert sorted(alias) == sorted(flat)


def test_prometheus_names_equal(both):
    ref, port = (both[p][0]["/admin/metrics/prometheus"][1].decode()
                 for p in ("ref", "port"))
    names = [{ln.split(" ")[0] for ln in t.splitlines()} for t in (ref, port)]
    assert names[1] == names[0]
    assert 'requests{rt="web"} 90' in port.splitlines()


def test_anomaly_scores_within_bf16_bounds(both):
    ref, port = (json.loads(both[p][0]["/anomaly.json"][1])
                 for p in ("ref", "port"))
    assert sorted(port) == sorted(ref)
    assert sorted(port["scores"]) == sorted(ref["scores"]) == [
        f"/svc/{r}" for r in sorted(ROUTES)]
    a = np.array([port["scores"][k] for k in sorted(port["scores"])])
    b = np.array([ref["scores"][k] for k in sorted(port["scores"])])
    diff = np.abs(a - b)
    assert diff.max() <= BF16_SCORE_ATOL, diff
    assert (diff > ATOL).mean() <= BF16_ROW_SHARE or len(diff) < 100
    assert {k: v for k, v in port.items() if k != "scores"} == \
        {k: v for k, v in ref.items() if k != "scores"}


@pytest.mark.parametrize("path", ["/model.json", "/control.json"])
def test_state_keys_equal(both, path):
    ref, port = (json.loads(both[p][0][path][1]) for p in ("ref", "port"))
    assert both["port"][0][path][0] == 200
    assert sorted(port) == sorted(ref)


def test_handler_list_is_the_reference_less_config_check(both):
    """Since the port's own config check, nothing is less: the port
    serves every handler of the reference's list, /config-check.json
    included."""
    ref, port = both["ref"][1], both["port"][1]
    assert set(ref) == set(port)
    assert "/config-check.json" in port


# -- TLS on the Python router ---------------------------------------------


@pytest.fixture(scope="module")
def certs(tmp_path_factory):
    """Self-signed cert for CN=web (SAN web, localhost), as the
    reference's TLS tests mint it."""
    d = tmp_path_factory.mktemp("certs")
    cert, key = d / "cert.pem", d / "key.pem"
    subprocess.run(
        ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
         "-keyout", str(key), "-out", str(cert), "-days", "2",
         "-subj", "/CN=web",
         "-addext", "subjectAltName=DNS:web,DNS:localhost,IP:127.0.0.1"],
        check=True, capture_output=True)
    return str(cert), str(key)


TLS_CASES = {
    # the router speaks TLS to the downstream, verifying against the CA
    # with the commonName captured from the client prefix
    "client_cn_substitution": ("""
  servers: [{{port: 0}}]
  client:
    kind: io.l5d.static
    configs:
    - prefix: "/#/io.l5d.fs/{{service}}"
      tls:
        commonName: "{{service}}"
        trustCerts: ["{cert}"]
""", True, False),
    # the router terminates TLS
    "server_terminates": ("""
  servers:
  - port: 0
    tls:
      certPath: "{cert}"
      keyPath: "{key}"
""", False, True),
    # a wrong commonName fails the handshake: a 5xx from the router
    "wrong_common_name": ("""
  servers: [{{port: 0}}]
  client:
    tls:
      commonName: "not-the-right-name"
      trustCerts: ["{cert}"]
""", True, False),
}


def tls_run(pkg: str, case: str, certs, root):
    cert, key = certs
    block, tls_down, tls_front = TLS_CASES[case]
    disco = root / f"{pkg}-{case}"
    disco.mkdir()
    text = ("routers:\n- protocol: http\n  label: tls\n  dtab: |\n"
            "    /svc => /#/io.l5d.fs ;\n"
            + block.format(cert=cert, key=key)
            + f"namers:\n- kind: io.l5d.fs\n  rootDir: {disco}\n")

    async def handler(req: Request) -> Response:
        return Response(200, body=b"secure-web" if tls_down
                        else b"plain-web")

    async def go():
        if tls_down:
            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ctx.load_cert_chain(cert, key)
            down = HttpServer(FnService(handler), ssl_context=ctx)
            await down.start()
        else:
            down = await serve(FnService(handler))
        (disco / "web").write_text(f"127.0.0.1 {down.bound_port}\n")
        linker = (ref_load_linker(text) if pkg == "ref"
                  else port_load_linker(text, device="cpu"))
        await linker.start()
        cctx = None
        if tls_front:
            cctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
            cctx.load_verify_locations(cafile=cert)
        proxy = HttpClient("127.0.0.1", linker.routers[0].server_ports[0],
                           ssl_context=cctx,
                           server_hostname="web" if tls_front else None)
        try:
            req = Request(uri="/")
            req.headers.set("Host", "web")
            r = await proxy(req)
            flat = linker.metrics.flatten()
            return (r.status // 100, r.body if r.status == 200 else b"",
                    flat["rt/tls/server/requests"])
        finally:
            await proxy.close()
            await linker.close()
            await down.close()

    return run(go())


@pytest.mark.parametrize("case", sorted(TLS_CASES))
def test_tls_matches_reference(case, certs, tmp_path):
    ref, port = (tls_run(pkg, case, certs, tmp_path)
                 for pkg in ("ref", "port"))
    assert port == ref
    want = {"client_cn_substitution": (2, b"secure-web", 1),
            "server_terminates": (2, b"plain-web", 1),
            "wrong_common_name": (5, b"", 1)}[case]
    assert port == want
