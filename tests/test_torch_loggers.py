"""The request loggers (``loggers:``) and ``httpAccessLog`` on the port
against the JAX package's, on the CPU, through a linker of each package
on the same config and traffic:

- ``io.l5d.http.file``: one JSON line a request that reached a client,
  equal apart from ``ts`` and ``latency_ms`` (the counterpart of
  ``tests/test_http_filters.py::TestRequestLoggers``);
- ``io.l5d.http.debug``: the same log records apart from the latency;
- ``httpAccessLog``: one Common Log Format line a request the server
  answered, equal apart from the timestamp;
- ``io.l5d.k8s.istio``, the istio logger kind: one mixer report a
  response, equal apart from ``response.duration`` (the counterpart of
  ``tests/test_istio.py::TestIstioLoggerPlugin``), on http and h2;
- the refusals: ``io.l5d.http.*`` on an h2 router, loggers with
  ``fastPath: true``; and the sinks' threads stop with the linker.
"""

import asyncio
import importlib
import json
import logging
import re
import threading

import pytest

from tests.test_torch_istio import start_mixer, without_duration

PKGS = {"ref": "linkerd_tpu", "port": "linkerd_tpu_torch"}


def mod(pkg: str, name: str):
    return importlib.import_module(f"{PKGS[pkg]}.{name}")


def run(coro, timeout=30):
    return asyncio.run(asyncio.wait_for(coro, timeout))


def load(pkg: str, text: str):
    linker = mod(pkg, "linker")
    return (linker.load_linker(text, device="cpu") if pkg == "port"
            else linker.load_linker(text))


SENT = [("web", "/things"), ("web", "/fail"), ("ghost", "/nowhere"),
        ("web", "/q?x=1")]


async def drive(pkg: str, tmp_path, router_extra: str):
    """A router of ``pkg`` with ``router_extra`` over an fs namer, one
    backend answering 503 on /fail; the requests of ``SENT`` in turn.
    Returns the statuses and the linker's metrics, after closing it."""
    http = mod(pkg, "protocol.http")
    server = mod(pkg, "protocol.http.server")
    client = mod(pkg, "protocol.http.client")
    service = mod(pkg, "router.service")

    async def handler(req):
        return http.Response(status=503 if "fail" in req.uri else 200,
                             body=b"hello")
    backend = await server.serve(service.FnService(handler))
    disco = tmp_path / f"disco-{pkg}"
    disco.mkdir(exist_ok=True)
    (disco / "web").write_text(f"127.0.0.1 {backend.bound_port}\n")
    linker = load(pkg, f"""
routers:
- protocol: http
  label: lg
  dtab: |
    /svc => /#/io.l5d.fs ;
  client: {{failureAccrual: {{kind: none}}}}
  servers: [{{port: 0}}]
{router_extra}
namers:
- kind: io.l5d.fs
  rootDir: {disco}
""")
    await linker.start()
    proxy = client.HttpClient("127.0.0.1", linker.routers[0].server_ports[0])
    statuses = []
    try:
        for host, uri in SENT:
            req = http.Request(uri=uri)
            req.headers.set("Host", host)
            statuses.append((await proxy(req)).status)
        flat = linker.metrics.flatten()
    finally:
        await proxy.close()
        await linker.close()
        await backend.close()
    return statuses, flat


def test_file_logger_lines_alike(tmp_path):
    """One line a request that reached a client; the unrouted one has
    none. Closing the linker flushes and closes the sink."""
    out = {}
    for pkg in PKGS:
        path = tmp_path / f"req-{pkg}.log"
        statuses, flat = run(drive(pkg, tmp_path, (
            f"  loggers:\n  - kind: io.l5d.http.file\n    path: {path}\n")))
        lines = [json.loads(ln) for ln in path.read_text().splitlines()]
        for ln in lines:
            assert ln.pop("ts") > 0 and ln.pop("latency_ms") >= 0
        out[pkg] = statuses, lines, flat["rt/lg/client/#.io.l5d.fs.web/"
                                         "requests"]
    assert out["port"] == out["ref"]
    statuses, lines, client_requests = out["port"]
    assert statuses == [200, 503, 400, 200]
    assert len(lines) == client_requests == 3
    assert lines[0] == {"method": "GET", "uri": "/things",
                        "dst": "/svc/web", "status": 200}


class Capture(logging.Handler):
    def __init__(self):
        super().__init__(logging.DEBUG)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def test_debug_logger_records_alike(tmp_path):
    out = {}
    for pkg in PKGS:
        name = f"edge.reqlog.{pkg}"
        cap = Capture()
        logger = logging.getLogger(name)
        logger.addHandler(cap)
        logger.setLevel(logging.INFO)
        try:
            statuses, _ = run(drive(pkg, tmp_path, (
                f"  loggers:\n  - {{kind: io.l5d.http.debug, level: INFO, "
                f"logger: {name}}}\n")))
        finally:
            logger.removeHandler(cap)
        out[pkg] = statuses, [re.sub(r"\(\d+\.\d+ms\)$", "(ms)", ln)
                              for ln in cap.lines]
    assert out["port"] == out["ref"]
    assert out["port"][1] == ["GET /things dst=/svc/web -> 200 (ms)",
                              "GET /fail dst=/svc/web -> 503 (ms)",
                              "GET /q?x=1 dst=/svc/web -> 200 (ms)"]
    with pytest.raises(mod("port", "config").ConfigError,
                       match="bad level"):
        load("port", "routers:\n- protocol: http\n  loggers:\n"
                     "  - {kind: io.l5d.http.debug, level: LOUD}\n")


def test_access_log_lines_alike(tmp_path):
    """One line a request the server answered, the unrouted one
    included, equal apart from the timestamp."""
    out = {}
    for pkg in PKGS:
        path = tmp_path / f"access-{pkg}.log"
        statuses, flat = run(drive(pkg, tmp_path,
                                   f"  httpAccessLog: {path}\n"))
        lines = [re.sub(r"\[[^\]]+\]", "[ts]", ln)
                 for ln in path.read_text().splitlines()]
        out[pkg] = statuses, lines, flat["rt/lg/server/requests"]
    assert out["port"] == out["ref"]
    statuses, lines, served = out["port"]
    assert len(lines) == served == len(SENT)
    assert lines[0] == '127.0.0.1 - - [ts] "GET /things HTTP/1.1" 200 5'
    assert lines[2].endswith(" 400 " + lines[2].rsplit(" ", 1)[1])


async def istio_reports(pkg: str, tmp_path, protocol: str):
    """``loggers: [{kind: io.l5d.k8s.istio}]`` on an http or h2 router,
    to a mixer of the same package: the statuses and the reports."""
    mixer, reports = await start_mixer(pkg)
    service = mod(pkg, "router.service")
    disco = tmp_path / f"istio-{protocol}-{pkg}"
    disco.mkdir()
    if protocol == "http":
        http = mod(pkg, "protocol.http")

        async def ok(req):
            return http.Response(status=503 if "fail" in req.uri else 200,
                                 body=b"hi")
        backend = await mod(pkg, "protocol.http.server").serve(
            service.FnService(ok))
    else:
        h2m = mod(pkg, "protocol.h2.messages")

        async def ok(req):
            return h2m.H2Response(status=503 if "fail" in req.path else 200,
                                  body=b"hi")
        backend = await mod(pkg, "protocol.h2.server").H2Server(
            service.FnService(ok)).start()
    (disco / "web").write_text(f"127.0.0.1 {backend.bound_port}\n")
    linker = load(pkg, f"""
routers:
- protocol: {protocol}
  label: mix
  loggers:
  - kind: io.l5d.k8s.istio
    mixerHost: 127.0.0.1
    mixerPort: {mixer.bound_port}
  dtab: |
    /svc => /#/io.l5d.fs ;
  servers: [{{port: 0}}]
namers:
- kind: io.l5d.fs
  rootDir: {disco}
""")
    await linker.start()
    port = linker.routers[0].server_ports[0]
    statuses = []
    try:
        if protocol == "http":
            http = mod(pkg, "protocol.http")
            proxy = mod(pkg, "protocol.http.client").HttpClient(
                "127.0.0.1", port)
            for uri in ("/api", "/fail", "/x"):
                req = http.Request(uri=uri)
                req.headers.set("Host", "web")
                statuses.append((await proxy(req)).status)
        else:
            proxy = mod(pkg, "protocol.h2.client").H2Client("127.0.0.1", port)
            for uri in ("/api", "/fail", "/x"):
                rsp = await proxy(h2m.H2Request(method="GET", path=uri,
                                                authority="web"))
                await rsp.stream.read_all()
                statuses.append(rsp.status)
        loop = asyncio.get_running_loop()
        t0 = loop.time()
        while len(reports) < 3 and loop.time() - t0 < 10:
            await asyncio.sleep(0.02)
        return statuses, [without_duration(pkg, r) for r in reports]
    finally:
        await proxy.close()
        await linker.close()
        await backend.close()
        await mixer.close()


@pytest.mark.parametrize("protocol", ["http", "h2"])
def test_istio_logger_reports_alike(protocol, tmp_path):
    out = {pkg: run(istio_reports(pkg, tmp_path, protocol))
           for pkg in PKGS}
    assert out["port"] == out["ref"]
    statuses, reports = out["port"]
    assert statuses == [200, 503, 200] and len(reports) == 3


REFUSED = {
    "http.file on h2": ("routers:\n- protocol: h2\n  loggers:\n"
                        "  - {kind: io.l5d.http.file, path: /dev/null}\n"),
    "http.debug on h2": ("routers:\n- protocol: h2\n  loggers:\n"
                         "  - {kind: io.l5d.http.debug}\n"),
    "loggers with fastPath": (
        "routers:\n- protocol: http\n  fastPath: true\n  loggers:\n"
        "  - {kind: io.l5d.http.debug}\n"),
    "file logger without path": ("routers:\n- protocol: http\n  loggers:\n"
                                 "  - {kind: io.l5d.http.file}\n"),
    "loggers not a list": ("routers:\n- protocol: http\n"
                           "  loggers: {kind: io.l5d.http.debug}\n"),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_logger_refusals_alike(case):
    out = {}
    for pkg in PKGS:
        with pytest.raises(Exception) as e:
            load(pkg, REFUSED[case])
        assert type(e.value).__name__ == "ConfigError"
        out[pkg] = str(e.value)
    assert out["port"] == out["ref"]


def test_sinks_stop_with_the_linker(tmp_path):
    """The file logger's and the access log's listener threads stop when
    the linker closes, and a load that fails after building them stops
    them too."""
    def listeners():
        return sum(t.name.startswith("Thread") and "_monitor" in str(
            getattr(t, "_target", "")) for t in threading.enumerate())

    before = listeners()
    text = (f"routers:\n- protocol: http\n  servers: [{{port: 0}}]\n"
            f"  httpAccessLog: {tmp_path / 'a.log'}\n  loggers:\n"
            f"  - {{kind: io.l5d.http.file, path: {tmp_path / 'f.log'}}}\n")
    linker = load("port", text)
    assert listeners() == before + 2
    run(linker.close())
    assert listeners() == before
    with pytest.raises(mod("port", "config").ConfigError):
        load("port", text + "- protocol: http\n  servers: [{port: 0}]\n"
                            "  tenants: {floor: 2}\n"
                            "  tenantIdentifier: {kind: header}\n")
    assert listeners() == before
