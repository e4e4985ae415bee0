"""The port's CLIs, ``python -m linkerd_tpu_torch`` and ``python -m
linkerd_tpu_torch.namerd``, run as users run them, on the CPU.

- The linkerd CLI with ``--device cpu`` boots ``tests/configs/linker-http.yml``
  and ``tests/configs/linker-anomaly.yml`` (copied with free ports, the
  namer's and lifecycle's directories under a temporary directory and
  ``usage`` off; the fixtures themselves are not edited), routes a
  request, answers ``/ping`` and exits 0 on SIGTERM.
- A bad argv prints the usage line and exits 64, as the reference's CLI
  does; without ``--device cpu`` on a host with no CUDA device the CLI
  exits non-zero with a message and serves nothing.
- ``linker-anomaly.yml`` loads to equal telemeter configs in both
  packages, the sidecar's keys included (its breaker keys inert with no
  ``sidecarAddress``, in both).
- The namerd CLI on ``tests/configs/namerd.yml`` less its mesh and thrift
  interfaces answers the HTTP API and its admin pages as the
  reference's namerd CLI does; on the whole fixture it serves all three
  interfaces, its thrift interface answering a dtab call as the
  reference's does (the mesh interface: ``tests/test_torch_mesh.py``;
  the thrift one: ``tests/test_torch_namerd_thrift.py``).
"""

import dataclasses
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import pytest
import yaml

ROOT = Path(__file__).resolve().parent.parent
CONFIGS = ROOT / "tests" / "configs"
BOOT_S = 60.0


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def env():
    e = dict(os.environ)
    e["PYTHONPATH"] = str(ROOT) + os.pathsep + e.get("PYTHONPATH", "")
    return e


def spawn(module: str, *args, cwd=None):
    return subprocess.Popen(
        [sys.executable, "-m", module, *map(str, args)], cwd=cwd, env=env(),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def http(method: str, port: int, path: str, body: bytes = None,
         headers=None):
    """(status, body) of one request, 5xx and 4xx included."""
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=body, method=method,
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=10) as rsp:
            return rsp.status, rsp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def wait_ping(proc, port: int) -> float:
    """Seconds until ``/ping`` answers pong; fails if ``proc`` exits."""
    t0 = time.monotonic()
    while time.monotonic() - t0 < BOOT_S:
        if proc.poll() is not None:
            raise AssertionError(f"exited {proc.returncode}: "
                                 f"{proc.stderr.read()[-3000:]}")
        try:
            if http("GET", port, "/ping") == (200, b"pong"):
                return time.monotonic() - t0
        except OSError:
            pass
        time.sleep(0.1)
    raise AssertionError(f"no /ping on {port} after {BOOT_S} s")


def stop(proc) -> int:
    proc.send_signal(signal.SIGTERM)
    try:
        return proc.wait(timeout=10)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


class Backend:
    """A threaded HTTP backend answering its name, in this process."""

    def __init__(self, name: bytes):
        class H(BaseHTTPRequestHandler):
            def do_GET(self):
                self.send_response(200)
                self.send_header("Content-Length", str(len(name)))
                self.end_headers()
                self.wfile.write(name)

            def log_message(self, *a):
                pass

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), H)
        self.port = self.server.server_address[1]
        threading.Thread(target=self.server.serve_forever,
                         daemon=True).start()

    def close(self):
        self.server.shutdown()
        self.server.server_close()


def fixture_copy(name: str, tmp: Path) -> tuple:
    """The fixture as JSON under ``tmp``, with free ports, its directories
    under ``tmp`` and usage off; returns (path, router port, admin port,
    config)."""
    cfg = yaml.safe_load((CONFIGS / name).read_text())
    router_port, admin_port = free_port(), free_port()
    cfg["routers"][0]["servers"][0]["port"] = router_port
    cfg["admin"]["port"] = admin_port
    cfg["namers"][0]["rootDir"] = str(tmp / "disco")
    for t in cfg.get("telemetry", []):
        if "lifecycle" in t:
            t["lifecycle"]["directory"] = str(tmp / "ckpt")
    cfg["usage"] = {"enabled": False}
    (tmp / "disco").mkdir()
    path = tmp / name.replace(".yml", ".json")
    path.write_text(json.dumps(cfg))
    return path, router_port, admin_port, cfg


@pytest.mark.parametrize("name", ["linker-http.yml", "linker-anomaly.yml"])
def test_cli_boots_a_fixture_routes_and_stops(name, tmp_path):
    path, router_port, admin_port, cfg = fixture_copy(name, tmp_path)
    backend = Backend(b"cli-web")
    try:
        (tmp_path / "disco" / "web").write_text(
            f"127.0.0.1 {backend.port}\n")
        proc = spawn("linkerd_tpu_torch", "--device", "cpu", path,
                     cwd=tmp_path)
        try:
            wait_ping(proc, admin_port)
            assert http("GET", router_port, "/",
                        headers={"Host": "web"}) == (200, b"cli-web")
            assert json.loads(http("GET", admin_port, "/config.json")[1]) \
                == cfg
            flat = json.loads(http("GET", admin_port,
                                   "/admin/metrics.json?q=rt")[1])
            label = cfg["routers"][0]["label"]
            assert flat[f"rt/{label}/server/requests"] == 1
            if "telemetry" in cfg:
                model = json.loads(http("GET", admin_port,
                                        "/model.json")[1])
                assert model["lifecycle_enabled"] is True
        finally:
            rc = stop(proc)
        err = proc.stderr.read()
        assert rc == 0, err[-3000:]
        assert "shutting down" in err
    finally:
        backend.close()


USAGE = {"linkerd_tpu": "usage: python -m linkerd_tpu <config.yaml>",
         "linkerd_tpu_torch": "usage: python -m linkerd_tpu_torch "
                              "[--device cpu] <config.yaml>"}


@pytest.mark.parametrize("module, argv", [
    ("linkerd_tpu", []), ("linkerd_tpu_torch", []),
    ("linkerd_tpu_torch", ["a.yml", "b.yml"]),
    ("linkerd_tpu_torch", ["--device", "cpu"])])
def test_cli_bad_argv_prints_usage_and_exits_64(module, argv):
    """The reference's usage line and code for a missing or an extra
    argument; the port's line names the port and its option."""
    proc = subprocess.run([sys.executable, "-m", module, *argv], env=env(),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 64, proc.stderr
    assert proc.stderr.strip().splitlines()[-1] == USAGE[module]


def test_cli_without_a_card_fails_and_serves_nothing(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid")
    path, _router_port, admin_port, _ = fixture_copy("linker-http.yml",
                                                     tmp_path)
    proc = subprocess.run([sys.executable, "-m", "linkerd_tpu_torch", path],
                          env=env(), capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr and "--device cpu" in proc.stderr
    with pytest.raises(OSError):
        http("GET", admin_port, "/ping")


def test_anomaly_fixture_loads_to_equal_configs(tmp_path):
    """Both packages load linker-anomaly.yml (ports and directories
    rewritten) to equal telemeter configs, the sidecar's keys at their
    defaults; the breaker keys are taken and inert in both."""
    from linkerd_tpu.linker import load_linker as ref_load_linker
    from linkerd_tpu_torch.linker import load_linker as port_load_linker
    from linkerd_tpu_torch.telemetry.anomaly import REFUSED_KEYS

    path, *_ = fixture_copy("linker-anomaly.yml", tmp_path)
    text = path.read_text()
    ref, port = ref_load_linker(text), port_load_linker(text, device="cpu")
    try:
        r = dataclasses.asdict(ref.telemeters[0].cfg)
        p = dataclasses.asdict(port.telemeters[0].cfg)
        assert not REFUSED_KEYS
        assert p == r
        assert p["breakerFailures"] == 3 and p["scoreTimeoutMs"] == 2000
        assert (p["sidecarAddress"], p["sidecarTier"]) == (None, "fallback")
        assert port.config_dict == ref.config_dict
    finally:
        for lk in (ref, port):
            for t in lk.telemeters:
                t.close()


# -- namerd ----------------------------------------------------------------


def namerd_config(tmp: Path, ifaces=("io.l5d.httpController",)) -> tuple:
    cfg = yaml.safe_load((CONFIGS / "namerd.yml").read_text())
    cfg["interfaces"] = [dict(i, port=free_port()) for i in cfg["interfaces"]
                         if i["kind"] in ifaces]
    cfg["admin"]["port"] = free_port()
    cfg["namers"][0]["rootDir"] = str(tmp / "disco")
    (tmp / "disco").mkdir(parents=True, exist_ok=True)
    (tmp / "disco" / "web").write_text("127.0.0.1 7001\n")
    path = tmp / f"namerd-{cfg['admin']['port']}.json"
    path.write_text(json.dumps(cfg))
    return path, cfg["interfaces"][0]["port"], cfg["admin"]["port"]


NAMERD_CALLS = (
    ("GET", "/api/1/dtabs", None),
    ("GET", "/api/1/dtabs/default", None),
    ("POST", "/api/1/dtabs/extra", b"/svc => /#/io.l5d.fs/web ;"),
    ("GET", "/api/1/dtabs", None),
    ("GET", "/api/1/dtabs/extra", None),
    ("GET", "/api/1/bind/default?path=/svc/web", None),
    ("GET", "/api/1/addr/default?path=/svc/web", None),
    ("GET", "/api/1/delegate/default?path=/svc/web", None),
    ("GET", "/api/1/dtabs/nope", None),
    ("DELETE", "/api/1/dtabs/extra", None),
    ("GET", "/api/1/dtabs", None),
)
ADMIN_CALLS = ("/ping", "/dtabs?format=json", "/dtabs/default?format=json",
               "/config.json")


def namerd_session(module: str, tmp: Path) -> list:
    path, api, admin = namerd_config(tmp)
    proc = spawn(module, path, cwd=tmp)
    try:
        wait_ping(proc, admin)
        out = []
        for method, p, body in NAMERD_CALLS:
            headers = {"Content-Type": "application/dtab"} if body else {}
            out.append((method, p, *http(method, api, p, body, headers)))
        for p in ADMIN_CALLS:
            status, b = http("GET", admin, p)
            if p == "/config.json":  # its ports are this run's own
                b = sorted(json.loads(b))
            out.append(("GET", p, status, b))
        keys = sorted(json.loads(http("GET", admin, "/metrics.json")[1]))
    finally:
        rc = stop(proc)
    assert rc == 0, proc.stderr.read()[-3000:]
    return out + [keys]


def test_namerd_cli_answers_as_the_reference(tmp_path):
    ref = namerd_session("linkerd_tpu.namerd", tmp_path / "ref")
    port = namerd_session("linkerd_tpu_torch.namerd", tmp_path / "port")
    assert port == ref
    assert [c[2] for c in port[:len(NAMERD_CALLS)]] == [
        200, 200, 204, 200, 200, 200, 200, 200, 404, 204, 200]


@pytest.mark.parametrize("kind", ["io.l5d.thriftNameInterpreter"])
def test_namerd_refuses_unported_interfaces_by_name(kind, tmp_path):
    """No interface kind is refused any more: the thrift interface,
    refused by name until the port took it, builds to the reference's
    config, field for field."""
    import linkerd_tpu.namerd.config as ref_config
    from linkerd_tpu_torch.namerd.config import (
        UNPORTED_KINDS, NamerdProcess, parse_namerd_spec,
    )

    assert UNPORTED_KINDS["namerdIface"] == {}
    path, *_ = namerd_config(tmp_path, ("io.l5d.httpController", kind))
    text = path.read_text()
    port = NamerdProcess(parse_namerd_spec(text))
    ref = ref_config.NamerdProcess(ref_config.parse_namerd_spec(text))
    got = [(type(c).__name__, dataclasses.asdict(c))
           for c in port._iface_cfgs]
    assert got == [(type(c).__name__, dataclasses.asdict(c))
                   for c in ref._iface_cfgs]
    assert got[1][0] == "ThriftIfaceConfig"


@pytest.mark.parametrize("kind", ["io.l5d.zk", "io.l5d.etcd",
                                  "io.l5d.consul", "io.l5d.k8s"])
def test_namerd_refuses_unported_stores_by_name(kind):
    from linkerd_tpu_torch.config import ConfigError
    from linkerd_tpu_torch.namerd.config import (
        NamerdProcess, parse_namerd_spec,
    )

    text = json.dumps({"storage": {"kind": kind},
                       "interfaces": [{"kind": "io.l5d.httpController"}]})
    with pytest.raises(ConfigError, match=f"'{kind}'.*item 15"):
        NamerdProcess(parse_namerd_spec(text))


def test_namerd_unported_kinds_are_the_reference_kinds():
    import linkerd_tpu.namerd.config  # noqa: F401 — registers its kinds
    from linkerd_tpu.config import kinds as ref_kinds
    from linkerd_tpu_torch.config import kinds as port_kinds
    from linkerd_tpu_torch.namerd.config import UNPORTED_KINDS

    for cat in ("namerdIface", "dtabStore"):
        unported = UNPORTED_KINDS[cat]
        assert not set(port_kinds(cat)) & set(unported)
        assert sorted(set(port_kinds(cat)) | set(unported)) == \
            sorted(ref_kinds(cat))


def thrift_dtab_call(port: int, module: str) -> str:
    """The namespace ``default``'s dtab through a namerd's thrift
    interface, read with ``module``'s client (run in a child, as a
    linkerd would read it)."""
    code = (
        "import asyncio\n"
        f"from {module}.interpreter.namerd_thrift import _decode_reply, "
        "_encode_call\n"
        f"from {module}.namerd import thrift_idl as idl\n"
        f"from {module}.protocol.thrift.client import ThriftClient\n"
        f"from {module}.protocol.thrift.codec import CALL, ThriftCall\n"
        "async def go():\n"
        f"    c = ThriftClient('127.0.0.1', {port})\n"
        "    p = _encode_call('dtab', 1, idl.DtabReq(stamp=b'', "
        "ns='default', clientId=[b't']))\n"
        "    r = await c(ThriftCall(payload=p, name='dtab', seqid=1, "
        "type=CALL))\n"
        "    await c.close()\n"
        "    print(_decode_reply(r, idl.DtabRef, idl.DtabFailure).dtab)\n"
        "asyncio.run(go())\n")
    out = subprocess.run([sys.executable, "-c", code], env=env(),
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout.strip()


def test_namerd_cli_refuses_the_fixture_with_mesh_and_thrift(tmp_path):
    """The whole fixture, refused until the port took the thrift
    interface, now serves: /ping answers, and the thrift interface
    answers the dtab call with the reference namerd CLI's answer."""
    answers = []
    for module in ("linkerd_tpu.namerd", "linkerd_tpu_torch.namerd"):
        d = tmp_path / module
        path, _, admin = namerd_config(
            d, ("io.l5d.httpController", "io.l5d.mesh",
                "io.l5d.thriftNameInterpreter"))
        thrift_port = next(i["port"] for i in json.loads(
            path.read_text())["interfaces"]
            if i["kind"] == "io.l5d.thriftNameInterpreter")
        proc = spawn(module, path, cwd=d)
        try:
            wait_ping(proc, admin)
            answers.append(thrift_dtab_call(
                thrift_port, module.split(".")[0]))
        finally:
            rc = stop(proc)
        assert rc == 0, proc.stderr.read()[-3000:]
    assert answers[1] == answers[0]
    assert "/svc=>/srv" in answers[1].replace(" ", "")
