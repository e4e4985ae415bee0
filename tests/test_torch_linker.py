"""The port's ``load_linker`` against the JAX package's on the same
configs, with real sockets on the CPU.

- The six scenarios of ``tests/test_router_e2e.py`` (host routing with
  a rebind, a weighted union, alt failover, the ``l5d-dtab`` header,
  ``/$/inet``, config errors) through both linkers, each with its own
  backends: every response's status and body, the ``l5d-dst-*``
  headers the backend saw, and the ``rt/*`` metric keys (and request
  counts) are equal; config errors carry the same text.
- What the port does not take yet is refused by name, one case a key.
- The reference's ``test_end_to_end_scoring_and_auc`` protocol on the
  port's linker with ``device="cpu"``: scored fraction 1.0, the faulted
  destination's score rises, AUC >= 0.9; the window's rows scored by the
  JAX scorer (``xla_allow_excess_precision`` off) and by the port from
  the same weights agree within the bf16 bounds: 1e-5 on all but 1% of
  rows and 1e-3 on every row.
- ``io.l5d.jaxAnomaly`` failure accrual ejects a failing endpoint after
  the same number of failures through both routers.
"""

import asyncio
import dataclasses

import jax
import numpy as np
import pytest

from linkerd_tpu.config import ConfigError as RefConfigError
from linkerd_tpu.linker import load_linker as ref_load_linker
from linkerd_tpu.models import anomaly as jax_model
from linkerd_tpu.ops import scoring as jax_scoring
from linkerd_tpu.protocol.http import Request, Response
from linkerd_tpu.protocol.http.client import HttpClient
from linkerd_tpu.protocol.http.server import serve
from linkerd_tpu.router.service import FnService
from linkerd_tpu.testing.faults import FaultInjector, FaultSpec
from linkerd_tpu_torch.config import ConfigError
from linkerd_tpu_torch.lifecycle.promote import auc
from linkerd_tpu_torch.linker import (
    REFUSED_PROTOCOLS, REFUSED_ROUTER_KEYS, UNPORTED_KINDS,
    load_linker as port_load_linker,
)
from linkerd_tpu_torch.models.convert import params_to_numpy
from linkerd_tpu_torch.models.features import featurize_batch

ATOL = 1e-5            # bf16 bounds, ROADMAP Queue 3
BF16_SCORE_ATOL = 1e-3
BF16_ROW_SHARE = 0.01


def load(pkg: str, text: str):
    return (port_load_linker(text, device="cpu") if pkg == "port"
            else ref_load_linker(text))


def run(coro, timeout=60):
    return asyncio.run(asyncio.wait_for(coro, timeout))


def downstream(name: str, seen: list):
    """A backend answering its name, keeping the l5d-dst-* headers of
    every request it serves."""
    async def handler(req: Request) -> Response:
        seen.append((name, sorted((k.lower(), v) for k, v in req.headers
                                  if k.lower().startswith("l5d-dst-"))))
        return Response(status=200, body=name.encode())

    return FnService(handler)


def counted_metrics(linker) -> dict:
    """The ``rt/*`` keys, with the values of the counts that do not
    depend on timing."""
    flat = linker.metrics.flatten()
    ends = ("/requests", "/success", "/failures", "/total",
            "/budget_exhausted", "/deadline_skipped", "/expired_at_edge")
    return {k: (v if k.endswith(ends) or "/status/" in k else None)
            for k, v in flat.items() if k.startswith("rt/")}


async def send(proxy, host: str, **headers):
    req = Request(uri="/")
    req.headers.set("Host", host)
    for k, v in headers.items():
        req.headers.set(k.replace("_", "-"), v)
    r = await proxy(req)
    return (r.status, r.body if r.status == 200 else b"",
            r.headers.get("l5d-err") is not None)


# -- the six router scenarios of tests/test_router_e2e.py ------------------

def scenario_host_rebind(pkg: str, root):
    disco = root / "disco"
    disco.mkdir()

    async def go():
        seen = []
        d_a = await serve(downstream("svc-a", seen))
        d_b = await serve(downstream("svc-b", seen))
        (disco / "web").write_text(f"127.0.0.1 {d_a.bound_port}\n")
        cfg = f"""
routers:
- protocol: http
  label: out
  dtab: |
    /svc => /#/io.l5d.fs ;
  servers:
  - port: 0
  client:
    loadBalancer: {{kind: roundRobin}}
namers:
- kind: io.l5d.fs
  rootDir: {disco}
"""
        linker = load(pkg, cfg)
        await linker.start()
        proxy = HttpClient("127.0.0.1", linker.routers[0].server_ports[0])
        try:
            out = [await send(proxy, "web"), await send(proxy, "nope")]
            (disco / "web").write_text(f"127.0.0.1 {d_b.bound_port}\n")
            linker.namers[0][1].refresh()  # deterministic poll
            out.append(await send(proxy, "web"))
            return out, seen, counted_metrics(linker)
        finally:
            await proxy.close()
            await linker.close()
            await d_a.close()
            await d_b.close()

    return run(go())


def scenario_weighted_union(pkg: str, root):
    disco = root / "disco"
    disco.mkdir()

    async def go():
        seen = []
        d_a = await serve(downstream("A", seen))
        d_b = await serve(downstream("B", seen))
        (disco / "a").write_text(f"127.0.0.1 {d_a.bound_port}\n")
        (disco / "b").write_text(f"127.0.0.1 {d_b.bound_port}\n")
        cfg = f"""
routers:
- protocol: http
  label: w
  dtab: |
    /svc/mix => 0.5 * /#/io.l5d.fs/a & 0.5 * /#/io.l5d.fs/b ;
  servers: [{{port: 0}}]
namers:
- kind: io.l5d.fs
  rootDir: {disco}
"""
        linker = load(pkg, cfg)
        await linker.start()
        proxy = HttpClient("127.0.0.1", linker.routers[0].server_ports[0])
        try:
            out = [await send(proxy, "mix") for _ in range(40)]
            # which branch a request takes is random: compare the set,
            # and the clients' keys but not their counts
            return (sorted(set(out)), sorted(set(
                (n, tuple(h)) for n, h in seen)),
                {k: (None if k.startswith("rt/w/client/") else v)
                 for k, v in counted_metrics(linker).items()})
        finally:
            await proxy.close()
            await linker.close()
            await d_a.close()
            await d_b.close()

    return run(go())


def scenario_alt_failover(pkg: str, root):
    disco = root / "disco"
    disco.mkdir()

    async def go():
        seen = []
        d_b = await serve(downstream("backup", seen))
        (disco / "primary").write_text("")
        (disco / "backup").write_text(f"127.0.0.1 {d_b.bound_port}\n")
        cfg = f"""
routers:
- protocol: http
  label: alt
  dtab: |
    /svc/x => /#/io.l5d.fs/primary | /#/io.l5d.fs/backup ;
  servers: [{{port: 0}}]
namers:
- kind: io.l5d.fs
  rootDir: {disco}
"""
        linker = load(pkg, cfg)
        await linker.start()
        proxy = HttpClient("127.0.0.1", linker.routers[0].server_ports[0])
        try:
            return ([await send(proxy, "x")], seen, counted_metrics(linker))
        finally:
            await proxy.close()
            await linker.close()
            await d_b.close()

    return run(go())


def scenario_dtab_override(pkg: str, root):
    disco = root / "disco"
    disco.mkdir()

    async def go():
        seen = []
        d_a = await serve(downstream("prod", seen))
        d_b = await serve(downstream("staging", seen))
        (disco / "prod").write_text(f"127.0.0.1 {d_a.bound_port}\n")
        (disco / "staging").write_text(f"127.0.0.1 {d_b.bound_port}\n")
        cfg = f"""
routers:
- protocol: http
  label: ovr
  dtab: |
    /svc => /#/io.l5d.fs/prod ;
  servers: [{{port: 0}}]
namers:
- kind: io.l5d.fs
  rootDir: {disco}
"""
        linker = load(pkg, cfg)
        await linker.start()
        proxy = HttpClient("127.0.0.1", linker.routers[0].server_ports[0])
        try:
            out = [await send(proxy, "anything"),
                   await send(proxy, "anything",
                              l5d_dtab="/svc => /#/io.l5d.fs/staging")]
            return out, seen, counted_metrics(linker)
        finally:
            await proxy.close()
            await linker.close()
            await d_a.close()
            await d_b.close()

    return run(go())


def scenario_inet(pkg: str, root):
    async def go():
        seen = []
        d = await serve(downstream("direct", seen))
        cfg = f"""
routers:
- protocol: http
  label: direct
  dtab: |
    /svc => /$/inet/127.0.0.1/{d.bound_port} ;
  servers: [{{port: 0}}]
"""
        linker = load(pkg, cfg)
        await linker.start()
        proxy = HttpClient("127.0.0.1", linker.routers[0].server_ports[0])
        try:
            out = [await send(proxy, "whatever")]
            # the bound id names the backend's port, which differs per run
            return out, [(n, len(h)) for n, h in seen], sorted(
                k.replace(str(d.bound_port), "PORT")
                for k in counted_metrics(linker))
        finally:
            await proxy.close()
            await linker.close()
            await d.close()

    return run(go())


CONFIG_ERRORS = [
    "admin: {port: 9990}",
    "routers:\n- protocol: http\n  bogus: 1\n",
    "routers:\n- protocol: http\nnamers:\n- kind: io.l5d.nope\n",
    "routers:\n- protocol: http\ntelemetry:\n- kind: io.l5d.nope\n",
    "routers:\n- protocol: http\n  identifier: {kind: io.l5d.nope}\n",
    "routers:\n- protocol: carrier-pigeon\n",
    "routers: 3\n",
    "- just a list\n",
    "routers:\n- protocol: http\n  servers: [{port: 4140}, {port: 4140}]\n",
]


def scenario_config_errors(pkg: str, root):
    err = ConfigError if pkg == "port" else RefConfigError
    out = []
    for text in CONFIG_ERRORS:
        with pytest.raises(err) as e:
            load(pkg, text)
        out.append(str(e.value))
    return out


SCENARIOS = {
    "host_rebind": scenario_host_rebind,
    "weighted_union": scenario_weighted_union,
    "alt_failover": scenario_alt_failover,
    "dtab_override": scenario_dtab_override,
    "inet": scenario_inet,
    "config_errors": scenario_config_errors,
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_router_scenario_alike(name, tmp_path):
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    ref = SCENARIOS[name]("ref", tmp_path / "ref")
    port = SCENARIOS[name]("port", tmp_path / "port")
    assert port == ref


def test_scenarios_route_as_the_reference_test_says(tmp_path):
    out, seen, flat = scenario_host_rebind("port", tmp_path)
    assert out == [(200, b"svc-a", False), (400, b"", True),
                   (200, b"svc-b", False)]
    assert flat["rt/out/server/requests"] == 3
    assert flat["rt/out/service/svc.web/requests"] == 2
    assert [n for n, _ in seen] == ["svc-a", "svc-b"]
    assert ("l5d-dst-service", "/svc/web") in seen[0][1]


# -- refusals -------------------------------------------------------------

BASE = ("routers:\n- protocol: http\n  servers: [{port: 0}]\n")


# Keys a kind is given beside ``kind``: the pilot and mixer clients
# point at the loopback address (the defaults name cluster hosts,
# istio-pilot and istio-mixer), and the fs and configMap interpreters
# take the key they need.
EXTRA = {"io.l5d.k8s.istio": "host: 127.0.0.1",
         "io.l5d.k8s.istio-ingress": "apiserverHost: 127.0.0.1",
         "io.l5d.istio": "mixerHost: 127.0.0.1",
         "io.l5d.fs": "dtabFile: dtab", "io.l5d.k8s.configMap": "name: d"}


def kind_text(cat: str, k: str) -> str:
    """A config naming kind ``k`` of category ``cat``."""
    extra = f", {EXTRA[k]}" if k in EXTRA else ""
    if cat in ("namer", "telemeter"):
        return BASE + {"namer": "namers:\n", "telemeter": "telemetry:\n"}[
            cat] + f"- {{kind: {k}{extra}}}\n"
    if cat == "h2identifier":
        return (f"routers:\n- protocol: h2\n  identifier: "
                f"{{kind: {k}{extra}}}\n")
    return f"routers:\n- protocol: http\n  {cat}: {{kind: {k}{extra}}}\n"


# Kinds refused by name until the k8s and istio families and the fs
# interpreter were ported (ROADMAP Queue 1 items 5 and 13).
K8S_ISTIO_KINDS = (
    *(("namer", k) for k in ("io.l5d.k8s", "io.l5d.k8s.external",
                             "io.l5d.k8s.ns", "io.l5d.k8s.istio")),
    ("telemeter", "io.l5d.istio"),
    *((cat, k) for cat in ("identifier", "h2identifier")
      for k in ("io.l5d.ingress", "io.l5d.k8s.istio",
                "io.l5d.k8s.istio-ingress")),
    *(("interpreter", k) for k in ("io.l5d.fs", "io.l5d.k8s.configMap",
                                   "io.l5d.k8s.istio")),
)
REFUSALS = {
    **{f"router key {k}": (
        "routers:\n- protocol: http\n  " + {
            "connectionGuard": "connectionGuard: {}",
            "streamScoring": "streamScoring: {}",
            "tenants": "tenants: {}",
            "tenantIdentifier": "tenantIdentifier: {kind: header}",
            "loggers": "loggers: [{kind: io.l5d.http.file, path: x}]",
            "httpAccessLog": "httpAccessLog: stdout",
        }[k] + "\n", k) for k in REFUSED_ROUTER_KEYS},
    **{f"protocol {p}": (f"routers:\n- protocol: {p}\n", f"protocol '{p}'")
       for p in REFUSED_PROTOCOLS},
    **{f"fastPath {k}": (
        "routers:\n- protocol: http\n  fastPath: true\n" + text, k)
       for k, text in (("tenants", "  tenants: {}\n"),)},
    "namer transformers": (
        BASE + "namers:\n- kind: io.l5d.fs\n  rootDir: .\n  transformers:"
        "\n  - kind: io.l5d.localhost\n", "transformers"),
    "announcers": (
        BASE + "announcers:\n- kind: io.l5d.fs\n  rootDir: .\n",
        "announcers"),
    "server announce": (
        "routers:\n- protocol: http\n  servers:\n  - port: 0\n    announce:"
        " [/#/io.l5d.fs/x]\n", "announce"),
    **{f"{cat} kind {k}": (kind_text(cat, k), repr(k))
       for cat, kinds in UNPORTED_KINDS.items() for k in kinds},
    **{f"control {k}": (
        BASE + f"telemetry:\n- kind: io.l5d.jaxAnomaly\n  control:\n"
        f"    {k}: {{}}\n", repr(k))
       for k in ("fleet", "regionFailover")},
}


# Cases this test refused by name until the port took their keys (the
# native engine's workers, TLS, connectionGuard and streamScoring, the
# h2 router, the h2 engine, the io.l5d.mesh interpreter, the thrift, mux
# and thriftmux routers, the io.l5d.namerd interpreter, and the k8s and
# istio kinds with the io.l5d.fs interpreter): each now does what the
# reference's linker does with the same text, loading or failing with
# the same message.
FP = "routers:\n- protocol: http\n  fastPath: true\n"
FP0 = FP + "  servers: [{port: 0}]\n"
PORTED = {
    "protocol h2": "routers:\n- protocol: h2\n",
    **{f"protocol {p}": f"routers:\n- protocol: {p}\n"
       for p in ("thrift", "mux", "thriftmux")},
    "interpreter kind io.l5d.namerd": (
        "routers:\n- protocol: http\n  interpreter: {kind: io.l5d.namerd}\n"),
    "fastPath on h2": ("routers:\n- protocol: h2\n  fastPath: true\n"
                       "  servers: [{port: 0}]\n"),
    "interpreter kind io.l5d.mesh": (
        "routers:\n- protocol: http\n  interpreter: {kind: io.l5d.mesh}\n"),
    "router key connectionGuard":
        "routers:\n- protocol: http\n  connectionGuard: {}\n",
    "router key streamScoring":
        "routers:\n- protocol: http\n  streamScoring: {}\n",
    "fastPath workers": FP0 + "  workers: 2\n",
    "fastPath connectionGuard": FP0 + "  connectionGuard: {}\n",
    "fastPath streamScoring": FP0 + "  streamScoring: {}\n",
    "fastPath servers[0].tls": (
        FP + "  servers:\n  - port: 0\n    tls:\n      certPath: c\n"
        "      keyPath: k\n"),
    "fastPath client.tls": FP0 + "  client:\n    tls: {}\n",
    "server tls": (
        FP + "  servers:\n  - port: 0\n  - port: 0\n    tls:\n"
        "      certPath: c\n      keyPath: k\n"),
    "client tls": (
        FP0 + "  client:\n    kind: io.l5d.static\n    configs:\n"
        "    - prefix: /svc\n      tls: {commonName: x}\n"),
    **{f"{cat} kind {k}": kind_text(cat, k) for cat, k in K8S_ISTIO_KINDS},
}


def load_outcome(pkg: str, text: str):
    """"loads" (the linker closed again), or the ConfigError's text.
    The linker loads on a running loop, as the CLI's does: the istio
    kinds start their pilot pollers when built."""
    async def go():
        try:
            linker = load(pkg, text)
        except (ConfigError, RefConfigError) as e:
            return str(e)
        await linker.close()
        return "loads"
    return run(go())


@pytest.mark.parametrize("case", sorted({**REFUSALS, **PORTED}))
def test_refused_by_name(case):
    if case in PORTED:
        got = load_outcome("port", PORTED[case])
        assert got == load_outcome("ref", PORTED[case])
        assert "not supported by the port yet" not in got
        return
    text, name = REFUSALS[case]
    with pytest.raises(ConfigError) as e:
        port_load_linker(text, device="cpu")
    msg = str(e.value)
    assert name in msg and "not supported by the port yet" in msg and \
        "ROADMAP Queue 1 item" in msg, msg


def test_admission_control_and_interpreter_load():
    """``admissionControl`` and the two ported interpreter kinds load on
    an http router; ``admissionControl`` on a fastPath router keeps the
    reference's error."""
    from linkerd_tpu_torch.interpreter.namerd_http import (
        NamerdHttpInterpreter,
    )
    from linkerd_tpu_torch.namer.core import ConfiguredDtabNamer

    linker = port_load_linker(
        BASE + "  admissionControl: {maxConcurrency: 4, maxPending: 2}\n"
        "  interpreter: {kind: io.l5d.namerd.http, "
        "dst: /$/inet/127.0.0.1/4180, namespace: ns1}\n", device="cpu")
    interp = linker.routers[0].interpreter
    assert isinstance(interp, NamerdHttpInterpreter)
    assert (interp.host, interp.port, interp.namespace) == (
        "127.0.0.1", 4180, "ns1")
    assert port_load_linker(
        BASE + "  interpreter: {kind: default}\n",
        device="cpu").routers[0].interpreter.__class__ is ConfiguredDtabNamer
    flat = linker.metrics.flatten()
    assert flat["rt/http/server/admission/limit"] == 4.0
    assert flat["rt/http/server/admission/shed_total"] == 0
    for pkg in ("ref", "port"):
        with pytest.raises((ConfigError, RefConfigError),
                           match="admissionControl is not supported with "
                                 "fastPath: true"):
            load(pkg, "routers:\n- protocol: http\n  fastPath: true\n"
                      "  admissionControl: {maxConcurrency: 4}\n")


def test_unported_kinds_are_the_reference_kinds():
    from linkerd_tpu.config import kinds as ref_kinds
    from linkerd_tpu_torch.config import kinds as port_kinds
    for cat in {*UNPORTED_KINDS, *(c for c, _ in K8S_ISTIO_KINDS)}:
        unported = UNPORTED_KINDS.get(cat, {})
        assert sorted(set(port_kinds(cat)) | set(unported)) == sorted(
            ref_kinds(cat)), cat
        assert not set(port_kinds(cat)) & set(unported)


@pytest.mark.parametrize("cat,kind", K8S_ISTIO_KINDS)
def test_ported_kind_config_is_the_references(cat, kind):
    """Each kind that left the refusals builds, from the same mapping,
    the reference's config class with the same fields and values."""
    from linkerd_tpu.config import instantiate as ref_instantiate
    from linkerd_tpu_torch.config import instantiate as port_instantiate
    got = port_instantiate(cat, {"kind": kind}, "x")
    want = ref_instantiate(cat, {"kind": kind}, "x")
    assert type(got).__name__ == type(want).__name__
    assert type(got).__module__.replace("linkerd_tpu_torch", "linkerd_tpu") \
        == type(want).__module__
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


PORTED_TELEMETERS = ("io.l5d.zipkin", "io.l5d.tracelog",
                     "io.l5d.recentRequests", "io.l5d.prometheus",
                     "io.l5d.influxdb", "io.l5d.statsd")


@pytest.mark.parametrize("kind", PORTED_TELEMETERS)
def test_ported_telemeter_kind_loads(kind):
    """The exporter and tracer telemeters, refused until they were
    ported, load in both packages to equal configs; the tracers among
    them are broadcast to the router's trace filters."""
    text = BASE + f"telemetry:\n- kind: {kind}\n"
    linkers = [load(pkg, text) for pkg in ("ref", "port")]
    (r,), (p,) = (lk.telemeters for lk in linkers)
    assert type(p).__name__ == type(r).__name__
    assert vars(getattr(p, "cfg", p)).keys() == vars(
        getattr(r, "cfg", r)).keys()
    for lk in linkers:
        assert (type(lk.tracer).__name__ == "BroadcastTracer") == (
            kind in ("io.l5d.zipkin", "io.l5d.tracelog",
                     "io.l5d.recentRequests"))


def test_admin_and_usage_parse_but_need_a_router():
    for text in ("admin: {port: 9990}", "usage: {enabled: false}"):
        with pytest.raises(ConfigError, match="at least one router"):
            port_load_linker(text, device="cpu")
    linker = port_load_linker(
        BASE + "admin: {port: 9990, ip: 0.0.0.0}\nusage: {enabled: false}\n",
        device="cpu")
    assert linker.spec.admin.port == 9990


def test_cuda_by_default():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_load_linker(BASE)


def test_json_config_needs_no_yaml(monkeypatch):
    import json
    import linkerd_tpu_torch.config.parser as parser
    monkeypatch.setattr(parser, "_STRICT_LOADER", None)
    monkeypatch.setitem(__import__("sys").modules, "yaml", None)
    linker = port_load_linker(json.dumps({"routers": [{
        "protocol": "http", "servers": [{"port": 0}]}]}), device="cpu")
    assert linker.routers[0].label == "http"
    with pytest.raises(ConfigError, match="PyYAML is not installed"):
        port_load_linker(BASE, device="cpu")


# -- the telemeter through the linker ------------------------------------

TELE_CONFIG = """
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
  reconWeight: 1.0
namers:
- kind: io.l5d.fs
  rootDir: {disco}
"""


class ScriptedClock:
    """A scripted ``time`` module for the port's telemeter: ``monotonic``
    reads ``now``, which the backend moves by a latency drawn from a
    seed (``step``: the fault window's 40 ms plus jitter, else about 1
    ms); ``time`` is the real clock. The recorded rows, and so the model
    trained on them, are then the same in every run."""

    def __init__(self, now=1000.0, seed=0):
        self.now = now
        self.rng = np.random.default_rng(seed)

    def step(self, fault: bool) -> None:
        ms = (40.0 + self.rng.uniform(0.0, 2.0) if fault
              else self.rng.gamma(2.0, 0.5))
        self.now += ms / 1e3

    def monotonic(self):
        return self.now

    @staticmethod
    def time():
        return __import__("time").time()


def port_scoring_e2e(disco, clock=None):
    """The reference's end-to-end protocol (tests/test_anomaly.py) on
    the port's linker: returns the scored fraction, the board before and
    after the fault window, the window's AUC, its rows and the scorer's
    snapshot with the port's scores of them. With ``clock`` (the port
    telemeter's scripted clock) each request takes the latency its
    window stands for on that clock."""
    injector = FaultInjector(FaultSpec(error_rate=0.9, latency_ms=40.0))

    async def backend(req: Request) -> Response:
        return Response(200, body=b"x" * 200)

    async def advance(req: Request, svc) -> Response:
        if clock is not None:
            clock.step(injector.active)
        return await svc(req)

    async def go():
        d = await serve(FnService(lambda req: advance(
            req, injector.and_then(FnService(backend)))))
        (disco / "web").write_text(f"127.0.0.1 {d.bound_port}\n")
        linker = port_load_linker(TELE_CONFIG.format(disco=disco),
                                  device="cpu")
        await linker.start()
        tele = linker.telemeters[0]
        proxy = HttpClient("127.0.0.1", linker.routers[0].server_ports[0])
        try:
            async def send_n(n):
                for _ in range(n):
                    req = Request(method="GET", uri="/")
                    req.headers.set("Host", "web")
                    await proxy(req)

            await send_n(120)
            ring_copy = list(tele.ring)
            for _ in range(6):
                await tele.drain_once()
                for item in ring_copy:
                    tele.ring.append(item)
                await tele.drain_once()
            baseline = tele.board.score_of("/svc/web")
            for _ in range(4):
                injector.active = True
                await send_n(30)
                injector.active = False
                await send_n(30)
            tele.cfg.trainEveryBatches = 0
            items = list(tele.ring)
            await tele.drain_once()
            anomalous = tele.board.score_of("/svc/web")
            fraction = linker.metrics.flatten()["anomaly/scored_fraction"]
            x = featurize_batch([it[0] for it in items])
            labels = [it[1] for it in items]
            scorer = tele._ensure_scorer()
            scores = await scorer.score(x)
            return (fraction, baseline, anomalous, x, labels,
                    np.asarray(scores), scorer.snapshot())
        finally:
            await proxy.close()
            await linker.close()
            await d.close()

    return run(go(), timeout=120)


def jax_scores(snap, x: np.ndarray) -> np.ndarray:
    """The JAX package's fused scorer (Pallas, interpreted) on the port's
    weights, compiled with ``xla_allow_excess_precision`` off."""
    jcfg = jax_model.AnomalyModelConfig(recon_weight=snap.cfg.recon_weight)
    params = jax.tree_util.tree_map(np.asarray, snap.params)
    z = jax_model.normalize_features(x, snap.mu, snap.var)
    fn = jax.jit(lambda p, z: jax_scoring.fused_anomaly_scores(
        p, z, jcfg, block_rows=256, interpret=True))
    compiled = fn.lower(params, z).compile(compiler_options={
        "xla_allow_excess_precision": False})
    return np.asarray(compiled(params, z))


def test_end_to_end_scoring_and_auc_on_the_port(tmp_path, monkeypatch):
    """Rows recorded under the scripted clock: their latency features,
    and so the model and the rows the bf16 bounds hold, do not change
    with the host's timing."""
    from linkerd_tpu_torch.telemetry import anomaly as port_anomaly
    clock = ScriptedClock()
    monkeypatch.setattr(port_anomaly, "time", clock)
    disco = tmp_path / "disco"
    disco.mkdir()
    fraction, baseline, anomalous, x, labels, scores, snap = \
        port_scoring_e2e(disco, clock)
    assert fraction == 1.0
    assert anomalous > baseline
    mask = [(lab, s) for lab, s in zip(labels, scores) if lab is not None]
    assert len(mask) == len(labels) == 240
    got_auc = auc([lab for lab, _ in mask], [s for _, s in mask])
    assert got_auc >= 0.9, f"AUC {got_auc}"
    # the same rows through the JAX scorer, from the same weights
    assert isinstance(snap.params["enc"][0]["w"], np.ndarray)
    ref = jax_scores(snap, x)
    diff = np.abs(scores - ref)
    assert diff.max() <= BF16_SCORE_ATOL, diff.max()
    assert (diff > ATOL).mean() <= BF16_ROW_SHARE, (diff > ATOL).mean()


def test_convert_carries_the_weights():
    """``models/convert.py`` round trip: the numpy weights the JAX scorer
    takes are the port's tensors bit for bit."""
    from linkerd_tpu_torch.models.anomaly import AnomalyModelConfig, init_params
    params = init_params(3, AnomalyModelConfig(), device="cpu")
    back = params_to_numpy(params)
    for g in params:
        for layer, np_layer in zip(params[g], back[g]):
            for k in layer:
                assert np.array_equal(layer[k].numpy(), np_layer[k])


ACCRUAL_CONFIG = """
routers:
- protocol: http
  label: acc
  dtab: |
    /svc => /#/io.l5d.fs ;
  servers: [{{port: 0}}]
  client:
    loadBalancer: {{kind: roundRobin}}
    failureAccrual: {{kind: io.l5d.jaxAnomaly}}
telemetry:
- kind: io.l5d.jaxAnomaly
  trainEveryBatches: 0
namers:
- kind: io.l5d.fs
  rootDir: {disco}
"""


def accrual_run(pkg: str, disco, level: float):
    """A failing and a healthy replica of /svc/web behind round robin;
    the board set to ``level`` for /svc/web. Returns the failing
    replica's hits over 20 requests and the statuses the client saw."""
    async def go():
        hits = {"bad": 0, "good": 0}

        def replica(name, status):
            async def handle(req):
                hits[name] += 1
                return Response(status, body=name.encode())
            return FnService(handle)

        bad = await serve(replica("bad", 503))
        good = await serve(replica("good", 200))
        (disco / "web").write_text(f"127.0.0.1 {bad.bound_port}\n"
                                   f"127.0.0.1 {good.bound_port}\n")
        linker = load(pkg, ACCRUAL_CONFIG.format(disco=disco))
        await linker.start()
        linker.telemeters[0].board.update_batch(["/svc/web"],
                                                np.array([level]))
        proxy = HttpClient("127.0.0.1", linker.routers[0].server_ports[0])
        try:
            statuses = []
            for _ in range(20):
                req = Request(uri="/")
                req.headers.set("Host", "web")
                statuses.append((await proxy(req)).status)
            return hits["bad"], sorted(statuses)
        finally:
            await proxy.close()
            await linker.close()
            await bad.close()
            await good.close()

    return run(go())


@pytest.mark.parametrize("level,failures", [(0.9, 2), (0.0, 5)])
def test_anomaly_accrual_ejects_alike(level, failures, tmp_path):
    got = {}
    for pkg in ("ref", "port"):
        disco = tmp_path / pkg
        disco.mkdir()
        got[pkg] = accrual_run(pkg, disco, level)
    assert got["port"] == got["ref"]
    assert got["port"][0] == failures
