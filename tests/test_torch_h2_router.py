"""The port's h2 router (``protocol: h2`` through ``load_linker``)
against the JAX package's, on the CPU.

Both linkers take the same config: an h2 router over the ``io.l5d.fs``
namer with ``io.l5d.h2.grpc.default`` and service retries, and the
``io.l5d.jaxAnomaly`` telemeter. The same gRPC calls, drawn from a numpy
seed, go through each to the same backends (one destination faulted:
UNAVAILABLE at 0.5 in the second half), one at a time; each package's
telemeter reads a scripted clock that the backends move by seeded
latencies, so the rows it records do not depend on the host's timing.

- The recorded rows (features, labels, endpoints) are bit-equal.
- Both telemeters score their rows from one snapshot: the port's bf16
  scores are within 1e-5 of the JAX scorer's (compiled with
  ``xla_allow_excess_precision`` off) on all but 1% of rows and within
  1e-3 on every row; the boards agree within 1e-3.
- The router's ``rt/*`` counters, what ``/admin/metrics.json`` serves,
  are equal.
- h2 config errors carry the reference's words.
- ``streamScoring`` on h2: the same calls give the same sentinel
  snapshot.
- A served h2c upgrade through the router answers as the reference's.
"""

import asyncio
import json

import numpy as np
import pytest

from linkerd_tpu import grpc as ref_grpc
from linkerd_tpu.config import ConfigError as RefConfigError
from linkerd_tpu.linker import load_linker as ref_load_linker
from linkerd_tpu.models import features as ref_features
from linkerd_tpu.protocol.h2.client import H2Client as RefH2Client
from linkerd_tpu.telemetry import anomaly as ref_anomaly
from linkerd_tpu_torch import grpc
from linkerd_tpu_torch.config import ConfigError
from linkerd_tpu_torch.linker import load_linker as port_load_linker
from linkerd_tpu_torch.models import features
from linkerd_tpu_torch.protocol.h2.client import H2Client
from linkerd_tpu_torch.protocol.h2.messages import H2Response, Headers
from linkerd_tpu_torch.protocol.h2.server import H2Server
from linkerd_tpu_torch.router.h2_layer import H2ClearContextFilter
from linkerd_tpu_torch.router.service import FnService
from linkerd_tpu_torch.telemetry import anomaly as port_anomaly
from tests.test_torch_h2 import upgrade_exchange
from tests.test_torch_linker import jax_scores
from tests.test_torch_telemeter import scorers, start_snapshot

ATOL = 1e-5             # bf16 bounds, ROADMAP Queue 3
BF16_SCORE_ATOL = 1e-3
BF16_ROW_SHARE = 0.01
BOARD_ATOL = 1e-3
DSTS = 6
CALLS = 160


def run(coro, timeout=120):
    return asyncio.run(asyncio.wait_for(coro, timeout))


def load(pkg: str, text: str):
    return (port_load_linker(text, device="cpu") if pkg == "port"
            else ref_load_linker(text))


class Msg(grpc.ProtoMessage):
    FIELDS = {"text": grpc.Field(1, "string"), "n": grpc.Field(2, "int32")}


class RefMsg(ref_grpc.ProtoMessage):
    FIELDS = {"text": ref_grpc.Field(1, "string"),
              "n": ref_grpc.Field(2, "int32")}


def svc_def(g, msg):
    return g.ServiceDef("test.Route", [
        g.Rpc("Echo", msg, msg),
        g.Rpc("Sum", msg, msg, client_streaming=True),
        g.Rpc("Watch", msg, msg, server_streaming=True)])


class Clock:
    """A scripted ``time`` module: ``monotonic`` reads ``now``;
    ``time`` is the real clock."""

    def __init__(self, now=1000.0):
        self.now = now

    def monotonic(self):
        return self.now

    @staticmethod
    def time():
        return __import__("time").time()


class Backends:
    """One gRPC server (the port's dispatcher) a destination, answering
    ``d<i>``; destination 0 fails with UNAVAILABLE (Trailers-Only,
    ``:status 503``) at ``error_rate`` while ``faulty``. Each attempt
    moves ``clock`` (when set) by a latency from ``rng``: 40 ms and
    jitter for a faulted attempt, about 1 ms else."""

    def __init__(self):
        self.servers, self.clock, self.rng = [], None, None
        self.faulty, self.error_rate = False, 0.5

    def reset(self, clock, seed: int) -> None:
        self.clock, self.rng, self.faulty = clock, \
            np.random.default_rng(seed), False

    async def start(self, disco):
        sdef = svc_def(grpc, Msg)
        for d in range(DSTS):
            disp = grpc.ServerDispatcher()

            async def echo(req, _d=d):
                return Msg(text=f"d{_d}", n=req.n)

            async def total(reqs, _d=d):
                s = 0
                async for m in reqs:
                    s += m.n
                return Msg(text=f"d{_d}", n=s)

            async def watch(req, _d=d):
                async def gen():
                    for i in range(req.n):
                        yield Msg(text=f"d{_d}", n=i)
                return gen()

            disp.register_all(sdef, {"Echo": echo, "Sum": total,
                                     "Watch": watch})
            srv = await H2Server(FnService(
                lambda req, _d=d, _disp=disp: self.handle(req, _d, _disp))
            ).start()
            self.servers.append(srv)
            (disco / f"d{d}").write_text(f"127.0.0.1 {srv.bound_port}\n")
        return self

    async def handle(self, req, d: int, disp):
        fault = self.faulty and d == 0
        if self.clock is not None:
            ms = (40.0 + self.rng.uniform(0.0, 2.0) if fault
                  else self.rng.gamma(2.0, 0.5))
            self.clock.now += ms / 1e3
        if fault and self.rng.random() < self.error_rate:
            return H2Response(status=503, headers=Headers([
                ("content-type", "application/grpc"),
                ("grpc-status", "14"), ("l5d-fault-label", "1")]),
                body=b"")
        rsp = await disp(req)
        rsp.headers.set("l5d-fault-label", "1" if fault else "0")
        return rsp

    async def close(self):
        for s in self.servers:
            await s.close()


def config(disco, extra: str = "", telemetry: bool = True) -> str:
    tele = """telemetry:
- kind: io.l5d.jaxAnomaly
  trainEveryBatches: 0
""" if telemetry else ""
    return f"""
routers:
- protocol: h2
  label: h2r
  dtab: |
    /svc => /#/io.l5d.fs ;
  servers:
  - port: 0
  - port: 0
    clearContext: true
  service:
    responseClassifier: {{kind: io.l5d.h2.grpc.default}}
{extra}{tele}namers:
- kind: io.l5d.fs
  rootDir: {disco}
"""


def client_of(pkg: str, port: int):
    return (H2Client if pkg == "port" else RefH2Client)("127.0.0.1", port)


def stubs(pkg: str, h2, dst: int):
    g, msg = (grpc, Msg) if pkg == "port" else (ref_grpc, RefMsg)
    return g, msg, svc_def(g, msg), g.ClientDispatcher(h2,
                                                       authority=f"d{dst}")


async def drive(pkg: str, linker, backends, clock, seed: int):
    """CALLS unary calls from ``seed`` through the linker's first server,
    one at a time, destination 0 faulted in the second half; returns
    each call's outcome."""
    backends.reset(clock, seed)
    plan = np.random.default_rng(seed).integers(DSTS, size=CALLS)
    h2 = client_of(pkg, linker.routers[0].server_ports[0])
    out = []
    try:
        for i, d in enumerate(plan):
            backends.faulty = i >= CALLS // 2
            g, msg, sdef, stub = stubs(pkg, h2, int(d))
            try:
                rep = await stub.unary(sdef, "Echo", msg(n=i))
                out.append((int(d), 0, rep.text))
            except g.GrpcError as e:
                out.append((int(d), e.status.code, ""))
            if clock is not None:
                clock.now += 5e-3
        return out
    finally:
        await h2.close()


def rt_counters(linker) -> dict:
    """The ``rt/*`` keys, with the values of the counters that do not
    depend on timing."""
    flat = linker.metrics.flatten()
    ends = ("/requests", "/success", "/failures", "/total",
            "/budget_exhausted", "/deadline_skipped", "/data_bytes",
            "/count")
    return {k: (v if k.endswith(ends) or "/status/" in k else None)
            for k, v in flat.items() if k.startswith("rt/")}


async def routed(pkg: str, disco, backends, clock, scorer):
    """One linker of ``pkg`` driven by ``drive``; then its ring drained
    through ``scorer``. Returns the outcomes, rows, labels, endpoints,
    counters and board."""
    linker = load(pkg, config(disco))
    await linker.start()
    tele = linker.telemeters[0]
    try:
        outcomes = await drive(pkg, linker, backends, clock, seed=3)
        items = list(tele.ring)
        feat = features if pkg == "port" else ref_features
        x = feat.featurize_batch([it[0] for it in items])
        labels = [it[1] for it in items]
        endpoints = [it[4] for it in items]
        while tele.ring:
            await tele.drain_once(scorer)
        return dict(outcomes=outcomes, x=x, labels=labels,
                    endpoints=endpoints, counters=rt_counters(linker),
                    board=tele.board.effective_scores())
    finally:
        await linker.close()


@pytest.fixture(scope="module")
def snap():
    return start_snapshot(seed=5)


def test_rows_scores_boards_and_counters_alike(tmp_path, monkeypatch, snap):
    clocks = {"ref": Clock(), "port": Clock()}
    monkeypatch.setattr(ref_anomaly, "time", clocks["ref"])
    monkeypatch.setattr(port_anomaly, "time", clocks["port"])
    disco = tmp_path / "disco"
    disco.mkdir()
    ref_scorer, port_scorer = scorers(snap)

    async def go():
        backends = await Backends().start(disco)
        try:
            got = {}
            for pkg, scorer in (("ref", ref_scorer), ("port", port_scorer)):
                got[pkg] = await routed(pkg, disco, backends, clocks[pkg],
                                        scorer)
            x = got["port"]["x"]
            return got, np.asarray(await port_scorer.score(x))
        finally:
            await backends.close()

    got, port_scores = run(go())
    ref, port = got["ref"], got["port"]
    assert port["outcomes"] == ref["outcomes"]
    # the router retries each UNAVAILABLE answer (grpc.default) until
    # the destination answers
    assert all(t == f"d{d}" for d, c, t in port["outcomes"] if c == 0)
    # rows, labels and endpoints bit-equal
    assert port["x"].dtype == ref["x"].dtype
    assert np.array_equal(port["x"], ref["x"])
    assert port["labels"] == ref["labels"] and \
        port["endpoints"] == ref["endpoints"]
    assert len(port["x"]) == CALLS and sum(port["labels"]) > 0
    # scores: the port's against the JAX scorer on the same rows
    want = jax_scores(snap, port["x"])
    diff = np.abs(port_scores - want)
    assert diff.max() <= BF16_SCORE_ATOL, diff.max()
    assert (diff > ATOL).mean() <= BF16_ROW_SHARE, (diff > ATOL).mean()
    assert sorted(port["board"]) == sorted(ref["board"]) == \
        [f"/svc/d{d}" for d in range(DSTS)]
    gap = max(abs(port["board"][k] - ref["board"][k]) for k in ref["board"])
    assert gap <= BOARD_ATOL, gap
    # the router's counters, retries included
    assert port["counters"] == ref["counters"]
    assert port["counters"]["rt/h2r/service/svc.d0/retries/total"] > 0


# -- config errors ----------------------------------------------------------

CONFIG_ERRORS = {
    "maxFrameBytes small": "  maxFrameBytes: 1024\n",
    "maxFrameBytes large": "  maxFrameBytes: 16777216\n",
    "stream window zero": "  initialStreamWindowBytes: 0\n",
    "header list zero": "  maxHeaderListBytes: 0\n",
    "concurrent streams zero": "  maxConcurrentStreamsPerConnection: 0\n",
    "requeueBudget": "  client:\n    requeueBudget: {ttlSecs: 5}\n",
    "static requeueBudget": (
        "  client:\n    kind: io.l5d.static\n    configs:\n"
        "    - prefix: /svc\n      requeueBudget: {ttlSecs: 5}\n"),
    "unknown classifier": (
        "  service:\n    responseClassifier: {kind: io.l5d.nope}\n"),
    "http classifier on h2": (
        "  service:\n    responseClassifier: "
        "{kind: io.l5d.http.nonRetryable5XX}\n"),
    "unknown identifier": "  identifier: {kind: io.l5d.nope}\n",
    "stream thresholds": (
        "  streamScoring: {enter: 0.5, exit: 0.6}\n"),
    "stream action": "  streamScoring: {action: nuke}\n",
    "connectionGuard": "  connectionGuard: {}\n",
    "workers": "  workers: 2\n",
    "admission zero": "  admissionControl: {maxConcurrency: 0}\n",
    "compressionLevel": (
        "  servers:\n  - port: 0\n    compressionLevel: 3\n"),
    "server timeout": "  servers:\n  - port: 0\n    timeoutMs: 0\n",
}


def h2_text(extra: str) -> str:
    return "routers:\n- protocol: h2\n  dtab: /svc => /$/inet ;\n" + extra


@pytest.mark.parametrize("case", sorted(CONFIG_ERRORS))
def test_config_errors_word_for_word(case):
    text = h2_text(CONFIG_ERRORS[case])
    with pytest.raises(RefConfigError) as want:
        linker = ref_load_linker(text)
        run(linker.close())
    with pytest.raises(ConfigError) as got:
        linker = port_load_linker(text, device="cpu")
        run(linker.close())
    assert str(got.value) == str(want.value)
    assert "not supported by the port yet" not in str(got.value)


@pytest.mark.parametrize("extra", [
    "  maxFrameBytes: 32768\n  initialStreamWindowBytes: 131072\n"
    "  maxHeaderListBytes: 65536\n  maxConcurrentStreamsPerConnection: 8\n",
    "  identifier: {kind: io.l5d.header.path, segments: 2}\n",
    "  admissionControl: {maxConcurrency: 4, maxPending: 2}\n"
    "  streamScoring: {action: observe}\n",
])
def test_h2_configs_load_alike(extra):
    """Configs both linkers take: the same router label, server count and
    metric keys."""
    out = {}
    for pkg in ("ref", "port"):
        linker = load(pkg, h2_text(extra + "  servers: [{port: 0}]\n"))
        out[pkg] = (linker.routers[0].label, len(linker.routers[0].servers),
                    sorted(linker.metrics.flatten()))
        run(linker.close())
    assert out["port"] == out["ref"]


def test_fastpath_and_other_protocols_still_refused():
    """Tenants on an h2 ``fastPath: true`` router, refused by name until
    the port took them, load in both packages. The thrift, mux and
    thriftmux routers, refused by name until the port took them, load or
    fail as the reference's do, with or without ``fastPath`` (which
    those routers do not read)."""
    text = ("routers:\n- protocol: h2\n  fastPath: true\n"
            "  servers: [{port: 0}]\n  tenants: {}\n"
            "  tenantIdentifier: {kind: header}\n")
    views = []
    for pkg in ("ref", "port"):
        linker = load(pkg, text)
        views.append([(label, type(a).__name__)
                      for label, _b, a in linker.tenant_views])
        run(linker.close())
    assert views[1] == views[0] == [("h2", "TenantAdmission")]
    for p in ("thrift", "mux", "thriftmux"):
        for fp in ("", "  fastPath: true\n",
                   "  fastPath: true\n  tenants: {}\n"):
            text = f"routers:\n- protocol: {p}\n  servers: [{{port: 0}}]\n{fp}"
            out = []
            for pkg in ("ref", "port"):
                try:
                    linker = load(pkg, text)
                except (ConfigError, RefConfigError) as e:
                    out.append(str(e))
                else:
                    out.append([r.label for r in linker.routers])
                    run(linker.close())
            assert out[1] == out[0], (p, fp)
            assert "not supported by the port yet" not in str(out[1])
            if "tenants" in fp:
                assert "only supported on http/h2 routers" in out[1]
            else:
                assert out[1] == [p]


# -- stream scoring and the h2c upgrade through the router ------------------

async def sentinel_run(pkg: str, disco, backends):
    """Client-streaming and server-streaming calls through a router with
    ``streamScoring`` (no gap bound): its sentinel's snapshot."""
    linker = load(pkg, config(
        disco, "  streamScoring: {sampleEveryFrames: 4, minGapMs: 0, "
        "action: observe}\n", telemetry=False))
    await linker.start()
    h2 = client_of(pkg, linker.routers[0].server_ports[0])
    try:
        backends.reset(None, 0)
        sums = []
        for d, n in ((1, 40), (2, 9), (3, 17)):
            g, msg, sdef, stub = stubs(pkg, h2, d)

            async def numbers(_n=n, _msg=msg):
                for i in range(_n):
                    yield _msg(n=i)

            reps = await stub.call_stream(sdef, "Sum", numbers())
            sums.append([m.n async for m in reps])
        g, msg, sdef, stub = stubs(pkg, h2, 4)
        reps = await stub.server_stream(sdef, "Watch", msg(n=50))
        sums.append(len([m async for m in reps]))
        (label, sentinel), = linker.stream_sentinels
        return label, sums, sentinel.snapshot(), \
            linker.metrics.flatten()["rt/h2r/streams/count"]
    finally:
        await h2.close()
        await linker.close()


def test_stream_sentinel_snapshot_alike(tmp_path):
    disco = tmp_path / "disco"
    disco.mkdir()

    async def go():
        backends = await Backends().start(disco)
        try:
            return {pkg: await sentinel_run(pkg, disco, backends)
                    for pkg in ("ref", "port")}
        finally:
            await backends.close()

    got = run(go())
    assert got["port"] == got["ref"]
    label, sums, snap, count = got["port"]
    assert sums == [[sum(range(40))], [sum(range(9))], [sum(range(17))], 50]
    assert snap["count"] == count == 4
    streams = snap["by_stream"].values()
    assert sum(s["samples"] for s in streams) > 0
    assert all(s["frames"] == 4 * s["samples"] for s in streams)


def test_admin_streams_json_alike():
    """``/streams.json`` of both linkers lists the h2 router's sentinel
    (``Linker.stream_sentinels``) alike."""
    from linkerd_tpu.admin.handlers import (
        linkerd_admin_handlers as ref_handlers,
    )
    from linkerd_tpu_torch.admin.handlers import linkerd_admin_handlers

    bodies = {}
    for pkg, mk in (("ref", ref_handlers), ("port", linkerd_admin_handlers)):
        linker = load(pkg, h2_text("  servers: [{port: 0}]\n"
                                   "  streamScoring: {action: observe}\n"))
        try:
            handler = dict(mk(linker))["/streams.json"]
            bodies[pkg] = json.loads(run(handler(None)).body)
        finally:
            run(linker.close())
    assert bodies["port"] == bodies["ref"]
    assert bodies["port"]["h2"]["enabled"] is True


def test_clear_context_server_strips_l5d_headers(tmp_path):
    """A ``clearContext`` server of an h2 router wraps its stack in
    ``H2ClearContextFilter``; the first server does not."""
    disco = tmp_path / "disco"
    disco.mkdir()
    linker = port_load_linker(config(disco, telemetry=False), device="cpu")
    try:
        plain, cleared = (s.service for s in linker.routers[0].servers)
        assert plain is linker.routers[0].service
        assert isinstance(cleared._filter, H2ClearContextFilter)
    finally:
        run(linker.close())


def test_h2c_upgrade_through_the_router_alike(tmp_path):
    """An h2c upgrade carrying a gRPC call, sent to each linker's
    clearContext server: 101, then the call routed to its destination
    and answered alike."""
    disco = tmp_path / "disco"
    disco.mkdir()
    codec = grpc.Codec(Msg)
    body = codec.encode_frame(Msg(n=7))

    async def go():
        backends = await Backends().start(disco)
        out = {}
        try:
            for pkg in ("ref", "port"):
                linker = load(pkg, config(disco, telemetry=False))
                await linker.start()
                try:
                    out[pkg] = await upgrade_exchange(
                        linker.routers[0].server_ports[1], body, host="d2",
                        path="/test.Route/Echo",
                        headers=(("content-type", "application/grpc"),
                                 ("te", "trailers")))
                finally:
                    await linker.close()
            return out
        finally:
            await backends.close()

    out = run(go())
    assert out["port"] == out["ref"]
    line, status, data, trailers = out["port"]
    assert line.startswith(b"HTTP/1.1 101") and status == "200"
    (flag, payload), = grpc.GrpcFramer().feed(data)
    assert codec.decode_payload(flag, payload).text == "d2"
    assert ("grpc-status", "0") in trailers


def test_cli_serves_the_h2_grpc_fixture(tmp_path):
    """``python -m linkerd_tpu_torch --device cpu`` on
    ``tests/configs/linker-h2-grpc.yml`` (copied with a free port, an
    admin port, the io.l5d.jaxAnomaly telemeter and usage off; the
    fixture is not edited) serves a gRPC call to its destination and
    counts it in ``/admin/metrics.json``."""
    import yaml

    from tests.test_torch_cli import (
        CONFIGS, free_port, http, spawn, stop, wait_ping,
    )

    cfg = yaml.safe_load((CONFIGS / "linker-h2-grpc.yml").read_text())
    port, admin = free_port(), free_port()
    cfg["routers"][0]["servers"][0]["port"] = port
    cfg["namers"][0]["rootDir"] = str(tmp_path / "disco")
    cfg.update(admin={"port": admin}, usage={"enabled": False},
               telemetry=[{"kind": "io.l5d.jaxAnomaly",
                           "trainEveryBatches": 0}])
    (tmp_path / "disco").mkdir()
    path = tmp_path / "h2.json"
    path.write_text(json.dumps(cfg))

    async def call():
        backends = Backends()
        await backends.start(tmp_path / "disco")
        # io.l5d.header.path with 2 segments: /svc/test.Route/Echo
        (tmp_path / "disco" / "test.Route").write_text(
            (tmp_path / "disco" / "d3").read_text())
        h2 = H2Client("127.0.0.1", port)
        try:
            _, msg, sdef, stub = stubs("port", h2, 3)
            return (await stub.unary(sdef, "Echo", msg(n=4))).text
        finally:
            await h2.close()
            await backends.close()

    proc = spawn("linkerd_tpu_torch", "--device", "cpu", path, cwd=tmp_path)
    try:
        wait_ping(proc, admin)
        assert run(call()) == "d3"
        flat = json.loads(http("GET", admin, "/admin/metrics.json")[1])
        assert flat["rt/grpc/server/requests"] == 1
        assert flat["rt/grpc/service/svc.test.Route.Echo/requests"] == 1
        assert flat["anomaly/requests_total"] == 1
    finally:
        rc = stop(proc)
    assert rc == 0, proc.stderr.read()[-3000:]
