"""Tenant isolation on the port against the JAX package's, on the CPU:
the counterpart of ``tests/test_tenant_isolation.py``.

Every case runs both packages on the same inputs and compares what they
do:

- ``tenant_hash`` on hypothesis-generated strings, in both packages and
  against both native engines' ``tenant_hash_native``;
- tenant extraction from both packages' http and h2 requests;
- ``TenantBoard`` on one scripted ``now`` sequence: equal snapshots and
  levels;
- ``TenantAdmission`` over a stub engine: equal quota pushes;
- the admission filter's per-tenant sub-limits;
- a full linker of each package on the same YAML and scripted traffic:
  equal status sequences and equal ``/tenants.json``;
- the engines' extraction, LRU bound, HTTP/1.1 503 and h2
  ``REFUSED_STREAM`` sheds, and the sharded quota split, on the port's
  engine library beside the reference's.

The native cases need ``g++`` to build the engines, as the reference's
do, and skip with a reason where it is missing.
"""

import asyncio
import json
import random
import shutil
from types import SimpleNamespace

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

import linkerd_tpu.admin.handlers as ref_handlers
import linkerd_tpu.control.admission as ref_cadm
import linkerd_tpu.control.state as ref_state
import linkerd_tpu.protocol.h2.messages as ref_h2m
import linkerd_tpu.protocol.http.message as ref_httpm
import linkerd_tpu.router.admission as ref_radm
import linkerd_tpu.router.fastpath as ref_fastpath
import linkerd_tpu.router.service as ref_service
import linkerd_tpu.router.tenancy as ref_tenancy
import linkerd_tpu.telemetry.metrics as ref_metrics
import linkerd_tpu_torch.admin.handlers as port_handlers
import linkerd_tpu_torch.control.admission as port_cadm
import linkerd_tpu_torch.control.state as port_state
import linkerd_tpu_torch.protocol.h2.messages as port_h2m
import linkerd_tpu_torch.protocol.http.message as port_httpm
import linkerd_tpu_torch.router.admission as port_radm
import linkerd_tpu_torch.router.fastpath as port_fastpath
import linkerd_tpu_torch.router.service as port_service
import linkerd_tpu_torch.router.tenancy as port_tenancy
import linkerd_tpu_torch.telemetry.metrics as port_metrics
from linkerd_tpu.linker import load_linker as ref_load_linker
from linkerd_tpu_torch.linker import load_linker as port_load_linker

PKGS = {
    "ref": SimpleNamespace(
        tenancy=ref_tenancy, cadm=ref_cadm, state=ref_state, h2m=ref_h2m,
        httpm=ref_httpm, radm=ref_radm, fastpath=ref_fastpath,
        service=ref_service, metrics=ref_metrics, handlers=ref_handlers,
        load=ref_load_linker),
    "port": SimpleNamespace(
        tenancy=port_tenancy, cadm=port_cadm, state=port_state,
        h2m=port_h2m, httpm=port_httpm, radm=port_radm,
        fastpath=port_fastpath, service=port_service,
        metrics=port_metrics, handlers=port_handlers,
        load=lambda text: port_load_linker(text, device="cpu")),
}

needs_gxx = pytest.mark.skipif(
    shutil.which("g++") is None,
    reason="the native engines build with g++, which is missing")


def run(coro, timeout=60):
    return asyncio.run(asyncio.wait_for(coro, timeout))


def both(fn):
    """``fn(pkg namespace)`` for each package; asserts they are equal
    and returns the port's."""
    out = {name: fn(ns) for name, ns in PKGS.items()}
    assert out["port"] == out["ref"]
    return out["port"]


# -- the hash ---------------------------------------------------------------

@settings(max_examples=300, deadline=None)
@given(st.text(max_size=80))
def test_tenant_hash_alike(s):
    got = both(lambda p: (p.tenancy.tenant_hash(s),
                          p.tenancy.tenant_feature(p.tenancy.tenant_hash(s))))
    assert got[0] != 0 and 0 <= got[1] < 2 ** 24
    assert got[1] == float(np.float32(got[1]))


@pytest.mark.parametrize("case", ["vectors", "zero folds to one",
                                  "feature fold"])
def test_tenant_hash_reference_values(case):
    if case == "vectors":
        assert both(lambda p: (p.tenancy.tenant_hash("a"),
                               p.tenancy.tenant_hash("foobar"))) == (
            0xE40C292C, 0xBF9CF968)
    elif case == "zero folds to one":
        assert all(both(lambda p: [p.tenancy.tenant_hash(s) != 0 for s in (
            "a", "b", "tenant", "x" * 64)]))
    else:
        fs = both(lambda p: [p.tenancy.tenant_feature(
            p.tenancy.tenant_hash(s)) for s in ("alice", "bob", "t-999")])
        assert all(f == float(np.float32(f)) for f in fs)


@pytest.fixture(scope="module")
def engines():
    """Both packages' engine libraries, built before any event loop runs
    (the port's raises where the build fails)."""
    if shutil.which("g++") is None:
        pytest.skip("the native engines build with g++, which is missing")
    from linkerd_tpu import native as ref_native
    from linkerd_tpu_torch import native as port_native
    port_native.ensure_built()
    if not ref_native.ensure_built():
        pytest.fail("the reference's native library did not build")
    return SimpleNamespace(ref=ref_native, port=port_native)


@settings(max_examples=200, deadline=None)
@given(st.text(max_size=80))
def test_native_tenant_hash_alike_hypothesis(s):
    if shutil.which("g++") is None:
        pytest.skip("the native engines build with g++, which is missing")
    from linkerd_tpu import native as ref_native
    from linkerd_tpu_torch import native as port_native
    b = s.encode("utf-8", "surrogateescape")
    want = port_tenancy.tenant_hash(s)
    assert port_native.tenant_hash_native(b) == want
    assert ref_native.tenant_hash_native(b) == want


@needs_gxx
def test_native_tenant_hash_seeded_ids(engines):
    rng = random.Random(16)
    ids = ["alice", "bob", "tenant-123", "UPPER", "with space", "ümlaut",
           "日本語", "x" * 200] + [f"t{i:02d}" for i in range(16)]
    ids += ["".join(rng.choice("abcdefghijklmnopqrstuvwxyz0123456789-_.")
                    for _ in range(rng.randint(1, 40)))
            for _ in range(10_000)]
    for s in ids:
        want = port_tenancy.tenant_hash(s)
        assert engines.port.tenant_hash_native(s.encode()) == want, s
        assert engines.ref.tenant_hash_native(s.encode()) == want, s


# -- extraction -------------------------------------------------------------

def _http_req(p, uri="/x", **headers):
    req = p.httpm.Request(uri=uri)
    for k, v in headers.items():
        req.headers.set(k.replace("_", "-"), v)
    return req


@pytest.mark.parametrize("case", ["header http and h2", "path segment",
                                  "sni", "validation"])
def test_extraction_alike(case):
    def go(p):
        spec_cls = p.tenancy.TenantIdentifierSpec
        if case == "header http and h2":
            spec = spec_cls(kind="header", header="l5d-tenant")
            h2 = p.h2m.H2Request(path="/x", headers=p.h2m.Headers(
                [("l5d-tenant", "bob")]))
            return [spec.extract(_http_req(p, l5d_tenant="alice")),
                    spec.extract(_http_req(p)), spec.extract(h2),
                    spec.extract(p.h2m.H2Request(path="/x"))]
        if case == "path segment":
            out = []
            for seg in (0, 1, 2):
                spec = spec_cls(kind="pathSegment", segment=seg)
                out += [spec.extract(_http_req(p, uri="/acme/api/v1?q=1")),
                        spec.extract(_http_req(p, uri="/")),
                        spec.extract(p.h2m.H2Request(path="/acme/api"))]
            return out
        if case == "sni":
            spec = spec_cls(kind="sni")
            req = _http_req(p)
            plain = spec.extract(req)
            req.ctx["sni"] = "tenant.example"
            return [plain, spec.extract(req)]
        out = []
        for kw in ({"kind": "nope"}, {"kind": "header", "header": ""},
                   {"kind": "pathSegment", "segment": -1},
                   {"kind": "header"}):
            try:
                spec_cls(**kw).validate("t")
                out.append("ok")
            except ValueError as e:
                out.append(str(e))
        return out
    got = both(go)
    if case == "header http and h2":
        assert got == ["alice", None, "bob", None]


# -- the board --------------------------------------------------------------

def board_script(p, case: str):
    """One scripted ``now`` sequence on a fresh board; returns its
    snapshot and levels."""
    T = p.tenancy
    if case == "error ewma":
        b = T.TenantBoard(alpha=0.3)
        for i in range(20):
            b.observe("bad", error=True, now=1.0 + i * 0.01)
            b.observe("good", error=False, now=1.0 + i * 0.01)
        names = ["bad", "good", "unknown"]
    elif case == "score ewma":
        b = T.TenantBoard()
        b.ingest_native(0x1234, requests=100, errors=3, sheds=2,
                        score_ewma=0.8, scored=100, now=1.0)
        b.ingest_native(0x1234, requests=50, errors=50, sheds=0,
                        score_ewma=0.4, scored=0, now=1.5)
        names = ["#00001234"]
    elif case == "dominance":
        b = T.TenantBoard(window_s=1.0, fair_share_burst=2.0)
        for _ in range(970):
            b.observe("atk", error=False, now=0.5)
        for _ in range(30):
            b.observe("vic", error=False, now=0.5)
        b.observe("atk", error=False, now=2.0)
        b.observe("vic", error=False, now=2.0)
        names = ["atk", "vic"]
    elif case == "lru churn":
        b = T.TenantBoard(max_tenants=64)
        for i in range(10_000):
            b.observe(f"churn-{i}", error=(i % 7 == 0), now=float(i))
        names = sorted(b.active_tenants())
        return (b.snapshot(), [b.level(n) for n in names], b.evicted,
                len(names))
    else:  # a seeded mix of every input
        rng = random.Random(7)
        b = T.TenantBoard(max_tenants=12)
        now = 0.0
        for _ in range(3000):
            now += rng.random() * 0.01
            t = f"t{rng.randrange(16):02d}"
            r = rng.random()
            if r < 0.1:
                b.observe_shed(t, now=now)
            elif r < 0.15:
                b.ingest_native(rng.randrange(1, 2 ** 32), rng.randrange(50),
                                rng.randrange(5), rng.randrange(3),
                                rng.random(), rng.randrange(50), now=now)
            else:
                b.observe(t, error=rng.random() < 0.2,
                          score=rng.random() if r > 0.9 else None, now=now)
        names = sorted(b.active_tenants())
    return b.snapshot(), [b.level(n) for n in names], b.evicted


@pytest.mark.parametrize("case", ["error ewma", "score ewma", "dominance",
                                  "lru churn", "seeded mix"])
def test_board_alike(case):
    got = both(lambda p: board_script(p, case))
    snap, levels = got[0], got[1]
    if case == "error ewma":
        assert levels[0] > 0.9 and levels[1:] == [0.0, 0.0]
    elif case == "score ewma":
        assert snap["#00001234"]["score_ewma"] == pytest.approx(0.8)
    elif case == "dominance":
        assert levels[0] > 0.0 and levels[1] == 0.0
    elif case == "lru churn":
        assert got[3] <= 64 and got[2] > 0


# -- the quota governor over a stub engine ----------------------------------

class StubEngine:
    """Records every quota push, in order."""

    def __init__(self):
        self.pushes = []
        self.quotas = {}

    def set_tenant_quota(self, thash, limit):
        self.pushes.append((thash, limit))
        if limit is None:
            self.quotas.pop(thash, None)
        else:
            self.quotas[thash] = limit


def admission_script(p, case: str):
    T, C, S = p.tenancy, p.cadm, p.state
    gov = dict(enter=0.6, exit=0.2, quorum=3, dwell_s=1.0)
    if case == "quota shrinks then recovers":
        gov["dwell_s"] = 0.0
    if case == "no flapping":
        gov["dwell_s"] = 5.0
    if case == "keys bounded under churn":
        gov.update(quorum=2, dwell_s=0.0)
    board = T.TenantBoard(max_tenants=16 if "churn" in case else 1024)
    ta = C.TenantAdmission(board, governor=S.HysteresisGovernor(**gov),
                           floor=0.125, engine_base=64)
    filt = p.radm.AdmissionControlFilter(32)
    eng = StubEngine()
    ta.register(filt)
    ta.register_engine(eng)
    now = 100.0
    limits = []
    if case == "quota shrinks then recovers":
        for _ in range(5):
            for _ in range(3):
                board.observe("atk", error=True, now=now)
            ta.step(now)
            now += 1.0
        limits.append(filt.tenant_limit_of(T.tenant_hash("atk")))
        for _ in range(60):
            board.observe("atk", error=False, now=now)
            ta.step(now)
            now += 1.0
    elif case == "no flapping":
        for _ in range(10):
            for _ in range(4):
                board.observe("osc", error=True, now=now)
            ta.step(now)
            now += 1.0
        flip = True
        for _ in range(100):
            board.observe("osc", error=flip, now=now)
            flip = not flip
            ta.step(now)
            now += 0.05
    elif case == "keys bounded under churn":
        for i in range(2000):
            board.observe(f"churn-{i}", error=(i % 3 == 0), now=now)
            if i % 10 == 0:
                ta.step(now)
            now += 0.01
        ta.step(now)
    else:  # untracked tenants untouched
        for _ in range(5):
            for _ in range(3):
                board.observe("atk", error=True, now=now)
            board.observe("vic", error=False, now=now)
            ta.step(now)
            now += 1.0
        limits += [filt.tenant_limit_of(T.tenant_hash(t))
                   for t in ("atk", "vic")]
    status = ta.status()
    return (eng.pushes, limits, ta.transitions, len(ta.governor.keys()),
            status["sick"], status["governor"], status["tenants"])


@pytest.mark.parametrize("case", ["quota shrinks then recovers",
                                  "no flapping", "keys bounded under churn",
                                  "untracked tenants untouched"])
def test_tenant_admission_alike(case):
    pushes, limits, transitions, nkeys, *_ = both(
        lambda p: admission_script(p, case))
    th = port_tenancy.tenant_hash
    if case == "quota shrinks then recovers":
        assert pushes == [(th("atk"), 8), (th("atk"), None)]
        assert limits == [4] and transitions == 2
    elif case == "no flapping":
        assert transitions == 1
    elif case == "keys bounded under churn":
        assert nkeys <= 16
    else:
        assert limits[0] is not None and limits[1] is None


# -- the admission filter's per-tenant sub-limits ---------------------------

def sublimit_script(p, queued: bool):
    async def go():
        gate = asyncio.Event()
        out = []

        async def slow(req):
            await gate.wait()
            return "ok"

        th = p.tenancy.tenant_hash
        filt = (p.radm.AdmissionControlFilter(1, max_pending=4) if queued
                else p.radm.AdmissionControlFilter(16))
        filt.set_tenant_limit(th("atk"), 2 if queued else 1)
        svc = p.service.FnService(slow)

        class Req:
            def __init__(self, tenant):
                self.ctx = {"tenant_hash": th(tenant)}

        async def attempt(tenant):
            try:
                return await filt.apply(Req(tenant), svc)
            except p.radm.OverloadShed as e:
                return f"shed: {e}"

        tasks = [asyncio.ensure_future(attempt("atk"))]
        await asyncio.sleep(0.01)
        if queued:
            tasks.append(asyncio.ensure_future(attempt("atk")))
            await asyncio.sleep(0.01)
        out.append(await attempt("atk"))
        tasks.append(asyncio.ensure_future(attempt("vic")))
        await asyncio.sleep(0.01)
        gate.set()
        out += [await t for t in tasks]
        out.append(await attempt("atk"))
        return out, filt.tenant_limit_of(th("atk"))
    return run(go())


@pytest.mark.parametrize("queued", [False, True], ids=["inflight", "queued"])
def test_tenant_sublimits_alike(queued):
    out, limit = both(lambda p: sublimit_script(p, queued))
    assert out[0].startswith("shed") and out[1:] == ["ok"] * (len(out) - 1)


# -- the shed signal --------------------------------------------------------

def test_h2_refused_is_retryable_in_classifiers_alike():
    def go(p):
        import importlib
        root = p.tenancy.__name__.split(".")[0]
        cls = importlib.import_module(f"{root}.protocol.h2.classifiers")
        stream = importlib.import_module(f"{root}.protocol.h2.stream")
        refused = stream.StreamReset(error_code=stream.RST_REFUSED_STREAM)
        req = p.h2m.H2Request(method="POST", path="/")
        return [cfg.mk().classify(req, None, None, refused).name
                for cfg in (cls.H2NonRetryable5XX(),
                            cls.H2RetryableRead5XX(),
                            cls.H2RetryableIdempotent5XX())]
    assert both(go) == ["RETRYABLE_FAILURE"] * 3


# -- a full linker of each package, on scripted traffic ---------------------

async def _backend(p, status: int, hold_s: float = 0.0):
    import importlib
    root = p.tenancy.__name__.split(".")[0]
    server = importlib.import_module(f"{root}.protocol.http.server")

    async def handler(req):
        if hold_s:
            await asyncio.sleep(hold_s)
        return p.httpm.Response(status=status, body=b"x")

    return await server.serve(p.service.FnService(handler))


async def read_response(r):
    """One HTTP/1.1 response off ``r``: (status, headers)."""
    line = await asyncio.wait_for(r.readline(), 10)
    hdrs = {}
    while True:
        ln = await asyncio.wait_for(r.readline(), 10)
        if ln in (b"\r\n", b""):
            break
        k, _, v = ln.decode("latin-1").partition(":")
        hdrs[k.strip().lower()] = v.strip()
    n = int(hdrs.get("content-length", 0))
    if n:
        await asyncio.wait_for(r.readexactly(n), 10)
    return int(line.split()[1]), hdrs


async def _get(port: int, host: str, tenant: str):
    """One request on its own connection: (status, l5d-retryable)."""
    r, w = await asyncio.open_connection("127.0.0.1", port)
    try:
        w.write(f"GET / HTTP/1.1\r\nHost: {host}\r\nl5d-tenant: {tenant}"
                f"\r\n\r\n".encode())
        await w.drain()
        status, hdrs = await read_response(r)
    finally:
        w.close()
    return status, hdrs.get("l5d-retryable") == "true"


LINKER_YAML = """
routers:
- protocol: http
  label: edge
  admissionControl: {{maxConcurrency: 8, maxPending: 0}}
  tenantIdentifier: {{kind: header}}
  tenants: {{floor: 0.1, enterThreshold: 0.6, exitThreshold: 0.2,
            quorum: 2, cooldownS: 0}}
  dtab: |
    /svc => /#/io.l5d.fs ;
  client: {{failureAccrual: {{kind: none}}}}
  servers: [{{port: 0}}]
namers:
- kind: io.l5d.fs
  rootDir: {disco}
"""


def linker_session(p, root):
    """Rounds 0.15 s apart, so the tag filter's interval-gated governor
    steps exactly once a round: ``bad`` sends three concurrent requests a
    round to a failing backend that holds each 30 ms, ``good`` three in
    turn to a healthy one; after ten rounds ``bad`` turns to the healthy
    backend. Returns each round's sorted statuses, the governor's sick
    set after each round, and ``/tenants.json``."""
    disco = root / p.tenancy.__name__.split(".")[0]
    disco.mkdir()

    async def go():
        ok = await _backend(p, 200)
        fail = await _backend(p, 500, hold_s=0.03)
        (disco / "ok").write_text(f"127.0.0.1 {ok.bound_port}\n")
        (disco / "fail").write_text(f"127.0.0.1 {fail.bound_port}\n")
        linker = p.load(LINKER_YAML.format(disco=disco))
        await linker.start()
        port = linker.routers[0].server_ports[0]
        _, board, adm = linker.tenant_views[0]
        rounds = []
        try:
            for i in range(36):
                host = "fail" if i < 10 else "ok"
                bad = await asyncio.gather(
                    *(_get(port, host, "bad") for _ in range(3)))
                good = [await _get(port, "ok", "good") for _ in range(3)]
                rounds.append((sorted(bad), good, adm.status()["sick"]))
                await asyncio.sleep(0.15)
            rsp = await p.handlers.mk_tenants_handler(linker)(
                p.httpm.Request(uri="/tenants.json"))
            tenants = json.loads(rsp.body)
            flat = linker.metrics.flatten()
            counters = {k: v for k, v in flat.items()
                        if "/tenants/" in k or "tenant_shed" in k}
        finally:
            await linker.close()
            await ok.close()
            await fail.close()
        return rounds, tenants, counters
    return run(go(), 90)


def test_linker_statuses_and_tenants_json_alike(tmp_path):
    rounds, tenants, counters = both(lambda p: linker_session(p, tmp_path))
    sick_rounds = [i for i, (_, _, sick) in enumerate(rounds) if sick]
    assert sick_rounds and sick_rounds[0] < 10
    # once SICK, the bad tenant holds one slot and two of its three
    # concurrent requests are shed retryably; the good tenant never is
    shed = [bad for bad, _, sick in rounds if sick and bad[0][0] == 500]
    assert any(bad[1:] == [(503, True), (503, True)] for bad in shed)
    assert all(good == [(200, False)] * 3 for _, good, _ in rounds)
    assert rounds[-1][2] == []
    quotas = tenants["edge"]["quotas"]
    assert quotas["transitions"] == 2 and quotas["sick"] == []
    assert counters["rt/edge/server/tenants/tenant_transitions"] == 2


# -- the fastPath controller's stats tick -----------------------------------

class StubStatsEngine(StubEngine):
    def __init__(self):
        super().__init__()
        self.tenants = {}
        self.guard = {"tenant_shed": 0}

    def stats(self):
        return {"routes": {}, "tenants": {
            "count": len(self.tenants), "evicted": 0,
            "by_tenant": dict(self.tenants)}, "guard": dict(self.guard)}


def controller_script(p):
    eng = StubStatsEngine()
    board = p.tenancy.TenantBoard()
    ta = p.cadm.TenantAdmission(
        board, governor=p.state.HysteresisGovernor(
            enter=0.6, exit=0.2, quorum=2, dwell_s=0.0),
        floor=0.125, engine_base=64)
    ta.register_engine(eng)
    metrics = p.metrics.MetricsTree()
    ctl = p.fastpath.FastPathController(
        eng, None, None, None, "t", metrics, tenant_board=board,
        tenant_admission=ta)
    th = p.tenancy.tenant_hash
    reqs = {"atk": 0, "vic": 0}
    for tick in range(40):
        for t in reqs:
            reqs[t] += 50
        errs = reqs["atk"] if tick < 16 else 16 * 50
        eng.tenants[str(th("atk"))] = {
            "requests": reqs["atk"], "shed": tick, "errors": errs,
            "scored": reqs["atk"], "score_ewma": 0.1, "inflight": 0,
            "quota": -1}
        eng.tenants[str(th("vic"))] = {
            "requests": reqs["vic"], "shed": 0, "errors": 0,
            "scored": reqs["vic"], "score_ewma": 0.05, "inflight": 0,
            "quota": -1}
        eng.guard["tenant_shed"] = tick
        ctl._export_tenants(eng.stats())
    flat = {k: v for k, v in metrics.flatten().items()
            if "/tenant" in k or "/guard/" in k}
    return eng.pushes, board.snapshot(), ta.transitions, flat


def test_stats_tick_feeds_board_and_pushes_quota_alike():
    pushes, snap, transitions, flat = both(controller_script)
    th = port_tenancy.tenant_hash("atk")
    assert pushes == [(th, 8), (th, None)] and transitions == 2
    assert flat[f"rt/t/fastpath/tenant/{th}/requests"] == 40 * 50
    assert snap[f"#{th:08x}"]["score_ewma"] == 0.1


# -- the native engines -----------------------------------------------------

async def ok_backend():
    """A keep-alive backend answering ``ok``; it closes each connection
    when its client goes, so ``wait_closed`` returns."""
    async def handle(r, w):
        try:
            while True:
                await r.readuntil(b"\r\n\r\n")
                w.write(b"HTTP/1.1 200 OK\r\nContent-Length: 2\r\n\r\nok")
                await w.drain()
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        finally:
            w.close()

    srv = await asyncio.start_server(handle, "127.0.0.1", 0)
    return srv, srv.sockets[0].getsockname()[1]


async def h1_get(port, host, uri="/", headers=()):
    r, w = await asyncio.open_connection("127.0.0.1", port)
    try:
        head = f"GET {uri} HTTP/1.1\r\nHost: {host}\r\n"
        for k, v in headers:
            head += f"{k}: {v}\r\n"
        w.write(head.encode() + b"\r\n")
        await w.drain()
        return await read_response(r)
    finally:
        w.close()


async def bounded(aw, s=10):
    return await asyncio.wait_for(aw, s)


def engine_session(native, case: str, workers: int = 1):
    """One engine case on ``native`` (either package's binding): what the
    engine answered and counted."""
    th = port_tenancy.tenant_hash

    async def go():
        srv, bport = await ok_backend()
        eng = native.FastPathEngine(workers=workers)
        try:
            if case == "path segment":
                eng.set_tenant("pathSegment", segment=0)
            else:
                eng.set_tenant("header", "l5d-tenant")
            if case == "lru bound":
                eng.set_guard(tenant_cap=16)
            port = eng.listen("127.0.0.1", 0)
            eng.start()
            eng.set_route("svc", [("127.0.0.1", bport)])
            out = []
            if case == "header":
                for tid in ("alice", "bob", "T-42"):
                    out.append((await bounded(h1_get(
                        port, "svc", headers=[("l5d-tenant", tid)])))[0])
                await asyncio.sleep(0.05)
                rows = eng.drain_features()
                out.append(sorted(float(x) for x in rows[:, 8]))
                out.append(sorted(int(k) for k in
                                  eng.stats()["tenants"]["by_tenant"]))
            elif case == "path segment":
                out.append((await bounded(h1_get(port, "svc",
                                                 uri="/acme/api?q=1")))[0])
                await asyncio.sleep(0.05)
                out.append(float(eng.drain_features()[0, 8]))
            elif case == "lru bound":
                for i in range(200):
                    out.append((await bounded(h1_get(
                        port, "svc", headers=[("l5d-tenant",
                                               f"churn-{i}")])))[0])
                tn = eng.stats()["tenants"]
                out.append(tn["count"] <= 16 and
                           tn["evicted"] >= 200 - 16 - 16)
            elif case == "quota 503":
                eng.set_tenant_quota(th("atk"), 0)
                st_, hdrs = await bounded(h1_get(
                    port, "svc", headers=[("l5d-tenant", "atk")]))
                out.append((st_, hdrs.get("l5d-retryable")))
                out.append((await bounded(h1_get(
                    port, "svc", headers=[("l5d-tenant", "vic")])))[0])
                eng.set_tenant_quota(th("atk"), None)
                out.append((await bounded(h1_get(
                    port, "svc", headers=[("l5d-tenant", "atk")])))[0])
                out.append(eng.stats()["guard"]["tenant_shed"])
            elif case == "sharded split":
                eng.set_tenant_quota(th("t-a"), 6)
                for _ in range(12):
                    out.append((await bounded(h1_get(
                        port, "svc", headers=[("l5d-tenant", "t-a")])))[0])
                st_ = eng.stats()
                # the quotas of the workers that saw the tenant: which
                # workers those are depends on how the kernel spreads
                # the connections, so only the distinct values count
                out.append(sorted({
                    s["tenants"]["by_tenant"][str(th("t-a"))]["quota"]
                    for s in st_["workers"] if s["tenants"]["by_tenant"]}))
                out.append(st_["tenants"]["by_tenant"][
                    str(th("t-a"))]["quota"])
            elif case == "no-route release":
                eng.set_route("dead", [])  # installed, no endpoints: 400
                eng.set_tenant_quota(th("t"), 2)
                for _ in range(5):
                    out.append((await bounded(h1_get(
                        port, "dead", headers=[("l5d-tenant", "t")])))[0])
                out.append((await bounded(h1_get(
                    port, "svc", headers=[("l5d-tenant", "t")])))[0])
                out.append(eng.stats()["tenants"]["by_tenant"][
                    str(th("t"))]["inflight"])
            else:  # sharded zero per worker
                eng.set_tenant_quota(th("t-b"), workers - 1)
                for _ in range(8):
                    out.append((await bounded(h1_get(
                        port, "svc", headers=[("l5d-tenant", "t-b")])))[0])
                out.append((await bounded(h1_get(
                    port, "svc", headers=[("l5d-tenant", "t-c")])))[0])
            return out
        finally:
            eng.close()
            srv.close()
            await bounded(srv.wait_closed())
    return run(go())


@needs_gxx
@pytest.mark.parametrize("case", ["header", "path segment", "lru bound",
                                  "quota 503", "no-route release"])
def test_engine_tenants_alike(engines, case):
    out = engine_session(engines.port, case)
    assert out == engine_session(engines.ref, case)
    ids = ("alice", "bob", "T-42")
    if case == "header":
        assert out[:3] == [200] * 3
        assert out[3] == sorted(port_tenancy.tenant_feature(
            port_tenancy.tenant_hash(t)) for t in ids)
        assert out[4] == sorted(port_tenancy.tenant_hash(t) for t in ids)
    elif case == "path segment":
        assert out == [200, port_tenancy.tenant_feature(
            port_tenancy.tenant_hash("acme"))]
    elif case == "lru bound":
        assert out == [200] * 200 + [True]
    elif case == "no-route release":
        # a synthesized 400 must release the tenant's in-flight slot
        assert out == [400] * 5 + [200, 0]
    else:
        assert out == [(503, "true"), 200, 200, 1]


@needs_gxx
@pytest.mark.parametrize("case", ["sharded split",
                                  "sharded zero per worker"])
def test_sharded_quota_split(engines, case):
    """``set_tenant_quota`` across 4 workers splits by floor division:
    6 is 1 a worker (sequential requests never pass it), and a quota
    under the worker count is 0 a worker, which sheds the tenant on
    every worker while another tenant passes. The backend closes its
    writers and every await is bounded, so the case ends."""
    out = engine_session(engines.port, case, workers=4)
    assert out == engine_session(engines.ref, case, workers=4)
    if case == "sharded split":
        assert out[:12] == [200] * 12
        assert out[12] == [1]
        assert out[13] == 4  # the merged view: the sum of the splits
    else:
        assert out == [503] * 8 + [200]


@needs_gxx
def test_h2_engine_quota_shed_is_refused_stream(engines):
    def go(p, native):
        import importlib
        root = p.tenancy.__name__.split(".")[0]
        client = importlib.import_module(f"{root}.protocol.h2.client")
        server = importlib.import_module(f"{root}.protocol.h2.server")
        stream = importlib.import_module(f"{root}.protocol.h2.stream")
        th = p.tenancy.tenant_hash

        async def main():
            async def handler(req):
                return p.h2m.H2Response(status=200, body=b"ok")

            backend = await server.H2Server(
                p.service.FnService(handler)).start()
            eng = native.H2FastPathEngine()
            eng.set_tenant("header", "l5d-tenant")
            port = eng.listen("127.0.0.1", 0)
            eng.start()
            eng.set_route("echo", [("127.0.0.1", backend.bound_port)])
            h2c = client.H2Client("127.0.0.1", port)
            out = []
            try:
                eng.set_tenant_quota(th("atk"), 0)

                async def get(tenant):
                    req = p.h2m.H2Request(
                        method="GET", path="/", authority="echo",
                        headers=p.h2m.Headers([("l5d-tenant", tenant)]))
                    try:
                        rsp = await bounded(h2c(req))
                        await bounded(rsp.stream.read_all())
                        return rsp.status
                    except stream.StreamReset as e:
                        return f"reset {e.error_code}"

                out += [await get("atk"), await get("vic")]
                eng.set_tenant_quota(th("atk"), None)
                out.append(await get("atk"))
                out.append(eng.stats()["guard"]["tenant_shed"])
            finally:
                await h2c.close()
                eng.close()
                await backend.close()
            return out
        return run(main())
    got = go(PKGS["port"], engines.port)
    assert got == go(PKGS["ref"], engines.ref)
    assert got == ["reset 7", 200, 200, 1]  # 7: REFUSED_STREAM
