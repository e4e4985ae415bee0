"""The port's HTTP/1.1 codec and router stacks against the JAX
package's on the same inputs: raw request and response bytes parse to
equal messages (or raise the same error class) and serialize back to
equal bytes; and on the same response sequences, each classifier's
classes, ``ClassifiedRetries``' retries and budget, ``DeadlineFilter``'s
outcomes on a scripted clock, the failure-accrual kinds' dead/alive
decisions and each balancer kind's picks are equal."""

import asyncio
import random

import numpy as np
import pytest

import linkerd_tpu.config as ref_config
import linkerd_tpu.router.balancer as ref_balancer
import linkerd_tpu.router.classifiers as ref_classifiers
import linkerd_tpu.router.deadline as ref_deadline
import linkerd_tpu.router.failure_accrual as ref_accrual
import linkerd_tpu.router.retries as ref_retries
import linkerd_tpu_torch.config as port_config
import linkerd_tpu_torch.router.balancer as port_balancer
import linkerd_tpu_torch.router.classifiers as port_classifiers
import linkerd_tpu_torch.router.deadline as port_deadline
import linkerd_tpu_torch.router.failure_accrual as port_accrual
import linkerd_tpu_torch.router.retries as port_retries
from linkerd_tpu.core import Var as RefVar
from linkerd_tpu.core.addr import Address as RefAddress, Bound as RefBound
from linkerd_tpu.protocol.http import codec as ref_codec
from linkerd_tpu.protocol.http.message import (
    Request as RefRequest, Response as RefResponse,
)
from linkerd_tpu.router.service import FnService as RefFn
from linkerd_tpu.telemetry.metrics import MetricsTree as RefMetrics
from linkerd_tpu_torch.core import Var as PortVar
from linkerd_tpu_torch.core.addr import Address as PortAddress, Bound as PortBound
from linkerd_tpu_torch.protocol.http import codec as port_codec
from linkerd_tpu_torch.protocol.http.message import (
    Request as PortRequest, Response as PortResponse,
)
from linkerd_tpu_torch.router.service import FnService as PortFn
from linkerd_tpu_torch.telemetry.metrics import MetricsTree as PortMetrics

PKG = {
    "ref": dict(codec=ref_codec, Request=RefRequest, Response=RefResponse,
                config=ref_config, classifiers=ref_classifiers,
                retries=ref_retries, deadline=ref_deadline,
                accrual=ref_accrual, balancer=ref_balancer, Fn=RefFn,
                Var=RefVar, Address=RefAddress, Bound=RefBound,
                Metrics=RefMetrics),
    "port": dict(codec=port_codec, Request=PortRequest,
                 Response=PortResponse, config=port_config,
                 classifiers=port_classifiers, retries=port_retries,
                 deadline=port_deadline, accrual=port_accrual,
                 balancer=port_balancer, Fn=PortFn, Var=PortVar,
                 Address=PortAddress, Bound=PortBound, Metrics=PortMetrics),
}


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, 30))


class Sink:
    """A stream writer that keeps what is written."""

    def __init__(self):
        self.data = b""

    def write(self, b: bytes) -> None:
        self.data += b


# -- codec --------------------------------------------------------------

REQUESTS = [
    b"GET / HTTP/1.1\r\nHost: a\r\n\r\n",
    b"GET /x?y=1 HTTP/1.0\r\nHost: a\r\nConnection: close\r\n\r\n",
    b"POST /p HTTP/1.1\r\nHost: a\r\nContent-Length: 5\r\n\r\nhello",
    b"POST /c HTTP/1.1\r\nTransfer-Encoding: chunked\r\n\r\n"
    b"5;ext=1\r\nhello\r\n6\r\n world\r\n0\r\nX-Trailer: t\r\n\r\n",
    # two requests on one keep-alive connection
    b"GET /1 HTTP/1.1\r\nHost: a\r\n\r\nPUT /2 HTTP/1.1\r\nHost: b\r\n"
    b"Content-Length: 2\r\n\r\nok",
    b"GET / HTTP/1.1\r\nHost: a\r\nX-Dup: 1\r\nx-dup: 2\r\n\r\n",
    b"GET / HTTP/1.1\r\nHost:   spaced   \r\n\r\n",
    # oversized: a header line, the whole head, the body
    b"GET / HTTP/1.1\r\nX-Big: " + b"a" * 9000 + b"\r\n\r\n",
    b"GET / HTTP/1.1\r\n" + b"".join(
        b"X-%d: %s\r\n" % (i, b"v" * 4000) for i in range(20)) + b"\r\n",
    b"POST / HTTP/1.1\r\nContent-Length: 4096\r\n\r\n" + b"b" * 4096,
    b"POST / HTTP/1.1\r\nTransfer-Encoding: chunked\r\n\r\n"
    b"1000\r\n" + b"c" * 4096 + b"\r\n0\r\n\r\n",
    # malformed
    b"GARBAGE\r\n\r\n",
    b"GET / HTTP/2.0\r\n\r\n",
    b"GET / HTTP/1.1\r\nno-colon-here\r\n\r\n",
    b"POST / HTTP/1.1\r\nContent-Length: x\r\n\r\n",
    b"POST / HTTP/1.1\r\nContent-Length: 3\r\nContent-Length: 4\r\n\r\nabcd",
    b"POST / HTTP/1.1\r\nContent-Length: 10\r\n\r\nshort",
    b"POST / HTTP/1.1\r\nTransfer-Encoding: chunked\r\n\r\nzz\r\n",
    b"POST / HTTP/1.1\r\nTransfer-Encoding: chunked\r\n\r\n3\r\nabcXY",
    b"GET / HTTP/1.1\r\nHost: a\r\n",
    b"",
    b"\r\n",
]

RESPONSES = [
    (b"HTTP/1.1 200 OK\r\nContent-Length: 2\r\n\r\nok", "GET"),
    (b"HTTP/1.1 404 Not Found\r\nContent-Length: 0\r\n\r\n", "GET"),
    (b"HTTP/1.1 200 OK\r\nTransfer-Encoding: chunked\r\n\r\n"
     b"3\r\nabc\r\n0\r\n\r\n", "GET"),
    (b"HTTP/1.1 200 OK\r\nContent-Length: 5\r\n\r\n", "HEAD"),
    (b"HTTP/1.1 204 No Content\r\n\r\n", "GET"),
    (b"HTTP/1.1 304 Not Modified\r\n\r\n", "GET"),
    (b"HTTP/1.1 100 Continue\r\n\r\n", "GET"),
    (b"HTTP/1.1 200 Connection established\r\n\r\ntunnel", "CONNECT"),
    (b"HTTP/1.0 200 OK\r\nConnection: close\r\n\r\nuntil close", "GET"),
    (b"HTTP/1.1 503\r\nContent-Length: 1\r\n\r\nx", "GET"),
    (b"HTTP/1.1 200 OK\r\nContent-Length: 4096\r\n\r\n" + b"r" * 4096,
     "GET"),
    (b"HTTP/1.1 abc OK\r\n\r\n", "GET"),
    (b"FTP 200 OK\r\n\r\n", "GET"),
    (b"HTTP/1.1 200 OK\r\nContent-Length: 9\r\n\r\nshort", "GET"),
    (b"HTTP/1.1 200 OK\r\nbroken header\r\n\r\n", "GET"),
]
MAX_BODY = 1024


def seeded_requests(seed: int, n: int):
    rng = np.random.default_rng(seed)
    names = ("Host", "X-A", "x-b", "Accept", "l5d-dtab", "User-Agent")
    out = []
    for _ in range(n):
        method = ("GET", "POST", "PUT", "DELETE", "HEAD")[rng.integers(5)]
        uri = "/" + "/".join(f"s{int(v)}" for v in rng.integers(
            0, 99, size=rng.integers(0, 4)))
        head = [f"{method} {uri} HTTP/1.1"]
        for _ in range(int(rng.integers(0, 6))):
            value = "".join(chr(c) for c in rng.integers(33, 127, size=int(
                rng.integers(0, 20)))).replace(":", ";")
            head.append(f"{names[rng.integers(len(names))]}: {value}")
        body = bytes(rng.integers(0, 256, size=int(rng.integers(0, 64)),
                                  dtype=np.uint8))
        framing = rng.integers(3)
        if framing == 0 and body:
            head.append(f"Content-Length: {len(body)}")
            raw = "\r\n".join(head).encode() + b"\r\n\r\n" + body
        elif framing == 1:
            head.append("Transfer-Encoding: chunked")
            raw = "\r\n".join(head).encode() + b"\r\n\r\n"
            if body:
                raw += b"%x\r\n" % len(body) + body + b"\r\n"
            raw += b"0\r\n\r\n"
        else:
            raw = "\r\n".join(head).encode() + b"\r\n\r\n"
        out.append(raw)
    return out


def parse_all(pkg: str, raw: bytes, response_method=None):
    """Every message in ``raw``, each as its fields and re-serialized
    bytes, until the stream ends or a parse error (its class name)."""
    p = PKG[pkg]
    codec = p["codec"]

    async def go():
        reader = asyncio.StreamReader()
        reader.feed_data(raw)
        reader.feed_eof()
        out = []
        while True:
            try:
                if response_method is None:
                    m = await codec.read_request(reader, max_body=MAX_BODY)
                else:
                    m = await codec.read_response(
                        reader, response_method, max_body=MAX_BODY)
            except EOFError:
                out.append("eof")
                return out
            except Exception as e:  # noqa: BLE001 — compared by class
                out.append(("error", type(e).__name__))
                return out
            sink = Sink()
            if response_method is None:
                fields = (m.method, m.uri, m.version, m.headers.items(),
                          m.body)
                codec.write_request(sink, m)
            else:
                fields = (m.status, m.reason, m.version, m.headers.items(),
                          m.body)
                codec.write_response(sink, m)
            out.append((fields, sink.data))
            if response_method is not None:
                return out

    return run(go())


def ref_pure(raw: bytes, monkeypatch, response_method=None):
    """The reference's pure-Python parser, its native head parser off."""
    with monkeypatch.context() as m:
        m.setattr(ref_codec, "_native", None)
        return parse_all("ref", raw, response_method)


def assert_request_parity(raw: bytes, monkeypatch) -> None:
    """The port parses as the reference's pure-Python path does, and as
    the reference's default path (native head parser where built) except
    where the reference's two paths disagree with each other: a head cut
    off at a line end reads as HttpCodecError natively and as a clean
    EOFError in pure Python."""
    port, pure = parse_all("port", raw), ref_pure(raw, monkeypatch)
    assert port == pure
    default = parse_all("ref", raw)
    if default != pure:
        assert default[-1] == ("error", "HttpCodecError") and \
            pure[-1] == "eof" and default[:-1] == pure[:-1], raw
    else:
        assert port == default


@pytest.mark.parametrize("i", range(len(REQUESTS)))
def test_requests_parse_and_serialize_alike(i, monkeypatch):
    assert_request_parity(REQUESTS[i], monkeypatch)


@pytest.mark.parametrize("i", range(len(RESPONSES)))
def test_responses_parse_and_serialize_alike(i, monkeypatch):
    raw, method = RESPONSES[i]
    port = parse_all("port", raw, method)
    assert port == parse_all("ref", raw, method)
    assert port == ref_pure(raw, monkeypatch, method)


@pytest.mark.parametrize("seed", range(4))
def test_seeded_requests_alike(seed, monkeypatch):
    reqs = seeded_requests(seed, 60)
    assert_request_parity(b"".join(reqs), monkeypatch)  # one connection
    for raw in reqs:
        assert_request_parity(raw, monkeypatch)


# -- stacks ---------------------------------------------------------------

class Clock:
    """A scripted clock for the modules' ``time``."""

    def __init__(self, t: float = 1_000_000.0):
        self.t = t

    def monotonic(self) -> float:
        return self.t

    def time(self) -> float:
        return self.t

    def time_ns(self) -> int:
        return int(self.t * 1e9)

    def perf_counter(self) -> float:
        return self.t


def scripted(pkg: str, rng: np.random.Generator, n: int):
    """``n`` (request, response or exception) pairs of the package's
    message classes, from ``rng``."""
    p = PKG[pkg]
    out = []
    for _ in range(n):
        method = ("GET", "POST", "PUT", "DELETE", "HEAD", "PATCH")[
            rng.integers(6)]
        req = p["Request"](method=method, uri="/")
        if rng.random() < 0.1:
            out.append((req, None, ConnectionResetError("reset")))
            continue
        status = int((200, 204, 404, 500, 502, 503, 504)[rng.integers(7)])
        rsp = p["Response"](status)
        r = rng.random()
        if r < 0.2:
            rsp.headers.set("l5d-retryable", ("true", "false")[
                rng.integers(2)])
        elif r < 0.4:
            rsp.headers.set("l5d-success-class", ("1.0", "0.0", "bad")[
                rng.integers(3)])
        out.append((req, rsp, None))
    return out


CLASSIFIER_KINDS = sorted(k for k in ref_config.kinds("classifier")
                          if k.startswith("io.l5d.http."))


def test_classifier_kinds_are_the_reference_kinds():
    assert CLASSIFIER_KINDS == sorted(
        k for k in port_config.kinds("classifier"))


@pytest.mark.parametrize("kind", CLASSIFIER_KINDS)
def test_classifiers_classify_alike(kind):
    got = {}
    for pkg in PKG:
        classify = PKG[pkg]["config"].instantiate(
            "classifier", {"kind": kind}).mk()
        got[pkg] = [classify(q, s, e).name
                    for q, s, e in scripted(pkg, np.random.default_rng(1), 300)]
    assert got["port"] == got["ref"]
    assert len(set(got["port"])) > 1


def retry_run(pkg: str, seed: int, monkeypatch):
    """A request stream through ClassifiedRetries over scripted
    responses, the clock stepping between requests: each request's final
    status (or error), the counters and the budget's balance."""
    p = PKG[pkg]
    clock = Clock()
    monkeypatch.setattr(p["retries"], "time", clock)
    rng = np.random.default_rng(seed)
    statuses = iter(rng.choice([200, 500, 503, 502], size=4000,
                               p=[0.5, 0.2, 0.2, 0.1]).tolist())

    async def backend(req):
        return p["Response"](next(statuses))

    classify = p["config"].instantiate(
        "classifier", {"kind": "io.l5d.http.retryableRead5XX"}).mk()
    budget = p["retries"].RetryBudget(ttl_s=10, min_retries_per_s=1,
                                      percent_can_retry=0.2)
    mt = p["Metrics"]()
    svc = p["retries"].ClassifiedRetries(
        classify, budget, [0.0] * 3, max_retries=3, metrics=mt,
        scope=("rt", "x"))

    async def go():
        out = []
        for i in range(300):
            clock.t += float(rng.exponential(0.05))
            req = p["Request"](method=("GET", "POST")[i % 2], uri="/")
            rsp = await svc.apply(req, p["Fn"](backend))
            out.append((rsp.status, req.ctx["response_class"].name,
                        round(budget.balance(), 9)))
        return out, {k: v for k, v in mt.flatten().items()}

    return run(go())


@pytest.mark.parametrize("seed", range(3))
def test_classified_retries_and_budget_alike(seed, monkeypatch):
    port = retry_run("port", seed, monkeypatch)
    ref = retry_run("ref", seed, monkeypatch)
    assert port == ref
    assert port[1]["rt/x/retries/total"] > 0
    assert port[1]["rt/x/retries/budget_exhausted"] > 0


def deadline_run(pkg: str, monkeypatch):
    """DeadlineFilter (under ServerDeadlineFilter) on a scripted clock:
    each case's outcome and the deadline the service saw."""
    p = PKG[pkg]
    clock = Clock()
    monkeypatch.setattr(p["deadline"], "time", clock)
    dl_mod = p["deadline"]
    cases = [
        # (incoming header: seconds from now or None, total timeout,
        #  service sleep in real seconds)
        (None, None, 0.0), (None, 1.0, 0.0), (5.0, None, 0.0),
        (5.0, 1.0, 0.0), (0.5, 1.0, 0.0), (-0.2, 1.0, 0.0),
        (-0.2, None, 0.0), (0.05, None, 0.3), (None, 0.05, 0.3),
        ("garbage", 1.0, 0.0), ("1 2 3", None, 0.0),
    ]

    async def go():
        out = []
        for incoming, total, sleep_s in cases:
            clock.t += 1.0
            req = p["Request"](uri="/")
            if isinstance(incoming, str):
                req.headers.set(dl_mod.CTX_DEADLINE, incoming)
            elif incoming is not None:
                req.headers.set(dl_mod.CTX_DEADLINE, dl_mod.Deadline(
                    clock.time_ns() - 10, clock.time_ns()
                    + int(incoming * 1e9)).encode())
            seen = []

            async def backend(r, _s=sleep_s, _seen=seen):
                d = dl_mod.deadline_of(r)
                _seen.append(None if d is None else d.encode())
                if _s:
                    await asyncio.sleep(_s)
                return p["Response"](200)

            svc = p["Fn"](backend)
            inner = p["Fn"](lambda r, _svc=svc: dl_mod.DeadlineFilter(
                total).apply(r, _svc))
            try:
                rsp = await dl_mod.ServerDeadlineFilter().apply(req, inner)
                outcome = ("ok", rsp.status)
            except Exception as e:  # noqa: BLE001 — compared by class
                outcome = ("error", type(e).__name__)
            out.append((outcome, seen))
        return out

    return run(go())


def test_deadline_filter_outcomes_alike(monkeypatch):
    port = deadline_run("port", monkeypatch)
    ref = deadline_run("ref", monkeypatch)
    assert port == ref
    assert {o for o, _ in port} == {("ok", 200),
                                     ("error", "DeadlineExceeded")}


ACCRUAL_KINDS = ("io.l5d.consecutiveFailures", "io.l5d.successRate",
                 "io.l5d.successRateWindowed", "none")


def accrual_run(pkg: str, kind: str, seed: int, monkeypatch):
    """A scripted outcome stream through FailureAccrualService with the
    kind's policy, on a scripted clock: each step's decision and the
    endpoint's status."""
    p = PKG[pkg]
    clock = Clock()
    monkeypatch.setattr(p["accrual"], "time", clock)
    rng = np.random.default_rng(seed)
    outcomes = iter(rng.choice([200, 503], size=2000,
                               p=[0.55, 0.45]).tolist())
    random.seed(seed)  # the default backoffs draw from ``random``
    policy = p["config"].instantiate("failureAccrual", {"kind": kind}).mk()

    async def backend(req):
        return p["Response"](next(outcomes))

    svc = p["accrual"].FailureAccrualService(p["Fn"](backend), policy)

    async def go():
        out = []
        for _ in range(400):
            clock.t += float(rng.exponential(0.5))
            before = svc.status.name
            rsp = await svc(p["Request"](uri="/"))
            out.append((before, rsp.status, svc.status.name,
                        None if svc._dead_until is None
                        else round(svc._dead_until - clock.t, 9)))
        return out

    return run(go())


def test_accrual_kinds_are_the_reference_kinds():
    assert sorted(ACCRUAL_KINDS) == sorted(
        k for k in ref_config.kinds("failureAccrual")
        if k != "io.l5d.jaxAnomaly")
    assert sorted(port_config.kinds("failureAccrual")) == sorted(
        ref_config.kinds("failureAccrual"))


@pytest.mark.parametrize("kind", ACCRUAL_KINDS)
def test_failure_accrual_decides_alike(kind, monkeypatch):
    port = accrual_run("port", kind, 7, monkeypatch)
    ref = accrual_run("ref", kind, 7, monkeypatch)
    assert port == ref
    dead = sum(1 for _, _, st, _ in port if st != "OPEN")
    assert (dead == 0) == (kind == "none")


def balancer_run(pkg: str, kind: str, seed: int, monkeypatch):
    """Rounds of five concurrent requests (so a least-loaded pick
    reaches every replica in a round, whatever the set's iteration
    order) through the kind's balancer over five weighted replicas
    wrapped in consecutive-failures accrual, with a seeded pick
    generator and scripted latencies and statuses: the replica each
    request reached and every replica's status after each round."""
    p = PKG[pkg]
    clock = Clock()
    monkeypatch.setattr(p["balancer"], "time", clock)
    monkeypatch.setattr(p["accrual"], "time", clock)
    random.seed(seed)
    addrs = [p["Address"].mk("10.0.0.%d" % i, 80, w)
             for i, w in enumerate((1.0, 1.0, 2.0, 0.5, 1.0))]
    var = p["Var"](p["Bound"](frozenset(addrs)))
    rng = np.random.default_rng(seed)
    failing = {"10.0.0.3"}

    def endpoint(addr):
        async def handle(req):
            await asyncio.sleep(0)
            for _ in range(int(rng.integers(3))):
                await asyncio.sleep(0)
            status = 503 if addr.host in failing else 200
            rsp = p["Response"](status)
            rsp.headers.set("x-replica", addr.host)
            return rsp
        return p["accrual"].FailureAccrualService(
            p["Fn"](handle), p["accrual"].ConsecutiveFailuresPolicy(1))

    bal = p["balancer"].mk_balancer(kind, var, endpoint,
                                    rng=random.Random(seed))

    async def go():
        out = []
        for _ in range(30):
            clock.t += 0.1
            rsps = await asyncio.gather(*(
                bal(p["Request"](uri="/")) for _ in range(5)))
            out.append(([r.headers.get("x-replica") for r in rsps],
                        sorted((a.host, e.service.status.name)
                               for a, e in bal._endpoints.items())))
        await bal.close()
        return out

    return run(go())


@pytest.mark.parametrize("kind", sorted(ref_balancer.BALANCER_KINDS))
@pytest.mark.parametrize("seed", (0, 1))
def test_balancers_pick_alike(kind, seed, monkeypatch):
    assert sorted(port_balancer.BALANCER_KINDS) == sorted(
        ref_balancer.BALANCER_KINDS)
    port = balancer_run("port", kind, seed, monkeypatch)
    ref = balancer_run("ref", kind, seed, monkeypatch)
    assert port == ref
    if kind != "aperture":  # its aperture of one may never reach .3
        assert any(st != "OPEN" for _, sts in port for _, st in sts)
