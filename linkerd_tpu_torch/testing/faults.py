"""Fault injection for labeled anomaly traces.

The reference has no built-in fault injection (SURVEY.md §5); its tests
script faults into fake services. This harness formalizes that: a filter
wrapped around downstream services injects 5xx bursts and latency spikes
per a schedule, and stamps ``fault_label`` into the request ctx so the
anomaly pipeline can be evaluated with ground truth (AUC >= 0.9 target,
BASELINE.md config 3).

A copy of ``linkerd_tpu/testing/faults.py``, except that ``auc`` is the
port's NaN-safe one (``lifecycle/promote.py``).
"""

from __future__ import annotations

import asyncio
import random
import time
from dataclasses import dataclass
from typing import Optional

from linkerd_tpu_torch.lifecycle.promote import auc  # noqa: F401 — NaN-safe
from linkerd_tpu_torch.protocol.http.message import Request, Response
from linkerd_tpu_torch.router.service import Filter, Service


@dataclass
class FaultSpec:
    """What to inject while active."""

    error_rate: float = 0.0       # probability of injected 5xx
    error_status: int = 503
    latency_ms: float = 0.0       # added latency
    latency_jitter_ms: float = 0.0
    # chaos kinds (inactive at their zero values):
    hang_s: float = 0.0            # hold the request this long before
    #                                forwarding (a near-black-hole hop —
    #                                upstream deadlines must fire first)
    connection_reset: bool = False  # abort mid-request with a RST
    trickle_bytes_per_s: float = 0.0  # slow-loris the response body


class FaultInjector(Filter[Request, Response]):
    """Wraps a downstream service; ``active`` toggles the fault window.

    While active, affected requests get ``req.ctx['fault_label'] = 1.0``
    (anomalous); all other requests get 0.0 (normal) so traces are fully
    labeled.
    """

    def __init__(self, spec: FaultSpec, rng: Optional[random.Random] = None):
        self.spec = spec
        self.active = False
        self._rng = rng or random.Random(1234)
        self.injected = 0

    LABEL_HEADER = "l5d-fault-label"

    def _label(self, rsp: Response, label: float) -> Response:
        # The label travels as a response header so it crosses the wire
        # back to the proxy-side FeatureRecorder (the injector typically
        # wraps a downstream in another process).
        rsp.headers.set(self.LABEL_HEADER, "1" if label else "0")
        return rsp

    async def apply(self, req: Request, service: Service) -> Response:
        if not self.active:
            return self._label(await service(req), 0.0)
        spec = self.spec
        if spec.connection_reset:
            self.injected += 1
            raise ConnectionResetError("injected fault: connection reset")
        if spec.hang_s > 0:
            self.injected += 1
            await asyncio.sleep(spec.hang_s)
            return self._label(await service(req), 1.0)
        if spec.trickle_bytes_per_s > 0:
            self.injected += 1
            rsp = await service(req)
            return self._label(self._trickled(rsp), 1.0)
        injected = False
        if spec.latency_ms > 0:
            delay = spec.latency_ms + self._rng.uniform(
                0, spec.latency_jitter_ms)
            await asyncio.sleep(delay / 1e3)
            injected = True
        if spec.error_rate > 0 and self._rng.random() < spec.error_rate:
            self.injected += 1
            return self._label(
                Response(status=spec.error_status, body=b"injected fault"), 1.0)
        if injected:
            self.injected += 1
        return self._label(await service(req), 1.0 if injected else 0.0)

    def _trickled(self, rsp: Response) -> Response:
        """Re-body the response as a drip-fed chunked stream."""
        body = rsp.body or b""
        rate = self.spec.trickle_bytes_per_s
        chunk = max(1, int(rate / 10) or 1)

        async def drip():
            for i in range(0, len(body), chunk):
                yield body[i:i + chunk]
                await asyncio.sleep(chunk / rate)

        rsp.body = b""
        rsp.body_stream = drip()
        return rsp


class BlackholeServer:
    """Transport-level black hole: accepts TCP connections, reads and
    discards forever, never writes a byte. The shape of a hung sidecar
    or a partitioned downstream — connects succeed, requests vanish,
    and only the caller's own deadline gets it unstuck. Chaos tests
    point gRPC/HTTP clients here to prove those deadlines exist."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self.host = host
        self.port = port
        self._server = None
        self._writers: set = set()
        self.connections = 0

    @property
    def bound_port(self) -> int:
        assert self._server is not None, "server not started"
        return self._server.sockets[0].getsockname()[1]

    async def start(self) -> "BlackholeServer":
        self._server = await asyncio.start_server(
            self._on_conn, self.host, self.port)
        return self

    async def _on_conn(self, reader, writer) -> None:
        self.connections += 1
        self._writers.add(writer)
        try:
            while await reader.read(65536):
                pass  # swallow and never answer
        except (ConnectionError, asyncio.CancelledError):
            pass
        finally:
            self._writers.discard(writer)
            writer.close()

    async def close(self) -> None:
        if self._server is not None:
            self._server.close()
        for w in list(self._writers):
            w.close()
        if self._server is not None:
            await self._server.wait_closed()


class FaultScorer:
    """Scorer wrapper driven by a mutable fault ``mode`` — the
    in-process twin of a blackholed/crashing scorer sidecar:

    - ``None``: pass through to the wrapped scorer
    - ``"hang"``: never completes (a black-holed sidecar; the caller's
      per-call deadline must fire)
    - ``"error"``: immediate ConnectionError (a reset/refused sidecar)

    Lifecycle hooks delegate untouched so the wrapper can stand in for
    the real scorer anywhere in the telemeter."""

    def __init__(self, inner):
        self.inner = inner
        self.mode: Optional[str] = None
        self.calls = 0

    async def _gate(self, what: str) -> None:
        self.calls += 1
        if self.mode == "hang":
            await asyncio.Event().wait()  # forever; cancellable
        if self.mode == "error":
            raise ConnectionError(f"injected scorer fault ({what})")

    async def score(self, x):
        await self._gate("score")
        return await self.inner.score(x)

    async def fit(self, x, labels, mask):
        await self._gate("fit")
        return await self.inner.fit(x, labels, mask)

    def __getattr__(self, name):
        if name == "inner":
            raise AttributeError(name)
        return getattr(self.inner, name)


class TenantRetryStorm:
    """Tenant-shaped attacker: a closed-loop flood of concurrent
    requests stamped with one tenant id, hammering as fast as the
    router answers — the shape of a retry storm (every shed/error is
    immediately re-sent). Counts outcomes so the chaos matrix can
    assert the attacker was shed while the victim held."""

    def __init__(self, port: int, host: str, tenant: str,
                 concurrency: int = 16,
                 tenant_header: str = "l5d-tenant", uri: str = "/",
                 retry_delay_s: float = 0.0):
        self.port = port
        self.host = host
        self.tenant = tenant
        self.concurrency = concurrency
        self.tenant_header = tenant_header
        self.uri = uri
        # pause after a non-200 (a real storm's retry backoff); also
        # keeps an in-process attacker from starving the shared event
        # loop the victim runs on
        self.retry_delay_s = retry_delay_s
        self.ok = 0
        self.shed = 0       # 503 + l5d-retryable (or REFUSED)
        self.errors = 0
        self._stop = asyncio.Event()
        self._tasks: list = []

    async def _worker(self) -> None:
        req = (f"GET {self.uri} HTTP/1.1\r\nHost: {self.host}\r\n"
               f"{self.tenant_header}: {self.tenant}\r\n\r\n").encode()
        while not self._stop.is_set():
            try:
                r, w = await asyncio.open_connection("127.0.0.1",
                                                     self.port)
            except OSError:
                self.errors += 1
                await asyncio.sleep(0.01)
                continue
            try:
                while not self._stop.is_set():
                    w.write(req)
                    await w.drain()
                    line = await asyncio.wait_for(r.readline(), 10)
                    if not line:
                        break
                    status = int(line.split()[1])
                    clen = 0
                    while True:
                        h = await r.readline()
                        if h in (b"\r\n", b""):
                            break
                        if h.lower().startswith(b"content-length:"):
                            clen = int(h.split(b":")[1])
                    if clen:
                        await r.readexactly(clen)
                    if status == 200:
                        self.ok += 1
                    elif status == 503:
                        self.shed += 1
                    else:
                        self.errors += 1
                    if status != 200 and self.retry_delay_s > 0:
                        await asyncio.sleep(self.retry_delay_s)
            except (OSError, asyncio.IncompleteReadError,
                    asyncio.TimeoutError, ValueError, IndexError):
                self.errors += 1
            finally:
                w.close()

    def start(self) -> "TenantRetryStorm":
        self._tasks = [asyncio.ensure_future(self._worker())
                       for _ in range(self.concurrency)]
        return self

    async def stop(self) -> None:
        self._stop.set()
        for t in self._tasks:
            t.cancel()
        for t in self._tasks:
            try:
                await t
            except (asyncio.CancelledError, Exception):  # noqa: BLE001
                pass

    @property
    def total(self) -> int:
        return self.ok + self.shed + self.errors

    @property
    def shed_fraction(self) -> float:
        return self.shed / self.total if self.total else 0.0


class SlowlorisAttack:
    """Connection-plane attacker: opens ``conns`` sockets, sends a
    PARTIAL request head (h1) or half a client preface (h2), then
    drips one byte every ``drip_s`` — classic slowloris. Tracks how
    many of its conns the target closed (the defense's kill count)."""

    H1_PARTIAL = b"GET / HTTP/1.1\r\nHost: victim\r\nX-Drip: "
    H2_PARTIAL = b"PRI * HTTP/2.0\r\n"

    def __init__(self, port: int, conns: int = 32, drip_s: float = 5.0,
                 h2: bool = False):
        self.port = port
        self.conns = conns
        self.drip_s = drip_s
        self.partial = self.H2_PARTIAL if h2 else self.H1_PARTIAL
        self.closed_by_target = 0
        self.opened = 0
        self._stop = asyncio.Event()
        self._tasks: list = []

    async def _worker(self) -> None:
        while not self._stop.is_set():
            try:
                r, w = await asyncio.open_connection("127.0.0.1",
                                                     self.port)
            except OSError:
                await asyncio.sleep(0.05)
                continue
            self.opened += 1
            try:
                w.write(self.partial)
                await w.drain()
                while not self._stop.is_set():
                    # a closed conn surfaces as EOF on read
                    try:
                        data = await asyncio.wait_for(
                            r.read(256), self.drip_s)
                    except asyncio.TimeoutError:
                        w.write(b"x")  # the drip
                        await w.drain()
                        continue
                    if not data:
                        self.closed_by_target += 1
                        break
            except OSError:
                self.closed_by_target += 1
            finally:
                w.close()

    def start(self) -> "SlowlorisAttack":
        self._tasks = [asyncio.ensure_future(self._worker())
                       for _ in range(self.conns)]
        return self

    async def stop(self) -> None:
        self._stop.set()
        for t in self._tasks:
            t.cancel()
        for t in self._tasks:
            try:
                await t
            except (asyncio.CancelledError, Exception):  # noqa: BLE001
                pass


class ConnectionChurnAttack:
    """Connection-plane attacker: opens and immediately abandons
    connections at rate — the TCP/TLS churn flood that thrashes accept
    queues and handshake state. ``tls_context`` upgrades each conn to
    a full TLS handshake (the expensive variant the handshake-churn
    backpressure exists for)."""

    def __init__(self, port: int, rate_per_s: float = 500.0,
                 workers: int = 8, tls_context=None):
        self.port = port
        self.rate_per_s = rate_per_s
        self.workers = workers
        self.tls_context = tls_context
        self.opened = 0
        self.refused = 0  # connect/handshake rejected by the target
        self._stop = asyncio.Event()
        self._tasks: list = []

    async def _worker(self) -> None:
        delay = self.workers / max(1.0, self.rate_per_s)
        while not self._stop.is_set():
            try:
                r, w = await asyncio.wait_for(
                    asyncio.open_connection(
                        "127.0.0.1", self.port, ssl=self.tls_context,
                        server_hostname=("localhost"
                                         if self.tls_context else None)),
                    5)
                self.opened += 1
                w.close()
            except (OSError, asyncio.TimeoutError, ConnectionError):
                self.refused += 1
            await asyncio.sleep(delay)

    def start(self) -> "ConnectionChurnAttack":
        self._tasks = [asyncio.ensure_future(self._worker())
                       for _ in range(self.workers)]
        return self

    async def stop(self) -> None:
        self._stop.set()
        for t in self._tasks:
            t.cancel()
        for t in self._tasks:
            try:
                await t
            except (asyncio.CancelledError, Exception):  # noqa: BLE001
                pass


class PacedTenantClient:
    """The victim tenant: paced (open-loop) requests with its own
    tenant id, recording per-request latency + outcome so the chaos
    matrix can assert its p99 and success rate held while the attacker
    was shed."""

    def __init__(self, port: int, host: str, tenant: str,
                 rate_per_s: float = 50.0,
                 tenant_header: str = "l5d-tenant"):
        self.port = port
        self.host = host
        self.tenant = tenant
        self.rate_per_s = rate_per_s
        self.tenant_header = tenant_header
        self.latencies_ms: list = []
        self.ok = 0
        self.failed = 0

    async def run(self, n: int) -> None:
        req = (f"GET / HTTP/1.1\r\nHost: {self.host}\r\n"
               f"{self.tenant_header}: {self.tenant}\r\n\r\n").encode()
        delay = 1.0 / self.rate_per_s
        r = w = None
        for _ in range(n):
            t0 = time.monotonic()
            try:
                if w is None:
                    r, w = await asyncio.open_connection("127.0.0.1",
                                                         self.port)
                w.write(req)
                await w.drain()
                line = await asyncio.wait_for(r.readline(), 10)
                status = int(line.split()[1])
                clen = 0
                while True:
                    h = await r.readline()
                    if h in (b"\r\n", b""):
                        break
                    if h.lower().startswith(b"content-length:"):
                        clen = int(h.split(b":")[1])
                if clen:
                    await r.readexactly(clen)
                if status == 200:
                    self.ok += 1
                    self.latencies_ms.append(
                        (time.monotonic() - t0) * 1e3)
                else:
                    self.failed += 1
            except (OSError, asyncio.IncompleteReadError,
                    asyncio.TimeoutError, ValueError, IndexError):
                self.failed += 1
                if w is not None:
                    w.close()
                r = w = None
            took = time.monotonic() - t0
            if took < delay:
                await asyncio.sleep(delay - took)
        if w is not None:
            w.close()

    @property
    def success_rate(self) -> float:
        total = self.ok + self.failed
        return self.ok / total if total else 0.0

    def p99_ms(self) -> float:
        if not self.latencies_ms:
            return float("inf")
        xs = sorted(self.latencies_ms)
        return xs[min(len(xs) - 1, int(0.99 * len(xs)))]


class WindowLabeler(Filter[Request, Response]):
    """Labels responses anomalous while a named window is open — used for
    cascade/degradation scenarios where the anomaly is indirect (inherited
    latency), so no injector touches the request itself. The label rides
    the same response header FaultInjector uses."""

    def __init__(self):
        self.active = False

    async def apply(self, req: Request, service: Service) -> Response:
        rsp = await service(req)
        rsp.headers.set(FaultInjector.LABEL_HEADER,
                        "1" if self.active else "0")
        return rsp
