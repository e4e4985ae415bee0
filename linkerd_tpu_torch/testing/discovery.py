"""Scripted consul and Marathon servers on the port's ``HttpServer``, for
the discovery namers' tests and the card harness (ZooKeeper's is
``testing/zkserver.py``).

``FakeConsul`` serves the agent's health API the ``io.l5d.consul`` namer
long-polls: ``/v1/health/service/<svc>`` answers the service's passing
entries with ``X-Consul-Index``, and a query at the current index is
held until the index moves (a write) or ``hold_s`` passes, as consul's
blocking queries are. ``FakeMarathon`` serves ``/v2/apps`` and
``/v2/apps/<id>/tasks`` (404 for an app it does not hold), which the
``io.l5d.marathon`` namer polls every ``ttlMs``.
"""

from __future__ import annotations

import asyncio
import json
import time
from typing import Dict, List, Optional, Tuple
from urllib.parse import parse_qsl, urlsplit

from linkerd_tpu_torch.protocol.http.message import Request, Response
from linkerd_tpu_torch.protocol.http.server import HttpServer
from linkerd_tpu_torch.router.service import FnService

HostPort = Tuple[str, int]


class _Served:
    def __init__(self):
        self.server: Optional[HttpServer] = None

    @property
    def port(self) -> int:
        return self.server.bound_port

    async def start(self, host: str = "127.0.0.1", port: int = 0):
        self.server = await HttpServer(FnService(self.handle), host=host,
                                       port=port).start()
        return self

    async def handle(self, req: Request) -> Response:
        raise NotImplementedError


class FakeConsul(_Served):
    def __init__(self, hold_s: float = 5.0):
        super().__init__()
        self.hold_s = hold_s
        self.index = 1
        self.services: Dict[str, List[dict]] = {}
        # monotonic instant of each write, by service
        self.written: Dict[str, float] = {}
        self._changed = asyncio.Event()
        self._closing = False

    def set_service(self, name: str, hostports: List[HostPort]) -> None:
        """The service's passing entries become ``hostports`` (one node
        each) under a new index; held queries answer."""
        self.services[name] = [
            {"Node": {"Node": f"node-{host}-{port}", "Address": host},
             "Service": {"Service": name, "Address": host, "Port": port}}
            for host, port in hostports]
        self.index += 1
        self.written[name] = time.monotonic()
        self._wake()

    def _wake(self) -> None:
        self._changed.set()
        self._changed = asyncio.Event()

    async def handle(self, req: Request) -> Response:
        parts = urlsplit(req.uri)
        if not parts.path.startswith("/v1/health/service/"):
            return Response(status=404, body=b"not found")
        q = dict(parse_qsl(parts.query, keep_blank_values=True))
        want = q.get("index")
        if want is not None and int(want) >= self.index \
                and not self._closing:
            try:
                await asyncio.wait_for(self._changed.wait(), self.hold_s)
            except asyncio.TimeoutError:
                pass
        svc = parts.path[len("/v1/health/service/"):]
        rsp = Response(status=200, body=json.dumps(
            self.services.get(svc, [])).encode())
        rsp.headers.set("X-Consul-Index", str(self.index))
        rsp.headers.set("Content-Type", "application/json")
        return rsp

    async def close(self) -> None:
        """Answers every held query, then stops serving."""
        self._closing = True
        self._wake()
        if self.server is not None:
            await self.server.close()


class FakeMarathon(_Served):
    def __init__(self):
        super().__init__()
        self.apps: Dict[str, List[HostPort]] = {}
        self.written: Dict[str, float] = {}

    def set_app(self, app_id: str, hostports: List[HostPort]) -> None:
        """App ``app_id`` (``/name``) runs one task on each of
        ``hostports``."""
        self.apps[app_id] = list(hostports)
        self.written[app_id] = time.monotonic()

    async def handle(self, req: Request) -> Response:
        path = urlsplit(req.uri).path
        if path == "/v2/apps":
            body = {"apps": [{"id": a, "instances": len(t)}
                             for a, t in sorted(self.apps.items())]}
        elif path.startswith("/v2/apps/") and path.endswith("/tasks"):
            app = path[len("/v2/apps"):-len("/tasks")]
            if app not in self.apps:
                return Response(status=404, body=json.dumps(
                    {"message": f"App '{app}' does not exist"}).encode())
            body = {"tasks": [
                {"id": f"{app[1:]}.{i}", "appId": app, "host": host,
                 "ports": [port], "state": "TASK_RUNNING"}
                for i, (host, port) in enumerate(self.apps[app])]}
        else:
            return Response(status=404, body=b"not found")
        rsp = Response(status=200, body=json.dumps(body).encode())
        rsp.headers.set("Content-Type", "application/json")
        return rsp

    async def close(self) -> None:
        if self.server is not None:
            await self.server.close()
