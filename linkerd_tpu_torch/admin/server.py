"""Admin server: /config.json, /admin/metrics.json, plugin handlers: a copy of
``linkerd_tpu/admin/server.py``.

Reference parity: admin/.../Admin.scala:1-145 (handler/nav extension
points, default 127.0.0.1:9990) + the always-installed metrics export
telemeter (telemetry/admin-metrics-export: flat or ?tree=true, ?q= subtree
filter) + linkerd/admin LinkerdAdmin composition (/config.json,
/bound-names.json, /delegator.json are added by their owners as handlers).
"""

from __future__ import annotations

import json
from typing import Any, Awaitable, Callable, Dict, List, Optional, Tuple

from linkerd_tpu_torch.protocol.http.message import Request, Response
from linkerd_tpu_torch.protocol.http.server import HttpServer
from linkerd_tpu_torch.router.service import FnService
from linkerd_tpu_torch.telemetry.metrics import MetricsTree

Handler = Callable[[Request], Awaitable[Response]]


def json_response(data: Any, status: int = 200) -> Response:
    rsp = Response(status=status, body=json.dumps(data, indent=2).encode())
    rsp.headers.set("Content-Type", "application/json")
    return rsp


class AdminServer:
    def __init__(self, metrics: MetricsTree, config_dict: Any = None,
                 host: str = "127.0.0.1", port: int = 9990):
        self.metrics = metrics
        self.config_dict = config_dict
        self.host = host
        self.port = port
        self._handlers: Dict[str, Handler] = {}
        self._prefix_handlers: List[Tuple[str, Handler]] = []
        self._server: Optional[HttpServer] = None
        self.add_handler("/ping", self._ping)
        self.add_handler("/config.json", self._config)
        self.add_handler("/admin/metrics.json", self._metrics_json)
        # short alias (namerd's documented surface; same tree)
        self.add_handler("/metrics.json", self._metrics_json)

    def add_handler(self, path: str, handler: Handler) -> None:
        self._handlers[path] = handler

    def add_prefix_handler(self, prefix: str, handler: Handler) -> None:
        """Route every path under ``prefix`` to ``handler`` (exact
        matches win; longest prefix wins among prefixes)."""
        self._prefix_handlers.append((prefix, handler))
        self._prefix_handlers.sort(key=lambda ph: -len(ph[0]))

    def add_handlers(self, handlers: List[Tuple[str, Handler]]) -> None:
        for path, h in handlers:
            self.add_handler(path, h)

    @property
    def bound_port(self) -> int:
        assert self._server is not None
        return self._server.bound_port

    async def start(self) -> "AdminServer":
        self._server = HttpServer(FnService(self._route), self.host, self.port)
        await self._server.start()
        return self

    async def close(self) -> None:
        if self._server is not None:
            await self._server.close()

    # -- routing ----------------------------------------------------------
    async def _route(self, req: Request) -> Response:
        handler = self._handlers.get(req.path)
        if handler is None:
            for prefix, h in self._prefix_handlers:
                if req.path.startswith(prefix):
                    handler = h
                    break
        if handler is None:
            return json_response(
                {"error": "not found", "handlers": sorted(self._handlers)},
                status=404)
        try:
            return await handler(req)
        except Exception as e:  # noqa: BLE001
            return json_response({"error": repr(e)}, status=500)

    # -- built-ins --------------------------------------------------------
    async def _ping(self, req: Request) -> Response:
        return Response(body=b"pong")

    async def _config(self, req: Request) -> Response:
        return json_response(self.config_dict)

    async def _metrics_json(self, req: Request) -> Response:
        query = _parse_query(req.uri)
        if query.get("tree") in ("true", "1"):
            return json_response(self.metrics.tree_dict())
        flat = self.metrics.flatten()
        q = query.get("q")
        if q:
            flat = {k: v for k, v in flat.items() if k.startswith(q)}
        return json_response(flat)


def _parse_query(uri: str) -> Dict[str, str]:
    i = uri.find("?")
    if i < 0:
        return {}
    out: Dict[str, str] = {}
    for pair in uri[i + 1:].split("&"):
        if "=" in pair:
            k, v = pair.split("=", 1)
            out[k] = v
        elif pair:
            out[pair] = "true"
    return out
