"""Minimal asyncio Consul HTTP API client with blocking queries.

Ref: consul/src/main/scala/io/buoyant/consul/v1/{BaseApi,ConsulApi}.scala —
the blocking-index protocol: pass ``index=<last>`` + ``wait=``, the server
holds the request until the index advances; ``X-Consul-Index`` carries the
new index. An index that goes backwards means reset (start over from 0),
per Consul's documented semantics (SvcAddr.scala:44-60 loop).
"""

from __future__ import annotations

import asyncio
import json
from typing import Any, Dict, Optional, Tuple


class ConsulApiError(Exception):
    def __init__(self, status: int, body: str):
        super().__init__(f"consul api {status}: {body[:200]}")
        self.status = status


class ConsulApi:
    def __init__(self, host: str = "127.0.0.1", port: int = 8500,
                 token: Optional[str] = None, wait: str = "5m",
                 consistency: str = "default"):
        self.host = host
        self.port = port
        self.token = token
        self.wait = wait
        if consistency not in ("default", "stale", "consistent"):
            raise ValueError(f"bad consul consistency {consistency!r}")
        # ref: BaseApi.scala ConsistencyMode — rides every blocking query
        self.consistency = consistency

    async def get(self, path: str,
                  index: Optional[int] = None,
                  extra_timeout: float = 330.0
                  ) -> Tuple[Any, Optional[int]]:
        """One (possibly blocking) GET -> (parsed json, X-Consul-Index)."""
        from linkerd_tpu_torch.protocol.http.simple_client import get as http_get
        sep = "&" if "?" in path else "?"
        uri = path
        if index is not None:
            uri += f"{sep}index={index}&wait={self.wait}"
        headers = {}
        if self.token:
            headers["X-Consul-Token"] = self.token
        rsp = await http_get(self.host, self.port, uri, headers=headers,
                             timeout=extra_timeout)
        if rsp.status != 200:
            raise ConsulApiError(rsp.status,
                                 rsp.body.decode("utf-8", "replace"))
        new_index: Optional[int] = None
        raw_index = rsp.headers.get("x-consul-index")
        if raw_index is not None:
            try:
                new_index = int(raw_index)
            except ValueError:
                pass
        return (json.loads(rsp.body) if rsp.body else None), new_index

    async def health_service(self, name: str, dc: Optional[str] = None,
                             tag: Optional[str] = None,
                             index: Optional[int] = None):
        path = f"/v1/health/service/{name}?passing=true"
        if dc:
            path += f"&dc={dc}"
        if tag:
            path += f"&tag={tag}"
        if self.consistency != "default":
            path += f"&{self.consistency}"
        return await self.get(path, index)

    async def catalog_datacenters(self):
        path = "/v1/catalog/datacenters"
        if self.consistency != "default":
            path += f"?{self.consistency}"
        data, _ = await self.get(path)
        return data or []

    async def catalog_services(self, dc: Optional[str] = None,
                               index: Optional[int] = None):
        path = "/v1/catalog/services"
        if dc:
            path += f"?dc={dc}"
        if self.consistency != "default":
            path += ("&" if "?" in path else "?") + self.consistency
        return await self.get(path, index)
