"""Istio-Pilot clients: discovery (SDS/RDS) + apiserver route-rules, and
the derived route/cluster caches.

Reference parity: DiscoveryClient.scala (SDS ``/v1/registration/<svc>|
<port>|<k=v>...``, RDS ``/v1/routes``), ApiserverClient.scala
(``/v1alpha1/config/route-rule``), RouteCache.scala:49 (name -> RouteRule
Activity), ClusterCache.scala:37 (domain -> Cluster(dest, port) from RDS
virtual_hosts). All are polling JSON APIs (Pilot has no watch protocol at
this API version); polls publish into Activities so downstream naming
re-binds live.

A copy of ``linkerd_tpu/istio/pilot.py``.
"""

from __future__ import annotations

import asyncio
import json
import logging
import random
import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from linkerd_tpu_torch.core import Activity
from linkerd_tpu_torch.core.activity import Ok
from linkerd_tpu_torch.protocol.http.simple_client import get as http_get

log = logging.getLogger(__name__)


# ---- route-rule model (the JSON shape of istio.proxy.v1.config.RouteRule;
# ref: istio/src/main/protobuf/proxy/v1/config/route_rule.proto via
# ApiserverClient's JSON mapper) --------------------------------------------

@dataclass
class StringMatch:
    """exact | prefix | regex — one set (ref StringMatch oneof)."""

    exact: Optional[str] = None
    prefix: Optional[str] = None
    regex: Optional[str] = None

    def matches(self, value: str) -> bool:
        if self.exact is not None:
            return value == self.exact
        if self.prefix is not None:
            return value.startswith(self.prefix)
        if self.regex is not None:
            return re.fullmatch(self.regex, value) is not None
        return False

    @staticmethod
    def parse(d: Dict[str, Any]) -> "StringMatch":
        return StringMatch(exact=d.get("exact"), prefix=d.get("prefix"),
                           regex=d.get("regex"))


@dataclass
class WeightedDest:
    destination: Optional[str] = None
    weight: int = 0
    tags: Dict[str, str] = field(default_factory=dict)


@dataclass
class RouteRule:
    destination: Optional[str] = None
    precedence: int = 0
    # header name -> match; "uri"/"scheme"/"method"/"authority" are
    # pseudo-headers (ref IstioIdentifierBase.matchesAllConditions)
    match_headers: Dict[str, StringMatch] = field(default_factory=dict)
    rewrite_uri: Optional[str] = None
    rewrite_authority: Optional[str] = None
    redirect_uri: Optional[str] = None
    redirect_authority: Optional[str] = None
    route: List[WeightedDest] = field(default_factory=list)

    @property
    def is_redirect(self) -> bool:
        return (self.redirect_uri is not None
                or self.redirect_authority is not None)

    @staticmethod
    def parse(spec: Dict[str, Any]) -> "RouteRule":
        match = spec.get("match") or {}
        headers = {
            name: StringMatch.parse(m)
            for name, m in (match.get("httpHeaders") or {}).items()
        }
        rewrite = spec.get("rewrite") or {}
        redirect = spec.get("redirect") or {}
        routes = [
            WeightedDest(destination=r.get("destination"),
                         weight=int(r.get("weight") or 0),
                         tags=dict(r.get("tags") or {}))
            for r in (spec.get("route") or [])
        ]
        return RouteRule(
            destination=spec.get("destination"),
            precedence=int(spec.get("precedence") or 0),
            match_headers=headers,
            rewrite_uri=rewrite.get("uri"),
            rewrite_authority=rewrite.get("authority"),
            redirect_uri=redirect.get("uri"),
            redirect_authority=redirect.get("authority"),
            route=routes,
        )


# ---- polling machinery -----------------------------------------------------

class _PollingClient:
    """GET a JSON path every ``interval`` into an Activity (ref
    PollingApiClient.scala); jittered backoff on errors."""

    def __init__(self, host: str, port: int, interval: float = 5.0):
        self.host = host
        self.port = port
        self.interval = interval
        self._acts: Dict[str, Activity] = {}
        self._tasks: Dict[str, asyncio.Task] = {}
        self._closed = False

    def watch_json(self, path: str) -> Activity:
        act = self._acts.get(path)
        if act is None:
            act = Activity.mutable()
            self._acts[path] = act
            if not self._closed:
                self._tasks[path] = asyncio.ensure_future(
                    self._poll(path, act))
        return act

    async def get_json(self, path: str) -> Any:
        rsp = await http_get(self.host, self.port, path, timeout=10.0)
        if rsp.status != 200:
            raise RuntimeError(f"pilot {path}: {rsp.status}")
        return json.loads(rsp.body)

    async def _poll(self, path: str, act: Activity) -> None:
        failures = 0
        while True:
            try:
                data = await self.get_json(path)
                act.set_value(data)
                failures = 0
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001 — keep polling
                failures += 1
                if not isinstance(act.current, Ok):
                    act.set_exception(e)
                log.debug("pilot poll %s: %r", path, e)
            await asyncio.sleep(
                self.interval * min(8, 1 + failures)
                * (0.75 + random.random() / 2))

    def close(self) -> None:
        self._closed = True
        for t in self._tasks.values():
            t.cancel()
        self._tasks.clear()


class DiscoveryClient(_PollingClient):
    """Pilot SDS + RDS (ref DiscoveryClient.scala)."""

    def watch_service(self, cluster: str, port_name: str,
                      labels: Dict[str, str]) -> Activity:
        """-> Activity of [(ip, port)] for the cluster/port/label set."""
        selectors = [port_name] + [f"{k}={v}"
                                   for k, v in sorted(labels.items())]
        path = f"/v1/registration/{cluster}|{'|'.join(selectors)}"
        return self.watch_json(path).map(self._parse_sds)

    @staticmethod
    def _parse_sds(data: Any) -> List[Tuple[str, int]]:
        return [(h.get("ip_address", ""), int(h.get("port", 0)))
                for h in (data.get("hosts") or [])]

    def watch_routes(self) -> Activity:
        """-> Activity of the raw RDS route configs."""
        return self.watch_json("/v1/routes")


class ApiserverClient(_PollingClient):
    """Pilot apiserver route-rule listing (ref ApiserverClient.scala)."""

    URL = "/v1alpha1/config/route-rule"

    def watch_route_rules(self) -> Activity:
        """-> Activity of {name: RouteRule}."""
        def parse(data: Any) -> Dict[str, RouteRule]:
            out: Dict[str, RouteRule] = {}
            for entry in data or []:
                name = entry.get("name")
                spec = entry.get("spec")
                if name and spec is not None:
                    out[name] = RouteRule.parse(spec)
            return out

        return self.watch_json(self.URL).map(parse)


class RouteCache:
    """Held-open name -> RouteRule map (ref RouteCache.scala)."""

    def __init__(self, api: ApiserverClient):
        self.api = api
        self.rules: Activity = api.watch_route_rules()
        self._handle = self.rules.states.observe(lambda _st: None)

    async def get_rules(self) -> Dict[str, RouteRule]:
        st = self.rules.current
        if isinstance(st, Ok):
            return st.value
        return await self.rules.to_future()

    def close(self) -> None:
        self._handle.close()


@dataclass(frozen=True)
class Cluster:
    dest: str
    port: str


class ClusterCache:
    """domain -> Cluster from RDS virtual_hosts, whose names look like
    ``<dest>|<port>`` (ref ClusterCache.scala:37)."""

    def __init__(self, discovery: DiscoveryClient):
        self.discovery = discovery
        self.clusters: Activity = discovery.watch_routes().map(
            self._parse)
        self._handle = self.clusters.states.observe(lambda _st: None)

    @staticmethod
    def _parse(routes: Any) -> Dict[str, Cluster]:
        out: Dict[str, Cluster] = {}
        for rc in routes or []:
            for vhost in rc.get("virtual_hosts") or []:
                name = vhost.get("name") or ""
                parts = name.split("|")
                if len(parts) != 2:
                    log.error("invalid virtual_host name: %s", name)
                    continue
                dest, port = parts
                for domain in vhost.get("domains") or []:
                    out[domain] = Cluster(dest, port)
        return out

    async def get(self, domain: str) -> Optional[Cluster]:
        st = self.clusters.current
        if isinstance(st, Ok):
            return st.value.get(domain)
        d = await self.clusters.to_future()
        return d.get(domain)

    def close(self) -> None:
        self._handle.close()
