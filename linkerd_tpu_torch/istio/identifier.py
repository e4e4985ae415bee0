"""Istio request identifiers (http + h2): route each request through the
cluster cache + route-rules.

Logic (ref IstioIdentifierBase.scala:1-127):
  authority -> ClusterCache -> Cluster(dest, port)
    no vhost              -> /<pfx>/ext/<host>/<port>   (external)
    rules for dest        -> filter by match conditions, take max
                             precedence:
        redirect rule     -> answer 302 directly
        otherwise         -> apply rewrite, route to
                             /<pfx>/route/<ruleName>/<port>
    no matching rule      -> /<pfx>/dest/<dest>/::/<port>

A copy of ``linkerd_tpu/istio/identifier.py``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from linkerd_tpu_torch.config import register
from linkerd_tpu_torch.core import Dtab, Path
from linkerd_tpu_torch.istio.pilot import (
    ApiserverClient, Cluster, ClusterCache, DiscoveryClient, RouteCache,
    RouteRule, StringMatch,
)
from linkerd_tpu_torch.router.binding import DstPath
from linkerd_tpu_torch.router.routing import IdentificationError, parse_local_dtab


@dataclass
class RequestMeta:
    """Normalized request view shared by http and h2
    (ref IstioRequestMeta)."""

    uri: str
    scheme: str
    method: str
    authority: str
    get_header: Callable[[str], Optional[str]]


def header_matches(value: str, sm: StringMatch) -> bool:
    return sm.matches(value)


def matches_all_conditions(meta: RequestMeta,
                           headers: Dict[str, StringMatch]) -> bool:
    for name, sm in headers.items():
        if name == "uri":
            got: Optional[str] = meta.uri
        elif name == "scheme":
            got = meta.scheme
        elif name == "method":
            got = meta.method
        elif name == "authority":
            got = meta.authority
        else:
            got = meta.get_header(name)
        if got is None or not sm.matches(got):
            return False
    return True


def filter_rules(rules: Dict[str, RouteRule], dest: str,
                 meta: RequestMeta) -> List[Tuple[str, RouteRule]]:
    return [
        (name, r) for name, r in rules.items()
        if r.destination == dest
        and matches_all_conditions(meta, r.match_headers)
    ]


def max_precedence(rules: List[Tuple[str, RouteRule]]
                   ) -> Optional[Tuple[str, RouteRule]]:
    if not rules:
        return None
    return max(rules, key=lambda nr: nr[1].precedence)


def http_rewrite(rule: RouteRule, meta: RequestMeta
                 ) -> Tuple[str, Optional[str]]:
    """-> (uri, authority) after the rule's rewrite
    (ref IstioIdentifierBase.httpRewrite)."""
    uri = meta.uri
    if rule.rewrite_uri is not None:
        m = rule.match_headers.get("uri")
        if m is not None and m.prefix is not None and \
                uri.startswith(m.prefix):
            uri = rule.rewrite_uri + uri[len(m.prefix):]
        else:
            uri = rule.rewrite_uri
    authority = rule.rewrite_authority or meta.authority
    return uri, authority


def external_path(pfx: Path, host: str) -> Path:
    parts = host.split(":")
    if len(parts) == 2:
        return pfx + Path.of("ext", parts[0], parts[1])
    if len(parts) == 1:
        return pfx + Path.of("ext", parts[0], "80")
    raise IdentificationError(f"unable to parse host {host!r}")


class IstioIdentifierLogic:
    """Protocol-independent identification over the caches."""

    def __init__(self, cluster_cache: ClusterCache, route_cache: RouteCache,
                 prefix: Path, base_dtab: Dtab):
        self.clusters = cluster_cache
        self.routes = route_cache
        self.prefix = prefix
        self.base_dtab = base_dtab

    async def apply_route_rules(self, dest: str, port: str,
                                meta: RequestMeta, local_dtab: Dtab,
                                apply_rewrite, mk_redirect):
        """The shared route-rule tail: max-precedence rule for ``dest``
        redirects / rewrites+routes / falls through to the empty-label
        dest path. Used by the plain istio identifier AND the
        istio-ingress fusion — one copy of the precedence/redirect/
        rewrite semantics."""
        rules = await self.routes.get_rules()
        best = max_precedence(filter_rules(rules, dest, meta))
        if best is None:
            path = self.prefix + Path.of("dest", dest, "::", port)
            return DstPath(path, self.base_dtab, local_dtab)
        name, rule = best
        if rule.is_redirect:
            return mk_redirect(rule.redirect_uri or meta.uri,
                               rule.redirect_authority or meta.authority)
        uri, authority = http_rewrite(rule, meta)
        apply_rewrite(uri, authority)
        path = self.prefix + Path.of("route", name, port)
        return DstPath(path, self.base_dtab, local_dtab)

    async def identify(self, meta: RequestMeta, local_dtab: Dtab,
                       apply_rewrite: Callable[[str, Optional[str]], None],
                       mk_redirect: Callable[[str, str], object]):
        """-> DstPath, or the value of mk_redirect(uri, authority)."""
        cluster = await self.clusters.get(meta.authority)
        if cluster is None:
            path = external_path(self.prefix, meta.authority)
            return DstPath(path, self.base_dtab, local_dtab)
        return await self.apply_route_rules(
            cluster.dest, cluster.port, meta, local_dtab, apply_rewrite,
            mk_redirect)


def _mk_caches(host: str, port: int, discovery_port: int,
               interval_s: float) -> Tuple[ClusterCache, RouteCache]:
    discovery = DiscoveryClient(host, discovery_port, interval=interval_s)
    apiserver = ApiserverClient(host, port, interval=interval_s)
    return ClusterCache(discovery), RouteCache(apiserver)


@register("identifier", "io.l5d.k8s.istio")
@dataclass
class IstioIdentifierConfig:
    """HTTP istio identifier (ref IstioIdentifier.scala; kind
    io.l5d.k8s.istio). ``host``/``port`` point at Pilot's apiserver,
    ``discoveryPort`` at its discovery service (RDS)."""

    host: str = "istio-pilot"
    port: int = 8081
    discoveryPort: int = 8080
    pollIntervalMs: int = 5000

    def mk(self, prefix: Path, base_dtab: Dtab):
        from linkerd_tpu_torch.protocol.http.message import Request, Response

        clusters, routes = _mk_caches(
            self.host, self.port, self.discoveryPort,
            self.pollIntervalMs / 1e3)
        logic = IstioIdentifierLogic(clusters, routes, prefix, base_dtab)

        async def identify(req: Request):
            host = req.host or ""
            meta = RequestMeta(
                uri=req.uri, scheme="http", method=req.method,
                authority=host, get_header=req.headers.get)

            def apply_rewrite(uri: str, authority: Optional[str]) -> None:
                req.uri = uri
                if authority is not None:
                    req.headers.set("Host", authority)

            def mk_redirect(uri: str, authority: str) -> Response:
                rsp = Response(status=302)
                rsp.headers.set("Location", f"http://{authority}{uri}")
                return rsp

            return await logic.identify(
                meta, parse_local_dtab(req), apply_rewrite, mk_redirect)

        return identify


class IstioIngressLogic:
    """Istio traffic routed through a k8s Ingress resource: the fusion of
    the ingress-rule match (annotation class ``istio``) with the istio
    route-rule machinery (ref IstioIngressIdentifier.scala:1-128 and its
    h2 twin).

    Flow: ingress (host, path) match -> backend svc/namespace/port ->
    cluster name ``<svc>.<ns>.svc.cluster.local``; a NUMERIC ingress port
    resolves to its istio port NAME via the cluster cache (RDS domains
    carry ``cluster:portNumber``); route rules for the cluster then
    redirect / rewrite+route / fall through to the label-less dest path
    exactly like the plain istio identifier."""

    def __init__(self, ingress, cluster_cache: ClusterCache,
                 route_cache: RouteCache, prefix: Path, base_dtab: Dtab):
        self.ingress = ingress
        self._logic = IstioIdentifierLogic(cluster_cache, route_cache,
                                           prefix, base_dtab)
        self.clusters = cluster_cache

    async def identify(self, meta: RequestMeta, local_dtab: Dtab,
                       apply_rewrite: Callable[[str, Optional[str]], None],
                       mk_redirect: Callable[[str, str], object]):
        import asyncio
        host = meta.authority.split(":", 1)[0].lower() or None
        uri = meta.uri.split("?", 1)[0]
        m = await asyncio.wait_for(self.ingress.match_path(host, uri), 30.0)
        if m is None:
            raise IdentificationError(
                f"no ingress rule matches {meta.authority}:{meta.uri}")
        cluster = f"{m.svc}.{m.namespace}.svc.cluster.local"
        port = str(m.port)
        if port.isdigit():
            # numeric ingress port -> istio port name via RDS domains
            c = await self.clusters.get(f"{cluster}:{port}")
            if c is None:
                raise IdentificationError(
                    f"ingress path {m.svc}:{m.port} does not match any "
                    f"istio vhosts")
            port = c.port
        return await self._logic.apply_route_rules(
            cluster, port, meta, local_dtab, apply_rewrite, mk_redirect)


@dataclass
class _IstioIngressBase:
    """Shared config/assembly for the http + h2 istio-ingress kinds."""

    # k8s apiserver (ingress watch)
    host: str = "localhost"
    port: int = 8001
    namespace: Optional[str] = None
    apiPrefix: str = "/apis/extensions/v1beta1"
    useTls: bool = False
    caCertPath: Optional[str] = None
    insecureSkipVerify: bool = False
    # istio pilot (route rules + RDS discovery)
    apiserverHost: str = "istio-pilot"
    apiserverPort: int = 8081
    discoveryHost: Optional[str] = None  # default: apiserverHost
    discoveryPort: int = 8080
    pollIntervalMs: int = 5000

    def _mk_logic(self, prefix: Path, base_dtab: Dtab) -> IstioIngressLogic:
        from linkerd_tpu_torch.k8s.ingress import IngressCache
        from linkerd_tpu_torch.k8s.namer import _mk_api

        ingress = IngressCache(
            _mk_api(self.host, self.port, self.useTls, self.caCertPath,
                    self.insecureSkipVerify),
            self.namespace, annotation_class="istio",
            api_prefix=self.apiPrefix).start()
        interval = self.pollIntervalMs / 1e3
        discovery = DiscoveryClient(self.discoveryHost or self.apiserverHost,
                                    self.discoveryPort, interval=interval)
        apiserver = ApiserverClient(self.apiserverHost, self.apiserverPort,
                                    interval=interval)
        return IstioIngressLogic(ingress, ClusterCache(discovery),
                                 RouteCache(apiserver), prefix, base_dtab)


@register("identifier", "io.l5d.k8s.istio-ingress")
@dataclass
class IstioIngressIdentifierConfig(_IstioIngressBase):
    """HTTP istio-ingress identifier (kind ``io.l5d.k8s.istio-ingress``,
    ref IstioIngressIdentifier.scala)."""

    def mk(self, prefix: Path, base_dtab: Dtab):
        from linkerd_tpu_torch.protocol.http.message import Request, Response

        logic = self._mk_logic(prefix, base_dtab)

        async def identify(req: Request):
            meta = RequestMeta(
                uri=req.uri, scheme="http", method=req.method,
                authority=req.host or "", get_header=req.headers.get)

            def apply_rewrite(uri: str, authority: Optional[str]) -> None:
                req.uri = uri
                if authority is not None:
                    req.headers.set("Host", authority)

            def mk_redirect(uri: str, authority: str) -> Response:
                rsp = Response(status=302)
                rsp.headers.set("Location", f"http://{authority}{uri}")
                return rsp

            return await logic.identify(
                meta, parse_local_dtab(req), apply_rewrite, mk_redirect)

        return identify


@register("h2identifier", "io.l5d.k8s.istio-ingress")
@dataclass
class IstioIngressH2IdentifierConfig(_IstioIngressBase):
    """h2 istio-ingress identifier (ref the h2 IstioIngressIdentifier
    twin)."""

    def mk(self, prefix: Path, base_dtab: Dtab):
        from linkerd_tpu_torch.protocol.h2.messages import H2Request, H2Response

        logic = self._mk_logic(prefix, base_dtab)

        async def identify(req: H2Request):
            meta = RequestMeta(
                uri=req.path, scheme=req.scheme or "http",
                method=req.method, authority=req.authority or "",
                get_header=req.headers.get)

            def apply_rewrite(uri: str, authority: Optional[str]) -> None:
                req.path = uri
                if authority is not None:
                    req.authority = authority

            def mk_redirect(uri: str, authority: str) -> H2Response:
                rsp = H2Response(status=302)
                rsp.headers.set("location", f"http://{authority}{uri}")
                return rsp

            local = Dtab.empty()
            raw = req.headers.get_all("l5d-dtab")
            if raw:
                local = Dtab.read(";".join(raw))
            return await logic.identify(
                meta, local, apply_rewrite, mk_redirect)

        return identify


@register("h2identifier", "io.l5d.k8s.istio")
@dataclass
class IstioH2IdentifierConfig:
    """H2 istio identifier (ref the h2 IstioIdentifier variant)."""

    host: str = "istio-pilot"
    port: int = 8081
    discoveryPort: int = 8080
    pollIntervalMs: int = 5000

    def mk(self, prefix: Path, base_dtab: Dtab):
        from linkerd_tpu_torch.protocol.h2.messages import H2Request, H2Response

        clusters, routes = _mk_caches(
            self.host, self.port, self.discoveryPort,
            self.pollIntervalMs / 1e3)
        logic = IstioIdentifierLogic(clusters, routes, prefix, base_dtab)

        async def identify(req: H2Request):
            meta = RequestMeta(
                uri=req.path, scheme=req.scheme or "http",
                method=req.method, authority=req.authority or "",
                get_header=req.headers.get)

            def apply_rewrite(uri: str, authority: Optional[str]) -> None:
                req.path = uri
                if authority is not None:
                    req.authority = authority

            def mk_redirect(uri: str, authority: str) -> H2Response:
                rsp = H2Response(status=302)
                rsp.headers.set("location", f"http://{authority}{uri}")
                return rsp

            local = Dtab.empty()
            raw = req.headers.get_all("l5d-dtab")
            if raw:
                local = Dtab.read(";".join(raw))
            return await logic.identify(
                meta, local, apply_rewrite, mk_redirect)

        return identify
