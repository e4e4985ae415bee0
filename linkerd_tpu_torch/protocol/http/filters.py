"""HTTP/1 protocol filters for the router stacks: a copy of
``linkerd_tpu/protocol/http/filters.py``.

Ref: router/http filters — FramingFilter (dup/conflicting Content-Length
-> 4xx/502), StripHopByHopHeadersFilter, ViaHeaderAppenderFilter,
AddForwardedHeader.scala:185 (RFC 7239), ProxyRewriteFilter (absolute-URI
proxy requests), and linkerd/protocol/http LinkerdHeaders ``l5d-dst-*``
context headers (LinkerdHeaders.scala:49-502) + ServerConfig clearContext
(ClearContext.scala).
"""

from __future__ import annotations

from typing import List, Optional
from urllib.parse import urlsplit

from linkerd_tpu_torch.protocol.http.message import Request, Response
from linkerd_tpu_torch.router.service import Filter, Service

VIA_VALUE = "1.1 linkerd"

# RFC 7230 §6.1 + TTwitter legacy set (StripHopByHopHeadersFilter.scala)
HOP_BY_HOP = frozenset({
    "connection", "keep-alive", "proxy-authenticate",
    "proxy-authorization", "te", "trailer", "transfer-encoding", "upgrade",
    "proxy-connection",
})

L5D_CTX_PREFIX = "l5d-ctx-"
L5D_DST_SERVICE = "l5d-dst-service"
L5D_DST_CLIENT = "l5d-dst-client"
L5D_DST_RESIDUAL = "l5d-dst-residual"
L5D_REQID = "l5d-reqid"


class FramingFilter(Filter[Request, Response]):
    """Reject messages with conflicting Content-Length headers
    (request-smuggling defence; ref: FramingFilter.scala — 4xx for
    requests, 502 for responses)."""

    @staticmethod
    def _bad(msg: "Request | Response") -> bool:
        lens = {v.strip() for v in msg.headers.get_all("content-length")}
        return len(lens) > 1

    async def apply(self, req: Request, service: Service) -> Response:
        if self._bad(req):
            return Response(status=400,
                            body=b"conflicting Content-Length headers")
        rsp = await service(req)
        if self._bad(rsp):
            return Response(status=502,
                            body=b"upstream sent conflicting Content-Length")
        return rsp


class StripHopByHopHeadersFilter(Filter[Request, Response]):
    """Remove hop-by-hop headers (and anything named by Connection)
    in both directions (ref: StripHopByHopHeadersFilter.scala)."""

    @staticmethod
    def _strip(msg) -> None:
        named = set()
        for v in msg.headers.get_all("connection"):
            named.update(t.strip().lower() for t in v.split(",") if t.strip())
        for name in HOP_BY_HOP | named:
            msg.headers.remove(name)

    async def apply(self, req: Request, service: Service) -> Response:
        self._strip(req)
        rsp = await service(req)
        self._strip(rsp)
        return rsp


class ViaHeaderAppenderFilter(Filter[Request, Response]):
    """Append ``Via: 1.1 linkerd`` on request and response
    (ref: ViaHeaderAppenderFilter.scala)."""

    @staticmethod
    def _append(msg) -> None:
        existing = msg.headers.get("via")
        msg.headers.set("Via", f"{existing}, {VIA_VALUE}"
                        if existing else VIA_VALUE)

    async def apply(self, req: Request, service: Service) -> Response:
        self._append(req)
        rsp = await service(req)
        self._append(rsp)
        return rsp


def _clear_ip(addr: Optional[tuple]) -> str:
    if not addr:
        return "unknown"
    host = addr[0]
    if ":" in host:  # IPv6 must be bracketed+quoted per RFC 7239
        return f'"[{host}]"'
    return host


def _clear_ip_port(addr: Optional[tuple]) -> str:
    if not addr:
        return "unknown"
    host, port = addr[0], addr[1]
    if ":" in host:
        return f'"[{host}]:{port}"'
    return f'"{host}:{port}"'  # node with port must be quoted (§6)


_OBFUSCATED_ALPHABET = "abcdefghijklmnopqrstuvwxyz0123456789"


def _random_label(length: int = 6) -> str:
    import random
    return "_" + "".join(random.choice(_OBFUSCATED_ALPHABET)
                         for _ in range(length))


import re as _re

_OBFUSCATED_LABEL_RE = _re.compile(r"^[A-Za-z0-9._-]+$")


def mk_forwarded_labeler(cfg: Optional[dict], router_label: str):
    """One RFC 7239 node labeler from config (ref:
    AddForwardedHeaderConfig.scala:9-72 — kinds ip, ip:port,
    requestRandom, connectionRandom, router, static; default
    requestRandom, matching AddForwardedHeader.Labeler.By/For.default).

    -> callable(addr_tuple, conn_key) -> str. ``addr_tuple`` is the node
    being labeled; ``conn_key`` identifies the client CONNECTION (so a
    connectionRandom ``by`` doesn't degenerate to one label for the
    shared listener address). The per-connection cache keys on the
    client peer (ip, port) — an approximation of the reference's
    per-Channel labeling that can reuse a label across an ephemeral-port
    reuse; bounded by FIFO eviction."""
    if cfg is not None and not isinstance(cfg, dict):
        raise ValueError(f"labeler config must be a mapping with 'kind', "
                         f"got {cfg!r}")
    kind = (cfg or {}).get("kind", "requestRandom")
    if kind == "ip":
        return lambda addr, conn_key: _clear_ip(addr)
    if kind == "ip:port":
        return lambda addr, conn_key: _clear_ip_port(addr)
    if kind == "requestRandom":
        return lambda addr, conn_key: _random_label()
    if kind == "connectionRandom":
        labels: dict = {}

        def per_conn(addr: Optional[tuple], conn_key) -> str:
            key = tuple(conn_key) if conn_key else None
            got = labels.get(key)
            if got is None:
                while len(labels) > 4096:  # FIFO: evict oldest entries
                    labels.pop(next(iter(labels)))
                got = labels[key] = _random_label()
            return got

        return per_conn

    def _checked(label: str, what: str) -> str:
        # RFC 7239 §6.3 obfuscated identifier syntax: anything else
        # (spaces, ';', ',') would corrupt or forge the header
        if not _OBFUSCATED_LABEL_RE.match(label):
            raise ValueError(
                f"{what} {label!r} is not a valid Forwarded label "
                f"(ALPHA / DIGIT / '.' / '_' / '-')")
        return f"_{label}"

    if kind == "router":
        lbl = _checked(router_label, "router label")
        return lambda addr, conn_key, _l=lbl: _l
    if kind == "static":
        label = (cfg or {}).get("label")
        if not label:
            raise ValueError("static labeler needs 'label'")
        lbl = _checked(str(label), "static label")
        return lambda addr, conn_key, _l=lbl: _l
    raise ValueError(f"unknown Forwarded labeler kind {kind!r}")


class AddForwardedHeaderFilter(Filter[Request, Response]):
    """RFC 7239 ``Forwarded: for=...;by=...`` (ref:
    AddForwardedHeader.scala:185 + AddForwardedHeaderConfig.scala;
    config-gated, off by default since it adds per-request allocation).
    ``by``/``for`` labelers default to per-request obfuscated random
    like the reference."""

    def __init__(self, by=None, for_=None):
        self._by = by or (lambda addr, conn_key: _random_label())
        self._for = for_ or (lambda addr, conn_key: _random_label())

    async def apply(self, req: Request, service: Service) -> Response:
        client = req.ctx.get("client_addr")
        server = req.ctx.get("server_addr")
        elem = (f"for={self._for(client, client)};"
                f"by={self._by(server, client)}")
        existing = req.headers.get("forwarded")
        req.headers.set("Forwarded",
                        f"{existing}, {elem}" if existing else elem)
        return await service(req)


class ProxyRewriteFilter(Filter[Request, Response]):
    """Accept absolute-URI (proxy-form) requests: rewrite to origin-form
    and set Host from the URI authority (ref: ProxyRewriteFilter.scala)."""

    async def apply(self, req: Request, service: Service) -> Response:
        if req.uri.startswith("http://") or req.uri.startswith("https://"):
            parts = urlsplit(req.uri)
            if parts.netloc:
                req.headers.set("Host", parts.netloc)
                path = parts.path or "/"
                if parts.query:
                    path += f"?{parts.query}"
                req.uri = path
        return await service(req)


class ClearContextFilter(Filter[Request, Response]):
    """Strip inbound linkerd context headers at the server edge
    (ref: ServerConfig clearContext -> ClearContext.scala) so untrusted
    callers can't inject trace ids or dtab overrides."""

    async def apply(self, req: Request, service: Service) -> Response:
        doomed = [n for n, _ in req.headers.items()
                  if n.lower().startswith("l5d-")]
        for n in doomed:
            req.headers.remove(n)
        return await service(req)


def _authority_of(addr_state) -> Optional[str]:
    """``authority`` metadata of a replica set: from the Bound's own
    meta, else the first address carrying one (consul's SvcAddr.mkMeta
    stamps every address identically)."""
    from linkerd_tpu_torch.core.addr import Bound
    if not isinstance(addr_state, Bound):
        return None
    for k, v in addr_state.meta:
        if k == "authority" and v:
            return str(v)
    for a in addr_state.addresses:
        for k, v in a.meta:
            if k == "authority" and v:
                return str(v)
    return None


def _swap_url_authority(url: str, frm: str, to: str) -> Optional[str]:
    """``url`` with its authority replaced when it names ``frm``
    (case-insensitive host compare); None = leave untouched."""
    parts = urlsplit(url)
    if not parts.netloc or parts.netloc.lower() != frm.lower():
        return None
    rebuilt = f"{parts.scheme}://{to}" if parts.scheme else f"//{to}"
    rebuilt += parts.path or ""
    if parts.query:
        rebuilt += f"?{parts.query}"
    if parts.fragment:
        rebuilt += f"#{parts.fragment}"
    return rebuilt


class RewriteHostHeader(Filter[Request, Response]):
    """Rewrite the request Host from the bound replica set's
    ``authority`` metadata — what consul's ``setHost`` (SvcAddr.mkMeta)
    produces — and reverse-rewrite ``Location``/``Refresh`` response
    headers that name the rewritten authority back to the caller's
    original Host, so redirects keep pointing at the virtual host the
    caller used. Ref: linkerd/protocol/http/.../RewriteHostHeader.scala:8-40.

    Installed in every http client stack; a bound name with no authority
    metadata (fs, k8s, ...) is a per-request no-op. The authority is
    derived once per replica-set update (cached on the sampled Addr's
    identity — Bound states are immutable between Var updates), not by
    scanning every address's metadata on every request."""

    def __init__(self, addr_var):
        self._addr = addr_var
        self._cached_state: Optional[object] = None
        self._cached_authority: Optional[str] = None

    def _authority(self) -> Optional[str]:
        state = self._addr.sample()
        if state is not self._cached_state:
            self._cached_authority = _authority_of(state)
            self._cached_state = state
        return self._cached_authority

    async def apply(self, req: Request, service: Service) -> Response:
        authority = self._authority()
        if not authority:
            return await service(req)
        original = req.headers.get("host")
        req.headers.set("Host", authority)
        rsp = await service(req)
        if original and original.lower() != authority.lower():
            loc = rsp.headers.get("location")
            if loc:
                swapped = _swap_url_authority(loc, authority, original)
                if swapped is not None:
                    rsp.headers.set("Location", swapped)
            refresh = rsp.headers.get("refresh")
            if refresh and "url=" in refresh.lower():
                head, _, url = refresh.partition("=")
                swapped = _swap_url_authority(url.strip(), authority,
                                              original)
                if swapped is not None:
                    rsp.headers.set("Refresh", f"{head}={swapped}")
        return rsp


class DstHeadersFilter(Filter[Request, Response]):
    """Client-side ``l5d-dst-*`` headers telling the next hop how this
    request was routed (ref: LinkerdHeaders.Dst, LinkerdHeaders.scala)."""

    def __init__(self, client_id: str):
        self._client_id = client_id

    async def apply(self, req: Request, service: Service) -> Response:
        dst = req.ctx.get("dst")
        if dst is not None:
            req.headers.set(L5D_DST_SERVICE, dst.path.show)
        req.headers.set(L5D_DST_CLIENT, self._client_id)
        return await service(req)
