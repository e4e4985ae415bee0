"""k8s Ingress routing: the piece that makes linkerd a k8s ingress
controller.

Reference parity: k8s/.../IngressCache.scala:78 (watch ingresses, match
host header + path regex against rules, honor the
``kubernetes.io/ingress.class`` annotation and the fallback backend) and
linkerd/protocol/http/.../IngressIdentifier.scala (kind
``io.l5d.ingress``: a matched rule identifies the request as
``/<prefix>/<namespace>/<port>/<svc>`` — the io.l5d.k8s namer's path
shape) plus its h2 twin.

Both the 2017-era ``extensions/v1beta1`` backend shape
(``serviceName``/``servicePort``) and the modern ``networking.k8s.io/v1``
shape (``service.name``/``service.port.{number,name}``) parse, so users
migrating from the reference keep their resources working.

A copy of ``linkerd_tpu/k8s/ingress.py``.
"""

from __future__ import annotations

import asyncio
import re
from dataclasses import dataclass, field
from typing import List, Optional

from linkerd_tpu_torch.config import register
from linkerd_tpu_torch.core import Dtab, Path
from linkerd_tpu_torch.k8s.client import K8sApi, K8sApiError, Watcher
from linkerd_tpu_torch.router.binding import DstPath
from linkerd_tpu_torch.router.routing import IdentificationError, parse_local_dtab

ANNOTATION_KEY = "kubernetes.io/ingress.class"


@dataclass(frozen=True)
class IngressPath:
    host: Optional[str]
    path: Optional[str]
    namespace: str
    svc: str
    port: str

    def matches(self, host_header: Optional[str], request_path: str) -> bool:
        if self.host is not None and host_header != self.host:
            return False
        if self.path:
            try:
                return re.fullmatch(self.path, request_path) is not None
            except re.error:
                return False
        return True


@dataclass(frozen=True)
class IngressSpec:
    name: Optional[str]
    namespace: Optional[str]
    fallback: Optional[IngressPath] = None
    rules: tuple = ()

    def matching_rule(self, host_header: Optional[str],
                      request_path: str) -> Optional[IngressPath]:
        for rule in self.rules:
            if rule.matches(host_header, request_path):
                return rule
        return None


def _parse_backend(backend: dict) -> Optional[tuple]:
    """(svc, port) from either API generation's backend shape."""
    if not backend:
        return None
    if "serviceName" in backend:  # extensions/v1beta1
        return backend["serviceName"], str(backend.get("servicePort", ""))
    svc = backend.get("service") or {}
    if svc.get("name"):          # networking.k8s.io/v1
        port = svc.get("port") or {}
        return svc["name"], str(port.get("number") or port.get("name") or "")
    return None


def parse_ingress(obj: dict, annotation_class: str) -> Optional[IngressSpec]:
    meta = obj.get("metadata") or {}
    annotations = meta.get("annotations") or {}
    cls = annotations.get(ANNOTATION_KEY)
    if cls is not None and cls != annotation_class:
        return None  # someone else's ingress
    spec = obj.get("spec") or {}
    ns = meta.get("namespace") or "default"
    rules: List[IngressPath] = []
    for rule in spec.get("rules") or []:
        http = rule.get("http") or {}
        for p in http.get("paths") or []:
            be = _parse_backend(p.get("backend") or {})
            if be is None:
                continue
            rules.append(IngressPath(rule.get("host"), p.get("path"),
                                     ns, be[0], be[1]))
    fallback = None
    be = _parse_backend(spec.get("backend")
                        or spec.get("defaultBackend") or {})
    if be is not None:
        fallback = IngressPath(None, None, ns, be[0], be[1])
    return IngressSpec(meta.get("name"), meta.get("namespace"),
                       fallback, tuple(rules))


class IngressCache:
    """Watches ingress resources; answers rule matches from local state
    (ref: IngressCache.scala — list + resourceVersion watch, Adds/
    Modifies/Deletes folded into the rule set)."""

    def __init__(self, api: K8sApi, namespace: Optional[str] = None,
                 annotation_class: str = "linkerd",
                 api_prefix: str = "/apis/extensions/v1beta1"):
        ns_part = f"/namespaces/{namespace}" if namespace else ""
        self._path = f"{api_prefix}{ns_part}/ingresses"
        self.annotation_class = annotation_class
        self._specs: dict = {}
        self.primed = asyncio.Event()
        self._watcher = Watcher(api, self._path, self._on_list,
                                self._on_event)

    def start(self) -> "IngressCache":
        self._watcher.start()
        return self

    def stop(self) -> None:
        self._watcher.stop()

    @staticmethod
    def _key(obj: dict) -> tuple:
        meta = obj.get("metadata") or {}
        return (meta.get("namespace"), meta.get("name"))

    def _on_list(self, obj: dict) -> None:
        if obj.get("kind") == "Status":
            # 404 from the API: do NOT prime an empty rule set. On k8s
            # >=1.22 extensions/v1beta1 is gone — fall over to the
            # networking.k8s.io/v1 path and make the watcher re-list.
            if "/apis/extensions/v1beta1" in self._path:
                self._path = self._path.replace(
                    "/apis/extensions/v1beta1", "/apis/networking.k8s.io/v1")
                self._watcher.set_path(self._path)
                raise K8sApiError(
                    404, "extensions/v1beta1 absent; retrying with "
                         "networking.k8s.io/v1")
            raise K8sApiError(int(obj.get("code") or 404),
                              f"ingress list failed: {obj}")
        self._specs = {}
        for item in obj.get("items") or []:
            spec = parse_ingress(item, self.annotation_class)
            if spec is not None:
                self._specs[self._key(item)] = spec
        self.primed.set()

    def _on_event(self, evt: dict) -> None:
        obj = evt.get("object") or {}
        etype = evt.get("type")
        if etype == "DELETED":
            self._specs.pop(self._key(obj), None)
            return
        if etype in ("ADDED", "MODIFIED"):
            spec = parse_ingress(obj, self.annotation_class)
            if spec is None:
                self._specs.pop(self._key(obj), None)
            else:
                self._specs[self._key(obj)] = spec

    async def match_path(self, host_header: Optional[str],
                         request_path: str) -> Optional[IngressPath]:
        await self.primed.wait()
        # Explicit rules across ALL ingresses take precedence; fallback
        # (default) backends are only consulted when no rule anywhere
        # matches — otherwise one ingress's default shadows another's
        # rules depending on iteration order.
        fallback = None
        for spec in self._specs.values():
            m = spec.matching_rule(host_header, request_path)
            if m is not None:
                return m
            if fallback is None and spec.fallback is not None:
                fallback = spec.fallback
        return fallback


def _clean_host(value: Optional[str]) -> Optional[str]:
    if not value:
        return None
    return value.split(":", 1)[0].lower()


@dataclass
class _IngressIdentifierBase:
    host: str = "localhost"   # "" -> in-cluster service account
    port: int = 8001
    namespace: Optional[str] = None
    ingressClassAnnotation: str = "linkerd"
    useTls: bool = False
    caCertPath: Optional[str] = None
    insecureSkipVerify: bool = False
    apiPrefix: str = "/apis/extensions/v1beta1"
    _cache: Optional[IngressCache] = field(default=None, repr=False)

    def _ensure_cache(self) -> IngressCache:
        if self._cache is None:
            from linkerd_tpu_torch.k8s.namer import _mk_api
            self._cache = IngressCache(
                _mk_api(self.host, self.port, self.useTls,
                        self.caCertPath, self.insecureSkipVerify),
                self.namespace, self.ingressClassAnnotation,
                self.apiPrefix).start()
        return self._cache

    def _identify(self, prefix: Path, base_dtab: Dtab, host, path, req):
        cache = self._ensure_cache()

        async def go() -> DstPath:
            m = await asyncio.wait_for(cache.match_path(host, path), 30.0)
            if m is None:
                raise IdentificationError("no ingress rule matches")
            dst = prefix + Path.of(m.namespace, m.port, m.svc)
            return DstPath(dst, base_dtab, parse_local_dtab(req))

        return go()


@register("identifier", "io.l5d.ingress")
@dataclass
class IngressIdentifier(_IngressIdentifierBase):
    """HTTP/1 ingress-controller identifier (kind ``io.l5d.ingress``)."""

    def mk(self, prefix: Path, base_dtab: Dtab):
        def identify(req):
            uri = req.uri.split("?", 1)[0]
            return self._identify(prefix, base_dtab,
                                  _clean_host(req.host), uri, req)

        return identify


@register("h2identifier", "io.l5d.ingress")
@dataclass
class H2IngressIdentifier(_IngressIdentifierBase):
    """h2/gRPC twin of the ingress identifier."""

    def mk(self, prefix: Path, base_dtab: Dtab):
        def identify(req):
            path = req.path.split("?", 1)[0]
            return self._identify(prefix, base_dtab,
                                  _clean_host(req.authority), path, req)

        return identify
