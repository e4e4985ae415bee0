"""k8s namers: Endpoints and external (LoadBalancer) service discovery.

Ref: k8s/.../EndpointsNamer.scala:108 (kind ``io.l5d.k8s``:
``/#/io.l5d.k8s/<namespace>/<port>/<service>[/residual]``),
``io.l5d.k8s.ns`` (K8sNamespacedInitializer — fixed namespace), and
``io.l5d.k8s.external`` (ServiceNamer — LoadBalancer ingress addresses).
Each (namespace, service) gets one resilient list+watch loop feeding a
Var[Addr]; port selection by name or number happens per-lookup.

A copy of ``linkerd_tpu/k8s/namer.py``.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from linkerd_tpu_torch.config import register
from linkerd_tpu_torch.core import Activity, Path, Var
from linkerd_tpu_torch.core.activity import Ok
from linkerd_tpu_torch.core.addr import (
    ADDR_NEG, ADDR_PENDING, Addr, Address, AddrNeg, AddrPending, Bound,
    BoundName,
)
from linkerd_tpu_torch.core.nametree import Leaf, NameTree, NEG
from linkerd_tpu_torch.k8s.client import K8sApi, Watcher
from linkerd_tpu_torch.namer.core import Namer

log = logging.getLogger(__name__)


def _endpoints_addrs(obj: dict, port_sel: str) -> Addr:
    """Endpoints object -> Bound for the selected port (name or number)."""
    addresses = []
    want_num: Optional[int] = None
    if port_sel.isdigit():
        want_num = int(port_sel)
    for subset in obj.get("subsets") or []:
        port = None
        for p in subset.get("ports") or []:
            if want_num is not None:
                if p.get("port") == want_num:
                    port = want_num
            elif p.get("name") == port_sel:
                port = p.get("port")
        if port is None:
            continue
        for a in subset.get("addresses") or []:
            ip = a.get("ip")
            if not ip:
                continue
            meta = {}
            if a.get("nodeName"):
                meta["nodeName"] = a["nodeName"]
            addresses.append(Address.mk(ip, port, **meta))
    return Bound(frozenset(addresses))


class _SvcWatch:
    """One list+watch per (namespace, service); raw-object Var."""

    def __init__(self, api: K8sApi, kind_path: str, ns: str, name: str,
                 label_selector: Optional[str] = None):
        self.obj: Var[Optional[dict]] = Var(None)
        self._started = False
        path = f"/api/v1/namespaces/{ns}/{kind_path}/{name}"
        want_label: Optional[Tuple[str, str]] = None
        if label_selector:
            from urllib.parse import quote
            path += f"?labelSelector={quote(label_selector)}"
            # real API servers IGNORE labelSelector on single-object
            # GETs, so the filter must also apply client-side
            k, _, v = label_selector.partition("=")
            want_label = (k, v)

        def matches(obj: dict) -> bool:
            if want_label is None:
                return True
            labels = (obj.get("metadata") or {}).get("labels") or {}
            return labels.get(want_label[0]) == want_label[1]

        def on_list(obj: dict) -> None:
            # a single-object GET returns the object itself
            if obj.get("kind") == "Status" or not matches(obj):
                self.obj.update({})
            else:
                self.obj.update(obj)

        def on_event(evt: dict) -> None:
            t = evt.get("type")
            if t in ("ADDED", "MODIFIED"):
                obj = evt.get("object") or {}
                self.obj.update(obj if matches(obj) else {})
            elif t == "DELETED":
                self.obj.update({})

        self.watcher = Watcher(api, path, on_list, on_event)

    def start(self) -> None:
        if not self._started:
            self._started = True
            self.watcher.start()

    def stop(self) -> None:
        self.watcher.stop()


class EndpointsNamer(Namer):
    """``/<namespace>/<port>/<service>[/residual]`` over Endpoints."""

    def __init__(self, api: K8sApi, id_prefix: str = "io.l5d.k8s",
                 fixed_namespace: Optional[str] = None,
                 label_name: Optional[str] = None):
        self._api = api
        self._id_prefix = id_prefix
        self._fixed_ns = fixed_namespace
        # ref: EndpointsNamer.scala labelSelector — when a label NAME is
        # configured, paths carry one extra segment (the label VALUE) and
        # the endpoints watch filters by `label=value`
        self._label_name = label_name
        self._watches: Dict[Tuple[str, str, Optional[str]], _SvcWatch] = {}

    def _watch(self, ns: str, svc: str,
               selector: Optional[str] = None) -> _SvcWatch:
        key = (ns, svc, selector)
        w = self._watches.get(key)
        if w is None:
            w = _SvcWatch(self._api, "endpoints", ns, svc,
                          label_selector=selector)
            self._watches[key] = w
        w.start()
        return w

    def lookup(self, path: Path) -> Activity[NameTree]:
        extra = 1 if self._label_name else 0
        if self._fixed_ns is None:
            if len(path) < 3 + extra:
                return Activity.value(NEG)
            ns, port, svc = path[0], path[1], path[2]
            consumed = 3 + extra
        else:
            if len(path) < 2 + extra:
                return Activity.value(NEG)
            ns, (port, svc) = self._fixed_ns, (path[0], path[1])
            consumed = 2 + extra
        selector = (f"{self._label_name}={path[consumed - 1]}"
                    if self._label_name else None)
        residual = path.drop(consumed)
        watch = self._watch(ns, svc, selector)
        bid = Path.of("#", self._id_prefix).concat(path.take(consumed))
        addr_var = watch.obj.map(
            lambda obj: (ADDR_PENDING if obj is None
                         else ADDR_NEG if not obj
                         else _endpoints_addrs(obj, port)))
        bound_leaf = Leaf(BoundName(bid, addr_var, residual))

        def to_state(obj: Optional[dict]):
            from linkerd_tpu_torch.core.activity import PENDING
            if obj is None:
                return PENDING
            if not obj:
                return Ok(NEG)
            return Ok(bound_leaf)

        return Activity(watch.obj.map(to_state))

    def close(self) -> None:
        for w in self._watches.values():
            w.stop()


def _lb_addrs(obj: dict, port_sel: str) -> Addr:
    """Service object -> LoadBalancer ingress addrs (ServiceNamer)."""
    port: Optional[int] = None
    if port_sel.isdigit():
        port = int(port_sel)
    else:
        for p in (obj.get("spec") or {}).get("ports") or []:
            if p.get("name") == port_sel:
                port = p.get("port")
    if port is None:
        return Bound(frozenset())
    addresses = []
    status = ((obj.get("status") or {}).get("loadBalancer") or {})
    for ing in status.get("ingress") or []:
        host = ing.get("ip") or ing.get("hostname")
        if host:
            addresses.append(Address.mk(host, port))
    return Bound(frozenset(addresses))


class ServiceNamer(EndpointsNamer):
    """``io.l5d.k8s.external`` — routes to LoadBalancer ingress IPs
    (ref: ServiceNamer.scala:20 via K8sExternalInitializer)."""

    def __init__(self, api: K8sApi, id_prefix: str = "io.l5d.k8s.external"):
        super().__init__(api, id_prefix)

    def _watch(self, ns: str, svc: str) -> _SvcWatch:
        key = (ns, svc)
        w = self._watches.get(key)
        if w is None:
            w = _SvcWatch(self._api, "services", ns, svc)
            self._watches[key] = w
        w.start()
        return w

    def lookup(self, path: Path) -> Activity[NameTree]:
        if len(path) < 3:
            return Activity.value(NEG)
        ns, port, svc = path[0], path[1], path[2]
        residual = path.drop(3)
        watch = self._watch(ns, svc)
        bid = Path.of("#", self._id_prefix).concat(path.take(3))
        addr_var = watch.obj.map(
            lambda obj: (ADDR_PENDING if obj is None
                         else ADDR_NEG if not obj
                         else _lb_addrs(obj, port)))
        bound_leaf = Leaf(BoundName(bid, addr_var, residual))

        def to_state(obj: Optional[dict]):
            from linkerd_tpu_torch.core.activity import PENDING
            if obj is None:
                return PENDING
            if not obj:
                return Ok(NEG)
            return Ok(bound_leaf)

        return Activity(watch.obj.map(to_state))


# ---- config kinds ----------------------------------------------------------

def _mk_api(host: str, port: int, useTls: bool,
            caCertPath=None, insecureSkipVerify: bool = False) -> K8sApi:
    """``host: ""`` selects in-cluster service-account auth; the default
    ``localhost:8001`` targets a kubectl proxy (the reference's default,
    ClientConfig.scala). TLS verifies against caCertPath or the system
    trust store; only insecureSkipVerify: true disables verification."""
    if host:
        return K8sApi(host, port, use_tls=useTls,
                      ca_cert_path=caCertPath,
                      insecure_skip_verify=insecureSkipVerify)
    return K8sApi.from_service_account()


@register("namer", "io.l5d.k8s")
@dataclass
class K8sNamerConfig:
    host: str = "localhost"   # "" -> in-cluster service account
    port: int = 8001          # ref default: localhost:8001 kubectl proxy
    useTls: bool = False
    caCertPath: Optional[str] = None
    insecureSkipVerify: bool = False
    # label NAME: paths gain a trailing label-VALUE segment and the
    # endpoints watch filters by `label=value` (ref: K8sConfig.labelSelector)
    labelSelector: Optional[str] = None
    prefix: str = "/io.l5d.k8s"

    def mk(self) -> Namer:
        return EndpointsNamer(
            _mk_api(self.host, self.port, self.useTls,
                    self.caCertPath, self.insecureSkipVerify),
            label_name=self.labelSelector)


@register("namer", "io.l5d.k8s.ns")
@dataclass
class K8sNamespacedConfig:
    """io.l5d.k8s pinned to one namespace:
    ``/#/io.l5d.k8s.ns/<port>/<svc>`` — the in-cluster shape where the
    namespace comes from config, not the name path."""

    namespace: str = "default"
    host: str = "localhost"   # "" -> in-cluster service account
    port: int = 8001
    useTls: bool = False
    caCertPath: Optional[str] = None
    insecureSkipVerify: bool = False
    labelSelector: Optional[str] = None
    prefix: str = "/io.l5d.k8s.ns"

    def mk(self) -> Namer:
        return EndpointsNamer(
            _mk_api(self.host, self.port, self.useTls,
                    self.caCertPath, self.insecureSkipVerify),
            id_prefix="io.l5d.k8s.ns", fixed_namespace=self.namespace,
            label_name=self.labelSelector)


@register("namer", "io.l5d.k8s.external")
@dataclass
class K8sExternalConfig:
    """Resolve services to their EXTERNAL addresses (LoadBalancer
    ingress / NodePort), for routers running outside the cluster."""

    host: str = "localhost"   # "" -> in-cluster service account
    port: int = 8001
    useTls: bool = False
    caCertPath: Optional[str] = None
    insecureSkipVerify: bool = False
    prefix: str = "/io.l5d.k8s.external"

    def mk(self) -> Namer:
        return ServiceNamer(_mk_api(
            self.host, self.port, self.useTls,
            self.caCertPath, self.insecureSkipVerify))
