"""IstioNamer: service discovery through Pilot's SDS API.

Accepts names of the form ``/<cluster>/<labels>/<port-name>/...residual``
where labels is ``::``-delimited ``label:value`` pairs in alphabetical
order (``::`` alone = no labels), e.g.
``/reviews.default.svc.cluster.local/version:v1/http``.
Ref: IstioNamer.scala:1-79.

A copy of ``linkerd_tpu/istio/namer.py``.
"""

from __future__ import annotations

import logging
import re
from dataclasses import dataclass
from typing import Dict, Tuple

from linkerd_tpu_torch.config import register
from linkerd_tpu_torch.core import Activity, Path, Var
from linkerd_tpu_torch.core.activity import Failed, Ok
from linkerd_tpu_torch.core.addr import (
    ADDR_PENDING, Addr, AddrFailed, Address, Bound as AddrBound, BoundName,
)
from linkerd_tpu_torch.core.nametree import Leaf, NameTree, Neg
from linkerd_tpu_torch.istio.pilot import DiscoveryClient
from linkerd_tpu_torch.namer.core import Namer

log = logging.getLogger(__name__)

_LABEL = re.compile(r"(.+):(.+)")


class IstioNamer(Namer):
    PREFIX_LEN = 3

    def __init__(self, discovery: DiscoveryClient,
                 id_prefix: str = "io.l5d.k8s.istio"):
        self.discovery = discovery
        self.id_prefix = id_prefix
        self._addr_vars: Dict[Tuple[str, str, str], Var[Addr]] = {}
        self._handles: list = []

    def lookup(self, path: Path) -> Activity[NameTree]:
        if len(path) < self.PREFIX_LEN:
            return Activity.value(Neg())
        cluster, labels_seg, port_name = (
            path[0].lower(), path[1].lower(), path[2].lower())
        residual = path.drop(self.PREFIX_LEN)
        labels: Dict[str, str] = {}
        for part in labels_seg.split("::"):
            m = _LABEL.fullmatch(part)
            if m is not None:
                labels[m.group(1)] = m.group(2)

        var = self._addr_var(cluster, labels_seg, port_name, labels)
        bid = Path.of("#", self.id_prefix, cluster, labels_seg, port_name)
        leaf = Leaf(BoundName(bid, var, residual))

        def to_tree(addr: Addr):
            # empty/failed replica sets -> Neg (ref IstioNamer.scala:62-70)
            if isinstance(addr, AddrBound) and addr.addresses:
                return Ok(leaf)
            if isinstance(addr, (AddrBound, AddrFailed)):
                return Ok(Neg())
            from linkerd_tpu_torch.core.activity import PENDING
            return PENDING

        return Activity(var.map(to_tree))

    def _addr_var(self, cluster: str, labels_seg: str, port_name: str,
                  labels: Dict[str, str]) -> Var[Addr]:
        key = (cluster, labels_seg, port_name)
        var = self._addr_vars.get(key)
        if var is not None:
            return var
        var = Var(ADDR_PENDING)
        self._addr_vars[key] = var
        sds = self.discovery.watch_service(cluster, port_name, labels)

        def on_state(st) -> None:
            if isinstance(st, Ok):
                var.update(AddrBound(frozenset(
                    Address(ip, port) for ip, port in st.value)))
            elif isinstance(st, Failed):
                var.update(AddrFailed(repr(st.exc)))

        self._handles.append(sds.states.observe(on_state))
        return var

    def close(self) -> None:
        for h in self._handles:
            h.close()
        self._handles.clear()


@register("namer", "io.l5d.k8s.istio")
@dataclass
class IstioNamerConfig:
    """Ref: IstioInitializer.scala:51 (kind io.l5d.k8s.istio)."""

    host: str = "istio-pilot"
    port: int = 8080
    pollIntervalMs: int = 5000
    prefix: str = "/io.l5d.k8s.istio"

    def mk(self) -> Namer:
        return IstioNamer(DiscoveryClient(
            self.host, self.port, interval=self.pollIntervalMs / 1e3))
