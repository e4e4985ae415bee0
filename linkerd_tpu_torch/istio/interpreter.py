"""IstioInterpreter: synthesizes a live dtab from Pilot route-rules.

Ref: interpreter/k8s/.../IstioInterpreter.scala:1-80 — the default route
dtab sends /svc/dest through the istio namer and /svc/ext through the
egress service; each route-rule named R with destination D contributes
``/svc/route/R => union of /#/io.l5d.k8s.istio/<dest>/<labels>`` weighted
per the rule's route entries.

A copy of ``linkerd_tpu/istio/interpreter.py``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

from linkerd_tpu_torch.config import register
from linkerd_tpu_torch.core import Activity, Dtab, Path
from linkerd_tpu_torch.core.dtab import Dentry, Prefix
from linkerd_tpu_torch.core.nametree import Leaf, NameTree, Union as TreeUnion, Weighted
from linkerd_tpu_torch.istio.pilot import ApiserverClient, RouteCache, RouteRule
from linkerd_tpu_torch.namer.core import ConfiguredDtabNamer, NameInterpreter

ISTIO_PFX = "/#/io.l5d.k8s.istio"
K8S_PFX = "/#/io.l5d.k8s.ns"

DEFAULT_ROUTE_DTAB = Dtab.read(f"""
/egress => {K8S_PFX}/incoming/istio-egress ;
/svc/ext => /egress ;
/svc/dest => /egress ;
/svc/dest => {ISTIO_PFX} ;
""")


def _label_segment(tags: Dict[str, str]) -> str:
    if not tags:
        return "::"
    return "::".join(f"{k}:{v}" for k, v in sorted(tags.items()))


def mk_dentry(name: str, rule: RouteRule) -> List[Dentry]:
    """One route-rule -> its /svc/route/<name> dentry (ref mkDentry)."""
    if rule.destination is None:
        return []
    branches = []
    for wd in rule.route:
        cluster = wd.destination or rule.destination
        dst_path = Path.read(
            f"{ISTIO_PFX}/{cluster}/{_label_segment(wd.tags)}")
        branches.append(Weighted(float(wd.weight), Leaf(dst_path)))
    if branches:
        dst: NameTree = TreeUnion(*branches)
    else:
        dst = Leaf(Path.read(f"{ISTIO_PFX}/{rule.destination}/::"))
    return [Dentry(Prefix.read(f"/svc/route/{name}"), dst)]


def routes_dtab(rules: Dict[str, RouteRule]) -> Dtab:
    dentries: List[Dentry] = []
    for name, rule in sorted(rules.items()):
        dentries.extend(mk_dentry(name, rule))
    return DEFAULT_ROUTE_DTAB + Dtab(tuple(dentries))


def mk_istio_interpreter(route_cache: RouteCache,
                         namers: List[Tuple[Path, object]]
                         ) -> NameInterpreter:
    dtab_act: Activity[Dtab] = route_cache.rules.map(routes_dtab)
    return ConfiguredDtabNamer(namers, dtab=dtab_act)


@register("interpreter", "io.l5d.k8s.istio")
@dataclass
class IstioInterpreterConfig:
    """Ref: IstioInterpreterInitializer.scala (kind io.l5d.k8s.istio).
    ``host``/``port`` point at Pilot's apiserver; the istio + k8s namers
    must be configured in the linker's ``namers`` list."""

    host: str = "istio-pilot"
    port: int = 8081
    pollIntervalMs: int = 5000

    def mk(self, namers) -> NameInterpreter:
        cache = RouteCache(ApiserverClient(
            self.host, self.port, interval=self.pollIntervalMs / 1e3))
        return mk_istio_interpreter(cache, list(namers))
