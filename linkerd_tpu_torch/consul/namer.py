"""``io.l5d.consul`` — Consul health-endpoint namer.

Ref: namer/consul/.../{ConsulNamer.scala:60,SvcAddr.scala:30-95,
LookupCache.scala:108} — paths ``/#/io.l5d.consul/<dc>/<svc>[/residual]``
(or ``/<dc>/<tag>/<svc>`` with includeTag); each (dc, svc, tag) gets one
blocking-index long-poll loop feeding a shared Var[Addr], retried forever
with jittered backoff, index reset handled per Consul semantics.
"""

from __future__ import annotations

import asyncio
import logging
import random
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from linkerd_tpu_torch.config import ConfigError, register
from linkerd_tpu_torch.core import Activity, Path, Var
from linkerd_tpu_torch.core.activity import Ok, PENDING
from linkerd_tpu_torch.core.addr import (
    ADDR_NEG, ADDR_PENDING, Addr, Address, Bound, BoundName,
)
from linkerd_tpu_torch.core.nametree import Leaf, NameTree, NEG
from linkerd_tpu_torch.consul.client import ConsulApi
from linkerd_tpu_torch.namer.core import Namer

log = logging.getLogger(__name__)


def _entries_to_addr(entries, prefer_service_addr: bool = True) -> Addr:
    addresses = []
    for e in entries or []:
        svc = e.get("Service") or {}
        node = e.get("Node") or {}
        host = None
        if prefer_service_addr:
            host = svc.get("Address") or node.get("Address")
        else:
            host = node.get("Address")
        port = svc.get("Port")
        if host and port:
            meta = {}
            if node.get("Node"):
                meta["nodeName"] = node["Node"]
            addresses.append(Address.mk(host, int(port), **meta))
    return Bound(frozenset(addresses))


class _SvcPoll:
    """One blocking-index loop per (dc, svc, tag) (ref: SvcAddr loop)."""

    def __init__(self, api: ConsulApi, dc: str, svc: str,
                 tag: Optional[str], prefer_service_addr: bool):
        self.addr: Var[Addr] = Var(ADDR_PENDING)
        self.seen = Var(False)  # becomes True after the first response
        self._api = api
        self._dc = dc
        self._svc = svc
        self._tag = tag
        self._prefer = prefer_service_addr
        self._task: Optional[asyncio.Task] = None

    def start(self) -> None:
        if self._task is None or self._task.done():
            self._task = asyncio.get_event_loop().create_task(self._run())

    def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None

    async def _run(self) -> None:
        index: Optional[int] = None
        attempt = 0
        while True:
            try:
                entries, new_index = await self._api.health_service(
                    self._svc, dc=self._dc or None, tag=self._tag,
                    index=index)
                attempt = 0
                if new_index is not None and (
                        index is not None and new_index < index):
                    index = None  # index reset: start over (Consul docs)
                    continue
                index = new_index if new_index is not None else index
                self.addr.update(_entries_to_addr(entries, self._prefer))
                self.seen.update(True)
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001 - retry forever
                log.debug("consul poll %s/%s: %s", self._dc, self._svc, e)
                delay = min(10.0, 0.1 * (2 ** attempt))
                attempt = min(attempt + 1, 30)
                await asyncio.sleep(delay * (0.5 + random.random() / 2))


class ConsulNamer(Namer):
    def __init__(self, api: ConsulApi, id_prefix: str = "io.l5d.consul",
                 include_tag: bool = False,
                 prefer_service_address: bool = True,
                 set_host: bool = False, domain: str = "consul"):
        self._api = api
        self._id_prefix = id_prefix
        self._include_tag = include_tag
        self._prefer = prefer_service_address
        # ref: SvcAddr.mkMeta — authority metadata
        # ({tag.}{svc}.service.{dc}.{domain}) for TLS/Host rewriting
        self._set_host = set_host
        self._domain = domain
        self._polls: Dict[Tuple[str, str, Optional[str]], _SvcPoll] = {}
        # one derived authority Var per poll key (NOT per lookup: a
        # per-lookup Var.map registers an observer that is never
        # detached and would leak across binding-cache churn)
        self._authority_vars: Dict[Tuple[str, str, Optional[str]], Var] = {}

    def _poll(self, dc: str, svc: str, tag: Optional[str]) -> _SvcPoll:
        key = (dc, svc, tag)
        p = self._polls.get(key)
        if p is None:
            p = _SvcPoll(self._api, dc, svc, tag, self._prefer)
            self._polls[key] = p
        p.start()
        return p

    def lookup(self, path: Path) -> Activity[NameTree]:
        need = 3 if self._include_tag else 2
        if len(path) < need:
            return Activity.value(NEG)
        if self._include_tag:
            dc, tag, svc = path[0], path[1], path[2]
        else:
            dc, tag, svc = path[0], None, path[1]
        residual = path.drop(need)
        poll = self._poll(dc, svc, tag)
        bid = Path.of("#", self._id_prefix).concat(path.take(need))
        addr_var = poll.addr
        if self._set_host:
            key = (dc, svc, tag)
            addr_var = self._authority_vars.get(key)
            if addr_var is None:
                authority = (f"{tag}.{svc}.service.{dc}.{self._domain}"
                             if tag else f"{svc}.service.{dc}.{self._domain}")

                def with_authority(a, _auth=authority):
                    if isinstance(a, Bound):
                        return Bound(a.addresses,
                                     a.meta + (("authority", _auth),))
                    return a

                addr_var = poll.addr.map(with_authority)
                self._authority_vars[key] = addr_var
        bound_leaf = Leaf(BoundName(bid, addr_var, residual))

        def to_state(args):
            seen, addr = args
            if not seen:
                return PENDING
            if isinstance(addr, Bound) and not addr.addresses:
                return Ok(NEG)  # unknown service -> negative binding
            return Ok(bound_leaf)

        joined = Var.collect([poll.seen, poll.addr])
        return Activity(joined.map(to_state))

    def close(self) -> None:
        for p in self._polls.values():
            p.stop()


@register("namer", "io.l5d.consul")
@dataclass
class ConsulNamerConfig:
    """Name via consul catalog/health: ``/#/io.l5d.consul/<dc>/<svc>``
    resolves through blocking-index long-polls; ``consistencyMode`` and
    tag filtering mirror the reference's io.l5d.consul options."""

    host: str = "127.0.0.1"
    port: int = 8500
    token: Optional[str] = None
    includeTag: bool = False
    useHealthCheck: bool = True   # parity flag; health endpoint is used
    preferServiceAddress: bool = True
    setHost: bool = False         # authority metadata (SvcAddr.mkMeta)
    domain: str = "consul"        # consul DNS domain in the authority
    consistencyMode: str = "default"  # default | stale | consistent
    prefix: str = "/io.l5d.consul"

    def mk(self) -> Namer:
        try:
            api = ConsulApi(self.host, self.port, token=self.token,
                            consistency=self.consistencyMode)
        except ValueError as e:
            raise ConfigError(str(e)) from None
        return ConsulNamer(api, include_tag=self.includeTag,
                           prefer_service_address=self.preferServiceAddress,
                           set_host=self.setHost, domain=self.domain)
