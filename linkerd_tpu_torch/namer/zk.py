"""ZooKeeper-backed namers: serversets, leader groups, curator discovery.

Reference parity:
- ``io.l5d.serversets`` — namer/serversets/.../ServersetNamer.scala:81:
  ``/#/io.l5d.serversets/<zkPath...>[:endpoint]`` binds a Twitter
  serverset (member_* children carrying serviceEndpoint JSON); when the
  full path isn't a serverset, segments fall back into the residual one
  at a time (longest-prefix binding).
- ``io.l5d.zkLeader`` — namer/zk-leader/.../ZkLeaderNamer.scala:86: the
  path names a leader-election group; resolves to the address(es) in the
  DATA of the lowest-sequence ephemeral child, with the same
  prefix-fallback behavior.
- ``io.l5d.curator`` — namer/curator/.../CuratorNamer.scala:124: the
  first segment is a Curator service name under ``basePath``; instances
  are JSON ServiceInstance records (address/port/sslPort).

All three share one watch-loop shape: read the relevant znodes with
watches armed, publish a NameTree, then park until any watch (or a
session loss) fires and re-read — ZooKeeper's one-shot watches re-armed
by re-reading, which is exactly how the reference's ZkSession resumes.
"""

from __future__ import annotations

import asyncio
import json
import logging
import random
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from linkerd_tpu_torch.config import ConfigError, register
from linkerd_tpu_torch.core import Activity, Path, Var
from linkerd_tpu_torch.core.activity import Ok, PENDING
from linkerd_tpu_torch.core.addr import Addr, Address, Bound, BoundName
from linkerd_tpu_torch.core.nametree import Leaf, NameTree, NEG
from linkerd_tpu_torch.namer.core import Namer
from linkerd_tpu_torch.zk.client import ZkClient, ZkError, ZK_NONODE, zk_backoff

log = logging.getLogger(__name__)

_shared_clients: Dict[str, ZkClient] = {}


def shared_zk(hosts: str, session_timeout_ms: int = 10000) -> ZkClient:
    """One ZK session per connect string per process — namers, stores and
    announcers pointed at the same ensemble share it."""
    client = _shared_clients.get(hosts)
    if client is None or client._closed:  # noqa: SLF001
        client = ZkClient(hosts, session_timeout_ms)
        _shared_clients[hosts] = client
    return client


async def close_shared_zk(hosts: Optional[str] = None) -> None:
    """Close (one or all) shared ZK sessions — the shutdown API for
    short-lived consumers like dcos-bootstrap; long-lived processes keep
    their sessions for the process lifetime."""
    if hosts is not None:
        client = _shared_clients.pop(hosts, None)
        if client is not None:
            await client.close()
        return
    for key in list(_shared_clients):
        client = _shared_clients.pop(key)
        await client.close()


def parse_zk_addrs(zk_addrs, hosts: str = "") -> str:
    if hosts:
        return hosts
    if zk_addrs:
        return ",".join(f"{a['host']}:{a.get('port', 2181)}"
                        for a in zk_addrs)
    raise ConfigError("zk namer needs zkAddrs or hosts")


def parse_serverset_member(data: bytes,
                           endpoint: Optional[str]) -> Optional[Address]:
    """Twitter serverset member JSON -> Address (None if not ALIVE or the
    requested endpoint is absent)."""
    try:
        obj = json.loads(data.decode("utf-8"))
    except Exception:  # noqa: BLE001
        return None
    if obj.get("status", "ALIVE") != "ALIVE":
        return None
    if endpoint:
        ep = (obj.get("additionalEndpoints") or {}).get(endpoint)
    else:
        ep = obj.get("serviceEndpoint")
    if not ep or not ep.get("host") or ep.get("port") is None:
        return None
    meta = {}
    if obj.get("shard") is not None:
        meta["shard"] = obj["shard"]
    return Address.mk(ep["host"], int(ep["port"]), **meta)


def parse_host_ports(text: str) -> List[Tuple[str, int]]:
    """``host:port[,host:port...]`` (the zk-leader DATA format)."""
    out = []
    for part in text.split(","):
        part = part.strip()
        if not part:
            continue
        host, _, port = part.rpartition(":")
        if not host or not port.isdigit():
            continue
        out.append((host, int(port)))
    return out


class _ZkNamerBase(Namer):
    """Shared per-path lookup cache + watch-loop scaffolding."""

    def __init__(self, zk: ZkClient, id_prefix: Path):
        self.zk = zk
        self.id_prefix = id_prefix
        self._lookups: Dict[str, Activity] = {}
        self._tasks: Dict[str, asyncio.Task] = {}

    def lookup(self, path: Path) -> Activity[NameTree]:
        if len(path) == 0:
            return Activity.value(NEG)
        key = path.show
        act = self._lookups.get(key)
        if act is None:
            act = Activity.mutable(PENDING)
            self._lookups[key] = act
            self._tasks[key] = asyncio.get_event_loop().create_task(
                self._loop(path, act))
        return act

    def close(self) -> None:
        for t in self._tasks.values():
            t.cancel()
        self._tasks.clear()

    async def _loop(self, path: Path, act: Activity) -> None:
        attempt = 0
        while True:
            event = asyncio.Event()
            try:
                tree = await self._bind_once(path, event)
                act.update(Ok(tree))
                attempt = 0
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001 — keep last good state
                log.debug("zk namer bind %s: %r", path.show, e)
                if not isinstance(act.current, Ok):
                    act.set_exception(e)
                attempt = await zk_backoff(attempt)
                continue
            await event.wait()

    async def _bind_once(self, path: Path, event: asyncio.Event) -> NameTree:
        raise NotImplementedError


class ServersetNamer(_ZkNamerBase):
    def __init__(self, zk: ZkClient, id_prefix: Path):
        super().__init__(zk, id_prefix)
        self._addr_vars: Dict[str, Var] = {}

    def _candidates(self, path: Path):
        """Longest-prefix first: (zkPath, endpoint, residual) per the
        reference's recursive fallback bind (ServersetNamer.scala bind)."""
        segs = list(path)
        for n in range(len(segs), 0, -1):
            prefix = segs[:n]
            endpoint = None
            last = prefix[-1]
            if ":" in last:
                name, endpoint = last.split(":", 1)
                prefix = prefix[:-1] + [name]
            zk_path = "/" + "/".join(prefix)
            yield zk_path, endpoint, Path.of(*segs[n:]), n

    async def _bind_once(self, path: Path, event: asyncio.Event) -> NameTree:
        watch = lambda ev: event.set()  # noqa: E731
        for zk_path, endpoint, residual, n in self._candidates(path):
            stat = await self.zk.exists(zk_path, watch=watch)
            if stat is None:
                continue  # creation watch armed; fall back to shorter
            children = await self.zk.get_children(zk_path, watch=watch)
            members = [c for c in sorted(children)
                       if c.startswith("member_")]
            addresses = []
            for m in members:
                try:
                    data, _ = await self.zk.get_data(
                        f"{zk_path}/{m}", watch=watch)
                except ZkError as e:
                    if e.code == ZK_NONODE:
                        continue
                    raise
                a = parse_serverset_member(data, endpoint)
                if a is not None:
                    addresses.append(a)
            var_key = f"{zk_path}!{endpoint or ''}"
            var = self._addr_vars.get(var_key)
            if not members and var is None:
                # a bare znode isn't a serverset: keep falling back. (If we
                # HAVE bound it before, an empty member set means the
                # serverset drained — publish empty, keep the binding.)
                continue
            addr = Bound(frozenset(addresses))
            if var is None:
                var = Var(addr)
                self._addr_vars[var_key] = var
            else:
                var.update(addr)
            bid = self.id_prefix + Path.of(*path[:n])
            return Leaf(BoundName(bid, var, residual))
        return NEG


class ZkLeaderNamer(_ZkNamerBase):
    def __init__(self, zk: ZkClient, id_prefix: Path):
        super().__init__(zk, id_prefix)
        self._addr_vars: Dict[str, Var] = {}

    @staticmethod
    def _seq_of(name: str) -> int:
        tail = name[-10:]
        return int(tail) if tail.isdigit() else (1 << 62)

    async def _bind_once(self, path: Path, event: asyncio.Event) -> NameTree:
        watch = lambda ev: event.set()  # noqa: E731
        segs = list(path)
        for n in range(len(segs), 0, -1):
            zk_path = "/" + "/".join(segs[:n])
            residual = Path.of(*segs[n:])
            stat = await self.zk.exists(zk_path, watch=watch)
            if stat is None:
                continue
            children = await self.zk.get_children(zk_path, watch=watch)
            if not children:
                continue
            leader = min(children, key=self._seq_of)
            try:
                data, _ = await self.zk.get_data(
                    f"{zk_path}/{leader}", watch=watch)
            except ZkError as e:
                if e.code == ZK_NONODE:
                    event.set()  # leader raced away; re-bind now
                    continue
                raise
            addrs = [Address.mk(h, p)
                     for h, p in parse_host_ports(data.decode("utf-8"))]
            if not addrs:
                continue
            var_key = zk_path
            var = self._addr_vars.get(var_key)
            addr = Bound(frozenset(addrs))
            if var is None:
                var = Var(addr)
                self._addr_vars[var_key] = var
            else:
                var.update(addr)
            bid = self.id_prefix + Path.of(*segs[:n])
            return Leaf(BoundName(bid, var, residual))
        return NEG


class CuratorNamer(_ZkNamerBase):
    def __init__(self, zk: ZkClient, base_path: str, id_prefix: Path):
        super().__init__(zk, id_prefix)
        self.base_path = base_path.rstrip("/")
        self._addr_vars: Dict[str, Var] = {}

    async def _bind_once(self, path: Path, event: asyncio.Event) -> NameTree:
        watch = lambda ev: event.set()  # noqa: E731
        svc = path[0]
        zk_path = f"{self.base_path}/{svc}"
        stat = await self.zk.exists(zk_path, watch=watch)
        if stat is None:
            return NEG
        children = await self.zk.get_children(zk_path, watch=watch)
        addresses = []
        any_ssl = False
        for inst in sorted(children):
            try:
                data, _ = await self.zk.get_data(
                    f"{zk_path}/{inst}", watch=watch)
                obj = json.loads(data.decode("utf-8"))
            except ZkError as e:
                if e.code == ZK_NONODE:
                    continue
                raise
            except Exception:  # noqa: BLE001 — bad instance record
                continue
            host = obj.get("address")
            ssl_port = obj.get("sslPort")
            port = ssl_port if ssl_port is not None else obj.get("port")
            if not host or port is None:
                continue
            any_ssl = any_ssl or ssl_port is not None
            addresses.append(Address.mk(host, int(port)))
        var = self._addr_vars.get(svc)
        addr = Bound(frozenset(addresses), meta=(("ssl", any_ssl),))
        if var is None:
            var = Var(addr)
            self._addr_vars[svc] = var
        else:
            var.update(addr)
        bid = self.id_prefix + Path.of(svc)
        return Leaf(BoundName(bid, var, path.drop(1)))


@register("namer", "io.l5d.serversets")
@dataclass
class ServersetsNamerConfig:
    """Name via finagle serversets:
    ``/#/io.l5d.serversets/<zk-path>[:endpoint]`` resolves member znode
    JSON (serviceEndpoint + additionalEndpoints) with live watches."""

    zkAddrs: list = field(default_factory=list)
    hosts: str = ""           # alternative: "host:port,host:port"
    prefix: str = "/io.l5d.serversets"
    sessionTimeoutMs: int = 10000

    def mk(self) -> Namer:
        connect = parse_zk_addrs(self.zkAddrs, self.hosts)
        return ServersetNamer(
            shared_zk(connect, self.sessionTimeoutMs),
            Path.of("#", "io.l5d.serversets"))


@register("namer", "io.l5d.zkLeader")
@dataclass
class ZkLeaderNamerConfig:
    """Resolve to the current leader of a ZooKeeper leader-election
    group (lowest sequence znode), failing over on leader change."""

    zkAddrs: list = field(default_factory=list)
    hosts: str = ""
    prefix: str = "/io.l5d.zkLeader"
    sessionTimeoutMs: int = 10000

    def mk(self) -> Namer:
        connect = parse_zk_addrs(self.zkAddrs, self.hosts)
        return ZkLeaderNamer(
            shared_zk(connect, self.sessionTimeoutMs),
            Path.of("#", "io.l5d.zkLeader"))


@register("namer", "io.l5d.curator")
@dataclass
class CuratorNamerConfig:
    """Name via Apache Curator service discovery under ``basePath``:
    ServiceInstance JSON (address/port/sslPort) with live watches."""

    zkAddrs: list = field(default_factory=list)
    hosts: str = ""
    basePath: str = "/discovery"
    prefix: str = "/io.l5d.curator"
    sessionTimeoutMs: int = 10000

    def mk(self) -> Namer:
        connect = parse_zk_addrs(self.zkAddrs, self.hosts)
        return CuratorNamer(
            shared_zk(connect, self.sessionTimeoutMs), self.basePath,
            Path.of("#", "io.l5d.curator"))
