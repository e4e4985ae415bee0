"""namerd config parsing and process assembly: the counterpart of
``linkerd_tpu/namerd/config.py`` for the in-memory and fs stores, the
HTTP control interface, the gRPC mesh interface and the thrift name
interpreter interface.

Ref: namerd/core/.../NamerdConfig.scala:28-95 (storage + namers + ifaces ->
Namerd of Servables) and namerd/main/.../Main.scala:10-55. YAML shape:

    storage: {kind: io.l5d.inMemory | io.l5d.fs, ...}
    namers: [{kind: io.l5d.fs, rootDir: ...}]
    interfaces:
      - {kind: io.l5d.mesh, port: 4321}
      - {kind: io.l5d.thriftNameInterpreter, port: 4100}
      - {kind: io.l5d.httpController, port: 4180}
    admin: {port: 9991}

The reference's other kinds are refused by name with the ROADMAP item
that brings each (``UNPORTED_KINDS``): its zk, etcd, consul and k8s
stores (``namerd/stores.py``) need their clients.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from linkerd_tpu_torch.config import ConfigError, register
from linkerd_tpu_torch.config.parser import (
    instantiate_as, instantiate_ported, parse_config,
)
from linkerd_tpu_torch.core import Dtab, Path
from linkerd_tpu_torch.namerd.core import Namerd
from linkerd_tpu_torch.namerd.http_api import HttpControlService
from linkerd_tpu_torch.namerd.mesh_iface import DEFAULT_MESH_PORT, MeshIface
from linkerd_tpu_torch.namerd.store import (
    DtabStore, FsDtabStore, InMemoryDtabStore,
)
from linkerd_tpu_torch.protocol.h2.server import H2Server
from linkerd_tpu_torch.protocol.http.server import HttpServer

DEFAULT_HTTP_CONTROL_PORT = 4180

# Ensure built-in plugin registrations are loaded (the LoadService
# analogue; ref: Linker.scala:64-75 SPI loading).
import linkerd_tpu_torch.namer.fs  # noqa: E402,F401

_STORES = "ROADMAP Queue 1 item 15 (namerd's remaining stores)"

# Kinds the reference registers and the port has not ported yet, by
# category, each with the item that brings it.
UNPORTED_KINDS: Dict[str, Dict[str, str]] = {
    "namerdIface": {},
    "dtabStore": {k: _STORES for k in (
        "io.l5d.etcd", "io.l5d.consul", "io.l5d.zk", "io.l5d.k8s")},
}


def _instantiate(category: str, raw: Any, where: str) -> Any:
    return instantiate_ported(category, raw, where,
                              UNPORTED_KINDS.get(category, {}))


def _instantiate_all(category: str, raws: Optional[List[Any]],
                     where: str) -> List[Any]:
    return [_instantiate(category, r, f"{where}[{i}]")
            for i, r in enumerate(raws or [])]


# ---- storage kinds ---------------------------------------------------------

@register("dtabStore", "io.l5d.inMemory")
@dataclass
class InMemoryStoreConfig:
    namespaces: Optional[Dict[str, str]] = None  # ns -> dtab text

    def mk(self) -> DtabStore:
        initial = {ns: Dtab.read(text)
                   for ns, text in (self.namespaces or {}).items()}
        return InMemoryDtabStore(initial)


@register("dtabStore", "io.l5d.fs")
@dataclass
class FsStoreConfig:
    directory: str

    def mk(self) -> DtabStore:
        return FsDtabStore(self.directory)


# ---- interface kinds -------------------------------------------------------

@register("namerdIface", "io.l5d.httpController")
@dataclass
class HttpControllerConfig:
    port: int = DEFAULT_HTTP_CONTROL_PORT
    ip: str = "127.0.0.1"

    def mk(self, namerd: Namerd):
        return HttpServer(HttpControlService(namerd),
                          host=self.ip, port=self.port)


@register("namerdIface", "io.l5d.mesh")
@dataclass
class MeshIfaceConfig:
    port: int = DEFAULT_MESH_PORT
    ip: str = "127.0.0.1"

    def mk(self, namerd: Namerd):
        iface = MeshIface(namerd)
        return H2Server(iface.dispatcher, host=self.ip, port=self.port)


@register("namerdIface", "io.l5d.thriftNameInterpreter")
@dataclass
class ThriftIfaceConfig:
    """The stamped long-poll thrift interface (the reference's default
    linkerd<->namerd protocol; ref ThriftNamerInterface.scala:1-573)."""

    port: int = 4100
    ip: str = "127.0.0.1"
    bindingCacheActive: int = 1000
    addrCacheActive: int = 1000

    def mk(self, namerd: Namerd):
        from linkerd_tpu_torch.namerd.thrift_iface import ThriftNamerIface
        return ThriftNamerIface(
            namerd, host=self.ip, port=self.port,
            binding_cache=self.bindingCacheActive,
            addr_cache=self.addrCacheActive)


# ---- assembly --------------------------------------------------------------

@dataclass
class NamerdSpec:
    storage: Dict[str, Any]
    interfaces: List[Any] = field(default_factory=list)
    namers: Optional[List[Any]] = None
    admin: Optional[Dict[str, Any]] = None


def parse_namerd_spec(text: str) -> NamerdSpec:
    data = parse_config(text)
    if not isinstance(data, dict):
        raise ConfigError("namerd config must be a mapping")
    spec = instantiate_as(NamerdSpec, data)
    if not spec.storage:
        raise ConfigError("namerd config needs 'storage'")
    if not spec.interfaces:
        raise ConfigError("namerd config needs at least one interface")
    return spec


class NamerdProcess:
    """Assembled namerd: store + namers + iface servers (+ admin)."""

    def __init__(self, spec: NamerdSpec, config_dict: Any = None):
        self.spec = spec
        self.config_dict = config_dict
        # the interfaces are checked before the store and namers are
        # built, so a refused kind leaks nothing
        self._iface_cfgs = _instantiate_all(
            "namerdIface", spec.interfaces, "interfaces")
        store = _instantiate("dtabStore", spec.storage, "storage").mk()
        namers: List[Tuple[Path, Any]] = []
        for ncfg in _instantiate_all("namer", spec.namers, "namers"):
            prefix = Path.read(getattr(ncfg, "prefix", f"/{ncfg.kind}"))
            namers.append((prefix, ncfg.mk()))
        # one MetricsTree behind the interfaces + the store, exported by
        # the admin server at /metrics.json
        from linkerd_tpu_torch.telemetry.metrics import MetricsTree
        self.metrics = MetricsTree()
        self.namerd = Namerd(store, namers, metrics=self.metrics)
        self.servers: List[Any] = []
        self.admin_server = None

    async def start(self) -> "NamerdProcess":
        for cfg in self._iface_cfgs:
            server = cfg.mk(self.namerd)
            await server.start()
            self.servers.append(server)
        if self.spec.admin is not None:
            from linkerd_tpu_torch.admin.server import AdminServer
            from linkerd_tpu_torch.namerd.admin_pages import (
                namerd_admin_handlers,
            )
            self.admin_server = AdminServer(
                self.metrics, config_dict=self.config_dict,
                port=int(self.spec.admin.get("port", 9991)))
            exact, prefix = namerd_admin_handlers(self.namerd)
            self.admin_server.add_handlers(exact)
            for p, h in prefix:
                self.admin_server.add_prefix_handler(p, h)
            await self.admin_server.start()
        return self

    @property
    def bound_ports(self) -> List[int]:
        return [s.bound_port for s in self.servers]

    async def close(self) -> None:
        if self.admin_server is not None:
            await self.admin_server.close()
        for s in self.servers:
            await s.close()
        await self.namerd.close()


async def serve_namerd(config_text: str) -> NamerdProcess:
    spec = parse_namerd_spec(config_text)
    return await NamerdProcess(spec, parse_config(config_text)).start()
