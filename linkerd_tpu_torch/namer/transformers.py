"""NameTree transformers: rewrite bound trees / replica sets after binding:
a copy of ``linkerd_tpu/namer/transformers.py``.

Ref: namer/core/.../NameTreeTransformer.scala:146 + DelegatingNameTree
Transformer; plugin kinds under interpreter/per-host and interpreter/subnet
(PortTransformer.scala:40, LocalhostTransformer, SpecificHostTransformer,
Netmask.scala/SubnetGatewayTransformer.scala). Transformed bound ids are
prefixed ``/%/<kind>`` (the reference's transformer prefix) so binding
caches never conflate transformed and untransformed clients.
"""

from __future__ import annotations

import abc
import ipaddress
import socket
from dataclasses import dataclass, field
from typing import FrozenSet, List, Optional

from linkerd_tpu_torch.config import ConfigError, register
from linkerd_tpu_torch.core import Activity, Path, Var
from linkerd_tpu_torch.core.addr import Addr, Address, Bound, BoundName
from linkerd_tpu_torch.core.nametree import (
    Alt, Leaf, NameTree, Union, Weighted,
)
from linkerd_tpu_torch.namer.core import Namer

TRANSFORMER_PREFIX = "%"  # /%/<kind>/... (ref: TransformerPrefix)


class AddressTransformer(abc.ABC):
    """Rewrites the concrete replica set of every bound leaf."""

    def __init__(self, kind: str):
        self.kind = kind

    @abc.abstractmethod
    def transform_addresses(
            self, addresses: FrozenSet[Address]) -> FrozenSet[Address]: ...

    def transform_addr(self, addr: Addr) -> Addr:
        if isinstance(addr, Bound):
            return Bound(self.transform_addresses(addr.addresses), addr.meta)
        return addr

    def transform_leaf(self, bound: BoundName) -> BoundName:
        new_id = Path.of(TRANSFORMER_PREFIX, *self.kind.split("/")).concat(
            bound.id_)
        return BoundName(new_id, bound.addr.map(self.transform_addr),
                        bound.residual)

    def transform_tree(self, tree: NameTree) -> NameTree:
        if isinstance(tree, Leaf):
            if isinstance(tree.value, Path):
                # un-bound Path leaf (e.g. emitted by io.l5d.const earlier
                # in the chain): nothing address-level to rewrite
                return tree
            return Leaf(self.transform_leaf(tree.value))
        if isinstance(tree, Alt):
            return Alt(*(self.transform_tree(t) for t in tree.trees))
        if isinstance(tree, Union):
            return Union(*(Weighted(w.weight, self.transform_tree(w.tree))
                           for w in tree.weighted))
        return tree


class TransformingNamer(Namer):
    """Applies a transformer chain to a namer's bind results."""

    def __init__(self, inner: Namer,
                 transformers: List[AddressTransformer]):
        self._inner = inner
        self._transformers = transformers

    def lookup(self, path: Path) -> Activity[NameTree]:
        act = self._inner.lookup(path)
        for t in self._transformers:
            act = act.map(t.transform_tree)
        return act

    def close(self) -> None:
        self._inner.close()


# ---- kinds -----------------------------------------------------------------

class PortTransformer(AddressTransformer):
    """Every endpoint's port replaced (ref: PortTransformer.scala:40 —
    route to a fixed proxy port on each discovered host)."""

    def __init__(self, port: int):
        super().__init__("io.l5d.port")
        self.port = port

    def transform_addresses(self, addresses):
        return frozenset(
            Address(a.host, self.port, a.weight, a.meta) for a in addresses)


def _local_ips() -> FrozenSet[str]:
    ips = {"127.0.0.1", "::1"}
    try:
        hostname = socket.gethostname()
        for info in socket.getaddrinfo(hostname, None):
            ips.add(info[4][0])
    except OSError:
        pass
    return frozenset(ips)


class LocalhostTransformer(AddressTransformer):
    """Keep only endpoints on this host (DaemonSet-style per-host routing,
    ref: LocalhostTransformer)."""

    def __init__(self, local_ips: Optional[FrozenSet[str]] = None):
        super().__init__("io.l5d.localhost")
        self.local_ips = local_ips if local_ips is not None else _local_ips()

    def transform_addresses(self, addresses):
        return frozenset(a for a in addresses if a.host in self.local_ips)


class SpecificHostTransformer(AddressTransformer):
    """Keep only endpoints on one configured host
    (ref: SpecificHostTransformer)."""

    def __init__(self, host: str):
        super().__init__("io.l5d.specificHost")
        self.host = host

    def transform_addresses(self, addresses):
        return frozenset(a for a in addresses if a.host == self.host)


class SubnetGatewayTransformer(AddressTransformer):
    """Replace each endpoint with the gateway sharing its subnet
    (DaemonSet routing across nodes; ref: SubnetGatewayTransformer.scala:78
    + Netmask.scala). Gateways come from a live Var[Addr] (e.g. a
    DaemonSet's endpoints)."""

    def __init__(self, gateways: Var, netmask: str):
        super().__init__("io.l5d.subnet")
        self._gateways = gateways
        try:
            self._prefix = int(netmask) if not ("." in netmask) else \
                ipaddress.ip_network(f"0.0.0.0/{netmask}").prefixlen
        except ValueError as e:
            raise ConfigError(f"bad netmask {netmask!r}: {e}") from None

    def _subnet(self, host: str):
        try:
            return ipaddress.ip_network(
                f"{host}/{self._prefix}", strict=False)
        except ValueError:
            return None

    def transform_addresses(self, addresses):
        gaddr = self._gateways.sample()
        gateways = gaddr.addresses if isinstance(gaddr, Bound) else frozenset()
        by_subnet = {}
        for g in gateways:
            net = self._subnet(g.host)
            if net is not None:
                by_subnet[net] = g
        out = set()
        for a in addresses:
            net = self._subnet(a.host)
            if net is not None and net in by_subnet:
                # the gateway address itself (NOT per-pod weight/meta):
                # N pods behind one gateway must dedup to one endpoint
                out.add(by_subnet[net])
        return frozenset(out)


# ---- config kinds ----------------------------------------------------------

@register("transformer", "io.l5d.port")
@dataclass
class PortTransformerConfig:
    """Rewrite every bound address to ``port`` (route to a sidecar
    proxy listening on a fixed port on each replica's host)."""

    port: int = 4140

    def mk(self) -> AddressTransformer:
        return PortTransformer(self.port)


@register("transformer", "io.l5d.localhost")
@dataclass
class LocalhostTransformerConfig:
    """Replace every bound host with 127.0.0.1, keeping ports — the
    node-local sidecar shape (ref: io.l5d.localhost)."""

    def mk(self) -> AddressTransformer:
        return LocalhostTransformer()


@register("transformer", "io.l5d.specificHost")
@dataclass
class SpecificHostTransformerConfig:
    """Replace every bound host with ``host``, keeping ports (pin all
    traffic through one gateway address)."""

    host: str = "127.0.0.1"

    def mk(self) -> AddressTransformer:
        return SpecificHostTransformer(self.host)


@register("transformer", "io.l5d.replace")
@dataclass
class ReplaceTransformerConfig:
    """Replace every replica set with a static one (the reference's
    ConstTransformer/ReplaceTransformer pair, used to force traffic
    through a fixed gateway)."""

    addrs: List[str] = field(default_factory=list)  # "host port" lines

    def mk(self) -> AddressTransformer:
        parsed = []
        for line in self.addrs:
            parts = line.split()
            if len(parts) != 2:
                raise ConfigError(
                    f"io.l5d.replace addrs: expected 'host port', "
                    f"got {line!r}")
            parsed.append(Address.mk(parts[0], int(parts[1])))
        const = frozenset(parsed)

        class _Replace(AddressTransformer):
            def __init__(self):
                super().__init__("io.l5d.replace")

            def transform_addresses(self, addresses):
                return const

        return _Replace()


class SubnetLocalTransformer(AddressTransformer):
    """Keep only endpoints in the local address's subnet (ref:
    interpreter/subnet/.../SubnetLocalTransformer.scala — the
    io.l5d.k8s.localnode shape: route only to pods on this node)."""

    def __init__(self, local_ip: str, netmask: str = "255.255.255.0",
                 kind: str = "io.l5d.k8s.localnode"):
        super().__init__(kind)
        # same syntaxes as SubnetGatewayTransformer: prefix length or
        # dotted mask; bad values are config errors, not tracebacks
        try:
            prefixlen = int(netmask) if "." not in netmask else \
                ipaddress.ip_network(f"0.0.0.0/{netmask}").prefixlen
            self._net = ipaddress.ip_network(
                f"{local_ip}/{prefixlen}", strict=False)
        except ValueError as e:
            raise ConfigError(
                f"bad localnode ip/netmask {local_ip!r}/{netmask!r}: {e}"
            ) from None

    def transform_addresses(self, addresses):
        out = set()
        for a in addresses:
            try:
                if ipaddress.ip_address(a.host) in self._net:
                    out.add(a)
            except ValueError:
                continue
        return frozenset(out)


class MetadataFilterTransformer(AddressTransformer):
    """Keep only endpoints whose metadata key equals ``value`` (ref:
    MetadataFiltertingNameTreeTransformer — hostNetwork localnode keyed
    by nodeName)."""

    def __init__(self, meta_key: str, value: str,
                 kind: str = "io.l5d.k8s.localnode"):
        super().__init__(kind)
        self._key = meta_key
        self._value = value

    def transform_addresses(self, addresses):
        return frozenset(
            a for a in addresses
            if dict(a.meta).get(self._key) == self._value)


class MetadataGatewayTransformer(AddressTransformer):
    """Replace each endpoint with the gateway sharing its metadata key
    (hostNetwork DaemonSet routing: match pod nodeName -> gateway
    nodeName; ref: MetadataGatewayTransformer)."""

    def __init__(self, gateways: "Var", meta_key: str,
                 kind: str = "io.l5d.k8s.daemonset"):
        super().__init__(kind)
        self._gateways = gateways
        self._key = meta_key

    def transform_addresses(self, addresses):
        gaddr = self._gateways.sample()
        gateways = gaddr.addresses if isinstance(gaddr, Bound) else frozenset()
        by_key = {}
        for g in gateways:
            k = dict(g.meta).get(self._key)
            if k is not None:
                by_key[k] = g
        out = set()
        for a in addresses:
            k = dict(a.meta).get(self._key)
            if k is not None and k in by_key:
                out.add(by_key[k])
        return frozenset(out)


class _BoundTreeAddrVar:
    """Var[Addr]-shaped view over a namer lookup's Activity[NameTree]
    (gateway sets for the daemonset transformer come from a live
    EndpointsNamer binding)."""

    def __init__(self, activity: Activity):
        self._activity = activity

    def sample(self) -> Addr:
        from linkerd_tpu_torch.core.activity import Ok
        state = self._activity.current
        if not isinstance(state, Ok):
            return Bound(frozenset())
        tree = state.value
        if isinstance(tree, Leaf):
            return tree.value.addr.sample()
        return Bound(frozenset())


@register("transformer", "io.l5d.k8s.daemonset")
@dataclass
class DaemonSetTransformerConfig:
    """Route via the DaemonSet pod on each endpoint's node (ref:
    DaemonSetTransformerInitializer.scala:54 — gateways are the
    daemonset service's endpoints; subnet match by default, nodeName
    metadata match with hostNetwork)."""

    namespace: str = ""
    service: str = ""
    port: str = ""
    k8sHost: str = "localhost"
    k8sPort: int = 8001
    hostNetwork: bool = False
    netmask: str = "255.255.255.0"
    useTls: bool = False
    caCertPath: Optional[str] = None
    insecureSkipVerify: bool = False

    def mk(self) -> AddressTransformer:
        if not (self.namespace and self.service and self.port):
            raise ConfigError(
                "io.l5d.k8s.daemonset needs namespace, service and port")
        from linkerd_tpu_torch.k8s.namer import EndpointsNamer, _mk_api
        api = _mk_api(self.k8sHost, self.k8sPort, self.useTls,
                      self.caCertPath, self.insecureSkipVerify)
        namer = EndpointsNamer(api)
        act = namer.lookup(
            Path.of(self.namespace, self.port, self.service))
        gateways = _BoundTreeAddrVar(act)
        if self.hostNetwork:
            return MetadataGatewayTransformer(
                gateways, "nodeName", kind="io.l5d.k8s.daemonset")
        t = SubnetGatewayTransformer(gateways, self.netmask)
        t.kind = "io.l5d.k8s.daemonset"
        return t


@register("transformer", "io.l5d.k8s.localnode")
@dataclass
class LocalNodeTransformerConfig:
    """Keep only endpoints on this node (ref:
    LocalNodeTransformerInitializer.scala:42 — POD_IP subnet match, or
    nodeName metadata match with hostNetwork)."""

    hostNetwork: bool = False
    netmask: str = "255.255.255.0"
    podIp: str = ""      # overrides $POD_IP (tests)
    nodeName: str = ""   # overrides $NODE_NAME (tests)

    def mk(self) -> AddressTransformer:
        import os
        if self.hostNetwork:
            node = self.nodeName or os.environ.get("NODE_NAME") or ""
            if not node:
                raise ConfigError(
                    "io.l5d.k8s.localnode hostNetwork needs NODE_NAME")
            return MetadataFilterTransformer("nodeName", node)
        ip = self.podIp or os.environ.get("POD_IP") or ""
        if not ip:
            raise ConfigError("io.l5d.k8s.localnode needs POD_IP")
        return SubnetLocalTransformer(ip, self.netmask)


class ConstTransformer(AddressTransformer):
    """Replace the whole bound tree with the binding of a fixed path
    (ref: namer/core/.../ConstTransformer.scala, kind ``io.l5d.const`` —
    force all traffic through e.g. a local proxy). The emitted Path leaf
    re-enters dtab resolution in ConfiguredDtabNamer.bind_leaves."""

    def __init__(self, path: Path):
        super().__init__("io.l5d.const")
        self._path = path

    def transform_addresses(self, addresses):  # unused: tree-level
        return addresses

    def transform_tree(self, tree: NameTree) -> NameTree:
        if isinstance(tree, (Leaf, Alt, Union)):
            return Leaf(self._path)
        return tree  # Neg/Fail/Empty stay


@register("transformer", "io.l5d.const")
@dataclass
class ConstTransformerConfig:
    """Replace every binding with the tree bound at ``path`` — the
    blunt "send everything here" override."""

    path: str = ""

    def mk(self) -> AddressTransformer:
        if not self.path:
            raise ConfigError("io.l5d.const transformer needs path")
        return ConstTransformer(Path.read(self.path))


@register("namer", "io.l5d.rewrite")
@dataclass
class RewritingNamerConfig:
    """ref: RewritingNamerInitializer.scala — the namer mounts at
    ``prefix`` (like every namer); the RESIDUAL after the prefix strip is
    matched by ``pattern`` (a PathMatcher expression) and rewritten into
    ``name`` (a template with {var} captures), then re-resolved."""

    prefix: str = ""      # mount point under /#/ (required)
    pattern: str = ""     # PathMatcher over the residual, e.g. /{env}/{svc}
    name: str = ""        # rewrite template, e.g. /envs/{env}/{svc}

    def mk(self) -> "Namer":
        if not (self.prefix and self.pattern and self.name):
            raise ConfigError(
                "io.l5d.rewrite needs prefix, pattern and name")
        from linkerd_tpu_torch.core.pathmatcher import PathMatcher
        from linkerd_tpu_torch.namer.core import RewritingNamer
        matcher = PathMatcher(self.pattern)
        # load-time validation: a typo'd capture or unparseable template
        # would otherwise silently bind EVERY path to Neg at runtime
        dummy = {v: "x" for v in matcher.var_names}
        rendered = PathMatcher.substitute_vars(dummy, self.name)
        if rendered is None:
            raise ConfigError(
                f"io.l5d.rewrite name {self.name!r} references captures "
                f"not in pattern {self.pattern!r} "
                f"(available: {sorted(matcher.var_names)})")
        try:
            Path.read(rendered)
        except ValueError as e:
            raise ConfigError(
                f"io.l5d.rewrite name {self.name!r} is not a valid "
                f"path template: {e}") from None
        return RewritingNamer(matcher, self.name)
