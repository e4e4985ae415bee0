"""Namer SPI and the recursive dtab interpreter: a copy of
``linkerd_tpu/namer/core.py``.

Reference parity:
- ``Namer`` — finagle Namer: lookup(path) -> Activity[NameTree[Name]] where
  leaves are either terminal bound names or paths to delegate further.
- ``ConfiguredDtabNamer`` — namer/core/.../ConfiguredDtabNamer.scala:14-42:
  recursive dtab lookup with ``/#/`` configured-namer prefixes (Paths.scala)
  and ``/$/`` utility namers, leaf-by-leaf grafting, and a recursion limit.

Here a NameTree's leaves during interpretation are either ``BoundName``
(terminal — carries the live Var[Addr]) or ``Path`` (delegate further).
"""

from __future__ import annotations

import abc
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

from linkerd_tpu_torch.core import (
    Activity, Addr, Address, Dtab, Path, Var,
)
from linkerd_tpu_torch.core.addr import ADDR_NEG, AddrFailed, Bound, BoundName
from linkerd_tpu_torch.core.nametree import (
    Alt, EMPTY, FAIL, Leaf, NameTree, NEG, Neg, Union as TreeUnion, Weighted,
)

CONFIGURED_PREFIX = "#"  # /#/<namer-prefix>/... -> configured namer
UTILITY_PREFIX = "$"     # /$/<utility>/...      -> utility namer
MAX_DEPTH = 100

Name = Union[BoundName, Path]


class Namer(abc.ABC):
    """Resolves residual paths under a configured prefix."""

    @abc.abstractmethod
    def lookup(self, path: Path) -> Activity[NameTree[Name]]: ...

    def close(self) -> None:
        return


class NameInterpreter(abc.ABC):
    """Binds logical paths through a delegation table
    (ref: finagle NameInterpreter; remote implementations are the namerd
    client interpreters, SURVEY.md §3.3)."""

    @abc.abstractmethod
    def bind(self, dtab: Dtab, path: Path) -> Activity[NameTree[BoundName]]: ...


def bind_leaves(
    tree: NameTree, f: Callable[[Path], Activity[NameTree[BoundName]]]
) -> Activity[NameTree[BoundName]]:
    """Substitute every Path leaf of ``tree`` with its resolved subtree.

    Combines leaf Activities with Activity.collect and grafts results back
    in position, preserving Alt/Union structure and weights.
    """
    leaves: List[Path] = []

    def collect(t: NameTree) -> None:
        if isinstance(t, Leaf):
            if isinstance(t.value, Path):
                leaves.append(t.value)
        elif isinstance(t, Alt):
            for s in t.trees:
                collect(s)
        elif isinstance(t, TreeUnion):
            for w in t.weighted:
                collect(w.tree)

    collect(tree)
    if not leaves:
        return Activity.value(tree)

    acts = [f(p) for p in leaves]

    def graft(subs: tuple) -> NameTree[BoundName]:
        it = iter(subs)

        def walk(t: NameTree) -> NameTree:
            if isinstance(t, Leaf):
                if isinstance(t.value, Path):
                    return next(it)
                return t
            if isinstance(t, Alt):
                return Alt(*[walk(s) for s in t.trees])
            if isinstance(t, TreeUnion):
                return TreeUnion(*[Weighted(w.weight, walk(w.tree))
                                   for w in t.weighted])
            return t

        return walk(tree)

    return Activity.collect(acts).map(graft)


# -- utility namers (/$/...) -------------------------------------------------

UtilityNamer = Callable[[Path], NameTree[Name]]
_UTILITY: Dict[str, UtilityNamer] = {}


def register_utility(name: str) -> Callable[[UtilityNamer], UtilityNamer]:
    def deco(fn: UtilityNamer) -> UtilityNamer:
        _UTILITY[name] = fn
        return fn
    return deco


@register_utility("inet")
def _inet(residual: Path) -> NameTree[Name]:
    """``/$/inet/<host>/<port>[/residual...]`` -> bound address
    (ref: finagle's IN-process inet namer used throughout linkerd configs)."""
    if len(residual) < 2:
        return FAIL
    host, port_s = residual[0], residual[1]
    try:
        port = int(port_s)
    except ValueError:
        return FAIL
    addr: Var[Addr] = Var(Bound.of(Address.mk(host, port)))
    bid = Path.of("$", "inet", host, port_s)
    return Leaf(BoundName(bid, addr, residual.drop(2)))


@register_utility("nil")
def _nil(residual: Path) -> NameTree[Name]:
    return EMPTY


@register_utility("fail")
def _fail(residual: Path) -> NameTree[Name]:
    return FAIL


# -- io.buoyant rewriting namers (ref: namer/core/.../http.scala:163,
#    hostport.scala, rinet.scala — /$/-addressable path rewriters whose
#    results re-enter dtab resolution) ---------------------------------------

import re as _re  # noqa: E402

_HOST_RE = _re.compile(r"^[A-Za-z0-9.:_-]+$")
_METHOD_RE = _re.compile(r"^[A-Z]+$")
# RFC 1035/1123 label (the reference's DNS_LABEL check for port names):
# no leading or trailing hyphen
_DNS_LABEL_RE = _re.compile(r"^[a-z0-9]([-a-z0-9]*[a-z0-9])?$")


def _drop_port(hostname: str) -> str:
    idx = hostname.find(":")
    return hostname[:idx] if idx > 0 else hostname


def _subdomain(domain: str, hostname: str) -> Optional[str]:
    sfx = "." + domain
    host = _drop_port(hostname)
    return host[:-len(sfx)] if host.endswith(sfx) else None


@register_utility("io.buoyant.http.anyMethod")
def _any_method(residual: Path) -> NameTree[Name]:
    """``/METHOD/rest`` -> ``/rest``."""
    if len(residual) >= 1 and _METHOD_RE.match(residual[0]):
        return Leaf(residual.drop(1))
    return NEG


@register_utility("io.buoyant.http.anyMethodPfx")
def _any_method_pfx(residual: Path) -> NameTree[Name]:
    """``/pfx/METHOD/rest`` -> ``/pfx/rest``."""
    if len(residual) >= 2 and _METHOD_RE.match(residual[1]):
        return Leaf(Path.of(residual[0]) + residual.drop(2))
    return NEG


@register_utility("io.buoyant.http.anyHost")
def _any_host(residual: Path) -> NameTree[Name]:
    """``/host/rest`` -> ``/rest``."""
    if len(residual) >= 1 and _HOST_RE.match(residual[0]):
        return Leaf(residual.drop(1))
    return NEG


@register_utility("io.buoyant.http.anyHostPfx")
def _any_host_pfx(residual: Path) -> NameTree[Name]:
    """``/pfx/host/rest`` -> ``/pfx/rest``."""
    if len(residual) >= 2 and _HOST_RE.match(residual[1]):
        return Leaf(Path.of(residual[0]) + residual.drop(2))
    return NEG


@register_utility("io.buoyant.http.subdomainOf")
def _subdomain_of(residual: Path) -> NameTree[Name]:
    """``/domain/sub.domain/rest`` -> ``/sub/rest``."""
    if (len(residual) >= 2 and _HOST_RE.match(residual[0])
            and _HOST_RE.match(residual[1])):
        sub = _subdomain(residual[0], residual[1])
        if sub:
            return Leaf(Path.of(sub) + residual.drop(2))
    return NEG


@register_utility("io.buoyant.http.subdomainOfPfx")
def _subdomain_of_pfx(residual: Path) -> NameTree[Name]:
    """``/domain/pfx/sub.domain/rest`` -> ``/pfx/sub/rest``."""
    if (len(residual) >= 3 and _HOST_RE.match(residual[0])
            and _HOST_RE.match(residual[2])):
        sub = _subdomain(residual[0], residual[2])
        if sub:
            return Leaf(Path.of(residual[1], sub) + residual.drop(3))
    return NEG


@register_utility("io.buoyant.http.domainToPath")
def _domain_to_path(residual: Path) -> NameTree[Name]:
    """``/foo.buoyant.io/rest`` -> ``/io/buoyant/foo/rest``."""
    if len(residual) >= 1 and _HOST_RE.match(residual[0]):
        return Leaf(
            Path.of(*reversed(residual[0].split("."))) + residual.drop(1))
    return NEG


@register_utility("io.buoyant.http.domainToPathPfx")
def _domain_to_path_pfx(residual: Path) -> NameTree[Name]:
    """``/pfx/foo.buoyant.io/rest`` -> ``/pfx/io/buoyant/foo/rest``."""
    if len(residual) >= 2 and _HOST_RE.match(residual[1]):
        return Leaf(Path.of(residual[0],
                            *reversed(residual[1].split(".")))
                    + residual.drop(2))
    return NEG


STATUS_NAMER_PREFIX = Path.of("$", "io.buoyant.http.status")


@register_utility("io.buoyant.http.status")
def _http_status(residual: Path) -> NameTree[Name]:
    """``/<code>/rest`` binds to an in-process service that always
    responds with <code> (ref: router/http/.../status.scala — the http
    client factory recognizes the bound id and short-circuits)."""
    if len(residual) >= 1:
        try:
            code = int(residual[0])
        except ValueError:
            return NEG
        if 100 <= code < 600:
            bid = STATUS_NAMER_PREFIX + Path.of(residual[0])
            addr: Var[Addr] = Var(Bound.of(Address.mk("0.0.0.0", code)))
            return Leaf(BoundName(bid, addr, residual.drop(1)))
    return NEG


def _host_colon_port(seg: str) -> Optional[Tuple[str, str]]:
    parts = seg.split(":")
    if len(parts) != 2:
        return None
    host, port = parts
    if not host or len(port) > 63 or not _DNS_LABEL_RE.match(port):
        return None
    return host, port


@register_utility("io.buoyant.hostportPfx")
def _hostport_pfx(residual: Path) -> NameTree[Name]:
    """``/pfx/host:port/etc`` -> ``/pfx/host/port/etc``."""
    if len(residual) >= 2:
        hp = _host_colon_port(residual[1])
        if hp is not None:
            return Leaf(Path.of(residual[0], hp[0], hp[1])
                        + residual.drop(2))
    return NEG


@register_utility("io.buoyant.porthostPfx")
def _porthost_pfx(residual: Path) -> NameTree[Name]:
    """``/pfx/host:port/etc`` -> ``/pfx/port/host/etc``."""
    if len(residual) >= 2:
        hp = _host_colon_port(residual[1])
        if hp is not None:
            return Leaf(Path.of(residual[0], hp[1], hp[0])
                        + residual.drop(2))
    return NEG


@register_utility("io.buoyant.rinet")
def _rinet(residual: Path) -> NameTree[Name]:
    """``/$/io.buoyant.rinet/<port>/<host>`` == ``/$/inet/<host>/<port>``
    (ref: rinet.scala)."""
    if len(residual) < 2:
        return NEG
    port_s, host = residual[0], residual[1]
    try:
        port = int(port_s)
    except ValueError:
        return NEG
    addr: Var[Addr] = Var(Bound.of(Address.mk(host, port)))
    bid = Path.of("$", "io.buoyant.rinet", port_s, host)
    return Leaf(BoundName(bid, addr, residual.drop(2)))


def utility_lookup(path: Path) -> NameTree[Name]:
    """Resolve a ``/$/<utility>/...`` path; unknown utilities are Neg."""
    if len(path) < 2 or path[0] != UTILITY_PREFIX:
        return NEG
    fn = _UTILITY.get(path[1])
    if fn is None:
        return NEG
    return fn(path.drop(2))


# -- the interpreter ---------------------------------------------------------


class TooDeep(Exception):
    pass


class ConfiguredDtabNamer(NameInterpreter):
    """Recursive dtab interpretation over configured namers.

    ``namers`` is an ordered list of (prefix, Namer); a path ``/#/pfx/rest``
    is delegated to the first namer whose prefix matches (most-specific
    config wins by list order, matching the reference's first-match
    semantics). The base dtab is reactive: an Activity[Dtab] so control-plane
    dtab updates re-bind live paths.
    """

    def __init__(self, namers: Sequence[Tuple[Path, Namer]] = (),
                 dtab: Optional[Activity] = None,
                 on_bind: Optional[Callable[[], None]] = None):
        self.namers = list(namers)
        self.dtab_activity: Activity = (
            dtab if dtab is not None else Activity.value(Dtab.empty()))
        # lazy-start hook: watched-dtab interpreters (fs file, k8s
        # configmap) start their watch loop on first bind, when an event
        # loop is guaranteed to exist
        self.on_bind = on_bind

    def bind(self, local_dtab: Dtab, path: Path) -> Activity[NameTree[BoundName]]:
        if self.on_bind is not None:
            self.on_bind()

        def with_dtab(base: Dtab) -> Activity[NameTree[BoundName]]:
            dtab = base + local_dtab
            return self._bind(dtab, path, 0)

        return self.dtab_activity.flat_map(with_dtab)

    # -- internals --------------------------------------------------------
    def _bind(self, dtab: Dtab, path: Path, depth: int
              ) -> Activity[NameTree[BoundName]]:
        if depth > MAX_DEPTH:
            return Activity.exception(
                TooDeep(f"dtab delegation exceeded {MAX_DEPTH} levels at "
                        f"{path.show}"))
        if len(path) > 0 and path[0] == UTILITY_PREFIX:
            tree = utility_lookup(path)
            return bind_leaves(
                tree, lambda p: self._bind(dtab, p, depth + 1))
        if len(path) > 0 and path[0] == CONFIGURED_PREFIX:
            return self._lookup_configured(dtab, path, depth)
        tree = dtab.lookup(path)
        if isinstance(tree, Neg):
            return Activity.value(NEG)
        return bind_leaves(tree, lambda p: self._bind(dtab, p, depth + 1))

    def _lookup_configured(self, dtab: Dtab, path: Path, depth: int
                           ) -> Activity[NameTree[BoundName]]:
        rest = path.drop(1)  # strip '#'
        for prefix, namer in self.namers:
            if rest.starts_with(prefix):
                act = namer.lookup(rest.drop(len(prefix)))
                return act.flat_map(
                    lambda tree: bind_leaves(
                        tree, lambda p: self._bind(dtab, p, depth + 1)))
        return Activity.value(NEG)


class RewritingNamer(Namer):
    """PathMatcher-driven path rewriter (ref: namer/core/.../
    RewritingNamer.scala, kind ``io.l5d.rewrite``): a matched path is
    rewritten by the template (captures substituted) and re-resolved."""

    def __init__(self, matcher, pattern: str):
        self.matcher = matcher
        self.pattern = pattern

    def lookup(self, path: Path) -> Activity[NameTree[Name]]:
        rewritten = self.matcher.substitute(path, self.pattern)
        if rewritten is None:
            return Activity.value(NEG)
        return Activity.value(Leaf(Path.read(rewritten)))
