"""The four-level binding cache: paths -> trees -> bounds -> clients: a copy of
``linkerd_tpu/router/binding.py``.

Reference parity: router/core/.../DstBindingFactory.scala:102-221 —
``Cached`` holds four ServiceFactoryCaches (default capacity 1000 each,
10-minute idle TTL) so that many logical paths share one bound tree, many
trees share bound stacks, and many bounds share one concrete client. Here:

- pathCache:   Dst.Path (path + dtab) -> path service observing the live
               bind Activity (address churn and dtab updates flow through
               WITHOUT re-creating the path stack).
- treeCache:   simplified NameTree[BoundName] -> NameTreeFactory
               (weighted union / alt failover selection per request).
- boundCache:  BoundName -> bound service (residual/bound ctx annotation).
- clientCache: client id Path -> balancer over the bound Var[Addr] wrapped
               in the protocol client stack.

Eviction (capacity LRU or idle TTL) closes the evicted stack — safe
because in-flight requests hold a direct reference to the services they
traverse (SURVEY.md §7 hard part 3).
"""

from __future__ import annotations

import asyncio
import logging
import time
from dataclasses import dataclass, field
from typing import Any, Awaitable, Callable, Dict, Generic, Optional, Tuple, TypeVar

from linkerd_tpu_torch.core import Activity, Dtab, Path, Var
from linkerd_tpu_torch.core.activity import Failed, Ok, Pending
from linkerd_tpu_torch.core.addr import Addr, BoundName
from linkerd_tpu_torch.core.nametree import (
    Alt, Empty, Fail, Leaf, NameTree, Neg, Union as TreeUnion,
)
from linkerd_tpu_torch.namer.core import NameInterpreter
from linkerd_tpu_torch.router.service import Service, Status
from linkerd_tpu_torch.router.stages import staged

log = logging.getLogger(__name__)

K = TypeVar("K")


@dataclass(frozen=True)
class DstPath:
    """A logical destination (ref: Dst.Path, router/core/.../Dst.scala:14)."""

    path: Path
    base_dtab: Dtab = Dtab()
    local_dtab: Dtab = Dtab()

    @property
    def dtab(self) -> Dtab:
        return self.base_dtab + self.local_dtab

    def __repr__(self) -> str:
        return f"DstPath({self.path.show})"


class UnboundError(Exception):
    """Binding resolved to Neg: no dentry/namer matched
    (-> 4xx at the server edge, ref: RoutingFactory.UnknownDst)."""


class BindingFailed(Exception):
    """Binding resolved to Fail or the name service errored (-> 5xx)."""


class ServiceCache(Generic[K]):
    """Keyed cache of live Services with LRU capacity + idle-TTL eviction."""

    def __init__(self, name: str, capacity: int = 1000,
                 idle_ttl: float = 600.0):
        self.name = name
        self.capacity = capacity
        self.idle_ttl = idle_ttl
        self._entries: Dict[K, Tuple[Service, float]] = {}

    def get(self, key: K, mk: Callable[[], Service]) -> Service:
        now = time.monotonic()
        hit = self._entries.get(key)
        if hit is not None:
            svc, _ = hit
            self._entries[key] = (svc, now)
            return svc
        svc = mk()
        self._entries[key] = (svc, now)
        self._evict(now)
        return svc

    def _evict(self, now: float) -> None:
        doomed = []
        if len(self._entries) > self.capacity:
            by_age = sorted(self._entries.items(), key=lambda kv: kv[1][1])
            for key, (svc, _) in by_age[: len(self._entries) - self.capacity]:
                doomed.append((key, svc))
        for key, (svc, last) in list(self._entries.items()):
            if now - last > self.idle_ttl:
                doomed.append((key, svc))
        for key, svc in doomed:
            self._entries.pop(key, None)
            _close_async(svc)

    def __len__(self) -> int:
        return len(self._entries)

    async def close(self) -> None:
        entries, self._entries = self._entries, {}
        for svc, _ in entries.values():
            try:
                await svc.close()
            except Exception as e:  # noqa: BLE001 — cache close must
                # visit every entry; a failed close is worth a line
                log.debug("bound service close failed: %r", e)


def _log_close_error(t: "asyncio.Task") -> None:
    if not t.cancelled() and t.exception() is not None:
        log.warning("evicted service close failed: %r", t.exception())


def _close_async(svc: Service) -> None:
    try:
        loop = asyncio.get_running_loop()
    except RuntimeError:
        return
    loop.create_task(svc.close()).add_done_callback(_log_close_error)


class NameTreeFactory(Service):
    """Per-request selection over a simplified NameTree[BoundName]
    (ref: NameTreeFactory in DstBindingFactory.scala:183-188).

    Union: weighted random choice, preferring OPEN branches.
    Alt: first branch whose selected service is OPEN, else the last.
    """

    def __init__(self, tree: NameTree, bound_for: Callable[[BoundName], Service],
                 rng=None):
        import random as _random
        self.tree = tree
        self._bound_for = bound_for
        self._rng = rng or _random.Random()

    def _select(self, tree: NameTree) -> Optional[Service]:
        if isinstance(tree, Leaf):
            svc = self._bound_for(tree.value)
            return svc if svc.status is Status.OPEN else None
        if isinstance(tree, Alt):
            # Trees here are pre-simplified (DynBoundService simplifies), so
            # a Fail can only be the final branch; stop there.
            for sub in tree.trees:
                if isinstance(sub, Fail):
                    break
                got = self._select(sub)
                if got is not None:
                    return got
            return None
        if isinstance(tree, TreeUnion):
            choices = [(w.weight, w.tree) for w in tree.weighted]
            total = sum(w for w, _ in choices)
            if total <= 0:
                return None
            # try up to len(choices) weighted draws, skipping dead branches
            for _ in range(len(choices)):
                r = self._rng.random() * total
                acc = 0.0
                chosen = choices[-1][1]
                for w, sub in choices:
                    acc += w
                    if r <= acc:
                        chosen = sub
                        break
                got = self._select(chosen)
                if got is not None:
                    return got
            return None
        return None  # Neg / Empty / Fail

    async def __call__(self, req):
        tree = self.tree
        if isinstance(tree, Neg):
            raise UnboundError("name resolved to Neg")
        if isinstance(tree, (Fail,)):
            raise BindingFailed("name resolved to Fail")
        if isinstance(tree, Empty):
            raise BindingFailed("name bound to empty replica set")
        svc = self._select(tree)
        if svc is None:
            # no OPEN branch; fall back to any leaf (least-bad dispatch)
            svc = self._any_leaf(tree)
        if svc is None:
            raise BindingFailed("no usable branch in name tree")
        return await svc(req)

    def _any_leaf(self, tree: NameTree) -> Optional[Service]:
        if isinstance(tree, Leaf):
            return self._bound_for(tree.value)
        if isinstance(tree, Alt):
            for sub in tree.trees:
                if isinstance(sub, Fail):
                    break  # Fail terminates an Alt; never fall past it
                got = self._any_leaf(sub)
                if got is not None:
                    return got
        if isinstance(tree, TreeUnion):
            for w in tree.weighted:
                got = self._any_leaf(w.tree)
                if got is not None:
                    return got
        return None


class DynBoundService(Service):
    """A path's service: tracks the live bind Activity and dispatches
    through the current tree (ref: DynBoundFactory.scala).

    Pending binds wait (bounded by ``bind_timeout``); Failed binds raise.
    """

    def __init__(self, activity: Activity, tree_for: Callable[[NameTree], Service],
                 bind_timeout: float = 10.0):
        self._activity = activity
        self._tree_for = tree_for
        self.bind_timeout = bind_timeout

    async def __call__(self, req):
        with staged(req, "binding"):
            st = self._activity.current
            if isinstance(st, Pending):
                try:
                    await asyncio.wait_for(self._activity.to_future(),
                                           self.bind_timeout)
                except asyncio.TimeoutError:
                    raise BindingFailed("name binding timed out") from None
                st = self._activity.current
            if isinstance(st, Failed):
                raise BindingFailed(f"name binding failed: {st.exc!r}")
            tree = st.value.simplified
            svc = self._tree_for(tree)
        with staged(req, "service"):
            return await svc(req)

    async def close(self) -> None:
        self._activity.close()


class DstBindingFactory:
    """The four-level cache wiring (ref: DstBindingFactory.Cached)."""

    def __init__(self, interpreter: NameInterpreter,
                 client_factory: Callable[[BoundName], Service],
                 path_filters: Optional[Callable[[DstPath, Service], Service]] = None,
                 bound_filters: Optional[Callable[[BoundName, Service], Service]] = None,
                 capacity: int = 1000, idle_ttl: float = 600.0,
                 bind_timeout: float = 10.0):
        self._interpreter = interpreter
        self._client_factory = client_factory
        self._path_filters = path_filters
        self._bound_filters = bound_filters
        self.bind_timeout = bind_timeout
        self.paths: ServiceCache[DstPath] = ServiceCache("paths", capacity, idle_ttl)
        self.trees: ServiceCache[NameTree] = ServiceCache("trees", capacity, idle_ttl)
        self.bounds: ServiceCache[BoundName] = ServiceCache("bounds", capacity, idle_ttl)
        self.clients: ServiceCache[Path] = ServiceCache("clients", capacity, idle_ttl)

    # paths -> trees -> bounds -> clients
    def path_service(self, dst: DstPath) -> Service:
        def mk() -> Service:
            activity = self._interpreter.bind(dst.dtab, dst.path)
            svc: Service = DynBoundService(activity, self._tree_service,
                                           self.bind_timeout)
            if self._path_filters is not None:
                svc = self._path_filters(dst, svc)
            return svc

        return self.paths.get(dst, mk)

    def _tree_service(self, tree: NameTree) -> Service:
        return self.trees.get(tree, lambda: NameTreeFactory(tree, self._bound_service))

    def _bound_service(self, bound: BoundName) -> Service:
        def mk() -> Service:
            svc = self._client_service(bound)
            if self._bound_filters is not None:
                svc = self._bound_filters(bound, svc)
            return svc

        return self.bounds.get(bound, mk)

    def _client_service(self, bound: BoundName) -> Service:
        return self.clients.get(bound.id_, lambda: self._client_factory(bound))

    async def close(self) -> None:
        for cache in (self.paths, self.trees, self.bounds, self.clients):
            await cache.close()
