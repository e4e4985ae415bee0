"""Namerd assembly: store-backed namespaced interpreters: a copy of
``linkerd_tpu/namerd/core.py``.

Ref: namerd/core/.../NamerdConfig.scala:28-95 (mk: storage + namers +
ifaces) and ConfiguredDtabNamer wiring — each namespace's interpreter is a
recursive dtab interpreter whose base dtab is the *live* stored dtab, so a
dtab write re-binds every watching linkerd without reconnects.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from linkerd_tpu_torch.core import Activity, Dtab, Path
from linkerd_tpu_torch.namer.core import ConfiguredDtabNamer, Namer, NameInterpreter
from linkerd_tpu_torch.namerd.store import DtabStore, VersionedDtab
from linkerd_tpu_torch.telemetry.metrics import MetricsTree, observed


class InstrumentedDtabStore(DtabStore):
    """Store wrapper recording per-op latency/failure stats under
    ``namerd/store/<op>/*`` — the control plane's persistence seam is
    where slow disks and CAS storms first show (ref: the reference's
    storage stats the MetricsTree never had here)."""

    def __init__(self, inner: DtabStore, metrics: MetricsTree):
        self._inner = inner
        self._node = metrics.scope("namerd", "store")

    def __getattr__(self, name):
        # store-kind-specific surface (fs paths, zk sessions, test
        # probes) stays reachable through the wrapper
        if name == "_inner":  # guard re-entrancy before __init__ ran
            raise AttributeError(name)
        return getattr(self._inner, name)

    def list(self):
        return self._inner.list()

    def observe(self, ns: str):
        with observed(self._node.scope("observe")):
            return self._inner.observe(ns)

    async def create(self, ns: str, dtab: Dtab) -> None:
        with observed(self._node.scope("create")):
            await self._inner.create(ns, dtab)

    async def update(self, ns: str, dtab: Dtab, version: bytes) -> None:
        with observed(self._node.scope("update")):
            await self._inner.update(ns, dtab, version)

    async def put(self, ns: str, dtab: Dtab) -> None:
        with observed(self._node.scope("put")):
            await self._inner.put(ns, dtab)

    async def delete(self, ns: str) -> None:
        with observed(self._node.scope("delete")):
            await self._inner.delete(ns)

    def close(self) -> None:
        self._inner.close()


class NamespacedInterpreters:
    """ns -> NameInterpreter over the store's live dtab (cached)."""

    def __init__(self, store: DtabStore,
                 namers: Sequence[Tuple[Path, Namer]] = ()):
        self._store = store
        self._namers = list(namers)
        self._cache: Dict[str, NameInterpreter] = {}

    def interpreter(self, ns: str) -> NameInterpreter:
        interp = self._cache.get(ns)
        if interp is None:
            dtab_act: Activity[Dtab] = self._store.observe(ns).map(
                lambda vd: vd.dtab if vd is not None else Dtab.empty())
            interp = ConfiguredDtabNamer(self._namers, dtab=dtab_act)
            self._cache[ns] = interp
        return interp


class Namerd:
    """The assembled control plane: store + namers + servable interfaces.

    ``metrics`` is the process-wide MetricsTree every interface
    instruments into (``namerd/{http,thrift,mesh,store}/...``) and the
    admin server exports at ``/metrics.json``; one is created when the
    caller doesn't supply one, so embedded uses stay observable."""

    def __init__(self, store: DtabStore,
                 namers: Sequence[Tuple[Path, Namer]] = (),
                 metrics: Optional[MetricsTree] = None):
        self.metrics = metrics if metrics is not None else MetricsTree()
        self.store = InstrumentedDtabStore(store, self.metrics)
        self.namers = list(namers)
        self.interpreters = NamespacedInterpreters(self.store, namers)
        self._servers: List = []

    def interpreter(self, ns: str) -> NameInterpreter:
        return self.interpreters.interpreter(ns)

    async def close(self) -> None:
        for s in self._servers:
            await s.close()
        for _, n in self.namers:
            n.close()
        self.store.close()
