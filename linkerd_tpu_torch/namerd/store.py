"""DtabStore SPI and backends: a copy of
``linkerd_tpu/namerd/store.py``.

Ref: namerd/core/src/main/scala/io/buoyant/namerd/DtabStore.scala —
observe/list/create/update(CAS)/put/delete over namespaced dtabs, each
namespace carrying an opaque version for compare-and-swap writes; and
namerd/storage/in-memory/.../InMemoryDtabStore.scala:131.
"""

from __future__ import annotations

import abc
import hashlib
import json
import os
from dataclasses import dataclass
from typing import Dict, FrozenSet, Optional

from linkerd_tpu_torch.core import Activity, Dtab, Var
from linkerd_tpu_torch.core.activity import Ok


@dataclass(frozen=True)
class VersionedDtab:
    dtab: Dtab
    version: bytes


class DtabNamespaceDoesNotExist(Exception):
    def __init__(self, ns: str):
        super().__init__(f"dtab namespace {ns!r} does not exist")
        self.ns = ns


class DtabNamespaceAlreadyExists(Exception):
    def __init__(self, ns: str):
        super().__init__(f"dtab namespace {ns!r} already exists")
        self.ns = ns


class DtabVersionMismatch(Exception):
    def __init__(self, ns: str):
        super().__init__(f"dtab namespace {ns!r}: version mismatch")
        self.ns = ns


def _version_of(ns: str, dtab: Dtab, generation: int) -> bytes:
    h = hashlib.sha256(f"{ns}:{generation}:{dtab.show}".encode())
    return h.digest()[:8]


class DtabStore(abc.ABC):
    """Namespaced dtab storage with CAS semantics and watchable state."""

    @abc.abstractmethod
    def list(self) -> Var[FrozenSet[str]]:
        """Live set of namespace names."""

    @abc.abstractmethod
    def observe(self, ns: str) -> Activity[Optional[VersionedDtab]]:
        """Watch one namespace; Ok(None) when the namespace is absent."""

    @abc.abstractmethod
    async def create(self, ns: str, dtab: Dtab) -> None:
        """Create; raises DtabNamespaceAlreadyExists."""

    @abc.abstractmethod
    async def update(self, ns: str, dtab: Dtab, version: bytes) -> None:
        """CAS write; raises DtabVersionMismatch / DtabNamespaceDoesNotExist."""

    @abc.abstractmethod
    async def put(self, ns: str, dtab: Dtab) -> None:
        """Unconditional upsert."""

    @abc.abstractmethod
    async def delete(self, ns: str) -> None:
        """Remove; raises DtabNamespaceDoesNotExist."""

    def close(self) -> None:
        return


class InMemoryDtabStore(DtabStore):
    """Process-local store (the test/default backend,
    ref: InMemoryDtabStore.scala; kind io.l5d.inMemory)."""

    def __init__(self, initial: Optional[Dict[str, Dtab]] = None):
        self._gen = 0
        self._dtabs: Dict[str, VersionedDtab] = {}
        self._acts: Dict[str, Activity] = {}
        self._list = Var(frozenset())
        for ns, dtab in (initial or {}).items():
            self._dtabs[ns] = VersionedDtab(dtab, _version_of(ns, dtab, 0))
        self._list.update(frozenset(self._dtabs))

    def _next_version(self, ns: str, dtab: Dtab) -> bytes:
        self._gen += 1
        return _version_of(ns, dtab, self._gen)

    def _publish(self, ns: str) -> None:
        if ns in self._acts:
            self._acts[ns].update(Ok(self._dtabs.get(ns)))
        self._list.update(frozenset(self._dtabs))

    def list(self) -> Var[FrozenSet[str]]:
        return self._list

    def observe(self, ns: str) -> Activity[Optional[VersionedDtab]]:
        if ns not in self._acts:
            self._acts[ns] = Activity.mutable(Ok(self._dtabs.get(ns)))
        return self._acts[ns]

    async def create(self, ns: str, dtab: Dtab) -> None:
        if ns in self._dtabs:
            raise DtabNamespaceAlreadyExists(ns)
        self._dtabs[ns] = VersionedDtab(dtab, self._next_version(ns, dtab))
        self._publish(ns)

    async def update(self, ns: str, dtab: Dtab, version: bytes) -> None:
        cur = self._dtabs.get(ns)
        if cur is None:
            raise DtabNamespaceDoesNotExist(ns)
        if cur.version != version:
            raise DtabVersionMismatch(ns)
        self._dtabs[ns] = VersionedDtab(dtab, self._next_version(ns, dtab))
        self._publish(ns)

    async def put(self, ns: str, dtab: Dtab) -> None:
        self._dtabs[ns] = VersionedDtab(dtab, self._next_version(ns, dtab))
        self._publish(ns)

    async def delete(self, ns: str) -> None:
        if ns not in self._dtabs:
            raise DtabNamespaceDoesNotExist(ns)
        del self._dtabs[ns]
        self._publish(ns)


class FsDtabStore(InMemoryDtabStore):
    """Dtabs persisted as files under a directory (one ``<ns>.dtab`` per
    namespace), surviving restarts — the single-node analogue of the
    reference's zk/etcd/consul stores (ref: namerd/storage/*)."""

    def __init__(self, directory: str):
        self._dir = directory
        os.makedirs(directory, exist_ok=True)
        initial: Dict[str, Dtab] = {}
        for fn in os.listdir(directory):
            if fn.endswith(".dtab"):
                with open(os.path.join(directory, fn)) as f:
                    initial[fn[:-5]] = Dtab.read(f.read())
        super().__init__(initial)

    def _write(self, ns: str) -> None:
        path = os.path.join(self._dir, f"{ns}.dtab")
        vd = self._dtabs.get(ns)
        if vd is None:
            if os.path.exists(path):
                os.unlink(path)
        else:
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                f.write(vd.dtab.show)
            os.replace(tmp, path)

    async def create(self, ns: str, dtab: Dtab) -> None:
        await super().create(ns, dtab)
        self._write(ns)

    async def update(self, ns: str, dtab: Dtab, version: bytes) -> None:
        await super().update(ns, dtab, version)
        self._write(ns)

    async def put(self, ns: str, dtab: Dtab) -> None:
        await super().put(ns, dtab)
        self._write(ns)

    async def delete(self, ns: str) -> None:
        await super().delete(ns)
        self._write(ns)
