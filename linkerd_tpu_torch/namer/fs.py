"""``io.l5d.fs`` — filesystem service discovery: a copy of
``linkerd_tpu/namer/fs.py``.

Reference parity: namer/fs/.../WatchingNamer.scala + Watcher.scala — a
directory of files, one per service; each file lists ``host port [weight]``
per line. The namer resolves ``/#/io.l5d.fs/<svc>[/residual]`` to a
BoundName whose Var[Addr] tracks live file edits.

The reference uses java.nio.WatchService; here an asyncio mtime-polling
task (interval configurable) drives the same ``Activity[Buf]``-per-file
semantics — polling is the portable choice and the watch granularity
(sub-second) matches the reference's rebind latency in practice.
"""

from __future__ import annotations

import asyncio
import logging
import os
from dataclasses import dataclass
from typing import Dict, Optional

from linkerd_tpu_torch.config import register
from linkerd_tpu_torch.core import Activity, Addr, Address, Path, Var
from linkerd_tpu_torch.core.addr import ADDR_NEG, AddrFailed, Bound, BoundName
from linkerd_tpu_torch.core.nametree import Leaf, NameTree, NEG
from linkerd_tpu_torch.namer.core import Namer

log = logging.getLogger(__name__)


def parse_addrs(text: str) -> Addr:
    """Parse ``host port [weight]`` lines into a Bound replica set."""
    addresses = []
    for i, line in enumerate(text.splitlines()):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        if len(parts) not in (2, 3):
            return AddrFailed(f"line {i + 1}: expected 'host port [weight]'")
        host, port_s = parts[0], parts[1]
        try:
            port = int(port_s)
            weight = float(parts[2]) if len(parts) == 3 else 1.0
        except ValueError:
            return AddrFailed(f"line {i + 1}: bad port/weight")
        addresses.append(Address.mk(host, port, weight))
    return Bound(frozenset(addresses))


class FsNamer(Namer):
    """Watches ``root_dir``; one file per service name."""

    def __init__(self, root_dir: str, poll_interval: float = 0.25):
        self.root_dir = root_dir
        self.poll_interval = poll_interval
        self._vars: Dict[str, Var[Addr]] = {}
        self._mtimes: Dict[str, Optional[float]] = {}
        self._task: Optional[asyncio.Task] = None

    # -- Namer ------------------------------------------------------------
    def lookup(self, path: Path) -> Activity[NameTree]:
        """A reactive tree: Neg while the file doesn't exist, Leaf(bound)
        once it does (file creation/deletion re-binds live — ref:
        WatchingNamer's Activity-per-file semantics)."""
        if len(path) == 0:
            return Activity.value(NEG)
        svc = path[0]
        var = self._svc_var(svc)
        bid = Path.of("#", "io.l5d.fs", svc)
        bound_leaf = Leaf(BoundName(bid, var, path.drop(1)))

        def to_tree(addr: Addr) -> NameTree:
            from linkerd_tpu_torch.core.addr import AddrNeg
            return NEG if isinstance(addr, AddrNeg) else bound_leaf

        from linkerd_tpu_torch.core.activity import Ok
        return Activity(var.map(lambda a: Ok(to_tree(a))))

    def _svc_var(self, svc: str) -> Var[Addr]:
        var = self._vars.get(svc)
        if var is None:
            var = Var(self._read(svc))
            self._vars[svc] = var
            self._ensure_watch_task()
        return var

    # -- watching ---------------------------------------------------------
    def _path_of(self, svc: str) -> str:
        return os.path.join(self.root_dir, svc)

    def _read(self, svc: str) -> Addr:
        p = self._path_of(svc)
        try:
            with open(p, "r", encoding="utf-8") as f:
                text = f.read()
            self._mtimes[svc] = os.stat(p).st_mtime_ns
            return parse_addrs(text)
        except FileNotFoundError:
            self._mtimes[svc] = None
            return ADDR_NEG
        except OSError as e:
            return AddrFailed(str(e))

    def refresh(self) -> None:
        """Re-check every watched file (poll body; callable from tests)."""
        for svc, var in self._vars.items():
            p = self._path_of(svc)
            try:
                mt: Optional[float] = os.stat(p).st_mtime_ns
            except OSError:
                mt = None
            if mt != self._mtimes.get(svc):
                var.update(self._read(svc))

    def _ensure_watch_task(self) -> None:
        if self._task is not None and not self._task.done():
            return
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            return  # no loop (sync tests drive refresh() directly)
        self._task = loop.create_task(self._watch_loop())

    async def _watch_loop(self) -> None:
        while True:
            await asyncio.sleep(self.poll_interval)
            try:
                self.refresh()
            except Exception:  # noqa: BLE001
                log.exception("fs namer refresh failed")

    def close(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None


@register("namer", "io.l5d.fs")
@dataclass
class FsNamerConfig:
    rootDir: str
    prefix: str = "/io.l5d.fs"
    pollIntervalSecs: float = 0.25

    def mk(self) -> Namer:
        if not os.path.isdir(self.rootDir):
            raise ValueError(f"io.l5d.fs rootDir does not exist: {self.rootDir}")
        return FsNamer(self.rootDir, self.pollIntervalSecs)
