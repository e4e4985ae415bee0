"""Announcers: register server addresses into service discovery.

Ref: linkerd/core/.../Announcer.scala:41 (SPI; ``servers[].announce``
paths matched by announcer prefix, driven from Main.announce,
linkerd/main/.../Main.scala:97-130) and linkerd/announcer/serversets
ZkAnnouncer.scala:19. The fs announcer is the file-based counterpart of
the fs namer — a linkerd announcing into a directory that other linkerds
discover from (the single-node-stack analogue of serversets).
"""

from __future__ import annotations

import abc
import os
from dataclasses import dataclass
from typing import List, Tuple

from linkerd_tpu_torch.config import ConfigError, register
from linkerd_tpu_torch.core import Path
from linkerd_tpu_torch.core.var import Closable


class Announcer(abc.ABC):
    prefix: Path

    @abc.abstractmethod
    def announce(self, host: str, port: int, name: Path) -> Closable:
        """Register host:port under ``name`` (the path AFTER the
        announcer prefix); the Closable withdraws it."""


class FsAnnouncer(Announcer):
    """One file per announced name; one ``host port`` line per announcer
    (kind ``io.l5d.fs``)."""

    def __init__(self, root_dir: str, prefix: Path):
        self.root = root_dir
        self.prefix = prefix
        os.makedirs(root_dir, exist_ok=True)

    def _file(self, name: Path) -> str:
        if len(name) == 0:
            raise ValueError("empty announce name")
        return os.path.join(self.root, "-".join(name))

    def _rewrite(self, path: str, drop: str, add: str = "") -> None:
        # Multiple linkerds announce into one shared directory, so the
        # read-modify-write must be serialized across PROCESSES: flock on
        # a sidecar lock file (the serversets analogue of ZK's atomicity).
        import fcntl
        with open(path + ".lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            try:
                lines: List[str] = []
                if os.path.exists(path):
                    with open(path) as f:
                        lines = [ln for ln in f.read().splitlines()
                                 if ln.strip() and ln.strip() != drop]
                if add:
                    lines.append(add)
                if lines:
                    tmp = path + ".tmp"
                    with open(tmp, "w") as f:
                        f.write("\n".join(lines) + "\n")
                    os.replace(tmp, path)
                elif os.path.exists(path):
                    os.unlink(path)
            finally:
                fcntl.flock(lock, fcntl.LOCK_UN)

    def announce(self, host: str, port: int, name: Path) -> Closable:
        path = self._file(name)
        entry = f"{host} {port}"
        self._rewrite(path, drop=entry, add=entry)
        return Closable(lambda: self._rewrite(path, drop=entry))


@register("announcer", "io.l5d.fs")
@dataclass
class FsAnnouncerConfig:
    rootDir: str = ""
    prefix: str = "/io.l5d.fs"

    def mk(self) -> Announcer:
        if not self.rootDir:
            raise ConfigError("io.l5d.fs announcer needs rootDir")
        return FsAnnouncer(self.rootDir, Path.read(self.prefix))


class ZkAnnouncer(Announcer):
    """Announce into a ZK serverset: an ephemeral-sequential ``member_``
    node carrying serviceEndpoint JSON under ``{pathPrefix}{name}``
    (kind ``io.l5d.serversets``; ref: linkerd/announcer/serversets/...
    /ZkAnnouncer.scala:19 — ephemerality is the withdrawal mechanism, so
    a crashed linkerd's announcement dies with its session)."""

    def __init__(self, hosts: str, path_prefix: Path, prefix: Path,
                 session_timeout_ms: int = 10000):
        from linkerd_tpu_torch.namer.zk import shared_zk

        self.zk = shared_zk(hosts, session_timeout_ms)
        self.path_prefix = path_prefix
        self.prefix = prefix

    def announce(self, host: str, port: int, name: Path) -> Closable:
        import asyncio
        import json
        import logging

        from linkerd_tpu_torch.zk.client import ZkError, ZK_NONODE, zk_backoff

        log = logging.getLogger(__name__)
        zk_path = "/" + "/".join(self.path_prefix + name)
        data = json.dumps({
            "serviceEndpoint": {"host": host, "port": port},
            "additionalEndpoints": {},
            "status": "ALIVE",
        }).encode("utf-8")
        state = {"node": None}

        async def maintain() -> None:
            # Supervising loop: (re)create the ephemeral member and
            # re-announce whenever it disappears (session expiry deletes
            # ephemerals server-side; the watch — or the synthetic
            # Disconnected event on session loss — wakes us to rejoin).
            attempt = 0
            try:
                while True:
                    try:
                        if state["node"] is None:
                            await self.zk.ensure_path(zk_path)
                            state["node"] = await self.zk.create(
                                f"{zk_path}/member_", data,
                                ephemeral=True, sequential=True)
                            log.info("announced %s at %s:%d",
                                     state["node"], host, port)
                        gone = asyncio.Event()
                        stat = await self.zk.exists(
                            state["node"], watch=lambda ev: gone.set())
                        if stat is None:
                            state["node"] = None
                            continue
                        attempt = 0
                        await gone.wait()
                        # re-check on the next iteration (exists) —
                        # a data-change event is not a disappearance
                    except asyncio.CancelledError:
                        raise
                    except Exception as e:  # noqa: BLE001 — keep trying
                        log.debug("zk announce %s: %r", zk_path, e)
                        attempt = await zk_backoff(attempt)
            finally:
                # withdraw: delete whatever we know we created. If a
                # create was in flight when cancelled, the node is
                # ephemeral and dies with the session.
                node = state["node"]
                if node is not None:
                    try:
                        await self.zk.delete(node)
                    except ZkError as e:
                        if e.code != ZK_NONODE:
                            log.debug("zk withdraw %s: %r", node, e)
                    except Exception:  # noqa: BLE001
                        pass

        task = asyncio.get_event_loop().create_task(maintain())

        def withdraw() -> None:
            task.cancel()

        return Closable(withdraw)


@register("announcer", "io.l5d.serversets")
@dataclass
class ZkAnnouncerConfig:
    """Announce server ports as ZooKeeper serversets under
    ``pathPrefix`` (finagle-compatible member JSON), so serverset-aware
    namers (io.l5d.serversets) resolve this router's listeners."""

    zkAddrs: list = None  # type: ignore[assignment]
    hosts: str = ""
    pathPrefix: str = "/discovery"
    prefix: str = "/io.l5d.serversets"
    sessionTimeoutMs: int = 10000

    def mk(self) -> Announcer:
        from linkerd_tpu_torch.namer.zk import parse_zk_addrs

        connect = parse_zk_addrs(self.zkAddrs or [], self.hosts)
        return ZkAnnouncer(connect, Path.read(self.pathPrefix),
                           Path.read(self.prefix), self.sessionTimeoutMs)


def match_announcer(announcers: List[Tuple[Path, Announcer]],
                    announce_path: Path) -> Tuple[Announcer, Path]:
    """``/#/io.l5d.fs/web`` -> (announcer, /web)
    (ref: Main.announce prefix matching)."""
    if len(announce_path) == 0 or announce_path[0] != "#":
        raise ConfigError(
            f"announce path must start with /#/, got {announce_path.show}")
    rest = announce_path.drop(1)
    for prefix, ann in announcers:
        if rest.starts_with(prefix):
            return ann, rest.drop(len(prefix))
    raise ConfigError(f"no announcer for {announce_path.show}")
