"""Announcers: register server addresses into service discovery; a copy
of ``linkerd_tpu/announcer.py`` without ``ZkAnnouncer`` and its
``io.l5d.serversets`` kind, which need a ZooKeeper client (the linker
refuses that kind by name).

Ref: linkerd/core/.../Announcer.scala:41 (SPI; ``servers[].announce``
paths matched by announcer prefix, driven from Main.announce,
linkerd/main/.../Main.scala:97-130). The fs announcer is the file-based
counterpart of the fs namer — a linkerd announcing into a directory that
other linkerds discover from, and the scorer sidecar registering its
replicas where linkers resolve them.
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
