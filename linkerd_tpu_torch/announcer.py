"""The fs announcer: counterpart of ``FsAnnouncer`` in
``linkerd_tpu/announcer.py``.

A scorer replica registers its address in a directory that the fs namer
of a linker reads, as the reference's replicas do: one file per
announced name, one ``host port`` line per replica.
"""

from __future__ import annotations

import fcntl
import os
from typing import Callable, List, Optional

from linkerd_tpu_torch.core import Path


class Closable:
    """A handle whose ``close`` undoes what made it, once."""

    def __init__(self, fn: Callable[[], None]):
        self._fn: Optional[Callable[[], None]] = fn

    def close(self) -> None:
        fn, self._fn = self._fn, None
        if fn is not None:
            fn()


class FsAnnouncer:
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
        # replicas of several processes announce into one directory, so
        # the read-modify-write is serialized across processes by flock
        # on a lock file beside the announcement
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
        """Register ``host:port`` under ``name`` (the path after the
        announcer prefix); closing the handle withdraws it."""
        path = self._file(name)
        entry = f"{host} {port}"
        self._rewrite(path, drop=entry, add=entry)
        return Closable(lambda: self._rewrite(path, drop=entry))
