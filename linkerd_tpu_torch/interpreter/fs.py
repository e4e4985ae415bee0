"""``io.l5d.fs`` interpreter: the base dtab read live from a watched file.

Ref: interpreter/fs/.../FsInterpreterConfig.scala:1-35 — a
ConfiguredDtabNamer whose dtab Activity follows the file's contents
(edits re-bind every live path). Watching is mtime-polling like the fs
namer (the portable equivalent of the reference's WatchService).

A copy of ``linkerd_tpu/interpreter/fs.py``.
"""

from __future__ import annotations

import asyncio
import logging
import os
from dataclasses import dataclass
from typing import Optional

from linkerd_tpu_torch.config import ConfigError, register
from linkerd_tpu_torch.core import Activity, Dtab
from linkerd_tpu_torch.core.activity import Ok
from linkerd_tpu_torch.namer.core import ConfiguredDtabNamer, NameInterpreter

log = logging.getLogger(__name__)


class FileDtab:
    """An Activity[Dtab] following one file's contents."""

    def __init__(self, path: str, poll_interval: float = 0.25):
        self.path = path
        self.poll_interval = poll_interval
        self.activity: Activity[Dtab] = Activity.mutable()
        self._mtime: Optional[int] = None
        self._task: Optional[asyncio.Task] = None
        self.refresh()

    def refresh(self) -> None:
        try:
            mtime = os.stat(self.path).st_mtime_ns
        except FileNotFoundError:
            # keep the last dtab if we had one; stay pending otherwise
            self._mtime = None
            return
        if mtime == self._mtime:
            return
        try:
            with open(self.path, "r", encoding="utf-8") as f:
                text = f.read()
        except OSError as e:
            # transient read failure (e.g. permissions): do NOT record the
            # mtime, so the next poll retries even without an edit
            log.warning("fs interpreter: cannot read %s: %s", self.path, e)
            return
        # a parse failure records the mtime: a persistently bad file
        # warns once per EDIT, not once per poll tick
        self._mtime = mtime
        try:
            self.activity.update(Ok(Dtab.read(text)))
        except Exception as e:  # noqa: BLE001 — bad dtab: keep last good
            log.warning("fs interpreter: bad dtab in %s: %s", self.path, e)
            if not isinstance(self.activity.current, Ok):
                self.activity.set_exception(e)

    def start(self) -> "FileDtab":
        if self._task is None or self._task.done():
            self._task = asyncio.get_event_loop().create_task(self._run())
        return self

    async def _run(self) -> None:
        while True:
            await asyncio.sleep(self.poll_interval)
            self.refresh()

    def close(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None


@register("interpreter", "io.l5d.fs")
@dataclass
class FsInterpreterConfig:
    dtabFile: str = ""
    pollIntervalSecs: float = 0.25

    def mk(self, namers) -> NameInterpreter:
        if not self.dtabFile:
            raise ConfigError("io.l5d.fs interpreter needs dtabFile")
        file_dtab = FileDtab(self.dtabFile, self.pollIntervalSecs)
        interp = ConfiguredDtabNamer(list(namers), dtab=file_dtab.activity,
                                     on_bind=lambda: file_dtab.start())
        interp._file_dtab = file_dtab  # handle for refresh/close (tests)
        return interp
