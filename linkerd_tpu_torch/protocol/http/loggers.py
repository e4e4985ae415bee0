"""Per-router request-logger plugin chain (the ``logger`` SPI): a copy of
``linkerd_tpu/protocol/http/loggers.py``.

Ref: linkerd/protocol/http/.../HttpLoggerConfig.scala — router configs
carry ``loggers: [{kind: ...}, ...]``; each kind materializes a filter
inserted into the client stack per request (the plugin point istio's
mixer logger uses, IstioLogger.scala). Kinds here:

- ``io.l5d.http.debug`` — logs one line per request/response pair at a
  configurable level (method, uri, dst, status, latency).
- ``io.l5d.http.file`` — appends JSON lines to a file off the event
  loop (same QueueListener pattern as the access log).
"""

from __future__ import annotations

import json
import logging
import time
from dataclasses import dataclass
from typing import Optional

from linkerd_tpu_torch.config import ConfigError, register
from linkerd_tpu_torch.router.service import Filter, Service

log = logging.getLogger("linkerd_tpu.reqlog")


class DebugLogger(Filter):
    def __init__(self, level: int, logger_name: str):
        self._level = level
        self._log = logging.getLogger(logger_name)

    async def apply(self, req, service: Service):
        t0 = time.monotonic()
        status = "err"
        try:
            rsp = await service(req)
            status = rsp.status
            return rsp
        finally:
            if self._log.isEnabledFor(self._level):
                dst = req.ctx.get("dst")
                self._log.log(
                    self._level, "%s %s dst=%s -> %s (%.1fms)",
                    req.method, req.uri,
                    dst.path.show if dst is not None else "-",
                    status, (time.monotonic() - t0) * 1e3)


@register("logger", "io.l5d.http.debug")
@dataclass
class DebugLoggerConfig:
    """Log every request/response line to a python logger at
    ``level`` — the zero-dependency debugging tap."""

    level: str = "DEBUG"       # DEBUG | INFO | WARNING
    logger: str = "linkerd_tpu.reqlog"

    def mk(self) -> Filter:
        level = logging.getLevelName(self.level.upper())
        if not isinstance(level, int):
            raise ConfigError(f"io.l5d.http.debug: bad level {self.level!r}")
        return DebugLogger(level, self.logger)


def mk_file_emit(path: str):
    """Off-event-loop line sink: (emit, close). One QueueListener thread
    drains a SimpleQueue into a FileHandler; the logger is standalone
    (NOT registered with logging.getLogger — registry entries live
    forever and id()-reuse could attach two handlers to one logger).
    Shared by the access log and the file request-logger."""
    import queue as _queue
    from logging.handlers import QueueHandler, QueueListener

    q: _queue.SimpleQueue = _queue.SimpleQueue()
    logger = logging.Logger("linkerd_tpu.filesink", logging.INFO)
    logger.addHandler(QueueHandler(q))
    fh = logging.FileHandler(path)
    fh.setFormatter(logging.Formatter("%(message)s"))
    listener = QueueListener(q, fh)
    listener.start()

    def close() -> None:
        listener.stop()
        fh.close()

    return logger.info, close


class FileLogger(Filter):
    """JSON-lines request log, written off the event loop."""

    def __init__(self, path: str):
        self._emit, self._close = mk_file_emit(path)

    def close(self) -> None:
        self._close()

    async def apply(self, req, service: Service):
        t0 = time.monotonic()
        status: Optional[int] = None
        try:
            rsp = await service(req)
            status = rsp.status
            return rsp
        finally:
            dst = req.ctx.get("dst")
            self._emit(json.dumps({
                "ts": round(time.time(), 3),
                "method": req.method,
                "uri": req.uri,
                "dst": dst.path.show if dst is not None else None,
                "status": status,
                "latency_ms": round((time.monotonic() - t0) * 1e3, 3),
            }))


@register("logger", "io.l5d.http.file")
@dataclass
class FileLoggerConfig:
    """Apache-combined-format access log appended to ``path``."""

    path: str = ""

    def mk(self) -> Filter:
        if not self.path:
            raise ConfigError("io.l5d.http.file logger needs path")
        return FileLogger(self.path)
