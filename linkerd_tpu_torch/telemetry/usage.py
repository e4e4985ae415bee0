"""Anonymized usage telemetry (opt-out): a copy of
``linkerd_tpu/telemetry/usage.py``.

Ref: linkerd/core/.../UsageDataTelemeter.scala:183 — an hourly POST of
anonymized config/runtime shape (kinds in use, router count, uptime; no
names, paths, or addresses) to stats.buoyant.io unless
``usage: {enabled: false}``. JSON instead of the reference's proto
(usage.proto); the target is configurable so tests point it at a local
sink, and a host with no network turns it off with ``enabled: false``.
"""

from __future__ import annotations

import asyncio
import json
import logging
import time
import uuid
from typing import Any, Dict, Optional

log = logging.getLogger(__name__)

DEFAULT_HOST = "stats.buoyant.io"
DEFAULT_PORT = 443
INTERVAL_S = 3600.0


def build_report(spec: Any, orgId: str, instance_id: str,
                 start_time: float,
                 uptime_s: float = 0.0) -> Dict[str, Any]:
    """Anonymized shape only: kinds and counts, never user values
    (ref: UsageMessage fields in usage.proto). ``start_time`` is the
    reported wall-clock instant; ``uptime_s`` is measured by the caller
    on the monotonic clock (an NTP step must not skew it)."""
    routers = []
    for r in getattr(spec, "routers", []) or []:
        ids = r.identifier
        if isinstance(ids, dict):
            ids = [ids]
        routers.append({
            "protocol": r.protocol,
            "identifiers": [c.get("kind") for c in (ids or [])],
            "transformers": [],
        })
    namers = [n.get("kind") for n in (getattr(spec, "namers", None) or [])
              if isinstance(n, dict)]
    telemeters = [t.get("kind")
                  for t in (getattr(spec, "telemetry", None) or [])
                  if isinstance(t, dict)]
    return {
        "pid": instance_id,
        "orgId": orgId,
        "linkerd_version": "tpu-0.1",
        "start_time": int(start_time),
        "uptime_s": int(uptime_s),
        "routers": routers,
        "namers": namers,
        "telemeters": telemeters,
    }


class UsageDataTelemeter:
    """Posts a usage report hourly; disabled via usage.enabled=false."""

    def __init__(self, spec: Any, orgId: str = "",
                 host: str = DEFAULT_HOST, port: int = DEFAULT_PORT,
                 interval_s: float = INTERVAL_S):
        self._spec = spec
        self._orgId = orgId
        self._host = host
        self._port = port
        self._interval = interval_s
        self._instance_id = str(uuid.uuid4())
        self._start = time.time()        # reported instant (wall clock)
        self._start_mono = time.monotonic()  # uptime measurement
        self.tracer = None

    def admin_handlers(self):
        return []

    async def _post(self) -> None:
        body = json.dumps(build_report(
            self._spec, self._orgId, self._instance_id, self._start,
            uptime_s=time.monotonic() - self._start_mono)
        ).encode()
        reader, writer = await asyncio.wait_for(
            asyncio.open_connection(
                self._host, self._port,
                ssl=(self._port == 443)), 10.0)
        try:
            head = (f"POST /ping HTTP/1.1\r\nHost: {self._host}\r\n"
                    f"Content-Type: application/json\r\n"
                    f"Content-Length: {len(body)}\r\n"
                    f"Connection: close\r\n\r\n").encode()
            writer.write(head + body)
            await writer.drain()
            await asyncio.wait_for(reader.read(256), 10.0)
        finally:
            writer.close()

    async def run(self) -> None:
        while True:
            try:
                await self._post()
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001 - usage is best-effort
                log.debug("usage post failed: %s", e)
            await asyncio.sleep(self._interval)
