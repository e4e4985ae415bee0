"""Telemeter SPI: a copy of ``linkerd_tpu/telemetry/telemeter.py``.

Reference parity: telemetry/core/.../Telemeter.scala:11-15 — a telemeter
optionally provides a stats receiver (here: a MetricsTree it populates or
reads), a tracer, and a ``run()`` lifecycle. Telemeters are configured via
the ``telemeter`` registry category (``kind: io.l5d.prometheus`` etc.) and
wired by the Linker (Linker.scala:115-135).
"""

from __future__ import annotations

import abc
from typing import Any, List, Optional, Sequence, Tuple


class Tracer(abc.ABC):
    """Span sink. Records completed spans (dicts with trace/span ids,
    timestamps, annotations)."""

    @abc.abstractmethod
    def record(self, span: dict) -> None: ...

    def close(self) -> None:  # pragma: no cover - default no-op
        pass


class NullTracer(Tracer):
    def record(self, span: dict) -> None:  # pragma: no cover - no-op
        pass


class BroadcastTracer(Tracer):
    """Fan a span out to several tracers (ref: Linker.scala:152-157)."""

    def __init__(self, tracers: Sequence[Tracer]):
        self.tracers = list(tracers)

    def record(self, span: dict) -> None:
        for t in self.tracers:
            t.record(span)

    def close(self) -> None:
        for t in self.tracers:
            t.close()


class Telemeter(abc.ABC):
    """A telemetry plugin: may expose a tracer, admin handlers, and a
    background task started by ``run()``."""

    @property
    def tracer(self) -> Optional[Tracer]:
        return None

    def admin_handlers(self) -> List[Tuple[str, Any]]:
        """(url_path, handler) pairs contributed to the admin server."""
        return []

    async def run(self) -> None:
        """Long-running background work; default none."""
        return

    def close(self) -> None:
        return
