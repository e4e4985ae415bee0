"""Mid-stream actuation: the stream sentinel governor.

The tracker (:mod:`linkerd_tpu_torch.streams.tracker`) turns frames into
features; the scorer turns features into an anomaly score; this module
turns the *sequence* of scores a long-lived stream produces into an
actuation decision while the stream is still open. It reuses
:class:`linkerd_tpu_torch.control.state.HysteresisGovernor` — the same
split-threshold / quorum / dwell machine every other actuator in the
mesh runs on — keyed by stream-lifetime key, so a stream whose score
EWMA crosses ``enter`` for ``quorum`` consecutive samples is declared
SICK and shed (RST with gRPC UNAVAILABLE trailers when the engine can,
connection drain, or tenant-quota shrink), and flapping scores change
nothing.

The sentinel's stream table is bounded: hostile stream churn (a client
opening and abandoning streams to bloat the table) buys eviction of
the stalest *closed* entries, never growth. Evicted keys are
``forget()``-ed from the governor so it stays bounded too — the same
contract ``HysteresisGovernor.forget`` documents for tenant churn.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

import numpy as np

from linkerd_tpu_torch.control.state import SICK, HysteresisGovernor
from linkerd_tpu_torch.streams.tracker import ROW_STREAM

# Actuation modes (mirror the native StreamCfg.action values, plus the
# Python-plane-only drain/quota modes the native engines delegate up).
ACTION_OBSERVE = "observe"
ACTION_RST = "rst"
ACTION_DRAIN = "drain"
ACTION_QUOTA = "quota"
ACTIONS = (ACTION_OBSERVE, ACTION_RST, ACTION_DRAIN, ACTION_QUOTA)

# Score-EWMA smoothing: alpha 1/4 in float32, mirroring the native
# gov_observe so a score sequence produces the same level either side.
_SCORE_ALPHA = np.float32(0.25)


@dataclass
class StreamEntry:
    """Per-stream sentinel state."""

    key: int
    kind: int = ROW_STREAM
    route: Optional[str] = None     # pinned at stream open: the route
    #                                 (specialist head) scoring sticks to
    tenant: int = 0
    score_ewma: np.float32 = field(
        default_factory=lambda: np.float32(0.0))
    samples: int = 0
    scored: int = 0
    frames: int = 0
    bytes: int = 0
    live: bool = True
    shed: bool = False
    last_seen: float = 0.0


class StreamSentinel:
    """Score-driven mid-stream governor over a bounded stream table.

    ``observe`` is the hot path: fold one score sample in, run the
    hysteresis machine, and on a healthy->SICK edge fire the configured
    actuation callback exactly once per transition. Callbacks receive
    the :class:`StreamEntry`; what "RST" or "drain" concretely means is
    the caller's business (the fastpath router forwards RST to the
    native engine; the Python h2 server resets its own stream).
    """

    def __init__(self, enter: float = 0.8, exit: float = 0.5,
                 quorum: int = 3, dwell_s: float = 1.0,
                 table_cap: int = 4096, action: str = ACTION_RST,
                 on_rst: Optional[Callable[[StreamEntry], None]] = None,
                 on_drain: Optional[Callable[[StreamEntry], None]] = None,
                 on_quota: Optional[Callable[[StreamEntry], None]] = None):
        if action not in ACTIONS:
            raise ValueError(
                f"action must be one of {ACTIONS} (got {action!r})")
        if table_cap < 1:
            raise ValueError("table_cap must be >= 1")
        # threshold/quorum/dwell validation lives in the governor —
        # one place, same errors as every other actuator
        self._gov = HysteresisGovernor(enter=enter, exit=exit,
                                       quorum=quorum, dwell_s=dwell_s)
        self.action = action
        self.table_cap = table_cap
        self._on = {ACTION_RST: on_rst, ACTION_DRAIN: on_drain,
                    ACTION_QUOTA: on_quota}
        self._streams: "OrderedDict[int, StreamEntry]" = OrderedDict()
        self.sick_transitions = 0
        self.actions_fired = 0
        self.evicted = 0

    # ---- lifecycle ----------------------------------------------------------

    def open(self, key: int, kind: int = ROW_STREAM,
             route: Optional[str] = None, tenant: int = 0,
             now: Optional[float] = None) -> StreamEntry:
        """Register a stream at open time, pinning its route (and so
        its specialist head) for the stream's lifetime. Idempotent per
        key: re-opening an existing key refreshes liveness but keeps
        the pinned route — mid-stream re-routing must not flip which
        head scores it."""
        now = time.monotonic() if now is None else now
        ent = self._streams.get(key)
        if ent is None:
            ent = StreamEntry(key=key, kind=kind, route=route,
                              tenant=tenant, last_seen=now)
            self._streams[key] = ent
            self._evict_over_cap()
        else:
            self._streams.move_to_end(key)
        ent.live = True
        ent.last_seen = now
        return ent

    def close(self, key: int, now: Optional[float] = None) -> None:
        """Mark a stream closed. The entry stays (bounded by the LRU)
        so /streams.json can show recently-finished streams; only
        closed entries are eviction candidates."""
        ent = self._streams.get(key)
        if ent is not None:
            ent.live = False
            ent.last_seen = time.monotonic() if now is None else now

    # ---- scoring ------------------------------------------------------------

    def observe(self, key: int, score: float, scored: bool = True,
                frames: int = 0, nbytes: int = 0,
                now: Optional[float] = None) -> Optional[str]:
        """Fold one score sample for ``key``; returns the actuation
        mode fired on a healthy->SICK edge (``None`` otherwise).
        Unscored samples (no weights published yet) refresh liveness
        but never move the governor."""
        now = time.monotonic() if now is None else now
        ent = self._streams.get(key)
        if ent is None:
            ent = self.open(key, now=now)
        else:
            self._streams.move_to_end(key)
        ent.samples += 1
        ent.frames = max(ent.frames, int(frames))
        ent.bytes = max(ent.bytes, int(nbytes))
        ent.last_seen = now
        if not scored:
            return None
        ent.scored += 1
        ent.score_ewma = np.float32(
            ent.score_ewma
            + np.float32(_SCORE_ALPHA
                         * np.float32(np.float32(score) - ent.score_ewma)))
        was_shed = ent.shed
        state = self._gov.observe(str(key), float(ent.score_ewma), now=now)
        if state == SICK and not was_shed:
            ent.shed = True
            self.sick_transitions += 1
            return self._fire(ent)
        if state != SICK:
            ent.shed = False
        return None

    def _fire(self, ent: StreamEntry) -> Optional[str]:
        if self.action == ACTION_OBSERVE:
            return ACTION_OBSERVE
        cb = self._on.get(self.action)
        if cb is not None:
            cb(ent)
            self.actions_fired += 1
        return self.action

    # ---- native-row ingestion ----------------------------------------------

    def ingest_rows(self, rows, now: Optional[float] = None) -> int:
        """Feed drained native feature rows (f32 [n, 12]) — stream and
        tunnel samples only; request rows pass through untouched.
        Returns the number of actuations fired. The engines score and
        actuate in-plane already; this keeps the Python-side table (and
        any drain/quota escalation) in sync with what they saw."""
        from linkerd_tpu_torch.telemetry.linerate import (
            NATIVE_COL_KIND, NATIVE_COL_SCORE, NATIVE_COL_SCORED,
            NATIVE_COL_SEQ, NATIVE_COL_STREAM, NATIVE_COL_TENANT)
        fired = 0
        now = time.monotonic() if now is None else now
        for r in rows:
            kind = int(r[NATIVE_COL_KIND])
            if kind == 0:
                continue
            key = int(r[NATIVE_COL_STREAM])
            if key == 0:
                continue
            ent = self._streams.get(key)
            if ent is None:
                ent = self.open(key, kind=kind,
                                tenant=int(r[NATIVE_COL_TENANT]), now=now)
            if self.observe(key, float(r[NATIVE_COL_SCORE]),
                            scored=r[NATIVE_COL_SCORED] > 0.5,
                            frames=int(r[NATIVE_COL_SEQ]),
                            now=now) not in (None, ACTION_OBSERVE):
                fired += 1
        return fired

    # ---- bounds + introspection ---------------------------------------------

    def _evict_over_cap(self) -> None:
        # stalest-first over *closed* entries only; live streams are
        # never evicted (their state is load-bearing for actuation)
        while len(self._streams) > self.table_cap:
            victim = None
            for k, ent in self._streams.items():  # oldest-first order
                if not ent.live:
                    victim = k
                    break
            if victim is None:
                return  # all live: over cap but un-evictable
            del self._streams[victim]
            self._gov.forget(str(victim))
            self.evicted += 1

    def __len__(self) -> int:
        return len(self._streams)

    def entry(self, key: int) -> Optional[StreamEntry]:
        return self._streams.get(key)

    def snapshot(self) -> Dict[str, object]:
        """/streams.json shape, mirroring the native streams_json doc
        so the admin plane can merge both without translation."""
        return {
            "enabled": True,
            "action": self.action,
            "count": len(self._streams),
            "evicted": self.evicted,
            "sick_transitions": self.sick_transitions,
            "actions_fired": self.actions_fired,
            "by_stream": {
                str(k): {
                    "kind": ent.kind,
                    "route": ent.route,
                    "samples": ent.samples,
                    "scored": ent.scored,
                    "score_ewma": round(float(ent.score_ewma), 6),
                    "frames": ent.frames,
                    "bytes": ent.bytes,
                    "sick": ent.shed,
                    "live": ent.live,
                }
                for k, ent in self._streams.items()
            },
        }
