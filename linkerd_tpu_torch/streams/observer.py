"""Per-connection frame observer for the Python h2 data plane.

The native engines featurize frames inline in their epoll loops; the
Python h2 path gets the same treatment here. One ``H2FrameObserver``
rides each server-side ``H2Connection``: every DATA / WINDOW_UPDATE /
RST (or flow-control violation) folds into the stream's
:class:`~linkerd_tpu_torch.streams.tracker.StreamTracker`, and on the same
sampling cadence the engines use (every N frames, min-gap-bounded) the
accumulated features are scored and fed to the shared
:class:`~linkerd_tpu_torch.streams.sentinel.StreamSentinel`. A SICK verdict
sheds the stream mid-flight via the connection's ``shed_stream`` —
RST_STREAM ENHANCE_YOUR_CALM, the Python twin of the engine's
actuation.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import numpy as np

from linkerd_tpu_torch.streams.sentinel import ACTION_OBSERVE, StreamSentinel
from linkerd_tpu_torch.streams.tracker import (
    FRAME_ANOMALY, ROW_STREAM, StreamTracker, fold_key,
    stream_feature_vector,
)


class _StreamSlot:
    __slots__ = ("skey", "tracker", "last_frame", "last_sample_frames",
                 "last_sample_t", "dst_path")

    def __init__(self, skey: int, now: float, dst_path: str):
        self.skey = skey
        self.tracker = StreamTracker()
        self.last_frame = now
        self.last_sample_frames = 0
        self.last_sample_t = 0.0
        self.dst_path = dst_path


class H2FrameObserver:
    """Frame-to-sample bridge for one h2 connection.

    ``scorer`` is an optional synchronous ``f32[FEATURE_DIM] -> float``
    (the JAX/native tier adapter); without one, samples reach the
    sentinel unscored — the table tracks liveness/frames but the
    governor never moves, exactly like an engine with no weight blob
    published.
    """

    def __init__(self, sentinel: StreamSentinel,
                 next_skey: Callable[[], int],
                 scorer: Optional[Callable[[np.ndarray],
                                           Optional[float]]] = None,
                 sample_every_frames: int = 8, min_gap_ms: int = 10,
                 action: str = "rst", dst_path: str = "/",
                 emit_row: Optional[Callable[[np.ndarray], None]] = None):
        self.sentinel = sentinel
        self.scorer = scorer
        self.sample_every = max(1, int(sample_every_frames))
        self.min_gap_s = max(0, int(min_gap_ms)) / 1000.0
        self.action = action
        self.dst_path = dst_path
        self.emit_row = emit_row
        self._next_skey = next_skey
        self._conn = None
        self._slots: Dict[int, _StreamSlot] = {}
        self.sheds = 0

    def bind(self, conn) -> "H2FrameObserver":
        """Attach the connection actuation runs against (the observer
        is constructed before the connection that owns it)."""
        self._conn = conn
        return self

    # ── frame feed (called from the connection's read loop) ──────────────

    def on_frame(self, sid: int, kind: int, nbytes: int = 0,
                 now: Optional[float] = None) -> None:
        now = time.monotonic() if now is None else now
        slot = self._slots.get(sid)
        if slot is None:
            slot = _StreamSlot(fold_key(self._next_skey()), now,
                               self.dst_path)
            self._slots[sid] = slot
            self.sentinel.open(slot.skey, kind=ROW_STREAM,
                               route=self.dst_path, now=now)
        gap_ms = (now - slot.last_frame) * 1000.0
        slot.last_frame = now
        slot.tracker.frame(kind, gap_ms, float(nbytes))
        if self._sample_due(slot, now):
            self._sample(sid, slot, now)

    def on_close(self, sid: int, now: Optional[float] = None) -> None:
        slot = self._slots.pop(sid, None)
        if slot is not None:
            self.sentinel.close(slot.skey, now=now)

    def close(self) -> None:
        """Connection teardown: every remaining stream is closed."""
        for sid in list(self._slots):
            self.on_close(sid)

    # ── sampling ─────────────────────────────────────────────────────────

    def _sample_due(self, slot: _StreamSlot, now: float) -> bool:
        t = slot.tracker
        if t.frames < slot.last_sample_frames + self.sample_every:
            return False
        return now - slot.last_sample_t >= self.min_gap_s

    def _sample(self, sid: int, slot: _StreamSlot, now: float) -> None:
        slot.last_sample_frames = slot.tracker.frames
        slot.last_sample_t = now
        score, scored = 0.0, False
        if self.scorer is not None:
            x = stream_feature_vector(slot.tracker, slot.dst_path)
            got = self.scorer(x)
            if got is not None:
                score, scored = float(got), True
        if self.emit_row is not None:
            self.emit_row(self._row(slot, score, scored, now))
        action = self.sentinel.observe(
            slot.skey, score, scored=scored, frames=slot.tracker.frames,
            nbytes=slot.tracker.bytes, now=now)
        if action is not None and action != ACTION_OBSERVE \
                and self.action != "observe":
            self._shed(sid)

    def _row(self, slot: _StreamSlot, score: float, scored: bool,
             now: float) -> np.ndarray:
        """A 12-wide native-layout feature row for this sample, so
        Python-path stream samples ride the same ring format as engine
        rows (NATIVE_ROW_WIDTH columns, kind=ROW_STREAM)."""
        t = slot.tracker
        return np.array(
            [0.0, float(t.gap_ewma_ms),
             500.0 if t.anomalies > 0 else 200.0,
             float(t.bpf_ewma), float(t.bytes), now, score,
             1.0 if scored else 0.0, 0.0, float(ROW_STREAM),
             float(slot.skey), float(t.frames)], dtype=np.float32)

    def _shed(self, sid: int) -> None:
        conn = self._conn
        if conn is None:
            return
        if conn.shed_stream(sid):
            self.sheds += 1
        self.on_close(sid)


__all__ = ["H2FrameObserver", "FRAME_ANOMALY"]
