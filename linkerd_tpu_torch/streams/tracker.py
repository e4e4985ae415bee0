"""Incremental per-stream featurization — the Python mirror of
``native/stream_track.h``.

Long-lived h2/gRPC streams, WebSocket upgrades, and CONNECT tunnels
carry most of their bytes after the opening exchange, so the
request-shaped "one row at completion" featurizer never sees them go
bad. ``StreamTracker`` accumulates per-frame deltas — inter-frame gap
EWMA + mean-abs-deviation, bytes-per-DATA-frame EWMA + deviation,
WINDOW_UPDATE cadence, reset / flow-control anomaly counts — exactly
like the C ``StreamAccum`` the epoll engines embed.

Bit-exactness contract: every arithmetic step here is performed in
float32 with multiply-then-add ordering (no fused multiply-add), so a
frame sequence driven through this class and through the native
``l5d_stream_accum`` parity entry point produces *identical* bits.
``tests/test_stream_scoring.py`` pins that; do not "simplify" the
numpy scalar dance below into Python-float math.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

# Feature-row kinds (column NATIVE_COL_KIND of the 12-wide engine
# row). Request rows are 0 so old 9-wide readers see zero-fill.
ROW_REQUEST = 0
ROW_STREAM = 1   # h2 stream sample
ROW_TUNNEL = 2   # CONNECT / 101-upgrade byte tunnel

# Frame kinds fed to StreamTracker.frame (mirror stream_track.h).
FRAME_DATA = 0
FRAME_WINDOW_UPDATE = 1
FRAME_ANOMALY = 2  # RST / flow-control violation

_ALPHA = np.float32(0.125)  # all EWMAs use alpha = 1/8


def fold_key(key: int) -> int:
    """Fold a stream key to 24 bits (float32-integer-exact so it can
    ride a feature-row column); 0 is reserved for "not a stream row"
    and folds to 1, same as the C ``fold_key``."""
    f = int(key) & 0xFFFFFF
    return 1 if f == 0 else f


class StreamTracker:
    """Per-stream frame accumulator (float32, C-parity).

    One instance per live stream/tunnel; feed it every observed frame
    via :meth:`frame` and read the current feature vector with
    :meth:`features` whenever a score sample is due.
    """

    __slots__ = ("gap_ewma_ms", "gap_dev_ms", "bpf_ewma", "bpf_dev",
                 "frames", "data_frames", "wu_frames", "anomalies",
                 "bytes")

    def __init__(self) -> None:
        self.gap_ewma_ms = np.float32(0.0)
        self.gap_dev_ms = np.float32(0.0)
        self.bpf_ewma = np.float32(0.0)
        self.bpf_dev = np.float32(0.0)
        self.frames = 0
        self.data_frames = 0
        self.wu_frames = 0
        self.anomalies = 0
        self.bytes = 0

    def frame(self, kind: int, gap_ms: float, size: float = 0.0) -> None:
        """Fold one frame in: ``kind`` is FRAME_DATA /
        FRAME_WINDOW_UPDATE / FRAME_ANOMALY, ``gap_ms`` the gap since
        the previous frame, ``size`` the DATA payload bytes (ignored
        for the other kinds, exactly like the C accumulator)."""
        gap = np.float32(gap_ms)
        self.frames += 1
        if self.frames == 1:
            self.gap_ewma_ms = gap
        else:
            d = np.float32(gap - self.gap_ewma_ms)
            self.gap_ewma_ms = np.float32(
                self.gap_ewma_ms + np.float32(_ALPHA * d))
            self.gap_dev_ms = np.float32(
                self.gap_dev_ms
                + np.float32(_ALPHA * np.float32(abs(d) - self.gap_dev_ms)))
        if kind == FRAME_DATA:
            sz = np.float32(size)
            self.data_frames += 1
            self.bytes += int(sz)
            if self.data_frames == 1:
                self.bpf_ewma = sz
            else:
                db = np.float32(sz - self.bpf_ewma)
                self.bpf_ewma = np.float32(
                    self.bpf_ewma + np.float32(_ALPHA * db))
                self.bpf_dev = np.float32(
                    self.bpf_dev
                    + np.float32(_ALPHA * np.float32(abs(db) - self.bpf_dev)))
        elif kind == FRAME_WINDOW_UPDATE:
            self.wu_frames += 1
        else:
            self.anomalies += 1

    def as_row(self) -> np.ndarray:
        """Accumulator state in the exact layout ``l5d_stream_accum``
        writes (the parity surface): [gap_ewma_ms, gap_dev_ms,
        bpf_ewma, bpf_dev, frames, data_frames, wu_frames, anomalies,
        bytes] as float32[9]."""
        return np.array(
            [self.gap_ewma_ms, self.gap_dev_ms, self.bpf_ewma,
             self.bpf_dev, self.frames, self.data_frames,
             self.wu_frames, self.anomalies, self.bytes],
            dtype=np.float32)

    def snapshot(self) -> Dict[str, float]:
        return {
            "gap_ewma_ms": float(self.gap_ewma_ms),
            "gap_dev_ms": float(self.gap_dev_ms),
            "bpf_ewma": float(self.bpf_ewma),
            "bpf_dev": float(self.bpf_dev),
            "frames": self.frames,
            "data_frames": self.data_frames,
            "wu_frames": self.wu_frames,
            "anomalies": self.anomalies,
            "bytes": self.bytes,
        }


def stream_feature_vector(tracker: StreamTracker,
                          dst_path: str = "/") -> np.ndarray:
    """Map a tracker onto the request featurizer's input slots the way
    the engines' ``featurize_stream`` does: gap EWMA rides the latency
    slot, a synthetic status (500 when anomalies were seen, 200
    otherwise) rides status, bytes/frame rides request_bytes, total
    bytes rides response_bytes, gap deviation rides the drift slot.
    Used by the Python scoring path so stream samples and request rows
    share one model (and one specialist bank)."""
    from linkerd_tpu_torch.models.features import FeatureVector, featurize
    fv = FeatureVector(
        latency_ms=float(tracker.gap_ewma_ms),
        status=500 if tracker.anomalies > 0 else 200,
        request_bytes=int(tracker.bpf_ewma),
        response_bytes=int(tracker.bytes),
        dst_path=dst_path,
        lat_drift_ms=float(tracker.gap_dev_ms))
    return featurize(fv)
