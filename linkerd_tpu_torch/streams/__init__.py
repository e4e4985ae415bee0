"""Stream sentinel: incremental scoring and mid-stream actuation for
long-lived streams.

Request-shaped scoring (one feature row at exchange completion) is
blind to everything that happens *inside* a long-lived h2/gRPC stream,
WebSocket upgrade, or CONNECT tunnel — which is where most of the
bytes are. This package is the Python half of the stream-tracking
layer (the native half lives in ``native/stream_track.h``, embedded in
both epoll engines):

- :mod:`.tracker` — per-frame feature deltas (gap EWMA, bytes/frame
  drift, WINDOW_UPDATE cadence, reset / flow-control anomalies) in
  float32 arithmetic bit-identical to the C accumulator;
- :mod:`.sentinel` — the score-EWMA hysteresis governor (reusing
  ``control.state.HysteresisGovernor``) that sheds sick streams
  mid-flight: RST with gRPC UNAVAILABLE trailers when possible,
  connection drain, or tenant-quota shrink.
"""

from linkerd_tpu_torch.streams.observer import H2FrameObserver
from linkerd_tpu_torch.streams.sentinel import (
    ACTION_DRAIN, ACTION_OBSERVE, ACTION_QUOTA, ACTION_RST, ACTIONS,
    StreamEntry, StreamSentinel,
)
from linkerd_tpu_torch.streams.tracker import (
    FRAME_ANOMALY, FRAME_DATA, FRAME_WINDOW_UPDATE, ROW_REQUEST,
    ROW_STREAM, ROW_TUNNEL, StreamTracker, fold_key,
    stream_feature_vector,
)

__all__ = [
    "ACTION_DRAIN", "ACTION_OBSERVE", "ACTION_QUOTA", "ACTION_RST",
    "ACTIONS", "FRAME_ANOMALY", "FRAME_DATA", "FRAME_WINDOW_UPDATE",
    "H2FrameObserver",
    "ROW_REQUEST", "ROW_STREAM", "ROW_TUNNEL", "StreamEntry",
    "StreamSentinel", "StreamTracker", "fold_key",
    "stream_feature_vector",
]
