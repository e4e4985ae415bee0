"""Model lifecycle of the anomaly scorer: counterpart of
``linkerd_tpu/lifecycle``.

    capture -> train -> checkpoint -> shadow-eval -> promote -> hot-swap
                                          |
                                          +-> reject -> rollback

- ``store``   — atomic, CRC-checked, versioned snapshots with lineage
  and retention (``CheckpointStore``, ``ModelSnapshot``).
- ``promote`` — held-out replay window, shadow evaluation on the
  device, promotion gate, and the ``ModelLifecycleManager`` that runs
  the loop.
- ``drift``   — population-stats shift against the serving checkpoint.
- ``export``  — the native engines' weight, bank and delta blobs.

The scorers' ``snapshot()``/``restore()``/``swap()`` do the hot swaps.
"""

from __future__ import annotations

from dataclasses import dataclass

from linkerd_tpu_torch import DeviceLike
from linkerd_tpu_torch.lifecycle.drift import DriftMonitor
from linkerd_tpu_torch.lifecycle.export import (
    BANK_MAGIC, DELTA_MAGIC, WEIGHT_MAGIC, blob_meta, export_bank_blob,
    export_delta_blob, export_weight_blob, route_hash,
)
from linkerd_tpu_torch.lifecycle.promote import (
    Decision, EvalReport, GatePolicy, ModelLifecycleManager, PromotionGate,
    ReplayWindow, evaluate_snapshot,
)
from linkerd_tpu_torch.lifecycle.store import (
    CheckpointCorruptError, CheckpointError, CheckpointStore, ModelSnapshot,
    decode_snapshot, encode_snapshot,
)


@dataclass
class LifecycleConfig:
    """The keys of the reference's ``lifecycle:`` block that build the
    manager, with the reference's defaults. The cadence, hold-out and
    restore-on-start keys are read by the reference's telemeter, which
    the port does not have yet, so it does not accept them."""

    directory: str                   # checkpoint store root (required)
    retain: int = 5                  # versions kept (serving never pruned)
    aucTolerance: float = 0.02
    lossTolerance: float = 0.10
    minLabeled: int = 8
    replayCapacity: int = 4096       # held-out window, rows
    minReplayRows: int = 256         # gate only once the window is warm

    def mk_manager(self, metrics_node=None,
                   device: DeviceLike = None) -> ModelLifecycleManager:
        store = CheckpointStore(self.directory, retain=self.retain)
        gate = PromotionGate(GatePolicy(
            aucTolerance=self.aucTolerance,
            lossTolerance=self.lossTolerance,
            minLabeled=self.minLabeled))
        replay = ReplayWindow(self.replayCapacity)
        drift = DriftMonitor(metrics_node)
        return ModelLifecycleManager(
            store, gate, replay, drift=drift,
            min_replay_rows=self.minReplayRows, device=device)


__all__ = [
    "BANK_MAGIC", "CheckpointCorruptError", "CheckpointError",
    "CheckpointStore", "DELTA_MAGIC", "Decision", "DriftMonitor",
    "EvalReport", "GatePolicy", "LifecycleConfig", "ModelLifecycleManager",
    "ModelSnapshot", "PromotionGate", "ReplayWindow", "WEIGHT_MAGIC",
    "blob_meta", "decode_snapshot", "encode_snapshot", "evaluate_snapshot",
    "export_bank_blob", "export_delta_blob", "export_weight_blob",
    "route_hash",
]
