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
    """The reference's ``lifecycle:`` block of the ``io.l5d.jaxAnomaly``
    telemeter, with its defaults. ``mk_manager`` reads the store, gate
    and replay keys; the telemeter reads the cadence, hold-out and
    restore-on-start keys."""

    directory: str                   # checkpoint store root (required)
    checkpointEveryS: float = 300.0  # gating-cycle cadence; 0 = manual only
    retain: int = 5                  # versions kept (serving never pruned)
    aucTolerance: float = 0.02
    lossTolerance: float = 0.10
    minLabeled: int = 8
    replayCapacity: int = 4096       # held-out window, rows
    minReplayRows: int = 256         # gate only once the window is warm
    # every Nth drained batch is diverted to the replay window and
    # EXCLUDED from training — the shadow-eval set must be held out from
    # the candidate, or a poisoned training stream would evaluate best
    # on its own poison and sail through the gate
    holdoutEveryBatches: int = 4
    restoreOnStart: bool = True      # survive restarts from last-good

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
