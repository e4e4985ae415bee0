"""Specialist model bank and drift-triggered distillation: counterpart
of ``linkerd_tpu/distill``.

One global model scores every route; this package distills a bank of
small per-route specialist heads from it:

    per-route score shift (RouteDriftMonitor)
        -> retrain on the route's replay rows (``distill_head``: the
           online-trained global model is the starting point; the
           candidate fine-tunes on the device on the route's own
           traffic with per-route normalization stats)
        -> shadow gate through the ``PromotionGate`` on held-out route
           rows, each side scored by one launch of the fused kernel
        -> publish a per-route DELTA patch (``lifecycle/export``
           ``L5DWTD01``), generation-fenced, with the full ``L5DWTS02``
           bank blob as the fallback for a sink that cannot take it.

Rollback of one route is one REMOVE delta that leaves every other head
serving. Head lineage (the base checkpoint each head was distilled
from, the CRC of the delta that shipped it) rides the CheckpointStore
manifest (``record_specialist``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from linkerd_tpu_torch import DeviceLike
from linkerd_tpu_torch.distill.bank import HeadInfo, SpecialistBank
from linkerd_tpu_torch.distill.monitor import (
    RouteDriftMonitor, RouteReplayWindow,
)


@dataclass
class DistillConfig:
    """The reference's ``distill:`` block, with its defaults.

    The drift trigger and the promotion gate interlock: a route
    retrains when its live score distribution shifts more than
    ``driftThreshold`` reference-sigmas from where it was anchored, and
    the candidate head is promoted only when it does not regress
    (loss/AUC tolerances, the ``PromotionGate`` semantics of the global
    lifecycle) on the route's held-out rows.
    """

    maxHeads: int = 32           # specialist heads the bank may carry
    driftThreshold: float = 1.0  # per-route score-shift trigger (sigmas)
    minRouteRows: int = 64       # replay rows before a route may retrain
    perRouteReplayRows: int = 512   # replay window per route, rows
    retrainSteps: int = 8        # fine-tune steps per candidate
    learningRate: float = 0.001
    cooldownS: float = 30.0      # per-route floor between retrains
    # candidate gate (PromotionGate semantics, scoped to one route)
    aucTolerance: float = 0.02
    lossTolerance: float = 0.10
    minLabeled: int = 8
    # bank blob encoding: f32 | int8 | int4; None inherits ``quant``
    # of ``mk``
    quant: Optional[str] = None
    # publish per-route delta patches (the full bank is always the
    # fallback for a sink that rejects the patch); False always ships
    # the full bank
    deltaPublish: bool = True

    def mk(self, node, gate=None, store=None, quant: str = "f32",
           device: DeviceLike = None) -> "DistillationPipeline":
        from linkerd_tpu_torch.distill.pipeline import DistillationPipeline
        return DistillationPipeline(self, node, gate=gate, store=store,
                                    default_quant=quant, device=device)


__all__ = [
    "DistillConfig", "HeadInfo", "RouteDriftMonitor",
    "RouteReplayWindow", "SpecialistBank",
]
