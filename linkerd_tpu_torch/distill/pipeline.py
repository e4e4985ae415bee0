"""The drift-triggered distillation pipeline: counterpart of
``linkerd_tpu/distill/pipeline.py``.

One ``run_once`` pass services the worst-shifted route:

    trigger (RouteDriftMonitor past driftThreshold, cooldown elapsed,
             enough replay rows, bank not full)
      -> snapshot the online-trained global model (the teacher)
      -> ``distill_head``: fine-tune a copy on the route's replay rows
         with per-route normalization stats, on the device, on a CUDA
         stream of its own, from the snapshot (the scorer's lock is not
         held while it steps), inside one worker thread
      -> shadow gate: candidate vs the route's SERVING model (its
         existing specialist head, or the base) on held-out route rows,
         each scored by one launch of the fused kernel, through the
         PromotionGate — a poisoned candidate regresses on rows it
         never trained on and is rejected
      -> on accept: one ``L5DWTD01`` delta patch (generation-fenced)
         publishes the head, with the full ``L5DWTS02`` bank as the
         per-sink fallback; the bank registry, drift reference and
         CheckpointStore specialist lineage advance only after the
         publish.

``rollback_route`` is the inverse: one REMOVE delta drops a single
route's head (the route falls back to the base model) while every
other head keeps serving.

Concurrency: one retrain runs at a time (``_busy`` reentrancy guard);
bank mutations and publishes sit under ``lock``, an ``asyncio.Lock``
held across the export awaits, which a caller publishing its own full
bank (``export_full``) also holds, so generations never interleave.
"""

from __future__ import annotations

import asyncio
import contextlib
import logging
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from linkerd_tpu_torch import DeviceLike, resolve_device
from linkerd_tpu_torch.distill.bank import SpecialistBank
from linkerd_tpu_torch.distill.monitor import (
    RouteDriftMonitor, RouteReplayWindow,
)
from linkerd_tpu_torch.lifecycle.export import (
    blob_meta, export_delta_blob, route_hash,
)
from linkerd_tpu_torch.lifecycle.promote import (
    GatePolicy, PromotionGate, evaluate_snapshot,
)
from linkerd_tpu_torch.lifecycle.store import ModelSnapshot
from linkerd_tpu_torch.models.anomaly import normalize_features
from linkerd_tpu_torch.models.convert import (
    params_from_numpy, params_to_numpy,
)
from linkerd_tpu_torch.telemetry.anomaly import (
    adam_from_leaves, train_steps, zero_adam_leaves,
)

log = logging.getLogger(__name__)


def distill_head(base_snap: ModelSnapshot, x: np.ndarray,
                 labels: np.ndarray, mask: np.ndarray, steps: int,
                 lr: float, device: DeviceLike = None) -> ModelSnapshot:
    """Fine-tune a specialist head for one route from the global model.

    The teacher is the starting point: the candidate begins at the
    online-trained global parameters and specializes on the route's own
    rows. Normalization specializes too: the head's mu/var blend the
    base stats with the route's observed distribution, computed on the
    host exactly as the reference computes them.

    ``max(1, steps)`` Adam steps from a fresh optimizer state run on
    float32 copies of the base params on ``device`` (CUDA unless the
    CPU is named), on a CUDA stream of their own. Refuses a float32
    matmul precision other than ``"highest"``, as ``fit`` does.
    Blocking: call off the event loop. Returns a ``ModelSnapshot`` with
    empty optimizer leaves (heads are serving artifacts; the global
    model keeps training).
    """
    if torch.get_float32_matmul_precision() != "highest":
        # TF32 products would move the head off the reference's
        raise RuntimeError(
            "distill_head needs float32 matmul precision 'highest', got "
            f"{torch.get_float32_matmul_precision()!r}")
    dev = resolve_device(device)
    x = np.ascontiguousarray(x, np.float32)
    mu_r = x.mean(axis=0)
    var_r = x.var(axis=0) + 1e-6
    mu = (0.5 * np.asarray(base_snap.mu, np.float32)
          + 0.5 * mu_r).astype(np.float32)
    var = (0.5 * np.asarray(base_snap.var, np.float32)
           + 0.5 * var_r).astype(np.float32)
    cfg = base_snap.cfg
    stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
    with (torch.cuda.stream(stream) if stream is not None
          else contextlib.nullcontext()):
        params = params_from_numpy(base_snap.params, dev)
        opt = adam_from_leaves(params, zero_adam_leaves(cfg), lr)
        xn = normalize_features(torch.tensor(x, device=dev),
                                torch.tensor(mu, device=dev),
                                torch.tensor(var, device=dev))
        train_steps(params, opt, xn,
                    torch.tensor(np.asarray(labels, np.float32), device=dev),
                    torch.tensor(np.asarray(mask, np.float32), device=dev),
                    cfg, max(1, int(steps)))
        fitted = params_to_numpy(params)  # synchronizes the stream
    return ModelSnapshot(
        params=fitted, opt_leaves=[], mu=mu.copy(), var=var.copy(),
        norm_initialized=True, step=int(base_snap.step), cfg=cfg)


class DistillationPipeline:
    """See module docstring. ``node`` is a metrics scope with
    ``counter(name)`` and ``gauge(name, fn=...)`` (None keeps no
    metrics); ``store`` the CheckpointStore carrying specialist lineage
    (None keeps none). Fine-tunes and shadow evaluations run on
    ``device`` (CUDA unless the CPU is named)."""

    def __init__(self, cfg, node=None, gate: Optional[PromotionGate] = None,
                 store=None, default_quant: str = "f32",
                 device: DeviceLike = None):
        if cfg.maxHeads < 1:
            raise ValueError("distill.maxHeads must be >= 1")
        if cfg.driftThreshold <= 0:
            raise ValueError("distill.driftThreshold must be > 0")
        if cfg.minRouteRows < 8:
            raise ValueError("distill.minRouteRows must be >= 8")
        if cfg.retrainSteps < 1:
            raise ValueError("distill.retrainSteps must be >= 1")
        if cfg.learningRate <= 0:
            raise ValueError("distill.learningRate must be > 0")
        if cfg.cooldownS < 0:
            raise ValueError("distill.cooldownS must be >= 0")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.quant = cfg.quant or default_quant
        self.bank = SpecialistBank(cfg.maxHeads)
        self.monitor = RouteDriftMonitor(
            threshold=cfg.driftThreshold, min_rows=cfg.minRouteRows)
        self.replay = RouteReplayWindow(
            per_route_rows=cfg.perRouteReplayRows)
        self.gate = gate or PromotionGate(GatePolicy(
            aucTolerance=cfg.aucTolerance,
            lossTolerance=cfg.lossTolerance,
            minLabeled=cfg.minLabeled))
        self.store = store
        # publisher: fn(full_blob, delta_blob|None) -> bool; None keeps
        # a local-only bank (no engine to publish to)
        self._publisher: Optional[Callable[[bytes, Optional[bytes]],
                                           bool]] = None
        self.lock = asyncio.Lock()
        self._busy = False
        self._cooldown: Dict[str, float] = {}  # dst -> monotonic
        self._base_snap = None  # last exported base ModelSnapshot
        self.last_outcome: Optional[Dict[str, Any]] = None
        self.last_rollback: Optional[Dict[str, Any]] = None
        if node is not None:
            self._retrains = node.counter("retrains")
            self._promotions = node.counter("promotions")
            self._rejections = node.counter("rejections")
            self._rollbacks = node.counter("rollbacks")
            self._delta_pub = node.counter("delta_publishes")
            self._full_pub = node.counter("full_publishes")
            node.gauge("heads", fn=lambda: float(len(self.bank)))
            node.gauge("generation",
                       fn=lambda: float(self.bank.generation))
            node.gauge("pending",
                       fn=lambda: float(len(self.monitor.triggered())))
        else:
            self._retrains = self._promotions = self._rejections = None
            self._rollbacks = self._delta_pub = self._full_pub = None

    def _incr(self, counter) -> None:
        if counter is not None:
            counter.incr()

    def set_publisher(self, fn: Callable[[bytes, Optional[bytes]],
                                         bool]) -> None:
        self._publisher = fn

    # -- batch feed (host numpy only) --------------------------------------
    def observe_batch(self, dsts: List[str], x: np.ndarray,
                      scores: np.ndarray, labels: np.ndarray,
                      mask: np.ndarray) -> None:
        self.monitor.observe(dsts, scores)
        self.replay.add(dsts, x, labels, mask)

    # -- trigger scan ------------------------------------------------------
    def pending_route(self) -> Optional[str]:
        """Worst-shifted route that is actually retrainable now."""
        now = time.monotonic()
        for dst in self.monitor.triggered():
            if now - self._cooldown.get(dst, -1e9) < self.cfg.cooldownS:
                continue
            if self.replay.rows(dst) < self.cfg.minRouteRows:
                continue
            if self.bank.full and self.bank.head_for(dst) is None:
                continue  # no slot for a NEW head; existing may retrain
            return dst
        return None

    @property
    def busy(self) -> bool:
        return self._busy

    # -- the retrain cycle -------------------------------------------------
    async def run_once(self, scorer,
                       base_version: Optional[int] = None
                       ) -> Optional[Dict[str, Any]]:
        """Retrain + gate + publish for ONE pending route (the worst
        shift). Returns the outcome dict, or None when nothing was
        pending or a retrain is already in flight."""
        if self._busy:
            return None
        dst = self.pending_route()
        if dst is None:
            return None
        self._busy = True
        try:
            return await self._retrain_route(dst, scorer, base_version)
        finally:
            self._busy = False

    async def _retrain_route(self, dst: str, scorer,
                             base_version: Optional[int]
                             ) -> Dict[str, Any]:
        self._incr(self._retrains)
        self._cooldown[dst] = time.monotonic()
        x, labels, mask = self.replay.sample(dst)
        # deterministic holdout: every 4th row is shadow-eval only —
        # the candidate never trains on the rows that judge it
        hold = np.arange(len(x)) % 4 == 0
        x_tr, l_tr, m_tr = x[~hold], labels[~hold], mask[~hold]
        x_ho, l_ho, m_ho = x[hold], labels[hold], mask[hold]
        base_snap = await asyncio.to_thread(scorer.snapshot)
        if base_version is None:
            base_version = int(getattr(base_snap, "step", 0) or 0)
        candidate = await asyncio.to_thread(
            distill_head, base_snap, x_tr, l_tr, m_tr,
            self.cfg.retrainSteps, self.cfg.learningRate, self.device)
        cand_report = await asyncio.to_thread(
            evaluate_snapshot, candidate, x_ho, l_ho, m_ho, self.device)
        serving_head = self.bank.head_for(dst)
        serving_snap = (serving_head.snapshot if serving_head is not None
                        else base_snap)
        serv_report = await asyncio.to_thread(
            evaluate_snapshot, serving_snap, x_ho, l_ho, m_ho, self.device)
        decision = self.gate.decide(cand_report, serv_report)
        if not decision.accepted:
            self._incr(self._rejections)
            outcome = {"action": "rejected", "route": dst,
                       "decision": decision.as_dict()}
            self.last_outcome = outcome
            log.info("distill: candidate head for %s rejected: %s",
                     dst, decision.reason)
            return outcome
        async with self.lock:
            gen = self.bank.generation
            head_version = self.bank.next_head_version()
            rh = route_hash(dst)
            delta = None
            if self.cfg.deltaPublish:
                delta = await asyncio.to_thread(
                    export_delta_blob, gen, gen + 1,
                    {rh: (head_version, candidate)}, quant=self.quant)
            info = self.bank.upsert(dst, candidate, head_version,
                                    int(base_version), gen + 1)
            self.bank.generation = gen + 1
            # the full-bank fallback ships the freshly snapshotted base,
            # so the stamped base version moves with it: a sink that
            # falls back to the full blob reports the lineage of the
            # bits it serves
            self._base_snap = base_snap
            self.bank.base_version = int(base_version)
            full = await asyncio.to_thread(
                self.bank.export_full, base_snap,
                self.bank.base_version, gen + 1, self.quant)
            used_delta = self._publish(full, delta)
            self._incr(self._promotions)
            self._incr(self._delta_pub if used_delta else self._full_pub)
            self.monitor.re_anchor(dst)
            self._record_lineage(rh, info, delta)
            outcome = {
                "action": "promoted", "route": dst,
                "route_hash": rh, "head_version": head_version,
                "generation": self.bank.generation,
                "delta_bytes": len(delta) if delta is not None else None,
                "full_bytes": len(full),
                "delta_published": used_delta,
                "decision": decision.as_dict(),
            }
            self.last_outcome = outcome
        log.info("distill: promoted specialist head for %s "
                 "(generation %d, %s publish)", dst,
                 self.bank.generation,
                 "delta" if used_delta else "full")
        return outcome

    def _publish(self, full: Optional[bytes],
                 delta: Optional[bytes]) -> bool:
        """Ship the update; True when the delta path carried it (False:
        the full blob did, or there is no publisher)."""
        if self._publisher is None:
            return False
        return bool(self._publisher(full, delta))

    def _record_lineage(self, rh: int, info, delta: Optional[bytes]
                        ) -> None:
        if self.store is None:
            return
        meta = info.meta()
        if delta is not None:
            dm = blob_meta(delta)
            meta["delta_crc"] = dm["crc"] if dm else None
            meta["delta_bytes"] = len(delta)
        try:
            self.store.record_specialist(rh, meta)
        except Exception:  # noqa: BLE001 — lineage annotation must not
            # undo a publish that already landed
            log.exception("specialist lineage record failed for %r",
                          info.dst)

    # -- single-route rollback --------------------------------------------
    async def rollback_route(self, dst: str) -> bool:
        """Drop ONE route's specialist head: one REMOVE delta,
        generation-fenced, every other head keeps serving; the route
        falls back to the base model."""
        async with self.lock:
            info = self.bank.head_for(dst)
            if info is None:
                return False
            gen = self.bank.generation
            delta = export_delta_blob(gen, gen + 1,
                                      removes=[info.route_hash],
                                      quant=self.quant)
            self.bank.remove(dst)
            self.bank.generation = gen + 1
            full = None
            if self._base_snap is not None:
                full = await asyncio.to_thread(
                    self.bank.export_full, self._base_snap,
                    self.bank.base_version or 0, gen + 1, self.quant)
            self._publish(full, delta)
            self._incr(self._rollbacks)
            self.monitor.re_anchor(dst)
            if self.store is not None:
                try:
                    self.store.record_specialist(info.route_hash, None)
                except Exception:  # noqa: BLE001 — see _record_lineage
                    log.exception(
                        "specialist lineage removal failed for %r", dst)
            self.last_rollback = {"route": dst,
                                  "route_hash": info.route_hash,
                                  "generation": self.bank.generation,
                                  "at": time.time()}
        log.info("distill: rolled back specialist head for %s "
                 "(generation %d)", dst, self.bank.generation)
        return True

    # -- base-model publishes ----------------------------------------------
    def export_full(self, base_snap, base_version: int,
                    quant: Optional[str] = None) -> bytes:
        """Full-bank export after the base model changed (startup, a
        lifecycle promotion or rollback): the generation bumps, every
        head rides along, and every route's drift reference re-anchors.
        The caller holds ``self.lock`` (sync body: no await point
        between the generation bump and the blob that carries it)."""
        self.bank.generation += 1
        self.bank.base_version = int(base_version)
        self._base_snap = base_snap
        blob = self.bank.export_full(base_snap, int(base_version),
                                     self.bank.generation,
                                     quant or self.quant)
        self.monitor.re_anchor_all()
        return blob

    # -- observability -----------------------------------------------------
    def state(self) -> Dict[str, Any]:
        return {
            "quant": self.quant,
            "delta_publish": bool(self.cfg.deltaPublish),
            "drift_threshold": self.cfg.driftThreshold,
            "bank": self.bank.state(),
            "routes": self.monitor.snapshot(),
            "pending": self.monitor.triggered()[:8],
            "last_outcome": self.last_outcome,
            "last_rollback": self.last_rollback,
        }
