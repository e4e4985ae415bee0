"""Shadow evaluation + promotion gating for the anomaly scorer:
counterpart of ``linkerd_tpu/lifecycle/promote.py``.

Online training makes the live model the *candidate*: it drifts with
every ``fit()`` and nothing guarantees the drift was good. The lifecycle
manager periodically shadow-evaluates the live parameters against a
held-out replay window (recent feature batches captured by the
telemeter) and compares them with the last promoted checkpoint:

    capture -> train -> shadow-eval -> promote | rollback -> hot-swap

A candidate is promoted only if its loss/AUC on the replay window does
not regress beyond configured tolerances; a rejected candidate triggers
an automatic rollback — the scorer hot-swaps back to the last-good
version and keeps serving (Taurus-style gated model updates,
arxiv 2002.08987). ``evaluate_snapshot`` scores the window on the
device through the fused kernel.
"""

from __future__ import annotations

import asyncio
import collections
import time
from dataclasses import dataclass
from typing import Any, Deque, Dict, Optional, Tuple

import numpy as np
import torch

from linkerd_tpu_torch import DeviceLike, resolve_device
from linkerd_tpu_torch.lifecycle.store import CheckpointStore, ModelSnapshot
from linkerd_tpu_torch.models.anomaly import loss_fn, normalize_features
from linkerd_tpu_torch.models.convert import params_from_numpy
from linkerd_tpu_torch.ops.scoring import fused_anomaly_scores

# -- held-out replay window ---------------------------------------------------


class ReplayWindow:
    """Recent feature micro-batches, capped by total rows. The window is
    the shadow-evaluation set: it reflects what the mesh looks like NOW,
    so a candidate that regressed on current traffic fails the gate even
    if it once fit older traffic well."""

    def __init__(self, capacity_rows: int = 4096):
        if capacity_rows < 1:
            raise ValueError("capacity_rows must be >= 1")
        self.capacity_rows = capacity_rows
        self._batches: Deque[Tuple[np.ndarray, np.ndarray, np.ndarray]] = \
            collections.deque()
        self._rows = 0

    def __len__(self) -> int:
        return self._rows

    @property
    def labeled_rows(self) -> int:
        return int(sum(float(m.sum()) for _, _, m in self._batches))

    def add_batch(self, x: np.ndarray, labels: np.ndarray,
                  mask: np.ndarray) -> None:
        x = np.asarray(x, np.float32)
        self._batches.append((x.copy(),
                              np.asarray(labels, np.float32).copy(),
                              np.asarray(mask, np.float32).copy()))
        self._rows += len(x)
        while self._batches and self._rows - len(self._batches[0][0]) \
                >= self.capacity_rows:
            old, _, _ = self._batches.popleft()
            self._rows -= len(old)

    def sample(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        if not self._batches:
            raise ValueError("empty replay window")
        xs, ls, ms = zip(*self._batches)
        return np.concatenate(xs), np.concatenate(ls), np.concatenate(ms)


# -- shadow evaluation --------------------------------------------------------


@dataclass(frozen=True)
class EvalReport:
    loss: float
    auc: float            # nan when the window has too few labeled rows
    score_mean: float
    score_std: float
    n_rows: int
    n_labeled: int

    def as_dict(self) -> Dict[str, Any]:
        return {
            "loss": self.loss,
            "auc": None if np.isnan(self.auc) else self.auc,
            "score_mean": self.score_mean,
            "score_std": self.score_std,
            "n_rows": self.n_rows,
            "n_labeled": self.n_labeled,
        }


def auc(labels, scores) -> float:
    """Area under the ROC curve by the rank-sum formulation, ties at
    their average rank: a copy of ``linkerd_tpu/testing/faults.py``'s,
    except that a NaN score makes the AUC NaN. (The reference's tie scan
    never advances past a NaN, which equals nothing, itself included, so
    it loops forever on the scores of a model with NaN weights.)"""
    if any(s != s for s in scores):
        return float("nan")
    pairs = sorted(zip(scores, labels))
    n_pos = sum(1 for _, l in pairs if l > 0.5)
    n_neg = len(pairs) - n_pos
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    rank_sum = 0.0
    i = 0
    while i < len(pairs):
        j = i
        while j < len(pairs) and pairs[j][0] == pairs[i][0]:
            j += 1
        avg_rank = (i + 1 + j) / 2.0
        for k in range(i, j):
            if pairs[k][1] > 0.5:
                rank_sum += avg_rank
        i = j
    return (rank_sum - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg)


def evaluate_snapshot(snap: ModelSnapshot, x: np.ndarray,
                      labels: np.ndarray, mask: np.ndarray,
                      device: DeviceLike = None) -> EvalReport:
    """Score a snapshot's params over the replay window on ``device``
    (CUDA unless the CPU is named). Normalization uses the SNAPSHOT's
    mu/var: a candidate is judged with the stats it would serve with.
    The scores come from one ``fused_anomaly_scores`` launch with the
    z-score folded in; the loss is ``loss_fn`` on the normalized rows.
    Blocking: call off the event loop."""
    dev = resolve_device(device)
    params = params_from_numpy(snap.params, dev)
    xd = torch.tensor(np.asarray(x, np.float32), device=dev)
    mu = torch.tensor(np.asarray(snap.mu, np.float32), device=dev)
    var = torch.tensor(np.asarray(snap.var, np.float32), device=dev)
    with torch.no_grad():
        scores = fused_anomaly_scores(params, xd, snap.cfg, mu,
                                      var).cpu().numpy()
        loss = float(loss_fn(
            params, normalize_features(xd, mu, var),
            torch.tensor(np.asarray(labels, np.float32), device=dev),
            torch.tensor(np.asarray(mask, np.float32), device=dev),
            snap.cfg))
    labeled = mask > 0.5
    n_labeled = int(labeled.sum())
    a = float("nan")
    if n_labeled:
        a = auc(labels[labeled].tolist(), scores[labeled].tolist())
    return EvalReport(
        loss=loss, auc=a,
        score_mean=float(scores.mean()) if len(scores) else 0.0,
        score_std=float(scores.std()) if len(scores) else 0.0,
        n_rows=len(x), n_labeled=n_labeled)


# -- promotion gate -----------------------------------------------------------


@dataclass(frozen=True)
class GatePolicy:
    aucTolerance: float = 0.02    # candidate AUC may trail serving by this
    lossTolerance: float = 0.10   # candidate loss may exceed serving by 10%
    minLabeled: int = 8           # below this, AUC is noise — gate on loss


@dataclass(frozen=True)
class Decision:
    accepted: bool
    reason: str
    candidate: EvalReport
    serving: Optional[EvalReport]

    def as_dict(self) -> Dict[str, Any]:
        return {
            "accepted": self.accepted,
            "reason": self.reason,
            "candidate": self.candidate.as_dict(),
            "serving": self.serving.as_dict() if self.serving else None,
        }


class PromotionGate:
    def __init__(self, policy: GatePolicy = GatePolicy()):
        self.policy = policy

    def decide(self, candidate: EvalReport,
               serving: Optional[EvalReport]) -> Decision:
        p = self.policy
        if serving is None:
            return Decision(True, "bootstrap (no serving version)",
                            candidate, None)
        if not np.isfinite(candidate.loss):
            return Decision(False, "candidate loss not finite",
                            candidate, serving)
        if candidate.loss > serving.loss * (1.0 + p.lossTolerance):
            return Decision(
                False,
                f"loss regressed: {candidate.loss:.4f} > "
                f"{serving.loss:.4f} * (1 + {p.lossTolerance})",
                candidate, serving)
        both_auc = (candidate.n_labeled >= p.minLabeled
                    and serving.n_labeled >= p.minLabeled
                    and np.isfinite(candidate.auc)
                    and np.isfinite(serving.auc))
        if both_auc and candidate.auc < serving.auc - p.aucTolerance:
            return Decision(
                False,
                f"AUC regressed: {candidate.auc:.4f} < "
                f"{serving.auc:.4f} - {p.aucTolerance}",
                candidate, serving)
        return Decision(True, "within tolerance", candidate, serving)


# -- lifecycle manager --------------------------------------------------------


async def _call_scorer(fn, *args):
    """Invoke a scorer snapshot/restore hook that may be sync (in-process:
    device transfers off the event loop) or async (gRPC sidecar)."""
    if asyncio.iscoroutinefunction(fn):
        return await fn(*args)
    return await asyncio.to_thread(fn, *args)


class ModelLifecycleManager:
    """Ties the checkpoint store, replay window, promotion gate, and
    drift monitor into the capture -> train -> shadow-eval -> promote ->
    hot-swap loop. Shadow evaluations run on ``device`` (CUDA unless the
    CPU is named)."""

    def __init__(self, store: CheckpointStore, gate: PromotionGate,
                 replay: ReplayWindow, drift=None,
                 min_replay_rows: int = 256, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.store = store
        self.gate = gate
        self.replay = replay
        self.drift = drift
        self.min_replay_rows = min_replay_rows
        self.serving_version: Optional[int] = store.latest_good()
        self.promotions = 0
        self.rollbacks = 0
        self.rejections = 0
        self.last_promotion: Optional[Dict[str, Any]] = None
        self.last_rollback: Optional[Dict[str, Any]] = None
        self.last_decision: Optional[Dict[str, Any]] = None
        self._lock = asyncio.Lock()

    # -- startup ----------------------------------------------------------
    async def bootstrap(self, scorer) -> Optional[int]:
        """Restore the last-good checkpoint into the scorer, surviving a
        router/sidecar restart (the seed motivation: params must not
        silently reset to random init). No-op on an empty store.

        Holds the cycle lock: a gate cycle promoting v(N+1) while the
        restore await is in flight would otherwise be clobbered — the
        scorer would serve vN with serving_version rolled back under a
        store whose latest promotion is newer."""
        async with self._lock:
            version = self.store.latest_good()
            if version is None:
                return None
            v, snap = self.store.load(version)
            await _call_scorer(scorer.restore, snap)
            self.serving_version = v
            if self.drift is not None:
                self.drift.set_reference(snap.mu, snap.var, version=v,
                                         step=snap.step)
            return v

    # -- the gating cycle -------------------------------------------------
    async def checkpoint(self, scorer, status: str = "candidate") -> int:
        # locked so the parent lineage is the serving version at SAVE
        # time: a promotion completing during the snapshot await would
        # otherwise leave this checkpoint claiming a stale parent
        async with self._lock:
            snap = await _call_scorer(scorer.snapshot)
            return self.store.save(snap, status=status,
                                   parent=self.serving_version)

    async def run_cycle(self, scorer) -> Dict[str, Any]:
        """One checkpoint/shadow-eval/promote-or-rollback pass over the
        live scorer. Returns an outcome dict (also kept as
        ``last_decision`` for /model.json)."""
        async with self._lock:
            snap = await _call_scorer(scorer.snapshot)
            if self.serving_version is None:
                # first ever checkpoint: promote unconditionally so there
                # is a rollback target from now on
                version = self.store.save(snap, status="promoted")
                self.serving_version = version
                self.promotions += 1
                self.last_promotion = {"version": version, "at": time.time(),
                                       "reason": "bootstrap"}
                if self.drift is not None:
                    self.drift.set_reference(snap.mu, snap.var,
                                             version=version, step=snap.step)
                outcome = {"action": "promoted", "version": version,
                           "reason": "bootstrap (no serving version)"}
                self.last_decision = outcome
                return outcome
            if len(self.replay) < self.min_replay_rows:
                outcome = {"action": "skipped",
                           "reason": f"replay window {len(self.replay)} < "
                                     f"{self.min_replay_rows} rows"}
                self.last_decision = outcome
                return outcome

            x, labels, mask = self.replay.sample()
            _, serving_snap = self.store.load(self.serving_version)
            cand_report = await asyncio.to_thread(
                evaluate_snapshot, snap, x, labels, mask, self.device)
            serv_report = await asyncio.to_thread(
                evaluate_snapshot, serving_snap, x, labels, mask,
                self.device)
            decision = self.gate.decide(cand_report, serv_report)

            if decision.accepted:
                version = self.store.save(snap, status="promoted",
                                          parent=self.serving_version)
                self.serving_version = version
                self.promotions += 1
                self.last_promotion = {
                    "version": version, "at": time.time(),
                    "reason": decision.reason,
                    "candidate": cand_report.as_dict(),
                }
                if self.drift is not None:
                    self.drift.set_reference(snap.mu, snap.var,
                                             version=version, step=snap.step)
                outcome = {"action": "promoted", "version": version,
                           "decision": decision.as_dict()}
            else:
                # record the rejected candidate for forensics, then
                # hot-swap the scorer back to the last-good version
                rejected = self.store.save(snap, status="rejected",
                                           parent=self.serving_version)
                self.rejections += 1
                await _call_scorer(scorer.restore, serving_snap)
                self.rollbacks += 1
                self.last_rollback = {
                    "to_version": self.serving_version,
                    "rejected_version": rejected,
                    "at": time.time(),
                    "reason": decision.reason,
                }
                outcome = {"action": "rolled_back",
                           "to_version": self.serving_version,
                           "rejected_version": rejected,
                           "decision": decision.as_dict()}
            self.last_decision = outcome
            return outcome

    async def rollback(self, scorer) -> Optional[int]:
        """Explicit rollback to the last-good version (admin-triggered)."""
        async with self._lock:
            version = self.store.latest_good()
            if version is None:
                return None
            v, snap = self.store.load(version)
            await _call_scorer(scorer.restore, snap)
            self.serving_version = v
            self.rollbacks += 1
            self.last_rollback = {"to_version": v, "at": time.time(),
                                  "reason": "manual"}
            return v

    # -- observability ----------------------------------------------------
    def status(self) -> Dict[str, Any]:
        out = {
            "serving_version": self.serving_version,
            "promotions": self.promotions,
            "rollbacks": self.rollbacks,
            "rejections": self.rejections,
            "replay_rows": len(self.replay),
            "replay_labeled_rows": self.replay.labeled_rows,
            "last_promotion": self.last_promotion,
            "last_rollback": self.last_rollback,
            "last_decision": self.last_decision,
            "store": self.store.status(),
        }
        if self.drift is not None:
            out["drift"] = self.drift.snapshot()
        return out
