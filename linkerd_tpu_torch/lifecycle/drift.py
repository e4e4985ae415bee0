"""Population-drift detection against the serving checkpoint's stats:
a copy of ``linkerd_tpu/lifecycle/drift.py``.

A promoted checkpoint freezes the feature distribution the model was
judged against (its mu/var normalization stats). As live traffic evolves,
this monitor tracks EWMA feature means/variances and the score
distribution, and exports shift gauges through the telemetry metrics
registry (``anomaly/drift/...`` in /admin/metrics.json) and /model.json:

- ``feature_shift``  — mean |live_mu - ref_mu| / sqrt(ref_var), i.e. how
  many sigmas the average feature has wandered from the checkpoint.
- ``var_log_ratio``  — mean |log(live_var / ref_var)|: spread change.
- ``score_shift``    — |live score mean - reference score mean| in units
  of the reference score std.

High drift means the serving model is normalizing today's traffic with
yesterday's statistics — the operator signal to retrain/promote sooner
(or distrust scores), per Solyx-style telemetry-aware routing needing
trustworthy, refreshable models (arxiv 2606.15050).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

_VAR_FLOOR = 1e-2  # matches models.anomaly.normalize_features


class DriftMonitor:
    """Running feature/score population stats vs. a reference snapshot.

    ``node`` is a MetricsTree scope (gauges register under it); pass None
    for registry-less use (unit tests, standalone evaluation).
    """

    def __init__(self, node=None, momentum: float = 0.05):
        if not 0.0 < momentum <= 1.0:
            raise ValueError("momentum must be in (0, 1]")
        self.momentum = momentum
        self._ref_mu: Optional[np.ndarray] = None
        self._ref_var: Optional[np.ndarray] = None
        self._ref_score_mean: Optional[float] = None
        self._ref_score_std: Optional[float] = None
        self.reference_version: Optional[int] = None
        self.reference_step: Optional[int] = None
        self._live_mu: Optional[np.ndarray] = None
        self._live_var: Optional[np.ndarray] = None
        self._live_score_mean: Optional[float] = None
        self._live_score_std: Optional[float] = None
        self.batches_observed = 0
        self._gauges: Dict[str, Any] = {}
        if node is not None:
            for name in ("feature_shift", "var_log_ratio", "score_shift",
                         "score_mean"):
                self._gauges[name] = node.gauge(name)

    # -- reference --------------------------------------------------------
    def set_reference(self, mu: np.ndarray, var: np.ndarray,
                      version: Optional[int] = None,
                      step: Optional[int] = None) -> None:
        """Anchor drift to a checkpoint's normalization stats. The score
        reference re-anchors to the live score distribution at promotion
        time (scores immediately after a promotion are 'normal')."""
        self._ref_mu = np.asarray(mu, np.float32).copy()
        self._ref_var = np.asarray(var, np.float32).copy()
        self.reference_version = version
        self.reference_step = step
        self._ref_score_mean = self._live_score_mean
        self._ref_score_std = self._live_score_std
        self._publish()

    # -- observation ------------------------------------------------------
    def observe(self, x: np.ndarray, scores: Optional[np.ndarray] = None) -> None:
        """Fold one micro-batch of raw features (+ optional scores) into
        the live EWMA stats and refresh the gauges. O(batch * dim) numpy;
        called once per drained batch, not per request."""
        x = np.asarray(x, np.float32)
        if x.ndim != 2 or len(x) == 0:
            return
        mu = x.mean(axis=0)
        var = x.var(axis=0)
        m = self.momentum
        if self._live_mu is None:
            self._live_mu, self._live_var = mu, var
        else:
            self._live_mu = (1 - m) * self._live_mu + m * mu
            self._live_var = (1 - m) * self._live_var + m * var
        if scores is not None and len(scores):
            s = np.asarray(scores, np.float32)
            sm, ss = float(s.mean()), float(s.std())
            if self._live_score_mean is None:
                self._live_score_mean, self._live_score_std = sm, ss
            else:
                self._live_score_mean = \
                    (1 - m) * self._live_score_mean + m * sm
                self._live_score_std = \
                    (1 - m) * self._live_score_std + m * ss
        self.batches_observed += 1
        self._publish()

    # -- derived gauges ---------------------------------------------------
    def feature_shift(self) -> float:
        if self._ref_mu is None or self._live_mu is None:
            return 0.0
        z = np.abs(self._live_mu - self._ref_mu) \
            / np.sqrt(self._ref_var + _VAR_FLOOR)
        return float(z.mean())

    def var_log_ratio(self) -> float:
        if self._ref_var is None or self._live_var is None:
            return 0.0
        ratio = (self._live_var + _VAR_FLOOR) / (self._ref_var + _VAR_FLOOR)
        return float(np.abs(np.log(ratio)).mean())

    def score_shift(self) -> float:
        if self._ref_score_mean is None or self._live_score_mean is None:
            return 0.0
        denom = max(self._ref_score_std or 0.0, 1e-3)
        return abs(self._live_score_mean - self._ref_score_mean) / denom

    def _publish(self) -> None:
        if not self._gauges:
            return
        self._gauges["feature_shift"].set(self.feature_shift())
        self._gauges["var_log_ratio"].set(self.var_log_ratio())
        self._gauges["score_shift"].set(self.score_shift())
        self._gauges["score_mean"].set(self._live_score_mean or 0.0)

    def snapshot(self) -> Dict[str, Any]:
        return {
            "feature_shift": self.feature_shift(),
            "var_log_ratio": self.var_log_ratio(),
            "score_shift": self.score_shift(),
            "score_mean": self._live_score_mean,
            "score_std": self._live_score_std,
            "batches_observed": self.batches_observed,
            "reference_version": self.reference_version,
            "reference_step": self.reference_step,
        }
