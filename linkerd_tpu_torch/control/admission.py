"""Adaptive admission control: shed earlier when trouble is coming: a copy of
``linkerd_tpu/control/admission.py``.

The static ``admissionControl`` bound (router/admission.py) protects the
router from overload that has already arrived. The control loop narrows
that bound *preemptively* when the anomaly signal says the mesh is
degrading — the mesh-wide score level and the drift monitor's
score-distribution shift both feed it — so the router sheds (with its
retryable signal) before queues build behind a sick downstream, and
widens back to the configured ceiling as the signal clears.

The factor moves through an EWMA (never a step function) and the limit
never drops below ``floor`` x the configured concurrency, so adaptive
shedding can slow a router down but never wedge it shut.
"""

from __future__ import annotations

import logging
from typing import List, Optional

log = logging.getLogger(__name__)


class AdaptiveAdmission:
    """Modulates registered AdmissionControlFilters' effective
    concurrency from the anomaly level and drift-monitor score shift.

    ``step()`` is called by the ControlLoop each tick; it is pure
    computation + ``set_limit`` calls (no awaits)."""

    # score_shift is in reference-score sigmas; 3 sigma reads as a
    # fully-drifted model (signal 1.0)
    DRIFT_FULL_SIGMAS = 3.0

    def __init__(self, board, drift=None, threshold: float = 0.5,
                 floor: float = 0.25, alpha: float = 0.3,
                 metrics_node=None):
        if not 0.0 < floor <= 1.0:
            raise ValueError("floor must be in (0, 1]")
        if not 0.0 < threshold < 1.0:
            raise ValueError("threshold must be in (0, 1)")
        if not 0.0 < alpha <= 1.0:
            raise ValueError("alpha must be in (0, 1]")
        self._board = board
        self._drift = drift
        self.threshold = threshold
        self.floor = floor
        self.alpha = alpha
        self.factor = 1.0
        self._filters: List = []
        if metrics_node is not None:
            self._factor_g = metrics_node.gauge("admission_factor")
            self._factor_g.set(1.0)
            metrics_node.gauge(
                "admission_limit",
                fn=lambda: float(sum(f.effective_concurrency
                                     for f in self._filters)))
        else:
            self._factor_g = None

    def register(self, admission_filter) -> None:
        """Adopt a router's AdmissionControlFilter (the Linker calls
        this during router assembly)."""
        self._filters.append(admission_filter)
        admission_filter.set_limit(
            round(admission_filter.max_concurrency * self.factor))

    def signal(self) -> float:
        """The combined trouble signal in [0, 1]: max of the mesh-wide
        anomaly level (staleness/degraded-aware) and the normalized
        drift score shift."""
        level = float(self._board.anomaly_level())
        drift_sig = 0.0
        if self._drift is not None:
            drift_sig = min(
                1.0, self._drift.score_shift() / self.DRIFT_FULL_SIGMAS)
        return max(level, drift_sig)

    def step(self) -> float:
        sig = self.signal()
        if sig <= self.threshold:
            target = 1.0
        else:
            span = max(1e-6, 1.0 - self.threshold)
            target = max(
                self.floor,
                1.0 - (1.0 - self.floor) * (sig - self.threshold) / span)
        self.factor += self.alpha * (target - self.factor)
        for f in self._filters:
            f.set_limit(round(f.max_concurrency * self.factor))
        if self._factor_g is not None:
            self._factor_g.set(self.factor)
        return self.factor

    def status(self) -> dict:
        return {
            "signal": round(self.signal(), 4),
            "factor": round(self.factor, 4),
            "threshold": self.threshold,
            "floor": self.floor,
            "limits": [
                {"max": f.max_concurrency,
                 "effective": f.effective_concurrency}
                for f in self._filters
            ],
        }


class TenantAdmission:
    """Per-tenant score-driven quotas: the isolation half of adaptive
    admission.

    Each active tenant's anomaly level (TenantBoard.level: error EWMA,
    in-plane score EWMA, traffic dominance) feeds the shared
    HysteresisGovernor — split thresholds + quorum + dwell, so quotas
    never flap. On the SICK edge a tenant's quota shrinks to its floor
    (``floor`` × each filter's configured concurrency on the Python
    path; ``floor`` × ``engine_base`` pushed into the native engines'
    in-data-plane quota maps); on the HEALTHY edge the quota clears
    entirely. Every other tenant's budget is untouched throughout —
    one abusive tenant degrades alone.

    ``step()`` is pure computation + quota pushes (no awaits); it is
    driven by the ControlLoop tick when one exists, by the fastpath
    stats loop for native routers, and opportunistically by
    TenantTagFilter (interval-gated) so isolation works without
    either."""

    def __init__(self, board, governor=None, floor: float = 0.1,
                 engine_base: int = 64, min_interval_s: float = 0.1,
                 metrics_node=None):
        if not 0.0 < floor <= 1.0:
            raise ValueError("floor must be in (0, 1]")
        if engine_base < 1:
            raise ValueError("engine_base must be >= 1")
        if governor is None:
            from linkerd_tpu_torch.control.state import HysteresisGovernor
            governor = HysteresisGovernor()
        self.board = board
        self.governor = governor
        self.floor = floor
        self.engine_base = engine_base
        self.min_interval_s = min_interval_s
        self._filters: List = []
        self._engines: List = []
        self._sick: dict = {}  # tenant -> applied floor quota
        self._last_step = 0.0
        self.transitions = 0
        if metrics_node is not None:
            metrics_node.gauge(
                "sick_tenants", fn=lambda: float(len(self._sick)))
            self._trans_c = metrics_node.counter("tenant_transitions")
        else:
            self._trans_c = None

    def register(self, admission_filter) -> None:
        """Adopt a router's AdmissionControlFilter (per-tenant
        sub-limits ride its set_tenant_limit)."""
        self._filters.append(admission_filter)

    def register_engine(self, engine) -> None:
        """Adopt a native engine (quotas ride set_tenant_quota into the
        data plane)."""
        self._engines.append(engine)

    def maybe_step(self, now: Optional[float] = None) -> None:
        """Interval-gated step for opportunistic drivers (the tag
        filter calls this per request; only one in ``min_interval_s``
        does work)."""
        import time as _time
        now = _time.monotonic() if now is None else now
        if now - self._last_step < self.min_interval_s:
            return
        self.step(now)

    def _apply(self, tenant: str, sick: bool) -> None:
        thash = self.board.hash_of(tenant)
        for f in self._filters:
            limit = (max(1, round(self.floor * f.max_concurrency))
                     if sick else None)
            f.set_tenant_limit(thash, limit)
        limit = (max(1, round(self.floor * self.engine_base))
                 if sick else None)
        for eng in self._engines:
            try:
                eng.set_tenant_quota(thash, limit)
            except (ValueError, RuntimeError) as e:
                log.warning("native tenant quota push failed: %s", e)

    def step(self, now: Optional[float] = None) -> None:
        import time as _time
        now = _time.monotonic() if now is None else now
        self._last_step = now
        from linkerd_tpu_torch.control.state import SICK
        active = self.board.active_tenants()
        # the governor's key store is unbounded by itself; under
        # hostile tenant-id churn the board's LRU evicts ids, and the
        # governor must forget them too (sick tenants are kept — their
        # quota must survive until recovery clears it)
        active_set = set(active)
        for key in self.governor.keys():
            if key not in active_set and key not in self._sick:
                self.governor.forget(key)
        for tenant in active:
            level = self.board.level(tenant)
            state = self.governor.observe(tenant, level, now=now)
            sick = state == SICK
            was_sick = tenant in self._sick
            if sick and not was_sick:
                self._sick[tenant] = max(
                    1, round(self.floor * self.engine_base))
                self._apply(tenant, True)
                self.transitions += 1
                if self._trans_c is not None:
                    self._trans_c.incr()
                log.info("tenant %s SICK (level %.3f): quota -> floor",
                         tenant, level)
            elif not sick and was_sick:
                del self._sick[tenant]
                self._apply(tenant, False)
                self.transitions += 1
                if self._trans_c is not None:
                    self._trans_c.incr()
                log.info("tenant %s recovered: quota cleared", tenant)

    def status(self) -> dict:
        return {
            "floor": self.floor,
            "engine_base": self.engine_base,
            "sick": sorted(self._sick),
            "transitions": self.transitions,
            "governor": self.governor.snapshot(),
            "tenants": self.board.snapshot(),
        }
