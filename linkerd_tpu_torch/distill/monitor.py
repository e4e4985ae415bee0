"""Per-route drift detection + per-route replay for the distiller. A
copy of ``linkerd_tpu/distill/monitor.py``.

The global ``lifecycle.drift.DriftMonitor`` answers "has the MESH
drifted from the serving checkpoint"; the distiller needs the per-ROUTE
question: which specific route's score distribution has walked away
from where it was when its serving head (base or specialist) was
anchored. ``RouteDriftMonitor`` keeps one EWMA score mean/std pair per
route, anchors a reference once the route has warmed, and reports
routes whose live mean sits more than the configured number of
reference-sigmas away — the retrain-on-shift trigger.

``RouteReplayWindow`` is the matching training/holdout source: recent
rows PER ROUTE (features, labels, mask), bounded per route and in route
count, so a retrain always fine-tunes on the traffic that actually
shifted. Both are host-side numpy on already-drained batches — nothing
here may touch the device (the batch publish path runs next to the
serving loop).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np

_STD_FLOOR = 0.05  # sigma denominator floor: scores live in [0, 1]


class _RouteStats:
    __slots__ = ("ref_mean", "ref_std", "live_mean", "live_std", "rows",
                 "last_anchor")

    def __init__(self) -> None:
        self.ref_mean: Optional[float] = None
        self.ref_std: Optional[float] = None
        self.live_mean: Optional[float] = None
        self.live_std: Optional[float] = None
        self.rows = 0
        self.last_anchor = 0.0  # monotonic


class RouteDriftMonitor:
    """Per-route score-shift gauges and retrain triggers.

    ``observe`` folds one drained batch's (dst, score) rows in;
    ``score_shift(dst)`` is |live - ref| in reference-sigma units;
    ``triggered`` lists routes past ``threshold``. ``re_anchor`` resets
    a route's reference to its live stats (called when its head — base
    or specialist — changes, exactly like the global DriftMonitor
    re-anchors on promotion: scores right after a publish are
    "normal"). Route cardinality is bounded: past ``max_routes`` new
    routes are ignored rather than growing without bound.
    """

    def __init__(self, threshold: float = 1.0, min_rows: int = 64,
                 momentum: float = 0.1, max_routes: int = 1024):
        if threshold <= 0:
            raise ValueError("threshold must be > 0")
        if min_rows < 1:
            raise ValueError("min_rows must be >= 1")
        if not 0.0 < momentum <= 1.0:
            raise ValueError("momentum must be in (0, 1]")
        self.threshold = threshold
        self.min_rows = min_rows
        self.momentum = momentum
        self.max_routes = max_routes
        self._routes: Dict[str, _RouteStats] = {}

    def observe(self, dsts: List[str], scores: np.ndarray) -> None:
        """Fold one batch of per-row (dst, score) pairs into the live
        EWMA stats. O(batch) host arithmetic."""
        if len(dsts) == 0:
            return
        groups: Dict[str, List[float]] = {}
        for dst, s in zip(dsts, scores):
            groups.setdefault(dst, []).append(float(s))
        m = self.momentum
        for dst, vals in groups.items():
            st = self._routes.get(dst)
            if st is None:
                if len(self._routes) >= self.max_routes:
                    continue  # bounded cardinality
                st = self._routes[dst] = _RouteStats()
            mean = sum(vals) / len(vals)
            var = sum((v - mean) ** 2 for v in vals) / len(vals)
            std = var ** 0.5
            if st.live_mean is None:
                st.live_mean, st.live_std = mean, std
            else:
                st.live_mean = (1 - m) * st.live_mean + m * mean
                st.live_std = (1 - m) * st.live_std + m * std
            st.rows += len(vals)
            if st.ref_mean is None and st.rows >= self.min_rows:
                # first warm anchor: the route's opening distribution
                # is its own "normal"
                self._anchor(st)

    def _anchor(self, st: _RouteStats) -> None:
        st.ref_mean = st.live_mean
        st.ref_std = st.live_std
        st.last_anchor = time.monotonic()

    def re_anchor(self, dst: str) -> None:
        st = self._routes.get(dst)
        if st is not None and st.live_mean is not None:
            self._anchor(st)

    def re_anchor_all(self) -> None:
        """Base-model publish: every route's serving model changed, so
        every reference is stale."""
        for st in self._routes.values():
            if st.live_mean is not None:
                self._anchor(st)

    def score_shift(self, dst: str) -> float:
        st = self._routes.get(dst)
        if st is None or st.ref_mean is None or st.live_mean is None:
            return 0.0
        denom = max(st.ref_std or 0.0, _STD_FLOOR)
        return abs(st.live_mean - st.ref_mean) / denom

    def rows_of(self, dst: str) -> int:
        st = self._routes.get(dst)
        return 0 if st is None else st.rows

    def triggered(self) -> List[str]:
        """Routes whose live score distribution shifted past the
        threshold — the distiller's work queue, worst shift first."""
        out = [(self.score_shift(dst), dst) for dst in self._routes]
        return [dst for shift, dst in sorted(out, reverse=True)
                if shift > self.threshold]

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        out: Dict[str, Dict[str, float]] = {}
        for dst, st in self._routes.items():
            out[dst] = {
                "shift": round(self.score_shift(dst), 4),
                "live_mean": st.live_mean,
                "ref_mean": st.ref_mean,
                "rows": st.rows,
            }
        return out


class RouteReplayWindow:
    """Recent rows per route: the retrain + holdout source.

    Rows arrive as whole drained batches (``add``); per route the
    newest ``per_route_rows`` rows are kept. Route cardinality is
    bounded by evicting the route with the OLDEST most-recent arrival
    (a route that stopped receiving traffic cannot retrain anyway).
    """

    def __init__(self, per_route_rows: int = 512, max_routes: int = 64):
        if per_route_rows < 8:
            raise ValueError("per_route_rows must be >= 8")
        if max_routes < 1:
            raise ValueError("max_routes must be >= 1")
        self.per_route_rows = per_route_rows
        self.max_routes = max_routes
        # dst -> (x rows, labels, mask) as growing-then-trimmed arrays
        self._rows: Dict[str, Tuple[np.ndarray, np.ndarray, np.ndarray]] = {}
        self._touched: Dict[str, int] = {}
        self._tick = 0

    def add(self, dsts: List[str], x: np.ndarray, labels: np.ndarray,
            mask: np.ndarray) -> None:
        if len(dsts) == 0:
            return
        self._tick += 1
        idx: Dict[str, List[int]] = {}
        for i, dst in enumerate(dsts):
            idx.setdefault(dst, []).append(i)
        for dst, rows in idx.items():
            if dst not in self._rows:
                if len(self._rows) >= self.max_routes:
                    victim = min(self._touched, key=self._touched.get)
                    del self._rows[victim]
                    del self._touched[victim]
                self._rows[dst] = (
                    np.zeros((0, x.shape[1]), np.float32),
                    np.zeros(0, np.float32), np.zeros(0, np.float32))
            xr, lr, mr = self._rows[dst]
            sel = np.array(rows, np.int64)
            xr = np.concatenate([xr, x[sel]])[-self.per_route_rows:]
            lr = np.concatenate([lr, labels[sel]])[-self.per_route_rows:]
            mr = np.concatenate([mr, mask[sel]])[-self.per_route_rows:]
            self._rows[dst] = (xr, lr, mr)
            self._touched[dst] = self._tick

    def rows(self, dst: str) -> int:
        got = self._rows.get(dst)
        return 0 if got is None else len(got[0])

    def sample(self, dst: str
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        got = self._rows.get(dst)
        if got is None or len(got[0]) == 0:
            raise ValueError(f"no replay rows for route {dst!r}")
        return got
