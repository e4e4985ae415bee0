"""Score-weighted load balancing: deprioritize before ejecting: a copy of
``linkerd_tpu/control/balancer.py``.

Failure accrual is binary and late — an endpoint must *fail* repeatedly
before it is removed. The anomaly scorer sees trouble earlier (latency
drift, error-rate creep), so the control loop multiplicatively
down-weights replicas trending anomalous inside the existing
p2c/ewma/aperture pick paths (``Balancer`` grew a ``weigher`` hook for
exactly this; see router/balancer.py):

- the endpoint's **effective weight** is scaled by the factor, so the
  load formulas (``pending / weight``, peak-EWMA x pending/weight)
  steer loaded traffic away;
- the dispatch **pick is rejection-sampled** by the same factor, so the
  shift is visible even at idle (zero pending load ties every formula).

The factor never reaches zero (``floor``): a sick replica keeps a probe
trickle, so its recovery is observable without failure-accrual-style
revival probes.
"""

from __future__ import annotations

from typing import Callable, Dict

from linkerd_tpu_torch.router.balancer import Balancer
from linkerd_tpu_torch.router.service import Service, Status


def mk_weigher(board, threshold: float = 0.3,
               floor: float = 0.05) -> Callable[[str], float]:
    """Weight factor from the ScoreBoard's per-endpoint effective
    scores: 1.0 at or below ``threshold``, ramping linearly down to
    ``floor`` at score 1.0. Uses the staleness-decayed, degraded-aware
    view — a dead scorer path reads neutral, never pinning a weight."""
    span = max(1e-6, 1.0 - threshold)

    def weigh(hostport: str) -> float:
        score = board.endpoint_score_of(hostport)
        if score <= threshold:
            return 1.0
        return max(floor, 1.0 - (1.0 - floor) * (score - threshold) / span)

    return weigh


class ScoreWeightedBalancer(Service):
    """Installs a score weigher on a Balancer and delegates dispatch.

    The weighting itself runs inside the wrapped balancer's pick path
    (every kind — p2c, ewma, aperture, heap, roundRobin — inherits it);
    this wrapper is the control loop's handle: it owns the weigher
    installation and exposes the live per-endpoint factors for
    ``/control.json``."""

    def __init__(self, inner: Balancer, weigher: Callable[[str], float]):
        self._inner = inner
        inner.weigher = weigher

    async def __call__(self, req):
        return await self._inner(req)

    @property
    def status(self) -> Status:
        return self._inner.status

    @property
    def size(self) -> int:
        return self._inner.size

    def pick(self):
        return self._inner.pick()

    def weights(self) -> Dict[str, float]:
        """{hostport: current weight factor} — the admin view."""
        self._inner.refresh_weights(force=True)
        return {
            ep.address.hostport: round(ep.weight_factor, 4)
            for ep in self._inner._endpoints.values()
        }

    async def close(self) -> None:
        await self._inner.close()

    def __getattr__(self, name):
        if name == "_inner":  # guard re-entrancy before __init__ ran
            raise AttributeError(name)
        return getattr(self._inner, name)
