"""Load balancers over live replica sets: a copy of
``linkerd_tpu/router/balancer.py``.

Reference parity: the balancer kinds linkerd exposes
(LoadBalancerConfig.scala:12-18 — p2c, ewma, aperture, heap, roundRobin)
over finagle's Balancers, fed by ``Var[Addr]`` so address churn flows
without re-binding (SURVEY.md §3.3).

Endpoints materialize lazily from the Var[Addr]; removed addresses close
their endpoint services. Load metrics:
- p2c       — power-of-two-choices on (pending / weight)
- ewma      — peak-EWMA latency x (pending+1), p2c choice
- roundRobin— weight-ignoring cycle
- heap      — global least-loaded
- aperture  — p2c over a load-adaptive prefix of the endpoint list
"""

from __future__ import annotations

import asyncio
import logging
import random
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from linkerd_tpu_torch.core import Var
from linkerd_tpu_torch.core.addr import (
    Addr, Address, AddrFailed, AddrNeg, AddrPending, Bound,
)
from linkerd_tpu_torch.router.service import Service, Status

log = logging.getLogger(__name__)


class NoBrokersAvailable(Exception):
    """No endpoints to dispatch to (empty/neg/failed replica set)."""


class Endpoint:
    """One concrete replica: the endpoint service + load accounting."""

    __slots__ = ("address", "service", "pending", "ewma_ms", "_decay",
                 "weight_factor")

    def __init__(self, address: Address, service: Service):
        self.address = address
        self.service = service
        self.pending = 0
        self.ewma_ms = 0.0  # peak-EWMA latency estimate
        self._decay = 0.1
        # multiplicative anomaly down-weight in (0, 1], refreshed from
        # the control loop's weigher (control/balancer.py); 1.0 =
        # healthy / no control loop configured
        self.weight_factor = 1.0

    @property
    def weight(self) -> float:
        base = self.address.weight if self.address.weight > 0 else 1e-6
        return base * self.weight_factor

    @property
    def load(self) -> float:
        return self.pending / self.weight

    def observe_latency(self, ms: float) -> None:
        # Peak-EWMA (ref: finagle ewma balancer): jump up instantly,
        # decay down exponentially.
        if ms > self.ewma_ms:
            self.ewma_ms = ms
        else:
            self.ewma_ms += self._decay * (ms - self.ewma_ms)

    @property
    def status(self) -> Status:
        return self.service.status


class Balancer(Service):
    """Base: maintains the endpoint set from a Var[Addr]."""

    # weigher refresh throttle / rejection-sampling redraw bound (see
    # _score_pick)
    WEIGHT_REFRESH_S = 0.05
    SCORE_REPICKS = 3

    def __init__(self, addr: Var[Addr],
                 endpoint_factory: Callable[[Address], Service],
                 rng: Optional[random.Random] = None):
        self._addr = addr
        self._endpoint_factory = endpoint_factory
        self._endpoints: Dict[Address, Endpoint] = {}
        self._rng = rng or random.Random()
        self._closed = False
        self._to_close: List[Service] = []
        # score weigher hook: hostport -> factor in (0, 1], installed by
        # control/balancer.ScoreWeightedBalancer; None = no weighting
        self.weigher: Optional[Callable[[str], float]] = None
        self._weights_at = 0.0
        self._obs = addr.observe(self._on_addr)

    # -- replica-set maintenance -----------------------------------------
    def _on_addr(self, addr: Addr) -> None:
        if not isinstance(addr, Bound):
            return  # keep last-known-good endpoints through blips
        want = {a for a in addr.addresses}
        for a in list(self._endpoints):
            if a not in want:
                ep = self._endpoints.pop(a)
                self._to_close.append(ep.service)
        for a in want:
            if a not in self._endpoints:
                self._endpoints[a] = Endpoint(a, self._endpoint_factory(a))

    async def _reap(self) -> None:
        to_close, self._to_close = self._to_close, []
        for svc in to_close:
            try:
                await svc.close()
            except Exception as e:  # noqa: BLE001 — reaping must visit
                # every evicted endpoint; a failed close is worth a line
                log.debug("endpoint close during reap failed: %r", e)

    def _usable(self) -> List[Endpoint]:
        eps = [e for e in self._endpoints.values()
               if e.status is Status.OPEN]
        return eps or list(self._endpoints.values())

    def _check_addr(self) -> None:
        addr = self._addr.sample()
        if not self._endpoints:
            if isinstance(addr, AddrFailed):
                raise NoBrokersAvailable(f"address failed: {addr.why}")
            if isinstance(addr, (AddrNeg, AddrPending)) or (
                    isinstance(addr, Bound) and not addr.addresses):
                raise NoBrokersAvailable("empty replica set")

    # -- Service ----------------------------------------------------------
    @property
    def status(self) -> Status:
        if self._closed:
            return Status.CLOSED
        return Status.OPEN if self._endpoints else Status.BUSY

    @property
    def size(self) -> int:
        return len(self._endpoints)

    def pick(self) -> Endpoint:
        raise NotImplementedError

    # -- score weighting (the control loop's balancer actuator) -----------
    def refresh_weights(self, force: bool = False) -> None:
        """Refresh every endpoint's anomaly weight factor from the
        installed weigher, throttled so the per-dispatch cost is an
        occasional dict walk, not a per-request one."""
        if self.weigher is None:
            return
        now = time.monotonic()
        if not force and now - self._weights_at < self.WEIGHT_REFRESH_S:
            return
        self._weights_at = now
        for ep in self._endpoints.values():
            ep.weight_factor = self.weigher(ep.address.hostport)

    def _score_pick(self) -> Endpoint:
        """The kind's own ``pick`` with anomaly rejection sampling
        layered on: a picked endpoint is accepted with probability equal
        to its weight factor, redrawn otherwise (bounded). Healthy
        endpoints (factor 1.0) pass untouched; a sick one keeps a
        ``floor``-sized trickle via the acceptance probability. The
        factor ALSO scales ``Endpoint.weight``, so the load formulas
        (pending/weight, peak-EWMA) steer loaded traffic the same way —
        rejection sampling is what makes the shift visible at idle,
        where every load formula ties at zero."""
        if self.weigher is None:
            return self.pick()
        self.refresh_weights()
        best: Optional[Endpoint] = None
        best_f = -1.0
        for _ in range(1 + self.SCORE_REPICKS):
            ep = self.pick()
            f = ep.weight_factor
            if f >= 1.0 or self._rng.random() < f:
                return ep
            if f > best_f:
                best, best_f = ep, f
        return best if best is not None else self.pick()

    # How long a request queues while the replica set is still Pending
    # (finagle balancers queue on Addr.Pending rather than failing —
    # matters on first dispatch through a freshly-opened resolver watch).
    PENDING_TIMEOUT = 10.0

    async def _await_nonpending(self) -> None:
        if self._endpoints or not isinstance(self._addr.sample(), AddrPending):
            return

        async def _wait() -> None:
            async for a in self._addr.changes():
                if not isinstance(a, AddrPending):
                    return

        try:
            # wait_for, not asyncio.timeout: the latter is 3.11+ and
            # this path must run on 3.10 (first dispatch through a
            # freshly-opened resolver watch lands here)
            await asyncio.wait_for(_wait(), self.PENDING_TIMEOUT)
        except (TimeoutError, asyncio.TimeoutError):
            return  # _check_addr reports the empty set

    async def __call__(self, req):
        if self._to_close:
            await self._reap()
        await self._await_nonpending()
        self._check_addr()
        ep = self._score_pick()
        # the chosen replica rides the request ctx so the anomaly
        # pipeline can score per-endpoint (FeatureRecorder reads it) —
        # which is what feeds the weigher back. FIRST pick wins: a
        # retry re-enters here after the first endpoint failed, and the
        # request's degraded features (aggregate latency, retries>0)
        # must blame the replica that caused them, not the healthy one
        # that served the retry.
        ctx = getattr(req, "ctx", None)
        if ctx is not None and "endpoint" not in ctx:
            ctx["endpoint"] = ep.address.hostport
        ep.pending += 1
        t0 = time.monotonic()
        try:
            rsp = await ep.service(req)
        finally:
            ep.pending -= 1
            ep.observe_latency((time.monotonic() - t0) * 1e3)
        return rsp

    async def close(self) -> None:
        self._closed = True
        self._obs.close()
        for ep in self._endpoints.values():
            self._to_close.append(ep.service)
        self._endpoints.clear()
        await self._reap()


class P2CBalancer(Balancer):
    """Power-of-two-choices least-loaded (ref: Balancers.p2c)."""

    def pick(self) -> Endpoint:
        eps = self._usable()
        if not eps:
            raise NoBrokersAvailable("no endpoints")
        if len(eps) == 1:
            return eps[0]
        a, b = self._rng.sample(eps, 2)
        return a if a.load <= b.load else b


class EwmaBalancer(Balancer):
    """Peak-EWMA p2c (ref: Balancers.p2cPeakEwma)."""

    def pick(self) -> Endpoint:
        eps = self._usable()
        if not eps:
            raise NoBrokersAvailable("no endpoints")
        if len(eps) == 1:
            return eps[0]
        a, b = self._rng.sample(eps, 2)
        sa = (a.ewma_ms + 1.0) * (a.pending + 1) / a.weight
        sb = (b.ewma_ms + 1.0) * (b.pending + 1) / b.weight
        return a if sa <= sb else b


class RoundRobinBalancer(Balancer):
    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self._i = 0

    def pick(self) -> Endpoint:
        eps = self._usable()
        if not eps:
            raise NoBrokersAvailable("no endpoints")
        self._i = (self._i + 1) % len(eps)
        return eps[self._i]


class HeapBalancer(Balancer):
    """Global least-loaded (ref: Balancers.heap)."""

    def pick(self) -> Endpoint:
        eps = self._usable()
        if not eps:
            raise NoBrokersAvailable("no endpoints")
        return min(eps, key=lambda e: e.load)


class ApertureBalancer(Balancer):
    """P2C over a load-adaptive aperture (ref: Balancers.aperture).

    The aperture widens when average in-flight load per endpoint exceeds
    ``high_load`` and narrows below ``low_load``, bounded to
    [min_aperture, n].
    """

    def __init__(self, *args, min_aperture: int = 1, low_load: float = 0.5,
                 high_load: float = 2.0, **kw):
        super().__init__(*args, **kw)
        self.min_aperture = min_aperture
        self.low_load = low_load
        self.high_load = high_load
        self._aperture = min_aperture

    def pick(self) -> Endpoint:
        eps = self._usable()
        if not eps:
            raise NoBrokersAvailable("no endpoints")
        n = len(eps)
        width = max(self.min_aperture, min(self._aperture, n))
        window = eps[:width]
        total_pending = sum(e.pending for e in window)
        avg = total_pending / max(1, width)
        if avg > self.high_load and self._aperture < n:
            self._aperture += 1
        elif avg < self.low_load and self._aperture > self.min_aperture:
            self._aperture -= 1
        if len(window) == 1:
            return window[0]
        a, b = self._rng.sample(window, 2)
        return a if a.load <= b.load else b


BALANCER_KINDS = {
    "p2c": P2CBalancer,
    "ewma": EwmaBalancer,
    "roundRobin": RoundRobinBalancer,
    "heap": HeapBalancer,
    "aperture": ApertureBalancer,
}


def mk_balancer(kind: str, addr: Var[Addr],
                endpoint_factory: Callable[[Address], Service],
                rng: Optional[random.Random] = None) -> Balancer:
    try:
        cls = BALANCER_KINDS[kind]
    except KeyError:
        raise ValueError(
            f"unknown balancer kind {kind!r}; known: {sorted(BALANCER_KINDS)}"
        ) from None
    return cls(addr, endpoint_factory, rng)
