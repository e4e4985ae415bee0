"""Failure accrual: per-endpoint health from observed outcomes: a copy of
``linkerd_tpu/router/failure_accrual.py``.

Reference parity: linkerd/failure-accrual's pluggable policy kinds
(ConsecutiveFailuresInitializer, SuccessRateInitializer,
SuccessRateWindowedInitializer, NoneInitializer) + router/core's
FailureAccrualFactory (mark dead -> probation with backoff revival).

A FailureAccrualPolicy decides when an endpoint is unhealthy; the
FailureAccrualService wraps each endpoint, reports Status.BUSY while dead
(so balancers skip it), and re-admits one probe request after each backoff
interval (ref: FailureAccrualFactory's ProbeOpen/ProbeClosed states).
"""

from __future__ import annotations

import abc
import asyncio
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Iterator, List, Optional

from linkerd_tpu_torch.config import register
from linkerd_tpu_torch.router.service import Filter, Service, Status


class FailureAccrualPolicy(abc.ABC):
    @abc.abstractmethod
    def record_success(self) -> None: ...

    @abc.abstractmethod
    def record_failure(self) -> Optional[float]:
        """Returns a dead-time in seconds when the endpoint should be
        marked dead, else None."""

    @abc.abstractmethod
    def revived(self) -> None:
        """Probe succeeded: reset state."""


def _default_backoffs() -> Iterator[float]:
    # ref: FailureAccrualFactory jittered 5s..300s default
    import random
    cur = 5.0
    while True:
        yield random.uniform(cur / 2, cur)
        cur = min(300.0, cur * 2)


class ConsecutiveFailuresPolicy(FailureAccrualPolicy):
    """Dead after N consecutive failures (kind io.l5d.consecutiveFailures;
    linkerd default N=5)."""

    def __init__(self, failures: int = 5,
                 backoffs: Optional[Iterator[float]] = None):
        self.failures = failures
        self._consecutive = 0
        self._backoffs = backoffs or _default_backoffs()

    def record_success(self) -> None:
        self._consecutive = 0

    def record_failure(self) -> Optional[float]:
        self._consecutive += 1
        if self._consecutive >= self.failures:
            return next(self._backoffs)
        return None

    def revived(self) -> None:
        self._consecutive = 0
        self._backoffs = _default_backoffs()


class SuccessRatePolicy(FailureAccrualPolicy):
    """Dead when EWMA success rate over ``requests`` drops below
    ``success_rate`` (kind io.l5d.successRate)."""

    def __init__(self, success_rate: float = 0.8, requests: int = 30,
                 backoffs: Optional[Iterator[float]] = None):
        self.success_rate = success_rate
        self.requests = requests
        self._alpha = 2.0 / (requests + 1)
        self._ewma = 1.0
        self._seen = 0
        self._backoffs = backoffs or _default_backoffs()

    def _record(self, ok: bool) -> None:
        self._seen += 1
        self._ewma += self._alpha * ((1.0 if ok else 0.0) - self._ewma)

    def record_success(self) -> None:
        self._record(True)

    def record_failure(self) -> Optional[float]:
        self._record(False)
        if self._seen >= self.requests and self._ewma < self.success_rate:
            return next(self._backoffs)
        return None

    def revived(self) -> None:
        self._ewma = 1.0
        self._seen = 0
        self._backoffs = _default_backoffs()


class SuccessRateWindowedPolicy(FailureAccrualPolicy):
    """Dead when success rate over a sliding time window drops below
    threshold (kind io.l5d.successRateWindowed)."""

    def __init__(self, success_rate: float = 0.8, window_s: float = 30.0,
                 backoffs: Optional[Iterator[float]] = None):
        self.success_rate = success_rate
        self.window_s = window_s
        self._events: deque = deque()  # (timestamp, ok)
        self._backoffs = backoffs or _default_backoffs()

    def _sweep(self, now: float) -> None:
        cutoff = now - self.window_s
        while self._events and self._events[0][0] < cutoff:
            self._events.popleft()

    def _record(self, ok: bool) -> None:
        now = time.monotonic()
        self._events.append((now, ok))
        self._sweep(now)

    def record_success(self) -> None:
        self._record(True)

    def record_failure(self) -> Optional[float]:
        self._record(False)
        if not self._events:
            return None
        oks = sum(1 for _, ok in self._events if ok)
        if oks / len(self._events) < self.success_rate:
            return next(self._backoffs)
        return None

    def revived(self) -> None:
        self._events.clear()
        self._backoffs = _default_backoffs()


class NonePolicy(FailureAccrualPolicy):
    """kind none: never mark dead."""

    def record_success(self) -> None:
        pass

    def record_failure(self) -> Optional[float]:
        return None

    def revived(self) -> None:
        pass


class FailureAccrualService(Service):
    """Wraps one endpoint service with accrual state.

    States: alive -> dead (Status.BUSY, until deadline) -> probing (one
    request admitted) -> alive | dead again.
    """

    def __init__(self, underlying: Service, policy: FailureAccrualPolicy):
        self._svc = underlying
        self._policy = policy
        self._dead_until: Optional[float] = None
        self._probing = False

    @property
    def status(self) -> Status:
        if self._dead_until is not None:
            if time.monotonic() >= self._dead_until and not self._probing:
                return Status.OPEN  # eligible for one probe
            return Status.BUSY
        return self._svc.status

    async def __call__(self, req):
        probing = False
        if self._dead_until is not None:
            if time.monotonic() >= self._dead_until and not self._probing:
                self._probing = True
                probing = True
            # else: balancer shouldn't have picked us, but serve anyway
            # rather than fail the request (ref: markDeadOnFailure is
            # advisory for the balancer, not a hard gate)
        try:
            rsp = await self._svc(req)
        except Exception:
            # l5d: ignore[await-atomicity] — advisory probe state machine: only the task that WON the pre-await probe slot mutates the backoff schedule; concurrent stampede writes of _dead_until are deliberate (see class docstring)
            self._on_failure(probing)
            raise
        status = getattr(rsp, "status", 200)
        if isinstance(status, int) and status >= 500:
            self._on_failure(probing)
        else:
            self._on_success(probing)
        return rsp

    def _on_success(self, probing: bool) -> None:
        if probing or self._dead_until is not None:
            self._policy.revived()
            self._dead_until = None
            self._probing = False
        self._policy.record_success()

    def _on_failure(self, probing: bool) -> None:
        dead_for = self._policy.record_failure()
        if probing:
            # failed probe: back off again
            self._probing = False
            dead_for = dead_for if dead_for is not None else 5.0
        if dead_for is not None:
            self._dead_until = time.monotonic() + dead_for

    async def close(self) -> None:
        await self._svc.close()


# -- config kinds ------------------------------------------------------------


@register("failureAccrual", "io.l5d.consecutiveFailures")
@dataclass
class ConsecutiveFailuresConfig:
    """Mark an endpoint dead after ``failures`` consecutive failures
    (the reference default policy)."""

    failures: int = 5

    def mk(self) -> FailureAccrualPolicy:
        return ConsecutiveFailuresPolicy(self.failures)


@register("failureAccrual", "io.l5d.successRate")
@dataclass
class SuccessRateConfig:
    """Mark dead when the EWMA success rate over the last
    ``requests`` requests drops below ``successRate``."""

    successRate: float = 0.8
    requests: int = 30

    def mk(self) -> FailureAccrualPolicy:
        return SuccessRatePolicy(self.successRate, self.requests)


@register("failureAccrual", "io.l5d.successRateWindowed")
@dataclass
class SuccessRateWindowedConfig:
    """Mark dead when the success rate over a ``window``-second
    rolling window drops below ``successRate``."""

    successRate: float = 0.8
    window: int = 30

    def mk(self) -> FailureAccrualPolicy:
        return SuccessRateWindowedPolicy(self.successRate, float(self.window))


@register("failureAccrual", "none")
@dataclass
class NoneConfig:
    def mk(self) -> FailureAccrualPolicy:
        return NonePolicy()


class FailFastService(Service):
    """finagle-style fail-fast on CONNECT failures: a connection-level
    failure marks this endpoint Busy with exponentially backed-off
    probing (1s doubling to 30s), so the balancer steers around a down
    host between probes (ref: FailFastFactory via ClientConfig.failFast;
    disabled by default for routers, Router.scala:374).

    Distinct from failure accrual, which reacts to RESPONSE outcomes —
    this reacts only to ConnectionError (the request never made it out).
    """

    _MIN_BACKOFF_S = 1.0
    _MAX_BACKOFF_S = 30.0

    def __init__(self, underlying: Service):
        self._svc = underlying
        self._down_until: Optional[float] = None
        self._backoff_s = self._MIN_BACKOFF_S
        self._probing = False

    @property
    def status(self) -> Status:
        if self._down_until is not None:
            if time.monotonic() >= self._down_until and not self._probing:
                return Status.OPEN  # one probe may go
            return Status.BUSY
        return self._svc.status

    async def __call__(self, req):
        probing = False
        if self._down_until is not None:
            if time.monotonic() >= self._down_until and not self._probing:
                self._probing = True
                probing = True
        try:
            rsp = await self._svc(req)
        except ConnectionError:
            now = time.monotonic()
            if probing:
                # a FAILED PROBE advances the backoff; concurrent
                # in-flight failures from one outage event must not
                # each double it
                self._probing = False  # l5d: ignore[await-atomicity] — only the task that won the pre-await probe slot (probing=True, claimed atomically) releases it
                self._backoff_s = min(self._backoff_s * 2,
                                      self._MAX_BACKOFF_S)
                self._down_until = now + self._backoff_s  # l5d: ignore[await-atomicity] — probe-slot holder owns the backoff schedule; non-probe stampede writes take the elif arm by design
            elif self._down_until is None:
                self._down_until = now + self._backoff_s
            raise
        except asyncio.CancelledError:
            if probing:
                # outcome unknown: release the probe slot (the expired
                # deadline admits the next probe) without reviving
                self._probing = False
            raise
        except Exception:
            if probing:
                self._probing = False
                self._revive()
            raise  # non-connect failure: the host is reachable
        if probing or self._down_until is not None:
            self._probing = False
            self._revive()
        return rsp

    def _revive(self) -> None:
        self._down_until = None
        self._backoff_s = self._MIN_BACKOFF_S

    async def close(self) -> None:
        await self._svc.close()
