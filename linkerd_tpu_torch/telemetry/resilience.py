"""Scorer-path graceful degradation: deadlines and circuit breaking, a
copy of ``linkerd_tpu/telemetry/resilience.py``.

The anomaly telemeter must never become a failure domain of the data
plane it protects: a hung scorer sidecar costs the drain loop one
bounded call, not a wedge. ``ResilientScorer`` wraps any scorer (in
practice the sidecar client or its replica pool) with a per-call
deadline and a ``CircuitBreaker``: after ``failures`` consecutive
failures the breaker opens and calls fail fast with
``ScorerUnavailable``; after each jittered backoff one probe call is
admitted, and its success closes the breaker. The telemeter maps
``ScorerUnavailable`` to degraded mode (``anomaly/degraded`` reads 1,
the board reads neutral) until a probe succeeds.
"""

from __future__ import annotations

import asyncio
import time
from typing import Iterator, Optional, Tuple

import numpy as np


def _jittered_backoffs(min_s: float, max_s: float) -> Iterator[float]:
    """Jittered exponential probe schedule (the failure-accrual
    _default_backoffs idiom, with configurable bounds)."""
    import random
    cur = min_s
    while True:
        yield random.uniform(cur / 2, cur)
        cur = min(max_s, cur * 2)


class ScorerUnavailable(Exception):
    """The scorer call failed or was refused by the open breaker; the
    caller should degrade (skip scoring), never block or crash."""


class CircuitBreaker:
    """closed -> open (after ``failures`` consecutive failures) ->
    half-open (one probe per backoff interval) -> closed | open.

    Concurrent in-flight failures from a single outage advance the
    consecutive count but open the breaker only once; a failed PROBE is
    what advances the backoff schedule (mirrors FailFastService)."""

    def __init__(self, failures: int = 3, min_backoff_s: float = 0.5,
                 max_backoff_s: float = 30.0, backoffs=None):
        if failures < 1:
            raise ValueError("failures must be >= 1")
        self.failures = failures
        self._mk_backoffs = ((lambda: backoffs) if backoffs is not None
                             else lambda: _jittered_backoffs(
                                 min_backoff_s, max_backoff_s))
        self._backoffs = self._mk_backoffs()
        self._consecutive = 0
        self._open_until: Optional[float] = None
        self._probing = False

    @property
    def state(self) -> str:
        if self._open_until is None:
            return "closed"
        if self._probing:
            return "half_open"
        if time.monotonic() >= self._open_until:
            return "half_open"  # a probe slot is available
        return "open"

    def next_probe_in_s(self) -> float:
        """Seconds until the next probe slot opens (0 when available or
        the breaker is closed)."""
        if self._open_until is None:
            return 0.0
        return max(0.0, self._open_until - time.monotonic())

    def acquire(self) -> Tuple[bool, bool]:
        """-> (admitted, is_probe). While open, only the single probe
        slot per backoff interval admits."""
        if self._open_until is None:
            return True, False
        if time.monotonic() >= self._open_until and not self._probing:
            self._probing = True
            return True, True
        return False, False

    def on_success(self, probe: bool) -> None:
        if probe or self._open_until is not None:
            self._open_until = None
            self._probing = False
            self._backoffs = self._mk_backoffs()
        self._consecutive = 0

    def on_failure(self, probe: bool) -> None:
        self._consecutive += 1
        if probe:
            # the failed probe advances the schedule; concurrent
            # non-probe failures from one outage must not
            self._probing = False
            self._open_until = time.monotonic() + next(self._backoffs)
        elif self._open_until is None \
                and self._consecutive >= self.failures:
            self._open_until = time.monotonic() + next(self._backoffs)

    def on_cancel(self, probe: bool) -> None:
        """Outcome unknown: release the probe slot without reviving."""
        if probe:
            self._probing = False


class ResilientScorer:
    """Wraps ``inner`` (typically GrpcScorerClient) with per-call
    deadlines and a circuit breaker. ``score``/``fit`` raise
    ScorerUnavailable on any failure or refusal; lifecycle hooks
    (snapshot/restore/swap/warmup) delegate untouched via __getattr__,
    preserving the inner hook's sync/async nature for the lifecycle
    manager's ``_call_scorer`` dispatch. Deliberately NOT a Scorer
    subclass: the base class's concrete snapshot/restore stubs would
    shadow the delegation (``__getattr__`` only fires on failed
    lookups)."""

    def __init__(self, inner, call_timeout_s: float = 2.0,
                 breaker: Optional[CircuitBreaker] = None):
        self._inner = inner
        self.call_timeout_s = call_timeout_s
        self.breaker = breaker if breaker is not None else CircuitBreaker()

    def __getattr__(self, name):
        if name == "_inner":  # guard re-entrancy before __init__ ran
            raise AttributeError(name)
        return getattr(self._inner, name)

    async def _guarded(self, what: str, coro):
        admitted, probe = self.breaker.acquire()
        if not admitted:
            coro.close()  # refused before dispatch: don't leak the coroutine
            raise ScorerUnavailable(
                f"{what}: breaker open, next probe in "
                f"{self.breaker.next_probe_in_s():.2f}s")
        try:
            rsp = await asyncio.wait_for(coro, self.call_timeout_s)
        except asyncio.CancelledError:
            self.breaker.on_cancel(probe)
            raise
        except Exception as e:  # noqa: BLE001 — degradation boundary:
            # every failure kind (deadline, transport, codec) becomes
            # the one signal the telemeter degrades on
            self.breaker.on_failure(probe)
            raise ScorerUnavailable(f"{what} failed: {e!r}") from e
        self.breaker.on_success(probe)
        return rsp

    async def score(self, x: np.ndarray) -> np.ndarray:
        return await self._guarded("score", self._inner.score(x))

    async def fit(self, x: np.ndarray, labels: np.ndarray,
                  mask: np.ndarray) -> float:
        return await self._guarded("fit", self._inner.fit(x, labels, mask))

    def close(self) -> None:
        self._inner.close()
