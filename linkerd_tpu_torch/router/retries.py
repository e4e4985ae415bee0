"""Classified retries with budgets, and total timeout: a copy of
``linkerd_tpu/router/retries.py``.

Reference parity:
- ``RetryBudget`` — finagle's token-bucket retry budget (ttl-windowed
  deposits per request + a minimum retries-per-second floor; default 20%
  + 10 rps), configured by RetryBudgetModule/RetryBudgetConfig
  (router/core/.../RetryBudgetModule.scala).
- ``ClassifiedRetries`` — response-class-driven retry filter with a
  backoff schedule (router/core/.../ClassifiedRetries.scala:8), applied in
  the path stack.
- ``TotalTimeout`` — per-request end-to-end timeout including retries
  (router/core/.../TotalTimeout.scala).
"""

from __future__ import annotations

import asyncio
import time
from typing import Iterable, Iterator, List, Optional

from linkerd_tpu_torch.protocol.http.message import Request, Response
from linkerd_tpu_torch.router.classifiers import Classifier, ResponseClass
from linkerd_tpu_torch.router.deadline import deadline_of
from linkerd_tpu_torch.router.service import Filter, Service
from linkerd_tpu_torch.router.stages import staged
from linkerd_tpu_torch.telemetry.metrics import MetricsTree


class RetryBudget:
    """Sliding-window token bucket: each request deposits ``percent_can_retry``
    tokens; each retry withdraws one; ``min_retries_per_s`` is an unconditional
    floor (ref: com.twitter.finagle.service.RetryBudget defaults).

    O(1) per operation: deposits/withdrawals land in per-second buckets in
    a fixed ring of ceil(ttl)+1 slots; balance sums the ring (hot-path cost
    is ~ttl additions, independent of request rate).
    """

    def __init__(self, ttl_s: float = 10.0, min_retries_per_s: float = 10.0,
                 percent_can_retry: float = 0.2):
        self.ttl_s = ttl_s
        self.min_retries_per_s = min_retries_per_s
        self.percent_can_retry = percent_can_retry
        n = max(1, int(ttl_s) + 1)
        self._sec = [0] * n        # absolute second id owning each slot
        self._earned = [0.0] * n
        self._spent = [0.0] * n

    def _slot(self, now: float) -> int:
        sec = int(now)
        i = sec % len(self._sec)
        if self._sec[i] != sec:
            self._sec[i] = sec
            self._earned[i] = 0.0
            self._spent[i] = 0.0
        return i

    def deposit(self) -> None:
        i = self._slot(time.monotonic())
        self._earned[i] += self.percent_can_retry

    def balance(self) -> float:
        now = time.monotonic()
        self._slot(now)  # rotate the current slot
        cutoff = int(now) - int(self.ttl_s)
        earned = spent = 0.0
        for sec, e, s in zip(self._sec, self._earned, self._spent):
            if sec >= cutoff:
                earned += e
                spent += s
        floor = self.min_retries_per_s * self.ttl_s
        return max(earned, floor) - spent

    def try_withdraw(self) -> bool:
        if self.balance() < 1.0:
            return False
        i = self._slot(time.monotonic())
        self._spent[i] += 1.0
        return True


def backoff_jittered(min_s: float, max_s: float) -> Iterator[float]:
    """Decorrelated-jitter backoff stream (ref: SvcConfig retries backoff
    kind 'jittered')."""
    import random
    cur = min_s
    while True:
        yield cur
        cur = min(max_s, random.uniform(min_s, cur * 3))


def backoff_constant(pause_s: float) -> Iterator[float]:
    while True:
        yield pause_s


class ClassifiedRetries(Filter[Request, Response]):
    """Re-dispatches retryable failures per the classifier, bounded by the
    budget and the backoff schedule."""

    def __init__(self, classifier: Classifier,
                 budget: Optional[RetryBudget] = None,
                 backoffs: Optional[Iterable[float]] = None,
                 max_retries: int = 25,
                 metrics: Optional[MetricsTree] = None,
                 scope: tuple = ()):
        self._classifier = classifier
        self._budget = budget if budget is not None else RetryBudget()
        self._backoffs = list(backoffs) if backoffs is not None else [0.0] * 25
        self._max_retries = max_retries
        node = (metrics.scope(*scope, "retries") if metrics is not None
                else MetricsTree().scope("retries"))
        self._retry_count = node.counter("total")
        self._budget_exhausted = node.counter("budget_exhausted")
        self._deadline_skipped = node.counter("deadline_skipped")

    async def apply(self, req: Request, service: Service) -> Response:
        self._budget.deposit()
        attempt = 0
        while True:
            rsp: Optional[Response] = None
            exc: Optional[BaseException] = None
            try:
                rsp = await service(req)
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001 — classified below
                exc = e
            rc = self._classifier(req, rsp, exc)
            req.ctx["response_class"] = rc
            if not rc.is_retryable or attempt >= min(
                    self._max_retries, len(self._backoffs)):
                break
            pause = self._backoffs[attempt]
            dl = deadline_of(req)
            if dl is not None and pause >= dl.remaining_s():
                # the backoff alone would overrun the propagated budget:
                # serve the classified failure now instead of burning the
                # caller's remaining time on a doomed attempt
                self._deadline_skipped.incr()
                break
            if not self._budget.try_withdraw():
                self._budget_exhausted.incr()
                break
            attempt += 1
            self._retry_count.incr()
            if pause > 0:
                with staged(req, "retry"):
                    await asyncio.sleep(pause)
        if exc is not None:
            raise exc
        assert rsp is not None
        return rsp


class TotalTimeout(Filter[Request, Response]):
    """Caps total time (including retries) for a request
    (ref: TotalTimeout.scala; -> 504 via ErrorResponder)."""

    def __init__(self, timeout_s: float):
        self.timeout_s = timeout_s

    async def apply(self, req: Request, service: Service) -> Response:
        try:
            return await asyncio.wait_for(service(req), self.timeout_s)
        except asyncio.TimeoutError:
            raise TimeoutError(
                f"total timeout of {self.timeout_s}s exceeded") from None


class RequeueFilter(Filter[Request, Response]):
    """Client-layer requeues: a request that failed BEFORE a response
    began (connect refused, pool exhausted — surfaced as
    ConnectionError) retries immediately against the balancer, budgeted
    (ref: finagle Requeues via ClientConfig.requeueBudget). Sits ABOVE
    the balancer so each attempt re-picks an endpoint; write-failures
    after a response started are NOT requeued (the downstream may have
    processed the request)."""

    def __init__(self, budget: RetryBudget, max_requeues: int = 25,
                 metrics_scope=None):
        self._budget = budget
        self._max = max_requeues
        self._counter = (metrics_scope.counter("requeues")
                         if metrics_scope is not None else None)

    async def apply(self, req: Request, service: Service) -> Response:
        # one deposit per EXTERNAL request (like ClassifiedRetries) —
        # depositing per attempt would let requeues fund themselves
        self._budget.deposit()
        attempts = 0
        while True:
            try:
                return await service(req)
            except ConnectionError:
                attempts += 1
                if attempts > self._max or not self._budget.try_withdraw():
                    raise
                if self._counter is not None:
                    self._counter.incr()
