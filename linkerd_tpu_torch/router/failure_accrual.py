"""Failure accrual policies: the ``FailureAccrualPolicy`` interface and
the default revival backoffs of ``linkerd_tpu/router/failure_accrual.py``.

A policy decides when an endpoint is unhealthy: ``record_failure``
returns the seconds to mark it dead, or None. The anomaly-aware policy
(``telemetry.anomaly.AnomalyFailureAccrualPolicy``) implements it; the
router that wraps endpoints in these policies is not ported yet.
"""

from __future__ import annotations

import abc
import random
from typing import Iterator, Optional


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
    cur = 5.0
    while True:
        yield random.uniform(cur / 2, cur)
        cur = min(300.0, cur * 2)
