"""Hysteresis state machine shared by every control-loop actuator: a copy of
``linkerd_tpu/control/state.py``.

A reactive mesh must never flap: an anomaly score oscillating around a
single threshold would publish and revert a dtab override on every
crossing, which is strictly worse than doing nothing (connection churn,
retry storms, cold caches on both clusters). Three guards compose here:

- **split thresholds** — a key trips at ``enter`` but only clears back
  at ``exit`` (< enter), so scores wandering between the two change
  nothing;
- **quorum** — a transition needs ``quorum`` *consecutive* observations
  on the far side of its threshold; a single spiky batch resets the
  streak, sustained sickness does not;
- **dwell** — after any transition the key holds its new state for at
  least ``dwell_s`` regardless of observations (the cooldown between
  actuations), bounding the actuation rate even under adversarial
  score sequences.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, Optional

HEALTHY = "healthy"
SICK = "sick"


@dataclass
class KeyState:
    """Per-key governor state (one key per cluster / endpoint)."""

    state: str = HEALTHY
    streak: int = 0            # consecutive observations past the
    #                            opposite threshold
    changed_at: float = 0.0    # monotonic instant of the last transition
    level: float = 0.0         # last observed level (for /control.json)
    transitions: int = 0


class HysteresisGovernor:
    """Maps a stream of per-key anomaly levels to flap-free
    HEALTHY/SICK verdicts (see module docstring for the three guards).

    ``observe`` is the only mutator; it returns the key's state *after*
    folding in this observation, so callers can act on the edge by
    comparing against their own notion of what is currently actuated.
    """

    def __init__(self, enter: float = 0.7, exit: float = 0.3,
                 quorum: int = 3, dwell_s: float = 2.0):
        if not 0.0 < exit < enter <= 1.0:
            raise ValueError(
                f"thresholds must satisfy 0 < exit < enter <= 1 "
                f"(got enter={enter}, exit={exit})")
        if quorum < 1:
            raise ValueError("quorum must be >= 1")
        if dwell_s < 0:
            raise ValueError("dwell_s must be >= 0")
        self.enter = enter
        self.exit = exit
        self.quorum = quorum
        self.dwell_s = dwell_s
        self._keys: Dict[str, KeyState] = {}

    def observe(self, key: str, level: float,
                now: Optional[float] = None) -> str:
        now = time.monotonic() if now is None else now
        ks = self._keys.get(key)
        if ks is None:
            ks = self._keys[key] = KeyState(changed_at=now)
        ks.level = level
        if ks.state == HEALTHY:
            ks.streak = ks.streak + 1 if level >= self.enter else 0
        else:
            ks.streak = ks.streak + 1 if level <= self.exit else 0
        if (ks.streak >= self.quorum
                and now - ks.changed_at >= self.dwell_s):
            ks.state = SICK if ks.state == HEALTHY else HEALTHY
            ks.streak = 0
            ks.changed_at = now
            ks.transitions += 1
        return ks.state

    def state_of(self, key: str) -> str:
        ks = self._keys.get(key)
        return ks.state if ks is not None else HEALTHY

    def forget(self, key: str) -> None:
        """Drop a key's state entirely (it re-enters HEALTHY with a
        fresh streak if observed again). Callers with unbounded key
        spaces — per-tenant governors under hostile tenant-id churn —
        MUST forget keys their own bounded stores evicted, or the
        governor grows without bound."""
        self._keys.pop(key, None)

    def keys(self):
        return list(self._keys)

    def snapshot(self) -> Dict[str, dict]:
        """{key: {state, level, streak, transitions}} for /control.json."""
        return {
            key: {
                "state": ks.state,
                "level": round(ks.level, 4),
                "streak": ks.streak,
                "transitions": ks.transitions,
            }
            for key, ks in self._keys.items()
        }
