"""Scorer replicas as a service, a copy of
``linkerd_tpu/fleet/scorer_pool.py``.

Replicas announce themselves through a namer (an fs-announced sidecar is
resolved by the fs namer like any service), the linker resolves the
replica set, and ``ScorerReplicaPool`` spreads score and fit calls over
it: least calls in flight, and one failover to another replica within
the same call. ``sidecarAddress`` names the set:

- ``"host:p1,host:p2"``, a fixed list;
- ``"/#/io.l5d.fs/l5d-scorer"``, a namer path the linker resolves
  against its namers; the pool then follows the live replica set.

The pool sits inside ``ResilientScorer``, so the per-call deadline, the
breaker and degraded mode are unchanged: the pool only chooses the
replica a call lands on.
"""

from __future__ import annotations

import asyncio
import logging
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

log = logging.getLogger(__name__)


@dataclass
class _Replica:
    scorer: object
    inflight: int = 0
    calls: int = 0
    failures: int = 0
    last_error: Optional[str] = field(default=None)


def _default_mk_client(address: str):
    from linkerd_tpu_torch.telemetry.sidecar import GrpcScorerClient
    return GrpcScorerClient(address)


class ScorerReplicaPool:
    """Least-in-flight scorer load balancer over a live replica set.

    Implements the Scorer call surface (score/fit + async
    snapshot/restore passthrough) so it drops into every place a
    GrpcScorerClient fits. ``set_addresses`` diffs the replica set —
    existing clients (and their warm gRPC channels) survive membership
    churn around them."""

    def __init__(self, addresses: Sequence[str] = (),
                 mk_client: Callable[[str], object] = _default_mk_client):
        self._mk_client = mk_client
        self._replicas: Dict[str, _Replica] = {}
        self._rr = 0
        self.last_timing: Optional[dict] = None
        self._watch_task: Optional[asyncio.Task] = None
        self._watch_source = None
        self.set_addresses(addresses)

    # -- membership --------------------------------------------------------
    def set_addresses(self, addresses: Sequence[str]) -> None:
        want = [a.strip() for a in addresses if a and a.strip()]
        gone = [a for a in self._replicas if a not in want]
        for a in gone:
            rep = self._replicas.pop(a)
            self._close_client(rep.scorer)
        for a in want:
            if a not in self._replicas:
                self._replicas[a] = _Replica(self._mk_client(a))
        if gone or len(want) != len(self._replicas):
            log.info("scorer pool membership: %s", sorted(self._replicas))

    def addresses(self) -> List[str]:
        return sorted(self._replicas)

    @staticmethod
    def _close_client(scorer) -> None:
        closer = getattr(scorer, "close", None)
        if closer is None:
            return
        try:
            closer()
        except Exception:  # noqa: BLE001 — a failing close on a dead
            # replica must not break membership updates
            log.debug("scorer replica close failed", exc_info=True)

    # -- dynamic resolution (namer path mode) ------------------------------
    def attach_activity(self, activity, poll_interval_s: float = 1.0) -> None:
        """Track a namer lookup's Activity[NameTree]: the first bound
        leaf's address set becomes the replica set (polled — the same
        cadence class as the fs namer's own file polling). Call
        ``start_watch`` from a running loop to begin."""
        self._watch_source = (activity, poll_interval_s)

    def start_watch(self) -> None:
        if self._watch_source is None or self._watch_task is not None:
            return
        from linkerd_tpu_torch.core.tasks import monitor
        self._watch_task = asyncio.get_running_loop().create_task(
            self._watch_loop(), name="scorer-pool-watch")
        monitor(self._watch_task, what="scorer-pool-watch")

    async def _watch_loop(self) -> None:
        activity, interval = self._watch_source
        while True:
            try:
                self.set_addresses(self._resolve_addresses(activity))
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001 — resolution trouble
                # keeps the LAST known replica set serving
                log.debug("scorer pool resolution failed: %r", e)
            await asyncio.sleep(interval)

    @staticmethod
    def _resolve_addresses(activity) -> List[str]:
        from linkerd_tpu_torch.core.activity import Ok
        from linkerd_tpu_torch.core.addr import Bound
        st = activity.current
        if not isinstance(st, Ok):
            return []
        leaf = _first_bound_leaf(st.value)
        if leaf is None:
            return []
        addr = leaf.addr.sample()
        if not isinstance(addr, Bound):
            return []
        return sorted(f"{a.host}:{a.port}" for a in addr.addresses)

    # -- picking -----------------------------------------------------------
    def _pick(self, exclude: Sequence[str] = ()) -> Optional[str]:
        candidates = [(rep.inflight, i, a)
                      for i, (a, rep) in enumerate(self._replicas.items())
                      if a not in exclude]
        if not candidates:
            return None
        self._rr += 1
        # least-in-flight; round-robin rotation breaks ties so idle
        # replicas share load instead of the dict-order first soaking it
        candidates.sort(key=lambda t: (t[0], (t[1] + self._rr)
                                       % max(1, len(self._replicas))))
        return candidates[0][2]

    async def _call(self, op: str, *args):
        """Run ``op`` on the least-loaded replica; one failover attempt
        to a different replica before the failure propagates (the
        outer ResilientScorer breaker counts what escapes here)."""
        tried: List[str] = []
        last: Optional[Exception] = None
        for _ in range(2):
            addr = self._pick(exclude=tried)
            if addr is None:
                break
            rep = self._replicas[addr]
            rep.inflight += 1
            rep.calls += 1
            try:
                out = await getattr(rep.scorer, op)(*args)
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001 — per-replica
                # failover boundary: remember and try one peer
                rep.failures += 1
                rep.last_error = repr(e)
                last = e
                tried.append(addr)
                continue
            finally:
                rep.inflight -= 1
            self.last_timing = getattr(rep.scorer, "last_timing", None)
            return out
        if last is not None:
            raise last
        raise RuntimeError("scorer pool has no replicas")

    # -- fleet model coordination ------------------------------------------
    async def broadcast_restore(self, snap,
                                per_call_timeout_s: float = 20.0) -> int:
        """Push one ModelSnapshot to EVERY replica (not a balanced
        pick): the fleet model-coordination path — when this linkerd
        promotes a model, every announced fallback scorer restores the
        same generation the in-plane bank serves. The pushes run
        CONCURRENTLY with a per-replica timeout, so one hung replica
        (black-holed address: grpc connects lazily and would otherwise
        sit on its long RPC deadline) delays nothing and every healthy
        peer still restores. Per-replica failures are logged and
        skipped (a dead replica catches up on its next restore);
        returns how many replicas restored."""
        async def push(addr: str, rep: _Replica) -> bool:
            rep.inflight += 1
            rep.calls += 1
            try:
                await asyncio.wait_for(rep.scorer.restore(snap),
                                       per_call_timeout_s)
                return True
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001 — one dead replica
                # must not block the fleet-wide model push
                rep.failures += 1
                rep.last_error = repr(e)
                log.warning("fleet model push to scorer replica %s "
                            "failed: %r", addr, e)
                return False
            finally:
                rep.inflight -= 1

        results = await asyncio.gather(
            *(push(addr, rep)
              for addr, rep in list(self._replicas.items())))
        return sum(1 for ok in results if ok)

    # -- Scorer surface ----------------------------------------------------
    async def score(self, x: np.ndarray) -> np.ndarray:
        return await self._call("score", x)

    async def fit(self, x: np.ndarray, labels: np.ndarray,
                  mask: np.ndarray) -> float:
        return await self._call("fit", x, labels, mask)

    async def snapshot(self):
        return await self._call("snapshot")

    async def restore(self, snap):
        return await self._call("restore", snap)

    def status(self) -> dict:
        return {
            "replicas": {
                a: {"inflight": r.inflight, "calls": r.calls,
                    "failures": r.failures, "last_error": r.last_error}
                for a, r in sorted(self._replicas.items())
            },
            "watching": self._watch_source is not None,
        }

    def close(self) -> None:
        if self._watch_task is not None:
            self._watch_task.cancel()
            self._watch_task = None
        for rep in self._replicas.values():
            self._close_client(rep.scorer)
        self._replicas.clear()


def _first_bound_leaf(tree):
    from linkerd_tpu_torch.core.nametree import Leaf
    if isinstance(tree, Leaf):
        v = tree.value
        return v if hasattr(v, "addr") else None
    for sub in getattr(tree, "trees", ()):
        found = _first_bound_leaf(sub)
        if found is not None:
            return found
    for w in getattr(tree, "weighted", ()):
        found = _first_bound_leaf(w.tree)
        if found is not None:
            return found
    return None


def namer_scorer_activity(namers, path_str: str):
    """Resolve a ``/#/<namer>/<name>`` scorer path against the linker's
    configured namers; returns the lookup Activity (caller closes it).
    Raises ValueError when no configured namer covers the path — a
    misconfigured scorer address must fail assembly loudly, not leave a
    silent always-empty pool."""
    from linkerd_tpu_torch.core import Path
    path = Path.read(path_str)
    if len(path) < 2 or path[0] != "#":
        raise ValueError(
            f"scorer address path must look like /#/<namer>/<name>, "
            f"got {path_str!r}")
    rest = path.drop(1)
    for prefix, namer in namers:
        if rest.starts_with(prefix):
            return namer.lookup(rest.drop(len(prefix)))
    raise ValueError(
        f"no configured namer covers scorer address {path_str!r} "
        f"(prefixes: {[p.show for p, _ in namers]})")
