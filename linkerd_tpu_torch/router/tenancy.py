"""Tenant identity, accounting, and isolation for the Python data plane:
a copy of ``linkerd_tpu/router/tenancy.py``.

One abusive tenant — a retry storm, a slowloris, a connection-churn
flood — must degrade alone. The pieces here give the router a tenant
axis end to end:

- ``tenant_hash``: FNV-1a 32-bit over the tenant id's UTF-8 bytes,
  bit-identical to the C engines' ``l5dtg::tenant_hash``
  (native/tenant_guard.h; pinned by the parity test), so a tenant
  observed on the Python path and on the native fast path is the SAME
  key everywhere — stats, quotas, feature rows.

- ``TenantIdentifierSpec``: the ``tenantIdentifier`` router knob
  (header / pathSegment / sni extraction), mirrored in C by
  ``fp_set_tenant``/``fph2_set_tenant``.

- ``TenantTagFilter``: stamps ``req.ctx["tenant"]`` +
  ``req.ctx["tenant_hash"]`` at the server edge (before admission, so
  per-tenant sub-limits see it) and records each request's outcome into
  the board.

- ``TenantBoard``: bounded-cardinality per-tenant aggregates (request
  rate, error EWMA, anomaly-score EWMA, sheds) with an LRU bound so
  hostile tenant-id churn cannot grow memory. ``level()`` is the
  per-tenant anomaly level the quota governor consumes: the max of the
  tenant's error EWMA, its score EWMA (fed by the in-data-plane scorer
  through the engine's per-tenant stats), and a traffic-dominance
  signal that flags retry-storm-shaped floods before their errors land.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from linkerd_tpu_torch.router.service import Filter, Service

TENANT_KINDS = ("header", "pathSegment", "sni")


def tenant_hash(tenant_id: str) -> int:
    """FNV-1a 32-bit over the id's UTF-8 bytes; 0 is reserved for
    "no tenant", so a real id hashing to 0 folds to 1 (the C side does
    the same)."""
    h = 2166136261
    for b in tenant_id.encode("utf-8", "surrogateescape"):
        h ^= b
        h = (h * 16777619) & 0xFFFFFFFF
    return h if h != 0 else 1


def tenant_feature(h: int) -> float:
    """The feature-row encoding: hash folded to 24 bits (f32-exact)."""
    return float(h & 0xFFFFFF)


@dataclass
class TenantIdentifierSpec:
    """The ``tenantIdentifier`` router block."""

    kind: str = "header"
    header: str = "l5d-tenant"
    segment: int = 0

    def validate(self, where: str = "tenantIdentifier") -> None:
        if self.kind not in TENANT_KINDS:
            raise ValueError(
                f"{where}.kind must be one of {TENANT_KINDS}, "
                f"got {self.kind!r}")
        if self.kind == "header" and not self.header:
            raise ValueError(f"{where}.header must be non-empty")
        if self.kind == "pathSegment" and self.segment < 0:
            raise ValueError(f"{where}.segment must be >= 0")

    def extract(self, req) -> Optional[str]:
        """Tenant id of one request (http Request or h2 H2Request), or
        None. Mirrors the engines' C extraction."""
        if self.kind == "header":
            v = req.headers.get(self.header)
            return v or None
        if self.kind == "pathSegment":
            # http carries the path in .uri, h2 in .path
            path = getattr(req, "uri", None)
            if path is None:
                path = getattr(req, "path", "") or ""
            path = path.split("?", 1)[0]
            segs = [s for s in path.split("/") if s]
            if self.segment < len(segs):
                return segs[self.segment]
            return None
        # sni: the transport stamps it (TLS servers put the server name
        # in ctx before the stack runs); absent on cleartext conns
        v = req.ctx.get("sni") if hasattr(req, "ctx") else None
        return v or None


@dataclass
class _TenantState:
    requests: int = 0          # total observed
    window_count: int = 0      # requests in the current dominance window
    prev_window: int = 0       # last completed window's count
    sheds: int = 0
    errors: int = 0
    err_ewma: float = 0.0
    score_ewma: float = 0.0
    score_seen: bool = False
    last_seen: float = 0.0
    thash: int = 0


class TenantBoard:
    """Bounded per-tenant aggregates + the per-tenant anomaly level.

    Thread-safe (the fastpath stats loop and the event loop both feed
    it). Levels are in [0, 1]:

    - error EWMA: per-request 1/0 error observations, alpha-smoothed;
    - score EWMA: ingested from the engines' in-plane per-tenant score
      aggregates (or observed directly when a score is known);
    - dominance: the tenant's share of the last completed traffic
      window beyond its fair share, ramped to 1.0 at total monopoly —
      a retry storm reads storm-shaped before its errors even land.

    Cardinality is bounded: beyond ``max_tenants``, the least-recently
    seen quarter is evicted in one pass (amortized O(1) per insert).
    """

    def __init__(self, alpha: float = 0.1, window_s: float = 1.0,
                 max_tenants: int = 1024, fair_share_burst: float = 4.0,
                 min_window_volume: int = 20):
        self.alpha = alpha
        self.window_s = window_s
        self.max_tenants = max(1, int(max_tenants))
        self.fair_share_burst = fair_share_burst
        self.min_window_volume = min_window_volume
        self.evicted = 0
        self._mu = threading.Lock()
        self._t: Dict[str, _TenantState] = {}
        self._window_start = 0.0
        self._prev_total = 0

    def _get(self, tenant: str, now: float) -> _TenantState:
        ts = self._t.get(tenant)
        if ts is None:
            if len(self._t) >= self.max_tenants:
                self._evict()
            ts = self._t[tenant] = _TenantState(thash=tenant_hash(tenant))
        ts.last_seen = now
        return ts

    def _evict(self) -> None:
        ages = sorted((ts.last_seen, key) for key, ts in self._t.items())
        k = max(1, len(ages) // 4)
        for _, key in ages[:k]:
            del self._t[key]
        self.evicted += k

    def _rotate(self, now: float) -> None:
        if now - self._window_start < self.window_s:
            return
        total = 0
        for ts in self._t.values():
            ts.prev_window = ts.window_count
            ts.window_count = 0
            total += ts.prev_window
        self._prev_total = total
        self._window_start = now

    def observe(self, tenant: str, error: bool,
                score: Optional[float] = None,
                now: Optional[float] = None) -> None:
        """One Python-path request outcome for a tenant."""
        now = time.monotonic() if now is None else now
        with self._mu:
            self._rotate(now)
            ts = self._get(tenant, now)
            ts.requests += 1
            ts.window_count += 1
            if error:
                ts.errors += 1
            ts.err_ewma += self.alpha * ((1.0 if error else 0.0)
                                         - ts.err_ewma)
            if score is not None:
                ts.score_seen = True
                ts.score_ewma += self.alpha * (float(score)
                                               - ts.score_ewma)

    def observe_shed(self, tenant: str,
                     now: Optional[float] = None) -> None:
        now = time.monotonic() if now is None else now
        with self._mu:
            ts = self._get(tenant, now)
            ts.sheds += 1

    def ingest_native(self, thash: int, requests: int, errors: int,
                      sheds: int, score_ewma: Optional[float],
                      scored: int, now: Optional[float] = None) -> None:
        """Fold one stats-poll DELTA of an engine's per-tenant
        aggregates into the board (FastPathController calls this each
        stats tick). Engine tenants are keyed ``#<hash>`` — the id is
        never on the wire in reverse."""
        now = time.monotonic() if now is None else now
        key = f"#{thash:08x}"
        with self._mu:
            self._rotate(now)
            ts = self._get(key, now)
            ts.thash = thash
            ts.requests += requests
            ts.window_count += requests
            ts.errors += errors
            ts.sheds += sheds
            if requests > 0:
                err_rate = min(1.0, errors / requests)
                ts.err_ewma += self.alpha * (err_rate - ts.err_ewma)
            if score_ewma is not None and scored > 0:
                ts.score_seen = True
                ts.score_ewma = float(score_ewma)

    def _dominance(self, ts: _TenantState) -> float:
        total = self._prev_total
        n = len(self._t)
        if total < self.min_window_volume or n < 2:
            return 0.0
        fair = 1.0 / n
        share = ts.prev_window / total
        start = min(0.95, fair * self.fair_share_burst)
        if share <= start:
            return 0.0
        return min(1.0, (share - start) / max(1e-6, 1.0 - start))

    def level(self, tenant: str) -> float:
        """The tenant's anomaly level in [0, 1] (0 for unknown)."""
        with self._mu:
            ts = self._t.get(tenant)
            if ts is None:
                return 0.0
            return max(ts.err_ewma,
                       ts.score_ewma if ts.score_seen else 0.0,
                       self._dominance(ts))

    def active_tenants(self) -> List[str]:
        with self._mu:
            return list(self._t.keys())

    def hash_of(self, tenant: str) -> int:
        with self._mu:
            ts = self._t.get(tenant)
            return ts.thash if ts is not None else tenant_hash(tenant)

    def snapshot(self) -> Dict[str, dict]:
        """Per-tenant state for /tenants.json."""
        with self._mu:
            return {
                key: {
                    "hash": ts.thash,
                    "requests": ts.requests,
                    "sheds": ts.sheds,
                    "errors": ts.errors,
                    "err_ewma": round(ts.err_ewma, 4),
                    "score_ewma": round(ts.score_ewma, 4)
                    if ts.score_seen else None,
                    "level": round(max(
                        ts.err_ewma,
                        ts.score_ewma if ts.score_seen else 0.0,
                        self._dominance(ts)), 4),
                }
                for key, ts in self._t.items()
            }


class TenantTagFilter(Filter):
    """Server-edge filter: extract + stamp the tenant, record the
    outcome, and (optionally) drive the quota governor's opportunistic
    step so per-tenant quotas work without a control loop.

    Sits BEFORE AdmissionControlFilter in the stack — the admission
    filter's per-tenant sub-limits read ``ctx["tenant_hash"]``."""

    def __init__(self, spec: TenantIdentifierSpec, board: TenantBoard,
                 stepper: Optional[Callable[[], None]] = None):
        self.spec = spec
        self.board = board
        self._stepper = stepper

    async def apply(self, req, service: Service):
        tenant = self.spec.extract(req)
        if tenant is not None:
            req.ctx["tenant"] = tenant
            req.ctx["tenant_hash"] = tenant_hash(tenant)
        if self._stepper is not None:
            self._stepper()
        if tenant is None:
            return await service(req)
        status = 0
        exc = None
        try:
            rsp = await service(req)
            status = getattr(rsp, "status", 0) or 0
            return rsp
        except BaseException as e:
            exc = e
            raise
        finally:
            from linkerd_tpu_torch.router.admission import OverloadShed
            if isinstance(exc, OverloadShed):
                self.board.observe_shed(tenant)
            else:
                self.board.observe(tenant,
                                   error=exc is not None or status >= 500)
