"""ControlConfig (the jaxAnomaly ``control:`` YAML block) + ControlLoop:
the port's counterpart of ``linkerd_tpu/control/loop.py``, in
single-instance mode.

One periodic driver owns all three actuators so their cadence, tracer,
metrics subtree, and admin surface stay coherent:

    telemetry:
    - kind: io.l5d.jaxAnomaly
      control:
        intervalMs: 100
        weightThreshold: 0.3        # balancer down-weighting ramp start
        weightFloor: 0.05           # sick replicas keep a probe trickle
        adaptiveAdmission: true
        admissionThreshold: 0.5
        admissionFloor: 0.25
        namespace: default          # namerd ns the reactor shifts
        namerdAddress: 127.0.0.1:4180   # its HTTP control API
        failover:                   # sick cluster -> where to shift
          /svc/web: /svc/web-b
        enterThreshold: 0.7
        exitThreshold: 0.3
        quorum: 3
        cooldownS: 2.0

Omitting ``failover``/``namespace`` disables the reactor; setting
``balancerWeighting``/``adaptiveAdmission`` false disables those
actuators — each is independent, all share the metrics subtree
(``control/*``).

``ControlConfig`` keeps every key and default of the reference's.
Fleet coordination (``fleet:``, ``regionFailover:``;
``linkerd_tpu/fleet/``) is not ported: naming either key raises
``ConfigError`` before the parser builds its value, and ``ControlLoop``
(as in the reference) leaves its fleet and region branches inert while
``fleet`` is None.
"""

from __future__ import annotations

import asyncio
import logging
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from linkerd_tpu_torch.config.parser import ConfigRefused
from linkerd_tpu_torch.core import Dtab

log = logging.getLogger(__name__)

# Keys of the reference's ``control:`` block that the port does not take
# yet, with the ROADMAP item that brings them. A config naming one is
# refused (``ConfigRefused``), not quietly run in single-instance mode.
REFUSED_KEYS = {
    "fleet": "ROADMAP Queue 1 item 14 (fleet coordination: "
             "linkerd_tpu/fleet/)",
    "regionFailover": "ROADMAP Queue 1 item 14 (fleet coordination: "
                      "linkerd_tpu/fleet/)",
}


@dataclass
class ControlConfig:
    """YAML ``control:`` block of the io.l5d.jaxAnomaly telemeter. Naming
    a key of ``REFUSED_KEYS`` raises ``ConfigError``."""

    intervalMs: int = 100
    # score-weighted balancing
    balancerWeighting: bool = True
    weightThreshold: float = 0.3
    weightFloor: float = 0.05
    # adaptive admission control
    adaptiveAdmission: bool = True
    admissionThreshold: float = 0.5
    admissionFloor: float = 0.25
    admissionAlpha: float = 0.3
    # mesh reactor (anomaly-triggered dtab overrides); requires
    # namespace + failover, and namerdAddress unless a store client is
    # injected programmatically (embedded namerd, tests, bench)
    namespace: Optional[str] = None
    namerdAddress: Optional[str] = None
    failover: Optional[Dict[str, str]] = None
    # hierarchical failover: sick cluster -> {peer region -> target};
    # the reactor shifts to the healthiest FRESH peer region's target
    # (fleet.region + region digests required), falling back to the
    # local ``failover`` entry when every peer region is stale or sick
    regionFailover: Optional[Dict[str, Dict[str, str]]] = None
    # partition tolerance: when the namerd store is unreachable, book
    # overrides in-process (LocalOverrideBook -> the routers' local
    # dtab seam) so a cut-off instance keeps actuating on the quorum
    # it can still see, and publish the book on heal
    localActuation: bool = True
    # failover binds are pre-warmed and re-touched on this cadence so
    # a partition-time booked override lands on an ALREADY-BOUND path
    # (new namerd binds fail mid-partition; warm ones hold last-good
    # state through the interpreter's bind activity)
    prewarmIntervalS: float = 120.0
    enterThreshold: float = 0.7
    exitThreshold: float = 0.3
    quorum: int = 3
    cooldownS: float = 2.0
    verifyOverrides: bool = True
    # bound on every reactor<->namerd store round-trip: a hung namerd
    # costs one timed-out step, never a wedged control loop
    storeTimeoutMs: int = 3000
    # cold-start guard: a fresh linker's UNTRAINED scorer reads most
    # traffic as anomalous (reconstruction error against random
    # weights); no actuator may fire until this many batches have been
    # scored (and, with online training on, learned from)
    warmupBatches: int = 50
    # fleet coordination (linkerd_tpu/fleet/): cross-instance score
    # exchange + quorum-gated actuation; None = single-instance mode
    # (refused by name: REFUSED_KEYS)
    fleet: Optional[dict] = None

    def __new__(cls, *args, **kwargs):
        refused = [k for k in kwargs if k in REFUSED_KEYS]
        if refused:
            raise ConfigRefused("; ".join(
                f"control key {k!r} is not supported by the port yet: "
                f"it comes with {REFUSED_KEYS[k]}" for k in refused))
        return super().__new__(cls)

    def mk(self, board, metrics, drift=None, namer_prefixes=None,
           ready_fn=None) -> "ControlLoop":
        return ControlLoop(self, board, metrics, drift=drift,
                           namer_prefixes=namer_prefixes,
                           ready_fn=ready_fn)


class ControlLoop:
    """Owns the actuators and drives them at ``intervalMs``. Built by
    the jaxAnomaly telemeter at assembly; the Linker registers balancers
    and admission filters into it while building routers; its ``run()``
    task rides alongside the telemeter's drain loop."""

    def __init__(self, cfg: ControlConfig, board, metrics, drift=None,
                 namer_prefixes=None, ready_fn=None):
        if cfg.intervalMs <= 0:
            raise ValueError("control.intervalMs must be > 0")
        if not 0.0 < cfg.weightFloor <= 1.0:
            raise ValueError("control.weightFloor must be in (0, 1]")
        if not 0.0 < cfg.weightThreshold < 1.0:
            raise ValueError("control.weightThreshold must be in (0, 1)")
        self.cfg = cfg
        self.board = board
        self.node = metrics.scope("control")
        self._stop = asyncio.Event()
        self._steps = self.node.counter("steps")
        # cold-start guard (see ControlConfig.warmupBatches); no gate
        # when unset (unit tests, boards fed out-of-band) or 0 batches
        self._ready_fn = ready_fn
        self._warmed = ready_fn is None or cfg.warmupBatches <= 0
        self.node.gauge("warmed_up",
                        fn=lambda: 1.0 if self._warmed else 0.0)
        self.weigher = None
        if cfg.balancerWeighting:
            from linkerd_tpu_torch.control.balancer import mk_weigher
            base_weigher = mk_weigher(board, cfg.weightThreshold,
                                      cfg.weightFloor)
            # warmup-gated: untrained scores must not skew picks either
            self.weigher = (lambda hostport:
                            base_weigher(hostport) if self._warmed
                            else 1.0)
        self.admission = None
        self._drift = drift
        if cfg.adaptiveAdmission:
            from linkerd_tpu_torch.control.admission import AdaptiveAdmission
            self.admission = AdaptiveAdmission(
                board, drift=drift, threshold=cfg.admissionThreshold,
                floor=cfg.admissionFloor, alpha=cfg.admissionAlpha,
                metrics_node=self.node.scope("admission"))
        # fleet exchange BEFORE the reactor: the reactor actuates on the
        # exchange's quorum levels, so it needs the exchange at build
        self.fleet = None
        if cfg.fleet is not None:
            store_client = None
            if cfg.namerdAddress:
                # the exchange gets its OWN HTTP client: its publish
                # cadence must never serialize behind a reactor CAS (nor
                # share a connection mid-teardown with it)
                from linkerd_tpu_torch.control.reactor import (
                    NamerdHttpStoreClient,
                )
                store_client = NamerdHttpStoreClient(cfg.namerdAddress)
            self.fleet = cfg.fleet.mk(
                store_client, metrics_node=self.node.scope("fleet"))
            # default doc source: the board's hottest dsts; replaced by
            # the reactor's cluster view when a reactor is configured
            self.fleet.set_source(
                self._board_levels, extras_fn=self._fleet_extras,
                warmed_fn=lambda: self._warmed)
        self.reactor = None
        self._reactor_prefixes = (list(namer_prefixes)
                                  if namer_prefixes is not None else None)
        if cfg.regionFailover and (
                cfg.fleet is None or not cfg.fleet.region):
            raise ValueError(
                "control.regionFailover requires a fleet block with a "
                "region (cross-region targets are chosen from peer "
                "region digests)")
        # the partition-time override book, shared between the reactor
        # (writer) and every router's RoutingService (readers via
        # local_dtab_for)
        self.local_book = None
        if cfg.localActuation and (cfg.failover or cfg.regionFailover):
            from linkerd_tpu_torch.control.reactor import LocalOverrideBook
            self.local_book = LocalOverrideBook()
        if cfg.failover or cfg.regionFailover:
            if not cfg.namespace:
                raise ValueError(
                    "control.failover/regionFailover requires "
                    "control.namespace")
            if cfg.namerdAddress:
                from linkerd_tpu_torch.control.reactor import (
                    NamerdHttpStoreClient,
                )
                self._mk_reactor(NamerdHttpStoreClient(cfg.namerdAddress))
            else:
                # embedded namerd / tests must inject a store via
                # set_store_client; until then the failover map is INERT
                # — loud, or an operator typo silently disables shifting
                log.warning(
                    "control.failover configured without namerdAddress: "
                    "the mesh reactor is DISABLED until a store client "
                    "is injected (set_store_client)")
        self._balancers: list = []
        self._tenant_admissions: list = []
        # failover-bind prewarmers registered by the Linker's routers
        # (one per router; called for every failover pair so partition-
        # time booked overrides route through already-warm binds)
        self._prewarmers: list = []
        self._last_prewarm: Optional[float] = None

    def _mk_reactor(self, client) -> None:
        from linkerd_tpu_torch.control.reactor import MeshReactor
        from linkerd_tpu_torch.control.state import HysteresisGovernor
        cfg = self.cfg
        self.reactor = MeshReactor(
            self.board, client, cfg.namespace, cfg.failover or {},
            governor=HysteresisGovernor(
                enter=cfg.enterThreshold, exit=cfg.exitThreshold,
                quorum=cfg.quorum, dwell_s=cfg.cooldownS),
            metrics_node=self.node.scope("reactor"),
            namer_prefixes=self._reactor_prefixes,
            verify=cfg.verifyOverrides,
            store_timeout_s=cfg.storeTimeoutMs / 1e3,
            fleet=self.fleet,
            region_failover=cfg.regionFailover,
            local_book=self.local_book)
        if self.fleet is not None:
            # the exchange publishes the reactor's LOCAL cluster view
            # (independent evidence — peers fold their own quorum), plus
            # which overrides this instance believes it holds
            reactor = self.reactor
            self.fleet.set_source(
                reactor.cluster_levels,
                overrides_fn=lambda: sorted(reactor.active),
                extras_fn=self._fleet_extras,
                warmed_fn=lambda: self._warmed)

    # -- fleet doc sources -------------------------------------------------
    def _board_levels(self) -> Dict[str, float]:
        """Doc levels when no reactor is configured: the hottest
        effective per-dst scores (bounded — the doc is a digest)."""
        eff = self.board.effective_scores()
        top = sorted(eff.items(), key=lambda kv: -kv[1])[:16]
        return {dst: lvl for dst, lvl in top}

    def _fleet_extras(self) -> Dict[str, float]:
        extras: Dict[str, float] = {}
        if self._drift is not None:
            try:
                extras["drift"] = float(self._drift.score_shift())
            except Exception:  # noqa: BLE001 — a cold drift monitor
                # (no baseline yet) must not break doc publication
                log.debug("fleet drift extra unavailable", exc_info=True)
        if self.admission is not None:
            extras["shed_rate"] = max(
                0.0, 1.0 - float(getattr(self.admission, "factor", 1.0)))
        return extras

    # -- assembly hooks (Linker) ------------------------------------------
    def set_store_client(self, client, fleet_client=None) -> None:
        """Install a reactor store client (embedded namerd / tests);
        the YAML path builds one from ``namerdAddress`` instead. The
        fleet exchange (when configured) shares ``client`` unless a
        dedicated ``fleet_client`` is given."""
        if self.fleet is not None:
            self.fleet.set_store_client(
                fleet_client if fleet_client is not None else client)
        self._mk_reactor(client)

    def set_namer_prefixes(self, prefixes) -> None:
        """Configured-namer prefixes for override verification (the
        Linker knows them only after building namers); None = unknown
        (remote namerd owns the namers)."""
        self._reactor_prefixes = (list(prefixes) if prefixes is not None
                                  else None)
        if self.reactor is not None:
            self.reactor._namer_prefixes = self._reactor_prefixes

    def register_admission(self, admission_filter) -> None:
        if self.admission is not None:
            self.admission.register(admission_filter)

    def register_tenant_admission(self, tenant_admission) -> None:
        """Adopt a router's TenantAdmission: its per-tenant quota
        governor rides this loop's tick (it also steps
        opportunistically on its own — registration here just gives it
        a steady cadence)."""
        self._tenant_admissions.append(tenant_admission)

    def register_balancer(self, bal) -> None:
        """Track a ScoreWeightedBalancer for /control.json weights."""
        self._balancers.append(bal)

    def register_prewarm(self, fn) -> None:
        """Register a router's failover-bind prewarmer: a callable
        ``fn(cluster, target)`` that binds ``cluster`` with the single
        override dentry ``cluster => target`` — the exact binding-cache
        key a partition-time booked override produces at request time.
        Warmed at startup and re-touched every ``prewarmIntervalS`` so
        the ServiceCache idle TTL never evicts it."""
        self._prewarmers.append(fn)

    def local_dtab_for(self, path) -> Dtab:
        """The RoutingService seam: partition-time booked overrides
        that apply to ``path`` (empty almost always — one dict probe
        on the request path)."""
        if self.local_book is None:
            return Dtab.empty()
        return self.local_book.dtab_for(path)

    def failover_pairs(self) -> List[Tuple[str, str]]:
        """Every (cluster, target) this loop could ever actuate —
        local failover plus all cross-region targets."""
        pairs = [(c, t) for c, t in (self.cfg.failover or {}).items()]
        for cluster, per_region in (self.cfg.regionFailover or {}).items():
            for target in per_region.values():
                pairs.append((cluster, target))
        return pairs

    def prewarm_failover_binds(self) -> int:
        """Warm (or re-touch) every failover bind through every
        registered router; returns how many binds were touched."""
        self._last_prewarm = time.monotonic()
        if self.local_book is None or not self._prewarmers:
            return 0
        warmed = 0
        for fn in self._prewarmers:
            for cluster, target in self.failover_pairs():
                try:
                    fn(cluster, target)
                    warmed += 1
                except Exception:  # noqa: BLE001 — a failed prewarm
                    # means that bind starts cold; it must never break
                    # the control tick
                    log.debug("failover bind prewarm failed for "
                              "%s => %s", cluster, target, exc_info=True)
        return warmed

    def set_tracer(self, tracer) -> None:
        if self.reactor is not None:
            self.reactor.set_tracer(tracer)

    # -- the loop ----------------------------------------------------------
    async def run(self) -> None:
        interval = self.cfg.intervalMs / 1e3
        try:
            while not self._stop.is_set():
                await self.step()
                await asyncio.sleep(interval)
        except asyncio.CancelledError:
            pass

    async def step(self) -> None:
        """One control tick (also driven directly by tests/bench).
        Until the scorer has warmed up, NO actuator fires — an
        untrained model's scores are noise, and noise must not shift
        fleet traffic."""
        self._steps.incr()
        if self.fleet is not None:
            # the exchange runs pre-warmup too: an identity-only doc
            # keeps this instance visible (and fenceable) in the fleet
            # while its scorer trains; cluster levels only appear in
            # the doc once warmed (FleetExchange.build_doc)
            self.fleet.maybe_step()
        if (self._prewarmers and self.local_book is not None
                and (self._last_prewarm is None
                     or time.monotonic() - self._last_prewarm
                     >= self.cfg.prewarmIntervalS)):
            self.prewarm_failover_binds()
        if not self._warmed:
            if not self._ready_fn():
                return
            self._warmed = True
            log.info("control loop warmed up; actuators live")
        if self.admission is not None:
            self.admission.step()
        for ta in self._tenant_admissions:
            ta.step()
        if self.reactor is not None:
            await self.reactor.step()

    # -- observability -----------------------------------------------------
    def status(self) -> dict:
        out: dict = {
            "interval_ms": self.cfg.intervalMs,
            "steps": self._steps.value,
            "warmed_up": self._warmed,
            "actuators": {
                "balancer_weighting": self.weigher is not None,
                "adaptive_admission": self.admission is not None,
                "mesh_reactor": self.reactor is not None,
                "fleet_exchange": self.fleet is not None,
            },
        }
        if self.weigher is not None:
            out["endpoint_scores"] = {
                ep: round(s, 4) for ep, s in
                self.board.effective_endpoint_scores().items()}
            weights: Dict[str, float] = {}
            for bal in self._balancers:
                weights.update(bal.weights())
            out["endpoint_weights"] = weights
        if self.admission is not None:
            out["admission"] = self.admission.status()
        if self._tenant_admissions:
            out["tenants"] = [ta.status() for ta in
                              self._tenant_admissions]
        if self.reactor is not None:
            out["reactor"] = self.reactor.status()
        if self.fleet is not None:
            out["fleet"] = self.fleet.status()
        if self.local_book is not None:
            out["local_book"] = self.local_book.status()
        return out

    def close(self) -> None:
        self._stop.set()

    async def aclose(self) -> None:
        self.close()
        if self.reactor is not None:
            await self.reactor.aclose()
        if self.fleet is not None:
            await self.fleet.aclose()
