"""Linker: parse config -> namers -> routers -> servers, for HTTP/1.1:
the ``protocol: http`` subset of ``linkerd_tpu/linker.py``.

Reference parity: linkerd/core/.../Linker.scala:101-196 (LinkerConfig.mk:
metrics tree, telemeters, namers, per-router interpreter + binding params,
port-conflict checks) and Router.scala / Server.scala for the per-router
assembly.

The port's linker builds HTTP routers with the ``io.l5d.fs`` namer (plus
the in-process ``/$/inet`` and status utility namers) and the
``io.l5d.jaxAnomaly`` telemeter, whose scorer runs on ``device``. What
the reference's linker also takes is refused by name with the ROADMAP
item that brings it (``REFUSED_ROUTER_KEYS``, ``UNPORTED_KINDS``):
a config naming one fails at load rather than serving without it.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from linkerd_tpu_torch import DeviceLike, resolve_device
from linkerd_tpu_torch.config import (
    ConfigError, instantiate, kinds, parse_config,
)
from linkerd_tpu_torch.config.parser import instantiate_as
from linkerd_tpu_torch.core import Dtab, Path
from linkerd_tpu_torch.core.addr import Address, BoundName
from linkerd_tpu_torch.core.pathmatcher import PathMatcher
from linkerd_tpu_torch.protocol.tls import TlsClientConfig, TlsServerConfig
from linkerd_tpu_torch.namer import ConfiguredDtabNamer, Namer
from linkerd_tpu_torch.protocol.http.client import HttpClient
from linkerd_tpu_torch.protocol.http.filters import (
    ClearContextFilter, DstHeadersFilter, FramingFilter, ProxyRewriteFilter,
    RewriteHostHeader, StripHopByHopHeadersFilter, ViaHeaderAppenderFilter,
    AddForwardedHeaderFilter, mk_forwarded_labeler,
)
from linkerd_tpu_torch.protocol.http.identifiers import compose_identifiers
from linkerd_tpu_torch.protocol.http.message import Response
from linkerd_tpu_torch.protocol.http.server import HttpServer
from linkerd_tpu_torch.router.balancer import BALANCER_KINDS, mk_balancer
from linkerd_tpu_torch.router.classifiers import ClassifierFilter
from linkerd_tpu_torch.router.binding import DstBindingFactory, DstPath
from linkerd_tpu_torch.router.deadline import (
    ClientDeadlineFilter, DeadlineFilter, ServerDeadlineFilter,
)
from linkerd_tpu_torch.router.failure_accrual import (
    FailFastService, FailureAccrualService,
)
from linkerd_tpu_torch.router.retries import (
    ClassifiedRetries, RequeueFilter, RetryBudget, TotalTimeout,
    backoff_jittered,
)
from linkerd_tpu_torch.router.routing import (
    ErrorResponder, RoutingService, StatsFilter, StatusCodeStatsFilter,
)
from linkerd_tpu_torch.router.service import (
    FnService, Service, filters_to_service,
)
from linkerd_tpu_torch.router.stages import StageTimerFilter
from linkerd_tpu_torch.telemetry.anomaly import (
    JaxAnomalyTelemeter, ScoreBoard,
)
from linkerd_tpu_torch.telemetry.metrics import MetricsTree

# The port's plugins register into its own registry when imported: the
# identifiers, classifiers, failure accrual kinds and the telemeter by
# the imports above, the fs namer here.
import linkerd_tpu_torch.namer.fs  # noqa: F401

DEFAULT_ADMIN_PORT = 9990  # ref: Linker.scala:37

# The ROADMAP items (Queue 1) that bring what this linker refuses.
_NATIVE = "ROADMAP Queue 1 item 4 (the native engines)"
_PROTOCOLS = "ROADMAP Queue 1 item 12 (h2/gRPC, then thrift/mux)"
_TLS = "ROADMAP Queue 1 item 9 (TLS)"
_EDGE = "ROADMAP Queue 1 item 10 (admission, tenants and loggers)"
_ADMIN = ("ROADMAP Queue 1 item 7 (the CLI, the admin server and the "
          "metric exporters)")
_TRACING = ("ROADMAP Queue 1 item 8 (router/tracing.py with the tracer "
            "telemeters)")
_ANNOUNCERS = "ROADMAP Queue 1 item 11 (the announcers)"
_K8S = "ROADMAP Queue 1 item 5 (the namers of the fault benchmarks)"
_NAMING = ("ROADMAP Queue 1 item 13 (the other namers, transformers and "
           "interpreters)")

# Router keys the reference takes and the port does not yet, each with
# the item that brings it. A key counts as given when it is not None and
# not False.
REFUSED_ROUTER_KEYS: Dict[str, str] = {
    "fastPath": _NATIVE,
    "workers": _NATIVE,
    "connectionGuard": _NATIVE,
    "streamScoring": _NATIVE,
    "tenants": _EDGE,
    "tenantIdentifier": _EDGE,
    "admissionControl": _EDGE,
    "loggers": _EDGE,
    "httpAccessLog": _EDGE,
    "interpreter": _NAMING,
}

REFUSED_PROTOCOLS: Dict[str, str] = {
    p: _PROTOCOLS for p in ("h2", "thrift", "mux", "thriftmux")}

# Kinds the reference registers and the port has not ported yet, by
# category, each with the item that brings it. A kind in neither
# package keeps the reference's own "unknown ... kind" error.
UNPORTED_KINDS: Dict[str, Dict[str, str]] = {
    "namer": {
        "io.l5d.k8s": _K8S, "io.l5d.k8s.external": _K8S,
        "io.l5d.k8s.ns": _K8S, "io.l5d.k8s.istio": _K8S,
        "io.l5d.consul": _NAMING, "io.l5d.curator": _NAMING,
        "io.l5d.marathon": _NAMING, "io.l5d.rewrite": _NAMING,
        "io.l5d.serversets": _NAMING, "io.l5d.zkLeader": _NAMING,
    },
    "telemeter": {
        "io.l5d.zipkin": _TRACING, "io.l5d.tracelog": _TRACING,
        "io.l5d.recentRequests": _TRACING,
        "io.l5d.prometheus": _ADMIN, "io.l5d.influxdb": _ADMIN,
        "io.l5d.statsd": _ADMIN, "io.l5d.istio": _K8S,
    },
    "identifier": {
        "io.l5d.ingress": _K8S, "io.l5d.k8s.istio": _K8S,
        "io.l5d.k8s.istio-ingress": _K8S,
    },
}


def _refusal(what: str, item: str) -> ConfigError:
    return ConfigError(
        f"{what} is not supported by the port yet: it comes with {item}")


def _instantiate(category: str, raw: Any, where: str) -> Any:
    """``instantiate`` that refuses a reference kind the port has not
    ported by name, and lists those kinds among the known ones when a
    kind is in neither package, as the reference's registry would."""
    kind = raw.get("kind") if isinstance(raw, dict) else None
    unported = UNPORTED_KINDS.get(category, {})
    if kind in unported:
        raise _refusal(f"{where}: {category} kind {kind!r}", unported[kind])
    if kind and unported and kind not in kinds(category):
        known = sorted(set(kinds(category)) | set(unported))
        raise ConfigError(
            f"unknown {category} kind {kind!r}; known kinds: {known}")
    return instantiate(category, raw, where)




def _status_code_of(bound) -> Optional[int]:
    """The constant-response code when ``bound`` is the in-process
    /$/io.buoyant.http.status namer, else None (single source for all
    protocol client factories)."""
    from linkerd_tpu_torch.namer.core import STATUS_NAMER_PREFIX
    if bound.id_.starts_with(STATUS_NAMER_PREFIX):
        return int(bound.id_[len(STATUS_NAMER_PREFIX)])
    return None


class _PruneOnClose(Service):
    """Delegates to a service; prunes a metrics subtree when closed."""

    def __init__(self, inner: Service, metrics: MetricsTree, scope: tuple):
        self._inner = inner
        self._metrics = metrics
        self._scope = scope

    async def __call__(self, req):
        return await self._inner(req)

    @property
    def status(self):
        return self._inner.status

    async def close(self) -> None:
        await self._inner.close()
        self._metrics.prune(*self._scope)


@dataclass
class ServerSpec:
    port: int = 0
    ip: str = "127.0.0.1"
    maxConcurrentRequests: Optional[int] = None
    tls: Optional[TlsServerConfig] = None
    # strip inbound l5d-* headers at this server edge (untrusted callers;
    # ref: ServerConfig clearContext, Server.scala:77-117)
    clearContext: bool = False
    # announce paths, e.g. ["/#/io.l5d.fs/web"] (ref: servers[].announce)
    announce: Optional[List[str]] = None
    # per-server request timeout (ref: ServerConfig.timeoutMs ->
    # TimeoutFilter, Server.scala:85,96)
    timeoutMs: Optional[int] = None
    # http only: gzip response compression (ref: HttpConfig.scala:202,248
    # compressionLevel). -1 = automatic (compressible content types at
    # the zlib default), 0 = off, 1..9 = always compress at that level
    # when the client sends Accept-Encoding: gzip
    compressionLevel: Optional[int] = None


@dataclass
class BalancerSpec:
    kind: str = "p2c"


@dataclass
class ClientSpec:
    loadBalancer: Optional[BalancerSpec] = None
    hostConnectionPool: int = 64
    connectTimeoutMs: int = 3000
    failureAccrual: Optional[Dict[str, Any]] = None  # kind-discriminated
    tls: Optional[TlsClientConfig] = None
    # ref ClientConfig.scala:23-35 — per-attempt timeout (each balancer
    # pick, inside requeues/retries), connect-failure requeues against a
    # budget, and fail-fast endpoint marking (off by default for
    # routers, Router.scala:374)
    requestAttemptTimeoutMs: Optional[int] = None
    requeueBudget: Optional["BudgetSpec"] = None
    failFast: bool = False


@dataclass
class BackoffSpec:
    kind: str = "jittered"  # constant | jittered
    ms: int = 0             # constant pause
    minMs: int = 10         # jittered bounds
    maxMs: int = 10000


@dataclass
class BudgetSpec:
    ttlSecs: float = 10.0
    minRetriesPerSec: float = 10.0
    percentCanRetry: float = 0.2


@dataclass
class RetriesSpec:
    backoff: Optional[BackoffSpec] = None
    budget: Optional[BudgetSpec] = None
    maxRetries: int = 25


@dataclass
class AdmissionControlSpec:
    """Per-router overload protection: at most ``maxConcurrency``
    requests in flight with up to ``maxPending`` queued for a slot;
    beyond that the router sheds with a retryable signal (http: 503 +
    ``l5d-retryable: true``; h2: ``RST_STREAM REFUSED_STREAM``)."""

    maxConcurrency: int = 1024
    maxPending: int = 0


@dataclass
class TenantsSpec:
    """Per-tenant score-driven quotas (the ``tenants:`` router block;
    requires a ``tenantIdentifier``): each tenant's anomaly level
    (error EWMA, in-plane score EWMA, traffic dominance) feeds a
    flap-proof HysteresisGovernor; a SICK tenant's quota shrinks to
    ``floor`` × the router's concurrency (Python path) / ``floor`` ×
    ``engineBase`` (pushed into the native engines), and clears on
    recovery — every other tenant's budget is untouched."""

    floor: float = 0.1
    enterThreshold: float = 0.7
    exitThreshold: float = 0.3
    quorum: int = 3
    cooldownS: float = 2.0
    maxTenants: int = 1024
    engineBase: int = 64

    def validate(self, where: str) -> None:
        if not 0.0 < self.floor <= 1.0:
            raise ConfigError(f"{where}.floor must be in (0, 1]")
        if not 0.0 < self.exitThreshold < self.enterThreshold <= 1.0:
            raise ConfigError(
                f"{where}: thresholds must satisfy 0 < exitThreshold "
                f"< enterThreshold <= 1")
        if self.quorum < 1:
            raise ConfigError(f"{where}.quorum must be >= 1")
        if self.cooldownS < 0:
            raise ConfigError(f"{where}.cooldownS must be >= 0")
        if self.maxTenants < 1:
            raise ConfigError(f"{where}.maxTenants must be >= 1")
        if self.engineBase < 1:
            raise ConfigError(f"{where}.engineBase must be >= 1")


@dataclass
class ConnectionGuardSpec:
    """Native connection-plane defenses (fastPath routers only): the
    slowloris header/body budgets, per-source accept throttle, TLS
    handshake-churn backpressure, and (h2) control-frame flood caps.
    0 disables an individual defense."""

    headerBudgetMs: int = 10_000
    bodyStallMs: int = 30_000
    acceptBurst: int = 0
    acceptWindowMs: int = 1000
    maxHandshakesInflight: int = 0
    # h2 only
    maxStreamsPerConnection: int = 512
    rstBurst: int = 200
    pingBurst: int = 256
    settingsBurst: int = 64
    floodWindowMs: int = 1000
    # http only: budgets for 101-upgrade / CONNECT byte tunnels riding
    # the native engine (tunnels escape the request slowloris budgets
    # by design — these are their replacement). 0 disables.
    tunnelIdleMs: int = 0
    tunnelMaxBytes: int = 0

    def validate(self, where: str) -> None:
        for name in ("headerBudgetMs", "bodyStallMs", "acceptBurst",
                     "maxHandshakesInflight", "maxStreamsPerConnection",
                     "rstBurst", "pingBurst", "settingsBurst",
                     "tunnelIdleMs", "tunnelMaxBytes"):
            if getattr(self, name) < 0:
                raise ConfigError(f"{where}.{name} must be >= 0")
        if self.acceptWindowMs < 1 or self.floodWindowMs < 1:
            raise ConfigError(
                f"{where}: window sizes must be >= 1 ms")


@dataclass
class StreamScoringSpec:
    """Stream sentinel config (http + h2): incremental per-stream
    featurization and mid-stream actuation for long-lived streams
    (h2/gRPC streams, WebSocket upgrades, CONNECT tunnels). The native
    engines sample each live stream's feature accumulator every
    ``sampleEveryFrames`` frames (at most once per ``minGapMs``), score
    it through the in-plane scorer (specialist head pinned at stream
    open), and run a per-stream hysteresis governor — same
    enter/exit/quorum/dwell semantics as every other actuator — that
    sheds a SICK stream mid-flight when ``action: rst``."""

    sampleEveryFrames: int = 8
    minGapMs: int = 10
    tableCap: int = 4096
    enter: float = 0.8
    exit: float = 0.5
    quorum: int = 3
    dwellMs: int = 1000
    action: str = "rst"  # observe | rst

    def validate(self, where: str) -> None:
        if self.sampleEveryFrames < 1:
            raise ConfigError(f"{where}.sampleEveryFrames must be >= 1")
        if self.minGapMs < 0:
            raise ConfigError(f"{where}.minGapMs must be >= 0")
        if self.tableCap < 1:
            raise ConfigError(f"{where}.tableCap must be >= 1")
        if not 0.0 < self.exit < self.enter <= 1.0:
            raise ConfigError(
                f"{where}: thresholds must satisfy 0 < exit < enter "
                f"<= 1 (got enter={self.enter}, exit={self.exit})")
        if self.quorum < 1:
            raise ConfigError(f"{where}.quorum must be >= 1")
        if self.dwellMs < 0:
            raise ConfigError(f"{where}.dwellMs must be >= 0")
        if self.action not in ("observe", "rst"):
            raise ConfigError(
                f"{where}.action must be observe or rst "
                f"(got {self.action!r})")


@dataclass
class SvcSpec:
    """Per-logical-name policy (ref: SvcConfig.scala — totalTimeout,
    retries, classification)."""

    totalTimeoutMs: Optional[int] = None
    retries: Optional[RetriesSpec] = None
    responseClassifier: Optional[Dict[str, Any]] = None  # kind-discriminated
    # h2 only: how long a response is held awaiting its classifying final
    # frame (grpc-status trailer) before forfeiting retryability and
    # streaming through (see H2ClassifiedRetries.rsp_hold_s)
    classificationTimeoutMs: int = 1000


@dataclass
class RouterSpec:
    protocol: str = "http"
    label: Optional[str] = None
    dtab: str = ""
    dstPrefix: str = "/svc"
    identifier: Optional[Any] = None      # kind-discriminated mapping(s)
    interpreter: Optional[Dict[str, Any]] = None  # kind-discriminated
    servers: Optional[List[ServerSpec]] = None
    # Plain mapping = one config for all clients/services; or
    # {kind: io.l5d.static, configs: [{prefix: ..., <fields>}]} for
    # per-prefix overrides (ref: Client.scala/Svc.scala StaticClient/
    # StaticSvc; PerClientParams Router.scala:271-303).
    client: Optional[Any] = None
    service: Optional[Any] = None
    bindingTimeoutMs: int = 10000
    bindingCache: Optional[Dict[str, Any]] = None
    sampleRate: float = 1.0               # trace sampling for new roots
    httpAccessLog: Optional[str] = None   # path or "stdout"
    # RFC 7239 Forwarded header: false (off), true (reference defaults:
    # obfuscated per-request labels), or {by: {kind: ...}, for: {...}}
    # with kinds ip | ip:port | requestRandom | connectionRandom |
    # router | static (ref: AddForwardedHeaderConfig.scala)
    addForwardedHeader: Any = False
    # h2 only: advertised SETTINGS (ref: H2Config.scala
    # initialStreamWindowBytes/maxFrameBytes/maxHeaderListBytes/
    # maxConcurrentStreamsPerConnection)
    initialStreamWindowBytes: Optional[int] = None
    maxFrameBytes: Optional[int] = None
    maxHeaderListBytes: Optional[int] = None
    maxConcurrentStreamsPerConnection: Optional[int] = None
    # thrift only: method name as the dst path element instead of the
    # static "thrift" dst (ref: router/thrift Identifier.scala:34)
    thriftMethodInDst: bool = False
    # thrift only: negotiate the TTwitter upgrade with servers/clients so
    # trace ids + dtab overrides ride thrift hops
    # (ref: ThriftInitializer.scala attemptTTwitterUpgrade)
    attemptTTwitterUpgrade: bool = True
    # thrift only: transport framing + protocol
    # (ref: ThriftInitializer.scala:47,68-72 thriftProtocol/thriftFramed)
    thriftFramed: bool = True
    thriftProtocol: str = "binary"  # binary | compact
    # http only: per-request logger plugin chain in the client stack
    # (ref: HttpLoggerConfig.scala loggers param; kinds under
    # protocol/http/loggers.py)
    loggers: Optional[List[Any]] = None
    # http + h2: per-router admission control (bounded concurrency +
    # bounded pending queue); sheds are retryable by contract (see
    # AdmissionControlSpec / router/admission.py)
    admissionControl: Optional[AdmissionControlSpec] = None
    # http + h2: serve the data plane from the native C++ epoll engine
    # (native/fastpath.cpp for http, native/h2_fastpath.cpp for h2);
    # Python remains the control plane (naming, route install,
    # stats/feature drain). Requires a built native lib.
    fastPath: bool = False
    # http + h2: tenant identity extraction (header / pathSegment /
    # sni; router/tenancy.py, mirrored in C by both engines) — stamps
    # ctx["tenant"]/["tenant_hash"] and feeds per-tenant accounting
    tenantIdentifier: Optional[Dict[str, Any]] = None
    # http + h2: per-tenant score-driven quotas on top of admission
    # control (Python path) / in-engine quota maps (fastPath); needs a
    # tenantIdentifier to key by
    tenants: Optional[TenantsSpec] = None
    # fastPath only: native connection-plane defenses (slowloris
    # budgets, accept throttle, handshake-churn backpressure, h2
    # flood caps, tunnel budgets)
    connectionGuard: Optional[ConnectionGuardSpec] = None
    # http + h2: stream sentinel — incremental scoring and mid-stream
    # actuation for long-lived streams/tunnels. Native in-plane on
    # fastPath routers; the Python h2 data plane runs the same
    # tracker/governor in-process (http Python path has no frame
    # stream to sample — l5dcheck warns there)
    streamScoring: Optional[StreamScoringSpec] = None
    # fastPath only: shard the native engine N-way — N per-core epoll
    # workers sharing the router's ports via SO_REUSEPORT, per-core
    # stats/tenant/guard slabs merged at scrape time, one shared
    # read-only scorer weight slab. None/1 = today's single engine
    # (bit-compatible); 0 = auto-size to min(4, hw cores).
    workers: Optional[int] = None


@dataclass
class AdminSpec:
    port: int = DEFAULT_ADMIN_PORT
    ip: str = "127.0.0.1"
    # standalone identification debug server: every request to this port
    # answers with each router's identification of a synthetic request
    # built from the query params (ref: Main.initAdmin wiring of
    # HttpIdentifierHandler.scala:48 when httpIdentifierPort is set)
    httpIdentifierPort: Optional[int] = None


@dataclass
class LinkerSpec:
    routers: List[RouterSpec] = field(default_factory=list)
    namers: Optional[List[Any]] = None     # kind-discriminated mappings
    telemetry: Optional[List[Any]] = None  # kind-discriminated mappings
    announcers: Optional[List[Any]] = None  # kind-discriminated mappings
    admin: Optional[AdminSpec] = None
    usage: Optional[Dict[str, Any]] = None  # {enabled, orgId}


def per_prefix_lookup(raw: Any, cls: type, where: str,
                      validate: Optional[Callable[[Any], None]] = None,
                      ) -> Callable[[Path], Tuple[Any, Dict[str, str]]]:
    """Resolve a client/svc config block into ``path -> (spec, vars)``.

    ``raw`` is either a plain mapping (one spec for every path), or the
    static form ``{kind: io.l5d.static, configs: [{prefix, <fields>}...]}``
    where every matching prefix's fields are merged in order (later configs
    override) and the PathMatcher's captured variables are returned for
    substitution (e.g. into a TLS commonName). Ref: Client.scala/Svc.scala,
    Router.scala:271-303 (PerClientParams).
    """
    if raw is None:
        default = cls()
        return lambda _p: (default, {})
    if not isinstance(raw, dict):
        raise ConfigError(f"{where}: expected a mapping")
    if raw.get("kind") == "io.l5d.static":
        unknown = set(raw) - {"kind", "configs"}
        if unknown:
            raise ConfigError(
                f"{where}: unknown fields {sorted(unknown)} "
                f"(io.l5d.static takes only 'configs')")
        configs = raw.get("configs")
        if not isinstance(configs, list):
            raise ConfigError(f"{where}.configs: expected a list")
        entries: List[Tuple[PathMatcher, Dict[str, Any]]] = []
        for i, c in enumerate(configs):
            if not isinstance(c, dict):
                raise ConfigError(f"{where}.configs[{i}]: expected a mapping")
            c = dict(c)
            prefix = c.pop("prefix", None)
            if prefix is None:
                raise ConfigError(f"{where}.configs[{i}]: missing 'prefix'")
            # Validate the entry's own fields (and nested kinds) at load
            # time so typos fail startup, not the first matching request
            # (ref: Parser strictness, Parser.scala:84).
            matcher = PathMatcher(str(prefix))
            entry_spec = instantiate_as(cls, c, f"{where}.configs[{i}]")
            entries.append((matcher, c, entry_spec))
        if validate is not None:
            # Runtime lookup() merges captures across ALL matching
            # prefixes, so a template var is satisfiable if ANY entry
            # captures it — validate against the union, not per-entry.
            all_vars = frozenset().union(
                *(mch.var_names for mch, _, _ in entries))
            for mch, _, entry_spec in entries:
                validate(entry_spec, all_vars)

        def lookup(path: Path) -> Tuple[Any, Dict[str, str]]:
            merged: Dict[str, Any] = {}
            vars_: Dict[str, str] = {}
            for matcher, fields, _spec in entries:
                captured = matcher.extract(path)
                if captured is not None:
                    merged.update(fields)
                    vars_.update(captured)
            return instantiate_as(cls, merged, where), vars_

        return lookup
    spec = instantiate_as(cls, raw, where)
    if validate is not None:
        validate(spec, frozenset())
    return lambda _p: (spec, {})


def parse_linker_spec(text: str) -> LinkerSpec:
    data = parse_config(text)
    if not isinstance(data, dict):
        raise ConfigError("linker config must be a mapping")
    spec = instantiate_as(LinkerSpec, data)
    if not spec.routers:
        raise ConfigError("config needs at least one router")
    return spec


class Router:
    """One configured router: routing service + its servers."""

    def __init__(self, spec: RouterSpec, label: str, service: Service,
                 binding: DstBindingFactory, servers: List[HttpServer],
                 interpreter=None, identifier=None):
        self.spec = spec
        self.label = label
        self.service = service
        self.binding = binding
        self.servers = servers
        self.interpreter = interpreter
        self.identifier = identifier  # admin /identifier.json debug

    @property
    def server_ports(self) -> List[int]:
        return [s.bound_port for s in self.servers]

    async def start(self) -> None:
        for s in self.servers:
            await s.start()

    async def close(self) -> None:
        for s in self.servers:
            await s.close()
        await self.service.close()

class Linker:
    """The reference's ``Linker`` for HTTP/1.1 routers, with its
    telemeters built on ``device``."""

    def __init__(self, spec: LinkerSpec, device: DeviceLike = None):
        self.spec = spec
        self.device = resolve_device(device)
        self.metrics = MetricsTree()
        self.namers: List[Tuple[Path, Namer]] = []
        self.routers: List[Router] = []
        self.telemeters: List[Any] = []
        try:
            self._build()
        except BaseException:
            # a config error mid-build must not leak the telemeters or
            # namers materialized before the failure
            for t in self.telemeters:
                t.close()
            for _, namer in self.namers:
                namer.close()
            raise

    # -- assembly ---------------------------------------------------------
    def _build(self) -> None:
        for i, raw in enumerate(self.spec.namers or []):
            if not isinstance(raw, dict):
                raise ConfigError(f"namers[{i}]: expected a mapping")
            if raw.get("transformers"):
                raise _refusal(f"namers[{i}].transformers", _NAMING)
            raw = {k: v for k, v in raw.items() if k != "transformers"}
            ncfg = _instantiate("namer", raw, f"namers[{i}]")
            prefix = Path.read(getattr(ncfg, "prefix", f"/{ncfg.kind}"))
            self.namers.append((prefix, ncfg.mk()))

        if self.spec.announcers:
            raise _refusal("announcers", _ANNOUNCERS)
        for rspec in self.spec.routers:
            for i, s in enumerate(rspec.servers or []):
                if s.announce:
                    raise _refusal(
                        f"{rspec.label or rspec.protocol}.servers[{i}]."
                        f"announce", _ANNOUNCERS)

        telemetry = self.spec.telemetry
        if telemetry is not None and not isinstance(telemetry, list):
            raise ConfigError(
                "telemetry: expected a list of telemeter configs")
        for i, raw in enumerate(telemetry or []):
            tcfg = _instantiate("telemeter", raw, f"telemetry[{i}]")
            self.telemeters.append(tcfg.mk(self.metrics, device=self.device))

        labels_seen: Dict[str, int] = {}
        for rspec in self.spec.routers:
            if rspec.protocol in REFUSED_PROTOCOLS:
                raise _refusal(f"protocol {rspec.protocol!r}",
                               REFUSED_PROTOCOLS[rspec.protocol])
            if rspec.protocol != "http":
                raise ConfigError(
                    f"protocol {rspec.protocol!r} not yet supported")
            label = rspec.label or rspec.protocol
            n = labels_seen.get(label, 0)
            labels_seen[label] = n + 1
            if n:
                label = f"{label}-{n}"
            for key, item in REFUSED_ROUTER_KEYS.items():
                value = getattr(rspec, key)
                if value is not None and value is not False:
                    raise _refusal(f"{label}.{key}", item)
            for i, s in enumerate(rspec.servers or []):
                if s.tls is not None:
                    raise _refusal(f"{label}.servers[{i}].tls", _TLS)
                if s.compressionLevel is None:
                    continue
                if not -1 <= s.compressionLevel <= 9:
                    raise ConfigError(
                        f"{label}.servers[{i}].compressionLevel must be "
                        f"in -1..9, got {s.compressionLevel}")
            self.routers.append(self._mk_http_router(rspec, label))

        # port-conflict check (ref: Linker.scala:189-195)
        ports = [
            (s.ip, s.port)
            for r in self.routers for s in (r.spec.servers or [])
            if s.port
        ]
        if len(ports) != len(set(ports)):
            raise ConfigError(f"server port conflict: {ports}")

    # -- router assembly helpers ------------------------------------------
    def _mk_client_validator(self, label: str):
        def validate_client(spec: ClientSpec, var_names=frozenset()) -> None:
            if spec.failureAccrual is not None:
                instantiate("failureAccrual", spec.failureAccrual,
                            f"{label}.failureAccrual")
            if spec.loadBalancer is not None:
                if spec.loadBalancer.kind not in BALANCER_KINDS:
                    raise ConfigError(
                        f"{label}.client: unknown balancer kind "
                        f"{spec.loadBalancer.kind!r} "
                        f"(known: {sorted(BALANCER_KINDS)})")
            if spec.tls is not None:
                raise _refusal(f"{label}.client.tls", _TLS)
        return validate_client

    def _mk_policy_factory_fn(self, label: str):
        def mk_policy_factory(cspec: ClientSpec):
            fa_cfg = cspec.failureAccrual or {
                "kind": "io.l5d.consecutiveFailures"}
            fa_config = instantiate(
                "failureAccrual", fa_cfg, f"{label}.failureAccrual")
            if getattr(fa_config, "needs_board", False):
                board = self._anomaly_board()
                return lambda: fa_config.mk(board)
            return fa_config.mk
        return mk_policy_factory

    def _mk_identifier(self, rspec: RouterSpec, label: str,
                       category: str, default_kind: str,
                       prefix: Path, base_dtab: Dtab):
        id_cfgs = rspec.identifier
        if id_cfgs is None:
            id_cfgs = [{"kind": default_kind}]
        elif isinstance(id_cfgs, dict):
            id_cfgs = [id_cfgs]
        return compose_identifiers([
            _instantiate(category, c, f"{label}.identifier")
            .mk(prefix, base_dtab)
            for c in id_cfgs
        ])

    @staticmethod
    def _mk_svc_validator(label: str, category: str):
        def validate_svc(spec: SvcSpec, var_names=frozenset()) -> None:
            if spec.responseClassifier is not None:
                instantiate(category, spec.responseClassifier,
                            f"{label}.responseClassifier")
        return validate_svc

    @staticmethod
    def _mk_backoffs(sspec: SvcSpec) -> List[float]:
        bspec = (sspec.retries.backoff if sspec.retries else None)
        max_retries = sspec.retries.maxRetries if sspec.retries else 25
        if bspec is None:
            return [0.0] * max_retries
        if bspec.kind == "constant":
            return [bspec.ms / 1e3] * max_retries
        import itertools
        return list(itertools.islice(
            backoff_jittered(bspec.minMs / 1e3, bspec.maxMs / 1e3),
            max_retries))

    def _client_stack_extras(self, cspec: "ClientSpec", label: str,
                             cid: str):
        """-> (endpoint_wrap, filters_above_balancer). Order in the
        stack: requeue OUTSIDE the per-attempt timeout (each re-pick is
        re-timed); failFast wraps the endpoint below accrual."""
        filters: List[Any] = []
        if cspec.requeueBudget is not None:
            b = cspec.requeueBudget
            filters.append(RequeueFilter(
                RetryBudget(b.ttlSecs, b.minRetriesPerSec,
                            b.percentCanRetry),
                metrics_scope=self.metrics.scope(
                    "rt", label, "client", cid)))
        if cspec.requestAttemptTimeoutMs is not None:
            filters.append(TotalTimeout(
                cspec.requestAttemptTimeoutMs / 1e3))
        wrap = FailFastService if cspec.failFast else (lambda s: s)
        return wrap, filters

    def _per_server_stack_fn(self, label: str, server_filters: List[Any],
                             routing: Service, shared_stack: Service):
        """The optional per-server TimeoutFilter (ref
        ServerConfig.timeoutMs, Server.scala:85,96) sits INNERMOST —
        below the responder and stats filters, so the mapped 504 is
        observed by metrics like any other response — and clearContext
        strips headers outermost."""
        def per_server(s: ServerSpec) -> Service:
            if s.timeoutMs is not None and s.timeoutMs <= 0:
                raise ConfigError(
                    f"{label}.servers[].timeoutMs must be > 0, "
                    f"got {s.timeoutMs}")
            if s.timeoutMs is None and not s.clearContext:
                return shared_stack
            chain = list(server_filters)
            if s.timeoutMs is not None:
                chain.append(TotalTimeout(s.timeoutMs / 1e3))
            if s.clearContext:
                chain.insert(0, ClearContextFilter())
            return filters_to_service(chain, routing)

        return per_server

    def _mk_http_router(self, rspec: RouterSpec, label: str) -> Router:
        base_dtab = Dtab.read(rspec.dtab) if rspec.dtab else Dtab.empty()
        prefix = Path.read(rspec.dstPrefix)
        identifier = self._mk_identifier(
            rspec, label, "identifier", "io.l5d.header.token",
            prefix, base_dtab)
        interpreter = ConfiguredDtabNamer(self.namers)
        validate_svc = self._mk_svc_validator(label, "classifier")

        client_lookup = per_prefix_lookup(
            rspec.client, ClientSpec, f"{label}.client",
            self._mk_client_validator(label))
        metrics = self.metrics
        mk_policy_factory = self._mk_policy_factory_fn(label)

        def client_factory(bound: BoundName) -> Service:
            code = _status_code_of(bound)
            if code is not None:
                # /$/io.buoyant.http.status/<code>: an in-process constant
                # responder, no socket (ref: router/http/.../status.scala)
                async def const_status(req, _c=code):
                    return Response(status=_c)

                return FnService(const_status)
            cid = bound.id_.show.lstrip("/").replace("/", ".") or "client"
            cspec, _ = client_lookup(bound.id_)
            mk_policy = mk_policy_factory(cspec)
            ep_wrap, extra_filters = self._client_stack_extras(
                cspec, label, cid)

            def endpoint_factory(addr: Address) -> Service:
                client: Service = HttpClient(
                    addr.host, addr.port,
                    max_connections=cspec.hostConnectionPool,
                    connect_timeout=cspec.connectTimeoutMs / 1e3)
                # per-endpoint accrual (ref: FailureAccrualFactory sits below
                # the balancer in the client stack, Router.scala:318)
                return FailureAccrualService(ep_wrap(client),
                                             mk_policy())

            bal_kind = (cspec.loadBalancer or BalancerSpec()).kind
            bal = mk_balancer(bal_kind, bound.addr, endpoint_factory)
            filters: List[Any] = [
                StatsFilter(metrics, "rt", label, "client", cid),
                DstHeadersFilter(cid),
                # Host from bound `authority` metadata (consul setHost),
                # Location/Refresh reverse-rewritten; no-op without meta
                RewriteHostHeader(bound.addr),
                # re-encode the clamped deadline for the next hop
                ClientDeadlineFilter(),
            ]
            filters.extend(extra_filters)
            metrics.scope("rt", label, "client", cid).gauge(
                "endpoints", fn=lambda b=bal: b.size)
            # Prune this client's metrics subtree on eviction so gauges
            # don't pin the closed balancer or report stale values (ref:
            # MetricsPruningModule.scala:39).
            return _PruneOnClose(
                filters_to_service(filters, bal), metrics,
                ("rt", label, "client", cid))

        svc_lookup = per_prefix_lookup(
            rspec.service, SvcSpec, f"{label}.service", validate_svc)
        mk_backoffs = self._mk_backoffs

        def path_filters(dst: DstPath, svc: Service) -> Service:
            # path stack order (ref: Router.scala:321-362): stats ->
            # total timeout -> budget/classified retries -> dispatch.
            # The budget is per path-stack instance, matching the
            # reference's per-materialized-stack RetryBudgetModule.
            sspec, _ = svc_lookup(dst.path)
            classifier_cfg = sspec.responseClassifier or {
                "kind": "io.l5d.http.nonRetryable5XX"}
            classifier = instantiate(
                "classifier", classifier_cfg,
                f"{label}.responseClassifier").mk()
            budget_spec = (
                sspec.retries.budget if sspec.retries else None) or BudgetSpec()
            budget = RetryBudget(
                budget_spec.ttlSecs, budget_spec.minRetriesPerSec,
                budget_spec.percentCanRetry)
            name = dst.path.show.lstrip("/").replace("/", ".") or "root"
            filters: List[Any] = [
                # outermost: stamp l5d-success-class with the verdict on
                # the response actually returned (post-retries)
                ClassifierFilter(classifier),
                StatsFilter(metrics, "rt", label, "service", name)]
            # DeadlineFilter enforces min(l5d-ctx-deadline, now +
            # totalTimeoutMs), rejects already-expired work before
            # dispatch, and its clamped deadline bounds the retries
            filters.append(DeadlineFilter(
                sspec.totalTimeoutMs / 1e3
                if sspec.totalTimeoutMs is not None else None))
            filters.append(ClassifiedRetries(
                classifier, budget, mk_backoffs(sspec),
                max_retries=(sspec.retries.maxRetries if sspec.retries else 25),
                metrics=metrics, scope=("rt", label, "service", name)))
            return filters_to_service(filters, svc)

        cache_cfg = rspec.bindingCache or {}
        binding = DstBindingFactory(
            interpreter, client_factory, path_filters=path_filters,
            capacity=int(cache_cfg.get("capacity", 1000)),
            idle_ttl=float(cache_cfg.get("idleTtlSecs", 600.0)),
            bind_timeout=rspec.bindingTimeoutMs / 1e3)

        routing = RoutingService(identifier, binding)
        # Stats outermost so they observe ErrorResponder's mapped statuses;
        # anomaly feature recorders tap the same final view.
        server_filters: List[Any] = [
            StageTimerFilter(metrics, "rt", label),
            StatsFilter(metrics, "rt", label, "server"),
            StatusCodeStatsFilter(metrics, "rt", label, "server"),
        ]
        for t in self.telemeters:
            if hasattr(t, "recorder"):
                server_filters.append(t.recorder())
        # protocol-surgery filters (ref: HttpConfig.scala:69-81 order)
        server_filters += [
            FramingFilter(), ProxyRewriteFilter(),
            StripHopByHopHeadersFilter(), ViaHeaderAppenderFilter(),
        ]
        # bool true -> reference defaults (obfuscated per-request random
        # for both); a mapping (INCLUDING an empty one — presence
        # enables, like the reference) configures by/for labelers
        if not isinstance(rspec.addForwardedHeader, (bool, dict)):
            raise ConfigError(
                f"{label}.addForwardedHeader must be a bool or a "
                f"mapping, got {rspec.addForwardedHeader!r}")
        if rspec.addForwardedHeader or isinstance(
                rspec.addForwardedHeader, dict):
            fwd_cfg = (rspec.addForwardedHeader
                       if isinstance(rspec.addForwardedHeader, dict)
                       else {})
            unknown = set(fwd_cfg) - {"by", "for"}
            if unknown:
                raise ConfigError(
                    f"{label}.addForwardedHeader: unknown fields "
                    f"{sorted(unknown)}")
            try:
                by = mk_forwarded_labeler(fwd_cfg.get("by"), label)
                for_ = mk_forwarded_labeler(fwd_cfg.get("for"), label)
            except ValueError as e:
                raise ConfigError(
                    f"{label}.addForwardedHeader: {e}") from None
            server_filters.append(AddForwardedHeaderFilter(by, for_))
        server_filters.append(ErrorResponder())
        # INSIDE the responder: an expired deadline must map to 504
        server_filters.append(ServerDeadlineFilter(
            metrics.scope("rt", label, "server", "deadline")))
        server_stack = filters_to_service(server_filters, routing)

        per_server_stack = self._per_server_stack_fn(
            label, server_filters, routing, server_stack)

        servers = [
            HttpServer(per_server_stack(s), s.ip, s.port,
                       max_concurrency=s.maxConcurrentRequests,
                       compression_level=s.compressionLevel)
            for s in (rspec.servers or [ServerSpec()])
        ]
        return Router(rspec, label, server_stack, binding, servers,
                      interpreter=interpreter,
                      identifier=identifier)

    def _anomaly_telemeter(self) -> Optional[JaxAnomalyTelemeter]:
        """The configured jaxAnomaly telemeter, or None."""
        for t in self.telemeters:
            if isinstance(t, JaxAnomalyTelemeter):
                return t
        return None

    def _anomaly_board(self) -> ScoreBoard:
        """ScoreBoard of the configured jaxAnomaly telemeter (or a detached
        one so anomaly-aware policies degrade to their base behavior)."""
        tele = self._anomaly_telemeter()
        return tele.board if tele is not None else ScoreBoard()

    # -- lifecycle --------------------------------------------------------
    async def start(self) -> "Linker":
        for r in self.routers:
            await r.start()
        return self

    async def close(self) -> None:
        for r in self.routers:
            await r.close()
        for _, namer in self.namers:
            namer.close()
        for t in self.telemeters:
            t.close()


def load_linker(text: str, device: DeviceLike = None) -> Linker:
    """Parse a YAML/JSON config into an (unstarted) Linker whose
    telemeters run on ``device``: CUDA unless ``"cpu"`` is named."""
    return Linker(parse_linker_spec(text), device=device)
