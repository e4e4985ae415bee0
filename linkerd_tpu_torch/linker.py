"""Linker: parse config -> namers -> routers -> servers, for HTTP/1.1,
h2, thrift, mux and thriftmux: the counterpart of
``linkerd_tpu/linker.py``.

Reference parity: linkerd/core/.../Linker.scala:101-196 (LinkerConfig.mk:
metrics tree, telemeters, namers, per-router interpreter + binding params,
port-conflict checks) and Router.scala / Server.scala for the per-router
assembly.

The port's linker builds HTTP/1.1 routers, h2 routers (the Python
HTTP/2 stack, gRPC-aware classification and retries, and a stream
sentinel under ``streamScoring``), thrift routers (framed or buffered,
binary or compact, the TTwitter upgrade, service retries on connection
failures) and mux and thriftmux routers (the bound residual as the
downstream Tdispatch dest), with the ``io.l5d.fs`` namer, the k8s
family (the ``io.l5d.k8s``, ``io.l5d.k8s.ns`` and ``io.l5d.k8s.external``
namers, the ``io.l5d.ingress`` identifiers and the
``io.l5d.k8s.configMap`` interpreter), the istio family (pilot's
``io.l5d.k8s.istio`` namer, interpreter and identifiers, the
``io.l5d.k8s.istio-ingress`` identifiers and the ``io.l5d.istio`` mixer
telemeter) and the ``io.l5d.fs`` interpreter (plus the in-process
``/$/inet`` and status utility namers), bound in process,
through namerd's HTTP API (``interpreter: {kind: io.l5d.namerd.http}``)
or its thrift interface (``interpreter: {kind: io.l5d.namerd}``), and
the ``io.l5d.jaxAnomaly`` telemeter, whose
scorer runs on ``device``, beside the metric-exporter and tracer
telemeters (``telemetry/exporters.py``), whose tracers are broadcast to
every router's trace filters and to the anomaly telemeter's scorer
spans. Servers and clients of a Python router take ``tls``. The
telemeter's ``control:`` block closes the
loop on routing: the linker wraps each balancer in the control loop's
score weigher, registers each router's ``admissionControl`` filter for
adaptive admission, and routes through the reactor's override book. A
``fastPath: true`` router is served by a native engine built from the
repository's ``native/`` sources, the HTTP/1.1 engine or, on ``protocol:
h2``, the h2/gRPC engine: ``workers`` sharded epoll workers, native TLS
on its servers and toward its endpoints, ``connectionGuard`` (with the h2
flood caps) and ``streamScoring``, and on h2 the strictest server
``timeoutMs``; its rows feed the telemeter's native ring; a thrift or
mux router with ``fastPath: true`` is served by Python, as the
reference's. A router binds in process or through namerd's HTTP API,
its gRPC mesh API (``interpreter: {kind: io.l5d.mesh}``) or its thrift
interface. What the reference's linker also
takes is refused by name with the ROADMAP item that brings it
(``REFUSED_ROUTER_KEYS``, ``UNPORTED_KINDS``): a config naming one fails
at load rather than serving without it.
"""

from __future__ import annotations

import inspect
import logging
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from linkerd_tpu_torch import DeviceLike, resolve_device
from linkerd_tpu_torch.config import (
    ConfigError, instantiate, parse_config,
)
from linkerd_tpu_torch.control.balancer import ScoreWeightedBalancer
from linkerd_tpu_torch.config.parser import (
    instantiate_as, instantiate_ported, refusal as _refusal,
)
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
from linkerd_tpu_torch.router.admission import AdmissionControlFilter
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
    BasicStatsFilter, ErrorResponder, IdentificationError, RoutingService,
    StatsFilter, StatusCodeStatsFilter,
)
from linkerd_tpu_torch.router.service import (
    Filter, FnService, Service, filters_to_service,
)
from linkerd_tpu_torch.router.stages import StageTimerFilter
from linkerd_tpu_torch.router.tracing import (
    ClientTraceFilter, MuxClientTraceFilter, MuxServerTraceFilter,
    ServerTraceFilter,
)
from linkerd_tpu_torch.telemetry.anomaly import (
    JaxAnomalyTelemeter, ScoreBoard,
)
from linkerd_tpu_torch.telemetry.metrics import MetricsTree
from linkerd_tpu_torch.telemetry.telemeter import BroadcastTracer, NullTracer

# The port's plugins register into its own registry when imported: the
# identifiers, classifiers, failure accrual kinds and the telemeter by
# the imports above, the interpreter kinds, the istio and k8s families,
# the fs namer, the h2 identifiers and classifiers and the exporter
# telemeters here.
import linkerd_tpu_torch.interpreter.configs  # noqa: F401
import linkerd_tpu_torch.istio.identifier  # noqa: F401
import linkerd_tpu_torch.istio.interpreter  # noqa: F401
import linkerd_tpu_torch.istio.namer  # noqa: F401
import linkerd_tpu_torch.istio.telemeter  # noqa: F401
import linkerd_tpu_torch.k8s.ingress  # noqa: F401
import linkerd_tpu_torch.k8s.namer  # noqa: F401
import linkerd_tpu_torch.namer.fs  # noqa: F401
import linkerd_tpu_torch.protocol.h2.classifiers  # noqa: F401
import linkerd_tpu_torch.protocol.h2.identifiers  # noqa: F401
import linkerd_tpu_torch.telemetry.exporters  # noqa: F401

log = logging.getLogger(__name__)

DEFAULT_ADMIN_PORT = 9990  # ref: Linker.scala:37

# The ROADMAP items (Queue 1) that bring what this linker refuses.
_EDGE = "ROADMAP Queue 1 item 10 (tenants and loggers)"
_ANNOUNCERS = "ROADMAP Queue 1 item 11 (the announcers)"
_NAMING = "ROADMAP Queue 1 item 13 (the other namers and transformers)"

# Router keys the reference takes and the port does not yet, each with
# the item that brings it. A key counts as given when it is not None and
# not False.
REFUSED_ROUTER_KEYS: Dict[str, str] = {
    "tenants": _EDGE,
    "tenantIdentifier": _EDGE,
    "loggers": _EDGE,
    "httpAccessLog": _EDGE,
}

# Protocols the reference's linker builds and the port does not yet:
# none since the thrift, mux and thriftmux routers (ROADMAP Queue 1
# item 12).
REFUSED_PROTOCOLS: Dict[str, str] = {}

# Kinds the reference registers and the port has not ported yet, by
# category, each with the item that brings it. A kind in neither
# package keeps the reference's own "unknown ... kind" error.
UNPORTED_KINDS: Dict[str, Dict[str, str]] = {
    "namer": {
        "io.l5d.consul": _NAMING, "io.l5d.curator": _NAMING,
        "io.l5d.marathon": _NAMING, "io.l5d.rewrite": _NAMING,
        "io.l5d.serversets": _NAMING, "io.l5d.zkLeader": _NAMING,
    },
}


def _instantiate(category: str, raw: Any, where: str) -> Any:
    return instantiate_ported(category, raw, where,
                              UNPORTED_KINDS.get(category, {}))




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


class _FastPathRouter(Router):
    """Router facade over a FastPathController (fastPath: true)."""

    class _ServerHandle:
        """A listener's bound port, as a Python HttpServer exposes
        it."""

        def __init__(self, port: int):
            self.bound_port = port

    def __init__(self, spec: RouterSpec, label: str, controller,
                 ports: List[int], interpreter=None):
        self.spec = spec
        self.label = label
        self.controller = controller
        self._ports = ports
        self.service = None
        self.binding = None
        self.servers = [self._ServerHandle(p) for p in ports]
        self.interpreter = interpreter

    @property
    def server_ports(self) -> List[int]:
        return list(self._ports)

    async def start(self) -> None:
        await self.controller.start()

    async def close(self) -> None:
        await self.controller.close()


class Linker:
    """The reference's ``Linker`` for its five router protocols, with its
    telemeters built on ``device``. ``config_dict`` and ``config_text``
    are what the admin server's ``/config.json`` serves."""

    def __init__(self, spec: LinkerSpec, device: DeviceLike = None,
                 config_dict: Any = None,
                 config_text: Optional[str] = None):
        self.spec = spec
        self.device = resolve_device(device)
        self.config_dict = config_dict
        self.config_text = config_text
        self.metrics = MetricsTree()
        self.namers: List[Tuple[Path, Namer]] = []
        self.routers: List[Router] = []
        self.telemeters: List[Any] = []
        self.tracer: Any = NullTracer()
        # concatenated trustCerts bundles for native client TLS contexts
        self._trust_bundles: List[str] = []
        # what /tenants.json reads: empty while ``tenants`` is refused
        # (ROADMAP Queue 1 item 10), so it answers {} as the reference
        # does on such a config
        self.tenant_views: List[Tuple[str, Any, Any]] = []
        # per-router Python-plane stream sentinels for /streams.json:
        # [(label, StreamSentinel)] — fastPath routers surface theirs
        # through FastPathController.streams_snapshot instead
        self.stream_sentinels: List[Tuple[str, Any]] = []
        try:
            self._build()
        except BaseException:
            # a config error mid-build must not leak the telemeters or
            # namers materialized before the failure
            for t in self.telemeters:
                t.close()
            for _, namer in self.namers:
                namer.close()
            self._close_trust_bundles()
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
            # the exporter telemeters are device-free copies whose mk
            # takes the metrics tree alone
            if "device" in inspect.signature(tcfg.mk).parameters:
                self.telemeters.append(
                    tcfg.mk(self.metrics, device=self.device))
            else:
                self.telemeters.append(tcfg.mk(self.metrics))
        # the control loop's reactor verifies generated overrides by
        # symbolic delegation over THESE namers' prefixes; a linker with
        # no local namers (remote namerd interpreter) passes None =
        # unknown, which keeps cycle/shadow checks but not reachability
        ctl = self._anomaly_control()
        if ctl is not None:
            ctl.set_namer_prefixes([p for p, _ in self.namers] or None)
        # broadcast tracer over all telemeter tracers (ref:
        # linkerd_tpu/linker.py:652-662, Linker.scala:152-157)
        tracers = [t.tracer for t in self.telemeters if t.tracer is not None]
        self.tracer = BroadcastTracer(tracers) if tracers else NullTracer()
        if tracers:
            # span-producing telemeters (the anomaly micro-batcher emits
            # scorer spans) get the assembled sink; with no tracer
            # configured they stay silent
            for t in self.telemeters:
                if hasattr(t, "set_tracer"):
                    t.set_tracer(self.tracer)

        labels_seen: Dict[str, int] = {}
        for rspec in self.spec.routers:
            if rspec.protocol in REFUSED_PROTOCOLS:
                raise _refusal(f"protocol {rspec.protocol!r}",
                               REFUSED_PROTOCOLS[rspec.protocol])
            if rspec.protocol not in (
                    "http", "h2", "thrift", "mux", "thriftmux"):
                raise ConfigError(
                    f"protocol {rspec.protocol!r} not yet supported")
            label = rspec.label or rspec.protocol
            n = labels_seen.get(label, 0)
            labels_seen[label] = n + 1
            if n:
                label = f"{label}-{n}"
            # the thrift and mux routers take neither the native engine
            # nor these keys: they refuse tenants in the reference's own
            # words and, as the reference's, leave the rest unread
            if rspec.protocol in ("http", "h2"):
                if rspec.fastPath:
                    self._check_fastpath_spec(rspec, label)
                for key, item in REFUSED_ROUTER_KEYS.items():
                    value = getattr(rspec, key)
                    if value is not None and value is not False:
                        raise _refusal(f"{label}.{key}", item)
            for i, s in enumerate(rspec.servers or []):
                if s.compressionLevel is None:
                    continue
                if not -1 <= s.compressionLevel <= 9:
                    raise ConfigError(
                        f"{label}.servers[{i}].compressionLevel must be "
                        f"in -1..9, got {s.compressionLevel}")
                if rspec.protocol != "http":
                    raise ConfigError(
                        f"{label}.servers[{i}].compressionLevel only "
                        f"supports http routers")
            if rspec.protocol == "h2":
                self.routers.append(self._mk_h2_router(rspec, label))
            elif rspec.protocol == "thrift":
                self.routers.append(self._mk_thrift_router(rspec, label))
            elif rspec.protocol in ("mux", "thriftmux"):
                self.routers.append(self._mk_mux_router(
                    rspec, label,
                    thrift_semantics=(rspec.protocol == "thriftmux")))
            else:
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
    def _mk_interpreter(self, rspec: RouterSpec, label: str):
        if rspec.interpreter is not None:
            return _instantiate(
                "interpreter", rspec.interpreter,
                f"{label}.interpreter").mk(self.namers)
        return ConfiguredDtabNamer(self.namers)

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
                spec.tls.validate(var_names)
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
                             routing: Service, shared_stack: Service,
                             clear_filter: Optional[Callable] = None):
        """The optional per-server TimeoutFilter (ref
        ServerConfig.timeoutMs, Server.scala:85,96) sits INNERMOST —
        below the responder and stats filters, so the mapped 504 is
        observed by metrics like any other response — and clearContext
        strips headers outermost with the protocol's ``clear_filter``."""
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
            if s.clearContext and clear_filter is not None:
                chain.insert(0, clear_filter())
            return filters_to_service(chain, routing)

        return per_server

    def _fastpath_client_tls(self, rspec: RouterSpec,
                             label: str) -> Optional[TlsClientConfig]:
        """The router-wide client.tls block for a fastPath router, or
        None. The native engine originates TLS per-endpoint with the
        route authority as SNI/verified name, so only the router-wide
        subset is honored: disableValidation + trustCerts. Per-prefix
        (io.l5d.static) TLS, commonName templates, and clientAuth have
        no native seam — refuse them rather than silently downgrade."""
        raw = rspec.client
        if not isinstance(raw, dict):
            return None
        if raw.get("kind") == "io.l5d.static":
            if any(isinstance(c, dict) and "tls" in c
                   for c in (raw.get("configs") or [])):
                raise ConfigError(
                    f"{label}: per-prefix client.tls (io.l5d.static) is "
                    f"not supported with fastPath: true")
            return None
        if "tls" not in raw:
            return None
        spec = instantiate_as(TlsClientConfig, raw["tls"] or {},
                              f"{label}.client.tls")
        if spec.clientAuth is not None:
            raise ConfigError(
                f"{label}.client.tls: clientAuth is not supported with "
                f"fastPath: true")
        if spec.commonName is not None:
            raise ConfigError(
                f"{label}.client.tls: commonName is not supported with "
                f"fastPath: true (the native engine verifies each "
                f"endpoint against its route authority)")
        return spec

    def _check_fastpath_spec(self, rspec: RouterSpec, label: str) -> None:
        """Refuse config the native engine cannot honor — silently
        dropping an operator's TLS or policy block would be worse than
        failing the load; the reference's own refusals, word for
        word."""
        self._fastpath_client_tls(rspec, label)  # raises on bad subsets
        for i, srv in enumerate(rspec.servers or []):
            if srv.tls is not None and srv.tls.caCertPath:
                raise ConfigError(
                    f"{label}.servers[{i}].tls: caCertPath (client-cert "
                    f"verification) is not supported with fastPath: true")
        if rspec.service:
            raise ConfigError(
                f"{label}: service policy (classifier/retries/timeout) "
                f"is not supported with fastPath: true")
        if rspec.loggers:
            # the native engine has no Python per-request hook; an
            # ignored audit log is worse than a load failure
            raise ConfigError(
                f"{label}: loggers are not supported with fastPath: true")
        if rspec.admissionControl is not None:
            raise ConfigError(
                f"{label}: admissionControl is not supported with "
                f"fastPath: true (the native engine has no Python "
                f"per-request hook to enforce it)")
        for i, srv in enumerate(rspec.servers or []):
            if srv.timeoutMs is not None and rspec.protocol != "h2":
                # the h2 engine exposes fph2_set_response_timeout_ms
                # (plumbed in _mk_fastpath_router); the h1 engine has
                # no per-response timeout setter, so reject rather
                # than silently drop the knob
                raise ConfigError(
                    f"{label}.servers[{i}].timeoutMs is not supported "
                    f"with fastPath: true on http/1.1 (the engine "
                    f"applies its own timeouts); h2 fastPath honors it")
            if srv.compressionLevel:
                raise ConfigError(
                    f"{label}.servers[{i}].compressionLevel is not "
                    f"supported with fastPath: true (the native engine "
                    f"proxies bodies byte-for-byte)")

    @staticmethod
    def _resolve_workers(rspec: RouterSpec, label: str) -> int:
        """The ``workers`` knob -> a concrete shard count: None -> 1
        (bit-compatible single engine), 0 -> auto = min(4, hw cores),
        N -> N (validated)."""
        raw = rspec.workers
        if raw is None:
            return 1
        from linkerd_tpu_torch import native
        n = int(raw)
        if n == 0:
            n = native.auto_workers()
        if not 1 <= n <= native.FastPathEngine.MAX_WORKERS:
            raise ConfigError(
                f"{label}.workers must be 0 (auto) or in "
                f"1..{native.FastPathEngine.MAX_WORKERS}, got {raw}")
        return n

    def _mk_fastpath_router(self, rspec: RouterSpec,
                            label: str) -> Optional[Router]:
        """An http or h2 router served by a native engine (fastPath:
        true). The engine owns the listeners and the request hot loop;
        naming, stats, and anomaly features flow through
        FastPathController. The h2 engine (native/h2_fastpath.cpp)
        proxies h2/gRPC frames with HPACK and both flow-control levels;
        the http engine (native/fastpath.cpp) proxies HTTP/1.1. Both
        terminate and originate TLS natively (tls_engine.h memory-BIO
        pump) when the OpenSSL runtime is present. The router's client
        and identifier blocks are not read (the engine routes by Host or
        ``:authority``), as in the reference.

        Returns None when the spec needs TLS but the OpenSSL runtime
        could not be loaded — the caller then assembles the Python
        router, which serves TLS on its own data plane."""
        from linkerd_tpu_torch import native
        from linkerd_tpu_torch.router.fastpath import FastPathController

        try:  # (the spec was checked before the by-name refusals)
            native.ensure_built()
        except (RuntimeError, OSError, AttributeError) as e:
            raise ConfigError(
                f"{label}: fastPath requires the native library ({e})"
            ) from None
        engine_cls = (native.H2FastPathEngine if rspec.protocol == "h2"
                      else native.FastPathEngine)
        workers = self._resolve_workers(rspec, label)
        specs = rspec.servers or [ServerSpec()]
        client_tls = self._fastpath_client_tls(rspec, label)
        tls_servers = [s for s in specs if s.tls is not None]
        if (tls_servers or client_tls is not None) \
                and not engine_cls.tls_runtime_available():
            log.warning(
                "%s: fastPath TLS requested but the OpenSSL runtime is "
                "unavailable natively; serving this router on the "
                "Python data plane instead", label)
            return None
        # one accept-leg identity per engine: distinct cert pairs across
        # a router's servers have no native seam
        pairs = {(s.tls.certPath, s.tls.keyPath) for s in tls_servers}
        if len(pairs) > 1:
            raise ConfigError(
                f"{label}: fastPath servers must share one TLS "
                f"cert/key pair (got {len(pairs)} distinct pairs)")
        base_dtab = Dtab.read(rspec.dtab) if rspec.dtab else Dtab.empty()
        prefix = Path.read(rspec.dstPrefix)
        interpreter = self._mk_interpreter(rspec, label)
        engine = engine_cls(workers=workers)
        try:
            sentinel = self._configure_engine(
                engine, rspec, label, tls_servers, client_tls)
            ports = [engine.listen_tls(s.ip, s.port) if s.tls is not None
                     else engine.listen(s.ip, s.port) for s in specs]
        except BaseException:
            engine.close()
            raise
        ctl = FastPathController(
            engine, interpreter, base_dtab, prefix, label, self.metrics,
            telemeters=self.telemeters, stream_sentinel=sentinel)
        return _FastPathRouter(rspec, label, ctl, ports,
                               interpreter=interpreter)

    def _configure_engine(self, engine, rspec: RouterSpec, label: str,
                          tls_servers, client_tls):
        """The engine's TLS identity and client TLS, its connection
        guard (with the h2 engine's flood caps), its stream sentinel and
        the h2 engine's response timeout, before it starts; returns the
        Python sentinel that mirrors the engine's sample rows (None
        without ``streamScoring``)."""
        if tls_servers:
            tls = tls_servers[0].tls
            if not tls.certPath or not tls.keyPath:
                raise ConfigError(
                    f"{label}.servers[].tls needs certPath and keyPath")
            try:
                engine.set_tls(tls.certPath, tls.keyPath)
            except OSError as e:
                raise ConfigError(f"{label}.servers[].tls: {e}") from None
        if client_tls is not None:
            ca = self._trust_bundle(client_tls.trustCerts, label)
            try:
                engine.set_client_tls(
                    verify=not client_tls.disableValidation, ca_path=ca)
            except OSError as e:
                raise ConfigError(f"{label}.client.tls: {e}") from None
        guard = rspec.connectionGuard
        if guard is not None:
            guard.validate(f"{label}.connectionGuard")
            engine.set_guard(
                header_budget_ms=guard.headerBudgetMs,
                body_stall_ms=guard.bodyStallMs,
                accept_burst=guard.acceptBurst,
                accept_window_ms=guard.acceptWindowMs,
                max_hs_inflight=guard.maxHandshakesInflight)
            if rspec.protocol == "h2":
                engine.set_flood_guard(
                    max_streams=guard.maxStreamsPerConnection,
                    rst_burst=guard.rstBurst,
                    ping_burst=guard.pingBurst,
                    settings_burst=guard.settingsBurst,
                    window_ms=guard.floodWindowMs)
                if guard.tunnelIdleMs or guard.tunnelMaxBytes:
                    # h2 carries no byte tunnels (CONNECT/101 are an
                    # h1 shape); the knobs are inert here
                    log.warning(
                        "%s.connectionGuard: tunnelIdleMs/"
                        "tunnelMaxBytes are ignored on h2 routers",
                        label)
            elif guard.tunnelIdleMs or guard.tunnelMaxBytes:
                engine.set_tunnel_guard(idle_ms=guard.tunnelIdleMs,
                                        max_bytes=guard.tunnelMaxBytes)
        if rspec.protocol == "h2":
            timeouts = [s.timeoutMs for s in (rspec.servers or [])
                        if s.timeoutMs is not None]
            if timeouts:
                # the engine timeout is per-engine, not per-listener:
                # the strictest server bound wins
                engine.set_response_timeout_ms(min(timeouts))
        if rspec.streamScoring is None:
            return None
        ss = rspec.streamScoring
        ss.validate(f"{label}.streamScoring")
        engine.set_stream_cfg(
            enabled=True,
            sample_every_frames=ss.sampleEveryFrames,
            min_gap_ms=ss.minGapMs, table_cap=ss.tableCap,
            enter=ss.enter, exit=ss.exit, quorum=ss.quorum,
            dwell_ms=ss.dwellMs, action=ss.action)
        # the native plane actuates in-flight (tunnel close); the
        # Python sentinel mirrors the drained sample rows for the admin
        # view and any drain/quota escalation — observe mode so sick
        # streams are never shot twice
        from linkerd_tpu_torch.streams import StreamSentinel
        return StreamSentinel(
            enter=ss.enter, exit=ss.exit, quorum=ss.quorum,
            dwell_s=ss.dwellMs / 1000.0, table_cap=ss.tableCap,
            action="observe")

    def _trust_bundle(self, trust_certs: List[str],
                      label: str) -> Optional[str]:
        """trustCerts -> one CA file for the native client context (the
        OpenSSL API takes a single location): pass-through for one path,
        concatenated bundle (linker-owned tempfile) for several, None
        (default roots) for none."""
        if not trust_certs:
            return None
        if len(trust_certs) == 1:
            return trust_certs[0]
        import tempfile
        # binary passthrough: distro bundles and `openssl -text` output
        # carry non-ASCII preamble bytes OpenSSL happily skips
        bundle = tempfile.NamedTemporaryFile(
            mode="wb", suffix=".pem", prefix="l5d-trust-", delete=False)
        try:
            for path in trust_certs:
                with open(path, "rb") as fh:
                    bundle.write(fh.read())
                    bundle.write(b"\n")
        except OSError as e:
            raise ConfigError(f"{label}.client.tls.trustCerts: {e}") \
                from None
        finally:
            bundle.close()
        self._trust_bundles.append(bundle.name)
        return bundle.name

    def _close_trust_bundles(self) -> None:
        import os
        for path in self._trust_bundles:
            try:
                os.unlink(path)
            except OSError:
                pass
        self._trust_bundles.clear()

    def _mk_http_router(self, rspec: RouterSpec, label: str) -> Router:
        if rspec.fastPath:
            router = self._mk_fastpath_router(rspec, label)
            if router is not None:
                return router
            # TLS requested but no native OpenSSL runtime: fall through
            # to the Python data plane (graceful gate)
        base_dtab = Dtab.read(rspec.dtab) if rspec.dtab else Dtab.empty()
        prefix = Path.read(rspec.dstPrefix)
        identifier = self._mk_identifier(
            rspec, label, "identifier", "io.l5d.header.token",
            prefix, base_dtab)
        interpreter = self._mk_interpreter(rspec, label)
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
            cspec, cvars = client_lookup(bound.id_)
            mk_policy = mk_policy_factory(cspec)
            ep_wrap, extra_filters = self._client_stack_extras(
                cspec, label, cid)

            # client TLS with the path's captures substituted into the
            # commonName (ref: linkerd_tpu/linker.py:1842-1852)
            ssl_ctx = sni = None
            if cspec.tls is not None:
                sni = cspec.tls.server_hostname(cvars)
                ssl_ctx = cspec.tls.mk_context(sni)

            def endpoint_factory(addr: Address) -> Service:
                client: Service = HttpClient(
                    addr.host, addr.port,
                    max_connections=cspec.hostConnectionPool,
                    connect_timeout=cspec.connectTimeoutMs / 1e3,
                    ssl_context=ssl_ctx, server_hostname=sni)
                # per-endpoint accrual (ref: FailureAccrualFactory sits below
                # the balancer in the client stack, Router.scala:318)
                return FailureAccrualService(ep_wrap(client),
                                             mk_policy())

            bal_kind = (cspec.loadBalancer or BalancerSpec()).kind
            bal = self._mk_balancer(bal_kind, bound.addr, endpoint_factory)
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
            # (ref: linkerd_tpu/linker.py:1877-1879)
            if not isinstance(self.tracer, NullTracer):
                filters.append(ClientTraceFilter(self.tracer, cid))
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

        routing = self._mk_routing(identifier, binding, base_dtab)
        # Stats outermost so they observe ErrorResponder's mapped statuses;
        # anomaly feature recorders tap the same final view. The stage
        # timer sits just inside the trace filter so span tags see the
        # completed per-stage totals (ref: linkerd_tpu/linker.py:1938-1949).
        server_filters: List[Any] = [
            StageTimerFilter(metrics, "rt", label),
            StatsFilter(metrics, "rt", label, "server"),
            StatusCodeStatsFilter(metrics, "rt", label, "server"),
        ]
        if not isinstance(self.tracer, NullTracer):
            # only pay per-request span construction when a sink exists
            server_filters.insert(
                0, ServerTraceFilter(self.tracer, label, rspec.sampleRate))
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
        # INSIDE the responder: an expired deadline must map to 504, a
        # shed to 503
        server_filters.extend(self._edge_resilience_filters(rspec, label))
        server_stack = filters_to_service(server_filters, routing)

        per_server_stack = self._per_server_stack_fn(
            label, server_filters, routing, server_stack,
            clear_filter=ClearContextFilter)

        servers = [
            HttpServer(per_server_stack(s), s.ip, s.port,
                       max_concurrency=s.maxConcurrentRequests,
                       ssl_context=(s.tls.mk_context() if s.tls else None),
                       compression_level=s.compressionLevel)
            for s in (rspec.servers or [ServerSpec()])
        ]
        return Router(rspec, label, server_stack, binding, servers,
                      interpreter=interpreter,
                      identifier=identifier)

    def _mk_h2_router(self, rspec: RouterSpec, label: str) -> Router:
        """h2 router: stream-aware stats/retries/classification (ref:
        router/h2 H2.scala:16-105 + linkerd/protocol/h2 H2Config;
        linkerd_tpu/linker.py:777-1010). With ``fastPath: true`` the
        native h2 engine serves it (``_mk_fastpath_router``)."""
        from linkerd_tpu_torch.protocol.h2.client import H2Client
        from linkerd_tpu_torch.protocol.h2.server import H2Server
        from linkerd_tpu_torch.router.h2_layer import (
            H2ClassifiedRetries, H2ClassifierFilter, H2ClearContextFilter,
            H2ErrorResponder, H2StreamStatsFilter,
        )

        if rspec.fastPath:
            # the native engine speaks fixed SETTINGS (16384 frames, 4MB
            # stream / 16MB conn windows); silently dropping configured
            # values would be worse than refusing them (same stance as
            # http fastPath vs loggers)
            for knob in ("maxFrameBytes", "initialStreamWindowBytes",
                         "maxHeaderListBytes",
                         "maxConcurrentStreamsPerConnection"):
                if getattr(rspec, knob) is not None:
                    raise ConfigError(
                        f"{label}: {knob} is not supported with "
                        f"fastPath: true (the native h2 engine uses "
                        f"fixed SETTINGS)")
            router = self._mk_fastpath_router(rspec, label)
            if router is not None:
                return router
            # TLS requested but no native OpenSSL runtime: fall through
            # to the Python data plane (graceful gate)
        base_dtab = Dtab.read(rspec.dtab) if rspec.dtab else Dtab.empty()
        prefix = Path.read(rspec.dstPrefix)
        # advertised SETTINGS for both sides (ref: H2Config.scala params);
        # validated here so a bad value fails config load, not every
        # connection at its SETTINGS exchange
        if rspec.maxFrameBytes is not None and not (
                16384 <= rspec.maxFrameBytes <= (1 << 24) - 1):
            raise ConfigError(
                f"{label}.maxFrameBytes must be in 16384..16777215 "
                f"(RFC 7540 §6.5.2), got {rspec.maxFrameBytes}")
        if rspec.initialStreamWindowBytes is not None and not (
                0 < rspec.initialStreamWindowBytes <= (1 << 31) - 1):
            raise ConfigError(
                f"{label}.initialStreamWindowBytes must be in 1..2^31-1, "
                f"got {rspec.initialStreamWindowBytes}")
        if (rspec.maxHeaderListBytes is not None
                and rspec.maxHeaderListBytes <= 0):
            raise ConfigError(f"{label}.maxHeaderListBytes must be > 0")
        if (rspec.maxConcurrentStreamsPerConnection is not None
                and rspec.maxConcurrentStreamsPerConnection < 1):
            raise ConfigError(
                f"{label}.maxConcurrentStreamsPerConnection must be >= 1")
        h2_settings = {k: v for k, v in {
            "initial_window": rspec.initialStreamWindowBytes,
            "max_frame": rspec.maxFrameBytes,
            "max_header_list": rspec.maxHeaderListBytes,
            "max_concurrent_streams":
                rspec.maxConcurrentStreamsPerConnection,
        }.items() if v is not None}
        identifier = self._mk_identifier(
            rspec, label, "h2identifier", "io.l5d.header.token",
            prefix, base_dtab)
        interpreter = self._mk_interpreter(rspec, label)
        validate_svc = self._mk_svc_validator(label, "h2classifier")

        def _client_has(raw, name: str) -> bool:
            if not isinstance(raw, dict):
                return False
            if raw.get("kind") == "io.l5d.static":
                return any(isinstance(c, dict) and name in c
                           for c in (raw.get("configs") or []))
            return name in raw

        if _client_has(rspec.client, "requeueBudget"):
            # a requeued h2 request would replay an already-consumed
            # one-shot stream; the buffered-replay machinery lives in
            # service retries (H2ClassifiedRetries)
            raise ConfigError(
                f"{label}: client.requeueBudget is not supported on h2 "
                f"routers; use service retries (buffered replay)")
        client_lookup = per_prefix_lookup(
            rspec.client, ClientSpec, f"{label}.client",
            self._mk_client_validator(label))
        metrics = self.metrics
        mk_policy_factory = self._mk_policy_factory_fn(label)

        def client_factory(bound: BoundName) -> Service:
            code = _status_code_of(bound)
            if code is not None:
                from linkerd_tpu_torch.protocol.h2.messages import H2Response
                from linkerd_tpu_torch.protocol.h2.stream import stream_of

                async def const_status(req, _c=code):
                    return H2Response(status=_c, stream=stream_of(b""))

                return FnService(const_status)
            cid = bound.id_.show.lstrip("/").replace("/", ".") or "client"
            cspec, cvars = client_lookup(bound.id_)
            mk_policy = mk_policy_factory(cspec)
            ep_wrap, extra_filters = self._client_stack_extras(
                cspec, label, cid)
            ssl_ctx = sni = None
            if cspec.tls is not None:
                sni = cspec.tls.server_hostname(cvars)
                ssl_ctx = cspec.tls.mk_context(sni)

            def endpoint_factory(addr: Address) -> Service:
                client: Service = H2Client(
                    addr.host, addr.port,
                    connect_timeout=cspec.connectTimeoutMs / 1e3,
                    ssl_context=ssl_ctx, server_hostname=sni,
                    h2_settings=h2_settings)
                return FailureAccrualService(ep_wrap(client),
                                             mk_policy())

            bal_kind = (cspec.loadBalancer or BalancerSpec()).kind
            bal = self._mk_balancer(bal_kind, bound.addr,
                                    endpoint_factory)
            filters: List[Any] = [
                H2StreamStatsFilter(metrics, "rt", label, "client", cid),
                ClientDeadlineFilter()]
            filters.extend(extra_filters)
            if not isinstance(self.tracer, NullTracer):
                # h2 carries l5d-ctx-trace as a plain header like http
                filters.append(ClientTraceFilter(self.tracer, cid))
            metrics.scope("rt", label, "client", cid).gauge(
                "endpoints", fn=lambda b=bal: b.size)
            return _PruneOnClose(
                filters_to_service(filters, bal), metrics,
                ("rt", label, "client", cid))

        svc_lookup = per_prefix_lookup(
            rspec.service, SvcSpec, f"{label}.service", validate_svc)
        mk_backoffs = self._mk_backoffs

        def path_filters(dst: DstPath, svc: Service) -> Service:
            sspec, _ = svc_lookup(dst.path)
            classifier_cfg = sspec.responseClassifier or {
                "kind": "io.l5d.h2.nonRetryable5XX"}
            classifier = instantiate(
                "h2classifier", classifier_cfg,
                f"{label}.responseClassifier").mk()
            budget_spec = (
                sspec.retries.budget if sspec.retries else None) or BudgetSpec()
            budget = RetryBudget(
                budget_spec.ttlSecs, budget_spec.minRetriesPerSec,
                budget_spec.percentCanRetry)
            name = dst.path.show.lstrip("/").replace("/", ".") or "root"
            filters: List[Any] = [
                # outermost: stamp l5d-success-class from the class the
                # retries filter recorded for the returned stream
                H2ClassifierFilter(),
                H2StreamStatsFilter(metrics, "rt", label, "service", name)]
            # deadline-aware total timeout (see the http twin)
            filters.append(DeadlineFilter(
                sspec.totalTimeoutMs / 1e3
                if sspec.totalTimeoutMs is not None else None))
            filters.append(H2ClassifiedRetries(
                classifier, budget, mk_backoffs(sspec),
                max_retries=(sspec.retries.maxRetries
                             if sspec.retries else 25),
                metrics=metrics, scope=("rt", label, "service", name),
                rsp_hold_s=sspec.classificationTimeoutMs / 1e3))
            return filters_to_service(filters, svc)

        cache_cfg = rspec.bindingCache or {}
        binding = DstBindingFactory(
            interpreter, client_factory, path_filters=path_filters,
            capacity=int(cache_cfg.get("capacity", 1000)),
            idle_ttl=float(cache_cfg.get("idleTtlSecs", 600.0)),
            bind_timeout=rspec.bindingTimeoutMs / 1e3)

        routing = self._mk_routing(identifier, binding, base_dtab)
        server_filters: List[Any] = [
            StageTimerFilter(metrics, "rt", label),
            H2StreamStatsFilter(metrics, "rt", label, "server"),
        ]
        if not isinstance(self.tracer, NullTracer):
            server_filters.insert(
                0, ServerTraceFilter(self.tracer, label, rspec.sampleRate))
        for t in self.telemeters:
            if hasattr(t, "recorder"):
                server_filters.append(t.recorder())
        server_filters.append(H2ErrorResponder())
        # INSIDE the responder: DeadlineExceeded -> 504/DEADLINE_EXCEEDED,
        # OverloadShed -> RST_STREAM REFUSED_STREAM
        server_filters.extend(self._edge_resilience_filters(rspec, label))
        server_stack = filters_to_service(server_filters, routing)

        per_server_stack = self._per_server_stack_fn(
            label, server_filters, routing, server_stack,
            clear_filter=H2ClearContextFilter)

        # stream sentinel on the Python h2 data plane: one shared
        # governor/table per router, one frame observer per accepted
        # connection. As in the reference, the observer gets no scorer:
        # this sentinel only observes (it samples each stream's frame
        # counters into its table and governor)
        mk_observer = None
        if rspec.streamScoring is not None:
            ss = rspec.streamScoring
            ss.validate(f"{label}.streamScoring")
            import itertools

            from linkerd_tpu_torch.streams import StreamSentinel
            from linkerd_tpu_torch.streams.observer import H2FrameObserver
            sentinel = StreamSentinel(
                enter=ss.enter, exit=ss.exit, quorum=ss.quorum,
                dwell_s=ss.dwellMs / 1000.0, table_cap=ss.tableCap,
                action=ss.action)
            skeys = itertools.count(1)
            self.metrics.scope("rt", label, "streams").gauge(
                "count", fn=lambda s=sentinel: float(len(s)))
            self.stream_sentinels.append((label, sentinel))

            def mk_observer(_ss=ss, _sent=sentinel, _sk=skeys):
                return H2FrameObserver(
                    _sent, next_skey=lambda: next(_sk),
                    sample_every_frames=_ss.sampleEveryFrames,
                    min_gap_ms=_ss.minGapMs, action=_ss.action,
                    dst_path=rspec.dstPrefix)
        servers = [
            H2Server(per_server_stack(s), s.ip, s.port,
                     max_concurrency=s.maxConcurrentRequests,
                     ssl_context=(s.tls.mk_context() if s.tls else None),
                     h2_settings=h2_settings,
                     stream_observer_factory=mk_observer)
            for s in (rspec.servers or [ServerSpec()])
        ]
        return Router(rspec, label, server_stack, binding, servers,
                      interpreter=interpreter)

    def _mk_mux_router(self, rspec: RouterSpec, label: str,
                       thrift_semantics: bool) -> Router:
        """mux / thriftmux routers (ref: router/mux Mux.scala:83 +
        router/thriftmux ThriftMux.scala:66). mux identifies by the
        Tdispatch ``dest`` path; thriftmux identifies like thrift
        (static dst, or the thrift method with thriftMethodInDst)."""
        from linkerd_tpu_torch.protocol.mux.client import MuxClient
        from linkerd_tpu_torch.protocol.mux.codec import Tdispatch
        from linkerd_tpu_torch.protocol.mux.server import MuxServer
        from linkerd_tpu_torch.protocol.thrift.codec import parse_message_header

        for i, s in enumerate(rspec.servers or []):
            if s.tls is not None or s.clearContext or \
                    s.maxConcurrentRequests is not None:
                raise ConfigError(
                    f"{label}.servers[{i}]: tls/clearContext/"
                    f"maxConcurrentRequests not supported for "
                    f"{rspec.protocol} servers")
        if rspec.admissionControl is not None:
            raise ConfigError(
                f"{label}: admissionControl is only supported on "
                f"http/h2 routers")
        if rspec.tenantIdentifier is not None or rspec.tenants is not None \
                or rspec.connectionGuard is not None \
                or rspec.streamScoring is not None:
            raise ConfigError(
                f"{label}: tenantIdentifier/tenants/connectionGuard/"
                f"streamScoring are only supported on http/h2 routers")

        base_dtab = Dtab.read(rspec.dtab) if rspec.dtab else Dtab.empty()
        prefix = Path.read(rspec.dstPrefix)
        method_in_dst = rspec.thriftMethodInDst

        def identifier(td: Tdispatch) -> DstPath:
            local = Dtab.empty()
            if td.dtab:
                try:
                    local = Dtab.read(";".join(
                        f"{src} => {dst}" for src, dst in td.dtab))
                except ValueError as e:
                    raise IdentificationError(
                        f"bad mux dtab: {e}") from None
            if thrift_semantics:
                seg = "thriftmux"
                if method_in_dst:
                    try:
                        seg, _, _ = parse_message_header(td.payload)
                    except Exception:  # noqa: BLE001
                        raise IdentificationError(
                            "unparseable thrift message") from None
                return DstPath(prefix + Path.of(seg), base_dtab, local)
            if td.dest.startswith("/"):
                return DstPath(prefix + Path.read(td.dest),
                               base_dtab, local)
            return DstPath(prefix + Path.of("mux"), base_dtab, local)

        interpreter = self._mk_interpreter(rspec, label)
        client_lookup = per_prefix_lookup(
            rspec.client, ClientSpec, f"{label}.client",
            self._mk_client_validator(label))
        metrics = self.metrics
        mk_policy_factory = self._mk_policy_factory_fn(label)

        MuxStatsFilter = BasicStatsFilter

        class _MuxEncodeResidual(Filter):
            """The downstream Tdispatch carries the BOUND residual path
            as its dest — not the client-sent logical dest — and no dtab
            (the local dtab was consumed during binding; re-sending it
            would double-apply). Ref: MuxEncodeResidual.scala:1-18."""

            def __init__(self, residual: Path):
                self._dest = residual.show if len(residual) else "/"

            async def apply(self, td: Tdispatch, service: Service):
                # ctx rides along: the client trace filter below this
                # layer reads td.ctx["trace"] to propagate the span
                return await service(Tdispatch(
                    td.tag, td.contexts, self._dest, [], td.payload,
                    td.ctx))

        def client_factory(bound: BoundName) -> Service:
            if _status_code_of(bound) is not None:
                raise ConfigError(
                    "/$/io.buoyant.http.status is only available to "
                    "http/h2 routers")
            cid = bound.id_.show.lstrip("/").replace("/", ".") or "client"
            cspec, _cvars = client_lookup(bound.id_)
            mk_policy = mk_policy_factory(cspec)
            ep_wrap, extra_filters = self._client_stack_extras(
                cspec, label, cid)

            def endpoint_factory(addr: Address) -> Service:
                client: Service = MuxClient(
                    addr.host, addr.port,
                    connect_timeout=cspec.connectTimeoutMs / 1e3)
                return FailureAccrualService(ep_wrap(client),
                                             mk_policy())

            bal_kind = (cspec.loadBalancer or BalancerSpec()).kind
            bal = self._mk_balancer(bal_kind, bound.addr,
                                    endpoint_factory)
            metrics.scope("rt", label, "client", cid).gauge(
                "endpoints", fn=lambda b=bal: b.size)
            client_filters: List[Any] = [
                MuxStatsFilter(metrics.scope("rt", label, "client", cid)),
                *extra_filters]
            if not isinstance(self.tracer, NullTracer):
                # propagate l5d-ctx-trace in the Tdispatch context
                # section (the mux analogue of the http header)
                client_filters.append(
                    MuxClientTraceFilter(self.tracer, cid))
            return _PruneOnClose(
                filters_to_service(client_filters, bal),
                metrics, ("rt", label, "client", cid))

        def bound_filters(bound: BoundName, svc: Service) -> Service:
            # the BOUND layer is keyed by (id, residual) — the client
            # layer below is shared across residuals, so the rewrite
            # must happen here (ref: Router.scala boundStack placement)
            if thrift_semantics:
                return svc
            return _MuxEncodeResidual(bound.residual).and_then(svc)

        svc_lookup = per_prefix_lookup(
            rspec.service, SvcSpec, f"{label}.service")

        def path_filters(dst: DstPath, svc: Service) -> Service:
            sspec, _ = svc_lookup(dst.path)
            name = dst.path.show.lstrip("/").replace("/", ".") or "root"
            filters: List[Any] = [MuxStatsFilter(
                metrics.scope("rt", label, "service", name))]
            if sspec.totalTimeoutMs is not None:
                filters.append(TotalTimeout(sspec.totalTimeoutMs / 1e3))
            return filters_to_service(filters, svc)

        cache_cfg = rspec.bindingCache or {}
        binding = DstBindingFactory(
            interpreter, client_factory, path_filters=path_filters,
            bound_filters=bound_filters,
            capacity=int(cache_cfg.get("capacity", 1000)),
            idle_ttl=float(cache_cfg.get("idleTtlSecs", 600.0)),
            bind_timeout=rspec.bindingTimeoutMs / 1e3)
        routing = self._mk_routing(identifier, binding, base_dtab)
        server_filters: List[Any] = [
            StageTimerFilter(metrics, "rt", label),
            MuxStatsFilter(metrics.scope("rt", label, "server"))]
        if not isinstance(self.tracer, NullTracer):
            server_filters.insert(0, MuxServerTraceFilter(
                self.tracer, label, rspec.sampleRate))
        server_stack = filters_to_service(server_filters, routing)
        per_server_stack = self._per_server_stack_fn(
            label, server_filters, routing, server_stack)
        servers = [
            MuxServer(per_server_stack(s), s.ip, s.port)
            for s in (rspec.servers or [ServerSpec()])
        ]
        return Router(rspec, label, server_stack, binding, servers,
                      interpreter=interpreter)

    def _mk_thrift_router(self, rspec: RouterSpec, label: str) -> Router:
        """Thrift router: static (or method) identification, framed
        transport passthrough (ref: router/thrift + ThriftInitializer)."""
        from linkerd_tpu_torch.protocol.thrift import ThriftCall, ThriftClient
        from linkerd_tpu_torch.protocol.thrift.codec import EXCEPTION
        from linkerd_tpu_torch.protocol.thrift.server import ThriftServer

        # reject config we'd otherwise silently ignore (a plaintext
        # listener the operator believes is TLS is worse than an error)
        for i, s in enumerate(rspec.servers or []):
            if s.tls is not None:
                raise ConfigError(f"{label}.servers[{i}].tls: "
                                  f"not supported for thrift servers")
            if s.maxConcurrentRequests is not None:
                raise ConfigError(
                    f"{label}.servers[{i}].maxConcurrentRequests: "
                    f"not supported for thrift servers")
            if s.clearContext:
                raise ConfigError(
                    f"{label}.servers[{i}].clearContext: "
                    f"not supported for thrift servers")

        if rspec.admissionControl is not None:
            raise ConfigError(
                f"{label}: admissionControl is only supported on "
                f"http/h2 routers")
        if rspec.tenantIdentifier is not None or rspec.tenants is not None \
                or rspec.connectionGuard is not None \
                or rspec.streamScoring is not None:
            raise ConfigError(
                f"{label}: tenantIdentifier/tenants/connectionGuard/"
                f"streamScoring are only supported on http/h2 routers")
        if rspec.thriftProtocol not in ("binary", "compact"):
            raise ConfigError(
                f"{label}.thriftProtocol must be binary or compact, "
                f"got {rspec.thriftProtocol!r}")
        if not rspec.thriftFramed and rspec.thriftProtocol != "binary":
            raise ConfigError(
                f"{label}: thriftFramed: false requires "
                f"thriftProtocol: binary (the buffered transport scans "
                f"binary-protocol message boundaries)")

        base_dtab = Dtab.read(rspec.dtab) if rspec.dtab else Dtab.empty()
        prefix = Path.read(rspec.dstPrefix)
        method_in_dst = rspec.thriftMethodInDst

        def identifier(call: ThriftCall) -> DstPath:
            seg = call.name if method_in_dst else "thrift"
            # an upgraded caller's dtab delegations act as the local dtab
            # (the thrift analogue of the l5d-dtab header)
            local = call.ctx.get("dtab") or Dtab.empty()
            return DstPath(prefix + Path.of(seg), base_dtab, local)

        interpreter = self._mk_interpreter(rspec, label)
        client_lookup = per_prefix_lookup(
            rspec.client, ClientSpec, f"{label}.client",
            self._mk_client_validator(label))
        metrics = self.metrics
        mk_policy_factory = self._mk_policy_factory_fn(label)

        def thrift_classifier(req, rsp, exc):
            from linkerd_tpu_torch.router.classifiers import ResponseClass
            from linkerd_tpu_torch.protocol.thrift.codec import parse_header
            if exc is not None:
                return ResponseClass.RETRYABLE_FAILURE \
                    if isinstance(exc, ConnectionError) \
                    else ResponseClass.FAILURE
            try:
                _, _, mtype = parse_header(rsp or b"",
                                           rspec.thriftProtocol)
                if mtype == EXCEPTION:
                    return ResponseClass.FAILURE
            except Exception:  # noqa: BLE001 - unparseable: assume ok
                pass
            return ResponseClass.SUCCESS

        from linkerd_tpu_torch.router.classifiers import ResponseClass

        def ThriftStatsFilter(node):
            return BasicStatsFilter(
                node, classify=lambda req, rsp: thrift_classifier(
                    req, rsp, None) is ResponseClass.SUCCESS)

        def client_factory(bound: BoundName) -> Service:
            if _status_code_of(bound) is not None:
                raise ConfigError(
                    "/$/io.buoyant.http.status is only available to "
                    "http/h2 routers")
            cid = bound.id_.show.lstrip("/").replace("/", ".") or "client"
            cspec, _cvars = client_lookup(bound.id_)
            mk_policy = mk_policy_factory(cspec)
            ep_wrap, extra_filters = self._client_stack_extras(
                cspec, label, cid)

            def endpoint_factory(addr: Address) -> Service:
                client: Service = ThriftClient(
                    addr.host, addr.port,
                    connect_timeout=cspec.connectTimeoutMs / 1e3,
                    attempt_ttwitter=rspec.attemptTTwitterUpgrade,
                    dest=bound.id_.show, client_id=label,
                    framed=rspec.thriftFramed,
                    protocol=rspec.thriftProtocol)
                return FailureAccrualService(ep_wrap(client),
                                             mk_policy())

            bal_kind = (cspec.loadBalancer or BalancerSpec()).kind
            bal = self._mk_balancer(bal_kind, bound.addr,
                                    endpoint_factory)
            metrics.scope("rt", label, "client", cid).gauge(
                "endpoints", fn=lambda b=bal: b.size)
            return _PruneOnClose(
                filters_to_service(
                    [ThriftStatsFilter(
                        metrics.scope("rt", label, "client", cid)),
                     *extra_filters], bal),
                metrics, ("rt", label, "client", cid))

        svc_lookup = per_prefix_lookup(
            rspec.service, SvcSpec, f"{label}.service")

        def path_filters(dst: DstPath, svc: Service) -> Service:
            sspec, _ = svc_lookup(dst.path)
            budget_spec = (
                sspec.retries.budget if sspec.retries else None) or BudgetSpec()
            budget = RetryBudget(
                budget_spec.ttlSecs, budget_spec.minRetriesPerSec,
                budget_spec.percentCanRetry)
            name = dst.path.show.lstrip("/").replace("/", ".") or "root"
            filters: List[Any] = [
                ThriftStatsFilter(metrics.scope("rt", label, "service", name))]
            if sspec.totalTimeoutMs is not None:
                filters.append(TotalTimeout(sspec.totalTimeoutMs / 1e3))
            filters.append(ClassifiedRetries(
                thrift_classifier, budget, self._mk_backoffs(sspec),
                max_retries=(sspec.retries.maxRetries
                             if sspec.retries else 25),
                metrics=metrics, scope=("rt", label, "service", name)))
            return filters_to_service(filters, svc)

        cache_cfg = rspec.bindingCache or {}
        binding = DstBindingFactory(
            interpreter, client_factory, path_filters=path_filters,
            capacity=int(cache_cfg.get("capacity", 1000)),
            idle_ttl=float(cache_cfg.get("idleTtlSecs", 600.0)),
            bind_timeout=rspec.bindingTimeoutMs / 1e3)
        routing = self._mk_routing(identifier, binding, base_dtab)
        server_filters: List[Any] = [
            StageTimerFilter(metrics, "rt", label),
            ThriftStatsFilter(metrics.scope("rt", label, "server"))]
        server_stack = filters_to_service(server_filters, routing)
        per_server_stack = self._per_server_stack_fn(
            label, server_filters, routing, server_stack)
        servers = [
            ThriftServer(per_server_stack(s), s.ip, s.port,
                         ttwitter=rspec.attemptTTwitterUpgrade,
                         framed=rspec.thriftFramed,
                         protocol=rspec.thriftProtocol)
            for s in (rspec.servers or [ServerSpec()])
        ]
        return Router(rspec, label, server_stack, binding, servers,
                      interpreter=interpreter)

    def _edge_resilience_filters(self, rspec: RouterSpec,
                                 label: str) -> List[Any]:
        """Server-edge resilience (http + h2): the deadline decode and
        expired shed, then admission control. The raisers sit INSIDE the
        protocol's error responder (appended AFTER it in the server
        filters), where DeadlineExceeded maps to 504/DEADLINE_EXCEEDED
        and OverloadShed to 503-retryable/REFUSED_STREAM. Single
        instances, shared across the router's servers: the concurrency
        bound is a router property. The reference's checks of a router
        on the Python data plane come first: the connection guard and
        the sharded workers live in the native engine. (The reference's
        tenant tagging waits on ``tenantIdentifier``, refused by
        name.)"""
        if rspec.connectionGuard is not None:
            raise ConfigError(
                f"{label}: connectionGuard requires fastPath: true "
                f"(the defenses live in the native engines)")
        if rspec.workers is not None:
            if not rspec.fastPath:
                raise ConfigError(
                    f"{label}: workers requires fastPath: true (the "
                    f"sharded epoll workers are the native engines; "
                    f"the asyncio data plane is single-loop)")
            # fastPath requested but the router fell back to the Python
            # data plane (no native TLS runtime): the knob is inert
            # there, which the operator should see but not die on
            log.warning(
                "%s: workers is ignored on the Python data-plane "
                "fallback (no native TLS runtime)", label)
        filters: List[Any] = [ServerDeadlineFilter(
            self.metrics.scope("rt", label, "server", "deadline"))]
        ac = rspec.admissionControl
        if ac is not None:
            try:
                admission = AdmissionControlFilter(
                    ac.maxConcurrency, ac.maxPending,
                    self.metrics.scope("rt", label, "server",
                                       "admission"))
            except ValueError as e:
                raise ConfigError(
                    f"{label}.admissionControl: {e}") from None
            # the control loop modulates this bound from score trends +
            # the drift monitor (shed earlier when trouble is coming)
            ctl = self._anomaly_control()
            if ctl is not None:
                ctl.register_admission(admission)
            filters.append(admission)
        return filters

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

    def _anomaly_control(self):
        """The jaxAnomaly telemeter's ControlLoop (None unless a
        ``control:`` block is configured)."""
        tele = self._anomaly_telemeter()
        return getattr(tele, "control", None) if tele is not None else None

    def _mk_routing(self, identifier, binding, base_dtab):
        """Build a router's RoutingService, wired into the control
        loop's partition-time override book when one exists: booked
        overrides reach requests through the local-dtab seam, and the
        failover binds they would route through are registered for
        prewarming (a bind that first opens DURING a store partition
        cannot resolve; a warm one holds its last-good state)."""
        ctl = self._anomaly_control()
        if ctl is None or getattr(ctl, "local_book", None) is None:
            return RoutingService(identifier, binding)

        def prewarm(cluster: str, target: str,
                    _binding=binding, _base=base_dtab) -> None:
            # the EXACT DstPath a booked `cluster => target` override
            # produces at request time (single-entry book): same path,
            # same base dtab, same single-dentry local dtab — so the
            # prewarmed ServiceCache entry is the one requests hit
            _binding.path_service(DstPath(
                Path.read(cluster), _base,
                Dtab.read(f"{cluster} => {target} ;")))

        ctl.register_prewarm(prewarm)
        return RoutingService(identifier, binding,
                              local_dtab_fn=ctl.local_dtab_for)

    def _mk_balancer(self, kind: str, addr, endpoint_factory):
        """mk_balancer + the control loop's score weighting when
        configured: replicas trending anomalous are multiplicatively
        down-weighted inside the kind's own pick path, deprioritizing
        BEFORE failure accrual would eject (control/balancer.py)."""
        bal = mk_balancer(kind, addr, endpoint_factory)
        ctl = self._anomaly_control()
        if ctl is not None and ctl.weigher is not None:
            bal = ScoreWeightedBalancer(bal, ctl.weigher)
            ctl.register_balancer(bal)
        return bal

    # -- lifecycle --------------------------------------------------------
    async def start(self) -> "Linker":
        for r in self.routers:
            await r.start()
        # warm the failover binds while the store is reachable (the
        # control loop re-touches them on its prewarm cadence)
        ctl = self._anomaly_control()
        if ctl is not None:
            ctl.prewarm_failover_binds()
        return self

    async def close(self) -> None:
        for r in self.routers:
            await r.close()
            # a remote interpreter's watch streams end with its router
            closer = getattr(r.interpreter, "aclose", None)
            if closer is not None:
                await closer()
        for _, namer in self.namers:
            namer.close()
        ctl = self._anomaly_control()
        for t in self.telemeters:
            t.close()
        self._close_trust_bundles()
        if ctl is not None:
            # the reactor's store client (its namerd connection)
            await ctl.aclose()


def load_linker(text: str, device: DeviceLike = None) -> Linker:
    """Parse a YAML/JSON config into an (unstarted) Linker whose
    telemeters run on ``device``: CUDA unless ``"cpu"`` is named."""
    return Linker(parse_linker_spec(text), device=device,
                  config_dict=parse_config(text), config_text=text)
