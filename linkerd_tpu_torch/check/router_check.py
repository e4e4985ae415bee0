"""Router wiring checks: ports, timeouts, retries, admission, TLS.

Everything here verifies invariants the runtime either enforces too late
(port conflicts surface at Linker build, cert paths at the first
handshake) or not at all (a retry budget that can never admit a retry is
silently a no-retry config; a per-try timeout above the total timeout
means the total always fires first and the per-try knob is dead).

Rules:

- ``router-port-conflict``  two listeners (router servers, admin,
  identifier port, namerd interfaces) on the same ip:port
- ``router-dst-uncovered``  (in dtab_check) dstPrefix binds to nothing
- ``timeout-inversion``     perTry/attempt or server caps that make the
  configured total timeout unreachable
- ``retry-starved``         retries configured but the budget/backoff
  can never admit one
- ``admission-deadline``    admissionControl bounds that are invalid or
  contradict the deadline budget
- ``tls-missing-cert``      cert/key/trust paths that do not exist

A copy of ``tools/analysis/semantic/router_check.py`` on the port's own
parsers and registry.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Iterator, List, Optional, Tuple

from linkerd_tpu_torch.config import ConfigError
from linkerd_tpu_torch.config.parser import instantiate_as
from linkerd_tpu_torch.core import Dtab, Path
from linkerd_tpu_torch.linker import ClientSpec, LinkerSpec, RouterSpec, SvcSpec
from linkerd_tpu_torch.check.core import Finding
from linkerd_tpu_torch.check.dtab_check import (
    check_dtab, dst_prefix_covered, parse_dtab,
)
from linkerd_tpu_torch.check.loader import ConfigSource, resolve_path

# interpreters that resolve against THIS config's dtab/namers in-process;
# remote interpreters get their dtab from the control plane, so dtab
# coverage can't be judged from the linker file alone
IN_PROCESS_INTERPRETERS = (None, "default", "io.l5d.default")


def namer_prefixes_of(spec) -> List[Path]:
    """Configured namer prefixes of a LinkerSpec OR NamerdSpec (both
    carry the same ``namers:`` block shape)."""
    out: List[Path] = []
    for raw in spec.namers or []:
        if not isinstance(raw, dict) or not raw.get("kind"):
            continue
        try:
            out.append(Path.read(str(raw.get("prefix")
                                      or f"/{raw['kind']}")))
        except ValueError:
            continue  # reported by the registry/parse pass
    return out


def _spec_entries(raw: Any, cls: type, where: str
                  ) -> Tuple[List[Tuple[Any, str]], List[str]]:
    """Client/service block -> [(spec, where)] covering both the plain
    mapping form and io.l5d.static per-prefix entries; unparseable
    entries come back as error strings (the strict parser's message)."""
    if raw is None or not isinstance(raw, dict):
        return [], []
    errors: List[str] = []
    if raw.get("kind") == "io.l5d.static":
        entries = []
        for i, c in enumerate(raw.get("configs") or []):
            if not isinstance(c, dict):
                continue
            c = {k: v for k, v in c.items() if k != "prefix"}
            try:
                entries.append((instantiate_as(cls, c,
                                               f"{where}.configs[{i}]"),
                                f"{where}.configs[{i}]"))
            except ConfigError as e:
                errors.append(str(e))
        return entries, errors
    try:
        return [(instantiate_as(cls, raw, where), where)], []
    except ConfigError as e:
        return [], [str(e)]


# binding a wildcard address claims the port on EVERY interface, so it
# conflicts with any other ip on the same port (EADDRINUSE at startup)
WILDCARD_IPS = ("0.0.0.0", "::", "")


def _ips_conflict(a: str, b: str) -> bool:
    return a == b or a in WILDCARD_IPS or b in WILDCARD_IPS


def claim_listeners(source: ConfigSource,
                    claims: List[Tuple[str, Optional[int], str,
                                       Tuple[str, ...]]]
                    ) -> Iterator[Finding]:
    """One definition of listener-conflict detection for linker routers
    AND namerd interfaces: ``claims`` is ordered (ip, port, what,
    needles); a repeated port on the same (or a wildcard) address yields
    a finding anchored on the CONFLICTING (second) occurrence, found
    past the owner's line."""
    by_port: Dict[int, List[Tuple[str, str, int]]] = {}
    for ip, port, what, needles in claims:
        if not port:
            continue  # port 0 = ephemeral, never conflicts
        port = int(port)
        owner = next(((o_what, o_line)
                      for o_ip, o_what, o_line in by_port.get(port, [])
                      if _ips_conflict(ip, o_ip)), None)
        if owner is not None:
            o_what, o_line = owner
            yield source.finding(
                "router-port-conflict",
                f"{what} listens on {ip}:{port}, already taken by "
                f"{o_what} — the second bind fails at startup",
                line=source.line_of(*needles, after=o_line))
        else:
            by_port.setdefault(port, []).append(
                (ip, what, source.line_of(*needles)))


class RouterChecks:
    def __init__(self, source: ConfigSource, spec: LinkerSpec):
        self.source = source
        self.spec = spec
        self.namer_prefixes = namer_prefixes_of(spec)

    def run(self) -> Iterator[Finding]:
        yield from self.check_ports()
        spans = self._router_spans()
        for i, rspec in enumerate(self.spec.routers):
            where = f"routers[{i}]"
            self._span = spans[i]
            yield from self.check_router_dtab(rspec, where)
            yield from self.check_timeouts_retries(rspec, where)
            yield from self.check_admission(rspec, where)
            yield from self.check_tenants(rspec, where)
            yield from self.check_streams(rspec, where)
            yield from self.check_workers(rspec, where)
            yield from self.check_tls(rspec, where)

    def _router_spans(self) -> List[Tuple[int, int]]:
        """(after, before) line bounds per router block, so a finding in
        routers[1] never anchors (or binds a suppression) onto
        routers[0]'s identically-named key. Blocks are located by their
        ``protocol:`` lines; a block without one falls back to the
        unbounded (0, 0) anchor."""
        starts: List[int] = []
        prev = 0
        for _ in self.spec.routers:
            ln = self.source.line_of("protocol:", after=prev)
            if ln == 0:
                break
            starts.append(ln)
            prev = ln
        spans: List[Tuple[int, int]] = []
        for i in range(len(self.spec.routers)):
            if i >= len(starts):
                spans.append((0, 0))
                continue
            after = starts[i] - 1
            before = starts[i + 1] if i + 1 < len(starts) else 0
            spans.append((after, before))
        return spans

    def _anchor(self, *needles: str) -> int:
        after, before = getattr(self, "_span", (0, 0))
        return self.source.line_of(*needles, after=after, before=before)

    # -- listeners ---------------------------------------------------------
    def check_ports(self) -> Iterator[Finding]:
        claims: List[Tuple[str, Optional[int], str, Tuple[str, ...]]] = []
        for i, rspec in enumerate(self.spec.routers):
            for j, s in enumerate(rspec.servers or []):
                claims.append((s.ip, s.port,
                               f"routers[{i}].servers[{j}] "
                               f"({rspec.label or rspec.protocol})",
                               (f"port: {s.port}",)))
        if self.spec.admin is not None:
            claims.append((self.spec.admin.ip, self.spec.admin.port,
                           "admin", (f"port: {self.spec.admin.port}",)))
            if self.spec.admin.httpIdentifierPort:
                claims.append((self.spec.admin.ip,
                               self.spec.admin.httpIdentifierPort,
                               "admin.httpIdentifierPort",
                               ("httpIdentifierPort",)))
        yield from claim_listeners(self.source, claims)

    # -- dtab --------------------------------------------------------------
    def check_router_dtab(self, rspec: RouterSpec, where: str
                          ) -> Iterator[Finding]:
        if rspec.dtab:
            yield from check_dtab(self.source, rspec.dtab,
                                  self.namer_prefixes, where)
        interp_kind = (rspec.interpreter or {}).get("kind") \
            if isinstance(rspec.interpreter, dict) else None
        if interp_kind not in IN_PROCESS_INTERPRETERS:
            return  # dtab comes from the control plane at runtime
        dtab, parse_findings = (parse_dtab(self.source, rspec.dtab, where)
                                if rspec.dtab else (Dtab.empty(), []))
        if parse_findings or dtab is None:
            return  # syntax already reported by check_dtab
        yield from dst_prefix_covered(
            self.source, dtab, self.namer_prefixes, rspec.dstPrefix, where)

    # -- timeouts + retries ------------------------------------------------
    def check_timeouts_retries(self, rspec: RouterSpec, where: str
                               ) -> Iterator[Finding]:
        clients, _ = _spec_entries(rspec.client, ClientSpec,
                                   f"{where}.client")
        services, _ = _spec_entries(rspec.service, SvcSpec,
                                    f"{where}.service")
        # parse errors already surface via the strict registry pass
        totals = [(s.totalTimeoutMs, w) for s, w in services
                  if s.totalTimeoutMs is not None]
        for cspec, cwhere in clients:
            per_try = cspec.requestAttemptTimeoutMs
            if per_try is None:
                continue
            for total, swhere in totals:
                if per_try > total:
                    yield self.source.finding(
                        "timeout-inversion",
                        f"{cwhere}: requestAttemptTimeoutMs ({per_try}) "
                        f"exceeds {swhere}.totalTimeoutMs ({total}) — the "
                        f"total always expires first, so the per-try "
                        f"timeout can never fire",
                        line=self._anchor("requestAttemptTimeoutMs"))
        for j, srv in enumerate(rspec.servers or []):
            if srv.timeoutMs is None:
                continue
            for total, swhere in totals:
                if srv.timeoutMs < total:
                    yield self.source.finding(
                        "timeout-inversion",
                        f"{where}.servers[{j}].timeoutMs ({srv.timeoutMs}) "
                        f"is below {swhere}.totalTimeoutMs ({total}) — the "
                        f"server cap preempts the service budget, so the "
                        f"configured total is unreachable",
                        line=self._anchor("timeoutMs"),
                        severity="warning")
        for sspec, swhere in services:
            yield from self.check_retries(sspec, swhere)

    def check_retries(self, sspec: SvcSpec, where: str) -> Iterator[Finding]:
        r = sspec.retries
        if r is None:
            return
        line = self._anchor("retries")
        if r.maxRetries <= 0:
            yield self.source.finding(
                "retry-starved",
                f"{where}.retries: maxRetries is {r.maxRetries} — the "
                f"retry block is configured but can never retry",
                line=line)
        b = r.budget
        if b is not None:
            if b.ttlSecs <= 0:
                yield self.source.finding(
                    "retry-starved",
                    f"{where}.retries.budget: ttlSecs must be > 0 "
                    f"(got {b.ttlSecs}) — deposits expire instantly and "
                    f"no retry is ever admitted",
                    line=line)
            elif b.percentCanRetry <= 0 and b.minRetriesPerSec <= 0:
                yield self.source.finding(
                    "retry-starved",
                    f"{where}.retries.budget: percentCanRetry and "
                    f"minRetriesPerSec are both 0 — the budget never "
                    f"earns a token, so classified-retryable responses "
                    f"are all surfaced as failures",
                    line=line)
        bo = r.backoff
        if bo is not None and bo.kind == "jittered" and bo.minMs > bo.maxMs:
            yield self.source.finding(
                "retry-starved",
                f"{where}.retries.backoff: minMs ({bo.minMs}) > maxMs "
                f"({bo.maxMs}) — the jittered backoff range is empty",
                line=line)

    # -- admission control -------------------------------------------------
    def check_admission(self, rspec: RouterSpec, where: str
                        ) -> Iterator[Finding]:
        ac = rspec.admissionControl
        if ac is None:
            return
        line = self._anchor("admissionControl")
        if ac.maxConcurrency < 1:
            yield self.source.finding(
                "admission-deadline",
                f"{where}.admissionControl: maxConcurrency must be >= 1 "
                f"(got {ac.maxConcurrency}) — the router would shed "
                f"every request",
                line=line)
        if ac.maxPending < 0:
            yield self.source.finding(
                "admission-deadline",
                f"{where}.admissionControl: maxPending must be >= 0 "
                f"(got {ac.maxPending})",
                line=line)
        services, _ = _spec_entries(rspec.service, SvcSpec,
                                    f"{where}.service")
        totals = [s.totalTimeoutMs for s, _ in services
                  if s.totalTimeoutMs is not None]
        if (totals and ac.maxConcurrency >= 1
                and ac.maxPending > 4 * ac.maxConcurrency):
            yield self.source.finding(
                "admission-deadline",
                f"{where}.admissionControl: maxPending ({ac.maxPending}) "
                f"is more than 4x maxConcurrency ({ac.maxConcurrency}) "
                f"while totalTimeoutMs is {min(totals)} — deeply queued "
                f"requests spend their whole deadline budget waiting for "
                f"a slot and are shed as 504s instead of fast 503s; "
                f"shrink the queue so sheds happen up front",
                line=line, severity="warning")

    # -- tenant isolation --------------------------------------------------
    def check_tenants(self, rspec: RouterSpec, where: str
                      ) -> Iterator[Finding]:
        """``tenantIdentifier`` / ``tenants:`` / ``connectionGuard``
        wiring: extraction-source sanity, floor-vs-limit coherence, and
        the inert-config traps (quotas without an identity axis; quotas
        on the Python path without an admission gate to enforce them;
        sni extraction where no TLS listener will ever see a server
        name)."""
        tid = None
        if rspec.tenantIdentifier is not None:
            from linkerd_tpu_torch.router.tenancy import TenantIdentifierSpec
            line = self._anchor("tenantIdentifier")
            try:
                tid = instantiate_as(TenantIdentifierSpec,
                                     rspec.tenantIdentifier,
                                     f"{where}.tenantIdentifier")
                tid.validate(f"{where}.tenantIdentifier")
            except (ConfigError, ValueError) as e:
                yield self.source.finding("tenant-config", str(e),
                                          line=line)
                tid = None
            if tid is not None and tid.kind == "sni":
                # both data planes surface SNI now (the engines via
                # SSL_get_servername, the asyncio servers via the
                # sni_callback on TlsServerConfig contexts) — the only
                # inert shape left is having no TLS listener at all
                has_tls_server = any(s.tls is not None
                                     for s in rspec.servers or [])
                if not has_tls_server:
                    yield self.source.finding(
                        "tenant-config",
                        f"{where}.tenantIdentifier: kind sni needs a "
                        f"TLS server — no listener here terminates "
                        f"TLS, so no request ever carries a server "
                        f"name and every request is tenantless",
                        line=line)
        ts = rspec.tenants
        if ts is not None:
            line = self._anchor("tenants")
            try:
                ts.validate(f"{where}.tenants")
            except ConfigError as e:
                yield self.source.finding("tenant-config", str(e),
                                          line=line)
                return
            if rspec.tenantIdentifier is None:
                yield self.source.finding(
                    "tenant-config",
                    f"{where}.tenants: per-tenant quotas are configured "
                    f"without a tenantIdentifier — no request gets a "
                    f"tenant, so the quotas never apply",
                    line=line, severity="warning")
            ac = rspec.admissionControl
            if ac is not None:
                # the floor quota must stay below the router's own
                # concurrency limit, or a "sick" tenant still owns the
                # whole gate
                floor_limit = max(1, round(ts.floor * ac.maxConcurrency))
                if floor_limit >= ac.maxConcurrency:
                    yield self.source.finding(
                        "tenant-config",
                        f"{where}.tenants: floor ({ts.floor}) x "
                        f"admissionControl.maxConcurrency "
                        f"({ac.maxConcurrency}) rounds to "
                        f"{floor_limit} — a sick tenant's \"floor\" "
                        f"still covers the whole gate, so shrinking "
                        f"its quota isolates nothing",
                        line=line)
            elif not rspec.fastPath:
                yield self.source.finding(
                    "tenant-config",
                    f"{where}.tenants: quotas on the Python data plane "
                    f"enforce through admissionControl — without one, "
                    f"tenant levels are tracked but nothing sheds",
                    line=line, severity="warning")
        if rspec.connectionGuard is not None and not rspec.fastPath:
            yield self.source.finding(
                "tenant-config",
                f"{where}.connectionGuard requires fastPath: true (the "
                f"defenses live in the native engines) — the linker "
                f"refuses this config at load",
                line=self._anchor("connectionGuard"))
        elif rspec.connectionGuard is not None:
            try:
                rspec.connectionGuard.validate(f"{where}.connectionGuard")
            except ConfigError as e:
                yield self.source.finding(
                    "tenant-config", str(e),
                    line=self._anchor("connectionGuard"))

    # -- stream sentinel ---------------------------------------------------
    def check_streams(self, rspec: RouterSpec, where: str
                      ) -> Iterator[Finding]:
        """``streamScoring`` / tunnel-budget wiring: knob ranges, the
        protocols the sentinel actually rides (http/h2; on the Python
        h1 plane there is no frame stream to sample), and tunnel-budget
        vs connectionGuard coherence (tunnels escape the slowloris
        budgets by design — stream-aware configs should budget them)."""
        ss = rspec.streamScoring
        if ss is not None:
            line = self._anchor("streamScoring")
            try:
                ss.validate(f"{where}.streamScoring")
            except ConfigError as e:
                yield self.source.finding("stream-config", str(e),
                                          line=line)
                return
            if rspec.protocol not in ("http", "h2"):
                yield self.source.finding(
                    "stream-config",
                    f"{where}.streamScoring is only supported on http/h2 "
                    f"routers (got protocol {rspec.protocol!r}) — the "
                    f"linker refuses this config at load",
                    line=line)
                return
            if rspec.protocol == "http" and not rspec.fastPath:
                yield self.source.finding(
                    "stream-config",
                    f"{where}.streamScoring on an http router needs "
                    f"fastPath: true — the asyncio h1 plane has no "
                    f"frame stream to sample (tunnels are byte-relayed "
                    f"opaquely), so the sentinel would track nothing",
                    line=line, severity="warning")
        guard = rspec.connectionGuard
        if guard is None:
            return
        tunnels_budgeted = (guard.tunnelIdleMs > 0
                            or guard.tunnelMaxBytes > 0)
        if tunnels_budgeted and rspec.protocol == "h2":
            yield self.source.finding(
                "stream-config",
                f"{where}.connectionGuard: tunnelIdleMs/tunnelMaxBytes "
                f"only apply to http routers (101-upgrade and CONNECT "
                f"byte tunnels ride the h1 engine) — on h2 the budgets "
                f"are inert",
                line=self._anchor("tunnelIdleMs", "tunnelMaxBytes",
                                  "connectionGuard"),
                severity="warning")
        if (ss is not None and rspec.fastPath
                and rspec.protocol == "http" and not tunnels_budgeted
                and (guard.headerBudgetMs > 0 or guard.bodyStallMs > 0)):
            yield self.source.finding(
                "stream-config",
                f"{where}.connectionGuard: slowloris budgets are on but "
                f"tunnels are unbudgeted (tunnelIdleMs and "
                f"tunnelMaxBytes both 0) — an upgraded/CONNECT "
                f"connection escapes the header/body budgets by design, "
                f"so a stream-aware router should cap tunnel idle time "
                f"or bytes",
                line=self._anchor("connectionGuard"),
                severity="warning")

    # -- multi-core sharding -----------------------------------------------
    def check_workers(self, rspec: RouterSpec, where: str
                      ) -> Iterator[Finding]:
        """``workers`` (the multi-core native data plane knob) wiring:
        it only exists on the native engines (fastPath), more shards
        than hardware cores just context-switch, and a per-tenant
        floor quota that rounds to ZERO after the N-way split sheds a
        sick tenant entirely instead of flooring it."""
        if rspec.workers is None:
            return
        line = self._anchor("workers")
        try:
            n = int(rspec.workers)
        except (TypeError, ValueError):
            yield self.source.finding(
                "fastpath-workers",
                f"{where}.workers must be an integer (0 = auto), got "
                f"{rspec.workers!r}",
                line=line)
            return
        if not rspec.fastPath:
            yield self.source.finding(
                "fastpath-workers",
                f"{where}.workers requires fastPath: true — the sharded "
                f"epoll workers ARE the native engines; the asyncio "
                f"data plane is single-loop and the linker refuses "
                f"this config at load",
                line=line)
            return
        # the importable module constants ARE the linker's bounds (the
        # native module imports without a toolchain; nothing builds)
        from linkerd_tpu_torch.native import FastPathEngine, auto_workers
        max_workers = FastPathEngine.MAX_WORKERS
        ncpu = os.cpu_count() or 1
        if n < 0 or n > max_workers:
            yield self.source.finding(
                "fastpath-workers",
                f"{where}.workers must be 0 (auto) or in "
                f"1..{max_workers}, got {n} — the linker refuses this "
                f"config at load",
                line=line)
            return
        if n > ncpu:
            yield self.source.finding(
                "fastpath-workers",
                f"{where}.workers: {n} exceeds the {ncpu} hardware "
                f"cores on this host — extra workers add context "
                f"switches and split the per-core pools thinner "
                f"without adding parallelism (use workers: 0 for "
                f"auto = min(4, cores))",
                line=line, severity="warning")
        resolved = auto_workers() if n == 0 else n
        ts = rspec.tenants
        if resolved > 1 and ts is not None \
                and rspec.tenantIdentifier is not None:
            try:
                ts.validate(f"{where}.tenants")
            except ConfigError:
                return  # tenant-config already reports it
            floor_quota = max(1, round(ts.floor * ts.engineBase))
            if floor_quota // resolved == 0:
                yield self.source.finding(
                    "fastpath-workers",
                    f"{where}.tenants: the floor quota "
                    f"(floor {ts.floor} x engineBase {ts.engineBase} "
                    f"= {floor_quota}) rounds to ZERO per worker "
                    f"after the {resolved}-way split — a sick tenant "
                    f"is shed entirely instead of floored; raise "
                    f"engineBase to at least "
                    f"{max(1, round(resolved / ts.floor))}",
                    line=line, severity="warning")

    # -- TLS ---------------------------------------------------------------
    def check_tls(self, rspec: RouterSpec, where: str) -> Iterator[Finding]:
        for j, srv in enumerate(rspec.servers or []):
            if srv.tls is None:
                continue
            swhere = f"{where}.servers[{j}].tls"
            if not srv.tls.certPath or not srv.tls.keyPath:
                yield self.source.finding(
                    "tls-missing-cert",
                    f"{swhere}: needs both certPath and keyPath — the "
                    f"server refuses to start without them",
                    line=self._anchor("tls"))
            for fieldname in ("certPath", "keyPath", "caCertPath"):
                yield from self._check_cert(
                    getattr(srv.tls, fieldname), f"{swhere}.{fieldname}")
        clients, _ = _spec_entries(rspec.client, ClientSpec,
                                   f"{where}.client")
        for cspec, cwhere in clients:
            if cspec.tls is None:
                continue
            for k, p in enumerate(cspec.tls.trustCerts or []):
                yield from self._check_cert(p, f"{cwhere}.tls.trustCerts[{k}]")
            if cspec.tls.clientAuth is not None:
                yield from self._check_cert(
                    cspec.tls.clientAuth.certPath,
                    f"{cwhere}.tls.clientAuth.certPath")
                yield from self._check_cert(
                    cspec.tls.clientAuth.keyPath,
                    f"{cwhere}.tls.clientAuth.keyPath")

    def _check_cert(self, path: Optional[str], where: str
                    ) -> Iterator[Finding]:
        if not path:
            return
        resolved = resolve_path(self.source, path)
        if not os.path.exists(resolved):
            yield self.source.finding(
                "tls-missing-cert",
                f"{where}: {path!r} does not exist (resolved to "
                f"{resolved}) — every handshake on this client/server "
                f"fails at runtime",
                line=self._anchor(os.path.basename(path)))
