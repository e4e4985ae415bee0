"""l5dcheck engine: load a linker/namerd YAML, run every semantic rule,
apply YAML-comment suppressions.

Entry points:

- ``check_file(path)`` / ``check_text(text, rel)`` — full analysis of
  one config document; returns ALL findings (suppressed ones flagged),
  the same contract as ``tools.analysis.run_analysis``.
- ``check_data(data, rel)`` — analysis of an already-parsed config (the
  admin ``/config-check.json`` endpoint checks the live linker's parsed
  config without re-reading the file; line anchors degrade to 0).

A copy of ``tools/analysis/semantic/engine.py`` on the port's own
parsers and registry.
"""

from __future__ import annotations

import json
from typing import Any, Iterator, List, Optional

from linkerd_tpu_torch.config import ConfigError
from linkerd_tpu_torch.config.parser import instantiate, parse_config
from linkerd_tpu_torch.config.registry import kinds as registry_kinds
from linkerd_tpu_torch.core import Path
from linkerd_tpu_torch.check.core import Finding
from linkerd_tpu_torch.check.loader import ConfigSource

SEMANTIC_RULES = (
    "config-parse",       # the document fails strict parsing
    "config-kind",        # a kind: unknown to the registry / bad fields
    "dtab-syntax", "dtab-cycle", "dtab-unbound",
    "dtab-neg-only", "dtab-shadowed", "dtab-dead-branch",
    "router-port-conflict", "router-dst-uncovered",
    "timeout-inversion", "retry-starved", "admission-deadline",
    "tls-missing-cert",
    "tenant-config",      # tenantIdentifier/tenants/connectionGuard wiring
    "fastpath-workers",   # multi-core sharding knob wiring
    "scorer-config", "scorer-width",
    "override-unsafe",    # reactor-generated dtab overrides (control/)
    "fleet-config",       # fleet exchange / quorum-gated actuation wiring
    "distill-config",     # specialist-bank / distillation knob wiring
    "stream-config",      # stream sentinel / tunnel budget wiring
)


def semantic_rule_ids() -> List[str]:
    return sorted(SEMANTIC_RULES)


def check_file(path: str, repo_root: Optional[str] = None) -> List[Finding]:
    return _run(ConfigSource.from_file(path, repo_root))


def check_text(text: str, rel: str = "<config>",
               base_dir: Optional[str] = None) -> List[Finding]:
    return _run(ConfigSource(rel, text, base_dir=base_dir))


def check_data(data: Any, rel: str = "<config>",
               base_dir: Optional[str] = None) -> List[Finding]:
    """Analyze an already-parsed config dict (no suppressions — those
    live in comments, which the parsed form no longer carries)."""
    text = json.dumps(data, indent=1, default=str)
    return _run(ConfigSource(rel, text, base_dir=base_dir), data=data)


# -- orchestration -----------------------------------------------------------


def _run(source: ConfigSource, data: Any = None) -> List[Finding]:
    # the linker imports every built-in plugin registration; l5dcheck
    # cross-checks kinds against the exact same registry state
    import linkerd_tpu_torch.linker  # noqa: F401
    import linkerd_tpu_torch.namerd.config  # noqa: F401

    findings: List[Finding] = []
    if data is None:
        try:
            data = parse_config(source.text)
        except ConfigError as e:
            findings.append(source.finding("config-parse", str(e)))
            return _apply_suppressions(source, findings, stale_check=False)
    if not isinstance(data, dict):
        findings.append(source.finding(
            "config-parse", "config must be a mapping"))
        return _apply_suppressions(source, findings, stale_check=False)

    if "routers" in data:
        findings.extend(_check_linker(source, data))
    elif "storage" in data or "interfaces" in data:
        findings.extend(_check_namerd(source, data))
    else:
        findings.append(source.finding(
            "config-parse",
            "neither a linker config (routers:) nor a namerd config "
            "(storage:/interfaces:)"))
    findings = _apply_suppressions(source, findings)
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings


def _apply_suppressions(source: ConfigSource, findings: List[Finding],
                        stale_check: bool = True) -> List[Finding]:
    used = set()  # suppression lines that silenced something
    for f in findings:
        sup = source.suppression_for(f.rule, f.line)
        if sup is not None and sup.justified:
            f.suppressed = True
            f.justification = sup.justification
            used.add(sup.line)
    known = set(SEMANTIC_RULES) | {"suppression", "stale-suppression"}
    for sup in source.suppressions.values():
        if not sup.justified:
            findings.append(Finding(
                "suppression", source.rel, sup.line, 0,
                "suppression without justification: write "
                "'# l5d: ignore[rule] — why it is safe'"))
        for r in sup.rules:
            if r not in known:
                findings.append(Finding(
                    "suppression", source.rel, sup.line, 0,
                    f"suppression names unknown semantic rule {r!r} "
                    f"(known: {sorted(known)})"))
    # stale-suppression: a justified waiver silencing nothing is debt.
    # Skipped when the document failed parsing (stale_check=False —
    # most rules never ran, so "unused" is unknowable).
    if stale_check:
        for sup in source.suppressions.values():
            if not sup.justified or sup.line in used:
                continue
            named = set(sup.rules)
            if not named or not named <= set(SEMANTIC_RULES):
                continue
            f = Finding(
                "stale-suppression", source.rel, sup.line, 0,
                f"suppression for {sorted(named)} no longer silences "
                f"any finding — the excused config was fixed or "
                f"removed; delete the ignore (it would hide future "
                f"regressions here)")
            stale_sup = source.suppression_for(
                "stale-suppression", sup.line)
            if stale_sup is not None and stale_sup.justified:
                f.suppressed = True
                f.justification = stale_sup.justification
            findings.append(f)
    return findings


# -- linker ------------------------------------------------------------------


def _check_linker(source: ConfigSource, data: dict) -> Iterator[Finding]:
    from linkerd_tpu_torch.linker import parse_linker_spec
    from linkerd_tpu_torch.check.router_check import RouterChecks
    from linkerd_tpu_torch.check.telemetry_check import check_telemetry

    yield from _registry_cross_check(source, data)
    try:
        spec = parse_linker_spec(json.dumps(data, default=str))
    except ConfigError as e:
        yield source.finding("config-parse", str(e))
        return
    yield from RouterChecks(source, spec).run()
    yield from check_telemetry(source, spec)


def _check_namerd(source: ConfigSource, data: dict) -> Iterator[Finding]:
    from linkerd_tpu_torch.namerd.config import parse_namerd_spec
    from linkerd_tpu_torch.check.dtab_check import check_dtab

    yield from _registry_cross_check_namerd(source, data)
    try:
        spec = parse_namerd_spec(json.dumps(data, default=str))
    except ConfigError as e:
        yield source.finding("config-parse", str(e))
        return
    from linkerd_tpu_torch.check.router_check import namer_prefixes_of
    prefixes = namer_prefixes_of(spec)  # NamerdSpec has .namers too
    # in-memory bootstrap namespaces carry whole dtabs: analyze each one
    storage = spec.storage or {}
    if storage.get("kind") == "io.l5d.inMemory":
        for ns, text in (storage.get("namespaces") or {}).items():
            if isinstance(text, str):
                yield from check_dtab(source, text, prefixes,
                                      f"storage.namespaces[{ns}]")
    # listener conflicts across control ifaces + admin (same helper as
    # the linker's router/admin listeners)
    from linkerd_tpu_torch.check.router_check import claim_listeners
    claims = []
    for i, raw in enumerate(spec.interfaces or []):
        if isinstance(raw, dict) and raw.get("port"):
            claims.append((str(raw.get("ip", "127.0.0.1")),
                           int(raw["port"]), f"interfaces[{i}]",
                           (f"port: {raw['port']}",)))
    if spec.admin and spec.admin.get("port"):
        claims.append((str(spec.admin.get("ip", "127.0.0.1")),
                       int(spec.admin["port"]), "admin",
                       (f"port: {spec.admin['port']}",)))
    yield from claim_listeners(source, claims)


# -- registry cross-check ----------------------------------------------------

# identifier configs are only consulted by http/h2 routers; on other
# protocols the block is silently ignored at assembly — worth a finding
IDENTIFIER_CATEGORY = {"http": "identifier", "h2": "h2identifier"}
CLASSIFIER_CATEGORY = {"http": "classifier", "h2": "h2classifier"}


def _check_kind(source: ConfigSource, category: str, raw: Any,
                where: str) -> Iterator[Finding]:
    if not isinstance(raw, dict):
        yield source.finding(
            "config-kind", f"{where}: expected a mapping with 'kind'",
            needles=(where.split(".")[-1].split("[")[0],))
        return
    kind = raw.get("kind")
    line = source.line_of(f"kind: {kind}") if kind else 0
    if not kind:
        yield source.finding(
            "config-kind", f"{where}: missing 'kind' discriminator",
            line=line)
        return
    known = registry_kinds(category)
    if kind not in known:
        yield source.finding(
            "config-kind",
            f"{where}: unknown {category} kind {kind!r} (known: "
            f"{list(known)})", line=line)
        return
    try:
        instantiate(category, raw, where)
    except ConfigError as e:
        # the strict parser's message already names the offending path
        yield source.finding("config-kind", str(e), line=line)


def _check_namers(source: ConfigSource, data: dict) -> Iterator[Finding]:
    """The namers: block is shared verbatim between linker and namerd
    configs (transformers nested per entry, popped before the strict
    instantiate like Linker._build does)."""
    for i, raw in enumerate(data.get("namers") or []):
        entry = dict(raw) if isinstance(raw, dict) else raw
        transformers = (entry.pop("transformers", None)
                        if isinstance(entry, dict) else None) or []
        yield from _check_kind(source, "namer", entry, f"namers[{i}]")
        for j, t in enumerate(transformers):
            yield from _check_kind(source, "transformer", t,
                                   f"namers[{i}].transformers[{j}]")


def _registry_cross_check(source: ConfigSource,
                          data: dict) -> Iterator[Finding]:
    yield from _check_namers(source, data)
    for i, raw in enumerate(data.get("telemetry") or []):
        yield from _check_kind(source, "telemeter", raw, f"telemetry[{i}]")
    for i, raw in enumerate(data.get("announcers") or []):
        yield from _check_kind(source, "announcer", raw, f"announcers[{i}]")
    for i, router in enumerate(data.get("routers") or []):
        if not isinstance(router, dict):
            continue
        yield from _router_cross_check(source, router, f"routers[{i}]")


def _router_cross_check(source: ConfigSource, router: dict,
                        where: str) -> Iterator[Finding]:
    protocol = router.get("protocol", "http")
    ident = router.get("identifier")
    if ident is not None:
        id_cat = IDENTIFIER_CATEGORY.get(protocol)
        id_cfgs = ident if isinstance(ident, list) else [ident]
        if id_cat is None:
            yield source.finding(
                "config-kind",
                f"{where}: identifier is ignored by {protocol!r} routers "
                f"(identification is protocol-defined) — remove the "
                f"block or it will silently not apply",
                needles=("identifier",), severity="warning")
        else:
            for j, c in enumerate(id_cfgs):
                yield from _check_kind(source, id_cat, c,
                                       f"{where}.identifier[{j}]")
    if isinstance(router.get("interpreter"), dict):
        yield from _check_kind(source, "interpreter",
                               router["interpreter"],
                               f"{where}.interpreter")
    for j, c in enumerate(router.get("loggers") or []):
        yield from _check_kind(source, "logger", c, f"{where}.loggers[{j}]")
    cls_cat = CLASSIFIER_CATEGORY.get(protocol)
    for svc in _static_entries(router.get("service")):
        rc = svc.get("responseClassifier")
        if rc is not None and cls_cat is not None:
            yield from _check_kind(source, cls_cat, rc,
                                   f"{where}.service.responseClassifier")
    for cl in _static_entries(router.get("client")):
        fa = cl.get("failureAccrual")
        if fa is not None:
            yield from _check_kind(source, "failureAccrual", fa,
                                   f"{where}.client.failureAccrual")


def _static_entries(raw: Any) -> List[dict]:
    """The plain mapping, or each io.l5d.static per-prefix entry."""
    if not isinstance(raw, dict):
        return []
    if raw.get("kind") == "io.l5d.static":
        return [c for c in (raw.get("configs") or [])
                if isinstance(c, dict)]
    return [raw]


def _registry_cross_check_namerd(source: ConfigSource,
                                 data: dict) -> Iterator[Finding]:
    if isinstance(data.get("storage"), dict):
        yield from _check_kind(source, "dtabStore", data["storage"],
                               "storage")
    for i, raw in enumerate(data.get("interfaces") or []):
        yield from _check_kind(source, "namerdIface", raw,
                               f"interfaces[{i}]")
    yield from _check_namers(source, data)
