"""Telemetry / anomaly-scorer wiring checks.

The jaxAnomaly telemeter is configured entirely from YAML but its knobs
interlock: a ring smaller than one batch never fills a batch, a breaker
whose min backoff exceeds its max has an empty probe range, lifecycle
gate tolerances outside their ranges make the promotion gate either
vacuous or unpassable. The runtime validates a few of these at telemeter
construction (and crashes the linker); l5dcheck reports all of them
pre-deploy.

- ``scorer-config``  invalid/contradictory jaxAnomaly + lifecycle knobs
- ``scorer-width``   an on-disk checkpoint whose model width disagrees
  with the feature pipeline's FEATURE_DIM (restore would fail or score
  garbage)

A copy of ``tools/analysis/semantic/telemetry_check.py`` on the port's own
parsers and registry.
"""

from __future__ import annotations

import os
from typing import Iterator

from linkerd_tpu_torch.config import ConfigError
from linkerd_tpu_torch.config.parser import instantiate
from linkerd_tpu_torch.linker import LinkerSpec
from linkerd_tpu_torch.check.core import Finding
from linkerd_tpu_torch.check.loader import ConfigSource, resolve_path


def check_telemetry(source: ConfigSource, spec: LinkerSpec
                    ) -> Iterator[Finding]:
    for i, raw in enumerate(spec.telemetry or []):
        if not isinstance(raw, dict):
            continue
        if raw.get("kind") != "io.l5d.jaxAnomaly":
            continue
        where = f"telemetry[{i}]"
        try:
            cfg = instantiate("telemeter", raw, where)
        except ConfigError:
            continue  # the registry cross-check already reported it
        yield from _check_anomaly_cfg(source, cfg, where)
        if cfg.distill is not None:
            yield from _check_distill_cfg(source, cfg, spec,
                                          f"{where}.distill")
        if cfg.control is not None:
            yield from _check_control_cfg(source, cfg.control, spec,
                                          f"{where}.control")
            if cfg.control.fleet is not None:
                yield from _check_fleet_cfg(source, cfg.control,
                                            spec,
                                            f"{where}.control.fleet")
            if (cfg.control.fleet is not None
                    or getattr(cfg.control, "regionFailover", None)):
                yield from _check_region_cfg(source, cfg.control,
                                             spec,
                                             f"{where}.control.fleet")
        if cfg.lifecycle is not None:
            yield from _check_lifecycle_cfg(source, cfg.lifecycle,
                                            f"{where}.lifecycle")
            yield from _check_checkpoint_width(source, cfg.lifecycle,
                                              f"{where}.lifecycle")


def _bad(source: ConfigSource, rule: str, where: str, message: str,
         needle: str, severity: str = "error") -> Finding:
    return source.finding(rule, f"{where}: {message}",
                          line=source.line_of(needle), severity=severity)


def _check_anomaly_cfg(source: ConfigSource, cfg, where: str
                       ) -> Iterator[Finding]:
    if cfg.intervalMs <= 0:
        yield _bad(source, "scorer-config", where,
                   f"intervalMs must be > 0 (got {cfg.intervalMs})",
                   "intervalMs")
    if cfg.maxBatch < 1:
        yield _bad(source, "scorer-config", where,
                   f"maxBatch must be >= 1 (got {cfg.maxBatch})",
                   "maxBatch")
    elif cfg.ringCapacity < cfg.maxBatch:
        yield _bad(source, "scorer-config", where,
                   f"ringCapacity ({cfg.ringCapacity}) is below maxBatch "
                   f"({cfg.maxBatch}) — the feature ring can never hold "
                   f"a full scoring batch",
                   "ringCapacity")
    if cfg.maxBatchesPerWake < 1:
        yield _bad(source, "scorer-config", where,
                   f"maxBatchesPerWake must be >= 1 (got "
                   f"{cfg.maxBatchesPerWake}) — 0 silently disables "
                   f"draining (the telemeter refuses it at startup)",
                   "maxBatchesPerWake")
    if not (0.0 <= cfg.scoreThreshold <= 1.0):
        yield _bad(source, "scorer-config", where,
                   f"scoreThreshold must be in [0, 1] (got "
                   f"{cfg.scoreThreshold}) — scores are sigmoid outputs",
                   "scoreThreshold")
    if cfg.trainEveryBatches < 0:
        yield _bad(source, "scorer-config", where,
                   f"trainEveryBatches must be >= 0 (0 = never train, "
                   f"got {cfg.trainEveryBatches})",
                   "trainEveryBatches")
    if cfg.scoreTimeoutMs <= 0:
        yield _bad(source, "scorer-config", where,
                   f"scoreTimeoutMs must be > 0 (got {cfg.scoreTimeoutMs})",
                   "scoreTimeoutMs")
    if cfg.scoreTtlSecs <= 0:
        yield _bad(source, "scorer-config", where,
                   f"scoreTtlSecs must be > 0 (got {cfg.scoreTtlSecs}) — "
                   f"every score would be stale on arrival and decay to "
                   f"neutral immediately",
                   "scoreTtlSecs")
    if cfg.breakerMinBackoffMs > cfg.breakerMaxBackoffMs:
        yield _bad(source, "scorer-config", where,
                   f"breakerMinBackoffMs ({cfg.breakerMinBackoffMs}) "
                   f"exceeds breakerMaxBackoffMs "
                   f"({cfg.breakerMaxBackoffMs}) — the probe backoff "
                   f"range is empty",
                   "breakerMinBackoffMs")
    if cfg.breakerFailures < 1:
        yield _bad(source, "scorer-config", where,
                   f"breakerFailures must be >= 1 (got "
                   f"{cfg.breakerFailures})",
                   "breakerFailures")


def _check_distill_cfg(source: ConfigSource, cfg, spec: LinkerSpec,
                       where: str) -> Iterator[Finding]:
    """Specialist-bank / distillation knob interlocks: knob ranges the
    pipeline refuses at startup, a head count the native evaluator
    cannot hold, a drift trigger below the score noise floor (retrain
    churn), int4 with no fastPath router to serve it, and delta
    publishing with the native tier off (specialists could never reach
    a data plane)."""
    d = cfg.distill
    if d.maxHeads < 1:
        yield _bad(source, "distill-config", where,
                   f"maxHeads must be >= 1 (got {d.maxHeads})",
                   "maxHeads")
    else:
        from linkerd_tpu_torch.lifecycle.export import MAX_HEADS
        if d.maxHeads > MAX_HEADS:
            yield _bad(source, "distill-config", where,
                       f"maxHeads ({d.maxHeads}) exceeds the native "
                       f"evaluator's bank capacity ({MAX_HEADS}) — a "
                       f"full bank would be a rejected publish",
                       "maxHeads")
    if d.driftThreshold <= 0:
        yield _bad(source, "distill-config", where,
                   f"driftThreshold must be > 0 (got "
                   f"{d.driftThreshold})", "driftThreshold")
    elif d.driftThreshold < 0.25:
        yield _bad(source, "distill-config", where,
                   f"driftThreshold {d.driftThreshold} sits inside the "
                   f"score noise floor (~0.25 sigma) — routes would "
                   f"retrain continuously and the gate would reject "
                   f"most candidates (retrain churn, not learning)",
                   "driftThreshold", severity="warning")
    if d.minRouteRows < 8:
        yield _bad(source, "distill-config", where,
                   f"minRouteRows must be >= 8 (got {d.minRouteRows}) "
                   f"— the pipeline refuses it at startup",
                   "minRouteRows")
    elif d.minRouteRows > d.perRouteReplayRows:
        yield _bad(source, "distill-config", where,
                   f"minRouteRows ({d.minRouteRows}) exceeds "
                   f"perRouteReplayRows ({d.perRouteReplayRows}) — no "
                   f"route can ever accumulate enough rows to retrain",
                   "minRouteRows")
    if d.retrainSteps < 1:
        yield _bad(source, "distill-config", where,
                   f"retrainSteps must be >= 1 (got {d.retrainSteps})",
                   "retrainSteps")
    if d.learningRate <= 0:
        yield _bad(source, "distill-config", where,
                   f"learningRate must be > 0 (got {d.learningRate})",
                   "learningRate")
    if d.cooldownS < 0:
        yield _bad(source, "distill-config", where,
                   f"cooldownS must be >= 0 (got {d.cooldownS})",
                   "cooldownS")
    if not (0.0 <= d.aucTolerance <= 1.0):
        yield _bad(source, "distill-config", where,
                   f"aucTolerance must be in [0, 1] (got "
                   f"{d.aucTolerance})", "aucTolerance")
    if d.lossTolerance < 0:
        yield _bad(source, "distill-config", where,
                   f"lossTolerance must be >= 0 (got "
                   f"{d.lossTolerance})", "lossTolerance")
    quant = d.quant or cfg.nativeQuant
    if quant not in ("f32", "int8", "int4"):
        yield _bad(source, "distill-config", where,
                   f"quant must be f32/int8/int4 (got {quant!r})",
                   "quant" if d.quant else "nativeQuant")
    any_fastpath = any(bool(getattr(r, "fastPath", False))
                       for r in (spec.routers or []))
    if quant == "int4" and not any_fastpath:
        yield _bad(source, "distill-config", where,
                   "int4 quantization with no fastPath router: only "
                   "the native engines evaluate quantized blobs — the "
                   "JAX tier scores f32 regardless, so int4 buys "
                   "nothing here and its quantization error is pure "
                   "cost", "int4", severity="warning")
    if cfg.nativeTier != "primary":
        yield _bad(source, "distill-config", where,
                   "distill with nativeTier: off — specialist heads "
                   "are served by the in-plane evaluator; with the "
                   "native tier off the bank is trained and gated but "
                   "never scores a request",
                   "nativeTier", severity="warning")
    elif d.deltaPublish and not any_fastpath:
        yield _bad(source, "distill-config", where,
                   "deltaPublish with no fastPath router: there is no "
                   "engine to patch — promoted heads only ever land in "
                   "/model.json", "deltaPublish", severity="warning")


def _check_control_cfg(source: ConfigSource, ctl, spec: LinkerSpec,
                       where: str) -> Iterator[Finding]:
    """Control-loop (reactive routing) knob interlocks + the statically
    checkable half of ``override-unsafe``: a failover mapping that can
    only ever generate a rejected override (self-shift cycle, wildcard
    claims, unparseable paths) is a config bug, not a runtime event."""
    from linkerd_tpu_torch.core import Path as _Path
    from linkerd_tpu_torch.core.dtab import WILDCARD as _WILDCARD

    if ctl.intervalMs <= 0:
        yield _bad(source, "scorer-config", where,
                   f"intervalMs must be > 0 (got {ctl.intervalMs})",
                   "intervalMs")
    if not (0.0 < ctl.exitThreshold < ctl.enterThreshold <= 1.0):
        yield _bad(source, "scorer-config", where,
                   f"thresholds must satisfy 0 < exitThreshold < "
                   f"enterThreshold <= 1 (got enter="
                   f"{ctl.enterThreshold}, exit={ctl.exitThreshold}) — "
                   f"split thresholds are the anti-flap hysteresis",
                   "enterThreshold")
    if ctl.quorum < 1:
        yield _bad(source, "scorer-config", where,
                   f"quorum must be >= 1 (got {ctl.quorum})", "quorum")
    if ctl.cooldownS < 0:
        yield _bad(source, "scorer-config", where,
                   f"cooldownS must be >= 0 (got {ctl.cooldownS})",
                   "cooldownS")
    for bad_range, name in (
            (not 0.0 < ctl.weightFloor <= 1.0, "weightFloor"),
            (not 0.0 < ctl.weightThreshold < 1.0, "weightThreshold"),
            (not 0.0 < ctl.admissionFloor <= 1.0, "admissionFloor"),
            (not 0.0 < ctl.admissionThreshold < 1.0,
             "admissionThreshold")):
        if bad_range:
            yield _bad(source, "scorer-config", where,
                       f"{name} out of range (got "
                       f"{getattr(ctl, name)})", name)
    if ctl.failover and not ctl.namespace:
        yield _bad(source, "scorer-config", where,
                   "failover requires namespace (the namerd dtab "
                   "namespace the reactor shifts)", "failover")
    if ctl.failover and ctl.namespace and not ctl.namerdAddress:
        yield _bad(source, "scorer-config", where,
                   "failover is configured but namerdAddress is not: "
                   "the mesh reactor stays disabled unless a store "
                   "client is injected programmatically "
                   "(set_store_client) — a YAML-only deployment will "
                   "never shift traffic", "failover",
                   severity="warning")
    for cluster, target in (ctl.failover or {}).items():
        try:
            c_path, t_path = _Path.read(cluster), _Path.read(str(target))
        except ValueError as e:
            yield _bad(source, "override-unsafe", where,
                       f"failover entry {cluster!r} -> {target!r} does "
                       f"not parse as paths: {e}", "failover")
            continue
        if cluster == str(target):
            yield _bad(source, "override-unsafe", where,
                       f"failover {cluster} -> {target} shifts a "
                       f"cluster to itself — the generated override is "
                       f"a guaranteed delegation cycle and would always "
                       f"be rejected", "failover")
        if _WILDCARD in tuple(c_path) or _WILDCARD in tuple(t_path):
            yield _bad(source, "override-unsafe", where,
                       f"failover {cluster} -> {target} uses a wildcard "
                       f"segment — overrides must name one concrete "
                       f"cluster", "failover")


def _check_fleet_cfg(source: ConfigSource, ctl, spec: LinkerSpec,
                     where: str) -> Iterator[Finding]:
    """Fleet exchange / quorum wiring interlocks: a quorum that can
    never be met silently pins the mesh healthy forever, a quorum of 1
    with actuation enabled defeats the whole point of fleet gating, a
    staleness TTL shorter than the doc refresh cadence makes every peer
    doc stale on arrival, and a gossip endpoint needs the admin server
    its peers are configured to reach."""
    from linkerd_tpu_torch.fleet.doc import valid_instance

    fleet = ctl.fleet
    if fleet.instance is not None and not valid_instance(fleet.instance):
        yield _bad(source, "fleet-config", where,
                   f"instance {fleet.instance!r} must match "
                   f"[A-Za-z0-9._-]{{1,64}} (it becomes a dtab dentry "
                   f"prefix segment)", "instance")
    if fleet.quorum < 0 or fleet.expectInstances < 0:
        yield _bad(source, "fleet-config", where,
                   f"quorum/expectInstances must be >= 0 (0 = auto; got "
                   f"quorum={fleet.quorum}, "
                   f"expectInstances={fleet.expectInstances})", "quorum")
        return
    if (fleet.quorum > 0 and fleet.expectInstances > 0
            and fleet.quorum > fleet.expectInstances):
        yield _bad(source, "fleet-config", where,
                   f"quorum ({fleet.quorum}) exceeds expectInstances "
                   f"({fleet.expectInstances}) — the quorum can never "
                   f"be met and no anomaly will ever actuate",
                   "quorum")
    if fleet.quorum == 1 and ctl.failover:
        yield _bad(source, "fleet-config", where,
                   "quorum: 1 with failover actuation enabled — any "
                   "single instance shifts the whole mesh, which "
                   "defeats quorum gating (use quorum >= 2, or drop "
                   "the fleet block for single-instance behavior)",
                   "quorum", severity="warning")
    if fleet.publishIntervalS <= 0 or fleet.stalenessTtlS <= 0:
        yield _bad(source, "fleet-config", where,
                   f"publishIntervalS and stalenessTtlS must be > 0 "
                   f"(got {fleet.publishIntervalS}, "
                   f"{fleet.stalenessTtlS})", "publishIntervalS")
        return
    gossiping = bool(fleet.gossip and fleet.peers)
    refresh_s = fleet.publishIntervalS
    if gossiping and fleet.gossipIntervalMs > 0:
        refresh_s = min(refresh_s, fleet.gossipIntervalMs / 1e3)
    if fleet.stalenessTtlS < refresh_s:
        yield _bad(source, "fleet-config", where,
                   f"stalenessTtlS ({fleet.stalenessTtlS}) is shorter "
                   f"than the doc refresh cadence ({refresh_s}s) — "
                   f"every peer doc expires before its successor "
                   f"arrives, so no peer ever carries a vote and the "
                   f"quorum can never be met", "stalenessTtlS")
    if gossiping and spec.admin is None:
        yield _bad(source, "fleet-config", where,
                   "gossip peers are configured but this linker has no "
                   "admin: block — the gossip endpoint rides the admin "
                   "server, and without an explicit admin port every "
                   "fleet instance binds the default (colliding on one "
                   "host, and unreachable at the address peers were "
                   "given)", "peers", severity="warning")


def _check_region_cfg(source: ConfigSource, ctl, spec: LinkerSpec,
                      where: str) -> Iterator[Finding]:
    """Hierarchical-region wiring interlocks (fleet/regions.py): a
    malformed region id poisons every digest dentry it would name, a
    region-local quorum larger than the region can never be met, a WAN
    TTL below the digest roll-up cadence makes every peer-region digest
    stale on arrival (cross-region failover silently never fires), a
    regionFailover entry targeting its OWN region shifts a sick
    cluster's traffic to the same blast radius it is fleeing, and
    cross-region evidence must ride digests — regionFailover without a
    region has no digest to read."""
    from linkerd_tpu_torch.fleet.doc import valid_region

    fleet = ctl.fleet
    region = getattr(fleet, "region", None) if fleet is not None \
        else None
    rf = getattr(ctl, "regionFailover", None) or {}
    if region is None:
        if rf:
            yield _bad(source, "region-config", where,
                       "regionFailover is configured but the fleet "
                       "block has no region: — cross-region targets "
                       "are picked from peer-REGION digests, and a "
                       "region-less fleet neither publishes nor reads "
                       "them, so no cross-region failover ever fires",
                       "regionFailover")
        return
    if not valid_region(region):
        yield _bad(source, "region-config", where,
                   f"region {region!r} must match "
                   f"[a-z][a-z0-9-]{{0,31}} (it becomes a digest "
                   f"dentry prefix segment in the fleet namespace)",
                   "region")
        return
    quorum = fleet.effective_quorum()
    region_size = 1 + len(fleet.peers or [])
    if fleet.gossip and fleet.peers and quorum > region_size:
        yield _bad(source, "region-config", where,
                   f"quorum ({quorum}) exceeds this region's instance "
                   f"count ({region_size} = this instance + "
                   f"{len(fleet.peers)} gossip peers) — in region mode "
                   f"quorum voting is region-LOCAL, so during a WAN "
                   f"partition the cut-off region can never reach "
                   f"quorum and stops actuating exactly when it must "
                   f"not", "quorum")
    if (fleet.gossip and fleet.peers
            and fleet.expectInstances > 0
            and len(fleet.peers) + 1 > fleet.expectInstances):
        yield _bad(source, "region-config", where,
                   f"{len(fleet.peers)} gossip peers + this instance "
                   f"exceed expectInstances ({fleet.expectInstances}) "
                   f"— in region mode expectInstances is the REGION's "
                   f"size, so the peer list must cross the region "
                   f"boundary; cross-region evidence rides digests "
                   f"(one bounded dentry per region), never gossip — "
                   f"WAN gossip reintroduces the O(instances) "
                   f"cross-region chatter the region tier exists to "
                   f"remove", "peers", severity="warning")
    if fleet.wanTtlS <= 0 or fleet.digestIntervalS <= 0:
        yield _bad(source, "region-config", where,
                   f"wanTtlS and digestIntervalS must be > 0 (got "
                   f"{fleet.wanTtlS}, {fleet.digestIntervalS})",
                   "wanTtlS")
    elif fleet.wanTtlS < fleet.digestIntervalS:
        yield _bad(source, "region-config", where,
                   f"wanTtlS ({fleet.wanTtlS}) is below the digest "
                   f"roll-up cadence ({fleet.digestIntervalS}s) — "
                   f"every peer-region digest expires before its "
                   f"successor arrives, so cross-region failover can "
                   f"never pick a target and regions silently degrade "
                   f"to flat fleets", "wanTtlS")
    for path, targets in rf.items():
        if not isinstance(targets, dict):
            continue
        for target_region in targets:
            if target_region == region:
                yield _bad(source, "region-config", where,
                           f"regionFailover for {path!r} targets its "
                           f"OWN region ({region!r}) — a self-shift "
                           f"moves a sick cluster's traffic into the "
                           f"same blast radius it is fleeing; point it "
                           f"at a peer region's replica set (local "
                           f"fallback belongs in control.failover)",
                           "regionFailover")
            elif not valid_region(target_region):
                yield _bad(source, "region-config", where,
                           f"regionFailover for {path!r} names target "
                           f"region {target_region!r}, which does not "
                           f"match [a-z][a-z0-9-]{{0,31}} — no digest "
                           f"can ever name it, so this entry never "
                           f"fires", "regionFailover")


def _check_lifecycle_cfg(source: ConfigSource, lc, where: str
                         ) -> Iterator[Finding]:
    if not (0.0 <= lc.aucTolerance <= 1.0):
        yield _bad(source, "scorer-config", where,
                   f"aucTolerance must be in [0, 1] (got "
                   f"{lc.aucTolerance}) — AUC itself lives in [0, 1]",
                   "aucTolerance")
    if lc.lossTolerance < 0:
        yield _bad(source, "scorer-config", where,
                   f"lossTolerance must be >= 0 (got {lc.lossTolerance})",
                   "lossTolerance")
    if lc.retain < 1:
        yield _bad(source, "scorer-config", where,
                   f"retain must be >= 1 (got {lc.retain}) — retention "
                   f"would prune the serving checkpoint",
                   "retain")
    if lc.holdoutEveryBatches < 1:
        yield _bad(source, "scorer-config", where,
                   f"holdoutEveryBatches must be >= 1 (got "
                   f"{lc.holdoutEveryBatches}) — the telemeter refuses "
                   f"it at startup",
                   "holdoutEveryBatches")
    if lc.minReplayRows > lc.replayCapacity:
        yield _bad(source, "scorer-config", where,
                   f"minReplayRows ({lc.minReplayRows}) exceeds "
                   f"replayCapacity ({lc.replayCapacity}) — the "
                   f"promotion gate can never warm up and no candidate "
                   f"is ever promoted",
                   "minReplayRows")
    if lc.checkpointEveryS < 0:
        yield _bad(source, "scorer-config", where,
                   f"checkpointEveryS must be >= 0 (got "
                   f"{lc.checkpointEveryS})",
                   "checkpointEveryS")
    if lc.minLabeled < 0:
        yield _bad(source, "scorer-config", where,
                   f"minLabeled must be >= 0 (got {lc.minLabeled})",
                   "minLabeled")


def _check_checkpoint_width(source: ConfigSource, lc, where: str
                            ) -> Iterator[Finding]:
    """Restore-time contract: the checkpoint this config would restore
    on startup must have been trained at the feature pipeline's width."""
    from linkerd_tpu_torch.models.features import FEATURE_DIM

    directory = resolve_path(source, lc.directory)
    if not os.path.isdir(directory):
        return  # fresh store: created on first checkpoint
    try:
        from linkerd_tpu_torch.lifecycle import CheckpointStore
        store = CheckpointStore(directory)
        serving = store.latest_good()
        if serving is None:
            return
        _, snap = store.load(serving)
    except Exception as e:  # noqa: BLE001 — corrupt store: point at ckpt
        yield _bad(source, "scorer-width", where,
                   f"checkpoint store {lc.directory!r} is unreadable "
                   f"({e}); run `python tools/validator.py ckpt` for the "
                   f"full integrity report",
                   "directory", severity="warning")
        return
    in_dim = getattr(snap.cfg, "in_dim", None)
    if in_dim is not None and in_dim != FEATURE_DIM:
        yield _bad(source, "scorer-width", where,
                   f"serving checkpoint v{serving} in {lc.directory!r} "
                   f"was trained with in_dim={in_dim} but the feature "
                   f"pipeline emits FEATURE_DIM={FEATURE_DIM}-wide "
                   f"vectors — restoreOnStart would crash or score "
                   f"garbage",
                   "directory")
