"""FastPath controller: Python control plane for the native data plane,
counterpart of ``linkerd_tpu/router/fastpath.py`` for both engines
(sharded workers, native TLS, tenant isolation, the connection guard
and the stream sentinel).

A native engine serves the hot loop: native/fastpath.cpp for HTTP/1.1,
routing by Host, or native/h2_fastpath.cpp for h2/gRPC, routing by
``:authority``; the controller drives either through the same surface
and keeps it honest with the naming system:

- route misses surfaced by the engine are resolved through the SAME
  interpreter/dtab machinery the Python path uses (identify -> bind, ref:
  RoutingFactory.scala:154-187), and the resulting address sets are
  installed with the engine's ``set_route``;
- every bind Activity and leaf ``Var[Addr]`` stays observed, so namer
  updates (fs file edits) re-install routes live — address churn flows
  WITHOUT re-binding, the same invariant as DstBindingFactory;
- engine stats feed the MetricsTree under the standard
  ``rt/<label>/fastpath`` scope, and per-request feature rows feed the
  ``io.l5d.jaxAnomaly`` telemeter's native ring, so fastpath traffic is
  scored on the card like Python-path traffic;
- the engine's h2 stream and tunnel sample rows (row kind 1 and 2)
  also feed the Python stream sentinel, which mirrors the engine's
  in-plane stream governor for ``/streams.json``;
- the engine's per-tenant aggregates fold into the router's
  ``TenantBoard`` on the same stats tick, and the tenant quota governor
  steps there, pushing quotas back into the engine.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Dict, List, Optional, Tuple

from linkerd_tpu_torch.core import Dtab, Path
from linkerd_tpu_torch.core.activity import Failed, Ok
from linkerd_tpu_torch.core.addr import Bound as AddrBound, BoundName
from linkerd_tpu_torch.core.nametree import (
    Alt, Empty, Fail, Leaf, NameTree, Neg, Union as TreeUnion,
)

log = logging.getLogger(__name__)


def _collect_leaves(tree: NameTree) -> List[BoundName]:
    """Leaves the engine should balance over: all union branches, first
    viable Alt branch (the engine has no per-request failover, so Alt
    degrades to its primary branch — misses fall back to later branches
    only on re-bind)."""
    if isinstance(tree, Leaf):
        return [tree.value]
    if isinstance(tree, TreeUnion):
        out: List[BoundName] = []
        for w in tree.weighted:
            out.extend(_collect_leaves(w.tree))
        return out
    if isinstance(tree, Alt):
        for sub in tree.trees:
            if isinstance(sub, (Neg, Empty, Fail)):
                continue
            got = _collect_leaves(sub)
            if got:
                return got
    return []


class _HostRoute:
    """Live resolution of one host: bind activity + leaf addr watches."""

    def __init__(self, ctl: "FastPathController", host: str):
        self.ctl = ctl
        self.host = host
        self._leaf_handles: list = []
        self._leaves: List[BoundName] = []
        path = ctl.prefix + Path.read("/" + host)
        self.activity = ctl.interpreter.bind(ctl.dtab, path)
        self._act_handle = self.activity.states.observe(self._on_state)

    def _on_state(self, st) -> None:
        if isinstance(st, Ok):
            tree = st.value.simplified
            leaves = _collect_leaves(tree)
            self._rewatch(leaves)
            self._push()
        elif isinstance(st, Failed):
            # keep the last installed route (fail-static, like balancers
            # keeping their last good replica set on namer failure)
            log.debug("fastpath bind failed for %s: %r", self.host, st.exc)

    def _rewatch(self, leaves: List[BoundName]) -> None:
        for h in self._leaf_handles:
            h.close()
        self._leaf_handles = []
        self._leaves = leaves
        for leaf in leaves:
            self._leaf_handles.append(
                leaf.addr.observe(lambda _a: self._push(), run_now=False))

    def _push(self) -> None:
        eps: List[Tuple[str, int]] = []
        for leaf in self._leaves:
            addr = leaf.addr.sample()
            if isinstance(addr, AddrBound):
                for a in addr.addresses:
                    eps.append((a.host, a.port))
        if eps:
            self.ctl.engine.set_route(self.host, sorted(set(eps)))
            # the in-engine scorer needs the dst-path feature hash
            # before it can featurize this route's rows; must follow
            # set_route (the engine rejects unknown routes)
            self.ctl.push_route_feature(self.host)
        else:
            # Neg everywhere / no replicas: drop the route so the engine
            # answers 400 (parity with UnboundError -> 4xx)
            self.ctl.engine.remove_route(self.host)

    def close(self) -> None:
        for h in self._leaf_handles:
            h.close()
        self._leaf_handles = []
        self._act_handle.close()
        self.activity.close()


class FastPathController:
    """Owns a FastPathEngine for one router: listeners, miss resolution,
    stats export, and anomaly-feature forwarding."""

    def __init__(self, engine, interpreter, base_dtab: Dtab, prefix: Path,
                 label: str, metrics, telemeters=(),
                 miss_poll_s: float = 0.01, stats_poll_s: float = 1.0,
                 max_hosts: int = 10_000, tenant_board=None,
                 tenant_admission=None, stream_sentinel=None):
        self.engine = engine
        self.interpreter = interpreter
        self.dtab = base_dtab
        self.prefix = prefix
        self.label = label
        self.metrics = metrics
        self.telemeters = list(telemeters)
        self.miss_poll_s = miss_poll_s
        self.stats_poll_s = stats_poll_s
        self.max_hosts = max_hosts
        self._routes: Dict[str, _HostRoute] = {}
        self._tasks: List[asyncio.Task] = []
        self._last_stats: Dict[str, Dict[str, int]] = {}
        self._last_scorer: Dict[str, int] = {}
        self._last_tls: Dict[str, int] = {}
        # multi-worker sharding: per-worker counter baselines for the
        # rt/*/fastpath/worker/<i>/* breakdown (merged totals ride the
        # normal scopes above)
        self._last_workers: List[Dict[str, int]] = []
        self._weight_sink_regs: List[tuple] = []
        self._id_to_host: Dict[int, str] = {}
        self._scope = metrics.scope("rt", label, "fastpath")
        self._last_guard: Dict[str, int] = {}
        # tenant isolation: engine per-tenant aggregates feed the board
        # (level inputs for the quota governor) each stats tick, and
        # the governor steps on the same cadence — the engines are the
        # data plane, this loop is their control plane
        self.tenant_board = tenant_board
        self.tenant_admission = tenant_admission
        self._last_tenants: Dict[str, Dict[str, float]] = {}
        # metrics-tree cardinality bound: the engine's tenant table is
        # LRU-bounded, but the metrics tree never forgets a scope —
        # under tenant-id churn each stats tick would otherwise mint
        # fresh rt/*/fastpath/tenant/<hash>/* counters forever. Past
        # this many distinct hashes, deltas roll up under .../other/*.
        self._tenant_metric_keys: set = set()
        self._tenant_metric_cap = 256
        # stream sentinel: the Python-side mirror of the engines'
        # in-plane stream governor. Stream/tunnel sample rows (row kind
        # > 0) drained off the feature ring feed it, keeping the
        # Python table — and any drain/quota escalation the native
        # plane delegates up — in sync with what the engines shed.
        self.stream_sentinel = stream_sentinel
        self._last_streams: Dict[str, int] = {}
        # native line-rate feed state: telemeters whose ring resolver is
        # installed, plus the overflow scratch block (drop-and-count
        # when the ring is full — the engine must not grow unbounded)
        self._native_sinks: set = set()
        import numpy as np
        from linkerd_tpu_torch.telemetry.linerate import NATIVE_ROW_WIDTH
        self._scratch = np.zeros((1024, NATIVE_ROW_WIDTH), np.float32)

    async def start(self) -> None:
        self.engine.start()
        # in-data-plane scoring: hand the engine's weight-slab publish
        # to every telemeter that exports native weight blobs — the
        # telemeter replays its last blob immediately, so an engine
        # that starts after the initial export still gets weights. The
        # delta hook (per-route specialist patches) registers alongside.
        sink = self.engine.publish_weights  # ONE bound method: the
        delta_sink = self.engine.publish_delta  # unregister must
        for t in self.telemeters:               # remove it
            reg = getattr(t, "register_weight_sink", None)
            if reg is not None:
                reg(sink, delta_sink=delta_sink)
                self._weight_sink_regs.append((t, sink))
        from linkerd_tpu_torch.core.tasks import monitor
        self._tasks = [
            monitor(asyncio.create_task(self._miss_loop(),
                                        name=f"fp-miss-{self.label}"),
                    what=f"fp-miss-{self.label}"),
            monitor(asyncio.create_task(self._stats_loop(),
                                        name=f"fp-stats-{self.label}"),
                    what=f"fp-stats-{self.label}"),
        ]

    def push_route_feature(self, host: str) -> None:
        """Install the dst-path feature hash (column, sign) AND the
        specialist-bank route hash for a route in the engine's
        in-data-plane scorer. Both are computed over the SAME
        ``{prefix}/{host}`` dst path the Python featurizer resolves for
        this route (``_route_dst``), so engine-side and Python-side
        features for one route land in the same column — and the
        engine selects exactly the specialist head the distiller
        promoted for this dst."""
        from linkerd_tpu_torch.lifecycle.export import route_hash
        from linkerd_tpu_torch.models.features import path_hash_cols
        dst = f"{self.prefix.show}/{host}"
        col, sign = path_hash_cols(dst)
        try:
            self.engine.set_route_feature(host, col, sign)
        except Exception:  # noqa: BLE001 — a rejecting engine must not
            log.exception("route feature push failed for %r", host)
        try:
            self.engine.set_route_hash(host, route_hash(dst))
        except Exception:  # noqa: BLE001 — same blast-radius contract
            log.exception("route hash push failed for %r", host)

    def resolve(self, host: str) -> None:
        """Begin (or refresh) resolution for a host."""
        host = host.lower()
        if host in self._routes:
            return
        if len(self._routes) >= self.max_hosts:
            log.warning("fastpath host watch limit reached; ignoring %s", host)
            return
        try:
            self._routes[host] = _HostRoute(self, host)
        except Exception:  # noqa: BLE001 — a bad host must not kill the loop
            log.exception("fastpath resolution setup failed for %r", host)

    async def _miss_loop(self) -> None:
        while True:
            try:
                misses = self.engine.drain_misses()
                for host in misses:
                    if host:
                        self.resolve(host)
                await asyncio.sleep(self.miss_poll_s)
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001
                log.exception("fastpath miss loop error")
                await asyncio.sleep(0.5)

    async def _stats_loop(self) -> None:
        while True:
            try:
                await asyncio.sleep(self.stats_poll_s)
                self._export_stats()
                self._forward_features()
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001
                log.exception("fastpath stats loop error")

    _TLS_KEYS = ("handshakes", "failures", "resumed", "alpn_h2",
                 "alpn_http1", "upstream_handshakes", "upstream_resumed",
                 "upstream_failures")
    _GUARD_KEYS = ("slowloris_closed", "body_stall_closed",
                   "accept_throttled", "hs_churn_shed",
                   "rapid_reset_closed", "flood_closed", "tenant_shed")
    _TENANT_KEYS = ("requests", "shed", "errors", "scored")

    def _export_tenants(self, snap: dict) -> None:
        """Engine per-tenant aggregates → rt/*/fastpath/tenant/* and
        (as deltas) into the TenantBoard; guard counters →
        rt/*/fastpath/guard/*. The quota governor steps on this same
        1 s cadence — sick tenants get their in-engine quota within
        one stats tick of their level crossing the governor's
        threshold."""
        guard = snap.get("guard")
        if guard:
            scope = self._scope.scope("guard")
            prev = self._last_guard
            for key in self._GUARD_KEYS:
                delta = int(guard.get(key, 0)) - int(prev.get(key, 0))
                if delta > 0:
                    scope.counter(key).incr(delta)
            self._last_guard = {k: int(guard.get(k, 0))
                                for k in self._GUARD_KEYS}
        tn = snap.get("tenants")
        if not tn:
            return
        scope = self._scope.scope("tenant")
        scope.gauge("count").set(float(tn.get("count", 0)))
        scope.gauge("evicted").set(float(tn.get("evicted", 0)))
        by = tn.get("by_tenant") or {}
        cur: Dict[str, Dict[str, float]] = {}
        for thash, t in by.items():
            prev = self._last_tenants.get(thash, {})
            if (thash in self._tenant_metric_keys
                    or len(self._tenant_metric_keys)
                    < self._tenant_metric_cap):
                self._tenant_metric_keys.add(thash)
                tscope = scope.scope(thash)
            else:
                tscope = scope.scope("other")
            deltas = {}
            for key in self._TENANT_KEYS:
                d = int(t.get(key, 0)) - int(prev.get(key, 0))
                deltas[key] = max(0, d)
                if d > 0:
                    tscope.counter(key).incr(d)
            cur[thash] = {k: int(t.get(k, 0))
                          for k in self._TENANT_KEYS}
            if self.tenant_board is not None and (
                    deltas["requests"] or deltas["shed"]):
                self.tenant_board.ingest_native(
                    int(thash), deltas["requests"], deltas["errors"],
                    deltas["shed"], t.get("score_ewma"),
                    deltas["scored"])
        self._last_tenants = cur
        if self.tenant_admission is not None:
            self.tenant_admission.step()

    _STREAM_KEYS = ("evicted", "sick_transitions", "rst_sent",
                    "tunnels_opened", "tunnel_idle_closed",
                    "tunnel_bytes_closed")

    def _export_streams(self) -> None:
        """Engine stream-table counters → rt/*/fastpath/streams/*: the
        live proof the stream sentinel is sampling (count gauge) and
        actuating (rst_sent / tunnel-budget closes as counters)."""
        fn = getattr(self.engine, "streams", None)
        if fn is None:
            return  # a scripted engine (tests)
        try:
            snap = fn()
        except Exception:  # noqa: BLE001 — scrape failure must not
            log.exception("fastpath streams scrape failed")  # kill loop
            return
        if not snap or not snap.get("enabled"):
            return
        scope = self._scope.scope("streams")
        scope.gauge("count").set(float(snap.get("count", 0)))
        prev = self._last_streams
        for key in self._STREAM_KEYS:
            delta = int(snap.get(key, 0)) - int(prev.get(key, 0))
            if delta > 0:
                scope.counter(key).incr(delta)
        self._last_streams = {k: int(snap.get(k, 0))
                              for k in self._STREAM_KEYS}

    def streams_snapshot(self) -> dict:
        """/streams.json body: the engine's in-plane stream table plus
        (when wired) the Python sentinel's view, under one document."""
        out: dict = {"enabled": False}
        fn = getattr(self.engine, "streams", None)
        if fn is not None:
            try:
                eng = fn()
            except Exception:  # noqa: BLE001
                eng = {"error": "stream scrape failed"}
            out["engine"] = eng
            out["enabled"] = bool(eng.get("enabled")) \
                if isinstance(eng, dict) else False
        if self.stream_sentinel is not None:
            out["sentinel"] = self.stream_sentinel.snapshot()
            out["enabled"] = True
        return out

    _WORKER_KEYS = ("requests", "accepted", "scored", "unscored",
                    "features_dropped")

    def _export_workers(self, snap: dict) -> None:
        """Per-worker breakdown under rt/*/fastpath/worker/<i>/* when
        the engine is sharded (stats() carries the raw per-worker
        snapshots under ``workers``): the live proof that the kernel's
        SO_REUSEPORT spread is actually using every core, and the
        denominator for merged-equals-sum checks."""
        workers = snap.get("workers")
        if not workers:
            return
        while len(self._last_workers) < len(workers):
            self._last_workers.append({})
        for i, ws in enumerate(workers):
            if not ws:
                # a failed scrape (oversized/errored stats JSON) must
                # not reset this worker's baseline to zero — the next
                # good scrape would re-count its whole history
                continue
            ns = ws.get("native_scorer") or {}
            cur = {
                "requests": sum(int(r.get("requests", 0)) for r in
                                (ws.get("routes") or {}).values()),
                "accepted": int(ws.get("accepted", 0)),
                "scored": int(ns.get("scored", 0)),
                "unscored": int(ns.get("unscored", 0)),
                "features_dropped": int(ws.get("features_dropped", 0)),
            }
            prev = self._last_workers[i]
            scope = self._scope.scope("worker", str(i))
            for key in self._WORKER_KEYS:
                delta = cur[key] - int(prev.get(key, 0))
                if delta > 0:
                    scope.counter(key).incr(delta)
            self._last_workers[i] = cur

    def _export_stats(self) -> None:
        snap = self.engine.stats()
        self._export_tenants(snap)
        self._export_workers(snap)
        self._export_streams()
        tls = snap.get("tls")
        if tls and (tls.get("enabled") or tls.get("client_enabled")):
            scope = self._scope.scope("tls")
            prev = self._last_tls
            for key in self._TLS_KEYS:
                delta = int(tls.get(key, 0)) - int(prev.get(key, 0))
                if delta > 0:
                    scope.counter(key).incr(delta)
            self._last_tls = {k: int(tls.get(k, 0))
                              for k in self._TLS_KEYS}
        ns = snap.get("native_scorer")
        if ns and (ns.get("weights") or ns.get("unscored")):
            # in-data-plane scorer accounting under
            # rt/<label>/fastpath/scorer/*: the live proof of WHICH
            # tier (and which bank generation / specialist head)
            # scored
            scope = self._scope.scope("scorer")
            prev = self._last_scorer
            keys = ("scored", "specialist_scored", "unscored", "swaps",
                    "delta_swaps", "retries")
            for key in keys:
                delta = int(ns.get(key, 0)) - int(prev.get(key, 0))
                if delta > 0:
                    scope.counter(key).incr(delta)
            self._last_scorer = {k: int(ns.get(k, 0)) for k in keys}
            scope.gauge("weights").set(1.0 if ns.get("weights") else 0.0)
            scope.gauge("version").set(float(ns.get("version", 0)))
            scope.gauge("crc").set(float(ns.get("crc", 0)))
            scope.gauge("generation").set(
                float(ns.get("generation", 0)))
            scope.gauge("heads").set(float(ns.get("heads", 0)))
        for host, s in snap.get("routes", {}).items():
            if "id" in s:
                self._id_to_host[int(s["id"])] = host
            prev = self._last_stats.get(host, {})
            scope = self._scope.scope("route", host)
            for key in ("requests", "success", "f4xx", "f5xx", "conn_fail"):
                delta = int(s.get(key, 0)) - int(prev.get(key, 0))
                if delta > 0:
                    scope.counter(key).incr(delta)
            self._last_stats[host] = {
                k: int(s.get(k, 0))
                for k in ("requests", "success", "f4xx", "f5xx", "conn_fail")}

    def _route_dst(self, route_id: int) -> Optional[str]:
        """route_id -> dst path for feature attribution, or None while
        the id is not yet in the stats-loop mapping (the featurizer
        then uses an UNCACHED placeholder, so attribution self-corrects
        on the next 1s stats tick instead of pinning a stale name)."""
        host = self._id_to_host.get(int(route_id))
        if host is None:
            return None
        return f"{self.prefix.show}/{host}"

    def _forward_features(self) -> None:
        """Forward per-request engine rows to the anomaly telemeters.

        Line-rate path: rows are drained by the engine DIRECTLY into
        the telemeter's preallocated NativeFeatureRing
        (``drain_features_into`` memcpys C → ring memory) and consumed
        zero-copy by the micro-batcher — no per-row Python objects on
        the C++→Python seam. With no such telemeter the rows are
        drained (stream and tunnel samples to the sentinel) and
        dropped, so the engine's queue never fills. (The reference's
        per-row FeatureVector feed serves telemeters with a ring and no
        native ring; the port has none.) Stream and tunnel sample rows
        reach the telemeters' rings like request rows, as the
        reference sends them, and the sentinel besides."""
        from linkerd_tpu_torch.telemetry.linerate import NATIVE_COL_KIND
        sinks = [t for t in self.telemeters
                 if getattr(t, "native_ring", None) is not None]
        if not sinks:
            rows = self.engine.drain_features()
            if self.stream_sentinel is not None:
                srows = rows[rows[:, NATIVE_COL_KIND] > 0.5]
                if len(srows):
                    self.stream_sentinel.ingest_rows(srows)
            return
        primary, extras = sinks[0], sinks[1:]
        for t in sinks:
            if t not in self._native_sinks:
                t.set_native_route_resolver(self._route_dst)
                self._native_sinks.add(t)
        ring = primary.native_ring
        total = 0
        drained_views = []  # row views, for fan-out to other consumers
        while True:
            wrote = 0
            for view in ring.produce_views():
                n = self.engine.drain_features_into(view)
                ring.commit(n)
                if n:
                    drained_views.append(view[:n])
                wrote += n
                if n < len(view):
                    break
            total += wrote
            if wrote == 0:
                break
        # ring full but the engine may still hold rows: shed them into
        # a scratch buffer so neither side grows unbounded. Shed rows
        # still COUNT toward requests_total (they entered the scoring
        # path and were dropped — under backpressure the scored
        # fraction must report < 1.0, not lie)
        dropped = 0
        if ring.free == 0:
            while True:
                n = self.engine.drain_features_into(self._scratch)
                if n <= 0:
                    break
                ring.drop(n)
                dropped += n
                if n < len(self._scratch):
                    break
        if total or dropped:
            primary.native_committed(total, dropped=dropped)
        # fan out: additional native sinks get a copy of the drained
        # block (the zero-copy path is inherently per-ring; a second
        # telemeter is a second consumer)
        for t in extras:
            copied = 0
            for block in drained_views:
                off = 0
                for view in t.native_ring.produce_views(len(block)):
                    k = len(view)
                    view[:] = block[off:off + k]
                    off += k
                t.native_ring.commit(off)
                copied += off
            short = (total - copied) + dropped
            if short > 0:
                t.native_ring.drop(short)
            if copied or short:
                t.native_committed(copied, dropped=short)
        # stream/tunnel sample rows also feed the Python sentinel (the
        # ring consumers route on the kind column themselves; the
        # sentinel needs its own look for drain/quota escalation)
        if self.stream_sentinel is not None:
            for block in drained_views:
                srows = block[block[:, NATIVE_COL_KIND] > 0.5]
                if len(srows):
                    self.stream_sentinel.ingest_rows(srows)

    async def close(self) -> None:
        # detach the task list BEFORE awaiting: a start() interleaving
        # with the cancel waits would otherwise have its fresh loops
        # clobbered by the assignment below and leak, still running
        tasks, self._tasks = self._tasks, []
        for t in tasks:
            t.cancel()
        for t in tasks:
            try:
                await t
            except asyncio.CancelledError:
                pass
            except Exception as e:  # noqa: BLE001 — loop crashes were
                log.debug("fastpath loop exit: %r", e)  # already logged
        # detach from weight publication BEFORE freeing the engine: a
        # lifecycle promote after close() must not call into freed
        # native memory (the engine guard raises, but the sink should
        # simply be gone)
        regs, self._weight_sink_regs = self._weight_sink_regs, []
        for t, sink in regs:
            unreg = getattr(t, "unregister_weight_sink", None)
            if unreg is not None:
                unreg(sink)
        for r in self._routes.values():
            r.close()
        self._routes.clear()
        self.engine.close()
