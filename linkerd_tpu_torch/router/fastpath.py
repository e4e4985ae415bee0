"""FastPath controller: Python control plane for the native data plane,
counterpart of ``linkerd_tpu/router/fastpath.py`` for one HTTP/1.1
engine (no tenants, streams or sharded workers).

The native engine (native/fastpath.cpp) serves the HTTP/1.1 hot loop; this
module keeps it honest with the naming system:

- route misses surfaced by the engine are resolved through the SAME
  interpreter/dtab machinery the Python path uses (identify -> bind, ref:
  RoutingFactory.scala:154-187), and the resulting address sets are
  installed with ``fp_set_route``;
- every bind Activity and leaf ``Var[Addr]`` stays observed, so namer
  updates (fs file edits) re-install routes live — address churn flows
  WITHOUT re-binding, the same invariant as DstBindingFactory;
- engine stats feed the MetricsTree under the standard
  ``rt/<label>/fastpath`` scope, and per-request feature rows feed the
  ``io.l5d.jaxAnomaly`` telemeter's native ring, so fastpath traffic is
  scored on the card like Python-path traffic.
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
                 max_hosts: int = 10_000):
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
        self._weight_sink_regs: List[tuple] = []
        self._id_to_host: Dict[int, str] = {}
        self._scope = metrics.scope("rt", label, "fastpath")
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

    def _export_stats(self) -> None:
        snap = self.engine.stats()
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
        drained and dropped, so the engine's queue never fills. (The
        reference's per-row FeatureVector feed serves telemeters with a
        ring and no native ring; the port has none.)"""
        sinks = [t for t in self.telemeters
                 if getattr(t, "native_ring", None) is not None]
        if not sinks:
            self.engine.drain_features()
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

    def streams_snapshot(self) -> dict:
        """/streams.json body (ref: linkerd_tpu/router/fastpath.py:363):
        the port's engine has no stream table and no sentinel while
        ``streamScoring`` is refused (ROADMAP Queue 1 item 4)."""
        return {"enabled": False}

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
