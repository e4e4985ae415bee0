"""MeshReactor: anomaly-triggered dtab overrides through namerd: a copy
of ``linkerd_tpu/control/reactor.py`` whose ``verify_override`` runs the
port's own copy of l5dcheck's ``check_override`` (``control/verify.py``):
the reference's lives in ``tools/``, which imports ``linkerd_tpu``.

When a whole cluster trends anomalous, per-replica down-weighting inside
one linkerd is not enough — the *fleet* must shift. The reactor watches
cluster-level score aggregates; past the hysteresis governor's guarded
threshold it appends a traffic-shifting dentry (``/svc/web =>
/svc/web-b``) to the namespace dtab and publishes it through the namerd
store with compare-and-swap, so every linkerd watching that namespace
re-binds away from the sick cluster. When scores recover (and the dwell
has elapsed), the exact dentry is removed again.

Safety properties:

- **verified before published** — the candidate override runs through
  l5dcheck's symbolic delegation (``override-unsafe``: cycles, unbound
  or neg-only destinations, collateral shadowing of unrelated rules);
  a bad override is rejected and counted, never published;
- **CAS, never clobber** — publishes and reverts are version-checked
  writes; a concurrent operator edit wins and the reactor retries
  against the new version on its next step;
- **flap-free** — all threshold logic lives in the shared
  ``HysteresisGovernor`` (split thresholds + quorum + dwell);
- **observable** — every actuation is a counter + a span
  (``control.override`` with cluster/action/verify tags) and shows in
  ``/control.json`` with its reason.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from linkerd_tpu_torch.core import Dtab, Path
from linkerd_tpu_torch.core.dtab import Dentry
from linkerd_tpu_torch.namerd.store import (
    DtabNamespaceAlreadyExists, DtabNamespaceDoesNotExist, DtabStore,
    DtabVersionMismatch, VersionedDtab,
)
from linkerd_tpu_torch.control.state import SICK, HysteresisGovernor

log = logging.getLogger(__name__)


class OverrideRejected(Exception):
    """The generated override failed l5dcheck verification; it was NOT
    published."""


class OverrideFenced(Exception):
    """A store write was refused because this instance was superseded
    (fleet generation fencing) after the step began."""


class LocalStoreClient:
    """Reactor store client over an in-process DtabStore (embedded
    namerd, tests, bench)."""

    def __init__(self, store: DtabStore):
        self._store = store

    async def fetch(self, ns: str) -> Optional[VersionedDtab]:
        from linkerd_tpu_torch.core.activity import Ok
        act = self._store.observe(ns)
        st = act.current
        if isinstance(st, Ok):
            return st.value
        return await act.to_future()

    async def watch(self, ns: str):
        """Standing watch on a namespace: yields each Dtab state as the
        store publishes it (the in-process store's Activity stream —
        the same push the namerd ifaces serve remotely). One call =
        one open watch; the caller owns reconnect policy."""
        from linkerd_tpu_torch.core.activity import Failed, Ok, Pending
        act = self._store.observe(ns)
        async for st in act.changes():
            if isinstance(st, Pending):
                continue
            if isinstance(st, Failed):
                raise st.exc
            if isinstance(st, Ok) and st.value is not None:
                yield st.value.dtab

    async def cas(self, ns: str, dtab: Dtab, version: bytes) -> None:
        await self._store.update(ns, dtab, version)

    async def create(self, ns: str, dtab: Dtab) -> None:
        await self._store.create(ns, dtab)

    async def aclose(self) -> None:
        return


class NamerdHttpStoreClient:
    """Reactor store client over namerd's HTTP control API
    (``/api/1/dtabs/<ns>`` with ETag/If-Match CAS), for linkers whose
    control plane is a remote namerd."""

    def __init__(self, address: str):
        host, _, port = address.partition(":")
        self._host = host
        self._port = int(port or 4180)
        self._client = None

    def _ensure_client(self):
        if self._client is None:
            from linkerd_tpu_torch.protocol.http.client import HttpClient
            self._client = HttpClient(self._host, self._port)
        return self._client

    async def fetch(self, ns: str) -> Optional[VersionedDtab]:
        from linkerd_tpu_torch.protocol.http.message import Request
        rsp = await self._ensure_client()(
            Request(method="GET", uri=f"/api/1/dtabs/{ns}"))
        if rsp.status == 404:
            return None
        if rsp.status != 200:
            raise RuntimeError(
                f"namerd GET dtabs/{ns} failed: {rsp.status}")
        etag = rsp.headers.get("etag")
        if not etag:
            # no version means no CAS: refusing is the only option that
            # preserves the reactor's never-clobber guarantee
            raise RuntimeError(
                f"namerd GET dtabs/{ns} returned no ETag; refusing to "
                f"write without compare-and-swap")
        body = rsp.body or b""
        import json
        dentries = json.loads(body.decode())
        dtab = Dtab.read(";".join(
            f"{d['prefix']} => {d['dst']}" for d in dentries))
        return VersionedDtab(dtab, bytes.fromhex(etag))

    async def cas(self, ns: str, dtab: Dtab, version: bytes) -> None:
        from linkerd_tpu_torch.protocol.http.message import Request
        req = Request(method="PUT", uri=f"/api/1/dtabs/{ns}",
                      body=dtab.show.encode())
        req.headers.set("Content-Type", "application/dtab")
        req.headers.set("If-Match", version.hex())
        rsp = await self._ensure_client()(req)
        if rsp.status == 412:
            raise DtabVersionMismatch(ns)
        if rsp.status == 404:
            # the namespace vanished between fetch and cas (operator
            # delete): the typed error lets retry loops re-create it
            # instead of treating a recoverable race as a hard failure
            raise DtabNamespaceDoesNotExist(ns)
        if rsp.status not in (200, 204):
            raise RuntimeError(
                f"namerd PUT dtabs/{ns} failed: {rsp.status}")

    async def create(self, ns: str, dtab: Dtab) -> None:
        from linkerd_tpu_torch.protocol.http.message import Request
        req = Request(method="POST", uri=f"/api/1/dtabs/{ns}",
                      body=dtab.show.encode())
        req.headers.set("Content-Type", "application/dtab")
        rsp = await self._ensure_client()(req)
        if rsp.status == 409:
            raise DtabNamespaceAlreadyExists(ns)
        if rsp.status not in (200, 204):
            raise RuntimeError(
                f"namerd POST dtabs/{ns} failed: {rsp.status}")

    async def watch(self, ns: str):
        """Standing watch over ``/api/1/dtabs/<ns>?watch=true`` (the
        chunked NDJSON stream the namerd HTTP iface already serves):
        yields each Dtab state as namerd pushes it. One call = one open
        connection; the caller owns reconnect policy."""
        from urllib.parse import quote

        from linkerd_tpu_torch.interpreter.namerd_http import _watch_ndjson
        uri = f"/api/1/dtabs/{quote(ns)}?watch=true"
        async for data in _watch_ndjson(self._host, self._port, uri):
            if data is None:
                continue  # namespace does not exist (yet)
            if isinstance(data, dict) and "error" in data:
                raise RuntimeError(f"namerd dtab watch: {data['error']}")
            dtab = Dtab.read(";".join(
                f"{d['prefix']} => {d['dst']}" for d in data))
            yield dtab

    async def aclose(self) -> None:
        if self._client is not None:
            await self._client.close()


async def cas_modify(client, ns: str, mutate: Callable[[Dtab], Dtab],
                     retries: int = 8,
                     create_if_missing: Optional[Dtab] = None,
                     on_conflict: Optional[Callable[[], None]] = None
                     ) -> Dtab:
    """Read-modify-write a namespace under CAS with bounded
    retry-on-conflict — the hardened path N concurrent writers (fleet
    instances publishing score docs, racing reactors) converge through:
    every round re-fetches the LATEST version and re-applies ``mutate``
    to it, so a lost CAS can delay a write but never lose a concurrent
    one. Returns the dtab this writer successfully wrote.

    ``create_if_missing``: base dtab to create the namespace from when
    it does not exist (creation itself is race-safe: a concurrent
    create turns into one more retry round). ``on_conflict`` is called
    once per lost CAS (conflict accounting)."""
    last: Optional[Exception] = None
    for _ in range(max(1, retries)):
        vd = await client.fetch(ns)
        if vd is None:
            if create_if_missing is None:
                raise DtabNamespaceDoesNotExist(ns)
            out = mutate(create_if_missing)
            try:
                await client.create(ns, out)
                return out
            except DtabNamespaceAlreadyExists as e:
                last = e  # a peer won the create: retry as an update
                continue
        try:
            out = mutate(vd.dtab)
            await client.cas(ns, out, vd.version)
            return out
        except (DtabVersionMismatch, DtabNamespaceDoesNotExist) as e:
            last = e
            if on_conflict is not None:
                on_conflict()
    raise DtabVersionMismatch(ns) from last


def verify_override(base: Dtab, override: Dtab,
                    namer_prefixes: Optional[Sequence[Path]]) -> List[str]:
    """Run the l5dcheck ``override-unsafe`` analysis (the port's own
    copy, ``control/verify.py``); returns the messages of unsuppressed
    findings (empty = safe to publish)."""
    from linkerd_tpu_torch.control.verify import check_override
    return [f.message for f in
            check_override(base, override, namer_prefixes)
            if not f.suppressed]


class LocalOverrideBook:
    """In-process override dentries consulted per-request by this
    linker's routers (the ``local_dtab_fn`` seam on RoutingService).

    The namerd store is the fleet-wide actuation path; the book is the
    PARTITION fallback: when the reactor cannot reach the store, a
    region-local quorum verdict still shifts THIS instance's traffic by
    appending the override to the request's local dtab — and the dentry
    is published to the store on heal (exactly once: the actuate path's
    adopt-if-present absorbs the race with fleet peers healing
    simultaneously). Booked dentries are filtered per destination path
    so an override for ``/svc/web`` never perturbs the binding cache
    key of an unrelated service."""

    def __init__(self):
        self._dentries: Dict[str, Dentry] = {}  # cluster -> dentry
        self.version = 0  # bumped on every change (cheap staleness probe)

    def __len__(self) -> int:
        return len(self._dentries)

    def __contains__(self, cluster: str) -> bool:
        return cluster in self._dentries

    def set(self, cluster: str, dentry: Dentry) -> None:
        if self._dentries.get(cluster) != dentry:
            self._dentries[cluster] = dentry
            self.version += 1

    def drop(self, cluster: str) -> Optional[Dentry]:
        dentry = self._dentries.pop(cluster, None)
        if dentry is not None:
            self.version += 1
        return dentry

    def clear(self) -> None:
        if self._dentries:
            self._dentries.clear()
            self.version += 1

    def clusters(self) -> List[str]:
        return list(self._dentries)

    def dtab_for(self, path: Path) -> Dtab:
        """The booked dentries that can affect ``path`` (the dentry's
        prefix is a prefix of the destination); empty for everything
        else, so unrelated services keep their cached binds."""
        if not self._dentries:
            return Dtab.empty()
        matched = [d for d in self._dentries.values()
                   if d.prefix.matches(path)]
        return Dtab(matched) if matched else Dtab.empty()

    def status(self) -> dict:
        return {c: d.show for c, d in sorted(self._dentries.items())}


class MeshReactor:
    """See module docstring. Drive with periodic ``step()`` calls (the
    ControlLoop does); every step is serialized under one lock so an
    actuate can never interleave with a revert of the same cluster."""

    def __init__(self, board, client, namespace: str,
                 failover: Dict[str, str],
                 governor: Optional[HysteresisGovernor] = None,
                 metrics_node=None,
                 namer_prefixes: Optional[Sequence[Path]] = None,
                 verify: bool = True,
                 verifier: Optional[Callable] = None,
                 store_timeout_s: float = 3.0,
                 fleet=None,
                 region_failover: Optional[Dict[str, Dict[str, str]]] = None,
                 local_book: Optional[LocalOverrideBook] = None,
                 heal_probe_interval_s: float = 0.5):
        for cluster, target in failover.items():
            Path.read(cluster)  # raises on bad config up front
            Path.read(target)
        for cluster, per_region in (region_failover or {}).items():
            Path.read(cluster)
            for target in per_region.values():
                Path.read(target)
        self._board = board
        self._client = client
        self._ns = namespace
        self._failover = dict(failover)
        # cluster -> {peer region -> target path}: cross-region shifts,
        # chosen per actuation from the healthiest FRESH peer digest
        # (fleet/regions.py); requires a fleet exchange with a region
        self._region_failover = {c: dict(m)
                                 for c, m in (region_failover or {}).items()}
        # every cluster the governor watches, local or cross-region
        self._watched = sorted(set(self._failover)
                               | set(self._region_failover))
        self._governor = governor or HysteresisGovernor()
        # fleet mode (a FleetExchange): the governor observes the
        # QUORUM level — the K-th highest level reported by fresh fleet
        # instances, self included — instead of this router's view
        # alone, and a superseded incarnation (a newer generation took
        # over our instance id) never actuates or reverts again
        self._fleet = fleet
        # None = unknown (remote namerd): verification skips
        # namer-reachability, keeps cycle/shadow analysis
        self._namer_prefixes = (list(namer_prefixes)
                                if namer_prefixes is not None else None)
        self._verify = verify
        self._verifier = verifier or verify_override
        # every store round-trip is bounded: a hung namerd must cost one
        # timed-out step, not wedge the whole control loop (admission
        # modulation shares the same driver) behind this lock forever
        self._store_timeout_s = store_timeout_s
        self._lock = asyncio.Lock()
        self._tracer = None
        # cluster -> the exact dentry this reactor appended (removed
        # verbatim on revert; an operator's own edits are never touched)
        self.active: Dict[str, Dentry] = {}
        self.rejected: Dict[str, str] = {}  # cluster -> last reject reason
        # partition-tolerant local actuation (see LocalOverrideBook):
        # cluster -> dentry actuated ONLY in this process, pending
        # store publication on heal
        self._book = local_book
        self.booked: Dict[str, Dentry] = {}
        self._partitioned = False
        self._partitioned_at: Optional[float] = None
        self._heal_probe_interval_s = heal_probe_interval_s
        self._last_probe: Optional[float] = None
        self.last_heal_reconcile_ms: Optional[float] = None
        node = metrics_node
        if node is not None:
            self._published = node.counter("overrides_published")
            self._reverted = node.counter("overrides_reverted")
            self._rejected_c = node.counter("overrides_rejected")
            self._adopted = node.counter("overrides_adopted")
            self._conflicts = node.counter("cas_conflicts")
            self._errors = node.counter("errors")
            self._fenced = node.counter("fenced_steps")
            self._local_acts = node.counter("local_actuations")
            self._local_revs = node.counter("local_reverts")
            self._heals = node.counter("heal_reconciles")
            self._probes = node.counter("partition_probes")
            self._xregion = node.counter("xregion_overrides")
            node.gauge("active_overrides",
                       fn=lambda: float(len(self.active)))
            node.gauge("booked_overrides",
                       fn=lambda: float(len(self.booked)))
            node.gauge("partitioned",
                       fn=lambda: 1.0 if self._partitioned else 0.0)
        else:
            self._published = self._reverted = self._rejected_c = None
            self._adopted = self._conflicts = self._errors = None
            self._fenced = None
            self._local_acts = self._local_revs = self._heals = None
            self._probes = self._xregion = None

    def set_tracer(self, tracer) -> None:
        self._tracer = tracer

    # -- level aggregation -------------------------------------------------
    def cluster_levels(self) -> Dict[str, float]:
        """Per-watched-cluster anomaly level: the max effective score of
        the cluster path itself and anything under it. Degraded scorer
        path reads 0 everywhere — no signal beats a stale signal, and
        the governor's dwell keeps an active override from snapping
        back the instant the scorer dies."""
        if getattr(self._board, "degraded", False):
            return {c: 0.0 for c in self._watched}
        eff = self._board.effective_scores()
        levels: Dict[str, float] = {}
        for cluster in self._watched:
            prefix = cluster.rstrip("/") + "/"
            levels[cluster] = max(
                (s for d, s in eff.items()
                 if d == cluster or d.startswith(prefix)),
                default=0.0)
        return levels

    def actuation_levels(self) -> Dict[str, float]:
        """The levels the governor actually observes: local cluster
        levels, folded through the fleet quorum order-statistic when a
        FleetExchange is attached (K-of-N instances must independently
        report a level for it to count)."""
        levels = self.cluster_levels()
        if self._fleet is None:
            return levels
        return {cluster: self._fleet.quorum_level(cluster, lvl)
                for cluster, lvl in levels.items()}

    def _target_for(self, cluster: str) -> Tuple[Optional[str],
                                                 Optional[str]]:
        """Resolve the failover target for a SICK cluster: the
        healthiest FRESH peer region with a configured cross-region
        target wins (the hierarchical shift the digests exist for);
        the local failover target is the fallback — which is exactly
        what a WAN-partitioned region degrades to, since its peer
        digests go stale. Returns (target, region); region is None for
        a local target, and (None, None) when nothing applies."""
        if self._fleet is not None and cluster in self._region_failover:
            per_region = self._region_failover[cluster]
            # candidacy bar is ENTER (the sickness threshold), not
            # exit: exit is the deliberately tight revert bar, and
            # healthy scorer levels oscillate right below it under
            # load — gating candidacy there makes the cross-region
            # choice flap with noise while the region is nowhere near
            # sick. Healthiest-first ordering still prefers the
            # calmest region among the candidates.
            for region in self._fleet.healthy_peer_regions(
                    cluster, self._governor.enter):
                target = per_region.get(region)
                if target is not None:
                    return target, region
        target = self._failover.get(cluster)
        return (target, None) if target is not None else (None, None)

    # -- the loop body -----------------------------------------------------
    async def step(self, now: Optional[float] = None) -> None:
        """One evaluation pass: fold current levels into the governor
        and reconcile the published overrides with its verdicts.

        Store connectivity loss (OSError / timeout) flips the reactor
        into PARTITION mode: actuations land in the LocalOverrideBook
        (this instance's routers apply them per-request), reverts of
        booked overrides are free, and store traffic throttles down to
        one short probe per ``heal_probe_interval_s``. A successful
        probe heals: the fetched namespace state is ingested into the
        fleet view FIRST (so generation/region fences are current —
        a zombie drops its book without writing), then still-SICK
        booked clusters publish through the normal actuate path, whose
        adopt-if-present makes the fleet-wide publish exactly-once."""
        async with self._lock:
            if self._fleet is not None and self._fleet.superseded:
                # generation fence: a newer incarnation of this instance
                # id is publishing — this process is a zombie whose
                # stale view must never shift the mesh NOR revert its
                # successor's override
                if self._fenced is not None:
                    self._fenced.incr()
                self._drop_book()
                return
            mono = time.monotonic()
            store_ok = True
            healed_at: Optional[float] = None
            if self._partitioned:
                if (self._last_probe is not None
                        and mono - self._last_probe
                        < self._heal_probe_interval_s):
                    store_ok = False  # throttle: no store traffic yet
                else:
                    self._last_probe = mono
                    store_ok = await self._probe_heal()
                    if store_ok:
                        healed_at = time.monotonic()
            booked_before = len(self.booked)
            levels = self.actuation_levels()
            for cluster in self._watched:
                state = self._governor.observe(
                    cluster, levels.get(cluster, 0.0), now)
                level = levels.get(cluster, 0.0)
                try:
                    if state == SICK and cluster not in self.active:
                        target, region = (self._target_for(cluster)
                                          if cluster not in self.booked
                                          else (None, None))
                        if cluster in self.booked:
                            if store_ok:
                                # heal: publish the booked override
                                # (adopt-if-present = exactly once)
                                dentry = self.booked[cluster]
                                await self._actuate(
                                    cluster, dentry.dst.show, level)
                                self._unbook(cluster, quiet=True)
                        elif target is None:
                            pass  # nothing configured / no healthy peer
                        elif store_ok:
                            await self._actuate(cluster, target, level,
                                                region=region)
                        else:
                            self._book_override(cluster, target, level)
                    elif state != SICK:
                        if cluster in self.booked:
                            self._unbook(cluster, level=level)
                        if cluster in self.active and store_ok:
                            await self._revert(cluster, level)
                except DtabVersionMismatch:
                    # a concurrent write won the CAS; re-fetch and retry
                    # on the next step rather than looping hot here
                    if self._conflicts is not None:
                        self._conflicts.incr()
                except OverrideFenced:
                    # superseded between the step's entry check and the
                    # write dispatch: the successor owns the mesh now
                    if self._fenced is not None:
                        self._fenced.incr()
                    log.warning("control write for %s dropped: instance "
                                "superseded mid-step", cluster)
                except (OSError, asyncio.TimeoutError) as e:
                    # the store is unreachable, not wrong: enter
                    # partition mode and actuate locally — a cut-off
                    # region keeps protecting its own traffic on the
                    # region-local quorum it can still see
                    self._note_partition(e)
                    store_ok = False
                    if (state == SICK and cluster not in self.active
                            and cluster not in self.booked):
                        target, _ = self._target_for(cluster)
                        if target is not None:
                            self._book_override(cluster, target, level)
                except asyncio.CancelledError:
                    raise
                except Exception as e:  # noqa: BLE001 — one cluster's
                    # store trouble must not starve the others; the
                    # governor state persists so the next step retries
                    if self._errors is not None:
                        self._errors.incr()
                    log.warning("control reactor step failed for %s: %r",
                                cluster, e)
            if healed_at is not None and booked_before:
                self.last_heal_reconcile_ms = round(
                    (time.monotonic() - healed_at) * 1e3, 3)

    def _fence_blocked(self) -> bool:
        """True when a newer incarnation of this instance has taken
        over (fleet generation fencing), OR this instance led its
        region and a successor leader's newer-generation digest has
        been observed (region fencing — a healed zombie region must
        not revert the successor's override). Checked at step entry
        AND re-checked after every store await before a CAS goes out:
        the supersede signal can arrive (gossip/namerd ingest) while
        this step is parked on a fetch, and a zombie's write — publish
        or revert — must not clobber its successor's."""
        if self._fleet is None:
            return False
        return (self._fleet.superseded
                or getattr(self._fleet, "region_fenced", False))

    # -- partition-tolerant local actuation --------------------------------
    def _note_partition(self, exc: Exception) -> None:
        if not self._partitioned:
            self._partitioned = True
            self._partitioned_at = time.monotonic()
            self._last_probe = time.monotonic()
            log.warning("control store unreachable (%r): PARTITION mode — "
                        "actuating locally on the quorum this instance "
                        "can still see", exc)

    async def _probe_heal(self) -> bool:
        """One short-timeout store fetch while partitioned. Success
        heals: the fetched state is folded into the fleet view BEFORE
        anything is written, so the fences reflect what happened on
        the far side of the cut — a superseded zombie finds out HERE
        and drops its book instead of publishing it."""
        if self._probes is not None:
            self._probes.incr()
        try:
            vd = await asyncio.wait_for(
                self._client.fetch(self._ns),
                min(1.0, self._store_timeout_s))
        except asyncio.CancelledError:
            raise
        except Exception:  # noqa: BLE001 — still cut off; probe again
            # after the throttle interval (any failure mode counts:
            # the probe's job is reachability, not correctness)
            return False
        healed_after = (time.monotonic() - self._partitioned_at
                        if self._partitioned_at is not None else 0.0)
        self._partitioned = False
        self._partitioned_at = None
        if self._fleet is not None and vd is not None:
            self._fleet.ingest_dtab(vd.dtab)
        if self._heals is not None:
            self._heals.incr()
        log.warning("control store reachable again after %.1fs: "
                    "reconciling %d booked override(s)",
                    healed_after, len(self.booked))
        if self._fence_blocked():
            # we are the zombie side of the partition: the successor's
            # state (ingested above) owns the mesh — drop the book
            # without a single store write
            if self._fenced is not None:
                self._fenced.incr()
            self._drop_book()
        return True

    def _book_override(self, cluster: str, target: str,
                       level: float) -> None:
        if self._book is None:
            return
        dentry = Dtab.read(f"{cluster} => {target} ;")[0]
        self._book.set(cluster, dentry)
        self.booked[cluster] = dentry
        if self._local_acts is not None:
            self._local_acts.incr()
        log.warning("control override BOOKED locally (store partitioned): "
                    "%s => %s (level=%.3f)", cluster, target, level)
        self._span("book", cluster, target, level)

    def _unbook(self, cluster: str, level: float = 0.0,
                quiet: bool = False) -> None:
        dentry = self.booked.pop(cluster, None)
        if self._book is not None:
            self._book.drop(cluster)
        if dentry is None or quiet:
            return
        if self._local_revs is not None:
            self._local_revs.incr()
        log.warning("control override UNBOOKED (local revert): %s "
                    "(level=%.3f)", cluster, level)
        self._span("unbook", cluster, dentry.dst.show, level)

    def _drop_book(self) -> None:
        for cluster in list(self.booked):
            self._unbook(cluster, quiet=True)
        if self._book is not None:
            self._book.clear()

    async def _fetch(self) -> Optional[VersionedDtab]:
        return await asyncio.wait_for(self._client.fetch(self._ns),
                                      self._store_timeout_s)

    async def _cas(self, dtab: Dtab, version: bytes) -> None:
        async def dispatch() -> None:
            # fencing backstop at the last atomic instant before the
            # write leaves: wait_for schedules this coroutine on a later
            # loop iteration, and a gossip/exchange handler running in
            # between may have ingested our supersede
            if self._fence_blocked():
                raise OverrideFenced(self._ns)
            await self._client.cas(self._ns, dtab, version)

        await asyncio.wait_for(dispatch(), self._store_timeout_s)

    async def _actuate(self, cluster: str, target: str,
                       level: float,
                       region: Optional[str] = None) -> None:
        vd = await self._fetch()
        if vd is None:
            raise RuntimeError(
                f"dtab namespace {self._ns!r} does not exist")
        if self._fence_blocked():
            # checked BEFORE the adopt branch too: a fenced zombie must
            # not even ADOPT the successor's dentry — adoption records
            # ownership in ``active``, and ownership is a claim to
            # revert later
            if self._fenced is not None:
                self._fenced.incr()
            log.warning("control override for %s NOT published: this "
                        "instance was superseded mid-step", cluster)
            return
        override = Dtab.read(f"{cluster} => {target} ;")
        existing = next((d for d in vd.dtab
                         if d.prefix == override[0].prefix), None)
        if existing is not None:
            # a fleet peer's reactor already holds an override for this
            # cluster: ADOPT the peer's dentry instead of stacking a
            # second one — even when its target differs from the one we
            # computed (region digest views diverge under WAN staleness:
            # the peer saw the cross-region target fresh while we did
            # not, or vice versa; stacking two dentries for one prefix
            # would let publish ORDER pick the serving target and double
            # the flap count). Recording the dentry actually in the
            # namespace keeps every adopter's revert exact.
            self.active[cluster] = existing
            self.rejected.pop(cluster, None)
            if self._adopted is not None:
                self._adopted.incr()
            log.info("control override ADOPTED (already published by a "
                     "peer): %s (ns=%s)", existing.show, self._ns)
            return
        if self._verify:
            problems = self._verifier(vd.dtab, override,
                                      self._namer_prefixes)
            if problems:
                reason = problems[0]
                first_time = self.rejected.get(cluster) != reason
                self.rejected[cluster] = reason
                if self._rejected_c is not None:
                    self._rejected_c.incr()
                if first_time:
                    log.warning(
                        "control override for %s REJECTED by l5dcheck "
                        "(not published): %s", cluster, reason)
                self._span("reject", cluster, target, level)
                return
        # (no await between the post-fetch fence check above and here;
        # the _cas dispatch re-checks at the last atomic instant)
        await self._cas(vd.dtab + override, vd.version)
        self.active[cluster] = override[0]
        self.rejected.pop(cluster, None)
        if self._published is not None:
            self._published.incr()
        if region is not None and self._xregion is not None:
            self._xregion.incr()
        log.warning("control override PUBLISHED: %s => %s "
                    "(ns=%s, level=%.3f%s)", cluster, target, self._ns,
                    level,
                    f", cross-region -> {region}" if region else "")
        self._span("publish", cluster, target, level)

    async def _revert(self, cluster: str, level: float) -> None:
        vd = await self._fetch()
        if self._fence_blocked():
            # superseded while parked on the fetch: the dentry now
            # belongs to our successor (same failover config publishes
            # the same dentry) — removing it would un-shift the mesh
            # the successor still believes shifted
            if self._fenced is not None:
                self._fenced.incr()
            log.warning("control override for %s NOT reverted: this "
                        "instance was superseded mid-step", cluster)
            return
        dentry = self.active[cluster]
        if vd is not None and dentry in vd.dtab:
            pruned = Dtab(d for d in vd.dtab if d != dentry)
            await self._cas(pruned, vd.version)
        # the dentry may already be gone (operator removed it); either
        # way this reactor no longer owns an override for the cluster
        del self.active[cluster]
        if self._reverted is not None:
            self._reverted.incr()
        log.warning("control override REVERTED: %s (ns=%s, level=%.3f)",
                    cluster, self._ns, level)
        self._span("revert", cluster, self._failover.get(cluster, ""),
                   level)

    def _span(self, action: str, cluster: str, target: str,
              level: float) -> None:
        if self._tracer is None:
            return
        from linkerd_tpu_torch.router.tracing import TraceId
        tid = TraceId.mk_root(True)
        self._tracer.record({
            "traceId": f"{tid.trace_id:032x}",
            "id": f"{tid.span_id:016x}",
            "parentId": None,
            "kind": "PRODUCER",
            "name": "control.override",
            "timestamp": int(time.time() * 1e6),
            "duration": 1,
            "localEndpoint": {"serviceName": "control"},
            "tags": {
                "control.action": action,
                "control.cluster": cluster,
                "control.target": target,
                "control.namespace": self._ns,
                "control.level": f"{level:.3f}",
                "control.verified": str(self._verify).lower(),
            },
        })

    # -- observability -----------------------------------------------------
    def status(self) -> dict:
        out = {
            "namespace": self._ns,
            "failover": dict(self._failover),
            "levels": {c: round(v, 4)
                       for c, v in self.cluster_levels().items()},
            "governor": self._governor.snapshot(),
            "active_overrides": {c: d.show
                                 for c, d in self.active.items()},
            "rejected": dict(self.rejected),
        }
        if self._region_failover:
            out["region_failover"] = {c: dict(m) for c, m
                                      in self._region_failover.items()}
        if self._book is not None:
            out["partitioned"] = self._partitioned
            out["booked_overrides"] = {c: d.show
                                       for c, d in self.booked.items()}
            out["last_heal_reconcile_ms"] = self.last_heal_reconcile_ms
        if self._fleet is not None:
            local = self.cluster_levels()
            out["fleet_mode"] = True
            out["fleet_levels"] = {
                c: round(v, 4) for c, v in self.actuation_levels().items()}
            out["fleet_sick_votes"] = {
                c: self._fleet.sick_votes(c, local.get(c, 0.0),
                                          self._governor.enter)
                for c in self._failover}
        return out

    async def aclose(self) -> None:
        await self._client.aclose()
