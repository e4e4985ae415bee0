"""FleetDoc + FleetView: the fleet's shared anomaly state model.

Each linkerd instance periodically publishes one compact JSON document —
its per-cluster anomaly aggregates plus an (instance, generation, seq)
identity stamp — and ingests every peer's. The view answers the one
question the reactor asks: *how sick does the fleet, not this router,
believe a cluster is?* via the quorum order-statistic (`quorum_level`).

Safety invariants owned here:

- **staleness TTL** — a doc older than ``ttl_s`` (by the *receiver's*
  monotonic clock; cross-host wall clocks are never compared) carries no
  vote. A wedged router can neither shift the mesh nor hold it shifted.
- **generation fencing** — docs are ordered per instance by
  ``(generation, seq)``; an older incarnation's docs are discarded, and
  observing a NEWER generation under our own instance id marks this
  process superseded (``FleetView.superseded``) so a restarted-and-
  replaced reactor can never revert its successor's override.
- **quorum order-statistic** — the fleet-level anomaly level of a
  cluster is the K-th highest level reported by fresh instances (self
  included). It crosses the governor's ``enter`` threshold only when at
  least K instances independently report a level that high, and falls
  back below ``exit`` as soon as fewer than K still do — the hysteresis
  governor's split thresholds / streak / dwell keep working unchanged
  on top of it.
"""

from __future__ import annotations

import json
import re
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

# path-segment-safe (FleetDoc ids become dtab dentry prefixes) and
# bounded so a hostile doc cannot mint unbounded metric/namespace keys
_INSTANCE_RE = re.compile(r"^[A-Za-z0-9._-]{1,64}$")

# region ids are DNS-label-ish and deliberately narrower than instance
# ids: they become dtab path segments, metric keys, AND config map keys
# (control.regionFailover), so the grammar is shared by the doc layer,
# the region digest layer (fleet/regions.py), and l5dcheck
_REGION_RE = re.compile(r"^[a-z][a-z0-9-]{0,31}$")

# per-cluster aggregate fields a doc may carry (everything else is
# dropped on decode: the wire doc is peer input, not trusted state)
CLUSTER_FIELDS = ("level", "drift", "err_rate", "shed_rate")

# hard bound on clusters per doc: the fleet namespace carries digests,
# not the whole score board
MAX_CLUSTERS = 64

# hard bound on tracked peer instances: gossip bodies are peer input,
# and fabricated instance ids must buy eviction of already-stale
# entries (or rejection), never unbounded memory / payload growth
MAX_PEERS = 128


def valid_instance(instance: str) -> bool:
    return bool(_INSTANCE_RE.match(instance or ""))


def valid_region(region: str) -> bool:
    return bool(_REGION_RE.match(region or ""))


@dataclass
class FleetDoc:
    """One instance's published digest (see module docstring)."""

    instance: str
    generation: int
    seq: int
    # cluster path -> {level, drift, err_rate, shed_rate}
    clusters: Dict[str, Dict[str, float]] = field(default_factory=dict)
    # clusters whose failover override this instance believes active
    overrides: List[str] = field(default_factory=list)
    # wall-clock stamp, informational only (humans reading /fleet.json);
    # freshness decisions use the receiver's monotonic ingest instant
    ts: float = 0.0
    # region membership ("" = regionless flat fleet, the pre-region
    # wire format): in region mode only SAME-REGION docs vote in the
    # intra-region quorum; cross-region evidence rides region digests
    # (fleet/regions.py), never raw peer docs
    region: str = ""

    def ordering(self) -> tuple:
        return (self.generation, self.seq)

    def level_of(self, cluster: str) -> Optional[float]:
        agg = self.clusters.get(cluster)
        if agg is None:
            return None
        return float(agg.get("level", 0.0))

    def to_json(self) -> str:
        data = {
            "i": self.instance, "g": self.generation, "s": self.seq,
            "c": self.clusters, "o": self.overrides, "t": self.ts,
        }
        if self.region:
            data["r"] = self.region
        return json.dumps(data, separators=(",", ":"), sort_keys=True)

    @staticmethod
    def from_json(text: str) -> "FleetDoc":
        data = json.loads(text)
        if not isinstance(data, dict):
            raise ValueError("fleet doc must be a JSON object")
        instance = data.get("i")
        if not isinstance(instance, str) or not valid_instance(instance):
            raise ValueError(f"bad fleet doc instance id: {instance!r}")
        region = data.get("r") or ""
        if region and (not isinstance(region, str)
                       or not valid_region(region)):
            raise ValueError(f"bad fleet doc region id: {region!r}")
        clusters_in = data.get("c") or {}
        if not isinstance(clusters_in, dict):
            raise ValueError("fleet doc clusters must be a mapping")
        try:
            clusters: Dict[str, Dict[str, float]] = {}
            for cluster, agg in list(clusters_in.items())[:MAX_CLUSTERS]:
                if not isinstance(cluster, str) \
                        or not isinstance(agg, dict):
                    raise ValueError(
                        f"bad fleet doc cluster entry: {cluster!r}")
                clusters[cluster] = {
                    k: float(agg.get(k) or 0.0) for k in CLUSTER_FIELDS}
            overrides = data.get("o") or []
            if not isinstance(overrides, list):
                raise ValueError("fleet doc overrides must be a list")
            return FleetDoc(
                instance=instance,
                generation=int(data.get("g") or 0),
                seq=int(data.get("s") or 0),
                clusters=clusters,
                overrides=[str(o) for o in overrides[:MAX_CLUSTERS]],
                ts=float(data.get("t") or 0.0),
                region=region,
            )
        except TypeError as e:
            # null/list-valued numeric fields: ONE malformed-doc error
            # type, so no caller can forget a TypeError branch (the
            # dentry path once did, and a single poison dentry in the
            # namespace would have broken every instance's publish)
            raise ValueError(f"bad fleet doc field types: {e}") from e

    # -- dtab encoding ----------------------------------------------------
    # The namerd store holds Dtabs, not blobs, so the doc rides as one
    # dentry per instance: ``/fleet/<instance> => /d/<hex-of-json>``.
    # Hex keeps the payload inside the path-segment grammar of every
    # store backend and of the HTTP control API's dtab codec.

    PREFIX_SEG = "fleet"
    DATA_SEG = "d"

    def to_dentry_parts(self) -> tuple:
        payload = self.to_json().encode("utf-8").hex()
        return (f"/{self.PREFIX_SEG}/{self.instance}",
                f"/{self.DATA_SEG}/{payload}")

    @staticmethod
    def from_dentry_parts(prefix: str, dst: str) -> Optional["FleetDoc"]:
        """Decode one store dentry; None when it is not a fleet doc
        (operator dentries sharing the namespace are left alone)."""
        psegs = [s for s in prefix.split("/") if s]
        dsegs = [s for s in dst.split("/") if s]
        if (len(psegs) != 2 or psegs[0] != FleetDoc.PREFIX_SEG
                or len(dsegs) != 2 or dsegs[0] != FleetDoc.DATA_SEG):
            return None
        try:
            doc = FleetDoc.from_json(bytes.fromhex(dsegs[1]).decode("utf-8"))
        except (ValueError, UnicodeDecodeError):
            return None
        if doc.instance != psegs[1]:
            return None  # a doc must live under its own instance prefix
        return doc


@dataclass
class _Entry:
    doc: FleetDoc
    received_at: float  # receiver-side monotonic ingest instant


class FleetView:
    """Every known peer's latest doc + the quorum/staleness logic."""

    def __init__(self, instance: str, generation: int,
                 ttl_s: float = 5.0, region: str = ""):
        if not valid_instance(instance):
            raise ValueError(
                f"fleet instance id must match [A-Za-z0-9._-]{{1,64}}, "
                f"got {instance!r}")
        if region and not valid_region(region):
            raise ValueError(
                f"fleet region id must match [a-z][a-z0-9-]{{0,31}}, "
                f"got {region!r}")
        self.instance = instance
        self.generation = int(generation)
        self.ttl_s = ttl_s
        # own region ("" = flat fleet): quorum_level / sick_votes count
        # only same-region peers, so a WAN neighbour's doc that leaks
        # in through the shared namespace can neither satisfy nor
        # starve the INTRA-region quorum
        self.region = region
        # True once a NEWER generation under our own id was observed:
        # this process is a zombie and must never actuate again
        self.superseded = False
        self._peers: Dict[str, _Entry] = {}
        self.ingested = 0
        self.fenced = 0
        self.rejected = 0  # table full of FRESH peers: newcomer dropped

    # -- ingest (synchronous: atomic under asyncio) -----------------------
    def ingest(self, doc: FleetDoc, now: Optional[float] = None) -> bool:
        """Fold one received doc in; returns True when it advanced the
        view (False: our own echo, fenced as stale, or rejected by the
        bounded peer table)."""
        now = time.monotonic() if now is None else now
        if doc.instance == self.instance:
            if doc.generation > self.generation and not self.superseded:
                self.superseded = True
            return False  # own echoes never count as peer evidence
        cur = self._peers.get(doc.instance)
        if cur is not None and doc.ordering() <= cur.doc.ordering():
            if doc.ordering() < cur.doc.ordering():
                self.fenced += 1
            return False
        if cur is None and len(self._peers) >= MAX_PEERS:
            # a newcomer may only displace an already-STALE entry (its
            # vote is gone anyway); a full table of fresh peers rejects
            # the newcomer — hostile id churn must never evict a live
            # voter, and must never grow the table
            stale = [inst for inst, e in self._peers.items()
                     if now - e.received_at > self.ttl_s]
            if not stale:
                self.rejected += 1
                return False
            del self._peers[min(
                stale, key=lambda inst: self._peers[inst].received_at)]
        self._peers[doc.instance] = _Entry(doc, now)
        self.ingested += 1
        return True

    def forget(self, instance: str) -> None:
        self._peers.pop(instance, None)

    # -- queries ----------------------------------------------------------
    def fresh_docs(self, now: Optional[float] = None,
                   region: Optional[str] = None) -> List[FleetDoc]:
        """Fresh peer docs; ``region`` restricts to that region's docs
        (None = every region, the flat-fleet behavior)."""
        now = time.monotonic() if now is None else now
        return [e.doc for e in self._peers.values()
                if now - e.received_at <= self.ttl_s
                and (region is None or e.doc.region == region)]

    def all_docs(self) -> List[FleetDoc]:
        return [e.doc for e in self._peers.values()]

    def fresh_count(self, now: Optional[float] = None) -> int:
        return len(self.fresh_docs(now))

    def _voting_docs(self, now: Optional[float]) -> List[FleetDoc]:
        """The docs that may vote in OUR quorum: same-region only when
        this view is regional (cross-region evidence must ride region
        digests, which cannot fabricate instance-level votes)."""
        return self.fresh_docs(now, region=self.region or None)

    def quorum_level(self, cluster: str, local_level: float,
                     quorum: int, now: Optional[float] = None) -> float:
        """K-th highest level reported for ``cluster`` by fresh
        instances, self included (see module docstring). Fewer than K
        fresh reporters => 0.0 (a partial fleet can never trip)."""
        levels = [float(local_level)]
        for doc in self._voting_docs(now):
            lvl = doc.level_of(cluster)
            if lvl is not None:
                levels.append(lvl)
        if quorum <= 1:
            return max(levels)
        if len(levels) < quorum:
            return 0.0
        levels.sort(reverse=True)
        return levels[quorum - 1]

    def sick_votes(self, cluster: str, local_level: float,
                   threshold: float, now: Optional[float] = None) -> int:
        """How many fresh instances (self included) report the cluster
        at or above ``threshold`` — the /fleet.json-facing count."""
        votes = 1 if local_level >= threshold else 0
        for doc in self._voting_docs(now):
            lvl = doc.level_of(cluster)
            if lvl is not None and lvl >= threshold:
                votes += 1
        return votes

    def status(self, now: Optional[float] = None) -> dict:
        now = time.monotonic() if now is None else now
        return {
            "instance": self.instance,
            "region": self.region or None,
            "generation": self.generation,
            "superseded": self.superseded,
            "ttl_s": self.ttl_s,
            "ingested": self.ingested,
            "fenced": self.fenced,
            "rejected": self.rejected,
            "peers": {
                inst: {
                    "generation": e.doc.generation,
                    "seq": e.doc.seq,
                    "region": e.doc.region or None,
                    "age_s": round(now - e.received_at, 3),
                    "fresh": now - e.received_at <= self.ttl_s,
                    "clusters": {c: round(a.get("level", 0.0), 4)
                                 for c, a in e.doc.clusters.items()},
                    "overrides": list(e.doc.overrides),
                }
                for inst, e in sorted(self._peers.items())
            },
        }
