"""MetricsTree — the concurrent metric registry: a copy of
``linkerd_tpu/telemetry/metrics.py``.

Reference parity: telemetry/core/.../MetricsTree.scala:9-122 (tree of scopes
with Counter/Gauge/Stat leaves, CAS registration, prune()) and the
BucketedHistogram (com/twitter/finagle/stats/buoyant/BucketedHistogram.scala).

Scope convention is the reference's ``rt/<router>/{server,service/<path>,
client/<id>}/...`` — the Prometheus exporter's label rewriting depends on it
(PrometheusTelemeter.scala:62-80).

Python build notes: leaf mutation is GIL-atomic (+= on int is not atomic
across threads in theory, so counters use an internal lock only on the slow
path — in practice the asyncio data plane mutates from one thread and the
scorer thread reads snapshots).
"""

from __future__ import annotations

import bisect
import math
import threading
import time
from contextlib import contextmanager
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple, Union


class Counter:
    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0

    def incr(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    """A gauge: either a set value or a zero-arg callable sampled on read."""

    __slots__ = ("_fn", "_value")

    def __init__(self, fn: Optional[Callable[[], float]] = None) -> None:
        self._fn = fn
        self._value = 0.0

    def set(self, v: float) -> None:
        self._fn = None
        self._value = float(v)

    @property
    def value(self) -> float:
        return float(self._fn()) if self._fn is not None else self._value


class Stat:
    """A histogram stat with power-of-two-ish bucketing.

    Bucket boundaries grow geometrically (~10% steps like the reference's
    BucketedHistogram error bound), giving bounded memory and cheap
    percentile snapshots.
    """

    __slots__ = ("_limits", "_counts", "count", "sum", "min", "max", "_lock")

    _SHARED_LIMITS: Optional[List[float]] = None

    @classmethod
    def _limits_shared(cls) -> List[float]:
        if cls._SHARED_LIMITS is None:
            # ~10% geometric buckets from 10us (in ms units) to 1e9 —
            # sub-ms resolution matters for a proxy with sub-1ms p99
            # targets (BASELINE.md).
            limits = [0.0]
            v = 0.01
            while v < 1e9:
                limits.append(v)
                v *= 1.1
            cls._SHARED_LIMITS = limits
        return cls._SHARED_LIMITS

    def __init__(self) -> None:
        self._limits = self._limits_shared()
        self._counts = [0] * len(self._limits)
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._lock = threading.Lock()

    def add(self, v: float) -> None:
        with self._lock:
            idx = bisect.bisect_right(self._limits, v) - 1
            if idx < 0:
                idx = 0
            self._counts[idx] += 1
            self.count += 1
            self.sum += v
            if v < self.min:
                self.min = v
            if v > self.max:
                self.max = v

    def percentile(self, q: float) -> float:
        """Approximate q-quantile (q in [0,1]) from bucket midpoints."""
        with self._lock:
            if self.count == 0:
                return 0.0
            target = max(1, math.ceil(q * self.count))
            seen = 0
            for i, c in enumerate(self._counts):
                seen += c
                if seen >= target:
                    lo = self._limits[i]
                    hi = self._limits[i + 1] if i + 1 < len(self._limits) else lo
                    return (lo + hi) / 2.0
            return self.max

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            if self.count == 0:
                return {"count": 0}
        return {
            "count": self.count,
            "sum": self.sum,
            "avg": self.sum / self.count,
            "min": self.min,
            "max": self.max,
            "p50": self.percentile(0.50),
            "p90": self.percentile(0.90),
            "p95": self.percentile(0.95),
            "p99": self.percentile(0.99),
            "p999": self.percentile(0.999),
        }


Metric = Union[Counter, Gauge, Stat]


@contextmanager
def observed(node: "MetricsTree"):
    """The standard op-instrumentation triple around a block:
    ``requests`` counter on entry, ``failures`` counter when the block
    raises, ``latency_ms`` stat always. One definition so every
    instrumented surface (namerd store ops, iface methods) exports the
    same family shape."""
    node.counter("requests").incr()
    t0 = time.monotonic()
    try:
        yield
    except BaseException:
        node.counter("failures").incr()
        raise
    finally:
        node.stat("latency_ms").add((time.monotonic() - t0) * 1e3)


class MetricsTree:
    """A tree of scopes; each node may hold one metric leaf + children."""

    __slots__ = ("_children", "_metric", "_lock")

    def __init__(self) -> None:
        self._children: Dict[str, "MetricsTree"] = {}
        self._metric: Optional[Metric] = None
        self._lock = threading.Lock()

    # -- navigation -------------------------------------------------------
    def scope(self, *names: str) -> "MetricsTree":
        node = self
        for name in names:
            nxt = node._children.get(name)
            if nxt is None:
                with node._lock:
                    nxt = node._children.setdefault(name, MetricsTree())
            node = nxt
        return node

    # -- leaf registration (idempotent; type conflicts raise) -------------
    def _mk(self, cls, *args) -> Metric:
        m = self._metric
        if m is None:
            with self._lock:
                if self._metric is None:
                    self._metric = cls(*args)
                m = self._metric
        if not isinstance(m, cls):
            raise ValueError(
                f"metric type conflict: wanted {cls.__name__}, "
                f"have {type(m).__name__}")
        return m

    def counter(self, *names: str) -> Counter:
        return self.scope(*names)._mk(Counter)

    def gauge(self, *names: str, fn: Optional[Callable[[], float]] = None) -> Gauge:
        g = self.scope(*names)._mk(Gauge)
        if fn is not None:
            g._fn = fn
        return g

    def stat(self, *names: str) -> Stat:
        return self.scope(*names)._mk(Stat)

    # -- maintenance ------------------------------------------------------
    def prune(self, *names: str) -> None:
        """Drop a subtree (ref: MetricsTree.prune, used by
        MetricsPruningModule when clients expire)."""
        if not names:
            return
        node = self
        for name in names[:-1]:
            node = node._children.get(name)  # type: ignore[assignment]
            if node is None:
                return
        with node._lock:
            node._children.pop(names[-1], None)

    # -- export -----------------------------------------------------------
    def walk(self, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Metric]]:
        if self._metric is not None:
            yield prefix, self._metric
        for name, child in sorted(self._children.items()):
            yield from child.walk(prefix + (name,))

    def flatten(self, sep: str = "/") -> Dict[str, Any]:
        """Flat name -> value mapping (stats expand to their snapshots),
        the shape /admin/metrics.json serves."""
        out: Dict[str, Any] = {}
        for names, metric in self.walk():
            key = sep.join(names)
            if isinstance(metric, Counter):
                out[key] = metric.value
            elif isinstance(metric, Gauge):
                out[key] = metric.value
            else:
                for k, v in metric.snapshot().items():
                    out[f"{key}{sep}{k}"] = v
        return out

    def tree_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        if isinstance(self._metric, Counter):
            out["counter"] = self._metric.value
        elif isinstance(self._metric, Gauge):
            out["gauge"] = self._metric.value
        elif isinstance(self._metric, Stat):
            out["stat"] = self._metric.snapshot()
        for name, child in sorted(self._children.items()):
            out[name] = child.tree_dict()
        return out
