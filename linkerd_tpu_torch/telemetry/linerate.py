"""Line-rate score dispatch: counterpart of ``RingDispatcher`` in
``linkerd_tpu/telemetry/linerate.py``, and of its native engine feed
(``NativeFeatureRing``, ``RouteTemporal``, ``NativeFeaturizer``), which
carries the engines' per-request rows into the micro-batcher; and
``TieredScorer``, the in-process scorer with the scorer sidecar as its
fallback tier (a copy of the reference's class).

``RingDispatcher`` keeps, per batch bucket, two persistent staging
slots in pinned host memory. A dispatch copies the batch into a free
slot and, on one side CUDA stream, issues the non-blocking
host-to-device copy and the score step, copies the scores back into the
slot's pinned output buffer, and records the slot's event. A single
drainer thread waits on each event in turn, slices the live rows off,
and resolves the caller's asyncio future, so the event loop never waits
on the device and batch N's copy overlaps batch N-1's kernel. A slot is
released only after its event, which is also when the pinned staging
memory is safe to refill.

Device memory that a step reads must be allocated on ``stream`` (see
``device_context``): the caching allocator then reuses a freed block
only for later work on the same stream, so tensors dropped while a
batch is in flight (a hot-swapped model) stay valid until it is done.
"""

from __future__ import annotations

import asyncio
import atexit
import contextlib
import logging
import queue
import threading
import weakref
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

log = logging.getLogger(__name__)

# Every live dispatcher's drainer is woken and joined before the
# interpreter finalizes: a daemon thread woken during finalization dies
# inside native frames and can abort the process after a clean run.
_LIVE_DISPATCHERS: "weakref.WeakSet" = weakref.WeakSet()


def _shutdown_drainers() -> None:
    for d in list(_LIVE_DISPATCHERS):
        d._queue.put(None)
        t = d._thread
        if t is not None and t.is_alive():
            t.join(timeout=2.0)


atexit.register(_shutdown_drainers)


class _Slot:
    """One staging slot of a bucket's ring: pinned input rows, pinned
    output scores, and the event that marks the batch done. ``busy``
    from dispatch until the drainer has read the scores back; touched
    under the dispatcher lock."""

    __slots__ = ("staging", "out", "event", "busy", "bucket")

    def __init__(self, bucket: int, in_dim: int, device: torch.device):
        cuda = device.type == "cuda"
        self.staging = torch.empty((bucket, in_dim), dtype=torch.float32,
                                   pin_memory=cuda)
        self.out = torch.empty(bucket, dtype=torch.float32, pin_memory=cuda)
        self.event = torch.cuda.Event() if cuda else None
        self.bucket = bucket
        self.busy = False


Step = Callable[[torch.Tensor], torch.Tensor]

DEPTH = 2  # slots per bucket: batches of one bucket in flight at once


class RingDispatcher:
    """Double-buffered score dispatch onto ``device``.

    ``dispatch(x, step)`` copies ``x`` (float32 [n, D]) into a staging
    slot of the batch's bucket and calls ``step(rows)`` with the slot's
    first ``n`` rows, a host tensor; ``step`` moves them to the device
    and returns the [n] scores there. The awaitable resolves to a
    float32 numpy [n] once the drainer has read them back. ``DEPTH``
    slots per bucket bound the batches in flight; a dispatch that finds
    none free waits for one of its own bucket.

    On a CPU device the same ring runs without stream or events: the
    step's result is ready when it returns.
    """

    def __init__(self, in_dim: int, bucket_fn: Callable[[int], int],
                 device: torch.device):
        self.in_dim = in_dim
        self.device = torch.device(device)
        self._bucket_fn = bucket_fn
        self.stream = (torch.cuda.Stream(self.device)
                       if self.device.type == "cuda" else None)
        self._slots: Dict[int, List[_Slot]] = {}
        self._waiters: List[Tuple[int, asyncio.AbstractEventLoop,
                                  asyncio.Future]] = []
        self._lock = threading.Lock()
        self._queue: "queue.SimpleQueue" = queue.SimpleQueue()
        self._thread: Optional[threading.Thread] = None
        self._closed = False
        # a collected dispatcher must not leak its drainer
        self._finalizer = weakref.finalize(self, self._queue.put, None)
        _LIVE_DISPATCHERS.add(self)

    def device_context(self):
        """Context in which to allocate tensors that steps read: the
        dispatch stream on CUDA (see the module docstring)."""
        if self.stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream)

    # -- drainer ----------------------------------------------------------
    def _ensure_thread(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._drain_loop, name="l5d-score-drainer",
                daemon=True)
            self._thread.start()

    def _drain_loop(self) -> None:
        while True:
            item = self._queue.get()
            if item is None:
                return
            n, loop, fut, slot = item
            out: Optional[np.ndarray] = None
            err: Optional[BaseException] = None
            try:
                # the only wait on the device, on this thread
                if slot.event is not None:
                    slot.event.synchronize()
                out = slot.out[:n].numpy().copy()
            except Exception as e:  # noqa: BLE001 — surfaced via fut
                err = e
            self._release(slot)
            try:
                if err is None:
                    loop.call_soon_threadsafe(self._resolve, fut, out)
                else:
                    loop.call_soon_threadsafe(self._reject, fut, err)
            except RuntimeError:
                pass  # loop already closed; the result is moot

    @staticmethod
    def _resolve(fut: asyncio.Future, out: np.ndarray) -> None:
        if not fut.done():
            fut.set_result(out)

    @staticmethod
    def _reject(fut: asyncio.Future, err: BaseException) -> None:
        if not fut.done():
            fut.set_exception(err)

    # -- slot ring --------------------------------------------------------
    def _acquire_nowait(self, bucket: int) -> Optional[_Slot]:
        slots = self._slots.get(bucket)
        if slots is None:
            slots = [_Slot(bucket, self.in_dim, self.device)
                     for _ in range(DEPTH)]
            self._slots[bucket] = slots
        for s in slots:
            if not s.busy:
                s.busy = True
                return s
        return None

    async def _acquire(self, bucket: int) -> _Slot:
        loop = asyncio.get_running_loop()
        while True:
            waiter: Optional[asyncio.Future] = None
            with self._lock:
                slot = self._acquire_nowait(bucket)
                if slot is None:
                    waiter = loop.create_future()
                    self._waiters.append((bucket, loop, waiter))
            if slot is not None:
                return slot
            await waiter  # backpressure: every slot of the bucket in flight

    def _release(self, slot: _Slot) -> None:
        """Free ``slot`` and wake the oldest waiter for the same bucket
        (a freed bucket-A slot cannot admit a bucket-B dispatch)."""
        wake: List[Tuple[asyncio.AbstractEventLoop, asyncio.Future]] = []
        with self._lock:
            slot.busy = False
            still = []
            for bucket, loop, fut in self._waiters:
                if fut.done():
                    continue
                if bucket == slot.bucket and not wake:
                    wake.append((loop, fut))
                else:
                    still.append((bucket, loop, fut))
            self._waiters = still
        for loop, fut in wake:
            try:
                loop.call_soon_threadsafe(self._resolve_waiter, fut)
            except RuntimeError:
                pass

    @staticmethod
    def _resolve_waiter(fut: asyncio.Future) -> None:
        if not fut.done():
            fut.set_result(None)

    # -- dispatch ---------------------------------------------------------
    def _launch(self, slot: _Slot, n: int, step: Step) -> None:
        with self.device_context():
            result = step(slot.staging[:n])
            slot.out[:n].copy_(result, non_blocking=True)
            if slot.event is not None:
                slot.event.record(self.stream)

    async def dispatch(self, x: np.ndarray, step: Step) -> np.ndarray:
        """Score one batch through the ring; returns float32 [n]."""
        if self._closed:
            raise RuntimeError("dispatcher closed")
        n = len(x)
        loop = asyncio.get_running_loop()
        bucket = int(self._bucket_fn(n))
        slot = await self._acquire(bucket)
        if self._closed:  # close() may have raced the acquire
            self._release(slot)
            raise RuntimeError("dispatcher closed")
        try:
            slot.staging[:n].numpy()[...] = x
            self._launch(slot, n, step)
        except BaseException:
            self._release(slot)
            raise
        fut = loop.create_future()
        self._ensure_thread()
        self._queue.put((n, loop, fut, slot))
        return await fut

    def close(self) -> None:
        self._closed = True
        self._finalizer()  # idempotent: enqueues the drainer sentinel
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout=5.0)
        # a dispatch that raced close() past the sentinel would wait
        # forever on an item the drainer never saw: reject it instead
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if item is None:
                continue
            _n, loop, fut, slot = item
            self._release(slot)
            try:
                loop.call_soon_threadsafe(
                    self._reject, fut, RuntimeError("dispatcher closed"))
            except RuntimeError:
                pass


# -- native engine rows ---------------------------------------------------

# engine row: route_id, lat_ms, status, req_b, rsp_b, ts, score,
# scored, tenant, kind, stream, frame_seq. score/scored are the
# in-data-plane scorer's output (native/scorer.h): scored == 1.0 rows
# arrive pre-scored from the engine; 0.0 rows (no weight blob
# published, route hash not pushed yet, nativeTier: off) fall back to
# the device tier in the micro-batcher. tenant is the 24-bit-folded
# FNV-1a tenant hash (0 = no tenant) the engine extracted per its
# tenantIdentifier config. kind (native/stream_track.h row kinds) is
# 0 for request rows, 1 for h2 stream samples, 2 for tunnel samples;
# kind > 0 rows carry the 24-bit stream-lifetime key in `stream` and
# the frame count at sample time in `frame_seq`, and repeat per
# stream — the training path must keep them out of request-shaped
# aggregation (the micro-batcher routes them to the stream sentinel).
NATIVE_ROW_WIDTH = 12
NATIVE_COL_SCORE = 6
NATIVE_COL_SCORED = 7
NATIVE_COL_TENANT = 8
NATIVE_COL_KIND = 9
NATIVE_COL_STREAM = 10
NATIVE_COL_SEQ = 11

# row kinds (mirror native/stream_track.h)
NATIVE_KIND_REQUEST = 0.0
NATIVE_KIND_STREAM = 1.0
NATIVE_KIND_TUNNEL = 2.0


class NativeFeatureRing:
    """Preallocated single-producer single-consumer ring of raw native
    feature rows (float32 [capacity, NATIVE_ROW_WIDTH], the engines'
    FeatureRow layout incl. the in-data-plane score/scored columns).
    Both sides run on the event loop thread; views are valid
    until the holder's next await (no interleaved producer).

    The producer (FastPathController) drains engine rows straight into
    ring memory via ``produce_views`` + ``commit`` — no per-row Python
    objects on the C++→Python seam. Under backpressure (consumer
    behind), overflow rows are dropped-and-counted, never written over
    unconsumed rows: wraparound can lose NEW rows, not corrupt old
    ones.
    """

    def __init__(self, capacity: int = 65536, width: int = NATIVE_ROW_WIDTH):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.buf = np.zeros((capacity, width), np.float32)
        self.capacity = capacity
        self.head = 0   # next row to consume
        self.count = 0  # readable rows
        self.dropped = 0

    def __len__(self) -> int:
        return self.count

    @property
    def free(self) -> int:
        return self.capacity - self.count

    def produce_views(self, max_rows: Optional[int] = None
                      ) -> List[np.ndarray]:
        """Up to two contiguous writable views (tail, then wrapped
        head). Fill in order, then ``commit(rows_written)``."""
        avail = self.free if max_rows is None else min(self.free, max_rows)
        if avail <= 0:
            return []
        tail = (self.head + self.count) % self.capacity
        first = min(avail, self.capacity - tail)
        views = [self.buf[tail:tail + first]]
        if avail > first:
            views.append(self.buf[:avail - first])
        return views

    def commit(self, rows: int) -> None:
        if rows < 0 or rows > self.free:
            raise ValueError(f"commit({rows}) with free={self.free}")
        self.count += rows

    def drop(self, rows: int) -> None:
        """Record ``rows`` overflow rows dropped at the producer."""
        self.dropped += rows

    def consume(self, max_rows: int) -> np.ndarray:
        """Zero-copy view of up to ``max_rows`` oldest rows (one
        contiguous chunk; call again for a wrapped remainder). The view
        is valid until the caller's next await."""
        n = min(self.count, max_rows, self.capacity - self.head)
        if n <= 0:
            return self.buf[:0]
        view = self.buf[self.head:self.head + n]
        self.head = (self.head + n) % self.capacity
        self.count -= n
        return view


class RouteTemporal:
    """Vectorized per-route latency-drift context for native feature
    blocks: the block-granular analogue of the one temporal signal that
    survived feature ablation (``models.features`` layout note: drift
    is column 32; the error-rate/rate-delta columns are deliberately
    zero). ``DstTemporal``'s per-row ``observe`` is exactly the
    per-row Python churn the native seam must avoid, so each consumed
    block updates one robust EWMA per route from the block's group
    mean; per-row drift is computed against the EWMA *before* the
    update, vectorized."""

    def __init__(self, lat_alpha: float = 0.05, dev_clip: float = 3.0,
                 dev_alpha: float = 0.05, max_routes: int = 4096):
        self._lat_alpha = lat_alpha
        self._dev_clip = dev_clip
        self._dev_alpha = dev_alpha
        self._max_routes = max_routes
        self._ewma: Dict[int, float] = {}
        self._dev: Dict[int, float] = {}

    def drift_block(self, route_ids: np.ndarray,
                    lat_ms: np.ndarray) -> np.ndarray:
        """-> per-row latency drift (ms) against state BEFORE this
        block updates it."""
        drift = np.zeros(len(route_ids), np.float32)
        uniq, inv = np.unique(route_ids, return_inverse=True)
        for j, rid in enumerate(uniq):
            rid = int(rid)
            rows = inv == j
            prev = self._ewma.get(rid)
            if prev is not None:
                drift[rows] = lat_ms[rows] - prev
            mean = float(lat_ms[rows].mean())
            if prev is None:
                if len(self._ewma) >= self._max_routes:
                    continue  # bounded cardinality: overflow routes get 0s
                self._ewma[rid] = mean
                self._dev[rid] = max(abs(mean) * 0.1, 0.25)
            else:
                dev = self._dev.get(rid, 0.25)
                lim = self._dev_clip * max(dev, 0.25)
                inc = min(max(mean - prev, -lim), lim)
                self._ewma[rid] = prev + self._lat_alpha * inc
                self._dev[rid] = dev + self._dev_alpha * (
                    min(abs(mean - prev), lim) - dev)
        return drift


class NativeFeaturizer:
    """Vectorized native-row → model-feature encoding. One numpy pass
    per block; the only per-ROUTE (not per-row) Python work is the
    cached dst-path hash lookup."""

    def __init__(self, resolver: Optional[Callable[[int], str]] = None):
        from linkerd_tpu_torch.models.features import FEATURE_DIM
        self.dim = FEATURE_DIM
        self.resolver = resolver
        self.temporal = RouteTemporal()
        self._hash_cache: Dict[int, Tuple[int, float, str]] = {}

    def _route_info(self, rid: int) -> Tuple[int, float, str]:
        from linkerd_tpu_torch.models.features import path_hash_cols
        info = self._hash_cache.get(rid)
        if info is None:
            dst = self.resolver(rid) if self.resolver is not None else None
            cacheable = dst is not None
            if dst is None:
                # resolver doesn't know this route yet (the id→host map
                # rides the 1s stats loop): attribute to a placeholder
                # but do NOT cache it — the next block re-resolves, so
                # the board key self-corrects once the mapping lands
                dst = f"/fp-{rid}"
            col, sign = path_hash_cols(dst)
            info = (col, sign, dst)
            if cacheable and len(self._hash_cache) < 65536:
                self._hash_cache[rid] = info
        return info

    def encode_block(self, block: np.ndarray
                     ) -> Tuple[np.ndarray, np.ndarray, List[str]]:
        """float32 [k, 6] engine rows -> (x [k, FEATURE_DIM], route
        index per row, dst path per unique route index)."""
        from linkerd_tpu_torch.models.features import STATUS_ONEHOT_OFF
        k = len(block)
        x = np.zeros((k, self.dim), np.float32)
        if k == 0:
            return x, np.zeros(0, np.int64), []
        rid = block[:, 0].astype(np.int64)
        lat = np.maximum(block[:, 1], 0.0)
        status = block[:, 2].astype(np.int64)
        x[:, 0] = np.log1p(lat)
        sc = status // 100
        ok = (sc >= 1) & (sc <= 5)
        x[np.flatnonzero(ok), STATUS_ONEHOT_OFF + sc[ok] - 1] = 1.0
        x[:, 8] = np.log1p(np.maximum(block[:, 3], 0.0))
        x[:, 9] = np.log1p(np.maximum(block[:, 4], 0.0))
        x[:, 10] = np.log1p(1.0)  # engine rows carry no concurrency
        x[:, 31] = 1.0
        uniq, inv = np.unique(rid, return_inverse=True)
        dsts: List[str] = []
        for j, r in enumerate(uniq):
            col, sign, dst = self._route_info(int(r))
            dsts.append(dst)
            x[inv == j, col] += sign
        drift = self.temporal.drift_block(rid, lat.astype(np.float32))
        x[:, 32] = np.sign(drift) * np.log1p(np.abs(drift))
        return x, inv, dsts


# -- tiered scorer ------------------------------------------------------------


class TieredScorer:
    """In-process primary with the gRPC sidecar as the fallback tier.

    The primary (InProcessScorer) serves every batch at line rate; its
    own breaker opens after consecutive failures so a sick local device
    doesn't add a failed attempt to every batch. While the primary is
    open, batches route to the fallback (a ResilientScorer-wrapped
    sidecar, with its own breaker + per-call deadline). Both tiers
    failing surfaces the fallback's error, which the telemeter maps to
    degraded mode as before.

    Lifecycle hooks (snapshot/restore/swap/warmup) bind to the primary:
    the in-process model is the one the lifecycle manager owns.
    """

    def __init__(self, primary, fallback, breaker=None):
        from linkerd_tpu_torch.telemetry.resilience import CircuitBreaker
        self.primary = primary
        self.fallback = fallback
        self.primary_breaker = breaker or CircuitBreaker(
            failures=3, min_backoff_s=1.0, max_backoff_s=30.0)
        self.primary_calls = 0
        self.fallback_calls = 0

    # the telemeter reads/steers these on whatever scorer it holds
    @property
    def breaker(self):
        return getattr(self.fallback, "breaker", None)

    @property
    def last_timing(self):
        return getattr(self.primary, "last_timing", None)

    @property
    def timing_enabled(self) -> bool:
        return bool(getattr(self.primary, "timing_enabled", False))

    @timing_enabled.setter
    def timing_enabled(self, v: bool) -> None:
        if hasattr(self.primary, "timing_enabled"):
            self.primary.timing_enabled = v

    @property
    def timing_sample_every(self) -> int:
        return int(getattr(self.primary, "timing_sample_every", 1))

    @timing_sample_every.setter
    def timing_sample_every(self, v: int) -> None:
        if hasattr(self.primary, "timing_sample_every"):
            self.primary.timing_sample_every = v

    @property
    def _step(self):
        return getattr(self.primary, "_step", None)

    async def _tiered(self, what: str, primary_call, fallback_call):
        admitted, probe = self.primary_breaker.acquire()
        if admitted:
            try:
                out = await primary_call()
            except asyncio.CancelledError:
                self.primary_breaker.on_cancel(probe)
                raise
            except Exception as e:  # noqa: BLE001 — tier boundary: any
                # primary failure demotes this call to the fallback tier
                self.primary_breaker.on_failure(probe)
                log.warning("in-process scorer %s failed; using fallback "
                            "tier: %r", what, e)
            else:
                self.primary_breaker.on_success(probe)
                self.primary_calls += 1
                return out
        self.fallback_calls += 1
        return await fallback_call()

    async def score(self, x: np.ndarray) -> np.ndarray:
        return await self._tiered(
            "score", lambda: self.primary.score(x),
            lambda: self.fallback.score(x))

    async def fit(self, x: np.ndarray, labels: np.ndarray,
                  mask: np.ndarray) -> float:
        """Training binds to the PRIMARY only — it is the model the
        lifecycle manager snapshots/promotes. Routing fit() to the
        fallback would silently train the sidecar's remote model,
        which no checkpoint ever sees and which would diverge from the
        primary for the rest of the outage. While the primary breaker
        is open, training is skipped (the telemeter logs and counts a
        skipped fit; scoring continues on the fallback)."""
        from linkerd_tpu_torch.telemetry.resilience import ScorerUnavailable
        admitted, probe = self.primary_breaker.acquire()
        if not admitted:
            raise ScorerUnavailable(
                "fit skipped: in-process primary breaker open "
                "(training never routes to the fallback tier)")
        try:
            out = await self.primary.fit(x, labels, mask)
        except asyncio.CancelledError:
            self.primary_breaker.on_cancel(probe)
            raise
        except Exception:
            self.primary_breaker.on_failure(probe)
            raise
        self.primary_breaker.on_success(probe)
        self.primary_calls += 1
        return out

    def snapshot(self):
        return self.primary.snapshot()

    def restore(self, snap) -> None:
        self.primary.restore(snap)

    def swap(self, snap):
        return self.primary.swap(snap)

    async def warmup(self, rows: int = 4) -> None:
        warm = getattr(self.primary, "warmup", None)
        if warm is not None:
            await warm(rows)

    def tier_state(self) -> dict:
        return {
            "primary": type(self.primary).__name__,
            "primary_breaker": self.primary_breaker.state,
            "primary_calls": self.primary_calls,
            "fallback_calls": self.fallback_calls,
        }

    def close(self) -> None:
        self.primary.close()
        self.fallback.close()
