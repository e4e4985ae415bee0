"""``io.l5d.jaxAnomaly``, the in-process anomaly telemeter, and its
scorer: counterpart of ``linkerd_tpu/telemetry/anomaly.py``.

Data path (the recorder filter does O(1) Python work per request;
everything else is batched):

    request -> FeatureRecorder filter -> ring buffer (deque)
            -> micro-batcher (drain + featurize -> float32[B, D])
            -> InProcessScorer.score -> RingDispatcher -> fused kernel
            -> ScoreBoard (per-dst EWMA scores, Var + metrics gauges)
            -> AnomalyFailureAccrualPolicy / admin handlers

Scoring runs through ``linerate.RingDispatcher`` and the fused kernel
(``ops.scoring.best_scorer``). Online training (``fit``) takes
``fit_steps`` steps of autograd and ``torch.optim.Adam`` on float32
master weights held on the device, and snapshots carry the Adam state
in the layout of ``optax.adam``'s, so training continues across the
two packages.

Native engine rows (a ``fastPath: true`` router's) arrive in
``native_ring``, drained by ``router.fastpath.FastPathController`` and
featurized a block at a time by ``linerate.NativeFeaturizer``; rows the
engine already scored in its data plane (``nativeTier: primary``) skip
the device and fold straight into the board. A ``control:`` block builds
the reactive control loop (``control/``) over the board; its ``run()``
task rides beside the drain loop. A ``sidecarAddress`` adds the scorer
sidecar (``telemetry/sidecar.py``) behind a deadline and a breaker
(``telemetry/resilience.py``), one replica or a ``ScorerReplicaPool``
(``fleet/scorer_pool.py``): as the fallback tier of the in-process
scorer (``linerate.TieredScorer``), or with ``sidecarTier: primary`` as
the one scorer, when this process builds nothing on a device.
"""

from __future__ import annotations

import asyncio
import collections
import contextlib
import logging
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from linkerd_tpu_torch import DeviceLike, resolve_device
from linkerd_tpu_torch.config import ConfigError, register
from linkerd_tpu_torch.control.loop import ControlConfig
from linkerd_tpu_torch.core.tasks import monitor
from linkerd_tpu_torch.core.var import Var
from linkerd_tpu_torch.distill import DistillConfig
from linkerd_tpu_torch.lifecycle import LifecycleConfig
from linkerd_tpu_torch.lifecycle.export import blob_meta, export_weight_blob
from linkerd_tpu_torch.lifecycle.store import ModelSnapshot, _cfg_to_dict
from linkerd_tpu_torch.models.anomaly import (
    AnomalyModelConfig, Params, init_params, layer_dims, loss_fn,
    normalize_features,
)
from linkerd_tpu_torch.models.convert import (
    params_from_numpy, params_to_numpy,
)
from linkerd_tpu_torch.ops.scoring import (
    KernelParams, best_scorer, pack_params,
)
from linkerd_tpu_torch.models.features import (
    DstTemporal, FeatureVector, featurize_batch,
)
from linkerd_tpu_torch.protocol.http.message import Request, Response
from linkerd_tpu_torch.router.failure_accrual import (
    FailureAccrualPolicy, _default_backoffs,
)
from linkerd_tpu_torch.router.service import Filter, Service
from linkerd_tpu_torch.router.tracing import TraceId
from linkerd_tpu_torch.telemetry.linerate import (
    NATIVE_COL_SCORE, NATIVE_COL_SCORED, NativeFeatureRing,
    NativeFeaturizer, RingDispatcher,
)
from linkerd_tpu_torch.telemetry.metrics import MetricsTree
from linkerd_tpu_torch.telemetry.sidecar import bucket_rows
from linkerd_tpu_torch.telemetry.telemeter import Telemeter

log = logging.getLogger(__name__)


def optax_order(params: Params) -> List[Any]:
    """The leaves of a params tree in ``jax.tree_util`` order: groups
    sorted (``cls``, ``dec``, ``enc``), layers in order, ``b`` before
    ``w``. optax's moments flatten in this order."""
    return [layer[k] for g in sorted(params) for layer in params[g]
            for k in sorted(layer)]


def zero_adam_leaves(cfg: AnomalyModelConfig) -> List[np.ndarray]:
    """A fresh ``optax.adam`` state as its flattened leaves: ``count``
    (int32 scalar), then ``mu`` and ``nu`` shaped like the params, each
    in sorted-key order (``cls``, ``dec``, ``enc``; ``b`` before ``w``)."""
    shapes = []
    for group in sorted(layer_dims(cfg)):
        for d_in, d_out in layer_dims(cfg)[group]:
            shapes += [(d_out,), (d_in, d_out)]
    moments = [np.zeros(s, np.float32) for s in shapes]
    return [np.zeros((), np.int32)] + moments + [m.copy() for m in moments]


def adam_from_leaves(params: Params, opt_leaves: List[np.ndarray],
                     learning_rate: float) -> torch.optim.Adam:
    """``torch.optim.Adam`` over ``params`` (float32 leaves, made to
    require grad) holding the state that ``opt_leaves``, optax's
    flattened adam state, describes: ``count`` becomes each parameter's
    ``step``, the ``mu`` and ``nu`` leaves its ``exp_avg`` and
    ``exp_avg_sq``. Its update is optax's: ``lr * mu_hat /
    (sqrt(nu_hat) + eps)``."""
    leaves = optax_order(params)
    for t in leaves:
        t.requires_grad_(True)
    opt = torch.optim.Adam(leaves, lr=learning_rate, betas=(0.9, 0.999),
                           eps=1e-8)
    count = float(np.asarray(opt_leaves[0]))
    k = len(leaves)
    for i, t in enumerate(leaves):
        opt.state[t] = {
            "step": torch.tensor(count, dtype=torch.float32),
            "exp_avg": torch.tensor(
                np.asarray(opt_leaves[1 + i], np.float32), device=t.device),
            "exp_avg_sq": torch.tensor(
                np.asarray(opt_leaves[1 + k + i], np.float32),
                device=t.device),
        }
    return opt


def adam_to_leaves(params: Params,
                   opt: torch.optim.Adam) -> List[np.ndarray]:
    """The reverse of ``adam_from_leaves``: host copies of the state as
    optax's flattened leaves."""
    states = [opt.state[t] for t in optax_order(params)]
    return ([np.array(int(states[0]["step"]), np.int32)]
            + [s["exp_avg"].detach().cpu().numpy().copy() for s in states]
            + [s["exp_avg_sq"].detach().cpu().numpy().copy()
               for s in states])


def train_steps(params: Params, opt: torch.optim.Adam, x: torch.Tensor,
                labels: torch.Tensor, mask: torch.Tensor,
                cfg: AnomalyModelConfig, steps: int) -> torch.Tensor:
    """``steps`` Adam steps on ``loss_fn`` over normalized rows ``x``;
    returns each step's loss (taken before its update), on the device."""
    losses = []
    for _ in range(steps):
        opt.zero_grad()
        loss = loss_fn(params, x, labels, mask, cfg)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
    return torch.stack(losses)


class ScoreBoard:
    """Per-dst anomaly scores: EWMA-smoothed, observable, with a
    staleness TTL.

    The Var publishes {dst_path: score}; failure-accrual policies and the
    admin handler read it. Scores decay toward 0 when traffic stops, and
    — independently — go STALE when the scorer stops updating them (a
    degraded scorer path must not pin accrual policies to an old anomaly
    verdict): within ``ttl_s`` of the last update a score reads at full
    strength, then decays linearly to neutral (0) over one further
    ``ttl_s`` window. ``degraded`` is set by the telemeter while the
    scorer path is failing; anomaly-aware policies treat it as "no
    signal" and fall back to their reference behavior.
    """

    def __init__(self, alpha: float = 0.3, ttl_s: Optional[float] = 30.0):
        self.alpha = alpha
        self.ttl_s = ttl_s
        self.scores: Var[dict] = Var({})
        self.degraded = False
        self._updated: Dict[str, float] = {}
        # per-REPLICA scores keyed by endpoint hostport (the balancer
        # stamps req.ctx["endpoint"] at pick time); same EWMA +
        # staleness machinery as the per-dst board
        self._ep_scores: Dict[str, float] = {}
        self._ep_updated: Dict[str, float] = {}

    def update_batch(self, dsts: List[str], scores: np.ndarray,
                     endpoints: Optional[List[Optional[str]]] = None,
                     ) -> None:
        now = time.monotonic()
        cur = dict(self.scores.sample())
        per_dst: Dict[str, List[float]] = {}
        per_ep: Dict[str, List[float]] = {}
        for i, (dst, s) in enumerate(zip(dsts, scores)):
            per_dst.setdefault(dst, []).append(float(s))
            if endpoints is not None and i < len(endpoints) \
                    and endpoints[i]:
                per_ep.setdefault(endpoints[i], []).append(float(s))
        for dst, vals in per_dst.items():
            mean = sum(vals) / len(vals)
            prev = cur.get(dst, mean)
            cur[dst] = prev + self.alpha * (mean - prev)
            self._updated[dst] = now
        for ep, vals in per_ep.items():
            mean = sum(vals) / len(vals)
            prev = self._ep_scores.get(ep, mean)
            self._ep_scores[ep] = prev + self.alpha * (mean - prev)
            self._ep_updated[ep] = now
        # endpoint keys churn with the replica set (hostports change on
        # every deploy); fully-stale entries are dead replicas — prune,
        # or the maps grow without bound on a long-running linker
        if self.ttl_s is not None and per_ep:
            dead = [ep for ep, upd in self._ep_updated.items()
                    if now - upd > 2 * self.ttl_s]
            for ep in dead:
                self._ep_scores.pop(ep, None)
                self._ep_updated.pop(ep, None)
        self.scores.update(cur)

    def _decay(self, updated: Optional[float], now: float) -> float:
        if self.ttl_s is None:
            return 1.0
        if updated is None:
            return 1.0  # pre-TTL boards (tests seed Var directly)
        age = now - updated
        if age <= self.ttl_s:
            return 1.0
        return max(0.0, 1.0 - (age - self.ttl_s) / self.ttl_s)

    def _staleness_factor(self, dst: str, now: float) -> float:
        return self._decay(self._updated.get(dst), now)

    def score_of(self, dst: str) -> float:
        raw = self.scores.sample().get(dst, 0.0)
        return raw * self._staleness_factor(dst, time.monotonic())

    def effective_scores(self) -> Dict[str, float]:
        """{dst: staleness-decayed score} — the policy-facing view."""
        now = time.monotonic()
        return {dst: s * self._staleness_factor(dst, now)
                for dst, s in self.scores.sample().items()}

    def endpoint_score_of(self, hostport: str) -> float:
        """Per-replica effective score: staleness-decayed, and neutral
        while the scorer path is degraded (a dead scorer must not pin
        a replica's down-weight)."""
        if self.degraded:
            return 0.0
        raw = self._ep_scores.get(hostport, 0.0)
        return raw * self._decay(self._ep_updated.get(hostport),
                                 time.monotonic())

    def effective_endpoint_scores(self) -> Dict[str, float]:
        if self.degraded:
            return {ep: 0.0 for ep in self._ep_scores}
        now = time.monotonic()
        return {ep: s * self._decay(self._ep_updated.get(ep), now)
                for ep, s in self._ep_scores.items()}

    def anomaly_level(self) -> float:
        """Mesh-wide anomaly level: max effective score, 0 while the
        scorer path is degraded (no signal beats a stale signal)."""
        if self.degraded:
            return 0.0
        return max(self.effective_scores().values(), default=0.0)


class FeatureRecorder(Filter[Request, Response]):
    """Tap the request path: record one FeatureVector per request into the
    ring. O(1) appends; the deque drops oldest under overload (scoring is
    best-effort, requests are never blocked). ``on_record`` (the
    telemeter's enqueue hook) counts the request toward the scored
    fraction and wakes the line-rate micro-batcher."""

    def __init__(self, ring: Deque,
                 on_record: Optional[Callable[[], None]] = None):
        self.ring = ring
        self._on_record = on_record
        self._inflight = 0
        self._rps_window: Deque[float] = collections.deque(maxlen=512)
        self._temporal = DstTemporal()

    async def apply(self, req: Request, service: Service) -> Response:
        t0 = time.monotonic()
        self._inflight += 1
        exc: Optional[BaseException] = None
        rsp: Optional[Response] = None
        try:
            rsp = await service(req)
            return rsp
        except BaseException as e:
            exc = e
            raise
        finally:
            self._inflight -= 1
            now = time.monotonic()
            self._rps_window.append(now)
            latency_ms = (now - t0) * 1e3
            dst = req.ctx.get("dst")
            dst_path = dst.path.show if dst is not None else "/unidentified"
            rc = req.ctx.get("response_class")
            status = rsp.status if rsp is not None else 0
            is_err = exc is not None or status >= 500
            drift, err_rate, rate_delta, mesh_err = self._temporal.observe(
                dst_path, latency_ms, is_err, now)
            fv = FeatureVector(
                latency_ms=latency_ms,
                status=status,
                retries=int(req.ctx.get("retries", 0)),
                # h2 messages carry streams, not bodies; size 0 there
                request_bytes=len(getattr(req, "body", b"") or b""),
                response_bytes=(len(getattr(rsp, "body", b"") or b"")
                                if rsp is not None else 0),
                concurrency=self._inflight + 1,
                queue_ms=0.0,
                exception=exc is not None,
                retryable=bool(getattr(rc, "is_retryable", False)),
                dst_path=dst_path,
                dst_rps=self._rps(now),
                lat_drift_ms=drift,
                dst_err_rate=err_rate,
                rate_delta=rate_delta,
                mesh_err_rate=mesh_err,
            )
            # label for fault-injection evaluation rides along when present:
            # from local ctx, or from the harness's response header
            label = req.ctx.get("fault_label")
            if label is None and rsp is not None:
                hdr = rsp.headers.get("l5d-fault-label")
                if hdr is not None:
                    try:
                        label = float(hdr)
                    except ValueError:
                        label = None  # untrusted header; never fail a request
            # the request's trace context + enqueue instant ride along so
            # the micro-batcher can emit scorer spans as children of the
            # originating request (ring wait = the span's queue
            # annotation); the balancer-picked endpoint rides too so the
            # board can score per replica
            self.ring.append((fv, label, req.ctx.get("trace"), now,
                              req.ctx.get("endpoint")))
            if self._on_record is not None:
                self._on_record()

    def _rps(self, now: float) -> float:
        w = self._rps_window
        if len(w) < 2:
            return 0.0
        span = now - w[0]
        return len(w) / span if span > 0 else 0.0


class Scorer:
    """Scoring backends. ``score`` takes float32 [B, D] and returns
    float32 [B] anomaly scores in [0, 1]. ``snapshot``/``restore``/
    ``swap`` capture and hot-swap the full state without recreating the
    scorer.

    ``last_timing``: the decomposition of the most recent timed score
    call (``{queue_ms, transfer_ms, device_ms, bytes}``), which the
    telemeter's scorer spans carry; None until one ran."""

    last_timing: Optional[dict] = None

    async def score(self, x: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    async def fit(self, x: np.ndarray, labels: np.ndarray,
                  mask: np.ndarray) -> float:
        raise NotImplementedError

    def snapshot(self):
        raise NotImplementedError

    def restore(self, snap) -> None:
        raise NotImplementedError

    def swap(self, snap):
        """Restore ``snap`` and return the previous state's snapshot."""
        raise NotImplementedError

    def close(self) -> None:
        return


class InProcessScorer(Scorer):
    """Serves and trains the anomaly model on one device.

    The device holds the training state: float32 master weights and
    their Adam moments. The host holds the normalization stats and the
    step counter. Scoring reads one tuple, ``(packed model, mu, var)``:
    the masters cast to ``compute_dtype`` and packed for the kernel, and
    device mirrors of the stats. ``Adam.step`` updates the masters in
    place, so a fit or a restore packs a new model and swaps the tuple's
    reference; nothing writes into a tuple that a batch has captured.

    On CUDA, training runs on a stream of its own. A pack runs on the
    dispatch stream after it waits for the train stream, so every tensor
    a batch reads is allocated on the dispatch stream (see ``linerate``);
    the train stream then waits for the pack before the next optimizer
    step overwrites the masters it read. One lock serializes fit,
    restore and snapshot, so none of them sees the masters mid-step.
    """

    def __init__(self, seed: int = 0, learning_rate: float = 1e-3,
                 recon_weight: float = 0.7, fit_steps: int = 4,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.cfg = AnomalyModelConfig(recon_weight=recon_weight)
        self.learning_rate = learning_rate
        self.fit_steps = fit_steps
        self._norm_momentum = 0.2
        self._scorer = best_scorer(self.cfg)
        self._dispatcher = RingDispatcher(self.cfg.in_dim, bucket_rows,
                                          self.device)
        self._train_stream = (torch.cuda.Stream(self.device)
                              if self.device.type == "cuda" else None)
        self._lock = threading.Lock()
        # score-path timing decomposition, as the reference's: off by
        # default, since the split puts barriers between a batch's
        # copies and its kernel; with it on, 1 batch in
        # ``timing_sample_every`` takes ``_score_timed`` and the rest
        # ride the ring
        self.timing_enabled = False
        self.timing_sample_every = 1
        self._timing_i = 0
        self.last_timing: Optional[dict] = None
        self.timing_totals = {"calls": 0, "queue_ms": 0.0,
                              "transfer_ms": 0.0, "device_ms": 0.0,
                              "bytes": 0}
        self._install(ModelSnapshot(
            params=params_to_numpy(init_params(seed, self.cfg, "cpu")),
            opt_leaves=zero_adam_leaves(self.cfg),
            mu=np.zeros(self.cfg.in_dim, np.float32),
            var=np.ones(self.cfg.in_dim, np.float32),
            norm_initialized=False, step=0, cfg=self.cfg))

    def _train_context(self):
        """Context for work on the training state: the train stream on
        CUDA."""
        if self._train_stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._train_stream)

    def _install(self, snap: ModelSnapshot) -> None:
        """Make ``snap`` the training state (new masters and a new Adam
        holding its moments) and publish it. Called under the lock, or
        before the scorer is shared."""
        with self._train_context():
            masters = params_from_numpy(snap.params, self.device)
            opt = adam_from_leaves(masters, snap.opt_leaves,
                                   self.learning_rate)
        self._masters, self._opt = masters, opt
        self._mu = np.asarray(snap.mu, np.float32).copy()
        self._var = np.asarray(snap.var, np.float32).copy()
        self._norm_initialized = bool(snap.norm_initialized)
        self._step = int(snap.step)
        self._dev: Tuple[KernelParams, torch.Tensor, torch.Tensor] = (
            self._pack(), *self._norm_mirrors())

    def _pack(self) -> KernelParams:
        """The masters cast and packed for the kernel, as new tensors on
        the dispatch stream, ordered after the train stream's work."""
        ring = self._dispatcher.stream
        if ring is not None:
            ring.wait_stream(self._train_stream)
        dt = self.cfg.compute_dtype
        with self._dispatcher.device_context(), torch.no_grad():
            kp = pack_params({
                g: [{k: t.detach().to(dt, copy=True) for k, t in l.items()}
                    for l in layers]
                for g, layers in self._masters.items()}, self.cfg)
        if ring is not None:
            self._train_stream.wait_stream(ring)
        return kp

    def _norm_mirrors(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Device copies of the stats, allocated on the dispatch stream."""
        with self._dispatcher.device_context():
            return (torch.tensor(self._mu, device=self.device),
                    torch.tensor(self._var, device=self.device))

    def _place_norm(self) -> None:
        """Publish the current stats with the current packed model."""
        self._dev = (self._dev[0], *self._norm_mirrors())

    def _update_norm(self, x: np.ndarray, labels: np.ndarray,
                     mask: np.ndarray) -> None:
        # learn the "normal" distribution: exclude rows labeled anomalous
        normal = x[(mask == 0.0) | (labels == 0.0)]
        if len(normal) == 0:
            return
        mu = normal.mean(axis=0)
        var = normal.var(axis=0) + 1e-6
        if not self._norm_initialized:
            self._mu, self._var = mu, var
            self._norm_initialized = True
        else:
            m = self._norm_momentum
            self._mu = (1 - m) * self._mu + m * mu
            self._var = (1 - m) * self._var + m * var
        self._mu = np.asarray(self._mu, np.float32)
        self._var = np.asarray(self._var, np.float32)
        self._place_norm()

    # -- lifecycle: snapshot / restore / swap -----------------------------
    def snapshot(self) -> ModelSnapshot:
        """The full state as host copies; restores to identical scores
        and continues training where it left off. Blocking: call off the
        event loop."""
        with self._lock, self._train_context():
            return ModelSnapshot(
                params=params_to_numpy(self._masters),
                opt_leaves=adam_to_leaves(self._masters, self._opt),
                mu=self._mu.copy(), var=self._var.copy(),
                norm_initialized=self._norm_initialized,
                step=self._step, cfg=self.cfg)

    def restore(self, snap: ModelSnapshot) -> None:
        """Hot-swap ``snap`` in, training state included. The snapshot
        must match this scorer's config and optimizer layout. Blocking:
        call off the event loop."""
        if _cfg_to_dict(snap.cfg) != _cfg_to_dict(self.cfg):
            raise ValueError(
                f"snapshot config {_cfg_to_dict(snap.cfg)} does not match "
                f"scorer config {_cfg_to_dict(self.cfg)}")
        template = zero_adam_leaves(self.cfg)
        if len(snap.opt_leaves) != len(template):
            raise ValueError(
                f"optimizer state mismatch: snapshot has "
                f"{len(snap.opt_leaves)} leaves, optimizer expects "
                f"{len(template)}")
        for leaf, t in zip(snap.opt_leaves, template):
            if np.shape(leaf) != t.shape:
                raise ValueError(
                    f"optimizer leaf shape mismatch: snapshot "
                    f"{np.shape(leaf)} vs optimizer {t.shape}")
        for group, dims in layer_dims(self.cfg).items():
            got = [(np.shape(layer["w"]), np.shape(layer["b"]))
                   for layer in snap.params[group]]
            if got != [((i, o), (o,)) for i, o in dims]:
                raise ValueError(
                    f"snapshot {group} layer shapes {got} do not match "
                    f"the scorer's {dims}")
        with self._lock:
            self._install(snap)

    def swap(self, snap: ModelSnapshot) -> ModelSnapshot:
        """Restore ``snap``; returns the displaced state."""
        old = self.snapshot()
        self.restore(snap)
        return old

    async def warmup(self, rows: int = 4) -> None:
        """Score a zero batch, fit on it once, round-trip snapshot ->
        restore and score again: builds the kernel, the bucket's ring
        slots and the training path, and exercises the hot swap, before
        real traffic. Afterwards the state is put back bit for bit, Adam
        moments and step counter included."""
        rows = max(rows, 1)
        x = np.zeros((rows, self.cfg.in_dim), np.float32)
        before = await asyncio.to_thread(self.snapshot)
        try:
            await self.score(x)
            await self.fit(x, np.zeros(rows, np.float32),
                           np.zeros(rows, np.float32))
            snap = await asyncio.to_thread(self.snapshot)
            await asyncio.to_thread(self.restore, snap)
            await self.score(x)
        finally:
            await asyncio.to_thread(self.restore, before)

    def _note_timing(self, queue_ms: float, transfer_ms: float,
                     device_ms: float, nbytes: int) -> None:
        self.last_timing = {"queue_ms": queue_ms,
                            "transfer_ms": transfer_ms,
                            "device_ms": device_ms, "bytes": nbytes}
        t = self.timing_totals
        t["calls"] += 1
        t["queue_ms"] += queue_ms
        t["transfer_ms"] += transfer_ms
        t["device_ms"] += device_ms
        t["bytes"] += nbytes

    async def score(self, x: np.ndarray) -> np.ndarray:
        """Score [n, D] -> [n] through the dispatch ring. The serving
        tuple is captured here, so a concurrent fit or restore cannot
        tear an in-flight batch's (params, mu, var)."""
        if self.timing_enabled:
            self._timing_i += 1
            if self.timing_sample_every <= 1 \
                    or self._timing_i % self.timing_sample_every == 1:
                return await self._score_timed(x)
        params, mu_d, var_d = self._dev
        dev, scorer = self.device, self._scorer

        def step(rows: torch.Tensor) -> torch.Tensor:
            xd = rows.to(dev, non_blocking=True)
            return scorer(params, xd, mu_d, var_d)

        return await self._dispatcher.dispatch(
            np.asarray(x, np.float32), step)

    async def _score_timed(self, x: np.ndarray) -> np.ndarray:
        """Score [n, D] -> [n] in three phases, each ended by a barrier
        on the dispatch stream: the host-to-device copy, the score step
        (one launch of the kernel on CUDA, as on the ring) and the
        readback. Notes ``queue_ms`` (submit to start, on a worker
        thread), ``transfer_ms`` (both copies), ``device_ms`` (the step)
        and ``bytes`` (rows in, scores out). The line-rate path is
        ``score``; this one forfeits the ring's overlap."""
        t_submit = time.monotonic()
        xf = np.ascontiguousarray(x, np.float32)
        params, mu_d, var_d = self._dev
        dev, scorer, ring = self.device, self._scorer, self._dispatcher

        def barrier() -> None:
            if ring.stream is not None:
                ring.stream.synchronize()

        def run() -> np.ndarray:
            t0 = time.monotonic()
            with ring.device_context():
                xd = torch.from_numpy(xf).to(dev)
                barrier()
                t1 = time.monotonic()
                r = scorer(params, xd, mu_d, var_d)
                barrier()
                t2 = time.monotonic()
                out = r.cpu().numpy()
            t3 = time.monotonic()
            self._note_timing(
                queue_ms=(t0 - t_submit) * 1e3,
                transfer_ms=(t1 - t0 + t3 - t2) * 1e3,
                device_ms=(t2 - t1) * 1e3,
                nbytes=xf.nbytes + out.nbytes)
            return out

        return await asyncio.to_thread(run)

    async def fit(self, x: np.ndarray, labels: np.ndarray,
                  mask: np.ndarray) -> float:
        """``fit_steps`` Adam steps on one labeled batch, off the event
        loop; returns the last step's loss. The rows train unpadded, so
        no row mask is needed."""
        return await asyncio.to_thread(
            self._fit, np.asarray(x, np.float32),
            np.asarray(labels, np.float32), np.asarray(mask, np.float32))

    def _fit(self, x: np.ndarray, labels: np.ndarray,
             mask: np.ndarray) -> float:
        if torch.get_float32_matmul_precision() != "highest":
            # TF32 products would move training off the reference's
            raise RuntimeError(
                "fit needs float32 matmul precision 'highest', got "
                f"{torch.get_float32_matmul_precision()!r}")
        dev = self.device
        with self._lock:
            # as the reference: the new stats go live before the steps,
            # the fitted weights after them
            self._update_norm(x, labels, mask)
            with self._train_context():
                xn = normalize_features(torch.tensor(x, device=dev),
                                        torch.tensor(self._mu, device=dev),
                                        torch.tensor(self._var, device=dev))
                y = torch.tensor(labels, device=dev)
                m = torch.tensor(mask, device=dev)
                losses = train_steps(self._masters, self._opt, xn, y, m,
                                     self.cfg, self.fit_steps)
                self._step += self.fit_steps
                # read before the pack, which makes the train stream
                # wait on the dispatch stream's queued Score batches
                loss = float(losses[-1])
                self._dev = (self._pack(), *self._dev[1:])
                return loss

    def close(self) -> None:
        self._dispatcher.close()


# Keys of the reference's ``io.l5d.jaxAnomaly`` block that the port does
# not take yet, with the ROADMAP item that brings each. A config naming
# one is refused, not quietly served without it. (None left.)
REFUSED_KEYS: Dict[str, str] = {}


@register("telemeter", "io.l5d.jaxAnomaly")
@dataclass
class JaxAnomalyConfig:
    """The ``io.l5d.jaxAnomaly`` telemeter block, with the reference's
    keys and defaults for the in-process tier. Naming a key of
    ``REFUSED_KEYS`` raises ``ConfigError``."""

    maxBatch: int = 1024
    intervalMs: int = 50
    ringCapacity: int = 65536
    maxBatchesPerWake: int = 8  # catch-up burst ceiling under backlog
    scoreThreshold: float = 0.5
    trainEveryBatches: int = 8      # online-fit cadence (0 = never train)
    reconWeight: float = 0.7
    learningRate: float = 0.001
    # line-rate micro-batcher (the default): a batch dispatches when
    # maxBatch rows are pending OR the oldest pending row has lingered
    # maxLingerMs, whichever first; lineRate: false falls back to the
    # intervalMs polling loop
    lineRate: bool = True
    maxLingerMs: float = 2.0
    scoreConcurrency: int = 2  # batches in flight (double-buffer depth)
    # the scorer sidecar: "host:port" (one replica), "host:p1,host:p2"
    # (a fixed replica pool), or a namer path such as
    # "/#/io.l5d.fs/l5d-scorer" (announced replicas, resolved through
    # the linker's namers and followed as they come and go)
    sidecarAddress: Optional[str] = None
    # "fallback" (the default): the in-process scorer serves every batch
    # and the sidecar is its fallback tier behind a breaker; "primary":
    # the sidecar is the one scorer
    sidecarTier: str = "fallback"
    # the native tier's weight export: "primary" exports the serving
    # model as a versioned, CRC'd blob to every registered weight sink
    # at startup and on every lifecycle promote/rollback; "off" exports
    # nothing
    nativeTier: str = "primary"
    nativeQuant: str = "f32"   # blob encoding: f32 | int8 | int4
    # without a lifecycle: block, the online-trained model is
    # re-exported on this cadence (seconds; 0 disables)
    nativeRefreshS: float = 30.0
    # the sidecar's per-call deadline and breaker (read only with a
    # sidecarAddress)
    scoreTimeoutMs: int = 2000
    breakerFailures: int = 3
    breakerMinBackoffMs: int = 500
    breakerMaxBackoffMs: int = 30000
    # ScoreBoard staleness TTL: stale scores decay to neutral so a dead
    # scorer can't pin accrual policy
    scoreTtlSecs: float = 30.0
    # model lifecycle: checkpointing, shadow-eval promotion gating, drift
    # detection, restart restore (see linkerd_tpu_torch/lifecycle/)
    lifecycle: Optional[LifecycleConfig] = None
    # drift-triggered distillation of per-route specialist heads (see
    # linkerd_tpu_torch/distill/)
    distill: Optional[DistillConfig] = None
    # reactive control loop: score-weighted balancing, adaptive
    # admission, anomaly-triggered dtab overrides (see
    # linkerd_tpu_torch/control/)
    control: Optional[ControlConfig] = None

    def __new__(cls, *args, **kwargs):
        refused = [k for k in kwargs if k in REFUSED_KEYS]
        if refused:
            raise ConfigError("; ".join(
                f"io.l5d.jaxAnomaly key {k!r} is not supported by the "
                f"port yet: it comes with {REFUSED_KEYS[k]}"
                for k in refused))
        return super().__new__(cls)

    def mk(self, metrics: MetricsTree,
           device: DeviceLike = None) -> "JaxAnomalyTelemeter":
        return JaxAnomalyTelemeter(self, metrics, device=device)


class JaxAnomalyTelemeter(Telemeter):
    """The anomaly telemeter: the reference's counterpart. The scorer,
    lifecycle manager and distillation pipeline it builds run on
    ``device`` (CUDA unless ``"cpu"`` is named; none with a
    ``sidecarTier: primary`` sidecar and neither of the other two); the
    control loop is device-free."""

    def __init__(self, cfg: JaxAnomalyConfig, metrics: MetricsTree,
                 scorer: Optional[Scorer] = None,
                 device: DeviceLike = None):
        if cfg.maxBatchesPerWake < 1:
            # 0 would silently disable draining (NOT a sentinel like
            # trainEveryBatches' 0 = never)
            raise ValueError("maxBatchesPerWake must be >= 1")
        if cfg.sidecarTier not in ("primary", "fallback"):
            raise ValueError("sidecarTier must be 'primary' or 'fallback'")
        if cfg.nativeTier not in ("primary", "off"):
            raise ValueError("nativeTier must be 'primary' or 'off'")
        if cfg.nativeQuant not in ("f32", "int8", "int4"):
            raise ValueError(
                "nativeQuant must be 'f32', 'int8', or 'int4'")
        if cfg.distill is not None \
                and (cfg.distill.quant or "f32") not in ("f32", "int8",
                                                         "int4"):
            raise ValueError(
                "distill.quant must be 'f32', 'int8', or 'int4'")
        if cfg.nativeRefreshS < 0:
            raise ValueError("nativeRefreshS must be >= 0")
        if cfg.maxLingerMs < 0:
            raise ValueError("maxLingerMs must be >= 0")
        if cfg.scoreConcurrency < 1:
            raise ValueError("scoreConcurrency must be >= 1")
        self.cfg = cfg
        self.device = self._resolve_device(device)
        self.metrics = metrics
        self.ring: Deque = collections.deque(maxlen=cfg.ringCapacity)
        # raw native-engine rows, drained C -> ring memory by the
        # FastPathController and consumed zero-copy by the batcher
        self.native_ring = NativeFeatureRing(cfg.ringCapacity)
        self._native_featurizer = NativeFeaturizer()
        self.board = ScoreBoard(ttl_s=cfg.scoreTtlSecs)
        self._scorer = scorer
        self._stop = asyncio.Event()
        self._wake = asyncio.Event()  # batcher wake: rows pending
        self._fit_lock = asyncio.Lock()
        self._node = metrics.scope("anomaly")
        self._scored = self._node.counter("scored_total")
        # rows scored IN the native engines (in-data-plane tier); the
        # scored_total counter includes them — native_scored_fraction
        # is the native-vs-device tier split
        self._native_scored = self._node.counter("native_scored_total")
        self._node.gauge("native_scored_fraction",
                         fn=self._native_fraction)
        # every request that ENTERS the scoring path (recorder append or
        # native-ring row): scored_total / requests_total is the scored
        # fraction — "100% scored" is measured, not asserted
        self._requests = self._node.counter("requests_total")
        self._node.gauge("scored_fraction", fn=self._scored_fraction)
        self._node.gauge("ring_depth", fn=lambda: len(self.ring))
        self._node.gauge("native_ring_depth",
                         fn=lambda: float(len(self.native_ring)))
        self._node.gauge("native_ring_dropped",
                         fn=lambda: float(self.native_ring.dropped))
        self._batches = self._node.counter("batches")
        self._train_loss = self._node.gauge("train_loss")
        # degraded mode: 1 while the scorer path is failing; scoring
        # pauses, anomaly-aware policies fall back to reference behavior
        self._degraded = self._node.gauge("degraded")
        self._degraded.set(0.0)
        self._score_failures = self._node.counter("score_failures")
        self._dropped_batches = self._node.counter("dropped_batches")
        # fleet model coordination: replicas restored per promote
        self._fleet_model_pushes = self._node.counter(
            "fleet_model_pushes")
        self._gauges: Dict[str, object] = {}
        self._batch_i = 0
        # weight publication: native engines register publish callbacks
        # (sinks); the serving model is exported as a CRC'd blob at
        # startup and on every lifecycle promote/rollback hot-swap, and
        # the last blob is replayed to late registrations
        self._weight_sinks: List[Callable[[bytes], None]] = []
        # full sink -> delta-patch sink (engines that can apply
        # per-route L5DWTD01 patches register one alongside)
        self._delta_sinks: Dict[Callable, Callable[[bytes], None]] = {}
        self._last_blob: Optional[bytes] = None
        self._native_blob_meta: Optional[dict] = None
        self._native_publishes = 0
        self._last_native_pub = 0.0   # monotonic; periodic re-export
        self._native_refreshing = False
        # scorer replica pool (sidecarAddress as a list or namer path):
        # held apart from the wrapped self._scorer so run() can start its
        # membership watch and /model.json can report it
        self._scorer_pool = None
        self._sidecar_activity = None
        # span sink: per-request children of the originating trace plus
        # one batch span linking its constituents
        self._span_sink = None
        self._spans_recorded = self._node.counter("spans_recorded")
        # model lifecycle: checkpoint store + promotion gate + drift
        # monitor; None when the config block is absent
        self._lifecycle = None
        if cfg.lifecycle is not None:
            if cfg.lifecycle.holdoutEveryBatches < 1:
                raise ValueError("lifecycle.holdoutEveryBatches must be >= 1")
            self._lifecycle = cfg.lifecycle.mk_manager(
                self._node.scope("drift"), device=self.device)
            model_node = self._node.scope("model")
            model_node.gauge("version", fn=lambda: float(
                self._lifecycle.serving_version or 0))
            model_node.gauge("step", fn=lambda: float(
                getattr(self._scorer, "_step", 0) or 0))
            model_node.gauge("promotions",
                             fn=lambda: float(self._lifecycle.promotions))
            model_node.gauge("rollbacks",
                             fn=lambda: float(self._lifecycle.rollbacks))
        # drift-triggered distillation of per-route specialist heads;
        # None when the block is absent. Publishes ride the weight
        # sinks, preferring delta patches.
        self.distill = None
        if cfg.distill is not None:
            self.distill = cfg.distill.mk(
                self._node.scope("distill"),
                store=(self._lifecycle.store
                       if self._lifecycle is not None else None),
                quant=cfg.nativeQuant, device=self.device)
            self.distill.set_publisher(self.publish_bank_update)
        # reactive control loop (score-weighted balancing / adaptive
        # admission / mesh reactor); None when the block is absent. The
        # Linker registers balancers + admission filters into it during
        # router assembly and its run() task rides alongside ours.
        self.control = None
        if cfg.control is not None:
            self.control = cfg.control.mk(
                self.board, metrics,
                drift=(self._lifecycle.drift
                       if self._lifecycle is not None else None),
                # cold-start guard: no actuation until the scorer has
                # seen (and trained on) warmupBatches batches
                ready_fn=lambda: (self._batches.value
                                  >= self.cfg.control.warmupBatches))

    def _resolve_device(self, device: DeviceLike) -> Optional[torch.device]:
        """The device this telemeter's scorer, lifecycle and distillation
        run on. With ``sidecarTier: primary`` and neither of the other
        two there is none: the sidecar scores, and no device is asked
        for unless one is named. A tiered config that finds no CUDA
        device says how to run without one: it never quietly makes the
        sidecar its only tier."""
        cfg = self.cfg
        if (self._sidecar_only and cfg.lifecycle is None
                and cfg.distill is None):
            return None if device is None else torch.device(device)
        try:
            return resolve_device(device)
        except RuntimeError as e:
            if not cfg.sidecarAddress:
                raise
            raise RuntimeError(
                f"{e}; or set sidecarTier: primary to score on the "
                "sidecar alone, with no device in this process") from e

    @property
    def _sidecar_only(self) -> bool:
        """``sidecarTier: primary`` with a sidecar: no in-process scorer."""
        return bool(self.cfg.sidecarAddress) \
            and self.cfg.sidecarTier == "primary"

    @property
    def lifecycle(self):
        """The ModelLifecycleManager (None unless configured)."""
        return self._lifecycle

    def _scored_fraction(self) -> float:
        req = self._requests.value
        if req <= 0:
            return 1.0
        return min(1.0, self._scored.value / req)

    def _native_fraction(self) -> float:
        scored = self._scored.value
        if scored <= 0:
            return 0.0
        return min(1.0, self._native_scored.value / scored)

    # -- native tier: weight export + publication -------------------------
    def register_weight_sink(self, sink: Callable[[bytes], None],
                             delta_sink: Optional[Callable[[bytes], None]]
                             = None) -> None:
        """Install a publish callback (``engine.publish_weights``, plus
        ``engine.publish_delta`` when the engine can apply per-route
        patches). The last exported blob is replayed immediately, so
        registration order against the startup publish does not
        matter."""
        self._weight_sinks.append(sink)
        if delta_sink is not None:
            self._delta_sinks[sink] = delta_sink
        if self._last_blob is not None:
            self._publish_blob_to(sink, self._last_blob)

    def unregister_weight_sink(self, sink: Callable[[bytes], None]) -> None:
        """Remove a publish callback: a later promote must not call into
        a freed engine."""
        try:
            self._weight_sinks.remove(sink)
        except ValueError:
            pass
        self._delta_sinks.pop(sink, None)

    def publish_bank_update(self, full: Optional[bytes],
                            delta: Optional[bytes] = None) -> bool:
        """Ship a specialist-bank update to every registered sink: the
        delta patch where a sink can take it (a rejection falls back to
        the full bank, which re-fences the engine for future deltas),
        the full blob otherwise. Returns True when at least one sink
        took the delta path. Called by the DistillationPipeline under
        its lock."""
        used_delta = False
        if full is not None:
            self._last_blob = full
            self._native_blob_meta = blob_meta(full)
            self._native_publishes += 1
            self._last_native_pub = time.monotonic()
        for sink in list(self._weight_sinks):
            dsink = self._delta_sinks.get(sink)
            if delta is not None and dsink is not None:
                try:
                    dsink(delta)
                    used_delta = True
                    continue
                except Exception:  # noqa: BLE001 — a fence-rejected
                    # patch falls back to the full bank below
                    log.warning("native delta publish rejected; "
                                "falling back to full bank",
                                exc_info=True)
            if full is not None:
                self._publish_blob_to(sink, full)
        return used_delta

    def _publish_blob_to(self, sink, blob: bytes) -> None:
        try:
            sink(blob)
        except Exception:  # noqa: BLE001 — a rejecting engine must not
            # take down the telemeter; the scorer keeps scoring
            log.exception("native weight publish failed")

    async def refresh_native_weights(self, scorer: Optional[Scorer] = None,
                                     version: Optional[int] = None) -> bool:
        """Export the serving model as a weight blob and publish it to
        every registered sink. Called at startup and after every
        lifecycle promote/rollback. Returns True when a blob went out."""
        if self.cfg.nativeTier != "primary":
            return False
        scorer = scorer or self._ensure_scorer()
        snap_fn = getattr(scorer, "snapshot", None)
        if snap_fn is None or asyncio.iscoroutinefunction(snap_fn):
            return False  # no host-side snapshot surface
        try:
            snap = await asyncio.to_thread(snap_fn)
            if version is None:
                version = (self._lifecycle.serving_version
                           if self._lifecycle is not None else None)
            if version is None:
                version = int(getattr(scorer, "_step", 0) or 0)
            if self.distill is not None:
                # base model changed: export the FULL bank (new base +
                # every promoted head, generation bumped). Export AND
                # sink fan-out stay under the pipeline lock: a retrain's
                # delta landing between them would otherwise be
                # clobbered by this (older-generation) full blob.
                async with self.distill.lock:
                    blob = await asyncio.to_thread(
                        self.distill.export_full, snap, int(version),
                        None)
                    self._finish_full_publish(blob, int(version))
                return True
            blob = await asyncio.to_thread(
                export_weight_blob, snap, int(version),
                self.cfg.nativeQuant)
        except Exception:  # noqa: BLE001 — export failures must never
            # stop scoring
            log.exception("native weight export failed")
            return False
        self._finish_full_publish(blob, int(version))
        return True

    def _finish_full_publish(self, blob: bytes, version: int) -> None:
        """Bookkeeping + sink fan-out for a full blob/bank export (sync
        so the distill path can hold its lock across it)."""
        self._last_blob = blob
        self._native_blob_meta = blob_meta(blob)
        self._native_publishes += 1
        self._last_native_pub = time.monotonic()
        if (self._lifecycle is not None
                and version == self._lifecycle.serving_version):
            # the blob rides the checkpoint manifest: the serving
            # version's entry records exactly which CRC'd bits went out
            try:
                self._lifecycle.store.record_native_blob(
                    int(version), self._native_blob_meta)
            except Exception:  # noqa: BLE001 — lineage annotation only
                log.exception("native blob manifest record failed")
        for sink in list(self._weight_sinks):
            self._publish_blob_to(sink, blob)

    def _maybe_refresh_native_weights(self, scorer: Scorer) -> None:
        """Periodic re-export of the online-trained model when no
        lifecycle manages promotes. Fire-and-forget with a reentrancy
        guard."""
        if (self.cfg.nativeTier != "primary"
                or self._lifecycle is not None
                or not self.cfg.nativeRefreshS
                or not self._weight_sinks
                or self._native_refreshing
                or time.monotonic() - self._last_native_pub
                < self.cfg.nativeRefreshS):
            return
        self._native_refreshing = True

        async def go() -> None:
            try:
                await self.refresh_native_weights(scorer)
            finally:
                # rate-limit retries on export failure too
                self._last_native_pub = time.monotonic()
                self._native_refreshing = False

        monitor(asyncio.create_task(go(), name="native-weight-refresh"),
                what="native-weight-refresh")

    def _maybe_distill(self, scorer: Scorer) -> None:
        """Kick one drift-triggered specialist retrain when a route is
        pending — fire-and-forget with the pipeline's own reentrancy
        guard (one retrain at a time). Fine-tune + shadow-eval run
        off-loop inside the pipeline; the drain path only pays the
        trigger scan."""
        if self.distill is None or self.distill.busy:
            return
        snap_fn = getattr(scorer, "snapshot", None)
        if snap_fn is None or asyncio.iscoroutinefunction(snap_fn):
            return  # no host snapshot surface: nothing to distill from
        if self.distill.pending_route() is None:
            return
        base_version = (self._lifecycle.serving_version
                        if self._lifecycle is not None else None)

        async def go() -> None:
            try:
                await self.distill.run_once(scorer,
                                            base_version=base_version)
            except Exception:  # noqa: BLE001 — a failed retrain must
                # never stop scoring; the route keeps its serving head
                log.exception("distillation cycle failed")

        monitor(asyncio.create_task(go(), name="distill-retrain"),
                what="distill-retrain")

    def native_tier_state(self) -> dict:
        """The /model.json native-tier block: what blob the sinks hold
        (version/CRC), how often it swapped, and the native-vs-device
        scored split."""
        scored = self._scored.value
        nat = self._native_scored.value
        return {
            "mode": self.cfg.nativeTier,
            "quant": self.cfg.nativeQuant,
            "blob": self._native_blob_meta,
            "publishes": self._native_publishes,
            "engines": len(self._weight_sinks),
            "native_scored_total": nat,
            "jax_scored_total": scored - nat,
            "native_scored_fraction": (round(nat / scored, 6)
                                       if scored else 0.0),
        }

    # -- stack tap --------------------------------------------------------
    def recorder(self) -> FeatureRecorder:
        return FeatureRecorder(self.ring, on_record=self._note_request)

    def _note_request(self) -> None:
        self._requests.incr()
        self._wake.set()

    # -- native fastpath feed ---------------------------------------------
    def set_native_route_resolver(self, fn: Callable[[int], str]) -> None:
        """Install the FastPathController's route_id -> dst-path mapping
        (consulted once per unique route, cached)."""
        self._native_featurizer.resolver = fn

    def native_committed(self, rows: int, dropped: int = 0) -> None:
        """The controller drained ``rows`` engine rows into
        ``native_ring`` and shed ``dropped`` more under backpressure:
        BOTH count toward requests_total (a shed row entered the
        scoring path and was not scored — the scored fraction must
        report < 1.0 under overload, not hide the shed), then wake the
        batcher."""
        if rows > 0 or dropped > 0:
            self._requests.incr(rows + dropped)
        if rows > 0:
            self._wake.set()

    # with a span sink installed, 1-in-N batches pay the instrumented
    # timing path; the other N-1 keep the line-rate ring and span tags
    # reuse the last sampled decomposition
    TIMING_SAMPLE_EVERY = 16

    def set_tracer(self, tracer) -> None:
        """Install the span sink. With a sink in place the scorer's
        phase-split timing pays for itself, so it is switched on —
        SAMPLED, so the serving path stays on the ring."""
        self._span_sink = tracer
        if self.control is not None and tracer is not None:
            self.control.set_tracer(tracer)
        if self._scorer is not None and tracer is not None:
            self._enable_sampled_timing(self._scorer)

    def _enable_sampled_timing(self, scorer) -> None:
        scorer.timing_enabled = True
        if hasattr(scorer, "timing_sample_every"):
            scorer.timing_sample_every = self.TIMING_SAMPLE_EVERY

    # -- Telemeter --------------------------------------------------------
    def _mk_inprocess(self) -> InProcessScorer:
        return InProcessScorer(
            learning_rate=self.cfg.learningRate,
            recon_weight=self.cfg.reconWeight, device=self.device)

    def set_sidecar_activity(self, activity) -> None:
        """Install the namer lookup Activity behind a path-form
        ``sidecarAddress`` (the Linker resolves the path against its
        namers at assembly); the replica pool follows it."""
        self._sidecar_activity = activity
        if self._scorer_pool is not None:
            self._scorer_pool.attach_activity(activity)

    def _mk_sidecar_client(self):
        """One GrpcScorerClient, or a ScorerReplicaPool for a list or a
        namer path (fleet/scorer_pool.py)."""
        addr = self.cfg.sidecarAddress
        from linkerd_tpu_torch.telemetry.sidecar import GrpcScorerClient
        if addr.startswith("/"):
            from linkerd_tpu_torch.fleet.scorer_pool import (
                ScorerReplicaPool,
            )
            self._scorer_pool = ScorerReplicaPool()
            if self._sidecar_activity is not None:
                self._scorer_pool.attach_activity(self._sidecar_activity)
            return self._scorer_pool
        if "," in addr:
            from linkerd_tpu_torch.fleet.scorer_pool import (
                ScorerReplicaPool,
            )
            self._scorer_pool = ScorerReplicaPool(addr.split(","))
            return self._scorer_pool
        return GrpcScorerClient(addr)

    def _mk_resilient(self):
        """The sidecar behind the per-call deadline and the breaker,
        which wrap outside the client's own first-call deadlines: a hung
        sidecar costs one bounded call, then fails fast."""
        from linkerd_tpu_torch.telemetry.resilience import (
            CircuitBreaker, ResilientScorer,
        )
        return ResilientScorer(
            self._mk_sidecar_client(),
            call_timeout_s=self.cfg.scoreTimeoutMs / 1e3,
            breaker=CircuitBreaker(
                failures=self.cfg.breakerFailures,
                min_backoff_s=self.cfg.breakerMinBackoffMs / 1e3,
                max_backoff_s=self.cfg.breakerMaxBackoffMs / 1e3))

    def _tiered(self, primary: Scorer) -> Scorer:
        """``primary`` alone, or with the sidecar as its fallback tier."""
        if not self.cfg.sidecarAddress:
            return primary
        from linkerd_tpu_torch.telemetry.linerate import TieredScorer
        return TieredScorer(primary, self._mk_resilient())

    def _ensure_scorer(self) -> Scorer:
        if self._scorer is None:
            if self._sidecar_only:
                self._scorer = self._mk_resilient()
            else:
                self._scorer = self._tiered(self._mk_inprocess())
            if self._span_sink is not None:
                self._enable_sampled_timing(self._scorer)
        return self._scorer

    def _set_degraded(self, degraded: bool) -> None:
        self._degraded.set(1.0 if degraded else 0.0)
        self.board.degraded = degraded

    async def _start_scorer(self) -> Scorer:
        """The scorer ``run()`` serves with. One not built yet is built
        on a worker thread (a CUDA context and the model's tensors:
        seconds on a card) and warmed up before the first batch, so the
        router's loop serves meanwhile and rows wait in the rings. (The
        reference builds it on the loop.) With ``sidecarTier: primary``
        the sidecar is the scorer and nothing is built here; a tiered
        scorer wraps the in-process one once it is warm."""
        if self._scorer is None and self._sidecar_only:
            return self._ensure_scorer()
        if self._scorer is None:
            built = asyncio.ensure_future(
                asyncio.to_thread(self._mk_inprocess))
            try:
                scorer = await asyncio.shield(built)
            except asyncio.CancelledError:
                # the thread runs on: close what it builds
                built.add_done_callback(
                    lambda f: f.cancelled() or f.exception()
                    or f.result().close())
                raise
            if self._scorer is not None:  # one was installed meanwhile
                scorer.close()
                return self._scorer
            # installed before the warm-up, so close() reaches it
            self._scorer = scorer
            await scorer.warmup()
            self._scorer = self._tiered(scorer)
            if self._span_sink is not None:
                self._enable_sampled_timing(self._scorer)
        return self._scorer

    async def run(self) -> None:
        scorer = await self._start_scorer()
        if self._scorer_pool is not None:
            # begin following announced scorer replicas (namer path
            # mode; a no-op for a fixed list)
            self._scorer_pool.start_watch()
        lc_cfg = self.cfg.lifecycle
        if self._lifecycle is not None and lc_cfg.restoreOnStart:
            # survive restarts: pull the last-good model before scoring
            try:
                restored = await self._lifecycle.bootstrap(scorer)
                if restored is not None:
                    log.info("anomaly model restored from checkpoint v%d",
                             restored)
            except Exception:  # noqa: BLE001 — a bad store must not
                log.exception("checkpoint bootstrap failed; "
                              "serving from fresh init")
        # initial publish: sinks hold the serving weights from the start
        await self.refresh_native_weights(scorer)
        control_task = None
        if self.control is not None:
            control_task = asyncio.create_task(
                self.control.run(), name="control-loop")
            monitor(control_task, what="control-loop")
        try:
            if self.cfg.lineRate:
                await self._line_rate_loop(scorer)
            else:
                await self._interval_loop(scorer)
        except asyncio.CancelledError:
            pass
        finally:
            if control_task is not None:
                control_task.cancel()
                await asyncio.gather(control_task, return_exceptions=True)

    async def _maybe_lifecycle(self, last_cycle: float) -> float:
        lc_cfg = self.cfg.lifecycle
        if (self._lifecycle is not None and lc_cfg.checkpointEveryS > 0
                and time.monotonic() - last_cycle
                >= lc_cfg.checkpointEveryS):
            last_cycle = time.monotonic()
            await self.lifecycle_cycle()
        return last_cycle

    async def _interval_loop(self, scorer: Scorer) -> None:
        """Polling drain (lineRate: false): one burst per intervalMs
        tick; rows arriving between ticks wait a full interval."""
        interval = self.cfg.intervalMs / 1e3
        last_cycle = time.monotonic()
        while not self._stop.is_set():
            await asyncio.sleep(interval)
            try:
                await self._drain_burst(scorer)
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001 — the drain loop must
                # outlive any scoring failure; drain_once already
                # downgraded scorer faults, so this is a last resort
                log.exception("anomaly drain failed; continuing")
            last_cycle = await self._maybe_lifecycle(last_cycle)

    async def _line_rate_loop(self, scorer: Scorer) -> None:
        """Adaptive micro-batcher (the default): dispatch when maxBatch
        rows are pending OR the oldest pending row has lingered
        ``maxLingerMs``. Up to ``scoreConcurrency`` batches stay in
        flight so the staging ring double-buffers, while the recorder
        path stays O(1) (it only sets the wake event)."""
        linger = max(self.cfg.maxLingerMs, 0.0) / 1e3
        tick = max(linger / 4, 2e-4)
        sem = asyncio.Semaphore(self.cfg.scoreConcurrency)
        inflight: set = set()
        last_cycle = time.monotonic()
        try:
            while not self._stop.is_set():
                if not self._pending_rows():
                    self._wake.clear()
                    if not self._pending_rows():  # recheck: append raced
                        # asyncio.wait, NOT wait_for: 3.10's wait_for
                        # swallows a cancel() that lands on the same
                        # tick the wake future completes
                        waiter = asyncio.ensure_future(self._wake.wait())
                        try:
                            await asyncio.wait((waiter,), timeout=0.05)
                        finally:
                            waiter.cancel()
                        if not self._pending_rows():
                            last_cycle = await self._maybe_lifecycle(
                                last_cycle)
                            continue
                # linger: give the batch up to maxLingerMs to fill
                t0 = time.monotonic()
                while (self._pending_rows() < self.cfg.maxBatch
                       and time.monotonic() - t0 < linger
                       and not self._stop.is_set()):
                    await asyncio.sleep(tick)
                batch = self._take_batch()
                if batch is None:
                    continue
                await sem.acquire()
                task = asyncio.create_task(
                    self._score_and_publish(scorer, batch),
                    name="anomaly-score-batch")
                task.add_done_callback(lambda _t: sem.release())
                inflight.add(task)
                task.add_done_callback(inflight.discard)
                monitor(task, what="anomaly-score-batch")
                last_cycle = await self._maybe_lifecycle(last_cycle)
        finally:
            for t in list(inflight):
                t.cancel()
            if inflight:
                await asyncio.gather(*inflight, return_exceptions=True)

    def _pending_rows(self) -> int:
        return len(self.ring) + len(self.native_ring)

    async def lifecycle_cycle(self) -> Optional[dict]:
        """One checkpoint/shadow-eval/promote-or-rollback pass (the
        periodic maintenance task; also admin-invocable)."""
        if self._lifecycle is None:
            return None
        try:
            outcome = await self._lifecycle.run_cycle(self._ensure_scorer())
            log.info("model lifecycle cycle: %s",
                     outcome.get("action", "?"))
            if outcome.get("action") in ("promoted", "rolled_back"):
                # the serving model changed (hot-swap): the sinks must
                # follow, or the engines keep scoring the old one
                await self.refresh_native_weights(
                    version=self._lifecycle.serving_version)
                # and so must every scorer replica of the pool
                # (Snapshot/Restore), so that the fallback tier serves
                # the generation the in-process scorer serves
                self._maybe_push_fleet_model()
            return outcome
        except Exception:  # noqa: BLE001 — lifecycle failures must never
            log.exception("model lifecycle cycle failed")  # stop scoring
            return None

    def _maybe_push_fleet_model(self) -> None:
        """Fire-and-forget fleet model push: the serving checkpoint to
        every scorer replica of the pool through the Restore RPC.
        Skipped with no pool or no promoted checkpoint. A slow replica
        costs one bounded background task, never the lifecycle cycle."""
        if self._scorer_pool is None or self._lifecycle is None:
            return
        version = self._lifecycle.serving_version
        if version is None:
            return

        async def go() -> None:
            try:
                _, snap = await asyncio.to_thread(
                    self._lifecycle.store.load, version)
                n = await asyncio.wait_for(
                    self._scorer_pool.broadcast_restore(snap), 30.0)
                if n:
                    self._fleet_model_pushes.incr(n)
                    log.info("fleet model push: v%s restored on %d "
                             "scorer replica(s)", version, n)
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001 — the fleet push is
                # best-effort; replicas converge on a later promote
                log.exception("fleet model push failed")

        monitor(asyncio.create_task(go(), name="fleet-model-push"),
                what="fleet-model-push")

    async def _drain_burst(self, scorer: Scorer,
                           max_batches: Optional[int] = None) -> int:
        """Catch-up drain: under backlog, score several micro-batches
        per wake instead of one per interval."""
        if max_batches is None:
            max_batches = self.cfg.maxBatchesPerWake
        total = 0
        for _ in range(max_batches):
            n = await self.drain_once(scorer)
            total += n
            if n < self.cfg.maxBatch:
                break  # ring drained below one full batch
        return total

    async def drain_once(self, scorer: Optional[Scorer] = None) -> int:
        """Drain one micro-batch through the scorer; returns rows scored."""
        scorer = scorer or self._ensure_scorer()
        batch = self._take_batch()
        if batch is None:
            return 0
        return await self._score_and_publish(scorer, batch)

    def _take_batch(self) -> Optional[dict]:
        """Assemble one micro-batch: Python-path ring items plus a
        zero-copy block of native engine rows. Featurization happens
        HERE, synchronously — the native block is a view into ring
        memory that is only valid until the caller's next await.

        Engine rows that arrived PRE-SCORED (the in-data-plane native
        tier; scored flag set) are split out of the device dispatch:
        their features still feed training/drift/holdout, but the
        device never re-scores them. ``x`` holds only the rows that
        NEED a device score (Python-path + unscored native rows)."""
        n_py = min(len(self.ring), self.cfg.maxBatch)
        # ring items are (fv, label[, trace, enqueued_at, endpoint]) —
        # external producers (benchmarks, fault harnesses) append
        # 2-tuples
        items = [(it + (None, None, None, None))[:5]
                 for it in (self.ring.popleft() for _ in range(n_py))]
        nat_block = self.native_ring.consume(self.cfg.maxBatch - n_py)
        k = len(nat_block)
        if not items and k == 0:
            return None
        fvs = [it[0] for it in items]
        x_py = featurize_batch(fvs)
        nat_inv: Optional[np.ndarray] = None
        nat_dsts: List[str] = []
        nat_scored: Optional[dict] = None
        x_nat: Optional[np.ndarray] = None
        if k:
            # encode the WHOLE block in one pass — the featurizer's
            # per-route drift EWMA must advance exactly once per drain,
            # in arrival order (two subset passes would double-step the
            # baseline and compute the later subset's drift against an
            # already-advanced EWMA) — then split the ENCODED rows by
            # tier. Boolean fancy indexing copies, safe across awaits.
            x_enc, inv_all, dsts = \
                self._native_featurizer.encode_block(nat_block)
            is_scored = nat_block[:, NATIVE_COL_SCORED] > 0.5
            if is_scored.any():
                all_sc = bool(is_scored.all())
                nat_scored = {
                    "x": x_enc if all_sc else x_enc[is_scored],
                    "scores": np.ascontiguousarray(
                        nat_block[is_scored, NATIVE_COL_SCORE],
                        np.float32),
                    "inv": inv_all if all_sc else inv_all[is_scored],
                    "dsts": dsts,
                }
            un = ~is_scored
            if un.any():
                all_un = bool(un.all())
                x_nat = x_enc if all_un else x_enc[un]
                nat_inv = inv_all if all_un else inv_all[un]
                nat_dsts = dsts
        k_un = 0 if x_nat is None else len(x_nat)
        labels = np.array(
            [0.0 if it[1] is None else float(it[1]) for it in items]
            + [0.0] * k_un, dtype=np.float32)
        mask = np.array(
            [0.0 if it[1] is None else 1.0 for it in items]
            + [0.0] * k_un, dtype=np.float32)
        if x_nat is not None:
            x = np.concatenate([x_py, x_nat]) if n_py else x_nat
        else:
            x = x_py
        return {"items": items, "fvs": fvs, "x": x, "labels": labels,
                "mask": mask, "n_py": n_py, "nat_inv": nat_inv,
                "nat_dsts": nat_dsts, "nat_scored": nat_scored}

    async def _score_and_publish(self, scorer: Scorer, b: dict) -> int:
        """Score one assembled batch and publish every downstream
        effect: degraded-mode accounting, scorer spans, lifecycle
        drift/holdout, per-dst board updates, the distill feed,
        training cadence.

        Rows the engines already scored in-data-plane (``nat_scored``)
        skip the device dispatch entirely: their scores publish
        straight to the board, their features still feed
        drift/holdout/distill/training — the RingDispatcher stays the
        training and fallback tier."""
        x, items, n_py = b["x"], b["items"], b["n_py"]
        ns = b.get("nat_scored")
        k_ns = 0 if ns is None else len(ns["x"])
        n_dev = len(x)
        t_drain = time.monotonic()
        ts_us = int(time.time() * 1e6)
        scores: Optional[np.ndarray] = None
        dev_failed = False
        if n_dev:
            try:
                scores = await scorer.score(x)
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001 — graceful degradation:
                # scoring is best-effort; a failing scorer drops the
                # device half of the batch (requests were never blocked
                # on it) and flips degraded mode — engine-scored rows
                # still publish below: the native tier does not depend
                # on the device being healthy
                self._score_failures.incr()
                self._dropped_batches.incr()
                dev_failed = True
                if not self.board.degraded:
                    log.warning(
                        "anomaly scorer degraded (scoring paused, data "
                        "plane unaffected): %r", e)
                self._set_degraded(True)
                if k_ns == 0:
                    return 0
            else:
                scores = np.asarray(scores)
                if self.board.degraded:
                    log.info("anomaly scorer recovered; scoring resumed")
                self._set_degraded(False)
        n_scored = (n_dev if scores is not None else 0) + k_ns
        self._scored.incr(n_scored)
        if k_ns:
            self._native_scored.incr(k_ns)
        if not dev_failed:
            # a failed device dispatch was already counted dropped; the
            # native half still publishes below but the batch must not
            # ALSO count completed, nor export scorer spans for the
            # Python items whose scoring was just dropped
            self._batches.incr()
            if self._span_sink is not None:
                self._record_scorer_spans(
                    items, t_drain, ts_us,
                    int((time.monotonic() - t_drain) * 1e6), scorer)
        # every row with a score — device-scored and engine-scored alike
        # — feeds drift/holdout; labels/mask for the native rows are all
        # zeros (engine rows are never fault-labeled)
        x_all, labels_all, mask_all, scores_all = x, b["labels"], \
            b["mask"], scores
        if k_ns:
            if scores is not None and n_dev:
                x_all = np.concatenate([x, ns["x"]])
                scores_all = np.concatenate(
                    [scores, ns["scores"]])
                labels_all = np.concatenate(
                    [b["labels"], np.zeros(k_ns, np.float32)])
                mask_all = np.concatenate(
                    [b["mask"], np.zeros(k_ns, np.float32)])
            else:
                x_all, scores_all = ns["x"], ns["scores"]
                labels_all = np.zeros(k_ns, np.float32)
                mask_all = np.zeros(k_ns, np.float32)
        holdout = False
        if self._lifecycle is not None and scores_all is not None:
            # drift sees every batch (read-only); the replay window only
            # takes HOLDOUT batches, which are then excluded from
            # training below — a shadow-eval set the candidate trained
            # on could not catch a poisoned training stream
            self._lifecycle.drift.observe(x_all, scores_all)
            holdout = self._batch_i % self.cfg.lifecycle.holdoutEveryBatches == 0
            if holdout:
                self._lifecycle.replay.add_batch(x_all, labels_all,
                                                 mask_all)
        if scores is not None:
            self.board.update_batch([fv.dst_path for fv in b["fvs"]],
                                    scores[:n_py],
                                    endpoints=[it[4] for it in items])
            if b["nat_inv"] is not None and b["nat_dsts"]:
                # native rows: per-ROUTE means, vectorized (update_batch
                # averages per dst anyway, so feeding group means is
                # equivalent to feeding every row)
                self._publish_route_means(
                    b["nat_dsts"], b["nat_inv"], scores[n_py:])
        self._publish_native_batch(ns)
        if self.distill is not None and scores_all is not None \
                and len(scores_all):
            # per-route drift + replay feed: host-only bookkeeping,
            # mirroring exactly how x_all was assembled (python rows,
            # then device-scored native rows, then engine-scored rows)
            dsts_all: List[str] = []
            if scores is not None:
                dsts_all.extend(fv.dst_path for fv in b["fvs"])
                if b["nat_inv"] is not None and b["nat_dsts"]:
                    nd = b["nat_dsts"]
                    dsts_all.extend(nd[int(i)] for i in b["nat_inv"])
            if k_ns:
                nsd = ns["dsts"]
                dsts_all.extend(nsd[int(i)] for i in ns["inv"])
            if len(dsts_all) == len(scores_all):
                self.distill.observe_batch(dsts_all, x_all, scores_all,
                                           labels_all, mask_all)
        self._publish_gauges()
        self._batch_i += 1
        if (not holdout and self.cfg.trainEveryBatches
                and not dev_failed
                and self._batch_i % self.cfg.trainEveryBatches == 0):
            try:
                # serialized: concurrent line-rate batches must not
                # interleave their fit steps. Engine-scored rows train
                # too — the device model is the training tier for ALL
                # traffic, or it would drift away from the distribution
                # the native tier actually serves
                async with self._fit_lock:
                    loss = await scorer.fit(x_all, labels_all, mask_all)
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001 — training is optional;
                # a fit failure (it still feeds the shared breaker) must
                # not take down scoring
                self._score_failures.incr()
                log.debug("online fit skipped (scorer failure): %r", e)
            else:
                self._train_loss.set(loss)
                self._maybe_refresh_native_weights(scorer)
        self._maybe_distill(scorer)
        return n_scored

    def _publish_native_batch(self, ns: Optional[dict]) -> None:
        """Publish engine-scored rows to the board: per-route score
        means, no device work — the scores were computed in-data-plane
        and this hop is pure host arithmetic."""
        if ns is None or not ns["dsts"]:
            return
        self._publish_route_means(ns["dsts"], ns["inv"], ns["scores"])

    def _publish_route_means(self, dsts: List[str], inv: np.ndarray,
                             scores: np.ndarray) -> None:
        """Per-route score means onto the board. ``dsts`` is the FULL
        block's route list while ``inv`` may index only one tier's
        subset of its rows — routes with no rows here are skipped, not
        published as a spurious 0.0."""
        m = len(dsts)
        sums = np.bincount(inv, weights=scores, minlength=m)
        counts = np.bincount(inv, minlength=m)
        nz = counts > 0
        if not nz.any():
            return
        if nz.all():
            self.board.update_batch(dsts, sums / counts)
        else:
            self.board.update_batch(
                [d for d, keep in zip(dsts, nz) if keep],
                sums[nz] / counts[nz])

    # at most this many per-request scorer spans per drained batch: a
    # 1024-row batch must not turn into 1024 span records
    MAX_SPANS_PER_BATCH = 128

    def _record_scorer_spans(self, items, t_drain: float, ts_us: int,
                             dur_us: int, scorer) -> None:
        """Scorer-path spans for one drained micro-batch: a batch span
        (own trace) that links its constituent request traces via
        annotations, plus one child span per SAMPLED originating request
        carrying the queue/device/transfer decomposition."""
        timing = getattr(scorer, "last_timing", None) or {}
        timing_tags = {f"scorer.{k}": (f"{v:.3f}" if isinstance(v, float)
                                       else str(v))
                       for k, v in timing.items()}
        traced = [(it[2], it[3]) for it in items
                  if it[2] is not None and it[2].sampled]
        batch = TraceId.mk_root(True)
        batch_tags = dict(timing_tags)
        batch_tags["scorer.batch_size"] = str(len(items))
        batch_tags["scorer.linked"] = str(len(traced))
        self._span_sink.record({
            "traceId": f"{batch.trace_id:032x}",
            "id": f"{batch.span_id:016x}",
            "parentId": None,
            "kind": "CONSUMER",
            "name": "scorer.batch",
            "timestamp": ts_us,
            "duration": dur_us,
            "localEndpoint": {"serviceName": "scorer"},
            # constituent request spans, linked (zipkin has no otel-style
            # span links; annotations are the v2-JSON-native equivalent)
            "annotations": [
                {"timestamp": ts_us,
                 "value": f"link:{t.trace_id:032x}:{t.span_id:016x}"}
                for t, _ in traced[:self.MAX_SPANS_PER_BATCH]],
            "tags": batch_tags,
        })
        self._spans_recorded.incr()
        for trace, enq in traced[:self.MAX_SPANS_PER_BATCH]:
            child = trace.child()
            tags = dict(timing_tags)
            tags["scorer.batch_span"] = f"{batch.span_id:016x}"
            if enq is not None:
                # ring wait: enqueue (request completion) -> drain start
                tags["scorer.queue_ms"] = f"{(t_drain - enq) * 1e3:.3f}"
            self._span_sink.record({
                "traceId": f"{child.trace_id:032x}",
                "id": f"{child.span_id:016x}",
                "parentId": f"{child.parent_id:016x}",
                "kind": "CONSUMER",
                "name": "scorer",
                "timestamp": ts_us,
                "duration": dur_us,
                "localEndpoint": {"serviceName": "scorer"},
                "tags": tags,
            })
            self._spans_recorded.incr()

    def _publish_gauges(self) -> None:
        for dst, score in self.board.scores.sample().items():
            key = dst.lstrip("/").replace("/", ".") or "root"
            g = self._gauges.get(key)
            if g is None:
                g = self._node.scope("dst").gauge(key)
                self._gauges[key] = g
            g.set(score)

    def admin_handlers(self):
        from linkerd_tpu_torch.admin.server import json_response

        async def anomaly_json(req: Request) -> Response:
            return json_response({
                "scores": self.board.scores.sample(),
                "threshold": self.cfg.scoreThreshold,
                "ring_depth": len(self.ring),
            })

        async def model_json(req: Request) -> Response:
            return json_response(self.model_state())

        handlers = [("/anomaly.json", anomaly_json),
                    ("/model.json", model_json)]
        if self.control is not None:
            # (ref: linkerd_tpu/telemetry/anomaly.py:1801-1810; the fleet
            # handlers come with control.fleet, ROADMAP Queue 1 item 14)
            async def control_json(req: Request) -> Response:
                st = self.control.status()
                # the control loop actuates on scores; surface WHICH
                # tier produced them (and which model version/CRC the
                # engines are serving) next to the actuation state
                st["native_tier"] = self.native_tier_state()
                return json_response(st)

            handlers.append(("/control.json", control_json))
        return handlers

    def model_state(self) -> dict:
        """Model-lifecycle state for /model.json: version, step, last
        promotion/rollback, drift gauges, store inventory."""
        out: dict = {
            "lifecycle_enabled": self._lifecycle is not None,
            "live_step": getattr(self._scorer, "_step", None),
            "scorer": type(self._scorer).__name__
            if self._scorer is not None else None,
            "degraded": bool(self.board.degraded),
            # "100% scored" is measured, not asserted
            "requests_total": self._requests.value,
            "scored_total": self._scored.value,
            "scored_fraction": round(self._scored_fraction(), 6),
            "line_rate": bool(self.cfg.lineRate),
            "native_tier": self.native_tier_state(),
        }
        breaker = getattr(self._scorer, "breaker", None)
        if breaker is not None:
            out["breaker"] = {
                "state": breaker.state,
                "next_probe_in_s": round(breaker.next_probe_in_s(), 3),
            }
        tier_fn = getattr(self._scorer, "tier_state", None)
        if tier_fn is not None:
            out["tiers"] = tier_fn()
        if self._scorer_pool is not None:
            out["scorer_pool"] = self._scorer_pool.status()
        if self.distill is not None:
            # the per-route bank view: generation, every specialist
            # head's lineage, live drift shifts, pending retrains
            out["distill"] = self.distill.state()
        if self._lifecycle is not None:
            out.update(self._lifecycle.status())
        return out

    def close(self) -> None:
        self._stop.set()
        if self.control is not None:
            self.control.close()
        if self._lifecycle is not None and self._scorer is not None:
            # best-effort shutdown snapshot: a restart must not silently
            # reset the model to random init. Saved as a candidate —
            # restart prefers the last PROMOTED version when one exists
            snap_fn = getattr(self._scorer, "snapshot", None)
            if snap_fn is not None \
                    and not asyncio.iscoroutinefunction(snap_fn):
                try:
                    self._lifecycle.store.save(
                        snap_fn(), status="candidate",
                        parent=self._lifecycle.serving_version)
                except Exception:  # noqa: BLE001 — shutdown must proceed
                    log.exception("shutdown checkpoint failed")
        if self._scorer is not None:
            self._scorer.close()


# -- score-driven failure accrual -------------------------------------------


@register("failureAccrual", "io.l5d.jaxAnomaly")
@dataclass
class AnomalyFailureAccrualConfig:
    """Failure accrual that tightens when the anomaly scorer flags the mesh:
    endpoints are marked dead after ``anomalousFailures`` consecutive
    failures while the (EWMA) anomaly level exceeds ``threshold``, else
    after ``failures``."""

    failures: int = 5
    anomalousFailures: int = 2
    threshold: float = 0.5

    needs_board = True

    def mk(self, board: Optional[ScoreBoard] = None):
        return AnomalyFailureAccrualPolicy(
            board or ScoreBoard(), self.failures, self.anomalousFailures,
            self.threshold)


class AnomalyFailureAccrualPolicy(FailureAccrualPolicy):
    """See AnomalyFailureAccrualConfig."""

    def __init__(self, board: ScoreBoard, failures: int,
                 anomalous_failures: int, threshold: float,
                 backoffs=None):
        self.board = board
        self.failures = failures
        self.anomalous_failures = anomalous_failures
        self.threshold = threshold
        self._consecutive = 0
        self._mk_backoffs = (lambda: backoffs) if backoffs else _default_backoffs
        self._backoffs = self._mk_backoffs()

    def _anomaly_level(self) -> float:
        # staleness-decayed and degraded-aware: while the scorer path is
        # down or its scores are stale, this reads 0 and the policy
        # degrades to its reference `failures` threshold
        return self.board.anomaly_level()

    def record_success(self) -> None:
        self._consecutive = 0

    def record_failure(self):
        self._consecutive += 1
        limit = (self.anomalous_failures
                 if self._anomaly_level() >= self.threshold
                 else self.failures)
        if self._consecutive >= limit:
            return next(self._backoffs)
        return None

    def revived(self) -> None:
        self._consecutive = 0
        self._backoffs = self._mk_backoffs()
