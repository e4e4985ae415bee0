"""The anomaly scorer: counterpart of ``Scorer`` and ``InProcessScorer``
in ``linkerd_tpu/telemetry/anomaly.py``.

Scoring runs through ``linerate.RingDispatcher`` and the fused kernel
(``ops.scoring.best_scorer``). Online training (``fit``) takes
``fit_steps`` steps of autograd and ``torch.optim.Adam`` on float32
master weights held on the device, and snapshots carry the Adam state
in the layout of ``optax.adam``'s, so training continues across the
two packages.
"""

from __future__ import annotations

import asyncio
import contextlib
import threading
from typing import Any, List, Tuple

import numpy as np
import torch

from linkerd_tpu_torch import DeviceLike, resolve_device
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
from linkerd_tpu_torch.telemetry.linerate import RingDispatcher
from linkerd_tpu_torch.telemetry.sidecar import bucket_rows


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


class Scorer:
    """Scoring backends. ``score`` takes float32 [B, D] and returns
    float32 [B] anomaly scores in [0, 1]. ``snapshot``/``restore``/
    ``swap`` capture and hot-swap the full state without recreating the
    scorer."""

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

    async def score(self, x: np.ndarray) -> np.ndarray:
        """Score [n, D] -> [n] through the dispatch ring. The serving
        tuple is captured here, so a concurrent fit or restore cannot
        tear an in-flight batch's (params, mu, var)."""
        params, mu_d, var_d = self._dev
        dev, scorer = self.device, self._scorer

        def step(rows: torch.Tensor) -> torch.Tensor:
            xd = rows.to(dev, non_blocking=True)
            return scorer(params, xd, mu_d, var_d)

        return await self._dispatcher.dispatch(
            np.asarray(x, np.float32), step)

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
