"""The anomaly scorer's serving half: counterpart of ``Scorer`` and
``InProcessScorer`` in ``linkerd_tpu/telemetry/anomaly.py``.

Scoring runs through ``linerate.RingDispatcher`` and the fused kernel
(``ops.scoring.best_scorer``). Online training (``fit``) is not part of
this package yet and raises.
"""

from __future__ import annotations

import asyncio
from typing import Any, List, Tuple

import numpy as np
import torch

from linkerd_tpu_torch import DeviceLike, resolve_device
from linkerd_tpu_torch.lifecycle.store import ModelSnapshot, _cfg_to_dict
from linkerd_tpu_torch.models.anomaly import (
    AnomalyModelConfig, init_params, layer_dims,
)
from linkerd_tpu_torch.models.convert import (
    params_from_numpy, params_to_numpy,
)
from linkerd_tpu_torch.ops.scoring import (
    KernelParams, best_scorer, pack_params,
)
from linkerd_tpu_torch.telemetry.linerate import RingDispatcher
from linkerd_tpu_torch.telemetry.sidecar import bucket_rows


def _host_tree(tree: Any) -> Any:
    """Float32 numpy copy of a nested dict/list of arrays."""
    if isinstance(tree, dict):
        return {k: _host_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_host_tree(v) for v in tree]
    return np.array(tree, np.float32)


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
    """Serves the anomaly model on one device through the fused kernel.

    The host holds the authoritative state: float32 params, optimizer
    leaves, normalization stats, step counter. The device holds only
    what scoring reads: the weights pre-cast to ``compute_dtype`` and
    packed for the kernel once, and the ``mu``/``var`` mirrors, as one
    tuple. ``restore`` builds a new tuple and swaps the reference; it
    never writes into tensors that an in-flight batch captured.
    """

    def __init__(self, seed: int = 0, device: DeviceLike = None):
        self.device = resolve_device(device)
        # the reference scorer's blend (JaxAnomalyConfig.reconWeight)
        self.cfg = AnomalyModelConfig(recon_weight=0.7)
        self._scorer = best_scorer(self.cfg)
        self._dispatcher = RingDispatcher(self.cfg.in_dim, bucket_rows,
                                          self.device)
        self._params = params_to_numpy(init_params(seed, self.cfg, "cpu"))
        self._opt_leaves = zero_adam_leaves(self.cfg)
        self._mu = np.zeros(self.cfg.in_dim, np.float32)
        self._var = np.ones(self.cfg.in_dim, np.float32)
        self._norm_initialized = False
        self._step = 0
        self._dev: Tuple[KernelParams, torch.Tensor, torch.Tensor] = \
            self._place()

    def _place(self) -> Tuple[KernelParams, torch.Tensor, torch.Tensor]:
        """Fresh device copies of the serving state, allocated on the
        dispatch stream so the ring's ordering covers their lifetime."""
        with self._dispatcher.device_context():
            params = pack_params(params_from_numpy(
                self._params, self.device, dtype=self.cfg.compute_dtype),
                self.cfg)
            mu = torch.tensor(self._mu, device=self.device)
            var = torch.tensor(self._var, device=self.device)
        return params, mu, var

    # -- lifecycle: snapshot / restore / swap -----------------------------
    def snapshot(self) -> ModelSnapshot:
        """The full state as host copies; restores to identical scores."""
        return ModelSnapshot(
            params=_host_tree(self._params),
            opt_leaves=[np.array(leaf) for leaf in self._opt_leaves],
            mu=self._mu.copy(), var=self._var.copy(),
            norm_initialized=self._norm_initialized,
            step=self._step, cfg=self.cfg)

    def restore(self, snap: ModelSnapshot) -> None:
        """Hot-swap ``snap`` in. The snapshot must match this scorer's
        config and optimizer layout; its optimizer leaves are kept
        verbatim for the next snapshot."""
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
        self._params = _host_tree(snap.params)
        self._opt_leaves = [np.array(leaf, t.dtype)
                            for leaf, t in zip(snap.opt_leaves, template)]
        self._mu = np.asarray(snap.mu, np.float32).copy()
        self._var = np.asarray(snap.var, np.float32).copy()
        self._norm_initialized = bool(snap.norm_initialized)
        self._step = int(snap.step)
        self._dev = self._place()

    def swap(self, snap: ModelSnapshot) -> ModelSnapshot:
        """Restore ``snap``; returns the displaced state."""
        old = self.snapshot()
        self.restore(snap)
        return old

    async def warmup(self, rows: int = 4) -> None:
        """Score a zero batch, round-trip snapshot -> restore, and score
        again: builds the kernel and the bucket's ring slots and
        exercises the hot-swap path before real traffic. The state is
        unchanged afterwards."""
        x = np.zeros((max(rows, 1), self.cfg.in_dim), np.float32)
        await self.score(x)
        snap = await asyncio.to_thread(self.snapshot)
        await asyncio.to_thread(self.restore, snap)
        await self.score(x)

    async def score(self, x: np.ndarray) -> np.ndarray:
        """Score [n, D] -> [n] through the dispatch ring. The serving
        state is captured here, so a concurrent ``restore`` cannot tear
        an in-flight batch's (params, mu, var)."""
        params, mu_d, var_d = self._dev
        dev, scorer = self.device, self._scorer

        def step(rows: torch.Tensor) -> torch.Tensor:
            xd = rows.to(dev, non_blocking=True)
            return scorer(params, xd, mu_d, var_d)

        return await self._dispatcher.dispatch(
            np.asarray(x, np.float32), step)

    async def fit(self, x: np.ndarray, labels: np.ndarray,
                  mask: np.ndarray) -> float:
        raise NotImplementedError("training is a later slice of the port")

    def close(self) -> None:
        self._dispatcher.close()
