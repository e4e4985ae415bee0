"""Fused anomaly scoring: the hand-written CUDA kernel and its plain twin.

``fused_anomaly_scores`` replaces the Pallas kernel
``linkerd_tpu/ops/scoring.py::_score_kernel``. On a CUDA tensor it
launches ``csrc/score_mlp.cu`` (built on first use by ``_build``) or
raises; on a CPU tensor it runs ``fused_anomaly_scores_plain``, the same
function in plain PyTorch. There is no probe that falls back: a kernel
that does not build or launch is an error.

``pack_params`` checks a model against what the kernel takes and lays
it out for launches once; a server packs each model when it places it
and every launch then only passes pointers.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, Optional, Union

import torch

from linkerd_tpu_torch.models.anomaly import (
    AnomalyModelConfig, Params, anomaly_scores, normalize_features,
)
from linkerd_tpu_torch.ops import _build

_GROUPS = ("enc", "dec", "cls")
MAX_WIDTH = 256   # MAXW in csrc/score_mlp.cu: widest layer and in_dim
MAX_LAYERS = 16   # MAX_LAYERS in csrc/score_mlp.cu


@functools.cache
def _kernel() -> Callable[..., int]:
    """``score_mlp_forward`` of ``csrc/score_mlp.cu``, built on first use."""
    fn = _build.load("score_mlp").score_mlp_forward
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [p, i, i, p, p, p, p, p, i, i, i, f, f, p, p]
    fn.restype = ctypes.c_int
    return fn


class KernelParams:
    """One model's layers, checked against what the kernel takes and
    held in ``cfg.compute_dtype`` on one device, with the host tables
    (weight and bias pointers, (in, out) widths) a launch passes. The
    tables point into ``params``, which this object keeps alive."""

    __slots__ = ("params", "device", "counts", "w_ptrs", "b_ptrs", "dims")

    def __init__(self, params: Params, device: torch.device, counts):
        self.params = params
        self.device = device
        self.counts = counts  # layers per group: (enc, dec, cls)
        layers = [layer for g in _GROUPS for layer in params[g]]
        n = len(layers)
        self.w_ptrs = (ctypes.c_void_p * n)(
            *[layer["w"].data_ptr() for layer in layers])
        self.b_ptrs = (ctypes.c_void_p * n)(
            *[layer["b"].data_ptr() for layer in layers])
        self.dims = (ctypes.c_int * (2 * n))(
            *[d for layer in layers for d in layer["w"].shape])


def pack_params(params: Params,
                cfg: AnomalyModelConfig = AnomalyModelConfig()
                ) -> KernelParams:
    """Check ``params`` against ``cfg`` and the kernel's limits and cast
    the layers to ``cfg.compute_dtype`` (a copy only where they are in
    another dtype). Raises ``ValueError`` naming the first fault: a
    missing group, a layer that does not chain onto the one before, a
    width above ``MAX_WIDTH``, or tensors on more than one device."""
    if cfg.in_dim > MAX_WIDTH:
        raise ValueError(f"in_dim {cfg.in_dim} exceeds the kernel's "
                         f"{MAX_WIDTH}")
    dt = cfg.compute_dtype
    out: Params = {}
    device = None
    for group in _GROUPS:
        layers = params.get(group) or []
        if not layers:
            raise ValueError(f"params have no {group} layers")
        out[group] = []
        for i, layer in enumerate(layers):
            w, b = layer["w"], layer["b"]
            name = f"{group}[{i}]"
            if w.dim() != 2 or tuple(b.shape) != (w.shape[1],):
                raise ValueError(f"{name}: want w [in, out] and b [out], "
                                 f"got w {tuple(w.shape)} b {tuple(b.shape)}")
            if max(w.shape) > MAX_WIDTH:
                raise ValueError(f"{name}: width {tuple(w.shape)} exceeds "
                                 f"the kernel's {MAX_WIDTH}")
            device = w.device if device is None else device
            if w.device != device or b.device != device:
                raise ValueError(f"{name}: on {w.device}/{b.device}, the "
                                 f"first layer on {device}")
            out[group].append({"w": w.to(dt).contiguous(),
                               "b": b.to(dt).contiguous()})
    counts = tuple(len(out[g]) for g in _GROUPS)
    if sum(counts) > MAX_LAYERS:
        raise ValueError(f"{sum(counts)} layers exceed the kernel's "
                         f"{MAX_LAYERS}")
    z = out["enc"][-1]["w"].shape[1]
    for group, d_in, d_out in (("enc", cfg.in_dim, z),
                               ("dec", z, cfg.in_dim), ("cls", z, 1)):
        want = d_in
        for i, layer in enumerate(out[group]):
            got_in, got_out = layer["w"].shape
            if got_in != want:
                raise ValueError(f"{group}[{i}] takes {got_in} inputs, "
                                 f"the layer before gives {want}")
            want = got_out
        if want != d_out:
            raise ValueError(f"{group} ends in {want} outputs, want {d_out}")
    return KernelParams(out, device, counts)


def fused_anomaly_scores_plain(params: Params, x: torch.Tensor,
                               cfg: AnomalyModelConfig = AnomalyModelConfig(),
                               mu: Optional[torch.Tensor] = None,
                               var: Optional[torch.Tensor] = None,
                               ) -> torch.Tensor:
    """``x`` [n, D] -> scores [n], plain PyTorch (the kernel's reference)."""
    if mu is not None:
        x = normalize_features(x, mu, var)
    return anomaly_scores(params, x, cfg)


def _check_vec(name: str, t: torch.Tensor, size: int,
               device: torch.device) -> None:
    if t.device != device or t.dtype != torch.float32 \
            or not t.is_contiguous() or tuple(t.shape) != (size,):
        raise ValueError(
            f"{name}: want contiguous float32 [{size}] on {device}, got "
            f"{t.dtype} {tuple(t.shape)} on {t.device}")


def fused_anomaly_scores(params: Union[Params, KernelParams],
                         x: torch.Tensor,
                         cfg: AnomalyModelConfig = AnomalyModelConfig(),
                         mu: Optional[torch.Tensor] = None,
                         var: Optional[torch.Tensor] = None,
                         ) -> torch.Tensor:
    """Score ``x`` float32 [n, D] -> float32 [n] in one kernel launch.

    With ``mu``/``var`` the z-score is folded into the tile load.
    ``params`` is a model packed by ``pack_params`` for ``cfg`` (as the
    serving scorer holds it) or a plain params tree, which is packed
    for this call. Every launch adds one to
    ``fused_anomaly_scores.launches``.
    """
    if x.device.type == "cpu":
        if isinstance(params, KernelParams):
            params = params.params
        return fused_anomaly_scores_plain(params, x, cfg, mu, var)
    if x.device.type != "cuda":
        raise ValueError(f"fused_anomaly_scores: unsupported device {x.device}")
    if cfg.compute_dtype != torch.bfloat16:
        raise ValueError("the CUDA kernel computes in bfloat16 only, got "
                         f"compute_dtype={cfg.compute_dtype}")
    if x.dtype != torch.float32 or x.dim() != 2 or not x.is_contiguous() \
            or x.shape[1] != cfg.in_dim:
        raise ValueError(
            f"x: want contiguous float32 [n, {cfg.in_dim}], got {x.dtype} "
            f"{tuple(x.shape)} contiguous={x.is_contiguous()}")
    if (mu is None) != (var is None):
        raise ValueError("pass mu and var together")
    dev = x.device
    if mu is not None:
        _check_vec("mu", mu, cfg.in_dim, dev)
        _check_vec("var", var, cfg.in_dim, dev)
    kp = params if isinstance(params, KernelParams) else pack_params(
        params, cfg)
    if kp.device != dev:
        raise ValueError(f"params on {kp.device}, x on {dev}")

    n = x.shape[0]
    out = torch.empty(n, dtype=torch.float32, device=dev)
    if n == 0:
        return out  # a zero grid is an invalid launch
    fn = _kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(x.data_ptr(), n, cfg.in_dim,
                mu.data_ptr() if mu is not None else None,
                var.data_ptr() if var is not None else None,
                kp.w_ptrs, kp.b_ptrs, kp.dims, *kp.counts,
                cfg.recon_weight, 1.0 - cfg.recon_weight,
                out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"score_mlp launch failed: cudaError {rc}")
    fused_anomaly_scores.launches += 1
    return out


fused_anomaly_scores.launches = 0


def best_scorer(cfg: AnomalyModelConfig = AnomalyModelConfig()
                ) -> Callable[..., torch.Tensor]:
    """The serving step ``(params, x, mu=None, var=None) -> scores``:
    the fused kernel on CUDA tensors, its plain version on CPU ones."""

    def step(params: Union[Params, KernelParams], x: torch.Tensor,
             mu: Optional[torch.Tensor] = None,
             var: Optional[torch.Tensor] = None) -> torch.Tensor:
        return fused_anomaly_scores(params, x, cfg, mu, var)

    return step
