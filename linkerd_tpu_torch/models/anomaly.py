"""Autoencoder + MLP-classifier anomaly model, plain PyTorch.

Counterpart of ``linkerd_tpu/models/anomaly.py``. Parameters keep the
reference layout, a dict of lists of ``{"w": [in, out], "b": [out]}``
tensors under ``"enc"``, ``"dec"`` and ``"cls"``, so checkpoints and
the native weight blobs read the same arrays in both packages.

These functions are the plain versions the fused CUDA kernel
(``ops/scoring.py``) is held against. They round where the reference
rounds: each layer takes the float32 sum of ``compute_dtype`` products,
rounds it to ``compute_dtype``, then adds the ``compute_dtype`` bias.
With ``exact_sums`` the sum is taken in float64 and then rounded to
float32: every bf16 or float32 product is exact in float64, and so is
the sum of a layer's products unless their magnitudes span more than
about 2^37, so the result is the correctly rounded float32 sum whatever
the order. A float32 sum depends on its order (the XLA dot's, torch's
GEMM's, the tensor cores'), and now and then a bf16 activation then
tips to its neighbour; the kernel and its plain version both take exact
sums and so agree activation for activation.
``loss_fn`` is the training objective; autograd carries its gradients
through the casts to the float32 parameters, as JAX's ``astype`` does.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from linkerd_tpu_torch import DeviceLike, resolve_device
from linkerd_tpu_torch.models.features import FEATURE_DIM

Params = Dict[str, List[Dict[str, torch.Tensor]]]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def dtype_name(dtype: torch.dtype) -> str:
    """``torch.bfloat16`` -> ``"bfloat16"``, the name checkpoints carry."""
    return str(dtype).removeprefix("torch.")


def dtype_from_name(name: str) -> torch.dtype:
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported compute dtype {name!r}") from None


@dataclass(frozen=True)
class AnomalyModelConfig:
    in_dim: int = FEATURE_DIM
    enc_dims: Tuple[int, ...] = (256, 128)
    bottleneck: int = 32
    cls_hidden: int = 128
    compute_dtype: Any = torch.bfloat16
    # blend of normalized reconstruction error vs classifier probability
    recon_weight: float = 0.5


def layer_dims(cfg: AnomalyModelConfig) -> Dict[str, List[Tuple[int, int]]]:
    """(in, out) of every dense layer, by group."""
    enc = (cfg.in_dim,) + tuple(cfg.enc_dims) + (cfg.bottleneck,)
    dec = tuple(reversed(enc))
    return {
        "enc": list(zip(enc[:-1], enc[1:])),
        "dec": list(zip(dec[:-1], dec[1:])),
        "cls": [(cfg.bottleneck, cfg.cls_hidden), (cfg.cls_hidden, 1)],
    }


def init_params(seed: int, cfg: AnomalyModelConfig = AnomalyModelConfig(),
                device: DeviceLike = None) -> Params:
    """He-normal weights and zero biases, drawn from
    ``numpy.random.default_rng(seed)``. The JAX package draws from
    ``jax.random``, so the same seed gives other numbers there; tests
    carry weights across with ``models.convert``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    params: Params = {}
    for group, dims in layer_dims(cfg).items():
        params[group] = []
        for d_in, d_out in dims:
            w = rng.standard_normal((d_in, d_out)) * math.sqrt(2.0 / d_in)
            params[group].append({
                "w": torch.tensor(w, dtype=torch.float32, device=dev),
                "b": torch.zeros(d_out, dtype=torch.float32, device=dev),
            })
    return params


def normalize_features(x: torch.Tensor, mu: torch.Tensor,
                       var: torch.Tensor) -> torch.Tensor:
    """z-scores with the reference's soft variance floor of 1e-2."""
    return (x - mu) * torch.rsqrt(var + 1e-2)


def _dense(h: torch.Tensor, layer: Dict[str, torch.Tensor],
           dt: torch.dtype, exact_sums: bool = False) -> torch.Tensor:
    # float32 sum of dt x dt products (float64 rounded to float32 with
    # exact_sums), rounded to dt, plus the dt bias
    w = layer["w"].to(dt)
    if exact_sums:
        y = (h.double() @ w.double()).float().to(dt)
    else:
        y = (h.float() @ w.float()).to(dt)
    return y + layer["b"].to(dt)


def _mlp(layers, h: torch.Tensor, dt: torch.dtype,
         final_act: bool, exact_sums: bool = False) -> torch.Tensor:
    n = len(layers)
    for i, layer in enumerate(layers):
        h = _dense(h, layer, dt, exact_sums)
        if final_act or i < n - 1:
            h = torch.relu(h)
    return h


def apply_model(params: Params, x: torch.Tensor,
                cfg: AnomalyModelConfig = AnomalyModelConfig(),
                exact_sums: bool = False,
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Forward pass -> ``(recon [B, D], z [B, Z], logits [B])``, float32."""
    dt = cfg.compute_dtype
    h = x.to(dt)
    z = _mlp(params["enc"], h, dt, True, exact_sums)
    recon = _mlp(params["dec"], z, dt, False, exact_sums)
    logits = _mlp(params["cls"], z, dt, False, exact_sums)[..., 0]
    return recon.float(), z.float(), logits.float()


def anomaly_scores(params: Params, x: torch.Tensor,
                   cfg: AnomalyModelConfig = AnomalyModelConfig(),
                   exact_sums: bool = False) -> torch.Tensor:
    """Blended anomaly score in [0, 1] per row: tanh-squashed
    reconstruction MSE (against the float32 input) blended with the
    classifier probability."""
    recon, _, logits = apply_model(params, x, cfg, exact_sums)
    err = torch.mean(torch.square(recon - x.float()), dim=-1)
    return (cfg.recon_weight * torch.tanh(err)
            + (1.0 - cfg.recon_weight) * torch.sigmoid(logits))


def loss_fn(params: Params, x: torch.Tensor, labels: torch.Tensor,
            label_mask: torch.Tensor,
            cfg: AnomalyModelConfig = AnomalyModelConfig(),
            row_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Reconstruction MSE plus the masked BCE of the labeled rows.

    ``labels`` in {0, 1}, ``label_mask`` 1.0 where a row is labeled.
    ``row_mask`` (1.0 = real row) drops padding rows from both terms;
    None means every row is real. The BCE is
    ``optax.sigmoid_binary_cross_entropy``'s, and each denominator is at
    least 1, as in the reference."""
    recon, _, logits = apply_model(params, x, cfg)
    sq = torch.mean(torch.square(recon - x.float()), dim=-1)
    if row_mask is None:
        recon_loss = torch.mean(sq)
    else:
        recon_loss = (torch.sum(sq * row_mask)
                      / torch.clamp(torch.sum(row_mask), min=1.0))
        label_mask = label_mask * row_mask
    bce = F.binary_cross_entropy_with_logits(logits, labels,
                                             reduction="none")
    denom = torch.clamp(torch.sum(label_mask), min=1.0)
    return recon_loss + torch.sum(bce * label_mask) / denom
