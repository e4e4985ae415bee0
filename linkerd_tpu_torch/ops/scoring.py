"""Fused anomaly scoring: the hand-written CUDA kernel and its plain twin.

``fused_anomaly_scores`` replaces the Pallas kernel
``linkerd_tpu/ops/scoring.py::_score_kernel``. On a CUDA tensor it
launches ``csrc/score_mlp.cu`` (built on first use by ``_build``) or
raises; on a CPU tensor it runs ``fused_anomaly_scores_plain``, the same
function in plain PyTorch. There is no probe that falls back: a kernel
that does not build or launch is an error.

``pack_params`` checks a model against what the kernel takes and lays
it out for launches once (one buffer of zero-padded bf16 weights and
biases, in the order the kernel streams them, and a table of where each
layer sits); a server packs each model when it places it and every
launch then only passes a pointer and the table.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, List, NamedTuple, Optional, Tuple, Union

import torch

from linkerd_tpu_torch.models.anomaly import (
    AnomalyModelConfig, Params, anomaly_scores, normalize_features,
)
from linkerd_tpu_torch.ops import _build

_GROUPS = ("enc", "dec", "cls")
# mirrors of csrc/score_mlp.cu (tests/test_torch_ops.py holds them equal)
MAX_WIDTH = 256   # MAXW: widest layer and in_dim
MAX_LAYERS = 16   # MAX_LAYERS
ROWS_PER_BLOCK = 16  # ROWS: rows a block owns
RELU, LOGIT = 1, 2  # layer flags


@functools.cache
def _kernel() -> Callable[..., int]:
    """``score_mlp_forward`` of ``csrc/score_mlp.cu``, built on first use."""
    fn = _build.load("score_mlp").score_mlp_forward
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [p, i, i, p, p, p, p, i, i, f, f, p, p]
    fn.restype = ctypes.c_int
    return fn


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


class PackedLayer(NamedTuple):
    """Where one layer sits in ``KernelParams.packed`` (offsets in
    elements) and which activation buffers (0..2) it reads and writes."""
    group: str
    index: int
    k: int          # the model's own (in, out) widths
    n: int
    kpad: int       # k padded to the mma depth, 16
    npad: int       # n padded to the mma width, 8
    wstride: int    # row stride of the padded [kpad, wstride] weights
    w_off: int
    b_off: int
    in_buf: int
    out_buf: int
    flags: int

    def row(self) -> Tuple[int, ...]:
        """The layer's entry of the kernel's table."""
        return (self.w_off, self.b_off, self.kpad, self.npad, self.wstride,
                self.in_buf, self.out_buf, self.flags)


def _weight_stride(npad: int) -> int:
    """An odd number of 16-byte units, so that ldmatrix's eight rows of
    a weight tile fall in eight distinct bank groups."""
    return npad if (npad // 8) % 2 else npad + 8


def _layout(params: Params) -> Tuple[List[PackedLayer], int, int]:
    """The packed layout in execution order (encoder, classifier,
    decoder): the biases first, each padded to ``npad``, then each
    layer's weights as ``[kpad, wstride]``. The encoder ping-pongs
    through buffers 1 and 2 from the input in 0; the classifier and
    then the decoder read z and ping-pong through the two buffers z is
    not in. Returns the layers, the bias length and the total length."""
    layers: List[PackedLayer] = []
    order = [("enc", params["enc"]), ("cls", params["cls"]),
             ("dec", params["dec"])]
    shapes = [(g, i, *layer["w"].shape) for g, group in order
              for i, layer in enumerate(group)]
    bias_len = sum(_round_up(n, 8) for *_, n in shapes)
    b_off, w_off = 0, bias_len
    n_enc = len(params["enc"])
    z = 1 + (n_enc - 1) % 2
    other = [b for b in (0, 1, 2) if b != z]
    for g, i, k, n in shapes:
        kpad, npad = _round_up(k, 16), _round_up(n, 8)
        wstride = _weight_stride(npad)
        if g == "enc":
            in_buf = 0 if i == 0 else 1 + (i - 1) % 2
            out_buf, flags = 1 + i % 2, RELU
        else:
            last = i == len(params[g]) - 1
            in_buf = z if i == 0 else other[(i - 1) % 2]
            out_buf = other[i % 2]
            flags = (0 if last else RELU) | (LOGIT if g == "cls" and last
                                             else 0)
        layers.append(PackedLayer(g, i, k, n, kpad, npad, wstride, w_off,
                                  b_off, in_buf, out_buf, flags))
        b_off += npad
        w_off += kpad * wstride
    return layers, bias_len, w_off


class KernelParams:
    """One model's layers, checked against what the kernel takes and
    held in ``cfg.compute_dtype`` on one device (``params``, unpadded,
    and ``dims``, their (in, out) widths in group order), and the
    layout a launch passes: ``packed``, one bf16 buffer of the biases
    and the zero-padded weights in execution order, with ``layers`` and
    ``table`` saying where each layer sits."""

    __slots__ = ("params", "device", "counts", "dims", "layers", "bias_len",
                 "packed", "table")

    def __init__(self, params: Params, device: torch.device, counts):
        self.params = params
        self.device = device
        self.counts = counts  # layers per group: (enc, dec, cls)
        self.dims = tuple(d for g in _GROUPS for layer in params[g]
                          for d in layer["w"].shape)
        self.layers, self.bias_len, total = _layout(params)
        packed = torch.zeros(total, dtype=torch.bfloat16, device=device)
        for pl in self.layers:
            layer = params[pl.group][pl.index]
            packed[pl.b_off:pl.b_off + pl.n] = layer["b"]
            packed[pl.w_off:pl.w_off + pl.kpad * pl.wstride].view(
                pl.kpad, pl.wstride)[:pl.k, :pl.n] = layer["w"]
        self.packed = packed
        self.table = (ctypes.c_int * (8 * len(self.layers)))(
            *[v for pl in self.layers for v in pl.row()])


def pack_params(params: Params,
                cfg: AnomalyModelConfig = AnomalyModelConfig()
                ) -> KernelParams:
    """Check ``params`` against ``cfg`` and the kernel's limits, cast
    the layers to ``cfg.compute_dtype`` (a copy only where they are in
    another dtype) and lay them out for the kernel. Raises
    ``ValueError`` naming the first fault: a missing group, a layer
    that does not chain onto the one before, a width above
    ``MAX_WIDTH``, or tensors on more than one device."""
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
                kp.packed.data_ptr(), kp.table, len(kp.layers),
                kp.bias_len, cfg.recon_weight, 1.0 - cfg.recon_weight,
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
