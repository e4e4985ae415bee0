"""Model snapshots and their checkpoint codec, without JAX.

Byte-compatible with ``linkerd_tpu/lifecycle/store.py``: the same
snapshot encodes to the same bytes in both packages, and either
package decodes the other's. Wire format::

    b"L5DCKPT1" | u32 header_len | header JSON | raw array payload | u32 crc

The CRC32 covers everything before it. Arrays are host numpy: params
in the reference layout (``w`` is ``[in, out]``), the optimizer state
as optax's flattened leaves, and the normalization stats.
"""

from __future__ import annotations

import json
import struct
import zlib
from dataclasses import dataclass
from typing import Any, Dict, List

import numpy as np

from linkerd_tpu_torch.models.anomaly import (
    AnomalyModelConfig, dtype_from_name, dtype_name,
)

MAGIC = b"L5DCKPT1"
FORMAT = 1


class CheckpointError(Exception):
    """Base for checkpoint failures."""


class CheckpointCorruptError(CheckpointError):
    """CRC mismatch, bad magic, or a truncated checkpoint."""


def _cfg_to_dict(cfg: AnomalyModelConfig) -> Dict[str, Any]:
    """Config -> JSON-safe dict, keys in the reference's order."""
    return {
        "in_dim": cfg.in_dim,
        "enc_dims": list(cfg.enc_dims),
        "bottleneck": cfg.bottleneck,
        "cls_hidden": cfg.cls_hidden,
        "compute_dtype": dtype_name(cfg.compute_dtype),
        "recon_weight": cfg.recon_weight,
    }


def _cfg_from_dict(d: Dict[str, Any]) -> AnomalyModelConfig:
    return AnomalyModelConfig(
        in_dim=int(d["in_dim"]),
        enc_dims=tuple(int(v) for v in d["enc_dims"]),
        bottleneck=int(d["bottleneck"]),
        cls_hidden=int(d["cls_hidden"]),
        compute_dtype=dtype_from_name(d["compute_dtype"]),
        recon_weight=float(d["recon_weight"]),
    )


@dataclass
class ModelSnapshot:
    """Host-side (numpy) capture of one scorer's full state."""

    params: Any                      # dict/list tree of np.ndarray
    opt_leaves: List[np.ndarray]     # optax adam state, flattened
    mu: np.ndarray                   # feature-normalization running mean
    var: np.ndarray                  # feature-normalization running var
    norm_initialized: bool
    step: int                        # cumulative train steps
    cfg: AnomalyModelConfig

    def cfg_dict(self) -> Dict[str, Any]:
        return _cfg_to_dict(self.cfg)


def _flatten_tree(tree: Any, prefix: str, out: Dict[str, np.ndarray]) -> None:
    if isinstance(tree, dict):
        for k in sorted(tree):
            _flatten_tree(tree[k], f"{prefix}.{k}" if prefix else str(k), out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten_tree(v, f"{prefix}.{i}" if prefix else str(i), out)
    else:
        out[prefix] = np.asarray(tree)


def _unflatten_tree(flat: Dict[str, np.ndarray]) -> Any:
    """Rebuild the nested dict/list tree from dotted paths; all-digit
    segments become list indices."""
    root: Dict[str, Any] = {}
    for path, arr in flat.items():
        parts = path.split(".")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr

    def materialize(node: Any) -> Any:
        if not isinstance(node, dict):
            return node
        keys = list(node)
        if keys and all(k.isdigit() for k in keys):
            return [materialize(node[str(i)]) for i in range(len(keys))]
        return {k: materialize(v) for k, v in node.items()}

    return materialize(root)


def _np_dtype(name: str, key: str) -> np.dtype:
    # numpy's own numeric types only: bfloat16 and the other ml_dtypes
    # types are named by numpy only once ml_dtypes is loaded, and the
    # scorer's checkpoints hold float32 and int32 arrays
    try:
        dt = np.dtype(name)
    except TypeError:
        dt = None
    if dt is None or dt.kind not in "biuf":
        raise CheckpointError(
            f"checkpoint array {key!r} has dtype {name!r}, which this "
            f"package does not decode (numpy numeric dtypes only)")
    return dt


def encode_snapshot(snap: ModelSnapshot) -> bytes:
    arrays: Dict[str, np.ndarray] = {}
    _flatten_tree(snap.params, "params", arrays)
    for i, leaf in enumerate(snap.opt_leaves):
        arrays[f"opt.{i}"] = np.asarray(leaf)
    arrays["norm.mu"] = np.asarray(snap.mu, np.float32)
    arrays["norm.var"] = np.asarray(snap.var, np.float32)

    manifest = []
    chunks = []
    for key, arr in arrays.items():
        raw = np.ascontiguousarray(arr).tobytes()
        manifest.append({"key": key, "dtype": arr.dtype.name,
                         "shape": list(arr.shape), "nbytes": len(raw)})
        chunks.append(raw)
    header = json.dumps({
        "format": FORMAT,
        "step": int(snap.step),
        "norm_initialized": bool(snap.norm_initialized),
        "cfg": snap.cfg_dict(),
        "arrays": manifest,
    }).encode()
    body = MAGIC + struct.pack("<I", len(header)) + header + b"".join(chunks)
    return body + struct.pack("<I", zlib.crc32(body))


def decode_snapshot(data: bytes) -> ModelSnapshot:
    if len(data) < len(MAGIC) + 8 or not data.startswith(MAGIC):
        raise CheckpointCorruptError("bad checkpoint magic or truncated file")
    body, (crc,) = data[:-4], struct.unpack("<I", data[-4:])
    if zlib.crc32(body) != crc:
        raise CheckpointCorruptError(
            f"checkpoint CRC mismatch (stored {crc:#010x}, "
            f"computed {zlib.crc32(body):#010x})")
    (hlen,) = struct.unpack_from("<I", body, len(MAGIC))
    hoff = len(MAGIC) + 4
    header = json.loads(body[hoff:hoff + hlen].decode())
    if header.get("format") != FORMAT:
        raise CheckpointError(
            f"unsupported checkpoint format {header.get('format')!r}")
    off = hoff + hlen
    arrays: Dict[str, np.ndarray] = {}
    for m in header["arrays"]:
        dt = _np_dtype(m["dtype"], m["key"])
        n = m["nbytes"]
        if off + n > len(body):
            raise CheckpointCorruptError("checkpoint payload truncated")
        arrays[m["key"]] = np.frombuffer(
            body, dt, n // dt.itemsize, off).reshape(m["shape"]).copy()
        off += n

    params_flat = {k[len("params."):]: v for k, v in arrays.items()
                   if k.startswith("params.")}
    opt_keys = sorted((k for k in arrays if k.startswith("opt.")),
                      key=lambda k: int(k.split(".", 1)[1]))
    return ModelSnapshot(
        params=_unflatten_tree(params_flat),
        opt_leaves=[arrays[k] for k in opt_keys],
        mu=arrays["norm.mu"],
        var=arrays["norm.var"],
        norm_initialized=header["norm_initialized"],
        step=header["step"],
        cfg=_cfg_from_dict(header["cfg"]),
    )
