"""Native weight-blob export: a copy of ``linkerd_tpu/lifecycle/export.py``.

``export_weight_blob`` turns a ``ModelSnapshot`` (the same host-side
capture the CheckpointStore persists) into the versioned flat blob the
native engines evaluate in the data plane (``native/scorer.h``). The
same snapshot exports to the same bytes in both packages. A "model
section" is the quant-tagged dense stack:

    u32 version | u32 quant (0=f32, 1=int8, 2=int4)
    | u32 in_dim | u32 n_enc | u32 n_dec | u32 n_cls | f32 recon_weight
    | f32 mu[in_dim] | f32 var[in_dim]
    | per layer (enc..., dec..., cls...):
        u32 rows | u32 cols | f32 b[cols]
        | quant 0: f32 w[rows*cols]   (row-major: w[i][j] = in i -> out j)
        | quant 1: f32 scale[cols] | i8 w[rows*cols]
        | quant 2: f32 scale[cols] | u8 packed[(rows*cols+1)//2]
                   (two 4-bit two's-complement weights per byte, low
                   nibble first, row-major, values in [-7, 7])

Three blob kinds share it, each tailed by u32 crc32 (zlib, over
everything before it):

    "L5DWTS01" | <model section> | crc          — one global model
    "L5DWTS02" | u32 generation | u32 n_heads
               | <model section>                — the base model
               | per head (route_hash ascending):
                   u32 route_hash | <model section>
               | crc                            — specialist bank
    "L5DWTD01" | u32 base_generation | u32 new_generation | u32 n_ops
               | per op: u32 op (0=upsert, 1=remove) | u32 route_hash
                         | upsert: <model section>
               | crc                            — per-route delta patch

int8/int4 quantization is symmetric per OUTPUT column — scale[j] =
max|w[:, j]| / 127 (or / 7) — with f32 biases and f32 accumulation on
the C++ side, so the error stays a per-weight rounding effect. A
flipped bit fails the CRC and the publish is rejected. Deltas carry a
generation fence: the engine refuses a patch whose base_generation is
not the generation of its ACTIVE bank.

Everything here is host numpy on a snapshot already on the host: the
export runs at promote time next to the serving loop and never touches
the device.
"""

from __future__ import annotations

import struct
import zlib
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np

WEIGHT_MAGIC = b"L5DWTS01"
BANK_MAGIC = b"L5DWTS02"
DELTA_MAGIC = b"L5DWTD01"
QUANT_F32 = 0
QUANT_INT8 = 1
QUANT_INT4 = 2
_QUANTS = {"f32": QUANT_F32, "int8": QUANT_INT8, "int4": QUANT_INT4}
_QUANT_NAMES = {v: k for k, v in _QUANTS.items()}
DELTA_OP_UPSERT = 0
DELTA_OP_REMOVE = 1
MAX_HEADS = 256      # must match l5dscore::MAX_HEADS
MAX_DELTA_OPS = 64   # must match l5dscore::MAX_DELTA_OPS


def route_hash(dst_path: str) -> int:
    """FNV-1a 32-bit of a dst path — the specialist-bank head key. The
    same function (and fold-0-to-1 rule) as the engines' tenant/route
    hashing (``l5dtg::tenant_hash``; parity-pinned): hash 0 means "no
    head pushed" in the engine, so a real path hashing to 0 folds to 1.
    """
    h = 2166136261
    for b in dst_path.encode("utf-8", "surrogateescape"):
        h ^= b
        h = (h * 16777619) & 0xFFFFFFFF
    return h if h != 0 else 1


def _f32(arr) -> np.ndarray:
    return np.ascontiguousarray(arr, dtype=np.float32)


def _layer_chunks(layer: Dict[str, Any], quant: int) -> List[bytes]:
    w = _f32(layer["w"])
    b = _f32(layer["b"])
    if w.ndim != 2 or b.ndim != 1 or w.shape[1] != b.shape[0]:
        raise ValueError(
            f"layer shapes do not form a dense layer: w {w.shape}, "
            f"b {b.shape}")
    rows, cols = w.shape
    out = [struct.pack("<II", rows, cols), b.tobytes()]
    if quant == QUANT_F32:
        out.append(w.tobytes())
    elif quant == QUANT_INT8:
        scale = np.abs(w).max(axis=0) / 127.0
        scale = np.where(scale > 0, scale, 1.0).astype(np.float32)
        wq = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
        out.append(_f32(scale).tobytes())
        out.append(np.ascontiguousarray(wq).tobytes())
    else:  # int4: two's-complement nibbles packed two per byte
        scale = np.abs(w).max(axis=0) / 7.0
        scale = np.where(scale > 0, scale, 1.0).astype(np.float32)
        wq = np.clip(np.round(w / scale), -7, 7).astype(np.int8)
        flat = wq.reshape(-1)
        if len(flat) % 2:
            flat = np.concatenate([flat, np.zeros(1, np.int8)])
        lo = flat[0::2].astype(np.uint8) & 0x0F
        hi = (flat[1::2].astype(np.uint8) & 0x0F) << 4
        out.append(_f32(scale).tobytes())
        out.append(np.ascontiguousarray(lo | hi).tobytes())
    return out


def _model_section(snap, version: int, quant: str) -> List[bytes]:
    """One model section (version through layers) as byte chunks."""
    if quant not in _QUANTS:
        raise ValueError(f"quant must be one of {sorted(_QUANTS)}, "
                         f"got {quant!r}")
    q = _QUANTS[quant]
    params = snap.params
    enc = list(params["enc"])
    dec = list(params["dec"])
    cls = list(params["cls"])
    if not enc or not dec or not cls:
        raise ValueError("snapshot params missing enc/dec/cls layers")
    mu = _f32(snap.mu)
    var = _f32(snap.var)
    in_dim = int(np.asarray(params["enc"][0]["w"]).shape[0])
    if mu.shape != (in_dim,) or var.shape != (in_dim,):
        raise ValueError(
            f"normalization stats ({mu.shape}/{var.shape}) do not match "
            f"in_dim {in_dim}")
    chunks = [
        struct.pack("<IIIIII", int(version), q, in_dim,
                    len(enc), len(dec), len(cls)),
        struct.pack("<f", float(snap.cfg.recon_weight)),
        mu.tobytes(),
        var.tobytes(),
    ]
    for layer in enc + dec + cls:
        chunks.extend(_layer_chunks(layer, q))
    return chunks


def _sealed(chunks: List[bytes]) -> bytes:
    body = b"".join(chunks)
    return body + struct.pack("<I", zlib.crc32(body))


def export_weight_blob(snap, version: int, quant: str = "f32") -> bytes:
    """``ModelSnapshot`` -> native v1 weight blob (bytes, CRC'd).

    ``version`` stamps the blob (the checkpoint version on a lifecycle
    publish, the train step otherwise) so /model.json and the engine
    stats can prove WHICH model the data plane is serving.
    """
    return _sealed([WEIGHT_MAGIC] + _model_section(snap, version, quant))


def export_bank_blob(base_snap, base_version: int, generation: int,
                     heads: Dict[int, Tuple[int, Any]],
                     quant: str = "f32") -> bytes:
    """Base model + specialist heads -> native v2 bank blob.

    ``heads`` maps route_hash -> (head_version, head ModelSnapshot);
    the wire format requires ascending hashes, so they are sorted here.
    ``generation`` is the bank's fence for later delta patches.
    """
    if len(heads) > MAX_HEADS:
        raise ValueError(
            f"bank carries {len(heads)} heads; the native evaluator "
            f"caps at {MAX_HEADS}")
    chunks = [BANK_MAGIC,
              struct.pack("<II", int(generation), len(heads))]
    chunks.extend(_model_section(base_snap, base_version, quant))
    for rh in sorted(heads):
        if not 0 < rh <= 0xFFFFFFFF:
            raise ValueError(f"route hash out of range: {rh}")
        head_version, head_snap = heads[rh]
        chunks.append(struct.pack("<I", rh))
        chunks.extend(_model_section(head_snap, head_version, quant))
    return _sealed(chunks)


def export_delta_blob(base_generation: int, new_generation: int,
                      upserts: Optional[Dict[int, Tuple[int, Any]]] = None,
                      removes: Iterable[int] = (),
                      quant: str = "f32") -> bytes:
    """Per-route delta patch -> native delta blob.

    ``upserts`` maps route_hash -> (head_version, head ModelSnapshot);
    ``removes`` names heads to drop (a single-route rollback). The
    engine applies the patch only when its active bank's generation is
    ``base_generation`` — a patch can never land on the wrong bank.
    """
    upserts = upserts or {}
    removes = list(removes)
    n_ops = len(upserts) + len(removes)
    if n_ops < 1:
        raise ValueError("delta blob needs at least one op")
    if n_ops > MAX_DELTA_OPS:
        raise ValueError(
            f"delta carries {n_ops} ops; the native evaluator caps at "
            f"{MAX_DELTA_OPS}")
    if int(new_generation) <= int(base_generation):
        raise ValueError(
            f"new_generation ({new_generation}) must exceed "
            f"base_generation ({base_generation})")
    chunks = [DELTA_MAGIC,
              struct.pack("<III", int(base_generation),
                          int(new_generation), n_ops)]
    for rh in sorted(upserts):
        head_version, head_snap = upserts[rh]
        chunks.append(struct.pack("<II", DELTA_OP_UPSERT, rh))
        chunks.extend(_model_section(head_snap, head_version, quant))
    for rh in removes:
        chunks.append(struct.pack("<II", DELTA_OP_REMOVE, int(rh)))
    return _sealed(chunks)


def blob_meta(blob: bytes) -> Optional[Dict[str, Any]]:
    """Header + CRC of an exported blob (v1 model, v2 bank, or delta),
    without the native lib (the telemeter records this for
    /model.json). None on a malformed blob.
    """
    if len(blob) < 8 + 4:
        return None
    body, (crc,) = blob[:-4], struct.unpack("<I", blob[-4:])
    if zlib.crc32(body) != crc:
        return None
    if blob.startswith(DELTA_MAGIC):
        if len(blob) < 8 + 12 + 4:
            return None
        base_gen, new_gen, n_ops = struct.unpack_from("<III", blob, 8)
        return {
            "format": "delta",
            "base_generation": int(base_gen),
            "new_generation": int(new_gen),
            "ops": int(n_ops),
            "crc": int(crc),
            "bytes": len(blob),
        }
    if blob.startswith(BANK_MAGIC):
        if len(blob) < 8 + 8 + 28 + 4:
            return None
        generation, n_heads = struct.unpack_from("<II", blob, 8)
        version, q, in_dim, n_enc, n_dec, n_cls = struct.unpack_from(
            "<IIIIII", blob, 16)
        return {
            "format": "bank",
            "generation": int(generation),
            "heads": int(n_heads),
            "version": int(version),
            "crc": int(crc),
            "quant": _QUANT_NAMES.get(int(q), "?"),
            "in_dim": int(in_dim),
            "layers": int(n_enc + n_dec + n_cls),
            "bytes": len(blob),
        }
    if len(blob) < len(WEIGHT_MAGIC) + 28 + 4 \
            or not blob.startswith(WEIGHT_MAGIC):
        return None
    version, q, in_dim, n_enc, n_dec, n_cls = struct.unpack_from(
        "<IIIIII", blob, len(WEIGHT_MAGIC))
    return {
        "format": "model",
        "version": int(version),
        "crc": int(crc),
        "quant": _QUANT_NAMES.get(int(q), "?"),
        "in_dim": int(in_dim),
        "layers": int(n_enc + n_dec + n_cls),
        "bytes": len(blob),
    }
