"""Model snapshots, their checkpoint codec and the versioned checkpoint
store, without JAX.

Byte-compatible with ``linkerd_tpu/lifecycle/store.py``: the same
snapshot encodes to the same bytes in both packages, either package
decodes the other's, and a store directory written by either loads in
the other. Wire format (one ``.ckpt`` file per version)::

    b"L5DCKPT1" | u32 header_len | header JSON | raw array payload | u32 crc

The CRC32 covers everything before it. Arrays are host numpy: params
in the reference layout (``w`` is ``[in, out]``), the optimizer state
as optax's flattened leaves, and the normalization stats. Files are
written to a temporary name and moved into place, so a crash mid-write
leaves no half checkpoint under a valid name; ``manifest.json``, also
replaced atomically, holds each version's lineage (parent), status
(candidate / promoted / rejected / rolled_back) and the retention.
"""

from __future__ import annotations

import dataclasses
import json
import os
import struct
import time
import zlib
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from linkerd_tpu_torch.models.anomaly import (
    AnomalyModelConfig, dtype_from_name, dtype_name,
)

MAGIC = b"L5DCKPT1"
MANIFEST = "manifest.json"
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


# -- versioned on-disk store --------------------------------------------------


@dataclass
class CheckpointMeta:
    version: int
    file: str
    crc: int
    step: int
    parent: Optional[int]
    status: str            # candidate | promoted | rejected | rolled_back
    created_at: float
    bytes: int
    # native weight-blob lineage, set when this version was exported to
    # the routers' in-data-plane scorer ({crc, quant, bytes, ...})
    native_blob: Optional[Dict[str, Any]] = None


class CheckpointStore:
    """Directory of versioned ``.ckpt`` files plus an atomic manifest.

    Retention keeps the newest ``retain`` versions, but never prunes the
    serving (last-promoted) version — the rollback target must survive
    any churn of rejected candidates.
    """

    def __init__(self, directory: str, retain: int = 5):
        if retain < 1:
            raise ValueError("retain must be >= 1")
        self.directory = directory
        self.retain = retain
        os.makedirs(directory, exist_ok=True)
        self._manifest = self._load_manifest()

    # -- manifest ---------------------------------------------------------
    @property
    def _manifest_path(self) -> str:
        return os.path.join(self.directory, MANIFEST)

    def _load_manifest(self) -> Dict[str, Any]:
        try:
            with open(self._manifest_path, "r", encoding="utf-8") as f:
                m = json.load(f)
        except FileNotFoundError:
            return {"format": FORMAT, "next_version": 1, "serving": None,
                    "pruned": [], "versions": []}
        except (OSError, json.JSONDecodeError) as e:
            raise CheckpointCorruptError(f"unreadable manifest: {e}") from e
        if m.get("format") != FORMAT:
            raise CheckpointError(
                f"unsupported manifest format {m.get('format')!r}")
        return m

    def _write_manifest(self) -> None:
        tmp = self._manifest_path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(self._manifest, f, indent=1)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._manifest_path)

    def _entries(self) -> List[CheckpointMeta]:
        return [CheckpointMeta(**e) for e in self._manifest["versions"]]

    def _entry(self, version: int) -> CheckpointMeta:
        for e in self._entries():
            if e.version == version:
                return e
        raise CheckpointError(f"unknown checkpoint version {version}")

    # -- write path -------------------------------------------------------
    def save(self, snap: ModelSnapshot, status: str = "candidate",
             parent: Optional[int] = None) -> int:
        version = self._manifest["next_version"]
        data = encode_snapshot(snap)
        crc = struct.unpack("<I", data[-4:])[0]
        fname = f"v{version:06d}.ckpt"
        path = os.path.join(self.directory, fname)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        self._manifest["versions"].append(dataclasses.asdict(CheckpointMeta(
            version=version, file=fname, crc=crc, step=int(snap.step),
            parent=parent, status=status, created_at=time.time(),
            bytes=len(data))))
        self._manifest["next_version"] = version + 1
        if status == "promoted":
            self._manifest["serving"] = version
        self._apply_retention()
        self._write_manifest()
        return version

    def record_native_blob(self, version: int,
                           meta: Optional[Dict[str, Any]]) -> None:
        """Annotate a checkpoint's manifest entry with the native
        weight blob exported from it: the manifest then carries the
        lineage from training state to the CRC'd bits the data-plane
        engines serve."""
        for e in self._manifest["versions"]:
            if e["version"] == version:
                e["native_blob"] = meta
                self._write_manifest()
                return
        raise CheckpointError(f"unknown checkpoint version {version}")

    def record_native_blob(self, version: int,
                           meta: Optional[Dict[str, Any]]) -> None:
        """Annotate a checkpoint's manifest entry with the native
        weight blob exported from it (lifecycle.export.blob_meta): the
        manifest then carries the full lineage from training state to
        the exact CRC'd bits the data-plane engines serve."""
        for e in self._manifest["versions"]:
            if e["version"] == version:
                e["native_blob"] = meta
                self._write_manifest()
                return
        raise CheckpointError(f"unknown checkpoint version {version}")

    def record_specialist(self, route_hash: int,
                          meta: Optional[Dict[str, Any]]) -> None:
        """Manifest lineage for one specialist head: ``meta`` records
        the dst path, head version, bank generation, the base
        checkpoint it was distilled from, and the published delta's
        CRC — or None to drop the entry (a single-route rollback).
        The manifest is then the full story of WHICH per-route bits
        the engines serve and where each head came from."""
        spec = self._manifest.setdefault("specialists", {})
        key = str(int(route_hash))
        if meta is None:
            if key not in spec:
                return
            del spec[key]
        else:
            spec[key] = meta
        self._write_manifest()

    def specialists(self) -> Dict[str, Any]:
        """{route_hash: head lineage meta} from the manifest."""
        return dict(self._manifest.get("specialists", {}))

    def mark(self, version: int, status: str) -> None:
        for e in self._manifest["versions"]:
            if e["version"] == version:
                e["status"] = status
                if status == "promoted":
                    self._manifest["serving"] = version
                self._write_manifest()
                return
        raise CheckpointError(f"unknown checkpoint version {version}")

    def _apply_retention(self) -> None:
        keep = self._manifest["serving"]
        entries = self._manifest["versions"]
        while len(entries) > self.retain:
            victim = next((e for e in entries if e["version"] != keep), None)
            if victim is None:
                return
            entries.remove(victim)
            self._manifest["pruned"].append(victim["version"])
            try:
                os.unlink(os.path.join(self.directory, victim["file"]))
            except FileNotFoundError:
                pass

    # -- read path --------------------------------------------------------
    def versions(self) -> List[CheckpointMeta]:
        return self._entries()

    def latest(self) -> Optional[int]:
        entries = self._entries()
        return max((e.version for e in entries), default=None)

    def latest_good(self) -> Optional[int]:
        """The serving (last-promoted) version; falls back to the newest
        checkpoint of any status when nothing was ever promoted."""
        serving = self._manifest["serving"]
        if serving is not None:
            return serving
        return self.latest()

    def load(self, version: Optional[int] = None) -> Tuple[int, ModelSnapshot]:
        if version is None:
            version = self.latest_good()
            if version is None:
                raise CheckpointError("empty checkpoint store")
        e = self._entry(version)
        path = os.path.join(self.directory, e.file)
        try:
            with open(path, "rb") as f:
                data = f.read()
        except FileNotFoundError:
            raise CheckpointCorruptError(
                f"checkpoint v{version} file missing: {e.file}") from None
        if len(data) >= 4 and struct.unpack("<I", data[-4:])[0] != e.crc:
            raise CheckpointCorruptError(
                f"checkpoint v{version}: file CRC does not match manifest")
        return version, decode_snapshot(data)

    # -- integrity --------------------------------------------------------
    def verify(self) -> List[str]:
        """Full-store integrity sweep: CRC of every file, manifest/file
        agreement, lineage, and orphaned files. Returns human-readable
        issues (empty = healthy)."""
        issues: List[str] = []
        known = {e.version for e in self._entries()}
        pruned = set(self._manifest["pruned"])
        listed_files = set()
        for e in self._entries():
            listed_files.add(e.file)
            path = os.path.join(self.directory, e.file)
            try:
                with open(path, "rb") as f:
                    data = f.read()
            except FileNotFoundError:
                issues.append(f"v{e.version}: file {e.file} missing")
                continue
            if len(data) < 4:
                issues.append(f"v{e.version}: file {e.file} truncated")
                continue
            if struct.unpack("<I", data[-4:])[0] != e.crc:
                issues.append(
                    f"v{e.version}: manifest CRC {e.crc:#010x} does not "
                    f"match file")
                continue
            try:
                decode_snapshot(data)
            except CheckpointError as exc:
                issues.append(f"v{e.version}: {exc}")
            if e.parent is not None and e.parent not in known \
                    and e.parent not in pruned:
                issues.append(
                    f"v{e.version}: parent v{e.parent} unknown "
                    f"(lineage break)")
        serving = self._manifest["serving"]
        if serving is not None and serving not in known:
            issues.append(f"serving version v{serving} not in manifest")
        for fname in os.listdir(self.directory):
            if fname.endswith(".ckpt") and fname not in listed_files:
                issues.append(f"orphaned checkpoint file: {fname}")
        return issues

    def status(self) -> Dict[str, Any]:
        return {
            "directory": self.directory,
            "serving": self._manifest["serving"],
            "retain": self.retain,
            "versions": [dataclasses.asdict(e) for e in self._entries()],
            "pruned": list(self._manifest["pruned"]),
            "specialists": self.specialists(),
        }
