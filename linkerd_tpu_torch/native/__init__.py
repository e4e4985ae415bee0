"""ctypes binding of the native engine: counterpart of
``linkerd_tpu/native/__init__.py`` for the HTTP/1.1 engine with one
worker and the in-data-plane scorer.

The library is built from the repository's ``native/`` sources by
``_build`` at first use. There is no pure-Python fallback: a build or
load failure raises, and a caller that cannot serve without the engine
(a ``fastPath: true`` router) reports it as a configuration error.
"""

from __future__ import annotations

import ctypes
import json
import logging
import threading
from typing import List, Optional, Tuple

import numpy as np

from linkerd_tpu_torch.native import _build

log = logging.getLogger(__name__)

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def lib() -> ctypes.CDLL:
    """The loaded engine library, built first if needed. Raises
    ``RuntimeError`` when it cannot be built, ``OSError`` or
    ``AttributeError`` when it cannot be loaded. The build shells out to
    ``g++``: call it at startup (``ensure_built``), never from a path an
    event loop serves."""
    global _lib
    with _lock:
        if _lib is None:
            cdll = ctypes.CDLL(str(_build.build()))
            _declare_fastpath(cdll)
            _declare_scorer(cdll)
            _lib = cdll
        return _lib


def ensure_built() -> bool:
    """Build and load the library (raising on failure); True once it is
    loaded."""
    lib()
    return True


def _declare_scorer(cdll: ctypes.CDLL) -> None:
    """Engine-independent in-data-plane scorer exports (l5d_score_* /
    l5d_slab_*) plus the HTTP/1.1 engine's publish/feature hooks."""
    cdll.l5d_score_feature_dim.restype = ctypes.c_int
    cdll.l5d_score_feature_dim.argtypes = []
    cdll.l5d_score_blob_info.restype = ctypes.c_long
    cdll.l5d_score_blob_info.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p,
        ctypes.c_size_t]
    cdll.l5d_score_eval.restype = ctypes.c_long
    cdll.l5d_score_eval.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_float), ctypes.c_long, ctypes.c_long,
        ctypes.POINTER(ctypes.c_float), ctypes.c_char_p, ctypes.c_size_t]
    cdll.l5d_score_eval_route.restype = ctypes.c_long
    cdll.l5d_score_eval_route.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_uint32,
        ctypes.POINTER(ctypes.c_float), ctypes.c_long, ctypes.c_long,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_char_p, ctypes.c_size_t]
    cdll.l5d_slab_create.restype = ctypes.c_void_p
    cdll.l5d_slab_create.argtypes = []
    cdll.l5d_slab_publish.restype = ctypes.c_int
    cdll.l5d_slab_publish.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t,
        ctypes.c_char_p, ctypes.c_size_t]
    cdll.l5d_slab_publish_delta.restype = ctypes.c_int
    cdll.l5d_slab_publish_delta.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t,
        ctypes.c_char_p, ctypes.c_size_t]
    cdll.l5d_slab_score.restype = ctypes.c_long
    cdll.l5d_slab_score.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_long,
        ctypes.POINTER(ctypes.c_float)]
    cdll.l5d_slab_score_route.restype = ctypes.c_long
    cdll.l5d_slab_score_route.argtypes = [
        ctypes.c_void_p, ctypes.c_uint32,
        ctypes.POINTER(ctypes.c_float), ctypes.c_long,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32)]
    cdll.l5d_slab_stats.restype = ctypes.c_long
    cdll.l5d_slab_stats.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t]
    cdll.l5d_slab_free.restype = None
    cdll.l5d_slab_free.argtypes = [ctypes.c_void_p]
    cdll.fp_publish_weights.restype = ctypes.c_int
    cdll.fp_publish_weights.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t,
        ctypes.c_char_p, ctypes.c_size_t]
    cdll.fp_publish_delta.restype = ctypes.c_int
    cdll.fp_publish_delta.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t,
        ctypes.c_char_p, ctypes.c_size_t]
    cdll.fp_set_route_feature.restype = ctypes.c_int
    cdll.fp_set_route_feature.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_float]
    cdll.fp_set_route_hash.restype = ctypes.c_int
    cdll.fp_set_route_hash.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint32]


def _declare_fastpath(cdll: ctypes.CDLL) -> None:
    cdll.fp_create.restype = ctypes.c_void_p
    cdll.fp_create.argtypes = []
    cdll.fp_start.restype = ctypes.c_int
    cdll.fp_start.argtypes = [ctypes.c_void_p]
    cdll.fp_listen.restype = ctypes.c_int
    cdll.fp_listen.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                               ctypes.c_int]
    cdll.fp_set_route.restype = ctypes.c_int
    cdll.fp_set_route.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                  ctypes.c_char_p]
    cdll.fp_remove_route.restype = ctypes.c_int
    cdll.fp_remove_route.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    cdll.fp_drain_misses.restype = ctypes.c_long
    cdll.fp_drain_misses.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                     ctypes.c_size_t]
    cdll.fp_stats_json.restype = ctypes.c_long
    cdll.fp_stats_json.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                   ctypes.c_size_t]
    cdll.fp_drain_features.restype = ctypes.c_long
    cdll.fp_drain_features.argtypes = [ctypes.c_void_p,
                                       ctypes.POINTER(ctypes.c_float),
                                       ctypes.c_long]
    cdll.fp_shutdown.restype = None
    cdll.fp_shutdown.argtypes = [ctypes.c_void_p]


class FastPathEngine:
    """Handle on the native epoll proxy data plane (native/fastpath.cpp),
    one worker.

    Python is the control plane: it binds listeners before start(), then
    installs/updates concrete routes (host -> [(ip, port), ...]) as the
    naming system publishes address changes, and periodically drains route
    misses, stats, and per-request feature rows."""

    # engine feature-row width: route_id, latency_ms, status, req_b,
    # rsp_b, ts_s, score, scored, tenant, kind, stream, frame_seq
    # (score/scored are the in-data-plane scorer's output; scored ==
    # 0.0 rows fall back to the device tier; tenant is the 24-bit-folded
    # tenant hash, 0 = none; kind 0 = request, 1 = h2 stream sample,
    # 2 = tunnel sample; stream is the 24-bit stream key for kind > 0
    # rows, frame_seq the frame count at sample time)
    FEATURE_DIM = 12

    def __init__(self):
        cdll = lib()
        self._lib = cdll
        self._e = cdll.fp_create()
        self._started = False
        self._closed = False
        self._miss_buf = ctypes.create_string_buffer(64 * 1024)
        self._stats_buf = ctypes.create_string_buffer(1024 * 1024)
        self._feat_rows = 16384
        self._feat_buf = (ctypes.c_float
                          * (self._feat_rows * self.FEATURE_DIM))()

    def listen(self, ip: str, port: int) -> int:
        """Bind a listener; returns the bound port. Call before start()."""
        assert not self._started
        got = self._lib.fp_listen(self._e, ip.encode(), port)
        if got < 0:
            raise OSError(f"fastpath listen {ip}:{port} failed")
        return got

    def start(self) -> None:
        if not self._started:
            if self._lib.fp_start(self._e) != 0:
                raise RuntimeError("fastpath thread start failed")
            self._started = True

    @staticmethod
    def _key(host: str) -> bytes:
        # Header bytes are latin-1; bytes.lower() folds ASCII only —
        # exactly matching the engine's lower() keying (fastpath.cpp).
        return host.encode("latin-1", "replace").lower()

    def set_route(self, host: str, endpoints: List[Tuple[str, int]]) -> None:
        eps = " ".join(f"{ip}:{port}" for ip, port in endpoints) + " "
        self._lib.fp_set_route(self._e, self._key(host), eps.encode())

    def set_route_feature(self, host: str, col: int, sign: float) -> bool:
        """Install the dst-path feature-hash (column, sign) for a route
        so the in-engine scorer can featurize its rows; call after
        set_route. Returns False while the route does not exist."""
        return self._lib.fp_set_route_feature(
            self._e, self._key(host), int(col), float(sign)) == 0

    def set_route_hash(self, host: str, rhash: int) -> bool:
        """Install a route's specialist-bank key (FNV-1a of the bound
        dst path, ``lifecycle.export.route_hash``); call after
        set_route. Until this lands the route's rows score on the
        bank's base model. Returns False while the route does not
        exist."""
        return self._lib.fp_set_route_hash(
            self._e, self._key(host), int(rhash) & 0xFFFFFFFF) == 0

    def publish_weights(self, blob: bytes) -> None:
        """Hot-swap the in-engine scorer's weights from a versioned
        blob — a v1 model or a v2 specialist bank
        (lifecycle/export.export_weight_blob / export_bank_blob).
        Raises ValueError on a rejected blob (bad magic/CRC/geometry);
        the data plane never pauses — scoring flips to the new weights
        per-row."""
        if self._closed:
            # a stale sink calling into a freed C++ engine would be a
            # native use-after-free, not a catchable Python error
            raise RuntimeError("engine is closed")
        err = ctypes.create_string_buffer(256)
        rc = self._lib.fp_publish_weights(self._e, blob, len(blob), err,
                                          len(err))
        if rc != 0:
            raise ValueError(
                f"weight blob rejected: "
                f"{err.value.decode('latin-1') or 'unknown error'}")

    def publish_delta(self, blob: bytes) -> None:
        """Apply a per-route delta patch (``L5DWTD01``) to the ACTIVE
        bank — generation-fenced: raises ValueError when the patch was
        built against a different bank generation (the caller falls
        back to a full publish), when it removes an absent head, or on
        any corruption."""
        if self._closed:
            raise RuntimeError("engine is closed")
        err = ctypes.create_string_buffer(256)
        rc = self._lib.fp_publish_delta(self._e, blob, len(blob), err,
                                        len(err))
        if rc != 0:
            raise ValueError(
                f"delta blob rejected: "
                f"{err.value.decode('latin-1') or 'unknown error'}")

    def remove_route(self, host: str) -> None:
        self._lib.fp_remove_route(self._e, self._key(host))

    def drain_misses(self) -> List[str]:
        n = self._lib.fp_drain_misses(self._e, self._miss_buf,
                                      len(self._miss_buf))
        if n <= 0:
            return []
        return self._miss_buf.value.decode("latin-1").split("\n")[:n]

    def stats(self) -> dict:
        """Engine stats snapshot (``{}`` when it cannot be read)."""
        for _ in range(6):
            n = self._lib.fp_stats_json(self._e, self._stats_buf,
                                        len(self._stats_buf))
            if n == -2:  # buffer too small: grow (capped at 64MB)
                if len(self._stats_buf) >= 64 << 20:
                    log.warning("fastpath stats exceed 64MB; dropping")
                    return {}
                self._stats_buf = ctypes.create_string_buffer(
                    len(self._stats_buf) * 4)
                continue
            if n < 0:
                return {}
            return json.loads(self._stats_buf.value.decode("latin-1"))
        return {}

    def drain_features(self) -> np.ndarray:
        """-> float32 ndarray [n, FEATURE_DIM] of per-request rows."""
        n = self._lib.fp_drain_features(self._e, self._feat_buf,
                                        self._feat_rows)
        if n <= 0:
            return np.zeros((0, self.FEATURE_DIM), dtype=np.float32)
        arr = np.ctypeslib.as_array(self._feat_buf)
        return arr[:n * self.FEATURE_DIM].reshape(
            n, self.FEATURE_DIM).copy()

    def drain_features_into(self, out: np.ndarray) -> int:
        """Drain up to ``len(out)`` feature rows directly into ``out``
        (a C-contiguous float32 [rows, FEATURE_DIM] ndarray — in
        practice a writable view of the telemeter's NativeFeatureRing):
        the engine memcpys rows straight into ring memory, no
        intermediate buffer and no per-row Python objects. Returns the
        number of rows written."""
        if len(out) == 0:
            return 0
        if out.dtype != np.float32:
            raise ValueError(f"want float32 rows, got {out.dtype}")
        if out.ndim != 2 or out.shape[1] != self.FEATURE_DIM \
                or not out.flags["C_CONTIGUOUS"]:
            raise ValueError(
                f"want C-contiguous [n, {self.FEATURE_DIM}] f32, got "
                f"shape {out.shape}")
        ptr = out.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        n = self._lib.fp_drain_features(self._e, ptr, len(out))
        return max(int(n), 0)

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self._lib.fp_shutdown(self._e)


# -- in-data-plane scorer (engine-independent surface) ------------------------


def _as_f32_ptr(arr):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def score_feature_dim() -> int:
    """The C featurizer's FEATURE_DIM."""
    return int(lib().l5d_score_feature_dim())


def score_blob_info(blob: bytes) -> dict:
    """Parse+validate a weight blob. Returns its header dict, or raises
    ValueError with the parser's reason."""
    out = ctypes.create_string_buffer(512)
    n = lib().l5d_score_blob_info(blob, len(blob), out, len(out))
    if n < 0:
        raise ValueError(out.value.decode("latin-1"))
    return json.loads(out.value.decode("latin-1"))


def score_eval(blob: bytes, x) -> np.ndarray:
    """Score featurized rows (f32 [n, in_dim]) with the C evaluator.
    Returns f32 [n] scores; ValueError on a rejected blob."""
    x = np.ascontiguousarray(x, np.float32)
    out = np.zeros(len(x), np.float32)
    err = ctypes.create_string_buffer(256)
    n = lib().l5d_score_eval(blob, len(blob), _as_f32_ptr(x), len(x),
                             x.shape[1], _as_f32_ptr(out), err, len(err))
    if n < 0:
        raise ValueError(err.value.decode("latin-1"))
    return out


def score_eval_route(blob: bytes, route_hash: int, x):
    """Score featurized rows through a bank blob's head for
    ``route_hash`` (base model when the bank has no such head).
    Returns (scores [n], specialist bool); ValueError on a rejected
    blob."""
    x = np.ascontiguousarray(x, np.float32)
    out = np.zeros(len(x), np.float32)
    spec = ctypes.c_int32(0)
    err = ctypes.create_string_buffer(256)
    n = lib().l5d_score_eval_route(
        blob, len(blob), int(route_hash) & 0xFFFFFFFF, _as_f32_ptr(x),
        len(x), x.shape[1], _as_f32_ptr(out), ctypes.byref(spec), err,
        len(err))
    if n < 0:
        raise ValueError(err.value.decode("latin-1"))
    return out, bool(spec.value)


class ScoreSlab:
    """Standalone handle on the double-buffered weight slab — the same
    hot-swap machinery the engines embed, without an engine."""

    def __init__(self):
        self._lib = lib()
        self._s = self._lib.l5d_slab_create()

    def _handle(self):
        if self._s is None:
            raise RuntimeError("slab is closed")
        return self._s

    def publish(self, blob: bytes) -> None:
        # the C side rejects a valid blob whose in_dim disagrees with
        # the featurizer width (l5d_slab_score strides by FEATURE_DIM)
        s = self._handle()
        err = ctypes.create_string_buffer(256)
        if self._lib.l5d_slab_publish(s, blob, len(blob), err,
                                      len(err)) != 0:
            raise ValueError(
                f"weight blob rejected: "
                f"{err.value.decode('latin-1') or 'unknown error'}")

    def publish_delta(self, blob: bytes) -> None:
        """Apply a generation-fenced per-route delta patch to the
        active bank; ValueError on rejection (fence/corruption/absent
        head) — the serving bank is untouched then."""
        s = self._handle()
        err = ctypes.create_string_buffer(256)
        if self._lib.l5d_slab_publish_delta(s, blob, len(blob), err,
                                            len(err)) != 0:
            raise ValueError(
                f"delta blob rejected: "
                f"{err.value.decode('latin-1') or 'unknown error'}")

    def _rows(self, x) -> np.ndarray:
        # the C side strides by FEATURE_DIM unchecked (an engine-row
        # shaped [n, 12] array would read out of bounds)
        x = np.ascontiguousarray(x, np.float32)
        dim = int(self._lib.l5d_score_feature_dim())
        if x.ndim != 2 or x.shape[1] != dim:
            raise ValueError(
                f"expected [n, {dim}] featurized rows, got {x.shape}")
        return x

    def score_route(self, x, route_hash: int):
        """Score featurized rows with per-route head selection.
        Returns (scores [n], specialist flags [n] int32) or None while
        no weights are published."""
        s = self._handle()
        x = self._rows(x)
        out = np.zeros(len(x), np.float32)
        spec = np.zeros(len(x), np.int32)
        n = self._lib.l5d_slab_score_route(
            s, int(route_hash) & 0xFFFFFFFF, _as_f32_ptr(x), len(x),
            _as_f32_ptr(out),
            spec.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        return None if n < 0 else (out, spec)

    def score(self, x) -> Optional[np.ndarray]:
        """Score featurized f32 [n, FEATURE_DIM] rows; None while no
        weights are published."""
        s = self._handle()
        x = self._rows(x)
        out = np.zeros(len(x), np.float32)
        n = self._lib.l5d_slab_score(s, _as_f32_ptr(x), len(x),
                                     _as_f32_ptr(out))
        return None if n < 0 else out

    def stats(self) -> dict:
        out = ctypes.create_string_buffer(256)
        self._lib.l5d_slab_stats(self._handle(), out, len(out))
        return json.loads(out.value.decode("latin-1"))

    def close(self) -> None:
        if self._s is not None:
            self._lib.l5d_slab_free(self._s)
            self._s = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass
