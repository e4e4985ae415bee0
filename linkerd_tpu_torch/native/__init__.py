"""ctypes binding of the native engines: counterpart of
``linkerd_tpu/native/__init__.py`` for the HTTP/1.1 engine and the
h2/gRPC engine (sharded workers, native TLS, tenant extraction and
quotas, the connection guard, the h2 flood caps and response timeout,
and the stream sentinel) and the in-data-plane scorer.

The library is built from the repository's ``native/`` sources by
``_build`` at first use. There is no pure-Python fallback: a build or
load failure raises, and a caller that cannot serve without the engine
(a ``fastPath: true`` router) reports it as a configuration error.
"""

from __future__ import annotations

import ctypes
import json
import logging
import os
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
            _declare_h2_fastpath(cdll)
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
    l5d_slab_*); the engines' publish and feature hooks are declared
    with each engine (``_declare_engine``)."""
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


def _declare_tls(cdll: ctypes.CDLL, prefix: str) -> None:
    """TLS exports shared by both engines (fp_* / fph2_*)."""
    fn = getattr(cdll, prefix + "_tls_runtime_available")
    fn.restype = ctypes.c_int
    fn.argtypes = []
    fn = getattr(cdll, prefix + "_set_tls")
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p,
                   ctypes.c_char_p, ctypes.c_char_p, ctypes.c_size_t]
    fn = getattr(cdll, prefix + "_listen_tls")
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
    fn = getattr(cdll, prefix + "_set_client_tls")
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
                   ctypes.c_char_p, ctypes.c_char_p, ctypes.c_size_t]


def _declare_engine(cdll: ctypes.CDLL, prefix: str) -> None:
    """The control surface both engines export under their prefix: the
    loop, listeners, routes, drains and stats, the in-plane scorer's
    weight publish and route features, tenant extraction and quotas, the
    connection guard and the stream sentinel (per-stream scoring cadence and hysteresis, the
    /streams.json snapshot, the mid-stream RST queue)."""
    _declare_tls(cdll, prefix)
    blob = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t,
            ctypes.c_char_p, ctypes.c_size_t]
    sigs = {
        "_create": (ctypes.c_void_p, []),
        "_start": (ctypes.c_int, [ctypes.c_void_p]),
        "_listen": (ctypes.c_int,
                    [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]),
        "_listen_shared": (ctypes.c_int,
                           [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]),
        "_listen_tls_shared": (ctypes.c_int, [ctypes.c_void_p,
                                              ctypes.c_char_p,
                                              ctypes.c_int]),
        "_attach_slab": (ctypes.c_int, [ctypes.c_void_p, ctypes.c_void_p]),
        "_set_route": (ctypes.c_int, [ctypes.c_void_p, ctypes.c_char_p,
                                      ctypes.c_char_p]),
        "_remove_route": (ctypes.c_int, [ctypes.c_void_p, ctypes.c_char_p]),
        "_drain_misses": (ctypes.c_long, [ctypes.c_void_p, ctypes.c_char_p,
                                          ctypes.c_size_t]),
        "_stats_json": (ctypes.c_long, [ctypes.c_void_p, ctypes.c_char_p,
                                        ctypes.c_size_t]),
        "_drain_features": (ctypes.c_long, [ctypes.c_void_p,
                                            ctypes.POINTER(ctypes.c_float),
                                            ctypes.c_long]),
        "_shutdown": (None, [ctypes.c_void_p]),
        "_set_guard": (ctypes.c_int, [ctypes.c_void_p] + [ctypes.c_long] * 6),
        "_set_tenant": (ctypes.c_int, [ctypes.c_void_p, ctypes.c_int,
                                       ctypes.c_char_p, ctypes.c_int]),
        "_set_tenant_quota": (ctypes.c_int, [ctypes.c_void_p,
                                             ctypes.c_uint32, ctypes.c_int]),
        "_set_stream_cfg": (ctypes.c_int, [
            ctypes.c_void_p, ctypes.c_long, ctypes.c_long, ctypes.c_long,
            ctypes.c_long, ctypes.c_double, ctypes.c_double, ctypes.c_long,
            ctypes.c_long, ctypes.c_long]),
        "_streams_json": (ctypes.c_long, [ctypes.c_void_p, ctypes.c_char_p,
                                          ctypes.c_size_t]),
        "_rst_stream": (ctypes.c_int, [ctypes.c_void_p, ctypes.c_uint32]),
        "_publish_weights": (ctypes.c_int, blob),
        "_publish_delta": (ctypes.c_int, blob),
        "_set_route_feature": (ctypes.c_int, [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_float]),
        "_set_route_hash": (ctypes.c_int, [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint32]),
    }
    for suffix, (restype, argtypes) in sigs.items():
        fn = getattr(cdll, prefix + suffix)
        fn.restype, fn.argtypes = restype, argtypes


def _declare_h2_fastpath(cdll: ctypes.CDLL) -> None:
    """The h2 engine: the shared surface under ``fph2`` plus its flood
    caps and response timeout."""
    _declare_engine(cdll, "fph2")
    cdll.fph2_set_flood_guard.restype = ctypes.c_int
    cdll.fph2_set_flood_guard.argtypes = \
        [ctypes.c_void_p] + [ctypes.c_long] * 5
    cdll.fph2_set_response_timeout_ms.restype = None
    cdll.fph2_set_response_timeout_ms.argtypes = [ctypes.c_void_p,
                                                  ctypes.c_long]


def _declare_fastpath(cdll: ctypes.CDLL) -> None:
    """The HTTP/1.1 engine: the shared surface under ``fp`` plus its
    byte-tunnel budgets, and the engines' tenant hash and stream
    accumulator."""
    _declare_engine(cdll, "fp")
    cdll.fp_set_tunnel_guard.restype = ctypes.c_int
    cdll.fp_set_tunnel_guard.argtypes = \
        [ctypes.c_void_p, ctypes.c_long, ctypes.c_long]
    cdll.l5d_tenant_hash.restype = ctypes.c_uint32
    cdll.l5d_tenant_hash.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
    cdll.l5d_stream_accum.restype = ctypes.c_long
    cdll.l5d_stream_accum.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float), ctypes.c_long,
        ctypes.POINTER(ctypes.c_float)]


def auto_workers() -> int:
    """The ``workers: 0`` auto-size rule — one definition shared by
    the linker's knob resolution and l5dcheck's ``fastpath-workers``
    rule: min(4, hw cores)."""
    return min(4, os.cpu_count() or 1)


def _sum_hists(a, b):
    if not a:
        return list(b)
    if not b:
        return list(a)
    return [int(x) + int(y) for x, y in zip(a, b)]


def _merge_worker_stats(snaps: List[dict], n_workers: int) -> dict:
    """Merge N per-worker engine stats snapshots into one router-level
    view — the merge-at-scrape rule: the hot path never shares a
    counter; the control plane adds the per-core slabs up here, once a
    second. Counters and histograms sum; shared-slab scorer fields
    (weights/version/crc/swaps/retries live in the ONE process-wide
    slab) are taken from the first worker; per-tenant score EWMAs
    average weighted by each worker's scored count."""
    if not snaps:
        return {}
    out: dict = {"routes": {}}
    for key in ("accepted", "features_dropped"):
        out[key] = sum(int(s.get(key, 0)) for s in snaps)
    for s in snaps:
        for host, r in (s.get("routes") or {}).items():
            m = out["routes"].get(host)
            if m is None:
                out["routes"][host] = dict(r)
                continue
            for k in ("requests", "success", "f4xx", "f5xx",
                      "conn_fail"):
                m[k] = int(m.get(k, 0)) + int(r.get(k, 0))
            m["hist"] = _sum_hists(m.get("hist") or [],
                                   r.get("hist") or [])
    tls_snaps = [s["tls"] for s in snaps if s.get("tls")]
    if tls_snaps:
        tls = {k: sum(int(t.get(k, 0)) for t in tls_snaps)
               for k in ("handshakes", "failures", "resumed", "alpn_h2",
                         "alpn_http1", "upstream_handshakes",
                         "upstream_resumed", "upstream_failures")}
        tls["enabled"] = any(t.get("enabled") for t in tls_snaps)
        tls["client_enabled"] = any(t.get("client_enabled")
                                    for t in tls_snaps)
        out["tls"] = tls
    guard_snaps = [s["guard"] for s in snaps if s.get("guard")]
    if guard_snaps:
        keys = set()
        for g in guard_snaps:
            keys.update(g)
        out["guard"] = {k: sum(int(g.get(k, 0)) for g in guard_snaps)
                        for k in keys}
    tn_snaps = [s["tenants"] for s in snaps if s.get("tenants")]
    if tn_snaps:
        by: dict = {}
        for tn in tn_snaps:
            for thash, t in (tn.get("by_tenant") or {}).items():
                m = by.get(thash)
                if m is None:
                    by[thash] = dict(t)
                    continue
                # score_ewma: scored-weighted mean across workers
                w_old, w_new = int(m.get("scored", 0)), int(
                    t.get("scored", 0))
                if w_old + w_new > 0:
                    m["score_ewma"] = (
                        float(m.get("score_ewma", 0.0)) * w_old
                        + float(t.get("score_ewma", 0.0)) * w_new
                    ) / (w_old + w_new)
                for k in ("requests", "shed", "errors", "scored",
                          "inflight"):
                    m[k] = int(m.get(k, 0)) + int(t.get(k, 0))
                # per-worker quota splits are equal; fold to the max
                # here (-1 = unlimited wins), scaled back to the
                # global cap below
                qa, qb = int(m.get("quota", -1)), int(t.get("quota", -1))
                m["quota"] = -1 if (qa < 0 or qb < 0) else max(qa, qb)
        # quota: report the GLOBAL cap, per-worker split x the TRUE
        # worker count (not a sum over the workers whose bounded-LRU
        # stats table still happens to hold the tenant, nor over the
        # scrapes that succeeded this tick — quota maps survive stats
        # eviction, so every worker enforces the same split even when
        # only some reported the tenant)
        for t in by.values():
            q = int(t.get("quota", -1))
            if q >= 0:
                t["quota"] = q * n_workers
        out["tenants"] = {
            "count": len(by),
            "evicted": sum(int(t.get("evicted", 0)) for t in tn_snaps),
            "by_tenant": by,
        }
    ns_snaps = [s["native_scorer"] for s in snaps
                if s.get("native_scorer")]
    if ns_snaps:
        ns = dict(ns_snaps[0])  # slab fields (version/crc/generation/
        # heads/swaps/delta_swaps/retries): shared, identical
        ns["scored"] = sum(int(x.get("scored", 0)) for x in ns_snaps)
        ns["specialist_scored"] = sum(
            int(x.get("specialist_scored", 0)) for x in ns_snaps)
        ns["unscored"] = sum(int(x.get("unscored", 0)) for x in ns_snaps)
        hist = ns_snaps[0].get("score_ns_hist") or []
        for x in ns_snaps[1:]:
            hist = _sum_hists(hist, x.get("score_ns_hist") or [])
        ns["score_ns_hist"] = hist
        out["native_scorer"] = ns
    return out


class FastPathEngine:
    """Handle on the native epoll proxy data plane (native/fastpath.cpp).

    Python is the control plane: it binds listeners before start(), then
    installs/updates concrete routes (host -> [(ip, port), ...]) as the
    naming system publishes address changes, and periodically drains route
    misses, stats, and per-request feature rows.

    Multi-core sharding (``workers`` > 1): N per-core C++ engine
    instances, each with its own epoll loop, upstream pools, and
    stats/guard slabs; ``listen()`` binds every worker to the SAME port
    via SO_REUSEPORT so the kernel distributes connections — no shared
    counters on the hot path. Control-plane calls (routes, TLS, guards)
    broadcast to all workers; drains fan in; ``stats()`` merges the
    per-worker slabs at scrape time and carries the raw per-worker
    snapshots under ``workers``. The scorer's double-buffered weight
    slab becomes ONE process-wide slab shared read-only across workers
    (attached before start), so a single ``publish_weights`` flips every
    core to the new blob atomically. ``workers=1`` is byte-for-byte the
    single engine: the legacy (non-REUSEPORT) bind, the embedded slab,
    and the unmerged stats shape."""

    # engine feature-row width: route_id, latency_ms, status, req_b,
    # rsp_b, ts_s, score, scored, tenant, kind, stream, frame_seq
    # (score/scored are the in-data-plane scorer's output; scored ==
    # 0.0 rows fall back to the device tier; tenant is the 24-bit-folded
    # tenant hash, 0 = none; kind 0 = request, 1 = h2 stream sample,
    # 2 = tunnel sample; stream is the 24-bit stream key for kind > 0
    # rows, frame_seq the frame count at sample time)
    FEATURE_DIM = 12
    _PREFIX = "fp"  # C symbol prefix; the h2 engine overrides to "fph2"
    # ALPN preference list the engine's TLS contexts advertise/offer
    _ALPN = "http/1.1"

    MAX_WORKERS = 64

    def __init__(self, workers: int = 1):
        cdll = lib()
        workers = int(workers)
        if not 1 <= workers <= self.MAX_WORKERS:
            raise ValueError(
                f"workers must be in 1..{self.MAX_WORKERS}, got {workers}")
        self._lib = cdll
        p = self._PREFIX
        self._fn_listen = getattr(cdll, p + "_listen")
        self._fn_listen_shared = getattr(cdll, p + "_listen_shared")
        self._fn_listen_tls_shared = getattr(cdll,
                                             p + "_listen_tls_shared")
        self._fn_start = getattr(cdll, p + "_start")
        self._fn_set_route = getattr(cdll, p + "_set_route")
        self._fn_remove_route = getattr(cdll, p + "_remove_route")
        self._fn_drain_misses = getattr(cdll, p + "_drain_misses")
        self._fn_stats = getattr(cdll, p + "_stats_json")
        self._fn_features = getattr(cdll, p + "_drain_features")
        self._fn_shutdown = getattr(cdll, p + "_shutdown")
        self._fn_publish = getattr(cdll, p + "_publish_weights")
        self._fn_publish_delta = getattr(cdll, p + "_publish_delta")
        self._fn_route_feat = getattr(cdll, p + "_set_route_feature")
        self._fn_route_hash = getattr(cdll, p + "_set_route_hash")
        self.workers = workers
        self._es = [getattr(cdll, p + "_create")()
                    for _ in range(workers)]
        self._e = self._es[0]  # single-worker compat handle
        # multi-worker: ONE process-wide weight slab, shared read-only
        # by every worker's epoll thread — one publish fans out to all
        # cores atomically (freed in close(), after every worker's loop
        # thread has joined)
        self._slab = None
        if workers > 1:
            self._slab = cdll.l5d_slab_create()
            attach = getattr(cdll, p + "_attach_slab")
            for h in self._es:
                attach(h, self._slab)
        self._started = False
        self._closed = False
        self._miss_buf = ctypes.create_string_buffer(64 * 1024)
        self._stats_buf = ctypes.create_string_buffer(1024 * 1024)
        self._feat_rows = 16384
        self._feat_buf = (ctypes.c_float
                          * (self._feat_rows * self.FEATURE_DIM))()

    def listen(self, ip: str, port: int) -> int:
        """Bind a listener; returns the bound port. Call before start().
        With ``workers`` > 1 every worker binds the same port via
        SO_REUSEPORT (the first worker resolves port 0 to a concrete
        port; the rest join it)."""
        assert not self._started
        if self.workers == 1:
            got = self._fn_listen(self._e, ip.encode(), port)
            if got < 0:
                raise OSError(f"fastpath listen {ip}:{port} failed")
            return got
        return self._listen_all(self._fn_listen_shared, ip, port)

    def _listen_all(self, fn, ip: str, port: int) -> int:
        got = fn(self._es[0], ip.encode(), port)
        if got < 0:
            raise OSError(f"fastpath listen {ip}:{port} failed")
        for h in self._es[1:]:
            if fn(h, ip.encode(), got) < 0:
                raise OSError(
                    f"fastpath shared listen {ip}:{got} failed")
        return got

    @classmethod
    def tls_runtime_available(cls) -> bool:
        """True when the engine could dlopen the OpenSSL runtime (TLS
        termination/origination available natively)."""
        fn = getattr(lib(), cls._PREFIX + "_tls_runtime_available")
        return bool(fn())

    def set_tls(self, cert_path: str, key_path: str) -> None:
        """Install the accept-leg TLS context (PEM cert chain + key).
        Call before start(); listeners bound with listen_tls() then
        terminate TLS with this identity (ALPN per engine protocol)."""
        assert not self._started
        err = ctypes.create_string_buffer(512)
        fn = getattr(self._lib, self._PREFIX + "_set_tls")
        for h in self._es:
            rc = fn(h, cert_path.encode(), key_path.encode(),
                    self._ALPN.encode(), err, len(err))
            if rc != 0:
                raise OSError(
                    f"fastpath TLS config failed: "
                    f"{err.value.decode('latin-1') or 'unknown error'}")

    def listen_tls(self, ip: str, port: int) -> int:
        """Bind a TLS-terminating listener (requires set_tls first);
        returns the bound port. Call before start(). Multi-worker
        engines share the port via SO_REUSEPORT like listen()."""
        assert not self._started
        if self.workers == 1:
            got = getattr(self._lib, self._PREFIX + "_listen_tls")(
                self._e, ip.encode(), port)
            if got < 0:
                raise OSError(f"fastpath TLS listen {ip}:{port} failed")
            return got
        return self._listen_all(self._fn_listen_tls_shared, ip, port)

    def set_client_tls(self, verify: bool = True,
                       ca_path: Optional[str] = None) -> None:
        """Originate TLS to every upstream endpoint (router-wide
        client.tls). The route authority is sent as SNI and, when
        ``verify`` is set, pinned against the peer certificate;
        ``ca_path`` replaces the default trust roots. Call before
        start()."""
        assert not self._started
        err = ctypes.create_string_buffer(512)
        fn = getattr(self._lib, self._PREFIX + "_set_client_tls")
        for h in self._es:
            rc = fn(h, self._ALPN.encode(), 1 if verify else 0,
                    ca_path.encode() if ca_path else None, err, len(err))
            if rc != 0:
                raise OSError(
                    f"fastpath client TLS config failed: "
                    f"{err.value.decode('latin-1') or 'unknown error'}")

    def start(self) -> None:
        if not self._started:
            for h in self._es:
                if self._fn_start(h) != 0:
                    raise RuntimeError("fastpath thread start failed")
            self._started = True

    @staticmethod
    def _key(host: str) -> bytes:
        # Header bytes are latin-1; bytes.lower() folds ASCII only —
        # exactly matching the engine's lower() keying (fastpath.cpp).
        return host.encode("latin-1", "replace").lower()

    def set_route(self, host: str, endpoints: List[Tuple[str, int]]) -> None:
        # Broadcast in WORKER ORDER, always: each worker assigns route
        # ids by install order, so identical broadcast order keeps ids
        # in lockstep across workers — feature rows drained from any
        # worker then attribute to the same dst path.
        eps = " ".join(f"{ip}:{port}" for ip, port in endpoints) + " "
        for h in self._es:
            self._fn_set_route(h, self._key(host), eps.encode())

    TENANT_KINDS = {"off": 0, "header": 1, "pathSegment": 2, "sni": 3}

    def set_tenant(self, kind: str, header: str = "l5d-tenant",
                   segment: int = 0) -> None:
        """Install the tenant-extraction mode (call before start()):
        ``header`` hashes the named request header's value,
        ``pathSegment`` the ``segment``th path element, ``sni`` the TLS
        server name. The engine stamps the FNV-1a hash into per-request
        feature rows and the per-tenant stats table."""
        assert not self._started
        k = self.TENANT_KINDS.get(kind)
        if k is None:
            raise ValueError(f"unknown tenant extraction kind {kind!r}")
        fn = getattr(self._lib, self._PREFIX + "_set_tenant")
        for h in self._es:
            if fn(h, k, header.encode("latin-1", "replace"),
                  int(segment)) != 0:
                raise ValueError("tenant extraction config rejected")

    def set_tenant_quota(self, tenant_hash: int,
                         limit: Optional[int]) -> None:
        """Push (or clear, with ``limit=None``) a per-tenant
        concurrency quota, keyed by the tenant's 32-bit hash. The
        engine sheds over-quota requests retryably in the data plane
        (h1: 503 + l5d-retryable, h2: RST REFUSED_STREAM). Safe at any
        time; raises when the native quota map is full.

        Multi-worker engines split the limit N ways (floor division:
        per-worker tables are independent, so the global cap is never
        exceeded). A limit below ``workers`` rounds to a per-worker
        quota of ZERO — every worker sheds that tenant entirely."""
        if self._closed:
            raise RuntimeError("engine is closed")
        if limit is None:
            per_worker = -1
        else:
            per_worker = max(0, int(limit))
            if self.workers > 1:
                per_worker //= self.workers
        fn = getattr(self._lib, self._PREFIX + "_set_tenant_quota")
        for h in self._es:
            if fn(h, int(tenant_hash) & 0xFFFFFFFF, per_worker) != 0:
                raise ValueError("native tenant quota map is full")

    def set_guard(self, header_budget_ms: int = 10_000,
                  body_stall_ms: int = 30_000, accept_burst: int = 0,
                  accept_window_ms: int = 1000,
                  max_hs_inflight: int = 0,
                  tenant_cap: int = 1024) -> None:
        """Connection-plane defense knobs (call before start()): the
        slowloris header/body budgets, the per-source accept throttle,
        TLS handshake-churn backpressure, and the tenant-stats LRU
        bound. 0 disables an individual defense."""
        assert not self._started
        fn = getattr(self._lib, self._PREFIX + "_set_guard")
        for h in self._es:
            rc = fn(h, int(header_budget_ms), int(body_stall_ms),
                    int(accept_burst), int(accept_window_ms),
                    int(max_hs_inflight), int(tenant_cap))
            if rc != 0:
                raise ValueError("guard config rejected")

    STREAM_ACTIONS = {"observe": 0, "rst": 1}

    def set_stream_cfg(self, enabled: bool = True,
                       sample_every_frames: int = 8,
                       min_gap_ms: int = 10, table_cap: int = 4096,
                       enter: float = 0.8, exit: float = 0.5,
                       quorum: int = 3, dwell_ms: int = 1000,
                       action: str = "rst") -> None:
        """Stream-sentinel knobs (call before start()): per-stream
        scoring cadence (every N frames, min gap between samples), the
        bounded stream-table cap, and the native hysteresis governor
        mirroring control.state.HysteresisGovernor (0 < exit < enter
        <= 1, quorum consecutive samples, dwell after a transition).
        ``action`` "rst" sheds a sick stream in-engine (h2: RST_STREAM
        / gRPC UNAVAILABLE trailers; h1: tunnel close); "observe" only
        records transitions."""
        assert not self._started
        a = self.STREAM_ACTIONS.get(action)
        if a is None:
            raise ValueError(f"unknown stream action {action!r}")
        fn = getattr(self._lib, self._PREFIX + "_set_stream_cfg")
        for h in self._es:
            rc = fn(h, 1 if enabled else 0, int(sample_every_frames),
                    int(min_gap_ms), int(table_cap), float(enter),
                    float(exit), int(quorum), int(dwell_ms), a)
            if rc != 0:
                raise ValueError("stream config rejected")

    def _json_one(self, fn, handle) -> dict:
        """One engine's JSON document from ``fn`` (stats or streams),
        growing the buffer as needed; ``{}`` when it cannot be read."""
        for _ in range(6):
            n = fn(handle, self._stats_buf, len(self._stats_buf))
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

    def streams(self) -> dict:
        """Stream-table snapshot (/streams.json shape). Multi-worker
        engines carry per-worker snapshots under ``workers`` — stream
        keys are per-worker sequences, so by_stream maps must not be
        merged across workers — with engine-wide counters summed."""
        fn = getattr(self._lib, self._PREFIX + "_streams_json")
        if self.workers == 1:
            return self._json_one(fn, self._e)
        snaps = [self._json_one(fn, h) for h in self._es]
        out: dict = {"enabled": any(s.get("enabled") for s in snaps)}
        for k in ("count", "evicted", "sick_transitions", "rst_sent",
                  "tunnels_opened", "tunnel_idle_closed",
                  "tunnel_bytes_closed"):
            out[k] = sum(int(s.get(k, 0)) for s in snaps)
        out["workers"] = snaps
        return out

    def rst_stream(self, skey: int, worker: Optional[int] = None) -> None:
        """Queue a mid-stream shed by 24-bit stream key (the ``stream``
        column of kind > 0 feature rows): the engine's loop thread
        RSTs the h2 stream (gRPC UNAVAILABLE trailers when possible)
        or closes the tunnel. Keys are per-worker sequences — pass
        ``worker`` when the engine is sharded; a broadcast would shed
        whatever stream holds that key on EVERY worker."""
        if self._closed:
            raise RuntimeError("engine is closed")
        fn = getattr(self._lib, self._PREFIX + "_rst_stream")
        handles = self._es if worker is None \
            else [self._es[int(worker)]]
        for h in handles:
            fn(h, int(skey) & 0xFFFFFF)

    def set_tunnel_guard(self, idle_ms: int = 0,
                         max_bytes: int = 0) -> None:
        """Byte-tunnel budgets (h1 engine only; call before start()):
        zero-activity window and lifetime byte cap for CONNECT /
        101-upgrade tunnels. 0 disables the individual cap. Enforced
        even when stream scoring is off — these are connection-plane
        defenses like the slowloris budgets."""
        assert not self._started
        if self._PREFIX != "fp":
            raise RuntimeError(
                "tunnel budgets are an h1-engine knob (h2 streams are "
                "bounded by the flood guard and response timeout)")
        for h in self._es:
            if self._lib.fp_set_tunnel_guard(h, int(idle_ms),
                                             int(max_bytes)) != 0:
                raise ValueError("tunnel guard config rejected")

    def set_route_feature(self, host: str, col: int, sign: float) -> bool:
        """Install the dst-path feature-hash (column, sign) for a route
        so the in-engine scorer can featurize its rows; call after
        set_route. Returns False while the route does not exist (on
        any worker — set_route broadcasts, so all workers agree)."""
        ok = True
        for h in self._es:
            if self._fn_route_feat(h, self._key(host), int(col),
                                   float(sign)) != 0:
                ok = False
        return ok

    def set_route_hash(self, host: str, rhash: int) -> bool:
        """Install a route's specialist-bank key (FNV-1a of the bound
        dst path, ``lifecycle.export.route_hash``); call after
        set_route. Until this lands the route's rows score on the
        bank's base model. Returns False while the route does not
        exist on some worker."""
        ok = True
        for h in self._es:
            if self._fn_route_hash(h, self._key(host),
                                   int(rhash) & 0xFFFFFFFF) != 0:
                ok = False
        return ok

    def publish_weights(self, blob: bytes) -> None:
        """Hot-swap the in-engine scorer's weights from a versioned
        blob — a v1 model or a v2 specialist bank
        (lifecycle/export.export_weight_blob / export_bank_blob).
        Raises ValueError on a rejected blob (bad magic/CRC/geometry);
        the data plane never pauses — scoring flips to the new weights
        per-row. With ``workers`` > 1 the publish goes ONCE into the
        shared slab and every worker observes the new blob atomically."""
        if self._closed:
            # a stale sink calling into a freed C++ engine would be a
            # native use-after-free, not a catchable Python error
            raise RuntimeError("engine is closed")
        err = ctypes.create_string_buffer(256)
        if self._slab is not None:
            rc = self._lib.l5d_slab_publish(self._slab, blob, len(blob),
                                            err, len(err))
        else:
            rc = self._fn_publish(self._e, blob, len(blob), err,
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
        any corruption. One apply flips every worker (shared slab)."""
        if self._closed:
            raise RuntimeError("engine is closed")
        err = ctypes.create_string_buffer(256)
        if self._slab is not None:
            rc = self._lib.l5d_slab_publish_delta(
                self._slab, blob, len(blob), err, len(err))
        else:
            rc = self._fn_publish_delta(self._e, blob, len(blob), err,
                                        len(err))
        if rc != 0:
            raise ValueError(
                f"delta blob rejected: "
                f"{err.value.decode('latin-1') or 'unknown error'}")

    def remove_route(self, host: str) -> None:
        for h in self._es:
            self._fn_remove_route(h, self._key(host))

    def drain_misses(self) -> List[str]:
        fn = self._fn_drain_misses
        if self.workers == 1:
            n = fn(self._e, self._miss_buf, len(self._miss_buf))
            if n <= 0:
                return []
            return self._miss_buf.value.decode("latin-1").split("\n")[:n]
        # fan-in: the same host typically misses on several workers at
        # once (the kernel spread its first connections); one entry is
        # enough — set_route broadcasts the resolution to all of them
        out: List[str] = []
        seen = set()
        for h in self._es:
            n = fn(h, self._miss_buf, len(self._miss_buf))
            if n <= 0:
                continue
            for host in self._miss_buf.value.decode(
                    "latin-1").split("\n")[:n]:
                if host not in seen:
                    seen.add(host)
                    out.append(host)
        return out

    def _stats_one(self, handle) -> dict:
        return self._json_one(self._fn_stats, handle)

    def stats(self) -> dict:
        """Engine stats snapshot (``{}`` when it cannot be read).
        ``workers == 1``: the single engine's snapshot, unchanged.
        ``workers > 1``: per-worker slabs merged at scrape time
        (counters summed, histograms added element-wise, shared-slab
        fields taken once), with the raw per-worker snapshots under
        ``workers`` for ``worker/<i>/*`` breakdowns."""
        if self.workers == 1:
            return self._stats_one(self._e)
        snaps = [self._stats_one(h) for h in self._es]
        if any(not s for s in snaps):
            # a PARTIAL merge would report totals below the
            # controller's delta baselines, and the next full scrape
            # would then re-count the missing worker's whole history
            # as one giant delta — skip this scrape entirely instead
            # (an empty snapshot is the established failure shape:
            # every consumer skips it and keeps its baselines)
            return {}
        merged = _merge_worker_stats(snaps, self.workers)
        merged["workers"] = snaps
        return merged

    def drain_features(self) -> np.ndarray:
        """-> float32 ndarray [n, FEATURE_DIM] of per-request rows
        (fan-in over every worker's ring segment)."""
        blocks = []
        for h in self._es:
            n = self._fn_features(h, self._feat_buf, self._feat_rows)
            if n > 0:
                arr = np.ctypeslib.as_array(self._feat_buf)
                blocks.append(arr[:n * self.FEATURE_DIM].reshape(
                    n, self.FEATURE_DIM).copy())
        if not blocks:
            return np.zeros((0, self.FEATURE_DIM), dtype=np.float32)
        return blocks[0] if len(blocks) == 1 else np.concatenate(blocks)

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
        # fan-in: fill `out` from each worker's per-core ring segment in
        # turn until it is full (each drain memcpys straight into ring
        # memory at the right row offset — still zero-copy per worker)
        total = 0
        row_bytes = self.FEATURE_DIM * 4
        base = out.ctypes.data
        for h in self._es:
            if total >= len(out):
                break
            ptr = ctypes.cast(base + total * row_bytes,
                              ctypes.POINTER(ctypes.c_float))
            n = self._fn_features(h, ptr, len(out) - total)
            if n > 0:
                total += int(n)
        return total

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            # every worker's epoll thread joins before the shared slab
            # is freed: no core can be mid-eval on freed weights
            for h in self._es:
                self._fn_shutdown(h)
            if self._slab is not None:
                self._lib.l5d_slab_free(self._slab)
                self._slab = None


class H2FastPathEngine(FastPathEngine):
    """Handle on the native h2/gRPC proxy data plane
    (native/h2_fastpath.cpp).

    Same control surface as FastPathEngine — FastPathController drives
    either interchangeably — but the engine speaks HTTP/2 (h2c prior
    knowledge) on both sides and routes by ``:authority``."""

    _PREFIX = "fph2"
    _ALPN = "h2"

    def set_flood_guard(self, max_streams: int = 512,
                        rst_burst: int = 200, ping_burst: int = 256,
                        settings_burst: int = 64,
                        window_ms: int = 1000) -> None:
        """h2 control-frame flood caps, per client conn per window:
        stream-concurrency bound, RST (rapid-reset, CVE-2023-44487),
        PING and SETTINGS bursts. 0 disables one cap. Call before
        start()."""
        assert not self._started
        for h in self._es:
            rc = self._lib.fph2_set_flood_guard(
                h, int(max_streams), int(rst_burst), int(ping_burst),
                int(settings_burst), int(window_ms))
            if rc != 0:
                raise ValueError("flood guard config rejected")

    def set_response_timeout_ms(self, ms: int) -> None:
        """Window within which a dispatched stream's backend must START
        its response (504 otherwise); streaming bodies are unbounded.
        Must be >= 1 (0 would time out everything immediately)."""
        ms = int(ms)
        if ms < 1:
            raise ValueError("response timeout must be >= 1 ms")
        for h in self._es:
            self._lib.fph2_set_response_timeout_ms(h, ms)


def tenant_hash_native(tenant_id: bytes) -> int:
    """The C engines' FNV-1a tenant hash (parity surface for
    router.tenancy.tenant_hash); raises when the library cannot be built
    or loaded, as every call into it does."""
    return int(lib().l5d_tenant_hash(tenant_id, len(tenant_id)))


def stream_accum(kinds, gaps_ms, sizes) -> np.ndarray:
    """Drive the engine's per-frame stream accumulator
    (l5dstream::accum_frame) over a whole frame trace — the parity
    surface for ``streams.tracker.StreamTracker``, which must
    reproduce the float32 EWMA arithmetic bit-for-bit. ``kinds`` are
    ints (0 DATA / 1 WINDOW_UPDATE / 2 anomaly), ``gaps_ms``/``sizes``
    per-frame floats. Returns f32 [9]: [gap_ewma_ms, gap_dev_ms,
    bpf_ewma, bpf_dev, frames, data_frames, wu_frames, anomalies,
    bytes]; ValueError on a bad kind."""
    k = np.ascontiguousarray(kinds, np.int32)
    g = np.ascontiguousarray(gaps_ms, np.float32)
    s = np.ascontiguousarray(sizes, np.float32)
    if not (len(k) == len(g) == len(s)):
        raise ValueError("kinds/gaps/sizes length mismatch")
    out = np.zeros(9, np.float32)
    rc = lib().l5d_stream_accum(
        k.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        _as_f32_ptr(g), _as_f32_ptr(s), len(k), _as_f32_ptr(out))
    if rc != 0:
        raise ValueError("bad frame kind in trace")
    return out


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
