"""The port's binding of the native engine (``linkerd_tpu_torch.native``)
against the reference's (``linkerd_tpu.native``), on the CPU.

The port builds its own library from ``native/`` into
``linkerd_tpu_torch/native/_build/`` (g++, about 12 s at first use); the
reference's is ``linkerd_tpu/native/libl5d_native.so``. Bounds:

- The HPACK Huffman table the port generates the engine's header from
  equals the reference's, and so does the header.
- The engine proxies by Host, streams a chunked response, keeps one
  pooled upstream connection, forwards a request body (the reference's
  ``tests/test_fastpath.py::TestFastPathEngine`` cases).
- ``score_eval`` and ``score_eval_route`` of the two libraries are
  bit-equal on the same f32/int8/int4 blobs and rows.
- The engine's in-plane scores of real loopback requests are within
  1e-5 of the port's float32 plain forward of the published snapshot
  on the engine's own features, and within 0.05 max and 0.01 mean of
  the port's bf16 plain scorer (``tests/test_native_scorer.py``'s
  bounds).
- A blob with a bad CRC, a wrong in_dim or a stale delta fence is
  rejected and the serving weights stay.

Every await is bounded (``asyncio.wait_for``, 10 s), so a wedged socket
fails the test rather than the suite's clock.
"""

import asyncio
import importlib.util
import struct
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from linkerd_tpu import native as ref_native
from linkerd_tpu.lifecycle import export as ref_export
from linkerd_tpu.lifecycle import store as ref_store
from linkerd_tpu.protocol.h2 import hpack
from linkerd_tpu_torch import native
from linkerd_tpu_torch.lifecycle import export, store
from linkerd_tpu_torch.lifecycle.store import ModelSnapshot
from linkerd_tpu_torch.models import anomaly as torch_model
from linkerd_tpu_torch.models.convert import params_from_numpy
from linkerd_tpu_torch.models.features import path_hash_cols
from linkerd_tpu_torch.native.huffman import HUFFMAN_TABLE, huffman_header
from linkerd_tpu_torch.ops.scoring import fused_anomaly_scores_plain
from linkerd_tpu_torch.protocol.http.message import Response
from linkerd_tpu_torch.protocol.http.server import serve
from linkerd_tpu_torch.router.service import FnService
from linkerd_tpu_torch.telemetry.anomaly import zero_adam_leaves
from linkerd_tpu_torch.telemetry.linerate import (
    NATIVE_COL_SCORE, NATIVE_COL_SCORED, NATIVE_ROW_WIDTH,
)

ROOT = Path(__file__).resolve().parent.parent
QUANTS = ("f32", "int8", "int4")
WAIT_S = 10
F32_ATOL = 1e-5                   # engine against the float32 forward
BF16_MAX, BF16_MEAN = 0.05, 0.01  # engine against the bf16 scorer


def bounded(aw):
    return asyncio.wait_for(aw, WAIT_S)


def run(coro):
    return asyncio.run(bounded(coro))


@pytest.fixture(scope="module")
def libs():
    """Both libraries, built before any event loop runs."""
    native.ensure_built()
    if not ref_native.ensure_built():
        pytest.fail("the reference's native library did not build")
    return native, ref_native


def snapshot(seed: int) -> ModelSnapshot:
    """A default-width snapshot with He-normal weights, biases around
    zero and the stats of engine rows' features."""
    cfg = torch_model.AnomalyModelConfig(recon_weight=0.7)
    rng = np.random.default_rng(seed)
    params = {g: [{"w": (rng.standard_normal((i, o)) * np.sqrt(2.0 / i)
                         ).astype(np.float32),
                   "b": (rng.standard_normal(o) * 0.1).astype(np.float32)}
                  for i, o in dims]
              for g, dims in torch_model.layer_dims(cfg).items()}
    return ModelSnapshot(
        params=params, opt_leaves=zero_adam_leaves(cfg),
        mu=(rng.standard_normal(36) * 0.3).astype(np.float32),
        var=rng.uniform(0.05, 2.0, 36).astype(np.float32),
        norm_initialized=True, step=seed, cfg=cfg)


def rows_for(snap: ModelSnapshot, seed: int, n: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (snap.mu + np.sqrt(snap.var) * rng.standard_normal((n, 36)) * 2
            ).astype(np.float32)


def plain_scores(snap: ModelSnapshot, x: np.ndarray, dtype) -> np.ndarray:
    cfg = torch_model.AnomalyModelConfig(
        compute_dtype=dtype, recon_weight=snap.cfg.recon_weight)
    params = params_from_numpy(snap.params, "cpu")
    return fused_anomaly_scores_plain(
        params, torch.tensor(x), cfg, torch.tensor(snap.mu),
        torch.tensor(snap.var)).numpy()


# -- the Huffman table -------------------------------------------------------


def test_huffman_table_is_the_reference_s():
    assert HUFFMAN_TABLE == hpack.HUFFMAN_TABLE
    spec = importlib.util.spec_from_file_location(
        "native_build", ROOT / "native" / "build.py")
    build_py = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(build_py)
    assert huffman_header() == build_py.gen_table()


# -- the engine's routing ----------------------------------------------------


def backend(name: str):
    """A port HttpServer answering ``name``, a chunked body on
    /chunked and the request body on /echo-body."""
    async def handle(req):
        if req.uri == "/echo-body":
            return Response(200, body=req.body)
        if req.uri == "/chunked":
            async def gen():
                yield b"hello "
                yield b"world"
            return Response(200, body_stream=gen())
        return Response(200, body=name.encode())

    return serve(FnService(handle))


async def exchange(port: int, head: bytes, body: bytes = b"", r_w=None):
    """One request on a fresh (or the given) connection; returns
    (status, headers, body, (reader, writer))."""
    r, w = r_w or await bounded(asyncio.open_connection("127.0.0.1", port))
    w.write(head + b"\r\n" + body)
    await bounded(w.drain())
    raw = await bounded(r.readuntil(b"\r\n\r\n"))
    lines = raw.decode().split("\r\n")
    status = int(lines[0].split()[1])
    headers = dict((k.strip().lower(), v.strip()) for k, _, v in
                   (ln.partition(":") for ln in lines[1:] if ln))
    if headers.get("transfer-encoding", "").lower() == "chunked":
        data = b""
        while not data.endswith(b"0\r\n\r\n"):
            data += await bounded(r.read(64))
        return status, headers, data, (r, w)
    n = int(headers.get("content-length", 0))
    data = await bounded(r.readexactly(n)) if n else b""
    return status, headers, data, (r, w)


def test_routes_by_host_and_answers_each(libs):
    async def go():
        eng = native.FastPathEngine()
        port = eng.listen("127.0.0.1", 0)
        eng.start()
        a, b = await backend("svc-a"), await backend("svc-b")
        try:
            eng.set_route("a", [("127.0.0.1", a.bound_port)])
            eng.set_route("B", [("127.0.0.1", b.bound_port)])
            got = []
            for host in ("a", "b", "A"):
                status, _, body, (_, w) = await exchange(
                    port, f"GET / HTTP/1.1\r\nHost: {host}\r\n".encode())
                w.close()
                got.append((status, body))
            assert got == [(200, b"svc-a"), (200, b"svc-b"), (200, b"svc-a")]
            assert eng.drain_misses() == []
            snap = eng.stats()
            assert snap["routes"]["a"]["requests"] == 2
            assert snap["routes"]["b"]["success"] == 1
        finally:
            eng.close()
            await bounded(a.close())
            await bounded(b.close())

    run(go())


def test_chunked_response_streams(libs):
    async def go():
        eng = native.FastPathEngine()
        port = eng.listen("127.0.0.1", 0)
        eng.start()
        d = await backend("c")
        try:
            eng.set_route("c", [("127.0.0.1", d.bound_port)])
            status, headers, body, (_, w) = await exchange(
                port, b"GET /chunked HTTP/1.1\r\nHost: c\r\n")
            w.close()
            assert status == 200 and headers["transfer-encoding"] == "chunked"
            assert b"hello " in body and b"world" in body
        finally:
            eng.close()
            await bounded(d.close())

    run(go())


def test_upstream_connection_is_pooled(libs):
    """Sequential requests on one client connection reuse one upstream
    connection."""
    async def go():
        eng = native.FastPathEngine()
        port = eng.listen("127.0.0.1", 0)
        eng.start()
        seen = set()

        async def handle(r, w):
            seen.add(w.get_extra_info("peername"))
            try:
                while True:
                    await r.readuntil(b"\r\n\r\n")
                    w.write(b"HTTP/1.1 200 OK\r\nContent-Length: 2\r\n\r\nok")
                    await w.drain()
            except (asyncio.IncompleteReadError, ConnectionError):
                pass
            finally:
                w.close()

        srv = await asyncio.start_server(handle, "127.0.0.1", 0)
        try:
            eng.set_route("p", [("127.0.0.1",
                                 srv.sockets[0].getsockname()[1])])
            conn = None
            for _ in range(20):
                status, _, body, conn = await exchange(
                    port, b"GET / HTTP/1.1\r\nHost: p\r\n", r_w=conn)
                assert (status, body) == (200, b"ok")
            conn[1].close()
            assert len(seen) == 1
        finally:
            eng.close()
            srv.close()

    run(go())


def test_request_body_forwarded(libs):
    async def go():
        eng = native.FastPathEngine()
        port = eng.listen("127.0.0.1", 0)
        eng.start()
        d = await backend("x")
        try:
            eng.set_route("b", [("127.0.0.1", d.bound_port)])
            status, _, body, (_, w) = await exchange(
                port, b"GET /echo-body HTTP/1.1\r\nHost: b\r\n"
                      b"Content-Length: 11\r\n", b"payload-123")
            w.close()
            assert (status, body) == (200, b"payload-123")
        finally:
            eng.close()
            await bounded(d.close())

    run(go())


# -- the scorer: the two libraries on the same blobs --------------------------


@pytest.mark.parametrize("quant", QUANTS)
def test_score_eval_is_bit_equal_to_the_reference_library(libs, quant):
    snap = snapshot(1)
    blob = export.export_weight_blob(snap, 3, quant)
    assert blob == ref_export.export_weight_blob(
        ref_store.decode_snapshot(store.encode_snapshot(snap)), 3, quant)
    x = rows_for(snap, 2, 257)
    got = native.score_eval(blob, x)
    want = ref_native.score_eval(blob, x)
    assert got.dtype == np.float32 and np.array_equal(got, want)
    assert native.score_blob_info(blob) == ref_native.score_blob_info(blob)
    assert native.score_feature_dim() == ref_native.score_feature_dim() == 36


@pytest.mark.parametrize("quant", QUANTS)
def test_score_eval_route_is_bit_equal_to_the_reference_library(libs, quant):
    base, heads = snapshot(1), [snapshot(s) for s in (4, 5)]
    keys = [export.route_hash(f"/svc/{i}") for i in range(2)]
    bank = export.export_bank_blob(
        base, 3, 7, {k: (i + 1, h) for i, (k, h) in
                     enumerate(zip(keys, heads))}, quant)
    x = rows_for(base, 3, 64)
    for key, spec in ((keys[0], True), (keys[1], True), (99, False)):
        got, got_spec = native.score_eval_route(bank, key, x)
        want, want_spec = ref_native.score_eval_route(bank, key, x)
        assert (got_spec, want_spec) == (spec, spec)
        assert np.array_equal(got, want)


# -- the engine's in-plane scores ---------------------------------------------


def test_engine_scores_against_the_plain_forward(libs):
    """Loopback requests on three routes through an engine holding the
    port's f32 blob: every row after the publish arrives scored, and its
    score matches the float32 plain forward of the snapshot on the
    engine's own features (drift replayed per row, as the engine keeps
    it) within 1e-5, and the bf16 plain scorer within the reference's
    bf16-vs-f32 bounds."""
    snap = snapshot(7)
    blob = export.export_weight_blob(snap, 5)

    async def go():
        eng = native.FastPathEngine()
        port = eng.listen("127.0.0.1", 0)
        eng.start()

        async def handle(req):
            size = int(req.uri.strip("/") or 1)
            return Response(503 if size % 7 == 0 else 200,
                            body=b"x" * size)

        d = await serve(FnService(handle))
        try:
            for host in ("r0", "r1", "r2"):
                eng.set_route(host, [("127.0.0.1", d.bound_port)])
                col, sign = path_hash_cols(f"/svc/{host}")
                assert eng.set_route_feature(host, col, sign)
                assert eng.set_route_hash(host, export.route_hash(
                    f"/svc/{host}"))
            assert not eng.set_route_feature("ghost", 3, 1.0)
            conn = None
            for i in range(6):  # before the publish: unscored
                _, _, _, conn = await exchange(
                    port, f"GET /{i + 1} HTTP/1.1\r\nHost: r0\r\n"
                    .encode(), r_w=conn)
            eng.publish_weights(blob)
            rng = np.random.default_rng(11)
            for i in range(60):
                host = f"r{i % 3}"
                _, _, _, conn = await exchange(
                    port, f"GET /{int(rng.integers(1, 4000))} HTTP/1.1\r\n"
                    f"Host: {host}\r\n".encode(), r_w=conn)
            conn[1].close()
            rows = eng.drain_features()
            stats = eng.stats()
        finally:
            eng.close()
            await bounded(d.close())
        return rows, stats

    rows, stats = run(go())
    assert rows.shape == (66, NATIVE_ROW_WIDTH)
    assert (rows[:6, NATIVE_COL_SCORED] == 0).all()
    assert (rows[6:, NATIVE_COL_SCORED] == 1).all()
    ns = stats["native_scorer"]
    assert (ns["scored"], ns["unscored"], ns["version"]) == (60, 6, 5)
    ids = {int(r["id"]): h for h, r in stats["routes"].items()}
    x = chip_smoke.engine_features(rows, lambda rid: f"/svc/{ids[rid]}")
    got = rows[6:, NATIVE_COL_SCORE]
    assert np.abs(got - native.score_eval(blob, x[6:])).max() <= F32_ATOL
    f32 = plain_scores(snap, x[6:], torch.float32)
    assert np.abs(got - f32).max() <= F32_ATOL
    gap = np.abs(got - plain_scores(snap, x[6:], torch.bfloat16))
    assert gap.max() < BF16_MAX and gap.mean() < BF16_MEAN


# -- rejected blobs -----------------------------------------------------------


def resealed(blob: bytes, offset: int, value: int) -> bytes:
    body = bytearray(blob[:-4])
    struct.pack_into("<I", body, offset, value)
    return bytes(body) + struct.pack("<I", zlib.crc32(bytes(body)))


def test_bad_blobs_are_rejected_and_the_serving_weights_stay(libs):
    snap = snapshot(2)
    ok = export.export_weight_blob(snap, 1)
    flipped = bytearray(ok)
    flipped[len(ok) // 2] ^= 0x40
    wrong_dim = resealed(ok, 16, 35)  # in_dim 36 -> 35, CRC valid
    eng, slab = native.FastPathEngine(), native.ScoreSlab()
    try:
        eng.publish_weights(ok)
        slab.publish(ok)
        for bad, why in ((bytes(flipped), "crc"), (wrong_dim, None)):
            with pytest.raises(ValueError, match=why):
                eng.publish_weights(bad)
            with pytest.raises(ValueError, match=why):
                slab.publish(bad)
            with pytest.raises(ValueError):
                native.score_blob_info(bad)
        assert slab.stats()["version"] == 1
        assert eng.stats()["native_scorer"]["version"] == 1
        x = rows_for(snap, 4, 8)
        assert np.array_equal(slab.score(x), native.score_eval(ok, x))
    finally:
        eng.close()
        slab.close()
    with pytest.raises(RuntimeError, match="closed"):
        eng.publish_weights(ok)


def test_stale_or_corrupt_deltas_are_rejected(libs):
    base, head = snapshot(1), snapshot(3)
    key = export.route_hash("/svc/a")
    bank = export.export_bank_blob(base, 1, 4, {}, "f32")
    stale = export.export_delta_blob(3, 5, upserts={key: (1, head)})
    good = export.export_delta_blob(4, 5, upserts={key: (1, head)})
    corrupt = bytearray(good)
    corrupt[len(good) // 2] ^= 0x10
    eng, slab = native.FastPathEngine(), native.ScoreSlab()
    try:
        for target in (eng, slab):
            publish = (target.publish_weights if target is eng
                       else target.publish)
            publish(bank)
            for bad in (stale, bytes(corrupt)):
                with pytest.raises(ValueError, match="delta blob rejected"):
                    target.publish_delta(bad)
            target.publish_delta(good)
        assert slab.stats()["generation"] == 5
        assert eng.stats()["native_scorer"]["generation"] == 5
        x = rows_for(base, 5, 8)
        got, spec = slab.score_route(x, key)
        assert spec.all()
    finally:
        eng.close()
        slab.close()
