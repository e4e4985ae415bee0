"""gRPC scorer sidecar on the port: counterpart of
``linkerd_tpu/telemetry/sidecar.py``, on the same wire.

Routers micro-batch feature rows over gRPC to a separate scorer
process. Service ``io.l5d.anomaly.Scorer``, raw-bytes methods:

- ``Score``:    request  = u32 n | u32 d | f32[n*d] features
                response = f32[n] scores
- ``Fit``:      request  = u32 n | u32 d | f32[n*d] x | f32[n] labels |
                           f32[n] mask
                response = f32[1] loss
- ``Snapshot``: request  = (empty)
                response = serialized ModelSnapshot (``lifecycle.store``)
- ``Restore``:  request  = serialized ModelSnapshot
                response = u64 restored step counter

``ScorerService`` holds the request handlers without any transport;
``ScorerSidecar`` binds them to a ``grpc.aio`` server. ``grpc`` is
imported only where a server or channel is made, so the package imports
where it is not installed.
"""

from __future__ import annotations

import asyncio
import logging
import struct
from typing import Optional, Tuple

import numpy as np

from linkerd_tpu_torch.lifecycle.store import decode_snapshot, encode_snapshot

log = logging.getLogger(__name__)

SERVICE = "io.l5d.anomaly.Scorer"
METHODS = ("Score", "Fit", "Snapshot", "Restore")


def bucket_rows(n: int) -> int:
    """Power-of-two batch bucket: the scorer's dispatch ring keeps one
    slot pair per bucket, and the client keys its first-call deadlines
    by it."""
    return 1 << max(0, n - 1).bit_length()


def encode_matrix(x: np.ndarray) -> bytes:
    x = np.ascontiguousarray(x, dtype=np.float32)
    if x.ndim != 2:
        raise ValueError(f"encode_matrix wants [n, d], got shape {x.shape}")
    n, d = x.shape
    return struct.pack("<II", n, d) + x.tobytes()


def decode_matrix(data: bytes) -> np.ndarray:
    if len(data) < 8:
        raise ValueError(
            f"truncated matrix payload: {len(data)} bytes, need >= 8")
    n, d = struct.unpack_from("<II", data)
    need = 8 + 4 * n * d
    if len(data) != need:
        # exactly one matrix: short payloads and trailing bytes are both
        # framing faults at the producer
        raise ValueError(
            f"bad matrix payload: {len(data)} bytes, "
            f"need exactly {need} for {n}x{d} f32")
    arr = np.frombuffer(data, dtype=np.float32, offset=8, count=n * d)
    return arr.reshape(n, d)


def encode_fit(x: np.ndarray, labels: np.ndarray, mask: np.ndarray) -> bytes:
    labels = np.ascontiguousarray(labels, np.float32)
    mask = np.ascontiguousarray(mask, np.float32)
    n = x.shape[0]
    if labels.shape != (n,) or mask.shape != (n,):
        raise ValueError(
            f"encode_fit row mismatch: x has {n} rows, labels "
            f"{labels.shape}, mask {mask.shape}")
    return encode_matrix(x) + labels.tobytes() + mask.tobytes()


def decode_fit(data: bytes) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    if len(data) < 8:
        raise ValueError(
            f"truncated fit payload: {len(data)} bytes, need >= 8")
    n, d = struct.unpack_from("<II", data)
    need = 8 + 4 * (n * d + 2 * n)
    if len(data) != need:
        raise ValueError(
            f"bad fit payload: {len(data)} bytes, need exactly {need} "
            f"for {n}x{d} f32 + 2x{n} f32")
    off = 8
    x = np.frombuffer(data, np.float32, n * d, off).reshape(n, d)
    off += 4 * n * d
    labels = np.frombuffer(data, np.float32, n, off)
    off += 4 * n
    mask = np.frombuffer(data, np.float32, n, off)
    return x, labels, mask


class ScorerService:
    """The sidecar's request handlers on wire bytes, without transport.
    ``rows_scored`` counts the rows answered by ``handle_score``."""

    def __init__(self, scorer):
        self.scorer = scorer
        self.rows_scored = 0

    async def handle_score(self, request: bytes) -> bytes:
        x = decode_matrix(request)
        s = await self.scorer.score(x)
        self.rows_scored += len(x)
        return np.ascontiguousarray(s, np.float32).tobytes()

    async def handle_fit(self, request: bytes) -> bytes:
        x, labels, mask = decode_fit(request)
        loss = await self.scorer.fit(x, labels, mask)
        return np.float32([loss]).tobytes()

    async def handle_snapshot(self, request: bytes) -> bytes:
        snap = await asyncio.to_thread(self.scorer.snapshot)
        return encode_snapshot(snap)

    async def handle_restore(self, request: bytes) -> bytes:
        snap = decode_snapshot(request)
        await asyncio.to_thread(self.scorer.restore, snap)
        # echo the restored step so callers can confirm the swap
        return struct.pack("<Q", int(snap.step))


class ScorerSidecar:
    """grpc.aio server over a ``ScorerService``. With no ``scorer`` it
    builds an ``InProcessScorer`` on the CUDA device."""

    def __init__(self, scorer=None, host: str = "127.0.0.1", port: int = 0,
                 warmup_rows: int = 0):
        if scorer is None:
            from linkerd_tpu_torch.telemetry.anomaly import InProcessScorer
            scorer = InProcessScorer()
        self.scorer = scorer
        self.service = ScorerService(scorer)
        self.host = host
        self.port = port
        self.warmup_rows = warmup_rows
        self._server = None

    async def start(self) -> "ScorerSidecar":
        import grpc

        svc = self.service

        def rpc(handle):
            async def call(request: bytes, context) -> bytes:
                return await handle(request)
            return grpc.unary_unary_rpc_method_handler(
                call, request_deserializer=None, response_serializer=None)

        handler = grpc.method_handlers_generic_handler(SERVICE, {
            name: rpc(getattr(svc, f"handle_{name.lower()}"))
            for name in METHODS})
        self._server = grpc.aio.server()
        self._server.add_generic_rpc_handlers((handler,))
        self.port = self._server.add_insecure_port(f"{self.host}:{self.port}")
        # warm up before serving, so no real request races the warmup
        if self.warmup_rows:
            await self.scorer.warmup(self.warmup_rows)
        await self._server.start()
        return self

    async def close(self) -> None:
        if self._server is not None:
            await self._server.stop(grace=0.5)
        self.scorer.close()  # release the dispatch ring and its drainer


class GrpcScorerClient:
    """Client for a scorer sidecar: score, fit, snapshot, restore."""

    def __init__(self, address: str, timeout_s: float = 5.0,
                 first_timeout_s: float = 60.0):
        # the first call of each RPC into each batch bucket gets the long
        # deadline, to absorb the sidecar's first-use kernel build and
        # its first training step
        self.address = address
        self.timeout_s = timeout_s
        self.first_timeout_s = first_timeout_s
        self._warm: set = set()
        self._channel = None
        self._calls: dict = {}
        self._closing: Optional[asyncio.Task] = None

    def _ensure(self) -> None:
        if self._channel is None:
            import grpc

            self._channel = grpc.aio.insecure_channel(self.address)
            self._calls = {
                m: self._channel.unary_unary(
                    f"/{SERVICE}/{m}",
                    request_serializer=None, response_deserializer=None)
                for m in METHODS}

    async def _bucketed(self, method: str, rows: int,
                        payload: bytes) -> bytes:
        self._ensure()
        key = (method, bucket_rows(rows))
        timeout = self.timeout_s if key in self._warm else self.first_timeout_s
        rsp = await self._calls[method](payload, timeout=timeout)
        self._warm.add(key)
        return rsp

    async def score(self, x: np.ndarray) -> np.ndarray:
        rsp = await self._bucketed("Score", len(x), encode_matrix(x))
        return np.frombuffer(rsp, np.float32)

    async def fit(self, x: np.ndarray, labels: np.ndarray,
                  mask: np.ndarray) -> float:
        rsp = await self._bucketed("Fit", len(x),
                                   encode_fit(x, labels, mask))
        return float(np.frombuffer(rsp, np.float32)[0])

    async def snapshot(self):
        self._ensure()
        rsp = await self._calls["Snapshot"](b"",
                                            timeout=self.first_timeout_s)
        return decode_snapshot(rsp)

    async def restore(self, snap) -> int:
        """Hot-swap ``snap`` into the sidecar; returns the restored step."""
        self._ensure()
        rsp = await self._calls["Restore"](encode_snapshot(snap),
                                           timeout=self.first_timeout_s)
        return struct.unpack("<Q", rsp)[0]

    async def aclose(self) -> None:
        """Close the channel and wait for it (before the loop ends)."""
        if self._channel is not None:
            ch, self._channel = self._channel, None
            await ch.close()

    def close(self) -> None:
        """Close the channel without waiting: on the running loop as a
        task this client keeps; with no loop running (interpreter
        teardown) the socket goes with the process."""
        if self._channel is None:
            return
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            self._channel = None
            return
        ch, self._channel = self._channel, None
        self._closing = loop.create_task(ch.close())
        self._closing.add_done_callback(_log_close_failure)


def _log_close_failure(task: asyncio.Task) -> None:
    if not task.cancelled() and task.exception() is not None:
        log.warning("scorer channel close failed: %r", task.exception())


def announce_replica(announce_dir: str, name: str, host: str, port: int):
    """Register a replica at ``host:port`` under ``/<name>`` in an fs
    announcer's directory, as the reference's replicas register; the
    returned handle's ``close`` withdraws it."""
    from linkerd_tpu_torch.announcer import FsAnnouncer
    from linkerd_tpu_torch.core import Path

    return FsAnnouncer(announce_dir, Path.read("/io.l5d.fs")).announce(
        host, port, Path.read(f"/{name}"))


def main() -> None:
    """``python -m linkerd_tpu_torch.telemetry.sidecar``: serve a scorer
    replica on the CUDA device until SIGINT/SIGTERM, optionally
    announced through the fs announcer, so that linkers resolve it as
    any other service (``sidecarAddress: /#/io.l5d.fs/<name>``)."""
    import argparse
    import signal

    parser = argparse.ArgumentParser(
        description="linkerd-tpu anomaly scorer replica (PyTorch/CUDA)")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--warmup-rows", type=int, default=0)
    parser.add_argument(
        "--announce-dir", default=None,
        help="fs-announcer root dir (the fs namer's rootDir); when set "
             "the replica registers itself under --announce-name and "
             "withdraws on shutdown")
    parser.add_argument("--announce-name", default="l5d-scorer")
    args = parser.parse_args()

    async def amain() -> None:
        sidecar = await ScorerSidecar(
            host=args.host, port=args.port,
            warmup_rows=args.warmup_rows).start()
        announcement = None
        if args.announce_dir:
            announcement = announce_replica(
                args.announce_dir, args.announce_name, args.host,
                sidecar.port)
            log.info("scorer replica announced as %s in %s",
                     args.announce_name, args.announce_dir)
        print(f"SCORER_SIDECAR {args.host}:{sidecar.port}", flush=True)
        stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            loop.add_signal_handler(sig, stop.set)
        await stop.wait()
        if announcement is not None:
            announcement.close()
        await sidecar.close()

    logging.basicConfig(level=logging.INFO)
    asyncio.run(amain())


if __name__ == "__main__":
    main()
