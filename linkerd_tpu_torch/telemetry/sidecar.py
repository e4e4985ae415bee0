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

``ScorerService`` holds the request handlers without any transport.
``ScorerSidecar`` serves them, and ``GrpcScorerClient`` calls them, over
the port's own gRPC runtime (``grpc/dispatch.py`` on ``protocol/h2``)
where the reference uses grpcio: the wire is the reference's, byte for
byte, and the port needs no ``grpc`` package.
"""

from __future__ import annotations

import asyncio
import contextvars
import json
import logging
import struct
import time
from typing import Optional, Tuple

import numpy as np

from linkerd_tpu_torch.grpc.dispatch import (
    ClientDispatcher, Rpc, ServerDispatcher, ServiceDef,
)
from linkerd_tpu_torch.grpc.status import (
    CANCELED, DEADLINE_EXCEEDED, UNKNOWN, GrpcError,
)
from linkerd_tpu_torch.lifecycle.store import decode_snapshot, encode_snapshot
from linkerd_tpu_torch.protocol.h2.client import H2Client
from linkerd_tpu_torch.protocol.h2.frames import CANCEL
from linkerd_tpu_torch.protocol.h2.messages import H2Request, H2Response
from linkerd_tpu_torch.protocol.h2.server import H2Server
from linkerd_tpu_torch.protocol.h2.stream import StreamReset
from linkerd_tpu_torch.router.service import Service

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


class RawBytes:
    """A gRPC message that is its payload's bytes as they are: the
    scorer's methods carry their own codec (above), not protobuf, so
    this stands where ``grpc.codec.Codec`` expects a message class."""

    __slots__ = ("data",)

    def __init__(self, data: bytes = b""):
        self.data = data

    def encode(self) -> bytes:
        return self.data

    @classmethod
    def decode(cls, data: bytes) -> "RawBytes":
        return cls(bytes(data))


SCORER = ServiceDef(SERVICE, [Rpc(m, RawBytes, RawBytes) for m in METHODS])

# the h2 request a server-side call serves, and the response streams of
# a client-side call: set per call, read where the dispatchers hand over
# only messages
_REQUEST: contextvars.ContextVar = contextvars.ContextVar("scorer_request")
_RESPONSES: contextvars.ContextVar = contextvars.ContextVar(
    "scorer_responses")
RESET_POLL_S = 0.005  # how often a served call looks for its peer's reset


async def _until_reset(stream) -> None:
    """Returns once the request ``stream`` is reset: the caller sent
    RST_STREAM (its deadline passed) or its connection went."""
    while not stream.is_reset:
        if stream.at_end:
            await asyncio.sleep(RESET_POLL_S)
            continue
        try:
            (await stream.read()).release()
        except StreamReset:
            return


class _Requests(Service):
    """The dispatcher behind the h2 server, with each call's request
    in reach of its handler."""

    def __init__(self, dispatcher: ServerDispatcher):
        self.dispatcher = dispatcher

    async def __call__(self, req: H2Request) -> H2Response:
        _REQUEST.set(req)  # the dispatcher's handler task copies it
        return await self.dispatcher(req)


class _Responses(Service):
    """The h2 client under the dispatcher, noting each call's response
    stream, so that a call past its deadline can be reset."""

    def __init__(self, client: H2Client):
        self.client = client

    async def __call__(self, req: H2Request) -> H2Response:
        rsp = await self.client(req)
        _RESPONSES.get([]).append(rsp.stream)
        return rsp


def _reset(client: H2Client, stream) -> None:
    """RST_STREAM CANCEL the call whose response is ``stream``, as
    grpcio does when a deadline passes, so that the server stops its
    handler. The h2 client has no reset for a stream whose response
    headers came; the connection's ``shed_stream`` is that reset."""
    for conn in (client._conn, *client._draining):  # noqa: SLF001
        if conn is None:
            continue
        for sid, st in list(conn._streams.items()):  # noqa: SLF001
            if st.recv_stream is stream:
                conn.shed_stream(sid, CANCEL)
                return


class ScorerSidecar:
    """The four unary RPCs of ``io.l5d.anomaly.Scorer`` over a
    ``ScorerService``, served by the port's gRPC runtime
    (``grpc.dispatch.ServerDispatcher`` on ``protocol.h2``'s
    ``H2Server``). With no ``scorer`` it builds an ``InProcessScorer``
    on the CUDA device. A handler whose caller resets the call is
    cancelled, as grpcio's server cancels it; a handler's exception
    answers UNKNOWN, in grpcio's words."""

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
        self._dispatcher: Optional[ServerDispatcher] = None
        self._server: Optional[H2Server] = None

    @staticmethod
    def _rpc(handle):
        async def call(msg: RawBytes) -> RawBytes:
            work = asyncio.ensure_future(handle(msg.data))
            reset = asyncio.ensure_future(_until_reset(_REQUEST.get().stream))
            try:
                await asyncio.wait((work, reset),
                                   return_when=asyncio.FIRST_COMPLETED)
            finally:
                reset.cancel()
                if not work.done():
                    work.cancel()
            if work.cancelled():
                raise GrpcError.of(CANCELED, "call reset by the client")
            exc = work.exception()
            if exc is not None:
                raise GrpcError.of(UNKNOWN, f"Unexpected {type(exc)}: {exc}")
            return RawBytes(work.result())
        return call

    async def start(self) -> "ScorerSidecar":
        svc = self.service
        self._dispatcher = ServerDispatcher()
        self._dispatcher.register_all(SCORER, {
            m: self._rpc(getattr(svc, f"handle_{m.lower()}"))
            for m in METHODS})
        # warm up before serving, so no real request races the warmup
        if self.warmup_rows:
            await self.scorer.warmup(self.warmup_rows)
        self._server = await H2Server(
            _Requests(self._dispatcher), self.host, self.port).start()
        self.port = self._server.bound_port
        return self

    async def close(self) -> None:
        if self._server is not None:
            await self._server.close()
            await self._dispatcher.close()
        self.scorer.close()  # release the dispatch ring and its drainer


class GrpcScorerClient:
    """Client for a scorer sidecar: score, fit, snapshot, restore, over
    the port's gRPC runtime (``grpc.dispatch.ClientDispatcher`` on
    ``protocol.h2``'s ``H2Client``, one connection, re-made after a
    failure). A call past its deadline is reset and raises
    DEADLINE_EXCEEDED; a non-OK status, a reset stream or a refused
    connection raises too."""

    def __init__(self, address: str, timeout_s: float = 5.0,
                 first_timeout_s: float = 60.0):
        # the first call of each RPC into each batch bucket gets the long
        # deadline, to absorb the sidecar's first-use kernel build and
        # its first training step
        self.address = address
        self.timeout_s = timeout_s
        self.first_timeout_s = first_timeout_s
        self._warm: set = set()
        # the last Score call's {rpc_ms, bytes}, which scorer spans read
        self.last_timing: Optional[dict] = None
        self._channel: Optional[H2Client] = None
        self._dispatch: Optional[ClientDispatcher] = None
        self._closing: Optional[asyncio.Task] = None

    def _ensure(self) -> ClientDispatcher:
        if self._channel is None:
            host, _, port = self.address.rpartition(":")
            self._channel = H2Client(host, int(port))
            self._dispatch = ClientDispatcher(_Responses(self._channel))
        return self._dispatch

    async def _call(self, method: str, payload: bytes,
                    timeout: float) -> bytes:
        dispatch, channel = self._ensure(), self._channel
        streams: list = []
        _RESPONSES.set(streams)
        try:
            rep = await asyncio.wait_for(
                dispatch.unary(SCORER, method, RawBytes(payload)), timeout)
        except asyncio.TimeoutError:
            for stream in streams:
                _reset(channel, stream)
            raise GrpcError.of(
                DEADLINE_EXCEEDED, f"{method}: no answer in {timeout} s")
        return rep.data

    async def _bucketed(self, method: str, rows: int,
                        payload: bytes) -> bytes:
        key = (method, bucket_rows(rows))
        timeout = self.timeout_s if key in self._warm else self.first_timeout_s
        rsp = await self._call(method, payload, timeout)
        self._warm.add(key)
        return rsp

    async def score(self, x: np.ndarray) -> np.ndarray:
        payload = encode_matrix(x)
        t0 = time.monotonic()
        rsp = await self._bucketed("Score", len(x), payload)
        self.last_timing = {"rpc_ms": (time.monotonic() - t0) * 1e3,
                            "bytes": len(payload) + len(rsp)}
        return np.frombuffer(rsp, np.float32)

    async def fit(self, x: np.ndarray, labels: np.ndarray,
                  mask: np.ndarray) -> float:
        rsp = await self._bucketed("Fit", len(x),
                                   encode_fit(x, labels, mask))
        return float(np.frombuffer(rsp, np.float32)[0])

    async def snapshot(self):
        rsp = await self._call("Snapshot", b"", self.first_timeout_s)
        return decode_snapshot(rsp)

    async def restore(self, snap) -> int:
        """Hot-swap ``snap`` into the sidecar; returns the restored step."""
        rsp = await self._call("Restore", encode_snapshot(snap),
                               self.first_timeout_s)
        return struct.unpack("<Q", rsp)[0]

    async def aclose(self) -> None:
        """Close the connection and wait for it (before the loop ends)."""
        if self._channel is not None:
            ch, self._channel = self._channel, None
            await ch.close()

    def close(self) -> None:
        """Close the connection without waiting: on the running loop as
        a task this client keeps; with no loop running (interpreter
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
    replica on the CUDA device (``--device cpu``: the plain path on the
    CPU) until SIGINT/SIGTERM, optionally announced through the fs
    announcer, so that linkers resolve it as any other service
    (``sidecarAddress: /#/io.l5d.fs/<name>``). It prints
    ``SCORER_SIDECAR host:port`` once it serves, and on its way out
    ``SCORER_SIDECAR_DONE`` with the rows it scored and the kernel's
    launches in this process."""
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
    parser.add_argument(
        "--device", default=None,
        help="the scorer's device: the CUDA device unless 'cpu' is named")
    args = parser.parse_args()

    async def amain() -> None:
        from linkerd_tpu_torch.ops.scoring import fused_anomaly_scores
        from linkerd_tpu_torch.telemetry.anomaly import InProcessScorer

        sidecar = await ScorerSidecar(
            scorer=InProcessScorer(device=args.device),
            host=args.host, port=args.port,
            warmup_rows=args.warmup_rows).start()
        launches = fused_anomaly_scores.launches  # the warm-up's
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
        print("SCORER_SIDECAR_DONE " + json.dumps({
            "rows_scored": sidecar.service.rows_scored,
            "kernel_launches": fused_anomaly_scores.launches - launches}),
            flush=True)

    logging.basicConfig(level=logging.INFO)
    asyncio.run(amain())


if __name__ == "__main__":
    main()
