"""gRPC client/server dispatchers over h2 request/response.

Ref: grpc/runtime/.../ServerDispatcher.scala:8-170 (the four rpc shapes:
Unary/Stream request x Unary/Stream response) and ClientDispatcher.scala:131.
A service is declared as a ``ServiceDef`` of ``Rpc``s; the server side is a
plain ``Service[H2Request, H2Response]`` so it can sit behind the h2 server
or the h2 router unchanged.
"""

from __future__ import annotations

import asyncio
import inspect
from typing import Any, AsyncIterator, Callable, Dict, List, Optional, Type

from linkerd_tpu_torch.grpc.codec import Codec
from linkerd_tpu_torch.grpc.status import (
    GrpcError, GrpcStatus, INTERNAL, OK, UNAVAILABLE, UNIMPLEMENTED, UNKNOWN,
)
from linkerd_tpu_torch.grpc.stream import DecodingStream, EncodingStream, GrpcStream
from linkerd_tpu_torch.grpc.proto import ProtoMessage
from linkerd_tpu_torch.protocol.h2.messages import H2Request, H2Response, Headers
from linkerd_tpu_torch.protocol.h2.stream import H2Stream
from linkerd_tpu_torch.router.service import Service

CONTENT_TYPE = "application/grpc+proto"


class Rpc:
    """One method of a gRPC service."""

    __slots__ = ("name", "req_cls", "rep_cls", "client_streaming",
                 "server_streaming")

    def __init__(self, name: str, req_cls: Type[ProtoMessage],
                 rep_cls: Type[ProtoMessage],
                 client_streaming: bool = False,
                 server_streaming: bool = False):
        self.name = name
        self.req_cls = req_cls
        self.rep_cls = rep_cls
        self.client_streaming = client_streaming
        self.server_streaming = server_streaming


class ServiceDef:
    """A named gRPC service: ``full_name`` like ``io.linkerd.mesh.Interpreter``."""

    def __init__(self, full_name: str, rpcs: List[Rpc]):
        self.full_name = full_name
        self.rpcs = {r.name: r for r in rpcs}

    def path_of(self, rpc: str) -> str:
        return f"/{self.full_name}/{rpc}"


async def _drain_into(result: Any, enc: EncodingStream) -> None:
    """Pump a handler's streaming result (GrpcStream / async iterator /
    plain iterable) into the response encoder, then close with a status."""
    try:
        if hasattr(result, "__aiter__"):
            async for msg in result:
                enc.send(msg)
                if enc.is_broken:
                    break
        else:
            for msg in result:
                enc.send(msg)
                if enc.is_broken:
                    break
        enc.close(GrpcStatus(OK))
    except GrpcError as e:
        enc.close(e.status)
    except asyncio.CancelledError:
        enc.close(GrpcStatus(INTERNAL, "canceled"))
        raise
    except Exception as e:  # noqa: BLE001 - handler faults become INTERNAL
        enc.close(GrpcStatus(INTERNAL, f"{type(e).__name__}: {e}"))


class ServerDispatcher(Service[H2Request, H2Response]):
    """Routes ``/<service>/<rpc>`` h2 requests to registered handlers.

    Handler signatures by rpc shape:
      unary-unary    async (req) -> rep
      unary-stream   async (req) -> async-iter[rep]   (or GrpcStream)
      stream-unary   async (DecodingStream) -> rep
      stream-stream  async (DecodingStream) -> async-iter[rep]
    """

    def __init__(self) -> None:
        self._routes: Dict[str, tuple] = {}
        self._tasks: set = set()

    def register(self, svc: ServiceDef, rpc_name: str,
                 handler: Callable) -> None:
        rpc = svc.rpcs[rpc_name]
        self._routes[svc.path_of(rpc_name)] = (rpc, handler)

    def register_all(self, svc: ServiceDef,
                     handlers: Dict[str, Callable]) -> None:
        for name, h in handlers.items():
            self.register(svc, name, h)

    def _spawn(self, coro) -> None:
        task = asyncio.ensure_future(coro)
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)

    async def __call__(self, req: H2Request) -> H2Response:
        route = self._routes.get(req.path)
        rsp_stream = H2Stream()
        rsp = H2Response(status=200,
                         headers=Headers([("content-type", CONTENT_TYPE)]),
                         stream=rsp_stream)
        if route is None:
            enc = EncodingStream(rsp_stream, None)
            enc.close(GrpcStatus(UNIMPLEMENTED, f"unknown rpc {req.path}"))
            return rsp
        rpc, handler = route
        enc = EncodingStream(rsp_stream, Codec(rpc.rep_cls))

        async def run() -> None:
            try:
                reqs = DecodingStream(req.stream, Codec(rpc.req_cls))
                if rpc.client_streaming:
                    arg: Any = reqs
                else:
                    try:
                        arg = await reqs.recv()
                    except StopAsyncIteration:
                        raise GrpcError.of(INTERNAL, "missing request message")
                result = handler(arg)
                if inspect.isawaitable(result):
                    result = await result
                if rpc.server_streaming:
                    await _drain_into(result, enc)
                else:
                    enc.send(result)
                    enc.close(GrpcStatus(OK))
            except GrpcError as e:
                enc.close(e.status)
            except asyncio.CancelledError:
                enc.close(GrpcStatus(INTERNAL, "canceled"))
                raise
            except Exception as e:  # noqa: BLE001
                enc.close(GrpcStatus(INTERNAL, f"{type(e).__name__}: {e}"))

        self._spawn(run())
        return rsp

    async def close(self) -> None:
        for t in list(self._tasks):
            t.cancel()


class ClientDispatcher:
    """Typed client stub machinery over any h2 ``Service``.

    ``svc`` may be a raw ``H2Client`` or a full router client stack — the
    dispatcher only shapes requests (ref: ClientDispatcher.scala).
    """

    def __init__(self, svc: Service[H2Request, H2Response],
                 authority: str = ""):
        self._svc = svc
        self._authority = authority

    def _mk_request(self, path: str, stream: H2Stream) -> H2Request:
        return H2Request(
            method="POST", path=path, scheme="http",
            authority=self._authority,
            headers=Headers([("content-type", CONTENT_TYPE), ("te", "trailers")]),
            stream=stream,
        )

    async def call_stream(self, svc_def: ServiceDef, rpc_name: str,
                          req_msgs: "GrpcStream | List[ProtoMessage]",
                          ) -> DecodingStream:
        """Generic entry: send request message(s), return response stream."""
        rpc = svc_def.rpcs[rpc_name]
        req_stream = H2Stream()
        enc = EncodingStream(req_stream, Codec(rpc.req_cls))
        req = self._mk_request(svc_def.path_of(rpc_name), req_stream)

        if isinstance(req_msgs, list):
            # Unary/known request set: encode synchronously so the h2
            # engine sees a fully-buffered body (const-body fast path — no
            # pump task, headers+data+eos coalesce into one write).
            for m in req_msgs:
                enc.send(m)
            enc.close_eos()
            pump = None
        else:
            async def pump_reqs() -> None:
                try:
                    async for m in req_msgs:
                        enc.send(m)
                    enc.close_eos()
                except Exception:  # noqa: BLE001 - reset request side
                    req_stream.reset()

            pump = asyncio.ensure_future(pump_reqs())
        try:
            rsp = await self._svc(req)
        except Exception:
            if pump is not None:
                pump.cancel()
            raise
        reps = DecodingStream(rsp.stream, Codec(rpc.rep_cls))
        # Trailers-Only responses (single HEADERS + END_STREAM carrying
        # grpc-status — how conformant servers send immediate errors) and
        # non-200 proxy responses resolve the status up front.
        if rsp.status != 200:
            reps.resolve_status(GrpcStatus(
                UNAVAILABLE, f"non-200 response: {rsp.status}"))
        else:
            code_s = rsp.headers.get("grpc-status")
            if code_s is not None:
                from urllib.parse import unquote
                try:
                    code = int(code_s)
                except ValueError:
                    code = UNKNOWN
                reps.resolve_status(GrpcStatus(
                    code, unquote(rsp.headers.get("grpc-message") or "")))
        return reps

    async def unary(self, svc_def: ServiceDef, rpc_name: str,
                    req_msg: ProtoMessage) -> ProtoMessage:
        reps = await self.call_stream(svc_def, rpc_name, [req_msg])
        try:
            rep = await reps.recv()
        except StopAsyncIteration:
            raise GrpcError.of(INTERNAL, "empty unary response")
        # Drain trailers so the terminal status resolves; a non-OK status
        # after the reply is authoritative (the rpc FAILED) and propagates.
        try:
            while True:
                await reps.recv()
        except StopAsyncIteration:
            pass
        return rep

    async def server_stream(self, svc_def: ServiceDef, rpc_name: str,
                            req_msg: ProtoMessage) -> DecodingStream:
        return await self.call_stream(svc_def, rpc_name, [req_msg])
