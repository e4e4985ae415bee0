"""namerd's gRPC mesh interface: a copy of
``linkerd_tpu/namerd/mesh_iface.py``.

Ref: namerd/iface/mesh/.../{MeshIfaceInitializer,InterpreterService,
ResolverService,DelegatorService}.scala — serves bind/resolve/dtab state,
unary (Get*) and server-streaming (Stream*), pumping reactive state through
coalescing event streams (VarEventStream semantics). Kind ``io.l5d.mesh``,
default port 4321 (MeshIfaceInitializer.scala:60).
"""

from __future__ import annotations

import asyncio
import time
from typing import AsyncIterator, Optional

from linkerd_tpu_torch.core import Activity, Dtab, Path
from linkerd_tpu_torch.core.activity import Failed, Ok, Pending, State
from linkerd_tpu_torch.core.addr import Addr, BoundName
from linkerd_tpu_torch.core.nametree import Leaf, NameTree
from linkerd_tpu_torch.grpc import GrpcError, ServerDispatcher
from linkerd_tpu_torch.grpc.status import INVALID_ARGUMENT, NOT_FOUND, UNKNOWN
from linkerd_tpu_torch.mesh import (
    DELEGATOR_SVC, INTERPRETER_SVC, RESOLVER_SVC, converters, messages as m,
)
from linkerd_tpu_torch.namerd.core import Namerd
from linkerd_tpu_torch.telemetry.metrics import observed

DEFAULT_MESH_PORT = 4321


def _ns_of(root: Optional[m.MPath]) -> str:
    path = converters.path_from_proto(root)
    if len(path) == 0:
        raise GrpcError.of(INVALID_ARGUMENT, "empty mesh root")
    return "/".join(path)


async def _state_stream(act: Activity) -> AsyncIterator[State]:
    async for st in act.changes():
        yield st


def _first_leaf(tree: NameTree) -> Optional[BoundName]:
    if isinstance(tree, Leaf):
        return tree.value
    for sub in getattr(tree, "trees", ()):  # Alt
        found = _first_leaf(sub)
        if found is not None:
            return found
    for w in getattr(tree, "weighted", ()):  # Union
        found = _first_leaf(w.tree)
        if found is not None:
            return found
    return None


class MeshIface:
    """Registers the three mesh services on a ServerDispatcher.
    Per-method request/latency/failure stats plus a live-stream gauge
    land under ``namerd/mesh/*`` in the namerd MetricsTree."""

    def __init__(self, namerd: Namerd):
        self._namerd = namerd
        self._metrics = namerd.metrics.scope("namerd", "mesh")
        self._streams = 0
        self._metrics.gauge("streams", fn=lambda: float(self._streams))
        self.dispatcher = ServerDispatcher()
        self.dispatcher.register_all(INTERPRETER_SVC, {
            "GetBoundTree": self._unary("GetBoundTree",
                                        self.get_bound_tree),
            "StreamBoundTree": self._streaming("StreamBoundTree",
                                               self.stream_bound_tree),
        })
        self.dispatcher.register_all(RESOLVER_SVC, {
            "GetReplicas": self._unary("GetReplicas", self.get_replicas),
            "StreamReplicas": self._streaming("StreamReplicas",
                                              self.stream_replicas),
        })
        self.dispatcher.register_all(DELEGATOR_SVC, {
            "GetDtab": self._unary("GetDtab", self.get_dtab),
            "StreamDtab": self._streaming("StreamDtab", self.stream_dtab),
        })

    # ---- instrumentation ---------------------------------------------------

    def _unary(self, name: str, fn):
        node = self._metrics.scope(name)

        async def wrapped(req):
            with observed(node):
                return await fn(req)
        return wrapped

    def _streaming(self, name: str, fn):
        """Stream methods: count the open, gauge live streams, count
        per-update fan-out, and record time-to-first-response (the
        latency a linkerd waits before its first routable state)."""
        node = self._metrics.scope(name)
        requests = node.counter("requests")
        failures = node.counter("failures")
        updates = node.counter("updates")
        first_rsp = node.stat("first_response_ms")

        async def wrapped(req):
            requests.incr()
            t0 = time.monotonic()
            try:
                gen = await fn(req)
            except BaseException:
                failures.incr()
                raise

            async def counted():
                self._streams += 1
                first = True
                try:
                    async for rsp in gen:
                        if first:
                            first = False
                            first_rsp.add((time.monotonic() - t0) * 1e3)
                        updates.incr()
                        yield rsp
                except GrpcError:
                    failures.incr()
                    raise
                finally:
                    self._streams -= 1
            return counted()
        return wrapped

    # ---- Interpreter -------------------------------------------------------

    def _bind(self, req: m.MBindReq) -> Activity:
        ns = _ns_of(req.root)
        name = converters.path_from_proto(req.name)
        dtab = converters.dtab_from_proto(req.dtab)
        return self._namerd.interpreter(ns).bind(dtab, name)

    async def get_bound_tree(self, req: m.MBindReq) -> m.MBoundTreeRsp:
        act = self._bind(req)
        try:
            tree = await act.to_future()
            return m.MBoundTreeRsp(tree=converters.boundtree_to_proto(tree))
        finally:
            act.close()

    async def stream_bound_tree(self, req: m.MBindReq):
        act = self._bind(req)

        async def gen():
            last = None
            try:
                async for st in _state_stream(act):
                    if isinstance(st, Pending):
                        continue
                    if isinstance(st, Failed):
                        rsp = m.MBoundTreeRsp(
                            tree=m.MBoundNameTree(fail=m.MEmpty()))
                    else:
                        rsp = m.MBoundTreeRsp(
                            tree=converters.boundtree_to_proto(st.value))
                    enc = rsp.encode()
                    if enc != last:
                        last = enc
                        yield rsp
            finally:
                act.close()
        return gen()

    # ---- Resolver ----------------------------------------------------------

    def _resolve_addr(self, req: m.MReplicasReq) -> tuple:
        """(bind Activity over the id, extractor of Var[Addr] states)."""
        id_path = converters.path_from_proto(req.id)
        if len(id_path) == 0:
            raise GrpcError.of(INVALID_ARGUMENT, "empty replica id")
        # A concrete id (/#/... or /$/...) binds through the configured
        # namers with an empty dtab (ref: ResolverService.scala:103 —
        # resolution is by bound id, not by logical name).
        interp = self._namerd.interpreter("")
        return interp.bind(Dtab.empty(), id_path)

    async def get_replicas(self, req: m.MReplicasReq) -> m.MReplicas:
        act = self._resolve_addr(req)
        try:
            tree = await act.to_future()
            leaf = _first_leaf(tree)
            if leaf is None:
                return m.MReplicas(neg=m.MEmpty())
            # wait for the addr to leave pending so Get is useful
            addr = leaf.addr.sample()
            from linkerd_tpu_torch.core.addr import AddrPending
            if isinstance(addr, AddrPending):
                async for a in leaf.addr.changes():
                    if not isinstance(a, AddrPending):
                        addr = a
                        break
            return converters.addr_to_replicas(addr)
        finally:
            act.close()

    async def stream_replicas(self, req: m.MReplicasReq):
        act = self._resolve_addr(req)

        async def gen():
            last = None
            try:
                tree = await act.to_future()
                leaf = _first_leaf(tree)
                if leaf is None:
                    yield m.MReplicas(neg=m.MEmpty())
                    return
                async for addr in leaf.addr.changes():
                    rsp = converters.addr_to_replicas(addr)
                    enc = rsp.encode()
                    if enc != last:
                        last = enc
                        yield rsp
            except GrpcError:
                raise
            except Exception as e:  # noqa: BLE001 - bind failure -> failed
                yield m.MReplicas(
                    failed=m.MReplicasFailed(message=str(e)))
            finally:
                act.close()
        return gen()

    # ---- Delegator ---------------------------------------------------------

    def _vdtab_rsp(self, vd) -> m.MDtabRsp:
        return m.MDtabRsp(dtab=m.MVersionedDtab(
            version=m.MDtabVersion(id=vd.version),
            dtab=converters.dtab_to_proto(vd.dtab)))

    async def get_dtab(self, req: m.MDtabReq) -> m.MDtabRsp:
        ns = _ns_of(req.root)
        act = self._namerd.store.observe(ns)
        vd = await act.to_future()
        if vd is None:
            raise GrpcError.of(NOT_FOUND, f"no dtab namespace {ns!r}")
        return self._vdtab_rsp(vd)

    async def stream_dtab(self, req: m.MDtabReq):
        ns = _ns_of(req.root)
        act = self._namerd.store.observe(ns)

        async def gen():
            last = None
            async for st in _state_stream(act):
                if isinstance(st, Pending):
                    continue
                if isinstance(st, Failed):
                    raise GrpcError.of(UNKNOWN, str(st.exc))
                if st.value is None:
                    continue  # namespace absent: hold the stream open
                rsp = self._vdtab_rsp(st.value)
                enc = rsp.encode()
                if enc != last:
                    last = enc
                    yield rsp
        return gen()
