"""namerd's thrift long-poll interface (kind io.l5d.thriftNameInterpreter).

The reference's default linkerd<->namerd protocol: stamped ``bind`` /
``addr`` / ``delegate`` / ``dtab`` operations where the client echoes the
last stamp it saw and the server parks the call until the observed value
changes (long poll). Ref:
/root/reference/namerd/iface/interpreter-thrift/src/main/scala/io/buoyant/namerd/iface/ThriftNamerInterface.scala:1-573
(LocalStamper :75-80, Observer stamping :85-124, bindingCache :402,
addrCache :501) and the wire IDL transcribed in thrift_idl.py.

Stamps are 8-byte big-endian counters unique to this server instance; an
empty stamp means "reply with the current value immediately".

A copy of ``linkerd_tpu/namerd/thrift_iface.py``.
"""

from __future__ import annotations

import asyncio
import logging
import struct
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Tuple

from linkerd_tpu_torch.core import Dtab, Path, Var
from linkerd_tpu_torch.core.activity import Failed, Ok
from linkerd_tpu_torch.core.addr import (
    Addr, AddrNeg, Bound as AddrBound, BoundName,
)
from linkerd_tpu_torch.core.nametree import (
    Alt, Empty, Fail, Leaf, NameTree, Neg, Union as TreeUnion,
)
from linkerd_tpu_torch.namer import delegate as dg
from linkerd_tpu_torch.namerd import thrift_idl as idl
from linkerd_tpu_torch.namerd.core import Namerd
from linkerd_tpu_torch.protocol.thrift.binary import (
    Reader, ThriftApplicationError, Writer, encode_struct, read_struct,
    write_struct,
)
from linkerd_tpu_torch.protocol.thrift.codec import (
    CALL, REPLY, VERSION_1, ThriftCall, encode_exception,
)
from linkerd_tpu_torch.protocol.thrift.server import ThriftServer
from linkerd_tpu_torch.router.service import FnService

log = logging.getLogger(__name__)


def path_to_wire(p: Path) -> List[bytes]:
    return [seg.encode("utf-8") for seg in p]


def path_from_wire(segs: Optional[List[bytes]]) -> Path:
    return Path(tuple(
        (s.decode("utf-8") if isinstance(s, (bytes, bytearray)) else str(s))
        for s in (segs or [])))


class _Stamper:
    """Instance-unique stamps (ref LocalStamper :75-80). A random
    instance prefix is added so a restarted server can never reissue a
    stamp the client already echoes — otherwise a client that survives a
    server restart would park against a value that has in fact changed."""

    def __init__(self) -> None:
        import os as _os
        self._instance = _os.urandom(8)
        self._n = 0

    def __call__(self) -> bytes:
        self._n += 1
        return self._instance + struct.pack(">q", self._n)


class Observer:
    """A stamped observation: poll(stamp) returns immediately when the
    current stamp differs, else parks until the next publish
    (ref Observer :85-124)."""

    def __init__(self, stamper: _Stamper,
                 on_publish: Optional[Callable[[], None]] = None):
        self._stamper = stamper
        self._on_publish = on_publish
        self.stamp: Optional[bytes] = None
        self.value = None
        self.error: Optional[Exception] = None
        self.dead = False  # permanently failed (e.g. unknown bound id)
        self._event = asyncio.Event()
        self._closers: List = []

    def publish(self, value) -> None:
        self.value = value
        self.error = None
        self.stamp = self._stamper()
        if self._on_publish is not None:
            self._on_publish()
        self._event.set()
        self._event = asyncio.Event()

    def publish_error(self, exc: Exception) -> None:
        self.error = exc
        self.stamp = self._stamper()
        if self._on_publish is not None:
            self._on_publish()
        self._event.set()
        self._event = asyncio.Event()

    async def poll(self, stamp: bytes) -> Tuple[bytes, object]:
        while self.stamp is None or self.stamp == stamp:
            ev = self._event
            await ev.wait()
        if self.error is not None:
            raise self.error
        return self.stamp, self.value

    def on_close(self, c) -> None:
        self._closers.append(c)

    def close(self) -> None:
        for c in self._closers:
            try:
                c.close()
            except Exception:  # noqa: BLE001
                pass
        self._closers.clear()
        # wake parked long-polls with a retryable error — clients re-poll
        # and the cache re-creates the observation from current state
        self.publish_error(ThriftApplicationError(idl.BindFailure(
            reason="observation evicted; retry", retryInSeconds=1)))


class ObserverCache:
    """LRU-bounded key -> Observer (ref ObserverCache :126-160; active/
    inactive split collapsed into one LRU since asyncio observers are
    cheap to re-create — the observation resumes from the namer's
    current state)."""

    def __init__(self, capacity: int, mk: Callable[[object], Observer]):
        self.capacity = capacity
        self._mk = mk
        self._entries: "OrderedDict[object, Observer]" = OrderedDict()

    def get(self, key) -> Observer:
        obs = self._entries.get(key)
        if obs is not None:
            self._entries.move_to_end(key)
            return obs
        obs = self._mk(key)
        self._entries[key] = obs
        while len(self._entries) > self.capacity:
            _, old = self._entries.popitem(last=False)
            old.close()
        return obs

    def peek(self, key) -> Optional[Observer]:
        return self._entries.get(key)

    def invalidate(self, key) -> None:
        obs = self._entries.pop(key, None)
        if obs is not None:
            obs.close()

    def close(self) -> None:
        for obs in self._entries.values():
            obs.close()
        self._entries.clear()


# ---- tree conversions ------------------------------------------------------

def nametree_to_bound_tree(tree: NameTree,
                           ) -> Tuple[idl.BoundTree, List[BoundName]]:
    """NameTree[BoundName] -> wire BoundTree with node ids; also returns
    the leaves so the server can register their Var[Addr]s."""
    nodes: Dict[int, idl.BoundNode] = {}
    leaves: List[BoundName] = []
    next_id = [0]

    def alloc(node: idl.BoundNode) -> int:
        nid = next_id[0]
        next_id[0] += 1
        nodes[nid] = node
        return nid

    def conv(t: NameTree) -> idl.BoundNode:
        if isinstance(t, Neg):
            return idl.BoundNode(neg=idl.TVoid())
        if isinstance(t, Empty):
            return idl.BoundNode(empty=idl.TVoid())
        if isinstance(t, Fail):
            return idl.BoundNode(fail=idl.TVoid())
        if isinstance(t, Leaf):
            leaves.append(t.value)
            return idl.BoundNode(leaf=idl.TBoundName(
                id=path_to_wire(t.value.id_),
                residual=path_to_wire(t.value.residual)))
        if isinstance(t, Alt):
            return idl.BoundNode(
                alt=[alloc(conv(sub)) for sub in t.trees])
        if isinstance(t, TreeUnion):
            return idl.BoundNode(weighted=[
                idl.WeightedNodeId(weight=w.weight, id=alloc(conv(w.tree)))
                for w in t.weighted])
        raise ValueError(f"unconvertible tree node {t!r}")

    root = conv(tree)
    return idl.BoundTree(root=root, nodes=nodes), leaves


def delegate_tree_to_wire(tree: dg.DelegateTree) -> idl.TDelegateTree:
    nodes: Dict[int, idl.DelegateNode] = {}
    next_id = [0]

    def alloc(node: idl.DelegateNode) -> int:
        nid = next_id[0]
        next_id[0] += 1
        nodes[nid] = node
        return nid

    def conv(t: dg.DelegateTree) -> idl.DelegateNode:
        dentry = ""
        if t.dentry is not None:
            dentry = f"{t.dentry.prefix.show}=>{t.dentry.dst.show}"
        node = idl.DelegateNode(path=path_to_wire(t.path), dentry=dentry)
        if isinstance(t, dg.DNeg):
            node.contents = idl.DelegateContents(neg=idl.TVoid())
        elif isinstance(t, dg.DEmpty):
            node.contents = idl.DelegateContents(empty=idl.TVoid())
        elif isinstance(t, dg.DFail):
            node.contents = idl.DelegateContents(fail=idl.TVoid())
        elif isinstance(t, dg.DException):
            node.contents = idl.DelegateContents(excpetion=t.message)
        elif isinstance(t, dg.DLeaf):
            if t.bound is not None:
                node.contents = idl.DelegateContents(
                    boundLeaf=idl.TBoundName(
                        id=path_to_wire(t.bound.id_),
                        residual=path_to_wire(t.bound.residual)))
            else:
                node.contents = idl.DelegateContents(
                    pathLeaf=path_to_wire(t.path))
        elif isinstance(t, dg.DDelegate):
            if t.child is not None:
                node.contents = idl.DelegateContents(
                    delegate=alloc(conv(t.child)))
            else:
                node.contents = idl.DelegateContents(neg=idl.TVoid())
        elif isinstance(t, dg.DAlt):
            node.contents = idl.DelegateContents(
                alt=[alloc(conv(c)) for c in t.children])
        elif isinstance(t, dg.DUnion):
            node.contents = idl.DelegateContents(weighted=[
                idl.WeightedNodeId(weight=w, id=alloc(conv(sub)))
                for w, sub in t.weighted])
        else:
            node.contents = idl.DelegateContents(
                excpetion=f"unknown node {type(t).__name__}")
        return node

    root = conv(tree)
    return idl.TDelegateTree(root=root, nodes=nodes)


def addr_to_wire(addr: Addr) -> Optional[idl.AddrVal]:
    """None => still pending (keep the long poll parked)."""
    if isinstance(addr, AddrBound):
        import socket
        taddrs = []
        for a in addr.addresses:
            try:
                ip = socket.inet_pton(
                    socket.AF_INET6 if ":" in a.host else socket.AF_INET,
                    a.host)
            except OSError:
                continue
            meta = None
            if a.weight != 1.0:
                meta = idl.AddrMeta(endpoint_addr_weight=a.weight)
            taddrs.append(idl.TransportAddress(
                ip=ip, port=a.port, meta=meta))
        return idl.AddrVal(bound=idl.BoundAddr(addresses=taddrs))
    if isinstance(addr, AddrNeg):
        return idl.AddrVal(neg=idl.TVoid())
    return None  # Pending / Failed handled by caller


# ---- the interface ---------------------------------------------------------

class ThriftNamerIface:
    """Serves the four stamped ops over the framed-thrift transport."""

    def __init__(self, namerd: Namerd, host: str = "127.0.0.1",
                 port: int = 0, binding_cache: int = 1000,
                 addr_cache: int = 1000):
        self.namerd = namerd
        self._stamper = _Stamper()
        self._server = ThriftServer(FnService(self._dispatch), host, port)
        self._addr_vars: "OrderedDict[Path, Var[Addr]]" = OrderedDict()
        self._bindings = ObserverCache(binding_cache, self._mk_binding)
        self._addrs = ObserverCache(addr_cache, self._mk_addr)
        self._dtabs = ObserverCache(64, self._mk_dtab)
        # interface stats: per-op requests/latency/failures under
        # namerd/thrift/<op>/*, watch-stream gauges (live observations
        # per cache), and the publish fan-out counter (every stamped
        # update pushed to parked long-polls)
        self._metrics = namerd.metrics.scope("namerd", "thrift")
        self._updates = self._metrics.counter("updates_total")
        watches = self._metrics.scope("watches")
        watches.gauge(
            "bindings", fn=lambda: float(len(self._bindings._entries)))
        watches.gauge(
            "addrs", fn=lambda: float(len(self._addrs._entries)))
        watches.gauge(
            "dtabs", fn=lambda: float(len(self._dtabs._entries)))

    async def start(self) -> "ThriftNamerIface":
        await self._server.start()
        return self

    @property
    def bound_port(self) -> int:
        return self._server.bound_port

    async def close(self) -> None:
        self._bindings.close()
        self._addrs.close()
        self._dtabs.close()
        await self._server.close()

    # -- observation factories -------------------------------------------

    def _mk_binding(self, key) -> Observer:
        ns, dtab_str, path_show = key
        obs = Observer(self._stamper, on_publish=self._updates.incr)
        interp = self.namerd.interpreter(ns)
        activity = interp.bind(Dtab.read(dtab_str) if dtab_str
                               else Dtab.empty(), Path.read(path_show))

        def on_state(st) -> None:
            if isinstance(st, Ok):
                tree = st.value.simplified
                try:
                    wire, leaves = nametree_to_bound_tree(tree)
                except ValueError as e:
                    obs.publish_error(ThriftApplicationError(
                        idl.BindFailure(reason=str(e), retryInSeconds=5)))
                    return
                for leaf in leaves:
                    self._register_addr(leaf)
                obs.publish(wire)
            elif isinstance(st, Failed):
                obs.publish_error(ThriftApplicationError(idl.BindFailure(
                    reason=repr(st.exc), retryInSeconds=5, ns=ns)))

        obs.on_close(activity.states.observe(on_state))
        obs.on_close(activity)
        return obs

    def _register_addr(self, leaf: BoundName) -> None:
        self._addr_vars[leaf.id_] = leaf.addr
        self._addr_vars.move_to_end(leaf.id_)
        # a dead (unknown-id) observer cached before this registration
        # must be dropped so the next addr poll sees the live Var
        cached = self._addrs.peek(leaf.id_)
        if cached is not None and cached.dead:
            self._addrs.invalidate(leaf.id_)
        while len(self._addr_vars) > 10_000:
            self._addr_vars.popitem(last=False)

    def _mk_addr(self, key: Path) -> Observer:
        obs = Observer(self._stamper, on_publish=self._updates.incr)
        var = self._addr_vars.get(key)
        if var is None:
            obs.dead = True
            obs.publish_error(ThriftApplicationError(idl.AddrFailure(
                reason=f"unknown bound id {key.show}; re-bind first",
                retryInSeconds=1)))
            return obs

        def on_addr(addr: Addr) -> None:
            wire = addr_to_wire(addr)
            if wire is not None:
                obs.publish(wire)

        obs.on_close(var.observe(on_addr))
        return obs

    def _mk_dtab(self, ns: str) -> Observer:
        obs = Observer(self._stamper, on_publish=self._updates.incr)
        activity = self.namerd.store.observe(ns)

        def on_state(st) -> None:
            if isinstance(st, Ok):
                vd = st.value
                if vd is None:
                    obs.publish_error(ThriftApplicationError(
                        idl.DtabFailure(reason=f"no namespace {ns!r}")))
                else:
                    obs.publish(idl.DtabRef(
                        stamp=b"", dtab=vd.dtab.show))
            elif isinstance(st, Failed):
                obs.publish_error(ThriftApplicationError(
                    idl.DtabFailure(reason=repr(st.exc))))

        obs.on_close(activity.states.observe(on_state))
        obs.on_close(activity)
        return obs

    # -- dispatch ---------------------------------------------------------

    async def _dispatch(self, call: ThriftCall) -> Optional[bytes]:
        import time
        handler = {
            "bind": self._handle_bind,
            "addr": self._handle_addr,
            "delegate": self._handle_delegate,
            "dtab": self._handle_dtab,
        }.get(call.name)
        if handler is None:
            self._metrics.scope("unknown").counter("requests").incr()
            return encode_exception(call.name, call.seqid,
                                    f"unknown method {call.name!r}")
        # args struct begins after the message header
        hdr_len = self._header_len(call.payload)
        node = self._metrics.scope(call.name)
        node.counter("requests").incr()
        t0 = time.monotonic()
        try:
            # NOTE: latency includes long-poll park time — for a stamped
            # long-poll interface, time-to-next-update IS the op's shape
            return await handler(call, call.payload, hdr_len)
        except ThriftApplicationError as e:
            node.counter("failures").incr()
            return self._reply(call, e.payload, field_id=1)
        except Exception as e:  # noqa: BLE001
            node.counter("failures").incr()
            log.exception("thrift iface %s failed", call.name)
            return encode_exception(call.name, call.seqid, repr(e))
        finally:
            node.stat("latency_ms").add((time.monotonic() - t0) * 1e3)

    @staticmethod
    def _header_len(payload: bytes) -> int:
        from linkerd_tpu_torch.protocol.thrift.binary import header_len
        return header_len(payload)

    def _reply(self, call: ThriftCall, result, field_id: int = 0) -> bytes:
        nb = call.name.encode("utf-8")
        out = struct.pack(">I", (VERSION_1 | REPLY) & 0xFFFFFFFF)
        out += struct.pack(">I", len(nb)) + nb
        out += struct.pack(">i", call.seqid)
        w = Writer()
        w.write(struct.pack(">bh", 12, field_id))  # T_STRUCT
        write_struct(w, result)
        w.write(b"\x00")
        return out + w.bytes()

    @staticmethod
    def _read_arg(payload: bytes, pos: int, cls: type):
        r = Reader(payload, pos)
        tid = struct.unpack(">b", r.take(1))[0]
        if tid != 12:
            raise ValueError("expected struct arg")
        r.take(2)  # field id (1)
        req = read_struct(r, cls)
        return req

    async def _handle_bind(self, call, payload, pos) -> bytes:
        req: idl.BindReq = self._read_arg(payload, pos, idl.BindReq)
        ref = req.name or idl.NameRef()
        ns = ref.ns or "default"
        path = path_from_wire(ref.name)
        obs = self._bindings.get((ns, req.dtab or "", path.show))
        stamp, tree = await obs.poll(ref.stamp or b"")
        return self._reply(call, idl.TBound(stamp=stamp, tree=tree, ns=ns))

    async def _handle_addr(self, call, payload, pos) -> bytes:
        req: idl.AddrReq = self._read_arg(payload, pos, idl.AddrReq)
        ref = req.name or idl.NameRef()
        path = path_from_wire(ref.name)
        obs = self._addrs.get(path)
        stamp, val = await obs.poll(ref.stamp or b"")
        return self._reply(call, idl.TAddr(stamp=stamp, value=val))

    async def _handle_delegate(self, call, payload, pos) -> bytes:
        req: idl.DelegateReq = self._read_arg(payload, pos, idl.DelegateReq)
        delegation = req.delegation or idl.Delegation()
        ns = delegation.ns or "default"
        # the request's tree root carries the path to delegate
        root = (delegation.tree.root if delegation.tree is not None
                else idl.DelegateNode())
        path = path_from_wire(root.path if root is not None else None)
        interp = self.namerd.interpreter(ns)
        local = Dtab.read(req.dtab) if req.dtab else Dtab.empty()
        tree = dg.Delegator(interp).delegate(local, path)
        wire = delegate_tree_to_wire(tree)
        return self._reply(call, idl.Delegation(
            stamp=self._stamper(), tree=wire, ns=ns))

    async def _handle_dtab(self, call, payload, pos) -> bytes:
        req: idl.DtabReq = self._read_arg(payload, pos, idl.DtabReq)
        ns = req.ns or "default"
        obs = self._dtabs.get(ns)
        stamp, ref = await obs.poll(req.stamp or b"")
        return self._reply(call, idl.DtabRef(stamp=stamp, dtab=ref.dtab))
