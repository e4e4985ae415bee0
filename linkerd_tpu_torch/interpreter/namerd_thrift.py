"""io.l5d.namerd — the thrift long-poll interpreter client.

The reference's default remote interpreter: binds are delegated to namerd
over the stamped thrift protocol (thrift_iface.py is the server side);
``bind`` and per-bound-id ``addr`` observations each run a long-poll loop
with jittered backoff on failure, resuming from the last stamp on
reconnect. Ref:
/root/reference/interpreter/namerd/src/main/scala/io/buoyant/namerd/iface/ThriftNamerClient.scala:1-347
(watchers :90-220, backoff/retry semantics) and
NamerdInterpreterInitializer.scala:133 (kind io.l5d.namerd).

A copy of ``linkerd_tpu/interpreter/namerd_thrift.py``.
"""

from __future__ import annotations

import asyncio
import logging
import random
import socket
import struct
from typing import Dict, Optional, Tuple

from linkerd_tpu_torch.core import Activity, Dtab, Path, Var
from linkerd_tpu_torch.core.activity import Ok
from linkerd_tpu_torch.core.addr import (
    ADDR_PENDING, Addr, AddrNeg, Address, Bound as AddrBound, BoundName,
)
from linkerd_tpu_torch.core.nametree import (
    Alt, Empty, Fail, Leaf, NameTree, Neg, Union as TreeUnion, Weighted,
)
from linkerd_tpu_torch.namer.core import NameInterpreter
from linkerd_tpu_torch.namerd import thrift_idl as idl
from linkerd_tpu_torch.namerd.thrift_iface import path_from_wire, path_to_wire
from linkerd_tpu_torch.protocol.thrift.binary import (
    ThriftApplicationError, decode_call_reply, encode_call,
)
from linkerd_tpu_torch.protocol.thrift.client import ThriftClient
from linkerd_tpu_torch.protocol.thrift.codec import (
    CALL, EXCEPTION, VERSION_1, ThriftCall, parse_message_header,
)

log = logging.getLogger(__name__)


def _encode_call(name: str, seqid: int, req) -> bytes:
    return encode_call(name, seqid, req, VERSION_1 | CALL)


def _decode_reply(payload: bytes, success_cls: type, exception_cls: type):
    name, _seqid, mtype = parse_message_header(payload)
    if mtype == EXCEPTION:
        raise ConnectionError(f"thrift application exception from {name}")
    return decode_call_reply(payload, success_cls, exception_cls)


class _Backoff:
    """Jittered exponential backoff (ref ThriftNamerClient's
    Backoff.exponential)."""

    def __init__(self, base: float = 0.1, cap: float = 10.0):
        self.base = base
        self.cap = cap
        self.n = 0

    def reset(self) -> None:
        self.n = 0

    async def sleep(self) -> None:
        d = min(self.cap, self.base * (2 ** min(self.n, 10)))
        self.n += 1
        await asyncio.sleep(d * (0.5 + random.random() / 2))


class ThriftNamerInterpreter(NameInterpreter):
    """bind() over the namerd thrift iface with stamp-resumed long polls."""

    def __init__(self, host: str, port: int, namespace: str = "default",
                 client_id: str = "/l5d", max_watches: int = 1000,
                 max_addr_watches: int = 10_000):
        from collections import OrderedDict
        self.host = host
        self.port = port
        self.namespace = namespace
        self.client_id = path_to_wire(Path.read(client_id))
        self.max_watches = max_watches
        self.max_addr_watches = max_addr_watches
        self._seq = 0
        # LRU-bounded like the router's binding cache: each entry holds a
        # live long-poll task + its own connection, so unbounded growth
        # means fd exhaustion under varied per-request dtab overrides
        self._binds: "OrderedDict[Tuple[str, str], Activity]" = OrderedDict()
        self._addrs: "OrderedDict[Path, Var[Addr]]" = OrderedDict()
        self._tasks: Dict[object, asyncio.Task] = {}
        self._closed = False

    # -- NameInterpreter ---------------------------------------------------
    def bind(self, dtab: Dtab, path: Path) -> Activity[NameTree[BoundName]]:
        key = (dtab.show, path.show)
        act = self._binds.get(key)
        if act is not None:
            self._binds.move_to_end(key)
            return act
        act = Activity.mutable()
        self._binds[key] = act
        self._spawn(("bind", key), self._bind_loop(act, dtab.show, path))
        while len(self._binds) > self.max_watches:
            old_key, _old_act = self._binds.popitem(last=False)
            self._cancel(("bind", old_key))
        return act

    def close(self) -> None:
        self._closed = True
        for t in self._tasks.values():
            t.cancel()
        self._tasks.clear()

    # -- internals ---------------------------------------------------------
    def _spawn(self, key, coro) -> None:
        if self._closed:
            coro.close()
            return
        task = asyncio.ensure_future(coro)
        self._tasks[key] = task
        task.add_done_callback(lambda _t: self._tasks.pop(key, None))

    def _cancel(self, key) -> None:
        task = self._tasks.pop(key, None)
        if task is not None:
            task.cancel()

    def _next_seq(self) -> int:
        self._seq += 1
        return self._seq

    async def _call(self, client: ThriftClient, method: str, req,
                    success_cls: type, exception_cls: type):
        seq = self._next_seq()
        payload = _encode_call(method, seq, req)
        reply = await client(ThriftCall(
            payload=payload, name=method, seqid=seq, type=CALL))
        if reply is None:
            raise ConnectionError("no thrift reply")
        return _decode_reply(reply, success_cls, exception_cls)

    async def _bind_loop(self, act: Activity, dtab_str: str,
                         path: Path) -> None:
        client = ThriftClient(self.host, self.port)
        backoff = _Backoff()
        stamp = b""
        try:
            while True:
                try:
                    rsp: idl.TBound = await self._call(
                        client, "bind",
                        idl.BindReq(
                            dtab=dtab_str,
                            name=idl.NameRef(
                                stamp=stamp, name=path_to_wire(path),
                                ns=self.namespace),
                            clientId=self.client_id),
                        idl.TBound, idl.BindFailure)
                    stamp = rsp.stamp or b""
                    tree = self._tree_from_wire(rsp.tree)
                    act.set_value(tree)
                    backoff.reset()
                except asyncio.CancelledError:
                    raise
                except ThriftApplicationError as e:
                    if isinstance(act.current, Ok):
                        log.debug("bind %s failed (keeping last): %r",
                                  path.show, e)
                    else:
                        act.set_exception(e)
                    retry = getattr(e.payload, "retryInSeconds", None) or 5
                    await asyncio.sleep(min(30, max(1, retry)))
                except Exception as e:  # noqa: BLE001 — transport errors
                    if not isinstance(act.current, Ok):
                        act.set_exception(e)
                    await backoff.sleep()
        finally:
            await client.close()

    def _tree_from_wire(self, wire: Optional[idl.BoundTree]) -> NameTree:
        if wire is None or wire.root is None:
            return Neg()
        nodes = wire.nodes or {}

        def conv(node: idl.BoundNode) -> NameTree:
            kind = node.union_field()
            if kind == "neg" or kind is None:
                return Neg()
            if kind == "empty":
                return Empty()
            if kind == "fail":
                return Fail()
            if kind == "leaf":
                leaf: idl.TBoundName = node.leaf
                id_path = path_from_wire(leaf.id)
                return Leaf(BoundName(
                    id_=id_path, addr=self._addr_var(id_path),
                    residual=path_from_wire(leaf.residual)))
            if kind == "alt":
                return Alt(*(
                    conv(nodes[i]) for i in (node.alt or [])
                    if i in nodes))
            if kind == "weighted":
                return TreeUnion(*(
                    Weighted(w.weight, conv(nodes[w.id]))
                    for w in (node.weighted or []) if w.id in nodes))
            return Neg()

        return conv(wire.root)

    def _addr_var(self, id_path: Path) -> Var[Addr]:
        var = self._addrs.get(id_path)
        if var is not None:
            self._addrs.move_to_end(id_path)
            return var
        var = Var(ADDR_PENDING)
        self._addrs[id_path] = var
        self._spawn(("addr", id_path), self._addr_loop(var, id_path))
        while len(self._addrs) > self.max_addr_watches:
            old_id, _old_var = self._addrs.popitem(last=False)
            self._cancel(("addr", old_id))
        return var

    async def _addr_loop(self, var: Var[Addr], id_path: Path) -> None:
        client = ThriftClient(self.host, self.port)
        backoff = _Backoff()
        stamp = b""
        try:
            while True:
                try:
                    rsp: idl.TAddr = await self._call(
                        client, "addr",
                        idl.AddrReq(
                            name=idl.NameRef(
                                stamp=stamp, name=path_to_wire(id_path),
                                ns=self.namespace),
                            clientId=self.client_id),
                        idl.TAddr, idl.AddrFailure)
                    stamp = rsp.stamp or b""
                    var.update(self._addr_from_wire(rsp.value))
                    backoff.reset()
                except asyncio.CancelledError:
                    raise
                except ThriftApplicationError as e:
                    # e.g. server restarted and lost the id: retry; the
                    # bind loop's re-bind re-registers it server-side
                    retry = getattr(e.payload, "retryInSeconds", None) or 1
                    await asyncio.sleep(min(30, max(1, retry)))
                except Exception:  # noqa: BLE001
                    await backoff.sleep()
        finally:
            await client.close()

    @staticmethod
    def _addr_from_wire(val: Optional[idl.AddrVal]) -> Addr:
        if val is None or val.union_field() in (None, "neg"):
            return AddrNeg()
        bound: idl.BoundAddr = val.bound
        addrs = []
        for ta in (bound.addresses or []):
            ip = bytes(ta.ip or b"")
            try:
                host = (socket.inet_ntop(socket.AF_INET6, ip)
                        if len(ip) == 16
                        else socket.inet_ntop(socket.AF_INET, ip))
            except OSError:
                continue
            weight = 1.0
            if ta.meta is not None and \
                    ta.meta.endpoint_addr_weight is not None:
                weight = ta.meta.endpoint_addr_weight
            addrs.append(Address(host, int(ta.port or 0), weight))
        return AddrBound(frozenset(addrs))
