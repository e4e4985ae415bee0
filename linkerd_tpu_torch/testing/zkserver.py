"""In-memory ZooKeeper server speaking the jute wire protocol.

The test double for the ZK family — the same technique the k8s/consul
namers use (scripted fake API servers, SURVEY.md §4 pattern 2), but at
the wire level so the real asyncio ZkClient is exercised end-to-end:
sessions, ephemerals (deleted on session close), sequential nodes,
one-shot watches, and versioned CAS all behave per ZooKeeper semantics.
"""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from linkerd_tpu_torch.zk import jute
from linkerd_tpu_torch.zk.client import (
    EPHEMERAL, EVENT_NODE_CHILDREN_CHANGED, EVENT_NODE_CREATED,
    EVENT_NODE_DATA_CHANGED, EVENT_NODE_DELETED, OP_CLOSE, OP_CREATE,
    OP_DELETE, OP_EXISTS, OP_GETCHILDREN, OP_GETCHILDREN2, OP_GETDATA,
    OP_PING, OP_SETDATA, SEQUENTIAL, XID_PING, XID_WATCH_EVENT,
    ZK_BADVERSION, ZK_NODEEXISTS, ZK_NONODE, ZK_NOTEMPTY, ZK_OK,
)


@dataclass
class _Node:
    data: bytes = b""
    version: int = 0
    cversion: int = 0
    czxid: int = 0
    mzxid: int = 0
    ephemeral_owner: int = 0
    seq_counter: int = 0


@dataclass
class _Session:
    sid: int
    writer: asyncio.StreamWriter
    ephemerals: Set[str] = field(default_factory=set)
    # (kind, path) armed one-shot watches for this session
    watches: Set[Tuple[str, str]] = field(default_factory=set)


class FakeZkServer:
    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self.host = host
        self.port = port
        self.nodes: Dict[str, _Node] = {"/": _Node()}
        self.zxid = 0
        self._next_sid = 0x1000
        self._sessions: Dict[int, _Session] = {}
        self._server: Optional[asyncio.AbstractServer] = None

    # ── lifecycle ────────────────────────────────────────────────────────
    async def start(self) -> "FakeZkServer":
        self._server = await asyncio.start_server(
            self._serve_conn, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        return self

    async def close(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
        for sess in list(self._sessions.values()):
            try:
                sess.writer.close()
            except Exception:  # noqa: BLE001
                pass

    @property
    def hosts(self) -> str:
        return f"{self.host}:{self.port}"

    # ── tree helpers (also used by tests to script state) ────────────────
    def _parent(self, path: str) -> str:
        return path.rsplit("/", 1)[0] or "/"

    def set_node(self, path: str, data: bytes) -> None:
        """Test hook: create/overwrite a node (parents included)."""
        parts = [p for p in path.split("/") if p]
        cur = ""
        for p in parts:
            parent = cur or "/"
            cur += "/" + p
            if cur not in self.nodes:
                self.zxid += 1
                self.nodes[cur] = _Node(czxid=self.zxid, mzxid=self.zxid)
                self._touch_children(parent)
                self._notify(EVENT_NODE_CREATED, cur)
        if self.nodes[path].data != data:
            self.zxid += 1
            node = self.nodes[path]
            node.data = data
            node.version += 1
            node.mzxid = self.zxid
            self._notify(EVENT_NODE_DATA_CHANGED, path)

    def delete_node(self, path: str) -> None:
        """Test hook: delete a node (and its subtree)."""
        for p in [p for p in list(self.nodes) if
                  p == path or p.startswith(path + "/")]:
            del self.nodes[p]
            self._notify(EVENT_NODE_DELETED, p)
        self._touch_children(self._parent(path))

    def children_of(self, path: str) -> List[str]:
        prefix = "" if path == "/" else path
        out = []
        for p in self.nodes:
            if p != "/" and self._parent(p) == (path if path != "/" else "/"):
                out.append(p[len(prefix) + 1:])
        return sorted(out)

    def _touch_children(self, parent: str) -> None:
        node = self.nodes.get(parent)
        if node is not None:
            node.cversion += 1
        self._notify(EVENT_NODE_CHILDREN_CHANGED, parent)

    # ── watch delivery ───────────────────────────────────────────────────
    def _notify(self, ev_type: int, path: str) -> None:
        if ev_type == EVENT_NODE_CHILDREN_CHANGED:
            kinds = ("children",)
        else:
            kinds = ("data", "exists")
        for sess in list(self._sessions.values()):
            hit = [k for k in kinds if (k, path) in sess.watches]
            if not hit:
                continue
            for k in hit:
                sess.watches.discard((k, path))
            w = jute.Writer()
            w.int32(XID_WATCH_EVENT).int64(self.zxid).int32(ZK_OK)
            w.int32(ev_type).int32(3).ustring(path)  # state 3 = connected
            try:
                sess.writer.write(w.packet())
            except Exception:  # noqa: BLE001
                pass

    # ── connection handling ──────────────────────────────────────────────
    async def _serve_conn(self, reader: asyncio.StreamReader,
                          writer: asyncio.StreamWriter) -> None:
        sess: Optional[_Session] = None
        try:
            # connect handshake
            req = jute.Reader(await self._read_packet(reader))
            req.int32()           # protocolVersion
            req.int64()           # lastZxidSeen
            timeout = req.int32()
            sid = req.int64()
            if sid == 0 or sid not in self._sessions:
                self._next_sid += 1
                sid = self._next_sid
            sess = _Session(sid, writer)
            self._sessions[sid] = sess
            w = jute.Writer()
            w.int32(0).int32(timeout).int64(sid)
            w.buffer(b"\x5a" * 16).boolean(False)
            writer.write(w.packet())
            await writer.drain()
            while True:
                pkt = await self._read_packet(reader)
                r = jute.Reader(pkt)
                xid = r.int32()
                op = r.int32()
                if op == OP_PING:
                    w = jute.Writer()
                    w.int32(XID_PING).int64(self.zxid).int32(ZK_OK)
                    writer.write(w.packet())
                    continue
                if op == OP_CLOSE:
                    break
                err, body = self._apply(sess, op, r)
                w = jute.Writer()
                w.int32(xid).int64(self.zxid).int32(err)
                if err == ZK_OK and body is not None:
                    w.buf += body.buf
                writer.write(w.packet())
                await writer.drain()
        except (asyncio.IncompleteReadError, ConnectionResetError,
                BrokenPipeError, asyncio.CancelledError):
            pass
        finally:
            if sess is not None:
                self._sessions.pop(sess.sid, None)
                for path in sorted(sess.ephemerals, reverse=True):
                    if path in self.nodes:
                        del self.nodes[path]
                        self._notify(EVENT_NODE_DELETED, path)
                        self._touch_children(self._parent(path))
            try:
                writer.close()
            except Exception:  # noqa: BLE001
                pass

    @staticmethod
    async def _read_packet(reader: asyncio.StreamReader) -> bytes:
        hdr = await reader.readexactly(4)
        n = int.from_bytes(hdr, "big", signed=True)
        return await reader.readexactly(n) if n > 0 else b""

    # ── op dispatch ──────────────────────────────────────────────────────
    def _apply(self, sess: _Session, op: int, r: jute.Reader
               ) -> Tuple[int, Optional[jute.Writer]]:
        if op == OP_GETDATA:
            path = r.ustring() or ""
            watch = r.boolean()
            node = self.nodes.get(path)
            if node is None:
                return ZK_NONODE, None
            if watch:
                sess.watches.add(("data", path))
            w = jute.Writer().buffer(node.data)
            self._stat(w, path, node)
            return ZK_OK, w
        if op in (OP_GETCHILDREN, OP_GETCHILDREN2):
            path = r.ustring() or ""
            watch = r.boolean()
            node = self.nodes.get(path)
            if node is None:
                return ZK_NONODE, None
            if watch:
                sess.watches.add(("children", path))
            w = jute.Writer().ustring_vector(self.children_of(path))
            if op == OP_GETCHILDREN2:
                self._stat(w, path, node)
            return ZK_OK, w
        if op == OP_EXISTS:
            path = r.ustring() or ""
            watch = r.boolean()
            node = self.nodes.get(path)
            if watch:
                # ZK arms exists-watches whether or not the node exists
                sess.watches.add(("exists" if node is None else "data", path))
            if node is None:
                return ZK_NONODE, None
            w = jute.Writer()
            self._stat(w, path, node)
            return ZK_OK, w
        if op == OP_CREATE:
            path = r.ustring() or ""
            data = r.buffer() or b""
            nacl = r.int32()
            for _ in range(max(0, nacl)):
                r.int32()
                r.ustring()
                r.ustring()
            flags = r.int32()
            parent = self._parent(path)
            pnode = self.nodes.get(parent)
            if pnode is None:
                return ZK_NONODE, None
            if flags & SEQUENTIAL:
                pnode.seq_counter += 1
                path = f"{path}{pnode.seq_counter:010d}"
            if path in self.nodes:
                return ZK_NODEEXISTS, None
            self.zxid += 1
            node = _Node(data=data, czxid=self.zxid, mzxid=self.zxid)
            if flags & EPHEMERAL:
                node.ephemeral_owner = sess.sid
                sess.ephemerals.add(path)
            self.nodes[path] = node
            self._touch_children(parent)
            self._notify(EVENT_NODE_CREATED, path)
            return ZK_OK, jute.Writer().ustring(path)
        if op == OP_SETDATA:
            path = r.ustring() or ""
            data = r.buffer() or b""
            version = r.int32()
            node = self.nodes.get(path)
            if node is None:
                return ZK_NONODE, None
            if version != -1 and version != node.version:
                return ZK_BADVERSION, None
            self.zxid += 1
            node.data = data
            node.version += 1
            node.mzxid = self.zxid
            self._notify(EVENT_NODE_DATA_CHANGED, path)
            w = jute.Writer()
            self._stat(w, path, node)
            return ZK_OK, w
        if op == OP_DELETE:
            path = r.ustring() or ""
            version = r.int32()
            node = self.nodes.get(path)
            if node is None:
                return ZK_NONODE, None
            if version != -1 and version != node.version:
                return ZK_BADVERSION, None
            if self.children_of(path):
                return ZK_NOTEMPTY, None
            del self.nodes[path]
            for s in self._sessions.values():
                s.ephemerals.discard(path)
            self._notify(EVENT_NODE_DELETED, path)
            self._touch_children(self._parent(path))
            return ZK_OK, None
        return ZK_NONODE, None

    def _stat(self, w: jute.Writer, path: str, node: _Node) -> None:
        w.int64(node.czxid).int64(node.mzxid)
        now = int(time.time() * 1000)
        w.int64(now).int64(now)
        w.int32(node.version).int32(node.cversion).int32(0)
        w.int64(node.ephemeral_owner).int32(len(node.data))
        w.int32(len(self.children_of(path))).int64(node.czxid)
