"""Asyncio ZooKeeper client: session handshake, requests, watches.

The reference consumes ZooKeeper through three different JVM clients
(finagle serverset2 in namerd/storage/zk ZkSession.scala:200, Twitter
commons in namer/zk-leader, Curator in namer/curator); this one asyncio
client replaces all of them. Protocol: framed jute records — connect
handshake, xid-correlated request/reply, server-initiated watch events
(xid -1), pings (xid -2).

Watch semantics follow ZooKeeper's: one-shot, re-armed by re-reading.
On session loss every registered watch fires a synthetic Disconnected
event so watch loops re-issue their reads against the new session —
the same "watches survive reconnect by re-registration" behavior the
reference's ZkSession provides via its Activity re-subscription.
"""

from __future__ import annotations

import asyncio
import logging
import random
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from linkerd_tpu_torch.zk.jute import Reader, Writer

log = logging.getLogger(__name__)

# op codes
OP_CREATE = 1
OP_DELETE = 2
OP_EXISTS = 3
OP_GETDATA = 4
OP_SETDATA = 5
OP_GETCHILDREN = 8
OP_PING = 11
OP_GETCHILDREN2 = 12
OP_CLOSE = -11

XID_WATCH_EVENT = -1
XID_PING = -2

# error codes (subset)
ZK_OK = 0
ZK_CONNECTIONLOSS = -4
ZK_NONODE = -101
ZK_NOAUTH = -102
ZK_BADVERSION = -103
ZK_NODEEXISTS = -110
ZK_NOTEMPTY = -111
ZK_SESSIONEXPIRED = -112

# create flags
EPHEMERAL = 1
SEQUENTIAL = 2

# watch event types
EVENT_NODE_CREATED = 1
EVENT_NODE_DELETED = 2
EVENT_NODE_DATA_CHANGED = 3
EVENT_NODE_CHILDREN_CHANGED = 4
EVENT_DISCONNECTED = -1000  # synthetic: session lost, re-read required

# ZK "world:anyone" open ACL
_OPEN_ACL = (0x1F, "world", "anyone")


class ZkError(Exception):
    def __init__(self, code: int, path: str = ""):
        super().__init__(f"zk error {code} on {path!r}")
        self.code = code
        self.path = path


async def zk_backoff(attempt: int, base: float = 0.1, cap: float = 5.0) -> int:
    """Shared jittered exponential backoff for ZK watch/retry loops.
    Returns the next attempt count."""
    attempt = min(attempt + 1, 6)
    await asyncio.sleep(
        min(cap, base * (2 ** attempt)) * (0.7 + random.random() / 2))
    return attempt


@dataclass(frozen=True)
class Stat:
    czxid: int
    mzxid: int
    ctime: int
    mtime: int
    version: int
    cversion: int
    aversion: int
    ephemeral_owner: int
    data_length: int
    num_children: int
    pzxid: int

    @classmethod
    def read(cls, r: Reader) -> "Stat":
        return cls(r.int64(), r.int64(), r.int64(), r.int64(), r.int32(),
                   r.int32(), r.int32(), r.int64(), r.int32(), r.int32(),
                   r.int64())


@dataclass(frozen=True)
class WatchEvent:
    type: int
    state: int
    path: str


WatchCallback = Callable[[WatchEvent], None]


@dataclass
class _Pending:
    op: int
    path: str
    fut: asyncio.Future
    watch: Optional[WatchCallback] = None
    watch_kind: str = ""


class ZkClient:
    """One ZK session shared by all ZK-family components.

    ``hosts`` is a comma-separated ``host:port`` list; connection rotates
    through it with jittered exponential backoff (ref: ZkSession.scala
    RetryStream semantics).
    """

    def __init__(self, hosts: str, session_timeout_ms: int = 10000):
        self.hosts: List[Tuple[str, int]] = []
        for part in hosts.split(","):
            part = part.strip()
            if not part:
                continue
            host, _, port = part.rpartition(":")
            self.hosts.append((host or part, int(port) if port else 2181))
        if not self.hosts:
            raise ValueError("empty zk host list")
        self.session_timeout_ms = session_timeout_ms
        self.connected = asyncio.Event()
        self._session_id = 0
        self._session_passwd = b"\0" * 16
        self._xid = 0
        self._pending: Dict[int, _Pending] = {}
        self._watches: Dict[Tuple[str, str], List[WatchCallback]] = {}
        self._writer: Optional[asyncio.StreamWriter] = None
        self._task: Optional[asyncio.Task] = None
        self._closed = False

    # ── lifecycle ────────────────────────────────────────────────────────
    def start(self) -> "ZkClient":
        if self._task is None or self._task.done():
            self._task = asyncio.get_event_loop().create_task(
                self._session_loop())
        return self

    async def close(self) -> None:
        self._closed = True
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except (asyncio.CancelledError, Exception):  # noqa: BLE001
                pass
        self._teardown(ZkError(ZK_SESSIONEXPIRED))

    # ── session loop ─────────────────────────────────────────────────────
    async def _session_loop(self) -> None:
        attempt = 0
        host_i = random.randrange(len(self.hosts))
        while not self._closed:
            host, port = self.hosts[host_i % len(self.hosts)]
            host_i += 1
            try:
                reader, writer = await asyncio.open_connection(host, port)
                try:
                    await self._handshake(reader, writer)
                    self._writer = writer
                    self.connected.set()
                    attempt = 0
                    ping_task = asyncio.get_event_loop().create_task(
                        self._ping_loop(writer))
                    try:
                        await self._read_loop(reader)
                    finally:
                        ping_task.cancel()
                finally:
                    self._writer = None
                    self.connected.clear()
                    try:
                        writer.close()
                    except Exception:  # noqa: BLE001
                        pass
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001 — reconnect forever
                log.debug("zk session to %s:%d: %r", host, port, e)
            if self._closed:
                return
            self._teardown(ZkError(ZK_CONNECTIONLOSS))
            attempt = min(attempt + 1, 6)
            await asyncio.sleep(
                min(5.0, 0.05 * (2 ** attempt)) * (0.7 + random.random() / 2))

    async def _handshake(self, reader: asyncio.StreamReader,
                         writer: asyncio.StreamWriter) -> None:
        w = Writer()
        w.int32(0)                       # protocolVersion
        w.int64(0)                       # lastZxidSeen
        w.int32(self.session_timeout_ms)
        w.int64(self._session_id)
        w.buffer(self._session_passwd)
        w.boolean(False)                 # readOnly
        writer.write(w.packet())
        await writer.drain()
        rsp = Reader(await self._read_packet(reader))
        rsp.int32()                      # protocolVersion
        rsp.int32()                      # negotiated timeout
        sid = rsp.int64()
        passwd = rsp.buffer() or b"\0" * 16
        if sid == 0:
            # server expired/rejected the session: forget it so the next
            # attempt starts a FRESH session instead of replaying the dead
            # id forever
            self._session_id = 0
            self._session_passwd = b"\0" * 16
            raise ZkError(ZK_SESSIONEXPIRED, "session rejected")
        self._session_id = sid
        self._session_passwd = passwd

    @staticmethod
    async def _read_packet(reader: asyncio.StreamReader) -> bytes:
        hdr = await reader.readexactly(4)
        n = int.from_bytes(hdr, "big", signed=True)
        if n < 0 or n > (1 << 26):
            raise ZkError(ZK_CONNECTIONLOSS, f"bad packet length {n}")
        return await reader.readexactly(n) if n else b""

    async def _ping_loop(self, writer: asyncio.StreamWriter) -> None:
        interval = self.session_timeout_ms / 3000.0
        while True:
            await asyncio.sleep(interval)
            w = Writer()
            w.int32(XID_PING).int32(OP_PING)
            writer.write(w.packet())
            await writer.drain()

    async def _read_loop(self, reader: asyncio.StreamReader) -> None:
        while True:
            pkt = Reader(await self._read_packet(reader))
            xid = pkt.int32()
            zxid = pkt.int64()  # noqa: F841 — tracked implicitly
            err = pkt.int32()
            if xid == XID_WATCH_EVENT:
                ev_type = pkt.int32()
                ev_state = pkt.int32()
                ev_path = pkt.ustring() or ""
                self._fire_watches(WatchEvent(ev_type, ev_state, ev_path))
                continue
            if xid == XID_PING:
                continue
            p = self._pending.pop(xid, None)
            if p is None:
                continue
            # Watches arm HERE, at reply processing, mirroring when the
            # server registered them: on success for all ops, and on
            # NoNode for exists (ZK arms creation watches for absent
            # nodes). Arming in _call would (a) leak callbacks for failed
            # reads and (b) lose events delivered before the caller's
            # coroutine resumes.
            if p.watch is not None:
                if err == ZK_OK:
                    self._arm_watch(p.watch_kind, p.path, p.watch)
                elif err == ZK_NONODE and p.op == OP_EXISTS:
                    self._arm_watch("exists", p.path, p.watch)
            if p.fut.done():
                continue
            if err != ZK_OK:
                p.fut.set_exception(ZkError(err, p.path))
                continue
            try:
                p.fut.set_result(self._decode_reply(p, pkt))
            except Exception as e:  # noqa: BLE001
                p.fut.set_exception(e)

    def _decode_reply(self, p: _Pending, r: Reader):
        if p.op == OP_GETDATA:
            data = r.buffer() or b""
            return data, Stat.read(r)
        if p.op == OP_GETCHILDREN:
            return r.ustring_vector()
        if p.op == OP_GETCHILDREN2:
            children = r.ustring_vector()
            return children, Stat.read(r)
        if p.op == OP_EXISTS:
            return Stat.read(r)
        if p.op == OP_CREATE:
            return r.ustring() or ""
        if p.op == OP_SETDATA:
            return Stat.read(r)
        return None

    # ── watches ──────────────────────────────────────────────────────────
    def _arm_watch(self, kind: str, path: str, cb: WatchCallback) -> None:
        self._watches.setdefault((kind, path), []).append(cb)

    def _fire_watches(self, ev: WatchEvent) -> None:
        if ev.type in (EVENT_NODE_CREATED, EVENT_NODE_DELETED,
                       EVENT_NODE_DATA_CHANGED):
            kinds = ("data", "exists")
        elif ev.type == EVENT_NODE_CHILDREN_CHANGED:
            kinds = ("children",)
        else:
            return
        for kind in kinds:
            for cb in self._watches.pop((kind, ev.path), []):
                try:
                    cb(ev)
                except Exception:  # noqa: BLE001
                    log.exception("zk watch callback failed")

    def _teardown(self, err: ZkError) -> None:
        """Connection lost: fail in-flight requests and fire every armed
        watch with a synthetic Disconnected event (consumers re-read)."""
        pending, self._pending = self._pending, {}
        for p in pending.values():
            if not p.fut.done():
                p.fut.set_exception(err)
        watches, self._watches = self._watches, {}
        for (kind, path), cbs in watches.items():
            ev = WatchEvent(EVENT_DISCONNECTED, 0, path)
            for cb in cbs:
                try:
                    cb(ev)
                except Exception:  # noqa: BLE001
                    log.exception("zk watch callback failed")

    # ── requests ─────────────────────────────────────────────────────────
    async def _call(self, op: int, path: str, body: Writer,
                    watch: Optional[WatchCallback] = None,
                    watch_kind: str = ""):
        self.start()
        await asyncio.wait_for(self.connected.wait(),
                               self.session_timeout_ms / 1000.0)
        writer = self._writer
        if writer is None:
            raise ZkError(ZK_CONNECTIONLOSS, path)
        self._xid += 1
        xid = self._xid
        w = Writer()
        w.int32(xid).int32(op)
        w.buf += body.buf
        fut = asyncio.get_event_loop().create_future()
        self._pending[xid] = _Pending(op, path, fut, watch, watch_kind)
        writer.write(w.packet())
        await writer.drain()
        return await fut

    async def get_data(self, path: str,
                       watch: Optional[WatchCallback] = None
                       ) -> Tuple[bytes, Stat]:
        body = Writer().ustring(path).boolean(watch is not None)
        return await self._call(OP_GETDATA, path, body, watch, "data")

    async def get_children(self, path: str,
                           watch: Optional[WatchCallback] = None
                           ) -> List[str]:
        body = Writer().ustring(path).boolean(watch is not None)
        return await self._call(OP_GETCHILDREN, path, body, watch, "children")

    async def exists(self, path: str,
                     watch: Optional[WatchCallback] = None
                     ) -> Optional[Stat]:
        body = Writer().ustring(path).boolean(watch is not None)
        try:
            return await self._call(OP_EXISTS, path, body, watch, "exists")
        except ZkError as e:
            if e.code == ZK_NONODE:
                # a NoNode exists() still arms creation watches server-side
                return None
            raise

    async def create(self, path: str, data: bytes = b"",
                     ephemeral: bool = False,
                     sequential: bool = False) -> str:
        flags = (EPHEMERAL if ephemeral else 0) | (
            SEQUENTIAL if sequential else 0)
        body = Writer().ustring(path).buffer(data)
        body.int32(1)                      # one ACL
        perms, scheme, ident = _OPEN_ACL
        body.int32(perms).ustring(scheme).ustring(ident)
        body.int32(flags)
        return await self._call(OP_CREATE, path, body)

    async def set_data(self, path: str, data: bytes,
                       version: int = -1) -> Stat:
        body = Writer().ustring(path).buffer(data).int32(version)
        return await self._call(OP_SETDATA, path, body)

    async def delete(self, path: str, version: int = -1) -> None:
        body = Writer().ustring(path).int32(version)
        await self._call(OP_DELETE, path, body)

    async def ensure_path(self, path: str) -> None:
        """mkdir -p: create each missing ancestor as a persistent node."""
        parts = [p for p in path.split("/") if p]
        cur = ""
        for p in parts:
            cur += "/" + p
            try:
                await self.create(cur)
            except ZkError as e:
                if e.code != ZK_NODEEXISTS:
                    raise
