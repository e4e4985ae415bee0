"""``io.l5d.namerd.http`` — remote interpretation via namerd's HTTP
control API with chunked-watch streams: a copy of
``linkerd_tpu/interpreter/namerd_http.py``.

Ref: interpreter/namerd NamerdHttpInterpreterInitializer.scala:94 +
StreamingNamerClient.scala:208 — binds stream over
``/api/1/bind/<ns>?watch=true`` and addresses over
``/api/1/addr/<ns>?watch=true`` (NDJSON chunks), with jittered-backoff
reconnect holding the last good state.
"""

from __future__ import annotations

import asyncio
import json
import logging
from typing import AsyncIterator, Dict, Optional, Tuple
from urllib.parse import quote

from linkerd_tpu_torch.core import Activity, Dtab, Path, Var
from linkerd_tpu_torch.core.activity import Ok
from linkerd_tpu_torch.core.addr import (
    ADDR_NEG, ADDR_PENDING, Addr, AddrFailed, Address, Bound, BoundName,
)
from linkerd_tpu_torch.core.nametree import (
    Alt, EMPTY, FAIL, Leaf, NameTree, NEG, Union, Weighted,
)
from linkerd_tpu_torch.interpreter.mesh import Backoff
from linkerd_tpu_torch.namer.core import NameInterpreter

log = logging.getLogger(__name__)


def tree_from_json(data, mk_leaf) -> NameTree:
    t = data.get("type")
    if t == "leaf":
        return Leaf(mk_leaf(Path.read(data["id"]),
                            Path.read(data.get("residual", "/"))))
    if t == "alt":
        return Alt(*(tree_from_json(s, mk_leaf) for s in data["trees"]))
    if t == "union":
        return Union(*(Weighted(w["weight"],
                                tree_from_json(w["tree"], mk_leaf))
                       for w in data["trees"]))
    if t == "fail":
        return FAIL
    if t == "empty":
        return EMPTY
    return NEG


def addr_from_json(data) -> Addr:
    t = data.get("type")
    if t == "bound":
        return Bound(frozenset(
            Address.mk(a["ip"], a["port"], **(a.get("meta") or {}))
            for a in data.get("addrs", [])))
    if t == "failed":
        return AddrFailed(data.get("cause", ""))
    if t == "pending":
        return ADDR_PENDING
    return ADDR_NEG


async def _watch_ndjson(host: str, port: int, uri: str
                        ) -> AsyncIterator[dict]:
    """One chunked-watch connection; yields parsed NDJSON objects."""
    reader, writer = await asyncio.open_connection(host, port)
    try:
        writer.write(f"GET {uri} HTTP/1.1\r\nHost: {host}\r\n\r\n".encode())
        await writer.drain()
        status_line = await reader.readline()
        status = int(status_line.split(b" ", 2)[1])
        chunked = False
        while True:
            line = await reader.readline()
            if line in (b"\r\n", b"\n", b""):
                break
            if line.lower().startswith(b"transfer-encoding:") and \
                    b"chunked" in line.lower():
                chunked = True
        if status != 200:
            raise ConnectionError(f"namerd watch: HTTP {status}")
        buf = b""
        while True:
            if chunked:
                size_line = await reader.readline()
                if not size_line:
                    return
                n = int(size_line.strip() or b"0", 16)
                if n == 0:
                    return
                chunk = await reader.readexactly(n)
                await reader.readline()
            else:
                chunk = await reader.read(65536)
                if not chunk:
                    return
            buf += chunk
            while b"\n" in buf:
                line, _, buf = buf.partition(b"\n")
                if line.strip():
                    yield json.loads(line)
    finally:
        writer.close()


class NamerdHttpInterpreter(NameInterpreter):
    """NameInterpreter over namerd's HTTP control API."""

    def __init__(self, host: str, port: int, namespace: str = "default",
                 backoff_base: float = 0.1, backoff_max: float = 10.0):
        self.host = host
        self.port = port
        self.namespace = namespace
        self._backoff_base = backoff_base
        self._backoff_max = backoff_max
        self._binds: Dict[Tuple[Dtab, Path], Activity] = {}
        self._addrs: Dict[Path, Var[Addr]] = {}
        self._tasks: set = set()
        self._closed = False

    def _spawn(self, coro) -> None:
        task = asyncio.get_event_loop().create_task(coro)
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)

    def _addr_of(self, id_path: Path) -> Var[Addr]:
        var = self._addrs.get(id_path)
        if var is None:
            var = Var(ADDR_PENDING)
            self._addrs[id_path] = var
            self._spawn(self._watch_addr(id_path, var))
        return var

    async def _watch_addr(self, id_path: Path, var: Var[Addr]) -> None:
        backoff = Backoff(self._backoff_base, self._backoff_max)
        uri = (f"/api/1/addr/{quote(self.namespace)}"
               f"?path={quote(id_path.show)}&watch=true")
        while not self._closed:
            try:
                async for data in _watch_ndjson(self.host, self.port, uri):
                    backoff.reset()
                    var.update(addr_from_json(data))
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001 - reconnect w/ backoff
                log.debug("namerd.http addr watch %s: %s", id_path.show, e)
            if self._closed:
                return
            await asyncio.sleep(backoff.next_delay())

    def bind(self, dtab: Dtab, path: Path) -> Activity:
        key = (dtab, path)
        act = self._binds.get(key)
        if act is None:
            act = Activity.mutable()
            self._binds[key] = act
            self._spawn(self._watch_bind(dtab, path, act))
        return act

    async def _watch_bind(self, dtab: Dtab, path: Path,
                          act: Activity) -> None:
        backoff = Backoff(self._backoff_base, self._backoff_max)
        uri = (f"/api/1/bind/{quote(self.namespace)}"
               f"?path={quote(path.show)}&watch=true")
        if len(dtab) > 0:
            uri += f"&dtab={quote(dtab.show)}"

        def mk_leaf(id_path: Path, residual: Path) -> BoundName:
            return BoundName(id_path, self._addr_of(id_path), residual)

        while not self._closed:
            try:
                async for data in _watch_ndjson(self.host, self.port, uri):
                    backoff.reset()
                    if "error" in data:
                        if not isinstance(act.current, Ok):
                            act.set_exception(RuntimeError(data["error"]))
                        continue
                    act.update(Ok(tree_from_json(data, mk_leaf)))
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001 - reconnect w/ backoff
                log.debug("namerd.http bind watch %s: %s", path.show, e)
                if not isinstance(act.current, Ok):
                    act.set_exception(e)
            if self._closed:
                return
            await asyncio.sleep(backoff.next_delay())

    async def aclose(self) -> None:
        self._closed = True
        for t in list(self._tasks):
            t.cancel()
