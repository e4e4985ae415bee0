"""``io.l5d.mesh`` — remote interpretation via namerd's gRPC mesh API: a
copy of ``linkerd_tpu/interpreter/mesh.py``.

Ref: interpreter/mesh/src/main/scala/io/buoyant/interpreter/mesh/Client.scala:
``bind`` opens Interpreter.StreamBoundTree and surfaces it as an Activity
(``streamActivity``, Client.scala:105-165): on stream failure the last good
state is HELD (stale-while-reconnect) and the watch re-opens with jittered
exponential backoff. Bound-leaf addresses are resolved through
Resolver.StreamReplicas, one shared Var[Addr] per bound id.
"""

from __future__ import annotations

import asyncio
import logging
import random
from typing import Dict, Optional, Tuple

from linkerd_tpu_torch.core import Activity, Dtab, Path, Var
from linkerd_tpu_torch.core.activity import Ok
from linkerd_tpu_torch.core.addr import ADDR_PENDING, Addr, BoundName
from linkerd_tpu_torch.core.nametree import NameTree
from linkerd_tpu_torch.grpc import ClientDispatcher
from linkerd_tpu_torch.mesh import (
    INTERPRETER_SVC, RESOLVER_SVC, converters, messages as m,
)
from linkerd_tpu_torch.namer.core import NameInterpreter
from linkerd_tpu_torch.protocol.h2.client import H2Client

log = logging.getLogger(__name__)


class Backoff:
    """Jittered exponential backoff (ref: Client.scala backoffs param)."""

    def __init__(self, base: float = 0.1, max_: float = 10.0):
        self.base = base
        self.max = max_
        self._attempt = 0

    def reset(self) -> None:
        self._attempt = 0

    def next_delay(self) -> float:
        d = min(self.max, self.base * (2 ** self._attempt))
        self._attempt = min(self._attempt + 1, 30)
        return d * (0.5 + random.random() / 2)


class MeshClientInterpreter(NameInterpreter):
    """NameInterpreter backed by a remote namerd over the mesh API."""

    def __init__(self, host: str, port: int, root: str = "default",
                 backoff_base: float = 0.1, backoff_max: float = 10.0):
        self.host = host
        self.port = port
        self.root = Path.read(root if root.startswith("/") else f"/{root}")
        self._backoff_base = backoff_base
        self._backoff_max = backoff_max
        self._client: Optional[ClientDispatcher] = None
        self._h2: Optional[H2Client] = None
        self._binds: Dict[Tuple[Dtab, Path], Activity] = {}
        self._addrs: Dict[Path, Var[Addr]] = {}
        self._tasks: set = set()
        self._closed = False

    # -- plumbing ---------------------------------------------------------
    def _dispatcher(self) -> ClientDispatcher:
        if self._client is None:
            self._h2 = H2Client(self.host, self.port)
            self._client = ClientDispatcher(
                self._h2, authority=f"{self.host}:{self.port}")
        return self._client

    def _spawn(self, coro) -> None:
        task = asyncio.get_event_loop().create_task(coro)
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)

    # -- address resolution ------------------------------------------------
    def _addr_of(self, id_path: Path) -> Var[Addr]:
        var = self._addrs.get(id_path)
        if var is None:
            var = Var(ADDR_PENDING)
            self._addrs[id_path] = var
            self._spawn(self._watch_replicas(id_path, var))
        return var

    async def _watch_replicas(self, id_path: Path, var: Var[Addr]) -> None:
        backoff = Backoff(self._backoff_base, self._backoff_max)
        req = m.MReplicasReq(id=converters.path_to_proto(id_path))
        while not self._closed:
            try:
                reps = await self._dispatcher().server_stream(
                    RESOLVER_SVC, "StreamReplicas", req)
                async for rep in reps:
                    backoff.reset()
                    var.update(converters.addr_from_replicas(rep))
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001 - reconnect w/ backoff
                log.debug("mesh replicas watch %s: %s", id_path.show, e)
            if self._closed:
                return
            # hold last addr while reconnecting (stale-while-revalidate)
            await asyncio.sleep(backoff.next_delay())

    # -- binding -----------------------------------------------------------
    def bind(self, dtab: Dtab, path: Path) -> Activity[NameTree[BoundName]]:
        key = (dtab, path)
        act = self._binds.get(key)
        if act is None:
            act = Activity.mutable()
            self._binds[key] = act
            self._spawn(self._watch_bound_tree(dtab, path, act))
        return act

    async def _watch_bound_tree(self, dtab: Dtab, path: Path,
                                act: Activity) -> None:
        backoff = Backoff(self._backoff_base, self._backoff_max)
        req = m.MBindReq(
            root=converters.path_to_proto(self.root),
            name=converters.path_to_proto(path),
            dtab=converters.dtab_to_proto(dtab))

        def mk_leaf(id_path: Path, residual: Path) -> BoundName:
            return BoundName(id_path, self._addr_of(id_path), residual)

        while not self._closed:
            try:
                rsps = await self._dispatcher().server_stream(
                    INTERPRETER_SVC, "StreamBoundTree", req)
                async for rsp in rsps:
                    backoff.reset()
                    tree = converters.boundtree_from_proto(rsp.tree, mk_leaf)
                    act.update(Ok(tree))
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001 - reconnect w/ backoff
                log.debug("mesh bind watch %s: %s", path.show, e)
                # only fail the Activity if we never had a value; a stale
                # Ok is held across reconnects (Client.scala:150-160)
                if not isinstance(act.current, Ok):
                    act.set_exception(e)
            if self._closed:
                return
            await asyncio.sleep(backoff.next_delay())

    async def aclose(self) -> None:
        self._closed = True
        for t in list(self._tasks):
            t.cancel()
        if self._h2 is not None:
            await self._h2.close()
